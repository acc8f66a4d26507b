"""The port's inference data layer and config overrides against the JAX
package.

``merge_from_list`` and the new default keys; ``VIDDataset`` and
``parse_vid_xml`` on the ``mini_vid`` fixture and on an XML with a box out of
the image and a wnid outside VID; the catalog's paths; the port's own
annotation cache (loading it never imports the JAX package); the test
transforms over a grid of sizes, bit-equal, and without ``cv2`` at scale 1.0;
``iter_test_videos`` bit-equal with 1 and 2 shards and a padded tail chunk;
``PrefetchIterator`` and ``prefetch_map``.
"""

import os
import pickle
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from diffusionvid_tpu.config import get_default_cfg as jax_default_cfg
from diffusionvid_tpu.data import catalog as jax_catalog
from diffusionvid_tpu.data import sampling as jax_sampling
from diffusionvid_tpu.data import transforms as jax_transforms
from diffusionvid_tpu.data import vid_dataset as jax_vid

from diffusionvid_torch.config import get_default_cfg, load_config
from diffusionvid_torch.data import catalog, prefetch, sampling, transforms, vid_dataset
from test_data import _write_xml, mini_vid  # noqa: F401  (the shared fixture)

ROOT = Path(__file__).resolve().parent.parent

OVERRIDES = ["MODEL.RESNETS.DEPTH", "18", "SOLVER.BASE_LR", "2.5e-4",
             "MODEL.VID.MEGA.GLOBAL.ENABLE", "False", "TEST.SEQ_NMS", "true",
             "INPUT.MIN_SIZE_TRAIN", "(128,)", "INPUT.MIN_SIZE_TEST", "[480, 512]",
             "DATASETS.TEST", "('VID_val_videos',)", "MODEL.WEIGHT", "''",
             "OUTPUT_DIR", "/some/where", "NEW.NODE.KEY", "3", "TEST.EXPECTED_RESULTS",
             "[['ap50', 0.5, 0.01]]"]


def _leaves(node, prefix=""):
    for k, v in node.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


# ---------------------------------------------------------------- config

def test_merge_from_list_vs_jax():
    cfg, ref = get_default_cfg(), jax_default_cfg()
    cfg.merge_from_list(list(OVERRIDES))
    ref.merge_from_list(list(OVERRIDES))
    for key in OVERRIDES[0::2]:
        got, want = dict(_leaves(cfg))[key], dict(_leaves(ref))[key]
        assert got == want and type(got) is type(want), key
    assert cfg.MODEL.WEIGHT == "" and cfg.INPUT.MIN_SIZE_TRAIN == (128,)
    assert cfg.MODEL.VID.MEGA.GLOBAL.ENABLE is False and cfg.SOLVER.BASE_LR == 2.5e-4
    with pytest.raises(ValueError, match="pairs"):
        cfg.merge_from_list(["MODEL.RESNETS.DEPTH"])


def test_load_config_applies_opts_after_the_yaml():
    path = str(ROOT / "configs" / "vid_R_101_DiffusionVID.yaml")
    opts = ["MODEL.DiffusionDet.SAMPLE_STEP", "4", "INPUT.INFER_BATCH", "4"]
    cfg = load_config(path, opts)
    assert cfg.MODEL.DiffusionDet.SAMPLE_STEP == 4 and cfg.INPUT.INFER_BATCH == 4
    assert cfg.MODEL.DiffusionDet.NUM_HEADS == 3   # from the YAML
    assert load_config(path).MODEL.DiffusionDet.SAMPLE_STEP == 1


@pytest.mark.parametrize("key", ["MODEL.RPN_ONLY", "TEST.EXPECTED_RESULTS",
                                 "TEST.EXPECTED_RESULTS_SIGMA_TOL", "TEST.SEQ_NMS"])
def test_cli_default_keys_vs_jax(key):
    got, want = dict(_leaves(get_default_cfg()))[key], dict(_leaves(jax_default_cfg()))[key]
    assert got == want and type(got) is type(want)


# ---------------------------------------------------------------- dataset

def _dataset(mod, mini_vid, is_train=False, use_cache=False):
    return mod.VIDDataset("test_set", mini_vid["root"], mini_vid["img_dir"],
                          mini_vid["anno_dir"], mini_vid["index"], is_train=is_train,
                          use_cache=use_cache)


def _same_anno(got, want):
    np.testing.assert_array_equal(got.boxes, want.boxes)
    np.testing.assert_array_equal(got.labels, want.labels)
    assert got.boxes.dtype == want.boxes.dtype and got.labels.dtype == want.labels.dtype
    assert (got.height, got.width) == (want.height, want.width)


@pytest.mark.parametrize("is_train", [False, True], ids=["test", "train"])
def test_vid_dataset_vs_jax(mini_vid, tmp_path, is_train):
    """The mini_vid fixture with an empty frame appended to each video's
    index (the train side drops it) and a 2-column DET-style index."""
    index = tmp_path / "index.txt"
    anno = Path(mini_vid["anno_dir"])
    lines = []
    for v in range(2):
        _write_xml(str(anno / f"val/vid_{v:04d}" / "000006.xml"), 160, 240, [])
        lines += [f"val/vid_{v:04d} {7 * v + f + 1} {f} 7" for f in range(7)]
    index.write_text("\n".join(lines) + "\n")
    spec = dict(mini_vid, index=str(index))
    got, want = _dataset(vid_dataset, spec, is_train), _dataset(jax_vid, spec, is_train)
    assert len(got) == len(want) == (12 if is_train else 14)
    for attr in ("image_set_index", "pattern", "frame_id", "frame_seg_id", "frame_seg_len"):
        assert getattr(got, attr) == getattr(want, attr), attr
    assert got.is_video and got.video_starts() == want.video_starts()
    for i in range(len(got)):
        _same_anno(got.get_groundtruth(i), want.get_groundtruth(i))
    s = got.video_starts()[1]
    assert got.frame_path(s, 3) == want.frame_path(s, 3)
    _same_anno(got.get_groundtruth_for_frame(s, 6), want.get_groundtruth_for_frame(s, 6))
    np.testing.assert_array_equal(got.load_image(got.frame_path(0, 2), np.uint8),
                                  want.load_image(want.frame_path(0, 2), np.uint8))

    det_index = tmp_path / "det.txt"
    det_index.write_text("val/vid_0000/000001 1\nval/vid_0001/000004 2\n")
    det = dict(mini_vid, index=str(det_index))
    got, want = _dataset(vid_dataset, det), _dataset(jax_vid, det)
    assert not got.is_video and got.image_set_index == want.image_set_index
    for i in range(2):
        _same_anno(got.get_groundtruth(i), want.get_groundtruth(i))


def test_parse_vid_xml_clips_and_drops_vs_jax(tmp_path):
    path = str(tmp_path / "a.xml")
    _write_xml(path, 100, 150, [(jax_vid.VID_WNIDS[3], (-5, -2, 170, 120)),
                                ("n00000000", (1, 1, 10, 10)),
                                (jax_vid.VID_WNIDS[30].upper() + " ", (3, 4, 20, 30))])
    got, want = vid_dataset.parse_vid_xml(path), jax_vid.parse_vid_xml(path)
    _same_anno(got, want)
    np.testing.assert_array_equal(got.boxes[0], [0, 0, 149, 99])
    assert got.labels.tolist() == [3, 30]
    assert vid_dataset.VID_CLASSES == jax_vid.VID_CLASSES
    assert vid_dataset.WNID_TO_LABEL == jax_vid.WNID_TO_LABEL


@pytest.mark.parametrize("name", sorted(jax_catalog.DATASETS))
def test_get_dataset_paths_vs_jax(name, tmp_path):
    assert catalog.DATASETS[name] == jax_catalog.DATASETS[name]
    index = catalog.DATASETS[name][2]
    built = {}

    class Spy:
        def __init__(self, **kw):
            built.setdefault("kw", []).append(kw)

    for mod in (catalog, jax_catalog):
        orig, mod.VIDDataset = mod.VIDDataset, Spy
        try:
            mod.get_dataset(name, is_train=False, data_dir=str(tmp_path))
        finally:
            mod.VIDDataset = orig
    assert built["kw"][0] == built["kw"][1]
    assert built["kw"][0]["img_index"] == os.path.join(str(tmp_path), index)


def test_get_dataset_refuses_still_images(monkeypatch):
    """The still-image names, refused until ROADMAP.md A8.1 was ported, now
    build the JAX catalog's datasets from the same paths and split (each
    class replaced by a spy); only an unknown name raises.  The datasets
    themselves are held against JAX in ``test_torch_port_still.py``."""
    from diffusionvid_torch.data import cityscapes, coco_voc
    from diffusionvid_tpu.data import cityscapes as jax_cityscapes
    from diffusionvid_tpu.data import coco_voc as jax_coco_voc

    calls = []

    def spy(kind):
        return lambda *a, **kw: calls.append((kind, a, kw))

    for mod in (coco_voc, jax_coco_voc):
        monkeypatch.setattr(mod, "COCODataset", spy("coco"))
        monkeypatch.setattr(mod, "VOCDataset", spy("voc"))
    for mod in (cityscapes, jax_cityscapes):
        monkeypatch.setattr(mod, "CityscapesDataset", spy("cityscapes"))
    for name in ("coco_2017_val", "voc_2007_test", "cityscapes_val"):
        for mod in (catalog, jax_catalog):
            mod.get_dataset(name, is_train=False, data_dir="/nonexistent")
        assert calls[-1] == calls[-2] and calls[-1][0] == name.split("_")[0], calls[-2:]
    assert calls[0][1] == ("/nonexistent/coco/annotations/instances_2017_val.json",
                           "/nonexistent/coco/2017_val")
    with pytest.raises(KeyError, match="unknown dataset"):
        catalog.get_dataset("VID_nothing", is_train=False)


def test_annotation_cache_never_imports_jax(mini_vid, tmp_path):
    """With the JAX package's cache file in place, the port writes and reads
    its own: a fresh process that loads the port's dataset twice never
    imports ``diffusionvid_tpu``."""
    data = tmp_path / "data"
    (data / "cache").mkdir(parents=True)
    jax_ds = jax_vid.VIDDataset("test_set", str(data), mini_vid["img_dir"],
                                mini_vid["anno_dir"], mini_vid["index"], is_train=False)
    assert (data / "cache" / "test_set_anno_tpu.pkl").exists()
    code = f"""
import sys
from diffusionvid_torch.data.vid_dataset import VIDDataset
for _ in range(2):
    ds = VIDDataset("test_set", {str(data)!r}, {mini_vid['img_dir']!r},
                    {mini_vid['anno_dir']!r}, {mini_vid['index']!r}, is_train=False)
assert not any(m.split(".")[0] == "diffusionvid_tpu" for m in sys.modules), "imported"
print(len(ds), type(ds.annos[0]).__module__)
"""
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split() == ["12", "diffusionvid_torch.data.vid_dataset"]
    with open(data / "cache" / "test_set_anno_torch.pkl", "rb") as f:
        cached = pickle.load(f)
    for got, want in zip(cached, jax_ds.annos):
        _same_anno(got, want)


# ---------------------------------------------------------------- transforms

SIZES = [(160, 240), (240, 160), (720, 1280), (1280, 720), (600, 1000), (375, 500),
         (500, 375), (64, 96), (1080, 1920), (333, 1000)]


@pytest.mark.parametrize("hw", SIZES, ids=lambda hw: f"{hw[0]}x{hw[1]}")
def test_scale_and_buckets_vs_jax(hw):
    for mn, mx in ((600, 1000), (64, 96), (128, 256), (800, 1333)):
        assert transforms.resize_scale(*hw, mn, mx) == jax_transforms.resize_scale(*hw, mn, mx)
        assert transforms.frame_bucket(*hw, mn, mx) == jax_transforms.frame_bucket(*hw, mn, mx)
        assert transforms.bucket_shape(mn, mx) == jax_transforms.bucket_shape(mn, mx)


@pytest.mark.parametrize("hw", [(160, 240), (240, 160), (75, 100), (64, 96)],
                         ids=lambda hw: f"{hw[0]}x{hw[1]}")
def test_transform_frame_bit_equal(hw):
    img = np.random.RandomState(hw[0]).randint(0, 256, (*hw, 3)).astype(np.uint8)
    for mn, mx in ((64, 96), (128, 256), (600, 1000)):
        scale = transforms.resize_scale(*hw, mn, mx)
        bucket = transforms.frame_bucket(*hw, mn, mx)
        for flip in (False, True):
            got = transforms.transform_frame(img, scale, flip, bucket)
            want = jax_transforms.transform_frame(img, scale, flip, bucket)
            assert got.dtype == np.uint8 and got.shape == (*bucket, 3)
            np.testing.assert_array_equal(got, want)


def test_transform_at_scale_one_needs_no_cv2(tmp_path):
    img = np.random.RandomState(1).randint(0, 256, (600, 1000, 3)).astype(np.uint8)
    code = """
import sys
sys.modules["cv2"] = None
import numpy as np
from diffusionvid_torch.data.transforms import frame_bucket, resize_scale, transform_frame
img = np.load(sys.argv[1])
out = transform_frame(img, resize_scale(600, 1000), False, frame_bucket(600, 1000))
assert out.shape == (608, 1024, 3) and (out[:600, :1000] == img).all() and not out[600:].any()
try:
    transform_frame(img, 0.5, False, (608, 1024))
except ImportError:
    print("ok")
"""
    path = tmp_path / "frame.npy"
    np.save(path, img)
    res = subprocess.run([sys.executable, "-c", code, str(path)], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr
    want = jax_transforms.transform_frame(img, 1.0, False, (608, 1024))
    np.testing.assert_array_equal(transforms.transform_frame(img, 1.0, False, (608, 1024)), want)


# ---------------------------------------------------------------- sampling

def _videos(mod, ds_mod, mini_vid, num_shards, shard):
    ds = _dataset(ds_mod, mini_vid)
    cfg = mod.SampleConfig(global_size=3, infer_batch=4, min_size=64, max_size=96)
    out = []
    for v in mod.iter_test_videos(ds, cfg, seed=5, shard=shard, num_shards=num_shards):
        out.append((v, list(v.chunk_iter)))
    return out


@pytest.mark.parametrize("shards", [1, 2])
def test_iter_test_videos_bit_equal(mini_vid, shards):
    assert sampling.SampleConfig() == sampling.SampleConfig(**vars(jax_sampling.SampleConfig()))
    for shard in range(shards):
        got = _videos(sampling, vid_dataset, mini_vid, shards, shard)
        want = _videos(jax_sampling, jax_vid, mini_vid, shards, shard)
        assert len(got) == len(want) == 2 // shards
        for (gv, gc), (wv, wc) in zip(got, want):
            assert (gv.video_index, gv.seg_len, gv.bucket) == (wv.video_index, wv.seg_len,
                                                              wv.bucket)
            np.testing.assert_array_equal(gv.global_frames, wv.global_frames)
            assert gv.global_frames.dtype == np.uint8 and gv.global_frames.shape[0] == 3
            np.testing.assert_array_equal(gv.whwh, wv.whwh)
            assert len(gc) == len(wc) == 2
            for (gf, gid, gn), (wf, wid, wn) in zip(gc, wc):
                np.testing.assert_array_equal(gf, wf)
                assert gid == wid and gn == wn
            assert gc[-1][2] == 2 and gc[-1][1] == [4, 5, 5, 5]   # the tail padded
            for ga, wa in zip(gv.frame_annos, wv.frame_annos):
                _same_anno(ga, wa)


# ---------------------------------------------------------------- prefetch

def test_prefetch_keeps_order_and_ends_after_a_slow_consumer():
    """Every item in order, then the end, also when the producer finishes
    while the consumer still holds the queue full."""
    for depth in (1, 2, 4):
        it = prefetch.PrefetchIterator(iter(range(7)), depth=depth)
        got = []
        done = threading.Event()

        def consume():
            for x in it:
                time.sleep(0.02)
                got.append(x)
            done.set()

        t = threading.Thread(target=consume, daemon=True)
        t.start()
        t.join(timeout=30)
        assert done.is_set() and got == list(range(7)), (depth, got)
    assert list(prefetch.prefetch_map(lambda x: x * x, range(40), workers=4, depth=5)) == [
        x * x for x in range(40)]


def test_prefetch_raises_the_producers_error():
    def items():
        yield 1
        raise ValueError("decode failed")

    it = prefetch.PrefetchIterator(items(), depth=2)
    assert next(it) == 1
    with pytest.raises(ValueError, match="decode failed"):
        next(it)

    def bad(x):
        if x == 3:
            raise KeyError(x)
        return x

    with pytest.raises(KeyError):
        list(prefetch.prefetch_map(bad, range(6), workers=2))


def test_prefetch_close_releases_the_producer():
    produced = []

    def items():
        for i in range(1000):
            produced.append(i)
            yield np.zeros(1000)

    it = prefetch.PrefetchIterator(items(), depth=2)
    next(it)
    it.close()
    it._thread.join(timeout=10)
    assert not it._thread.is_alive() and len(produced) < 10
