"""The port's train data against the JAX package, on the same seeded inputs.

The train side's own resize and RGB <-> HSV against ``cv2``, and samples
built with ``cv2`` and ``PIL`` blocked; each piece of the SSD augmentation
(``INPUT.TRANSFORM``) over 60 seeds; ``pad_groundtruth`` and
``image_path``; ``build_train_sample`` on the shared ``mini_vid`` fixture
(a video index and a DET-style index of its frames) with the augmentation
off and on; ``ConcatDataset`` and ``train_sample_stream`` with 2 shards; the
aspect-ratio samplers; and the train CLI's per-iteration samples (draws from
``RandomState((1000003 * it + 12345) % (2**31 - 1))``, reuse swaps from
``RandomState((7654321 + it) % (2**31 - 1))``) rebuilt from the JAX package's
functions with the JAX CLI's formulas (``tools/train_net.py:232-287``).

Tolerances.  Boxes, labels and valid masks are equal: every draw of the
random state happens in the same order on both sides, so any difference
there is a difference in the draws.  Images: the port resizes and converts
colours with its own numpy code where the JAX package calls ``cv2``.  On
float images the two agree to 1e-4 (float32 rounding of the same
formulas); OpenCV resizes uint8 images with 11-bit fixed-point weights
where the port rounds a float result, and float32 round-off can move a
value across an integer before the augmentation's final truncation to
uint8: one grey level each, so 1 after either step and 2 after both.
"""

import subprocess
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest

from diffusionvid_tpu.data import samplers as jax_samplers
from diffusionvid_tpu.data import sampling as jax_sampling
from diffusionvid_tpu.data import transforms as jax_transforms
from diffusionvid_tpu.data import vid_dataset as jax_vid

from diffusionvid_torch.data import samplers, sampling, transforms, vid_dataset
from diffusionvid_torch.tools import train_net
from test_data import mini_vid  # noqa: F401  (the shared fixture)

ROOT = Path(__file__).resolve().parent.parent
SEEDS = range(60)


def _grey(got, want, levels: int):
    diff = np.abs(got.astype(np.int64) - want.astype(np.int64))
    assert got.shape == want.shape and diff.max() <= levels, diff.max()


# ---------------------------------------------------------------- resize, HSV

def test_rgb_hsv_vs_cv2():
    """Values from -40 to 300, as brightness and contrast leave them before
    the HSV step, with greys and ties between channels; then saturation x1.5
    and a hue shift, which take RGB outside 0..255 on the way back."""
    img = np.random.RandomState(0).uniform(-40, 300, (64, 80, 3)).astype(np.float32)
    img[0, :, 1:] = img[0, :, :1]
    img[1, :, 2] = img[1, :, 0]
    img[2, :, 1] = img[2, :, 0]
    hsv, want = transforms.rgb_to_hsv(img), cv2.cvtColor(img, cv2.COLOR_RGB2HSV)
    np.testing.assert_allclose(hsv[..., 0], want[..., 0], rtol=0, atol=1e-3)
    np.testing.assert_allclose(hsv[..., 1:], want[..., 1:], rtol=1e-6, atol=1e-6)
    want[..., 1] *= 1.5
    want[..., 0] = (want[..., 0] + 17.0) % 360.0
    rgb, ref = transforms.hsv_to_rgb(want), cv2.cvtColor(want, cv2.COLOR_HSV2RGB)
    assert ref.min() < -40 and ref.max() > 260          # nothing clipped
    np.testing.assert_allclose(rgb, ref, rtol=0, atol=1e-3)


RESIZES = [((64, 96), (50, 77)), ((64, 96), (128, 200)), ((31, 17), (64, 96)),
           ((64, 96), (32, 48)), ((144, 256), (113, 200)), ((96, 64), (96, 64))]


@pytest.mark.parametrize("src,dst", RESIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_transform_frame_to_vs_jax(src, dst):
    rng = np.random.RandomState(src[0] * dst[1])
    img = rng.randint(0, 256, (*src, 3)).astype(np.uint8)
    bucket = (max(dst[0], 64) + 32, max(dst[1], 96) + 32)
    for flip in (False, True):
        for im, tol in ((img, 1), (img.astype(np.float32) + rng.rand(*src, 3), 1e-4)):
            got = transforms.transform_frame_to(im, dst, flip, bucket)
            want = jax_transforms.transform_frame_to(im, dst, flip, bucket)
            assert got.dtype == want.dtype and got.shape == (*bucket, 3)
            if im.dtype == np.uint8:
                _grey(got, want, tol)
            else:
                np.testing.assert_allclose(got, want, rtol=0, atol=tol)


# ---------------------------------------------------------------- the SSD pieces

def _frame(seed: int):
    """A uint8 frame with a few boxes: flat regions, edges and noise."""
    rng = np.random.RandomState(1000 + seed)
    h, w = rng.randint(40, 72), rng.randint(56, 96)
    img = np.full((h, w, 3), rng.randint(0, 256, 3), np.uint8)
    n = rng.randint(0, 4) if seed % 7 else 0
    xy = rng.uniform(0, 0.6, (n, 2)) * (w, h)
    wh = rng.uniform(0.15, 0.4, (n, 2)) * (w, h)
    boxes = np.concatenate([xy, xy + wh], 1).astype(np.float32)
    for x1, y1, x2, y2 in boxes.astype(int):
        img[y1:y2, x1:x2] = rng.randint(0, 256, 3)
    img = np.clip(img + rng.randint(-20, 21, img.shape), 0, 255).astype(np.uint8)
    return img, boxes, rng.randint(1, 31, n).astype(np.int32)


def _same_state(a: np.random.RandomState, b: np.random.RandomState):
    sa, sb = a.get_state(), b.get_state()
    assert np.array_equal(sa[1], sb[1]) and sa[2:] == sb[2:]


@pytest.mark.parametrize("piece", ["photometric", "expand", "crop", "augment"])
def test_ssd_pieces_vs_jax(piece):
    mean = (123.675, 116.280, 103.530)
    for seed in SEEDS:
        img, boxes, labels = _frame(seed)
        rp, rj = np.random.RandomState(seed), np.random.RandomState(seed)
        if piece == "photometric":
            got = transforms.ssd_photometric_distort(img.astype(np.float32), rp)
            want = jax_transforms.ssd_photometric_distort(img.astype(np.float32), rj)
            _grey(np.clip(got, 0, 255).astype(np.uint8), np.clip(want, 0, 255).astype(np.uint8), 1)
        elif piece == "expand":
            fimg = img.astype(np.float32)
            got = transforms.ssd_expand(fimg, boxes, rp, mean)
            want = jax_transforms.ssd_expand(fimg, boxes, rj, mean)
            np.testing.assert_array_equal(got[0], want[0])
            np.testing.assert_array_equal(got[1], want[1])
        elif piece == "crop":
            got = transforms.ssd_random_sample_crop(img, boxes, labels, rp)
            want = jax_transforms.ssd_random_sample_crop(img, boxes, labels, rj)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)
        else:
            got = transforms.ssd_augment(img, boxes.copy(), labels, rp, mean)
            want = jax_transforms.ssd_augment(img, boxes.copy(), labels, rj, mean)
            assert got[0].dtype == np.uint8
            _grey(got[0], want[0], 1)
            np.testing.assert_array_equal(got[1], want[1])
            np.testing.assert_array_equal(got[2], want[2])
        _same_state(rp, rj)


# ---------------------------------------------------------------- dataset, samples

@pytest.mark.parametrize("flip", [False, True])
def test_pad_groundtruth_vs_jax(flip):
    rng = np.random.RandomState(int(flip))
    for n in (0, 1, 5, 9):
        boxes = np.sort(rng.uniform(0, 200, (n, 4)).astype(np.float32).reshape(n, 2, 2),
                        1).reshape(n, 4)
        labels = rng.randint(1, 31, n).astype(np.int32)
        for scale in (1.0, 0.625, 1.6):
            got = vid_dataset.pad_groundtruth(vid_dataset.FrameAnno(boxes, labels, 150, 220),
                                              8, scale, flip)
            want = jax_vid.pad_groundtruth(jax_vid.FrameAnno(boxes, labels, 150, 220),
                                           8, scale, flip)
            for g, w in zip(got, want):
                assert g.dtype == w.dtype
                np.testing.assert_array_equal(g, w)


def _datasets(mini_vid, tmp_path):
    """The port's and the JAX package's (video, DET-style) datasets over the
    fixture's frames: the DET index lists four of them as stills."""
    det_index = tmp_path / "det.txt"
    det_index.write_text("val/vid_0000/000001 1\nval/vid_0001/000004 2\n"
                         "val/vid_0000/000005 3\nval/vid_0001/000000 4\n")
    out = []
    for mod in (vid_dataset, jax_vid):
        made = []
        for name, index in (("vid", mini_vid["index"]), ("det", str(det_index))):
            made.append(mod.VIDDataset(f"train_{name}", mini_vid["root"], mini_vid["img_dir"],
                                       mini_vid["anno_dir"], index, is_train=True,
                                       use_cache=False))
        out.append(made)
    return out


def _same_sample(got, want, image_tol):
    assert set(got) == set(want)
    for k in ("gt_boxes", "gt_labels", "gt_valid", "whwh"):
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k])
    assert got["bucket"] == want["bucket"] and got["images"].dtype == want["images"].dtype
    if image_tol >= 1:
        _grey(got["images"], want["images"], image_tol)
    else:
        np.testing.assert_allclose(got["images"], want["images"], rtol=0, atol=image_tol)


def test_train_samples_need_no_cv2(mini_vid, tmp_path):
    """The train side resizes and converts colours without ``cv2`` or
    ``PIL``: with both blocked, samples build with the augmentation off and
    on (frames from a ``load_image`` that needs no decoder)."""
    code = f"""
import sys
sys.modules["cv2"] = None
sys.modules["PIL"] = None
import numpy as np
from diffusionvid_torch.data.sampling import SampleConfig, build_train_sample
from diffusionvid_torch.data.vid_dataset import VIDDataset

class Decoded(VIDDataset):
    def load_image(self, path, dtype=np.float32):
        return np.random.RandomState(len(path)).randint(0, 256, (160, 240, 3)).astype(dtype)

ds = Decoded("nocv2", {mini_vid['root']!r}, {mini_vid['img_dir']!r}, {mini_vid['anno_dir']!r},
             {mini_vid['index']!r}, is_train=True, use_cache=False)
for transform in (False, True):
    smp = build_train_sample(ds, 3, np.random.RandomState(0),
                             SampleConfig(num_global=2, min_size=(96,), max_size=160,
                                          transform=transform))
    assert smp["images"].shape == (3, 96, 160, 3) and smp["gt_valid"].any()
print("ok")
"""
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr


def test_image_path_vs_jax(mini_vid, tmp_path):
    (pv, pd), (jv, jd) = _datasets(mini_vid, tmp_path)
    for p, j in ((pv, jv), (pd, jd)):
        assert [p.image_path(i) for i in range(len(p))] == [j.image_path(i) for i in range(len(j))]


@pytest.mark.parametrize("transform", [False, True], ids=["plain", "ssd"])
def test_build_train_sample_vs_jax(mini_vid, tmp_path, transform):
    """Scale jitter over two sizes, both flips, the video's global refs and
    the stills' copies (replicated, or augmented each on its own)."""
    (pv, pd), (jv, jd) = _datasets(mini_vid, tmp_path)
    cfg = dict(num_global=3, min_size=(96, 128), max_size=200, transform=transform)
    pcfg, jcfg = sampling.SampleConfig(**cfg), jax_sampling.SampleConfig(**cfg)
    tol = 2 if transform else 1e-4
    for p, j in ((pv, jv), (pd, jd)):
        for idx in range(len(p)):
            for seed in (idx, 100 + idx):
                got = sampling.build_train_sample(p, idx, np.random.RandomState(seed), pcfg)
                want = jax_sampling.build_train_sample(j, idx, np.random.RandomState(seed), jcfg)
                assert got["images"].shape[0] == 4
                _same_sample(got, want, tol)


def test_build_train_sample_method_layouts_vs_jax(mini_vid, tmp_path):
    """The other methods' layouts ([cur, locals…, mems…, globals…]) that
    ``MethodSampleSpec`` describes."""
    (pv, _), (jv, _) = _datasets(mini_vid, tmp_path)
    cfg = dict(min_size=96, max_size=160)
    pcfg, jcfg = sampling.SampleConfig(**cfg), jax_sampling.SampleConfig(**cfg)
    for spec in (dict(method="rdn", num_local=2, min_offset=-2, max_offset=2),
                 dict(method="mega", num_local=2, min_offset=-1, max_offset=1, num_mem=3,
                      all_frame_interval=2, num_global=2)):
        for idx in (0, 4, 9):
            got = sampling.build_train_sample_method(pv, idx, np.random.RandomState(idx), pcfg,
                                                     sampling.MethodSampleSpec(**spec))
            want = jax_sampling.build_train_sample_method(
                jv, idx, np.random.RandomState(idx), jcfg, jax_sampling.MethodSampleSpec(**spec))
            _same_sample(got, want, 1e-4)


def test_method_sample_spec_from_config_vs_jax():
    from diffusionvid_tpu.config import get_default_cfg as jax_default_cfg
    cfg = jax_default_cfg()
    for method in ("base", "dff", "fgfa", "rdn", "mega", "dafa"):
        cfg.MODEL.VID.METHOD = method
        want = jax_sampling.MethodSampleSpec.from_config(cfg)
        assert sampling.MethodSampleSpec.from_config(cfg) == sampling.MethodSampleSpec(**vars(want))
    cfg.MODEL.VID.METHOD = "unknown"
    with pytest.raises(ValueError, match="no train sampling"):
        sampling.MethodSampleSpec.from_config(cfg)


def test_concat_dataset_and_sharded_stream_vs_jax(mini_vid, tmp_path):
    (pv, pd), (jv, jd) = _datasets(mini_vid, tmp_path)
    pc, jc = sampling.ConcatDataset([pd, pv]), jax_sampling.ConcatDataset([jd, jv])
    assert len(pc) == len(jc) == 16 and pc.offsets == jc.offsets
    for a, b in zip(pc.annos, jc.annos):
        np.testing.assert_array_equal(a.boxes, b.boxes)
    cfg = dict(num_global=2, min_size=96, max_size=160)
    pcfg, jcfg = sampling.SampleConfig(**cfg), jax_sampling.SampleConfig(**cfg)
    for idx in (0, 3, 4, 15):
        _same_sample(pc.sample(idx, np.random.RandomState(idx), pcfg),
                     jc.sample(idx, np.random.RandomState(idx), jcfg), 1e-4)
    with pytest.raises(IndexError):
        pc._locate(16)
    for shard in range(2):
        got = sampling.train_sample_stream(pv, pcfg, seed=3, shard=shard, num_shards=2)
        want = jax_sampling.train_sample_stream(jv, jcfg, seed=3, shard=shard, num_shards=2)
        for _ in range(8):   # past the first epoch's 6 samples a shard
            _same_sample(next(got), next(want), 1e-4)


# ---------------------------------------------------------------- samplers

class _Annos:
    def __init__(self, hws):
        self.annos = [vid_dataset.FrameAnno(np.zeros((0, 4), np.float32),
                                            np.zeros(0, np.int32), h, w) for h, w in hws]

    def __len__(self):
        return len(self.annos)


@pytest.mark.parametrize("batch_size", [1, 2, 3])
def test_samplers_vs_jax(batch_size):
    rng = np.random.RandomState(batch_size)
    ds = _Annos([(int(h), int(w)) for h, w in rng.randint(50, 150, (37, 2))])
    ids = samplers.aspect_ratio_group_ids(ds)
    np.testing.assert_array_equal(ids, jax_samplers.aspect_ratio_group_ids(ds))
    assert 0 < ids.sum() < len(ids)
    for shard, shards in ((0, 1), (0, 2), (1, 2)):
        for max_it in (None, 5, 40):
            got = samplers.grouped_batches(ids, batch_size, seed=4, shard=shard,
                                           num_shards=shards, max_iterations=max_it)
            want = jax_samplers.grouped_batches(ids, batch_size, seed=4, shard=shard,
                                                num_shards=shards, max_iterations=max_it)
            n = 60 if max_it is None else max_it + 1
            g = [b for _, b in zip(range(n), got)]
            w = [b for _, b in zip(range(n), want)]
            assert g == w and len(g) == min(n, max_it or n)
            assert all(len({int(ids[i]) for i in b}) == 1 for b in g)


# ---------------------------------------------------------------- the CLI's draws

def _jax_cli_samples(ds, cfg, start_iter, max_iter, reuse_steps, first_global):
    """The JAX CLI's per-iteration samples (``tools/train_net.py:218-287``),
    its lines over the JAX package's functions."""
    batch_iter = jax_samplers.grouped_batches(jax_samplers.aspect_ratio_group_ids(ds), 1, seed=0)
    for _ in range((start_iter + reuse_steps - 1) // reuse_steps):
        next(batch_iter)

    def sample_batches():
        it = start_iter
        while True:
            srng = np.random.RandomState((1000003 * it + 12345) % (2**31 - 1))
            yield [ds.sample(i, srng, cfg) for i in next(batch_iter)]
            it = (it // reuse_steps + 1) * reuse_steps

    batches, samples = sample_batches(), None
    for it in range(start_iter, max_iter):
        if samples is None or it % reuse_steps == 0:
            samples = next(batches)
        else:
            reuse_rng = np.random.RandomState((7654321 + it) % (2**31 - 1))
            for smp in samples:
                j = reuse_rng.randint(first_global, smp["images"].shape[0])
                for key in ("images", "gt_boxes", "gt_labels", "gt_valid"):
                    smp[key][[0, j]] = smp[key][[j, 0]]
        yield _copies(samples)


def _copies(samples):
    return [{k: np.copy(v) if isinstance(v, np.ndarray) else v for k, v in s.items()}
            for s in samples]


def _port_cli_samples(ds, cfg, start_iter, max_iter, reuse_steps, first_global):
    batch_iter = samplers.grouped_batches(samplers.aspect_ratio_group_ids(ds), 1, seed=0)
    for _ in range((start_iter + reuse_steps - 1) // reuse_steps):
        next(batch_iter)
    batches = train_net.sample_batches(ds, batch_iter, cfg, start_iter, reuse_steps)
    for samples in train_net.iteration_samples(batches, start_iter, max_iter, reuse_steps,
                                               first_global):
        yield _copies(samples)


@pytest.mark.parametrize("start_iter", [0, 2, 3])
def test_cli_draws_and_reuse_swaps_vs_jax_formulas(mini_vid, tmp_path, start_iter):
    """6 iterations with BATCH_REUSE_STEPS 2 and the SSD augmentation over a
    DET + VID concatenation, from iteration 0 and as resumed runs.  From
    iteration 2, where a batch loads, the samples are the uninterrupted
    run's.  From iteration 3, inside a reuse, both packages load the next
    batch with iteration 3's draws instead of replaying the swap, and go on
    a batch ahead: a resume is exact only at a multiple of
    BATCH_REUSE_STEPS."""
    (pv, pd), (jv, jd) = _datasets(mini_vid, tmp_path)
    cfg = dict(num_global=2, min_size=(64,), max_size=96, transform=True)
    got = list(_port_cli_samples(sampling.ConcatDataset([pd, pv]), sampling.SampleConfig(**cfg),
                                 start_iter, 6, 2, 1))
    want = list(_jax_cli_samples(jax_sampling.ConcatDataset([jd, jv]),
                                 jax_sampling.SampleConfig(**cfg), start_iter, 6, 2, 1))
    straight = list(_port_cli_samples(sampling.ConcatDataset([pd, pv]),
                                      sampling.SampleConfig(**cfg), 0, 6, 2, 1))
    assert len(got) == len(want) == 6 - start_iter
    for it, (g, w) in enumerate(zip(got, want), start_iter):
        assert len(g) == len(w) == 1
        _same_sample(g[0], w[0], 2)
        if start_iter % 2 == 0:
            for k, v in g[0].items():
                assert np.array_equal(v, straight[it][0][k]), k
    if start_iter % 2:
        assert not np.array_equal(got[0][0]["images"], straight[start_iter][0]["images"])
    # iteration 5 reuses iteration 4's batch: the same frames, one swapped in
    assert sorted(map(bytes, got[-2][0]["images"])) == sorted(map(bytes, got[-1][0]["images"]))
