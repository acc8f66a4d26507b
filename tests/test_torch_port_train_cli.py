"""The port's train CLI (``python -m diffusionvid_torch.tools.train_net``) on
the CPU, on the tiny config at depth 18 and 64x96 frames, over an
ILSVRC-layout tree of JPEGs (DET stills, two of them portrait, a VID train
set and a val video).

What it holds: the files a run writes; a run 0→4 against a run 0→2 resumed
to 4, with BATCH_REUSE_STEPS 2 and ACCUMULATION_STEPS 2 (bit-equal
parameters, the same ``metrics.jsonl``, a stale record after the resume
point purged); the CLI against ``train_loop`` on the same batches; each
``MODEL.WEIGHT`` format through ``--pretrained`` against the JAX package's
``load_torch_checkpoint`` + ``merge_pretrained`` (mapped through
``state_dict_from_jax``), the class head fresh; ``--torch-weights`` with a
``module.`` prefix (the fault the JAX loader keeps); the failures the CLI
reports.
"""

import json
import logging
import pickle
import shutil
import xml.etree.ElementTree as ET
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from diffusionvid_tpu.utils import load_torch_checkpoint
from diffusionvid_tpu.utils import merge_pretrained as jax_merge_pretrained
from diffusionvid_tpu.utils.torch_convert import convert_torch_state_dict

from diffusionvid_torch.config import load_config
from diffusionvid_torch.data.catalog import DATASETS
from diffusionvid_torch.data.vid_dataset import VID_WNIDS
from diffusionvid_torch.engine.train import optimizer_from_config, train_loop
from diffusionvid_torch.models.diffusion_det import DiffusionDetArch
from diffusionvid_torch.tools import test_net, train_net
from diffusionvid_torch.utils.checkpoint import load_checkpoint
from diffusionvid_torch.utils.convert import load_pretrained, state_dict_from_jax

ROOT = Path(__file__).resolve().parent.parent
CONFIG = str(ROOT / "configs" / "vid_R_50_tiny_synthetic.yaml")
# depth 18 and a 64-wide head: a checkpoint with its Adam state is 190 MB
TINY = ["MODEL.RESNETS.DEPTH", "18", "MODEL.DiffusionDet.NUM_PROPOSALS", "16",
        "MODEL.DiffusionDet.HIDDEN_DIM", "64",
        "INPUT.MIN_SIZE_TRAIN", "(64,)", "INPUT.MAX_SIZE_TRAIN", "96",
        "INPUT.MIN_SIZE_TEST", "64", "INPUT.MAX_SIZE_TEST", "96",
        "DATASETS.TRAIN", "('DET_train_30classes', 'VID_train_15frames')",
        "SOLVER.WARMUP_ITERS", "0", "SOLVER.BASE_LR", "0.001",
        "SOLVER.BATCH_REUSE_STEPS", "2", "SOLVER.ACCUMULATION_STEPS", "2",
        "SOLVER.TEST_PERIOD", "0", "MODEL.VID.MEGA.GLOBAL.SIZE", "2"]


def _write(root: Path, name: str, frames):
    """One catalog dataset under ``root``: per (path, (h, w), box) a JPEG
    with the box filled and its annotation; returns the paths."""
    img_dir, anno_dir, _ = DATASETS[name]
    for path, (h, w), box, label in frames:
        for d in (img_dir, anno_dir):
            (root / d / path).parent.mkdir(parents=True, exist_ok=True)
        img = np.full((h, w, 3), 40 + 7 * label, np.uint8)
        x1, y1, x2, y2 = box
        img[y1:y2, x1:x2] = (30 * label % 256, 200, 255 - 9 * label)
        cv2.imwrite(str(root / img_dir / f"{path}.JPEG"), img)
        ann = ET.Element("annotation")
        size = ET.SubElement(ann, "size")
        ET.SubElement(size, "height").text = str(h)
        ET.SubElement(size, "width").text = str(w)
        obj = ET.SubElement(ann, "object")
        ET.SubElement(obj, "name").text = VID_WNIDS[label]
        bb = ET.SubElement(obj, "bndbox")
        for k, v in zip(("xmin", "ymin", "xmax", "ymax"), box):
            ET.SubElement(bb, k).text = str(v)
        ET.ElementTree(ann).write(root / anno_dir / f"{path}.xml")


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("ilsvrc")
    stills = [(f"train/det_{i:04d}", (96, 64) if i in (1, 3) else (64, 96),
               (8 + i, 10, 40 + i, 50), 1 + i) for i in range(5)]
    _write(root, "DET_train_30classes", stills)
    vids = [(f"train/vid_{v:04d}/{f:06d}", (64, 96), (10 + 4 * f, 8 + v, 40 + 4 * f, 40), 3 + v)
            for v in range(2) for f in range(6)]
    _write(root, "VID_train_15frames", vids)
    val = [(f"val/vid_0000/{f:06d}", (64, 96), (20 + 3 * f, 12, 50 + 3 * f, 44), 4)
           for f in range(4)]
    _write(root, "VID_val_videos", val)
    index = {"DET_train_30classes": [f"{p} {i + 1}" for i, (p, *_) in enumerate(stills)],
             "VID_train_15frames": [f"train/vid_{v:04d} {6 * v + f + 1} {f} 6"
                                    for v in range(2) for f in range(6)],
             "VID_val_videos": [f"val/vid_0000 {f + 1} {f} 4" for f in range(4)]}
    for name, lines in index.items():
        path = root / DATASETS[name][2]
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text("\n".join(lines) + "\n")
    return root


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the tiny model's ops are too small to share, and
    with several test workers on the host, threads that wait for each
    other at every op slowed these runs many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def log_every_step(monkeypatch):
    monkeypatch.setattr(train_net, "LOG_PERIOD", 1)


def _run(tree, out, *extra, opts=()):
    return train_net.main(["--config-file", CONFIG, "--data-dir", str(tree), "--device", "cpu",
                           "--seed", "3", *extra, *TINY, "OUTPUT_DIR", str(out), *opts])


def _records(out: Path):
    """metrics.jsonl without its wall-clock fields."""
    lines = (out / "metrics.jsonl").read_text().splitlines()
    return [{k: v for k, v in json.loads(ln).items() if k not in ("time", "sec_per_iter")}
            for ln in lines]


def _params(path):
    return load_checkpoint(path)["model"]


def test_cli_files_and_bitexact_resume(tree, tmp_path, log_every_step):
    """0→4 straight against 0→2 then ``--resume`` to 4 (BATCH_REUSE_STEPS 2,
    ACCUMULATION_STEPS 2, validation at 4); before the resume a stale
    record of step 3 is appended, as a run that died after its checkpoint
    leaves it."""
    val = ["SOLVER.TEST_PERIOD", "4", "SOLVER.CHECKPOINT_PERIOD", "4"]
    a = _run(tree, tmp_path / "a", opts=[*val, "SOLVER.MAX_ITER", "4"])
    assert a["start_iter"] == 0 and a["max_iter"] == 4 and a["pretrained_tensors"] == 0
    assert all(np.isfinite(v) for v in a["metrics"].values()) and "total_loss" in a["metrics"]
    out = tmp_path / "a"
    for name in ("config.yml", "log.txt", "metrics.jsonl", "last_checkpoint",
                 "model_0000004.pth"):
        assert (out / name).exists(), name
    assert a["checkpoint"] == str(out / "model_0000004.pth")
    cfg = load_config(str(out / "config.yml"))
    assert cfg.SOLVER.MAX_ITER == 4 and cfg.SOLVER.BATCH_REUSE_STEPS == 2
    log = (out / "log.txt").read_text()
    assert "environment:" in log and "torch:" in log and "iter 4/4" in log
    recs = _records(out)
    assert [r["step"] for r in recs] == [1, 2, 3, 4, 4]
    assert {"Train/total_loss", "Val/mAP"} <= {k for r in recs for k in r}

    b = tmp_path / "b"
    _run(tree, b, opts=[*val, "SOLVER.MAX_ITER", "2"])
    with open(b / "metrics.jsonl", "a") as f:
        f.write(json.dumps({"step": 3, "time": 0.0, "Train/total_loss": -1.0}) + "\n")
    resumed = _run(tree, b, "--resume", opts=[*val, "SOLVER.MAX_ITER", "4"])
    assert resumed["start_iter"] == 2 and "resumed from" in (b / "log.txt").read_text()
    assert resumed["metrics"] == a["metrics"]
    assert _records(b) == recs
    want, got = _params(out / "model_0000004.pth"), _params(b / "model_0000004.pth")
    assert set(want) == set(got)
    for name, t in want.items():
        assert torch.equal(got[name], t), name
    assert not torch.equal(want["head.head_series.0.linear1.weight"],
                           _params(b / "model_0000002.pth")["head.head_series.0.linear1.weight"])
    shutil.rmtree(tmp_path)   # 3 checkpoints of 190 MB


def test_cli_equals_train_loop_on_the_same_batches(tree, tmp_path):
    """BATCH_REUSE_STEPS 1, without the prefetch thread: the CLI's
    parameters after 3 iterations are ``train_loop``'s on the batches its
    sampler makes, from the same model and optimizer."""
    opts = ["SOLVER.BATCH_REUSE_STEPS", "1", "SOLVER.MAX_ITER", "3"]
    out = _run(tree, tmp_path / "cli", "--no-prefetch", opts=opts)
    cfg = load_config(CONFIG, [*TINY, *opts])
    model = DiffusionDetArch.from_config(cfg, device="cpu", seed=3)
    ds = train_net.ConcatDataset([train_net.get_dataset(n, True, str(tree))
                                  for n in cfg.DATASETS.TRAIN])
    batch_iter = train_net.grouped_batches(train_net.aspect_ratio_group_ids(ds), 1, seed=0)
    sample_cfg = train_net.train_sample_config(cfg)
    batches = (train_net.collate(s, "cpu") for s in train_net.iteration_samples(
        train_net.sample_batches(ds, batch_iter, sample_cfg, 0, 1), 0, 3, 1, 1))
    metrics = train_loop(model, optimizer_from_config(model, cfg), batches,
                         num_global=sample_cfg.num_global, max_iter=3, seed=3, log_every=0)
    assert {k: float(v) for k, v in metrics.items()} == out["metrics"]
    got = _params(out["checkpoint"])
    for name, t in model.state_dict().items():
        assert torch.equal(got[name], t), name
    shutil.rmtree(tmp_path)


# ---------------------------------------------------------------- weight formats

def _reference_state():
    """Weights of the tiny config's model under another seed: what a file
    to load holds."""
    cfg = load_config(CONFIG, TINY)
    return DiffusionDetArch.from_config(cfg, device="cpu", seed=11).state_dict()


def _trunk(state):
    return {k[len("backbone.bottom_up."):]: v.numpy() for k, v in state.items()
            if k.startswith("backbone.bottom_up.")}


def _d2_to_tv(name: str) -> str:
    """A detectron2 trunk name → the torchvision-style one."""
    name = name.replace("stem.conv1.norm.", "bn1.").replace("stem.conv1.", "conv1.")
    if name.startswith("res"):
        stage, block, rest = name[3], *name[5:].split(".", 1)
        rest = (rest.replace("shortcut.norm.", "downsample_bn.")
                .replace("shortcut.", "downsample_conv."))
        for k in "123":
            rest = rest.replace(f"conv{k}.norm.", f"bn{k}.")
        name = f"layer{int(stage) - 1}.{block}.{rest}"
    return name


def _tv_to_c2(name: str):
    """A torchvision-style trunk name → the Caffe2 blob name (None for the
    running statistics, which Caffe2 does not store)."""
    leaf = name.rsplit(".", 1)[1]
    if leaf in ("running_mean", "running_var"):
        return None
    if name.startswith(("conv1.", "bn1.")):
        return "conv1_w" if name.startswith("conv1.") else f"conv1_bn_{'s' if leaf == 'weight' else 'b'}"
    layer, block, mod, _ = name.split(".")
    base = f"res{int(layer[5:]) + 1}_{block}_"
    if mod.startswith("downsample"):
        base += "branch1"
    else:
        base += "branch2" + "abc"[int(mod[-1]) - 1]
    if mod.endswith("conv") or mod.startswith("conv"):
        return base + "_w"
    return base + ("_bn_s" if leaf == "weight" else "_bn_b")


def _write_format(fmt: str, state, path: Path) -> Path:
    if fmt == "caffe2":
        tv = {_d2_to_tv(k): v for k, v in _trunk(state).items()}
        blobs = {_tv_to_c2(k): v for k, v in tv.items() if _tv_to_c2(k)}
        path = path.with_suffix(".pkl")
        with open(path, "wb") as f:
            pickle.dump(blobs, f)
        with open(path.with_name("blobs.pkl"), "wb") as f:   # as Caffe2 writes it
            pickle.dump({"blobs": blobs}, f)
    elif fmt == "detectron2":
        path = path.with_suffix(".pkl")
        with open(path, "wb") as f:
            pickle.dump({"model": _trunk(state), "__author__": "torchvision",
                         "matching_heuristics": True}, f)
    elif fmt == "torchvision":
        path = path.with_suffix(".pth")
        torch.save({_d2_to_tv(k): torch.from_numpy(v) for k, v in _trunk(state).items()}, path)
    else:
        path = path.with_suffix(".pth")
        prefix = "module." if fmt == "module" else ""
        torch.save({"model": {prefix + k: v for k, v in state.items()}}, path)
    return path


@pytest.mark.parametrize("fmt", ["caffe2", "detectron2", "torchvision", "full", "module"])
def test_pretrained_formats_load_as_jax_loads_them(tree, tmp_path, fmt):
    """``--pretrained`` copies, by name and value, the tensors the JAX
    package's loader copies into a tree of the same initial weights; the
    class head stays fresh.  The ``module.`` file loads as the bare one
    (the JAX loader copies nothing from it: ROADMAP.md §C)."""
    ref = _reference_state()
    path = _write_format(fmt, ref, tmp_path / "weights")
    args = train_net.parse_args(["--config-file", CONFIG, "--device", "cpu", "--seed", "3",
                                 "--pretrained", str(path), *TINY])
    cfg = load_config(CONFIG, args.opts)
    init = DiffusionDetArch.from_config(cfg, device="cpu", seed=3).state_dict()
    model, loaded = train_net.build_model(cfg, args, logging.getLogger("test"))
    got = model.state_dict()

    want_path = _write_format("full", ref, tmp_path / "bare") if fmt == "module" else path
    target = convert_torch_state_dict({k: v.numpy() for k, v in init.items()})["params"]
    merged, copied = jax_merge_pretrained(target, load_torch_checkpoint(str(want_path))["params"],
                                          skip_keys=("class_logits", "cls_score"))
    want = state_dict_from_jax(merged)
    assert loaded == copied and set(want) == set(got)
    trunk = [k for k in got if k.startswith("backbone.bottom_up.")]
    assert loaded >= len(trunk) - (2 * len(trunk) // 5 if fmt == "caffe2" else 0)
    for name, t in want.items():
        assert torch.equal(got[name], t), name
    for name, t in got.items():
        if "class_logits" in name:
            assert torch.equal(t, init[name]), name
        elif name in trunk and not name.endswith(("running_mean", "running_var")):
            assert torch.equal(t, ref[name]), name
    if fmt == "caffe2":   # identity statistics stand in for the ones Caffe2 folds in
        assert all(not got[k].any() for k in trunk if k.endswith("running_mean"))
        wrapped = load_pretrained(str(path.with_name("blobs.pkl")))
        assert wrapped.keys() == load_pretrained(str(path)).keys()


def test_torch_weights_with_module_prefix_load_bit_equal(tmp_path):
    """``--torch-weights`` of ``{"model": {"module." + k: v}}`` loads as the
    unprefixed file; a file that matches no tensor raises."""
    ref = _reference_state()
    loaded = []
    for fmt in ("full", "module"):
        args = test_net.parse_args(["--config-file", CONFIG, "--torch-weights",
                                    str(_write_format(fmt, ref, tmp_path / fmt))])
        model = DiffusionDetArch.from_config(load_config(CONFIG, TINY), device="cpu", seed=3)
        test_net.load_weights(model, args, logging.getLogger("test"))
        loaded.append(model.state_dict())
    for name, t in loaded[0].items():
        assert torch.equal(loaded[1][name], t) and torch.equal(t, ref[name]), name
    bad = tmp_path / "other.pth"
    torch.save({"model": {"net.layer.weight": torch.zeros(3)}}, bad)
    args = test_net.parse_args(["--config-file", CONFIG, "--torch-weights", str(bad)])
    model = DiffusionDetArch.from_config(load_config(CONFIG, TINY), device="cpu", seed=3)
    with pytest.raises(ValueError, match="no tensor matches"):
        test_net.load_weights(model, args, logging.getLogger("test"))


# ---------------------------------------------------------------- failures

@pytest.mark.parametrize("weight,match", [("/nonexistent/R-101.pkl", "/nonexistent/R-101.pkl"),
                                          ("catalog://ImageNetPretrained/MSRA/R-101", "--pretrained")])
def test_model_weight_not_on_disk_raises(tree, tmp_path, weight, match):
    with pytest.raises(FileNotFoundError, match=match):
        _run(tree, tmp_path, opts=["MODEL.WEIGHT", weight, "SOLVER.MAX_ITER", "1"])


def test_validation_aborts_on_the_second_failure(tree, tmp_path, monkeypatch):
    calls = []

    def broken(*args, **kw):
        calls.append(1)
        raise RuntimeError("val path broken")

    monkeypatch.setattr(train_net, "run_inference", broken)
    with pytest.raises(RuntimeError, match="val path broken"):
        _run(tree, tmp_path, "--no-prefetch",
             opts=["SOLVER.TEST_PERIOD", "1", "SOLVER.MAX_ITER", "3"])
    assert len(calls) == 2 and "periodic validation failed (1/2)" in (tmp_path / "log.txt").read_text()


def test_missing_val_set_warns_and_trains_on(tree, tmp_path):
    out = _run(tree, tmp_path, "--no-prefetch", opts=[
        "SOLVER.TEST_PERIOD", "1", "SOLVER.MAX_ITER", "1", "DATASETS.TEST", "('VID_val_frames',)"])
    assert out["checkpoint"] == str(tmp_path / "model_0000001.pth")
    assert "periodic validation skipped (no data)" in (tmp_path / "log.txt").read_text()
    shutil.rmtree(tmp_path)


def test_no_card_without_device_raises(tree, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_net.main(["--config-file", CONFIG, "--data-dir", str(tree), *TINY,
                        "OUTPUT_DIR", str(tmp_path)])
    assert not (tmp_path / "config.yml").exists()


def test_other_methods_are_refused(tmp_path):
    """What the train CLI does not run, ROADMAP.md A8.6: the still-image
    detectors' training, RetinaNet and the mask and keypoint heads (the MEGA
    family's six methods train: ``test_torch_port_train_cli_methods.py``; the
    test CLI runs the three: ``test_torch_port_still.py``)."""
    c4 = ["MODEL.META_ARCHITECTURE", "GeneralizedRCNN", "MODEL.VID.ENABLE", "True",
          "MODEL.VID.METHOD", "base"]
    for extra in (["MODEL.RETINANET_ON", "True"], ["MODEL.MASK_ON", "True"],
                  ["MODEL.KEYPOINT_ON", "True"]):
        with pytest.raises(NotImplementedError, match=r"ROADMAP\.md A8\.6"):
            train_net.main(["--config-file", CONFIG, "--device", "cpu", *c4, *extra,
                            "OUTPUT_DIR", str(tmp_path)])
    assert not (tmp_path / "config.yml").exists()
