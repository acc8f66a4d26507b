"""The port's train CLI on the MEGA family, on the CPU: the shipped
``base``, RDN and DAFA configs cut to depth 18 and 64x96 frames
(``C4_TINY``), over the ILSVRC-layout tree of
``test_torch_port_train_cli.py``.

What it holds: each method trains (finite losses under the JAX package's
names, the checkpoint, the log); the CLI equals ``train_loop`` with the
method's loss and draws on the batches its sampler makes, bit for bit; a
DAFA run resumed from its own iteration-2 checkpoint ends bit-equal to the
uninterrupted run (BATCH_REUSE_STEPS 2: the reuse swap draws a global
frame); ``MODEL.WEIGHT`` a detectron2 trunk ``.pkl`` loads into ``base``
and DAFA the tensors the JAX package's loader copies into the same tree,
count for count, and is refused for RDN, into whose tree the JAX loader
copies none (its trunk nests under ``detector``: ROADMAP.md §C 5).
"""

import logging
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from diffusionvid_tpu.config import load_config as jax_load_config
from diffusionvid_tpu.models.detectors import build_detection_model as jax_build
from diffusionvid_tpu.utils import load_torch_checkpoint
from diffusionvid_tpu.utils import merge_pretrained as jax_merge_pretrained

from diffusionvid_torch.config import load_config
from diffusionvid_torch.engine.train import optimizer_from_config, train_loop
from diffusionvid_torch.engine.train_methods import draw_method_randoms, make_method_loss_fn
from diffusionvid_torch.models.detectors import build_detection_model
from diffusionvid_torch.tools import train_net
from diffusionvid_torch.utils.checkpoint import load_checkpoint
from test_torch_port_train_cli import _params, _write_format, one_thread, tree  # noqa: F401
from test_torch_port_train_methods import jax_tree_like, method_inputs

ROOT = Path(__file__).resolve().parent.parent
CONFIGS = {"base": "vid_R_101_C4_1x.yaml", "rdn": "RDN/vid_R_101_C4_RDN_base_1x.yaml",
           "dafa": "MEGA/vid_R_101_C4_DAFA_1x.yaml"}
C4_TINY = ["MODEL.RESNETS.DEPTH", "18", "MODEL.WEIGHT", "''", "TPU.COMPUTE_DTYPE", "float32",
           "MODEL.RPN.PRE_NMS_TOP_N_TRAIN", "100", "MODEL.RPN.POST_NMS_TOP_N_TRAIN", "80",
           "MODEL.RPN.PRE_NMS_TOP_N_TEST", "100", "MODEL.RPN.POST_NMS_TOP_N_TEST", "8",
           "MODEL.VID.RPN.REF_POST_NMS_TOP_N", "4", "MODEL.DiffusionDet.NUM_PROPOSALS", "16",
           "MODEL.VID.MEGA.REF_NUM_GLOBAL", "2", "MODEL.VID.MEGA.GLOBAL.SIZE", "2",
           "MODEL.VID.MEGA.MEMORY_MANAGEMENT_SIZE_TEST", "64",
           "INPUT.MIN_SIZE_TRAIN", "(64,)", "INPUT.MAX_SIZE_TRAIN", "96",
           "INPUT.MIN_SIZE_TEST", "64", "INPUT.MAX_SIZE_TEST", "96",
           "DATASETS.TRAIN", "('DET_train_30classes', 'VID_train_15frames')",
           "DATASETS.TEST", "('VID_val_videos',)", "SOLVER.WARMUP_ITERS", "0",
           "SOLVER.TEST_PERIOD", "0", "SOLVER.CHECKPOINT_PERIOD", "100"]
LOSSES = {"base": {"loss_objectness", "loss_rpn_box_reg", "loss_classifier", "loss_box_reg"},
          "rdn": {"loss_objectness", "loss_rpn_box_reg", "loss_classifier", "loss_box_reg"},
          "dafa": {"loss_ce", "loss_bbox", "loss_giou"}}


def _config(method: str) -> str:
    return str(ROOT / "configs" / CONFIGS[method])


def _run(tree, method, out, *extra, opts=()):
    return train_net.main(["--config-file", _config(method), "--data-dir", str(tree),
                           "--device", "cpu", "--seed", "3", *extra, *C4_TINY,
                           "OUTPUT_DIR", str(out), *opts])


@pytest.mark.parametrize("method", ["base", "rdn", "dafa"])
def test_cli_trains_the_method(tree, tmp_path, method):
    """One iteration, then validation through ``run_inference_video_arch``."""
    out = _run(tree, method, tmp_path, opts=["SOLVER.MAX_ITER", "1", "SOLVER.TEST_PERIOD", "1"])
    assert out["start_iter"] == 0 and out["max_iter"] == 1
    assert LOSSES[method] <= set(out["metrics"]) and "total_loss" in out["metrics"]
    assert all(np.isfinite(v) for v in out["metrics"].values())
    assert out["checkpoint"] == str(tmp_path / "model_0000001.pth")
    log = (tmp_path / "log.txt").read_text()
    assert "trained iterations 0..1" in log and "periodic validation" not in log
    shutil.rmtree(tmp_path)


def test_cli_equals_train_loop_on_the_same_batches(tree, tmp_path):
    """RDN, without the prefetch thread: the CLI's parameters after an
    iteration are ``train_loop``'s with ``make_method_loss_fn`` and
    ``draw_method_randoms`` on the batches its sampler makes, from the same
    model and optimizer."""
    opts = ["SOLVER.MAX_ITER", "1"]
    out = _run(tree, "rdn", tmp_path / "cli", "--no-prefetch", opts=opts)
    cfg = load_config(_config("rdn"), [*C4_TINY, *opts])
    model = build_detection_model(cfg, device="cpu", seed=3)
    spec = train_net.method_spec(cfg)
    ds = train_net.ConcatDataset([train_net.get_dataset(n, True, str(tree))
                                  for n in cfg.DATASETS.TRAIN])
    batch_iter = train_net.grouped_batches(train_net.aspect_ratio_group_ids(ds), 1, seed=0)
    sample_cfg = train_net.train_sample_config(cfg)
    batches = (train_net.collate(s, "cpu") for s in train_net.iteration_samples(
        train_net.sample_batches(ds, batch_iter, sample_cfg, 0, 1, spec=spec), 0, 1, 1, 1))
    metrics = train_loop(model, optimizer_from_config(model, cfg), batches, max_iter=1,
                         seed=3, log_every=0, loss_fn=make_method_loss_fn(model, spec),
                         draw=draw_method_randoms)
    assert {k: float(v) for k, v in metrics.items()} == out["metrics"]
    got = _params(out["checkpoint"])
    for name, t in model.state_dict().items():
        assert torch.equal(got[name], t), name
    shutil.rmtree(tmp_path)


def test_dafa_resumed_inside_the_run_is_bitexact(tree, tmp_path):
    """0→4 with a checkpoint at 2 (BATCH_REUSE_STEPS 2: iterations 1 and 3
    retrain their batch with a global frame swapped in), against a second
    directory resumed from that checkpoint to 4: the same parameters and
    the same last metrics."""
    opts = ["SOLVER.MAX_ITER", "4", "SOLVER.CHECKPOINT_PERIOD", "2",
            "SOLVER.BATCH_REUSE_STEPS", "2"]
    a, b = tmp_path / "a", tmp_path / "b"
    full = _run(tree, "dafa", a, opts=opts)
    want = _params(a / "model_0000004.pth")
    b.mkdir()       # a DAFA checkpoint with its SGD state is about 0.5 GB: move, drop
    ckpt = b / "model_0000002.pth"
    shutil.move(a / ckpt.name, ckpt)
    shutil.rmtree(a)
    (b / "last_checkpoint").write_text(str(ckpt))
    start = load_checkpoint(str(ckpt))["model"]["heads.0.linear1.weight"]
    resumed = _run(tree, "dafa", b, "--resume", opts=opts)
    assert resumed["start_iter"] == 2 and resumed["metrics"] == full["metrics"]
    got = _params(b / "model_0000004.pth")
    shutil.rmtree(tmp_path)
    assert set(want) == set(got)
    for name, t in want.items():
        assert torch.equal(got[name], t), name
    assert not torch.equal(want["heads.0.linear1.weight"], start)


@pytest.mark.parametrize("method", ["base", "dafa", "rdn"])
def test_model_weight_loads_as_jax_loads_it(tree, tmp_path, method):
    """A detectron2-style trunk ``.pkl`` (the R-18 trunk of a seeded
    ``base`` model) as ``MODEL.WEIGHT``: the port copies the tensors the JAX
    package's ``merge_pretrained`` copies into the same tree, count for
    count; for RDN the JAX loader copies none and the port refuses the
    file, naming ROADMAP.md §C 5."""
    state = build_detection_model(load_config(_config("base"), C4_TINY), device="cpu",
                                  seed=11).state_dict()
    trunk = {k: v for k, v in state.items() if k.startswith("backbone.bottom_up.")}
    path = _write_format("detectron2", state, tmp_path / "trunk")
    opts = [*C4_TINY, "MODEL.WEIGHT", str(path)]
    cfg = load_config(_config(method), opts)
    args = train_net.parse_args(["--config-file", _config(method), "--device", "cpu",
                                 "--seed", "3", *opts])
    init = build_detection_model(cfg, device="cpu", seed=3)
    jmodel = jax_build(jax_load_config(_config(method), opts))
    target = jax_tree_like(method, jmodel, method_inputs(method), init.state_dict())
    _, copied = jax_merge_pretrained(target, load_torch_checkpoint(str(path))["params"],
                                     skip_keys=("class_logits", "cls_score"))
    if method == "rdn":
        assert copied == 0
        with pytest.raises(ValueError, match="§C 5"):
            train_net.build_model(cfg, args, logging.getLogger("test"))
        return
    assert init.state_dict().keys() >= trunk.keys()
    model, loaded = train_net.build_model(cfg, args, logging.getLogger("test"))
    assert loaded == copied == len(trunk)
    got = model.state_dict()
    for k, v in trunk.items():
        assert torch.equal(got[k], v), k
    shutil.rmtree(tmp_path)

