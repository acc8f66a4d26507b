"""The MEGA family's dataset evaluation through the port against the JAX
package, and the port's test CLI running the four methods.

``run_inference_video_arch`` of both packages on the ``mini_vid`` fixture
(2 videos of 6 frames at 160x240, resized to 64x96; 3 global frames) with
the depth-18 models of ``test_torch_port_rcnn.py`` and the weights carried
by ``state_dict_from_jax``: ``base`` and ``dafa`` over both videos, ``rdn``
(with RDN's advanced stage) and ``mega`` over the first; MEGA with the
stage rings and with ``SHUFFLED_CUR_TEST`` over the first video cut to 4
frames.  Frame by
frame the labels and the number of detections are equal, the scores and
boxes agree within 1e-3 relative (the diffusion path's tolerance,
``test_torch_port_inference.py``: a frame's values pass through memories
that earlier frames filled), and the AP50s are equal.

The CLI runs in-process with ``--device cpu`` on a catalog layout of the
fixture: a JAX package checkpoint (its pickle form) by ``--checkpoint``
gives the JAX run's predictions, and ``--torch-weights`` copies what the
JAX package's ``merge_pretrained`` copies into each method's model from
the same file, count for count.
"""

import pickle
from pathlib import Path

import numpy as np
import pytest
import torch

from diffusionvid_tpu.data import SampleConfig as JaxSampleConfig
from diffusionvid_tpu.data import VIDDataset as JaxVID
from diffusionvid_tpu.engine import inference_mega as jax_inference_mega
from diffusionvid_tpu.models.dafa import SparseRCNNDAFA as JaxDAFA
from diffusionvid_tpu.utils import checkpoint as jax_checkpoint
from diffusionvid_tpu.utils import load_torch_checkpoint
from diffusionvid_tpu.utils import merge_pretrained as jax_merge_pretrained

from diffusionvid_torch.data import SampleConfig, VIDDataset
from diffusionvid_torch.engine.inference_mega import run_inference_video_arch
from diffusionvid_torch.models.diffusion_det import DiffusionDetArch
from diffusionvid_torch.tools import test_net
from diffusionvid_torch.utils.convert import load_weights_into
from test_data import mini_vid  # noqa: F401  (the shared fixture)
from test_torch_port_inference import catalog_vid, short_video  # noqa: F401
from test_torch_port_rcnn import (  # noqa: F401  (one_thread: the fixture)
    DAFA, JAX_MODELS, PARAMS_OF, dafa_params, jax_rcnn_params, one_thread, port_of,
    rcnn_params, rel_err)

ROOT = Path(__file__).resolve().parent.parent
SEED = 0   # the CLI's: its DAFA run shares the fixture run's global frames
SCFG = dict(global_size=3, infer_batch=4, min_size=64, max_size=96)
RTOL = 1e-3


def _datasets(spec):
    args = ("test_set", spec["root"], spec["img_dir"], spec["anno_dir"], spec["index"])
    return VIDDataset(*args, is_train=False, use_cache=False), JaxVID(
        *args, is_train=False, use_cache=False)


def _jax_model(kind):
    return JaxDAFA(**DAFA, res_stage=2) if kind == "dafa" else JAX_MODELS[kind]()


def predictions_agree(got, want, what):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g["labels"], w["labels"], err_msg=f"{what} frame {i}")
        if len(w["scores"]):
            assert rel_err(g["scores"], w["scores"]) < RTOL, f"{what} frame {i} scores"
            assert rel_err(g["boxes"], w["boxes"]) < RTOL, f"{what} frame {i} boxes"
    assert sum(len(w["scores"]) for w in want) > 0, f"{what}: no detection"


def run_jax(kind, method, tree, spec, **kw):
    """The JAX package's run_inference_video_arch: (predictions, AP50)."""
    _, jds = _datasets(spec)
    preds, _, res = jax_inference_mega.run_inference_video_arch(
        _jax_model(kind), {"params": tree}, jds, JaxSampleConfig(**SCFG), method=method,
        seed=SEED, **kw)
    return preds, res["ap50"]


def run_port(kind, method, tree, spec, **kw):
    ds, _ = _datasets(spec)
    preds, _, res = run_inference_video_arch(port_of(kind, tree), ds, SampleConfig(**SCFG),
                                             method=method, seed=SEED, **kw)
    return preds, res["ap50"]


@pytest.fixture(scope="module")
def jax_dafa_run(mini_vid, dafa_params):  # noqa: F811
    return run_jax("dafa", "dafa", dafa_params, mini_vid)


@pytest.mark.parametrize("kind, method, videos", [
    ("base", "base", 2), ("rdn_adv", "rdn", 1), ("mega3", "mega", 1), ("dafa", "dafa", 2)],
    ids=["base", "rdn", "mega", "dafa"])
def test_run_inference_video_arch_vs_jax(mini_vid, rcnn_params, dafa_params,  # noqa: F811
                                         jax_dafa_run, kind, method, videos):
    """``base`` and ``dafa`` over both videos, RDN and MEGA (their 5-frame
    windows cost most here) over the first."""
    tree = dafa_params if kind == "dafa" else rcnn_params[kind]
    kw = {} if videos == 2 else {"max_videos": 1}
    jpreds, jap = jax_dafa_run if kind == "dafa" else run_jax(kind, method, tree, mini_vid, **kw)
    preds, ap = run_port(kind, method, tree, mini_vid, **kw)
    assert len(preds) == 6 * videos
    predictions_agree(preds, jpreds, method)
    assert ap == jap
    for p in preds:   # original coordinates: the 160x240 frame, not 64x96
        assert p["boxes"][:, 0::2].max(initial=0) <= 240
        assert p["boxes"][:, 1::2].max(initial=0) <= 160
        assert (p["scores"] > 0.05).all()


@pytest.mark.parametrize("kind, shuffled", [("mega3_mem", False), ("mega3", True)],
                         ids=["stage_rings", "shuffled_cur"])
def test_run_inference_mega_variants_vs_jax(mini_vid, rcnn_params, tmp_path,  # noqa: F811
                                            kind, shuffled):
    tree = rcnn_params[PARAMS_OF.get(kind, kind)]
    spec = short_video(mini_vid, tmp_path)
    jpreds, jap = run_jax(kind, "mega", tree, spec, shuffled_cur=shuffled)
    preds, ap = run_port(kind, "mega", tree, spec, shuffled_cur=shuffled)
    assert len(preds) == 4
    predictions_agree(preds, jpreds, kind)
    assert ap == jap


# ---------------------------------------------------------------- the CLI

DAFA_CONFIG = str(ROOT / "configs" / "MEGA" / "vid_R_101_C4_DAFA_1x.yaml")
DAFA_OPTS = ["MODEL.RESNETS.DEPTH", "18", "MODEL.DiffusionDet.NUM_PROPOSALS", "16",
             "MODEL.DiffusionDet.NUM_CLASSES", "5", "INPUT.MIN_SIZE_TEST", "64",
             "INPUT.MAX_SIZE_TEST", "96", "INPUT.INFER_BATCH", "4",
             "MODEL.VID.MEGA.GLOBAL.SIZE", "3", "MODEL.VID.MEGA.GLOBAL.RES_STAGE", "2",
             "MODEL.VID.MEGA.MEMORY_MANAGEMENT_SIZE_TEST", "16", "TPU.COMPUTE_DTYPE",
             "float32", "MODEL.WEIGHT", "''"]


def test_cli_runs_dafa_from_a_jax_checkpoint(catalog_vid, dafa_params, jax_dafa_run,  # noqa: F811
                                             tmp_path, monkeypatch):
    """The JAX package's checkpoint writer (its pickle form, as without
    orbax) → ``--checkpoint`` → the predictions of the JAX package's
    ``run_inference_video_arch`` on the same weights (seed 0, the CLI's,
    draws the same global frames; the CLI's DAFA keeps its top 75 of 16
    proposals, the fixture's model its top 16)."""
    monkeypatch.setattr(jax_checkpoint, "_HAS_ORBAX", False)
    ckpt = jax_checkpoint.save_checkpoint(str(tmp_path / "jax"), 7, dafa_params)
    out = tmp_path / "out"
    results = test_net.main(["--config-file", DAFA_CONFIG, "--data-dir", str(catalog_vid),
                             "--output-dir", str(out), "--device", "cpu", "--checkpoint",
                             ckpt, *DAFA_OPTS])
    with open(out / "predictions.pkl", "rb") as f:
        preds = pickle.load(f)
    jpreds, jap = jax_dafa_run
    assert len(preds) == 12
    predictions_agree(preds, jpreds, "CLI dafa")
    assert results["ap50"] == jap
    assert (out / "result.txt").exists() and "FINAL AP50" in (out / "log.txt").read_text()
    with pytest.raises(ValueError, match="orbax"):
        test_net.main(["--config-file", DAFA_CONFIG, "--data-dir", str(catalog_vid),
                       "--output-dir", str(out), "--device", "cpu", "--checkpoint",
                       str(tmp_path), *DAFA_OPTS])


@pytest.fixture(scope="module")
def reference_pth(tmp_path_factory):
    """A reference-format ``.pth`` of a depth-18 DiffusionVID model (the
    detectron2 trunk + FPN + decoder names)."""
    model = DiffusionDetArch(depth=18, num_classes=5, num_proposals=16)
    model.reset_parameters(torch.Generator().manual_seed(5))
    path = tmp_path_factory.mktemp("ref") / "diffusionvid.pth"
    torch.save({"model": model.state_dict()}, path)
    return str(path)


@pytest.mark.parametrize("kind", ["base", "rdn_adv", "mega3", "dafa"])
def test_torch_weights_copy_what_jax_copies(rcnn_params, dafa_params, reference_pth, kind):
    """The JAX package nests RDN's and MEGA's trunk under ``detector``, so
    its ``merge_pretrained`` copies no tensor of a reference file into them;
    the port's names nest the same way, so it copies none either, and
    refuses the file (a load that matches nothing raises)."""
    tree = dafa_params if kind == "dafa" else rcnn_params[kind]
    _, copied = jax_merge_pretrained(tree, load_torch_checkpoint(reference_pth)["params"],
                                     skip_keys=())
    model = port_of(kind, tree)
    if kind in ("rdn_adv", "mega3"):
        assert copied == 0
        with pytest.raises(ValueError, match="no tensor matches"):
            load_weights_into(model, reference_pth)
        return
    assert copied > 50
    assert load_weights_into(model, reference_pth) == copied
    ref = torch.load(reference_pth)["model"]
    state = model.state_dict()
    assert torch.equal(state["backbone.bottom_up.res4.1.conv3.weight"],
                       ref["backbone.bottom_up.res4.1.conv3.weight"])
    if kind == "dafa":
        assert torch.equal(state["backbone.fpn_output3.weight"],
                           ref["backbone.fpn_output3.weight"])


def test_cli_refuses_what_is_not_ported(catalog_vid, tmp_path):  # noqa: F811
    """The mask head (A8) and, as the JAX package's engine does,
    ``TEST.BBOX_AUG`` on a method other than ``base``."""
    for opts, err, what in ((["MODEL.MASK_ON", "True"], NotImplementedError, r"ROADMAP\.md A8"),
                            (["TEST.BBOX_AUG.ENABLED", "True"], ValueError,
                             "only implemented for METHOD 'base'")):
        with pytest.raises(err, match=what):
            test_net.main(["--config-file", DAFA_CONFIG, "--data-dir", str(catalog_vid),
                           "--output-dir", str(tmp_path), "--device", "cpu", *DAFA_OPTS,
                           *opts])
    assert not (tmp_path / "predictions.pkl").exists()


def test_jax_checkpoint_path_forms(dafa_params, tmp_path, monkeypatch):
    """``--checkpoint`` takes the pickle's path with or without ``.pkl``."""
    from diffusionvid_torch.utils.convert import load_jax_checkpoint, state_dict_from_jax
    monkeypatch.setattr(jax_checkpoint, "_HAS_ORBAX", False)
    path = jax_checkpoint.save_checkpoint(str(tmp_path), 3, dafa_params)
    want = state_dict_from_jax(dafa_params)
    for p in (path, path + ".pkl"):
        got = load_jax_checkpoint(p)
        assert set(got) == set(want)
        assert all(torch.equal(got[k], want[k]) for k in want)
    assert load_jax_checkpoint(str(tmp_path / "model_0000009")) is None
