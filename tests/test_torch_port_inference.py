"""Dataset evaluation through the port against the JAX package, and the
port's test CLIs.

``run_inference`` of both packages on the ``mini_vid`` fixture (2 videos of
6 frames at 160x240, resized to 64x96; 3 global frames, chunks of 4 with the
tail padded): the depth-18 model of ``test_torch_port_weights.py`` with the
weights carried by ``state_dict_from_jax``, the port's ``noise`` handed the
JAX package's draws (one ``split`` of the run's key a video, then
``start_video``'s chain).  The JAX side runs under ``jax.disable_jit()``
with its prefetch threads off (``os.cpu_count`` 1: its ``PrefetchIterator``
drops the end marker when the queue is full at the end, and the consumer
then waits for ever).  Frame by frame the boxes and scores agree within
1e-3 relative and the labels are equal, then the AP50s: at x1 with and
without seq-NMS, at x4 on one video (the renewal masks equal, mixed, and no
best score within 1e-4 of the threshold), and once with a Swin-T model.

The CLIs run in-process with ``--device cpu`` on a catalog layout of the
fixture: ``--checkpoint`` and ``--torch-weights`` give the same predictions;
the ``--torch-weights`` loader and the JAX package's ``load_torch_checkpoint``
+ ``merge_pretrained`` give the same parameters; two shards merge into the
single run's ``predictions.pkl``; ``test_prediction`` reproduces the AP50
and re-evaluates a JAX ``predictions.pkl`` to the JAX package's AP50;
without ``--device`` and with no card the CLI raises.  Last, uint8 frames
and their float32 values give identical detections.
"""

import os
import pickle
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from diffusionvid_tpu.data import SampleConfig as JaxSampleConfig
from diffusionvid_tpu.data import VIDDataset as JaxVID
from diffusionvid_tpu.engine import inference as jax_inference
from diffusionvid_tpu.utils import load_torch_checkpoint
from diffusionvid_tpu.utils import merge_pretrained as jax_merge_pretrained

from diffusionvid_torch.data import SampleConfig, VIDDataset
from diffusionvid_torch.engine import inference
from diffusionvid_torch.engine.streaming import StreamingDetector
from diffusionvid_torch.models.diffusion_det import DiffusionDetArch, ddim_times
from diffusionvid_torch.tools import test_net, test_prediction
from diffusionvid_torch.utils.checkpoint import save_checkpoint
from diffusionvid_torch.utils.convert import state_dict_from_jax
from test_data import mini_vid  # noqa: F401  (the shared fixture)
from test_torch_port_eval import make_case
from test_torch_port_stream import _JaxRecorder
from test_torch_port_stream_x4 import _renewal_agrees, spread
from test_torch_port_weights import (  # noqa: F401  (one_thread: the fixture)
    PROPS, jax_model_and_params, one_thread, port_model, rel_err)

ROOT = Path(__file__).resolve().parent.parent
SEED = 3
SCFG = dict(global_size=3, infer_batch=4, min_size=64, max_size=96)
RUN = dict(mem_size=16, num_proposals=PROPS, seed=SEED)


def jax_draws(videos: int, sample_step: int = 1, chunks: int = 2):
    """The JAX run's noise in call order: per video ``split(rng)``, then
    for its global chunk (3 frames, padded) the extract boxes; per chunk
    the extract boxes and, at xN, the starting signal and (noise, renewal)
    for each step but the last."""
    f = SCFG["infer_batch"]

    def normal(k):
        return np.asarray(jax.random.normal(k, (f, PROPS, 4)))

    rng, draws = jax.random.PRNGKey(SEED), []
    for _ in range(videos):
        rng, key = jax.random.split(rng)
        key, r = jax.random.split(key)
        draws.append(normal(r))
        for _ in range(chunks):
            key, r_extract, r_x, r_loop = jax.random.split(key, 4)
            draws.append(normal(r_extract))
            if sample_step > 1:
                draws.append(normal(r_x))
                for _, t_next in ddim_times(1000, sample_step):
                    r_loop, r_noise, r_renew = jax.random.split(r_loop, 3)
                    if t_next >= 0:
                        draws += [normal(r_noise), normal(r_renew)]
    return draws


def short_video(mini_vid, tmp_path):  # noqa: F811
    """The fixture's first video cut to 4 frames: the global chunk, then
    one chunk."""
    index = tmp_path / "short.txt"
    index.write_text("".join(f"val/vid_0000 {f + 1} {f} 4\n" for f in range(4)))
    return dict(mini_vid, index=str(index))


def _datasets(spec):
    args = ("test_set", spec["root"], spec["img_dir"], spec["anno_dir"], spec["index"])
    return VIDDataset(*args, is_train=False, use_cache=False), JaxVID(
        *args, is_train=False, use_cache=False)


def run_jax(jmodel, variables, ds, sample_step=1, max_videos=None, logits=None):
    """JAX's run_inference with seq-NMS: (predictions before seq-NMS, after
    it, AP50 without and with it)."""
    raw, inner = [], jax_inference.seq_nms_video
    model = _JaxRecorder(jmodel, logits) if logits is not None else jmodel
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(os, "cpu_count", lambda: 1)
        mp.setattr(jax_inference, "seq_nms_video", lambda p: raw.append(p) or inner(p))
        with jax.disable_jit():
            preds, gts, results = jax_inference.run_inference(
                model, variables, ds, JaxSampleConfig(**SCFG), sample_step=sample_step,
                use_seq_nms=True, max_videos=max_videos, **RUN)
    raw = [p for video in raw for p in video]
    return raw, preds, jax_inference.evaluate_vid(gts, raw)["ap50"], results["ap50"]


def run_port(model, ds, draws, sample_step=1, max_videos=None, use_seq_nms=False):
    """The port's run_inference with JAX's draws: (predictions, AP50)."""
    it = iter(draws)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(StreamingDetector, "noise",
                   lambda self, state, shape: torch.from_numpy(np.array(next(it))).reshape(shape))
        preds, _, results = inference.run_inference(
            model, ds, SampleConfig(**SCFG), sample_step=sample_step, use_seq_nms=use_seq_nms,
            max_videos=max_videos, **RUN)
    assert next(it, None) is None, "the port drew less noise than JAX"
    return preds, results["ap50"]


def predictions_agree(got, want, rtol=1e-3):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g["labels"], w["labels"], err_msg=f"frame {i}")
        assert len(w["scores"]) > 0, f"frame {i}: no detection"
        assert rel_err(g["scores"], w["scores"]) < rtol, f"frame {i} scores"
        assert rel_err(g["boxes"], w["boxes"]) < rtol, f"frame {i} boxes"


# ---------------------------------------------------------------- run_inference vs JAX

@pytest.fixture(scope="module")
def pair():
    return jax_model_and_params()


@pytest.fixture(scope="module")
def x1(mini_vid, pair):  # noqa: F811
    jmodel, variables = pair
    ds, jds = _datasets(mini_vid)
    jax_raw, jax_seq, jax_ap, jax_seq_ap = run_jax(jmodel, variables, jds)
    model = port_model(jmodel, variables)
    raw, ap = run_port(model, ds, jax_draws(2))
    seq, seq_ap = run_port(model, ds, jax_draws(2), use_seq_nms=True)
    return dict(ds=ds, jax=(jax_raw, jax_seq, jax_ap, jax_seq_ap), port=(raw, seq, ap, seq_ap))


@pytest.mark.parametrize("seq_nms", [False, True], ids=["x1", "x1_seq_nms"])
def test_run_inference_vs_jax(x1, seq_nms):
    jax_raw, jax_seq, jax_ap, jax_seq_ap = x1["jax"]
    raw, seq, ap, seq_ap = x1["port"]
    got, want = (seq, jax_seq) if seq_nms else (raw, jax_raw)
    assert len(got) == 12
    predictions_agree(got, want)
    assert (seq_ap if seq_nms else ap) == (jax_seq_ap if seq_nms else jax_ap)
    for p in got:   # original coordinates: the 160x240 frame, not 64x96
        assert p["boxes"][:, 0::2].max() <= 240 and p["boxes"][:, 1::2].max() <= 160
    assert max(p["boxes"][:, 2].max() for p in got) > 96
    if seq_nms:
        assert sum(map(len, (p["scores"] for p in seq))) < sum(
            map(len, (p["scores"] for p in raw)))


def test_run_inference_x4_vs_jax(mini_vid, pair, tmp_path):  # noqa: F811
    """One video of 4 frames at SAMPLE_STEP 4 with the x4 tests' spread
    model (the default renewal threshold 0.5 keeps some slots and renews
    others)."""
    jmodel, variables = spread(pair)
    ds, jds = _datasets(short_video(mini_vid, tmp_path))
    jlogits, logits = [], []
    jax_raw, _, jax_ap, _ = run_jax(jmodel, variables, jds, 4, logits=jlogits)
    model = port_model(jmodel, variables)
    inner = model.full_forward_test

    def recorded(*args):
        out = inner(*args)
        logits.append(out[0].numpy())
        return out

    model.full_forward_test = recorded
    preds, ap = run_port(model, ds, jax_draws(1, 4, chunks=1), sample_step=4)
    assert len(preds) == 4
    predictions_agree(preds, jax_raw)
    assert ap == jax_ap
    _renewal_agrees(jlogits, logits, 4, 0.5)


def test_run_inference_swin_t_vs_jax(mini_vid, tmp_path):  # noqa: F811
    """A Swin-T trunk (its plain versions) on one video of 4 frames."""
    jmodel, variables = jax_model_and_params(swin=True)
    ds, jds = _datasets(short_video(mini_vid, tmp_path))
    jax_raw, _, jax_ap, _ = run_jax(jmodel, variables, jds)
    preds, ap = run_port(port_model(jmodel, variables), ds, jax_draws(1, chunks=1))
    assert len(preds) == 4
    predictions_agree(preds, jax_raw)
    assert ap == jax_ap


def test_uint8_and_float_frames_give_identical_detections(pair):
    model = port_model(*pair)
    rng = np.random.RandomState(2)
    frames = rng.randint(0, 256, (3, 2, 64, 96, 3)).astype(np.uint8)
    whwh = np.asarray([96, 64, 96, 64], np.float32)
    outs = []
    for dtype in (np.uint8, np.float32):
        det = StreamingDetector(model, infer_batch=2, mem_size=16, mem_dis_size=8,
                                num_proposals=PROPS, detections_per_img=PROPS)
        gen = torch.Generator().manual_seed(0)
        det.noise = lambda state, shape: torch.randn(shape, generator=gen)
        state = det.start_video(0, frames[0].astype(dtype), whwh)
        outs.append([det.process_chunk(state, c.astype(dtype), whwh)[1] for c in frames[1:]])
    for a, b in zip(*outs):
        for x, y in zip(a, b):
            assert torch.equal(x, y)


# ---------------------------------------------------------------- the CLIs

OPTS = ["MODEL.RESNETS.DEPTH", "18", "MODEL.DiffusionDet.NUM_PROPOSALS", "16",
        "MODEL.DiffusionDet.NUM_CLASSES", "5", "INPUT.MIN_SIZE_TEST", "64",
        "INPUT.MAX_SIZE_TEST", "96", "INPUT.INFER_BATCH", "4", "MODEL.VID.MEGA.GLOBAL.SIZE",
        "3", "MODEL.VID.MEGA.MEMORY_MANAGEMENT_SIZE_TEST", "16"]
CONFIG = str(ROOT / "configs" / "vid_R_50_tiny_synthetic.yaml")


@pytest.fixture(scope="module")
def catalog_vid(mini_vid, tmp_path_factory):  # noqa: F811
    """The fixture under the catalog's ``VID_val_videos`` paths."""
    from diffusionvid_torch.data.catalog import DATASETS
    root = tmp_path_factory.mktemp("catalog")
    img, anno, index = DATASETS["VID_val_videos"]
    shutil.copytree(mini_vid["img_dir"], root / img)
    shutil.copytree(mini_vid["anno_dir"], root / anno)
    (root / index).parent.mkdir(parents=True)
    shutil.copy(mini_vid["index"], root / index)
    return root


def cli(data, out, *args):
    return test_net.main(["--config-file", CONFIG, "--data-dir", str(data), "--output-dir",
                          str(out), "--device", "cpu", *args, *OPTS])


def load(path):
    with open(path, "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """A model of the CLI's architecture with weights from seed 11, saved
    as the port's checkpoint and as a reference ``.pth``."""
    from diffusionvid_torch.config import load_config
    out = tmp_path_factory.mktemp("weights")
    model = DiffusionDetArch.from_config(load_config(CONFIG, OPTS), device="cpu", seed=11)
    state = model.state_dict()
    ckpt = save_checkpoint(str(out), 5, state)
    torch.save({"model": state, "iteration": 5}, out / "reference.pth")
    return ckpt, str(out / "reference.pth"), state


@pytest.fixture(scope="module")
def single_run(catalog_vid, weights, tmp_path_factory):
    out = tmp_path_factory.mktemp("single")
    results = cli(catalog_vid, out, "--checkpoint", weights[0])
    return out, results


def test_cli_checkpoint_and_torch_weights_agree(catalog_vid, weights, single_run, tmp_path):
    out, results = single_run
    again = cli(catalog_vid, tmp_path, "--torch-weights", weights[1])
    a, b = load(out / "predictions.pkl"), load(tmp_path / "predictions.pkl")
    assert len(a) == 12
    for x, y in zip(a, b):
        for k in ("boxes", "scores", "labels"):
            np.testing.assert_array_equal(x[k], y[k])
    assert again["ap50"] == results["ap50"]
    assert (out / "result.txt").exists() and "FINAL AP50" in (out / "log.txt").read_text()
    cli(catalog_vid, tmp_path / "random")   # the random weights under the checkpoint
    assert any(len(x["scores"]) != len(y["scores"]) or not np.array_equal(x["scores"], y["scores"])
               for x, y in zip(a, load(tmp_path / "random" / "predictions.pkl")))


def test_torch_weights_load_as_jax_loads_them(pair, tmp_path):
    """A reference-format ``.pth`` (the pair's weights, perturbed): the
    port's ``--torch-weights`` loader and the JAX package's
    ``load_torch_checkpoint`` + ``merge_pretrained`` (``skip_keys=()``) give
    the same parameters."""
    jmodel, variables = pair
    gen = torch.Generator().manual_seed(1)
    ref = {k: v + torch.randn(v.shape, generator=gen) if v.is_floating_point() else v
           for k, v in state_dict_from_jax(variables["params"]).items()}
    path = tmp_path / "reference.pth"
    torch.save({"model": ref}, path)
    model = port_model(jmodel, variables)
    args = test_net.parse_args(["--config-file", CONFIG, "--torch-weights", str(path)])
    test_net.load_weights(model, args, test_net.setup_logger())
    merged, copied = jax_merge_pretrained(variables["params"],
                                          load_torch_checkpoint(str(path))["params"],
                                          skip_keys=())
    want = state_dict_from_jax(merged)
    got = model.state_dict()
    assert copied > 100 and set(want) == set(got)
    for name, t in want.items():
        assert torch.equal(got[name], t), name
        assert torch.equal(got[name], ref[name]), name


def test_cli_shards_merge_into_the_single_run(catalog_vid, weights, single_run, tmp_path):
    out, results = single_run
    assert cli(catalog_vid, tmp_path, "--checkpoint", weights[0], "--num-shards", "2",
               "--shard", "1") is None   # shard 0 is still missing
    merged = cli(catalog_vid, tmp_path, "--checkpoint", weights[0], "--num-shards", "2",
                 "--shard", "0")
    assert merged["ap50"] == results["ap50"]
    a, b = load(out / "predictions.pkl"), load(tmp_path / "predictions.pkl")
    assert len(a) == len(b) == 12
    for x, y in zip(a, b):
        for k in ("boxes", "scores", "labels"):
            np.testing.assert_array_equal(x[k], y[k])


def test_test_prediction_reevaluates(catalog_vid, single_run, tmp_path):
    out, results = single_run
    base = ["--config-file", CONFIG, "--data-dir", str(catalog_vid)]
    got = test_prediction.main(base + ["--predictions", str(out / "predictions.pkl")])
    assert got["ap50"] == results["ap50"]
    # a predictions.pkl written by the JAX package, with hits on the GT
    _, preds, _ = make_case(0, frames=12)
    jds = JaxVID("VID_val_videos", str(catalog_vid), str(catalog_vid / "x"), str(
        catalog_vid / "ILSVRC2015/Annotations/VID"), str(
        catalog_vid / "ILSVRC2015/ImageSets/VID_val_videos.txt"), is_train=False,
        use_cache=False)
    for p, a in zip(preds, jds.annos):   # hits on this dataset's GT
        p["boxes"][: len(a.boxes)] = a.boxes[: len(p["boxes"])]
        p["labels"][: len(a.boxes)] = a.labels[: len(p["boxes"])]
    jax_inference.save_predictions(str(tmp_path), preds, None, 0, 1)
    want = jax_inference.inference_no_model(str(tmp_path / "predictions.pkl"), jds)
    got = test_prediction.main(base + ["--predictions", str(tmp_path / "predictions.pkl")])
    assert 0 < want["ap50"] and abs(got["ap50"] - want["ap50"]) < 1e-12


def test_cli_without_a_card_raises(catalog_vid, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        test_net.main(["--config-file", CONFIG, "--data-dir", str(catalog_vid),
                       "--output-dir", str(tmp_path), *OPTS])
    assert not (tmp_path / "predictions.pkl").exists()


def test_cli_refuses_unported_methods(catalog_vid, tmp_path):
    """RetinaNet (A8) and a still-image dataset (A11) raise before any
    model runs; DFF, which this test refused before, runs in
    ``test_torch_port_flow.py``."""
    with pytest.raises(NotImplementedError, match="A8"):
        cli(catalog_vid, tmp_path, "MODEL.META_ARCHITECTURE", "GeneralizedRCNN",
            "MODEL.VID.ENABLE", "True", "MODEL.VID.METHOD", "dff", "MODEL.RETINANET_ON", "True")
    with pytest.raises(NotImplementedError, match="A11"):
        cli(catalog_vid, tmp_path, "DATASETS.TEST", "('coco_2017_val',)")
    assert not (tmp_path / "predictions.pkl").exists()
