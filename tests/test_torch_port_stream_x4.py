"""The xN DDIM ensemble (SAMPLE_STEP 2 and 4) against the JAX package.

``predict_noise_from_start``, ``DiffusionDetArch.full_forward_test`` and
``postprocess_ensemble`` each against their JAX counterparts, then whole
streams against the JAX ``StreamingDetector(sample_step=S)`` frame by frame:
a depth-18 model with a conditioned stage (S = 4 and 2), plain DiffusionDet
(NUM_HEADS_LOCAL 0) with GLOBAL.ENABLE on and off, and a Swin-T model, all
with 16 proposals on 64x96 frames, 3 global frames then chunks of 2.  The
weights are carried with ``state_dict_from_jax``; the port's noise method is
handed the JAX package's own draws, recomputed from its key splits; the JAX
side runs under ``jax.disable_jit()``.  Boxes and scores agree to < 1e-3
relative, labels and NMS keep masks are equal.

The renewal threshold is chosen so that some step keeps some slots and
renews others (with random weights the class scores sit near the 0.01
prior, so the default 0.5 would renew every slot), and no slot's best score
lies within 1e-4 of it in a step that renews, so that a rounding difference
cannot flip a slot between the two implementations.  To leave room for
such a threshold, the conditioned model's class projections are scaled by
``SPREAD``: its best scores then spread over about 0.002-0.97 instead of
0.008-0.014.  The other models' spread enough as they are.  Both sides'
renewal masks are recomputed from the logits each step returns, and must be
equal.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from diffusionvid_tpu.engine.postprocess import postprocess_ensemble as jax_ensemble
from diffusionvid_tpu.models.diffusion_det import (
    DiffusionDetArch as JaxArch, make_schedule as jax_schedule,
    predict_noise_from_start as jax_noise_from_start,
)

from diffusionvid_torch.engine.postprocess import postprocess_ensemble
from diffusionvid_torch.models.diffusion_det import make_schedule, predict_noise_from_start
from test_torch_port_stream import _frames_agree, run_both
from test_torch_port_weights import (  # noqa: F401  (one_thread: the fixture)
    H, PROPS, W, jax_model_and_params, one_thread, port_model, rel_err)

MARGIN = 1e-4
SPREAD = 20.0


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-np.asarray(x, np.float64)))


def spread(pair):
    """The model with every stage's class projection scaled by SPREAD."""
    jmodel, variables = pair

    def f(path, a):
        return a * np.float32(SPREAD) if "class_logits_weight" in str(path[-1]) else a

    return jmodel, {**variables, "params": jax.tree_util.tree_map_with_path(
        f, variables["params"])}


def run_x(jmodel, variables, sample_step: int, thresh: float, n_chunks: int = 2):
    """``run_both`` at ``sample_step``: (JAX detections, port detections,
    JAX step logits, port step logits), the logits in call order."""
    jlogits, logits = [], []
    _, jdets, _, dets = run_both(jmodel, variables, sample_step, thresh, n_chunks,
                                 logits=(jlogits, logits))
    return jdets, dets, jlogits, logits


def _ensemble_agrees(jd, d, sample_step):
    assert tuple(d.boxes.shape) == jd.boxes.shape == (2, sample_step * PROPS, 4)
    _frames_agree(jd, d)


def _renewal_agrees(jlogits, logits, sample_step, thresh):
    """Every step's logits agree.  In every step that renews (all but a
    chunk's last): equal renewal masks and no best score within MARGIN of
    the threshold; and some such step's mask is mixed."""
    assert len(logits) == len(jlogits) and len(logits) % sample_step == 0
    mixed = False
    for i, (jl, pl) in enumerate(zip(jlogits, logits)):
        assert rel_err(pl, jl) < 1e-3, f"step call {i} logits"
        if i % sample_step == sample_step - 1:
            continue
        jbest, best = _sigmoid(jl).max(-1), _sigmoid(pl).max(-1)
        np.testing.assert_array_equal(best > thresh, jbest > thresh)
        assert np.abs(best - thresh).min() > MARGIN, (
            f"step call {i}: a best score within {MARGIN} of the threshold {thresh}")
        keep = best > thresh
        mixed |= bool(keep.any() and not keep.all())
    assert mixed, "no step renewed some slots and kept others"


# ---------------------------------------------------------------- the modules

@pytest.mark.parametrize("t", [999, 749, 249, 0])
def test_predict_noise_from_start_vs_jax(t):
    rng = np.random.RandomState(t)
    x_t, x0 = rng.randn(2, 3, PROPS, 4).astype(np.float32) * 2
    tt = np.asarray([t, max(t - 1, 0), t], np.int64)
    want = jax_noise_from_start(jax_schedule(), jnp.asarray(x_t), jnp.asarray(tt, jnp.int32),
                                jnp.asarray(x0))
    got = predict_noise_from_start(make_schedule(), torch.from_numpy(x_t),
                                   torch.from_numpy(tt), torch.from_numpy(x0))
    assert rel_err(got.numpy(), want) < 1e-6


@pytest.fixture(scope="module")
def conditioned():
    return spread(jax_model_and_params())


@pytest.fixture(scope="module")
def plain_global():
    return jax_model_and_params(num_heads=2, num_heads_local=0)


@pytest.mark.parametrize("which", ["conditioned", "plain"])
def test_full_forward_test_vs_jax(which, conditioned, plain_global):
    """The whole stack on given boxes at t = 749 against a filled memory,
    with a conditioned stage and without (plain DiffusionDet)."""
    jmodel, variables = conditioned if which == "conditioned" else plain_global
    rng = np.random.RandomState(3)
    frames = rng.uniform(0, 255, (2, H, W, 3)).astype(np.float32)
    xy = rng.uniform(0, [W - 20, H - 20], (2, PROPS, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(4, 20, (2, PROPS, 2))], -1).astype(np.float32)
    memory = rng.randn(16, 256).astype(np.float32)
    mask = np.arange(16) < 11
    t = np.asarray([749, 749])
    with jax.disable_jit():
        feats = jmodel.apply(variables, jnp.asarray(frames),
                             method=JaxArch.extract_features)
        want = jmodel.apply(variables, feats, jnp.asarray(boxes), jnp.asarray(t, jnp.int32),
                            jnp.asarray(memory), jnp.asarray(mask),
                            method=JaxArch.full_forward_test)
    model = port_model(jmodel, variables)
    with torch.no_grad():
        pfeats = model.extract_features(torch.from_numpy(frames))
        got = model.full_forward_test(pfeats, torch.from_numpy(boxes), torch.from_numpy(t),
                                      torch.from_numpy(memory), torch.from_numpy(mask))
    assert got[0].dtype == got[1].dtype == torch.float32
    for g, w, what in zip(got, want, ("logits", "boxes", "features")):
        assert rel_err(g.numpy(), w) < 1e-3, what


def test_postprocess_ensemble_vs_jax():
    """Four steps' selections of 3 frames, with scores that repeat across
    steps and labels that repeat within them: the NMS's tie order is the
    step order, as in JAX."""
    rng = np.random.RandomState(11)
    s, f, d = 4, 3, 24
    xy = rng.uniform(0, 80, (s, f, d, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(5, 40, (s, f, d, 2))], -1).astype(np.float32)
    boxes[1:, :, :8] = boxes[0, :, :8] + rng.uniform(-1, 1, (s - 1, f, 8, 4))   # near-duplicates
    scores = rng.uniform(0, 1, (s, f, d)).astype(np.float32)
    scores[1:, :, :10] = scores[0, :, :10]                                   # equal across steps
    labels = rng.randint(1, 4, (s, f, d))
    image_hw = (90.0, 110.0)
    got = postprocess_ensemble([torch.from_numpy(b) for b in boxes],
                               [torch.from_numpy(c) for c in scores],
                               [torch.from_numpy(lb) for lb in labels], image_hw, 0.5)
    assert tuple(got.boxes.shape) == (f, s * d, 4)
    for i in range(f):
        want = jax_ensemble([jnp.asarray(b[i]) for b in boxes],
                            [jnp.asarray(c[i]) for c in scores],
                            [jnp.asarray(lb[i], jnp.int32) for lb in labels], image_hw, 0.5)
        np.testing.assert_array_equal(got.valid[i].numpy(), np.asarray(want.valid))
        np.testing.assert_array_equal(got.labels[i].numpy(), np.asarray(want.labels))
        np.testing.assert_allclose(got.boxes[i].numpy(), np.asarray(want.boxes), rtol=1e-6)
        np.testing.assert_array_equal(got.scores[i].numpy(), np.asarray(want.scores))
    assert 0 < int(got.valid.sum()) < f * s * d


# ---------------------------------------------------------------- the streams

# renewal thresholds, each in a gap of the best scores of its run; the
# conditioned model's is the default
THRESH = {"x4": 0.5, "x2": 0.5, "plain_global": 0.037262, "plain_no_global": 0.037262,
          "swin": 0.053044}


@pytest.fixture(scope="module", params=[4, 2], ids=["x4", "x2"])
def stream(request, conditioned):
    s = request.param
    thresh = THRESH[f"x{s}"]
    return s, thresh, run_x(*conditioned, s, thresh)


@pytest.mark.parametrize("chunk", [0, 1])
def test_ensemble_stream_frame_by_frame(stream, chunk):
    """A depth-18 model with a conditioned stage, S = 4 and 2: shape
    [2, S * PROPS, 4], detections frame by frame."""
    s, _, (jdets, dets, _, _) = stream
    _ensemble_agrees(jdets[chunk], dets[chunk], s)


def test_ensemble_renewal_masks(stream):
    s, thresh, (_, _, jlogits, logits) = stream
    assert len(logits) == 2 * s
    _renewal_agrees(jlogits, logits, s, thresh)


@pytest.mark.parametrize("global_enable", [True, False], ids=["global", "no_global"])
def test_plain_diffusiondet_x4(global_enable, plain_global):
    """No conditioned stage (NUM_HEADS_LOCAL 0, as in
    configs/vid_R_101_DiffusionDET.yaml), GLOBAL.ENABLE on and off: each
    step's detections are the last shared stage's."""
    jmodel, variables = plain_global
    if not global_enable:   # without a conditioned stage the params do not change
        jmodel = jmodel.clone(global_enable=False)
    thresh = THRESH["plain_global" if global_enable else "plain_no_global"]
    jdets, dets, jlogits, logits = run_x(jmodel, variables, 4, thresh, n_chunks=1)
    _ensemble_agrees(jdets[0], dets[0], 4)
    _renewal_agrees(jlogits, logits, 4, thresh)


def test_swin_t_x4():
    """A Swin-T trunk (its plain versions on the CPU) through the x4 stream."""
    thresh = THRESH["swin"]
    jdets, dets, jlogits, logits = run_x(*jax_model_and_params(swin=True), 4, thresh,
                                         n_chunks=1)
    _ensemble_agrees(jdets[0], dets[0], 4)
    _renewal_agrees(jlogits, logits, 4, thresh)
