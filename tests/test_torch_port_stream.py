"""The whole x1 streaming slice against the JAX ``StreamingDetector``.

A depth-18 model (16 proposals, 1 shared + 1 conditioned stage) on 64x96
frames, infer_batch 2, memories of 16/8 slots.  The weights are carried with
``state_dict_from_jax``; the port's noise method is handed the JAX
package's own draws, recomputed from its key splits (``split(state.rng)``
per global chunk in ``_update_memory``, ``split(state.rng, 4)`` per chunk in
``_detect_chunk``).  The JAX side runs under ``jax.disable_jit()``.  Frame by
frame, boxes and scores agree to < 1e-3 relative, labels and keep masks are
equal, and both memories agree after ``start_video``.  ``run_both`` also
drives the xN ensemble (tests/test_torch_port_stream_x4.py).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from diffusionvid_tpu.engine.streaming import StreamingDetector as JaxDetector

from diffusionvid_torch.engine.streaming import StreamingDetector
from diffusionvid_torch.models.diffusion_det import ddim_times
from test_torch_port_weights import (  # noqa: F401  (one_thread: the fixture)
    H, PROPS, W, jax_model_and_params, one_thread, port_model, rel_err)

KW = dict(infer_batch=2, mem_size=16, mem_dis_size=8, num_proposals=PROPS,
          detections_per_img=PROPS)
SEED = 7


def _jax_draws(n_global_chunks: int, n_chunks: int, f: int, sample_step: int = 1):
    """The noise the JAX detector draws, in call order: per global chunk
    the extract pass's boxes; per chunk the extract pass's boxes, then at
    xN the starting signal and (DDIM noise, renewal noise) for each step
    but the last."""
    def normal(k):
        return np.asarray(jax.random.normal(k, (f, PROPS, 4)))

    key = jax.random.PRNGKey(SEED)
    draws = []
    for _ in range(n_global_chunks):
        key, r = jax.random.split(key)
        draws.append(normal(r))
    for _ in range(n_chunks):
        key, r_extract, r_x, r_loop = jax.random.split(key, 4)
        draws.append(normal(r_extract))
        if sample_step > 1:
            draws.append(normal(r_x))
            for _, t_next in ddim_times(1000, sample_step):
                r_loop, r_noise, r_renew = jax.random.split(r_loop, 3)
                if t_next >= 0:
                    draws += [normal(r_noise), normal(r_renew)]
    return draws


class _JaxRecorder:
    """The JAX model with every ``full_forward_test`` call's logits kept."""

    def __init__(self, model, logits):
        self._model, self._logits = model, logits

    def __getattr__(self, name):
        return getattr(self._model, name)

    def apply(self, *args, method=None, **kw):
        out = self._model.apply(*args, method=method, **kw)
        if getattr(method, "__name__", "") == "full_forward_test":
            self._logits.append(np.asarray(out[0]))
        return out


def run_both(jmodel, variables, sample_step: int = 1, thresh: float = 0.5,
             n_chunks: int = 2, logits=None):
    """Both detectors over 3 global frames and ``n_chunks`` chunks of 2 at
    ``sample_step``, renewal threshold ``thresh``: (JAX memories, JAX
    detections, port memories, port detections).  ``logits``, a pair of
    lists, gets the logits of each DDIM step, JAX's and the port's."""
    rng = np.random.RandomState(5)
    gframes = rng.uniform(0, 255, (3, H, W, 3)).astype(np.float32)   # 2 chunks, tail padded
    chunks = [rng.uniform(0, 255, (2, H, W, 3)).astype(np.float32) for _ in range(n_chunks)]
    whwh = np.asarray([W, H, W, H], np.float32)
    kw = dict(KW, sample_step=sample_step, score_renewal_thresh=thresh)

    jlogits, plogits = logits if logits is not None else ([], [])
    jdet = JaxDetector(_JaxRecorder(jmodel, jlogits), variables, **kw)
    with jax.disable_jit():
        jstate = jdet.start_video(jax.random.PRNGKey(SEED), jnp.asarray(gframes),
                                  jnp.asarray(whwh))
        jmem = (jstate.mem, jstate.mem_dis)
        jdets = []
        for c in chunks:
            jstate, d = jdet.process_chunk(jstate, jnp.asarray(c), jnp.asarray(whwh))
            jdets.append(d)

    model = port_model(jmodel, variables)
    inner = model.full_forward_test

    def recorded(*args):
        out = inner(*args)
        plogits.append(out[0].numpy())
        return out

    model.full_forward_test = recorded
    det = StreamingDetector(model, **kw)
    draws = iter(_jax_draws(2, n_chunks, 2, sample_step))
    det.noise = lambda state, shape: torch.from_numpy(np.array(next(draws))).reshape(shape)
    state = det.start_video(SEED, gframes, whwh)
    mem = (state.mem, state.mem_dis)
    dets = []
    for c in chunks:
        state, d = det.process_chunk(state, c, whwh)
        dets.append(d)
    assert next(draws, None) is None, "the port drew less noise than JAX"
    return jmem, jdets, mem, dets


@pytest.fixture(scope="module")
def runs():
    return run_both(*jax_model_and_params())


def test_memory_after_start_video(runs):
    jmem, _, mem, _ = runs
    for (jm, m) in zip(jmem, mem):
        assert m.count == int(jm.count)
        assert rel_err(m.feats.numpy(), jm.feats) < 1e-3


def _frames_agree(jd, d):
    for f in range(d.boxes.shape[0]):
        assert rel_err(d.scores[f], jd.scores[f]) < 1e-3, f"frame {f} scores"
        assert rel_err(d.boxes[f], jd.boxes[f]) < 1e-3, f"frame {f} boxes"
        np.testing.assert_array_equal(d.labels[f].numpy(), np.asarray(jd.labels[f]))
        np.testing.assert_array_equal(d.valid[f].numpy(), np.asarray(jd.valid[f]))


@pytest.mark.parametrize("chunk", [0, 1])
def test_detections_frame_by_frame(runs, chunk):
    _, jdets, _, dets = runs
    _frames_agree(jdets[chunk], dets[chunk])


@pytest.fixture(scope="module", params=[True, False], ids=["global", "no_global"])
def plain_runs(request):
    return run_both(*jax_model_and_params(num_heads=2, num_heads_local=0,
                                          global_enable=request.param))


@pytest.mark.parametrize("chunk", [0, 1])
def test_plain_diffusiondet_frame_by_frame(plain_runs, chunk):
    """No conditioned stage (NUM_HEADS_LOCAL 0, plain DiffusionDet as in
    configs/vid_R_101_DiffusionDET.yaml), with GLOBAL.ENABLE set or not:
    the last shared stage's outputs are the detections."""
    _, jdets, _, dets = plain_runs
    _frames_agree(jdets[chunk], dets[chunk])


def test_fold_topk_vs_jax():
    """With STOP_UPDATE_AFTER_INIT_TEST off, each chunk's top-k features of
    the valid frames fold into both memories (``_fold_topk``)."""
    from diffusionvid_tpu.engine.streaming import StreamState as JaxState
    from diffusionvid_tpu.ops.memory import FeatureMemory as JaxMemory

    from diffusionvid_torch.engine.streaming import StreamState
    from diffusionvid_torch.ops.memory import FeatureMemory

    rng = np.random.RandomState(9)
    k1, k2 = rng.randn(2, 16, 32).astype(np.float32), rng.randn(2, 8, 32).astype(np.float32)
    mems = [(np.pad(rng.randn(n, 32), ((0, cap - n), (0, 0))).astype(np.float32), n)
            for cap, n in ((16, 5), (8, 3))]
    want = JaxDetector._fold_topk(
        None, JaxState(*[JaxMemory(jnp.asarray(m), jnp.asarray(n, jnp.int32)) for m, n in mems],
                       jax.random.PRNGKey(0)),
        jnp.asarray(k1), jnp.asarray(k2), 1)
    got = StreamingDetector._fold_topk(
        None, StreamState(*[FeatureMemory(torch.from_numpy(m), n) for m, n in mems], None),
        torch.from_numpy(k1), torch.from_numpy(k2), 1)
    for g, w in ((got.mem, want.mem), (got.mem_dis, want.mem_dis)):
        assert g.count == int(w.count)
        np.testing.assert_allclose(g.feats.numpy(), np.asarray(w.feats), atol=1e-6)
