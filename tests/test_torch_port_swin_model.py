"""The port's Swin trunk and the Swin x1 stream against the JAX package.

Same weights (carried by ``state_dict_from_jax``) and the same numpy inputs
on both sides, CPU, float32, where the JAX package's ``SwinBlock`` takes its
XLA branch and the port runs the plain versions of K4 and K5 (in float32
the two coincide).

- ``SwinTransformer`` at narrow widths (embed 64, depths 2/2/2/2, heads
  2/4/8/16, window 7) on a map that the windows divide (112x112: 28x28
  patches) and on one they do not (64x96: every stage padded, and stages
  2-3 too small to shift): every stage output within 1e-4 relative, the
  tolerance of tests/test_swin_parity.py.
- A Swin-T ``DiffusionDetArch`` (16 proposals) through the whole x1 stream
  at 64x96 frame by frame against the JAX ``StreamingDetector`` under
  ``jax.disable_jit()``, with the JAX package's noise draws: boxes and
  scores within 1e-3 relative, labels and NMS keep masks equal, memories
  within 1e-3, as tests/test_torch_port_stream.py holds the ResNet stream.
- The window-12 sizes (``B-22k-384``, ``L-22k-384``): the narrow trunk at
  window 12 (embed 48, heads 1/2/4/8) at 192x192 and at 96x160 (padded,
  stage 0 shifted by 6), within 1e-4; and a tiny window-12 size (embed 64,
  depths 2/2/2/2, heads 2/4/8/16, registered in both packages'
  ``SWIN_SIZES``) through the x1 stream against the JAX
  ``StreamingDetector``, within 1e-3.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from diffusionvid_tpu.models import swin as jswin
from diffusionvid_tpu.models.swin import SwinTransformer as JaxSwin

from diffusionvid_torch.models import swin as tswin
from diffusionvid_torch.models.swin import SwinTransformer
from diffusionvid_torch.utils.convert import state_dict_from_jax
from test_torch_port_stream import run_both
from test_torch_port_weights import jax_model_and_params, rel_err

NARROW = dict(embed_dim=64, depths=(2, 2, 2, 2), num_heads=(2, 4, 8, 16), window=7)
NARROW_W12 = dict(embed_dim=48, depths=(2, 2, 2, 2), num_heads=(1, 2, 4, 8), window=12)
TINY_W12 = dict(embed_dim=64, depths=(2, 2, 2, 2), num_heads=(2, 4, 8, 16), window=12)
PREFIX = "backbone.bottom_up."


def _perturb(params, seed):
    """Biases and LayerNorm affines off their init, bias tables at std 0.5."""
    noise = np.random.RandomState(seed)

    def f(path, a):
        a = np.array(a)
        if "relative_position_bias_table" in str(path[-1]):
            return a * np.float32(25.0)
        if a.ndim == 1:
            return a + np.float32(0.2) * noise.randn(*a.shape).astype(np.float32)
        return a

    return jax.tree_util.tree_map_with_path(f, params)


def _trunk_vs_jax(arch, hw):
    x = np.random.RandomState(1).normal(0, 1, (2, *hw, 3)).astype(np.float32)
    jmodel = JaxSwin(**arch, dtype=jnp.float32)
    params = _perturb(jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.asarray(x))["params"], 2)
    want = jax.jit(jmodel.apply)({"params": params}, jnp.asarray(x))

    model = SwinTransformer(**arch).eval()
    state = {k[len(PREFIX):]: v for k, v in state_dict_from_jax({"backbone": params}).items()}
    model.load_state_dict(state, strict=True)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert sorted(got) == sorted(want) == ["swin0", "swin1", "swin2", "swin3"]
    for k, w in want.items():
        assert tuple(got[k].shape) == w.shape, (k, got[k].shape, w.shape)
        assert rel_err(got[k].numpy(), w) < 1e-4, f"{k}: rel err {rel_err(got[k].numpy(), w)}"


@pytest.mark.parametrize("hw", [(112, 112), (64, 96)], ids=["divisible", "padded"])
def test_swin_trunk_vs_jax(hw):
    _trunk_vs_jax(NARROW, hw)


@pytest.mark.parametrize("hw", [(192, 192), (96, 160)], ids=["divisible", "padded"])
def test_swin_trunk_vs_jax_window12(hw):
    _trunk_vs_jax(NARROW_W12, hw)


@pytest.fixture(scope="module")
def runs():
    return run_both(*jax_model_and_params(swin=True))


def test_swin_memory_after_start_video(runs):
    _memories_agree(runs)


@pytest.fixture(scope="module")
def runs_w12():
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jswin.SWIN_SIZES, "w12-test", TINY_W12)
        mp.setitem(tswin.SWIN_SIZES, "w12-test", TINY_W12)
        return run_both(*jax_model_and_params(swin=True, swin_size="w12-test"))


def _memories_agree(runs):
    jmem, _, mem, _ = runs
    for jm, m in zip(jmem, mem):
        assert m.count == int(jm.count)
        assert rel_err(m.feats.numpy(), jm.feats) < 1e-3


def _detections_agree(runs, chunk):
    _, jdets, _, dets = runs
    jd, d = jdets[chunk], dets[chunk]
    for f in range(d.boxes.shape[0]):
        assert rel_err(d.scores[f], jd.scores[f]) < 1e-3, f"frame {f} scores"
        assert rel_err(d.boxes[f], jd.boxes[f]) < 1e-3, f"frame {f} boxes"
        np.testing.assert_array_equal(d.labels[f].numpy(), np.asarray(jd.labels[f]))
        np.testing.assert_array_equal(d.valid[f].numpy(), np.asarray(jd.valid[f]))


@pytest.mark.parametrize("chunk", [0, 1])
def test_swin_detections_frame_by_frame(runs, chunk):
    _detections_agree(runs, chunk)


def test_swin_w12_memory_after_start_video(runs_w12):
    _memories_agree(runs_w12)


@pytest.mark.parametrize("chunk", [0, 1])
def test_swin_w12_detections_frame_by_frame(runs_w12, chunk):
    _detections_agree(runs_w12, chunk)
