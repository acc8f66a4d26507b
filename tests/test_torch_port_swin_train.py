"""The port's Swin train path against the JAX package.

- The narrow Swin trunk of tests/test_torch_port_swin_model.py (embed 64,
  depths 2/2/2/2, heads 2/4/8/16) on 64x96 frames (every stage padded,
  stages 0-1 shifted and masked), under grad: the port takes its ``v2``
  branch (K6's autograd function: the plain version forward on the CPU,
  the backward through the twin), JAX's ``SwinTransformer`` its XLA branch
  with ``train=False``, as the JAX train step runs it.  Every parameter
  gradient and the input gradient of a loss that weights each stage output
  with random numbers agree to 1e-3 relative in norm.
- The kernel modes ``v3``, ``v2`` and ``v1`` give the same trunk output in
  float32 to 1e-5; under grad the trunk takes ``v2`` whatever its mode and
  never reaches K4 or K5.
- The same two at window 12: the narrow window-12 trunk of that file
  (embed 48, heads 1/2/4/8) on 96x160 frames (every stage padded, stage 0
  shifted by 6 and masked).
- A tiny Swin ``DiffusionDetArch`` through ``make_loss_fn`` against the JAX
  package's, with the JAX draws of tests/test_torch_port_train.py: the
  losses to 1e-4 relative and every parameter's gradient to 1e-3 relative in
  norm (that file's tolerances).  The trunk is a narrow size (embed 32,
  depths 2/2/2/2, heads 1/2/4/8) registered in both packages' ``SWIN_SIZES``
  for the test only.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusionvid_tpu.engine import train as jt
from diffusionvid_tpu.models import swin as jswin
from diffusionvid_tpu.models.diffusion_det import DiffusionDetArch as JaxArch

from diffusionvid_torch.engine import train as tt
from diffusionvid_torch.models import swin as tswin
from diffusionvid_torch.utils.convert import state_dict_from_jax
from chip_smoke import conditioned_train_model
from test_torch_port_swin_model import NARROW, NARROW_W12, PREFIX, _perturb
from test_torch_port_train import (
    ARCH, NUM_GLOBAL, _batch, _jax_draws, _jax_params, _port_batch)
from test_torch_port_weights import rel_err

HW = (64, 96)
HW_W12 = (96, 160)
TINY_SIZE = dict(embed_dim=32, depths=(2, 2, 2, 2), num_heads=(1, 2, 4, 8), window=7)
SWIN_ARCH = {**ARCH, "backbone_type": "swin", "swin_size": "tiny-test",
             "fpn_in": ("swin1", "swin2", "swin3")}


def norm_err(got, want) -> float:
    """|got - want| / |want| in the 2-norm, in float64."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-12))


def _trunk_pair(arch, hw):
    """A narrow trunk's JAX parameters and the port's trunk carrying them."""
    x = np.random.RandomState(3).normal(0, 1, (2, *hw, 3)).astype(np.float32)
    jmodel = jswin.SwinTransformer(**arch, dtype=jnp.float32)
    params = _perturb(jax.jit(jmodel.init)(jax.random.PRNGKey(1), jnp.asarray(x))["params"], 4)
    model = tswin.SwinTransformer(**arch)
    state = {k[len(PREFIX):]: v for k, v in state_dict_from_jax({"backbone": params}).items()}
    model.load_state_dict(state, strict=True)
    return jmodel, params, model, x


@pytest.fixture(scope="module")
def trunk_pair():
    return _trunk_pair(NARROW, HW)


@pytest.fixture(scope="module")
def trunk_pair_w12():
    return _trunk_pair(NARROW_W12, HW_W12)


def _grads_vs_jax(trunk_pair):
    jmodel, params, model, x = trunk_pair
    r = np.random.RandomState(5)
    want_out = jax.jit(jmodel.apply)({"params": params}, jnp.asarray(x))
    weights = {k: r.randn(*v.shape).astype(np.float32) for k, v in want_out.items()}

    def loss(p, xx):
        out = jmodel.apply({"params": p}, xx, train=False)
        return sum(jnp.sum(out[k] * weights[k]) for k in out)

    want, (g_params, g_x) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1)))(
        params, jnp.asarray(x))

    xt = torch.from_numpy(x).requires_grad_()
    assert model.branch(xt) == "v2"
    out = model(xt)
    total = sum((out[k] * torch.from_numpy(weights[k])).sum() for k in out)
    total.backward()
    assert rel_err(total.detach(), want) < 1e-4
    g_want = {k[len(PREFIX):]: v for k, v in
              state_dict_from_jax({"backbone": g_params}).items()}
    named = dict(model.named_parameters())
    assert set(named) == set(g_want) - {k for k in g_want if k.endswith("_index")}
    for name, p in named.items():
        assert p.grad is not None, name
        assert norm_err(p.grad, g_want[name]) < 1e-3, (name, norm_err(p.grad, g_want[name]))
    assert norm_err(xt.grad, g_x) < 1e-3
    # the bias tables' gradient passed the index gather
    assert float(named["layers.0.blocks.1.attn.relative_position_bias_table"].grad.abs().sum()) > 0


def test_swin_trunk_grads_vs_jax(trunk_pair):
    _grads_vs_jax(trunk_pair)


def test_swin_w12_trunk_grads_vs_jax(trunk_pair_w12):
    _grads_vs_jax(trunk_pair_w12)


def _modes_agree_and_grad_takes_v2(trunk_pair, monkeypatch, arch):
    _, _, model, x = trunk_pair
    xt = torch.from_numpy(x)
    outs = {}
    for mode in tswin.KERNEL_MODES:
        model.kernel_mode = mode
        with torch.no_grad():
            outs[mode] = model(xt)
    model.kernel_mode = "v3"
    for mode in ("v2", "v1"):
        for k, v in outs["v3"].items():
            torch.testing.assert_close(outs[mode][k], v, atol=1e-5, rtol=1e-5)

    def refuse(*a, **k):
        raise AssertionError("an inference half-block kernel ran under grad")

    monkeypatch.setattr(tswin, "swin_block_attn", refuse)
    monkeypatch.setattr(tswin, "swin_block_mlp", refuse)
    for mode in tswin.KERNEL_MODES:
        model.kernel_mode = mode
        out = model(xt)
        assert all(v.requires_grad for v in out.values())
        torch.testing.assert_close(out["swin3"].detach(), outs["v3"]["swin3"], atol=1e-5,
                                   rtol=1e-5)
    model.kernel_mode = "v3"
    with pytest.raises(ValueError):
        tswin.SwinTransformer(**arch, kernel_mode="off")


def test_kernel_modes_agree_and_grad_takes_v2(trunk_pair, monkeypatch):
    _modes_agree_and_grad_takes_v2(trunk_pair, monkeypatch, NARROW)


def test_swin_w12_kernel_modes_agree_and_grad_takes_v2(trunk_pair_w12, monkeypatch):
    _modes_agree_and_grad_takes_v2(trunk_pair_w12, monkeypatch, NARROW_W12)


@pytest.fixture(scope="module")
def step_pair():
    """The tiny Swin model's loss and gradients on both sides."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jswin.SWIN_SIZES, "tiny-test", TINY_SIZE)
        mp.setitem(tswin.SWIN_SIZES, "tiny-test", TINY_SIZE)
        cfg_uniform = np.asarray([0.5, 0.05, 0.7], np.float32)
        mp.setattr(jax.random, "uniform",
                   lambda key, shape=(), *a, **k: jnp.asarray(cfg_uniform))
        arrays = _batch()
        model = conditioned_train_model(torch.Generator().manual_seed(2),
                                        torch.from_numpy(arrays[0][0]), **SWIN_ARCH)
        params = _jax_params(model)
        jmodel = JaxArch(**SWIN_ARCH, compute_dtype=jnp.float32)
        rng = jax.random.PRNGKey(6)
        (w_total, w_losses), w_grads = jax.jit(jax.value_and_grad(
            jt.make_loss_fn(jmodel, NUM_GLOBAL), has_aux=True))(
                params, jt.TrainBatch(*[jnp.asarray(a) for a in arrays]), rng)
        total, losses = tt.make_loss_fn(model, NUM_GLOBAL)(_port_batch(arrays),
                                                           _jax_draws(rng))
        total.backward()
    return (w_total, w_losses, state_dict_from_jax(w_grads)), (total, losses, model)


def test_tiny_swin_train_losses_vs_jax(step_pair):
    (w_total, w_losses, _), (total, losses, _) = step_pair
    assert rel_err(total.detach(), w_total) < 1e-4
    assert sorted(losses) == sorted(w_losses) and "loss_ce_1" in losses
    for k, v in w_losses.items():
        assert rel_err(losses[k].detach(), v) < 1e-4, k


def test_tiny_swin_train_grads_vs_jax(step_pair):
    (_, _, want), (_, _, model) = step_pair
    got = dict(model.named_parameters())
    assert set(got) == {k for k in want if not k.endswith("relative_position_index")}
    trunk = 0
    for name, g in got.items():
        assert g.grad is not None, name
        err = norm_err(g.grad, want[name])
        assert err <= 1e-3 or float(np.linalg.norm(want[name])) == 0.0, (name, err)
        trunk += name.startswith(PREFIX) and float(g.grad.abs().sum()) > 0
    assert trunk > 100
