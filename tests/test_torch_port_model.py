"""The port's backbone and decoder against the JAX package on shared weights.

Same weights (carried by ``state_dict_from_jax``) and the same numpy inputs
on both sides, CPU, float32.  Tolerances are the JAX package's own against
torch: ResNet+FPN < 2e-4 relative (tests/test_torch_parity.py), the
DynamicHead stages < 1e-3 relative (tests/test_decoder_parity.py).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from diffusionvid_tpu.models.diffusion_det import DiffusionDetArch as JaxArch
from diffusionvid_tpu.models.diffusion_det import boxes_to_signal as jax_boxes_to_signal
from diffusionvid_tpu.models.diffusion_det import ddim_times as jax_ddim_times
from diffusionvid_tpu.models.diffusion_det import make_schedule as jax_make_schedule
from diffusionvid_tpu.models.diffusion_det import signal_to_boxes as jax_signal_to_boxes
from diffusionvid_tpu.models.heads import DynamicHead as JaxHead

from diffusionvid_torch.models.diffusion_det import (
    boxes_to_signal, ddim_times, make_schedule, signal_to_boxes)
from test_torch_port_weights import H, PROPS, W, jax_model_and_params, port_model, rel_err

F = 2


@pytest.fixture(scope="module")
def pair():
    jmodel, variables = jax_model_and_params(num_heads=2)
    return jmodel, variables, port_model(jmodel, variables)


def _inputs(seed):
    r = np.random.RandomState(seed)
    frames = r.uniform(0, 255, (F, H, W, 3)).astype(np.float32)
    noise = r.randn(F, PROPS, 4).astype(np.float32)
    whwh = np.asarray([W, H, W, H], np.float32)
    return frames, noise, whwh


def test_resnet_fpn_parity(pair):
    jmodel, variables, model = pair
    frames, _, _ = _inputs(0)
    want = jax.jit(lambda v, x: jmodel.apply(
        v, x, method=JaxArch.extract_features))(variables, jnp.asarray(frames))
    with torch.no_grad():
        got = model.extract_features(torch.from_numpy(frames))
    assert len(got) == 3
    for lvl, (g, w) in enumerate(zip(got, want)):
        assert tuple(g.shape) == w.shape, (lvl, g.shape, w.shape)
        assert rel_err(g.numpy(), w) < 2e-4, f"p{lvl + 3}: rel err {rel_err(g.numpy(), w)}"


def test_signal_to_boxes_parity():
    _, noise, whwh = _inputs(1)
    want = jax_signal_to_boxes(jnp.asarray(noise), jnp.asarray(whwh), 2.0)
    got = signal_to_boxes(torch.from_numpy(noise), torch.from_numpy(whwh), 2.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-5)
    back = boxes_to_signal(got, torch.from_numpy(whwh), 2.0)
    want_back = jax_boxes_to_signal(want, jnp.asarray(whwh), 2.0)
    np.testing.assert_allclose(back.numpy(), np.asarray(want_back), rtol=1e-6, atol=1e-5)


def test_schedule_and_ddim_times_parity():
    """Every schedule buffer (derived in float64, cast at the end) and the
    DDIM time pairs are the JAX package's."""
    want, got = jax_make_schedule(), make_schedule()
    assert got.num_timesteps == want.num_timesteps and got.scale == want.scale
    for name in ("betas", "alphas_cumprod", "sqrt_alphas_cumprod",
                 "sqrt_one_minus_alphas_cumprod", "sqrt_recip_alphas_cumprod",
                 "sqrt_recipm1_alphas_cumprod"):
        g = getattr(got, name)
        assert g.dtype == torch.float32, name
        np.testing.assert_array_equal(g.numpy(), np.asarray(getattr(want, name)), err_msg=name)
    for steps in (1, 4):
        assert ddim_times(1000, steps) == jax_ddim_times(1000, steps)


def test_dynamic_head_parity(pair):
    """Shared stages, top-k set and the conditioned stage, from the same
    FPN maps (the JAX package's, handed to both sides)."""
    jmodel, variables, model = pair
    frames, noise, whwh = _inputs(2)
    jfeats = jax.jit(lambda v, x: jmodel.apply(
        v, x, method=JaxArch.extract_features))(variables, jnp.asarray(frames))
    boxes = np.array(jax_signal_to_boxes(jnp.asarray(noise), jnp.asarray(whwh), 2.0))
    t = np.full((F,), 999, np.int32)
    memory = np.random.RandomState(3).randn(12, 256).astype(np.float32)
    mem_mask = np.arange(12) < 9
    head_vars = {"params": variables["params"]["head"]}
    jhead = JaxHead(num_classes=jmodel.num_classes, num_heads=2, num_heads_local=1,
                    top_k=(PROPS, 8), dtype=jnp.float32)
    scales = (1 / 8, 1 / 16, 1 / 32)

    j_logits, j_boxes, j_pro, _ = jhead.apply(
        head_vars, list(jfeats), scales, jnp.asarray(boxes), jnp.asarray(t),
        method=JaxHead.shared_stages)
    j_k1, j_k2 = jhead.apply(head_vars, j_logits[-1], j_pro,
                             method=JaxHead.topk_features)
    j_cl, j_cb, _ = jhead.apply(
        head_vars, list(jfeats), scales, j_boxes[-1], j_pro, jnp.asarray(t),
        jnp.asarray(memory), jnp.asarray(mem_mask), False,
        method=JaxHead.condition)

    feats = [torch.from_numpy(np.array(f)) for f in jfeats]
    head = model.head
    head.top_k = (PROPS, 8)
    with torch.no_grad():
        logits, pboxes, pro, _ = head.shared_stages(
            feats, scales, torch.from_numpy(boxes), torch.from_numpy(t).long())
        k1, k2 = head.topk_features(logits[-1], pro)
        cl, cb, _ = head.condition(
            feats, scales, pboxes[-1], pro, torch.from_numpy(t).long(),
            torch.from_numpy(memory), torch.from_numpy(mem_mask))

    for i, (gl, gb, wl, wb) in enumerate(zip(logits + cl, pboxes + cb,
                                             j_logits + j_cl, j_boxes + j_cb)):
        assert rel_err(gl, wl) < 1e-3, f"stage {i}: logits rel err {rel_err(gl, wl)}"
        assert rel_err(gb, wb) < 1e-3, f"stage {i}: boxes rel err {rel_err(gb, wb)}"
    assert rel_err(pro, j_pro) < 1e-3
    # the top-k condition features are the same rows in the same order
    assert rel_err(k1, j_k1) < 1e-3 and rel_err(k2, j_k2) < 1e-3
