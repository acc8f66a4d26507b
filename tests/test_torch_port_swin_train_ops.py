"""Kernels K6 and K7 (Swin window attention): plain versions against the
Pallas kernels, the training function's gradients against the JAX custom
VJP, and the wrappers' routing.

The plain versions of ``ops/window_attention.py`` against
``fused_window_attention_qkv`` / ``fused_window_attention`` in interpret
mode, as tests/test_swin.py runs them, on a 14x21 map (3 windows across,
C = 64, 2 heads) and on a padded stage map (Swin-T's stage 0 at 64x96: the
valid 16x24 padded to 21x28, C = 96, 3 heads, the pad region zero as LN1's
pad-zero leaves it), with and without the SW-MSA mask, in float32 and
bfloat16; at the window-12 sizes' shapes (valid 20x30 padded to 24x36,
shifts 0 and 6) and at Swin-L's C = 1536 (48 heads at windows 7 and 12, on
a map of two windows, the weights scaled by C^-0.5).
``WindowAttentionQKVFn``'s gradients for x, wqkv, bqkv and the bias
against ``jax.value_and_grad`` of ``fused_window_attention_qkv_
trainable`` in interpret mode, at window 7 and at window 12.

Tolerances: K6 float32 5e-5 abs + 1e-4 rel and the gradients 2e-4 abs +
1e-4 rel, tests/test_swin.py's own; K7 float32 2e-5 abs + 1e-5 rel.
bfloat16 1e-2 abs + 2^-7 rel, one bf16 step on outputs below 1: both sides
round at the same points and sum their fp32 products in other orders, so a
score or a probability next to a rounding boundary may round the other way.

The CUDA kernels run only on the card (``chip_smoke.py``); here meta
tensors stand in for CUDA tensors to check each wrapper's input checks and
that it goes to its kernel, never to the plain version, off the CPU: the
fused design at window 7 up to C = 1024, the staged design at window 12
and at C = 1536, each with its plan.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from diffusionvid_tpu.models.swin import _shift_attn_mask
from diffusionvid_tpu.ops.swin_attention_pallas import (
    fused_window_attention, fused_window_attention_qkv,
    fused_window_attention_qkv_trainable)

from diffusionvid_torch.ops import _build
from diffusionvid_torch.ops import window_attention as wa
from diffusionvid_torch.ops.swin_attention import (
    _mm, mlp_gemm_plans, mlp_gemm_smem, staged_plan, swin_attn_core_ref, swin_block_attn,
    swin_block_mlp)
from diffusionvid_torch.ops.window_attention import (
    WindowAttentionQKVFn, qkv_plan, qkv_plans, window_attention, window_attention_qkv,
    window_attention_qkv_einsum, window_attention_qkv_ref, window_attention_ref, window_path)

WIN, N = 7, 49
# name: (B, Hp, Wp, C, heads, valid H, valid W)
MAPS = {"14x21": (2, 14, 21, 64, 2, 14, 21), "padded_stage": (1, 21, 28, 96, 3, 16, 24)}
DTYPES = {"float32": (torch.float32, jnp.float32, 5e-5, 1e-4),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, 1e-2, 2 ** -7)}


def _inputs(seed, name, masked):
    b, hp, wp, c, h, hv, wv = MAPS[name]
    r = np.random.RandomState(seed)
    x = r.randn(b, hp, wp, c).astype(np.float32)
    x[:, hv:] = 0.0
    x[:, :, wv:] = 0.0
    x = np.roll(x, (-3, -3), (1, 2)) if masked else x
    wqkv = (r.randn(3 * c, c) * c ** -0.5).astype(np.float32)
    bqkv = (r.randn(3 * c) * 0.1).astype(np.float32)
    bias = r.randn(h, N, N).astype(np.float32)
    mask = (_shift_attn_mask(hp, wp, WIN, 3).reshape(hp // WIN, wp // WIN, N, N)
            if masked else None)
    return x, wqkv, bqkv, bias, mask, h


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


def _close(got, want, atol, rtol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               atol=atol, rtol=rtol)


@pytest.mark.parametrize("masked", [False, True], ids=["shift0", "shift3"])
@pytest.mark.parametrize("name", list(MAPS))
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_qkv_plain_vs_pallas_interpreted(dtype, name, masked):
    tdt, jdt, atol, rtol = DTYPES[dtype]
    x, wqkv, bqkv, bias, mask, h = _inputs(11, name, masked)
    with pltpu.force_tpu_interpret_mode():
        want = fused_window_attention_qkv(jnp.asarray(x, jdt), _j(wqkv), _j(bqkv), _j(bias),
                                          _j(mask), WIN, h)
    got = window_attention_qkv(_t(x).to(tdt), _t(wqkv), _t(bqkv), _t(bias), _t(mask), WIN, h)
    assert got.dtype == tdt and got.shape == x.shape
    _close(got, want, atol, rtol)


@pytest.mark.parametrize("masked", [False, True], ids=["shift0", "shift3"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_plain_vs_pallas_interpreted(dtype, masked):
    """K7 over q/k/v maps of the padded stage."""
    tdt, jdt = DTYPES[dtype][:2]
    atol, rtol = (2e-5, 1e-5) if dtype == "float32" else DTYPES[dtype][2:]
    x, wqkv, bqkv, bias, mask, h = _inputs(12, "padded_stage", masked)
    c = x.shape[-1]
    q, k, v = (x @ wqkv[i * c:(i + 1) * c].T + bqkv[i * c:(i + 1) * c] for i in range(3))
    with pltpu.force_tpu_interpret_mode():
        want = fused_window_attention(*(jnp.asarray(t, jdt) for t in (q, k, v)), _j(bias),
                                      _j(mask), WIN)
    got = window_attention(*(_t(t).to(tdt) for t in (q, k, v)), _t(bias), _t(mask), WIN)
    assert got.dtype == tdt and got.shape == x.shape
    _close(got, want, atol, rtol)


# (window, C, heads, valid, padded, shift): the window-12 sizes on a padded
# map of 2x3 windows, shifts 0 and 6; Swin-L's C = 1536 on two windows at
# window 7 (L-22k's stage 3) and 12 (L-22k-384's)
WIDE_CASES = {"w12_shift0": (12, 64, 2, (20, 30), (24, 36), 0),
              "w12_shift6": (12, 64, 2, (20, 30), (24, 36), 6),
              "c1536_w7": (7, 1536, 48, (7, 12), (7, 14), 0),
              "c1536_w12_shift6": (12, 1536, 48, (12, 19), (12, 24), 6)}


def _wide_inputs(seed, case):
    """A map of ``WIDE_CASES[case]`` (2 maps at C = 64, 1 at 1536), the pad
    region zero, rolled by the shift; K6's weights (scaled by C^-0.5), the
    head biases and the SW-MSA mask of the shift."""
    win, c, h, (hv, wv), (hp, wp), shift = WIDE_CASES[case]
    n = win * win
    r = np.random.RandomState(seed)
    x = r.randn(1 if c > 64 else 2, hp, wp, c).astype(np.float32)
    x[:, hv:] = 0.0
    x[:, :, wv:] = 0.0
    mask = None
    if shift:
        x = np.roll(x, (-shift, -shift), (1, 2))
        mask = _shift_attn_mask(hp, wp, win, shift).reshape(hp // win, wp // win, n, n)
    wqkv = (r.randn(3 * c, c) * c ** -0.5).astype(np.float32)
    bqkv = (r.randn(3 * c) * 0.1).astype(np.float32)
    bias = r.randn(h, n, n).astype(np.float32)
    return x, wqkv, bqkv, bias, mask, h, win


@pytest.mark.parametrize("case", list(WIDE_CASES))
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_qkv_plain_vs_pallas_interpreted_wide(dtype, case):
    """K6 as above, at the window-12 sizes' shapes and at C = 1536."""
    tdt, jdt, atol, rtol = DTYPES[dtype]
    x, wqkv, bqkv, bias, mask, h, win = _wide_inputs(21, case)
    with pltpu.force_tpu_interpret_mode():
        want = fused_window_attention_qkv(jnp.asarray(x, jdt), _j(wqkv), _j(bqkv), _j(bias),
                                          _j(mask), win, h)
    got = window_attention_qkv(_t(x).to(tdt), _t(wqkv), _t(bqkv), _t(bias), _t(mask), win, h)
    assert got.dtype == tdt and got.shape == x.shape
    _close(got, want, atol, rtol)


@pytest.mark.parametrize("case", list(WIDE_CASES))
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_plain_vs_pallas_interpreted_wide(dtype, case):
    """K7 as above, at the window-12 sizes' shapes and at C = 1536."""
    tdt, jdt = DTYPES[dtype][:2]
    atol, rtol = (2e-5, 1e-5) if dtype == "float32" else DTYPES[dtype][2:]
    x, wqkv, bqkv, bias, mask, h, win = _wide_inputs(22, case)
    c = x.shape[-1]
    q, k, v = (x @ wqkv[i * c:(i + 1) * c].T + bqkv[i * c:(i + 1) * c] for i in range(3))
    with pltpu.force_tpu_interpret_mode():
        want = fused_window_attention(*(jnp.asarray(t, jdt) for t in (q, k, v)), _j(bias),
                                      _j(mask), win)
    got = window_attention(*(_t(t).to(tdt) for t in (q, k, v)), _t(bias), _t(mask), win)
    assert got.dtype == tdt and got.shape == x.shape
    _close(got, want, atol, rtol)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_qkv_plain_is_its_staged_launches(dtype):
    """K6's plain version is the composition of the plain versions of its
    staged design's two launches, the qkv product over the map (``_mm``)
    and the window attention over the qkv map (``swin_attn_core_ref``), bit
    for bit, at window 12 with the mask and at C = 1536."""
    tdt = DTYPES[dtype][0]
    for case in ("w12_shift6", "c1536_w7"):
        x, wqkv, bqkv, bias, mask, h, win = _wide_inputs(23, case)
        xt, wt, bt, bi, mk = _t(x).to(tdt), _t(wqkv), _t(bqkv), _t(bias), _t(mask)
        qkv = _mm(xt, wt, bt)
        assert qkv.shape == (*x.shape[:3], 3 * x.shape[-1]) and qkv.dtype == tdt
        assert torch.equal(window_attention_qkv_ref(xt, wt, bt, bi, mk, win, h),
                           swin_attn_core_ref(qkv, bi, mk, win, h))


@pytest.mark.parametrize("masked", [False, True], ids=["shift0", "shift3"])
def test_qkv_grads_vs_jax_custom_vjp(masked):
    x, wqkv, bqkv, bias, mask, h = _inputs(13, "14x21", masked)
    g = np.random.RandomState(14).randn(*x.shape).astype(np.float32)

    def loss(x_, w_, b_, bi_):
        out = fused_window_attention_qkv_trainable(x_, w_, b_, bi_, _j(mask), WIN, h)
        return jnp.sum(out * jnp.asarray(g))

    with pltpu.force_tpu_interpret_mode():
        val, grads = jax.value_and_grad(loss, argnums=(0, 1, 2, 3))(
            *map(jnp.asarray, (x, wqkv, bqkv, bias)))
    ins = [_t(a).requires_grad_() for a in (x, wqkv, bqkv, bias)]
    tmask = None if mask is None else _t(mask).requires_grad_()
    total = (WindowAttentionQKVFn.apply(*ins, tmask, WIN, h) * _t(g)).sum()
    total.backward()
    np.testing.assert_allclose(float(total.detach()), float(val), rtol=1e-5, atol=1e-4)
    for t, want, what in zip(ins, grads, ("x", "wqkv", "bqkv", "bias")):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(want), rtol=1e-4, atol=2e-4,
                                   err_msg=what)
    assert tmask is None or tmask.grad is None


def test_qkv_grads_vs_jax_custom_vjp_w12():
    """As above at window 12 on the padded 24x36 map, shifted by 6 and
    masked."""
    x, wqkv, bqkv, bias, mask, h, win = _wide_inputs(24, "w12_shift6")
    g = np.random.RandomState(25).randn(*x.shape).astype(np.float32)

    def loss(x_, w_, b_, bi_):
        out = fused_window_attention_qkv_trainable(x_, w_, b_, bi_, _j(mask), win, h)
        return jnp.sum(out * jnp.asarray(g))

    with pltpu.force_tpu_interpret_mode():
        val, grads = jax.value_and_grad(loss, argnums=(0, 1, 2, 3))(
            *map(jnp.asarray, (x, wqkv, bqkv, bias)))
    ins = [_t(a).requires_grad_() for a in (x, wqkv, bqkv, bias)]
    total = (WindowAttentionQKVFn.apply(*ins, _t(mask), win, h) * _t(g)).sum()
    total.backward()
    np.testing.assert_allclose(float(total.detach()), float(val), rtol=1e-5, atol=1e-4)
    for t, want, what in zip(ins, grads, ("x", "wqkv", "bqkv", "bias")):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(want), rtol=1e-4, atol=2e-4,
                                   err_msg=what)


def test_backward_differentiates_the_twin():
    """The backward is the gradient of ``window_attention_qkv_einsum`` (the
    twin of ``_einsum_window_attention_qkv``), not of the forward's plain
    version: in bf16 the two round the projection at other points."""
    x, wqkv, bqkv, bias, mask, h = _inputs(15, "14x21", True)
    g = torch.randn(x.shape, generator=torch.Generator().manual_seed(0)).bfloat16()
    ins = [_t(x).bfloat16().requires_grad_()] + [_t(a).requires_grad_()
                                                  for a in (wqkv, bqkv, bias)]
    WindowAttentionQKVFn.apply(*ins, _t(mask), WIN, h).backward(g)
    ref = [t.detach().clone().requires_grad_() for t in ins]
    window_attention_qkv_einsum(*ref, _t(mask), WIN, h).backward(g)
    for t, r in zip(ins, ref):
        assert torch.equal(t.grad, r.grad)


def test_plain_versions_agree_in_float32():
    """In float32 the kernel's plain version and the twin coincide."""
    x, wqkv, bqkv, bias, mask, h = _inputs(16, "padded_stage", True)
    args = (_t(x), _t(wqkv), _t(bqkv), _t(bias), _t(mask), WIN, h)
    torch.testing.assert_close(window_attention_qkv_ref(*args),
                               window_attention_qkv_einsum(*args), atol=2e-6, rtol=1e-5)


# ---------------------------------------------------------------- wrappers

class _ReachedLaunch(Exception):
    pass


@pytest.fixture
def stop_at_launch(monkeypatch):
    def load(name):
        raise _ReachedLaunch(name)
    monkeypatch.setattr(_build, "load", load)


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _k6_args(c=128, heads=4, hp=14, wp=21, dtype=torch.bfloat16, masked=True, win=WIN):
    n = win * win
    mask = _meta(hp // win, wp // win, n, n) if masked else None
    return [_meta(2, hp, wp, c, dtype=dtype), _meta(3 * c, c), _meta(3 * c),
            _meta(heads, n, n), mask, win, heads]


def _k7_args(c=128, heads=4, hp=14, wp=21, dtype=torch.bfloat16, masked=True, win=WIN):
    n = win * win
    mask = _meta(hp // win, wp // win, n, n) if masked else None
    return [_meta(2, hp, wp, c, dtype=dtype) for _ in range(3)] + [
        _meta(heads, n, n), mask, win]


@pytest.mark.parametrize("masked", [False, True], ids=["shift0", "shift3"])
@pytest.mark.parametrize("kernel", ["window_attn_qkv", "window_attn"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
def test_wrapper_launches_kernel_off_the_cpu(stop_at_launch, kernel, dtype, masked):
    if kernel == "window_attn_qkv":
        wrapper, args = window_attention_qkv, _k6_args(dtype=dtype, masked=masked)
    else:
        wrapper, args = window_attention, _k7_args(dtype=dtype, masked=masked)
    before = wrapper.launches
    with pytest.raises(_ReachedLaunch, match="window_attn_qkv"):
        wrapper(*args)
    assert wrapper.launches == before


class _FakeLib:
    """Stands in for K6/K7's library: records which entry point a wrapper
    call reached and with what integer arguments."""

    def __init__(self):
        self.calls = []
        for name in ("window_attn_qkv_fwd", "window_attn_qkv_staged", "window_attn_fwd",
                     "window_attn_staged"):
            def fn(*args, name=name):
                self.calls.append((name, [a for a in args if isinstance(a, int)]))
                return 0
            setattr(self, name, fn)


@pytest.mark.parametrize("case", ["w7_c128", "w7_c1024", "w7_c1536", "w12_c192", "w12_c1536"])
@pytest.mark.parametrize("kernel", ["window_attn_qkv", "window_attn"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
def test_wrapper_takes_the_planned_design(monkeypatch, case, kernel, dtype):
    """Off the CPU, window 7 up to C = 1024 reaches the fused design's entry
    point (K6 with qkv_plan in bf16; K7 with window_plan in bf16); window
    12, and C = 1536, the staged design's, K6 in bf16 with staged_plan's
    qkv product plan, fp32 with none; never the plain version.  Each call
    counts one launch."""
    lib = _FakeLib()
    monkeypatch.setattr(_build, "load", lambda name: lib)
    monkeypatch.setattr(_build, "stream_ptr", lambda device: 0)
    monkeypatch.setattr(wa, "_sm_count", lambda index: 132)
    win, c = (int(v[1:]) for v in case.split("_"))
    hp, wp = (14, 21) if win == 7 else (24, 36)
    qkv = kernel == "window_attn_qkv"
    wrapper = window_attention_qkv if qkv else window_attention
    args = (_k6_args if qkv else _k7_args)(c=c, heads=c // 32, hp=hp, wp=wp, dtype=dtype,
                                         win=win)
    before = wrapper.launches
    out = wrapper(*args)
    assert out.shape == args[0].shape and out.dtype == dtype
    assert wrapper.launches == before + 1
    [(name, ints)] = lib.calls
    path = window_path(c, win)
    assert path == ("fused" if win == 7 and c <= 1024 else "staged")
    head = [2, hp, wp, c, c // 32]        # B, Hp, Wp, C, heads
    if path == "staged":
        assert name == f"{kernel}_staged"
        bf16 = dtype == torch.bfloat16
        if qkv:                           # ..., window, dtype, the product's plan, the stream
            p = staged_plan(c, 2, hp, wp, win, 132)["qkv"]
            assert ints[-11:-1] == head + [win, int(bf16)] + (
                [p["bn"], p["stages"], p["smem_bytes"]] if bf16 else [0, 0, 0])
        else:                             # ..., window, dtype, the stream
            assert ints[-8:-1] == head + [win, int(bf16)]
    elif qkv:
        assert name == "window_attn_qkv_fwd"
        p = qkv_plan(c, 2, hp, wp, 132)
        assert ints[-12:-6] == head + [int(dtype == torch.bfloat16)]
        if dtype == torch.bfloat16:
            assert ints[-6:-1] == [p[k] for k in ("wpb", "hsplit", "kc", "stages", "smem_bytes")]
    else:
        assert name == "window_attn_fwd"
        assert ints[-11:-5] == head + [int(dtype == torch.bfloat16)]


# (C, B, Hp, Wp, window): Swin-L-22k-384's four stage maps of a 5-frame
# train sample at 608x1024 and L-22k's stage 3 (C = 1536 at window 7)
QKV_STAGED_CASES = [(192, 5, 156, 264, 12), (384, 5, 84, 132, 12), (768, 5, 48, 72, 12),
                    (1536, 5, 24, 36, 12), (1536, 5, 21, 35, 7)]


@pytest.mark.parametrize("c,b,hp,wp,win", QKV_STAGED_CASES)
def test_qkv_staged_plan_at_swin_l(c, b, hp, wp, win):
    """K6's staged design at Swin-L's train maps: its qkv product's plan is
    the cheapest of mlp_gemm_plans (no GELU table) over [M, 3C] by C, each
    tile once, its shared bytes fit a block; the attention takes a block a
    (window, head)."""
    assert window_path(c, win) == "staged"
    plan, m = staged_plan(c, b, hp, wp, win, 132), b * hp * wp
    p = plan["qkv"]
    assert p == min(mlp_gemm_plans(m, 3 * c, c, False), key=lambda q: (q["cost"], q["tiles"]))
    assert p["tiles"] == -(-m // 128) * (3 * c // p["bn"]) and 3 * c % p["bn"] == 0
    assert p["smem_bytes"] == mlp_gemm_smem(p["bn"], p["stages"], False) <= 232_448
    assert plan["attn_blocks"] == b * (hp // win) * (wp // win) * (c // 32)


def test_autograd_function_launches_k6_under_grad(stop_at_launch):
    """The training function's forward reaches K6 with inputs that need a
    gradient, where the bare wrapper refuses them."""
    args = _k6_args()
    args[0] = _meta(2, 14, 21, 128).requires_grad_()
    args[1].requires_grad_()
    with pytest.raises(NotImplementedError):
        window_attention_qkv(*args)
    with pytest.raises(_ReachedLaunch, match="window_attn_qkv"):
        WindowAttentionQKVFn.apply(*args)


def test_wrappers_take_the_plain_version_on_the_cpu():
    x, wqkv, bqkv, bias, mask, h = _inputs(17, "14x21", True)
    args = (_t(x), _t(wqkv), _t(bqkv), _t(bias), _t(mask), WIN, h)
    before = window_attention_qkv.launches, window_attention.launches
    assert torch.equal(window_attention_qkv(*args), window_attention_qkv_ref(*args))
    qkv = [_t(x) * s for s in (1.0, 0.5, -1.0)]
    assert torch.equal(window_attention(*qkv, _t(bias), _t(mask), WIN),
                       window_attention_ref(*qkv, _t(bias), _t(mask), WIN))
    assert (window_attention_qkv.launches, window_attention.launches) == before


def _k6_bad(case):
    if case == "float16":
        return _k6_args(dtype=torch.float16)
    if case == "window":        # 7 and 12 are the kernel's windows
        args = _k6_args(hp=16, wp=24)
        args[5] = 8
        return args
    if case == "map_not_padded":
        return _k6_args(hp=15)
    if case == "head_dim":
        return _k6_args(c=128, heads=2)
    if case == "head_dim_w12":
        return _k6_args(c=768, heads=12, hp=24, wp=36, win=12)
    if case == "too_wide":      # C = 1536 is Swin-L's stage 3
        return _k6_args(c=2048, heads=64)
    if case == "staged_width":  # the staged design's product takes C in steps of 64
        return _k6_args(c=96, heads=3, hp=24, wp=36, win=12)
    if case == "mask_shape_w12":
        args = _k6_args(hp=24, wp=36, win=12)
        args[4] = _meta(2, 3, N, N)
        return args
    args = _k6_args()
    if case == "bias_shape":
        args[3] = _meta(4, N, 48)
    if case == "mask_shape":
        args[4] = _meta(3, 3, N, N)
    if case == "wqkv_shape":
        args[1] = _meta(128, 3 * 128)
    if case == "bqkv_shape":
        args[2] = _meta(128)
    if case == "not_contiguous":
        args[0] = _meta(2, 21, 14, 128, dtype=torch.bfloat16).transpose(1, 2)
    if case == "requires_grad":
        args[0] = args[0].float().requires_grad_()
    if case == "unaligned_wqkv":
        args[1] = _meta(3 * 128 * 128 + 1, dtype=torch.bfloat16)[1:].view(3 * 128, 128)
    return args


@pytest.mark.parametrize("case,error", [
    ("float16", TypeError), ("window", ValueError), ("map_not_padded", ValueError),
    ("head_dim", ValueError), ("too_wide", ValueError), ("bias_shape", ValueError),
    ("mask_shape", ValueError), ("wqkv_shape", ValueError), ("bqkv_shape", ValueError),
    ("not_contiguous", ValueError), ("requires_grad", NotImplementedError),
    ("unaligned_wqkv", ValueError), ("head_dim_w12", ValueError),
    ("staged_width", ValueError), ("mask_shape_w12", ValueError)])
def test_qkv_wrapper_rejects(stop_at_launch, case, error):
    with pytest.raises(error):
        window_attention_qkv(*_k6_bad(case))


# (C, B, Hp, Wp): the four Swin-B stage maps of a 5-frame train sample and of
# a 4-frame chunk at 608x1024, then Swin-T's widths over 2 frames at 64x96
# (chip_smoke.py's K6 checks)
QKV_PLAN_CASES = [(128, 5, 154, 259), (256, 5, 77, 133), (512, 5, 42, 70), (1024, 5, 21, 35),
                  (128, 4, 154, 259), (256, 4, 77, 133), (512, 4, 42, 70), (1024, 4, 21, 35),
                  (96, 2, 21, 28), (192, 2, 14, 14), (384, 2, 7, 7), (768, 2, 7, 7)]


@pytest.mark.parametrize("c,b,hp,wp", QKV_PLAN_CASES)
def test_qkv_plan_fits_the_card(c, b, hp, wp):
    """K6's launch plan: the shared memory that csrc/window_attn_qkv.cu
    lays out (K4's SmemBf16) fits one block, and as many blocks an SM as
    planned; block i takes windows (i // hsplit) wpb + t, t < wpb, and the
    heads' share i % hsplit, which covers every (window, head) once; the
    ring keeps at least two chunks in flight; and at Swin-B's stage 2 over
    5 frames the plan's waves x work a block beats pair mode's 2 waves."""
    plan = qkv_plan(c, b, hp, wp, sms=132)
    wpb, hsplit, kc, stages = plan["wpb"], plan["hsplit"], plan["kc"], plan["stages"]
    heads, windows = c // 32, b * (hp // 7) * (wp // 7)
    spl = 3 - wpb                                           # heads a ring slot holds
    assert wpb in (1, 2) and hsplit in (1, 2, 4) and heads % (hsplit * spl) == 0
    assert kc in (32, 64) and c % kc == 0 and 3 <= stages <= 5
    ring = stages * 2 * 96 * spl * kc                       # weight rows, bf16
    tiles = wpb * 2 * 49 * (c + 8)                          # x tiles, bf16
    kv = 2 * 2 * (64 * 40 + 32 * 72)                        # k, v^T of each warpgroup
    nn = (wpb + 2) * 9616                                   # masks, two attention biases
    assert plan["smem_bytes"] == ring + tiles + kv + nn + 256 <= 232_448
    assert plan["blocks_per_sm"] * (plan["smem_bytes"] + 1024) <= 233_472
    assert plan["blocks_per_sm"] == 1 or c <= 128           # the kernel's launch bounds
    cover = np.zeros((windows, heads), np.int64)
    hpb = heads // hsplit
    for i in range(plan["blocks"]):
        for t in range(wpb):
            win = (i // hsplit) * wpb + t
            if win < windows:                               # a missing second window stores nothing
                cover[win, (i % hsplit) * hpb:(i % hsplit + 1) * hpb] += 1
    assert (cover == 1).all()
    assert plan["waves"] == -(-plan["blocks"] // (132 * plan["blocks_per_sm"]))
    assert plan["cost"] == min(p["cost"] for p in qkv_plans(c, b, hp, wp, sms=132))
    if (c, b) == (512, 5):
        pair = [p for p in qkv_plans(c, b, hp, wp, sms=132)
                if (p["wpb"], p["hsplit"]) == (2, 1)][0]
        assert pair["waves"] * pair["work"] == 2
        assert plan["waves"] * plan["work"] < 2


def _k7_bad(case):
    if case == "float16":
        return _k7_args(dtype=torch.float16)
    if case == "map_not_padded":
        return _k7_args(hp=15)
    if case == "head_dim":
        return _k7_args(c=128, heads=2)
    if case == "too_wide":      # C = 1536 is Swin-L's stage 3
        return _k7_args(c=2048, heads=64)
    if case == "window":        # 7 and 12 are the kernel's windows
        args = _k7_args(hp=16, wp=24)
        args[5] = 8
        return args
    if case == "mask_shape_w12":
        args = _k7_args(hp=24, wp=36, win=12)
        args[4] = _meta(2, 3, N, N)
        return args
    args = _k7_args()
    if case == "k_shape":
        args[1] = _meta(2, 14, 28, 128, dtype=torch.bfloat16)
    if case == "v_dtype":
        args[2] = _meta(2, 14, 21, 128)
    if case == "mask_shape":
        args[4] = _meta(3, 2, N, N)
    if case == "not_contiguous":
        args[0] = _meta(2, 21, 14, 128, dtype=torch.bfloat16).transpose(1, 2)
    if case == "requires_grad":
        args[3] = args[3].requires_grad_()
    return args


@pytest.mark.parametrize("case,error", [
    ("float16", TypeError), ("map_not_padded", ValueError), ("head_dim", ValueError),
    ("too_wide", ValueError), ("k_shape", ValueError), ("v_dtype", ValueError),
    ("mask_shape", ValueError), ("not_contiguous", ValueError),
    ("requires_grad", NotImplementedError), ("window", ValueError),
    ("mask_shape_w12", ValueError)])
def test_wrapper_rejects(stop_at_launch, case, error):
    with pytest.raises(error):
        window_attention(*_k7_bad(case))


@pytest.mark.parametrize("kernel", ["swin_block_attn", "swin_block_mlp"])
def test_inference_half_blocks_still_raise_under_grad(stop_at_launch, kernel):
    """K4 and K5 stay inference-only: under grad they raise, under no_grad
    they reach their launch."""
    c = 128
    x = _meta(2, 14, 21, c, dtype=torch.bfloat16)
    if kernel == "swin_block_attn":
        fn = swin_block_attn
        args = [x, _meta(c), _meta(c), _meta(3 * c, c), _meta(3 * c), _meta(4, N, N), None,
                _meta(c, c), _meta(c), WIN, 4, (12, 19)]
    else:
        fn = swin_block_mlp
        args = [x, _meta(c), _meta(c), _meta(4 * c, c), _meta(4 * c), _meta(c, 4 * c),
                _meta(c)]
    args[3].requires_grad_()          # the first weight
    with pytest.raises(NotImplementedError):
        fn(*args)
    with torch.no_grad(), pytest.raises(_ReachedLaunch, match=kernel):
        fn(*args)
