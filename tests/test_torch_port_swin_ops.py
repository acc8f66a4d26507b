"""Kernels K4 and K5 (the Swin half-blocks): plain versions against the
Pallas kernels, and the wrappers' routing.

The plain versions of ``ops/swin_attention.py`` against
``fused_swin_block_attn`` / ``fused_swin_block_mlp`` in interpret mode, as
tests/test_swin.py runs them: a padded map (valid 12x19 → 14x21) whose pad
region holds nonzero values, shift 0 and 3 (with the SW-MSA mask), 32
channels per head, in float32 and bfloat16; the window-12 sizes' shapes
(valid 20x30 → 24x36, shift 0 and 6) and Swin-L's C = 1536 (48 heads at
window 7 and 12, on a map of two windows), where the weights are scaled by
C^-0.5 so that the outputs stay O(1).

Tolerances: float32 holds to tests/test_swin.py's 5e-5 abs + 1e-4 rel.
bfloat16 holds to 1e-2 abs + 2^-7 rel: both sides round at the same points
and sum their fp32 products in other orders, so a value that lands next to
a rounding boundary of an intermediate (the LN output, a score, a
probability) may round the other way, and the output, near 1 in magnitude,
moves by about one bf16 step (2^-8 to 2^-7).

The CUDA kernels run only on the card (``chip_smoke.py``); here meta tensors
stand in for CUDA tensors to check each wrapper's input checks and that it
goes to its kernel, never to the plain version, for a tensor off the CPU.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from diffusionvid_tpu.models.swin import _relative_position_index, _shift_attn_mask
from diffusionvid_tpu.ops.swin_attention_pallas import (
    fused_swin_block_attn, fused_swin_block_mlp)

from diffusionvid_torch.models.swin import relative_position_index, shift_attn_mask
from diffusionvid_torch.ops import _build
from diffusionvid_torch.ops import swin_attention
from diffusionvid_torch.ops.swin_attention import (
    _ln_f32, _mm, attn_path, attn_plan, mlp_gemm_plans, mlp_gemm_smem, mlp_plan, staged_plan,
    swin_attn_core_ref, swin_attn_ln_ref, swin_block_attn, swin_block_attn_ref, swin_block_mlp,
    swin_block_mlp_ref, swin_mlp_fc1_ref, swin_mlp_fc2_ref, swin_mlp_ln_ref)

B, C, HEADS, WIN = 2, 64, 2, 7
HV, WV, HP, WP = 12, 19, 14, 21
N = WIN * WIN
DTYPES = {"float32": (torch.float32, jnp.float32, 5e-5, 1e-4),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, 1e-2, 2 ** -7)}


def _params(seed, c=C, heads=HEADS, shape=(B, HP, WP), n=N, scale=None):
    """A map of ``shape`` + (c,) and half-block weights; the matrices at
    std 0.1, or ``scale`` times C^-0.5 (4C^-0.5 for fc2)."""
    r = np.random.RandomState(seed)

    def f(*shape, scale=1.0):
        return (r.randn(*shape) * scale).astype(np.float32)

    w, w4 = (0.1, 0.1) if scale is None else (scale * c ** -0.5, scale * (4 * c) ** -0.5)
    # the whole map is random: the pad region of the residual stream holds
    # values from earlier blocks, and only LN1's output is zeroed there
    x = f(*shape, c)
    attn = dict(ln_g=1 + f(c, scale=0.1), ln_b=f(c, scale=0.1),
                wqkv=f(3 * c, c, scale=w), bqkv=f(3 * c, scale=0.1),
                bias=f(heads, n, n), wproj=f(c, c, scale=w), bproj=f(c, scale=0.1))
    mlp = dict(ln_g=1 + f(c, scale=0.1), ln_b=f(c, scale=0.1),
               w1=f(4 * c, c, scale=w), b1=f(4 * c, scale=0.1),
               w2=f(c, 4 * c, scale=w4), b2=f(c, scale=0.1))
    return x, attn, mlp


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _close(got, want, atol, rtol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               atol=atol, rtol=rtol)


def test_index_and_mask_copies_match_jax():
    """The port keeps its own copies of the index and mask functions."""
    for w in (3, 7, 12):
        np.testing.assert_array_equal(relative_position_index(w), _relative_position_index(w))
    for hp, wp in ((14, 21), (21, 35), (154, 259)):
        np.testing.assert_array_equal(shift_attn_mask(hp, wp, 7, 3),
                                      _shift_attn_mask(hp, wp, 7, 3))


@pytest.mark.parametrize("shift", [0, 3])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_attn_plain_vs_pallas_interpreted(dtype, shift):
    tdt, jdt, atol, rtol = DTYPES[dtype]
    x, p, _ = _params(7)
    if shift:
        x = np.roll(x, (-shift, -shift), (1, 2))
        mask = _shift_attn_mask(HP, WP, WIN, shift).reshape(HP // WIN, WP // WIN, N, N)
    else:
        mask = None
    args = (p["ln_g"], p["ln_b"], p["wqkv"], p["bqkv"], p["bias"])
    tail = (p["wproj"], p["bproj"])
    with pltpu.force_tpu_interpret_mode():
        want = fused_swin_block_attn(jnp.asarray(x, jdt), *map(jnp.asarray, args),
                                     None if mask is None else jnp.asarray(mask),
                                     *map(jnp.asarray, tail), WIN, HEADS, (HV, WV),
                                     shift=shift)
    got = swin_block_attn(_t(x).to(tdt), *map(_t, args), _t(mask), *map(_t, tail),
                          WIN, HEADS, (HV, WV), shift=shift)
    assert got.dtype == tdt and got.shape == (B, HP, WP, C)
    _close(got, want, atol, rtol)


# (window, C, heads, valid, padded, shift): the window-12 sizes on a padded
# map of 2x3 windows, shifts 0 and 6; Swin-L's C = 1536 on two windows at
# window 7 (L-22k's stage 3) and 12 (L-22k-384's)
WIDE_CASES = {"w12_shift0": (12, 64, 2, (20, 30), (24, 36), 0),
              "w12_shift6": (12, 64, 2, (20, 30), (24, 36), 6),
              "c1536_w7": (7, 1536, 48, (7, 12), (7, 14), 0),
              "c1536_w12_shift6": (12, 1536, 48, (12, 19), (12, 24), 6)}


@pytest.mark.parametrize("case", list(WIDE_CASES))
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_attn_plain_vs_pallas_interpreted_wide(dtype, case):
    """As above, at the window-12 sizes' shapes and at C = 1536."""
    tdt, jdt, atol, rtol = DTYPES[dtype]
    win, c, heads, (hv, wv), (hp, wp), shift = WIDE_CASES[case]
    n = win * win
    x, p, _ = _params(11, c, heads, (1 if c > 64 else B, hp, wp), n,
                      scale=None if c == 64 else 0.8)
    mask = None
    if shift:
        x = np.roll(x, (-shift, -shift), (1, 2))
        mask = _shift_attn_mask(hp, wp, win, shift).reshape(hp // win, wp // win, n, n)
    args = (p["ln_g"], p["ln_b"], p["wqkv"], p["bqkv"], p["bias"])
    tail = (p["wproj"], p["bproj"])
    with pltpu.force_tpu_interpret_mode():
        want = fused_swin_block_attn(jnp.asarray(x, jdt), *map(jnp.asarray, args),
                                     None if mask is None else jnp.asarray(mask),
                                     *map(jnp.asarray, tail), win, heads, (hv, wv),
                                     shift=shift)
    got = swin_block_attn(_t(x).to(tdt), *map(_t, args), _t(mask), *map(_t, tail),
                          win, heads, (hv, wv), shift=shift)
    assert got.dtype == tdt and got.shape == x.shape
    _close(got, want, atol, rtol)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_attn_plain_is_its_staged_launches(dtype):
    """The plain version of K4 is the composition of the plain versions of
    the staged design's launches (LN pass, qkv product, window attention,
    out-projection with the residual), bit for bit, at window 12."""
    tdt = DTYPES[dtype][0]
    x, p, _ = _params(12, shape=(B, 24, 36), n=144)
    xt = _t(np.roll(x, (-6, -6), (1, 2))).to(tdt)
    mask = _t(shift_attn_mask(24, 36, 12, 6).reshape(2, 3, 144, 144))
    ln_g, ln_b, wqkv, bqkv, bias, wproj, bproj = (
        _t(p[k]) for k in ("ln_g", "ln_b", "wqkv", "bqkv", "bias", "wproj", "bproj"))
    y = swin_attn_ln_ref(xt, ln_g, ln_b, (20, 30), shift=6)
    assert float(y.float()[:, -4:, :].abs().max()) > 0   # rolled: the padding moved
    qkv = _mm(y, wqkv, bqkv)
    o = swin_attn_core_ref(qkv, bias, mask, 12, HEADS)
    assert o.shape == xt.shape and qkv.shape == (*xt.shape[:3], 3 * C)
    assert torch.equal(swin_block_attn_ref(xt, ln_g, ln_b, wqkv, bqkv, bias, mask, wproj, bproj,
                                           12, HEADS, (20, 30), shift=6),
                       xt + _mm(o, wproj, bproj))


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_mlp_plain_vs_pallas_interpreted(dtype):
    tdt, jdt, atol, rtol = DTYPES[dtype]
    x, _, p = _params(8)
    args = [p[k] for k in ("ln_g", "ln_b", "w1", "b1", "w2", "b2")]
    with pltpu.force_tpu_interpret_mode():
        want = fused_swin_block_mlp(jnp.asarray(x, jdt), *map(jnp.asarray, args), rows=WIN)
    got = swin_block_mlp(_t(x).to(tdt), *map(_t, args))
    assert got.dtype == tdt and got.shape == (B, HP, WP, C)
    _close(got, want, atol, rtol)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_mlp_plain_vs_pallas_interpreted_c1536(dtype):
    """K5's plain version at Swin-L's C = 1536, on 98 rows."""
    tdt, jdt, atol, rtol = DTYPES[dtype]
    x, _, p = _params(13, 1536, 48, (1, 7, 14), scale=0.8)
    args = [p[k] for k in ("ln_g", "ln_b", "w1", "b1", "w2", "b2")]
    with pltpu.force_tpu_interpret_mode():
        want = fused_swin_block_mlp(jnp.asarray(x, jdt), *map(jnp.asarray, args), rows=WIN)
    got = swin_block_mlp(_t(x).to(tdt), *map(_t, args))
    assert got.dtype == tdt and got.shape == x.shape
    _close(got, want, atol, rtol)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_mlp_plain_is_its_three_launches(dtype):
    """The plain version of K5 is the composition of the plain versions of
    the wgmma path's three launches (LN pass, fc1, fc2), bit for bit the
    one-piece formula it replaced, in bf16 and fp32."""
    tdt = DTYPES[dtype][0]
    x, _, p = _params(8)
    xt = _t(x).to(tdt)
    ln_g, ln_b, w1, b1, w2, b2 = (_t(p[k]) for k in ("ln_g", "ln_b", "w1", "b1", "w2", "b2"))
    y = _ln_f32(xt, ln_g, ln_b, 1e-5).to(tdt)
    z = _mm(y, w1, b1).float()
    z = (0.5 * z * (1.0 + torch.erf(z * 2.0 ** -0.5))).to(tdt)
    whole = xt + _mm(z, w2, b2)
    y3 = swin_mlp_ln_ref(xt, ln_g, ln_b)
    h3 = swin_mlp_fc1_ref(y3, w1, b1)
    assert torch.equal(y3, y) and torch.equal(h3, z)
    assert torch.equal(swin_mlp_fc2_ref(xt, h3, w2, b2), whole)
    assert torch.equal(swin_block_mlp_ref(xt, ln_g, ln_b, w1, b1, w2, b2), whole)


def test_pad_mask_is_in_rolled_coordinates():
    """Shifting the map without shifting the pad mask's addressing changes
    the result: the mask follows the roll (the case a full-size map hits at
    every odd block)."""
    x, p, _ = _params(9)
    xr = _t(np.roll(x, (-3, -3), (1, 2)))
    mask = _t(shift_attn_mask(HP, WP, WIN, 3).reshape(HP // WIN, WP // WIN, N, N))
    args = [_t(p[k]) for k in ("ln_g", "ln_b", "wqkv", "bqkv", "bias")]
    tail = [_t(p["wproj"]), _t(p["bproj"])]
    rolled = swin_block_attn_ref(xr, *args, mask, *tail, WIN, HEADS, (HV, WV), shift=3)
    unrolled = swin_block_attn_ref(xr, *args, mask, *tail, WIN, HEADS, (HV, WV), shift=0)
    assert (rolled - unrolled).abs().max() > 1e-3


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


def _k4_args(c=128, heads=4, hp=14, wp=21, dtype=torch.bfloat16, masked=True, win=WIN):
    x = _meta(2, hp, wp, c, dtype=dtype)
    n = win * win
    mask = _meta(hp // win, wp // win, n, n) if masked else None
    return ([x, _meta(c), _meta(c), _meta(3 * c, c), _meta(3 * c), _meta(heads, n, n),
             mask, _meta(c, c), _meta(c)], dict(window=win, num_heads=heads,
                                                 valid_hw=(hp - 2, wp - 2), shift=win // 2))


# the K4 and K5 calls of test_wrapper_launches_kernel_off_the_cpu beyond the
# first: window 12 (the staged design), C = 1536 at window 7 (staged too)
K4_CALLS = {"swin_block_attn": {}, "swin_block_attn_w12": dict(hp=24, wp=36, win=12),
            "swin_block_attn_c1536": dict(c=1536, heads=48)}
K5_WIDTHS = {"swin_block_mlp": 128, "swin_block_mlp_c512": 512, "swin_block_mlp_c1536": 1536}


def _k5_args(c=128, dtype=torch.bfloat16):
    return [_meta(2, 14, 21, c, dtype=dtype), _meta(c), _meta(c), _meta(4 * c, c),
            _meta(4 * c), _meta(c, 4 * c), _meta(c)]


@pytest.mark.parametrize("kernel", ["swin_block_attn", "swin_block_mlp", "swin_block_mlp_c512",
                                    "swin_block_attn_w12", "swin_block_attn_c1536",
                                    "swin_block_mlp_c1536"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
def test_wrapper_launches_kernel_off_the_cpu(stop_at_launch, kernel, dtype):
    if kernel in K4_CALLS:
        wrapper = swin_block_attn
        args, kw = _k4_args(dtype=dtype, **K4_CALLS[kernel])
    else:
        wrapper, (args, kw) = swin_block_mlp, (_k5_args(c=K5_WIDTHS[kernel], dtype=dtype), {})
    before = wrapper.launches
    with pytest.raises(_ReachedLaunch, match=kernel.split("_c")[0].removesuffix("_w12")):
        wrapper(*args, **kw)
    assert wrapper.launches == before


class _FakeLib:
    """Stands in for K4's and K5's libraries: records which entry point a
    wrapper call reached and with what integer arguments."""

    def __init__(self):
        self.calls = []
        for name in ("swin_block_mlp_fwd", "swin_block_mlp_wgmma", "swin_block_attn_fwd",
                     "swin_block_attn_staged"):
            def fn(*args, name=name):
                self.calls.append((name, [a for a in args if isinstance(a, int)]))
                return 0
            setattr(self, name, fn)


@pytest.mark.parametrize("c", [128, 384, 512, 768, 1024, 1536])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
def test_mlp_wrapper_takes_the_planned_path(monkeypatch, c, dtype):
    """Off the CPU, bf16 from C = 512 on reaches the wgmma path's entry point
    with mlp_plan's tiles, rings and shared bytes (no flag sends it back to
    the fused kernel); below 512, and in fp32, the fused entry point.  Each
    call counts one launch."""
    lib = _FakeLib()
    monkeypatch.setattr(_build, "load", lambda name: lib)
    monkeypatch.setattr(_build, "stream_ptr", lambda device: 0)
    monkeypatch.setattr(swin_attention, "_sm_count", lambda index: 132)
    before = swin_block_mlp.launches
    swin_block_mlp(*_k5_args(c=c, dtype=dtype))
    assert swin_block_mlp.launches == before + 1
    [(name, ints)] = lib.calls
    m = 2 * 14 * 21
    if dtype == torch.bfloat16 and c >= 512:
        plan = mlp_plan(c, m)
        assert name == "swin_block_mlp_wgmma" and plan["path"] == "wgmma"
        # ..., M, C, (eps), the two products' plans, the stream
        assert ints[-9:-1] == [m, c, *[plan[p][k] for p in ("fc1", "fc2")
                                       for k in ("bn", "stages", "smem_bytes")]]
    else:
        assert name == "swin_block_mlp_fwd"
        assert ints[-4:-1] == [m, c, 1 if dtype == torch.bfloat16 else 0]  # M, C, (eps), dtype


@pytest.mark.parametrize("case", ["w7_c128", "w7_c1024", "w7_c1536", "w12_c192", "w12_c1536"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
def test_attn_wrapper_takes_the_planned_path(monkeypatch, case, dtype):
    """Off the CPU, bf16 at window 7 up to C = 1024 reaches the fused
    design's entry point with attn_plan's mode, ring and shared bytes;
    window 12, and C = 1536, the staged design's with its products' plans;
    fp32 the fused entry point (its fp32 kernel) at either window.  Each
    call counts one launch."""
    lib = _FakeLib()
    monkeypatch.setattr(_build, "load", lambda name: lib)
    monkeypatch.setattr(_build, "stream_ptr", lambda device: 0)
    monkeypatch.setattr(swin_attention, "_sm_count", lambda index: 132)
    win, c = (int(v[1:]) for v in case.split("_"))
    hp, wp = (14, 21) if win == 7 else (24, 36)
    args, kw = _k4_args(c=c, heads=c // 32, hp=hp, wp=wp, dtype=dtype, win=win)
    before = swin_block_attn.launches
    swin_block_attn(*args, **kw)
    assert swin_block_attn.launches == before + 1
    [(name, ints)] = lib.calls
    plan = attn_plan(c, 2, hp, wp, win)
    assert plan["path"] == ("fused" if win == 7 and c <= 1024 else "staged") == attn_path(c, win)
    # ..., B, Hp, Wp, C, heads, hv, wv, shift, window, (eps), the plan's six, the stream
    head = [2, hp, wp, c, c // 32, hp - 2, wp - 2, win // 2, win]
    if dtype == torch.bfloat16 and plan["path"] == "staged":
        assert name == "swin_block_attn_staged"
        assert ints[-16:-7] == head and ints[-7:-1] == [
            plan[p][k] for p in ("qkv", "proj") for k in ("bn", "stages", "smem_bytes")]
    else:
        assert name == "swin_block_attn_fwd"
        assert ints[-16:-7] == head and ints[-7:-1] == (
            [1, *[plan[k] for k in ("wpb", "cluster", "kc", "stages", "smem_bytes")]]
            if dtype == torch.bfloat16 else [0, 0, 0, 0, 0, 0])


def test_wrappers_take_the_plain_version_on_the_cpu():
    x, p, q = _params(3)
    xt = _t(x)
    args = [_t(p[k]) for k in ("ln_g", "ln_b", "wqkv", "bqkv", "bias")]
    tail = [_t(p["wproj"]), _t(p["bproj"])]
    before = swin_block_attn.launches, swin_block_mlp.launches
    got = swin_block_attn(xt, *args, None, *tail, WIN, HEADS, (HV, WV))
    want = swin_block_attn_ref(xt, *args, None, *tail, WIN, HEADS, (HV, WV))
    assert torch.equal(got, want)
    margs = [_t(q[k]) for k in ("ln_g", "ln_b", "w1", "b1", "w2", "b2")]
    assert torch.equal(swin_block_mlp(xt, *margs), swin_block_mlp_ref(xt, *margs))
    assert (swin_block_attn.launches, swin_block_mlp.launches) == before


def _k4_bad(case):
    if case == "float16":
        return _k4_args(dtype=torch.float16)
    if case == "window":        # 7 and 12 are K4's windows
        args, kw = _k4_args(hp=16, wp=24)
        return args, {**kw, "window": 8}
    if case == "map_not_padded":
        return _k4_args(hp=15)
    if case == "head_dim":
        return _k4_args(c=128, heads=2)
    if case == "head_dim_w12":
        return _k4_args(c=768, heads=12, hp=24, wp=36, win=12)
    if case == "too_wide":      # C = 1536 is Swin-L's stage 3
        return _k4_args(c=2048, heads=64)
    if case == "staged_width":  # the staged design's products take C in steps of 64
        return _k4_args(c=96, heads=3, hp=24, wp=36, win=12)
    if case == "mask_shape_w12":
        args, kw = _k4_args(hp=24, wp=36, win=12)
        args[6] = _meta(2, 3, N, N)
        return args, kw
    args, kw = _k4_args()
    if case == "valid_hw":
        kw["valid_hw"] = (15, 19)
    if case == "shift":
        kw["shift"] = 7
    if case == "bias_shape":
        args[5] = _meta(4, N, 48)
    if case == "mask_shape":
        args[6] = _meta(3, 3, N, N)
    if case == "wqkv_shape":
        args[3] = _meta(128, 3 * 128)
    if case == "not_contiguous":
        args[0] = _meta(2, 21, 14, 128, dtype=torch.bfloat16).transpose(1, 2)
    if case == "requires_grad":
        args[0] = args[0].float().requires_grad_()
    if case == "unaligned":
        args[0] = _meta(2 * 14 * 21 * 128 + 1, dtype=torch.bfloat16)[1:].view(2, 14, 21, 128)
    return args, kw


@pytest.mark.parametrize("case,error", [
    ("float16", TypeError), ("window", ValueError), ("map_not_padded", ValueError),
    ("head_dim", ValueError), ("too_wide", ValueError), ("valid_hw", ValueError),
    ("shift", ValueError), ("bias_shape", ValueError), ("mask_shape", ValueError),
    ("wqkv_shape", ValueError), ("not_contiguous", ValueError),
    ("requires_grad", NotImplementedError), ("unaligned", ValueError),
    ("head_dim_w12", ValueError), ("staged_width", ValueError), ("mask_shape_w12", ValueError)])
def test_attn_wrapper_rejects(stop_at_launch, case, error):
    args, kw = _k4_bad(case)
    with pytest.raises(error):
        swin_block_attn(*args, **kw)


# (C, B, Hp, Wp, window): the four Swin-B stage maps of a 4-frame chunk at
# 608x1024, then Swin-T's widths over 2 frames at 64x96 (chip_smoke.py's K4
# checks), then Swin-L-22k-384's four stage maps of a 4-frame chunk at
# 608x1024 and L-22k's stage 3 (C = 1536 at window 7)
PLAN_CASES = [(128, 4, 154, 259, 7), (256, 4, 77, 133, 7), (512, 4, 42, 70, 7),
              (1024, 4, 21, 35, 7), (96, 2, 21, 28, 7), (192, 2, 14, 14, 7), (384, 2, 7, 7, 7),
              (768, 2, 7, 7, 7), (192, 4, 156, 264, 12), (384, 4, 84, 132, 12),
              (768, 4, 48, 72, 12), (1536, 4, 24, 36, 12), (1536, 4, 21, 35, 7)]


def _check_staged_plan(plan, c, b, hp, wp, win):
    assert plan["path"] == "staged" and plan["window"] == win
    m = b * hp * wp
    for name, n in (("qkv", 3 * c), ("proj", c)):
        p = plan[name]
        assert p == min(mlp_gemm_plans(m, n, c, False), key=lambda q: (q["cost"], q["tiles"]))
        assert p["tiles"] == -(-m // 128) * (n // p["bn"]) and n % p["bn"] == 0
        assert p["smem_bytes"] == mlp_gemm_smem(p["bn"], p["stages"], False) <= 232_448
    assert plan["attn_blocks"] == b * (hp // win) * (wp // win) * (c // 32)


@pytest.mark.parametrize("c,b,hp,wp,win", PLAN_CASES,
                         ids=["-".join(map(str, case[:4] if case[4] == 7 and case[0] <= 1024
                                           else case)) for case in PLAN_CASES])
def test_attn_plan_fits_the_card(c, b, hp, wp, win):
    """K4's launch plan.  The fused design (window 7, C <= 1024): the
    shared memory that csrc/swin_block_attn.cu lays out fits one block (and
    as many blocks an SM as planned), the weight ring keeps at least two
    chunks in flight, the heads split evenly over the cluster (and, in
    split mode, over the two warpgroups), and Swin-B's stages 2 and 3 fill
    the H100's 132 SMs.  The staged design (window 12; C = 1536, whose
    fused sum is over a block even with the smallest ring): its products'
    plans are the cheapest of mlp_gemm_plans (no GELU table), each tile
    once, and the attention takes a block a (window, head)."""
    plan = attn_plan(c, b, hp, wp, win)
    if win == 12 or c > 1024:
        _check_staged_plan(plan, c, b, hp, wp, win)
        if win == 7:
            assert swin_attention._attn_smem(c, 1, 32, 3) == 236_736 > 232_448
        return
    assert plan["path"] == "fused"
    wpb, cl, kc, stages = plan["wpb"], plan["cluster"], plan["kc"], plan["stages"]
    assert (wpb, cl) == ((2, 1) if c <= 512 else (1, 2))
    heads = c // 32
    assert heads % cl == 0 and (wpb == 2 or (heads // cl) % 2 == 0)
    assert kc in (32, 64) and c % kc == 0 and 3 <= stages <= 5
    spl = 3 - wpb                                           # heads a ring slot holds
    ring = stages * 2 * 96 * spl * kc                       # weight rows, bf16
    tiles = wpb * 2 * 49 * (c + 8)                          # LN / o tiles, bf16
    kv = 2 * 2 * (64 * 40 + 32 * 72)                        # k, v^T of each warpgroup
    nn = (wpb + 2) * 9616                                   # masks, two attention biases
    assert plan["smem_bytes"] == ring + tiles + kv + nn + 256 <= 232_448
    assert plan["blocks_per_sm"] * (plan["smem_bytes"] + 1024) <= 233_472
    assert plan["blocks"] == -(-b * (hp // 7) * (wp // 7) // wpb) * cl
    if c == 1024:
        assert plan["blocks"] >= 120
    if b == 4 and c >= 512:      # no thin last wave
        wave = 132 * plan["blocks_per_sm"]
        assert plan["blocks"] % wave == 0 or plan["blocks"] % wave >= wave // 2


def _k5_bad(case):
    if case == "float16":
        return _k5_args(dtype=torch.float16)
    if case == "width":
        return _k5_args(c=64)
    args = _k5_args()
    if case == "w1_shape":
        args[3] = _meta(128, 4 * 128)
    if case == "b2_shape":
        args[6] = _meta(4 * 128)
    if case == "not_contiguous":
        args[0] = _meta(2, 21, 14, 128, dtype=torch.bfloat16).transpose(1, 2)
    if case == "requires_grad":
        args[3] = args[3].requires_grad_()
    if case == "unaligned":
        args[0] = _meta(2 * 14 * 21 * 128 + 1, dtype=torch.bfloat16)[1:].view(2, 14, 21, 128)
    return args


@pytest.mark.parametrize("case,error", [
    ("float16", TypeError), ("width", ValueError), ("w1_shape", ValueError),
    ("b2_shape", ValueError), ("not_contiguous", ValueError),
    ("requires_grad", NotImplementedError), ("unaligned", ValueError)])
def test_mlp_wrapper_rejects(stop_at_launch, case, error):
    with pytest.raises(error):
        swin_block_mlp(*_k5_bad(case))


# (C, M): the Swin-B stage maps of a 4-frame chunk at 608x1024 (M = 4 Hp Wp),
# Swin-T's widths over 2 frames at 64x96, M = 98 at the wgmma widths, then
# Swin-L-22k-384's stage maps of a 4-frame chunk at 608x1024 and L-22k's
# stage 3
@pytest.mark.parametrize("c,b,hp,wp,win", PLAN_CASES[:4],
                         ids=["-".join(map(str, case[:4])) for case in PLAN_CASES[:4]])
def test_staged_plan_at_swin_b(c, b, hp, wp, win):
    """The staged design's plan at Swin-B's maps, where attn_plan takes the
    fused design and chip_smoke.py runs the staged one beside it
    (launch_attn_staged): a plan of the same checks as at window 12."""
    assert attn_plan(c, b, hp, wp, win)["path"] == "fused"
    _check_staged_plan(staged_plan(c, b, hp, wp, win), c, b, hp, wp, win)


MLP_PLAN_CASES = [(128, 159_544), (256, 40_964), (512, 11_760), (1024, 2_940),
                  (96, 1_176), (192, 392), (384, 98), (768, 98), (512, 98), (1024, 98),
                  (192, 164_736), (384, 44_352), (768, 13_824), (1536, 3_456), (1536, 2_940)]


@pytest.mark.parametrize("c,m", MLP_PLAN_CASES)
def test_mlp_plan_fits_the_card(c, m):
    """K5's launch plan: the path by width (fused up to C = 384, wgmma from
    512 on); each product's tiles of 128 rows x bn cover [M, N] once; the
    shared bytes csrc/swin_block_mlp.cu lays out (ring slots of an A box
    and a W box of 64 channels, barriers, the tile's bias, fc1's GELU
    table) fit a block and the planned blocks an SM; the ring holds at
    least 3 slots; at Swin-B's stages 2 and 3 each product's last wave is
    at least half full on the H100's 132 SMs."""
    plan = mlp_plan(c, m)
    if c <= 384:
        assert plan["path"] == "fused"
        assert (plan["tiles"] - 1) * plan["tm"] < m <= plan["tiles"] * plan["tm"]
        return
    assert plan["path"] == "wgmma"
    for name, n, k in (("fc1", 4 * c, c), ("fc2", c, 4 * c)):
        p = plan[name]
        bn, stages, per_sm = p["bn"], p["stages"], p["blocks_per_sm"]
        assert bn in (64, 128, 256) and n % bn == 0 and k % 64 == 0
        row_tiles = -(-m // 128)
        assert p["tiles"] == row_tiles * (n // bn)            # each tile once
        assert (row_tiles - 1) * 128 < m <= row_tiles * 128
        ring = stages * (128 * 64 + bn * 64) * 2
        table = 5_888 * 2 if name == "fc1" else 0
        assert p["smem_bytes"] == ring + 256 + 4 * bn + table == mlp_gemm_smem(
            bn, stages, name == "fc1")
        assert p["smem_bytes"] <= 232_448 and per_sm * (p["smem_bytes"] + 1024) <= 233_472
        assert 3 <= stages <= 5 and per_sm in ((1, 2) if bn <= 128 else (1,))
        wave = 132 * per_sm
        assert p["waves"] == -(-p["tiles"] // wave)
        if (c, m) in ((512, 11_760), (1024, 2_940)):   # Swin-B's: no thin last wave
            assert p["tiles"] % wave == 0 or p["tiles"] % wave >= wave // 2
