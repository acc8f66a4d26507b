"""Kernels K4 and K5 (the Swin half-blocks): plain versions against the
Pallas kernels, and the wrappers' routing.

The plain versions of ``ops/swin_attention.py`` against
``fused_swin_block_attn`` / ``fused_swin_block_mlp`` in interpret mode, as
tests/test_swin.py runs them: a padded map (valid 12x19 → 14x21) whose pad
region holds nonzero values, shift 0 and 3 (with the SW-MSA mask), 32
channels per head, in float32 and bfloat16.

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
    _ln_f32, _mm, attn_plan, mlp_gemm_smem, mlp_plan, swin_block_attn, swin_block_attn_ref,
    swin_block_mlp, swin_block_mlp_ref, swin_mlp_fc1_ref, swin_mlp_fc2_ref, swin_mlp_ln_ref)

B, C, HEADS, WIN = 2, 64, 2, 7
HV, WV, HP, WP = 12, 19, 14, 21
N = WIN * WIN
DTYPES = {"float32": (torch.float32, jnp.float32, 5e-5, 1e-4),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, 1e-2, 2 ** -7)}


def _params(seed, c=C, heads=HEADS):
    r = np.random.RandomState(seed)

    def f(*shape, scale=1.0):
        return (r.randn(*shape) * scale).astype(np.float32)

    # the whole map is random: the pad region of the residual stream holds
    # values from earlier blocks, and only LN1's output is zeroed there
    x = f(B, HP, WP, c)
    attn = dict(ln_g=1 + f(c, scale=0.1), ln_b=f(c, scale=0.1),
                wqkv=f(3 * c, c, scale=0.1), bqkv=f(3 * c, scale=0.1),
                bias=f(heads, N, N), wproj=f(c, c, scale=0.1), bproj=f(c, scale=0.1))
    mlp = dict(ln_g=1 + f(c, scale=0.1), ln_b=f(c, scale=0.1),
               w1=f(4 * c, c, scale=0.1), b1=f(4 * c, scale=0.1),
               w2=f(c, 4 * c, scale=0.1), b2=f(c, scale=0.1))
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


def _k4_args(c=128, heads=4, hp=14, wp=21, dtype=torch.bfloat16, masked=True):
    x = _meta(2, hp, wp, c, dtype=dtype)
    mask = _meta(hp // WIN, wp // WIN, N, N) if masked else None
    return ([x, _meta(c), _meta(c), _meta(3 * c, c), _meta(3 * c), _meta(heads, N, N),
             mask, _meta(c, c), _meta(c)], dict(window=WIN, num_heads=heads,
                                                 valid_hw=(hp - 2, wp - 2), shift=3))


def _k5_args(c=128, dtype=torch.bfloat16):
    return [_meta(2, 14, 21, c, dtype=dtype), _meta(c), _meta(c), _meta(4 * c, c),
            _meta(4 * c), _meta(c, 4 * c), _meta(c)]


@pytest.mark.parametrize("kernel", ["swin_block_attn", "swin_block_mlp", "swin_block_mlp_c512"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
def test_wrapper_launches_kernel_off_the_cpu(stop_at_launch, kernel, dtype):
    if kernel == "swin_block_attn":
        wrapper = swin_block_attn
        args, kw = _k4_args(dtype=dtype)
    else:
        c = 512 if kernel.endswith("c512") else 128
        wrapper, (args, kw) = swin_block_mlp, (_k5_args(c=c, dtype=dtype), {})
    before = wrapper.launches
    with pytest.raises(_ReachedLaunch, match=kernel.removesuffix("_c512")):
        wrapper(*args, **kw)
    assert wrapper.launches == before


class _FakeLib:
    """Stands in for K5's library: records which entry point a wrapper call
    reached and with what integer arguments."""

    def __init__(self):
        self.calls = []
        for name in ("swin_block_mlp_fwd", "swin_block_mlp_wgmma"):
            def fn(*args, name=name):
                self.calls.append((name, [a for a in args if isinstance(a, int)]))
                return 0
            setattr(self, name, fn)


@pytest.mark.parametrize("c", [128, 384, 512, 768, 1024])
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
    if case == "window":
        args, kw = _k4_args()
        return args, {**kw, "window": 12}
    if case == "map_not_padded":
        return _k4_args(hp=15)
    if case == "head_dim":
        return _k4_args(c=128, heads=2)
    if case == "too_wide":
        return _k4_args(c=1536, heads=48)
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
    ("requires_grad", NotImplementedError), ("unaligned", ValueError)])
def test_attn_wrapper_rejects(stop_at_launch, case, error):
    args, kw = _k4_bad(case)
    with pytest.raises(error):
        swin_block_attn(*args, **kw)


# (C, B, Hp, Wp): the four Swin-B stage maps of a 4-frame chunk at 608x1024,
# then Swin-T's widths over 2 frames at 64x96 (chip_smoke.py's K4 checks)
PLAN_CASES = [(128, 4, 154, 259), (256, 4, 77, 133), (512, 4, 42, 70), (1024, 4, 21, 35),
              (96, 2, 21, 28), (192, 2, 14, 14), (384, 2, 7, 7), (768, 2, 7, 7)]


@pytest.mark.parametrize("c,b,hp,wp", PLAN_CASES)
def test_attn_plan_fits_the_card(c, b, hp, wp):
    """K4's launch plan: the shared memory that csrc/swin_block_attn.cu lays
    out fits one block (and as many blocks an SM as planned), the weight
    ring keeps at least two chunks in flight, the heads split evenly over
    the cluster (and, in split mode, over the two warpgroups), and Swin-B's
    stages 2 and 3 fill the H100's 132 SMs."""
    plan = attn_plan(c, b, hp, wp)
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
# Swin-T's widths over 2 frames at 64x96, and M = 98 at the wgmma widths
MLP_PLAN_CASES = [(128, 159_544), (256, 40_964), (512, 11_760), (1024, 2_940),
                  (96, 1_176), (192, 392), (384, 98), (768, 98), (512, 98), (1024, 98)]


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
        if m in (11_760, 2_940):   # no thin last wave
            assert p["tiles"] % wave == 0 or p["tiles"] % wave >= wave // 2
