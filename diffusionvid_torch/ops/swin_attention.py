"""Swin half-blocks: kernels K4 (attention) and K5 (MLP) and their plain versions.

Port of the inference kernels of ``diffusionvid_tpu/ops/swin_attention_pallas.py``:
``fused_swin_block_attn`` (LN1 → pad-zero → qkv → windowed MHA with the
relative-position bias and the SW-MSA mask → out-projection → +residual) and
``fused_swin_block_mlp`` (LN2 → fc1 → exact GELU → fc2 → +residual).

The plain versions repeat the Pallas kernels' rounding points, not those of
the JAX package's XLA branch of ``SwinBlock``: every product is an fp32
matmul of operands rounded to the compute dtype, its fp32 bias is added
before it is rounded, and the attention scores cross to the softmax through
the compute dtype and back.  In fp32 the two branches coincide.

On CPU tensors a wrapper runs the plain version; on CUDA tensors it launches
``csrc/swin_block_attn.cu`` / ``csrc/swin_block_mlp.cu`` or raises.  Both
kernels are inference-only, as in the JAX package (``SwinBlock`` takes them
only when not training): a CUDA input that needs a gradient raises.  The
trunk's training path is ``ops/window_attention.py`` (K6).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

_EPS = 1e-5
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
WINDOW = 7          # the window of the fused designs of K4, K6 and K7
ATTN_WINDOWS = (7, 12)   # K4's, K6's and K7's windows: every Swin size's
HEAD_DIM = 32       # channels per head, shared by Swin-T/S/B/L
MAX_ATTN_C = 1024   # fused K4, K6, K7: a window's [49, C] bf16 tile in shared memory
MAX_C = 1536        # K4 to K7: Swin-L's stage 3
MLP_C = (96, 128, 192, 256, 384, 512, 768, 1024, 1536)   # K5 is compiled per width


def _ln_f32(x, g, b, eps):
    """LayerNorm in fp32 (two-pass variance), not rounded."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    return (xf - mu) * torch.rsqrt(var + eps) * g.float() + b.float()


def _mm(a, w, bias):
    """``a @ w.T + bias`` as an fp32 product of the rounded operands, the
    fp32 bias added, then rounded to ``a.dtype``."""
    return (torch.matmul(a.float(), w.to(a.dtype).float().t()) + bias.float()).to(a.dtype)


def _partition(t, w: int):
    """[B, Hp, Wp, C] → [B·nW, w·w, C], windows row-major."""
    b, hp, wp, c = t.shape
    t = t.reshape(b, hp // w, w, wp // w, w, c).permute(0, 1, 3, 2, 4, 5)
    return t.reshape(-1, w * w, c)


def _reverse(t, w: int, b: int, hp: int, wp: int):
    c = t.shape[-1]
    t = t.reshape(b, hp // w, wp // w, w, w, c).permute(0, 1, 3, 2, 4, 5)
    return t.reshape(b, hp, wp, c)


def _attend(q, k, v, bias, mask):
    """Windowed MHA at the Pallas kernels' rounding points
    (``swin_attention_pallas.py: _attention_stripe``): q, k, v ``[B·nW, h,
    w², dh]`` in the compute dtype, bias ``[h, w², w²]``, mask ``[Hp/w,
    Wp/w, w², w²]`` or None → ``[B·nW, w², h·dh]`` in the compute dtype."""
    nb, h, n, dh = q.shape
    dt = q.dtype
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * float(dh ** -0.5)
    s = s.to(dt).float() + bias.float()[None]
    if mask is not None:
        nw = mask.shape[0] * mask.shape[1]
        s = (s.view(-1, nw, h, n, n) + mask.reshape(nw, n, n).float()[None, :, None]
             ).view(nb, h, n, n)
    s = s - s.amax(-1, keepdim=True)
    e = s.exp()
    p = (e / e.sum(-1, keepdim=True)).to(dt)
    return torch.matmul(p.float(), v.float()).to(dt).permute(0, 2, 1, 3).reshape(nb, n, h * dh)


def swin_attn_ln_ref(x, ln_g, ln_b, valid_hw, shift: int = 0, eps: float = _EPS):
    """K4's first rounding point, ``y = round(LN1(x) * keep)``, zero over the
    window padding in the coordinates of the rolled map: the plain version
    of the staged design's LN pass."""
    _, hp, wp, _ = x.shape
    y = _ln_f32(x, ln_g, ln_b, eps)
    hv, wv = valid_hw
    if (hp, wp) != (hv, wv):
        rows = (torch.arange(hp, device=x.device) + shift) % hp < hv
        cols = (torch.arange(wp, device=x.device) + shift) % wp < wv
        y = y * (rows[:, None] & cols[None, :]).float()[:, :, None]
    return y.to(x.dtype)


def swin_attn_core_ref(qkv, bias, mask, window: int, num_heads: int):
    """The window attention over the qkv map ``[B, Hp, Wp, 3C]`` (q | k | v,
    heads of 32) → o ``[B, Hp, Wp, C]`` in map order: the plain version of
    the staged design's attention launch."""
    b, hp, wp, c3 = qkv.shape
    w, h = window, num_heads
    q, k, v = _partition(qkv, w).view(-1, w * w, 3, h, c3 // (3 * h)).permute(2, 0, 3, 1, 4)
    return _reverse(_attend(q, k, v, bias, mask), w, b, hp, wp)


def swin_block_attn_ref(x, ln_g, ln_b, wqkv, bqkv, bias, mask, wproj, bproj,
                        window: int, num_heads: int, valid_hw, shift: int = 0,
                        eps: float = _EPS):
    """The plain version of K4 (``swin_attention_pallas.py: _kernel_block_attn``):
    its rounding points in turn, the products row by row in map order."""
    y = swin_attn_ln_ref(x, ln_g, ln_b, valid_hw, shift, eps)
    o = swin_attn_core_ref(_mm(y, wqkv, bqkv), bias, mask, window, num_heads)
    return x + _mm(o, wproj, bproj)


def swin_mlp_ln_ref(x, ln_g, ln_b, eps: float = _EPS):
    """K5's first rounding point, ``y = round(LN2(x))``: the plain version
    of the wgmma design's LN pass."""
    return _ln_f32(x, ln_g, ln_b, eps).to(x.dtype)


def swin_mlp_fc1_ref(y, w1, b1):
    """``h = round(gelu(round(y w1^T + b1)))``, the exact erf GELU in fp32:
    the plain version of the fc1 product."""
    z = _mm(y, w1, b1).float()
    return (0.5 * z * (1.0 + torch.erf(z * 2.0 ** -0.5))).to(y.dtype)


def swin_mlp_fc2_ref(x, h, w2, b2):
    """``out = x + round(h w2^T + b2)``: the plain version of the fc2 product."""
    return x + _mm(h, w2, b2)


def swin_block_mlp_ref(x, ln_g, ln_b, w1, b1, w2, b2, eps: float = _EPS):
    """The plain version of K5 (``swin_attention_pallas.py: _kernel_block_mlp``):
    its three rounding points in turn."""
    y = swin_mlp_ln_ref(x, ln_g, ln_b, eps)
    return swin_mlp_fc2_ref(x, swin_mlp_fc1_ref(y, w1, b1), w2, b2)


# ---------------------------------------------------------------- kernels

def _f32(t):
    return t.to(torch.float32).contiguous()


def _f32_a16(t):
    """``_f32``, copied where it is not 16-byte aligned (a kernel reads it
    by 16-byte loads)."""
    t = _f32(t)
    return t if t.data_ptr() % 16 == 0 else t.clone()


# K4's launch plan (csrc/swin_block_attn.cu, bf16).  An H100 SM has 228 KB
# of shared memory; a block may take 227 KB of it (232,448 bytes), and each
# block in an SM also holds 1 KB for the system.
SMEM_BLOCK_LIMIT = 232_448
SMEM_SM = 233_472
H100_SMS = 132


def _attn_smem(c: int, wpb: int, kc: int, stages: int, window: int = WINDOW) -> int:
    """K4's fused shared bytes (``SmemBf16`` in the source, at window 7):
    the weight ring of ``stages`` slots of 96 rows (192 in split mode) of
    ``kc`` channels; ``wpb`` LN tiles [w², C] in bf16, each row padded by 8
    elements; per warpgroup k [R, 40] and v^T [32, R + 8] in bf16, R the
    window's rows in wgmma tiles of 64; a mask per window and two attention
    biases (fp32 [w², w²], padded to 16 bytes: 9,616 at window 7); 256
    bytes of barriers."""
    n, spl = window * window, 3 - wpb
    rows = -(-n // 64) * 64
    nn = -(-4 * n * n // 16) * 16
    return (stages * 2 * 96 * spl * kc + 2 * n * (c + 8) * wpb
            + 2 * 2 * (rows * 40 + 32 * (rows + 8)) + (wpb + 2) * nn + 256)


def ring_plan(c: int, wpb: int, per_sm_max: int = 2, window: int = WINDOW):
    """The weight ring of a ring kernel (K4, K6) at C channels with ``wpb``
    windows a block: ``kc`` (32 or 64 channels) a chunk and ``stages`` (3
    to 5) slots, the most bytes in flight (stages - 1 slots) at which
    ``per_sm_max`` blocks share an SM, else at which fewer do, the wider
    chunk on a tie.  Returns (kc, stages, shared bytes, blocks an SM), or
    None where not even one block fits."""
    options = [(kc, st) for kc in (64, 32) for st in range(5, 2, -1) if c % kc == 0]
    size = {o: _attn_smem(c, wpb, *o, window=window) for o in options}
    for per_sm in range(per_sm_max, 0, -1):
        fit = [o for o in options
               if size[o] <= SMEM_BLOCK_LIMIT and per_sm * (size[o] + 1024) <= SMEM_SM]
        if fit:
            kc, stages = max(fit, key=lambda o: ((o[1] - 1) * o[0], o[0]))
            return kc, stages, size[(kc, stages)], per_sm
    return None


@functools.lru_cache(maxsize=None)
def attn_path(c: int, window: int = WINDOW) -> str:
    """K4's design for C channels at ``window``: ``"fused"`` where its
    shared-memory sum (``_attn_smem``) fits a block with the smallest ring
    (window 7 up to C = 1024), else ``"staged"`` (window 12 at every width;
    C = 1536 at window 7, whose sum is 236,736 bytes).  By fit, not by
    cost: at Swin-B's C = 256 to 1024 the staged design times faster
    (PERF.md, section 6)."""
    return "fused" if ring_plan(c, 2 if c <= 512 else 1, window=window) else "staged"


@functools.lru_cache(maxsize=None)
def attn_plan(c: int, b: int, hp: int, wp: int, window: int = WINDOW,
              sms: int = H100_SMS) -> dict:
    """K4's launch for C channels over ``b`` maps of hp x wp at ``window``.

    ``path`` "fused" (``attn_path``): the mode is C's: up to C = 512 a
    block takes two windows (``wpb`` 2), one to each warpgroup, so that each
    weight tile it streams serves both; from C = 768 on, whose two LN tiles
    would not fit, a ``cluster`` of two blocks takes one window, each block
    half of the heads and of the out-projection's columns, so that Swin-B's
    stage 3 (60 windows) runs 120 blocks.  Then the ring (``ring_plan``)
    and ``smem_bytes``.  ``path`` "staged": ``staged_plan``.  Cached (the
    wrapper asks at every launch): do not modify the dict."""
    if attn_path(c, window) == "staged":
        return staged_plan(c, b, hp, wp, window, sms)
    windows = b * (hp // window) * (wp // window)
    wpb = 2 if c <= 512 else 1
    cluster = 3 - wpb
    kc, stages, smem, per_sm = ring_plan(c, wpb, window=window)
    return dict(path="fused", wpb=wpb, cluster=cluster, kc=kc, stages=stages, smem_bytes=smem,
                blocks=-(-windows // wpb) * cluster, blocks_per_sm=per_sm)


@functools.lru_cache(maxsize=None)
def staged_plan(c: int, b: int, hp: int, wp: int, window: int = WINDOW,
                sms: int = H100_SMS) -> dict:
    """K4's staged design over ``b`` maps of hp x wp at ``window``: the
    plans of the ``qkv`` ([M, 3C] by C) and ``proj`` ([M, C] by C) products
    on ``sms`` SMs, each the one of least cost of ``mlp_gemm_plans`` (on a
    tie the one of fewer tiles), M = b hp wp; the attention launch's
    ``attn_blocks``, one a (window, head).  Cached: do not modify the dict."""
    m = b * hp * wp

    def pick(n):
        return min(mlp_gemm_plans(m, n, c, False, sms), key=lambda p: (p["cost"], p["tiles"]))

    return dict(path="staged", window=window, qkv=pick(3 * c), proj=pick(c),
                attn_blocks=b * (hp // window) * (wp // window) * (c // HEAD_DIM))


# K5's launch plan (csrc/swin_block_mlp.cu, bf16).  Up to C = 384 the fused
# kernel keeps the hidden map on chip; from C = 512 on the LN pass and the
# two wgmma products put it through device memory.
MLP_WGMMA_MIN_C = 512
MLP_BM, MLP_KC = 128, 64     # rows of a product's tile, channels of a k-chunk
MLP_GELU_TABLE = 11_776      # fc1's GELU table (5,888 bf16 entries), bytes
# The products' cost model, in the time of one k-chunk of a 128 x 256 tile
# alone on an SM (measured on an H100 by utils/k5_bench.py --candidates and
# the blocks' phase cycles): a chunk of a wave at bn columns and one or two
# blocks an SM (two narrow tiles share the tensor cores; one alone leaves
# them idle part of the time), and a block's fixed cost, its first boxes'
# latency and the epilogue, which grows with bn.  Two blocks an SM hide
# part of each other's fixed cost.
MLP_CHUNK = {(256, 1): 1.0, (128, 1): 0.63, (128, 2): 1.1, (64, 1): 0.47, (64, 2): 0.92}
MLP_FIXED, MLP_EPILOGUE = 4.5, 9.0


def _mlp_fused_smem(c: int) -> tuple[int, int]:
    """The fused kernel's rows a block and shared bytes (``Tile`` in the
    source)."""
    tm = hc = 64 if c <= 512 else 32
    return tm, 2 * (tm * (c + 8) + tm * (hc + 8) + hc * (c + 8) + c * (hc + 8))


def mlp_gemm_smem(bn: int, stages: int, gelu: bool) -> int:
    """A product block's shared bytes (``gemm_smem`` in the source): per
    ring slot an A box of 128 rows and a weight box of ``bn`` rows, 64
    channels each in bf16; 256 bytes of barriers; the tile's fp32 bias;
    fc1's GELU table."""
    return (stages * 2 * MLP_KC * (MLP_BM + bn) + 256 + 4 * bn
            + (MLP_GELU_TABLE if gelu else 0))


def mlp_gemm_plans(m: int, n: int, k: int, gelu: bool, sms: int = H100_SMS) -> list[dict]:
    """Every launch of one wgmma product ``[m, k] x [n, k]^T`` (fc1 when
    ``gelu``) on ``sms`` SMs: ``bn`` columns a tile (64, 128 or 256,
    dividing n), one or two blocks an SM (two only up to bn 128, the
    kernel's launch bounds), and the deepest ring (3 to 5 slots) whose
    shared memory lets that many blocks share an SM.  Each carries its
    ``tiles``, ``waves`` and ``cost``, waves x (the k-loop in
    ``MLP_CHUNK`` units + a block's fixed cost, ``MLP_FIXED`` +
    ``MLP_EPILOGUE`` x bn / 256)."""
    nk = k // MLP_KC
    plans = []
    for bn in (256, 128, 64):
        if n % bn:
            continue
        for per_sm in ((1, 2) if bn <= 128 else (1,)):
            fit = [st for st in range(5, 2, -1)
                   if mlp_gemm_smem(bn, st, gelu) <= SMEM_BLOCK_LIMIT
                   and per_sm * (mlp_gemm_smem(bn, st, gelu) + 1024) <= SMEM_SM]
            if not fit:
                continue
            tiles = -(-m // MLP_BM) * (n // bn)
            waves = -(-tiles // (sms * per_sm))
            plans.append(dict(bn=bn, stages=fit[0], smem_bytes=mlp_gemm_smem(bn, fit[0], gelu),
                              blocks_per_sm=per_sm, tiles=tiles, waves=waves,
                              cost=waves * (MLP_CHUNK[(bn, per_sm)] * nk + MLP_FIXED
                                            + MLP_EPILOGUE * bn / 256)))
    return plans


@functools.lru_cache(maxsize=None)
def mlp_plan(c: int, m: int, sms: int = H100_SMS, path: str | None = None) -> dict:
    """K5's launch for ``m`` token rows of C channels.  ``path`` is C's
    unless named: ``"fused"`` up to C = 384 (one launch, ``tm`` rows a
    block), ``"wgmma"`` from 512 on (the LN pass, then the fc1 product
    [m, 4C] and the fc2 product [m, C], each with the plan of
    ``mlp_gemm_plans`` of least cost; on a tie the one of fewer tiles).
    At Swin-B's stage 2 (m = 11,760) fc1 takes 1,472 tiles of 128 x 128,
    two blocks an SM, and fc2 368, one an SM: 93% of the last waves' slots
    busy in both.  Cached (the wrapper asks at every launch): do not modify
    the dict."""
    path = path or ("wgmma" if c >= MLP_WGMMA_MIN_C else "fused")
    if path == "fused":
        tm, smem = _mlp_fused_smem(c)
        return dict(path=path, tm=tm, smem_bytes=smem, tiles=-(-m // tm))
    pick = {}
    for name, n, k in (("fc1", 4 * c, c), ("fc2", c, 4 * c)):
        pick[name] = min(mlp_gemm_plans(m, n, k, name == "fc1", sms),
                         key=lambda p: (p["cost"], p["tiles"]))
    return dict(path=path, **pick)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check_x(x, what: str):
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"the {what} kernel takes float32 or bfloat16, not {x.dtype}")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous [B, Hp, Wp, C] map, got {tuple(x.shape)}")


def _check_shape(t, shape, name: str, device):
    if tuple(t.shape) != tuple(shape) or t.device != device:
        raise ValueError(f"{name} must be {list(shape)} on {device}, got "
                         f"{list(t.shape)} on {t.device}")


def _check_no_grad(tensors, what: str):
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"the {what} kernel is inference-only: call it under torch.no_grad()")


def swin_block_attn(x, ln_g, ln_b, wqkv, bqkv, bias, mask, wproj, bproj,
                    window: int, num_heads: int, valid_hw, shift: int = 0,
                    eps: float = _EPS):
    """Swin attention half-block → ``x + attn_block(x)``, still rolled.

    x ``[B, Hp, Wp, C]`` residual stream, pre-rolled by ``shift`` when
    ``shift > 0``; ln_g/ln_b ``[C]``; wqkv ``[3C, C]``, bqkv ``[3C]``; bias
    ``[h, w², w²]`` fp32; mask ``[Hp/w, Wp/w, w², w²]`` fp32 or None; wproj
    ``[C, C]``, bproj ``[C]``; ``window`` w 7 or 12; valid_hw the true (H, W)
    before the window padding.  CPU tensors: the plain version.  CUDA
    tensors: kernel K4, in the design of ``attn_plan``."""
    if x.device.type == "cpu":
        return swin_block_attn_ref(x, ln_g, ln_b, wqkv, bqkv, bias, mask, wproj,
                                   bproj, window, num_heads, valid_hw, shift, eps)
    _check_x(x, "Swin attention")
    b, hp, wp, c = x.shape
    if window not in ATTN_WINDOWS or hp % window or wp % window:
        raise ValueError(f"the Swin attention kernel takes a window in {ATTN_WINDOWS} over a "
                         f"map padded to its multiples, got window {window}, map {hp}x{wp}")
    if num_heads * HEAD_DIM != c or c > MAX_C:
        raise ValueError(f"the Swin attention kernel takes {HEAD_DIM} channels per head "
                         f"and C <= {MAX_C}, got C={c}, {num_heads} heads")
    staged = attn_path(c, window) == "staged"
    if staged and c % 64:
        raise ValueError(f"the Swin attention kernel's staged design (window {window}, C={c}) "
                         "takes C a multiple of 64, its products' k-chunk")
    hv, wv = valid_hw
    if not (0 < hv <= hp and 0 < wv <= wp and 0 <= shift < window):
        raise ValueError(f"valid_hw {tuple(valid_hw)} / shift {shift} do not fit map {hp}x{wp}")
    dev, n = x.device, window * window
    for t, shape, name in ((ln_g, (c,), "ln_g"), (ln_b, (c,), "ln_b"),
                           (wqkv, (3 * c, c), "wqkv"), (bqkv, (3 * c,), "bqkv"),
                           (wproj, (c, c), "wproj"), (bproj, (c,), "bproj"),
                           (bias, (num_heads, n, n), "bias")):
        _check_shape(t, shape, name, dev)
    if mask is not None:
        _check_shape(mask, (hp // window, wp // window, n, n), "mask", dev)
    _check_no_grad((x, ln_g, ln_b, wqkv, bqkv, bias, wproj, bproj), "Swin attention")
    out = torch.empty_like(x)
    wqkv, wproj = wqkv.to(x.dtype).contiguous(), wproj.to(x.dtype).contiguous()
    if any(t.data_ptr() % 16 for t in (x, wqkv, wproj)):
        raise ValueError("x, wqkv and wproj must be 16-byte aligned (the kernel reads "
                         "them by TMA and 16-byte copies)")
    if x.numel() == 0:
        return out
    lib = _build.load("swin_block_attn")
    if staged and x.dtype == torch.bfloat16:
        launch_attn_staged(x, ln_g, ln_b, wqkv, bqkv, bias, mask, wproj, bproj, out, window,
                           num_heads, valid_hw, shift, eps)
    else:
        # the attention output of each window in device memory (see the
        # source); the fp32 instantiation keeps the LN'd window there too
        plan = attn_plan(c, b, hp, wp, window) if x.dtype == torch.bfloat16 else {}
        windows = b * (hp // window) * (wp // window)
        scratch = torch.empty((2 if x.dtype == torch.float32 else 1, windows, n, c),
                              dtype=x.dtype, device=dev)
        args = [x, _f32(ln_g), _f32(ln_b), wqkv, _f32(bqkv), _f32(bias),
                None if mask is None else _f32(mask), wproj, _f32(bproj), out, scratch]
        fn = lib.swin_block_attn_fwd
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 9 + [
            ctypes.c_float] + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        err = fn(*[None if t is None else t.data_ptr() for t in args],
                 b, hp, wp, c, num_heads, hv, wv, shift, window, float(eps),
                 _DTYPE_CODE[x.dtype],
                 *[plan.get(k, 0) for k in ("wpb", "cluster", "kc", "stages", "smem_bytes")],
                 _build.stream_ptr(dev))
        _build.check(lib, err, "swin_block_attn_fwd")
    swin_block_attn.launches += 1
    return out


swin_block_attn.launches = 0


def launch_attn_staged(x, ln_g, ln_b, wqkv, bqkv, bias, mask, wproj, bproj, out, window: int,
                       num_heads: int, valid_hw, shift: int = 0, eps: float = _EPS):
    """Launch K4's staged design on checked bf16 CUDA inputs
    (``swin_block_attn``; wqkv, wproj already in x's dtype) into ``out``
    with ``staged_plan`` for this device's SMs, whatever ``attn_path``
    takes at its shape; counts no launch.  Returns its scratch maps: o
    ``[B, Hp, Wp, C]`` (the LN pass's map, which the attention overwrites)
    and qkv ``[B, Hp, Wp, 3C]``."""
    b, hp, wp, c = x.shape
    plan = staged_plan(c, b, hp, wp, window, _sm_count(x.device.index))
    o = torch.empty_like(x)
    qkv = torch.empty((b, hp, wp, 3 * c), dtype=x.dtype, device=x.device)
    args = [x, _f32_a16(ln_g), _f32_a16(ln_b), wqkv, _f32(bqkv), _f32_a16(bias),
            None if mask is None else _f32_a16(mask), wproj, _f32(bproj), out, o, qkv]
    lib = _build.load("swin_block_attn")
    fn = lib.swin_block_attn_staged
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 9 + [
        ctypes.c_float] + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    err = fn(*[None if t is None else t.data_ptr() for t in args],
             b, hp, wp, c, num_heads, *valid_hw, shift, window, float(eps),
             *[plan[p][k] for p in ("qkv", "proj") for k in ("bn", "stages", "smem_bytes")],
             _build.stream_ptr(x.device))
    _build.check(lib, err, "swin_block_attn_staged")
    return o, qkv


def swin_block_mlp(x, ln_g, ln_b, w1, b1, w2, b2, eps: float = _EPS):
    """Swin MLP half-block → ``x + fc2(gelu(fc1(LN2(x))))``.

    x ``[..., C]`` contiguous; w1 ``[4C, C]``, b1 ``[4C]``, w2 ``[C, 4C]``,
    b2 ``[C]``.  CPU tensors: the plain version.  CUDA tensors: kernel K5,
    launched with ``mlp_plan``."""
    if x.device.type == "cpu":
        return swin_block_mlp_ref(x, ln_g, ln_b, w1, b1, w2, b2, eps)
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"the Swin MLP kernel takes float32 or bfloat16, not {x.dtype}")
    if x.dim() < 2 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous [..., C] tensor, got {tuple(x.shape)}")
    c = x.shape[-1]
    if c not in MLP_C:
        raise ValueError(f"the Swin MLP kernel is built for C in {MLP_C}, got {c}")
    dev = x.device
    for t, shape, name in ((ln_g, (c,), "ln_g"), (ln_b, (c,), "ln_b"),
                           (w1, (4 * c, c), "w1"), (b1, (4 * c,), "b1"),
                           (w2, (c, 4 * c), "w2"), (b2, (c,), "b2")):
        _check_shape(t, shape, name, dev)
    _check_no_grad((x, ln_g, ln_b, w1, b1, w2, b2), "Swin MLP")
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    w1, w2 = w1.to(x.dtype).contiguous(), w2.to(x.dtype).contiguous()
    if any(t.data_ptr() % 16 for t in (x, w1, w2)):
        raise ValueError("x, w1 and w2 must be 16-byte aligned (the kernel reads them "
                         "by TMA and 16-byte copies)")
    launch_mlp(x, ln_g, ln_b, w1, b1, w2, b2, out, eps)
    swin_block_mlp.launches += 1
    return out


swin_block_mlp.launches = 0


def launch_mlp(x, ln_g, ln_b, w1, b1, w2, b2, out, eps: float = _EPS, plan=None):
    """Launch K5 on checked CUDA inputs (``swin_block_mlp``; w1, w2 already
    in x's dtype) into ``out`` with ``plan`` (bf16 only; default
    ``mlp_plan`` for this device's SMs); counts no launch.  Returns the
    wgmma path's scratch maps ``(y [M, C], h [M, 4C])``, else None."""
    c = x.shape[-1]
    m = x.numel() // c
    lib = _build.load("swin_block_mlp")
    params = [x, _f32(ln_g), _f32(ln_b), w1, _f32(b1), w2, _f32(b2), out]
    if x.dtype == torch.bfloat16:
        plan = plan or mlp_plan(c, m, _sm_count(x.device.index))
        if plan["path"] == "wgmma":
            params[1:3] = _f32_a16(ln_g), _f32_a16(ln_b)
            y = torch.empty((m, c), dtype=x.dtype, device=x.device)
            h = torch.empty((m, 4 * c), dtype=x.dtype, device=x.device)
            table = torch.empty(MLP_GELU_TABLE // 2, dtype=x.dtype, device=x.device)
            fc1, fc2 = plan["fc1"], plan["fc2"]
            fn = lib.swin_block_mlp_wgmma
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 2 + [
                ctypes.c_float] + [ctypes.c_int] * 6 + [ctypes.c_void_p]
            err = fn(*[t.data_ptr() for t in (*params, y, h, table)], m, c, float(eps),
                     *[p[k] for p in (fc1, fc2) for k in ("bn", "stages", "smem_bytes")],
                     _build.stream_ptr(x.device))
            _build.check(lib, err, "swin_block_mlp_wgmma")
            return y, h
    fn = lib.swin_block_mlp_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 2 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    err = fn(*[t.data_ptr() for t in params], m, c, float(eps),
             _DTYPE_CODE[x.dtype], _build.stream_ptr(x.device))
    _build.check(lib, err, "swin_block_mlp_fwd")
    return None
