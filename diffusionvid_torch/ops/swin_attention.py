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

import torch

from . import _build

_EPS = 1e-5
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
WINDOW = 7          # the window every Swin size of the kernels uses
HEAD_DIM = 32       # channels per head, shared by Swin-T/S/B/L
MAX_ATTN_C = 1024   # K4 keeps a window's [49, C] bf16 tile in shared memory
MLP_C = (96, 128, 192, 256, 384, 512, 768, 1024)   # K5 is compiled per width


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


def swin_block_attn_ref(x, ln_g, ln_b, wqkv, bqkv, bias, mask, wproj, bproj,
                        window: int, num_heads: int, valid_hw, shift: int = 0,
                        eps: float = _EPS):
    """The plain version of K4 (``swin_attention_pallas.py: _kernel_block_attn``)."""
    b, hp, wp, c = x.shape
    dt, w, h = x.dtype, window, num_heads
    y = _ln_f32(x, ln_g, ln_b, eps)
    hv, wv = valid_hw
    if (hp, wp) != (hv, wv):
        # zero the window padding, in the coordinates of the rolled map
        rows = (torch.arange(hp, device=x.device) + shift) % hp < hv
        cols = (torch.arange(wp, device=x.device) + shift) % wp < wv
        y = y * (rows[:, None] & cols[None, :]).float()[:, :, None]
    xw = _partition(y.to(dt), w)
    q, k, v = _mm(xw, wqkv, bqkv).view(-1, w * w, 3, h, c // h).permute(2, 0, 3, 1, 4)
    o = _attend(q, k, v, bias, mask)
    return x + _reverse(_mm(o, wproj, bproj), w, b, hp, wp)


def swin_block_mlp_ref(x, ln_g, ln_b, w1, b1, w2, b2, eps: float = _EPS):
    """The plain version of K5 (``swin_attention_pallas.py: _kernel_block_mlp``)."""
    dt = x.dtype
    y = _ln_f32(x, ln_g, ln_b, eps).to(dt)
    z = _mm(y, w1, b1).float()
    z = (0.5 * z * (1.0 + torch.erf(z * 2.0 ** -0.5))).to(dt)
    return x + _mm(z, w2, b2)


# ---------------------------------------------------------------- kernels

def _f32(t):
    return t.to(torch.float32).contiguous()


# K4's launch plan (csrc/swin_block_attn.cu, bf16).  An H100 SM has 228 KB
# of shared memory; a block may take 227 KB of it (232,448 bytes), and each
# block in an SM also holds 1 KB for the system.
SMEM_BLOCK_LIMIT = 232_448
SMEM_SM = 233_472


def _attn_smem(c: int, wpb: int, kc: int, stages: int) -> int:
    """K4's shared bytes (``SmemBf16`` in the source): the weight ring of
    ``stages`` slots of 96 rows (192 in split mode) of ``kc`` channels;
    ``wpb`` LN tiles [49, C] in bf16, each row padded by 8 elements; per
    warpgroup k [64, 40] and v^T [32, 72] in bf16; a mask per window and
    two attention biases (fp32 [49, 49], 9,616 bytes each); 256 bytes of
    barriers."""
    n, spl = WINDOW * WINDOW, 3 - wpb
    return (stages * 2 * 96 * spl * kc + 2 * n * (c + 8) * wpb
            + 2 * 2 * (64 * 40 + 32 * 72) + (wpb + 2) * 9616 + 256)


def ring_plan(c: int, wpb: int, per_sm_max: int = 2):
    """The weight ring of a ring kernel (K4, K6) at C channels with ``wpb``
    windows a block: ``kc`` (32 or 64 channels) a chunk and ``stages`` (3
    to 5) slots, the most bytes in flight (stages - 1 slots) at which
    ``per_sm_max`` blocks share an SM, else at which fewer do, the wider
    chunk on a tie.  Returns (kc, stages, shared bytes, blocks an SM), or
    None where not even one block fits."""
    options = [(kc, st) for kc in (64, 32) for st in range(5, 2, -1) if c % kc == 0]
    size = {o: _attn_smem(c, wpb, *o) for o in options}
    for per_sm in range(per_sm_max, 0, -1):
        fit = [o for o in options
               if size[o] <= SMEM_BLOCK_LIMIT and per_sm * (size[o] + 1024) <= SMEM_SM]
        if fit:
            kc, stages = max(fit, key=lambda o: ((o[1] - 1) * o[0], o[0]))
            return kc, stages, size[(kc, stages)], per_sm
    return None


def attn_plan(c: int, b: int, hp: int, wp: int) -> dict:
    """K4's launch for C channels over ``b`` maps of hp x wp.  The mode is
    C's: up to C = 512 a block takes two windows (``wpb`` 2), one to each
    warpgroup, so that each weight tile it streams serves both; from C =
    768 on, whose two LN tiles would not fit, a ``cluster`` of two blocks
    takes one window, each block half of the heads and of the
    out-projection's columns, so that Swin-B's stage 3 (60 windows) runs
    120 blocks.  Then the ring (``ring_plan``) and ``smem_bytes``."""
    wpb = 2 if c <= 512 else 1
    cluster = 3 - wpb
    kc, stages, smem, per_sm = ring_plan(c, wpb)
    windows = b * (hp // WINDOW) * (wp // WINDOW)
    return dict(wpb=wpb, cluster=cluster, kc=kc, stages=stages, smem_bytes=smem,
                blocks=-(-windows // wpb) * cluster, blocks_per_sm=per_sm)


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
    ``[h, 49, 49]`` fp32; mask ``[Hp/7, Wp/7, 49, 49]`` fp32 or None; wproj
    ``[C, C]``, bproj ``[C]``; valid_hw the true (H, W) before the window
    padding.  CPU tensors: the plain version.  CUDA tensors: kernel K4."""
    if x.device.type == "cpu":
        return swin_block_attn_ref(x, ln_g, ln_b, wqkv, bqkv, bias, mask, wproj,
                                   bproj, window, num_heads, valid_hw, shift, eps)
    _check_x(x, "Swin attention")
    b, hp, wp, c = x.shape
    n = WINDOW * WINDOW
    if window != WINDOW or hp % WINDOW or wp % WINDOW:
        raise ValueError(f"the Swin attention kernel takes window {WINDOW} over a map "
                         f"padded to its multiples, got window {window}, map {hp}x{wp}")
    if num_heads * HEAD_DIM != c or c > MAX_ATTN_C:
        raise ValueError(f"the Swin attention kernel takes {HEAD_DIM} channels per head "
                         f"and C <= {MAX_ATTN_C}, got C={c}, {num_heads} heads")
    hv, wv = valid_hw
    if not (0 < hv <= hp and 0 < wv <= wp and 0 <= shift < WINDOW):
        raise ValueError(f"valid_hw {tuple(valid_hw)} / shift {shift} do not fit map {hp}x{wp}")
    dev = x.device
    for t, shape, name in ((ln_g, (c,), "ln_g"), (ln_b, (c,), "ln_b"),
                           (wqkv, (3 * c, c), "wqkv"), (bqkv, (3 * c,), "bqkv"),
                           (wproj, (c, c), "wproj"), (bproj, (c,), "bproj"),
                           (bias, (num_heads, n, n), "bias")):
        _check_shape(t, shape, name, dev)
    if mask is not None:
        _check_shape(mask, (hp // WINDOW, wp // WINDOW, n, n), "mask", dev)
    _check_no_grad((x, ln_g, ln_b, wqkv, bqkv, bias, wproj, bproj), "Swin attention")
    out = torch.empty_like(x)
    # the attention output of each window in device memory (see the
    # source); the fp32 instantiation keeps the LN'd window there too
    windows = b * (hp // WINDOW) * (wp // WINDOW)
    scratch = torch.empty((2 if x.dtype == torch.float32 else 1, windows, n, c),
                          dtype=x.dtype, device=dev)
    wqkv, wproj = wqkv.to(x.dtype).contiguous(), wproj.to(x.dtype).contiguous()
    if any(t.data_ptr() % 16 for t in (x, wqkv, wproj)):
        raise ValueError("x, wqkv and wproj must be 16-byte aligned (the kernel reads "
                         "them by TMA and 16-byte copies)")
    args = [x, _f32(ln_g), _f32(ln_b), wqkv, _f32(bqkv), _f32(bias),
            None if mask is None else _f32(mask), wproj, _f32(bproj), out, scratch]
    if x.numel() == 0:
        return out
    plan = attn_plan(c, b, hp, wp)
    lib = _build.load("swin_block_attn")
    fn = lib.swin_block_attn_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 8 + [
        ctypes.c_float] + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    err = fn(*[None if t is None else t.data_ptr() for t in args],
             b, hp, wp, c, num_heads, hv, wv, shift, float(eps), _DTYPE_CODE[x.dtype],
             plan["wpb"], plan["cluster"], plan["kc"], plan["stages"], plan["smem_bytes"],
             _build.stream_ptr(dev))
    _build.check(lib, err, "swin_block_attn_fwd")
    swin_block_attn.launches += 1
    return out


swin_block_attn.launches = 0


def swin_block_mlp(x, ln_g, ln_b, w1, b1, w2, b2, eps: float = _EPS):
    """Swin MLP half-block → ``x + fc2(gelu(fc1(LN2(x))))``.

    x ``[..., C]`` contiguous; w1 ``[4C, C]``, b1 ``[4C]``, w2 ``[C, 4C]``,
    b2 ``[C]``.  CPU tensors: the plain version.  CUDA tensors: kernel K5."""
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
    m = x.numel() // c
    if m == 0:
        return out
    w1, w2 = w1.to(x.dtype).contiguous(), w2.to(x.dtype).contiguous()
    if any(t.data_ptr() % 16 for t in (x, w1, w2)):
        raise ValueError("x, w1 and w2 must be 16-byte aligned (the kernel copies "
                         "16-byte pieces)")
    args = [x, _f32(ln_g), _f32(ln_b), w1, _f32(b1), w2, _f32(b2), out]
    lib = _build.load("swin_block_mlp")
    fn = lib.swin_block_mlp_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 2 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    err = fn(*[t.data_ptr() for t in args], m, c, float(eps),
             _DTYPE_CODE[x.dtype], _build.stream_ptr(dev))
    _build.check(lib, err, "swin_block_mlp_fwd")
    swin_block_mlp.launches += 1
    return out


swin_block_mlp.launches = 0
