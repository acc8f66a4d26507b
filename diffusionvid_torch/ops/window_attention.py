"""Swin window attention: kernels K6 (the qkv projection inside) and K7 (over
pre-projected q/k/v), their plain versions, and the training function.

Port of ``diffusionvid_tpu/ops/swin_attention_pallas.py``:

- ``fused_window_attention_qkv`` (K6): windowed MHA with the qkv projection
  inside, over the post-LN1, pad-zeroed, pre-rolled map, giving the
  attention output before the out-projection in map layout;
- ``fused_window_attention_qkv_trainable``: K6 forward, and a backward that
  differentiates the twin ``_einsum_window_attention_qkv``
  (``WindowAttentionQKVFn`` here; the JAX package has no backward kernel,
  so neither has the port);
- ``fused_window_attention`` (K7): the same attention over q/k/v maps
  projected beforehand.

The plain versions ``window_attention_qkv_ref`` and ``window_attention_ref``
repeat the Pallas kernels' rounding points (fp32 product plus fp32 bias,
then a round; the scores through the compute dtype and back; fp32 bias,
mask and softmax; P rounded before P·V).  The twin
``window_attention_qkv_einsum`` projects and adds the bias in the compute
dtype, as ``_einsum_window_attention_qkv`` does; in fp32 the three agree.

On CPU tensors a wrapper runs the plain version; on CUDA tensors it launches
``csrc/window_attn_qkv.cu`` or raises, in the design of ``window_path``:
at window 7 up to C = 1024 the fused designs (K6's launch plan
``qkv_plan``, K7's in bf16 ``window_plan``), at window 12 and at C = 1536
the staged designs (K6: the qkv product into a scratch map, with
``staged_plan``'s "qkv" plan, then the window attention; K7: the window
attention alone).
The wrappers compute no gradient: a CUDA input that needs one raises, and
training goes through ``WindowAttentionQKVFn``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .swin_attention import (
    ATTN_WINDOWS, H100_SMS, HEAD_DIM, MAX_ATTN_C, MAX_C, SMEM_BLOCK_LIMIT, SMEM_SM, WINDOW,
    _DTYPE_CODE, _attend, _check_no_grad, _check_shape, _check_x, _f32, _f32_a16, _mm,
    _partition, _reverse, _sm_count, ring_plan, staged_plan)


def window_attention_qkv_ref(x, wqkv, bqkv, bias, mask, window: int, num_heads: int):
    """The plain version of K6 (``swin_attention_pallas.py: _kernel_qkv``)."""
    b, hp, wp, c = x.shape
    n = window * window
    q, k, v = _mm(_partition(x, window), wqkv, bqkv).view(
        -1, n, 3, num_heads, c // num_heads).permute(2, 0, 3, 1, 4)
    return _reverse(_attend(q, k, v, bias, mask), window, b, hp, wp)


def window_attention_ref(q, k, v, bias, mask, window: int):
    """The plain version of K7 (``swin_attention_pallas.py: _kernel``); the
    head count is ``bias.shape[0]``."""
    b, hp, wp, c = q.shape
    h, n = bias.shape[0], window * window

    def heads(t):
        return _partition(t, window).view(-1, n, h, c // h).transpose(1, 2)

    return _reverse(_attend(heads(q), heads(k), heads(v), bias, mask), window, b, hp, wp)


def window_attention_qkv_einsum(x, wqkv, bqkv, bias, mask, window: int, num_heads: int):
    """Port of ``_einsum_window_attention_qkv``, the function the backward
    differentiates: q, k and v projected and biased in the compute dtype,
    then the scores' round trip, fp32 bias, mask and softmax, P rounded."""
    b, hp, wp, c = x.shape
    dt, h, n = x.dtype, num_heads, window * window
    dh = c // h
    wd, bd = wqkv.to(dt), bqkv.to(dt)

    def part(i):
        z = torch.matmul(x, wd[i * c:(i + 1) * c].t()) + bd[i * c:(i + 1) * c]
        return _partition(z, window).view(-1, n, h, dh).transpose(1, 2)

    q, k, v = part(0), part(1), part(2)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * dh ** -0.5
    s = s.to(dt).float() + bias.float()[None]
    if mask is not None:
        nw = mask.shape[0] * mask.shape[1]
        s = (s.view(-1, nw, h, n, n) + mask.reshape(nw, n, n).float()[None, :, None]
             ).view(-1, h, n, n)
    p = torch.softmax(s, -1).to(dt)
    o = torch.matmul(p, v).transpose(1, 2).reshape(-1, n, c)
    return _reverse(o, window, b, hp, wp)


# ---------------------------------------------------------------- kernels

def window_path(c: int, window: int = WINDOW) -> str:
    """K6's and K7's design for C channels at ``window``: ``"fused"`` at
    window 7 up to C = 1024, where a window's [49, C] bf16 tile fits a
    block beside K6's weight ring (K7's TMA ring is sized for window 7);
    else ``"staged"`` (window 12 at every width, C = 1536 at window 7)."""
    return "fused" if window == WINDOW and c <= MAX_ATTN_C else "staged"


def _check_map(x, window: int, num_heads: int, what: str, k_chunk: bool = False):
    """x a contiguous [B, Hp, Wp, C] map padded to ``window``'s multiples,
    ``window`` in ATTN_WINDOWS, C = 32 ``num_heads`` up to MAX_C; with
    ``k_chunk`` (K6) a multiple of 64 on the staged design, its product's
    k-chunk."""
    _check_x(x, what)
    _, hp, wp, c = x.shape
    if window not in ATTN_WINDOWS or hp % window or wp % window:
        raise ValueError(f"the {what} kernel takes a window in {ATTN_WINDOWS} over a map "
                         f"padded to its multiples, got window {window}, map {hp}x{wp}")
    if num_heads * HEAD_DIM != c or c > MAX_C:
        raise ValueError(f"the {what} kernel takes {HEAD_DIM} channels per head and "
                         f"C <= {MAX_C}, got C={c}, {num_heads} heads")
    if k_chunk and c % 64 and window_path(c, window) == "staged":
        raise ValueError(f"the {what} kernel's staged design (window {window}, C={c}) takes "
                         "C a multiple of 64, its product's k-chunk")
    if x.data_ptr() % 16:
        raise ValueError(f"the {what} kernel copies 16-byte pieces: the map must be "
                         "16-byte aligned")


def _check_bias_mask(x, bias, mask, num_heads: int, window: int):
    _, hp, wp, _ = x.shape
    n = window * window
    _check_shape(bias, (num_heads, n, n), "bias", x.device)
    if mask is not None:
        _check_shape(mask, (hp // window, wp // window, n, n), "mask", x.device)


# K6's launch plan (csrc/window_attn_qkv.cu, bf16).  A block's fixed cost
# (its x tiles, filling the ring), in rounds of products and attention.
QKV_PROLOGUE_ROUNDS = 0.5


def qkv_plans(c: int, b: int, hp: int, wp: int, sms: int = H100_SMS) -> list[dict]:
    """Every launch K6 can take for C channels over ``b`` maps of hp x wp:
    ``wpb`` windows a block (2: one to each warpgroup, both walking the
    block's heads, so that each weight tile serves two windows; 1: the two
    warpgroups take the even and the odd heads), the heads split over
    ``hsplit`` blocks (1, 2 or 4; no cluster: heads write disjoint output
    columns), and the ring (``ring_plan``; two blocks an SM only up to C =
    128, the kernel's launch bounds).  Each carries its ``blocks``,
    ``waves`` on ``sms`` SMs, ``work`` a block as a share of a block of two
    windows and all heads, and ``cost``, waves x (work + the prologue's
    share)."""
    heads = c // HEAD_DIM
    windows = b * (hp // WINDOW) * (wp // WINDOW)
    plans = []
    for wpb in (2, 1):
        ring = ring_plan(c, wpb, 2 if c <= 128 else 1)
        if ring is None:
            continue
        kc, stages, smem, per_sm = ring
        for hsplit in (1, 2, 4):
            if heads % (hsplit * (3 - wpb)):
                continue
            blocks = -(-windows // wpb) * hsplit
            waves = -(-blocks // (sms * per_sm))
            work = wpb / 2 / hsplit
            plans.append(dict(wpb=wpb, hsplit=hsplit, kc=kc, stages=stages, smem_bytes=smem,
                              blocks=blocks, blocks_per_sm=per_sm, waves=waves, work=work,
                              cost=waves * (work + QKV_PROLOGUE_ROUNDS / heads)))
    return plans


@functools.lru_cache(maxsize=None)
def qkv_plan(c: int, b: int, hp: int, wp: int, sms: int = H100_SMS) -> dict:
    """K6's launch: the plan of ``qkv_plans`` of least cost; on a tie the
    one whose weight tiles serve two windows, then the one of fewer blocks.
    For Swin-B's stage 2 over 5 frames (300 windows, 16 heads) pair mode
    would run 150 blocks of one an SM on 132 SMs, a second wave 14% full.
    Cached (the wrapper asks at every launch): do not modify the dict."""
    return min(qkv_plans(c, b, hp, wp, sms),
               key=lambda p: (p["cost"], p["wpb"] != 2, p["blocks"]))


def window_attention_qkv(x, wqkv, bqkv, bias, mask, window: int, num_heads: int):
    """Windowed MHA with the qkv projection inside → ``[B, Hp, Wp, C]``, the
    attention output before the out-projection.

    x ``[B, Hp, Wp, C]`` the post-LN1, pad-zeroed, pre-rolled map; wqkv
    ``[3C, C]``, bqkv ``[3C]``; bias ``[h, w², w²]`` fp32; mask ``[Hp/w,
    Wp/w, w², w²]`` fp32 or None; ``window`` w 7 or 12.  CPU tensors: the
    plain version.  CUDA tensors: kernel K6, in the design of
    ``window_path`` (fused: launched with ``qkv_plan``)."""
    if x.device.type == "cpu":
        return window_attention_qkv_ref(x, wqkv, bqkv, bias, mask, window, num_heads)
    _check_map(x, window, num_heads, "window attention qkv", k_chunk=True)
    b, hp, wp, c = x.shape
    _check_shape(wqkv, (3 * c, c), "wqkv", x.device)
    _check_shape(bqkv, (3 * c,), "bqkv", x.device)
    _check_bias_mask(x, bias, mask, num_heads, window)
    _check_no_grad((x, wqkv, bqkv, bias), "window attention qkv")
    wqkv = wqkv.to(x.dtype).contiguous()
    if wqkv.data_ptr() % 16:
        raise ValueError("wqkv must be 16-byte aligned (the kernel reads it by TMA)")
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    if window_path(c, window) == "staged":
        launch_qkv_staged(x, wqkv, bqkv, bias, mask, out, window, num_heads)
    else:
        launch_qkv(x, wqkv, bqkv, bias, mask, out, num_heads)
    window_attention_qkv.launches += 1
    return out


window_attention_qkv.launches = 0


def launch_qkv(x, wqkv, bqkv, bias, mask, out, num_heads: int, plan=None):
    """Launch K6 on checked CUDA inputs (``window_attention_qkv``; wqkv
    already in x's dtype) into ``out`` with ``plan`` (default ``qkv_plan``
    for this device's SMs); counts no launch."""
    b, hp, wp, c = x.shape
    lib = _build.load("window_attn_qkv")
    if plan is None:
        plan = qkv_plan(c, b, hp, wp, _sm_count(x.device.index))
    args = [x, wqkv, _f32(bqkv), _f32(bias), None if mask is None else _f32(mask), out]
    fn = lib.window_attn_qkv_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 11 + [ctypes.c_void_p]
    err = fn(*[None if t is None else t.data_ptr() for t in args], b, hp, wp, c, num_heads,
             _DTYPE_CODE[x.dtype], plan["wpb"], plan["hsplit"], plan["kc"], plan["stages"],
             plan["smem_bytes"], _build.stream_ptr(x.device))
    _build.check(lib, err, "window_attn_qkv_fwd")


def launch_qkv_staged(x, wqkv, bqkv, bias, mask, out, window: int, num_heads: int):
    """Launch K6's staged design on checked CUDA inputs
    (``window_attention_qkv``; wqkv already in x's dtype) into ``out``,
    whatever ``window_path`` takes at its shape: in bf16 the qkv product
    with ``staged_plan``'s "qkv" plan for this device's SMs, then the
    window attention; in fp32 the fp32 kernel at ``window``.  Counts no
    launch.  Returns the bf16 scratch map qkv ``[B, Hp, Wp, 3C]`` (None in
    fp32)."""
    b, hp, wp, c = x.shape
    lib = _build.load("window_attn_qkv")
    qkv, plan = None, [0, 0, 0]
    if x.dtype == torch.bfloat16:
        p = staged_plan(c, b, hp, wp, window, _sm_count(x.device.index))["qkv"]
        plan = [p["bn"], p["stages"], p["smem_bytes"]]
        qkv = torch.empty((b, hp, wp, 3 * c), dtype=x.dtype, device=x.device)
    args = [x, wqkv, _f32(bqkv), _f32_a16(bias), None if mask is None else _f32_a16(mask), out,
            qkv]
    fn = lib.window_attn_qkv_staged
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
    err = fn(*[None if t is None else t.data_ptr() for t in args], b, hp, wp, c, num_heads,
             window, _DTYPE_CODE[x.dtype], *plan, _build.stream_ptr(x.device))
    _build.check(lib, err, "window_attn_qkv_staged")
    return qkv


# K7's launch plan (csrc/window_attn_qkv.cu, bf16).  A block's fixed cost
# in head-windows: its barriers and the ring's first fill, then each head of
# its group's bias copied once.
WINDOW_PROLOGUE = 2.0
WINDOW_BIAS = 0.25
WINDOW_TILE = 3584          # a head's [49 x 32] bf16 q, k or v tile, 512-byte aligned
WINDOW_MAX_STAGES = 6       # the plan's deepest ring (the kernel takes up to 8)


def window_smem(group: int, stages: int) -> int:
    """K7's shared bytes (``WinSmem``): ``stages`` ring slots of a head's
    q, k and v tiles, the group's fp32 biases ([49, 49] padded to 9,616
    bytes each), 256 of barriers."""
    return stages * 3 * WINDOW_TILE + group * 9616 + 256


def window_plans(c: int, b: int, hp: int, wp: int, sms: int = H100_SMS) -> list[dict]:
    """Every launch K7 can take for C channels over ``b`` maps of hp x wp.
    A block takes a head ``group`` (dividing the heads; its biases stay in
    shared memory) and a run of ``wpb`` windows, and walks its (window,
    head) items, heads inner, through a ring of ``stages`` slots: the
    deepest up to WINDOW_MAX_STAGES at which two blocks share an SM (the
    kernel's launch bounds), else one.  For each group, ``wpb`` is the
    shortest run that puts at most n x sms blocks on the card, n = 1 .. 8,
    and one window a block.  Each plan carries its ``blocks``,
    ``blocks_per_sm``, ``waves`` of resident blocks, ``work`` (head-windows
    a block) and ``cost``: the most blocks an SM runs times their work,
    over the blocks it runs at once, plus a prologue per wave, in
    head-windows."""
    heads = c // HEAD_DIM
    windows = b * (hp // WINDOW) * (wp // WINDOW)
    plans = []
    for group in (g for g in range(1, heads + 1) if heads % g == 0):
        for per_sm in (2, 1):
            fit = [s for s in range(3, WINDOW_MAX_STAGES + 1)
                   if per_sm * (window_smem(group, s) + 1024) <= SMEM_SM
                   and window_smem(group, s) <= SMEM_BLOCK_LIMIT]
            if fit:
                break
        if not fit:
            continue
        stages = fit[-1]
        groups = heads // group
        runs_options = {max(1, n * sms // groups) for n in range(1, 9)} | {windows}
        for wpb in sorted({-(-windows // min(r, windows)) for r in runs_options}):
            blocks = groups * -(-windows // wpb)
            per_sm_run = -(-blocks // sms)              # blocks the busiest SM runs
            at_once = min(per_sm_run, per_sm)
            work = group * wpb
            cost = (per_sm_run * work / at_once
                    + -(-per_sm_run // per_sm) * (WINDOW_PROLOGUE + WINDOW_BIAS * group))
            plans.append(dict(group=group, wpb=wpb, stages=stages,
                              smem_bytes=window_smem(group, stages), blocks=blocks,
                              blocks_per_sm=per_sm, waves=-(-blocks // (sms * per_sm)),
                              work=work, cost=cost))
    return plans


@functools.lru_cache(maxsize=None)
def window_plan(c: int, b: int, hp: int, wp: int, sms: int = H100_SMS) -> dict:
    """K7's launch: the plan of ``window_plans`` of least cost; on a tie the
    one of fewer blocks.  Swin-B's stages 2 and 3 over 4 frames (240 and 60
    windows of 16 and 32 heads) then run about two blocks an SM, where one
    block a window left 72 of 132 SMs idle at stage 3.  Cached (the wrapper
    asks at every launch): do not modify the dict."""
    return min(window_plans(c, b, hp, wp, sms), key=lambda p: (p["cost"], p["blocks"]))


def window_attention(q, k, v, bias, mask, window: int):
    """Windowed MHA over pre-projected q/k/v maps ``[B, Hp, Wp, C]`` →
    ``[B, Hp, Wp, C]``; ``h = bias.shape[0]``; ``window`` w 7 or 12.  CPU
    tensors: the plain version.  CUDA tensors: kernel K7, in the design of
    ``window_path`` (fused: in bf16 launched with ``window_plan``)."""
    if q.device.type == "cpu":
        return window_attention_ref(q, k, v, bias, mask, window)
    h = bias.shape[0] if bias.dim() == 3 else 0
    for t in (q, k, v):
        _check_map(t, window, h, "window attention")
    if k.shape != q.shape or v.shape != q.shape or not (q.dtype == k.dtype == v.dtype) \
            or not (q.device == k.device == v.device):
        raise ValueError(f"q, k and v must share shape, dtype and device, got "
                         f"{[tuple(t.shape) for t in (q, k, v)]}, "
                         f"{[t.dtype for t in (q, k, v)]}")
    _check_bias_mask(q, bias, mask, h, window)
    _check_no_grad((q, k, v, bias), "window attention")
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    if window_path(q.shape[-1], window) == "staged":
        launch_window_staged(q, k, v, bias, mask, out, window)
    else:
        launch_window(q, k, v, bias, mask, out)
    window_attention.launches += 1
    return out


window_attention.launches = 0


def launch_window(q, k, v, bias, mask, out, plan=None):
    """Launch K7 on checked CUDA inputs (``window_attention``) into ``out``;
    in bf16 with ``plan`` (default ``window_plan`` for this device's SMs),
    in fp32 the first design (no plan); counts no launch."""
    b, hp, wp, c = q.shape
    lib = _build.load("window_attn_qkv")
    if q.dtype == torch.bfloat16 and plan is None:
        plan = window_plan(c, b, hp, wp, _sm_count(q.device.index))
    ring = [plan[k_] for k_ in ("group", "wpb", "stages", "smem_bytes")] if plan else [0] * 4
    args = [q, k, v, _f32(bias), None if mask is None else _f32(mask), out]
    fn = lib.window_attn_fwd
    if getattr(fn, "argtypes", None) is None:   # once: ctypes rebuilds its converters each time
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
    err = fn(*[None if t is None else t.data_ptr() for t in args], b, hp, wp, c,
             bias.shape[0], _DTYPE_CODE[q.dtype], *ring, _build.stream_ptr(q.device))
    _build.check(lib, err, "window_attn_fwd")


def launch_window_staged(q, k, v, bias, mask, out, window: int):
    """Launch K7's staged design on checked CUDA inputs
    (``window_attention``) into ``out``, whatever ``window_path`` takes at
    its shape: one launch of the window attention over q, k and v (bf16),
    or the fp32 kernel at ``window``; counts no launch."""
    b, hp, wp, c = q.shape
    lib = _build.load("window_attn_qkv")
    args = [q, k, v, _f32_a16(bias), None if mask is None else _f32_a16(mask), out]
    fn = lib.window_attn_staged
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    err = fn(*[None if t is None else t.data_ptr() for t in args], b, hp, wp, c, bias.shape[0],
             window, _DTYPE_CODE[q.dtype], _build.stream_ptr(q.device))
    _build.check(lib, err, "window_attn_staged")


class WindowAttentionQKVFn(torch.autograd.Function):
    """``fused_window_attention_qkv_trainable``: the forward is
    ``window_attention_qkv`` (K6 on the card, the plain version on the
    CPU); the backward recomputes ``window_attention_qkv_einsum`` from the
    saved inputs and returns its gradients for x, wqkv, bqkv and bias, as
    ``_fwa_bwd`` does.  Only the inputs are saved, never the output or the
    scores.  The mask is a constant and gets no gradient.

    ``WindowAttentionQKVFn.apply(x, wqkv, bqkv, bias, mask, window, num_heads)``."""

    @staticmethod
    def forward(ctx, x, wqkv, bqkv, bias, mask, window: int, num_heads: int):
        ctx.save_for_backward(x, wqkv, bqkv, bias, mask)
        ctx.window, ctx.num_heads = window, num_heads
        return window_attention_qkv(x, wqkv, bqkv, bias, mask, window, num_heads)

    @staticmethod
    def backward(ctx, g):
        x, wqkv, bqkv, bias, mask = ctx.saved_tensors
        with torch.enable_grad():
            ins = [t.detach().requires_grad_() for t in (x, wqkv, bqkv, bias)]
            out = window_attention_qkv_einsum(*ins, mask, ctx.window, ctx.num_heads)
            grads = torch.autograd.grad(out, ins, g)
        return (*grads, None, None, None)
