"""Fused DynamicConv chain: kernel K2 and its plain version.

Port of ``diffusionvid_tpu/ops/dynamic_conv_pallas.py``.  Per proposal:
``relu(LN(relu(LN(roi @ p1t^T)) @ p2e))`` with fp32 products rounded to
the compute dtype before each fp32 LayerNorm.  ``p1t`` and ``p2e`` are
e-major ``[S, E, D]``.  On CPU tensors the wrapper runs the plain version;
on CUDA tensors it launches ``csrc/dynamic_conv.cu`` or raises: bf16 by
the ring design (persistent blocks, whole proposals streamed by TMA into
wgmma products, launch plan ``dynconv_plan``), fp32 by the first design
(one block a proposal, the products on the fp32 cores).  The gradient
recomputes through the plain version, as the JAX custom VJP does.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .swin_attention import _sm_count

_EPS = 1e-5
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_KERNEL_SHAPE = (49, 64, 256)   # (P, E, D) the kernel is compiled for

# The ring design's shared memory (csrc/dynamic_conv.cu, namespace ring): a
# proposal's slots are part A, roi and p1t as four boxes of 64 rows x 64
# channels each, and part B, p2e's four boxes (then the output); then the
# fp32 LayerNorm weights and the mbarriers.
DYNCONV_BOX = 64 * 64 * 2
DYNCONV_SLOT_A = 2 * 4 * DYNCONV_BOX
DYNCONV_SLOT_B = 4 * DYNCONV_BOX
DYNCONV_LN = (2 * 64 + 2 * 256) * 4
DYNCONV_BARS = 256
DYNCONV_STAGES = 2          # proposals in the ring; three do not fit
# C entry point of each design: (name, argument types after the 8 pointers)
_ENTRIES = {
    "ring": ("dynamic_conv_ring", [ctypes.c_int, ctypes.c_float] + [ctypes.c_int] * 3
             + [ctypes.c_void_p]),
    "v1": ("dynamic_conv_fwd", [ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]),
}


def _ln(x, g, b, eps):
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps) * g + b).to(x.dtype)


def dynamic_conv_ref(roi, p1t, p2e, g1, b1, g2, b2, eps: float = _EPS):
    """The plain version: batched products with fp32 accumulation."""
    cdtype = roi.dtype
    x = torch.bmm(roi.float(), p1t.float().transpose(1, 2)).to(cdtype)
    x = torch.relu(_ln(x, g1, b1, eps))
    x = torch.bmm(x.float(), p2e.float()).to(cdtype)
    return torch.relu(_ln(x, g2, b2, eps))


def _check_kernel_inputs(roi, p1t, p2e, lns):
    dt = roi.dtype
    if dt not in _DTYPE_CODE:
        raise TypeError(f"the DynamicConv kernel takes float32 or bfloat16, not {dt}")
    s, p, d = roi.shape
    e = p1t.shape[1]
    if (p, e, d) != _KERNEL_SHAPE:
        raise ValueError(f"the DynamicConv kernel is built for (P, E, D) = "
                         f"{_KERNEL_SHAPE}, got {(p, e, d)}")
    for name, t in (("p1t", p1t), ("p2e", p2e)):
        if t.shape != (s, e, d) or t.dtype != dt:
            raise ValueError(f"{name} must be [{s}, {e}, {d}] {dt}, got "
                             f"{tuple(t.shape)} {t.dtype}")
    for t in (roi, p1t, p2e):
        if t.device != roi.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("roi, p1t and p2e must be contiguous and 16-byte "
                             "aligned on one device")
    for t, n in zip(lns, (e, e, d, d)):
        if t.shape != (n,) or t.dtype != torch.float32 or t.device != roi.device \
                or not t.is_contiguous():
            raise ValueError("LayerNorm weights must be contiguous float32 [E] and [D]")


@functools.lru_cache(maxsize=None)
def dynconv_plan(s: int, sms: int) -> dict:
    """The ring design's launch plan for ``s`` proposals on a card of
    ``sms`` SMs: ``grid`` persistent blocks (one an SM, fewer for fewer
    proposals), block b taking proposals b, b + grid, ...; a ring of
    ``stages`` proposals; when each part of a slot is freed (``release``);
    and the block's shared bytes, which the C entry point checks against
    its layout.  Cached (the wrapper asks at every launch): do not modify
    the dict."""
    grid = max(1, min(s, sms))
    smem = DYNCONV_STAGES * (DYNCONV_SLOT_A + DYNCONV_SLOT_B) + DYNCONV_LN + DYNCONV_BARS
    return dict(grid=grid, stages=DYNCONV_STAGES, smem_bytes=smem,
                per_block=(s // grid, -(-s // grid)),
                release={"roi, p1t": "after the first product", "p2e": "after the store"})


# design -> (library, entry name, typed ctypes function), filled at first use
_FNS: dict = {}


def _entry(design: str):
    """The library and the ctypes function of a design, typed once."""
    hit = _FNS.get(design)
    if hit is None:
        lib = _build.load("dynamic_conv")
        name, args = _ENTRIES[design]
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 8 + args
        hit = _FNS[design] = (lib, name, fn)
    return hit


def launch_dynconv(roi, p1t, p2e, g1, b1, g2, b2, out, eps: float = _EPS,
                   design: str | None = None):
    """Launch K2 on checked CUDA inputs (``_check_kernel_inputs``) into
    ``out``; counts no launch.  ``design``: ``"ring"`` (bf16 only, the
    default for bf16, with ``dynconv_plan``) or ``"v1"`` (the first
    design, the default for fp32).  Naming a design is for the
    benchmark (``utils/k2_bench.py``); the wrapper takes the default."""
    bf16 = roi.dtype == torch.bfloat16
    design = design or ("ring" if bf16 else "v1")
    if design == "ring" and not bf16:
        raise TypeError("the ring design of the DynamicConv kernel takes bfloat16")
    lib, name, fn = _entry(design)
    s = roi.shape[0]
    ptrs = [t.data_ptr() for t in (roi, p1t, p2e, g1, b1, g2, b2, out)]
    stream = _build.stream_ptr(roi.device)
    if design == "ring":
        plan = dynconv_plan(s, _sm_count(roi.device.index))
        err = fn(*ptrs, s, float(eps), plan["grid"], plan["stages"], plan["smem_bytes"], stream)
    else:
        err = fn(*ptrs, s, float(eps), _DTYPE_CODE[roi.dtype], stream)
    _build.check(lib, err, name)


def _launch(roi, p1t, p2e, g1, b1, g2, b2, eps):
    _check_kernel_inputs(roi, p1t, p2e, (g1, b1, g2, b2))
    out = torch.empty_like(roi)
    if roi.shape[0] == 0:
        return out
    launch_dynconv(roi, p1t, p2e, g1, b1, g2, b2, out, eps)
    dynamic_conv_fused.launches += 1
    return out


class _DynamicConvFn(torch.autograd.Function):
    """Forward through the kernel; backward recomputes the plain version
    (the JAX package's custom VJP, ``dynamic_conv_pallas.py:180-185``)."""

    @staticmethod
    def forward(ctx, roi, p1t, p2e, g1, b1, g2, b2, eps):
        ctx.save_for_backward(roi, p1t, p2e, g1, b1, g2, b2)
        ctx.eps = eps
        return _launch(roi, p1t, p2e, g1, b1, g2, b2, eps)

    @staticmethod
    def backward(ctx, grad):
        inputs = [t.detach().requires_grad_(need)
                  for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
        with torch.enable_grad():
            out = dynamic_conv_ref(*inputs, eps=ctx.eps)
        wrt = [t for t in inputs if t.requires_grad]
        grads = iter(torch.autograd.grad(out, wrt, grad.to(out.dtype)))
        return tuple(next(grads) if t.requires_grad else None
                     for t in inputs) + (None,)


def dynamic_conv_fused(roi, p1t, p2e, g1, b1, g2, b2, eps: float = _EPS):
    """Fused bmm→LN→relu→bmm→LN→relu → ``[S, P, D]`` in ``roi.dtype``.

    roi ``[S, P, D]``; p1t, p2e ``[S, E, D]`` e-major; g1/b1 ``[E]``,
    g2/b2 ``[D]`` float32.  CPU tensors: the plain version.  CUDA tensors:
    kernel K2, differentiable through the plain version."""
    if roi.device.type == "cpu":
        return dynamic_conv_ref(roi, p1t, p2e, g1, b1, g2, b2, eps)
    return _DynamicConvFn.apply(roi, p1t, p2e, g1, b1, g2, b2, eps)


dynamic_conv_fused.launches = 0
