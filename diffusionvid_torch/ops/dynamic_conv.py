"""Fused DynamicConv chain: kernel K2 and its plain version.

Port of ``diffusionvid_tpu/ops/dynamic_conv_pallas.py``.  Per proposal:
``relu(LN(relu(LN(roi @ p1t^T)) @ p2e))`` with fp32 products rounded to
the compute dtype before each fp32 LayerNorm.  ``p1t`` and ``p2e`` are
e-major ``[S, E, D]``.  On CPU tensors the wrapper runs the plain version;
on CUDA tensors it launches ``csrc/dynamic_conv.cu`` or raises.  The
gradient recomputes through the plain version, as the JAX custom VJP does.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

_EPS = 1e-5
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_KERNEL_SHAPE = (49, 64, 256)   # (P, E, D) the kernel is compiled for


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


def _launch(roi, p1t, p2e, g1, b1, g2, b2, eps):
    _check_kernel_inputs(roi, p1t, p2e, (g1, b1, g2, b2))
    out = torch.empty_like(roi)
    if roi.shape[0] == 0:
        return out
    lib = _build.load("dynamic_conv")
    fn = lib.dynamic_conv_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int, ctypes.c_float,
                                            ctypes.c_int, ctypes.c_void_p])
    err = fn(roi.data_ptr(), p1t.data_ptr(), p2e.data_ptr(), g1.data_ptr(),
             b1.data_ptr(), g2.data_ptr(), b2.data_ptr(), out.data_ptr(),
             roi.shape[0], float(eps), _DTYPE_CODE[roi.dtype],
             _build.stream_ptr(roi.device))
    _build.check(lib, err, "dynamic_conv_fwd")
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
