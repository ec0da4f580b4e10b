"""RMSNorm: plain PyTorch version + CUDA kernels, forward and backward.

Port of :mod:`repro.kernels.rmsnorm` (``rmsnorm_2d``), whose math is
``y = x * rsqrt(mean(x^2) + eps) * w`` in float32, cast back to x's
dtype (also ``repro.kernels.ref.rmsnorm_ref``).

- :func:`rmsnorm_ref` is the plain version; on the CPU its gradient is
  torch autograd's.
- :func:`rmsnorm` runs ``csrc/rmsnorm.cu`` through :class:`RMSNorm`, a
  ``torch.autograd.Function`` whose forward and backward are both
  kernels (which TPU kernel it replaces, what bounds it and its design
  are in the source's header). It takes CUDA tensors only and raises on
  anything else; it never falls back to the plain version.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

EPS = 1e-6
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def rmsnorm_ref(x, w, *, eps: float = EPS):
    """Plain version: x (..., D), w (D,). Returns x's shape and dtype."""
    x32 = x.float()
    ms = x32.square().mean(-1, keepdim=True)
    return (x32 * torch.rsqrt(ms + eps) * w.float()).to(x.dtype)


_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {
    # x, w, y, rstd, dtype, R, D, eps, stream
    "rmsnorm_fwd_launch": [_P] * 4 + [_I] * 3 + [ctypes.c_float, _P],
    # x, w, dy, dx, dtype, R, D
    "rmsnorm_bwd_partials": [_P] * 4 + [_I] * 3,
    # x, w, rstd, dy, dx, dw, partial, dtype, R, D, n_part, stream
    "rmsnorm_bwd_launch": [_P] * 7 + [_I] * 4 + [_P],
}


def _fn(name):
    fn = getattr(build.load("rmsnorm"), name)
    if not fn.argtypes:
        fn.restype = ctypes.c_int
        fn.argtypes = _ARGTYPES[name]
    return fn


def _check(x, w):
    if not (x.is_cuda and w.is_cuda):
        raise ValueError("the rmsnorm kernels take CUDA tensors only; the "
                         "plain version is rmsnorm_ref")
    if x.dtype not in _DTYPE_CODE or w.dtype != torch.float32:
        raise ValueError(f"dtypes x={x.dtype} w={w.dtype}: need x float32 "
                         "or bfloat16 and w float32")
    if x.dim() != 2 or w.shape != (x.shape[1],) or x.shape[1] == 0:
        raise ValueError(f"need x (R, D) and w (D,), got {tuple(x.shape)} "
                         f"and {tuple(w.shape)}")


def rmsnorm_fwd(x, w, eps: float = EPS):
    """Forward kernel: x (R, D) float32/bf16, w (D,) float32. Returns
    (y like x, rstd (R,) float32). Adds one to ``rmsnorm_fwd.launches``."""
    _check(x, w)
    x = x.contiguous()
    R, D = x.shape
    y = torch.empty_like(x)
    rstd = x.new_empty(R, dtype=torch.float32)
    if R:
        rc = _fn("rmsnorm_fwd_launch")(
            x.data_ptr(), w.contiguous().data_ptr(), y.data_ptr(),
            rstd.data_ptr(), _DTYPE_CODE[x.dtype], R, D, eps, build.stream_ptr(x))
        build.check(rc, "rmsnorm_fwd_launch")
        rmsnorm_fwd.launches += 1
    return y, rstd


def rmsnorm_bwd(x, w, rstd, dy):
    """Backward kernels: returns (dx like x, dw (D,) float32), dw summed
    in a fixed order over a number of partial rows that the launcher
    picks from the shape and the card alone. Adds one to
    ``rmsnorm_bwd.launches``."""
    _check(x, w)
    if dy.shape != x.shape or dy.dtype != x.dtype or not dy.is_cuda:
        raise ValueError("dy must match x's shape, dtype and device")
    x, dy, w = x.contiguous(), dy.contiguous(), w.contiguous()
    R, D = x.shape
    dx = torch.empty_like(x)
    if not R:
        return dx, torch.zeros(D, dtype=torch.float32, device=x.device)
    dw = torch.empty(D, dtype=torch.float32, device=x.device)
    ptrs = x.data_ptr(), w.data_ptr(), dy.data_ptr(), dx.data_ptr()
    code = _DTYPE_CODE[x.dtype]
    n_part = _fn("rmsnorm_bwd_partials")(*ptrs, code, R, D)
    partial = torch.empty((n_part, D), dtype=torch.float32, device=x.device)
    rc = _fn("rmsnorm_bwd_launch")(
        ptrs[0], ptrs[1], rstd.data_ptr(), ptrs[2], ptrs[3], dw.data_ptr(),
        partial.data_ptr(), code, R, D, n_part, build.stream_ptr(x))
    build.check(rc, "rmsnorm_bwd_launch")
    rmsnorm_bwd.launches += 1
    return dx, dw


rmsnorm_fwd.launches = 0
rmsnorm_bwd.launches = 0


class RMSNorm(torch.autograd.Function):
    """x (R, D), w (D,) float32 -> y; backward through the kernels."""

    @staticmethod
    def forward(ctx, x, w, eps):
        y, rstd = rmsnorm_fwd(x, w, eps)
        ctx.save_for_backward(x, w, rstd)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, w, rstd = ctx.saved_tensors
        dx, dw = rmsnorm_bwd(x, w, rstd, dy)
        return dx, dw, None


def rmsnorm(x, w, *, eps: float = EPS):
    """The kernel path, same contract as :func:`rmsnorm_ref` (x (..., D)
    on the card, any leading dims; w (D,) of any float dtype, read in
    float32 as the reference does)."""
    shape = x.shape
    y = RMSNorm.apply(x.reshape(-1, shape[-1]), w.float(), eps)
    return y.reshape(shape)
