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


def _fn(name, n_ptr, n_int):
    fn = getattr(build.load("rmsnorm"), name)
    if not fn.argtypes:
        fn.restype = ctypes.c_int
        tail = [ctypes.c_float] if name == "rmsnorm_fwd_launch" else []
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                       + tail + [ctypes.c_void_p])
    return fn


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


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


def dw_chunks(R: int, D: int) -> int:
    """Row chunks of the dw reduction: a function of the shape alone, so
    the summation order (and dw's bits) never change between runs."""
    col_blocks = -(-D // 256)
    return max(1, min(R, 1024 // col_blocks))


def rmsnorm_fwd(x, w, eps: float = EPS):
    """Forward kernel: x (R, D) float32/bf16, w (D,) float32. Returns
    (y like x, rstd (R,) float32). Adds one to ``rmsnorm_fwd.launches``."""
    _check(x, w)
    x = x.contiguous()
    R, D = x.shape
    y = torch.empty_like(x)
    rstd = torch.empty(R, dtype=torch.float32, device=x.device)
    if R:
        rc = _fn("rmsnorm_fwd_launch", 4, 3)(
            x.data_ptr(), w.contiguous().data_ptr(), y.data_ptr(),
            rstd.data_ptr(), _DTYPE_CODE[x.dtype], R, D, eps, _stream(x))
        build.check(rc, "rmsnorm_fwd_launch")
        rmsnorm_fwd.launches += 1
    return y, rstd


def rmsnorm_bwd(x, w, rstd, dy):
    """Backward kernels: returns (dx like x, dw (D,) float32), dw summed
    in a fixed order. Adds one to ``rmsnorm_bwd.launches``."""
    _check(x, w)
    if dy.shape != x.shape or dy.dtype != x.dtype or not dy.is_cuda:
        raise ValueError("dy must match x's shape, dtype and device")
    x, dy = x.contiguous(), dy.contiguous()
    R, D = x.shape
    dx = torch.empty_like(x)
    dw = torch.zeros(D, dtype=torch.float32, device=x.device)
    if R:
        n_chunks = dw_chunks(R, D)
        partial = torch.empty((n_chunks, D), dtype=torch.float32,
                              device=x.device)
        rc = _fn("rmsnorm_bwd_launch", 7, 4)(
            x.data_ptr(), w.contiguous().data_ptr(), rstd.data_ptr(),
            dy.data_ptr(), dx.data_ptr(), dw.data_ptr(), partial.data_ptr(),
            _DTYPE_CODE[x.dtype], R, D, n_chunks, _stream(x))
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
