"""Flash attention: plain PyTorch version + CUDA kernels, forward and
backward.

Port of :mod:`repro.kernels.flash_attention` (``flash_attention_bhsd``):
blocked GQA softmax attention, query head h reading KV head
``h // (H / Hkv)``, scale ``1/sqrt(hd)``, causal mask ``qpos >= kpos``
with both positions counted from 0 (top-left, also when Sq != Sk),
float32 softmax, output in q's dtype.

- :func:`flash_attention_ref` is the plain version in the TPU kernel's
  layout (B, H, S, hd): the dense softmax of ``repro.kernels.ref``; on
  the CPU its gradient is torch autograd's.
- :func:`flash_attention` runs ``csrc/flash_attention.cu`` in the model
  layout (B, S, H, hd) through :class:`FlashAttention`, a
  ``torch.autograd.Function`` whose forward and backward are kernels
  (which TPU kernel it replaces, what bounds it and its design are in the
  source's header). It takes CUDA tensors only and raises on anything
  else; it never falls back to the plain version.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build

NEG_INF = -1e30
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 32, 64, 128)


def flash_attention_ref(q, k, v, *, causal: bool = True):
    """Plain version. q: (B, H, Sq, hd); k/v: (B, Hkv, Sk, hd). Returns
    (B, H, Sq, hd) in q's dtype."""
    B, H, Sq, hd = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    g = H // Hkv
    qg = q.reshape(B, Hkv, g, Sq, hd).float() / math.sqrt(hd)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.float())
    if causal:
        mask = (torch.arange(Sq, device=q.device)[:, None]
                >= torch.arange(Sk, device=q.device)[None, :])
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float())
    return o.reshape(B, H, Sq, hd).to(q.dtype)


def _fn(name, n_ptr):
    fn = getattr(build.load("flash_attention"), name)
    if not fn.argtypes:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 8
                       + [ctypes.c_float, ctypes.c_void_p])
    return fn


def _check(q, k, v):
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError("the flash attention kernels take CUDA tensors "
                         "only; the plain version is flash_attention_ref")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"dtypes q={q.dtype} k={k.dtype} v={v.dtype}: "
                         "need one of float32/bfloat16 for all three")
    B, Sq, H, hd = q.shape
    if k.dim() != 4 or k.shape[0] != B or k.shape[3] != hd \
            or v.shape != k.shape:
        raise ValueError(f"need q (B, Sq, H, hd) and k = v (B, Sk, Hkv, hd),"
                         f" got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if hd not in _HEAD_DIMS or H % k.shape[2] or 0 in q.shape \
            or k.shape[1] == 0:
        raise ValueError(f"head dim {hd} not in {_HEAD_DIMS}, H % Hkv != 0 "
                         "or an empty axis")


def _dims(q, k, causal):
    B, Sq, H, hd = q.shape
    return (_DTYPE_CODE[q.dtype], B, Sq, k.shape[1], H, k.shape[2], hd,
            int(causal), 1.0 / math.sqrt(hd),
            torch.cuda.current_stream(q.device).cuda_stream)


def flash_attention_fwd(q, k, v, causal: bool = True):
    """Forward kernel in model layout: q (B, Sq, H, hd), k/v (B, Sk, Hkv,
    hd). Returns (o like q, lse (B, H, Sq) float32). Adds one to
    ``flash_attention_fwd.launches``."""
    _check(q, k, v)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    B, Sq, H, _ = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    rc = _fn("flash_attention_fwd_launch", 5)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), *_dims(q, k, causal))
    build.check(rc, "flash_attention_fwd_launch")
    flash_attention_fwd.launches += 1
    return o, lse


def flash_attention_bwd(q, k, v, o, lse, do, causal: bool = True):
    """Backward kernels (row term, dK/dV, dQ). Returns (dq, dk, dv) like
    (q, k, v), each summed in a fixed order. Adds one to
    ``flash_attention_bwd.launches``."""
    _check(q, k, v)
    if do.shape != q.shape or do.dtype != q.dtype or o.shape != q.shape:
        raise ValueError("o and do must match q's shape and dtype")
    q, k, v, o, do = (t.contiguous() for t in (q, k, v, o, do))
    B, Sq, H, _ = q.shape
    delta = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), \
        torch.empty_like(v)
    rc = _fn("flash_attention_bwd_launch", 10)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        do.data_ptr(), lse.contiguous().data_ptr(), delta.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), *_dims(q, k, causal))
    build.check(rc, "flash_attention_bwd_launch")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_fwd.launches = 0
flash_attention_bwd.launches = 0


class FlashAttention(torch.autograd.Function):
    """Model layout q (B, Sq, H, hd), k/v (B, Sk, Hkv, hd) -> o."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        o, lse = flash_attention_fwd(q, k, v, causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, ctx.causal)
        return dq, dk, dv, None


def flash_attention(q, k, v, *, causal: bool = True):
    """The kernel path in model layout (B, S, H, hd); differentiable."""
    return FlashAttention.apply(q, k, v, causal)

