"""Paged flash-decode attention: plain PyTorch version + CUDA kernel.

Port of :mod:`repro.kernels.paged_attention`. Keys live in the serve
engine's page pool (n_pages, page_size, Hkv, hd) and slot b reads its
logical page p from physical page ``page_table[b, p]``.

- :func:`paged_attention_ref` is the plain version: the gathered-view
  computation over however many table columns the caller passes, the
  same contractions, mask constant and casts as the model's
  ``dot_attention`` path, so on the CPU the fused and gathered serve
  paths agree bitwise (the reference's own contract).
- :func:`paged_flash_attention` launches ``csrc/paged_attention.cu``
  (which TPU kernel it replaces, what bounds it and its design are in
  the source's header). It takes CUDA tensors only and raises on
  anything else; it never falls back to the plain version.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

NEG_INF = -1e30
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 32, 64, 128)


def _dot_attention_paged(q, kd, vd, lengths, *, scale=None):
    """Dense GQA attention with per-slot causal offsets — a verbatim twin
    of ``repro_torch.models.attention.dot_attention(..., q_offset=
    lengths)`` (kept here: kernels/ must not depend on models/)."""
    B, Sq, H, hd = q.shape
    Hkv = kd.shape[2]
    g = H // Hkv
    scale = scale if scale is not None else hd ** -0.5
    qg = q.reshape(B, Sq, Hkv, g, hd)
    logits = torch.einsum("bqhgk,bshk->bhgqs", qg.float(), kd.float()) * scale
    Sk = kd.shape[1]
    qpos = lengths[:, None] + torch.arange(Sq, device=q.device)
    kpos = torch.arange(Sk, device=q.device)
    mask = (qpos[:, :, None] >= kpos)[:, None, None]
    logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqs,bshk->bqhgk", probs.to(vd.dtype), vd)
    return out.reshape(B, Sq, H, hd)


def paged_attention_ref(q, pk, pv, page_table, lengths):
    """Plain version in model layout — q: (B, S, H, hd); pk/pv page pools
    (n_pages, page_size, Hkv, hd); page_table (B, P); lengths (B,).
    Returns (B, S, H, hd) in q's dtype."""
    B = q.shape[0]
    n_pages, page_size = pk.shape[0], pk.shape[1]
    pk_flat = pk.reshape(n_pages * page_size, *pk.shape[2:])
    pv_flat = pv.reshape(n_pages * page_size, *pv.shape[2:])
    gather = (page_table.long()[:, :, None] * page_size
              + torch.arange(page_size, device=pk.device)).reshape(B, -1)
    return _dot_attention_paged(q, pk_flat[gather], pv_flat[gather],
                                lengths.long())


def _lib():
    fn = build.load("paged_attention").paged_attention_launch
    if not fn.argtypes:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 8
                       + [ctypes.c_float, ctypes.c_void_p])
    return fn


def paged_flash_attention(q, pk, pv, page_table, lengths):
    """The CUDA kernel, same contract as :func:`paged_attention_ref`.
    Every launch adds one to ``paged_flash_attention.launches``."""
    if not (q.is_cuda and pk.is_cuda and pv.is_cuda and page_table.is_cuda
            and lengths.is_cuda):
        raise ValueError("paged_flash_attention takes CUDA tensors only; "
                         "the plain version is paged_attention_ref")
    B, S, H, hd = q.shape
    n_pages, page_size, Hkv, hd_k = pk.shape
    if q.dtype not in _DTYPE_CODE or pk.dtype != q.dtype \
            or pv.dtype != q.dtype:
        raise ValueError(f"dtypes q={q.dtype} pk={pk.dtype} pv={pv.dtype}: "
                         "need one of float32/bfloat16 for all three")
    if hd not in _HEAD_DIMS or hd_k != hd or pv.shape != pk.shape:
        raise ValueError(f"head dim {hd} (pool {hd_k}) not in {_HEAD_DIMS}"
                         " or pool shapes differ")
    if H % Hkv or not (pk.is_contiguous() and pv.is_contiguous()):
        raise ValueError("need H % Hkv == 0 and contiguous page pools")
    P = page_table.shape[1]
    if page_table.shape[0] != B or lengths.shape != (B,) or P == 0:
        raise ValueError("page_table must be (B, P>0) and lengths (B,)")
    q = q.contiguous()
    table = page_table.to(torch.int32).contiguous()
    lens = lengths.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    if B == 0 or S == 0:
        return out
    rc = _lib()(q.data_ptr(), pk.data_ptr(), pv.data_ptr(), table.data_ptr(),
                lens.data_ptr(), out.data_ptr(), _DTYPE_CODE[q.dtype], B, S,
                H, Hkv, hd, page_size, P, hd ** -0.5,
                torch.cuda.current_stream(q.device).cuda_stream)
    build.check(rc, "paged_attention_launch")
    paged_flash_attention.launches += 1
    return out


paged_flash_attention.launches = 0
