"""Sort-free top-k/top-p logit masking: plain PyTorch version + CUDA
kernel.

Port of :mod:`repro.kernels.sampling`. Both thresholds are found by
binary search over the *sortable-integer* encoding of float32

    u = bitcast(x, uint32);  u ^= (0x80000000 | (0xFFFFFFFF if x < 0))

which is strictly monotone for finite floats: tau_k is the k-th largest
logit, tau_p the smallest logit whose strictly-greater survivor mass is
still < p, and the row keeps ``u >= max(tau_k, tau_p)``. Survivors keep
their logits bit-unchanged; the rest drop to -1e30. Gumbel noise stays
outside (the sampler's key schedule is contract surface).

- :func:`topk_topp_mask_ref` is the plain version. torch's uint32
  support on the CPU is thin, so it carries the encoding in int64.
- :func:`topk_topp_mask` launches ``csrc/sampling.cu`` (native uint32;
  its header says what it replaces and what bounds it). CUDA tensors
  only; it never falls back.

Tie caveat (as in the reference): thresholds keep every logit tied with
the k-th value; the nucleus mass is summed in a different order than
the sorted path, so a token whose cumulative mass lies within float
rounding of p can flip.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_MASKED = -1e30
_SEARCH_BITS = 32
_U32 = 0xFFFFFFFF


def _sortable_u32(x):
    """Monotone uint32 encoding of float32 (finite values), as int64."""
    u = x.float().contiguous().view(torch.int32).to(torch.int64) & _U32
    flip = torch.where((u >> 31) != 0, torch.full_like(u, _U32),
                       torch.full_like(u, 0x80000000))
    return u ^ flip


def _search_kth(u, k_eff):
    """Largest threshold tau with count(u >= tau) >= k_eff, per row."""
    B = u.shape[0]
    lo = torch.zeros((B,), dtype=torch.int64, device=u.device)
    hi = torch.full((B,), _U32, dtype=torch.int64, device=u.device)
    for _ in range(_SEARCH_BITS):
        # ceil((hi-lo)/2) exactly as the uint32 reference computes it
        span = hi - lo
        mid = lo + (span >> 1) + (span & 1)
        cnt = (u >= mid[:, None]).sum(-1)
        ok = cnt >= k_eff
        lo, hi = torch.where(ok, mid, lo), torch.where(ok, hi, mid - 1)
    return lo


def _search_nucleus(u, e, p_z):
    """Smallest threshold tau with mass(u > tau) < p_z, per row."""
    B = u.shape[0]
    lo = torch.zeros((B,), dtype=torch.int64, device=u.device)
    hi = torch.full((B,), _U32, dtype=torch.int64, device=u.device)
    zero = torch.zeros_like(e)
    for _ in range(_SEARCH_BITS):
        mid = lo + ((hi - lo) >> 1)
        mass = torch.where(u > mid[:, None], e, zero).sum(-1)
        ok = mass < p_z
        lo, hi = torch.where(ok, lo, mid + 1), torch.where(ok, mid, hi)
    return hi


def topk_topp_mask_ref(logits, top_ks, top_ps):
    """Mask all but each row's top-k/top-p survivors to -1e30.
    logits: (B, V); top_ks: (B,) int (<= 0 disables); top_ps: (B,) float
    in (0, 1]. Returns (B, V) float32."""
    lf = logits.float()
    V = lf.shape[-1]
    u = _sortable_u32(lf)
    ks = top_ks.long()
    k_eff = torch.where(ks <= 0, torch.full_like(ks, V), ks).clamp(1, V)
    tau_k = _search_kth(u, k_eff)
    keep_k = u >= tau_k[:, None]
    masked_k = torch.where(keep_k, lf, torch.full_like(lf, _MASKED))
    m = masked_k.max(-1, keepdim=True).values
    e = torch.exp(masked_k - m)                 # exact 0 for masked entries
    p_z = top_ps.float() * e.sum(-1)
    tau_p = _search_nucleus(u, e, p_z)
    keep = keep_k & (u >= tau_p[:, None])
    return torch.where(keep, lf, torch.full_like(lf, _MASKED))


def _lib():
    fn = build.load("sampling").topk_topp_mask_launch
    if not fn.argtypes:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 2
                       + [ctypes.c_void_p])
    return fn


def topk_topp_mask(logits, top_ks, top_ps):
    """The CUDA kernel, same contract as :func:`topk_topp_mask_ref`.
    Every launch adds one to ``topk_topp_mask.launches``."""
    if not (logits.is_cuda and top_ks.is_cuda and top_ps.is_cuda):
        raise ValueError("topk_topp_mask takes CUDA tensors only; the "
                         "plain version is topk_topp_mask_ref")
    if logits.ndim != 2:
        raise ValueError(f"logits must be (B, V), got {tuple(logits.shape)}")
    B, V = logits.shape
    if top_ks.shape != (B,) or top_ps.shape != (B,):
        raise ValueError("top_ks and top_ps must be (B,)")
    x = logits.float().contiguous()
    ks = top_ks.to(torch.int32).contiguous()
    ps = top_ps.float().contiguous()
    out = torch.empty_like(x)
    if B == 0 or V == 0:
        return out
    rc = _lib()(x.data_ptr(), ks.data_ptr(), ps.data_ptr(), out.data_ptr(),
                B, V, torch.cuda.current_stream(x.device).cuda_stream)
    build.check(rc, "topk_topp_mask_launch")
    topk_topp_mask.launches += 1
    return out


topk_topp_mask.launches = 0
