"""Public entry points of the port's kernels — dispatch by device.

Port of :mod:`repro.kernels.ops`: the training kernels (flash attention,
RMSNorm) and the paged-decode ones. The JAX
package resolves a three-way mode ("pallas" / "interpret" / "ref") per
call; here device placement alone decides, with no override:

- CPU tensors go to the plain PyTorch version (tests, CPU serving);
- CUDA tensors go to the hand-written kernel, which launches or raises.

A CUDA tensor never reaches a plain version through this module; the
plain versions are called by name from tests and ``chip_smoke.py``.
"""
from __future__ import annotations

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import rmsnorm as rn
from repro_torch.kernels import sampling as sp


def flash_attention(q, k, v, *, causal: bool = True):
    """Blocked GQA attention in model layout — q: (B, S, H, hd); k/v:
    (B, S, Hkv, hd). Differentiable on both devices (kernel backward on
    the card, autograd of the plain version on the CPU)."""
    if q.is_cuda:
        return fa.flash_attention(q, k, v, causal=causal)
    return fa.flash_attention_ref(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        causal=causal).transpose(1, 2)


def rmsnorm(x, w):
    """``x * rsqrt(mean(x^2) + 1e-6) * w`` over the last axis, in float32,
    cast back to x's dtype. x: (..., D); w: (D,). Differentiable."""
    if x.is_cuda:
        return rn.rmsnorm(x, w)
    return rn.rmsnorm_ref(x, w)


def paged_attention(q, pk, pv, page_table, lengths):
    """Paged flash-decode attention in model layout.

    q: (B, S, H, hd) new-token queries (post-rope); pk/pv: (n_pages,
    page_size, Hkv, hd) pools (new k/v already scattered in);
    page_table: (B, P) — pass the table sliced to the live page bucket;
    lengths: (B,). Returns (B, S, H, hd).
    """
    if q.is_cuda:
        return pa.paged_flash_attention(q, pk, pv, page_table, lengths)
    return pa.paged_attention_ref(q, pk, pv, page_table, lengths)


def topk_topp_mask(logits, top_ks, top_ps):
    """Sort-free top-k/top-p masking: survivors keep their logits
    bit-unchanged, the rest drop to -1e30. logits: (B, V); top_ks: (B,)
    int (<= 0 disables); top_ps: (B,) float in (0, 1]."""
    if logits.is_cuda:
        return sp.topk_topp_mask(logits, top_ks, top_ps)
    return sp.topk_topp_mask_ref(logits, top_ks, top_ps)
