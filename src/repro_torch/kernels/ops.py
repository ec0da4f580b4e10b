"""Public entry points of the port's kernels — dispatch by device.

Port of the paged-decode half of :mod:`repro.kernels.ops`. The JAX
package resolves a three-way mode ("pallas" / "interpret" / "ref") per
call; here device placement alone decides, with no override:

- CPU tensors go to the plain PyTorch version (tests, CPU serving);
- CUDA tensors go to the hand-written kernel, which launches or raises.

A CUDA tensor never reaches a plain version through this module; the
plain versions are called by name from tests and ``chip_smoke.py``.
"""
from __future__ import annotations

from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import sampling as sp


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
