"""Public entry points of the port's kernels — dispatch by device.

Port of :mod:`repro.kernels.ops`: the training kernels (flash attention,
RMSNorm, the selective scan) and the paged-decode ones (attention, SSM
update, sampling mask). The JAX
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
from repro_torch.kernels import paged_ssm as ps
from repro_torch.kernels import rmsnorm as rn
from repro_torch.kernels import sampling as sp
from repro_torch.kernels import ssm_scan as ss


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


def ssm_scan(dt, x, A, B, C, D):
    """Selective scan ``h = exp(dt*A)*h + (dt*x) B``, ``y = h.C + D*x``
    (``repro.kernels.ssm_scan``). dt/x: (Bb, S, di); A: (di, ds), any
    strides; B/C: (Bb, S, ds); D: (di,). Returns y (Bb, S, di) in x's
    dtype. Differentiable in every input (kernel backward on the card,
    autograd of the plain version on the CPU)."""
    if x.is_cuda:
        return ss.ssm_scan(dt, x, A, B, C, D)
    return ss.ssm_scan_ref(dt, x, A, B, C, D)


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


def paged_ssm_update(dt, x, Bm, Cm, A, h_pool, read_page, live, phys_w,
                     t_w, n_new, *, order: str):
    """Paged SSM recurrence + compact snapshot commit, rows layout.

    dt/x: (B, S, R); Bm/Cm: (B, S, ds); A: (R, ds); h_pool: (N, R, ds)
    float32, **updated in place** (where the JAX package aliases it to
    the output). read_page/live/n_new: (B,); phys_w/t_w: (B, W) — the
    compact write plan from ``repro_torch.models.ssm.
    compact_snapshot_steps``. ``order`` selects the mamba1 ("dbx") vs
    mamba2 ("dxb") product grouping. Returns y (B, S, R) float32.
    """
    if dt.is_cuda:
        return ps.paged_ssm_update(dt, x, Bm, Cm, A, h_pool, read_page,
                                   live, phys_w, t_w, n_new, order=order)
    return ps.paged_ssm_update_ref(dt, x, Bm, Cm, A, h_pool, read_page,
                                   live, phys_w, t_w, n_new, order=order)


def topk_topp_mask(logits, top_ks, top_ps):
    """Sort-free top-k/top-p masking: survivors keep their logits
    bit-unchanged, the rest drop to -1e30. logits: (B, V); top_ks: (B,)
    int (<= 0 disables); top_ps: (B,) float in (0, 1]."""
    if logits.is_cuda:
        return sp.topk_topp_mask(logits, top_ks, top_ps)
    return sp.topk_topp_mask_ref(logits, top_ks, top_ps)
