"""Public entry points of the port's kernels — dispatch by device.

Port of :mod:`repro.kernels.ops`: the training kernels (flash attention,
RMSNorm, the selective scan) and the paged-decode ones (attention, SSM
update, sampling mask). The JAX
package resolves a three-way mode ("pallas" / "interpret" / "ref") per
call; here device placement alone decides, with no override:

- CPU tensors go to the plain PyTorch version (tests, CPU serving);
- CUDA tensors go to the hand-written kernel, which launches or raises;
- meta tensors (the dry-run, :mod:`repro_torch.launch.dryrun`) go to a
  shape-and-cost stand-in: empty meta outputs of the kernel's shapes and
  dtypes, forward and backward, the kernel's flops and bytes (its
  module's ``cost``) added to every :class:`KernelCounts` entered. The
  plain versions would run their Python loops on meta for nothing (the
  scan loops over S), and ``FlopCounterMode`` counts no elementwise
  work.

A CUDA tensor never reaches a plain version through this module; the
plain versions are called by name from tests and ``chip_smoke.py``.
Models take the card's route (:func:`kernel_route`) on meta too, so the
dry-run counts the work the card would do.
"""
from __future__ import annotations

from typing import Dict, List

import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import paged_ssm as ps
from repro_torch.kernels import rmsnorm as rn
from repro_torch.kernels import sampling as sp
from repro_torch.kernels import ssm_scan as ss

_ACTIVE: List["KernelCounts"] = []


class KernelCounts:
    """Calls, flops and bytes of the kernels called on meta tensors while
    entered (``with KernelCounts() as kc``), by kernel name
    (``flash_attention_fwd``, ...). ``flops`` run on the tensor cores
    (bf16 / fp16 operands), ``f32_flops`` on the CUDA cores (float32
    operands, the scan, the SSM update)."""

    def __init__(self):
        self.by_name: Dict[str, Dict[str, int]] = {}

    def __enter__(self):
        _ACTIVE.append(self)
        return self

    def __exit__(self, *exc):
        _ACTIVE.remove(self)

    def add(self, name: str, flops: int, nbytes: int, *, f32: bool):
        row = self.by_name.setdefault(
            name, {"calls": 0, "flops": 0, "f32_flops": 0, "bytes": 0})
        row["calls"] += 1
        row["f32_flops" if f32 else "flops"] += flops
        row["bytes"] += nbytes

    def total(self, key: str) -> int:
        return sum(row[key] for row in self.by_name.values())


def _record(name, cost, f32):
    for kc in _ACTIVE:
        kc.add(name, *cost, f32=f32)


def kernel_route(t) -> bool:
    """Whether a model takes the card's route for ``t``: on the card,
    and on meta, where the dry-run counts the card's work."""
    return t.is_cuda or t.is_meta


def _empty(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


class _MetaKernel(torch.autograd.Function):
    """A differentiable kernel on meta tensors: the output comes back
    empty with the ``like`` input's shape and dtype, and ``fwd`` / ``bwd``
    = (name, (flops, bytes), f32) are recorded; the backward returns
    empty gradients shaped like the inputs that need them."""

    @staticmethod
    def forward(ctx, like, fwd, bwd, *inputs):
        ctx.bwd = bwd
        ctx.like = [(t.shape, t.dtype) for t in inputs]
        _record(*fwd)
        return _empty(like.shape, like.dtype)

    @staticmethod
    def backward(ctx, *grads):
        _record(*ctx.bwd)
        need = ctx.needs_input_grad[3:]
        return (None, None, None) + tuple(
            _empty(*like) if n else None
            for like, n in zip(ctx.like, need, strict=True))


def _tensor_core(dtype) -> bool:
    return dtype in (torch.bfloat16, torch.float16)


def flash_attention(q, k, v, *, causal: bool = True):
    """Blocked GQA attention in model layout — q: (B, S, H, hd); k/v:
    (B, S, Hkv, hd). Differentiable on both devices (kernel backward on
    the card, autograd of the plain version on the CPU)."""
    if q.is_cuda:
        return fa.flash_attention(q, k, v, causal=causal)
    if q.is_meta:
        B, Sq, H, hd = q.shape
        shape = (B, Sq, k.shape[1], H, k.shape[2], hd, q.element_size())
        f32 = not _tensor_core(q.dtype)
        return _MetaKernel.apply(
            q, ("flash_attention_fwd", fa.cost(*shape, causal=causal), f32),
            ("flash_attention_bwd", fa.cost(*shape, causal=causal,
                                            backward=True), f32),
            q, k, v)
    return fa.flash_attention_ref(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        causal=causal).transpose(1, 2)


def rmsnorm(x, w):
    """``x * rsqrt(mean(x^2) + 1e-6) * w`` over the last axis, in float32,
    cast back to x's dtype. x: (..., D); w: (D,). Differentiable."""
    if x.is_cuda:
        return rn.rmsnorm(x, w)
    if x.is_meta:
        R, D = x.numel() // x.shape[-1], x.shape[-1]
        return _MetaKernel.apply(
            x, ("rmsnorm_fwd", rn.cost(R, D, x.element_size()), False),
            ("rmsnorm_bwd", rn.cost(R, D, x.element_size(), backward=True),
             False),
            x, w)
    return rn.rmsnorm_ref(x, w)


def ssm_scan(dt, x, A, B, C, D, *, heads=None):
    """Selective scan ``h = exp(dt*A)*h + (dt*x) B``, ``y = h.C + D*x``
    (``repro.kernels.ssm_scan``). dt/x: (Bb, S, di); A: (di, ds), any
    strides; B/C: (Bb, S, ds); D: (di,). Returns y (Bb, S, di) in x's
    dtype. Differentiable in every input (kernel backward on the card,
    autograd of the plain version on the CPU). ``heads``: mamba2's rows,
    whose dt, D and decay are one value a head repeated across the head's
    rows; on meta they are counted once a head (``ssm_scan.cost``'s
    ``n_ch`` and ``n_decay``), elsewhere the argument changes nothing."""
    if x.is_cuda:
        return ss.ssm_scan(dt, x, A, B, C, D)
    if x.is_meta:
        Bb, S, di = x.shape
        counts = dict(n_ch=heads, n_decay=heads)
        return _MetaKernel.apply(
            x, ("ssm_scan_fwd", ss.cost(Bb, S, di, A.shape[1], **counts),
                True),
            ("ssm_scan_bwd", ss.cost(Bb, S, di, A.shape[1], backward=True,
                                     **counts), True),
            dt, x, A, B, C, D)
    return ss.ssm_scan_ref(dt, x, A, B, C, D)


def paged_attention(q, pk, pv, page_table, lengths, *,
                    return_lse: bool = False):
    """Paged flash-decode attention in model layout.

    q: (B, S, H, hd) new-token queries (post-rope); pk/pv: (n_pages,
    page_size, Hkv, hd) pools (new k/v already scattered in);
    page_table: (B, P) — pass the table sliced to the live page bucket;
    lengths: (B,). Returns (B, S, H, hd). On meta the lengths are unknown:
    every slot is counted with its table full (the context of P pages
    less the S new rows), the decode shapes' cache of ``seq_len``.

    ``return_lse``: (out, lse), lse (B, S, H) float32 each row's
    log-sum-exp of its scaled logits (the lse route: the kernels with the
    log-sum-exp written, ``paged_flash_attention_lse``, on the card; its
    plain version on the CPU). A row that sees no key (``lengths`` may be
    negative: a slice of the keys that starts after the query) carries
    lse <= -1e30, zero weight when partials are merged.
    """
    if q.is_cuda:
        if return_lse:
            return pa.paged_flash_attention_lse(q, pk, pv, page_table,
                                                lengths)
        return pa.paged_flash_attention(q, pk, pv, page_table, lengths)
    if q.is_meta:
        B, S, H, hd = q.shape
        P = page_table.shape[1]
        full = [P * pk.shape[1] - S] * B
        _record("paged_flash_attention_lse" if return_lse
                else "paged_flash_attention",
                pa.cost(S, H, pk.shape[2], hd, q.element_size(), full, P),
                not _tensor_core(q.dtype))
        out = _empty(q.shape, q.dtype)
        return (out, _empty(q.shape[:3], torch.float32)) if return_lse \
            else out
    if return_lse:
        return pa.paged_attention_lse_ref(q, pk, pv, page_table, lengths)
    return pa.paged_attention_ref(q, pk, pv, page_table, lengths)


def paged_ssm_update(dt, x, Bm, Cm, A, h_pool, read_page, live, phys_w,
                     t_w, n_new, *, order: str):
    """Paged SSM recurrence + compact snapshot commit, rows layout.

    dt/x: (B, S, R); Bm/Cm: (B, S, ds); A: (R, ds); h_pool: (N, R, ds)
    float32, **updated in place** (where the JAX package aliases it to
    the output). read_page/live/n_new: (B,); phys_w/t_w: (B, W) — the
    compact write plan from ``repro_torch.models.ssm.
    compact_snapshot_steps``. ``order`` selects the mamba1 ("dbx") vs
    mamba2 ("dxb") product grouping. Returns y (B, S, R) float32. On meta
    every slot is counted live, all S steps active and its W pages
    written.
    """
    if dt.is_cuda:
        return ps.paged_ssm_update(dt, x, Bm, Cm, A, h_pool, read_page,
                                   live, phys_w, t_w, n_new, order=order)
    if dt.is_meta:
        B, S, R = dt.shape
        W = phys_w.shape[1]
        _record("paged_ssm_update",
                ps.cost(order, S, R, A.shape[1], W, [S] * B, B, B * W), True)
        return _empty(dt.shape, torch.float32)
    return ps.paged_ssm_update_ref(dt, x, Bm, Cm, A, h_pool, read_page,
                                   live, phys_w, t_w, n_new, order=order)


def topk_topp_mask(logits, top_ks, top_ps):
    """Sort-free top-k/top-p masking: survivors keep their logits
    bit-unchanged, the rest drop to -1e30. logits: (B, V); top_ks: (B,)
    int (<= 0 disables); top_ps: (B,) float in (0, 1]."""
    if logits.is_cuda:
        return sp.topk_topp_mask(logits, top_ks, top_ps)
    if logits.is_meta:
        _record("topk_topp_mask", sp.cost(*logits.shape), False)
        return _empty(logits.shape, torch.float32)
    return sp.topk_topp_mask_ref(logits, top_ks, top_ps)
