"""Top-k Mixture-of-Experts FFN (GShard-style capacity dispatch).

Port of :mod:`repro.models.moe`. The reference builds dense (B, S, E, C)
one-hot ``dispatch`` / ``combine`` tensors and contracts them by einsum,
a layout that GSPMD can shard. At qwen3-moe's training shape (B=2,
S=4096, C=320) those are 335 M entries a layer call, and the two one-hot
contractions cost more than the experts. This module computes a
**routing plan** instead: for every (b, s, k) choice its expert and
capacity slot, or "dropped". It gathers the kept token rows into an
(E, B, C, D) buffer (empty slots zero, as in the reference), runs the
three expert products as batched matmuls over the expert axis and
combines each token's K slots back. The function is the reference's:

- router logits in ``cfg.dtype``, softmax over their float32 upcast,
  gates renormalised by ``max(sum, 1e-9)``;
- top-k ties go to the lowest expert index and the K choices are in
  descending order, as ``jax.lax.top_k`` (a stable descending sort);
- choice-major priority: every position's first choice is queued before
  any position's second; a choice is kept if its running position in
  its expert is below C;
- capacity from the S of the call (per group with ``group_size``), for
  each batch row apart; padded and idle positions take capacity too;
- the combine weights rounded to ``cfg.dtype`` before the product;
- the experts use ``silu(g) * h`` whatever ``cfg.act`` says;
- a token whose K choices are all dropped gets 0.

No step accumulates with atomics, forward or backward: every slot holds
one token at most, so dispatch and combine are gathers (a fixed-order
sum over k where a token collects its K slots), and their backward is
:class:`_Dispatch` / :class:`_Combine`, gathers again. The gradient
reaches the router only through the gate values, as ``jax.vjp``'s does:
the top-k indices are piecewise constant.

:func:`moe_apply_onehot` is the literal transcription of the
reference's ``_moe_dense_inner``; only the tests and ``chip_smoke.py``
use it, as each kernel's plain twin.

**Expert parallelism.** The reference constrains the (E, B, C, D)
dispatch buffer to ``("experts", "batch", ...)`` and GSPMD inserts the
all-to-all. Here, where the active rules (training's
:func:`repro_torch.parallel.sharding.axis_rules`, or serving's
:func:`repro_torch.parallel.tp.active`) map ``experts`` to a mesh axis
of n > 1 ranks that E divides (:func:`expert_split`), each rank holds
experts [r E/n, (r+1) E/n) and its own batch rows. The buffer is
expert-major (slot ``(expert * B + b) * C + pos``), so one all-to-all
over that axis (:class:`_Exchange`, ``ep_dispatch``) sends expert group
g's rows to rank g, which gets (E/n, n B, C, D) with the batch
rank-major: the one-rank buffer's rows of its experts, in the one-rank
order. It runs the expert products and the opposite all-to-all
(``ep_combine``) sends the rows back before the combine. Each
exchange's backward is the opposite exchange (``*_grad``). The router
stays whole on every rank, and each rank routes its own tokens over all
E experts; the routing plan and the capacity (from the S of the call,
per batch row) are the one-rank ones. ``experts`` on another axis than
the batch's raises: a token's rows must come from the ranks that hold
its batch rows.

The exchange is a collective, so every rank of the expert axis must make
the same MoE calls in the same order at the same S. The paths that rely
on it: training (every rank of a data group runs the same chunks and
MGRIT iteration counts, and the adaptive probe's branch is all-reduced,
``train/trainer.py``), and a serving wave (``launch/steps.SlotRows``
gives every data rank the same call, on its own slots).

Under serving's tensor-parallel rules (``mlp`` over ``model``) each
expert's products run on this rank's columns of ``w_in`` / ``w_gate``
and rows of ``w_out``; the partial ``ye`` stays in float32 through the
combine (which is linear in it) and the combined (B, S, D) partials are
summed over the ranks and rounded once (``tp_moe``): B S D floats in
place of E B C D. One device rounds ``ye`` to ``cfg.dtype`` before the
combine; this path does not.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import (dense_init, preln_output_scale,
                                       torch_dtype)
from repro_torch.parallel import sharding, tp

CAPACITY_FACTOR = 1.25


def init_moe(gen: torch.Generator, cfg: ModelConfig, *, lead=(),
             device=None):
    """The router (d, E) and the experts' ``w_in`` / ``w_gate`` (E, d, ff)
    and ``w_out`` (E, ff, d), under ``lead`` stacked layers. The expert
    leaves are drawn one layer at a time: a single draw over a stacked
    full-width leaf needs its whole size again in float32 scratch."""
    assert cfg.moe is not None
    d, e = cfg.d_model, cfg.moe.num_experts
    ff = cfg.moe.d_ff or cfg.d_ff
    pdt = torch_dtype(cfg.param_dtype)
    oscale = 0.02 * preln_output_scale(cfg.n_layers)
    p = {"router": dense_init(gen, (*lead, d, e), pdt, device=device)}
    for name, shape, scale in (("w_in", (e, d, ff), 0.02),
                               ("w_gate", (e, d, ff), 0.02),
                               ("w_out", (e, ff, d), oscale)):
        leaf = torch.empty((*lead, *shape), dtype=pdt, device=device)
        for layer in leaf.view(-1, *shape):
            layer.copy_(dense_init(gen, shape, pdt, scale=scale,
                                   device=device))
        p[name] = leaf
    return p


def capacity(seq: int, cfg: ModelConfig) -> int:
    m = cfg.moe
    c = int(math.ceil(seq * m.top_k / m.num_experts * CAPACITY_FACTOR))
    return max(4, min(seq, c))


def _grouped(fn, x, cfg: ModelConfig):
    """Apply ``fn`` to GShard groups of ``group_size`` positions when set
    and S splits into more than one (capacity is then per group)."""
    g = cfg.moe.group_size
    if g and x.shape[1] > g and x.shape[1] % g == 0:
        B, S, D = x.shape
        return fn(x.reshape(B * (S // g), g, D)).reshape(B, S, D)
    return fn(x)


# ---------------------------------------------------------------------------
# The routing plan
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class RoutingPlan:
    """Where each (b, s, k) choice goes, for one call of (B, S) tokens.

    ``expert`` (B, S, K) int64, in descending gate order; ``gate`` (B, S,
    K) float32, renormalised (differentiable); ``pos`` (B, S, K) the
    choice's running position in its expert; ``keep`` = pos < C;
    ``slot`` (B, S, K) the row of the (E, B, C) buffer, flattened, or
    ``n_slots`` where dropped; ``src`` (n_slots,) the flat choice index
    (b, s, k) held by each buffer row, or B*S*K where it is empty;
    ``logits`` (B, S, E) the router's, in ``cfg.dtype``."""
    expert: torch.Tensor
    gate: torch.Tensor
    pos: torch.Tensor
    keep: torch.Tensor
    slot: torch.Tensor
    src: torch.Tensor
    logits: torch.Tensor
    capacity: int

    @property
    def n_slots(self) -> int:
        return self.src.shape[0]

    def n_dropped(self) -> int:
        return int((~self.keep).sum())


def _router(params, x, cfg: ModelConfig):
    """Router logits (in ``cfg.dtype``), top-K experts and renormalised
    gates. The stable descending sort puts the lowest expert index first
    among equal probabilities, as ``jax.lax.top_k`` does; its backward
    writes each cotangent to one place (``gather``'s would add)."""
    K = cfg.moe.top_k
    logits = x @ params["router"].to(x.dtype)
    probs = torch.softmax(logits.float(), dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate = vals[..., :K]
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    return logits, idx[..., :K], gate


def _positions(expert, E: int):
    """Choice-major running position of every (b, s, k) choice within its
    expert, per batch row: the rank among the row's choices queued in
    (k, s) order for the same expert. A stable sort by expert keeps that
    order within each expert; integer ops only."""
    B, S, K = expert.shape
    flat = expert.transpose(1, 2).reshape(B, K * S)          # choice-major
    order = torch.sort(flat, dim=1, stable=True).indices
    by_expert = flat.gather(1, order)
    first = torch.searchsorted(
        by_expert, torch.arange(E, device=expert.device).expand(B, E)
        .contiguous())
    rank = torch.arange(K * S, device=expert.device).expand(B, K * S)
    pos = torch.empty_like(flat).scatter_(
        1, order, rank - first.gather(1, by_expert))   # a permutation
    return pos.view(B, K, S).transpose(1, 2)


def routing_plan(params, x, cfg: ModelConfig) -> RoutingPlan:
    """The plan of one ungrouped call on x (B, S, D) in ``cfg.dtype``."""
    logits, expert, gate = _router(params, x, cfg)
    return plan_from(expert, gate, logits, cfg)


def plan_from(expert, gate, logits, cfg: ModelConfig) -> RoutingPlan:
    """The plan of the choices ``expert`` (B, S, K) with their ``gate``
    and the router's ``logits``: positions, kept bits and slots."""
    E = cfg.moe.num_experts
    B, S, K = expert.shape
    dev = expert.device
    C = capacity(S, cfg)
    pos = _positions(expert, E)
    keep = pos < C
    n_slots = E * B * C
    b = torch.arange(B, device=dev)[:, None, None]
    slot = torch.where(keep, (expert * B + b) * C + pos, n_slots)
    # buffer row -> choice; a dropped choice goes to a row of its own past
    # the buffer, so every index written is unique
    choice = torch.arange(B * S * K, device=dev)
    dest = torch.where(keep.reshape(-1), slot.reshape(-1),
                       n_slots + choice)
    src = torch.full((n_slots + B * S * K,), B * S * K, dtype=torch.long,
                     device=dev).scatter_(0, dest, choice)[:n_slots]
    return RoutingPlan(expert, gate, pos, keep, slot, src, logits, C)


# ---------------------------------------------------------------------------
# Dispatch and combine (gathers both ways)
# ---------------------------------------------------------------------------


def _pad_row(t):
    """``t`` (N, D) with a zero row appended (index N reads 0)."""
    return torch.cat([t, t.new_zeros((1, t.shape[1]))])


class _Dispatch(torch.autograd.Function):
    """x (B, S, D) -> the (n_slots, D) buffer: row j is the token that
    ``src[j]`` names, or 0. Backward: each token sums the cotangents of
    its kept slots over k, in k order."""

    @staticmethod
    def forward(ctx, x, slot, src):
        B, S, D = x.shape
        K = slot.shape[-1]
        ctx.save_for_backward(slot)
        return _pad_row(x.reshape(B * S, D))[src // K]

    @staticmethod
    def backward(ctx, dxe):
        (slot,) = ctx.saved_tensors
        d = _pad_row(dxe)
        acc = d[slot[..., 0]].float()
        for k in range(1, slot.shape[-1]):
            acc += d[slot[..., k]].float()
        return acc.to(dxe.dtype), None, None


class _Combine(torch.autograd.Function):
    """ye (n_slots, D), w (B, S, K) in ``ye``'s dtype -> y (B, S, D) =
    sum over k of w * ye[slot] (float32 sum in k order, one rounding).
    Backward: dye[j] = w * dy of the choice that row j holds (0 where
    empty); dw = <dy, ye[slot]> (0 where dropped)."""

    @staticmethod
    def forward(ctx, ye, w, slot, src):
        rows = _pad_row(ye)
        acc = w[..., 0, None].float() * rows[slot[..., 0]].float()
        for k in range(1, slot.shape[-1]):
            acc += w[..., k, None].float() * rows[slot[..., k]].float()
        ctx.save_for_backward(ye, w, slot, src)
        return acc.to(ye.dtype)

    @staticmethod
    def backward(ctx, dy):
        ye, w, slot, src = ctx.saved_tensors
        B, S, K = slot.shape
        D = dy.shape[-1]
        dy = dy.to(ye.dtype)
        w_flat = torch.cat([w.reshape(-1), w.new_zeros(1)])
        dye = w_flat[src, None] * _pad_row(dy.reshape(B * S, D))[src // K]
        rows = _pad_row(ye)
        dw = torch.stack([(dy.float() * rows[slot[..., k]].float()).sum(-1)
                          for k in range(K)], dim=-1)
        return dye, dw.to(w.dtype), None, None


# ---------------------------------------------------------------------------
# Expert parallelism: the exchange over the expert axis
# ---------------------------------------------------------------------------


def expert_split(cfg: ModelConfig):
    """The :class:`repro_torch.parallel.tp.Split` of the expert axis
    under the active rules (serving's ``tp.active`` first, else
    training's ``axis_rules``), or None: no rules, ``experts`` unmapped
    or on an axis of one rank, or E not dividing over it (the spec then
    keeps the experts whole). Raises where ``experts`` resolves to
    another axis than the batch's."""
    mesh, rules = tp.current()
    if mesh is None:
        return None
    ax = tp.axis_of(mesh, rules, "experts")
    if ax is None or cfg.moe.num_experts % mesh.shape[ax]:
        return None
    if tp.axis_of(mesh, rules, "batch") != ax:
        raise NotImplementedError(
            f"experts over mesh axis {ax!r} and the batch over "
            f"{tp.axis_of(mesh, rules, 'batch')!r}: expert parallelism "
            "needs the experts on the batch's axis, the ranks that hold "
            "a token's batch rows")
    return tp.Split(mesh, ax, mesh.shape[ax], mesh.index(ax))


def _to_experts(t, sp, kind):
    """(E, R, D), this rank's R rows of every expert -> (E/n, n R, D),
    every rank's rows of this rank's experts, rank-major."""
    E, R, D = t.shape
    got = sp.mesh.all_to_all(kind, t, sp.axis)
    return got.view(sp.n, E // sp.n, R, D).transpose(0, 1).reshape(
        E // sp.n, sp.n * R, D)


def _from_experts(t, sp, kind):
    """The inverse of :func:`_to_experts`: (E/n, n R, D) -> (E, R, D)."""
    El, nR, D = t.shape
    send = t.view(El, sp.n, nR // sp.n, D).transpose(0, 1).reshape(
        sp.n * El, nR // sp.n, D)
    return sp.mesh.all_to_all(kind, send, sp.axis)


class _Exchange(torch.autograd.Function):
    """The all-to-all over the expert axis ``sp``: to the experts'
    ranks (``to_experts``) or back. Backward: the opposite exchange of
    the cotangent, counted as ``kind`` + ``_grad``. The mesh rides in
    ``ctx``: the backward may run on another thread (the autograd
    engine's device thread), where no rules are active."""

    @staticmethod
    def forward(ctx, t, sp, to_experts: bool, kind: str):
        ctx.sp, ctx.to_experts, ctx.kind = sp, to_experts, kind
        return (_to_experts if to_experts else _from_experts)(t, sp, kind)

    @staticmethod
    def backward(ctx, g):
        fn = _from_experts if ctx.to_experts else _to_experts
        return fn(g.contiguous(), ctx.sp, ctx.kind + "_grad"), None, None, \
            None


def _experts(params, xe, dt, sp=None):
    """The three expert products over (E, rows, D): silu(x Wg) * (x Wi)
    then Wo, batched over the expert axis. ``sp``: the expert ``d_ff``
    cut over tensor-parallel ranks (this rank's columns and rows); the
    result is then this rank's float32 partial sum."""
    h = xe @ params["w_in"].to(dt)
    g = xe @ params["w_gate"].to(dt)
    if sp is None:
        return (F.silu(g) * h) @ params["w_out"].to(dt)
    return tp.partial_product(F.silu(g) * h, params["w_out"].to(dt))


def _moe_indexed(params, x, cfg: ModelConfig):
    dt = torch_dtype(cfg.dtype)
    x = x.to(dt)
    B, S, D = x.shape
    E = cfg.moe.num_experts
    ep = expert_split(cfg)
    mp = tp.split("mlp", cfg.moe.d_ff or cfg.d_ff)
    if mp is not None and torch.is_grad_enabled() and x.requires_grad:
        raise NotImplementedError(
            "the expert d_ff cut over tensor-parallel ranks is a serving "
            "layout: training rules map the MoE's mlp to no axis")
    plan = routing_plan(params, x, cfg)
    xe = _Dispatch.apply(x, plan.slot, plan.src).view(
        E, B * plan.capacity, D)
    if ep is not None:
        xe = _Exchange.apply(xe, ep, True, "ep_dispatch")
    ye = _experts(params, xe, dt, mp)
    if ep is not None:
        ye = _Exchange.apply(ye, ep, False, "ep_combine")
    w = plan.gate.to(dt)
    y = _Combine.apply(ye.reshape(plan.n_slots, D),
                       w if mp is None else w.float(), plan.slot, plan.src)
    return y if mp is None else mp.all_sum("tp_moe", y).to(dt)


def moe_apply(params, x, cfg: ModelConfig):
    """x: (B, S, D) -> (B, S, D). With ``group_size`` set, the sequence is
    split into GShard groups (capacity per group) as in the reference."""
    return _grouped(lambda xg: _moe_indexed(params, xg, cfg), x, cfg)


# ---------------------------------------------------------------------------
# The reference's literal one-hot version (tests and chip_smoke.py only)
# ---------------------------------------------------------------------------


def _one_hot(idx, n: int):
    """``jax.nn.one_hot``: a comparison with arange (``F.one_hot`` checks
    its indices on the host, a device sync)."""
    return idx[..., None] == torch.arange(n, device=idx.device)


def onehot_dispatch(params, x, cfg: ModelConfig):
    """``_moe_dense_inner``'s (B, S, E, C) ``dispatch`` (bool) and
    ``combine`` (float32) tensors for x (B, S, D) in ``cfg.dtype``."""
    m = cfg.moe
    B, S, _ = x.shape
    E, K, C = m.num_experts, m.top_k, capacity(S, cfg)
    _, gate_idx, gate_vals = _router(params, x, cfg)
    dispatch = torch.zeros((B, S, E, C), dtype=torch.bool, device=x.device)
    combine = torch.zeros((B, S, E, C), dtype=torch.float32,
                          device=x.device)
    onehot_k = _one_hot(gate_idx, E).to(torch.int32)           # (B,S,K,E)
    prio = onehot_k.transpose(1, 2).reshape(B, K * S, E)     # choice-major
    pos_in_e = torch.cumsum(prio, dim=1) - prio
    pos_in_e = pos_in_e.reshape(B, K, S, E).transpose(1, 2)   # (B,S,K,E)
    for k in range(K):
        oh = onehot_k[:, :, k, :]
        pos = torch.sum(pos_in_e[:, :, k, :] * oh, dim=-1)
        keep = (pos < C) & (torch.sum(oh, -1) > 0)
        pos_oh = _one_hot(torch.where(keep, pos, C), C + 1).float()[..., :C]
        d_k = oh.float()[..., None] * pos_oh[:, :, None, :]
        dispatch = dispatch | (d_k > 0)
        combine = combine + d_k * gate_vals[:, :, k, None, None]
    return dispatch, combine


def _moe_onehot(params, x, cfg: ModelConfig):
    dt = torch_dtype(cfg.dtype)
    x = x.to(dt)
    dispatch, combine = onehot_dispatch(params, x, cfg)
    xe = torch.einsum("bsec,bsd->ebcd", dispatch.to(dt), x)
    h = torch.einsum("ebcd,edf->ebcf", xe, params["w_in"].to(dt))
    g = torch.einsum("ebcd,edf->ebcf", xe, params["w_gate"].to(dt))
    h = F.silu(g) * h
    ye = torch.einsum("ebcf,efd->ebcd", h, params["w_out"].to(dt))
    return torch.einsum("bsec,ebcd->bsd", combine.to(dt), ye)


def moe_apply_onehot(params, x, cfg: ModelConfig):
    """The reference's dense one-hot dispatch and combine, literally."""
    return _grouped(lambda xg: _moe_onehot(params, xg, cfg), x, cfg)


def load_balance_loss(logits, gate_idx, cfg: ModelConfig):
    """Switch-style auxiliary loss (the reference defines it and no path
    calls it)."""
    m = cfg.moe
    probs = torch.softmax(logits.float(), dim=-1)
    me = probs.mean(dim=(0, 1))
    ce = _one_hot(gate_idx[..., 0], m.num_experts).float().mean(dim=(0, 1))
    return m.num_experts * torch.sum(me * ce) * m.aux_loss_weight
