"""Tensor parallelism at run time: the Megatron split of serving and of
training.

The JAX package hands its rules (serving's
:func:`repro_torch.configs.registry.serve_sharding`, training's
``train_sharding`` / ``tp_sharding``) to GSPMD, which inserts the
collectives. The port runs the split itself: under the active rules
(:func:`active`, entered by the paged serve, verify and draft steps of a
mesh engine and by the dense decode step under a mesh, or training's
:func:`repro_torch.parallel.sharding.axis_rules`, entered by
:func:`repro_torch.launch.steps.make_grad_fn`; :func:`current` reads
serving's first) the model code asks :func:`split` whether a dimension
named ``heads``, ``kv_heads``, ``mlp`` or ``vocab`` is cut over a mesh
axis of more than one rank, runs on its rank's columns or rows of each
weight (cut once, with :func:`repro_torch.parallel.params.shard_tree`),
and sums or gathers over that axis through the mesh's counted
collectives. The MoE's expert axis reads the same rules
(:func:`repro_torch.models.moe.expert_split`). The dense-cache decode
step under a mesh (:func:`repro_torch.launch.steps.make_serve_fn`)
cuts more: ``batch`` cuts its slots over the data ranks
(:func:`local_rows`) and ``kv_seq`` may cut the cache along the
sequence (:func:`seq_split`), each rank attending over its slice and the
slices' partial softmaxes merged by their log-sum-exp
(:func:`merge_partials`); both read serving's rules only (in training
the batch is this rank's rows already). Without rules :func:`split` is
None everywhere and the model code runs as it always did.

The split differentiates (Megatron's pair, over the counted collectives):
:meth:`Split.column` runs the column-parallel products of an input every
rank holds whole and, in a backward, sums its cotangent over the ranks
(each holds the part its own columns gave: Megatron's copy into the
split, fused with the products); :meth:`Split.all_sum` sums the
ranks' partial outputs and passes the cotangent through unchanged;
:meth:`Split.all_gather` puts the ranks' pieces together and hands each
rank its piece of the cotangent summed over the ranks (a
reduce-scatter). Cotangents are summed in float32 and rounded once.
Under ``torch.no_grad`` (serving, decode) they issue exactly the forward
collectives.

A dimension may be packed from several blocks that split apart (mamba1's
``in_proj`` is ``[x | z]``): a layout is a list of ``(size, split)``
blocks, a split block cut evenly over the ranks, a whole block (mamba2's
B and C, one group) copied to every rank. :func:`slice_blocks` gives a
rank's piece and :func:`join_blocks` puts the pieces of every rank back
together; :mod:`repro_torch.parallel.params` stores the weights and
the page pools with them.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch.parallel.sharding import (axis_tuple, current_rules,
                                           resolve_axis)

Blocks = Sequence[Tuple[int, bool]]

_ctx = threading.local()


@contextlib.contextmanager
def active(mesh, cfg):
    """Run the enclosed model code tensor-parallel over ``mesh`` under
    the sharding rules ``cfg`` (a ``ShardingConfig``)."""
    prev = getattr(_ctx, "rules", None)
    _ctx.rules = (mesh, cfg)
    try:
        yield
    finally:
        _ctx.rules = prev


def _serving():
    """(mesh, ShardingConfig) of the innermost :func:`active`, or None.
    Serving's rules stay apart from training's: they cut the slots and
    the cache (:func:`local_rows`, :func:`seq_split`), which training's
    batch (this rank's rows already) must not be cut by, and training's
    readers (the fsdp plan, the MGRIT layout) must not see serving's
    ``fsdp`` or batch axes where serving runs an encoder trunk."""
    return getattr(_ctx, "rules", None)


def _wants_grad(t: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and t.requires_grad


class _AllSum(torch.autograd.Function):
    """The ranks' partials summed (``kind``); backward: the identity (every
    rank reads the sum whole, so its cotangent is each partial's)."""

    @staticmethod
    def forward(ctx, t, sp, kind):
        return sp.mesh.all_sum(kind, t.clone(
            memory_format=torch.contiguous_format), (sp.axis,))

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _AllGather(torch.autograd.Function):
    """The ranks' pieces concatenated along ``dim`` (``kind``); backward:
    this rank's piece of the cotangent summed over the ranks
    (``<kind>_grad``, a reduce-scatter: each rank used the whole in its
    own way)."""

    @staticmethod
    def forward(ctx, t, sp, kind, dim):
        ctx.sp, ctx.kind, ctx.dim = sp, kind, dim
        return sp.mesh.all_gather(kind, t, sp.axis, dim=dim)

    @staticmethod
    def backward(ctx, g):
        sp = ctx.sp
        g32 = g.to(torch.float32)
        return sp.mesh.reduce_scatter(ctx.kind + "_grad", g32, sp.axis,
                                      ctx.dim).to(g.dtype), None, None, None


class _Column(torch.autograd.Function):
    """``x @ w`` for each ``w`` (this rank's columns; ``x`` whole on every
    rank); backward: each weight's gradient as one device's, and ``x``'s
    cotangent from this rank's products in float32, summed over the
    split's ranks (``<kind>_grad``) and rounded once: one device's
    contraction over every column, split in the ranks' pieces."""

    @staticmethod
    def forward(ctx, sp, kind, x, *ws):
        ctx.sp, ctx.kind = sp, kind
        ctx.save_for_backward(x, *ws)
        return tuple(x @ w for w in ws)

    @staticmethod
    def backward(ctx, *gs):
        x, *ws = ctx.saved_tensors
        sp = ctx.sp
        x2 = x.reshape(-1, x.shape[-1])
        dx, dws = None, []
        for g, w in zip(gs, ws, strict=True):
            g2 = g.reshape(-1, g.shape[-1])
            part = partial_product(g2, w.t())
            dx = part if dx is None else dx + part
            dws.append(x2.t() @ g2 if ctx.needs_input_grad[3 + len(dws)]
                       else None)
        dx = sp.mesh.all_sum(ctx.kind + "_grad", dx, (sp.axis,))
        return (None, None, dx.to(x.dtype).reshape(x.shape), *dws)


@dataclasses.dataclass(frozen=True)
class Split:
    """A dimension cut over ``axis`` of ``mesh``: ``n`` ranks, this one
    at ``r``."""
    mesh: object
    axis: str
    n: int
    r: int

    def column(self, kind: str, x: torch.Tensor,
               *ws: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """``x @ w`` for each of ``ws`` (2-d, this rank's columns), ``x``
        held whole on every rank: column-parallel products sharing one
        input. In a backward ``x``'s cotangent is this rank's products'
        part summed over the ranks in float32 and rounded once, as one
        device's single product over every column rounds once."""
        if _wants_grad(x) or any(_wants_grad(w) for w in ws):
            return _Column.apply(self, kind, x, *ws)
        return tuple(x @ w for w in ws)

    def all_sum(self, kind: str, t: torch.Tensor) -> torch.Tensor:
        """The sum of every rank's ``t`` (in place without a gradient to
        carry)."""
        if _wants_grad(t):
            return _AllSum.apply(t, self, kind)
        return self.mesh.all_sum(kind, t, (self.axis,))

    def all_gather(self, kind: str, t: torch.Tensor,
                   dim: int) -> torch.Tensor:
        return _AllGather.apply(t, self, kind, dim) if _wants_grad(t) \
            else self.mesh.all_gather(kind, t, self.axis, dim=dim)


def axis_of(mesh, cfg, logical: str) -> Optional[str]:
    """The one mesh axis of more than one rank that ``logical`` maps to
    under ``cfg``, else None (a compound mapping is not executed)."""
    axes = axis_tuple(resolve_axis(logical, cfg, mesh))
    if len(axes) != 1 or mesh.shape[axes[0]] == 1:
        return None
    return axes[0]


def split(logical: str, full: int) -> Optional[Split]:
    """The split of a ``full``-long dimension named ``logical`` under
    the active rules (:func:`current`), or None: without rules, where
    the name maps to no axis of more than one rank, or where ``full``
    does not divide over it (then every rank runs the whole dimension,
    as the reference's spec drops the mapping)."""
    return _split(logical, full, current())


def _split(logical: str, full: int, rules) -> Optional[Split]:
    mesh, cfg = rules
    if mesh is None:
        return None
    ax = axis_of(mesh, cfg, logical)
    if ax is None or full % mesh.shape[ax]:
        return None
    return Split(mesh, ax, mesh.shape[ax], mesh.index(ax))


@dataclasses.dataclass(frozen=True)
class SeqSplit:
    """The dense cache's sequence cut over the mesh ``axes`` (the first
    major, each of more than one rank): ``n`` slices of ``size`` rows,
    this rank's the ``r``-th, from row ``offset``."""
    mesh: object
    axes: Tuple[str, ...]
    n: int
    r: int
    size: int

    @property
    def offset(self) -> int:
        return self.r * self.size


def seq_split(rows: int, local: bool = False) -> Optional[SeqSplit]:
    """The cut of a dense cache of ``rows`` rows (``local``: this rank's
    slice holds ``rows``) along its sequence under :func:`active`, or
    None: outside it, or where ``kv_seq`` maps to no axis of more than
    one rank. A whole length that does not divide over those ranks
    raises (the reference's spec would keep it whole on every rank; the
    port cuts the sequence wherever the rules say)."""
    rules = _serving()
    if rules is None:
        return None
    mesh, cfg = rules
    axes = tuple(a for a in axis_tuple(resolve_axis("kv_seq", cfg, mesh))
                 if mesh.shape[a] > 1)
    if not axes:
        return None
    if axis_of(mesh, cfg, "batch") in axes:
        raise NotImplementedError(
            f"kv_seq over {axes} and the batch over "
            f"{axis_of(mesh, cfg, 'batch')!r}: one axis cannot cut both")
    n = math.prod(mesh.shape[a] for a in axes)
    if not local and rows % n:
        raise NotImplementedError(
            f"a dense cache of {rows} rows does not cut into {n} slices "
            f"over {axes}: take a max_len that divides")
    r = 0
    for a in axes:
        r = r * mesh.shape[a] + mesh.index(a)
    return SeqSplit(mesh, axes, n, r, rows if local else rows // n)


def local_rows(full: int) -> int:
    """This rank's share of ``full`` slots (the ``batch`` dimension)
    under :func:`active`: ``full`` itself where it is not cut (and under
    training's rules, whose batch is this rank's rows already)."""
    sp = _split("batch", full, _serving() or (None, None))
    return full // sp.n if sp else full


def merge_partials(out: torch.Tensor, lse: torch.Tensor,
                   heads: Optional[Split], seq: SeqSplit) -> torch.Tensor:
    """Attention over the whole sequence from this rank's partial over
    its slice: ``out`` (B, S, Hq, hd) and ``lse`` (B, S, Hq) float32, the
    query heads it attended. Where ``heads`` cuts the query heads over
    one of ``seq``'s axes, one all-to-all over that axis sends each head
    block's partial to the rank that owns those heads; over every other
    axis of ``seq`` one all-gather brings the other slices' partials.
    Then the partials are merged in rank order, each weighted by
    exp(lse - max): a slice that holds no key of a row (lse -inf, or
    -1e30 from the plain version) weighs zero. Returns (B, S, H_own, hd)
    in ``out``'s dtype, the same bits on every rank of a head group."""
    B, S, Hq, hd = out.shape
    o, ls = out.float(), lse
    mesh = seq.mesh
    n = 1
    if heads is not None and heads.axis in seq.axes:
        n = heads.n
        o = o.unflatten(2, (n, Hq // n)).movedim(2, 0)
        ls = ls.unflatten(2, (n, Hq // n)).movedim(2, 0)
    else:
        o, ls = o[None], ls[None]
    h_own = o.shape[3]
    pack = torch.cat([o.reshape(n, -1), ls.reshape(n, -1)], dim=1)
    if n > 1:
        pack = mesh.all_to_all("kv_seq_combine", pack, heads.axis, dim=0)
    for a in seq.axes:
        if heads is not None and a == heads.axis:
            continue
        pack = mesh.all_gather("kv_seq_combine", pack, a, dim=0)
    k = pack.shape[0]
    n_o = B * S * h_own * hd
    o = pack[:, :n_o].reshape(k, B, S, h_own, hd)
    ls = pack[:, n_o:].reshape(k, B, S, h_own)
    m = ls.amax(dim=0)
    w = torch.exp(ls - m)
    num = (w[..., None] * o).sum(dim=0)
    return (num / w.sum(dim=0)[..., None]).to(out.dtype)


def current():
    """(mesh, ShardingConfig) of the innermost :func:`active`, else of
    training's innermost :func:`repro_torch.parallel.sharding.axis_rules`,
    or (None, None)."""
    return _serving() or current_rules()


class _PartialProduct(torch.autograd.Function):
    """``x @ w`` accumulated and returned in float32 from inputs in
    ``x``'s type (the card's ``out_dtype`` product); backward: one
    device's products in ``x``'s type."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        mm = torch.bmm if x.ndim == 3 else torch.mm
        return mm(x, w, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype)
        return g @ w.transpose(-1, -2), x.transpose(-1, -2) @ g


def partial_product(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` (2-d, or 3-d batched over the leading dimension) in
    float32, from inputs in ``x``'s type: one device's product before
    it rounds, the partial sum a row-parallel rank contributes."""
    if x.dtype == torch.float32:
        return x @ w
    if x.is_cuda:
        return _PartialProduct.apply(x, w)
    return x.float() @ w.float()


def row_parallel(sp: Optional[Split], kind: str, x: torch.Tensor,
                 w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` contracted over a dimension that ``sp`` cuts over the
    ranks (``x``'s last dimension and ``w``'s rows this rank's part;
    None: not cut): the partial products in float32, summed over the
    ranks and rounded once to ``x``'s type, as one device's product
    accumulates in float32 and rounds once (partials rounded each and
    summed in ``x``'s type would round twice). The backward passes the
    sum's cotangent to each rank's partial product
    (:meth:`Split.all_sum`)."""
    if sp is None:
        return x @ w
    part = partial_product(x.reshape(-1, x.shape[-1]), w)
    return sp.all_sum(kind, part).to(x.dtype).reshape(
        *x.shape[:-1], w.shape[-1])


def even(full: int) -> List[Tuple[int, bool]]:
    return [(full, True)]


def local_size(blocks: Blocks, n: int) -> int:
    return sum(size // n if cut else size for size, cut in blocks)


def slice_blocks(x, dim: int, blocks: Blocks, n: int, r: int):
    """Rank ``r``'s piece of ``x`` along ``dim`` (a tensor or numpy
    array): each split block's r-th of ``n`` parts, each whole block
    entire, in block order (a view where there is one block)."""
    dim = dim % x.ndim
    pieces, o = [], 0
    for size, cut in blocks:
        lo, hi = (o + r * (size // n), o + (r + 1) * (size // n)) if cut \
            else (o, o + size)
        sl = [slice(None)] * x.ndim
        sl[dim] = slice(lo, hi)
        pieces.append(x[tuple(sl)])
        o += size
    if o != x.shape[dim]:
        raise ValueError(f"blocks {list(blocks)} cover {o} of dim {dim} "
                         f"({x.shape[dim]})")
    if len(pieces) == 1:
        return pieces[0]
    if isinstance(x, torch.Tensor):
        return torch.cat(pieces, dim=dim)
    import numpy as np
    return np.concatenate(pieces, axis=dim)


def join_blocks(parts: Sequence[torch.Tensor], dim: int, blocks: Blocks):
    """The inverse of :func:`slice_blocks`: every rank's piece (in rank
    order) put back into the whole dimension; a whole block is taken
    from rank 0's piece."""
    n = len(parts)
    dim = dim % parts[0].ndim
    out, o = [], 0
    for size, cut in blocks:
        m = size // n if cut else size
        for p in (parts if cut else parts[:1]):
            out.append(p.narrow(dim, o, m))
        o += m
    return torch.cat(out, dim=dim)
