"""Tensor parallelism at run time: the serving slice's Megatron split.

The JAX package hands the serving rules
(:func:`repro_torch.configs.registry.serve_sharding`) to GSPMD, which
inserts the collectives. The port runs the split itself: inside
:func:`active` (entered by the paged serve, verify and draft steps of a
mesh engine) the model code asks :func:`split` whether a dimension
named ``heads``, ``kv_heads``, ``mlp`` or ``vocab`` is cut over a mesh
axis of more than one rank, runs on its rank's columns or rows of each
weight (the serve backend cut the weights once, with
:func:`repro_torch.parallel.params.shard_tree`), and sums or gathers
over that axis through the mesh's counted collectives. The MoE's
expert axis reads the same rules (:func:`current`;
:func:`repro_torch.models.moe.expert_split`). The dense-cache decode
step under a mesh (:func:`repro_torch.launch.steps.make_serve_fn`)
enters it too: there ``batch`` cuts the slots over the data ranks and
``kv_seq`` may cut the cache along the sequence (:func:`seq_split`),
each rank attending over its slice and the slices' partial softmaxes
merged by their log-sum-exp (:func:`merge_partials`). Outside
:func:`active` (training, an engine without a mesh) :func:`split` is
None everywhere and the model code runs as it always did.

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

from repro_torch.parallel.sharding import axis_tuple, resolve_axis

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


@dataclasses.dataclass(frozen=True)
class Split:
    """A dimension cut over ``axis`` of ``mesh``: ``n`` ranks, this one
    at ``r``."""
    mesh: object
    axis: str
    n: int
    r: int

    def all_sum(self, kind: str, t: torch.Tensor) -> torch.Tensor:
        return self.mesh.all_sum(kind, t, (self.axis,))

    def all_gather(self, kind: str, t: torch.Tensor,
                   dim: int) -> torch.Tensor:
        return self.mesh.all_gather(kind, t, self.axis, dim=dim)


def axis_of(mesh, cfg, logical: str) -> Optional[str]:
    """The one mesh axis of more than one rank that ``logical`` maps to
    under ``cfg``, else None (a compound mapping is not executed)."""
    axes = axis_tuple(resolve_axis(logical, cfg, mesh))
    if len(axes) != 1 or mesh.shape[axes[0]] == 1:
        return None
    return axes[0]


def split(logical: str, full: int) -> Optional[Split]:
    """The split of a ``full``-long dimension named ``logical`` under
    :func:`active`, or None: outside it, where the name maps to no axis
    of more than one rank, or where ``full`` does not divide over it
    (then every rank runs the whole dimension, as the reference's spec
    drops the mapping)."""
    rules = getattr(_ctx, "rules", None)
    if rules is None:
        return None
    mesh, cfg = rules
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
    rules = getattr(_ctx, "rules", None)
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
    under :func:`active`: ``full`` itself where it is not cut."""
    sp = split("batch", full)
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
    """(mesh, ShardingConfig) of the innermost :func:`active`, or (None,
    None)."""
    return getattr(_ctx, "rules", None) or (None, None)


def partial_product(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` (2-d, or 3-d batched over the leading dimension) in
    float32, from inputs in ``x``'s type: one device's product before
    it rounds, the partial sum a row-parallel rank contributes."""
    if x.dtype == torch.float32:
        return x @ w
    if x.is_cuda:
        mm = torch.bmm if x.ndim == 3 else torch.mm
        return mm(x, w, out_dtype=torch.float32)
    return x.float() @ w.float()


def row_parallel(sp: Optional[Split], kind: str, x: torch.Tensor,
                 w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` contracted over a dimension that ``sp`` cuts over the
    ranks (``x``'s last dimension and ``w``'s rows this rank's part;
    None: not cut): the partial products in float32, summed over the
    ranks and rounded once to ``x``'s type, as one device's product
    accumulates in float32 and rounds once (partials rounded each and
    summed in ``x``'s type would round twice)."""
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
