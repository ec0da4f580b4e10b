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
:func:`repro_torch.models.moe.expert_split`). Outside :func:`active`
(training, the dense decode, an engine without a mesh) :func:`split`
is None everywhere and the model code runs as it always did.

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
