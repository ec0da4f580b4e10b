"""Fully sharded data parallelism in training: the port's execution of
``ShardingConfig.fsdp``.

The reference storage-shards the largest unsharded dimension of every
leaf of 4M elements or more over the fsdp axis
(:func:`repro_torch.parallel.params.build_spec`) and leaves it to XLA to
all-gather each such leaf just in time. The port does it explicitly: a
rank stores its even contiguous piece of the leaf, its gradient and its
AdamW moments (:func:`repro_torch.parallel.params.shard_tree` with
``sharding``), and every use of the leaf sees it whole:

  * the MGRIT trunk gathers one layer's leaves for each F evaluation
    (forward relaxation, coarse solve, adjoint and the parameter VJPs
    alike) and frees them after it; each layer's parameter VJP is
    reduce-scattered as soon as it is complete (:mod:`repro_torch.core.lp`);
  * every other cut leaf (the embeddings, the open and close buffers, a
    serial backbone) is gathered once a forward through
    :meth:`Plan.gather_tree` with ``grad=True``, whose backward
    reduce-scatters the cotangent. Autograd keeps a matmul's weight until
    the backward, so these leaves are whole from their gather to the
    backward.

The reduce-scatter sums the data ranks' batch shards, so it is the data
mean's sum for such a leaf already: :func:`repro_torch.launch.steps.make_grad_fn`
leaves the fsdp axis out of its all-reduce for it. Collectives
(counted by :class:`repro_torch.launch.mesh.Mesh`): ``fsdp_gather`` (an
all-gather of one leaf or one layer's leaf), ``fsdp_grad`` (a
reduce-scatter of one gradient).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.tree import Path


def _map_with_path(fn, tree, prefix: Path = ()):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, prefix + (k,))
                for k, v in tree.items()}
    return None if tree is None else fn(prefix, tree)


class _Gather(torch.autograd.Function):
    """A leaf's piece -> the whole leaf (all-gather over ``axis`` along
    ``dim``); backward: the cotangent reduce-scattered back to the
    piece."""

    @staticmethod
    def forward(ctx, t, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return mesh.all_gather("fsdp_gather", t, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return (ctx.mesh.reduce_scatter("fsdp_grad", g, ctx.axis, ctx.dim),
                None, None, None)


@dataclasses.dataclass(frozen=True)
class Plan:
    """The fsdp-cut leaves of a params tree (or of one subtree, with
    paths relative to it): (key path, the cut dimension, the mesh axis)
    each, over ``mesh``."""
    mesh: Any
    cut: Tuple[Tuple[Path, int, str], ...]

    def under(self, prefix: Path, lead: int = 0) -> Optional["Plan"]:
        """The plan of the subtree at ``prefix``, its paths relative to
        it; ``lead``: leading dimensions a view of the subtree drops (1
        for one layer of a stacked trunk, whose cut dimension is then
        one lower). None where no cut leaf lies below ``prefix``."""
        n = len(prefix)
        cut = []
        for path, d, ax in self.cut:
            if path[:n] != prefix:
                continue
            if d < lead:
                raise NotImplementedError(
                    f"{'.'.join(path)}: fsdp cuts dimension {d}, which one "
                    "layer's view does not hold")
            cut.append((path[n:], d - lead, ax))
        return dataclasses.replace(self, cut=tuple(cut)) if cut else None

    def gather_tree(self, tree, grad: bool = False, skip=()):
        """``tree`` with every cut leaf whole (one all-gather each), the
        leaves under the top-level keys ``skip`` left as they are.
        ``grad``: through :class:`_Gather`, whose backward
        reduce-scatters the cotangent; else a plain gather (under
        ``no_grad`` or of detached leaves)."""
        at = {p: (d, ax) for p, d, ax in self.cut}

        def one(path, leaf):
            if path not in at or path[0] in skip:
                return leaf
            d, ax = at[path]
            if grad:
                return _Gather.apply(leaf, self.mesh, ax, d)
            return self.mesh.all_gather("fsdp_gather", leaf, ax, d)

        return _map_with_path(one, tree)

    def scatter_grads(self, paths, grads):
        """The gradients ``grads`` of the whole leaves at ``paths``, each
        cut leaf's reduce-scattered to this rank's piece."""
        at = {p: (d, ax) for p, d, ax in self.cut}
        return [self.mesh.reduce_scatter("fsdp_grad", g, at[p][1], at[p][0])
                if p in at else g for p, g in zip(paths, grads, strict=True)]


def plan_of(cut: Dict[Path, Tuple[int, str]], mesh) -> Optional[Plan]:
    """The :class:`Plan` of :func:`repro_torch.parallel.params.fsdp_cut`'s
    result (None where nothing is cut)."""
    if not cut:
        return None
    return Plan(mesh, tuple((p, d, ax) for p, (d, ax) in cut.items()))
