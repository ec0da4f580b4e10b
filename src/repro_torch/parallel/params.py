"""Parameter / cache / batch specs by key path, and each rank's slices:
port of :mod:`repro.parallel.params`.

``param_specs`` walks a params tree (tensors, meta tensors included)
and gives every leaf its spec (a tuple of mesh axes a dimension, entry
for entry the reference's ``PartitionSpec``):

  * stacked trunk leaves (under mid/enc_mid/dec_mid) get a leading
    "layers" axis: the MGRIT chunk axis, over the physical 'model' axis
    in the paper's training regime;
  * weight-matrix dims map to logical heads/mlp/embed/vocab/experts axes;
  * if ``sharding.fsdp`` is set, the largest still-unsharded dim of every
    big leaf is storage-sharded over the fsdp axis;
  * every mapping is divisibility-checked against the mesh and dropped
    when it does not divide.

What this port executes of them: :func:`shard_tree` slices a leaf only
along its ``layers`` and ``batch`` dimensions (:data:`EXECUTED`). A leaf
whose spec names a mesh axis for another logical axis (vocab, heads,
mlp, experts, kv_seq, fsdp) is kept whole on every rank: its math is
unchanged, only its storage differs from the reference's, and
:func:`shard_tree` lists it. Tensor parallelism comes with the serving
slice.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from repro_torch.configs.base import RunConfig, ShardingConfig
from repro_torch.parallel.sharding import (axis_size, axis_tuple,
                                           canonical, chunk_axis,
                                           resolve_axis)
from repro_torch.tree import Path, leaf_at

# logical axis tuples by (leaf name, ndim) — without the stacked prefix
_LEAF_AXES = {
    ("tok", 2): ("vocab", "embed"),
    ("out", 2): ("vocab", "embed"),
    ("wq", 3): ("embed", "heads", "head_dim"),
    ("wk", 3): ("embed", "kv_heads", "head_dim"),
    ("wv", 3): ("embed", "kv_heads", "head_dim"),
    ("wo", 3): ("heads", "head_dim", "embed"),
    ("w_in", 2): ("embed", "mlp"),
    ("w_gate", 2): ("embed", "mlp"),
    ("w_out", 2): ("mlp", "embed"),
    ("w_in", 3): ("experts", "embed", "mlp"),
    ("w_gate", 3): ("experts", "embed", "mlp"),
    ("w_out", 3): ("experts", "mlp", "embed"),
    ("router", 2): ("embed", "experts"),
    ("in_proj", 2): ("embed", "mlp"),
    ("x_proj", 2): ("mlp", None),
    ("dt_proj", 2): (None, "mlp"),
    ("A_log", 2): ("mlp", None),
    ("conv_w", 2): (None, "mlp"),
    ("out_proj", 2): ("mlp", "embed"),
}

_STACKED_ROOTS = ("mid", "enc_mid", "dec_mid")
_FSDP_MIN_SIZE = 1 << 22  # only storage-shard leaves >= 4M elements

# the logical axes this slice executes (slices storage and work along)
EXECUTED = ("layers", "batch")


def logical_axes_for(path: Path, shape) -> Tuple[Optional[str], ...]:
    """Logical axes of the params leaf at key path ``path`` (a tuple of
    dict keys)."""
    names = set(path)
    leaf = path[-1] if path else ""
    in_trunk = bool(names & set(_STACKED_ROOTS))
    in_buffer = bool(names & {"open", "close", "backbone"})
    stacked = in_trunk or in_buffer
    if leaf == "gate":
        return ("layers",)
    base_ndim = len(shape) - (1 if stacked else 0)
    base = _LEAF_AXES.get((leaf, base_ndim), (None,) * base_ndim)
    if stacked:
        return (("layers",) if in_trunk else (None,)) + base
    return base


def build_spec(logical: Tuple[Optional[str], ...], shape,
               cfg: ShardingConfig, mesh) -> tuple:
    """Resolve logical names -> physical axes with divisibility checks,
    per-tensor axis dedupe, and an FSDP fallback for large leaves."""
    used = set()
    phys = []
    for dim, name in zip(shape, logical, strict=True):
        ax = resolve_axis(name, cfg, mesh)
        if ax is not None:
            axs = axis_tuple(ax)
            if any(a in used for a in axs) or dim % axis_size(mesh, ax):
                ax = None
            else:
                used.update(axs)
        phys.append(ax)
    # FSDP: storage-shard the largest unsharded dim of big leaves
    n = 1
    for d in shape:
        n *= d
    if cfg.fsdp and cfg.fsdp in mesh.axis_names and cfg.fsdp not in used \
            and n >= _FSDP_MIN_SIZE:
        fs = mesh.shape[cfg.fsdp]
        cands = [(d, i) for i, (d, ax) in enumerate(zip(shape, phys,
                                                        strict=True))
                 if ax is None and d % fs == 0]
        if cands:
            _, i = max(cands)
            phys[i] = cfg.fsdp
    return canonical(phys)


def _map_with_path(fn, tree, prefix: Path = ()):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, prefix + (k,))
                for k, v in tree.items()}
    return fn(prefix, tree)


def param_specs(params, rcfg: RunConfig, mesh):
    """The tree of specs matching ``params`` (tensors or meta tensors;
    the optimizer's host-int ``step`` gets ``()``)."""
    cfg = rcfg.sharding

    def one(path, leaf):
        if not isinstance(leaf, torch.Tensor):
            return ()
        return build_spec(logical_axes_for(path, leaf.shape), leaf.shape,
                          cfg, mesh)

    return _map_with_path(one, params)


# ---------------------------------------------------------------------------
# Batches and caches
# ---------------------------------------------------------------------------

_BATCH_AXES = {
    "tokens": ("batch", None),
    "labels": ("batch", None),
    "src_tokens": ("batch", None),
    "mm_embeds": ("batch", None, "embed"),
    "src_embeds": ("batch", None, "embed"),
}

_CACHE_AXES = {
    ("k", 5): (None, "batch", "kv_seq", "kv_heads", "head_dim"),
    ("v", 5): (None, "batch", "kv_seq", "kv_heads", "head_dim"),
    ("conv", 4): (None, "batch", None, "mlp"),
    ("h", 4): (None, "batch", "mlp", None),
    ("h", 5): (None, "batch", "mlp", None, None),
    ("index", 0): (),
}

# Paged-serving page pools (the serve backends' state trees): the
# batch/seq axes replaced by one global physical-page axis (axis 1).
_PAGED_POOL_AXES = {
    ("k", 5): (None, "pages", None, "kv_heads", "head_dim"),
    ("v", 5): (None, "pages", None, "kv_heads", "head_dim"),
    ("conv", 4): (None, "pages", None, "mlp"),
    ("h", 4): (None, "pages", "mlp", None),
    ("h", 5): (None, "pages", "heads", None, None),
}


def _batch_logical(name: str, ndim: int):
    return _BATCH_AXES.get(name, ("batch",) + (None,) * (ndim - 1))


def batch_specs(batch, rcfg: RunConfig, mesh):
    """Specs of a batch dict (tensors or numpy arrays): rows over the
    batch axis."""
    cfg = rcfg.sharding
    return {name: build_spec(_batch_logical(name, len(a.shape)), a.shape,
                             cfg, mesh) for name, a in batch.items()}


def cache_specs(cache, rcfg: RunConfig, mesh):
    """Specs of a dense decode cache (stacked over layers, per-slot batch
    axis)."""
    return _state_specs(cache, rcfg, mesh, _CACHE_AXES)


def paged_state_specs(state, rcfg: RunConfig, mesh):
    """Specs of a serve backend's page-pool state tree: physical pages
    over the serving DP axis, head/inner dims over TP, a non-divisible
    mapping dropped (replicated), never an error."""
    return _state_specs(state, rcfg, mesh, _PAGED_POOL_AXES)


def _state_specs(tree, rcfg: RunConfig, mesh, table):
    cfg = rcfg.sharding

    def one(path, leaf):
        logical = table.get((path[-1], leaf.ndim), (None,) * leaf.ndim)
        return build_spec(logical, leaf.shape, cfg, mesh)

    return _map_with_path(one, tree)


# ---------------------------------------------------------------------------
# What a rank holds
# ---------------------------------------------------------------------------


def train_specs(tree, rcfg: RunConfig, mesh):
    """:func:`param_specs` of a params or optimizer-state tree (full
    shapes; meta tensors will do), with the layer axis of an MGRIT trunk
    whose chunks do not divide over the mesh dropped: that trunk runs
    replicated (:func:`repro_torch.parallel.sharding.chunk_axis`), so
    every rank stores all its layers."""
    cfg, mg = rcfg.sharding, rcfg.mgrit
    specs = param_specs(tree, rcfg, mesh)

    def one(path, spec):
        if spec and set(path) & set(_STACKED_ROOTS) and spec[0] is not None:
            n_layers = leaf_at(tree, path).shape[0]
            if chunk_axis(n_layers, mg.cf, cfg, mesh, mg.shard_levels) \
                    is None:
                return (None,) + spec[1:]
        return spec

    return _map_with_path(one, specs)


def _logical_of(path: Path, shape) -> tuple:
    """A leaf's logical axes from its key path: a batch tree's leaves sit
    at the root, params and optimizer-state leaves below it."""
    if len(path) == 1:
        return _batch_logical(path[0], len(shape))
    return logical_axes_for(path, shape)


def _split_dims(path: Path, leaf, spec) -> Tuple[List[Tuple[int, tuple]],
                                                 bool]:
    """(the dims of ``leaf`` this slice splits, each with its mesh axes;
    whether the spec names an axis this slice does not execute)."""
    split, whole = [], False
    for d, (name, ax) in enumerate(zip(_logical_of(path, leaf.shape),
                                       spec, strict=True)):
        if ax is None:
            continue
        if name in EXECUTED:
            split.append((d, axis_tuple(ax)))
        else:
            whole = True
    return split, whole


def local_slice(leaf, path: Path, spec, mesh):
    """This rank's slice of the full ``leaf`` (a tensor or numpy array;
    a view where slicing allows) along the dims this slice splits."""
    if not spec:
        return leaf
    split, _ = _split_dims(path, leaf, spec)
    for d, axes in split:
        idx, size = 0, 1
        for a in axes:                       # the first axis is major
            idx, size = idx * mesh.shape[a] + mesh.index(a), \
                size * mesh.shape[a]
        n = leaf.shape[d] // size
        sl = [slice(None)] * len(leaf.shape)
        sl[d] = slice(idx * n, (idx + 1) * n)
        leaf = leaf[tuple(sl)]
    return leaf


def gather_leaf(leaf: torch.Tensor, path: Path, spec, mesh,
                kind: str = "gather"):
    """The full leaf from every rank's slice: all-gathers along the
    split dims, the minor mesh axis of a dim first."""
    if not spec:
        return leaf
    split, _ = _split_dims(path, leaf, spec)
    for d, axes in split:
        for a in reversed(axes):
            leaf = mesh.all_gather(kind, leaf, a, dim=d)
    return leaf


def shard_tree(full, specs, mesh) -> Tuple[dict, List[Path]]:
    """Each leaf of ``full`` cut to this rank's slice (``local_slice``,
    cloned so that the full tensor can be freed), and the key paths of
    the leaves kept whole although their spec names a mesh axis (an axis
    this slice does not execute)."""
    whole: List[Path] = []

    def one(path, leaf):
        spec = leaf_at(specs, path)
        if not isinstance(leaf, torch.Tensor) or not spec:
            return leaf
        split, keep = _split_dims(path, leaf, spec)
        if keep:
            whole.append(path)
        return local_slice(leaf, path, spec, mesh).clone() if split \
            else leaf

    return _map_with_path(one, full), whole


def gather_tree(local, specs, mesh):
    """The inverse of :func:`shard_tree`: every leaf whole on every
    rank."""
    def one(path, leaf):
        if not isinstance(leaf, torch.Tensor):
            return leaf
        return gather_leaf(leaf, path, leaf_at(specs, path), mesh)

    return _map_with_path(one, local)
