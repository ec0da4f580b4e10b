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

What this port executes of them: :func:`shard_tree` slices a leaf along
the logical axes its caller executes. Training executes ``layers``,
``batch``, ``experts``, ``fsdp`` and the tensor-parallel axes ``heads``,
``kv_heads``, ``mlp`` and ``vocab`` (:data:`EXECUTED`), on the
reference's training spec (a Mamba mixer's per-row vectors whole); a
leaf whose spec names a mesh axis that the port does not cut (the MoE
router's experts, a Mamba split whose rows do not divide) is kept whole
on every rank and listed. A whole leaf, or whole block of a cut leaf,
that the ranks of a tensor-parallel axis read in part holds a partial
gradient on each (:func:`tp_partial`). ``fsdp`` is no logical axis of a
leaf: it names the dimension :func:`build_spec`'s fallback storage-shards over
``ShardingConfig.fsdp`` (:func:`fsdp_dim`), which the callers that cut
it pass as ``sharding``. Such a leaf is stored in even contiguous
pieces and rebuilt whole for each use (:mod:`repro_torch.parallel.fsdp`).
Serving executes :data:`SERVE_EXECUTED`: the slots and page
pools over ``data``, Megatron tensor parallelism over ``model`` and the
experts where the rules map them. The dense decode step under a mesh
executes :data:`DECODE_EXECUTED`: serving's axes, the dense cache's
rows over ``kv_seq`` and the fsdp fallback's storage cut
(:func:`repro_torch.launch.steps.shard_decode_params`). ``experts``
cuts the expert leaves
(``w_in`` / ``w_gate`` / ``w_out``, each rank its E/n experts, whose
products it runs: :mod:`repro_torch.models.moe`); the router's experts
dimension is never cut (every rank routes its own tokens over all E),
so the router is kept whole and listed where its spec names an axis.

GSPMD makes a contiguous split of a packed axis correct by
communicating; explicit tensor parallelism cannot, so a leaf packed from
blocks that split apart is cut block by block (:func:`model_blocks`):
mamba1's ``in_proj`` ``[x | z]``, mamba2's ``in_proj`` ``[z | x | B C |
dt]`` and its conv weight and conv pool ``[x | B C]`` (B and C are one
group, whole on every rank). :func:`local_slice` gives a rank's piece
and :func:`gather_leaf` its inverse, bit for bit.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, RunConfig, ShardingConfig
from repro_torch.parallel import tp
from repro_torch.parallel.sharding import (axis_size, axis_tuple,
                                           canonical, chunk_axis,
                                           resolve_axis)
from repro_torch.tree import Path, leaf_at, leaves_with_paths

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

# The per-row vectors of a Mamba mixer (mamba1: di long; mamba2: one a
# head). The reference's specs keep them whole, as GSPMD reads them
# replicated; the serving layout cuts them with the mixer's rows, so that
# a rank holds only the leaves its model code reads (serve_logical_axes_for).
_SERVE_LEAF_AXES = {
    **_LEAF_AXES,
    ("dt_bias", 1): ("mlp",),
    ("D", 1): ("mlp",),
    ("A_log", 1): ("mlp",),
    ("conv_b", 1): ("mlp",),
}

_STACKED_ROOTS = ("mid", "enc_mid", "dec_mid")
_FSDP_MIN_SIZE = 1 << 22  # only storage-shard leaves >= 4M elements

# the logical axes training executes (slices storage and work along);
# "fsdp" stands for the dimension fsdp_dim names
EXECUTED = ("layers", "batch", "experts", "fsdp", "heads", "kv_heads",
            "mlp", "vocab")
# ... and serving: slots and pools over data, Megatron TP over model,
# the experts where the rules map them
SERVE_EXECUTED = ("batch", "pages", "heads", "kv_heads", "mlp", "vocab",
                  "experts")
# ... and the dense decode step: serving's axes, the cache's rows over
# kv_seq, big leaves stored one slice a rank of the fsdp axis
DECODE_EXECUTED = SERVE_EXECUTED + ("kv_seq", "fsdp")
_TP_AXES = ("heads", "kv_heads", "mlp", "vocab")


def logical_axes_for(path: Path, shape,
                     table=_LEAF_AXES) -> Tuple[Optional[str], ...]:
    """Logical axes of the params leaf at key path ``path`` (a tuple of
    dict keys), its own dimensions' names from ``table``."""
    names = set(path)
    leaf = path[-1] if path else ""
    in_trunk = bool(names & set(_STACKED_ROOTS))
    in_buffer = bool(names & {"open", "close", "backbone"})
    stacked = in_trunk or in_buffer
    if leaf == "gate":
        return ("layers",)
    base_ndim = len(shape) - (1 if stacked else 0)
    base = table.get((leaf, base_ndim), (None,) * base_ndim)
    if stacked:
        return (("layers",) if in_trunk else (None,)) + base
    return base


def serve_logical_axes_for(path: Path, shape) -> Tuple[Optional[str], ...]:
    """:func:`logical_axes_for` with a Mamba mixer's per-row vectors
    named over its rows (``_SERVE_LEAF_AXES``): the serving layout."""
    return logical_axes_for(path, shape, _SERVE_LEAF_AXES)


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


def fsdp_dim(logical: Tuple[Optional[str], ...], spec,
             sharding: Optional[ShardingConfig], mesh) -> Optional[int]:
    """The dimension of a leaf (its ``logical`` axes and ``spec``) that
    :func:`build_spec`'s fallback placed on ``sharding.fsdp``: the one
    whose spec entry is that axis while its logical name does not resolve
    to it. None without such a dimension (or without ``sharding``)."""
    fs = None if sharding is None else sharding.fsdp
    if not fs:
        return None
    for d, (name, ax) in enumerate(zip(logical, spec, strict=True)):
        if ax == fs and axis_tuple(resolve_axis(name, sharding,
                                                mesh)) != (fs,):
            return d
    return None


def _map_with_path(fn, tree, prefix: Path = ()):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, prefix + (k,))
                for k, v in tree.items()}
    return fn(prefix, tree)


def param_specs(params, rcfg: RunConfig, mesh, logical=logical_axes_for):
    """The tree of specs matching ``params`` (tensors or meta tensors;
    the optimizer's host-int ``step`` gets ``()``); ``logical``:
    :func:`serve_logical_axes_for` gives the serving layout's."""
    cfg = rcfg.sharding

    def one(path, leaf):
        if not isinstance(leaf, torch.Tensor):
            return ()
        return build_spec(logical(path, leaf.shape), leaf.shape, cfg, mesh)

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


def pool_logical(path: Path, shape) -> tuple:
    """A page-pool leaf's logical axes (:func:`paged_state_specs`)."""
    return _PAGED_POOL_AXES.get((path[-1], len(shape)), (None,) * len(shape))


def cache_logical(path: Path, shape) -> tuple:
    """A dense decode cache leaf's logical axes (:func:`cache_specs`)."""
    return _CACHE_AXES.get((path[-1], len(shape)), (None,) * len(shape))


def mamba_version(cfg: ModelConfig) -> int:
    """The mixer of an SSM or hybrid model: 1 or 2 (hybrid backbones are
    mamba2)."""
    return 2 if cfg.family == "hybrid" else cfg.ssm.version


def mamba_blocks(cfg: ModelConfig, name: str) -> tp.Blocks:
    """The blocks of a Mamba mixer's packed dimension: ``in_proj``'s
    output (mamba1 ``[x | z]``, mamba2 ``[z | x | B C | dt]``) or
    ``conv``'s channels (the conv weight, bias and pool: mamba1 ``x``,
    mamba2 ``[x | B C]``)."""
    s = cfg.ssm
    di = s.expand * cfg.d_model
    v2 = mamba_version(cfg) == 2
    if name == "in_proj":
        return [(di, True), (di, True)] + (
            [(2 * s.d_state, False), (di // s.headdim, True)] if v2 else [])
    return [(di, True)] + ([(2 * s.d_state, False)] if v2 else [])


def model_blocks(path: Path, size: int, cfg: Optional[ModelConfig],
                 n: int) -> Optional[tp.Blocks]:
    """How a whole dimension of ``size`` that the spec maps to a
    tensor-parallel axis of ``n`` ranks (so ``size`` divides) is cut:
    its blocks, or None where the leaf stays whole because the split the
    model code runs does not divide (a Mamba mixer splits only where its
    rows, di for mamba1 and the heads for mamba2, divide). Without
    ``cfg`` every dimension is one even block."""
    if cfg is None and "mixer" in path:
        raise ValueError(f"{'.'.join(path)}: a Mamba mixer's leaf is cut "
                         "block by block: pass the model config (cfg=)")
    if cfg is not None and cfg.ssm is not None and (
            "mixer" in path or path[-1] in ("conv", "h")):
        s = cfg.ssm
        di = s.expand * cfg.d_model
        if (di if mamba_version(cfg) == 1 else di // s.headdim) % n:
            return None
        if path[-1] == "in_proj":
            return mamba_blocks(cfg, "in_proj")
        if path[-1] in ("conv_w", "conv_b", "conv"):
            return mamba_blocks(cfg, "conv")
    return tp.even(size)


def _split_dims(path: Path, leaf, spec, mesh, executed=EXECUTED, cfg=None,
                logical=None, local=False, sharding=None):
    """(the dims of ``leaf`` cut over ``executed`` logical axes, each
    with its mesh axes and blocks; whether the spec names an axis that
    stays whole: one not executed, or a block split that does not
    divide). ``local``: ``leaf`` is a rank's piece already (an even
    block's whole size is then its size times the ranks). ``sharding``:
    the rules that made ``spec``, which name its fsdp dimension."""
    split, whole = [], False
    names = list((logical or _logical_of)(path, leaf.shape))
    fd = fsdp_dim(names, spec, sharding, mesh)
    if fd is not None:
        names[fd] = "fsdp"
    for d, (name, ax) in enumerate(zip(names, spec, strict=True)):
        if ax is None:
            continue
        blocks = None
        if name in executed and (name, path[-1]) != ("experts", "router"):
            n = axis_size(mesh, ax)
            if n == 1:              # one rank holds the whole dimension
                continue
            size = leaf.shape[d] * (n if local else 1)
            blocks = model_blocks(path, size, cfg, n) \
                if name in _TP_AXES else tp.even(size)
        if blocks is None:
            whole = True
        else:
            split.append((d, axis_tuple(ax), blocks))
    return split, whole


def local_slice(leaf, path: Path, spec, mesh, *, executed=EXECUTED,
                cfg: Optional[ModelConfig] = None, logical=None,
                sharding: Optional[ShardingConfig] = None):
    """This rank's slice of the full ``leaf`` (a tensor or numpy array;
    a view where slicing allows) along the dims cut over ``executed``
    logical axes (``cfg``: the model, for the block layouts of
    :func:`model_blocks`; ``logical``: the leaf's logical axes from its
    path, batch and params trees' by default, :func:`pool_logical` for
    page pools; ``sharding``: the rules of ``spec``, whose fsdp
    dimension is then cut too)."""
    if not spec:
        return leaf
    split, _ = _split_dims(path, leaf, spec, mesh, executed, cfg, logical,
                           sharding=sharding)
    for d, axes, blocks in split:
        idx, size = 0, 1
        for a in axes:                       # the first axis is major
            idx, size = idx * mesh.shape[a] + mesh.index(a), \
                size * mesh.shape[a]
        leaf = tp.slice_blocks(leaf, d, blocks, size, idx)
    return leaf


def gather_leaf(leaf: torch.Tensor, path: Path, spec, mesh,
                kind: str = "gather", *, executed=EXECUTED,
                cfg: Optional[ModelConfig] = None, logical=None,
                sharding: Optional[ShardingConfig] = None):
    """The full leaf from every rank's slice (the inverse of
    :func:`local_slice`): all-gathers along the split dims, the minor
    mesh axis of a dim first; a dim of several blocks is put back
    together block by block."""
    if not spec:
        return leaf
    split, _ = _split_dims(path, leaf, spec, mesh, executed, cfg, logical,
                           local=True, sharding=sharding)
    for d, axes, blocks in split:
        if len(blocks) > 1:              # one tensor-parallel axis
            (a,) = axes
            parts = mesh.all_gather(kind, leaf, a, dim=d).chunk(
                mesh.shape[a], dim=d)
            leaf = tp.join_blocks(parts, d, blocks)
            continue
        for a in reversed(axes):
            leaf = mesh.all_gather(kind, leaf, a, dim=d)
    return leaf


def shard_tree(full, specs, mesh, *, executed=EXECUTED,
               cfg: Optional[ModelConfig] = None, logical=None,
               sharding: Optional[ShardingConfig] = None
               ) -> Tuple[dict, List[Path]]:
    """Each leaf of ``full`` cut to this rank's slice (``local_slice``,
    copied contiguous so that the full tensor can be freed; a leaf that
    no axis of 2+ ranks cuts is returned as it is), and the key paths of
    the leaves kept whole although their spec names a mesh axis (an axis
    not executed, or a block split that does not divide). ``sharding``:
    the rules of ``specs``, for the fsdp dimensions."""
    whole: List[Path] = []

    def one(path, leaf):
        spec = leaf_at(specs, path)
        if not isinstance(leaf, torch.Tensor) or not spec:
            return leaf
        split, keep = _split_dims(path, leaf, spec, mesh, executed, cfg,
                                  logical, sharding=sharding)
        if keep:
            whole.append(path)
        return local_slice(leaf, path, spec, mesh, executed=executed,
                           cfg=cfg, logical=logical, sharding=sharding
                           ).clone(memory_format=torch.contiguous_format) \
            if split else leaf

    return _map_with_path(one, full), whole


def expert_cut(tree, specs, mesh) -> Dict[Path, Tuple[str, ...]]:
    """The leaves of a params tree (full shapes; meta tensors will do)
    whose experts dimension a spec of ``specs`` cuts over mesh axes of
    more than one rank, each with those axes: every rank holds its own
    experts' slice, and its gradient its experts' (the router, never
    cut, is not one of them)."""
    out = {}
    for path, leaf in leaves_with_paths(tree):
        spec = leaf_at(specs, path)
        if not spec or path[-1] == "router":
            continue
        for name, ax in zip(_logical_of(path, leaf.shape), spec,
                            strict=True):
            axes = tuple(a for a in axis_tuple(ax) if mesh.shape[a] > 1)
            if name == "experts" and axes:
                out[path] = axes
    return out


def tp_cut(tree, specs, mesh, cfg: Optional[ModelConfig],
           sharding: ShardingConfig) -> Dict[Path, Tuple[str, ...]]:
    """The leaves of a params tree (full shapes; meta tensors will do)
    that a spec of ``specs`` (made under ``sharding``, whose fsdp
    dimension is no tensor-parallel cut) cuts over a tensor-parallel axis
    of more than one rank (``heads``, ``kv_heads``, ``mlp``, ``vocab``),
    each with those axes: every rank holds its own slice (``cfg``: the
    model, for the Mamba block layouts)."""
    out = {}
    for path, leaf in leaves_with_paths(tree):
        spec = leaf_at(specs, path)
        if not spec:
            continue
        split, _ = _split_dims(path, leaf, spec, mesh, _TP_AXES, cfg,
                               sharding=sharding)
        axes = tuple(a for _, axs, _ in split for a in axs)
        if axes:
            out[path] = axes
    return out


def tp_partial(tree, mesh, rcfg: RunConfig
               ) -> Dict[Path, Tuple[str, Optional[Tuple[int, int]]]]:
    """The leaves of a training params tree (full shapes) whose gradient
    each rank of a tensor-parallel axis holds in part, each with that
    axis and the range of its last dimension (on this rank's slice) so
    held, None for all of it: the leaves, and whole blocks of cut leaves,
    that every rank stores whole and reads for its own heads or rows
    only. Under a mamba2 inner split: the per-row vectors that serving's
    layout cuts over ``mlp`` and training's keeps whole (``conv_b``,
    ``dt_bias``, ``D``, ``A_log``: :func:`serve_logical_axes_for` against
    :func:`logical_axes_for`), the gated norm's ``norm_scale`` (whole in
    both: each rank keeps its own columns of the normed rows), and the B
    C block of ``in_proj`` and of ``conv_w``. Under a heads split:
    ``q_norm`` / ``k_norm``, and ``wk`` / ``wv`` where the KV heads do
    not divide (each rank reads its group's head). Their sum over the
    axis is the gradient. (A mamba1 mixer is split in serving only:
    :func:`repro_torch.models.ssm.mamba1_apply` raises under a
    gradient.)"""
    cfg, rules = rcfg.model, rcfg.sharding

    def axis(logical, full):
        ax = tp.axis_of(mesh, rules, logical)
        return None if ax is None or full % mesh.shape[ax] else ax

    heads = axis("heads", cfg.n_heads)
    kv_whole = heads is not None and cfg.n_kv_heads % mesh.shape[heads]
    inner = None
    if cfg.ssm is not None and mamba_version(cfg) == 2:
        s = cfg.ssm
        inner = axis("mlp", s.expand * cfg.d_model // s.headdim)
    out = {}
    for path, leaf in leaves_with_paths(tree):
        name = path[-1]
        if "mixer" in path and inner is not None:
            if name == "norm_scale" or (
                    "mlp" in serve_logical_axes_for(path, leaf.shape)
                    and "mlp" not in logical_axes_for(path, leaf.shape)):
                out[path] = (inner, None)
            elif name in ("in_proj", "conv_w"):
                blocks = mamba_blocks(cfg, "in_proj" if name == "in_proj"
                                      else "conv")
                # [z | x | B C | dt] or [x | B C]: B C after the x block
                lo = tp.local_size(blocks[:2 if name == "in_proj" else 1],
                                   mesh.shape[inner])
                out[path] = (inner, (lo, lo + 2 * cfg.ssm.d_state))
        elif len(path) > 1 and path[-2] in ("attn", "xattn") \
                and heads is not None and (
                    name in ("q_norm", "k_norm")
                    or (kv_whole and name in ("wk", "wv"))):
            out[path] = (heads, None)
    return out


def fsdp_cut(tree, specs, mesh,
             sharding: ShardingConfig) -> Dict[Path, Tuple[int, str]]:
    """The leaves of a params tree (full shapes; meta tensors will do)
    whose fsdp dimension (:func:`fsdp_dim`) is cut over an axis of more
    than one rank, each with (that dimension, the axis): every rank
    stores an even contiguous piece of it."""
    fs = sharding.fsdp
    if not fs or fs not in mesh.axis_names or mesh.shape[fs] == 1:
        return {}
    out = {}
    for path, leaf in leaves_with_paths(tree):
        spec = leaf_at(specs, path)
        if not spec:
            continue
        d = fsdp_dim(_logical_of(path, leaf.shape), spec, sharding, mesh)
        if d is not None:
            out[path] = (d, fs)
    return out


def gather_tree(local, specs, mesh, *, executed=EXECUTED,
                cfg: Optional[ModelConfig] = None, logical=None,
                sharding: Optional[ShardingConfig] = None):
    """The inverse of :func:`shard_tree`: every leaf whole on every
    rank."""
    def one(path, leaf):
        if not isinstance(leaf, torch.Tensor):
            return leaf
        return gather_leaf(leaf, path, leaf_at(specs, path), mesh,
                           executed=executed, cfg=cfg, logical=logical,
                           sharding=sharding)

    return _map_with_path(one, local)
