"""Logical-axis sharding rules: port of :mod:`repro.parallel.sharding`.

Tensors throughout the model code carry *logical* axis names (e.g.
``("batch", "seq", "embed")``). A ``ShardingConfig`` maps logical names
to physical mesh axes, and :func:`spec_for` turns the names of one
tensor into its spec: the tuple of mesh axes a dimension (None, an axis
name, or a tuple of axis names), entry for entry the reference's
``PartitionSpec``. The mesh is read only through its ``axis_names`` and
``shape`` (axis name -> size), so a JAX mesh, a
:class:`repro_torch.launch.mesh.Mesh` or any stand-in with those two
attributes will do.

The JAX package hands its specs to GSPMD, which inserts the collectives.
The port runs explicit SPMD instead: each rank holds its own slices
(:func:`repro_torch.parallel.params.shard_tree`) and the code that needs
another rank's data calls a collective itself (the MGRIT solver's halo,
the data-parallel gradient sum). So :func:`logical_constraint`
constrains nothing here; it keeps the reference's signature and rank
check for the code that calls it.
"""
from __future__ import annotations

import collections
import contextlib
import threading
from typing import Optional, Sequence, Tuple

from repro_torch.configs.base import ShardingConfig

_ctx = threading.local()

# aliases that share a physical mapping
_ALIASES = {"kv_heads": "heads", "seq": None, "head_dim": None,
            "state": None, "conv": None}

NamedSharding = collections.namedtuple("NamedSharding", "mesh spec")


def _state():
    if not hasattr(_ctx, "stack"):
        _ctx.stack = []
    return _ctx.stack


@contextlib.contextmanager
def axis_rules(mesh, cfg: ShardingConfig):
    """Activate the logical -> physical mapping for the enclosed code."""
    _state().append((mesh, cfg))
    try:
        yield
    finally:
        _state().pop()


def current_rules():
    """(mesh, ShardingConfig) of the innermost :func:`axis_rules`, or
    (None, None)."""
    st = _state()
    return st[-1] if st else (None, None)


def resolve_axis(logical: Optional[str], cfg: ShardingConfig, mesh):
    """Logical axis name -> physical mesh axis, tuple of axes, or None."""
    if logical is None:
        return None
    phys = getattr(cfg, logical, None) if hasattr(cfg, logical) else None
    if phys is None:
        alias = _ALIASES.get(logical, None)
        if alias is not None:
            phys = getattr(cfg, alias, None)
    if phys is None:
        return None
    if "+" in phys:  # compound mapping, e.g. "data+pod", "data+model"
        axes = tuple(a for a in phys.split("+") if a in mesh.axis_names)
        if phys == "data+pod":  # pod leads for contiguous batch shards
            axes = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
        return axes if axes else None
    if phys not in mesh.axis_names:
        return None
    return phys


def axis_tuple(ax) -> Tuple[str, ...]:
    """A spec entry as a tuple of axis names (() for None)."""
    if ax is None:
        return ()
    return ax if isinstance(ax, tuple) else (ax,)


def axis_size(mesh, ax) -> int:
    size = 1
    for a in axis_tuple(ax):
        size *= mesh.shape[a]
    return size


def canonical(axes) -> tuple:
    """A spec as ``PartitionSpec`` stores it: a one-axis tuple entry is
    that axis's name."""
    return tuple(a[0] if isinstance(a, tuple) and len(a) == 1 else a
                 for a in axes)


def spec_for(names: Sequence[Optional[str]], cfg: ShardingConfig, mesh,
             shape: Optional[Sequence[int]] = None) -> tuple:
    axes = []
    used = set()
    for i, n in enumerate(names):
        ax = resolve_axis(n, cfg, mesh)
        if ax is not None:
            flat = axis_tuple(ax)
            bad = any(a in used for a in flat)
            if shape is not None and shape[i] % axis_size(mesh, ax):
                bad = True  # non-divisible: drop instead of erroring
            if bad:
                ax = None
            else:
                used.update(flat)
        axes.append(ax)
    return canonical(axes)


def logical_constraint(x, names: Sequence[Optional[str]]):
    """The reference's sharding constraint. In explicit SPMD each rank
    already holds exactly its slice, so there is nothing to constrain:
    ``x`` is returned as it is. The rank check is kept."""
    mesh, cfg = current_rules()
    if mesh is None or cfg is None:
        return x
    if x.ndim != len(names):
        raise ValueError(f"rank {x.ndim} != names {names}")
    return x


def named_sharding(mesh, cfg: ShardingConfig,
                   names: Sequence[Optional[str]]) -> NamedSharding:
    return NamedSharding(mesh, spec_for(names, cfg, mesh))


def _is_names(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(n, (str, type(None)))
                                        for n in x)


def tree_shardings(mesh, cfg: ShardingConfig, logical_tree):
    """Map a nested dict of logical-axis tuples to NamedShardings."""
    if _is_names(logical_tree):
        return named_sharding(mesh, cfg, logical_tree)
    if isinstance(logical_tree, dict):
        return {k: tree_shardings(mesh, cfg, v)
                for k, v in logical_tree.items()}
    return logical_tree


def chunk_axis(n_layers: int, cf: int, cfg: ShardingConfig, mesh,
               shard_levels: int = 1) -> Optional[str]:
    """The mesh axis that an MGRIT trunk of ``n_layers`` stacked layers
    (J = n_layers / cf chunks) runs its chunks over, or None where every
    rank runs all of them: ``layers`` resolves to one axis, level 0 is
    sharded (``shard_levels`` >= 1) and the chunks divide over the axis
    (``n_layers % (cf * size) == 0``: no chunk straddles two ranks),
    else replicated, as the reference's solver falls back to
    replication. The single owner of that decision: the solver's layout
    and the trunk's storage both follow it."""
    ax = resolve_axis("layers", cfg, mesh)
    if isinstance(ax, tuple):
        ax = ax[0] if len(ax) == 1 else None
    if ax is None or shard_levels < 1 or cf < 1 \
            or n_layers % (cf * mesh.shape[ax]):
        return None
    return ax
