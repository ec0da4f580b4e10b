"""MGRIT (multigrid-reduction-in-time) over the transformer layer dimension.

Port of :mod:`repro.core.mgrit` for one device. The fine time grid of N
layers is chunked into J = N / c_f coarse intervals; one call to
:func:`_vcycle` is one FAS V-cycle (F-relaxation, C-relaxation, residual,
coarse solve, correction, interpolating F-relaxation), and
:func:`mgrit_solve` runs ``spec.iters`` of them after a coarse-grid
initialisation.

What differs from the reference, and why:

- The layer stack is a Python list of per-layer slots (dicts of tensor
  views, see :func:`slots`), so reversing it (the adjoint) and restricting
  it to every c_f-th layer (the coarse grid) are list operations that copy
  no weights. The states stay stacked tensors ``(N, *state)``.
- ``jax.vmap`` over the J chunks and ``lax.scan`` over the steps become
  Python loops: at full width every layer's step already fills the card,
  and a loop keeps one layer's activations live at a time.
- Across ranks (a :class:`Layout` with a ``chunks`` axis) the solver is
  explicit SPMD where the reference leaves the collectives to GSPMD.
  Each rank holds the layers of its own chunks and relaxes only those;
  ``_shift``'s slice across the chunk axis is a halo exchange (each rank
  sends its last C-value to the next, the first takes ``z0``); ``zT`` is
  broadcast from the last owner; the residual norm is an all-reduced sum
  of squares (over the batch axes too). The serial coarse solve is a
  hand-off: each rank waits for the previous one's state, steps through
  its own coarse layers and passes the state on (the paper's serial
  coarse solve, as XBraid distributes it). It is the reference's
  replicated coarse solve bit for bit, without gathering the coarse
  layers' weights. A coarse level that recurses (``levels`` >= 3) stays
  sharded below ``shard_levels`` when its chunks divide over the ranks;
  else its problem and layers are all-gathered and every rank solves
  it, as the reference replicates it. With ``layout=None`` (one rank)
  no collective is made.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch

from repro_torch.parallel.sharding import (axis_tuple, chunk_axis,
                                           current_rules, spec_for)
from repro_torch.tree import leaves_with_paths, tree_map, unflatten

# step_fn(slot, z, h: float) -> z_next
StepFn = Callable[[Any, torch.Tensor, float], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class MGRITSpec:
    cf: int = 4
    levels: int = 2
    iters: int = 1
    h: float = 1.0
    # levels [0, shard_levels) keep the chunk axis sharded (where the
    # chunks divide over the ranks); deeper levels replicate
    shard_levels: int = 1


@dataclasses.dataclass(frozen=True)
class Layout:
    """Where a solve's data lives across the ranks of ``mesh`` (a
    :class:`repro_torch.launch.mesh.Mesh`).

    ``chunks``: the mesh axis the J chunks are split over in order, J/P
    to a rank (the rank at position p holds chunks [pJ/P, (p+1)J/P) and
    their layers), or None where every rank holds all of them.
    ``batch``: the mesh axes the state's batch rows are split over (the
    residual norm sums over them). ``reverse``: positions run from the
    axis's last rank to its first (the adjoint solve runs the stack
    backwards)."""
    mesh: Any
    chunks: Optional[str] = None
    batch: Tuple[str, ...] = ()
    reverse: bool = False

    @property
    def parts(self) -> int:
        return self.mesh.shape[self.chunks] if self.chunks else 1

    @property
    def pos(self) -> int:
        i = self.mesh.index(self.chunks) if self.chunks else 0
        return self.parts - 1 - i if self.reverse else i

    def _index(self, pos: int) -> int:
        return self.parts - 1 - pos if self.reverse else pos

    def _rank(self, pos: int) -> int:
        return self.mesh.global_rank(self.chunks, self._index(pos))

    def flipped(self) -> "Layout":
        return dataclasses.replace(self, reverse=not self.reverse)

    def replicated(self) -> "Layout":
        return dataclasses.replace(self, chunks=None)

    def shift_in(self, z0, last):
        """Send ``last`` to the next position; return the previous
        position's ``last`` (``z0`` at position 0)."""
        p, n = self.pos, self.parts
        buf = torch.empty_like(last) if p > 0 else None
        self.mesh.exchange("halo", (last, self._rank(p + 1)) if p + 1 < n
                           else None,
                           (buf, self._rank(p - 1)) if p > 0 else None)
        return z0 if p == 0 else buf

    def hand_in(self, z0):
        """The previous position's state (``z0`` at position 0)."""
        if self.pos == 0:
            return z0
        buf = torch.empty_like(z0)
        self.mesh.exchange("handoff", None, (buf, self._rank(self.pos - 1)))
        return buf

    def hand_on(self, z):
        """Send ``z`` to the next position (none after the last)."""
        if self.pos + 1 < self.parts:
            self.mesh.exchange("handoff", (z, self._rank(self.pos + 1)),
                               None)

    def from_last(self, t):
        """The last position's ``t`` on every rank (a new tensor)."""
        return self.mesh.broadcast(
            "broadcast", t.clone(memory_format=torch.contiguous_format),
            self.chunks, self._index(self.parts - 1))

    def sum_sq(self, x):
        """A sum of squares summed over the ranks the state is split
        over (the chunk axis and the batch axes)."""
        axes = ((self.chunks,) if self.chunks else ()) + self.batch
        if not axes:
            return x
        return self.mesh.all_sum("norm", x.reshape(1).clone(), axes)[0]

    def gather(self, t):
        """Every position's piece of ``t`` (leading dim), in position
        order."""
        full = self.mesh.all_gather("coarse_gather", t, self.chunks)
        if self.reverse:
            full = torch.cat(full.chunk(self.parts)[::-1])
        return full


def current_layout(n_layers: int, cf: int, shard_levels: int,
                   rows: int) -> Optional[Layout]:
    """The :class:`Layout` of a trunk of ``n_layers`` stacked layers and
    ``rows`` batch rows in all under the active
    :func:`repro_torch.parallel.sharding.axis_rules` (None without a
    mesh): its chunks over ``chunk_axis``'s choice, its rows over the
    batch axes where they divide."""
    mesh, cfg = current_rules()
    if mesh is None:
        return None
    return Layout(mesh, chunk_axis(n_layers, cf, cfg, mesh, shard_levels),
                  axis_tuple(spec_for(("batch",), cfg, mesh, (rows,))[0]))


def _chunked(lay: Optional[Layout]) -> bool:
    return lay is not None and lay.chunks is not None


def slots(stacked) -> List[Any]:
    """Per-layer views of a tree of tensors stacked on a leading layer
    axis: ``slots(t)[n]`` is ``t`` with every leaf indexed at ``n``."""
    n_layers = leaves_with_paths(stacked)[0][1].shape[0]
    return [tree_map(lambda a, n=n: a[n], stacked) for n in range(n_layers)]


# ---------------------------------------------------------------------------
# Relaxation sweeps
# ---------------------------------------------------------------------------


def _f_relax(step_fn: StepFn, stacked: Sequence, Zc, g, cf: int, h: float):
    """F-relaxation: propagate c_f - 1 steps from every coarse point.

    Zc: (J, *state) current coarse-point values; g: None or (N, *state)
    FAS rhs (g[n] is added producing point n + 1). Returns U (N, *state)
    with U[n] = Z_n.
    """
    U = []
    for j in range(Zc.shape[0]):
        z = Zc[j]
        U.append(z)
        for n in range(j * cf, (j + 1) * cf - 1):
            z = step_fn(stacked[n], z, h)
            if g is not None:
                z = z + g[n]
            U.append(z)
    return torch.stack(U)


def _c_step(step_fn: StepFn, stacked: Sequence, U, g, cf: int, h: float):
    """Propagate the last fine point of every chunk across the boundary:
    W[j] = Phi(U[j*cf + cf-1]) (+ g) = candidate value for Z_{(j+1)cf}."""
    W = []
    for n in range(cf - 1, U.shape[0], cf):
        w = step_fn(stacked[n], U[n], h)
        if g is not None:
            w = w + g[n]
        W.append(w)
    return torch.stack(W)


def _shift(z0, W, lay: Optional[Layout] = None):
    """New coarse points after C-relaxation: [z0, W[0], ..., W[J-2]]; on
    a chunk axis a halo exchange (this rank's W[-1] to the next)."""
    first = lay.shift_in(z0, W[-1]) if _chunked(lay) else z0
    return torch.cat([first[None], W[:-1]], dim=0)


# ---------------------------------------------------------------------------
# Exact serial solves (coarsest level / reference / buffer layers)
# ---------------------------------------------------------------------------


def serial_solve(step_fn: StepFn, stacked: Sequence, z0, h: float, g=None,
                 lay: Optional[Layout] = None):
    """Exact forward substitution Z_{n+1} = Phi(Z_n) + g_n.

    Returns (states, zT): states[n] = Z_n for n = 0..N-1 and zT = Z_N.
    Differentiable by autograd when the step is (one rank). On a chunk
    axis ``stacked``, ``g`` and the states are this rank's: it takes the
    previous rank's state (``z0`` at the first), steps through its own
    layers and hands the state on; zT is broadcast from the last.
    """
    if _chunked(lay):
        z0 = lay.hand_in(z0)
    states, z = [], z0
    for n, slot in enumerate(stacked):
        states.append(z)
        z = step_fn(slot, z, h)
        if g is not None:
            z = z + g[n]
    if _chunked(lay):
        lay.hand_on(z)
        z = lay.from_last(z)
    return torch.stack(states), z


# ---------------------------------------------------------------------------
# Level restriction
# ---------------------------------------------------------------------------


def coarse_restrict(stacked: Sequence, cf: int) -> list:
    """Level restriction R: the coarse propagator's arguments are the fine
    arguments at every ``cf``-th layer (coarse point j reuses the weights
    of layer ``j*cf``; the caller rescales the step, ``h_c = h * cf``)."""
    return list(stacked[::cf])


# ---------------------------------------------------------------------------
# The V-cycle
# ---------------------------------------------------------------------------


def _vcycle(step_fn: StepFn, stacked: Sequence, z0, states, zT, g,
            spec: MGRITSpec, level: int, h: float,
            final_frelax: bool = True, lay: Optional[Layout] = None):
    """One FAS MGRIT V-cycle at ``level``.

    stacked: N_l slots; states: (N_l, *state) current values (states[n] =
    Z_n); zT: Z_{N_l}; g: None or (N_l, *state). Returns (states, zT,
    resnorm) improved. ``final_frelax=False`` skips the trailing
    interpolation F-relaxation, which the next cycle's opening sweep
    recomputes bit for bit. On a chunk axis (``lay``) ``stacked``,
    ``states`` and ``g`` are this rank's chunks; z0, zT and resnorm are
    every rank's.
    """
    cf, P = spec.cf, lay.parts if _chunked(lay) else 1
    if len(stacked) % cf:
        raise ValueError(f"level {level}: N={len(stacked)} not divisible "
                         f"by cf={cf}")
    J = len(stacked) // cf * P                     # chunks on all ranks
    Zc = states[::cf]

    # ---- FCF relaxation ----
    U = _f_relax(step_fn, stacked, Zc, g, cf, h)                   # F
    W = _c_step(step_fn, stacked, U, g, cf, h)                     # C
    Zc = _shift(z0, W, lay)
    zT = lay.from_last(W[-1]) if _chunked(lay) else W[-1]
    # Z at this rank's chunks' right ends: the next Zc[0] is this W[-1]
    ends = torch.cat([Zc[1:], W[-1:]], dim=0)
    U = _f_relax(step_fn, stacked, Zc, g, cf, h)                   # F
    # propagated C-values of the relaxed iterate (residual + FAS rhs)
    W = _c_step(step_fn, stacked, U, g, cf, h)

    # ---- residual at C-points:  r_{(j+1)cf} = W[j] - Z_{(j+1)cf} ----
    r = W - ends
    sq = torch.sum(torch.square(r.float()))
    resnorm = torch.sqrt(lay.sum_sq(sq) if lay is not None else sq)

    # ---- coarse grid (FAS): u_{j+1} = Phi_c(u_j) + g_c[j] ----
    coarse = coarse_restrict(stacked, cf)
    h_c = h * cf
    phi_c_u0 = torch.stack([step_fn(coarse[j], Zc[j], h_c)
                            for j in range(Zc.shape[0])])
    g_c = W - phi_c_u0                                             # (J, ..)

    if level + 1 >= spec.levels - 1 or J % cf != 0:
        # exact coarsest solve: serial forward substitution
        cs, czT = serial_solve(step_fn, coarse, z0, h_c, g=g_c, lay=lay)
    elif not _chunked(lay) or P == 1 or (level + 1 < spec.shard_levels
                                         and (J // cf) % P == 0):
        # (a chunk axis of one rank holds every layer: gathering them
        # would only copy them)
        cs, czT, _ = _vcycle(step_fn, coarse, z0, Zc, zT, g_c, spec,
                             level + 1, h_c, lay=lay)
    else:
        # the coarse level runs replicated: gather its problem and layers
        mine = slice(lay.pos * Zc.shape[0], (lay.pos + 1) * Zc.shape[0])
        cs, czT, _ = _vcycle(step_fn, _gather_slots(coarse, lay), z0,
                             lay.gather(Zc), zT, lay.gather(g_c), spec,
                             level + 1, h_c, lay=lay.replicated())
        cs = cs[mine]

    # ---- correct C-points and final F-relax (interpolation) ----
    Zc = Zc + (cs - Zc)
    zT = zT + (czT - zT)
    if final_frelax:
        states = _f_relax(step_fn, stacked, Zc, g, cf, h)
    else:
        # write back corrected C-points only; the stale F-points are
        # overwritten by the next cycle's opening F-relaxation anyway
        states = U.clone()
        states[::cf] = Zc
    return states, zT, resnorm


def _gather_slots(stacked: Sequence, lay: Layout) -> list:
    """Every rank's slots of a level, in order (each leaf stacked over
    this rank's slots and all-gathered)."""
    paths = [p for p, _ in leaves_with_paths(stacked[0])]
    full = {p: lay.gather(torch.stack([dict(leaves_with_paths(s))[p]
                                       for s in stacked]))
            for p in paths}
    n = next(iter(full.values())).shape[0]
    return [unflatten((p, full[p][i]) for p in paths) for i in range(n)]


# ---------------------------------------------------------------------------
# Solve
# ---------------------------------------------------------------------------


def mgrit_solve(step_fn: StepFn, stacked: Sequence, z0, spec: MGRITSpec,
                lay: Optional[Layout] = None):
    """Run ``spec.iters`` MGRIT V-cycles for the evolution
    ``Z_{n+1} = step_fn(stacked[n], Z_n, h)``.

    Returns (states (N, *state) with states[n] = Z_n, zT, resnorms
    (iters,) float32). Initialisation is the coarse-grid propagation: a
    serial coarse traversal with Phi_c, then an F-relaxation fills the
    fine points. (The reference's ``init_states`` / ``init_zT`` warm
    start has no caller and is not ported.) On a chunk axis ``stacked``
    and the states are this rank's (see :class:`Layout`).
    """
    cf = spec.cf
    cs, zT = serial_solve(step_fn, coarse_restrict(stacked, cf), z0,
                          spec.h * cf, lay=lay)
    states = _f_relax(step_fn, stacked, cs, None, cf, spec.h)
    norms = []
    n_iters = max(spec.iters, 1)
    for i in range(n_iters):
        states, zT, rn = _vcycle(step_fn, stacked, z0, states, zT, None,
                                 spec, 0, spec.h,
                                 final_frelax=(i == n_iters - 1), lay=lay)
        norms.append(rn)
    return states, zT, torch.stack(norms)
