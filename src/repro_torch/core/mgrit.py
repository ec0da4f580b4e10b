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
- ``logical_constraint`` / ``_constrain`` and the spec's sharding fields
  are gone: on one device they constrain nothing.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Sequence

import torch

from repro_torch.tree import leaves_with_paths, tree_map

# step_fn(slot, z, h: float) -> z_next
StepFn = Callable[[Any, torch.Tensor, float], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class MGRITSpec:
    cf: int = 4
    levels: int = 2
    iters: int = 1
    h: float = 1.0


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


def _shift(z0, W):
    """New coarse points after C-relaxation: [z0, W[0], ..., W[J-2]]."""
    return torch.cat([z0[None], W[:-1]], dim=0)


# ---------------------------------------------------------------------------
# Exact serial solves (coarsest level / reference / buffer layers)
# ---------------------------------------------------------------------------


def serial_solve(step_fn: StepFn, stacked: Sequence, z0, h: float, g=None):
    """Exact forward substitution Z_{n+1} = Phi(Z_n) + g_n.

    Returns (states, zT): states[n] = Z_n for n = 0..N-1 and zT = Z_N.
    Differentiable by autograd when the step is.
    """
    states, z = [], z0
    for n, slot in enumerate(stacked):
        states.append(z)
        z = step_fn(slot, z, h)
        if g is not None:
            z = z + g[n]
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
            final_frelax: bool = True):
    """One FAS MGRIT V-cycle at ``level``.

    stacked: N_l slots; states: (N_l, *state) current values (states[n] =
    Z_n); zT: Z_{N_l}; g: None or (N_l, *state). Returns (states, zT,
    resnorm) improved. ``final_frelax=False`` skips the trailing
    interpolation F-relaxation, which the next cycle's opening sweep
    recomputes bit for bit.
    """
    N, cf = len(stacked), spec.cf
    if N % cf:
        raise ValueError(f"level {level}: N={N} not divisible by cf={cf}")
    J = N // cf
    Zc = states[::cf]

    # ---- FCF relaxation ----
    U = _f_relax(step_fn, stacked, Zc, g, cf, h)                   # F
    W = _c_step(step_fn, stacked, U, g, cf, h)                     # C
    Zc = _shift(z0, W)
    zT = W[-1]
    U = _f_relax(step_fn, stacked, Zc, g, cf, h)                   # F
    # propagated C-values of the relaxed iterate (residual + FAS rhs)
    W = _c_step(step_fn, stacked, U, g, cf, h)

    # ---- residual at C-points:  r_{(j+1)cf} = W[j] - Z_{(j+1)cf} ----
    u0 = torch.cat([Zc, zT[None]], dim=0)                          # (J+1,..)
    r = W - u0[1:]
    resnorm = torch.sqrt(torch.sum(torch.square(r.float())))

    # ---- coarse grid (FAS): u_{j+1} = Phi_c(u_j) + g_c[j] ----
    coarse = coarse_restrict(stacked, cf)
    h_c = h * cf
    phi_c_u0 = torch.stack([step_fn(coarse[j], u0[j], h_c)
                            for j in range(J)])
    g_c = W - phi_c_u0                                             # (J, ..)

    if level + 1 >= spec.levels - 1 or J % cf != 0:
        # exact coarsest solve: serial forward substitution
        cs, czT = serial_solve(step_fn, coarse, z0, h_c, g=g_c)
    else:
        cs, czT, _ = _vcycle(step_fn, coarse, z0, u0[:-1], u0[-1], g_c,
                             spec, level + 1, h_c)
    u_new = torch.cat([cs, czT[None]], dim=0)

    # ---- correct C-points and final F-relax (interpolation) ----
    e = u_new - u0
    Zc = Zc + e[:-1]
    zT = zT + e[-1]
    if final_frelax:
        states = _f_relax(step_fn, stacked, Zc, g, cf, h)
    else:
        # write back corrected C-points only; the stale F-points are
        # overwritten by the next cycle's opening F-relaxation anyway
        states = U.clone()
        states[::cf] = Zc
    return states, zT, resnorm


# ---------------------------------------------------------------------------
# Solve
# ---------------------------------------------------------------------------


def mgrit_solve(step_fn: StepFn, stacked: Sequence, z0, spec: MGRITSpec):
    """Run ``spec.iters`` MGRIT V-cycles for the evolution
    ``Z_{n+1} = step_fn(stacked[n], Z_n, h)``.

    Returns (states (N, *state) with states[n] = Z_n, zT, resnorms
    (iters,) float32). Initialisation is the coarse-grid propagation: a
    serial coarse traversal with Phi_c, then an F-relaxation fills the
    fine points. (The reference's ``init_states`` / ``init_zT`` warm
    start has no caller and is not ported.)
    """
    cf = spec.cf
    cs, zT = serial_solve(step_fn, coarse_restrict(stacked, cf), z0,
                          spec.h * cf)
    states = _f_relax(step_fn, stacked, cs, None, cf, spec.h)
    norms = []
    n_iters = max(spec.iters, 1)
    for i in range(n_iters):
        states, zT, rn = _vcycle(step_fn, stacked, z0, states, zT, None,
                                 spec, 0, spec.h,
                                 final_frelax=(i == n_iters - 1))
        norms.append(rn)
    return states, zT, torch.stack(norms)
