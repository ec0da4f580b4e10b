"""LayerParallelNet: the paper's ParallelNet as a torch autograd Function.

Port of :mod:`repro.core.lp`. :func:`lp_forward` evaluates the neural-ODE
trunk Z_{n+1} = Z_n + h*gate_n*F_n(Z_n) with an exact serial solve
(fwd_iters=0) or ``fwd_iters`` MGRIT V-cycles; its backward runs the
*adjoint* equation through the same MGRIT solver with its own
``bwd_iters`` count, then every layer's parameter gradient
g_n = h*gate_n*(dF/dtheta_n)^T lambda_{n+1}.

What differs from the reference, and why:

- ``jax.custom_vjp`` becomes :class:`_LPForward`. The forward solve runs
  without autograd; the backward builds F's graph one layer at a time
  under ``torch.enable_grad()`` and calls ``torch.autograd.grad`` (only
  first-order VJPs of F appear).
- ``jax.vmap`` over layers in ``_param_grads`` is a Python loop over the
  layers, each a VJP of one layer's F (see :mod:`repro_torch.core.mgrit`
  for why loops, not a stacked layer axis).
- The extra inputs (rope cos/sin) are built from positions, not
  parameters: they get no cotangent here (the reference computes one and
  nothing consumes it).
- Sharding fields (``znames``, ``use_pallas``) are gone: one device, and
  on the card the kernels are the only path.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List

import torch

from repro_torch.configs.base import MGRITConfig, ModelConfig
from repro_torch.core import mgrit
from repro_torch.models.blocks import block_F
from repro_torch.tree import leaves_with_paths, tree_map, unflatten

Extra = Dict[str, Any]  # per-call inputs: rope (cos, sin)


@dataclasses.dataclass(frozen=True)
class LPStatic:
    cfg: ModelConfig
    mgrit: MGRITConfig
    kind: str               # block kind (attn_mlp in this port)
    causal: bool = True

    def spec(self, iters: int) -> mgrit.MGRITSpec:
        return mgrit.MGRITSpec(cf=self.mgrit.cf, levels=self.mgrit.levels,
                               iters=iters, h=self.mgrit.h)


def eval_F(static: LPStatic, params, z, extra: Extra):
    """The ODE right-hand side F(t_n, Z) of paper Eq. 1/2."""
    return block_F(params, z, static.cfg, kind=static.kind,
                   causal=static.causal, rope=extra.get("rope"))


def make_fwd_step(static: LPStatic, extra: Extra) -> mgrit.StepFn:
    """Phi(z) = z + h * gate * F(z). ``slot`` = {"params", "gate"}."""
    def step(slot, z, h):
        f = eval_F(static, slot["params"], z, extra)
        return z + (h * slot["gate"].to(z.dtype)) * f
    return step


def make_adj_step(static: LPStatic, extra: Extra) -> mgrit.StepFn:
    """Adjoint propagator Psi(lam) = lam + h*gate*(dF/dZ)^T lam, evaluated
    at the stored forward state. ``slot`` = {"params", "gate", "z"}."""
    def step(slot, lam, h):
        z = slot["z"].detach().requires_grad_(True)
        with torch.enable_grad():
            f = eval_F(static, slot["params"], z, extra)
        (dz,) = torch.autograd.grad(f, z, lam)
        return lam + (h * slot["gate"].to(lam.dtype)) * dz
    return step


# ---------------------------------------------------------------------------
# Solves
# ---------------------------------------------------------------------------


def _forward_solve(static: LPStatic, stacked: List, z0, extra, iters: int):
    step = make_fwd_step(static, extra)
    if iters <= 0:
        states, zT = mgrit.serial_solve(step, stacked, z0, static.mgrit.h)
        norms = torch.zeros((1,), dtype=torch.float32, device=z0.device)
    else:
        states, zT, norms = mgrit.mgrit_solve(step, stacked, z0,
                                              static.spec(iters))
    return states, zT, norms


def _adjoint_solve(static: LPStatic, stacked: List, states, lamN, extra,
                   iters: int):
    """Solve the adjoint backward from lam_N. Returns (rev_lam, lam0, norms)
    with rev_lam[n] = lambda_{n+1} (the multiplier hitting layer n's
    output). The reversed stack is a reversed list: no weight is copied."""
    adj_stacked = [dict(slot, z=states[n])
                   for n, slot in reversed(list(enumerate(stacked)))]
    step = make_adj_step(static, extra)
    if iters <= 0:
        mu_states, mu_T = mgrit.serial_solve(step, adj_stacked, lamN,
                                             static.mgrit.h)
        norms = torch.zeros((1,), dtype=torch.float32, device=lamN.device)
    else:
        mu_states, mu_T, norms = mgrit.mgrit_solve(step, adj_stacked, lamN,
                                                   static.spec(iters))
    # mu_states[m] = lambda_{N-m}; layer n consumes lambda_{n+1} = mu[N-1-n]
    return torch.flip(mu_states, dims=(0,)), mu_T, norms


def _param_grads(static: LPStatic, stacked: List, states, rev_lam, extra):
    """Per-layer gradients g_theta_n = h*gate_n*(dF/dtheta_n)^T
    lambda_{n+1}, one layer at a time, written into stacked (N, ...)
    tensors in the order of ``leaves_with_paths(slot["params"])``."""
    h = static.mgrit.h
    out = None
    for n, slot in enumerate(stacked):
        paths, leaves = zip(*leaves_with_paths(slot["params"]))
        leaves = [p.detach().requires_grad_(True) for p in leaves]
        with torch.enable_grad():
            f = eval_F(static, unflatten(zip(paths, leaves)), states[n],
                       extra)
        ct = (h * slot["gate"].to(rev_lam.dtype)) * rev_lam[n]
        grads = torch.autograd.grad(f, leaves, ct)
        if out is None:
            out = [g.new_empty((len(stacked), *g.shape)) for g in grads]
        for acc, g in zip(out, grads):
            acc[n] = g
    return out


# ---------------------------------------------------------------------------
# autograd binding
# ---------------------------------------------------------------------------


class _LPForward(torch.autograd.Function):
    """(z0, gate, *param leaves) -> (zT, fwd_norms); backward = MGRIT
    adjoint. Gate gradients are zero (structural constants)."""

    @staticmethod
    def forward(ctx, static, extra, paths, z0, gate, *leaves):
        stacked = _layer_slots(unflatten(zip(paths, leaves)), gate)
        states, zT, norms = _forward_solve(static, stacked, z0, extra,
                                           static.mgrit.fwd_iters)
        ctx.save_for_backward(states, gate, *leaves)
        ctx.static, ctx.extra, ctx.paths = static, extra, paths
        ctx.mark_non_differentiable(norms)
        return zT, norms

    @staticmethod
    def backward(ctx, ct_zT, _ct_norms):
        states, gate, *leaves = ctx.saved_tensors
        static, extra = ctx.static, ctx.extra
        stacked = _layer_slots(unflatten(zip(ctx.paths, leaves)), gate)
        # the adjoint runs in the trunk's compute dtype (lambda ~ z)
        rev_lam, lam0, _ = _adjoint_solve(static, stacked, states,
                                          ct_zT.to(states.dtype), extra,
                                          static.mgrit.bwd_iters)
        d_leaves = _param_grads(static, stacked, states, rev_lam, extra)
        return (None, None, None, lam0, torch.zeros_like(gate), *d_leaves)


def _layer_slots(params, gate):
    """Per-layer {"params", "gate"} slots of detached weight views."""
    return [{"params": p, "gate": gate[n]} for n, p in
            enumerate(mgrit.slots(tree_map(torch.Tensor.detach, params)))]


def lp_forward(static: LPStatic, stacked, z0, extra: Extra):
    """Returns (zT, fwd_residual_norms). ``stacked`` = {"params": tree of
    (N, ...) tensors, "gate": (N,)}. The gradient is the MGRIT adjoint."""
    paths, leaves = zip(*leaves_with_paths(stacked["params"]))
    return _LPForward.apply(static, extra, paths, z0, stacked["gate"],
                            *leaves)


# ---------------------------------------------------------------------------
# Diagnostics for the adaptive controller (paper 3.2.3, Fig. 5)
# ---------------------------------------------------------------------------


def lp_diagnose(static: LPStatic, stacked, z0, extra, seed_ct,
                fwd_iters: int, bwd_iters: int):
    """Run forward + adjoint MGRIT with explicit iteration counts and
    return both residual-norm sequences (the controller doubles the
    counts to estimate the convergence factor of the final iteration)."""
    layers = _layer_slots(stacked["params"], stacked["gate"])
    with torch.no_grad():
        states, zT, fwd_norms = _forward_solve(static, layers, z0, extra,
                                               max(fwd_iters, 1))
        _, _, bwd_norms = _adjoint_solve(static, layers, states,
                                         seed_ct(zT), extra,
                                         max(bwd_iters, 1))
    return fwd_norms, bwd_norms
