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
- Of the extra inputs, only ``xa`` (the encoder's output, read by the
  ``encdec_dec`` kind's cross-attention) is differentiable: its
  cotangent, summed over the layers, is the reference's ``d_extra`` and
  flows into the encoder trunk's own adjoint. Rope cos/sin are built
  from positions, not parameters: they get no cotangent here (the
  reference computes one and nothing consumes it).
- ``znames`` and ``use_pallas`` are gone: on the card the kernels are
  the only path. Under a mesh, ``LPStatic.layout`` says where the trunk
  lives (:class:`repro_torch.core.mgrit.Layout`): each rank holds and
  differentiates the layers of its own chunks. The adjoint runs the
  stack backwards, so its chunks run from the last rank to the first
  (the halo goes r -> r-1); lambda_0, the cotangent of z0, comes out of
  the solve on every rank (the solver broadcasts zT), so the replicated
  layers before the trunk see the same value everywhere; ``xa``'s
  cotangent, a sum over the layers, is all-reduced over the chunk axis.
  Where ``LPStatic.fsdp`` names leaves stored cut over the fsdp axis
  (:mod:`repro_torch.parallel.fsdp`), every F evaluation gathers its
  layer's leaves whole and drops them after it, and each layer's
  parameter VJP is reduce-scattered to this rank's piece as soon as it
  is complete: one whole layer lives at a time.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, List, Optional

import torch

from repro_torch.configs.base import MGRITConfig, ModelConfig
from repro_torch.core import mgrit
from repro_torch.models.blocks import block_F
from repro_torch.parallel.fsdp import Plan
from repro_torch.parallel.sharding import axis_rules, current_rules
from repro_torch.tree import leaves_with_paths, tree_map, unflatten

Extra = Dict[str, Any]  # per-call inputs: rope (cos, sin), None for
                        # mamba; xa for encdec_dec


@dataclasses.dataclass(frozen=True)
class LPStatic:
    cfg: ModelConfig
    mgrit: MGRITConfig
    kind: str               # block kind: attn_mlp, attn_moe, encdec_dec,
                            # mamba1 or mamba2
    causal: bool = True
    # where the trunk's chunks and batch rows live; None: one rank
    layout: Optional[mgrit.Layout] = None
    # one layer's leaves stored cut over the fsdp axis; None: none
    fsdp: Optional[Plan] = None

    def spec(self, iters: int) -> mgrit.MGRITSpec:
        return mgrit.MGRITSpec(cf=self.mgrit.cf, levels=self.mgrit.levels,
                               iters=iters, h=self.mgrit.h,
                               shard_levels=self.mgrit.shard_levels)


def whole_layer(static: LPStatic, params):
    """One layer's params with its fsdp-cut leaves gathered whole (no
    gradient flows through the gather)."""
    return params if static.fsdp is None else static.fsdp.gather_tree(
        params)


def _F(static: LPStatic, whole, z, extra: Extra):
    return block_F(whole, z, static.cfg, kind=static.kind,
                   causal=static.causal, rope=extra.get("rope"),
                   xa=extra.get("xa"))


def eval_F(static: LPStatic, params, z, extra: Extra):
    """The ODE right-hand side F(t_n, Z) of paper Eq. 1/2; ``params``
    one layer's as stored (its fsdp-cut leaves are gathered here)."""
    return _F(static, whole_layer(static, params), z, extra)


def make_fwd_step(static: LPStatic, extra: Extra) -> mgrit.StepFn:
    """Phi(z) = z + h * gate * F(z). ``slot`` = {"params", "gate"}."""
    def step(slot, z, h):
        f = eval_F(static, slot["params"], z, extra)
        return z + (h * slot["gate"].to(z.dtype)) * f
    return step


def make_adj_step(static: LPStatic, extra: Extra) -> mgrit.StepFn:
    """Adjoint propagator Psi(lam) = lam + h*gate*(dF/dZ)^T lam, evaluated
    at the stored forward state. ``slot`` = {"params", "gate", "z"}. Only
    z is differentiated (``xa`` is held fixed), as in the reference."""
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
    lay = static.layout
    if iters <= 0:
        states, zT = mgrit.serial_solve(step, stacked, z0, static.mgrit.h,
                                        lay=lay)
        norms = torch.zeros((1,), dtype=torch.float32, device=z0.device)
    else:
        states, zT, norms = mgrit.mgrit_solve(step, stacked, z0,
                                              static.spec(iters), lay=lay)
    return states, zT, norms


def _adjoint_solve(static: LPStatic, stacked: List, states, lamN, extra,
                   iters: int):
    """Solve the adjoint backward from lam_N. Returns (rev_lam, lam0, norms)
    with rev_lam[n] = lambda_{n+1} (the multiplier hitting layer n's
    output). The reversed stack is a reversed list: no weight is copied."""
    adj_stacked = [dict(slot, z=states[n])
                   for n, slot in reversed(list(enumerate(stacked)))]
    step = make_adj_step(static, extra)
    lay = None if static.layout is None else static.layout.flipped()
    if iters <= 0:
        mu_states, mu_T = mgrit.serial_solve(step, adj_stacked, lamN,
                                             static.mgrit.h, lay=lay)
        norms = torch.zeros((1,), dtype=torch.float32, device=lamN.device)
    else:
        mu_states, mu_T, norms = mgrit.mgrit_solve(step, adj_stacked, lamN,
                                                   static.spec(iters),
                                                   lay=lay)
    # mu_states[m] = lambda_{N-m}; layer n consumes lambda_{n+1} = mu[N-1-n]
    return torch.flip(mu_states, dims=(0,)), mu_T, norms


def _param_grads(static: LPStatic, stacked: List, states, rev_lam, extra):
    """Per-layer gradients g_theta_n = h*gate_n*(dF/dtheta_n)^T
    lambda_{n+1}, one layer at a time, written into stacked (N, ...)
    tensors in the order of ``leaves_with_paths(slot["params"])`` (an
    fsdp-cut leaf's as this rank's piece: reduce-scattered); and
    the cotangent of ``extra["xa"]`` (None where that is None): the sum
    over the layers, in layer order and in float32, of
    h*gate_n*(dF_n/dxa)^T lambda_{n+1} (on a chunk axis each rank sums
    its own layers and the sums are all-reduced)."""
    h = static.mgrit.h
    xa = extra.get("xa")
    if xa is not None:
        xa = xa.detach().requires_grad_(True)
        extra = dict(extra, xa=xa)
    out, d_xa = None, None
    for n, slot in enumerate(stacked):
        paths, leaves = zip(*leaves_with_paths(
            whole_layer(static, slot["params"])))
        leaves = [p.detach().requires_grad_(True) for p in leaves]
        with torch.enable_grad():
            f = _F(static, unflatten(zip(paths, leaves)), states[n], extra)
        ct = (h * slot["gate"].to(rev_lam.dtype)) * rev_lam[n]
        grads = torch.autograd.grad(
            f, leaves if xa is None else [*leaves, xa], ct)
        del f, leaves               # the whole layer, before the scatter
        if xa is not None:
            *grads, g_xa = grads
            d_xa = g_xa.float() if d_xa is None else d_xa + g_xa.float()
        if static.fsdp is not None:
            grads = static.fsdp.scatter_grads(paths, grads)
        if out is None:
            out = [g.new_empty((len(stacked), *g.shape)) for g in grads]
        for acc, g in zip(out, grads):
            acc[n] = g
    lay = static.layout
    if d_xa is not None and lay is not None and lay.chunks is not None:
        d_xa = lay.mesh.all_sum("xa_grad", d_xa, (lay.chunks,))
    return out, None if d_xa is None else d_xa.to(xa.dtype)


# ---------------------------------------------------------------------------
# autograd binding
# ---------------------------------------------------------------------------


class _LPForward(torch.autograd.Function):
    """(z0, gate, xa, *param leaves) -> (zT, fwd_norms); backward = MGRIT
    adjoint. Gate gradients are zero (structural constants); ``xa`` is
    the encoder's output for ``encdec_dec`` trunks, else None."""

    @staticmethod
    def forward(ctx, static, rope, paths, z0, gate, xa, *leaves):
        stacked = _layer_slots(unflatten(zip(paths, leaves)), gate)
        extra = {"rope": rope, "xa": xa}
        states, zT, norms = _forward_solve(static, stacked, z0, extra,
                                           static.mgrit.fwd_iters)
        ctx.save_for_backward(states, gate, xa, *leaves)
        ctx.static, ctx.rope, ctx.paths = static, rope, paths
        ctx.rules = current_rules()
        ctx.mark_non_differentiable(norms)
        return zT, norms

    @staticmethod
    def backward(ctx, ct_zT, _ct_norms):
        states, gate, xa, *leaves = ctx.saved_tensors
        static, extra = ctx.static, {"rope": ctx.rope, "xa": xa}
        stacked = _layer_slots(unflatten(zip(ctx.paths, leaves)), gate)
        # the layer replays run under the forward's rules (the MoE's
        # expert exchange reads them): on the card the autograd engine
        # runs this on its device thread, where none are active
        with (contextlib.nullcontext() if ctx.rules[0] is None
              else axis_rules(*ctx.rules)):
            # the adjoint runs in the trunk's compute dtype (lambda ~ z)
            rev_lam, lam0, _ = _adjoint_solve(static, stacked, states,
                                              ct_zT.to(states.dtype),
                                              extra, static.mgrit.bwd_iters)
            d_leaves, d_xa = _param_grads(static, stacked, states, rev_lam,
                                          extra)
        return (None, None, None, lam0, torch.zeros_like(gate), d_xa,
                *d_leaves)


def _layer_slots(params, gate):
    """Per-layer {"params", "gate"} slots of detached weight views."""
    return [{"params": p, "gate": gate[n]} for n, p in
            enumerate(mgrit.slots(tree_map(torch.Tensor.detach, params)))]


def lp_forward(static: LPStatic, stacked, z0, extra: Extra):
    """Returns (zT, fwd_residual_norms). ``stacked`` = {"params": tree of
    (N, ...) tensors, "gate": (N,)}; ``extra`` = {"rope"[, "xa"]}. The
    gradient is the MGRIT adjoint, for ``xa`` too."""
    paths, leaves = zip(*leaves_with_paths(stacked["params"]))
    return _LPForward.apply(static, extra.get("rope"), paths, z0,
                            stacked["gate"], extra.get("xa"), *leaves)


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
