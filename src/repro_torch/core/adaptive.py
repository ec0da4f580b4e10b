"""Adaptive control of MGRIT inexactness (paper §3.2.3, Fig. 5).

A copy of :mod:`repro.core.adaptive` (the port imports nothing of the
JAX package).

Every ``check_every`` batches the trainer runs a *probe*: it transiently
doubles the MGRIT iteration count and evaluates the convergence factor of the
final iteration, rho = ||r^(k+1)|| / ||r^(k)||. When rho exceeds the
threshold (1.0 in the paper) the gradients' bias has grown too large; the
controller either raises the iteration count or switches the trainer to the
serial (exact) step — reproducing the green curves of Fig. 4.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.configs.base import MGRITConfig


@dataclasses.dataclass
class ControllerState:
    mode: str = "lp"                  # "lp" | "serial"
    fwd_iters: int = 1
    bwd_iters: int = 1
    step_of_switch: Optional[int] = None
    history: List[Tuple[int, float, float]] = dataclasses.field(
        default_factory=list)        # (step, rho_fwd, rho_bwd)


def convergence_factor(norms: np.ndarray) -> float:
    """rho of the final iteration: ||r^(k+1)||/||r^(k)||."""
    norms = np.asarray(norms, dtype=np.float64)
    if norms.size < 2:
        return 0.0
    denom = norms[-2]
    if denom <= 1e-30:   # already at machine floor: converged
        return 0.0
    return float(norms[-1] / denom)


class AdaptiveController:
    """Host-side controller; the trainer consults it to pick the step
    (LP vs serial) and the iteration counts."""

    def __init__(self, mgrit: MGRITConfig, escalate: bool = False,
                 max_iters: int = 8):
        self.cfg = mgrit
        self.escalate = escalate      # raise iters instead of going serial
        self.max_iters = max_iters
        self.state = ControllerState(
            mode="lp" if mgrit.enabled else "serial",
            fwd_iters=mgrit.fwd_iters, bwd_iters=mgrit.bwd_iters)

    def should_probe(self, step: int) -> bool:
        return (self.state.mode == "lp" and step > 0
                and step % self.cfg.check_every == 0)

    def probe_iters(self) -> Tuple[int, int]:
        """Doubled iteration counts used for the probe (paper 3.2.3)."""
        return (max(2 * self.state.fwd_iters, 2),
                max(2 * self.state.bwd_iters, 2))

    def observe(self, step: int, fwd_norms, bwd_norms) -> str:
        rho_f = convergence_factor(fwd_norms)
        rho_b = convergence_factor(bwd_norms)
        self.state.history.append((step, rho_f, rho_b))
        rho = max(rho_f, rho_b)
        if rho < self.cfg.switch_threshold:
            return "ok"
        if self.escalate and max(self.state.fwd_iters,
                                 self.state.bwd_iters) < self.max_iters:
            self.state.fwd_iters = min(2 * max(self.state.fwd_iters, 1),
                                       self.max_iters)
            self.state.bwd_iters = min(2 * max(self.state.bwd_iters, 1),
                                       self.max_iters)
            return "escalated"
        self.state.mode = "serial"
        self.state.step_of_switch = step
        return "switched"
