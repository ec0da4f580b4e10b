"""Trainer: the paper's training procedure on one device.

Port of :mod:`repro.train.trainer`:

  * layer-parallel (MGRIT) steps by default, serial steps on demand;
  * adaptive inexactness control (paper §3.2.3): every ``check_every``
    steps run a doubled-iteration probe, compute the convergence factor,
    and switch LP -> serial when it crosses 1;
  * straggler watch: EWMA of step wall-time, slow steps logged.

Checkpoints (``ckpt_dir``) and meshes come in later slices and raise
here. The LP and serial steps are two step functions; switching is a
host-side decision. The entry point runs on ``cuda`` unless the caller
passes ``device="cpu"`` (see :func:`repro_torch.device.resolve_device`).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import RunConfig
from repro_torch.core import lp as lp_mod
from repro_torch.core.adaptive import AdaptiveController
from repro_torch.data.pipeline import make_pipeline, shard_batch
from repro_torch.device import resolve_device
from repro_torch.launch import steps as steps_mod
from repro_torch.models import transformer
from repro_torch.models.blocks import block_kind
from repro_torch.optim import optimizers


@dataclasses.dataclass
class TrainReport:
    losses: List[float]
    mode_trace: List[str]
    controller_history: List
    switched_at: Optional[int]
    steps_per_sec: float
    # per step: wall seconds (ending in a device sync) and forward MGRIT
    # residual norms
    step_seconds: List[float] = dataclasses.field(default_factory=list)
    fwd_norms: List[List[float]] = dataclasses.field(default_factory=list)


class Trainer:
    def __init__(self, rcfg: RunConfig, mesh=None, ckpt_dir: str = "",
                 seed: int = 0, data_path: str = "", device=None):
        if mesh is not None:
            raise NotImplementedError(
                "meshes come with the port's multi-device slice (ROADMAP "
                "Queue 1)")
        if ckpt_dir:
            raise NotImplementedError(
                "checkpoints come with the port's training-runtime slice "
                "(ROADMAP Queue 1, train/checkpoint.py)")
        self.rcfg = rcfg
        self.device = resolve_device(device)
        self.controller = AdaptiveController(rcfg.mgrit)
        self.pipeline = make_pipeline(rcfg, seed, data_path)
        self.params = transformer.init_model(rcfg, seed=seed,
                                             device=self.device)
        self.opt_state = optimizers.init_opt_state(rcfg.optimizer,
                                                   self.params)
        self.step = 0
        self._steps: Dict[str, Callable] = {}
        self._ewma_dt = None

    def _step_fn(self, mode: str):
        if mode not in self._steps:
            rcfg = self.rcfg
            if mode == "serial":
                rcfg = rcfg.replace(
                    mgrit=dataclasses.replace(rcfg.mgrit, enabled=False))
            self._steps[mode] = steps_mod.make_train_fn(rcfg)
        return self._steps[mode]

    def _probe(self, batch):
        """Paper's indicator probe: doubled iterations, measure rho."""
        fwd_it, bwd_it = self.controller.probe_iters()
        rcfg = self.rcfg
        cfg = rcfg.model
        kind = block_kind(cfg)
        static = lp_mod.LPStatic(
            cfg=cfg,
            mgrit=dataclasses.replace(rcfg.mgrit, fwd_iters=fwd_it,
                                      bwd_iters=bwd_it),
            kind=kind, causal=True)
        with torch.no_grad():
            z = transformer._embed_inputs(self.params, batch, cfg)
            rope = transformer._rope_for(cfg, z.shape[1], z.device)
            z = transformer._serial_buffer(self.params.get("open"), z, cfg,
                                           kind=kind, causal=True,
                                           rope=rope)
        return lp_mod.lp_diagnose(
            static, self.params["mid"], z, {"rope": rope},
            seed_ct=lambda zT: torch.ones_like(zT) / torch.tensor(
                float(zT.numel()), dtype=zT.dtype),
            fwd_iters=fwd_it, bwd_iters=bwd_it)

    def train(self, num_steps: int, ckpt_every: int = 0,
              log_every: int = 50, probe: bool = True) -> TrainReport:
        if ckpt_every:
            raise NotImplementedError(
                "checkpoints come with the port's training-runtime slice "
                "(ROADMAP Queue 1)")
        losses, modes, times, norms = [], [], [], []
        t_start = time.perf_counter()
        for _ in range(num_steps):
            batch = shard_batch(self.pipeline.batch_at(self.step),
                                self.device)
            mode = self.controller.state.mode
            t0 = time.perf_counter()

            if probe and self.controller.should_probe(self.step):
                fwd_norms, bwd_norms = self._probe(batch)
                action = self.controller.observe(
                    self.step, fwd_norms.cpu().numpy(),
                    bwd_norms.cpu().numpy())
                if action == "switched":
                    mode = "serial"

            fn = self._step_fn(mode)
            self.params, self.opt_state, metrics = fn(
                self.params, self.opt_state, batch)
            losses.append(float(metrics["loss"]))     # waits for the step
            norms.append(np.asarray(metrics["fwd_norms"].cpu()).tolist())
            dt = time.perf_counter() - t0
            times.append(dt)
            self._ewma_dt = dt if self._ewma_dt is None else \
                0.9 * self._ewma_dt + 0.1 * dt
            if dt > 3.0 * self._ewma_dt:
                print(f"[straggler] step {self.step} took {dt:.2f}s "
                      f"(ewma {self._ewma_dt:.2f}s)")
            modes.append(mode)
            self.step += 1
            if log_every and self.step % log_every == 0:
                print(f"step {self.step} [{mode}] loss={losses[-1]:.4f}")
        dt_total = time.perf_counter() - t_start
        return TrainReport(
            losses=losses, mode_trace=modes,
            controller_history=list(self.controller.state.history),
            switched_at=self.controller.state.step_of_switch,
            steps_per_sec=len(losses) / max(dt_total, 1e-9),
            step_seconds=times, fwd_norms=norms)
