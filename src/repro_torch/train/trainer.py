"""Trainer: the paper's training procedure on one device.

Port of :mod:`repro.train.trainer`:

  * layer-parallel (MGRIT) steps by default, serial steps on demand;
  * adaptive inexactness control (paper §3.2.3): every ``check_every``
    steps run a doubled-iteration probe, compute the convergence factor,
    and switch LP -> serial when it crosses 1;
  * fault tolerance: periodic atomic checkpoints in the JAX package's
    format (:mod:`repro_torch.train.checkpoint`), resume from the latest
    in place, an emergency checkpoint when a step raises — unless the
    optimizer's in-place update had begun (the reference's functional
    update cannot leave a half-updated state; this one can) or the step
    is already checkpointed;
  * straggler watch: EWMA of step wall-time, slow steps logged.

The probe of an encoder-decoder model raises ``NotImplementedError``:
the reference has none to port (its probe reads ``params["mid"]``).
The LP and serial steps are two step functions; switching is a
host-side decision. The entry point runs on ``cuda`` unless the caller
passes ``device="cpu"`` (see :func:`repro_torch.device.resolve_device`).

Under a ``mesh`` (:class:`repro_torch.launch.mesh.Mesh`, one process a
rank, the mesh's device type that of the params) every rank builds the
full params from the seed and keeps its slices
(:func:`repro_torch.parallel.params.shard_tree`: the trunk's chunks
over the chunk axis, the MoE experts over theirs, the fsdp dimension of
a big leaf over the fsdp axis, the heads, MLP columns, Mamba rows and
vocab rows over the tensor-parallel axis; ``kept_whole`` lists the
leaves whose spec names an axis the port does not cut, the MoE router),
reads its rows of each batch, and
steps through :func:`repro_torch.launch.steps.make_train_fn` under the
mesh. The probe's residual norms are all-reduced, so every rank takes
the same branch. Rank 0 logs; checkpoints hold full arrays (see
:mod:`repro_torch.train.checkpoint`).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import os
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
from repro_torch.parallel import params as pparams
from repro_torch.parallel.sharding import axis_rules
from repro_torch.train import checkpoint as ckpt_mod


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
        self.rcfg = rcfg
        self.mesh = mesh
        self.device = resolve_device(device)
        if self.device.type == "meta":
            raise ValueError("the Trainer reads losses back: it runs on "
                             "cuda or cpu, not meta")
        if mesh is not None and mesh.device_type != self.device.type:
            raise ValueError(f"the mesh is on {mesh.device_type}, the "
                             f"params on {self.device.type}")
        self.ckpt_dir = ckpt_dir
        self.controller = AdaptiveController(rcfg.mgrit)
        self.pipeline = make_pipeline(rcfg, seed, data_path)
        self.params = transformer.init_model(rcfg, seed=seed,
                                             device=self.device)
        self.kept_whole = []
        if mesh is not None:
            specs = pparams.train_specs(self.params, rcfg, mesh)
            self.params, self.kept_whole = pparams.shard_tree(
                self.params, specs, mesh, cfg=rcfg.model,
                sharding=rcfg.sharding)
        self.opt_state = optimizers.init_opt_state(rcfg.optimizer,
                                                   self.params)
        self.step = 0
        self._steps: Dict[str, Callable] = {}
        self._ewma_dt = None

        if ckpt_dir:
            restored = ckpt_mod.restore(ckpt_dir, self.params,
                                        self.opt_state, mesh, rcfg)
            if restored is not None:
                self.params, self.opt_state, self.step, extra = restored
                if extra.get("controller_mode"):
                    self.controller.state.mode = extra["controller_mode"]

    def _step_fn(self, mode: str):
        if mode not in self._steps:
            rcfg = self.rcfg
            if mode == "serial":
                rcfg = rcfg.replace(
                    mgrit=dataclasses.replace(rcfg.mgrit, enabled=False))
            self._steps[mode] = steps_mod.make_train_fn(rcfg, self.mesh)
        return self._steps[mode]

    def _probe(self, batch):
        """Paper's indicator probe: doubled iterations, measure rho."""
        rcfg = self.rcfg
        cfg = rcfg.model
        if cfg.family == "encdec":
            raise NotImplementedError(
                "the adaptive probe of an encoder-decoder model is not "
                "ported: the reference's Trainer._probe has none (it reads "
                "params['mid'], which an encdec model lacks, and raises "
                "KeyError; ROADMAP Queue 3). Train it with probe=False or "
                "a check_every beyond the steps run")
        fwd_it, bwd_it = self.controller.probe_iters()
        kind = block_kind(cfg)
        causal = cfg.family != "encoder"
        # under the mesh's rules throughout: the MoE's expert exchange
        # reads them in the buffer layers and the trunk
        with self._rules():
            static = transformer.trunk_static(
                rcfg, cfg.n_layers, kind=kind, causal=causal,
                mg=dataclasses.replace(rcfg.mgrit, fwd_iters=fwd_it,
                                       bwd_iters=bwd_it))
            # the seed is 1 / (the global zT's size): rows split over ranks
            rows = 1 if static.layout is None else math.prod(
                self.mesh.shape[a] for a in static.layout.batch)
            with torch.no_grad():
                params = transformer.train_params(self.params, rcfg)
                z = transformer._embed_inputs(params, batch, cfg)
                rope = None if kind in ("mamba1", "mamba2") else \
                    transformer._rope_for(cfg, z.shape[1], z.device)
                z = transformer._serial_buffer(params.get("open"), z,
                                               cfg, kind=kind, causal=causal,
                                               rope=rope)
                del params
            return lp_mod.lp_diagnose(
                static, self.params["mid"], z, {"rope": rope},
                seed_ct=lambda zT: torch.ones_like(zT) / torch.tensor(
                    float(zT.numel() * rows), dtype=zT.dtype),
                fwd_iters=fwd_it, bwd_iters=bwd_it)

    def _rules(self):
        if self.mesh is None:
            return contextlib.nullcontext()
        return axis_rules(self.mesh, self.rcfg.sharding)

    def _log(self, msg: str):
        if self.mesh is None or torch.distributed.get_rank() == 0:
            print(msg)

    def train(self, num_steps: int, ckpt_every: int = 0,
              log_every: int = 50, probe: bool = True) -> TrainReport:
        losses, modes, times, norms = [], [], [], []
        t_start = time.perf_counter()
        try:
            for _ in range(num_steps):
                batch = shard_batch(self.pipeline.batch_at(self.step),
                                    self.device, self.mesh, self.rcfg)
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
                losses.append(float(metrics["loss"]))  # waits for the step
                norms.append(np.asarray(metrics["fwd_norms"].cpu()).tolist())
                dt = time.perf_counter() - t0
                times.append(dt)
                self._ewma_dt = dt if self._ewma_dt is None else \
                    0.9 * self._ewma_dt + 0.1 * dt
                if dt > 3.0 * self._ewma_dt:
                    self._log(f"[straggler] step {self.step} took "
                              f"{dt:.2f}s (ewma {self._ewma_dt:.2f}s)")
                modes.append(mode)
                self.step += 1
                if ckpt_every and self.step % ckpt_every == 0:
                    self._save()
                if log_every and self.step % log_every == 0:
                    self._log(f"step {self.step} [{mode}] "
                              f"loss={losses[-1]:.4f}")
        except Exception:
            if self.ckpt_dir:
                self._emergency_save()
            raise
        dt_total = time.perf_counter() - t_start
        return TrainReport(
            losses=losses, mode_trace=modes,
            controller_history=list(self.controller.state.history),
            switched_at=self.controller.state.step_of_switch,
            steps_per_sec=len(losses) / max(dt_total, 1e-9),
            step_seconds=times, fwd_norms=norms)

    def _emergency_save(self):
        """Checkpoint the state a failed step left, if it is still the
        state of ``self.step``: ``opt_state["step"]`` differs once the
        optimizer's update has begun (None while it writes, some leaves
        updated and others not). An existing ``step_<N>`` holds that
        same state and is never replaced."""
        if self.opt_state["step"] != self.step:
            self._log(f"[emergency] no checkpoint: the optimizer update "
                      f"of step {self.step} had begun, the state is no "
                      f"longer step {self.step}'s")
        elif os.path.exists(os.path.join(self.ckpt_dir,
                                         f"step_{self.step:010d}")):
            self._log(f"[emergency] step {self.step} is already "
                      "checkpointed")
        else:
            self._save(tag="emergency")

    def _save(self, tag: str = ""):
        ckpt_mod.save(self.ckpt_dir, self.step, self.params, self.opt_state,
                      extra={"controller_mode": self.controller.state.mode,
                             "tag": tag}, mesh=self.mesh, rcfg=self.rcfg)
