"""Roofline terms of one step on one NVIDIA H100 (port of
:mod:`repro.analysis.roofline`, retargeted from TPU v5e).

  compute term    = counted flops / peak bf16 tensor-core FLOP/s
                    (+ float32 CUDA-core flops / the float32 peak)
  memory term     = counted bytes / HBM bytes/s
  collective term = collective bytes / NVLink bytes/s (0 on one card)

The counts come from the dry-run (:mod:`repro_torch.launch.dryrun`),
which runs a step on the meta device: ``FlopCounterMode``'s matmul
flops, the bytes every aten op reads and writes, and the hand-written
kernels' own flops and bytes (``kernels/*.cost``). An eager PyTorch step
fuses nothing, so the unfused count is the traffic: where the reference
models XLA's fused bytes, here every elementwise op's inputs and outputs
are counted. Matmul flops are priced at the bf16 peak whatever their
dtype. The peaks are NVIDIA's data sheet for the H100 SXM (dense, no
sparsity) at its 700 W limit; a card set lower runs slower.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, Optional, Tuple

PEAK_FLOPS = 989e12          # bf16 dense tensor-core FLOP/s (H100 SXM)
PEAK_F32_FLOPS = 67e12       # float32 outside the tensor cores
HBM_BW = 3.35e12             # bytes/s (HBM3)
HBM_BYTES = 80e9             # device memory (80 GB)
NVLINK_BW = 450e9            # bytes/s a direction (NVLink 4, 900 GB/s
                             # both); the multi-device slice's term


def bound_ms(flops: float, nbytes: float,
             peak_flops: float = PEAK_FLOPS) -> Tuple[float, str]:
    """The least time (ms) for ``flops`` at ``peak_flops`` and ``nbytes``
    at the HBM rate, and which of the two bounds it."""
    t_bytes, t_ops = nbytes / HBM_BW, flops / peak_flops
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops \
        else "operations"


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float          # per chip: the dry-run's counted flops
    hlo_bytes: float          # per chip: the dry-run's counted bytes
    coll_bytes: float         # per chip
    model_flops: float        # 6*N*D (active) whole step, all chips
    t_compute: float = 0.0
    t_memory: float = 0.0
    t_collective: float = 0.0
    bottleneck: str = ""
    useful_ratio: float = 0.0
    peak_fraction: float = 0.0
    coll_detail: Optional[Dict[str, float]] = None
    memory_per_chip: float = 0.0
    f32_flops: float = 0.0    # per chip, on the CUDA cores (in hlo_flops)

    def finalize(self):
        self.t_compute = (self.hlo_flops - self.f32_flops) / PEAK_FLOPS \
            + self.f32_flops / PEAK_F32_FLOPS
        self.t_memory = self.hlo_bytes / HBM_BW
        self.t_collective = self.coll_bytes / NVLINK_BW
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        self.bottleneck = max(terms, key=terms.get)
        self.useful_ratio = (self.model_flops / self.chips) / max(
            self.hlo_flops, 1.0)
        t_step = max(self.t_compute, self.t_memory, self.t_collective)
        self.peak_fraction = (self.model_flops / self.chips / max(t_step, 1e-30)
                              ) / PEAK_FLOPS
        return self

    def row(self):
        return (f"| {self.arch} | {self.shape} | {self.mesh} | "
                f"{self.t_compute*1e3:.2f} | {self.t_memory*1e3:.2f} | "
                f"{self.t_collective*1e3:.2f} | {self.bottleneck} | "
                f"{self.useful_ratio:.2f} | {self.peak_fraction*100:.1f}% |")

    def to_json(self):
        d = dataclasses.asdict(self)
        return json.dumps(d, indent=1, default=float)


def model_flops_train(rcfg, tokens_per_step: int) -> float:
    """6*N(active)*D for a train step (fwd+bwd); 2*N*D for inference."""
    n = rcfg.model.active_param_count()
    mult = 6.0 if rcfg.shape.kind == "train" else 2.0
    return mult * n * tokens_per_step


def from_counts(arch, shape, mesh_name, chips, rcfg, tokens_per_step, *,
                flops, nbytes, f32_flops=0.0, memory=0.0, detail=None):
    """Roofline terms from the dry-run's counts: ``flops`` all counted
    flops (``f32_flops`` of them on the CUDA cores), ``nbytes`` every
    aten op's and kernel's bytes, ``memory`` the bytes the step's
    arguments hold."""
    return Roofline(
        arch=arch, shape=shape, mesh=mesh_name, chips=chips,
        hlo_flops=float(flops), hlo_bytes=float(nbytes), coll_bytes=0.0,
        model_flops=model_flops_train(rcfg, tokens_per_step),
        coll_detail=detail, memory_per_chip=float(memory),
        f32_flops=float(f32_flops)).finalize()


HEADER = ("| arch | shape | mesh | t_comp (ms) | t_mem (ms) | t_coll (ms) "
          "| bottleneck | useful | roofline frac |\n"
          "|---|---|---|---|---|---|---|---|---|")
