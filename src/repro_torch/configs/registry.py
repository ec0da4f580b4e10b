"""Architecture registry: ``get_config(arch, shape)`` -> RunConfig.

Each assigned architecture lives in its own module (``configs/<id>.py``)
exporting ``CONFIG`` (a RunConfig factory). Paper architectures
(bert128/gpt2/vit/mc/mt) are included for the reproduction benchmarks.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Optional

from repro_torch.configs.base import (RunConfig, SHAPE_BY_NAME,
                                ShardingConfig)

ARCH_IDS = (
    "zamba2_1p2b",
    "deepseek_7b",
    "phi4_mini_3p8b",
    "qwen3_1p7b",
    "granite_34b",
    "qwen2_vl_7b",
    "grok1_314b",
    "qwen3_moe_235b",
    "seamless_m4t_v2",
    "falcon_mamba_7b",
    # the paper's own experiment architectures
    "bert128",
    "gpt2_nanogpt",
    "vit32",
    "mc_tiny",
    "mt_marian",
)

# canonical <id> spellings from the assignment table
ALIASES = {
    "zamba2-1.2b": "zamba2_1p2b",
    "deepseek-7b": "deepseek_7b",
    "phi4-mini-3.8b": "phi4_mini_3p8b",
    "qwen3-1.7b": "qwen3_1p7b",
    "granite-34b": "granite_34b",
    "qwen2-vl-7b": "qwen2_vl_7b",
    "grok-1-314b": "grok1_314b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b",
    "seamless-m4t-large-v2": "seamless_m4t_v2",
    "falcon-mamba-7b": "falcon_mamba_7b",
}


def get_config(arch: str, shape: str = "train_4k") -> RunConfig:
    arch = ALIASES.get(arch, arch).replace("-", "_")
    if arch not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{arch}")
    rcfg: RunConfig = mod.CONFIG
    shp = SHAPE_BY_NAME[shape]
    sharding = mod.sharding_for(shp) if hasattr(mod, "sharding_for") \
        else rcfg.sharding
    mb = TRAIN_MICROBATCHES.get(arch, 1) if shp.kind == "train" else 1
    return dataclasses.replace(rcfg, shape=shp, sharding=sharding,
                               microbatches=mb)


def shape_supported(arch: str, shape: str) -> Optional[str]:
    """None if supported, else a skip reason (recorded in EXPERIMENTS.md)."""
    arch = ALIASES.get(arch, arch).replace("-", "_")
    cfg = get_config(arch, "train_4k").model
    if shape == "long_500k":
        subq = cfg.family in ("ssm", "hybrid")
        if not subq:
            return ("full quadratic attention: 512k KV-cache decode is "
                    "excluded per assignment (sub-quadratic archs only)")
    if shape.startswith("decode") or shape == "long_500k":
        if cfg.family == "encoder":
            return "encoder-only: no autoregressive decode step"
    return None


def train_sharding() -> ShardingConfig:
    """Paper regime: layer-parallel over 'model', batch over data(+pod)."""
    return ShardingConfig(batch="data+pod", layers="model", vocab="model",
                          fsdp=None)


def tp_sharding() -> ShardingConfig:
    """Megatron TP over 'model' (serving, and zamba2 training)."""
    return ShardingConfig(batch="data+pod", heads="model", mlp="model",
                          vocab="model", layers=None)


def decode_sharding(long_context: bool = False) -> ShardingConfig:
    """Serving: Megatron TP + flash-decoding style KV-seq sharding over
    'model' (partial softmax + combine inserted by GSPMD), FSDP storage
    sharding of big weights over 'data'."""
    s = dataclasses.replace(tp_sharding(), kv_seq="model", fsdp="data")
    if long_context:
        # batch=1: the data axis moves onto the cache sequence dim too
        s = dataclasses.replace(s, kv_seq="data+model", batch=None)
    return s


def serve_sharding() -> ShardingConfig:
    """Mesh-sharded paged serving (the ServeEngine's default under a
    mesh): weights Megatron-TP over 'model' (heads / d_ff / SSM inner
    dims), decode-state page pools and the slot batch over 'data'. The
    scheduler/allocator stay host-side and mesh-blind — page ids and
    slot ids are global; only device arrays carry shardings (see
    docs/sharding.md)."""
    return ShardingConfig(batch="data", heads="model", mlp="model",
                          vocab="model", layers=None, pages="data")


# gradient-accumulation microbatches per arch for train_4k: bounds the live
# MGRIT state + activation memory per chip (EXPERIMENTS.md §Dry-run)
TRAIN_MICROBATCHES = {
    "deepseek_7b": 4, "phi4_mini_3p8b": 4, "qwen3_1p7b": 4,
    "qwen2_vl_7b": 4, "granite_34b": 16, "grok1_314b": 8,
    "qwen3_moe_235b": 16, "seamless_m4t_v2": 8, "falcon_mamba_7b": 8,
    "zamba2_1p2b": 4,
}
