"""grok-1-314b [moe]: 64L d_model=6144 48H (GQA kv=8) d_ff=32768 vocab=131072,
MoE 8 experts top-2 [hf:xai-org/grok-1; unverified].

314B params: weights are layer-sharded over 'model' (LP chunks) AND
storage-sharded over 'data' (FSDP) — XLA all-gathers just-in-time.
"""
import dataclasses

from repro_torch.configs.base import (MGRITConfig, ModelConfig, MoEConfig,
                                OptimizerConfig, RunConfig)
from repro_torch.configs import registry

MODEL = ModelConfig(
    name="grok-1-314b", family="decoder", n_layers=64, d_model=6144,
    n_heads=48, n_kv_heads=8, d_ff=32768, vocab_size=131072,
    moe=MoEConfig(num_experts=8, top_k=2, d_ff=32768),
    act="gelu", norm="rmsnorm")

# 64 = 1 + 1 buffers + 62 -> pad 64 (J=16 @ cf=4)
MGRIT = MGRITConfig(cf=4, levels=2, fwd_iters=2, bwd_iters=1,
                    n_open=1, n_close=1, pad_to=64)

# bf16 moments: 314B params x 12B/param of fp32 Adam state would not fit a
# single pod's 4 TB HBM (see EXPERIMENTS.md §Dry-run)
CONFIG = RunConfig(
    model=MODEL, mgrit=MGRIT,
    optimizer=OptimizerConfig(moment_dtype="bfloat16"),
    sharding=dataclasses.replace(registry.train_sharding(),
                                 fsdp="data", experts=None))


def sharding_for(shape):
    if shape.kind == "train":
        return CONFIG.sharding
    return dataclasses.replace(
        registry.decode_sharding(long_context=shape.name == "long_500k"),
        fsdp="data")
