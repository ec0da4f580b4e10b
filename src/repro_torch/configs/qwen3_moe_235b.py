"""qwen3-moe-235b-a22b [moe]: 94L d_model=4096 64H (GQA kv=4) d_ff=1536
vocab=151936, MoE 128 experts top-8 [hf:Qwen/Qwen3-30B-A3B; hf].

128 experts shard 8-per-device over the 16-way 'data' axis (EP) while the
layer grid shards over 'model' (LP) — the paper's orthogonal-parallelism
claim exercised with expert parallelism instead of plain DP.
"""
import dataclasses

from repro_torch.configs.base import (MGRITConfig, ModelConfig, MoEConfig,
                                RunConfig)
from repro_torch.configs import registry

MODEL = ModelConfig(
    name="qwen3-moe-235b-a22b", family="decoder", n_layers=94, d_model=4096,
    n_heads=64, n_kv_heads=4, d_ff=1536, vocab_size=151936,
    qk_norm=True, moe=MoEConfig(num_experts=128, top_k=8, d_ff=1536),
    act="silu", norm="rmsnorm", rope_theta=1000000.0)

# 94 = 1 + 1 buffers + 92 -> pad 96; cf=3 J=32 L=2
MGRIT = MGRITConfig(cf=3, levels=2, fwd_iters=2, bwd_iters=1,
                    n_open=1, n_close=1, pad_to=96)

CONFIG = RunConfig(
    model=MODEL, mgrit=MGRIT,
    sharding=dataclasses.replace(registry.train_sharding(),
                                 experts="data", fsdp="data"))


def sharding_for(shape):
    if shape.kind == "train":
        return CONFIG.sharding
    return dataclasses.replace(
        registry.decode_sharding(long_context=shape.name == "long_500k"),
        experts="data", fsdp="data")
