"""zamba2-1.2b [hybrid]: 38L d_model=2048 32H (kv=32) d_ff=8192 vocab=32000,
ssm_state=64 — Mamba2 backbone + shared attention blocks [arXiv:2411.15242].

LP applicability (DESIGN.md §6): the *shared-weight* attention block
interleaved every 6 Mamba2 blocks makes the time grid heterogeneous and the
shared block is not an Euler step of a single F — MGRIT layer-parallelism is
inapplicable to the interleave. The trunk runs serially with Megatron TP;
the Mamba2 segments remain ODE-form so buffer-layer style serial execution
is exact.
"""
from repro_torch.configs.base import (MGRITConfig, ModelConfig, RunConfig,
                                SSMConfig)
from repro_torch.configs import registry

MODEL = ModelConfig(
    name="zamba2-1.2b", family="hybrid", n_layers=38, d_model=2048,
    n_heads=32, n_kv_heads=32, d_ff=8192, vocab_size=32000,
    ssm=SSMConfig(version=2, d_state=64, d_conv=4, expand=2, headdim=64),
    hybrid_attn_every=6, norm="rmsnorm")

MGRIT = MGRITConfig(enabled=False)

CONFIG = RunConfig(model=MODEL, mgrit=MGRIT,
                   sharding=registry.tp_sharding())


def sharding_for(shape):
    if shape.kind == "train":
        return registry.tp_sharding()
    return registry.decode_sharding(long_context=shape.name == "long_500k")
