"""qwen3-1.7b [dense]: 28L d_model=2048 16H (GQA kv=8) d_ff=6144
vocab=151936 — qk_norm, GQA [hf:Qwen/Qwen3-8B; hf]."""
from repro_torch.configs.base import MGRITConfig, ModelConfig, RunConfig
from repro_torch.configs import registry

MODEL = ModelConfig(
    name="qwen3-1.7b", family="decoder", n_layers=28, d_model=2048,
    n_heads=16, n_kv_heads=8, d_ff=6144, vocab_size=151936,
    qk_norm=True, act="silu", norm="rmsnorm", rope_theta=1000000.0)

# 28 = 1 + 1 buffers + 26 -> pad 32 (J=16 @ cf=2)
MGRIT = MGRITConfig(cf=2, levels=2, fwd_iters=2, bwd_iters=1,
                    n_open=1, n_close=1, pad_to=32)

CONFIG = RunConfig(model=MODEL, mgrit=MGRIT,
                   sharding=registry.train_sharding())


def sharding_for(shape):
    if shape.kind == "train":
        return registry.train_sharding()
    return registry.decode_sharding(long_context=shape.name == "long_500k")
