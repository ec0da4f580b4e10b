"""phi4-mini-3.8b [dense]: 32L d_model=3072 24H (GQA kv=8) d_ff=8192
vocab=200064 — RoPE SwiGLU GQA [arXiv:2412.08905; hf]."""
from repro_torch.configs.base import MGRITConfig, ModelConfig, RunConfig
from repro_torch.configs import registry

MODEL = ModelConfig(
    name="phi4-mini-3.8b", family="decoder", n_layers=32, d_model=3072,
    n_heads=24, n_kv_heads=8, d_ff=8192, vocab_size=200064,
    act="silu", norm="rmsnorm")

# 32 = 1 + 1 buffers + 30 -> pad 32 (J=16 @ cf=2)
MGRIT = MGRITConfig(cf=2, levels=2, fwd_iters=2, bwd_iters=1,
                    n_open=1, n_close=1, pad_to=32)

CONFIG = RunConfig(model=MODEL, mgrit=MGRIT,
                   sharding=registry.train_sharding())


def sharding_for(shape):
    if shape.kind == "train":
        return registry.train_sharding()
    return registry.decode_sharding(long_context=shape.name == "long_500k")
