"""deepseek-7b [dense]: 30L d_model=4096 32H (GQA kv=32) d_ff=11008
vocab=102400 — llama-arch [arXiv:2401.02954; hf]."""

from repro_torch.configs.base import MGRITConfig, ModelConfig, RunConfig
from repro_torch.configs import registry

MODEL = ModelConfig(
    name="deepseek-7b", family="decoder", n_layers=30, d_model=4096,
    n_heads=32, n_kv_heads=32, d_ff=11008, vocab_size=102400,
    act="silu", norm="rmsnorm")

# 30 = 1 open + 1 close buffer + 28 ParallelNet padded to 32 (J=16 @ cf=2)
MGRIT = MGRITConfig(cf=2, levels=2, fwd_iters=2, bwd_iters=1,
                    n_open=1, n_close=1, pad_to=32)

CONFIG = RunConfig(model=MODEL, mgrit=MGRIT,
                   sharding=registry.train_sharding())


def sharding_for(shape):
    if shape.kind == "train":
        return registry.train_sharding()
    return registry.decode_sharding(long_context=shape.name == "long_500k")
