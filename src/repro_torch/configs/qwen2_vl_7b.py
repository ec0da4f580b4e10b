"""qwen2-vl-7b [vlm]: 28L d_model=3584 28H (GQA kv=4) d_ff=18944
vocab=152064 — M-RoPE, dynamic resolution [arXiv:2409.12191; hf].

The vision frontend is a STUB per the assignment: input_specs() provides
precomputed patch embeddings (B, S_mm, D) prepended to token embeddings.
"""
from repro_torch.configs.base import MGRITConfig, ModelConfig, RunConfig
from repro_torch.configs import registry

MM_TOKENS = 256  # stubbed patch-embedding positions per sample

MODEL = ModelConfig(
    name="qwen2-vl-7b", family="decoder", n_layers=28, d_model=3584,
    n_heads=28, n_kv_heads=4, d_ff=18944, vocab_size=152064,
    mrope=True, frontend="vision", act="silu", norm="rmsnorm")

# 28 = 1 + 1 buffers + 26 -> pad 32 (J=16 @ cf=2)
MGRIT = MGRITConfig(cf=2, levels=2, fwd_iters=2, bwd_iters=1,
                    n_open=1, n_close=1, pad_to=32)

CONFIG = RunConfig(model=MODEL, mgrit=MGRIT,
                   sharding=registry.train_sharding())


def sharding_for(shape):
    if shape.kind == "train":
        return registry.train_sharding()
    return registry.decode_sharding(long_context=shape.name == "long_500k")
