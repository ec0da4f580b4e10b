"""granite-34b [dense]: 88L d_model=6144 48H (MQA kv=1) d_ff=24576
vocab=49152 — llama-arch, code [arXiv:2405.04324; hf].

Deepest assigned arch — the paper's sweet spot (Fig. 8 right: LP benefit
grows with depth). MQA (kv=1) makes head-TP unattractive; LP sidesteps it.
"""
from repro_torch.configs.base import MGRITConfig, ModelConfig, RunConfig
from repro_torch.configs import registry

MODEL = ModelConfig(
    name="granite-34b", family="decoder", n_layers=88, d_model=6144,
    n_heads=48, n_kv_heads=1, d_ff=24576, vocab_size=49152,
    act="gelu", norm="layernorm")

# 88 = 1 + 1 buffers + 86 -> pad 96; cf=2 J=48, L=3 (48 -> 24 serial)
MGRIT = MGRITConfig(cf=2, levels=3, fwd_iters=2, bwd_iters=1,
                    n_open=1, n_close=1, pad_to=96)

CONFIG = RunConfig(model=MODEL, mgrit=MGRIT,
                   sharding=registry.train_sharding())


def sharding_for(shape):
    if shape.kind == "train":
        import dataclasses
        # 68B bf16 params need storage sharding over data as well
        return dataclasses.replace(registry.train_sharding(), fsdp="data")
    return registry.decode_sharding(long_context=shape.name == "long_500k")
