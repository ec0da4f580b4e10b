"""seamless-m4t-large-v2 [audio]: 24L d_model=1024 16H d_ff=8192
vocab=256206 — enc-dec, multimodal [arXiv:2308.11596; hf].

The paper's NOVEL encoder-decoder neural-ODE formulation (Eq. 3): the
stacked time grid is block-triangular (X frozen after T_enc, Y frozen
before), so it is implemented as two chained MGRIT solves — mathematically
identical, see DESIGN.md §6. The speech frontend is a STUB: input_specs()
provides precomputed frame embeddings.
"""
from repro_torch.configs.base import MGRITConfig, ModelConfig, RunConfig
from repro_torch.configs import registry

MODEL = ModelConfig(
    name="seamless-m4t-large-v2", family="encdec", n_layers=24,
    n_dec_layers=24, d_model=1024, n_heads=16, n_kv_heads=16, d_ff=8192,
    vocab_size=256206, frontend="audio", act="gelu", norm="layernorm")

# enc 24 -> pad 32, dec 24 -> pad 32 (J=16 @ cf=2), no buffers (enc-dec)
MGRIT = MGRITConfig(cf=2, levels=2, fwd_iters=2, bwd_iters=1,
                    n_open=0, n_close=0, pad_to=32)

CONFIG = RunConfig(model=MODEL, mgrit=MGRIT,
                   sharding=registry.train_sharding())


def sharding_for(shape):
    if shape.kind == "train":
        return registry.train_sharding()
    return registry.decode_sharding(long_context=shape.name == "long_500k")
