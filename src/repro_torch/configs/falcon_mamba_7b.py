"""falcon-mamba-7b [ssm]: 64L d_model=4096 (attention-free) vocab=65024,
ssm_state=16 — mamba1 arch [arXiv:2410.05355; unverified].

Attention-free residual trunk: F = Mamba1 o RMSNorm is a textbook neural-ODE
right-hand side, so the paper's technique applies directly. O(1) decode
state => runs the long_500k shape.
"""
from repro_torch.configs.base import MGRITConfig, ModelConfig, RunConfig, SSMConfig
from repro_torch.configs import registry

MODEL = ModelConfig(
    name="falcon-mamba-7b", family="ssm", n_layers=64, d_model=4096,
    n_heads=1, n_kv_heads=1, d_ff=0, vocab_size=65024,
    ssm=SSMConfig(version=1, d_state=16, d_conv=4, expand=2),
    norm="rmsnorm")

# 64 = 1 + 1 buffers + 62 -> pad 64 (J=16 @ cf=4, paper's BERT cf)
MGRIT = MGRITConfig(cf=4, levels=2, fwd_iters=2, bwd_iters=1,
                    n_open=1, n_close=1, pad_to=64)

CONFIG = RunConfig(model=MODEL, mgrit=MGRIT,
                   sharding=registry.train_sharding())


def sharding_for(shape):
    if shape.kind == "train":
        return registry.train_sharding()
    return registry.decode_sharding(long_context=shape.name == "long_500k")
