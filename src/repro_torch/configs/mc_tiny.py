"""Paper morphological-classification config (Table 2): encoder-only
neural ODE transformer, d=128, 1 head, d_ff=128, up to 64+ layers in the
scaling studies. MGRIT: cf=2 (Table 3: cf=8 for strong scaling; Fig. 3 uses
cf=2), 2 fwd / 1 bwd iterations."""
from repro_torch.configs.base import MGRITConfig, ModelConfig, RunConfig
from repro_torch.configs import registry

MODEL = ModelConfig(
    name="mc-tiny", family="encoder", n_layers=64, d_model=128,
    n_heads=1, n_kv_heads=1, d_ff=128, vocab_size=8000,
    act="gelu", norm="layernorm", max_seq_len=2048)

MGRIT = MGRITConfig(cf=2, levels=2, fwd_iters=2, bwd_iters=1, pad_to=64)

CONFIG = RunConfig(model=MODEL, mgrit=MGRIT,
                   sharding=registry.train_sharding())
