"""Paper GPT2 config (Table 2 + App. B): 20 decoder layers, d=768, 12H,
nanoGPT-style. Buffer layers: 2 open + 2 close serial (Delta-t=1), middle 16
in the ParallelNet with Delta-t = 1/16 (App. B / Fig. 12). Serial forward,
1 parallel backward iteration, cf=4 (Table 3)."""
from repro_torch.configs.base import MGRITConfig, ModelConfig, RunConfig
from repro_torch.configs import registry

MODEL = ModelConfig(
    name="gpt2-nanogpt", family="decoder", n_layers=20, d_model=768,
    n_heads=12, n_kv_heads=12, d_ff=3072, vocab_size=50304,
    act="gelu", norm="layernorm", max_seq_len=1024)

MGRIT = MGRITConfig(cf=4, levels=2, fwd_iters=0, bwd_iters=1,
                    n_open=2, n_close=2, pad_to=16, h=1.0 / 16.0)

CONFIG = RunConfig(model=MODEL, mgrit=MGRIT,
                   sharding=registry.train_sharding())
