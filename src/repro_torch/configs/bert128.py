"""Paper BERT pre-training config (Table 2): 128 encoder layers, d=768,
12H, d_ff=3072, MLM on C4 (synthetic substitute here). MGRIT per Table 3:
cf=4, L=2, 1 fwd / 1 bwd iteration."""
from repro_torch.configs.base import MGRITConfig, ModelConfig, RunConfig
from repro_torch.configs import registry

MODEL = ModelConfig(
    name="bert128", family="encoder", n_layers=128, d_model=768,
    n_heads=12, n_kv_heads=12, d_ff=3072, vocab_size=30522,
    act="gelu", norm="layernorm", max_seq_len=224, dropout=0.1)

MGRIT = MGRITConfig(cf=4, levels=2, fwd_iters=1, bwd_iters=1, pad_to=128)

CONFIG = RunConfig(model=MODEL, mgrit=MGRIT,
                   sharding=registry.train_sharding())
