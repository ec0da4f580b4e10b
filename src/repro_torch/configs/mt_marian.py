"""Paper machine-translation config (Table 2): Marian-style enc-dec,
6+6 layers, d=512, 8H, d_ff=2048, vocab 32000 (OPUS de-en). MGRIT Table 3:
cf=3, L=2, 3 bwd iterations; Fig. 7 scales depth to 160+160."""
from repro_torch.configs.base import MGRITConfig, ModelConfig, RunConfig
from repro_torch.configs import registry

MODEL = ModelConfig(
    name="mt-marian", family="encdec", n_layers=6, n_dec_layers=6,
    d_model=512, n_heads=8, n_kv_heads=8, d_ff=2048, vocab_size=32000,
    act="gelu", norm="layernorm", max_seq_len=274, dropout=0.1)

MGRIT = MGRITConfig(cf=3, levels=2, fwd_iters=2, bwd_iters=3, pad_to=6)

CONFIG = RunConfig(model=MODEL, mgrit=MGRIT,
                   sharding=registry.train_sharding())
