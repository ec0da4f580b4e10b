"""Paper ViT config: 32 encoder layers, d=768, 12H, patch16 (frontend
stubbed as patch embeddings). Serial forward, 1 parallel backward, cf=4."""
from repro_torch.configs.base import MGRITConfig, ModelConfig, RunConfig
from repro_torch.configs import registry

MODEL = ModelConfig(
    name="vit32", family="encoder", n_layers=32, d_model=768,
    n_heads=12, n_kv_heads=12, d_ff=3072, vocab_size=1000,
    frontend="vision", act="gelu", norm="layernorm", max_seq_len=197)

MGRIT = MGRITConfig(cf=4, levels=2, fwd_iters=0, bwd_iters=1, pad_to=32)

CONFIG = RunConfig(model=MODEL, mgrit=MGRIT,
                   sharding=registry.train_sharding())
