"""Reduced configs for CPU smoke tests: same family/structure, tiny dims.

The FULL configs are exercised only via the dry-run (ShapeDtypeStruct);
smoke tests instantiate these reductions and run a real forward/train step.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import (MGRITConfig, ModelConfig, MoEConfig,
                                RunConfig, SSMConfig, ShapeConfig)


def reduce_model(m: ModelConfig) -> ModelConfig:
    kw = dict(
        d_model=64,
        n_heads=4,
        n_kv_heads=min(m.n_kv_heads, 2) if m.n_kv_heads < m.n_heads else 4,
        d_ff=128,
        vocab_size=256,
        max_seq_len=128,
        head_dim=16,
    )
    if m.family == "encdec":
        kw["n_layers"] = 6
        kw["n_dec_layers"] = 6
    elif m.family == "hybrid":
        kw["n_layers"] = 8
        kw["hybrid_attn_every"] = 3
    else:
        kw["n_layers"] = 10
    if m.moe is not None:
        kw["moe"] = MoEConfig(num_experts=4, top_k=2, d_ff=128)
    if m.ssm is not None:
        kw["ssm"] = SSMConfig(version=m.ssm.version, d_state=8, d_conv=4,
                              expand=2, headdim=16)
    return dataclasses.replace(m, **kw)


def reduce_mgrit(mg: MGRITConfig, model: ModelConfig) -> MGRITConfig:
    if not mg.enabled:
        return mg
    n_open = min(mg.n_open, 1)
    n_close = min(mg.n_close, 1)
    if model.family == "encdec":
        n_open = n_close = 0
        pad_to = 8
    else:
        pad_to = 8
    return dataclasses.replace(mg, cf=2, levels=2, n_open=n_open,
                               n_close=n_close, pad_to=pad_to)


def reduce_config(rcfg: RunConfig, seq: int = 16, batch: int = 2) -> RunConfig:
    model = reduce_model(rcfg.model)
    return dataclasses.replace(
        rcfg,
        model=model,
        mgrit=reduce_mgrit(rcfg.mgrit, model),
        shape=ShapeConfig("smoke", "train", seq, batch),
        use_pallas=False,
        microbatches=1,
    )
