"""Meta-tensor stand-ins for every model input (no allocation). Port of
:mod:`repro.launch.specs`, whose ``jax.ShapeDtypeStruct`` stand-ins
become tensors on the meta device with the same shapes and dtypes.

``input_specs(rcfg)`` returns the inputs for the shape kind:
  train   -> batch dict for train_step
  prefill -> batch dict for prefill_step
  decode  -> (cache, tokens[, xa]) for serve_step (one new token against
             a KV/SSM cache of seq_len; ``xa`` the encoder output of the
             encoder-decoder family)

Modality frontends are stubs, as in the reference: the vision family
gets precomputed patch embeddings (``mm_embeds``), the audio
encoder-decoder precomputed frame embeddings (``src_embeds``).
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import RunConfig
from repro_torch.configs.qwen2_vl_7b import MM_TOKENS
from repro_torch.models import transformer
from repro_torch.models.layers import torch_dtype

I32 = torch.int32
META = torch.device("meta")


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device=META)


def train_batch_specs(rcfg: RunConfig) -> Dict[str, Any]:
    cfg, shp = rcfg.model, rcfg.shape
    B, S = shp.global_batch, shp.seq_len
    dt = torch_dtype(cfg.dtype)
    batch = {}
    if cfg.family == "encdec":
        batch["src_embeds"] = _meta((B, S, cfg.d_model), dt)
        batch["tokens"] = _meta((B, S), I32)
        batch["labels"] = _meta((B, S), I32)
    elif cfg.frontend == "vision":
        batch["mm_embeds"] = _meta((B, MM_TOKENS, cfg.d_model), dt)
        batch["tokens"] = _meta((B, S - MM_TOKENS), I32)
        batch["labels"] = _meta((B, S - MM_TOKENS), I32)
    else:
        batch["tokens"] = _meta((B, S), I32)
        batch["labels"] = _meta((B, S), I32)
    return batch


def prefill_batch_specs(rcfg: RunConfig) -> Dict[str, Any]:
    b = train_batch_specs(rcfg)
    b.pop("labels", None)
    return b


def decode_specs(rcfg: RunConfig) -> Tuple[Any, ...]:
    cfg, shp = rcfg.model, rcfg.shape
    B, S = shp.global_batch, shp.seq_len
    cache = transformer.init_cache(rcfg, B, S, device=META)
    tokens = _meta((B, 1), I32)
    if cfg.family == "encdec":
        # cross-attention context from the encoder (bounded length)
        xa = _meta((B, min(S, 4096), cfg.d_model), torch_dtype(cfg.dtype))
        return (cache, tokens, xa)
    return (cache, tokens)


def params_specs(rcfg: RunConfig):
    """The model params on meta (no allocation)."""
    return transformer.param_shapes(rcfg)


def input_specs(rcfg: RunConfig):
    kind = rcfg.shape.kind
    if kind == "train":
        return train_batch_specs(rcfg)
    if kind == "prefill":
        return prefill_batch_specs(rcfg)
    return decode_specs(rcfg)
