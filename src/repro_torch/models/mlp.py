"""Feed-forward sublayers: SwiGLU / GELU MLP (port of
:mod:`repro.models.mlp`)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import (dense_init, preln_output_scale,
                                       torch_dtype)


def init_mlp(gen: torch.Generator, cfg: ModelConfig, d_ff: int = 0, *,
             lead=(), device=None):
    d, ff = cfg.d_model, d_ff or cfg.d_ff
    pdt = torch_dtype(cfg.param_dtype)
    oscale = 0.02 * preln_output_scale(cfg.n_layers)
    p = {
        "w_in": dense_init(gen, (*lead, d, ff), pdt, device=device),
        "w_out": dense_init(gen, (*lead, ff, d), pdt, scale=oscale,
                            device=device),
    }
    if cfg.act == "silu":
        p["w_gate"] = dense_init(gen, (*lead, d, ff), pdt, device=device)
    return p


def mlp_apply(params, x, cfg: ModelConfig):
    dt = torch_dtype(cfg.dtype)
    x = x.to(dt)
    h = x @ params["w_in"].to(dt)
    if cfg.act == "silu":
        g = x @ params["w_gate"].to(dt)
        h = F.silu(g) * h
    else:
        # jax.nn.gelu defaults to the tanh approximation; torch's to erf
        h = F.gelu(h, approximate="tanh")
    return h @ params["w_out"].to(dt)
