"""Feed-forward sublayers: SwiGLU / GELU MLP (port of
:mod:`repro.models.mlp`)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import (dense_init, preln_output_scale,
                                       torch_dtype)
from repro_torch.parallel import tp


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
    """Under an mlp split (:func:`repro_torch.parallel.tp.split`;
    ``params`` this rank's part) ``w_in`` / ``w_gate`` are
    column-parallel (:meth:`repro_torch.parallel.tp.Split.column`) and
    ``w_out`` row-parallel, the partial outputs summed over the ranks in
    float32."""
    dt = torch_dtype(cfg.dtype)
    x = x.to(dt)
    sp = tp.split("mlp", cfg.d_ff)
    names = ("w_in", "w_gate") if cfg.act == "silu" else ("w_in",)
    ws = [params[n].to(dt) for n in names]
    hs = [x @ w for w in ws] if sp is None else \
        sp.column("tp_mlp_in", x, *ws)
    h = hs[0]
    if cfg.act == "silu":
        h = F.silu(hs[1]) * h
    else:
        # jax.nn.gelu defaults to the tanh approximation; torch's to erf
        h = F.gelu(h, approximate="tanh")
    return tp.row_parallel(sp, "tp_mlp", h, params["w_out"].to(dt))
