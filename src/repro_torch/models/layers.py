"""Common neural layers: norms, rotary embeddings, token embeddings.

Port of :mod:`repro.models.layers`. Plain functions on tensors; a params
"pytree" is a dict of tensors under the JAX package's key names, so
weight conversion (:mod:`repro_torch.convert`) is a 1:1 mapping.
``init_*`` take an explicit ``torch.Generator`` and device.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops


def torch_dtype(name: str) -> torch.dtype:
    """Config dtype string ("float32", "bfloat16", ...) -> torch dtype."""
    return getattr(torch, name)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def init_norm(cfg: ModelConfig, dim: Optional[int] = None, *, lead=(),
              device=None):
    d = dim or cfg.d_model
    pdt = torch_dtype(cfg.param_dtype)
    p = {"scale": torch.ones((*lead, d), dtype=pdt, device=device)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros((*lead, d), dtype=pdt, device=device)
    return p


def norm_apply(params, x, cfg: ModelConfig):
    """LayerNorm or RMSNorm (eps 1e-6) in float32, cast back to x's dtype.
    RMSNorm is exactly the RMSNorm kernel's function, so it goes through
    :func:`repro_torch.kernels.ops.rmsnorm` (the kernel on the card);
    LayerNorm has no TPU kernel and stays plain PyTorch."""
    if cfg.norm != "layernorm":
        return kops.rmsnorm(x, params["scale"])
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    # jnp.var is the population variance
    var = x32.var(-1, keepdim=True, unbiased=False)
    y = (x32 - mu) * torch.rsqrt(var + 1e-6)
    y = y * params["scale"].float() + params["bias"].float()
    return y.to(x.dtype)


def rms_norm(x, scale):
    """Bare RMSNorm used for qk-norm (per-head), through the kernel."""
    return kops.rmsnorm(x, scale)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, positions: torch.Tensor):
    """positions: int (..., S). Returns cos/sin of shape
    (..., S, head_dim//2)."""
    half = head_dim // 2
    ar = torch.arange(0, half, dtype=torch.float32, device=positions.device)
    inv = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                       device=positions.device), ar / half)
    ang = positions.float()[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x: (B, S, H, D). cos/sin: (S, D/2) or (B, S, D/2), broadcast over H."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    if cos.ndim == 2:       # (S, D/2)
        c, s = cos[None, :, None, :], sin[None, :, None, :]
    else:                   # (B, S, D/2)
        c, s = cos[:, :, None, :], sin[:, :, None, :]
    c, s = c.to(x.dtype), s.to(x.dtype)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


# ---------------------------------------------------------------------------
# Embeddings
# ---------------------------------------------------------------------------


def init_embedding(gen: torch.Generator, cfg: ModelConfig, *, device=None):
    pdt = torch_dtype(cfg.param_dtype)
    shape = (cfg.vocab_size, cfg.d_model)
    p = {"tok": dense_init(gen, shape, pdt, device=device)}
    if not cfg.tie_embeddings:
        p["out"] = dense_init(gen, shape, pdt, device=device)
    return p


def embed_tokens(params, tokens, cfg: ModelConfig):
    emb = params["tok"].to(torch_dtype(cfg.dtype))
    return emb[tokens]


def unembed(params, x, cfg: ModelConfig):
    w = params.get("out", params["tok"]).to(torch_dtype(cfg.dtype))
    return x @ w.t()


# ---------------------------------------------------------------------------
# Linear init helpers (pre-LN scaled init, Wang et al. 2024 / paper App. C)
# ---------------------------------------------------------------------------


def dense_init(gen: torch.Generator, shape, dtype, scale: float = 0.02, *,
               device=None):
    """Normal(0, scale) with the same shapes and scales as the JAX init
    (not the same numbers: torch's generator is not threefry)."""
    return torch.randn(tuple(shape), generator=gen, dtype=torch.float32,
                       device=device).mul_(scale).to(dtype)


def preln_output_scale(n_layers: int) -> float:
    """Paper App. C: scale MLP/value/output projections by sqrt(log 2L)
    (DeepNet-style stabilization for very deep pre-LN nets). Used as a
    *divisor* on init std to keep the residual stream bounded."""
    return 1.0 / max(1.0, math.sqrt(math.log(2 * max(n_layers, 1))))
