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
from repro_torch.parallel import tp


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
    # theta filled on the device (torch.tensor would copy it from the host)
    inv = 1.0 / torch.pow(torch.full((), theta, dtype=torch.float32,
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
    """The token embeddings. Vocab-parallel under the active rules
    (:func:`repro_torch.parallel.tp.split`): each rank looks up the ids
    of its own rows of the table (``params`` this rank's part; zeros
    elsewhere) and the ranks sum; one term of the sum is non-zero, so
    the result is exact, and in a backward each rank's rows get only
    their own tokens' cotangent."""
    emb = params["tok"].to(torch_dtype(cfg.dtype))
    sp = tp.split("vocab", cfg.vocab_size)
    if sp is None:
        return emb[tokens]
    n = emb.shape[0]
    idx = tokens - sp.r * n
    mine = (idx >= 0) & (idx < n)
    x = torch.where(mine[..., None], emb[idx.clamp(0, n - 1)],
                    torch.zeros((), dtype=emb.dtype, device=emb.device))
    return sp.all_sum("tp_embed", x)


def unembed(params, x, cfg: ModelConfig):
    """Logits; under a vocab split (:func:`repro_torch.parallel.tp.split`)
    this rank's vocab columns only (:func:`gather_vocab` makes them
    whole), column-parallel (:meth:`repro_torch.parallel.tp.Split.column`:
    ``x``'s cotangent summed over the vocab's ranks)."""
    w = params.get("out", params["tok"]).to(torch_dtype(cfg.dtype))
    sp = tp.split("vocab", cfg.vocab_size)
    if sp is None:
        return x @ w.t()
    return sp.column("tp_head_in", x, w.t())[0]


def gather_vocab(logits, cfg: ModelConfig):
    """:func:`unembed`'s logits over the whole vocab on every rank (no
    gradient flows through the gather: a training loss over a vocab
    split is :func:`vocab_parallel_loss`)."""
    sp = tp.split("vocab", cfg.vocab_size)
    if sp is None:
        return logits
    if torch.is_grad_enabled() and logits.requires_grad:
        raise NotImplementedError(
            "whole logits under a vocab split carry no gradient: "
            "differentiate transformer.loss_fn")
    return sp.mesh.all_gather("tp_logits", logits, sp.axis, dim=-1)


def vocab_parallel_loss(logits, labels, sp: tp.Split):
    """The mean token cross-entropy in float32 from this rank's vocab
    columns ``logits`` (B, S, V/n) of ``sp``'s split, the whole (B, S,
    V) never formed: the row maxima all-gathered (the shift carries no
    gradient), each rank's sum of exp(logit - max) and its label logits
    (zero where another rank owns the label) summed over the ranks in
    one all-reduce, lse = log(sum) + max. Every rank returns the same
    bits; in a backward each rank's columns get softmax - onehot of
    their own entries."""
    lg = logits.float()
    n = lg.shape[-1]
    with torch.no_grad():
        m = sp.mesh.all_gather("tp_loss_max", lg.amax(-1, keepdim=True),
                               sp.axis, dim=-1).amax(-1)
    idx = labels.long() - sp.r * n
    mine = (idx >= 0) & (idx < n)
    ll = torch.where(mine, torch.gather(lg, -1, idx.clamp(0, n - 1)[
        ..., None])[..., 0], torch.zeros((), device=lg.device))
    se = torch.exp(lg - m[..., None]).sum(-1)
    se, ll = sp.all_sum("tp_loss", torch.stack([se, ll], dim=-1)).unbind(-1)
    return torch.mean(torch.log(se) + m - ll)


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
