"""Pre-LN transformer blocks in neural-ODE form (paper Eq. 1-2).

Port of :mod:`repro.models.blocks` (every kind: ``attn_mlp``,
``attn_moe``, ``encdec_dec``, ``mamba1``, ``mamba2``): one layer is the
forward-Euler step ``Z_{n+1} = Z_n + gate * F(Z_n)`` with

  attn_mlp (Eq. 1):    F = phi1(X) + phi2(X + phi1(X)),
                       phi1 = SA o LN, phi2 = MLP o LN
  attn_moe:            the same with phi2 = MoE o LN
  encdec_dec (Eq. 2):  Ybar = phi1(Y) + phi3(Y + phi1(Y), X_enc),
                       phi3 = CA o LN (cross-attention to X_enc),
                       F = Ybar + phi2(Y + Ybar)
  mamba1/mamba2:       F = Mixer o LN (their paged serving step is
                       ``repro_torch.models.ssm``).

With a dense decode cache, ``block_F`` / ``block_step`` return
``(value, new_cache)``, as the reference's do; without one, the value
alone.

Block params are homogeneous within a kind, so they stack over the layer
axis (leading dim of every leaf).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.attention import (attention_apply, init_attention,
                                          paged_attention_apply)
from repro_torch.models.layers import init_norm, norm_apply
from repro_torch.models.mlp import init_mlp, mlp_apply
from repro_torch.models.moe import init_moe, moe_apply
from repro_torch.models.ssm import (init_mamba1, init_mamba2, mamba1_apply,
                                   mamba2_apply)


def block_kind(cfg: ModelConfig) -> str:
    if cfg.family == "ssm":
        return "mamba1" if cfg.ssm.version == 1 else "mamba2"
    if cfg.family == "hybrid":
        return "mamba2"
    if cfg.moe is not None:
        return "attn_moe"
    return "attn_mlp"


def init_block(gen: torch.Generator, cfg: ModelConfig,
               kind: Optional[str] = None, *, lead=(), device=None):
    """Params of one block, or of ``lead`` stacked blocks."""
    kind = kind or block_kind(cfg)
    if kind in ("mamba1", "mamba2"):
        init_mixer = init_mamba1 if kind == "mamba1" else init_mamba2
        return {"norm": init_norm(cfg, lead=lead, device=device),
                "mixer": init_mixer(gen, cfg, lead=lead, device=device)}
    p = {
        "ln1": init_norm(cfg, lead=lead, device=device),
        "attn": init_attention(gen, cfg, lead=lead, device=device),
        "ln2": init_norm(cfg, lead=lead, device=device),
    }
    if kind == "attn_moe":
        p["moe"] = init_moe(gen, cfg, lead=lead, device=device)
        return p
    p["mlp"] = init_mlp(gen, cfg, lead=lead, device=device)
    if kind == "encdec_dec":
        p["ln3"] = init_norm(cfg, lead=lead, device=device)
        p["xattn"] = init_attention(gen, cfg, cross=True, lead=lead,
                                    device=device)
    return p


def attn_block_F(params, z, a, cfg: ModelConfig, *, kind: str):
    """F = phi1 + phi2(z + phi1) given the attention output ``a`` = phi1(z).
    Single owner of the attn_mlp / attn_moe block formula: the paged
    serving path (:func:`paged_attn_block`) computes the attention
    differently and keeps this form."""
    h_in = norm_apply(params["ln2"], z + a, cfg)
    if kind == "attn_moe":
        return a + moe_apply(params["moe"], h_in, cfg)
    return a + mlp_apply(params["mlp"], h_in, cfg)


def block_F(params, z, cfg: ModelConfig, *, kind: str, causal: bool,
            rope=None, xa=None, cache=None):
    """Evaluate the ODE right-hand side F(t, z) of one block (``rope`` is
    read by the attention kinds only, ``xa``, the encoder's output, by
    ``encdec_dec`` only). ``cache``: the layer's dense decode cache (the
    self-attention's KV, or the mixer's conv window and state), updated
    in place; then returns (F, new_cache), else F."""
    if kind in ("mamba1", "mamba2"):
        mixer = mamba1_apply if kind == "mamba1" else mamba2_apply
        return mixer(params["mixer"], norm_apply(params["norm"], z, cfg),
                     cfg, cache=cache)
    a = attention_apply(params["attn"], norm_apply(params["ln1"], z, cfg),
                        cfg, causal=causal, rope=rope, cache=cache)
    if cache is not None:
        a, cache = a
    if kind == "encdec_dec":
        ca = attention_apply(params["xattn"],
                             norm_apply(params["ln3"], z + a, cfg), cfg,
                             causal=False, xa=xa)
        ybar = a + ca
        f = ybar + mlp_apply(params["mlp"],
                             norm_apply(params["ln2"], z + ybar, cfg), cfg)
    else:
        f = attn_block_F(params, z, a, cfg, kind=kind)
    return f if cache is None else (f, cache)


def block_step(params, z, cfg: ModelConfig, *, kind: str, causal: bool,
               h: float = 1.0, gate=None, rope=None, xa=None, cache=None):
    """One Euler step Phi(z) = z + h*gate*F(z). ``gate`` (0/1) marks padded
    identity layers used for layer-parallel divisibility padding. The
    step sizes in use (1, 1/16 and their cf multiples) are exact in bf16,
    so scaling by the Python float equals the reference's cast-then-
    multiply. With a ``cache`` (see :func:`block_F`) returns (z_next,
    new_cache)."""
    f = block_F(params, z, cfg, kind=kind, causal=causal, rope=rope, xa=xa,
                cache=cache)
    if cache is not None:
        f, cache = f
    z = z + h * f if gate is None else z + (h * gate.to(z.dtype)) * f
    return z if cache is None else (z, cache)


def paged_attn_block(params, z, cfg: ModelConfig, *, kind: str, rope,
                     pk, pv, page_table, lengths, n_new, gate=None,
                     fused: bool = False):
    """One attention block step against a layer's KV page pool (written
    in place). ``gate`` 0 marks a padded identity layer, which still runs:
    ``z + 0 * f == z`` only for finite f, as in the reference. Returns
    z_next."""
    a = paged_attention_apply(
        params["attn"], norm_apply(params["ln1"], z, cfg), cfg, rope=rope,
        pk=pk, pv=pv, page_table=page_table, lengths=lengths, n_new=n_new,
        fused=fused)
    f = attn_block_F(params, z, a, cfg, kind=kind)
    if gate is None:
        return z + f
    return z + gate.to(z.dtype) * f
