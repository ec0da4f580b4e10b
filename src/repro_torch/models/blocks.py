"""Pre-LN transformer blocks in neural-ODE form (paper Eq. 1).

Port of the ``attn_mlp`` kind of :mod:`repro.models.blocks`: one layer is
the forward-Euler step ``Z_{n+1} = Z_n + gate * F(Z_n)`` with
``F = phi1(X) + phi2(X + phi1(X))``, phi1 = SA o LN, phi2 = MLP o LN.
Block params are homogeneous within a kind, so they stack over the
layer axis (leading dim of every leaf).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.attention import (attention_apply, init_attention,
                                          paged_attention_apply)
from repro_torch.models.layers import init_norm, norm_apply
from repro_torch.models.mlp import init_mlp, mlp_apply


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
    if kind != "attn_mlp":
        raise NotImplementedError(
            f"block kind {kind!r} is not ported yet (attn_mlp only; the "
            "SSM/hybrid and MoE families come in later slices)")
    return {
        "ln1": init_norm(cfg, lead=lead, device=device),
        "attn": init_attention(gen, cfg, lead=lead, device=device),
        "ln2": init_norm(cfg, lead=lead, device=device),
        "mlp": init_mlp(gen, cfg, lead=lead, device=device),
    }


def attn_block_F(params, z, a, cfg: ModelConfig, *, kind: str):
    """F = phi1 + phi2(z + phi1) given the attention output ``a`` = phi1(z)."""
    if kind != "attn_mlp":
        raise NotImplementedError(f"block kind {kind!r} is not ported yet")
    h_in = norm_apply(params["ln2"], z + a, cfg)
    return a + mlp_apply(params["mlp"], h_in, cfg)


def block_F(params, z, cfg: ModelConfig, *, kind: str, causal: bool,
            rope=None):
    """Evaluate the ODE right-hand side F(t, z) of one block."""
    if kind != "attn_mlp":
        raise NotImplementedError(f"block kind {kind!r} is not ported yet")
    a = attention_apply(params["attn"], norm_apply(params["ln1"], z, cfg),
                        cfg, causal=causal, rope=rope)
    return attn_block_F(params, z, a, cfg, kind=kind)


def block_step(params, z, cfg: ModelConfig, *, kind: str, causal: bool,
               h: float = 1.0, gate=None, rope=None):
    """One Euler step Phi(z) = z + h*gate*F(z). ``gate`` (0/1) marks padded
    identity layers used for layer-parallel divisibility padding. The
    step sizes in use (1, 1/16 and their cf multiples) are exact in bf16,
    so scaling by the Python float equals the reference's cast-then-
    multiply."""
    f = block_F(params, z, cfg, kind=kind, causal=causal, rope=rope)
    if gate is None:
        return z + h * f
    return z + (h * gate.to(z.dtype)) * f


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
