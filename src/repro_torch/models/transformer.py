"""The decoder model around the layer stack: training and serving.

Port of :mod:`repro.models.transformer` for the decoder family with
``attn_mlp`` blocks. Params use the JAX pytree's key paths: ``embed``
(``tok``, ``out``), ``final_norm``, ``open`` / ``close`` (serial buffer
stacks) and ``mid`` (``params`` stack + ``gate``) — the ParallelNet's
layers, padded with gate-0 identity layers to the MGRIT divisibility.
Training runs the buffers serially and the ParallelNet through
:func:`repro_torch.core.lp.lp_forward` (MGRIT forward, MGRIT adjoint
backward); serving runs every stacked layer in order, padded ones
included. The encoder-decoder, SSM and hybrid families come in later
slices.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple

import torch

from repro_torch.configs.base import MGRITConfig, ModelConfig, RunConfig
from repro_torch.core import mgrit
from repro_torch.core.lp import LPStatic, lp_forward
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models.blocks import (block_kind, block_step, init_block,
                                       paged_attn_block)
from repro_torch.models.layers import (embed_tokens, init_embedding,
                                       init_norm, norm_apply, rope_freqs,
                                       torch_dtype, unembed)
from repro_torch.tree import leaves_with_paths

# ---------------------------------------------------------------------------
# Depth bookkeeping (pad_depth / make_gates: own copies of repro.core.lp's)
# ---------------------------------------------------------------------------


def pad_depth(n_real: int, pad_to: int) -> int:
    if pad_to <= 0:
        return n_real
    return ((n_real + pad_to - 1) // pad_to) * pad_to


def make_gates(n_real: int, n_padded: int, dtype=torch.float32, device=None):
    return (torch.arange(n_padded, device=device) < n_real).to(dtype)


@dataclasses.dataclass(frozen=True)
class DepthPlan:
    n_open: int
    n_close: int
    n_mid_real: int
    n_mid_padded: int


def depth_plan(n_layers: int, mg: MGRITConfig) -> DepthPlan:
    n_open, n_close = mg.n_open, mg.n_close
    n_mid = n_layers - n_open - n_close
    if n_mid <= 0:
        raise ValueError("buffers consume all layers")
    return DepthPlan(n_open, n_close, n_mid, pad_depth(n_mid, mg.pad_to))


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def _init_params(rcfg: RunConfig, gen, device) -> Dict[str, Any]:
    cfg, mg = rcfg.model, rcfg.mgrit
    if cfg.family != "decoder" or block_kind(cfg) != "attn_mlp":
        raise NotImplementedError(
            f"family={cfg.family!r} kind={block_kind(cfg)!r} is not ported "
            "yet: this slice serves decoder models with attn_mlp blocks")
    plan = depth_plan(cfg.n_layers, mg)
    params: Dict[str, Any] = {
        "embed": init_embedding(gen, cfg, device=device),
        "final_norm": init_norm(cfg, device=device)}

    def stack(n):
        return init_block(gen, cfg, lead=(n,), device=device) if n else None

    params["open"] = stack(plan.n_open)
    params["close"] = stack(plan.n_close)
    params["mid"] = {
        "params": stack(plan.n_mid_padded),
        "gate": make_gates(plan.n_mid_real, plan.n_mid_padded, device=device)}
    return params


def init_model(rcfg: RunConfig, *, seed: int = 0, device=None):
    """Random weights with the JAX init's shapes, scales and gates (not
    its numbers: the generator is torch's, seeded with ``seed``). Runs on
    ``cuda`` unless ``device="cpu"`` (see ``resolve_device``)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return _init_params(rcfg, gen, dev)


def param_shapes(rcfg: RunConfig) -> Dict[str, Any]:
    """The params tree of :func:`init_model` on the meta device: key
    paths, shapes and dtypes without allocating anything."""
    return _init_params(rcfg, None, torch.device("meta"))


def serving_params(params, cfg: ModelConfig):
    """A copy of ``params`` whose matmul weights (embeddings, attention
    and MLP projections) are held in the compute dtype. The reference
    casts them to ``cfg.dtype`` at every use; casting once gives the same
    numbers without re-reading the float32 weights every wave. Norm
    scales and gates keep their dtype: the reference reads them in
    float32."""
    dt = torch_dtype(cfg.dtype)
    matmul = {"tok", "out", "wq", "wk", "wv", "wo", "w_in", "w_out",
              "w_gate"}

    def walk(tree):
        if tree is None:
            return None
        if isinstance(tree, dict):
            return {k: (v.to(dt) if k in matmul else walk(v))
                    for k, v in tree.items()}
        return tree

    return walk(params)


# ---------------------------------------------------------------------------
# Forward (train)
# ---------------------------------------------------------------------------


def _rope_for(cfg: ModelConfig, seq: int, device):
    pos = torch.arange(seq, dtype=torch.int32, device=device)
    return rope_freqs(cfg.resolved_head_dim, cfg.rope_theta, pos)


def _serial_buffer(stacked, z, cfg: ModelConfig, *, kind, causal, rope):
    """Exact serial buffer layers (paper App. B, Delta-t = 1), normal
    autograd."""
    if stacked is None:
        return z
    for p in mgrit.slots(stacked):
        z = block_step(p, z, cfg, kind=kind, causal=causal, h=1.0,
                       rope=rope)
    return z


def _trunk(params_mid, z, rcfg: RunConfig, *, kind, causal, rope,
           mode: str):
    """The ParallelNet: MGRIT layer-parallel or exact serial trunk."""
    cfg, mg = rcfg.model, rcfg.mgrit
    if mode == "serial" or not mg.enabled:
        mg = dataclasses.replace(mg, fwd_iters=0, bwd_iters=0)
    static = LPStatic(cfg=cfg, mgrit=mg, kind=kind, causal=causal)
    return lp_forward(static, params_mid, z, {"rope": rope})


def _embed_inputs(params, batch, cfg: ModelConfig):
    """Token embeddings, with the vision frontend stub prepended."""
    x = embed_tokens(params["embed"], batch["tokens"], cfg)
    if cfg.frontend == "vision" and "mm_embeds" in batch:
        x = torch.cat([batch["mm_embeds"].to(x.dtype), x], dim=1)
    return x


def forward(params, batch, rcfg: RunConfig, mode: str = "lp"):
    """Returns (logits, diagnostics). batch: tokens (B, S) [+ mm_embeds]."""
    cfg = rcfg.model
    kind = block_kind(cfg)
    if cfg.family != "decoder":
        later = ("the SSM and hybrid slice (ROADMAP Queue 1)"
                 if cfg.family in ("ssm", "hybrid") else
                 "the remaining-families slice (ROADMAP Queue 1)")
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet: the port trains "
            f"decoder models; it comes with {later}")
    z = _embed_inputs(params, batch, cfg)
    rope = _rope_for(cfg, z.shape[1], z.device)
    z = _serial_buffer(params.get("open"), z, cfg, kind=kind, causal=True,
                       rope=rope)
    z, norms = _trunk(params["mid"], z, rcfg, kind=kind, causal=True,
                      rope=rope, mode=mode)
    z = _serial_buffer(params.get("close"), z, cfg, kind=kind, causal=True,
                       rope=rope)
    z = norm_apply(params["final_norm"], z, cfg)
    logits = unembed(params["embed"], z, cfg)
    return logits, {"fwd_norms": norms}


def lm_loss(logits, labels):
    """Mean token cross-entropy in float32."""
    lg = logits.float()
    lse = torch.logsumexp(lg, dim=-1)
    ll = torch.gather(lg, -1, labels.long()[..., None])[..., 0]
    return torch.mean(lse - ll)


def loss_fn(params, batch, rcfg: RunConfig, mode: str = "lp"):
    logits, diagnostics = forward(params, batch, rcfg, mode=mode)
    labels = batch["labels"]
    if logits.shape[1] != labels.shape[1]:  # vlm: mm positions carry no loss
        logits = logits[:, -labels.shape[1]:]
    return lm_loss(logits, labels), diagnostics


# ---------------------------------------------------------------------------
# Paged serving
# ---------------------------------------------------------------------------


def _all_layers_stacked(params) -> Tuple[List[Dict[str, Any]], torch.Tensor]:
    """Every serial layer in order (open, mid, close) with its gate. The
    JAX package concatenates the stacks for its layer scan; the port's
    Python loop takes per-layer views instead, since a concatenation would
    copy every weight on every wave."""
    layers, gates = [], []
    for name in ("open", "mid", "close"):
        p = params.get(name)
        if p is None:
            continue
        if name == "mid":
            stack, gate = p["params"], p["gate"]
        else:
            stack = p
            gate = None
        if stack is None:
            continue
        n = len(layers)
        layers.extend(mgrit.slots(stack))
        gates.append(gate if gate is not None else torch.ones(
            len(layers) - n, dtype=torch.float32,
            device=leaves_with_paths(stack)[0][1].device))
    return layers, torch.cat(gates)


def stacked_layer_depth(rcfg: RunConfig) -> int:
    plan = depth_plan(rcfg.model.n_layers, rcfg.mgrit)
    return plan.n_open + plan.n_mid_padded + plan.n_close


def init_paged_cache(rcfg: RunConfig, n_pages: int, page_size: int, *,
                     device=None):
    """Attention KV page pool sized for the full serial layer stack
    (open+mid+close)."""
    return attn_mod.init_paged_kv_cache(
        rcfg.model, stacked_layer_depth(rcfg), n_pages, page_size,
        device=device)


def _paged_last_logits(params, z, n_new, cfg: ModelConfig):
    """Logits at each slot's last real token (index ``n_new - 1``); rows
    past ``n_new`` in a prefill bucket are garbage and never unembedded."""
    last = torch.clamp(n_new - 1, min=0)
    z_last = z[torch.arange(z.shape[0], device=z.device), last]
    # the norm is per row, so normalizing after the gather is the same
    return unembed(params["embed"],
                   norm_apply(params["final_norm"], z_last, cfg), cfg)


def _paged_attn_forward(params, pages, tokens, lengths, n_new, page_table,
                        rcfg: RunConfig, *, fused: bool = False):
    """Embeds, runs every stacked layer against its page pool (pools
    written in place), returns z (B, S, D). ``fused`` routes each layer's
    attention core through the paged kernel."""
    cfg = rcfg.model
    kind = block_kind(cfg)
    if kind != "attn_mlp":
        raise NotImplementedError("paged KV decode requires attn_mlp blocks")
    layers, gates = _all_layers_stacked(params)
    if len(layers) != pages["k"].shape[0]:
        raise ValueError(f"{len(layers)} layers but the page pools stack "
                         f"{pages['k'].shape[0]}")
    S = tokens.shape[1]
    pos = lengths[:, None] + torch.arange(S, device=tokens.device)[None, :]
    rope = rope_freqs(cfg.resolved_head_dim, cfg.rope_theta, pos)
    z = embed_tokens(params["embed"], tokens, cfg)
    for i, p in enumerate(layers):
        z = paged_attn_block(p, z, cfg, kind=kind, rope=rope,
                             pk=pages["k"][i], pv=pages["v"][i],
                             page_table=page_table, lengths=lengths,
                             n_new=n_new, gate=gates[i], fused=fused)
    return z


def paged_decode_step(params, pages, tokens, lengths, n_new, page_table,
                      rcfg: RunConfig, *, fused: bool = False):
    """Batched step against the shared KV page pool.

    tokens: (B, S). S == 1 in steady-state decode; S == the prompt bucket
    during chunked prefill. Slot b holds ``lengths[b]`` cached tokens and
    contributes ``n_new[b] <= S`` new ones (0 = empty slot). Returns
    (last_logits (B, V) at each slot's final real token, pages) — the
    pools are updated in place and returned for the reference's
    signature.
    """
    z = _paged_attn_forward(params, pages, tokens, lengths, n_new,
                            page_table, rcfg, fused=fused)
    return _paged_last_logits(params, z, n_new, rcfg.model), pages
