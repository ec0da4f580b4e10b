"""The model around the layer stack: training and serving.

Port of :mod:`repro.models.transformer` for every family: the decoder
(``attn_mlp`` blocks, or ``attn_moe`` for the MoE configs), encoder and
encoder-decoder families (``encdec_dec`` in the decoder of the last) and
the SSM and hybrid families: training for all of them, paged serving for
the decoder, SSM and hybrid ones. Params use
the JAX pytree's key paths: ``embed`` (``tok``, ``out``),
``final_norm``, ``open`` / ``close`` (serial buffer stacks) and ``mid``
(``params`` stack + ``gate``) — the ParallelNet's layers, padded with
gate-0 identity layers to the MGRIT divisibility. The encoder-decoder
family has ``enc_mid`` and ``dec_mid`` instead (two ParallelNets, no
buffers), the hybrid family ``backbone`` (mamba2 stack) and
``shared_attn`` (one ``attn_mlp`` block). Training runs the buffers
serially and each ParallelNet through
:func:`repro_torch.core.lp.lp_forward` (MGRIT forward, MGRIT adjoint
backward); the encoder-decoder is the paper's Eq. 3, one time grid
solved as two chained trunks, the decoder's cross-attention input's
cotangent flowing into the encoder's adjoint; the hybrid family trains
serially (the shared attention block breaks the ODE form); decode and
serving run every stacked layer in order, padded ones included.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import MGRITConfig, ModelConfig, RunConfig
from repro_torch.core import mgrit
from repro_torch.core.lp import LPStatic, lp_forward
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.blocks import (block_kind, block_step, init_block,
                                       paged_attn_block)
from repro_torch.models.layers import (embed_tokens, gather_vocab,
                                       init_embedding, init_norm,
                                       norm_apply, rope_freqs, torch_dtype,
                                       unembed, vocab_parallel_loss)
from repro_torch.parallel import fsdp, tp
from repro_torch.parallel.sharding import current_rules
from repro_torch.tree import leaves_with_paths, tree_map

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
    kind = block_kind(cfg)
    params: Dict[str, Any] = {
        "embed": init_embedding(gen, cfg, device=device),
        "final_norm": init_norm(cfg, device=device)}

    def stack(n, kind=kind):
        return init_block(gen, cfg, kind, lead=(n,), device=device) \
            if n else None

    def trunk(n_layers, kind):
        plan = depth_plan(n_layers, mg)
        return {"params": stack(plan.n_mid_padded, kind),
                "gate": make_gates(plan.n_mid_real, plan.n_mid_padded,
                                   device=device)}

    if cfg.family == "encdec":
        params["enc_mid"] = trunk(cfg.n_layers, "attn_mlp")
        params["dec_mid"] = trunk(cfg.n_dec_layers, "encdec_dec")
        return params
    if cfg.family == "hybrid":
        params["backbone"] = init_block(gen, cfg, "mamba2",
                                        lead=(cfg.n_layers,), device=device)
        params["shared_attn"] = init_block(gen, cfg, "attn_mlp",
                                           device=device)
        return params
    plan = depth_plan(cfg.n_layers, mg)
    params["open"] = stack(plan.n_open)
    params["close"] = stack(plan.n_close)
    params["mid"] = trunk(cfg.n_layers, kind)
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
    """A copy of ``params`` whose matmul weights (embeddings, attention,
    MLP, MoE router and expert, and Mamba projections, the Mamba conv)
    are held in the compute dtype. The reference casts them to ``cfg.dtype`` at every use;
    casting once gives the same numbers without re-reading the float32
    weights every wave. Everything else keeps its dtype and is cast where
    the reference casts it: norm scales and gates are read in float32,
    and Mamba's ``dt_bias``, ``D`` and ``norm_scale`` are cast to
    ``cfg.dtype`` by mamba1 but read in float32 by mamba2."""
    dt = torch_dtype(cfg.dtype)
    matmul = {"tok", "out", "wq", "wk", "wv", "wo", "w_in", "w_out",
              "w_gate", "router", "in_proj", "x_proj", "dt_proj", "out_proj",
              "conv_w", "conv_b"}

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


_TRUNKS = ("mid", "enc_mid", "dec_mid")


@functools.lru_cache(maxsize=8)
def _fsdp_plan(rcfg: RunConfig, mesh) -> Optional[fsdp.Plan]:
    from repro_torch.parallel import params as pparams
    shapes = param_shapes(rcfg)
    return fsdp.plan_of(pparams.fsdp_cut(
        shapes, pparams.train_specs(shapes, rcfg, mesh), mesh,
        rcfg.sharding), mesh)


def fsdp_plan(rcfg: RunConfig) -> Optional[fsdp.Plan]:
    """The leaves of ``rcfg``'s params stored cut over the fsdp axis
    under the active training rules
    (:func:`repro_torch.parallel.sharding.axis_rules`), or None (no
    rules, no ``sharding.fsdp``, or an fsdp axis of one rank)."""
    mesh, _ = current_rules()
    if mesh is None or not rcfg.sharding.fsdp:
        return None
    return _fsdp_plan(rcfg, mesh)


def train_params(params, rcfg: RunConfig):
    """``params`` as the training forward reads them: every fsdp-cut
    leaf outside the ParallelNets gathered whole, its gradient
    reduce-scattered in the backward (:mod:`repro_torch.parallel.fsdp`);
    the trunks' leaves stay as stored (each F evaluation gathers its own
    layer). ``params`` itself without fsdp."""
    plan = fsdp_plan(rcfg)
    if plan is None:
        return params
    return plan.gather_tree(params, grad=True, skip=_TRUNKS)


def trunk_static(rcfg: RunConfig, n_layers: int, *, kind, causal,
                 mg: MGRITConfig = None, root: str = "mid") -> LPStatic:
    """The ParallelNet's static description for a model of ``n_layers``
    layers (``rcfg.mgrit``'s, or ``mg``'s, iteration counts), with the
    layout of its chunks and batch rows under the active sharding rules
    (:func:`repro_torch.core.mgrit.current_layout`; None without) and
    the fsdp-cut leaves of one layer of the trunk at ``root``."""
    plan = depth_plan(n_layers, rcfg.mgrit)
    mg = rcfg.mgrit if mg is None else mg
    cut = fsdp_plan(rcfg)
    return LPStatic(cfg=rcfg.model, mgrit=mg, kind=kind, causal=causal,
                    layout=mgrit.current_layout(
                        plan.n_mid_padded, mg.cf, mg.shard_levels,
                        rcfg.shape.global_batch),
                    fsdp=None if cut is None else cut.under(
                        (root, "params"), lead=1))


def _trunk(params, root: str, z, rcfg: RunConfig, *, kind, causal, rope,
           mode: str, n_layers: int, xa=None):
    """The ParallelNet at ``params[root]`` of a model of ``n_layers``
    layers: MGRIT layer-parallel or exact serial trunk. ``xa``: the
    encoder's output, for an ``encdec_dec`` trunk. Under a mesh the trunk
    holds this rank's chunks (:func:`repro_torch.parallel.params.shard_tree`);
    the layers around the trunk are replicated and computed on every
    rank."""
    mg = rcfg.mgrit
    if mode == "serial" or not mg.enabled:
        mg = dataclasses.replace(mg, fwd_iters=0, bwd_iters=0)
    static = trunk_static(rcfg, n_layers, kind=kind, causal=causal, mg=mg,
                          root=root)
    return lp_forward(static, params[root], z, {"rope": rope, "xa": xa})


def _embed_inputs(params, batch, cfg: ModelConfig):
    """Token embeddings, with the vision frontend stub prepended."""
    x = embed_tokens(params["embed"], batch["tokens"], cfg)
    if cfg.frontend == "vision" and "mm_embeds" in batch:
        x = torch.cat([batch["mm_embeds"].to(x.dtype), x], dim=1)
    return x


def _hybrid_trunk(params, z, cfg: ModelConfig, rope):
    """The mamba2 backbone, serial, with the shared attention block after
    every ``hybrid_attn_every`` layers (none after a trailing partial
    segment)."""
    k = cfg.hybrid_attn_every
    for i, p in enumerate(mgrit.slots(params["backbone"])):
        z = block_step(p, z, cfg, kind="mamba2", causal=True, h=1.0)
        if (i + 1) % k == 0:
            z = block_step(params["shared_attn"], z, cfg, kind="attn_mlp",
                           causal=True, h=1.0, rope=rope)
    return z


def encode(params, batch, rcfg: RunConfig, mode: str = "serial"):
    """The encoder-decoder family's encoder grid over the source
    (``src_tokens``, or the audio stub's ``src_embeds``). Returns
    (X_{N_enc} (B, S_src, D), its forward residual norms); X_{N_enc} is
    the ``xa`` that :func:`decode_step` cross-attends to."""
    cfg = rcfg.model
    if cfg.frontend == "audio" and "src_embeds" in batch:
        xe = batch["src_embeds"].to(torch_dtype(cfg.dtype))
    else:
        xe = _embed_inputs(params, {"tokens": batch["src_tokens"]}, cfg)
    return _trunk(params, "enc_mid", xe, rcfg, kind="attn_mlp",
                  causal=False, rope=_rope_for(cfg, xe.shape[1], xe.device),
                  mode=mode, n_layers=cfg.n_layers)


def _encdec_trunks(params, batch, rcfg: RunConfig, mode: str):
    """Paper Eq. 3: the encoder grid (:func:`encode`), then the decoder
    grid over ``tokens`` cross-attending to the encoder's output
    X_{N_enc}. Returns (Y_N, both trunks' forward residual norms)."""
    cfg = rcfg.model
    xN, n1 = encode(params, batch, rcfg, mode)
    y = embed_tokens(params["embed"], batch["tokens"], cfg)
    yN, n2 = _trunk(params, "dec_mid", y, rcfg, kind="encdec_dec",
                    causal=True, rope=_rope_for(cfg, y.shape[1], y.device),
                    mode=mode, n_layers=cfg.n_dec_layers, xa=xN)
    return yN, torch.cat([n1, n2])


def _hidden(params, batch, rcfg: RunConfig, mode: str):
    """(the final-normed state (B, S, D) the head reads, diagnostics) of
    params as :func:`train_params` gives them."""
    cfg = rcfg.model
    kind = block_kind(cfg)
    if cfg.family == "encdec":
        z, norms = _encdec_trunks(params, batch, rcfg, mode)
    elif cfg.family == "hybrid":
        z = _embed_inputs(params, batch, cfg)
        z = _hybrid_trunk(params, z, cfg,
                          _rope_for(cfg, z.shape[1], z.device))
        norms = torch.zeros((1,), dtype=torch.float32, device=z.device)
    else:
        causal = cfg.family != "encoder"
        z = _embed_inputs(params, batch, cfg)
        rope = None if kind in ("mamba1", "mamba2") else \
            _rope_for(cfg, z.shape[1], z.device)
        z = _serial_buffer(params.get("open"), z, cfg, kind=kind,
                           causal=causal, rope=rope)
        z, norms = _trunk(params, "mid", z, rcfg, kind=kind, causal=causal,
                          rope=rope, mode=mode, n_layers=cfg.n_layers)
        z = _serial_buffer(params.get("close"), z, cfg, kind=kind,
                           causal=causal, rope=rope)
    return norm_apply(params["final_norm"], z, cfg), {"fwd_norms": norms}


def hidden_states(params, batch, rcfg: RunConfig, mode: str = "lp"):
    """The state the head reads (after the final norm) and the
    diagnostics: :func:`forward` without its head."""
    return _hidden(train_params(params, rcfg), batch, rcfg, mode)


def forward(params, batch, rcfg: RunConfig, mode: str = "lp"):
    """Returns (logits, diagnostics). batch: tokens (B, S) [+ mm_embeds
    for the vision stub; + src_tokens, or src_embeds for the audio stub,
    for the encoder-decoder family]. Under a vocab split the logits are
    gathered whole (:func:`repro_torch.models.layers.gather_vocab`)."""
    params = train_params(params, rcfg)
    z, diag = _hidden(params, batch, rcfg, mode)
    return gather_vocab(unembed(params["embed"], z, rcfg.model),
                        rcfg.model), diag


def lm_loss(logits, labels):
    """Mean token cross-entropy in float32."""
    lg = logits.float()
    lse = torch.logsumexp(lg, dim=-1)
    ll = torch.gather(lg, -1, labels.long()[..., None])[..., 0]
    return torch.mean(lse - ll)


def loss_fn(params, batch, rcfg: RunConfig, mode: str = "lp"):
    """(the mean token cross-entropy, diagnostics). Under a vocab split
    (the training rules' ``vocab`` over an axis that the vocab divides)
    the head computes this rank's columns and the loss is
    :func:`repro_torch.models.layers.vocab_parallel_loss`."""
    cfg = rcfg.model
    params = train_params(params, rcfg)
    z, diagnostics = _hidden(params, batch, rcfg, mode)
    logits = unembed(params["embed"], z, cfg)
    labels = batch["labels"]
    if logits.shape[1] != labels.shape[1]:  # vlm: mm positions carry no loss
        logits = logits[:, -labels.shape[1]:]
    sp = tp.split("vocab", cfg.vocab_size)
    if sp is None:
        return lm_loss(logits, labels), diagnostics
    return vocab_parallel_loss(logits, labels, sp), diagnostics


def prefill(params, batch, rcfg: RunConfig):
    """Prefill forward (no loss): the serial forward's logits. The serve
    engine populates its caches itself."""
    logits, _ = forward(params, batch, rcfg, mode="serial")
    return logits


# ---------------------------------------------------------------------------
# Dense-cache decode (the serial-forward oracle)
# ---------------------------------------------------------------------------


def init_cache(rcfg: RunConfig, batch: int, max_len: int, *, device=None,
               mesh=None):
    """The dense decode cache of every stacked layer, on ``cuda`` unless
    ``device="cpu"`` (see ``resolve_device``): KV (L, B, max_len, Hkv, hd)
    + ``index`` for attention stacks (the encoder-decoder's decoder
    trunk), conv window + state for SSM stacks, both for the hybrid
    family (its shared attention block keeps one KV layer a position).
    ``mesh``: this rank's part under ``rcfg.sharding`` (the slots over
    the batch's axis, the rows over ``kv_seq``'s, KV heads and SSM rows
    over the tensor-parallel axis), the cache
    :func:`repro_torch.launch.steps.make_serve_fn` ``(rcfg, mesh)``
    takes."""
    if mesh is not None:
        with tp.active(mesh, rcfg.sharding):
            return init_cache(rcfg, batch, max_len, device=device)
    cfg = rcfg.model
    kind = block_kind(cfg)
    dev = resolve_device(device)
    if cfg.family == "encdec":
        plan = depth_plan(cfg.n_dec_layers, rcfg.mgrit)
        return attn_mod.init_kv_cache(cfg, batch, max_len,
                                      plan.n_mid_padded, device=dev)
    if cfg.family == "hybrid":
        return {"mamba": ssm_mod.init_mamba2_cache(cfg, batch, cfg.n_layers,
                                                   device=dev),
                "attn": attn_mod.init_kv_cache(
                    cfg, batch, max_len,
                    cfg.n_layers // cfg.hybrid_attn_every, device=dev)}
    n = stacked_layer_depth(rcfg)
    if kind == "mamba1":
        return ssm_mod.init_mamba1_cache(cfg, batch, n, device=dev)
    if kind == "mamba2":
        return ssm_mod.init_mamba2_cache(cfg, batch, n, device=dev)
    return attn_mod.init_kv_cache(cfg, batch, max_len, n, device=dev)


def decode_step(params, cache, tokens, rcfg: RunConfig, xa=None, *,
                fsdp_plan=None):
    """Cached decode: tokens (B, T) on the cache's device. Returns
    (logits (B, T, V), cache) — the cache updated **in place** (the
    reference returns a new one) and returned.

    T == 1 is the steady-state decode step. T > 1 is **chunked
    prefill**: the whole chunk is written into the KV cache by one call
    (attention kinds only; SSM and hybrid caches advance one token a
    call). Every stacked layer runs in order, gate-0 padded ones
    included. ``xa``: the encoder's output (B, S_src, D) for the
    encoder-decoder family, whose decoder trunk (``dec_mid``) runs here.
    Positions come from ``cache["index"]`` on the device; nothing is read
    back to the host.

    Under :func:`repro_torch.parallel.tp.active` (the dense step under a
    mesh: ``params`` and ``cache`` this rank's parts, ``tokens`` and
    ``xa`` its slots) the logits are gathered over the vocab's ranks.
    ``fsdp_plan``: a :class:`repro_torch.parallel.fsdp.Plan` of the
    leaves ``params`` holds one slice a rank of: the embeddings and the
    other unstacked leaves are gathered whole once a call, each stacked
    layer's just before it runs."""
    cfg = rcfg.model
    kind = block_kind(cfg)
    if tokens.shape[1] != 1 and (cfg.family == "hybrid"
                                 or kind in ("mamba1", "mamba2")):
        raise NotImplementedError(
            "chunked prefill requires attention blocks; SSM/hybrid caches "
            "advance token-by-token")
    whole = _layer_gather(fsdp_plan, ())
    params = dict(params, **whole({k: params[k] for k in (
        "embed", "final_norm", "shared_attn") if k in params}))
    z = embed_tokens(params["embed"], tokens, cfg)
    if cfg.family == "hybrid":
        return _decode_hybrid(params, cache, z, rcfg, fsdp_plan)
    if cfg.family == "encdec":
        layers = mgrit.slots(params["dec_mid"]["params"])
        gates = params["dec_mid"]["gate"]
        kind = "encdec_dec"
        plans = [_layer_gather(fsdp_plan, ("dec_mid", "params"), 1)
                 ] * len(layers)
    else:
        layers, gates = _all_layers_stacked(params)
        plans = _stack_gathers(params, fsdp_plan)
    if kind in ("mamba1", "mamba2"):
        rope = None
        layer_cache = [{"conv": c, "h": h}
                       for c, h in zip(cache["conv"], cache["h"], strict=True)]
    else:
        idx = cache["index"]
        pos = idx + torch.arange(tokens.shape[1], device=tokens.device)
        rope = rope_freqs(cfg.resolved_head_dim, cfg.rope_theta, pos)
        layer_cache = [{"k": k, "v": v, "index": idx}
                       for k, v in zip(cache["k"], cache["v"], strict=True)]
    if len(layers) != len(layer_cache):
        raise ValueError(f"{len(layers)} layers but the cache stacks "
                         f"{len(layer_cache)}")
    for i, p in enumerate(layers):
        z, _ = block_step(plans[i](p), z, cfg, kind=kind, causal=True,
                          h=1.0, gate=gates[i], rope=rope, xa=xa,
                          cache=layer_cache[i])
    if "index" in cache:
        cache["index"] += tokens.shape[1]
    logits = gather_vocab(unembed(params["embed"],
                                  norm_apply(params["final_norm"], z, cfg),
                                  cfg), cfg)
    return logits, cache


def _layer_gather(plan, prefix, lead: int = 0):
    """The function that makes a subtree at ``prefix`` (``lead``: of one
    layer of a stack) whole from ``plan``'s cut leaves (identity without
    a plan or a cut leaf there)."""
    sub = None if plan is None else plan.under(prefix, lead)
    if sub is None:
        return lambda tree: tree
    return sub.gather_tree


def _stack_gathers(params, plan):
    """:func:`_layer_gather` of every layer :func:`_all_layers_stacked`
    lists, in its order."""
    out = []
    for name in ("open", "mid", "close"):
        p = params.get(name)
        stack = p["params"] if name == "mid" and p is not None else p
        if stack is None:
            continue
        n = (len(stack) if isinstance(stack, list)
             else leaves_with_paths(stack)[0][1].shape[0])
        prefix = (name, "params") if name == "mid" else (name,)
        out += [_layer_gather(None if isinstance(stack, list) else plan,
                              prefix, 1)] * n
    return out


def _decode_hybrid(params, cache, z, rcfg: RunConfig, fsdp_plan=None):
    """One token of the hybrid family: the mamba2 backbone against its
    dense states, the shared attention block after every
    ``hybrid_attn_every`` layers against its KV layer."""
    cfg = rcfg.model
    k = cfg.hybrid_attn_every
    n_seg, rem = divmod(cfg.n_layers, k)
    mamba, attn = cache["mamba"], cache["attn"]
    idx = attn["index"]
    rope = rope_freqs(cfg.resolved_head_dim, cfg.rope_theta,
                      torch.atleast_1d(idx))
    backbone = mgrit.slots(params["backbone"])
    whole = _layer_gather(fsdp_plan, ("backbone",), 1)
    li = 0
    for s_i in range(n_seg + (1 if rem else 0)):
        for _ in range(k if s_i < n_seg else rem):
            z, _ = block_step(whole(backbone[li]), z, cfg, kind="mamba2",
                              causal=True,
                              cache={"conv": mamba["conv"][li],
                                     "h": mamba["h"][li]})
            li += 1
        if s_i < n_seg:
            z, _ = block_step(params["shared_attn"], z, cfg, kind="attn_mlp",
                              causal=True, rope=rope,
                              cache={"k": attn["k"][s_i],
                                     "v": attn["v"][s_i], "index": idx})
    attn["index"] += 1
    logits = gather_vocab(unembed(params["embed"],
                                  norm_apply(params["final_norm"], z, cfg),
                                  cfg), cfg)
    return logits, cache


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
        # a list is already per-layer (the coarse draft's restriction)
        layers.extend(stack if isinstance(stack, list)
                      else mgrit.slots(stack))
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
    past ``n_new`` in a prefill bucket are garbage and never unembedded.
    Under :func:`repro_torch.parallel.tp.active` the vocab-parallel
    logits are gathered whole on every rank (as in
    :func:`_paged_all_logits`)."""
    last = torch.clamp(n_new - 1, min=0)
    z_last = z[torch.arange(z.shape[0], device=z.device), last]
    # the norm is per row, so normalizing after the gather is the same
    return gather_vocab(unembed(params["embed"],
                                norm_apply(params["final_norm"], z_last,
                                           cfg), cfg), cfg)


def _paged_all_logits(params, z, cfg: ModelConfig):
    """Logits at every position of the step window (B, S, V): the
    speculative verifier needs a target per drafted token. Positions
    >= n_new carry garbage; callers mask them."""
    return gather_vocab(unembed(params["embed"],
                                norm_apply(params["final_norm"], z, cfg),
                                cfg), cfg)


def _paged_attn_forward(params, pages, tokens, lengths, n_new, page_table,
                        rcfg: RunConfig, *, fused: bool = False):
    """Embeds, runs every stacked layer against its page pool (pools
    written in place), returns z (B, S, D). ``fused`` routes each layer's
    attention core through the paged kernel."""
    cfg = rcfg.model
    kind = block_kind(cfg)
    if kind not in ("attn_mlp", "attn_moe"):
        raise NotImplementedError(
            "paged KV decode requires attn_mlp or attn_moe blocks")
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


def paged_verify_step(params, pages, tokens, lengths, n_new, page_table,
                      rcfg: RunConfig, *, fused: bool = False):
    """Speculative-verify forward for the attention family: one call over
    the pending token + k drafted tokens, logits at every position.
    Returns (logits (B, S, V), pages, None).

    KV rollback is host-side length truncation: the k+1 K/V rows are
    written positionally, and rows beyond the accepted length stay masked
    (``kpos > qpos``) until the next wave overwrites them. The trailing
    ``None`` is the artifact slot the snapshot families fill."""
    z = _paged_attn_forward(params, pages, tokens, lengths, n_new,
                            page_table, rcfg, fused=fused)
    return _paged_all_logits(params, z, rcfg.model), pages, None


def init_paged_ssm_cache(rcfg: RunConfig, n_pages: int, *, device=None):
    """State-snapshot page pools for the ssm family's full stacked layer
    stack (open+mid+close)."""
    cfg = rcfg.model
    return ssm_mod.init_paged_ssm_pool(cfg, stacked_layer_depth(rcfg),
                                       n_pages, cfg.ssm.version,
                                       device=device)


def init_paged_hybrid_cache(rcfg: RunConfig, n_pages: int, page_size: int,
                            *, device=None):
    """Hybrid (zamba2) pools: mamba2 state snapshots for every backbone
    layer + KV pages for each interleaved shared-attention position, all
    addressed by the same physical page ids."""
    cfg = rcfg.model
    n_attn = cfg.n_layers // cfg.hybrid_attn_every
    return {
        "mamba": ssm_mod.init_paged_ssm_pool(cfg, cfg.n_layers, n_pages, 2,
                                             device=device),
        "attn": attn_mod.init_paged_kv_cache(cfg, n_attn, n_pages,
                                             page_size, device=device),
    }


def _ssm_paged_forward(params, pools, tokens, lengths, n_new, page_table,
                       rcfg: RunConfig, *, page_size: int,
                       commit: bool = True, fused: bool = False):
    """Embeds and runs every stacked mamba layer against its state pools
    (written in place); returns (z (B, S, D), artifacts). ``fused``
    routes each mixer's recurrence (and commit) through the paged SSM
    kernel. ``commit=False`` leaves the pools untouched and returns every
    layer's snapshot candidates, ``{"xp": [...], "hs": [...]}`` (one
    entry a layer), for :func:`ssm_paged_commit_step`; else artifacts
    is None."""
    cfg = rcfg.model
    kind = block_kind(cfg)
    if kind not in ("mamba1", "mamba2"):
        raise NotImplementedError("ssm paged decode requires mamba blocks")
    mixer = ssm_mod.mamba1_paged_apply if kind == "mamba1" \
        else ssm_mod.mamba2_paged_apply
    layers, gates = _all_layers_stacked(params)
    if len(layers) != pools["h"].shape[0]:
        raise ValueError(f"{len(layers)} layers but the state pools stack "
                         f"{pools['h'].shape[0]}")
    z = embed_tokens(params["embed"], tokens, cfg)
    art = {"xp": [], "hs": []}
    for i, p in enumerate(layers):
        f = mixer(p["mixer"], norm_apply(p["norm"], z, cfg), cfg,
                  conv_pool=pools["conv"][i], h_pool=pools["h"][i],
                  page_table=page_table, lengths=lengths, n_new=n_new,
                  page_size=page_size, commit=commit, fused=fused)
        if not commit:
            f, xp, hs_b = f
            art["xp"].append(xp)
            art["hs"].append(hs_b)
        z = z + gates[i].to(z.dtype) * f
    return z, None if commit else art


def ssm_paged_decode_step(params, pools, tokens, lengths, n_new, page_table,
                          rcfg: RunConfig, *, page_size: int,
                          fused: bool = False):
    """Paged step for the ssm family: the contract of
    :func:`paged_decode_step` with KV pages replaced by state-snapshot
    pages. Padded positions (>= n_new) freeze the recurrent state, so one
    call advances a whole prompt chunk. Returns (last_logits (B, V),
    pools) — the pools updated in place."""
    z, _ = _ssm_paged_forward(params, pools, tokens, lengths, n_new,
                              page_table, rcfg, page_size=page_size,
                              fused=fused)
    return _paged_last_logits(params, z, n_new, rcfg.model), pools


def ssm_paged_verify_step(params, pools, tokens, lengths, n_new, page_table,
                          rcfg: RunConfig, *, page_size: int,
                          fused: bool = False):
    """Speculative-verify forward for the ssm family: advances the masked
    recurrence over the pending + k drafted tokens without touching the
    pools. Returns (logits (B, S, V), pools, artifacts); after acceptance
    :func:`ssm_paged_commit_step` publishes the accepted prefix only (the
    snapshot-page twin of truncating KV lengths: every local step's state
    is a snapshot candidate). ``fused`` runs each layer's recurrence
    through the paged SSM kernel with the every-step write plan."""
    z, art = _ssm_paged_forward(params, pools, tokens, lengths, n_new,
                                page_table, rcfg, page_size=page_size,
                                commit=False, fused=fused)
    return _paged_all_logits(params, z, rcfg.model), pools, art


def ssm_paged_commit_step(pools, art, page_table, lengths, n_write, *,
                          page_size: int):
    """Deferred snapshot commit for every layer of the stack, in place:
    writes the states after exactly ``n_write[b]`` of the verified tokens
    (``accepted + 1``; 0 skips the slot) through
    :func:`repro_torch.models.ssm.paged_pool_commit`. Returns the pools."""
    for i, (xp, hs_b) in enumerate(zip(art["xp"], art["hs"], strict=True)):
        ssm_mod.paged_pool_commit(
            pools["conv"][i], pools["h"][i], xp, hs_b, page_table=page_table,
            lengths=lengths, n_new=n_write, page_size=page_size)
    return pools


def _hybrid_paged_forward(params, state, tokens, lengths, n_new, page_table,
                          rcfg: RunConfig, *, page_size: int,
                          commit: bool = True, fused: bool = False):
    """The mamba2 backbone against its snapshot pools, with the shared
    attention block after every ``hybrid_attn_every`` layers against its
    KV pools (all written in place); returns (z (B, S, D), artifacts).
    ``commit=False`` defers only the backbone's snapshot writes (the
    artifacts, as in :func:`_ssm_paged_forward`); the shared attention
    block writes its KV in line either way (truncation rollback)."""
    cfg = rcfg.model
    k = cfg.hybrid_attn_every
    n_seg, rem = divmod(cfg.n_layers, k)
    S = tokens.shape[1]
    pos = lengths[:, None] + torch.arange(S, device=tokens.device)[None, :]
    rope = rope_freqs(cfg.resolved_head_dim, cfg.rope_theta, pos)
    z = embed_tokens(params["embed"], tokens, cfg)
    backbone = mgrit.slots(params["backbone"])
    mamba, attn = state["mamba"], state["attn"]
    art = {"xp": [], "hs": []}
    li = 0
    for s_i in range(n_seg + (1 if rem else 0)):
        for _ in range(k if s_i < n_seg else rem):
            p = backbone[li]
            f = ssm_mod.mamba2_paged_apply(
                p["mixer"], norm_apply(p["norm"], z, cfg), cfg,
                conv_pool=mamba["conv"][li], h_pool=mamba["h"][li],
                page_table=page_table, lengths=lengths, n_new=n_new,
                page_size=page_size, commit=commit, fused=fused)
            if not commit:
                f, xp, hs_b = f
                art["xp"].append(xp)
                art["hs"].append(hs_b)
            z = z + f
            li += 1
        if s_i < n_seg:
            z = paged_attn_block(
                params["shared_attn"], z, cfg, kind="attn_mlp", rope=rope,
                pk=attn["k"][s_i], pv=attn["v"][s_i], page_table=page_table,
                lengths=lengths, n_new=n_new, fused=fused)
    return z, None if commit else art


def hybrid_paged_decode_step(params, state, tokens, lengths, n_new,
                             page_table, rcfg: RunConfig, *, page_size: int,
                             fused: bool = False):
    """Paged step for the hybrid family: mamba2 backbone layers advance
    state-snapshot pages, the interleaved shared-attention block reads
    and writes its KV pages — one page table, one physical page id space.
    Returns (last_logits (B, V), state) — the pools updated in place."""
    z, _ = _hybrid_paged_forward(params, state, tokens, lengths, n_new,
                                 page_table, rcfg, page_size=page_size,
                                 fused=fused)
    return _paged_last_logits(params, z, n_new, rcfg.model), state


def hybrid_paged_verify_step(params, state, tokens, lengths, n_new,
                             page_table, rcfg: RunConfig, *, page_size: int,
                             fused: bool = False):
    """Speculative-verify forward for the hybrid family: shared-attention
    KV is written in line (length-truncation rollback), the backbone's
    snapshot writes are deferred to :func:`hybrid_paged_commit_step`.
    Returns (logits (B, S, V), state, artifacts)."""
    z, art = _hybrid_paged_forward(params, state, tokens, lengths, n_new,
                                   page_table, rcfg, page_size=page_size,
                                   commit=False, fused=fused)
    return _paged_all_logits(params, z, rcfg.model), state, art


def hybrid_paged_commit_step(state, art, page_table, lengths, n_write, *,
                             page_size: int):
    """Deferred backbone snapshot commit for the hybrid family, in place
    (the verify forward already wrote the attention half)."""
    ssm_paged_commit_step(state["mamba"], art, page_table, lengths, n_write,
                          page_size=page_size)
    return state


# ---------------------------------------------------------------------------
# Coarse-propagator draft model (speculative decoding)
# ---------------------------------------------------------------------------


def coarse_draft_params(params, rcfg: RunConfig, cf: int):
    """The paper's coarse propagator as a zero-parameter draft model: the
    network restricted to every ``cf``-th layer with the ODE step
    rescaled by ``cf`` (:func:`repro_torch.core.mgrit.coarse_restrict`).
    Returns ``(draft_params, draft_rcfg, n_coarse)``.

    - decoder / ssm: the serial stack (open + mid + close with gates) is
      restricted to every ``cf``-th layer, a list of per-layer views (no
      weight is copied); the coarse gate is the sum of the chunk's fine
      gates, so Phi_c(z) = z + (real layers in the chunk) * F(z), and
      fully padded chunks stay identity. ``draft_rcfg`` is ``rcfg``.
    - hybrid: the mamba2 backbone is restricted (strided views) and the
      chunk span scales each coarse layer's ``out_proj`` (the mixer is
      linear in it; those weights alone are new tensors); the shared
      attention block runs at a proportionally coarsened cadence.
      ``draft_rcfg`` carries the coarse ``n_layers`` /
      ``hybrid_attn_every``.

    Embeddings and the final norm are shared by reference."""
    cfg = rcfg.model
    if cf < 1:
        raise ValueError("cf must be >= 1")
    if cfg.family == "hybrid":
        N = cfg.n_layers
        n_coarse = -(-N // cf)
        bb = tree_map(lambda a: a[::cf], params["backbone"])
        op = bb["mixer"]["out_proj"]
        sizes = torch.clamp(N - cf * torch.arange(n_coarse, device=op.device),
                            max=cf)
        bb["mixer"]["out_proj"] = op * sizes.to(op.dtype)[:, None, None]
        hae = min(max(1, cfg.hybrid_attn_every // cf), n_coarse)
        cfg_c = dataclasses.replace(cfg, n_layers=n_coarse,
                                    hybrid_attn_every=hae)
        draft = {"embed": params["embed"],
                 "final_norm": params["final_norm"],
                 "backbone": bb,
                 "shared_attn": params["shared_attn"]}
        return draft, rcfg.replace(model=cfg_c), n_coarse

    layers, gates = _all_layers_stacked(params)
    N = len(layers)
    n_coarse = -(-N // cf)
    gpad = torch.cat([gates, gates.new_zeros(n_coarse * cf - N)])
    draft = {"embed": params["embed"],
             "final_norm": params["final_norm"],
             "mid": {"params": mgrit.coarse_restrict(layers, cf),
                     "gate": gpad.reshape(n_coarse, cf).sum(dim=1)}}
    return draft, rcfg, n_coarse
