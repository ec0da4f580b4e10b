"""Grouped-query attention with RoPE and qk-norm: full-sequence (training)
and over a paged KV cache (serving).

Port of :mod:`repro.models.attention` without its contiguous KV cache and
cross-attention (encoder-decoder models come in a later slice). Layouts are
the reference's: activations (B, S, D), q/k/v after projection
(B, S, H, hd), page pools (L, n_pages, page_size, Hkv, hd).

Not ported: the fused ref-mode "view" path (``paged_view_gather`` /
``paged_view_attention_apply`` / ``paged_kv_commit``). It exists in the
JAX package only to keep the pools out of XLA's layer scan on the CPU;
here the layer loop is Python and :func:`paged_attention_apply` writes
the new K/V rows into the pools in place (where JAX donated them).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models.layers import (apply_rope, dense_init,
                                       preln_output_scale, rms_norm,
                                       torch_dtype)


def init_attention(gen: torch.Generator, cfg: ModelConfig, *, lead=(),
                   device=None):
    d, hd = cfg.d_model, cfg.resolved_head_dim
    h, hkv = cfg.n_heads, cfg.n_kv_heads
    pdt = torch_dtype(cfg.param_dtype)
    oscale = 0.02 * preln_output_scale(cfg.n_layers)
    p = {
        "wq": dense_init(gen, (*lead, d, h, hd), pdt, device=device),
        "wk": dense_init(gen, (*lead, d, hkv, hd), pdt, device=device),
        "wv": dense_init(gen, (*lead, d, hkv, hd), pdt, scale=oscale,
                         device=device),
        "wo": dense_init(gen, (*lead, h, hd, d), pdt, scale=oscale,
                         device=device),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((*lead, hd), dtype=pdt, device=device)
        p["k_norm"] = torch.ones((*lead, hd), dtype=pdt, device=device)
    return p


def _proj(x, w, dt):
    """einsum("bsd,dhk->bshk") as one matmul over the flattened heads."""
    d, h, k = w.shape
    return (x @ w.to(dt).reshape(d, h * k)).unflatten(-1, (h, k))


def _project_qkv(params, x, xa, cfg: ModelConfig):
    dt = torch_dtype(cfg.dtype)
    q = _proj(x, params["wq"], dt)
    src = x if xa is None else xa
    k = _proj(src, params["wk"], dt)
    v = _proj(src, params["wv"], dt)
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"])
        k = rms_norm(k, params["k_norm"])
    return q, k, v


def dot_attention(q, k, v, *, causal: bool, q_offset=0,
                  scale: Optional[float] = None):
    """Reference dense GQA attention.

    q: (B, Sq, H, hd); k, v: (B, Sk, Hkv, hd). ``q_offset`` is the absolute
    position of q[.., 0] for causal masking against a longer k — an int,
    or a (B,) tensor when each batch slot has its own position (paged
    serving, no left-padding).
    """
    B, Sq, H, hd = q.shape
    Hkv = k.shape[2]
    g = H // Hkv
    scale = scale if scale is not None else hd ** -0.5
    qg = q.reshape(B, Sq, Hkv, g, hd)
    logits = torch.einsum("bqhgk,bshk->bhgqs", qg.float(), k.float()) * scale
    if causal:
        Sk = k.shape[1]
        qoff = torch.as_tensor(q_offset, device=q.device)
        qpos = qoff[..., None] + torch.arange(Sq, device=q.device)
        kpos = torch.arange(Sk, device=q.device)
        mask = qpos[..., :, None] >= kpos             # (.., Sq, Sk)
        mask = mask[:, None, None] if mask.ndim == 3 else mask
        logits = torch.where(mask, logits, torch.full_like(logits, -1e30))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqs,bshk->bqhgk", probs.to(v.dtype), v)
    return out.reshape(B, Sq, H, hd)


def chunked_attention(q, k, v, *, causal: bool, q_block: int = 512,
                      k_block: int = 512):
    """Flash-style online-softmax attention in plain PyTorch (a double
    loop over query and key blocks). Memory is O(Sq*Ck + Sk) per head
    instead of O(Sq*Sk). Same shapes as :func:`dot_attention`."""
    B, Sq, H, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    g = H // Hkv
    scale = hd ** -0.5
    q_block = min(q_block, Sq)
    k_block = min(k_block, Sk)
    # fold gqa groups: (B, Hkv, g, Sq, hd)
    qh = q.reshape(B, Sq, Hkv, g, hd).permute(0, 2, 3, 1, 4) * scale
    kh = k.permute(0, 2, 1, 3)                       # (B, Hkv, Sk, hd)
    vh = v.permute(0, 2, 1, 3)
    outs = []
    for q0 in range(0, Sq - Sq % q_block, q_block):
        qi = qh[:, :, :, q0:q0 + q_block].float()
        qpos = q0 + torch.arange(q_block, device=q.device)
        m = torch.full((B, Hkv, g, q_block), -float("inf"),
                       device=q.device)
        l = torch.zeros((B, Hkv, g, q_block), device=q.device)
        acc = torch.zeros((B, Hkv, g, q_block, hd), device=q.device)
        for k0 in range(0, Sk - Sk % k_block, k_block):
            s = torch.einsum("bhgqd,bhkd->bhgqk", qi,
                             kh[:, :, k0:k0 + k_block].float())
            if causal:
                kpos = k0 + torch.arange(k_block, device=q.device)
                mask = qpos[:, None] >= kpos[None, :]
                s = torch.where(mask, s, torch.full_like(s, -1e30))
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhgqk,bhkd->bhgqd", p, vh[:, :, k0:k0 + k_block].float())
            m = m_new
        outs.append((acc / torch.clamp(l[..., None], min=1e-30))
                    .to(v.dtype))
    out = torch.cat(outs, dim=3)                     # (B, Hkv, g, Sq, hd)
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd)


ATTN_CHUNK_THRESHOLD = 8192


def attention_apply(params, x, cfg: ModelConfig, *, causal: bool,
                    rope=None):
    """Self-attention without a cache (training / full-sequence forward).

    x: (B, S, D). rope: precomputed (cos, sin), shared across layers.
    On the card the attention core is the flash kernel
    (:func:`repro_torch.kernels.ops.flash_attention`, the counterpart of
    the reference's ``use_pallas=True``); on the CPU it takes the
    reference's dense / chunked branches. Returns (B, S, D).
    """
    dt = torch_dtype(cfg.dtype)
    x = x.to(dt)
    q, k, v = _project_qkv(params, x, None, cfg)
    if rope is not None:
        cos, sin = rope
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    S = q.shape[1]
    if q.is_cuda:
        out = kops.flash_attention(q, k, v, causal=causal)
    elif S >= (cfg.attn_chunk or ATTN_CHUNK_THRESHOLD) and S % 512 == 0:
        out = chunked_attention(q, k, v, causal=causal)
    else:
        out = dot_attention(q, k, v, causal=causal)
    h, hd, d = params["wo"].shape
    return out.reshape(*out.shape[:2], h * hd) \
        @ params["wo"].to(dt).reshape(h * hd, d)


# ---------------------------------------------------------------------------
# Paged KV cache (serving)
# ---------------------------------------------------------------------------
#
# K/V live in a pool of fixed-size pages shared by all sequences; a
# per-slot page table maps logical page p of slot b to a physical page id
# (repro_torch.serve.kv_pages). Page 0 is a scratch page that absorbs
# writes from padded prompt positions and unoccupied slots, so the step
# needs no data-dependent shapes.


def init_paged_kv_cache(cfg: ModelConfig, n_layers: int, n_pages: int,
                        page_size: int, *, device=None):
    """Page pool stacked over layers: (L, n_pages, page_size, Hkv, hd)."""
    hd = cfg.resolved_head_dim
    dt = torch_dtype(cfg.dtype)
    shape = (n_layers, n_pages, page_size, cfg.n_kv_heads, hd)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def paged_attention_apply(params, x, cfg: ModelConfig, *, rope, pk, pv,
                          page_table, lengths, n_new, fused: bool = False):
    """Self-attention reading/writing one layer's page pool.

    x: (B, S, D) new-token activations. Slot b contributes ``n_new[b] <= S``
    real tokens at absolute positions ``lengths[b] .. lengths[b]+n_new[b]-1``
    (``n_new == 0`` marks an unoccupied slot). rope: (cos, sin) of shape
    (B, S, hd/2) for those positions. pk/pv: (n_pages, page_size, Hkv, hd)
    — **updated in place** with the new K/V rows (the JAX package returns
    new pools and donates the old ones). page_table: (B, P) int; lengths,
    n_new: (B,) int. Returns y (B, S, D).

    Prefix-sharing contract (as in the reference): every page overlapping
    a slot's write range [lengths[b], lengths[b]+n_new[b]) is private to
    that slot; copy-on-write forks happen host-side before the step.

    ``fused=True`` routes the attention core through
    :func:`repro_torch.kernels.ops.paged_attention` (the CUDA kernel on
    the card, its plain version on the CPU) instead of materializing the
    (B, P*page_size, Hkv, hd) dense view. The scatter-write is identical
    in both branches.
    """
    dt = torch_dtype(cfg.dtype)
    x = x.to(dt)
    q, k, v = _project_qkv(params, x, None, cfg)
    cos, sin = rope
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)

    B, S = x.shape[:2]
    n_pages, page_size = pk.shape[0], pk.shape[1]
    P = page_table.shape[1]
    ar = torch.arange(S, device=x.device)
    pos = lengths[:, None] + ar[None, :]                           # (B, S)
    valid = ar[None, :] < n_new[:, None]                           # (B, S)
    slot = torch.clamp(pos // page_size, 0, P - 1)
    phys = torch.gather(page_table, 1, slot)                       # (B, S)
    # invalid writes (prompt padding / idle slots) all land in scratch
    # page 0, which is never read at an unmasked position
    flat = torch.where(valid, phys * page_size + pos % page_size,
                       torch.zeros_like(pos)).reshape(-1).long()
    pk_flat = pk.view(n_pages * page_size, *pk.shape[2:])
    pv_flat = pv.view(n_pages * page_size, *pv.shape[2:])
    pk_flat.index_copy_(0, flat, k.to(pk.dtype).reshape(B * S, *k.shape[2:]))
    pv_flat.index_copy_(0, flat, v.to(pv.dtype).reshape(B * S, *v.shape[2:]))

    if fused:
        out = kops.paged_attention(q, pk, pv, page_table, lengths)
    else:
        # per-slot dense view in logical order: (B, P*page_size, Hkv, hd);
        # garbage beyond a slot's written length has kpos > qpos and masks
        # out under the per-slot causal offset
        gather = (page_table.long()[:, :, None] * page_size
                  + torch.arange(page_size, device=x.device)).reshape(B, -1)
        out = dot_attention(q, pk_flat[gather], pv_flat[gather], causal=True,
                            q_offset=lengths)
    h, hd, d = params["wo"].shape
    return out.reshape(B, S, h * hd) @ params["wo"].to(dt).reshape(h * hd, d)
