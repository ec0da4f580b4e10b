"""Grouped-query attention with RoPE and qk-norm: full-sequence self- and
cross-attention (training), over a contiguous KV cache (dense decode,
the serial-forward oracle) and over a paged KV cache (serving).

Port of :mod:`repro.models.attention`. Layouts are the reference's:
activations (B, S, D), q/k/v after projection (B, S, H, hd), the dense
cache (L, B, max_len, Hkv, hd) with a 0-d int32 ``index``, page pools
(L, n_pages, page_size, Hkv, hd).

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
from repro_torch.parallel import tp


def init_attention(gen: torch.Generator, cfg: ModelConfig,
                   cross: bool = False, *, lead=(), device=None):
    """Attention projections; ``cross`` (an encoder-decoder block's
    cross-attention) draws the same leaves, as in the reference."""
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


def _project_qkv(params, x, xa, cfg: ModelConfig, sq=None):
    """q from ``x``, k and v from ``x`` or ``xa``; under a heads split
    ``sq`` column-parallel (:meth:`repro_torch.parallel.tp.Split.column`)."""
    dt = torch_dtype(cfg.dtype)
    src = x if xa is None else xa
    if sq is None:
        q = _proj(x, params["wq"], dt)
        k = _proj(src, params["wk"], dt)
        v = _proj(src, params["wv"], dt)
    else:
        w = {n: params[n].to(dt) for n in ("wq", "wk", "wv")}
        flat = [w[n].reshape(w[n].shape[0], -1) for n in ("wq", "wk", "wv")]
        if xa is None:
            q, k, v = sq.column("tp_attn_in", x, *flat)
        else:
            (q,) = sq.column("tp_attn_in", x, flat[0])
            k, v = sq.column("tp_attn_in", xa, *flat[1:])
        q, k, v = (t.unflatten(-1, w[n].shape[1:])
                   for t, n in zip((q, k, v), ("wq", "wk", "wv")))
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
        qoff = q_offset.to(q.device) if torch.is_tensor(q_offset) else \
            torch.full((), q_offset, dtype=torch.long, device=q.device)
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
                    rope=None, xa=None, cache=None):
    """Self- or cross-attention, over the sequence or over a KV cache.

    x: (B, S, D). rope: precomputed (cos, sin), shared across layers.
    xa: (B, Sk, D) encoder output for cross-attention: K and V are
    projected from it, no rope is applied and no mask either. Without a
    cache the core on the card (and on meta, where the dry-run counts the
    card's work) is the flash kernel
    (:func:`repro_torch.kernels.ops.flash_attention`, the counterpart of
    the reference's ``use_pallas=True``), cross-attention included; on
    the CPU it takes the reference's dense / chunked branches. Returns
    (B, S, D).

    ``cache``: one layer's dense KV cache for autoregressive decode,
    dict(k, v: (B, max_len, Hkv, hd), index: 0-d int tensor) — causal
    self-attention only. The S new K/V rows are written at positions
    ``index .. index+S-1`` **in place** (the reference returns an updated
    copy), and the query rows at those positions attend over the whole
    cache (:func:`_cached_core`). Returns (y, new_cache), new_cache
    holding the same k/v tensors and ``index + S``.

    Under a heads split (:func:`repro_torch.parallel.tp.split`: the dense
    decode step under a mesh, and training under ``tp_sharding``,
    cross-attention included) each rank projects its query heads and the
    KV heads they read, as the paged path does (``wo`` row-parallel; q,
    k and v column-parallel through
    :meth:`repro_torch.parallel.tp.Split.column`, so that a backward sums
    the cotangents of ``x`` and ``xa`` over the ranks; ``wk`` / ``wv``
    stored whole where the KV heads do not divide, each rank reading its
    group's head). Where ``kv_seq`` cuts the cache along the sequence
    (:func:`repro_torch.parallel.tp.seq_split`) the cache holds every KV
    head of this rank's slice of the rows instead: the new K/V rows of
    the heads cut over the ranks are gathered (``kv_seq_kv``), the query
    heads too where their axis also cuts the sequence (``kv_seq_q``),
    each rank attends over its slice with the log-sum-exp route and the
    slices' partials are merged onto the ranks that own each head
    (:func:`repro_torch.parallel.tp.merge_partials`).
    """
    dt = torch_dtype(cfg.dtype)
    x = x.to(dt)
    seq = None if cache is None else tp.seq_split(cache["k"].shape[1],
                                                  local=True)
    if seq is None:
        params, sq = _tp_heads(params, cfg)
    else:
        sq = kv_split(cfg)[0]
    q, k, v = _project_qkv(params, x, xa, cfg, sq)
    if xa is None and rope is not None:
        cos, sin = rope
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    causal = causal and xa is None
    S = q.shape[1]
    new_cache = None
    if cache is not None:
        if not causal:
            raise ValueError("a KV cache takes causal self-attention only")
        if seq is None:
            out = _cached_core(q, k, v, cache)
        else:
            out = _seq_cached_core(q, k, v, cache, cfg, sq, seq)
        new_cache = {"k": cache["k"], "v": cache["v"],
                     "index": cache["index"] + S}
    elif kops.kernel_route(q):
        out = kops.flash_attention(q, k, v, causal=causal)
    elif S >= (cfg.attn_chunk or ATTN_CHUNK_THRESHOLD) \
            and S == k.shape[1] and S % 512 == 0:
        out = chunked_attention(q, k, v, causal=causal)
    else:
        out = dot_attention(q, k, v, causal=causal)
    h, hd, d = params["wo"].shape
    y = tp.row_parallel(sq, "tp_attn", out.reshape(*out.shape[:2], h * hd),
                        params["wo"].to(dt).reshape(h * hd, d))
    return y if cache is None else (y, new_cache)


def _cached_core(q, k, v, cache):
    """Writes the new rows k/v (B, S, Hkv, hd) into the layer's cache at
    ``cache["index"]`` in place, then attends q (B, S, H, hd), whose row i
    sits at position index + i, over the whole cache. The write start is
    clamped to ``max_len - S``, as ``jax.lax.dynamic_update_slice``
    clamps it; nothing reads ``index`` on the host.

    On the CPU the core is the reference's ``dot_attention(q, cache,
    q_offset=index)``. On the card (and on meta) it is the paged
    attention kernel
    (:func:`repro_torch.kernels.ops.paged_attention`) over the cache seen
    as a pool of B pages of ``max_len`` rows, slot b reading page b
    (``page_table = arange(B)[:, None]``, ``lengths = index`` for every
    slot): the kernel resolves each row's page itself, so one page of any
    length is a valid table, and its masking is ``dot_attention``'s."""
    ck, cv, idx = cache["k"], cache["v"], cache["index"]
    B, S = q.shape[:2]
    start = torch.clamp(idx, max=ck.shape[1] - S)
    rows = (start + torch.arange(S, device=ck.device)).long()
    ck.index_copy_(1, rows, k.to(ck.dtype))
    cv.index_copy_(1, rows, v.to(cv.dtype))
    if not kops.kernel_route(q):
        return dot_attention(q, ck, cv, causal=True, q_offset=idx)
    table = torch.arange(B, dtype=torch.int32, device=q.device)[:, None]
    return kops.paged_attention(q, ck, cv, table,
                                idx.to(torch.int32).expand(B))


def _seq_cached_core(q, k, v, cache, cfg: ModelConfig, sq, seq):
    """:func:`_cached_core` over this rank's slice of the cache's rows
    (``seq``, a :class:`repro_torch.parallel.tp.SeqSplit`), which holds
    every KV head. q: this rank's query heads (``sq`` their split or
    None); k, v: its KV heads where ``sq`` cuts them, else all of them.
    Returns this rank's query heads' attention over the whole
    sequence."""
    if sq is not None and tp.split("kv_heads", cfg.n_kv_heads):
        kv = sq.all_gather("kv_seq_kv", torch.cat([k, v], dim=-1), 2)
        k, v = kv.chunk(2, dim=-1)
    if sq is not None and sq.axis in seq.axes:
        q = sq.all_gather("kv_seq_q", q, 2)
    ck, cv, idx = cache["k"], cache["v"], cache["index"]
    B, S = q.shape[:2]
    L = ck.shape[1]
    W = min(S, L)
    # the global write clamp first (dynamic_update_slice's), then the W
    # local rows of the window that holds this rank's share of the new
    # rows; rows of the window outside it keep their contents, so every
    # index written is distinct and nothing reads ``index`` on the host
    lo = torch.clamp(idx, max=L * seq.n - S) - seq.offset
    rows = torch.clamp(lo, 0, L - W) + torch.arange(W, device=ck.device)
    src = rows - lo
    take = ((src >= 0) & (src < S))[None, :, None, None]
    src = torch.clamp(src, 0, S - 1)
    for c, new in ((ck, k), (cv, v)):
        c.index_copy_(1, rows, torch.where(take, new.to(c.dtype)[:, src],
                                           c[:, rows]))
    table = torch.arange(B, dtype=torch.int32, device=q.device)[:, None]
    local = (idx - seq.offset).to(torch.int32).expand(B)
    out, lse = kops.paged_attention(q, ck, cv, table, local, return_lse=True)
    return tp.merge_partials(out, lse, sq, seq)


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, n_layers: int,
                  *, device=None):
    """Stacked-over-layers dense KV cache: k/v (L, B, max_len, Hkv, hd) in
    ``cfg.dtype`` and a 0-d int32 ``index``, all on ``device``. Under
    :func:`repro_torch.parallel.tp.active` this rank's part: its slots
    where ``batch`` cuts them, and its slice of the rows with every KV
    head where ``kv_seq`` cuts the sequence, else the KV heads its query
    heads read (:func:`kv_split`)."""
    hd = cfg.resolved_head_dim
    dt = torch_dtype(cfg.dtype)
    seq = tp.seq_split(max_len)
    kv = None if seq is not None else kv_split(cfg)[1]
    shape = (n_layers, tp.local_rows(batch), seq.size if seq else max_len,
             kv[1] - kv[0] if kv else cfg.n_kv_heads, hd)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device),
            "index": torch.zeros((), dtype=torch.int32, device=device)}


# ---------------------------------------------------------------------------
# Paged KV cache (serving)
# ---------------------------------------------------------------------------
#
# K/V live in a pool of fixed-size pages shared by all sequences; a
# per-slot page table maps logical page p of slot b to a physical page id
# (repro_torch.serve.kv_pages). Page 0 is a scratch page that absorbs
# writes from padded prompt positions and unoccupied slots, so the step
# needs no data-dependent shapes.


def kv_split(cfg: ModelConfig):
    """(the split of the query heads, the KV heads this rank stores)
    under :func:`repro_torch.parallel.tp.active`, else (None, None).
    Each rank runs its own query heads and the KV heads they read: its
    share where the KV heads divide over the ranks (``wk`` / ``wv`` are
    stored cut), else the one KV head its query heads' GQA group reads
    (the reference's spec drops the mapping, so ``wk`` / ``wv`` are
    stored whole): a range ``(lo, hi)``."""
    sq = tp.split("heads", cfg.n_heads)
    if sq is None:
        return None, None
    Hkv, n = cfg.n_kv_heads, sq.n
    if Hkv % n and n % Hkv:
        raise NotImplementedError(
            f"{cfg.n_heads} query heads over {n} ranks read {Hkv} KV heads "
            "unevenly: neither divides the other")
    lo = sq.r * Hkv // n
    return sq, (lo, lo + max(Hkv // n, 1))


def narrow_kv_split(cfg: ModelConfig):
    """Under :func:`repro_torch.parallel.tp.active`: the split of the
    query heads where each rank's KV holds only the one KV head its query
    heads read (:func:`kv_split`'s MQA case, the spec keeping the KV
    heads whole), else None."""
    sq, _ = kv_split(cfg)
    if sq is not None and not tp.split("kv_heads", cfg.n_kv_heads):
        return sq
    return None


def gather_narrow_kv(mesh, kind: str, t: torch.Tensor, sq,
                     n_kv_heads: int) -> torch.Tensor:
    """Every KV head of ``t`` (heads on dim 3), from ranks that each hold
    the one KV head of their query heads (:func:`narrow_kv_split`'s
    ``sq``): one all-gather over ``sq``'s axis, head h taken from the
    first rank of its group."""
    got = mesh.all_gather(kind, t, sq.axis, dim=3)
    return got[:, :, :, [h * sq.n // n_kv_heads for h in range(n_kv_heads)]]


def init_paged_kv_cache(cfg: ModelConfig, n_layers: int, n_pages: int,
                        page_size: int, *, device=None):
    """Page pool stacked over layers: (L, n_pages, page_size, Hkv, hd);
    under :func:`repro_torch.parallel.tp.active` this rank's KV heads."""
    hd = cfg.resolved_head_dim
    dt = torch_dtype(cfg.dtype)
    kv = kv_split(cfg)[1]
    hkv = kv[1] - kv[0] if kv else cfg.n_kv_heads
    shape = (n_layers, n_pages, page_size, hkv, hd)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def _tp_heads(params, cfg: ModelConfig):
    """(this rank's attention weights, the query-head split) under
    :func:`repro_torch.parallel.tp.active` (``wk`` / ``wv`` stored whole
    narrowed to the KV head this rank reads); the weights themselves and
    None outside it."""
    sq, kv = kv_split(cfg)
    if sq is None or tp.split("kv_heads", cfg.n_kv_heads):   # stored cut
        return params, sq
    return dict(params, **{name: params[name][..., kv[0]:kv[1], :]
                           for name in ("wk", "wv")}), sq


def last_scratch_writer(flat):
    """The source row each write of ``index_copy_(0, flat, rows)`` takes,
    where only flat row 0 (the scratch page's first row) has several
    writers: each of those takes the last of them in (slot, position)
    order, every other write its own row. Which of several writes to one
    row lands is undefined on CUDA, and a padded query can read the
    scratch row (a MoE capacity count then sees it); with the same bytes
    from every writer the row holds the last writer's, as the
    reference's scatter leaves it, on both devices and in every run. On
    the device, no host sync."""
    idx = torch.arange(flat.shape[0], device=flat.device)
    scratch = flat == 0
    last = torch.where(scratch, idx, -1).amax()
    return torch.where(scratch, last, idx)


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

    Under :func:`repro_torch.parallel.tp.active` each rank projects and
    attends its own query heads and the KV heads they read (``wq`` /
    ``wk`` / ``wv`` column-parallel, its pools holding those KV heads;
    :func:`kv_split`) and ``wo`` is row-parallel, the partial outputs
    summed over the ranks in float32.
    """
    dt = torch_dtype(cfg.dtype)
    x = x.to(dt)
    params, sq = _tp_heads(params, cfg)
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
    src = last_scratch_writer(flat)
    pk_flat.index_copy_(0, flat,
                        k.to(pk.dtype).reshape(B * S, *k.shape[2:])[src])
    pv_flat.index_copy_(0, flat,
                        v.to(pv.dtype).reshape(B * S, *v.shape[2:])[src])

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
    return tp.row_parallel(sq, "tp_attn", out.reshape(B, S, h * hd),
                           params["wo"].to(dt).reshape(h * hd, d))
