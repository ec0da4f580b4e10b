"""Mamba1 (falcon-mamba) and Mamba2 (zamba2 backbone) mixers: dense
(training) and against the paged state pool (serving).

Port of :mod:`repro.models.ssm`. The dense mixers ``mamba{1,2}_apply``
run the whole sequence through :func:`repro_torch.kernels.ops.ssm_scan`
(the selective-scan kernel on the card, its plain version on the CPU;
the JAX package runs the same recurrence as a ``lax.scan``). Given a
dense cache (conv window + h per slot, the decode oracle's) they advance
the recurrence through :func:`repro_torch.kernels.ops.paged_ssm_update`
instead (:func:`_cached_scan`). The serve engine
treats SSM decode state like paged KV: a pool of fixed-size pages
managed by the refcounted allocator. A page here is a per-slot state
*snapshot* — page p of a slot holds the (conv window, h) state after
exactly (p+1)*page_size tokens. A step reads the state of position
``lengths`` from page (lengths-1)//page_size and writes the advanced
state into page lengths//page_size, so crossing a page boundary leaves
the completed page holding its boundary snapshot, which the prefix trie
publishes. Page 0 is the scratch page: writes from idle slots and padded
positions land there, and reads at position 0 are masked to the zero
state.

The pools are updated **in place** (the JAX package returns new pools
and donates the old ones), so in commit mode the mixers return their
output only. The deferred mode (``commit=False``, speculative
verification) leaves the pools untouched and returns ``(out, xp, hs_b)``:
every local step's state is a snapshot candidate, and
:func:`paged_pool_commit` later publishes the accepted prefix. The
reference's ``state_in`` view path is not ported (the port writes pools
in place).

``fused=True`` runs the recurrence through
:func:`repro_torch.kernels.ops.paged_ssm_update` (the CUDA kernel on the
card, its plain version on the CPU): in commit mode from the *compact*
plan, which also commits the snapshots; in deferred mode from the
every-step plan of :func:`every_step_update`, which stores each step's
state in a scratch buffer instead of the pool. The gathered path runs
the masked scan here and commits every (slot, table-column) pair. On the
CPU the two give bitwise-equal outputs, artifacts and non-scratch pool
pages.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.kernels.paged_ssm import max_write_pages
from repro_torch.models.layers import dense_init, torch_dtype
from repro_torch.parallel import params as pparams
from repro_torch.parallel import tp


def _dt_rank(cfg: ModelConfig) -> int:
    return cfg.ssm.dt_rank or int(math.ceil(cfg.d_model / 16))


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def init_mamba1(gen: torch.Generator, cfg: ModelConfig, *, lead=(),
                device=None):
    """Mamba1 mixer params (the JAX init's shapes and scales)."""
    s = cfg.ssm
    d = cfg.d_model
    di = s.expand * d
    dtr = _dt_rank(cfg)
    pdt = torch_dtype(cfg.param_dtype)
    u = torch.rand((*lead, di), generator=gen, dtype=torch.float32,
                   device=device)
    A = torch.arange(1, s.d_state + 1, dtype=torch.float32,
                     device=device).expand(*lead, di, s.d_state)
    return {
        "in_proj": dense_init(gen, (*lead, d, 2 * di), pdt, device=device),
        "conv_w": dense_init(gen, (*lead, s.d_conv, di), pdt, scale=0.1,
                             device=device),
        "conv_b": torch.zeros((*lead, di), dtype=pdt, device=device),
        "x_proj": dense_init(gen, (*lead, di, dtr + 2 * s.d_state), pdt,
                             device=device),
        "dt_proj": dense_init(gen, (*lead, dtr, di), pdt, scale=dtr ** -0.5,
                              device=device),
        "dt_bias": torch.log(torch.expm1(
            torch.clamp(u * 0.1 + 1e-3, min=1e-4))).to(pdt),
        "A_log": torch.log(A).to(pdt),
        "D": torch.ones((*lead, di), dtype=pdt, device=device),
        "out_proj": dense_init(gen, (*lead, di, d), pdt, device=device),
    }


def init_mamba2(gen: torch.Generator, cfg: ModelConfig, *, lead=(),
                device=None):
    """Mamba2 mixer params (the JAX init's shapes and scales)."""
    s = cfg.ssm
    d = cfg.d_model
    di = s.expand * d
    nh = di // s.headdim
    pdt = torch_dtype(cfg.param_dtype)
    A = torch.arange(1, nh + 1, dtype=torch.float32,
                     device=device).expand(*lead, nh)
    return {
        "in_proj": dense_init(gen, (*lead, d, 2 * di + 2 * s.d_state + nh),
                              pdt, device=device),
        "conv_w": dense_init(gen, (*lead, s.d_conv, di + 2 * s.d_state),
                             pdt, scale=0.1, device=device),
        "conv_b": torch.zeros((*lead, di + 2 * s.d_state), dtype=pdt,
                              device=device),
        "dt_bias": torch.zeros((*lead, nh), dtype=pdt, device=device),
        "A_log": torch.log(A).to(pdt),
        "D": torch.ones((*lead, nh), dtype=pdt, device=device),
        "norm_scale": torch.ones((*lead, di), dtype=pdt, device=device),
        "out_proj": dense_init(gen, (*lead, di, d), pdt, device=device),
    }


# ---------------------------------------------------------------------------
# Paged recurrent state
# ---------------------------------------------------------------------------


def inner_split(cfg: ModelConfig):
    """The split of a Mamba mixer's rows under
    :func:`repro_torch.parallel.tp.active` (over the axis ``mlp`` maps
    to): mamba1's di, mamba2's heads; None where they do not divide."""
    s = cfg.ssm
    di = s.expand * cfg.d_model
    unit = di if pparams.mamba_version(cfg) == 1 else di // s.headdim
    return tp.split("mlp", unit)


def _own(v, sp, blocks: tp.Blocks):
    """This rank's part of a mamba2 mixer vector laid out in ``blocks``:
    cut here where it is stored whole (training's spec keeps the per-row
    vectors whole), as stored where serving's layout cut it (any other
    length raises)."""
    if sp is None:
        return v
    full = sum(size for size, _ in blocks)
    if v.shape[-1] == full:
        return tp.slice_blocks(v, -1, blocks, sp.n, sp.r)
    if v.shape[-1] != tp.local_size(blocks, sp.n):
        raise ValueError(f"a mixer vector of {v.shape[-1]}: neither whole "
                         f"({full}) nor this rank's part of {sp.n}")
    return v


def init_paged_ssm_pool(cfg: ModelConfig, n_layers: int, n_pages: int,
                        version: int, *, device=None):
    """State-snapshot page pool stacked over layers (page axis 1, like
    the paged KV layout, so one copy-on-write covers every backend);
    under :func:`repro_torch.parallel.tp.active` this rank's rows (conv
    channels ``[x | B C]`` for mamba2, B and C whole)."""
    s = cfg.ssm
    di = s.expand * cfg.d_model
    dt = torch_dtype(cfg.dtype)
    sp = inner_split(cfg)
    n = sp.n if sp else 1
    ci = tp.local_size(pparams.mamba_blocks(cfg, "conv"), n)
    if version == 1:
        return {
            "conv": torch.zeros((n_layers, n_pages, s.d_conv - 1, ci),
                                dtype=dt, device=device),
            "h": torch.zeros((n_layers, n_pages, di // n, s.d_state),
                             dtype=torch.float32, device=device),
        }
    nh = di // s.headdim
    return {
        "conv": torch.zeros((n_layers, n_pages, s.d_conv - 1, ci), dtype=dt,
                            device=device),
        "h": torch.zeros((n_layers, n_pages, nh // n, s.headdim, s.d_state),
                         dtype=torch.float32, device=device),
    }


def paged_read_plan(page_table, lengths, page_size: int):
    """(read_page (B,), live (B,) bool): the pool page holding the state
    after ``lengths`` tokens, and whether there is any (position 0 reads
    the zero state)."""
    P = page_table.shape[1]
    slot = torch.clamp((lengths.long() - 1) // page_size, 0, P - 1)
    prev = torch.gather(page_table.long(), 1, slot[:, None])[:, 0]
    return prev, lengths > 0


def paged_state_read(pool, page_table, lengths, page_size: int):
    """Per-slot incoming state (zeros for slots at position 0). pool:
    (n_pages, ...); page_table: (B, P); lengths: (B,). Returns (B, ...),
    a copy."""
    prev, live = paged_read_plan(page_table, lengths, page_size)
    init = pool[prev]
    live = live.reshape((-1,) + (1,) * (init.ndim - 1))
    return torch.where(live, init, torch.zeros_like(init))


def snapshot_steps(page_table, lengths, n_new, page_size: int):
    """Which pages this call finalizes, and at which local step: for slot
    b processing positions lengths[b] .. lengths[b]+n_new[b]-1, page-slot
    p receives its final write at local step ``min((p+1)*page_size-1,
    last_pos) - lengths`` iff p overlaps the written range. Returns (t
    (B, P), phys (B, P)) with unwritten entries routed to scratch page 0.
    """
    B, P = page_table.shape
    lengths, n_new = lengths.long(), n_new.long()
    last = lengths + n_new - 1
    p = torch.arange(P, device=page_table.device)[None, :]
    t = torch.minimum((p + 1) * page_size - 1, last[:, None]) \
        - lengths[:, None]
    written = (n_new[:, None] > 0) & (p >= (lengths // page_size)[:, None]) \
        & (p <= (last // page_size)[:, None])
    phys = torch.where(written, page_table.long(), torch.zeros_like(t))
    return torch.clamp(t, min=0), phys


def compact_snapshot_steps(page_table, lengths, n_new, page_size: int,
                           seq_len: int):
    """Compact twin of :func:`snapshot_steps` for the fused path: the
    same (t, phys) contract restricted to the W = ``max_write_pages(
    seq_len, page_size)`` table slots a call can finalize,
    ``lengths//page_size ..``. Every real page the full plan writes is
    covered with an identical step, so pools committed through either
    plan agree everywhere except scratch page 0."""
    W = max_write_pages(seq_len, page_size)
    B, P = page_table.shape
    lengths, n_new = lengths.long(), n_new.long()
    last = lengths + n_new - 1
    wslot = (lengths // page_size)[:, None] \
        + torch.arange(W, device=page_table.device)[None, :]
    written = (n_new[:, None] > 0) & (wslot <= (last // page_size)[:, None]) \
        & (wslot < P)
    phys = torch.where(written, torch.gather(
        page_table.long(), 1, torch.clamp(wslot, 0, P - 1)),
        torch.zeros_like(wslot))
    t = torch.minimum((wslot + 1) * page_size - 1, last[:, None]) \
        - lengths[:, None]
    return torch.clamp(t, min=0), phys


def paged_state_write(pool, snaps, phys):
    """Scatter per-(slot, page) snapshots into the pool in place. snaps:
    (B, P, ...) aligned with ``phys``. Duplicate writes to scratch page 0
    land in unspecified order; page 0 is never read as state."""
    B, P = phys.shape
    flat = snaps.reshape((B * P,) + snaps.shape[2:]).to(pool.dtype)
    pool[phys.reshape(-1)] = flat


def _gather_windows(xp, t, K: int):
    """Conv-window snapshots: the window after local step t is
    xp[:, t+1 : t+K] (xp = [init window | new inputs], (B, S+K-1, C));
    t: (B, P). Returns (B, P, K-1, C)."""
    B = xp.shape[0]
    idx = t[:, :, None] + torch.arange(1, K, device=xp.device)[None, None, :]
    return xp[torch.arange(B, device=xp.device)[:, None, None], idx]


def paged_pool_commit(conv_pool, h_pool, xp, hs_b, *, page_table, lengths,
                      n_new, page_size: int):
    """Publish one layer's snapshots for the first ``n_new[b]`` tokens
    through the full (B, P) plan, in place. ``xp``: the padded conv input
    (B, S+K-1, C); ``hs_b``: every local step's state (B, S, ...)."""
    K = conv_pool.shape[-2] + 1
    t, phys = snapshot_steps(page_table, lengths, n_new, page_size)
    B = phys.shape[0]
    h_snap = hs_b[torch.arange(B, device=hs_b.device)[:, None], t]
    paged_state_write(h_pool, h_snap, phys)
    paged_state_write(conv_pool, _gather_windows(xp, t, K), phys)


def every_step_update(dt, x, Bm, Cm, A, h_rows, page_table, lengths, n_new,
                      page_size: int, *, order: str):
    """The deferred (verify) mode of the fused path: one
    ``ops.paged_ssm_update`` call whose write plan stores *every* local
    step, ``t_w = arange(S)``, into a scratch buffer of B x (S+1) pages
    instead of the pool. Page ``b*(S+1)`` of the buffer is seeded with
    slot b's incoming state and is its read page; pages ``b*(S+1)+1+t``
    receive the state after step t. h_rows: (n_pages, R, ds), read only.
    Returns (y (B, S, R) float32, hs_b (B, S, R, ds), a view of the
    buffer)."""
    B, S, R = dt.shape
    ds = h_rows.shape[-1]
    dev = dt.device
    read_page, live = paged_read_plan(page_table, lengths, page_size)
    buf = torch.empty((B * (S + 1), R, ds), dtype=h_rows.dtype, device=dev)
    seed = torch.arange(B, device=dev) * (S + 1)
    buf.index_copy_(0, seed, h_rows[read_page])
    steps = torch.arange(S, device=dev)
    y = kops.paged_ssm_update(dt, x, Bm, Cm, A, buf, seed, live,
                              seed[:, None] + 1 + steps[None, :],
                              steps[None, :].expand(B, S), n_new,
                              order=order)
    return y, buf.view(B, S + 1, R, ds)[:, 1:]


# ---------------------------------------------------------------------------
# Dense mixers (training, and decode over a dense cache)
# ---------------------------------------------------------------------------

def _conv_sum(xp, w, S: int):
    """sum_i xp[:, i:i+S] * w[i]: the depthwise causal conv over a
    left-padded input xp (B, S+K-1, C); w: (K, C)."""
    return sum(xp[:, i:i + S, :] * w[i][None, None, :]
               for i in range(w.shape[0]))


def _causal_conv(x, w, b, conv_cache=None):
    """Depthwise causal conv. x: (B, S, C), w: (K, C), b: (C,). History:
    zeros, or ``conv_cache`` (B, K-1, C), the last K-1 inputs, which is
    then overwritten in place with the window after these S inputs."""
    K = w.shape[0]
    if conv_cache is None:
        xp = F.pad(x, (0, 0, K - 1, 0))
    else:
        xp = torch.cat([conv_cache, x], dim=1)
        if K > 1:
            conv_cache.copy_(xp[:, -(K - 1):])
    return _conv_sum(xp, w, x.shape[1]) + b[None, None, :]


def _cached_scan(dt, x, Bm, Cm, A, h, *, order: str):
    """The recurrence over S steps from the dense state h (B, R, ds)
    float32, rows layout, written back into h in place; returns y (B, S,
    R) float32 without the D skip. It is one
    :func:`repro_torch.kernels.ops.paged_ssm_update` call over h seen as
    a pool of pages, slot b reading and rewriting its own page (the
    state after its last step): on the card the paged SSM kernel (the
    decode kernel at S = 1; reading and writing one page is safe in
    place, see ``csrc/paged_ssm.cu``), on the CPU its plain version, the
    reference's recurrence in the same product ``order``. The kernel
    never writes pool page 0, the paged pools' scratch page, so the pool
    starts one page before h and the slots are its pages 1..B: h must be
    contiguous with a page of storage before it, as every layer of
    :func:`init_mamba1_cache` / :func:`init_mamba2_cache` is; that page
    is neither read nor written."""
    B, S = dt.shape[:2]
    dev = dt.device
    page = h[0].numel()
    if h.storage_offset() < page or not h.is_contiguous():
        raise ValueError("a dense SSM state must be contiguous with a page "
                         "of storage before it (init_mamba1_cache / "
                         "init_mamba2_cache allocate one)")
    pool = h.as_strided((B + 1, *h.shape[1:]), (page, *h.stride()[1:]),
                        h.storage_offset() - page)
    slots = torch.arange(1, B + 1, device=dev)
    return kops.paged_ssm_update(
        dt.contiguous(), x.contiguous(), Bm.contiguous(), Cm.contiguous(),
        A, pool, slots, torch.ones_like(slots), slots[:, None],
        torch.full((B, 1), S - 1, dtype=torch.long, device=dev),
        torch.full((B,), S, dtype=torch.long, device=dev), order=order)


def _dense_state(shape, device):
    """Zeros of ``shape`` (L, B, ...) float32 starting one page (a slot's
    state) into their storage, so that every layer's slots have the page
    of storage before them that :func:`_cached_scan` takes on the card."""
    page = math.prod(shape[2:])
    flat = torch.zeros(page + math.prod(shape), dtype=torch.float32,
                       device=device)
    return flat[page:].view(shape)


def _local_inner(cfg: ModelConfig, batch: int):
    """(this rank's slots, conv channels, rows under
    :func:`repro_torch.parallel.tp.active`: mamba1's di, mamba2's heads)
    of a dense decode state; all of them outside it."""
    s = cfg.ssm
    di = s.expand * cfg.d_model
    sp = inner_split(cfg)
    n = sp.n if sp else 1
    rows = di if pparams.mamba_version(cfg) == 1 else di // s.headdim
    return (tp.local_rows(batch),
            tp.local_size(pparams.mamba_blocks(cfg, "conv"), n), rows // n)


def init_mamba1_cache(cfg: ModelConfig, batch: int, n_layers: int, *,
                      device=None):
    """Dense decode state stacked over layers: conv (L, B, K-1, di) in
    ``cfg.dtype``, h (L, B, di, d_state) float32 (one spare page of
    storage before it, :func:`_dense_state`); under
    :func:`repro_torch.parallel.tp.active` this rank's slots and rows."""
    s = cfg.ssm
    b, ci, di = _local_inner(cfg, batch)
    return {
        "conv": torch.zeros((n_layers, b, s.d_conv - 1, ci),
                            dtype=torch_dtype(cfg.dtype), device=device),
        "h": _dense_state((n_layers, b, di, s.d_state), device),
    }


def init_mamba2_cache(cfg: ModelConfig, batch: int, n_layers: int, *,
                      device=None):
    """Mamba2's dense decode state: conv (L, B, K-1, di + 2 d_state) in
    ``cfg.dtype``, h (L, B, heads, headdim, d_state) float32 (one spare
    page of storage before it); under
    :func:`repro_torch.parallel.tp.active` this rank's slots, conv
    channels ``[x | B C]`` and heads."""
    s = cfg.ssm
    b, ci, nh = _local_inner(cfg, batch)
    return {
        "conv": torch.zeros((n_layers, b, s.d_conv - 1, ci),
                            dtype=torch_dtype(cfg.dtype), device=device),
        "h": _dense_state((n_layers, b, nh, s.headdim, s.d_state),
                          device),
    }


def mamba1_apply(params, x, cfg: ModelConfig, cache=None):
    """Mamba1 mixer. x: (B, S, D) -> (B, S, D).

    Without a cache: the whole sequence through the scan, which adds
    ``D * xc`` in float32 and rounds once; the reference rounds the scan
    to ``cfg.dtype`` first (ulps in float32). With ``cache`` = one
    layer's {"conv": (B, K-1, di), "h": (B, di, d_state)} (both updated
    in place) the recurrence continues from it (:func:`_cached_scan`,
    order "dbx") and, as in the reference and the paged mixer, rounds
    before adding ``D * xc`` in ``cfg.dtype``; returns (out, cache).

    Under :func:`repro_torch.parallel.tp.active` (the dense decode step
    under a mesh) each rank runs its di rows as the paged mixer does:
    ``x_proj`` and ``out_proj`` row-parallel. That split is serving's
    layout: no training rules split a mamba1 mixer, and it raises under a
    gradient."""
    s = cfg.ssm
    dt_ = torch_dtype(cfg.dtype)
    x = x.to(dt_)
    dtr = _dt_rank(cfg)
    sp = inner_split(cfg)
    if sp is not None and torch.is_grad_enabled() and x.requires_grad:
        raise NotImplementedError(
            "a mamba1 mixer's rows cut over tensor-parallel ranks is a "
            "serving layout: no training rules map its mlp to an axis")

    xin, z = (x @ params["in_proj"].to(dt_)).chunk(2, dim=-1)
    xc = F.silu(_causal_conv(xin, params["conv_w"].to(dt_),
                             params["conv_b"].to(dt_),
                             None if cache is None else cache["conv"]))
    dtr_v, Bm, Cm = torch.split(
        tp.row_parallel(sp, "tp_ssm_dbc", xc, params["x_proj"].to(dt_)),
        [dtr, s.d_state, s.d_state], dim=-1)
    dt = F.softplus(dtr_v @ params["dt_proj"].to(dt_)
                    + params["dt_bias"].to(dt_))
    A = -torch.exp(params["A_log"].float())
    if cache is None:
        y = kops.ssm_scan(dt.float(), xc.float(), A, Bm.float(), Cm.float(),
                          params["D"].float()).to(dt_)
    else:
        y = _cached_scan(dt.float(), xc.float(), Bm.float(), Cm.float(), A,
                         cache["h"], order="dbx").to(dt_)
        y = y + params["D"].to(dt_)[None, None, :] * xc
    y = y * F.silu(z)
    out = tp.row_parallel(sp, "tp_ssm_out", y, params["out_proj"].to(dt_))
    return out if cache is None else (out, cache)


def mamba2_apply(params, x, cfg: ModelConfig, cache=None):
    """Mamba2 mixer. x: (B, S, D) -> (B, S, D).

    The scan runs in rows layout, as the paged kernel does: rows = heads
    x headdim, the per-head dt and D repeated across headdim and the
    per-head decay a stride-0 (rows, d_state) view; autograd sums the
    repeated cotangents back to each head. The gated RMSNorm goes
    through ``ops.rmsnorm`` (the same function). With ``cache`` = one
    layer's {"conv": (B, K-1, di + 2 d_state), "h": (B, heads, headdim,
    d_state)} (both updated in place) the recurrence continues from it
    (:func:`_cached_scan` over h viewed as rows, order "dxb"); returns
    (out, cache). Under an inner split (:func:`inner_split`: the dense
    decode step under a mesh, or zamba2's training under ``tp_sharding``)
    each rank runs its heads as :func:`mamba2_paged_apply` does,
    ``in_proj`` column-parallel
    (:meth:`repro_torch.parallel.tp.Split.column`); B and C come whole
    from the whole block of ``in_proj`` and the conv on every rank, and
    the per-head ``dt_bias``, ``A_log`` and ``D`` (and ``conv_b``),
    stored whole in training, are cut here."""
    s = cfg.ssm
    dt_ = torch_dtype(cfg.dtype)
    x = x.to(dt_)
    B, S = x.shape[:2]
    sp = inner_split(cfg)
    di = s.expand * x.shape[-1] // (sp.n if sp else 1)
    nh = di // s.headdim
    heads = tp.even(s.expand * x.shape[-1] // s.headdim)

    w_in = params["in_proj"].to(dt_)
    z, xbc, dt = torch.split(
        x @ w_in if sp is None else sp.column("tp_ssm_in", x, w_in)[0],
        [di, di + 2 * s.d_state, nh], dim=-1)
    xbc = F.silu(_causal_conv(xbc, params["conv_w"].to(dt_),
                              _own(params["conv_b"], sp, pparams.mamba_blocks(
                                  cfg, "conv")).to(dt_),
                              None if cache is None else cache["conv"]))
    xin, Bm, Cm = torch.split(xbc, [di, s.d_state, s.d_state], dim=-1)
    dt = F.softplus(dt.float() + _own(params["dt_bias"], sp,
                                      heads).float())        # (B, S, nh)
    A = -torch.exp(_own(params["A_log"], sp, heads).float())  # (nh,)
    D = _own(params["D"], sp, heads).float()
    dt_rows = dt.repeat_interleave(s.headdim, dim=-1)
    A_rows = A.repeat_interleave(s.headdim)[:, None].expand(di, s.d_state)
    if cache is None:
        y = kops.ssm_scan(
            dt_rows, xin.float(), A_rows, Bm.float(), Cm.float(),
            D.repeat_interleave(s.headdim), heads=nh).to(dt_)
    else:
        xh = xin.reshape(B, S, nh, s.headdim).float()
        ys = _cached_scan(dt_rows, xin.float(), Bm.float(), Cm.float(),
                          A_rows, cache["h"].view(B, di, s.d_state),
                          order="dxb").reshape(B, S, nh, s.headdim)
        y = ys + D[None, None, :, None] * xh
        y = y.reshape(B, S, di).to(dt_)
    y = y * F.silu(z)
    out = _gated_norm_out(params, y, sp, di, dt_)
    return out if cache is None else (out, cache)


def _gated_norm_out(params, y, sp, di: int, dt_):
    """Mamba2's gated RMSNorm (over the whole di: under a split the rows
    are gathered, normed whole on every rank, and each rank keeps its
    own columns; in a backward each rank gets its columns of the
    cotangent summed over the ranks) and ``out_proj`` (row-parallel
    under a split)."""
    if sp is None:
        y = kops.rmsnorm(y, params["norm_scale"])             # gated RMSNorm
    else:
        y = kops.rmsnorm(sp.all_gather("tp_ssm_norm", y, -1),
                         params["norm_scale"])[..., sp.r * di:(sp.r + 1) * di]
    return tp.row_parallel(sp, "tp_ssm_out", y, params["out_proj"].to(dt_))


# ---------------------------------------------------------------------------
# Paged mixers (serving)
# ---------------------------------------------------------------------------


def _conv_window(params, xin, conv_pool, page_table, lengths, page_size,
                 dt_):
    """Depthwise causal conv over [stored window | new inputs]. Returns
    (silu(conv + bias) (B, S, C), xp (B, S+K-1, C))."""
    win0 = paged_state_read(conv_pool, page_table, lengths, page_size)
    xp = torch.cat([win0.to(dt_), xin], dim=1)
    xc = _conv_sum(xp, params["conv_w"].to(dt_), xin.shape[1])
    return F.silu(xc + params["conv_b"].to(dt_)[None, None, :]), xp


def _commit_conv_fused(conv_pool, xp, t_w, phys_w):
    K = conv_pool.shape[-2] + 1
    paged_state_write(conv_pool, _gather_windows(xp, t_w, K), phys_w)


def mamba1_paged_apply(params, x, cfg: ModelConfig, *, conv_pool, h_pool,
                       page_table, lengths, n_new, page_size: int,
                       commit: bool = True, fused: bool = False):
    """One layer's mamba1 mixer against the paged state pool.

    x: (B, S, D) normed block input; slot b contributes ``n_new[b] <= S``
    real tokens from absolute position ``lengths[b]`` (0 = idle slot, its
    state untouched). conv_pool: (n_pages, K-1, di); h_pool: (n_pages,
    di, d_state) — both written in place. Returns the mixer output
    (B, S, D); rows at padded positions are garbage (the caller reads
    position n_new-1 only).

    ``commit=False`` (speculative verification) leaves both pools
    untouched and returns ``(out, xp, hs_b)``: the padded conv input and
    every local step's state (B, S, di, d_state), for
    :func:`paged_pool_commit` to publish an accepted prefix later.

    Under :func:`repro_torch.parallel.tp.active` each rank runs its di
    rows (``params`` this rank's part: ``in_proj`` cut ``[x | z]``, the
    row-indexed leaves to its rows, ``dt_proj`` to its columns):
    ``x_proj``'s partial products are summed over the ranks before the
    split into dt, B and C, ``out_proj`` is row-parallel.
    """
    s = cfg.ssm
    dt_ = torch_dtype(cfg.dtype)
    x = x.to(dt_)
    B, S, D = x.shape
    dtr = _dt_rank(cfg)
    sp = inner_split(cfg)

    xz = x @ params["in_proj"].to(dt_)
    xin, z = xz.chunk(2, dim=-1)
    xc, xp = _conv_window(params, xin, conv_pool, page_table, lengths,
                          page_size, dt_)

    dbc = tp.row_parallel(sp, "tp_ssm_dbc", xc,
                          params["x_proj"].to(dt_))   # contracts over di
    dtr_v, Bm, Cm = torch.split(dbc, [dtr, s.d_state, s.d_state], dim=-1)
    dt = F.softplus(dtr_v @ params["dt_proj"].to(dt_)
                    + params["dt_bias"].to(dt_))
    A = -torch.exp(params["A_log"].float())

    dt32, xc32 = dt.float(), xc.float()
    B32, C32 = Bm.float(), Cm.float()

    if fused and commit:
        t_w, phys_w = compact_snapshot_steps(page_table, lengths, n_new,
                                             page_size, S)
        read_page, live = paged_read_plan(page_table, lengths, page_size)
        ys = kops.paged_ssm_update(
            dt32.contiguous(), xc32.contiguous(), B32.contiguous(),
            C32.contiguous(), A, h_pool, read_page, live, phys_w, t_w,
            n_new, order="dbx")
        y = ys.to(dt_)
    elif fused:
        ys, hs_b = every_step_update(
            dt32.contiguous(), xc32.contiguous(), B32.contiguous(),
            C32.contiguous(), A, h_pool, page_table, lengths, n_new,
            page_size, order="dbx")
        y = ys.to(dt_)
    else:
        valid = torch.arange(S, device=x.device)[None, :] < n_new[:, None]
        h = paged_state_read(h_pool, page_table, lengths, page_size)
        hs, ys = [], []
        for t in range(S):
            dt_t, x_t, b_t, c_t = dt32[:, t], xc32[:, t], B32[:, t], C32[:, t]
            dA = torch.exp(dt_t[:, :, None] * A[None])
            h2 = dA * h + dt_t[:, :, None] * b_t[:, None, :] \
                * x_t[:, :, None]
            h = torch.where(valid[:, t, None, None], h2, h)  # frozen state
            ys.append(torch.einsum("bes,bs->be", h, c_t))
            hs.append(h)
        y = torch.stack(ys, dim=1).to(dt_)
        hs_b = torch.stack(hs, dim=1)
    y = y + params["D"].to(dt_)[None, None, :] * xc
    y = y * F.silu(z)
    out = tp.row_parallel(sp, "tp_ssm_out", y, params["out_proj"].to(dt_))

    if not commit:
        return out, xp, hs_b
    if fused:
        _commit_conv_fused(conv_pool, xp, t_w, phys_w)
    else:
        paged_pool_commit(conv_pool, h_pool, xp, hs_b, page_table=page_table,
                          lengths=lengths, n_new=n_new, page_size=page_size)
    return out


def mamba2_paged_apply(params, x, cfg: ModelConfig, *, conv_pool, h_pool,
                       page_table, lengths, n_new, page_size: int,
                       commit: bool = True, fused: bool = False):
    """Mamba2 twin of :func:`mamba1_paged_apply` (same pool contract,
    ``commit=False`` included; the conv runs over the concatenated x/B/C
    channels, h is per head: (n_pages, nh, headdim, d_state)).

    The fused path flattens (heads, headdim) to the kernel's rows axis:
    per-head dt repeats across headdim and A is a stride-0 broadcast of
    the per-head decay (the kernel takes A's strides), the h pool is
    viewed as (n_pages, R, d_state) — a view, so the kernel's in-place
    update lands in the pool — and the product order is ``"dxb"``.

    The gated RMSNorm is the RMSNorm kernel's function (eps 1e-6, float32
    reduction, cast back), so it goes through ``ops.rmsnorm``.
    """
    s = cfg.ssm
    dt_ = torch_dtype(cfg.dtype)
    x = x.to(dt_)
    B, S, D = x.shape
    sp = inner_split(cfg)
    # this rank's inner width and heads (all of them on one rank)
    di = s.expand * D // (sp.n if sp else 1)
    nh = di // s.headdim

    proj = x @ params["in_proj"].to(dt_)
    z, xbc, dt = torch.split(proj, [di, di + 2 * s.d_state, nh], dim=-1)
    xbc, xp = _conv_window(params, xbc, conv_pool, page_table, lengths,
                           page_size, dt_)
    xin, Bm, Cm = torch.split(xbc, [di, s.d_state, s.d_state], dim=-1)
    dt = F.softplus(dt.float() + params["dt_bias"].float())   # (B, S, nh)
    A = -torch.exp(params["A_log"].float())                   # (nh,)

    xh = xin.reshape(B, S, nh, s.headdim).float()
    B32, C32 = Bm.float(), Cm.float()

    if fused:
        R = nh * s.headdim
        A_rows = A.repeat_interleave(s.headdim)[:, None].expand(
            R, s.d_state)
        h_rows = h_pool.view(-1, R, s.d_state)
        rows = (dt.repeat_interleave(s.headdim, dim=-1).contiguous(),
                xh.reshape(B, S, R).contiguous(), B32.contiguous(),
                C32.contiguous(), A_rows)
        if commit:
            t_w, phys_w = compact_snapshot_steps(page_table, lengths, n_new,
                                                 page_size, S)
            read_page, live = paged_read_plan(page_table, lengths,
                                              page_size)
            ys = kops.paged_ssm_update(*rows, h_rows, read_page, live,
                                       phys_w, t_w, n_new, order="dxb")
        else:
            ys, hs_b = every_step_update(*rows, h_rows, page_table, lengths,
                                         n_new, page_size, order="dxb")
            hs_b = hs_b.reshape(B, S, *h_pool.shape[1:])
        y = ys.reshape(B, S, nh, s.headdim)
    else:
        valid = torch.arange(S, device=x.device)[None, :] < n_new[:, None]
        h = paged_state_read(h_pool, page_table, lengths, page_size)
        hs, ys = [], []
        for t in range(S):
            dt_t, x_t, b_t, c_t = dt[:, t], xh[:, t], B32[:, t], C32[:, t]
            dA = torch.exp(dt_t * A[None])
            h2 = dA[:, :, None, None] * h \
                + (dt_t[:, :, None] * x_t)[..., None] * b_t[:, None, None, :]
            h = torch.where(valid[:, t, None, None, None], h2, h)
            ys.append(torch.einsum("bhes,bs->bhe", h, c_t))
            hs.append(h)
        y = torch.stack(ys, dim=1)
        hs_b = torch.stack(hs, dim=1)
    y = y + params["D"].float()[None, None, :, None] * xh
    y = y.reshape(B, S, di).to(dt_)
    y = y * F.silu(z)
    out = _gated_norm_out(params, y, sp, di, dt_)

    if not commit:
        return out, xp, hs_b
    if fused:
        _commit_conv_fused(conv_pool, xp, t_w, phys_w)
    else:
        paged_pool_commit(conv_pool, h_pool, xp, hs_b, page_table=page_table,
                          lengths=lengths, n_new=n_new, page_size=page_size)
    return out
