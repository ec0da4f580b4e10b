"""Paged SSM update (decode and chunked prefill): plain PyTorch version +
CUDA kernel.

Port of :mod:`repro.kernels.paged_ssm`. Serving keeps SSM state as
snapshot *pages*: page p of a slot holds the recurrent state after
exactly (p+1)*page_size tokens. One call advances the masked recurrence

    h_t = exp(dt_t * A) * h_{t-1} + term_t,   y_t = h_t . C_t

over S new tokens per slot (state frozen at steps >= n_new[b]), reads
the initial state from pool page ``read_page[b]`` (zero where ``live[b]``
is false) and writes the state after local step ``t_w[b, w]`` into pool
page ``phys_w[b, w]`` — the compact write plan of
``repro_torch.models.ssm.compact_snapshot_steps``.

Rows layout: both mamba versions are R independent rows over a shared
(B, S, ds) B/C stream. Mamba1 maps rows to the d_inner channels with
term ``(dt * B) * x`` (``order="dbx"``); mamba2 flattens (heads, headdim)
to rows with per-head dt and A tiled across headdim and term
``(dt * x) * B`` (``order="dxb"``). The orders are not interchangeable:
float products do not associate bit for bit, and on the CPU the fused
path must reproduce the gathered scan's exact product order.

- :func:`paged_ssm_update_ref` is the plain version, copied from the
  reference operation for operation (the ``order`` grouping, the
  frozen-state ``where``, the frozen readout at padded positions), so on
  the CPU the fused serve path is bitwise its gathered path.
- :func:`paged_ssm_update` launches ``csrc/paged_ssm.cu`` (which TPU
  kernel it replaces, what bounds it and its design are in the source's
  header). It takes CUDA tensors only and raises on anything else; it
  never falls back to the plain version.

Both update ``h_pool`` **in place** — the port's counterpart of the
Pallas call's ``input_output_aliases={10: 1}`` — and return y only.
Scratch page 0 (where unwritten windows point) holds unspecified
contents afterwards; it is never read as state.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

ORDERS = ("dbx", "dxb")
_STATE_DIMS = (4, 8, 16, 32, 64)     # d_state widths the kernel is built for


def max_write_pages(seq_len: int, page_size: int) -> int:
    """Most snapshot pages S consecutive tokens can finalize, over every
    possible start offset within a page: ceil((page_size-1 + S)/page_size)."""
    return (seq_len + page_size - 2) // page_size + 1


def paged_ssm_update_ref(dt, x, Bm, Cm, A, h_pool, read_page, live,
                         phys_w, t_w, n_new, *, order: str):
    """Plain version. dt/x: (B, S, R) float32; Bm/Cm: (B, S, ds) float32;
    A: (R, ds) float32 (any strides); h_pool: (N, R, ds) float32, updated
    in place. read_page/live/n_new: (B,); phys_w/t_w: (B, W). Returns
    y (B, S, R) float32."""
    if order not in ORDERS:
        raise ValueError(f"order {order!r} not in {ORDERS}")
    B, S, R = dt.shape
    h0 = h_pool[read_page.long()]
    h = torch.where(live.bool()[:, None, None], h0, torch.zeros_like(h0))
    valid = torch.arange(S, device=dt.device)[None, :] < n_new[:, None]
    hs, ys = [], []
    for t in range(S):
        dt_t, x_t, b_t, c_t = dt[:, t], x[:, t], Bm[:, t], Cm[:, t]
        dA = torch.exp(dt_t[:, :, None] * A[None])
        if order == "dbx":
            term = dt_t[:, :, None] * b_t[:, None, :] * x_t[:, :, None]
        else:
            term = (dt_t * x_t)[:, :, None] * b_t[:, None, :]
        h2 = dA * h + term
        h = torch.where(valid[:, t, None, None], h2, h)
        ys.append(torch.einsum("brs,bs->br", h, c_t))
        hs.append(h)
    y = torch.stack(ys, dim=1)                                 # (B, S, R)
    hs_b = torch.stack(hs, dim=1)                              # (B, S, R, ds)
    snaps = hs_b[torch.arange(B, device=dt.device)[:, None], t_w.long()]
    h_pool[phys_w.long().reshape(-1)] = snaps.reshape(
        (-1,) + snaps.shape[2:]).to(h_pool.dtype)
    return y


def cost(order, S, R, ds, W, n_new, live, written):
    """The least work of one call, as (float32 operations, bytes), for B
    = len(n_new) slots, ``live`` of them reading a state page and
    ``written`` snapshot pages written (of the plan's B x W): 7
    operations (exp included) a state element and active step (slot b's
    first min(S, n_new[b]) steps); bytes dt and x at the active steps, y
    (B, S, R), B and C, A's distinct values (the decay a row for
    mamba2's "dxb"), the state pages read and written, and the plan
    (read page, live, n_new and the two (B, W) tables, int32)."""
    B = len(n_new)
    steps = sum(min(S, int(n)) for n in n_new)
    a_bytes = R * ds * 4 if order == "dbx" else R * 4
    nbytes = (2 * steps * R * 4 + B * S * R * 4 + 2 * B * S * ds * 4
              + a_bytes + (live + written) * R * ds * 4 + B * (3 + 2 * W) * 4)
    return 7 * steps * R * ds, nbytes


def _lib():
    fn = build.load("paged_ssm").paged_ssm_launch
    if not fn.argtypes:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 2
                       + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
                       + [ctypes.c_void_p])
    return fn


def paged_ssm_update(dt, x, Bm, Cm, A, h_pool, read_page, live, phys_w,
                     t_w, n_new, *, order: str):
    """The CUDA kernel, same contract as :func:`paged_ssm_update_ref`:
    ``h_pool`` is updated in place, y (B, S, R) float32 is returned. A
    may be a broadcast view (its two strides are passed to the kernel);
    dt, x, Bm, Cm and h_pool must be contiguous float32 and h_pool 16-byte
    aligned. Outputs at padded steps (>= n_new[b]) are the frozen-state
    readout, as in the plain version; callers read step n_new-1 only.
    Every launch adds one to ``paged_ssm_update.launches``."""
    args = (dt, x, Bm, Cm, A, h_pool, read_page, live, phys_w, t_w, n_new)
    if not all(t.is_cuda for t in args):
        raise ValueError("paged_ssm_update takes CUDA tensors only; the "
                         "plain version is paged_ssm_update_ref")
    if order not in ORDERS:
        raise ValueError(f"order {order!r} not in {ORDERS}")
    if dt.ndim != 3 or h_pool.ndim != 3:
        raise ValueError(f"need dt (B, S, R) and h_pool (N, R, ds), got "
                         f"{tuple(dt.shape)} and {tuple(h_pool.shape)}")
    B, S, R = dt.shape
    N, R_pool, ds = h_pool.shape
    W = phys_w.shape[-1] if phys_w.ndim == 2 else -1
    want = {"x": (x, (B, S, R)), "Bm": (Bm, (B, S, ds)),
            "Cm": (Cm, (B, S, ds)), "A": (A, (R, ds)),
            "read_page": (read_page, (B,)), "live": (live, (B,)),
            "n_new": (n_new, (B,)), "phys_w": (phys_w, (B, W)),
            "t_w": (t_w, (B, W))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)} != {shape}")
    if R_pool != R:
        raise ValueError(f"h_pool rows {R_pool} != dt rows {R}")
    floats = {"dt": dt, "x": x, "Bm": Bm, "Cm": Cm, "A": A,
              "h_pool": h_pool}
    for name, t in floats.items():
        if t.dtype != torch.float32:
            raise ValueError(f"{name}: dtype {t.dtype}, need float32")
        if name != "A" and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous (h_pool is "
                             "updated in place, so it is never copied)")
    if ds not in _STATE_DIMS:
        raise ValueError(f"d_state {ds} not in {_STATE_DIMS}")
    if h_pool.data_ptr() % 16:
        raise ValueError("h_pool must be 16-byte aligned (float4 stores)")
    ints = [t.to(torch.int32).contiguous()
            for t in (read_page, live, phys_w, t_w, n_new)]
    y = torch.empty((B, S, R), dtype=torch.float32, device=dt.device)
    if B == 0 or S == 0 or R == 0:
        return y
    rc = _lib()(dt.data_ptr(), x.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
                A.data_ptr(), A.stride(0), A.stride(1), h_pool.data_ptr(),
                *(t.data_ptr() for t in ints), y.data_ptr(),
                ORDERS.index(order), B, S, R, ds, W,
                build.stream_ptr(dt))
    build.check(rc, "paged_ssm_launch")
    paged_ssm_update.launches += 1
    return y


paged_ssm_update.launches = 0
