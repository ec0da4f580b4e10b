"""Paged flash-decode attention: plain PyTorch version + CUDA kernel.

Port of :mod:`repro.kernels.paged_attention`. Keys live in the serve
engine's page pool (n_pages, page_size, Hkv, hd) and slot b reads its
logical page p from physical page ``page_table[b, p]``.

- :func:`paged_attention_ref` is the plain version: the gathered-view
  computation over however many table columns the caller passes, the
  same contractions, mask constant and casts as the model's
  ``dot_attention`` path, so on the CPU the fused and gathered serve
  paths agree bitwise (the reference's own contract).
- :func:`paged_attention_lse_ref` is the plain version of the route that
  also returns each row's log-sum-exp (float32, (B, S, H)), the weight
  of a partial softmax over one slice of the keys: the dense cache cut
  along the sequence over ranks merges the slices' partials by it.
- :func:`paged_flash_attention` launches ``csrc/paged_attention.cu``
  (which TPU kernel it replaces, what bounds it and its two designs,
  split-KV decode and tensor-core multi-row, are in the source's
  header); :func:`plan` reports which design a shape takes;
  :func:`paged_flash_attention_lse` launches the same kernels with the
  log-sum-exp written too. Both take CUDA tensors only and raise on
  anything else; they never fall back to the plain version.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import torch

from repro_torch.kernels import build

NEG_INF = -1e30
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 32, 64, 128)


def _dot_attention_paged(q, kd, vd, lengths, *, scale=None):
    """Dense GQA attention with per-slot causal offsets — a verbatim twin
    of ``repro_torch.models.attention.dot_attention(..., q_offset=
    lengths)`` (kept here: kernels/ must not depend on models/)."""
    B, Sq, H, hd = q.shape
    Hkv = kd.shape[2]
    g = H // Hkv
    scale = scale if scale is not None else hd ** -0.5
    qg = q.reshape(B, Sq, Hkv, g, hd)
    logits = torch.einsum("bqhgk,bshk->bhgqs", qg.float(), kd.float()) * scale
    Sk = kd.shape[1]
    qpos = lengths[:, None] + torch.arange(Sq, device=q.device)
    kpos = torch.arange(Sk, device=q.device)
    mask = (qpos[:, :, None] >= kpos)[:, None, None]
    logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqs,bshk->bqhgk", probs.to(vd.dtype), vd)
    return out.reshape(B, Sq, H, hd)


def _gathered(pk, pv, page_table):
    """The slots' K and V rows in logical order: (B, P*page_size, Hkv, hd)
    each."""
    B = page_table.shape[0]
    n_pages, page_size = pk.shape[0], pk.shape[1]
    pk_flat = pk.reshape(n_pages * page_size, *pk.shape[2:])
    pv_flat = pv.reshape(n_pages * page_size, *pv.shape[2:])
    gather = (page_table.long()[:, :, None] * page_size
              + torch.arange(page_size, device=pk.device)).reshape(B, -1)
    return pk_flat[gather], pv_flat[gather]


def paged_attention_ref(q, pk, pv, page_table, lengths):
    """Plain version in model layout — q: (B, S, H, hd); pk/pv page pools
    (n_pages, page_size, Hkv, hd); page_table (B, P); lengths (B,).
    Returns (B, S, H, hd) in q's dtype."""
    kd, vd = _gathered(pk, pv, page_table)
    return _dot_attention_paged(q, kd, vd, lengths.long())


def paged_attention_lse_ref(q, pk, pv, page_table, lengths):
    """:func:`paged_attention_ref` and each row's log-sum-exp of its
    scaled, masked float32 logits, (B, S, H) float32; the output is the
    plain version's own, bit for bit. A row that sees no key (``lengths
    + i < 0``: a sequence slice that starts after the query) keeps the
    mask's uniform average as its output, and its lse is -1e30 +
    log(keys), which is -1e30 in float32: merged with any row that sees
    a key it carries zero weight."""
    B, Sq, H, hd = q.shape
    kd, vd = _gathered(pk, pv, page_table)
    Hkv = kd.shape[2]
    qg = q.reshape(B, Sq, Hkv, H // Hkv, hd)
    logits = torch.einsum("bqhgk,bshk->bhgqs", qg.float(),
                          kd.float()) * hd ** -0.5
    qpos = lengths.long()[:, None] + torch.arange(Sq, device=q.device)
    mask = (qpos[:, :, None] >= torch.arange(kd.shape[1], device=q.device)
            )[:, None, None]
    lse = torch.logsumexp(torch.where(mask, logits, torch.full_like(
        logits, NEG_INF)), dim=-1)                      # (B, Hkv, g, Sq)
    out = _dot_attention_paged(q, kd, vd, lengths.long())
    return out, lse.permute(0, 3, 1, 2).reshape(B, Sq, H)


def cost(S, H, Hkv, hd, itemsize, lengths, P):
    """The least work of one call, as (flops, bytes), for slots holding
    ``lengths`` cached tokens each (B = len(lengths)) and a table of P
    columns: 4 x hd flops (q.k and p.v) a visible (query, key) pair and
    head, slot b's row i seeing keys 0 .. lengths[b] + i; bytes q read
    and out written, the K and V rows visible to the slot's last row
    read once, the int32 table and lengths read."""
    B = len(lengths)
    keys = sum(int(n) + S for n in lengths)
    nbytes = (2 * B * S * H * hd * itemsize + 2 * keys * Hkv * hd * itemsize
              + B * P * 4 + B * 4)
    pairs = sum(int(n) * S + S * (S + 1) // 2 for n in lengths)
    return 4 * hd * H * pairs, nbytes


def _lib():
    lib = build.load("paged_attention")
    fn = lib.paged_attention_launch
    if not fn.argtypes:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_longlong]
                       + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p])
        lib.paged_attention_plan.restype = ctypes.c_int
        lib.paged_attention_plan.argtypes = [ctypes.c_int] * 8 + [
            ctypes.POINTER(ctypes.c_longlong)]
    return lib


class Plan(NamedTuple):
    """What the C launcher does for one call shape."""
    split: bool                  # True: split-KV decode, False: multi-row
    grid: Tuple[int, int, int]   # of the main kernel
    workspace: int               # float32 partials the split path needs
    split_keys: int              # keys per split (fixed offsets from 0)


@functools.lru_cache(maxsize=256)
def plan(dtype: torch.dtype, B: int, S: int, H: int, Hkv: int, hd: int,
         page_size: int, P: int) -> Plan:
    """The C launcher's :class:`Plan` for one call shape (the library is
    built on first use)."""
    out = (ctypes.c_longlong * 6)()
    rc = _lib().paged_attention_plan(_DTYPE_CODE[dtype], B, S, H, Hkv, hd,
                                     page_size, P, out)
    build.check(rc, "paged_attention_plan")
    return Plan(bool(out[0]), (out[1], out[2], out[3]), out[4], out[5])


def paged_flash_attention(q, pk, pv, page_table, lengths):
    """The CUDA kernels, same contract as :func:`paged_attention_ref`.
    Every call adds one to ``paged_flash_attention.launches`` (the split
    path's combine kernel is part of the same call)."""
    out, _ = _launch(q, pk, pv, page_table, lengths, False)
    paged_flash_attention.launches += 1
    return out


paged_flash_attention.launches = 0


def paged_flash_attention_lse(q, pk, pv, page_table, lengths):
    """The same kernels with each row's log-sum-exp written too: (out,
    lse (B, S, H) float32), the contract of
    :func:`paged_attention_lse_ref` except that a row that sees no key
    writes out = 0 and lse = -inf. Every call adds one to
    ``paged_flash_attention_lse.launches``."""
    out = _launch(q, pk, pv, page_table, lengths, True)
    paged_flash_attention_lse.launches += 1
    return out


paged_flash_attention_lse.launches = 0


def _launch(q, pk, pv, page_table, lengths, with_lse: bool):
    if not (q.is_cuda and pk.is_cuda and pv.is_cuda and page_table.is_cuda
            and lengths.is_cuda):
        raise ValueError("paged_flash_attention takes CUDA tensors only; "
                         "the plain version is paged_attention_ref")
    B, S, H, hd = q.shape
    n_pages, page_size, Hkv, hd_k = pk.shape
    if q.dtype not in _DTYPE_CODE or pk.dtype != q.dtype \
            or pv.dtype != q.dtype:
        raise ValueError(f"dtypes q={q.dtype} pk={pk.dtype} pv={pv.dtype}: "
                         "need one of float32/bfloat16 for all three")
    if hd not in _HEAD_DIMS or hd_k != hd or pv.shape != pk.shape:
        raise ValueError(f"head dim {hd} (pool {hd_k}) not in {_HEAD_DIMS}"
                         " or pool shapes differ")
    if H % Hkv or not (pk.is_contiguous() and pv.is_contiguous()):
        raise ValueError("need H % Hkv == 0 and contiguous page pools")
    if pk.data_ptr() % 16 or pv.data_ptr() % 16:
        raise ValueError("page pools must start on a 16-byte boundary")
    P = page_table.shape[1]
    if page_table.shape[0] != B or lengths.shape != (B,) or P == 0:
        raise ValueError("page_table must be (B, P>0) and lengths (B,)")
    q = q.contiguous()
    if q.data_ptr() % 16:                 # the kernels read 16-byte rows
        q = q.clone()
    table, lens = (t if t.dtype == torch.int32 and t.is_contiguous()
                   else t.to(torch.int32).contiguous()
                   for t in (page_table, lengths))
    out = torch.empty_like(q)
    lse = q.new_empty((B, S, H), dtype=torch.float32) if with_lse else None
    if B == 0 or S == 0:
        return out, lse
    lib = _lib()
    n_work = plan(q.dtype, B, S, H, Hkv, hd, page_size, P).workspace
    work = q.new_empty(n_work, dtype=torch.float32) if n_work else None
    rc = lib.paged_attention_launch(
        q.data_ptr(), pk.data_ptr(), pv.data_ptr(), table.data_ptr(),
        lens.data_ptr(), out.data_ptr(),
        lse.data_ptr() if lse is not None else None,
        work.data_ptr() if work is not None else None, n_work,
        _DTYPE_CODE[q.dtype], B, S, H, Hkv, hd, page_size, P, hd ** -0.5,
        build.stream_ptr(q))
    build.check(rc, "paged_attention_launch")
    return out, lse
