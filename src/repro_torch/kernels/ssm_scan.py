"""Selective scan (Mamba): plain PyTorch version + CUDA kernels, forward
and backward.

Port of :mod:`repro.kernels.ssm_scan` (``ssm_scan``), whose oracle is
``repro.kernels.ref.ssm_scan_ref``: over t, with h starting at zero,

    h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) (outer) B_t
    y_t = h_t . C_t + D * x_t

in float32, y cast to x's dtype. dt/x: (Bb, S, di); A: (di, ds); B/C:
(Bb, S, ds); D: (di,).

- :func:`ssm_scan_ref` is the plain version; on the CPU its gradient is
  torch autograd's. :func:`ssm_scan_fwd_ref` is the plain twin of the
  forward kernel's whole output (y and the stored states).
- :func:`ssm_scan` runs ``csrc/ssm_scan.cu`` through :class:`SSMScan`, a
  ``torch.autograd.Function`` whose forward and backward are both
  kernels (which TPU kernel it replaces, what bounds it and its design
  are in the source's header). It takes float32 CUDA tensors only and
  raises on anything else; it never falls back to the plain version. A
  may be a broadcast view (mamba2's per-head decay): the kernels take its
  strides. Any S >= 1 (the TPU kernel needs its chunk to divide S).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.paged_ssm import _STATE_DIMS

CHUNK = 64              # steps between the forward's stored states
TILE = 256              # rows per partial of the backward's gB/gC sums


def ssm_scan_ref(dt, x, A, B, C, D):
    """Plain version, any float dtypes (math in float32). Returns y
    (Bb, S, di) in x's dtype."""
    dt32, x32, A32 = dt.float(), x.float(), A.float()
    B32, C32, D32 = B.float(), C.float(), D.float()
    Bb, S, di = x.shape
    h = torch.zeros((Bb, di, A.shape[1]), dtype=torch.float32,
                    device=x.device)
    ys = []
    for t in range(S):
        dt_t, x_t = dt32[:, t], x32[:, t]
        dA = torch.exp(dt_t[:, :, None] * A32[None])
        h = dA * h + (dt_t * x_t)[:, :, None] * B32[:, t, None, :]
        ys.append(torch.sum(h * C32[:, t, None, :], dim=-1)
                  + D32[None] * x_t)
    return torch.stack(ys, dim=1).to(x.dtype)


def ssm_scan_fwd_ref(dt, x, A, B, C, D):
    """Plain version of :func:`ssm_scan_fwd`, the recurrence of
    :func:`ssm_scan_ref` step for step: (y (Bb, S, di) float32, the state
    before every CHUNK steps (Bb, ceil(S/CHUNK), ds, di) float32)."""
    dt32, x32, A32 = dt.float(), x.float(), A.float()
    B32, C32, D32 = B.float(), C.float(), D.float()
    Bb, S, di = x.shape
    h = torch.zeros((Bb, di, A.shape[1]), dtype=torch.float32,
                    device=x.device)
    ys, hc = [], []
    for t in range(S):
        if t % CHUNK == 0:
            hc.append(h.transpose(1, 2))
        dt_t, x_t = dt32[:, t], x32[:, t]
        dA = torch.exp(dt_t[:, :, None] * A32[None])
        h = dA * h + (dt_t * x_t)[:, :, None] * B32[:, t, None, :]
        ys.append(torch.sum(h * C32[:, t, None, :], dim=-1)
                  + D32[None] * x_t)
    return torch.stack(ys, dim=1), torch.stack(hc, dim=1)


def cost(Bb, S, di, ds, *, n_ch=None, n_decay=None, backward=False):
    """The least work of one call, as (float32 operations, bytes), with
    dt, A and D (and their cotangents) counted at their distinct values
    where the caller knows them: ``n_ch`` dt and D values a step (default
    di; one per head for mamba2's rows), ``n_decay`` A values (default
    di x ds). Bytes: forward dt, x, B, C, A and D read, y written;
    backward those inputs and gy read, the six cotangents written.
    Operations per state element and step: 5 (forward: the update's
    multiply-add and term, the readout's multiply-add) or 18 (backward,
    the chunk's recompute included), plus 2 (dt*A and its exp) per A
    value and step. The checkpoints the design stores are not counted."""
    n_ch = di if n_ch is None else n_ch
    n_decay = di * ds if n_decay is None else n_decay
    x, dt, bc = Bb * S * di * 4, Bb * S * n_ch * 4, 2 * Bb * S * ds * 4
    ins = dt + x + bc + n_decay * 4 + n_ch * 4
    if backward:
        return Bb * S * (18 * di * ds + 2 * n_decay), 2 * ins + x
    return Bb * S * (5 * di * ds + 2 * n_decay), ins + x


_P, _L, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_ARGTYPES = {
    "ssm_scan_chunk": [],
    "ssm_scan_tile": [],
    # dt, x, A, A's strides, B, C, D, y, hc, Bb, S, di, ds, stream
    "ssm_scan_fwd_launch": [_P] * 3 + [_L] * 2 + [_P] * 5 + [_I] * 4 + [_P],
    # dt, x, A, A's strides, B, C, D, hc, gy, the six cotangents, the
    # four scratch buffers (carries, dt sums, gB/gC and gD partials), Bb,
    # S, di, ds, stream
    "ssm_scan_bwd_launch": [_P] * 3 + [_L] * 2 + [_P] * 15 + [_I] * 4
    + [_P],
}


def _fn(name):
    fn = getattr(build.load("ssm_scan"), name)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = _ARGTYPES[name]
    return fn


def _check(dt, x, A, B, C, D, **more):
    named = {"dt": dt, "x": x, "A": A, "B": B, "C": C, "D": D, **more}
    if not all(t.is_cuda for t in named.values()):
        raise ValueError("the ssm_scan kernels take CUDA tensors only; the "
                         "plain version is ssm_scan_ref")
    for name, t in named.items():
        if t.dtype != torch.float32:
            raise ValueError(f"{name}: dtype {t.dtype}, the ssm_scan "
                             "kernels take float32")
    if x.ndim != 3 or A.ndim != 2:
        raise ValueError(f"need x (Bb, S, di) and A (di, ds), got "
                         f"{tuple(x.shape)} and {tuple(A.shape)}")
    Bb, S, di = x.shape
    ds = A.shape[1]
    if min(Bb, S, di) == 0:
        raise ValueError(f"empty input x {tuple(x.shape)}")
    want = {"dt": (Bb, S, di), "A": (di, ds), "B": (Bb, S, ds),
            "C": (Bb, S, ds), "D": (di,)}
    for name, shape in want.items():
        if tuple(named[name].shape) != shape:
            raise ValueError(f"{name}: shape {tuple(named[name].shape)} != "
                             f"{shape}")
    if ds not in _STATE_DIMS:
        raise ValueError(f"d_state {ds} not in {_STATE_DIMS}")
    if (_fn("ssm_scan_chunk")(), _fn("ssm_scan_tile")()) != (CHUNK, TILE):
        raise RuntimeError("csrc/ssm_scan.cu and kernels/ssm_scan.py "
                           "disagree on the checkpoint chunk or row tile")
    return Bb, S, di, ds


def ssm_scan_fwd(dt, x, A, B, C, D):
    """Forward kernel: returns (y (Bb, S, di) float32, the state before
    every CHUNK steps (Bb, ceil(S/CHUNK), ds, di) float32 for the
    backward). Adds one to ``ssm_scan_fwd.launches``."""
    Bb, S, di, ds = _check(dt, x, A, B, C, D)
    dt, x, B, C, D = (t.contiguous() for t in (dt, x, B, C, D))
    y = torch.empty_like(x)
    hc = torch.empty((Bb, -(-S // CHUNK), ds, di), dtype=torch.float32,
                     device=x.device)
    rc = _fn("ssm_scan_fwd_launch")(
        dt.data_ptr(), x.data_ptr(), A.data_ptr(), A.stride(0), A.stride(1),
        B.data_ptr(), C.data_ptr(), D.data_ptr(), y.data_ptr(),
        hc.data_ptr(), Bb, S, di, ds, build.stream_ptr(x))
    build.check(rc, "ssm_scan_fwd_launch")
    ssm_scan_fwd.launches += 1
    return y, hc


def ssm_scan_bwd(dt, x, A, B, C, D, hc, gy):
    """Backward kernels (chunk-parallel: carries, their scan, then every
    chunk from its stored state): the cotangents (gdt, gx, gA, gB, gC,
    gD) of (dt, x, A, B, C, D), all float32 and contiguous (gA dense (di,
    ds) even when A is a broadcast view), each cross-row or cross-chunk
    sum taken in a fixed order. Adds one to ``ssm_scan_bwd.launches``."""
    Bb, S, di, ds = _check(dt, x, A, B, C, D, hc=hc, gy=gy)
    if tuple(gy.shape) != (Bb, S, di) or \
            tuple(hc.shape) != (Bb, -(-S // CHUNK), ds, di):
        raise ValueError(f"gy {tuple(gy.shape)} / checkpoints "
                         f"{tuple(hc.shape)} do not fit x {tuple(x.shape)}")
    dt, x, B, C, D, hc, gy = (t.contiguous()
                              for t in (dt, x, B, C, D, hc, gy))
    dev = x.device

    def empty(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)
    gdt, gx = empty(Bb, S, di), empty(Bb, S, di)
    gA, gB, gC, gD = empty(di, ds), empty(Bb, S, ds), empty(Bb, S, ds), \
        empty(di)
    n_c, n_t = -(-S // CHUNK), -(-di // TILE)
    scratch = (empty(Bb, n_c, di, ds), empty(Bb, n_c, di),
               empty(Bb, S, n_t, 2 * ds), empty(Bb, n_c, di))
    rc = _fn("ssm_scan_bwd_launch")(
        dt.data_ptr(), x.data_ptr(), A.data_ptr(), A.stride(0), A.stride(1),
        B.data_ptr(), C.data_ptr(), D.data_ptr(), hc.data_ptr(),
        gy.data_ptr(), gdt.data_ptr(), gx.data_ptr(), gB.data_ptr(),
        gC.data_ptr(), gA.data_ptr(), gD.data_ptr(),
        *(t.data_ptr() for t in scratch), Bb, S, di, ds, build.stream_ptr(x))
    build.check(rc, "ssm_scan_bwd_launch")
    ssm_scan_bwd.launches += 1
    return gdt, gx, gA, gB, gC, gD


ssm_scan_fwd.launches = 0
ssm_scan_bwd.launches = 0


class SSMScan(torch.autograd.Function):
    """(dt, x, A, B, C, D) -> y; backward through the kernels."""

    @staticmethod
    def forward(ctx, dt, x, A, B, C, D):
        y, hc = ssm_scan_fwd(dt, x, A, B, C, D)
        ctx.save_for_backward(dt, x, A, B, C, D, hc)
        return y

    @staticmethod
    def backward(ctx, gy):
        return ssm_scan_bwd(*ctx.saved_tensors, gy)


def ssm_scan(dt, x, A, B, C, D):
    """The kernel path, same contract as :func:`ssm_scan_ref` for float32
    CUDA tensors. Without a gradient to take, autograd keeps no context
    and the checkpoints are freed at once."""
    return SSMScan.apply(dt, x, A, B, C, D)
