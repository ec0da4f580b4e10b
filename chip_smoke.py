#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA card (H100 class).

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc`` with
``nvcc`` for ``sm_90a``, counts the wgmma (HGMMA), mma.sync (HMMA) and
TMA-load (UTMALDG) instructions of every flash-attention and
paged-attention kernel in its SASS (the bf16 flash kernels must hold
wgmma and TMA loads, the bf16 multi-row paged kernel tensor-core
products, no float32 paged kernel any), and holds each kernel against
its plain PyTorch version:
paged attention at qwen3_1p7b's and zamba2_1p2b's head shapes (also
bitwise: a live-bucket table against a wider one, a second launch), the
sampling mask, the paged SSM update at falcon_mamba_7b's and
zamba2_1p2b's full-width rows (both product orders), the training
kernels forward and backward, in float32 and bf16, at the training and
serve shapes, and the selective scan forward and backward at
falcon_mamba_7b's and zamba2_1p2b's full-width rows, with a
bit-repeatability check of every backward. Then it drives the port's
paths, each with the launch counters set to 0 just before and read just
after: it serves ``qwen3_1p7b``, then ``falcon_mamba_7b`` and
``zamba2_1p2b``, each at full width and full depth (random weights from
a seed) through ``ServeEngine``, compares one fused step with the
gathered plain path and profiles a decode wave; it checks the training
gradients at full width and reduced depth (kernel path vs plain path vs
direct autograd), then trains full-width, full-depth ``qwen3_1p7b`` for
three MGRIT steps through ``Trainer.train`` (adaptive probe at step 2)
and profiles one MGRIT and one serial step. It checks the SSM training
gradients the same way at reduced depth, then trains full-width
``falcon_mamba_7b`` at 26 layers (MGRIT, probe at step 2; full depth
does not fit one card) and full-width, full-depth ``zamba2_1p2b``
(serial) for three steps each, profiling one step of each mode.
Before serving (phase 2b) it times each training kernel beside its
plain version, a library yardstick where one PyTorch call computes the
same function, and its bound (the RMSNorm and scan kernels with their
device times too), and holds the flash kernels and the scan backward
against the plain version at the training shapes (qwen3_1p7b's and
zamba2_1p2b's attention, falcon_mamba_7b's and zamba2_1p2b's scan rows
at S=4096, each timed); the serve kernels are timed after serving
qwen3_1p7b. Imports ``repro_torch``, torch and numpy only. Exits non-zero, before printing any result, when
no CUDA device is available or the repository's ``src`` is missing;
exits non-zero on any mismatch.
The last line is ``{"ok": true, "device": {...}}``; the lines before it
are the launch counts, the card's name and power limit, and one JSON
object with every kernel's numbers.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

PEAK_BYTES_S = 3.35e12          # H100 SXM HBM3
PEAK_BF16_FLOP_S = 989e12       # H100 SXM dense bf16 tensor cores
ATTN_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
SAMPLING_TV = 1e-5              # mass of tokens the two masks disagree on
STEP_F32_TOL = 1e-3             # fused vs gathered f32 logits / max |logit|
STEP_BF16_FACTOR = 2.0          # bf16 kernel path error vs plain path error
H, HKV, HD, PAGE, MAX_LEN, MAX_BATCH = 16, 8, 128, 16, 512, 4
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}   # grads: x max|tensor|
FLASH_OUT_BF16 = (1e-3, 1e-2)   # bf16 out, per element: atol + rtol|plain|
RMS_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
GRAD_REL = 1e-4                 # per leaf, x max|leaf| (float32)
TRAIN_B, TRAIN_S = 2, 4096      # train_4k's sequence, its batch cut to 2
PEAK_F32_FLOP_S = 67e12         # H100 SXM float32 outside the tensor cores
DECODE_LENS = [287, 301, 150, 64]   # contexts of the profiled decode wave
# paged SSM update: rows and d_state of falcon-mamba-7b (mamba1, "dbx")
# and zamba2-1.2b (mamba2, 64 heads x headdim 64, "dxb"); the kernel vs
# plain tolerance is relative to max|plain| (FMA contraction and the
# card's expf over up to 256 sequential float32 steps)
SSM_ROWS = {"dbx": (8192, 16), "dxb": (4096, 64)}
SSM_TOL = 1e-5
# (S, lengths, n_new): a decode step crossing a page boundary (16), one
# reading and rewriting its mid-page (31), an empty slot and an idle one;
# 64- and 256-token prefill chunks from 0, mid-page, idle and late slots
SSM_CASES = ((1, [16, 31, 0, 300], [1, 1, 1, 0]),
             (64, [0, 37, 200, 448], [64, 50, 0, 64]),
             (256, [0, 37, 200, 256], [256, 200, 0, 256]))
# selective scan: (Bb, rows, d_state, headdim) of falcon-mamba-7b's
# training shape (its d_inner channels) and zamba2-1.2b's (64 heads x
# headdim 64 rows; per-head dt, decay and D repeated across headdim);
# kernel vs plain tolerances relative to max|plain|: y as the paged SSM
# update, the six cotangents 1e-4 (float32 sums over up to 8192 rows and
# S steps in another order)
SCAN_ROWS = {"falcon": (2, 8192, 16, 0), "zamba2": (1, 4096, 64, 64)}
SCAN_TOL = {"y": 1e-5, "grad": 1e-4}
SCAN_NAMES = ("dt", "x", "A", "B", "C", "D")
FALCON_TRAIN_LAYERS = 26        # 1 open + 24 ParallelNet + 1 close
# (rows, width) the RMSNorm kernel sees: training ln / qk-norm rows; a
# decode wave's ln, q-norm and k-norm rows; a 512-token prefill bucket's;
# falcon-mamba-7b's training block norms and zamba2-1.2b's gated norm
RMS_SHAPES = ((8192, 2048), (8192 * H, HD),
              (MAX_BATCH, 2048), (MAX_BATCH * H, HD), (MAX_BATCH * HKV, HD),
              (MAX_BATCH * 512, 2048), (MAX_BATCH * 512 * H, HD),
              (TRAIN_B * TRAIN_S, 4096), (TRAIN_S, 4096))


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


SASS_OPS = ("HGMMA", "HMMA", "UTMALDG")    # wgmma, mma.sync, TMA load


def sass_census(lib: str) -> dict:
    """{short kernel name: {op: count}} of the HGMMA, HMMA and UTMALDG
    instructions of every kernel of one built library (``cuobjdump
    -sass``), printed one kernel a line."""
    from repro_torch.kernels import build
    tools = Path(build.nvcc_path()).parent
    sass = subprocess.run(
        [str(tools / "cuobjdump"), "-sass", str(build.library_path(lib))],
        capture_output=True, text=True, timeout=300, check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            counts[name] = dict.fromkeys(SASS_OPS, 0)
        elif name:
            for op in re.findall(r"\b(" + "|".join(SASS_OPS) + r")\b", line):
                counts[name][op] += 1
    names = list(counts)
    try:
        plain = subprocess.run([str(tools / "cu++filt")], input="\n".join(
            names), capture_output=True, text=True, timeout=60,
            check=True).stdout.splitlines()
    except (OSError, subprocess.SubprocessError):
        plain = names
    short = {n: re.sub(r"^void |\(anonymous namespace\)::|<unnamed>::|"
                       r"\(int\)", "", p).split("(")[0]
             for n, p in zip(names, plain)}
    out = {short[n]: counts[n] for n in names}
    for n in sorted(out):
        print(f"  SASS {n}: " + ", ".join(f"{op} {out[n][op]}"
                                          for op in SASS_OPS))
    return out


def sass_checks():
    """Fails unless every bf16 flash-attention kernel (namespace ``tc``:
    the forward, dK/dV and dQ at both tile widths) holds wgmma and TMA
    loads, the bf16 multi-row paged-attention kernel holds tensor-core
    products (HMMA or HGMMA), and no float32 paged-attention kernel does."""
    print("flash_attention SASS (the bf16 path on the tensor cores and "
          "TMA):")
    flash = sass_census("flash_attention")
    tc = {n: c for n, c in flash.items() if "tc::" in n}
    kinds = {re.sub(r"<.*", "", n) for n in tc}
    if kinds != {"tc::fwd_kernel", "tc::dkdv_kernel", "tc::dq_kernel"} \
            or any(c["HGMMA"] == 0 or c["UTMALDG"] == 0 for c in tc.values()):
        fail("a bf16 flash-attention kernel lacks wgmma (HGMMA) or TMA "
             f"loads (UTMALDG): {tc}")
    print("paged_attention SASS (bf16 multi-row on the tensor cores, "
          "float32 on the CUDA cores):")
    paged = sass_census("paged_attention")
    mma = {n: c for n, c in paged.items() if "paged_mma_kernel" in n}
    f32 = {n: c for n, c in paged.items() if re.search(r"<float\b", n)}
    if not mma or any(c["HMMA"] + c["HGMMA"] == 0 for c in mma.values()):
        fail(f"a bf16 multi-row paged-attention kernel lacks HMMA: {mma}")
    if not f32 or any(c["HMMA"] + c["HGMMA"] for c in f32.values()):
        fail(f"a float32 paged-attention kernel uses the tensor cores: {f32}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0]


def time_ms(fn, iters: int = 20, flush=None, warmup: int = 3) -> float:
    """Mean device time of ``fn`` from CUDA events, after ``warmup``
    calls. With ``flush`` (a large tensor) the L2 cache is overwritten
    before each timed launch, as a layer's caller would find it."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(iters):
        if flush is not None:
            flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        total += a.elapsed_time(b)
    return total / iters


def dev_us(e) -> float:
    """Device time (us) of a profiler ``key_averages()`` row."""
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0.0))


def device_ms(fn, iters: int, flush) -> float:
    """Mean device time (ms) of one ``fn()`` call, the L2 cleared before
    each by a read of ``flush`` (a read leaves no dirty lines for the
    call to write back, as ``flush.zero_()`` would right before it): a
    long device-side sleep is queued first, then the ``iters`` calls,
    each between its own pair of CUDA events, so that the host has
    queued every call before the device reaches the first. The events
    then time the device's work alone, without the host time of the
    wrapper, which events around a call include whenever the host is the
    slower side. A reading counts only if the host finished queueing
    within the sleep (else the sleep doubles, up to 3 tries)."""
    import torch
    fn()
    torch.cuda.synchronize()
    cycles = 100_000_000                  # ~50 ms at the H100's clocks
    for _ in range(3):
        s0, s1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        marks = [(torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
                 for _ in range(iters)]
        s0.record()
        torch.cuda._sleep(cycles)
        s1.record()
        t0 = time.perf_counter()
        for a, b in marks:
            flush.sum()
            a.record()
            fn()
            b.record()
        queued_ms = 1e3 * (time.perf_counter() - t0)
        torch.cuda.synchronize()
        if queued_ms < s0.elapsed_time(s1):
            return sum(a.elapsed_time(b) for a, b in marks) / iters
        cycles *= 2
    fail("device_ms: the host could not queue the calls within the sleep")


def attn_case(gen, B, S, lengths, dtype, n_slot_pages, poison, heads=None):
    """Pools with per-slot random page tables; rows past each slot's last
    visible key hold ``poison`` (they must not move a bit). ``heads`` is
    (H, Hkv, hd), qwen3_1p7b's by default."""
    import torch
    dev = "cuda"
    h, hkv, hd = heads or (H, HKV, HD)
    n_pages = 1 + B * n_slot_pages
    q = (torch.randn((B, S, h, hd), generator=gen, device=dev) * 0.5) \
        .to(dtype)
    pk = (torch.randn((n_pages, PAGE, hkv, hd), generator=gen, device=dev)
          * 0.5).to(dtype)
    pv = (torch.randn((n_pages, PAGE, hkv, hd), generator=gen, device=dev)
          * 0.5).to(dtype)
    perm = torch.randperm(n_pages - 1, generator=gen, device=dev) + 1
    table = perm.reshape(B, n_slot_pages).to(torch.int32)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    for b in range(B):
        last = int(lengths[b]) + S - 1
        rows = (table[b].long()[:, None] * PAGE
                + torch.arange(PAGE, device=dev)).reshape(-1)
        dead = rows[last + 1:]
        pk.view(-1, hkv, hd)[dead] = poison
        pv.view(-1, hkv, hd)[dead] = poison
    return q, pk, pv, table, lens


def live_bucket(lengths, S) -> int:
    need = max(int(x) + S for x in lengths)
    return 1 << (max(-(-need // PAGE), 1) - 1).bit_length()


def attn_bound_ms(B, S, lengths, P, itemsize):
    keys = sum(int(x) + S for x in lengths)            # visible K/V rows
    nbytes = (2 * B * S * H * HD * itemsize            # q in, out
              + 2 * keys * HKV * HD * itemsize         # K and V
              + B * P * 4 + B * 4)                     # table, lengths
    pairs = sum(int(x) + i + 1 for x in lengths for i in range(S))
    ops = 4 * HD * H * pairs                           # q.k and p.v
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, ops / PEAK_BF16_FLOP_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops \
        else "operations"


def sampling_case(gen, B, V):
    import torch
    logits = torch.randn((B, V), generator=gen, device="cuda") * 2.0
    ks = torch.tensor([0, 40, 1, 0, V, 5, 40, 0][:B], dtype=torch.int32,
                      device="cuda")
    ps = torch.tensor([1.0, 0.95, 0.5, 0.9, 0.3, 1.0, 0.95, 0.8][:B],
                      dtype=torch.float32, device="cuda")
    return logits, ks, ps


def flipped_mass(logits, keep_a, keep_b) -> float:
    import torch
    union = torch.where(keep_a | keep_b, logits.float(),
                        torch.full_like(logits.float(), -float("inf")))
    prob = torch.softmax(union, dim=-1)
    return float((prob * (keep_a != keep_b)).sum(-1).max())


def _scaled_err(got, want) -> float:
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max().clamp(min=1e-30)).item()


def _attn_grads(fn, q, k, v, do):
    import torch
    q, k, v = (x.detach().requires_grad_(True) for x in (q, k, v))
    out = fn(q, k, v)
    return (out, *torch.autograd.grad(out, (q, k, v), do))


def _kernel_bhsd(q, k, v, causal):
    """The flash kernel path on the TPU kernel's layout (B, H, S, hd)."""
    from repro_torch.kernels import flash_attention as fa
    return fa.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), causal=causal) \
        .transpose(1, 2)


def flash_out_check(got, want, dname):
    """(max|kernel - plain|, ok) for an attention output. float32: the
    absolute FLASH_TOL; bf16: FLASH_TOL and, per element, FLASH_OUT_BF16
    (late causal rows hold values far below FLASH_TOL)."""
    d = (got.float() - want.float()).abs()
    e = d.max().item()
    ok = e <= FLASH_TOL[dname]
    if dname == "bfloat16":
        atol, rtol = FLASH_OUT_BF16
        ok = ok and bool((d <= atol + rtol * want.float().abs()).all())
    return e, ok


def flash_tol_text(dname) -> str:
    tol = f"tolerance {FLASH_TOL[dname]:g}"
    if dname == "bfloat16":
        tol += (f", out per element {FLASH_OUT_BF16[0]:g} + "
                f"{FLASH_OUT_BF16[1]:g}|plain|")
    return tol


def check_train_kernels(gen):
    """Flash attention and RMSNorm, forward and backward, against their
    plain versions (autograd of the plain version for the gradients), in
    float32 and bf16; each backward twice, bit-identical. Attention also
    runs at zamba2_1p2b's training shape, in bf16 (its dtype). Returns
    the largest bf16 absolute error of each kernel at the training
    shapes."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rn
    err = {"flash_attention_fwd": 0.0, "flash_attention_bwd": 0.0,
           "rmsnorm_fwd": 0.0, "rmsnorm_bwd": 0.0}
    grid = [(1, 4, 4, 128, 128, 64, True), (2, 4, 2, 128, 128, 32, True),
            (1, 8, 1, 256, 256, 64, True), (1, 2, 2, 128, 256, 64, False),
            (2, 2, 2, 384, 384, 128, True), (1, 4, 2, 100, 77, 64, True),
            (1, 4, 2, 200, 333, 128, True),
            (TRAIN_B, H, HKV, 1024, 1024, HD, True)]
    zamba2_attn = (1, 32, 32, TRAIN_S, TRAIN_S, 64, True)
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[1]
        tol = FLASH_TOL[dname]
        bf16 = dtype == torch.bfloat16
        cases = grid + ([zamba2_attn] if bf16 else [])
        for B, h, hkv, Sq, Sk, hd, causal in cases:
            q, do = (torch.randn((B, h, Sq, hd), generator=gen,
                                 device="cuda") * 0.5 for _ in range(2))
            k, v = (torch.randn((B, hkv, Sk, hd), generator=gen,
                                device="cuda") * 0.5 for _ in range(2))
            q, k, v, do = (x.to(dtype) for x in (q, k, v, do))
            want = _attn_grads(lambda *a, c=causal: fa.flash_attention_ref(
                *a, causal=c), q, k, v, do)
            got = _attn_grads(lambda *a, c=causal: _kernel_bhsd(*a, c),
                              q, k, v, do)
            torch.cuda.synchronize()
            e_out, out_ok = flash_out_check(got[0], want[0], dname)
            e_grad = max(_scaled_err(g, w) for g, w in zip(got[1:],
                                                           want[1:]))
            shape = f"B={B} H={h}/{hkv} Sq={Sq} Sk={Sk} hd={hd} " \
                    f"{'causal' if causal else 'full'}"
            print(f"flash_attention {shape} {dname:8s}: out max|kernel-"
                  f"plain| {e_out:.3e}, dq/dk/dv max|kernel-plain|/max|"
                  f"plain| {e_grad:.3e} ({flash_tol_text(dname)})")
            if not (out_ok and e_grad <= tol):
                fail(f"flash attention {shape} {dname} disagrees with its "
                     "plain version")
            if bf16 and Sq >= 1024:
                err["flash_attention_fwd"] = max(err["flash_attention_fwd"],
                                                 e_out)
                err["flash_attention_bwd"] = max(
                    err["flash_attention_bwd"],
                    *((g.float() - w.float()).abs().max().item()
                      for g, w in zip(got[1:], want[1:])))
                qm, km, vm, dom = (x.transpose(1, 2).contiguous()
                                   for x in (q, k, v, do))
                o, lse = fa.flash_attention_fwd(qm, km, vm, True)
                first = fa.flash_attention_bwd(qm, km, vm, o, lse, dom, True)
                again = fa.flash_attention_bwd(qm, km, vm, o, lse, dom, True)
                torch.cuda.synchronize()
                if not all(torch.equal(a, b) for a, b in zip(first, again)):
                    fail(f"flash attention backward {shape} is not "
                         "bit-repeatable")
                del qm, km, vm, dom, o, lse, first, again
            del q, k, v, do, want, got
        for R, D in RMS_SHAPES:
            x = (torch.randn((R, D), generator=gen, device="cuda") * 2.0) \
                .to(dtype)
            dy = torch.randn((R, D), generator=gen, device="cuda").to(dtype)
            w = 1.0 + 0.1 * torch.randn(D, generator=gen, device="cuda")

            def run(fn, x=x, w=w, dy=dy):
                xx = x.detach().requires_grad_(True)
                ww = w.detach().requires_grad_(True)
                y = fn(xx, ww)
                return (y, *torch.autograd.grad(y, (xx, ww), dy))
            want, got = run(rn.rmsnorm_ref), run(rn.rmsnorm)
            torch.cuda.synchronize()
            e_y = (got[0].float() - want[0].float()).abs().max().item()
            e_dx, e_dw = _scaled_err(got[1], want[1]), _scaled_err(got[2],
                                                                   want[2])
            tol = RMS_TOL[dname]
            print(f"rmsnorm ({R}, {D}) {dname:8s}: y max|kernel-plain| "
                  f"{e_y:.3e}, dx {e_dx:.3e}, dw {e_dw:.3e} of max|plain| "
                  f"(tolerance {tol:g})")
            if not (e_y <= tol and e_dx <= tol and e_dw <= tol):
                fail(f"rmsnorm ({R}, {D}) {dname} disagrees with its plain "
                     "version")
            _, rstd = rn.rmsnorm_fwd(x, w)
            first, again = (rn.rmsnorm_bwd(x, w, rstd, dy) for _ in range(2))
            torch.cuda.synchronize()
            if not (torch.equal(first[0], again[0])
                    and torch.equal(first[1], again[1])):
                fail("rmsnorm backward is not bit-repeatable")
            if dtype == torch.bfloat16:
                err["rmsnorm_fwd"] = max(err["rmsnorm_fwd"], e_y)
                err["rmsnorm_bwd"] = max(
                    err["rmsnorm_bwd"],
                    (got[1].float() - want[1].float()).abs().max().item())
    print("training kernels: every backward bit-identical on a second run")
    return err


@contextlib.contextmanager
def plain_kernels():
    """Route ``kernels.ops``' training entry points to the plain versions
    for the duration (the package has no such switch: CUDA tensors always
    reach the kernels). Fails if a training kernel launches meanwhile."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.kernels import ssm_scan as ss
    saved = ops.flash_attention, ops.rmsnorm, ops.ssm_scan
    before = train_counts()
    ops.flash_attention = lambda q, k, v, *, causal=True: \
        fa.flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2),
                               causal=causal).transpose(1, 2)
    ops.rmsnorm = rn.rmsnorm_ref
    ops.ssm_scan = ss.ssm_scan_ref
    try:
        yield
    finally:
        ops.flash_attention, ops.rmsnorm, ops.ssm_scan = saved
    if train_counts() != before:
        fail("a training kernel launched on the plain path")


def _train_kernel_fns():
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.kernels import ssm_scan as ss
    return {"flash_attention_fwd": fa.flash_attention_fwd,
            "flash_attention_bwd": fa.flash_attention_bwd,
            "rmsnorm_fwd": rn.rmsnorm_fwd, "rmsnorm_bwd": rn.rmsnorm_bwd,
            "ssm_scan_fwd": ss.ssm_scan_fwd,
            "ssm_scan_bwd": ss.ssm_scan_bwd}


def train_counts():
    return {k: fn.launches for k, fn in _train_kernel_fns().items()}


def reset_train_counts():
    for fn in _train_kernel_fns().values():
        fn.launches = 0


def grads_of(params, batch, rcfg, mode=None, loss=None):
    """{path: gradient} of ``loss_fn(mode)`` (the MGRIT adjoint) or of
    ``loss(params)`` (direct autograd)."""
    import torch
    from repro_torch.models import transformer
    from repro_torch.tree import leaves_with_paths, unflatten
    paths, leaves = zip(*leaves_with_paths(params))
    leaves = [p.detach().requires_grad_(True) for p in leaves]
    tree = unflatten(zip(paths, leaves))
    val = loss(tree) if loss is not None else \
        transformer.loss_fn(tree, batch, rcfg, mode=mode)[0]
    grads = torch.autograd.grad(val, leaves, allow_unused=True)
    return val.item(), {p: (g if g is not None else torch.zeros_like(x))
                        for p, g, x in zip(paths, grads, leaves)}


def direct_loss(rcfg, batch):
    """The loss by plain autograd through the serial layer loop (the
    oracle of ``tests/test_lp_grads.py``)."""
    from repro_torch.core import lp, mgrit
    from repro_torch.models import transformer as tr
    from repro_torch.models.layers import norm_apply, unembed
    cfg = rcfg.model

    def loss(p):
        static = lp.LPStatic(cfg=cfg, mgrit=rcfg.mgrit, kind="attn_mlp")
        z = tr._embed_inputs(p, batch, cfg)
        rope = tr._rope_for(cfg, z.shape[1], z.device)
        z = tr._serial_buffer(p.get("open"), z, cfg, kind="attn_mlp",
                              causal=True, rope=rope)
        mid = [{"params": s, "gate": p["mid"]["gate"][n]}
               for n, s in enumerate(mgrit.slots(p["mid"]["params"]))]
        _, zT = mgrit.serial_solve(lp.make_fwd_step(static, {"rope": rope}),
                                   mid, z, rcfg.mgrit.h)
        zT = tr._serial_buffer(p.get("close"), zT, cfg, kind="attn_mlp",
                               causal=True, rope=rope)
        zT = norm_apply(p["final_norm"], zT, cfg)
        return tr.lm_loss(unembed(p["embed"], zT, cfg), batch["labels"])
    return loss


def leaf_errors(got, want):
    """Largest per-leaf max|got - want| / max|want| and its leaf. The
    gates are structural: the adjoint returns zero for them by design."""
    worst = (0.0, "")
    for path, w in want.items():
        if path[-1] == "gate":
            continue
        den = w.float().abs().max().item()
        e = (got[path].float() - w.float()).abs().max().item()
        e = e / den if den > 0 else e
        worst = max(worst, (e, ".".join(path)))
    return worst


def check_train_grads():
    """Full-width qwen3_1p7b at 6 layers (1 open, 4 mid, 1 close), S=512:
    kernel-path gradients vs direct autograd through the plain serial
    loop (serial mode) and vs the plain path (MGRIT mode), float32; in
    bf16 the direction-and-norm checks of tests/test_lp_grads.py."""
    import numpy as np
    import torch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import SyntheticLM, shard_batch
    from repro_torch.models import transformer

    def rcfg_for(dtype, fwd, bwd):
        rcfg = get_config("qwen3_1p7b", "train_4k")
        return rcfg.replace(
            model=dataclasses.replace(rcfg.model, n_layers=6, dtype=dtype),
            mgrit=dataclasses.replace(rcfg.mgrit, pad_to=4, fwd_iters=fwd,
                                      bwd_iters=bwd),
            shape=ShapeConfig("s512", "train", 512, 2), microbatches=1)
    r32 = rcfg_for("float32", 0, 0)
    params = transformer.init_model(r32, seed=1, device="cuda")
    batch = shard_batch(SyntheticLM(r32, seed=1).batch_at(0), "cuda")

    la, ga = grads_of(params, batch, r32, mode="serial")
    with plain_kernels():
        ld, gd = grads_of(params, batch, r32, loss=direct_loss(r32, batch))
    e, leaf = leaf_errors(ga, gd)
    print(f"train grads, 6 layers S=512 f32, serial adjoint (kernels) vs "
          f"direct autograd (plain): loss {la:.6f} vs {ld:.6f}; worst leaf "
          f"{leaf} max|diff|/max|leaf| {e:.3e} (tolerance {GRAD_REL:g})")
    if not (e <= GRAD_REL and abs(la - ld) <= 1e-5 * abs(ld)):
        fail("serial adjoint gradients disagree with direct autograd")

    rm = rcfg_for("float32", 2, 1)
    lk, gk = grads_of(params, batch, rm, mode="lp")
    with plain_kernels():
        lp_, gp = grads_of(params, batch, rm, mode="lp")
    e, leaf = leaf_errors(gk, gp)
    print(f"train grads, 6 layers S=512 f32, MGRIT fwd 2 / bwd 1: kernel "
          f"path vs plain path: loss {lk:.6f} vs {lp_:.6f}; worst leaf "
          f"{leaf} {e:.3e} (tolerance {GRAD_REL:g})")
    if not (e <= GRAD_REL and abs(lk - lp_) <= 1e-5 * abs(lp_)):
        fail("MGRIT gradients differ between the kernel and plain paths")

    r16 = rcfg_for("bfloat16", 0, 0)
    _, ga = grads_of(params, batch, r16, mode="serial")
    _, gd = grads_of(params, batch, r16, loss=direct_loss(r16, batch))

    def flat(g):
        return torch.cat([g[p].float().reshape(-1) for p in sorted(g)
                          if p[-1] != "gate"])
    fa_, fd = flat(ga), flat(gd)
    cos = (fa_ @ fd / (fa_.norm() * fd.norm() + 1e-30)).item()
    nrel = abs(fa_.norm().item() - fd.norm().item()) / fd.norm().item()
    print(f"train grads, 6 layers S=512 bf16, serial adjoint vs direct "
          f"autograd (both kernels): cosine {cos:.6f} (> 0.9999), norm "
          f"rel diff {nrel:.3e} (< 1e-2)")
    if not (cos > 0.9999 and nrel < 1e-2 and np.isfinite(cos)):
        fail("bf16 adjoint gradients lose direction or norm")
    del params, ga, gd, gk, gp


def scan_case(gen, fam, S):
    """(dt, x, A, B, C, D) of the selective scan at ``fam``'s rows
    (SCAN_ROWS) on the card: mamba1 draws per-channel dt, decay and D;
    mamba2 per-head ones repeated across headdim, the decay a stride-0
    (rows, d_state) view, as on the main path."""
    import torch
    import torch.nn.functional as F
    Bb, R, ds, hd = SCAN_ROWS[fam]

    def r(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    if hd:
        nh = R // hd
        dt = (F.softplus(r(Bb, S, nh)) * 0.2).repeat_interleave(hd, dim=-1)
        A = (-torch.exp(r(nh))).repeat_interleave(hd)[:, None].expand(R, ds)
        D = (1.0 + 0.1 * r(nh)).repeat_interleave(hd)
    else:
        dt = F.softplus(r(Bb, S, R)) * 0.2
        A = -torch.exp(r(R, ds))
        D = 1.0 + 0.1 * r(R)
    return dt, r(Bb, S, R), A, r(Bb, S, ds), r(Bb, S, ds), D


def check_scan_kernel(gen):
    """The selective scan against its plain version at falcon-mamba-7b's
    and zamba2-1.2b's full-width rows: y and all six cotangents (autograd
    of the plain version) at S=1000 (15 checkpoint chunks and a ragged
    tail), a second backward bit-identical; y at the training length
    S=4096. Returns the largest abs error of y and of the cotangents."""
    import torch
    from repro_torch.kernels import ssm_scan as ss
    err = {"ssm_scan_fwd": 0.0, "ssm_scan_bwd": 0.0}
    for fam in ("falcon", "zamba2"):
        Bb, R, ds, hd = SCAN_ROWS[fam]
        shape = f"{fam} rows Bb={Bb} R={R} ds={ds}" + \
            (f" (heads of {hd}, stride-0 decay)" if hd else "")
        ins = scan_case(gen, fam, 1000)
        gy = torch.randn(ins[1].shape, generator=gen, device="cuda")

        def run(fn, ins=ins, gy=gy):
            args = [t.detach().requires_grad_(True) for t in ins]
            y = fn(*args)
            return (y, *torch.autograd.grad(y, args, gy))
        want, got = run(ss.ssm_scan_ref), run(ss.ssm_scan)
        _, hc = ss.ssm_scan_fwd(*ins)
        first, again = (ss.ssm_scan_bwd(*ins, hc, gy) for _ in range(2))
        torch.cuda.synchronize()
        e_y = _scaled_err(got[0], want[0])
        e_g = {n: _scaled_err(g, w)
               for n, g, w in zip(SCAN_NAMES, got[1:], want[1:])}
        same = all(torch.equal(a, b) for a, b in zip(first, again))
        print(f"ssm_scan {shape} S=1000: y max|kernel-plain|/max|plain| "
              f"{e_y:.3e} (tolerance {SCAN_TOL['y']:g}); cotangents "
              + ", ".join(f"{n} {e:.3e}" for n, e in e_g.items())
              + f" (tolerance {SCAN_TOL['grad']:g}); second backward "
              f"bit-identical {same}")
        if not (e_y <= SCAN_TOL["y"] and max(e_g.values())
                <= SCAN_TOL["grad"] and same):
            fail(f"ssm_scan {shape} disagrees with its plain version")
        err["ssm_scan_fwd"] = max(err["ssm_scan_fwd"], (
            got[0] - want[0]).abs().max().item())
        err["ssm_scan_bwd"] = max(err["ssm_scan_bwd"], max(
            (g - w).abs().max().item() for g, w in zip(got[1:], want[1:])))
        del want, got, first, again, hc
        ins = scan_case(gen, fam, TRAIN_S)
        with torch.no_grad():
            want, got = ss.ssm_scan_ref(*ins), ss.ssm_scan(*ins)
        torch.cuda.synchronize()
        e_y = _scaled_err(got, want)
        print(f"ssm_scan {shape} S={TRAIN_S}: y max|kernel-plain|/max|plain|"
              f" {e_y:.3e} (tolerance {SCAN_TOL['y']:g})")
        if not e_y <= SCAN_TOL["y"]:
            fail(f"ssm_scan {shape} S={TRAIN_S} disagrees with its plain "
                 "version")
        err["ssm_scan_fwd"] = max(err["ssm_scan_fwd"],
                                  (got - want).abs().max().item())
    return err


def check_ssm_train_grads():
    """Gradients through the scan kernel at full width and reduced depth,
    B=2, S=512: falcon_mamba_7b at 6 layers (1 open, 4 ParallelNet, 1
    close), the kernel path's loss and every gradient leaf against the
    plain path's in float32, serial and MGRIT (fwd 2 / bwd 1), and in bf16
    serial by direction and norm (the checks of tests/test_lp_grads.py);
    zamba2_1p2b at 6 mamba2 layers and one shared-attention application
    (attention at hd 64, backward included), the same float32 and bf16
    checks, serial (its config)."""
    import numpy as np
    import torch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import SyntheticLM, shard_batch
    from repro_torch.models import transformer

    def rcfg_for(arch, dtype, fwd=0, bwd=0):
        rcfg = get_config(arch, "train_4k")
        mg = rcfg.mgrit
        if mg.enabled:
            mg = dataclasses.replace(mg, pad_to=4, fwd_iters=fwd,
                                     bwd_iters=bwd)
        return rcfg.replace(
            model=dataclasses.replace(rcfg.model, n_layers=6, dtype=dtype),
            mgrit=mg, shape=ShapeConfig("s512", "train", 512, 2),
            microbatches=1)

    def compare(arch, label, rcfg, mode, params, batch):
        lk, gk = grads_of(params, batch, rcfg, mode=mode)
        with plain_kernels():
            lp_, gp = grads_of(params, batch, rcfg, mode=mode)
        e, leaf = leaf_errors(gk, gp)
        print(f"train grads {arch}, 6 layers S=512 {label}: kernel path vs "
              f"plain path: loss {lk:.6f} vs {lp_:.6f}; worst leaf {leaf} "
              f"max|diff|/max|leaf| {e:.3e} (tolerance {GRAD_REL:g})")
        if not (e <= GRAD_REL and abs(lk - lp_) <= 1e-5 * abs(lp_)):
            fail(f"{arch} {label} gradients differ between the kernel and "
                 "plain paths")

    def flat(g):
        return torch.cat([g[p].float().reshape(-1) for p in sorted(g)
                          if p[-1] != "gate"])

    for arch in ("falcon_mamba_7b", "zamba2_1p2b"):
        r32 = rcfg_for(arch, "float32")
        params = transformer.init_model(r32, seed=1, device="cuda")
        batch = shard_batch(SyntheticLM(r32, seed=1).batch_at(0), "cuda")
        compare(arch, "f32 serial", r32, "serial", params, batch)
        if arch == "falcon_mamba_7b":
            compare(arch, "f32 MGRIT fwd 2 / bwd 1",
                    rcfg_for(arch, "float32", 2, 1), "lp", params, batch)
        r16 = rcfg_for(arch, "bfloat16")
        _, gk = grads_of(params, batch, r16, mode="serial")
        with plain_kernels():
            _, gp = grads_of(params, batch, r16, mode="serial")
        fk, fp = flat(gk), flat(gp)
        cos = (fk @ fp / (fk.norm() * fp.norm() + 1e-30)).item()
        nrel = abs(fk.norm().item() - fp.norm().item()) / fp.norm().item()
        print(f"train grads {arch}, 6 layers S=512 bf16 serial: kernel "
              f"path vs plain path: cosine {cos:.6f} (> 0.9999), norm "
              f"rel diff {nrel:.3e} (< 1e-2)")
        if not (cos > 0.9999 and nrel < 1e-2 and np.isfinite(cos)):
            fail(f"{arch} bf16 kernel-path gradients lose direction or "
                 "norm")
        del gk, gp, fk, fp, params


def scan_bound_ms(fam, S, backward=False):
    """Least time for one scan call at ``fam``'s rows: the bytes the
    function must move (forward: dt, x, B, C, A and D read, y written;
    backward: those inputs and gy read, the six cotangents written; dt,
    A, D and their cotangents counted at their distinct values, one per
    head for mamba2's rows) over the HBM rate, vs float32 operations over
    the non-tensor peak: per state element and step 5 (forward: the
    update's multiply-add and term, the readout's multiply-add) or 18
    (backward, the chunk's recompute included), plus 2 (the product dt*A
    and its exp) per distinct decay value and step: every (row, state)
    for mamba1, one per head for mamba2's rows. The checkpoints the
    design stores are not in the bound (see ``scan_checkpoint_bytes``)."""
    Bb, R, ds, hd = SCAN_ROWS[fam]
    n_ch = R // hd if hd else R           # distinct dt and D values
    n_decay = R // hd if hd else R * ds   # distinct A values
    x, dt, bc = Bb * S * R * 4, Bb * S * n_ch * 4, 2 * Bb * S * ds * 4
    ins = dt + x + bc + n_decay * 4 + n_ch * 4
    if backward:
        nbytes = 2 * ins + x                # inputs, gy; cotangents
        ops = Bb * S * (18 * R * ds + 2 * n_decay)
    else:
        nbytes = ins + x
        ops = Bb * S * (5 * R * ds + 2 * n_decay)
    t_b, t_o = nbytes / PEAK_BYTES_S, ops / PEAK_F32_FLOP_S
    return 1e3 * max(t_b, t_o), "bytes" if t_b >= t_o else "operations"


def scan_checkpoint_bytes(fam, S):
    """Bytes of the float32 state the forward stores every 64 steps (and
    the backward reads): a cost of the design, outside the bound."""
    Bb, R, ds, _ = SCAN_ROWS[fam]
    return Bb * -(-S // 64) * R * ds * 4


def time_scan_kernels(gen, flush, err):
    """Kernel and plain times (CUDA events, L2 flushed) and the kernels'
    device times (``device_ms``) of the selective scan forward (with the
    checkpoints a training forward stores) and backward at both training
    shapes (S=4096), and their bounds; the backward's six cotangents are
    also held against the plain version's autograd there (``err`` takes
    the largest abs error). No single PyTorch call computes a selective
    scan, so there is no library time."""
    import torch
    from repro_torch.kernels import ssm_scan as ss
    rows = {}
    for fam in ("falcon", "zamba2"):
        ins = scan_case(gen, fam, TRAIN_S)
        gy = torch.randn(ins[1].shape, generator=gen, device="cuda")
        _, hc = ss.ssm_scan_fwd(*ins)
        k_fwd = time_ms(lambda a=ins: ss.ssm_scan_fwd(*a), 5, flush)
        k_bwd = time_ms(lambda a=ins, h=hc, g=gy: ss.ssm_scan_bwd(*a, h, g),
                        5, flush)
        d_fwd = device_ms(lambda a=ins: ss.ssm_scan_fwd(*a), 5, flush)
        d_bwd = device_ms(lambda a=ins, h=hc, g=gy: ss.ssm_scan_bwd(
            *a, h, g), 5, flush)
        with torch.no_grad():
            p_fwd = time_ms(lambda a=ins: ss.ssm_scan_ref(*a), 2, flush,
                            warmup=1)
        args = [t.detach().requires_grad_(True) for t in ins]
        py = ss.ssm_scan_ref(*args)
        p_bwd = time_ms(lambda: torch.autograd.grad(
            py, args, gy, retain_graph=True), 2, flush, warmup=1)
        want = torch.autograd.grad(py, args, gy)
        got = ss.ssm_scan_bwd(*ins, hc, gy)
        torch.cuda.synchronize()
        e_g = {n: _scaled_err(g, w)
               for n, g, w in zip(SCAN_NAMES, got, want)}
        Bb, R, ds, _ = SCAN_ROWS[fam]
        print(f"ssm_scan_bwd {fam} rows Bb={Bb} R={R} ds={ds} S={TRAIN_S}: "
              "cotangents max|kernel-plain|/max|plain| "
              + ", ".join(f"{n} {e:.3e}" for n, e in e_g.items())
              + f" (tolerance {SCAN_TOL['grad']:g})")
        if not max(e_g.values()) <= SCAN_TOL["grad"]:
            fail(f"ssm_scan backward {fam} S={TRAIN_S} disagrees with its "
                 "plain version")
        err["ssm_scan_bwd"] = max(err["ssm_scan_bwd"], max(
            (g - w).abs().max().item() for g, w in zip(got, want)))
        del py, args, hc, want, got
        fb, fby = scan_bound_ms(fam, TRAIN_S)
        bb, bby = scan_bound_ms(fam, TRAIN_S, backward=True)
        for name, km, dm, pm, bm, by in (
                ("ssm_scan_fwd", k_fwd, d_fwd, p_fwd, fb, fby),
                ("ssm_scan_bwd", k_bwd, d_bwd, p_bwd, bb, bby)):
            print(f"{name} {fam} rows Bb={Bb} S={TRAIN_S} R={R} ds={ds} f32:"
                  f" kernel {km:.4f} ms (device {dm:.4f}), plain {pm:.4f} "
                  f"ms, bound {bm:.5f} ms ({by}), library none; checkpoints "
                  f"{scan_checkpoint_bytes(fam, TRAIN_S) / 1e6:.1f} MB "
                  "(outside the bound)")
            rows[(name, fam)] = (km, pm, bm, by, dm)
        del ins, gy
        gc.collect()
        torch.cuda.empty_cache()
    return rows


def qwen3_train_config():
    """Full-width, full-depth qwen3_1p7b at train_4k's S=4096, B=2."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.registry import get_config
    rcfg = get_config("qwen3_1p7b", "train_4k")
    return rcfg.replace(
        shape=ShapeConfig("train_4k", "train", TRAIN_S, TRAIN_B),
        microbatches=1,
        mgrit=dataclasses.replace(rcfg.mgrit, check_every=2))


def falcon_train_config():
    """Full-width falcon_mamba_7b at FALCON_TRAIN_LAYERS layers (1 open +
    24 ParallelNet + 1 close, pad_to 4: no gate-0 layers), its MGRIT
    config (cf 4, levels 2, fwd 2 / bwd 1) probed every 2 steps, B=2,
    S=4096. Full depth (64 layers, 7.48 B parameters) needs 120 GB of
    float32 params, grads and AdamW moments: more than one card holds."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.registry import get_config
    rcfg = get_config("falcon_mamba_7b", "train_4k")
    return rcfg.replace(
        model=dataclasses.replace(rcfg.model, n_layers=FALCON_TRAIN_LAYERS),
        shape=ShapeConfig("train_4k", "train", TRAIN_S, TRAIN_B),
        microbatches=1,
        mgrit=dataclasses.replace(rcfg.mgrit, pad_to=4, check_every=2))


def zamba2_train_config():
    """Full-width, full-depth zamba2_1p2b (38 mamba2 layers, the shared
    attention block after every 6), serial as its config says, B=1,
    S=4096."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.registry import get_config
    rcfg = get_config("zamba2_1p2b", "train_4k")
    return rcfg.replace(shape=ShapeConfig("train_4k", "train", TRAIN_S, 1),
                        microbatches=1)


def run_train(rcfg, required):
    """``Trainer.train(3)`` of ``rcfg``, every training launch counter set
    to 0 just before and read just after (the adaptive probe at step 2
    when MGRIT is on); then one step of each mode under the profiler
    (MGRIT and serial when MGRIT is on, else serial), each on the batch
    after them. Fails unless each kernel in ``required`` launched, every loss
    and forward residual norm is finite and, under MGRIT, the probe ran
    at step 2. Returns (launches over the 3 steps, {mode: launches in
    the profiled step}, peak GiB)."""
    import numpy as np
    import torch
    from repro_torch.data.pipeline import shard_batch
    from repro_torch.launch.steps import make_train_fn
    from repro_torch.models import transformer
    from repro_torch.train.trainer import Trainer
    from repro_torch.tree import leaves_with_paths
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cfg, mg = rcfg.model, rcfg.mgrit
    B, S = rcfg.shape.global_batch, rcfg.shape.seq_len
    t0 = time.perf_counter()
    trainer = Trainer(rcfg, seed=0)
    torch.cuda.synchronize()
    if cfg.family == "hybrid":
        depth = (f"{cfg.n_layers} mamba2 layers + the shared attention "
                 f"block after every {cfg.hybrid_attn_every} "
                 f"({cfg.n_layers // cfg.hybrid_attn_every} applications), "
                 "serial (its config)")
    else:
        n_layers = transformer.stacked_layer_depth(rcfg)
        n_mid = n_layers - mg.n_open - mg.n_close
        n_real = cfg.n_layers - mg.n_open - mg.n_close
        depth = (f"{n_layers} stacked layers ({mg.n_open} open + {n_mid} "
                 f"ParallelNet, gate-0 padded from {n_real}, + "
                 f"{mg.n_close} close); MGRIT cf={mg.cf} levels="
                 f"{mg.levels} fwd_iters={mg.fwd_iters} bwd_iters="
                 f"{mg.bwd_iters}, probe every {mg.check_every}")
    n_params = sum(p.numel() for _, p in
                   leaves_with_paths(trainer.params))
    print(f"train: {cfg.name} d_model={cfg.d_model} {depth}; "
          f"{n_params / 1e9:.3f} B params; B={B} S={S} (train_4k's global "
          f"batch 256 cut to {B}, microbatches 1), {cfg.dtype} compute, "
          f"f32 params; init {time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB")
    torch.cuda.reset_peak_memory_stats()
    reset_train_counts()
    rep = trainer.train(3, log_every=0)
    torch.cuda.synchronize()
    launches = train_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    for i, (loss, sec, norms, mode) in enumerate(zip(
            rep.losses, rep.step_seconds, rep.fwd_norms, rep.mode_trace)):
        print(f"train {cfg.name} step {i} [{mode}]: loss {loss:.4f}, "
              f"fwd_norms {[float(f'{n:.4g}') for n in norms]}, "
              f"{sec:.2f} s, {B * S / sec:.0f} tokens/s")
    total = torch.cuda.get_device_properties(0).total_memory / 2**30
    print(f"train {cfg.name}: probe history (step, rho_fwd, rho_bwd) "
          f"{rep.controller_history}; switched_at {rep.switched_at}; peak "
          f"memory {peak:.1f} GiB of {total:.1f}; launches over 3 steps "
          f"{launches}")
    if len(rep.losses) != 3 or not np.all(np.isfinite(rep.losses)):
        fail(f"{cfg.name} train losses {rep.losses}")
    if not all(np.all(np.isfinite(n)) for n in rep.fwd_norms):
        fail(f"{cfg.name}: non-finite forward residual norms "
             f"{rep.fwd_norms}")
    if mg.enabled and [h[0] for h in rep.controller_history] != [2]:
        fail(f"{cfg.name}: the probe did not run at step 2: "
             f"{rep.controller_history}")
    if min(launches[k] for k in required) <= 0:
        fail(f"{cfg.name}: a training kernel never launched: {launches}")

    modes = [("serial", rcfg.replace(
        mgrit=dataclasses.replace(mg, enabled=False)))]
    if mg.enabled:
        modes.insert(0, ("MGRIT (lp)", rcfg))
    per_mode = {}
    for mode, step_rcfg in modes:
        step_fn = make_train_fn(step_rcfg)
        batch = shard_batch(trainer.pipeline.batch_at(trainer.step),
                            "cuda")
        before = train_counts()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            _, _, metrics = step_fn(trainer.params, trainer.opt_state,
                                    batch)
            loss = metrics["loss"].item()
            window = time.perf_counter() - t0
        if not np.isfinite(loss):
            fail(f"the profiled {cfg.name} {mode} step's loss is {loss}")
        per_step = {k: v - before[k] for k, v in train_counts().items()
                    if k in required}
        per_mode[mode] = per_step
        kern = [e for e in prof.key_averages()
                if getattr(e, "device_type", None) == DeviceType.CUDA]
        busy = sum(dev_us(e) for e in kern) / 1e6
        print(f"one {cfg.name} {mode} train step under the profiler: loss "
              f"{loss:.4f}, {window:.2f} s wall, "
              + (f"device busy {busy:.2f} s = {100 * busy / window:.1f}%, "
                 f"{sum(e.count for e in kern)} device ops"
                 if kern else "device busy not measured (no device events)")
              + f"; launches in this step {per_step}")
        for e in sorted(kern, key=dev_us, reverse=True)[:10]:
            print(f"  {dev_us(e) / 1e6:8.3f} s  {e.count:6d}x  {e.key[:80]}")
    del trainer
    return launches, per_mode, peak


def flash_bound_ms(B, h, hkv, S, hd, itemsize, backward=False):
    """Least time at a causal training shape: causal pairs x (4 fwd, 10
    bwd) x hd flops over the bf16 peak, vs each input and output once."""
    pairs = S * (S + 1) // 2
    ops = (10 if backward else 4) * hd * pairs * B * h
    n_q = B * S * h * hd * itemsize
    n_kv = 2 * B * S * hkv * hd * itemsize
    lse = B * h * S * 4
    nbytes = (3 * n_q + 2 * n_kv + lse) if backward else \
        (2 * n_q + n_kv + lse)        # bwd: q,o,dO + dq; fwd: q,o
    if backward:
        nbytes += n_kv                # dk, dv
    t_b, t_o = nbytes / PEAK_BYTES_S, ops / PEAK_BF16_FLOP_S
    return 1e3 * max(t_b, t_o), "bytes" if t_b >= t_o else "operations"


def time_flash(gen, flush, err, name, B, h, hkv, hd):
    """The bf16 flash kernels at one causal training shape (S=4096): held
    against the plain version (``err`` takes the largest abs errors of
    out and of dq/dk/dv), then kernel, plain, SDPA and bound times.
    Returns {"fwd"/"bwd": (kernel, plain, library, bound ms, bound by)}."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    bf, S = torch.bfloat16, TRAIN_S
    q, do = (torch.randn((B, S, h, hd), generator=gen,
                         device="cuda").to(bf) for _ in range(2))
    k, v = (torch.randn((B, S, hkv, hd), generator=gen,
                        device="cuda").to(bf) for _ in range(2))
    o, lse = fa.flash_attention_fwd(q, k, v, True)
    k_fwd = time_ms(lambda: fa.flash_attention_fwd(q, k, v, True), 5, flush)
    k_bwd = time_ms(lambda: fa.flash_attention_bwd(q, k, v, o, lse, do,
                                                   True), 5, flush)
    qt, kt, vt, dot = (x.transpose(1, 2) for x in (q, k, v, do))
    qr, kr, vr = (x.detach().requires_grad_(True) for x in (qt, kt, vt))
    plain_fwd = time_ms(lambda: fa.flash_attention_ref(qt, kt, vt), 3,
                        flush)
    po = fa.flash_attention_ref(qr, kr, vr)
    plain_bwd = time_ms(lambda: torch.autograd.grad(
        po, (qr, kr, vr), dot, retain_graph=True), 3, flush)
    want = (po, *torch.autograd.grad(po, (qr, kr, vr), dot))
    got = (o, *fa.flash_attention_bwd(q, k, v, o, lse, do, True))
    got = [x.transpose(1, 2) for x in got]
    torch.cuda.synchronize()
    e_out, out_ok = flash_out_check(got[0], want[0], "bfloat16")
    e_grad = max(_scaled_err(g, w) for g, w in zip(got[1:], want[1:]))
    shape = f"B={B} H={h}/{hkv} Sq=Sk={S} hd={hd} causal bfloat16"
    print(f"flash_attention {shape} ({name}): out max|kernel-plain| "
          f"{e_out:.3e}, dq/dk/dv max|kernel-plain|/max|plain| {e_grad:.3e} "
          f"({flash_tol_text('bfloat16')})")
    if not (out_ok and e_grad <= FLASH_TOL["bfloat16"]):
        fail(f"flash attention disagrees with its plain version at {name}")
    err["flash_attention_fwd"] = max(err["flash_attention_fwd"], e_out)
    err["flash_attention_bwd"] = max(
        err["flash_attention_bwd"],
        max((g.float() - w.float()).abs().max().item()
            for g, w in zip(got[1:], want[1:])))
    del po, want, got
    sdpa = F.scaled_dot_product_attention
    qc, kc, vc = (x.contiguous() for x in (qt, kt, vt))
    lib_fwd = time_ms(lambda: sdpa(qc, kc, vc, is_causal=True,
                                   enable_gqa=True), 5, flush)
    ql, kl, vl = (x.detach().requires_grad_(True) for x in (qc, kc, vc))
    lo = sdpa(ql, kl, vl, is_causal=True, enable_gqa=True)
    lib_bwd = time_ms(lambda: torch.autograd.grad(
        lo, (ql, kl, vl), dot.contiguous(), retain_graph=True), 5, flush)
    del lo
    pairs = B * h * S * (S + 1) // 2
    rows = {}
    for part, km, pm, lm, per_pair in (("fwd", k_fwd, plain_fwd, lib_fwd, 6),
                                       ("bwd", k_bwd, plain_bwd, lib_bwd,
                                        16)):
        bm, by = flash_bound_ms(B, h, hkv, S, hd, 2, backward=part == "bwd")
        design = 1e3 * per_pair * hd * pairs / PEAK_BF16_FLOP_S
        rows[part] = (km, pm, lm, bm, by)
        print(f"flash_attention_{part} {shape} ({name}): kernel {km:.4f} "
              f"ms, plain {pm:.4f} ms, SDPA(enable_gqa) {lm:.4f} ms, bound "
              f"{bm:.5f} ms ({by}); the design's {per_pair} x hd flops a "
              f"pair take {design:.5f} ms at the bf16 peak")
    return rows


def time_train_kernels(gen, flush, err):
    """Kernel, plain and library times at the training shapes (bf16):
    attention causal S=4096 at qwen3_1p7b's B=2 H=16/8 hd=128 and
    zamba2_1p2b's B=1 H=32/32 hd=64 (each also held against the plain
    version, see ``time_flash``); RMSNorm forward and backward at (8192,
    2048) and at qk-norm's (131072, 128), with device times. Returns
    {kernel: (kernel, plain, library, bound ms, bound by)}, with zamba2's
    flash rows under "<kernel>@zamba2", the RMSNorm device times (kernel,
    library) under "rmsnorm_{fwd,bwd}@device" and the qk-norm rows (the
    five, then both device times) under "rmsnorm_{fwd,bwd}@qk_norm"."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import rmsnorm as rn
    bf = torch.bfloat16
    rows = {}
    for name, (B, h, hkv, hd), suffix in (
            ("qwen3_1p7b", (TRAIN_B, H, HKV, HD), ""),
            ("zamba2_1p2b", (1, 32, 32, 64), "@zamba2")):
        flash = time_flash(gen, flush, err, name, B, h, hkv, hd)
        for part, row in flash.items():
            rows[f"flash_attention_{part}{suffix}"] = row
        gc.collect()
        torch.cuda.empty_cache()
    out = {}

    x = torch.randn((TRAIN_B * TRAIN_S, 2048), generator=gen,
                    device="cuda").to(bf)
    dy = torch.randn_like(x)
    w = torch.ones(2048, device="cuda")
    _, rstd = rn.rmsnorm_fwd(x, w)
    out["rmsnorm_fwd"] = time_ms(lambda: rn.rmsnorm_fwd(x, w), 20, flush)
    out["rmsnorm_bwd"] = time_ms(lambda: rn.rmsnorm_bwd(x, w, rstd, dy), 20,
                                 flush)
    xr, wr = x.detach().requires_grad_(True), w.detach().requires_grad_(True)
    rms_plain_fwd = time_ms(lambda: rn.rmsnorm_ref(x, w), 20, flush)
    ry = rn.rmsnorm_ref(xr, wr)
    rms_plain_bwd = time_ms(lambda: torch.autograd.grad(
        ry, (xr, wr), dy, retain_graph=True), 20, flush)
    wb = w.to(bf)                     # the library call wants one dtype
    rms_lib_fwd = time_ms(lambda: F.rms_norm(x, (2048,), wb, eps=1e-6), 20,
                          flush)
    wbr = wb.detach().requires_grad_(True)
    ly = F.rms_norm(xr, (2048,), wbr, eps=1e-6)
    rms_lib_bwd = time_ms(lambda: torch.autograd.grad(
        ly, (xr, wbr), dy, retain_graph=True), 20, flush)

    R, D = x.shape
    rb_fwd = 1e3 * (2 * R * D * 2 + D * 4 + R * 4) / PEAK_BYTES_S
    rb_bwd = 1e3 * (3 * R * D * 2 + R * 4 + 2 * D * 4) / PEAK_BYTES_S
    rows["rmsnorm_fwd"] = (out["rmsnorm_fwd"], rms_plain_fwd, rms_lib_fwd,
                           rb_fwd, "bytes")
    rows["rmsnorm_bwd"] = (out["rmsnorm_bwd"], rms_plain_bwd, rms_lib_bwd,
                           rb_bwd, "bytes")
    for name in ("rmsnorm_fwd", "rmsnorm_bwd"):
        km, pm, lm, bm, by = rows[name]
        print(f"{name} ({R}, {D}) bf16: kernel {km:.4f} ms, plain {pm:.4f} "
              f"ms, F.rms_norm {lm:.4f} ms, bound {bm:.5f} ms ({by})")
    rows["rmsnorm_fwd@device"] = (
        device_ms(lambda: rn.rmsnorm_fwd(x, w), 20, flush),
        device_ms(lambda: F.rms_norm(x, (D,), wb, eps=1e-6), 20, flush))
    rows["rmsnorm_bwd@device"] = (
        device_ms(lambda: rn.rmsnorm_bwd(x, w, rstd, dy), 20, flush),
        device_ms(lambda: torch.autograd.grad(
            ly, (xr, wbr), dy, retain_graph=True), 20, flush))
    # the forward at qk-norm's rows: B x S x heads rows of hd
    xq = torch.randn((TRAIN_B * TRAIN_S * H, HD), generator=gen,
                     device="cuda").to(bf)
    wq = 1.0 + 0.1 * torch.randn(HD, generator=gen, device="cuda")
    wqb = wq.to(bf)
    Rq = xq.shape[0]
    rows["rmsnorm_fwd@qk_norm"] = (
        time_ms(lambda: rn.rmsnorm_fwd(xq, wq), 20, flush),
        time_ms(lambda: rn.rmsnorm_ref(xq, wq), 20, flush),
        time_ms(lambda: F.rms_norm(xq, (HD,), wqb, eps=1e-6), 20, flush),
        1e3 * (2 * Rq * HD * 2 + HD * 4 + Rq * 4) / PEAK_BYTES_S, "bytes",
        device_ms(lambda: rn.rmsnorm_fwd(xq, wq), 20, flush),
        device_ms(lambda: F.rms_norm(xq, (HD,), wqb, eps=1e-6), 20, flush))
    # the backward at qk-norm's rows
    dyq = torch.randn_like(xq)
    _, rstdq = rn.rmsnorm_fwd(xq, wq)
    xqr, wqr = xq.detach().requires_grad_(True), wq.detach().requires_grad_(
        True)
    pyq = rn.rmsnorm_ref(xqr, wqr)
    wqbr = wqb.detach().requires_grad_(True)
    lyq = F.rms_norm(xqr, (HD,), wqbr, eps=1e-6)
    rows["rmsnorm_bwd@qk_norm"] = (
        time_ms(lambda: rn.rmsnorm_bwd(xq, wq, rstdq, dyq), 20, flush),
        time_ms(lambda: torch.autograd.grad(
            pyq, (xqr, wqr), dyq, retain_graph=True), 20, flush),
        time_ms(lambda: torch.autograd.grad(
            lyq, (xqr, wqbr), dyq, retain_graph=True), 20, flush),
        1e3 * (3 * Rq * HD * 2 + Rq * 4 + 2 * HD * 4) / PEAK_BYTES_S,
        "bytes",
        device_ms(lambda: rn.rmsnorm_bwd(xq, wq, rstdq, dyq), 20, flush),
        device_ms(lambda: torch.autograd.grad(
            lyq, (xqr, wqbr), dyq, retain_graph=True), 20, flush))
    for name in ("rmsnorm_fwd", "rmsnorm_bwd"):
        kd_, ld_ = rows[f"{name}@device"]
        print(f"{name} ({R}, {D}) bf16 device time: kernel {kd_:.4f} ms, "
              f"F.rms_norm {ld_:.4f} ms")
    for name in ("rmsnorm_fwd", "rmsnorm_bwd"):
        km, pm, lm, bm, by, kd_, ld_ = rows[f"{name}@qk_norm"]
        print(f"{name} ({Rq}, {HD}) bf16: kernel {km:.4f} ms (device "
              f"{kd_:.4f}), plain {pm:.4f} ms, F.rms_norm {lm:.4f} ms "
              f"(device {ld_:.4f}), bound {bm:.5f} ms ({by})")
    return rows


def time_paged(flush, q, pk, pv, table, lens, lengths, S):
    """Paged attention at one bf16 serve shape (qwen3_1p7b's heads): the
    kernel (CUDA events, and the call's device work alone,
    ``device_ms``), the plain version, SDPA on the gathered view (the
    pages gathered beforehand, K/V repeated over the g heads, a boolean
    causal mask; events and device time) and the bound."""
    import torch
    from repro_torch.kernels import paged_attention as pa
    B, P = q.shape[0], table.shape[1]
    rows_idx = (table.long()[:, :, None] * PAGE
                + torch.arange(PAGE, device="cuda")).reshape(B, -1)
    g = H // HKV
    kd = pk.view(-1, HKV, HD)[rows_idx].transpose(1, 2) \
        .repeat_interleave(g, dim=1)
    vd = pv.view(-1, HKV, HD)[rows_idx].transpose(1, 2) \
        .repeat_interleave(g, dim=1)
    qd = q.transpose(1, 2)
    qpos = lens.long()[:, None] + torch.arange(S, device="cuda")
    mask = (torch.arange(kd.shape[2], device="cuda")[None, None, None, :]
            <= qpos[:, None, :, None])
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def kernel():
        return pa.paged_flash_attention(q, pk, pv, table, lens)

    def library():
        return sdpa(qd, kd, vd, attn_mask=mask)
    bound, by = attn_bound_ms(B, S, lengths, P, 2)
    return {"ms": time_ms(kernel, flush=flush),
            "device_ms": device_ms(kernel, 20, flush),
            "plain_ms": time_ms(lambda: pa.paged_attention_ref(
                q, pk, pv, table, lens), flush=flush),
            "library_ms": time_ms(library, flush=flush),
            "library_device_ms": device_ms(library, 20, flush),
            "bound_ms": bound, "bound_by": by}


def make_queue(rng, V):
    """The serve smoke queue: 8 requests, prompts of 32-300 tokens, most
    starting with a common 64-token prefix, 16-32 new tokens, half greedy
    and half temperature 0.8 / top-k 40 / top-p 0.95."""
    import numpy as np
    from repro_torch.serve.engine import Request
    prefix = rng.integers(0, V, 64).astype(np.int32)
    reqs = []
    for i in range(8):
        n = int(rng.integers(32, 301))
        p = rng.integers(0, V, n).astype(np.int32)
        if i % 3 != 2 and n > 64:
            p[:64] = prefix                  # shared 64-token prefix
        sampled = i % 2 == 1
        reqs.append(Request(prompt=p, max_new_tokens=int(rng.integers(16, 33)),
                            temperature=0.8 if sampled else 0.0,
                            top_k=40 if sampled else 0,
                            top_p=0.95 if sampled else 1.0,
                            seed=int(rng.integers(0, 2**31))))
    return reqs


def serve_counts():
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import paged_ssm as ps
    from repro_torch.kernels import sampling as sp
    return {"paged_flash_attention": pa.paged_flash_attention.launches,
            "paged_ssm_update": ps.paged_ssm_update.launches,
            "topk_topp_mask": sp.topk_topp_mask.launches,
            "rmsnorm_fwd": train_counts()["rmsnorm_fwd"]}


def reset_serve_counts():
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import paged_ssm as ps
    from repro_torch.kernels import sampling as sp
    for fn in (pa.paged_flash_attention, ps.paged_ssm_update,
               sp.topk_topp_mask):
        fn.launches = 0
    reset_train_counts()


def serve_queue(engine, rng, per_wave):
    """``ServeEngine.generate`` on the smoke queue, every launch counter
    set to 0 just before and read just after. Fails unless every request
    emits its tokens inside the vocab, each kernel in ``per_wave`` ran
    exactly that many times per wave, and sampling and RMSNorm ran.
    Returns the launch counts."""
    import torch
    name = engine.rcfg.model.name
    V = engine.rcfg.model.vocab_size
    reqs = make_queue(rng, V)
    reset_serve_counts()
    t0 = time.perf_counter()
    out = engine.generate(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = serve_counts()
    st = engine.scheduler.stats
    thr = engine.scheduler.throughput()
    for i, r in enumerate(out):
        if r.error is not None or len(r.output) != r.max_new_tokens:
            fail(f"{name} request {i}: error={r.error} "
                 f"tokens={len(r.output)}/{r.max_new_tokens}")
        if not ((r.output >= 0) & (r.output < V)).all():
            fail(f"{name} request {i}: token ids outside the vocab")
    waves = st["prefill_calls"] + st["decode_steps"]
    for kernel, n in per_wave.items():
        if launches[kernel] != n * waves:
            fail(f"{name}: {kernel} launched {launches[kernel]} times, "
                 f"want {n} per wave x {waves} waves")
    if launches["topk_topp_mask"] <= 0 or launches["rmsnorm_fwd"] <= 0:
        fail(f"{name}: a kernel of the path never launched: {launches}")
    ttft = sorted(r.ttft_s for r in out)
    n_tok = sum(len(r.output) for r in out)
    print(f"serve {name}: 8 requests, {st['prefill_tokens']} prompt tokens "
          f"prefilled ({st['shared_tokens']} shared), {n_tok} tokens out in "
          f"{wall:.2f} s; {st['prefill_calls']} prefill + "
          f"{st['decode_steps']} decode waves")
    print(f"serve {name}: decode {thr['decode_tok_s']:.1f} tok/s, prefill "
          f"{thr['prefill_tok_s']:.1f} tok/s, TTFT p50 {ttft[4]:.3f} s max "
          f"{ttft[-1]:.3f} s, end-to-end {n_tok / wall:.1f} tok/s")
    print(f"serve {name}: launches {launches}; per wave "
          + ", ".join(f"{k} {v}" for k, v in per_wave.items()))
    return launches


def step_check(engine, step, init_pool, rng):
    """One prefill (S=64) and one decode step, fused kernels vs the
    gathered path with every plain version (norms included). In float32
    the two must agree closely; in bf16 the kernel path must be no
    further from the float32 reference than the plain bf16 path is
    (times STEP_BF16_FACTOR) — bf16 rounding through a random-weight
    model's layers moves logits by a few percent either way."""
    import torch
    be = engine.backend
    rcfg = engine.rcfg
    cfg = rcfg.model
    rcfg32 = rcfg.replace(model=dataclasses.replace(cfg, dtype="float32"))
    variants = {"f32 fused": (engine.params, rcfg32, True),
                "f32 gathered": (engine.params, rcfg32, False),
                "bf16 fused": (be.params, rcfg, True),
                "bf16 gathered": (be.params, rcfg, False)}
    pools = {k: init_pool(r) for k, (_, r, _) in variants.items()}
    table = (1 + torch.arange(MAX_BATCH * 8, device="cuda")).reshape(
        MAX_BATCH, 8).to(torch.int32)
    lengths = torch.zeros(MAX_BATCH, dtype=torch.int32, device="cuda")
    n_new = torch.tensor([64, 50, 33, 10], device="cuda")
    for i, S in enumerate((64, 1)):
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                             (MAX_BATCH, S))).cuda()
        lg = {}
        for k, (prm, r, fused) in variants.items():
            with contextlib.nullcontext() if fused else plain_kernels():
                logit, _ = step(prm, pools[k], toks, lengths, n_new, table,
                                r, fused=fused)
            lg[k] = logit.float()
            if not torch.isfinite(lg[k]).all():
                fail(f"{cfg.name}: non-finite logits ({k})")
        ref = lg["f32 gathered"]

        def rel(k, ref=ref, lg=lg):
            return ((lg[k] - ref).abs().max() / ref.abs().max()).item()
        e32, ek, ep = rel("f32 fused"), rel("bf16 fused"), rel("bf16 gathered")
        print(f"{cfg.name} fused vs gathered step {i} (S={S}): float32 "
              f"max|diff|/max|logit| = {e32:.3e} (tolerance {STEP_F32_TOL:g});"
              f" bf16 vs the float32 reference: kernel path {ek:.3e}, plain "
              f"path {ep:.3e} (tolerance {STEP_BF16_FACTOR:g}x plain)")
        if not e32 <= STEP_F32_TOL or not ek <= STEP_BF16_FACTOR * ep:
            fail(f"{cfg.name}: fused and gathered steps disagree at step {i}")
        lengths = lengths + n_new.to(torch.int32)
        n_new = torch.ones(MAX_BATCH, dtype=torch.long, device="cuda")


def profile_decode_wave(be, name):
    """Where a steady decode wave's device time goes: B=4 at contexts
    DECODE_LENS, 2 of 4 slots sampled, 5 waves under the profiler."""
    import numpy as np
    import torch
    from repro_torch.serve.cache import SlotBatch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    scratch = be.init_state(1 + MAX_BATCH * (MAX_LEN // PAGE))
    ptab = (1 + np.arange(MAX_BATCH * (MAX_LEN // PAGE))).reshape(
        MAX_BATCH, -1).astype(np.int32)
    slots = SlotBatch.greedy(MAX_BATCH, ptab, lengths=DECODE_LENS)
    slots.temps[1::2] = 0.8
    slots.top_ks[1::2] = 40
    slots.top_ps[1::2] = 0.95
    tok = np.ones((MAX_BATCH, 1), np.int32)
    for _ in range(2):
        be.step(scratch, slots, tok)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        be.step(scratch, slots, tok)      # each step reads its tokens back
    bare = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(5):
            be.step(scratch, slots, tok)
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
    # device-side rows only (kernels, copies): summing the host ops' device
    # time as well would count every kernel twice
    kern = [e for e in prof.key_averages()
            if getattr(e, "device_type", None) == DeviceType.CUDA]
    busy = sum(dev_us(e) for e in kern) / 1e6
    print(f"{name} decode wave (B=4, contexts {DECODE_LENS}, 2 of 4 slots "
          f"sampled): {1e3 * bare / 5:.2f} ms wall ({1e3 * window / 5:.2f} "
          f"ms under the profiler), "
          + (f"device busy {1e3 * busy / 5:.2f} ms per wave = "
             f"{100 * busy / bare:.1f}% of the unprofiled wave, "
             f"{sum(e.count for e in kern) // 5} device ops per wave"
             if kern else "device busy not measured (no device events)"))
    for e in sorted(kern, key=dev_us, reverse=True)[:10]:
        print(f"  {dev_us(e) / 5 / 1e3:8.4f} ms/wave  {e.count // 5:4d}x  "
              f"{e.key[:80]}")


def serve_ssm(arch, seed):
    """Serve ``arch`` (an SSM or hybrid config) at full width and full
    depth: the smoke queue, the fused-vs-gathered step check and a
    profiled decode wave. Returns the queue's launch counts."""
    import functools

    import numpy as np
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.models import transformer
    from repro_torch.serve.engine import ServeEngine
    rcfg = get_config(arch, "decode_32k")
    cfg, s = rcfg.model, rcfg.model.ssm
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = transformer.init_model(rcfg, seed=seed, device="cuda")
    engine = ServeEngine(rcfg, params, max_batch=MAX_BATCH, page_size=PAGE,
                         max_len=MAX_LEN, device="cuda")
    torch.cuda.synchronize()
    n_pages = 1 + MAX_BATCH * 8
    if cfg.family == "ssm":
        n_ssm, n_attn = transformer.stacked_layer_depth(rcfg), 0
        step = functools.partial(transformer.ssm_paged_decode_step,
                                 page_size=PAGE)

        def init_pool(r):
            return transformer.init_paged_ssm_cache(r, n_pages,
                                                    device="cuda")
        shape = (f"{n_ssm} stacked mamba1 layers ({cfg.n_layers} + "
                 f"{n_ssm - cfg.n_layers} gate-0 padded)")
    else:
        n_ssm, n_attn = cfg.n_layers, cfg.n_layers // cfg.hybrid_attn_every
        step = functools.partial(transformer.hybrid_paged_decode_step,
                                 page_size=PAGE)

        def init_pool(r):
            return transformer.init_paged_hybrid_cache(r, n_pages, PAGE,
                                                       device="cuda")
        shape = (f"{n_ssm} mamba2 layers (headdim {s.headdim}) + a shared "
                 f"attention block ({cfg.n_heads}/{cfg.n_kv_heads} heads, hd "
                 f"{cfg.resolved_head_dim}) after every "
                 f"{cfg.hybrid_attn_every}: {n_attn} applications")
    print(f"model: {cfg.name} d_model={cfg.d_model} {shape}, d_inner="
          f"{s.expand * cfg.d_model} d_state={s.d_state} vocab="
          f"{cfg.vocab_size} dtype={cfg.dtype}; init + engine "
          f"{time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB on the card")
    per_wave = {"paged_ssm_update": n_ssm}
    if n_attn:
        per_wave["paged_flash_attention"] = n_attn
    rng = np.random.default_rng(seed)
    launches = serve_queue(engine, rng, per_wave)
    step_check(engine, step, init_pool, rng)
    profile_decode_wave(engine.backend, cfg.name)
    torch.cuda.synchronize()
    print(f"{cfg.name}: peak memory {torch.cuda.max_memory_allocated() / 2**30:.1f}"
          f" GiB")
    return launches


def ssm_kernel_case(gen, order, S, lengths, n_new):
    """Full-width rows-layout inputs for one order (R, ds from SSM_ROWS)
    on a pool of MAX_BATCH slots x MAX_LEN // PAGE pages in random order,
    with the compact plan the mixers build. Mamba2's A is the per-head
    decay broadcast across d_state (stride 0), as on the main path."""
    import torch
    from repro_torch.models import ssm as tssm
    R, ds = SSM_ROWS[order]
    P = MAX_LEN // PAGE
    n_pages = 1 + MAX_BATCH * P

    def r(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    dt = torch.nn.functional.softplus(r(MAX_BATCH, S, R)) * 0.2
    if order == "dbx":
        A = -torch.exp(r(R, ds))
    else:
        A = (-torch.exp(r(R // 64))).repeat_interleave(64)[:, None] \
            .expand(R, ds)
    perm = torch.randperm(n_pages - 1, generator=gen, device="cuda") + 1
    table = perm.reshape(MAX_BATCH, P).to(torch.int32)
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    nn = torch.tensor(n_new, dtype=torch.int32, device="cuda")
    t_w, phys_w = tssm.compact_snapshot_steps(table, lens, nn, PAGE, S)
    read_page, live = tssm.paged_read_plan(table, lens, PAGE)
    return (dt, r(MAX_BATCH, S, R), r(MAX_BATCH, S, ds), r(MAX_BATCH, S, ds),
            A, r(n_pages, R, ds), (read_page, live, phys_w, t_w), nn)


def check_ssm_kernel(gen):
    """The paged SSM kernel against its plain version at both full-width
    shapes: y on valid rows and the non-scratch pages within SSM_TOL of
    max|plain|, pages outside the plan bit-identical, a second launch
    bit-identical. Returns the largest abs error of y per order."""
    import torch
    from repro_torch.kernels import paged_ssm as ps
    err = {}
    for order in ("dbx", "dxb"):
        R, ds = SSM_ROWS[order]
        for S, lengths, n_new in SSM_CASES:
            dt, x, Bm, Cm, A, pool, plan, nn = ssm_kernel_case(
                gen, order, S, lengths, n_new)
            pools = [pool.clone() for _ in range(3)]
            want = ps.paged_ssm_update_ref(dt, x, Bm, Cm, A, pools[0], *plan,
                                           nn, order=order)
            got, again = (ps.paged_ssm_update(dt, x, Bm, Cm, A, p, *plan, nn,
                                              order=order)
                          for p in pools[1:])
            torch.cuda.synchronize()
            valid = (torch.arange(S, device="cuda")[None, :]
                     < nn[:, None])[..., None]
            e_y = _scaled_err(got * valid, want * valid)
            e_pool = _scaled_err(pools[1][1:], pools[0][1:])
            abs_y = ((got - want) * valid).abs().max().item()
            planned = torch.zeros(pool.shape[0], dtype=torch.bool,
                                  device="cuda")
            planned[plan[2].reshape(-1).long()] = True
            planned[0] = True
            kept = torch.equal(pools[1][~planned], pool[~planned])
            same = torch.equal(got, again) and torch.equal(pools[1],
                                                           pools[2])
            print(f"paged_ssm_update {order} R={R} ds={ds} S={S:3d} lengths "
                  f"{lengths} n_new {n_new}: y max|kernel-plain| {abs_y:.3e}"
                  f" = {e_y:.3e} of max|plain|, pool[1:] {e_pool:.3e} "
                  f"(tolerance {SSM_TOL:g}); unplanned pages kept {kept}, "
                  f"second launch bit-identical {same}")
            if not (e_y <= SSM_TOL and e_pool <= SSM_TOL and kept and same):
                fail(f"paged_ssm_update {order} S={S} disagrees with its "
                     "plain version")
            err[order] = max(err.get(order, 0.0), abs_y)
    return err


def ssm_bound_ms(order, S, lengths, n_new, plan):
    """Least time for one paged SSM update on these inputs: the bytes it
    must move (dt and x at the active steps, y, B and C, A's distinct
    values, the live read pages and the pages written, the plan) over
    the HBM rate, vs 7 float32 operations (exp included) per state
    element and active step over the non-tensor float32 peak."""
    R, ds = SSM_ROWS[order]
    steps = sum(min(S, n) for n in n_new)
    live = sum(1 for n in lengths if n > 0)
    written = int((plan[2] != 0).sum())
    W = plan[2].shape[1]
    a_bytes = R * ds * 4 if order == "dbx" else R * 4
    nbytes = (2 * steps * R * 4 + MAX_BATCH * S * R * 4
              + 2 * MAX_BATCH * S * ds * 4 + a_bytes
              + (live + written) * R * ds * 4 + MAX_BATCH * (3 + 2 * W) * 4)
    ops = 7 * steps * R * ds
    t_b, t_o = nbytes / PEAK_BYTES_S, ops / PEAK_F32_FLOP_S
    return 1e3 * max(t_b, t_o), "bytes" if t_b >= t_o else "operations"


def time_ssm_kernel(gen, flush):
    """Kernel (CUDA events around the wrapper call, and the kernel's
    device time, ``device_ms``), plain and bound times of the paged
    SSM update at both full-width shapes: decode (B=4, S=1, contexts
    DECODE_LENS) and a 256-token prefill chunk. No single PyTorch call
    computes the paged scan (a snapshot-paged selective scan), so there
    is no library time."""
    from repro_torch.kernels import paged_ssm as ps
    rows = {}
    for order in ("dbx", "dxb"):
        R, ds = SSM_ROWS[order]
        for S, lengths, n_new in ((1, DECODE_LENS, [1] * MAX_BATCH),
                                  (256, [0, 37, 200, 256],
                                   [256] * MAX_BATCH)):
            dt, x, Bm, Cm, A, pool, plan, nn = ssm_kernel_case(
                gen, order, S, lengths, n_new)
            args = (dt, x, Bm, Cm, A, pool, *plan, nn)
            k_ms = time_ms(lambda a=args, o=order: ps.paged_ssm_update(
                *a, order=o), flush=flush)
            d_ms = device_ms(lambda a=args, o=order: ps.paged_ssm_update(
                *a, order=o), 20, flush)
            p_ms = time_ms(lambda a=args, o=order: ps.paged_ssm_update_ref(
                *a, order=o), iters=20 if S == 1 else 3, flush=flush)
            b_ms, by = ssm_bound_ms(order, S, lengths, n_new, plan)
            print(f"paged_ssm_update {order} R={R} ds={ds} B={MAX_BATCH} "
                  f"S={S}: kernel {k_ms:.4f} ms (device {d_ms:.4f} ms), "
                  f"plain {p_ms:.4f} ms, bound {b_ms:.5f} ms ({by}), "
                  "library none")
            rows[(order, S)] = (k_ms, d_ms, p_ms, b_ms, by)
    return rows


def main() -> int:
    t_start = time.perf_counter()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device is available")
    try:
        from repro_torch.configs.registry import get_config
        from repro_torch.kernels import build
        from repro_torch.kernels import paged_attention as pa
        from repro_torch.kernels import sampling as sp
        from repro_torch.launch.steps import apply_top_k_top_p
        from repro_torch.models import transformer
        from repro_torch.serve.engine import ServeEngine
    except ImportError as e:
        fail(f"the port is not importable next to this script ({e})")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- 1. card, versions, build ------------------------------------------
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} "
          f"device {torch.cuda.get_device_name(0)} "
          f"x{torch.cuda.device_count()}")
    t0 = time.perf_counter()
    logs = build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s wall for "
          f"{', '.join(f'{k} ({v[0]:.1f} s)' for k, v in logs.items())}")
    for name, (_, log) in logs.items():
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
        spills = re.findall(r"[1-9]\d* bytes spill \w+", log)
        serial = len(re.findall(r"wgmma.mma_async instructions are "
                                r"serialized", log))
        print(f"  {name}: {len(regs)} kernels, registers "
              f"{min(regs, default=0)}-{max(regs, default=0)}, spills "
              f"{spills or 'none'}"
              + (f", {serial} kernels with serialised wgmma" if serial
                 else ""))
    sass_checks()

    # -- 2. kernels vs plain versions at the serve shapes -------------------
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    attn_err = {}
    # qwen3_1p7b's GQA heads, then zamba2_1p2b's shared attention (MHA,
    # 32/32 heads of hd 64)
    for heads, cases in (((H, HKV, HD), ((1, [300, 17, 129, 0]),
                                         (64, [0, 37, 200, 448]),
                                         (256, [0, 37, 200, 256]))),
                         ((32, 32, 64), ((1, [300, 17, 129, 0]),
                                         (64, [0, 37, 200, 448]),
                                         (256, [0, 37, 200, 256])))):
        for dtype in (torch.bfloat16, torch.float32):
            dname = str(dtype).split(".")[1]
            for S, lengths in cases:
                # a full table of 48 pages a slot, wider than the live
                # bucket's 32, so the two tables give the split-KV path
                # different grids
                case = attn_case(gen, MAX_BATCH, S, lengths, dtype,
                                 MAX_LEN // PAGE + 16, poison=1e30,
                                 heads=heads)
                q, pk, pv, table, lens = case
                cut = table[:, :live_bucket(lengths, S)]
                want = pa.paged_attention_ref(q, pk, pv, cut, lens).float()
                got = pa.paged_flash_attention(q, pk, pv, cut, lens)
                full = pa.paged_flash_attention(q, pk, pv, table, lens)
                again = pa.paged_flash_attention(q, pk, pv, cut, lens)
                torch.cuda.synchronize()
                path = "split-KV" if pa.plan(dtype, MAX_BATCH, S, *heads,
                                             PAGE, cut.shape[1]).split \
                    else "multi-row"
                shape = f"H={heads[0]}/{heads[1]} hd={heads[2]} S={S:3d}"
                if not torch.equal(got, full):
                    fail(f"paged attention {shape} {dname}: the live-bucket "
                         "table changed the output")
                if not torch.equal(got, again):
                    fail(f"paged attention {shape} {dname}: a second launch "
                         "changed the output")
                err = (got.float() - want).abs().max().item()
                print(f"paged_flash_attention {shape} {dname:8s} ({path}) "
                      f"max|kernel-plain| = {err:.3e} (tolerance "
                      f"{ATTN_TOL[dname]:g}); live-bucket table ({cut.shape[1]}"
                      f" pages) == full ({table.shape[1]}) == second launch, "
                      "bitwise")
                if not err <= ATTN_TOL[dname]:
                    fail(f"paged attention {shape} {dname} error {err:.3e}")
                attn_err[dname] = max(attn_err.get(dname, 0.0), err)
    logits, ks, ps = sampling_case(gen, 8, 151936)
    want = sp.topk_topp_mask_ref(logits, ks, ps)
    got = sp.topk_topp_mask(logits, ks, ps)
    torch.cuda.synchronize()
    keep_w, keep_g = want > -1e30, got > -1e30
    both = keep_w & keep_g
    samp_err = (got[both] - want[both]).abs().max().item()
    tv = flipped_mass(logits, keep_w, keep_g)
    print(f"topk_topp_mask B=8 V=151936: survivors max|kernel-plain| = "
          f"{samp_err:.3e} (tolerance 0), {int((keep_w != keep_g).sum())} "
          f"borderline tokens differ, mass {tv:.3e} (tolerance "
          f"{SAMPLING_TV:g}); kept per row {keep_g.sum(-1).tolist()}")
    if samp_err != 0.0 or not tv <= SAMPLING_TV:
        fail("sampling mask disagrees with its plain version")
    ssm_err = check_ssm_kernel(gen)
    train_err = check_train_kernels(gen)
    train_err.update(check_scan_kernel(gen))
    gc.collect()
    torch.cuda.empty_cache()

    # -- 2b. training kernels' times at the training shapes (before the
    # long profiler sessions of the later phases) --------------------------
    flush = torch.empty(64 * 2**20 // 4, device="cuda")   # > 50 MB L2
    train_rows = time_train_kernels(gen, flush, train_err)
    scan_rows = time_scan_kernels(gen, flush, train_err)
    gc.collect()
    torch.cuda.empty_cache()

    # -- 3. serve qwen3_1p7b at full width through the kernels --------------
    rcfg = get_config("qwen3_1p7b", "decode_32k")
    cfg = rcfg.model
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    params = transformer.init_model(rcfg, seed=0, device="cuda")
    engine = ServeEngine(rcfg, params, max_batch=MAX_BATCH, page_size=PAGE,
                         max_len=MAX_LEN, device="cuda")
    torch.cuda.synchronize()
    n_layers = transformer.stacked_layer_depth(rcfg)
    print(f"model: {cfg.name} d_model={cfg.d_model} layers={cfg.n_layers} "
          f"(+{n_layers - cfg.n_layers} gate-0 padded) heads={cfg.n_heads}/"
          f"{cfg.n_kv_heads} vocab={cfg.vocab_size} dtype={cfg.dtype}; "
          f"init + engine {time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB on the card")
    rng = np.random.default_rng(0)
    launches = serve_queue(engine, rng,
                           {"paged_flash_attention": n_layers})
    step_check(engine, transformer.paged_decode_step,
               lambda r: transformer.init_paged_cache(
                   r, 1 + MAX_BATCH * 8, PAGE, device="cuda"), rng)
    profile_decode_wave(engine.backend, cfg.name)
    print(f"{cfg.name}: peak memory {torch.cuda.max_memory_allocated() / 2**30:.1f}"
          f" GiB")

    # -- 4. times at the serve shapes ---------------------------------------
    q, pk, pv, table, lens = attn_case(gen, MAX_BATCH, 1, DECODE_LENS,
                                       torch.bfloat16, MAX_LEN // PAGE,
                                       poison=0.0)
    P = live_bucket(DECODE_LENS, 1)
    cut = table[:, :P]
    decode_plan = pa.plan(torch.bfloat16, MAX_BATCH, 1, H, HKV, HD, PAGE, P)
    blocks = decode_plan.grid[0] * decode_plan.grid[1] // HKV
    print(f"paged_flash_attention decode plan at P={P}: {decode_plan}; "
          f"{blocks} blocks per (KV head, slot)")
    if not decode_plan.split or blocks <= 1:
        fail("the decode shape does not take the split-KV grid")
    attn = time_paged(flush, q, pk, pv, cut, lens, DECODE_LENS, 1)
    print(f"paged_flash_attention decode B=4 S=1 bf16 P={P}: kernel "
          f"{attn['ms']:.4f} ms (device {attn['device_ms']:.4f}), plain "
          f"{attn['plain_ms']:.4f} ms, SDPA on the gathered view "
          f"{attn['library_ms']:.4f} ms (device "
          f"{attn['library_device_ms']:.4f}), bound {attn['bound_ms']:.5f}"
          f" ms ({attn['bound_by']}); x{n_layers} per wave")
    pre_len = [0, 37, 100, 200]
    qp, pkp, pvp, tp_, lp = attn_case(gen, MAX_BATCH, 256, pre_len,
                                      torch.bfloat16, MAX_LEN // PAGE, 0.0)
    Pp = live_bucket(pre_len, 256)
    pre = time_paged(flush, qp, pkp, pvp, tp_[:, :Pp], lp, pre_len, 256)
    print(f"paged_flash_attention prefill B=4 S=256 bf16 P={Pp}: kernel "
          f"{pre['ms']:.4f} ms (device {pre['device_ms']:.4f}), plain "
          f"{pre['plain_ms']:.4f} ms, SDPA on the gathered view "
          f"{pre['library_ms']:.4f} ms (device "
          f"{pre['library_device_ms']:.4f}), bound {pre['bound_ms']:.5f} ms "
          f"({pre['bound_by']})")

    V = cfg.vocab_size
    sl, sks, sps = sampling_case(gen, MAX_BATCH, V)
    s_ms = time_ms(lambda: sp.topk_topp_mask(sl, sks, sps), flush=flush)
    s_plain = time_ms(lambda: sp.topk_topp_mask_ref(sl, sks, sps),
                      flush=flush)
    s_sort = time_ms(lambda: apply_top_k_top_p(sl, sks, sps), flush=flush)
    s_bound = 1e3 * (2 * MAX_BATCH * V * 4 + MAX_BATCH * 8) / PEAK_BYTES_S
    print(f"topk_topp_mask B=4 V={V}: kernel {s_ms:.4f} ms, plain "
          f"{s_plain:.4f} ms, sort-based apply_top_k_top_p {s_sort:.4f} ms,"
          f" bound {s_bound:.5f} ms (bytes)")
    ssm_rows = time_ssm_kernel(gen, flush)
    del engine, params, q, pk, pv, qp, pkp, pvp
    gc.collect()
    torch.cuda.empty_cache()

    # -- 5. serve falcon_mamba_7b and zamba2_1p2b at full width and depth ---
    ssm_launches = {}
    for arch, order in (("falcon_mamba_7b", "dbx"), ("zamba2_1p2b", "dxb")):
        ssm_launches[order] = serve_ssm(arch, seed=1)
        gc.collect()
        torch.cuda.empty_cache()

    # -- 6. training: gradients at reduced depth, then full depth ----------
    check_train_grads()
    gc.collect()
    torch.cuda.empty_cache()
    attn_kernels = ("flash_attention_fwd", "flash_attention_bwd",
                    "rmsnorm_fwd", "rmsnorm_bwd")
    scan_kernels = ("ssm_scan_fwd", "ssm_scan_bwd")
    train_launches, _, _ = run_train(qwen3_train_config(), attn_kernels)
    gc.collect()
    torch.cuda.empty_cache()

    # -- 7. SSM training: gradients at reduced depth, then path A (falcon,
    # MGRIT) and path B (zamba2, serial) at full width ----------------------
    check_ssm_train_grads()
    gc.collect()
    torch.cuda.empty_cache()
    ssm_train = {}
    for fam, rcfg, need in (
            ("falcon", falcon_train_config(),
             ("rmsnorm_fwd", "rmsnorm_bwd") + scan_kernels),
            ("zamba2", zamba2_train_config(), attn_kernels + scan_kernels)):
        ssm_train[fam] = run_train(rcfg, need)
        gc.collect()
        torch.cuda.empty_cache()

    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all")

    kernels = [
        {"name": "paged_flash_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
         "replaces": "src/repro/kernels/paged_attention.py:88",
         "launches": launches["paged_flash_attention"],
         "max_abs_err": attn_err["bfloat16"],
         # decode (S=1, split-KV; device_ms counts the combine kernel
         # too), prefill_* a 256-token chunk (tensor cores)
         **attn, **{f"prefill_{k}": v for k, v in pre.items()}},
        {"name": "topk_topp_mask", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/sampling.cu",
         "replaces": "src/repro/kernels/sampling.py:126",
         "launches": launches["topk_topp_mask"],
         "max_abs_err": samp_err, "ms": s_ms, "plain_ms": s_plain,
         "bound_ms": s_bound, "bound_by": "bytes", "library_ms": None,
         "sort_ms": s_sort},
    ]
    for name, src, line in (
            ("flash_attention_fwd", "flash_attention", 64),
            ("flash_attention_bwd", "flash_attention", 64),
            ("rmsnorm_fwd", "rmsnorm", 23), ("rmsnorm_bwd", "rmsnorm", 23)):
        km, pm, lm, bm, by = train_rows[name]
        row = {
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}.cu",
            "replaces": f"src/repro/kernels/{src}.py:{line}",
            "launches": train_launches[name], "max_abs_err": train_err[name],
            "ms": km, "plain_ms": pm, "bound_ms": bm, "bound_by": by,
            "library_ms": lm}
        if src == "rmsnorm":
            # device_* the device work alone (device_ms); qk_norm_* at
            # qk-norm's (131072, 128) rows
            row["device_ms"], row["library_device_ms"] = \
                train_rows[f"{name}@device"]
            row.update(zip(("qk_norm_ms", "qk_norm_plain_ms",
                            "qk_norm_library_ms", "qk_norm_bound_ms",
                            "qk_norm_bound_by", "qk_norm_device_ms",
                            "qk_norm_library_device_ms"),
                           train_rows[f"{name}@qk_norm"], strict=True))
        if src == "flash_attention":
            # zamba2_1p2b's shape (B=1 H=32/32 hd=64) and its run's launches
            kz, pz, lz, bz, byz = train_rows[f"{name}@zamba2"]
            row.update(zamba2_ms=kz, zamba2_plain_ms=pz,
                       zamba2_library_ms=lz, zamba2_bound_ms=bz,
                       zamba2_bound_by=byz,
                       launches_zamba2=ssm_train["zamba2"][0][name])
        kernels.append(row)
    # one row per product order: falcon-mamba-7b's path launches "dbx",
    # zamba2-1.2b's "dxb"; ms/plain_ms/bound_ms at decode (S=1), prefill_*
    # at a 256-token chunk, device_* the device work alone; no
    # single PyTorch call computes the paged scan
    for order in ("dbx", "dxb"):
        km, dm, pm, bm, by = ssm_rows[(order, 1)]
        kp, dp, pp, bp, _ = ssm_rows[(order, 256)]
        kernels.append({
            "name": f"paged_ssm_update_{order}", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/paged_ssm.cu",
            "replaces": "src/repro/kernels/paged_ssm.py:92",
            "launches": ssm_launches[order]["paged_ssm_update"],
            "max_abs_err": ssm_err[order], "ms": km, "plain_ms": pm,
            "bound_ms": bm, "bound_by": by, "library_ms": None,
            "device_ms": dm, "prefill_ms": kp, "prefill_device_ms": dp,
            "prefill_plain_ms": pp, "prefill_bound_ms": bp})
    # path A (falcon-mamba-7b, MGRIT) and path B (zamba2-1.2b, serial):
    # launches over Trainer.train(3) summed, per path, and per profiled
    # step; ms/plain_ms/bound_ms/device_ms at path A's shape, zamba2_* at
    # path B's; device_* the device work alone (device_ms)
    for name in scan_kernels:
        km, pm, bm, by, dm = scan_rows[(name, "falcon")]
        kz, pz, bz, byz, dz = scan_rows[(name, "zamba2")]
        per_path = {fam: ssm_train[fam][0][name] for fam in ssm_train}
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/ssm_scan.cu",
            "replaces": "src/repro/kernels/ssm_scan.py:50",
            "launches": sum(per_path.values()),
            "max_abs_err": train_err[name], "ms": km, "plain_ms": pm,
            "bound_ms": bm, "bound_by": by, "library_ms": None,
            "launches_falcon": per_path["falcon"],
            "launches_zamba2": per_path["zamba2"],
            "launches_per_step": {
                f"{fam} {mode}": n[name] for fam in ssm_train
                for mode, n in ssm_train[fam][1].items()},
            "zamba2_ms": kz, "zamba2_plain_ms": pz, "zamba2_bound_ms": bz,
            "zamba2_bound_by": byz, "device_ms": dm,
            "zamba2_device_ms": dz})
    counts = {"paged_flash_attention": launches["paged_flash_attention"],
              "topk_topp_mask": launches["topk_topp_mask"],
              **{k: train_launches[k] for k in attn_kernels},
              **{f"{k}_{fam}": ssm_train[fam][0][k]
                 for fam in ssm_train for k in scan_kernels},
              "paged_ssm_update_dbx":
                  ssm_launches["dbx"]["paged_ssm_update"],
              "paged_ssm_update_dxb":
                  ssm_launches["dxb"]["paged_ssm_update"]}
    print("kernels: " + ", ".join(f"{k}={v}" for k, v in counts.items()))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
