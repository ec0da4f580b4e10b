#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA card (H100 class).

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc`` with
``nvcc`` for ``sm_90a`` and holds each against its plain PyTorch version
(the training kernels forward and backward, in float32 and bf16, at the
training and serve shapes, with a bit-repeatability check of every
backward). Then it drives the port's
two paths, each with the launch counters set to 0 just before and read
just after: it serves ``qwen3_1p7b`` at full width (random weights from a
seed) through ``ServeEngine`` and compares one fused step with the
gathered plain path; it checks the training gradients at full width and
reduced depth (kernel path vs plain path vs direct autograd), then trains
full-width, full-depth ``qwen3_1p7b`` for three MGRIT steps through
``Trainer.train`` (adaptive probe at step 2) and profiles one MGRIT and
one serial step. Last it times each kernel beside its plain version, a
library yardstick and its bound, and holds the flash kernels against the
plain version at the training shape. Imports ``repro_torch``, torch and
numpy only. Exits non-zero, before printing any result, when no CUDA
device is available or the repository's ``src`` is missing; exits
non-zero on any mismatch. The last line is
``{"ok": true, "device": {...}}``; the lines before it are the launch
counts, the card's name and power limit, and one JSON object with every
kernel's numbers.
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
# (rows, width) the RMSNorm kernel sees: training ln / qk-norm rows; a
# decode wave's ln, q-norm and k-norm rows; a 512-token prefill bucket's
RMS_SHAPES = ((8192, 2048), (8192 * H, HD),
              (MAX_BATCH, 2048), (MAX_BATCH * H, HD), (MAX_BATCH * HKV, HD),
              (MAX_BATCH * 512, 2048), (MAX_BATCH * 512 * H, HD))


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0]


def time_ms(fn, iters: int = 20, flush=None) -> float:
    """Mean device time of ``fn`` from CUDA events, after warm-up. With
    ``flush`` (a large tensor) the L2 cache is overwritten before each
    timed launch, as a layer's caller would find it."""
    import torch
    for _ in range(3):
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


def attn_case(gen, B, S, lengths, dtype, n_slot_pages, poison):
    """Pools with per-slot random page tables; rows past each slot's last
    visible key hold ``poison`` (they must not move a bit)."""
    import torch
    dev = "cuda"
    n_pages = 1 + B * n_slot_pages
    q = (torch.randn((B, S, H, HD), generator=gen, device=dev) * 0.5) \
        .to(dtype)
    pk = (torch.randn((n_pages, PAGE, HKV, HD), generator=gen, device=dev)
          * 0.5).to(dtype)
    pv = (torch.randn((n_pages, PAGE, HKV, HD), generator=gen, device=dev)
          * 0.5).to(dtype)
    perm = torch.randperm(n_pages - 1, generator=gen, device=dev) + 1
    table = perm.reshape(B, n_slot_pages).to(torch.int32)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    for b in range(B):
        last = int(lengths[b]) + S - 1
        rows = (table[b].long()[:, None] * PAGE
                + torch.arange(PAGE, device=dev)).reshape(-1)
        dead = rows[last + 1:]
        pk.view(-1, HKV, HD)[dead] = poison
        pv.view(-1, HKV, HD)[dead] = poison
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
    float32 and bf16; each backward twice, bit-identical. Returns the
    largest bf16 absolute error of each kernel at the training shapes."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rn
    err = {"flash_attention_fwd": 0.0, "flash_attention_bwd": 0.0,
           "rmsnorm_fwd": 0.0, "rmsnorm_bwd": 0.0}
    grid = [(1, 4, 4, 128, 128, 64, True), (2, 4, 2, 128, 128, 32, True),
            (1, 8, 1, 256, 256, 64, True), (1, 2, 2, 128, 256, 64, False),
            (2, 2, 2, 384, 384, 128, True), (1, 4, 2, 100, 77, 64, True),
            (TRAIN_B, H, HKV, 1024, 1024, HD, True)]
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[1]
        tol = FLASH_TOL[dname]
        for B, h, hkv, Sq, Sk, hd, causal in grid:
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
            if dtype == torch.bfloat16 and Sq == 1024:
                err["flash_attention_fwd"] = e_out
                err["flash_attention_bwd"] = max(
                    (g.float() - w.float()).abs().max().item()
                    for g, w in zip(got[1:], want[1:]))
                qm, km, vm, dom = (x.transpose(1, 2).contiguous()
                                   for x in (q, k, v, do))
                o, lse = fa.flash_attention_fwd(qm, km, vm, True)
                first = fa.flash_attention_bwd(qm, km, vm, o, lse, dom, True)
                again = fa.flash_attention_bwd(qm, km, vm, o, lse, dom, True)
                torch.cuda.synchronize()
                if not all(torch.equal(a, b) for a, b in zip(first, again)):
                    fail("flash attention backward is not bit-repeatable")
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
    saved = ops.flash_attention, ops.rmsnorm
    before = train_counts()
    ops.flash_attention = lambda q, k, v, *, causal=True: \
        fa.flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2),
                               causal=causal).transpose(1, 2)
    ops.rmsnorm = rn.rmsnorm_ref
    try:
        yield
    finally:
        ops.flash_attention, ops.rmsnorm = saved
    if train_counts() != before:
        fail("a training kernel launched on the plain path")


def train_counts():
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rn
    return {"flash_attention_fwd": fa.flash_attention_fwd.launches,
            "flash_attention_bwd": fa.flash_attention_bwd.launches,
            "rmsnorm_fwd": rn.rmsnorm_fwd.launches,
            "rmsnorm_bwd": rn.rmsnorm_bwd.launches}


def reset_train_counts():
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rn
    for fn in (fa.flash_attention_fwd, fa.flash_attention_bwd,
               rn.rmsnorm_fwd, rn.rmsnorm_bwd):
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


def run_train():
    """Full-width, full-depth qwen3_1p7b: Trainer.train(3) in MGRIT mode
    with the probe at step 2, the training launch counters reset just
    before and read just after; then one more MGRIT step under the
    profiler."""
    import numpy as np
    import torch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import shard_batch
    from repro_torch.launch.steps import make_train_fn
    from repro_torch.models import transformer
    from repro_torch.train.trainer import Trainer
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    rcfg = get_config("qwen3_1p7b", "train_4k")
    rcfg = rcfg.replace(
        shape=ShapeConfig("train_4k", "train", TRAIN_S, TRAIN_B),
        microbatches=1,
        mgrit=dataclasses.replace(rcfg.mgrit, check_every=2))
    cfg, mg = rcfg.model, rcfg.mgrit
    t0 = time.perf_counter()
    trainer = Trainer(rcfg, seed=0)
    torch.cuda.synchronize()
    n_layers = transformer.stacked_layer_depth(rcfg)
    n_mid = n_layers - mg.n_open - mg.n_close
    n_real = cfg.n_layers - mg.n_open - mg.n_close
    print(f"train: {cfg.name} d_model={cfg.d_model} {n_layers} stacked "
          f"layers ({mg.n_open} open + {n_mid} ParallelNet, gate-0 padded "
          f"from {n_real}, + {mg.n_close} close), B={TRAIN_B} S={TRAIN_S} "
          f"(train_4k's global batch 256 cut to {TRAIN_B}, microbatches 1),"
          f" {cfg.dtype} compute, f32 params; MGRIT cf={mg.cf} "
          f"levels={mg.levels} fwd_iters={mg.fwd_iters} bwd_iters="
          f"{mg.bwd_iters}, probe every {mg.check_every}; init "
          f"{time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB")
    torch.cuda.reset_peak_memory_stats()
    reset_train_counts()
    rep = trainer.train(3, log_every=0)
    torch.cuda.synchronize()
    launches = train_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    for i, (loss, sec, norms, mode) in enumerate(zip(
            rep.losses, rep.step_seconds, rep.fwd_norms, rep.mode_trace)):
        print(f"train step {i} [{mode}]: loss {loss:.4f}, fwd_norms "
              f"{[float(f'{n:.4g}') for n in norms]}, {sec:.2f} s, "
              f"{TRAIN_B * TRAIN_S / sec:.0f} tokens/s")
    print(f"train: probe history (step, rho_fwd, rho_bwd) "
          f"{rep.controller_history}; switched_at {rep.switched_at}; peak "
          f"memory {peak:.1f} GiB; launches over 3 steps {launches}")
    if len(rep.losses) != 3 or not np.all(np.isfinite(rep.losses)):
        fail(f"train losses {rep.losses}")
    if not all(np.all(np.isfinite(n)) for n in rep.fwd_norms):
        fail(f"non-finite forward residual norms {rep.fwd_norms}")
    if [h[0] for h in rep.controller_history] != [2]:
        fail(f"the probe did not run at step 2: {rep.controller_history}")
    if min(launches.values()) <= 0:
        fail(f"a training kernel never launched: {launches}")

    # one step of each mode under the profiler, MGRIT (lp) first, each
    # on the next batch, whatever mode the controller is in now
    serial = rcfg.replace(mgrit=dataclasses.replace(mg, enabled=False))
    for mode, step_rcfg in (("MGRIT (lp)", rcfg), ("serial", serial)):
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
            fail(f"the profiled {mode} step's loss is {loss}")
        per_step = {k: v - before[k] for k, v in train_counts().items()}
        kern = [e for e in prof.key_averages()
                if getattr(e, "device_type", None) == DeviceType.CUDA]

        def dev_us(e):
            return getattr(e, "self_device_time_total",
                           getattr(e, "self_cuda_time_total", 0.0))
        busy = sum(dev_us(e) for e in kern) / 1e6
        print(f"one {mode} train step under the profiler: loss "
              f"{loss:.4f}, {window:.2f} s wall, "
              + (f"device busy {busy:.2f} s = {100 * busy / window:.1f}%, "
                 f"{sum(e.count for e in kern)} device ops"
                 if kern else "device busy not measured (no device events)")
              + f"; launches in this step {per_step}")
        for e in sorted(kern, key=dev_us, reverse=True)[:10]:
            print(f"  {dev_us(e) / 1e6:8.3f} s  {e.count:6d}x  {e.key[:80]}")
    return launches, rep


def flash_bound_ms(B, h, S, hd, itemsize, backward=False):
    """Least time at the training shape: causal pairs x (4 fwd, 10 bwd)
    x hd flops over the bf16 peak, vs each input and output once."""
    pairs = S * (S + 1) // 2
    ops = (10 if backward else 4) * hd * pairs * B * h
    n_q = B * S * h * hd * itemsize
    n_kv = 2 * B * S * HKV * hd * itemsize
    lse = B * h * S * 4
    nbytes = (3 * n_q + 2 * n_kv + lse) if backward else \
        (2 * n_q + n_kv + lse)        # bwd: q,o,dO + dq; fwd: q,o
    if backward:
        nbytes += n_kv                # dk, dv
    t_b, t_o = nbytes / PEAK_BYTES_S, ops / PEAK_BF16_FLOP_S
    return 1e3 * max(t_b, t_o), "bytes" if t_b >= t_o else "operations"


def time_train_kernels(gen, flush, err):
    """Kernel, plain and library times at the training shapes (bf16):
    attention B=2 S=4096 H=16/8 hd=128 causal; RMSNorm (8192, 2048). The
    attention kernels' out, dq, dk and dv at that shape are also held
    against the plain version's (``err`` takes their largest abs
    errors)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rn
    bf = torch.bfloat16
    q, do = (torch.randn((TRAIN_B, TRAIN_S, H, HD), generator=gen,
                         device="cuda").to(bf) for _ in range(2))
    k, v = (torch.randn((TRAIN_B, TRAIN_S, HKV, HD), generator=gen,
                        device="cuda").to(bf) for _ in range(2))
    o, lse = fa.flash_attention_fwd(q, k, v, True)
    out = {}
    out["flash_attention_fwd"] = time_ms(
        lambda: fa.flash_attention_fwd(q, k, v, True), 5, flush)
    out["flash_attention_bwd"] = time_ms(
        lambda: fa.flash_attention_bwd(q, k, v, o, lse, do, True), 5, flush)
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
    print(f"flash_attention B={TRAIN_B} H={H}/{HKV} Sq=Sk={TRAIN_S} hd={HD} "
          f"causal bfloat16 (the training shape): out max|kernel-plain| "
          f"{e_out:.3e}, dq/dk/dv max|kernel-plain|/max|plain| {e_grad:.3e} "
          f"({flash_tol_text('bfloat16')})")
    if not (out_ok and e_grad <= FLASH_TOL["bfloat16"]):
        fail("flash attention disagrees with its plain version at the "
             "training shape")
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
    fb, fby = flash_bound_ms(TRAIN_B, H, TRAIN_S, HD, 2)
    bb, bby = flash_bound_ms(TRAIN_B, H, TRAIN_S, HD, 2, backward=True)
    rows = {
        "flash_attention_fwd": (out["flash_attention_fwd"], plain_fwd,
                                lib_fwd, fb, fby),
        "flash_attention_bwd": (out["flash_attention_bwd"], plain_bwd,
                                lib_bwd, bb, bby),
        "rmsnorm_fwd": (out["rmsnorm_fwd"], rms_plain_fwd, rms_lib_fwd,
                        rb_fwd, "bytes"),
        "rmsnorm_bwd": (out["rmsnorm_bwd"], rms_plain_bwd, rms_lib_bwd,
                        rb_bwd, "bytes")}
    for name, (km, pm, lm, bm, by) in rows.items():
        shape = (f"B={TRAIN_B} S={TRAIN_S} H={H}/{HKV} hd={HD} causal"
                 if name.startswith("flash") else f"({R}, {D})")
        lib = "SDPA(enable_gqa)" if name.startswith("flash") else \
            "F.rms_norm"
        print(f"{name} {shape} bf16: kernel {km:.4f} ms, plain {pm:.4f} ms,"
              f" {lib} {lm:.4f} ms, bound {bm:.5f} ms ({by})")
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
        from repro_torch.serve.cache import SlotBatch
        from repro_torch.serve.engine import Request, ServeEngine
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
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
        print(f"  {name}: {len(regs)} kernels, registers "
              f"{min(regs, default=0)}-{max(regs, default=0)}, spills "
              f"{spills or 'none'}")

    # -- 2. kernels vs plain versions at the serve shapes -------------------
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    attn_err = {}
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[1]
        for S, lengths in ((1, [300, 17, 129, 0]),
                           (64, [0, 37, 200, 448]),
                           (256, [0, 37, 200, 256])):
            case = attn_case(gen, MAX_BATCH, S, lengths, dtype,
                             MAX_LEN // PAGE, poison=1e30)
            q, pk, pv, table, lens = case
            cut = table[:, :live_bucket(lengths, S)]
            want = pa.paged_attention_ref(q, pk, pv, cut, lens).float()
            got = pa.paged_flash_attention(q, pk, pv, cut, lens)
            full = pa.paged_flash_attention(q, pk, pv, table, lens)
            torch.cuda.synchronize()
            if not torch.equal(got, full):
                fail(f"paged attention S={S} {dname}: the live-bucket "
                     "table changed the output")
            err = (got.float() - want).abs().max().item()
            print(f"paged_flash_attention S={S:3d} {dname:8s} max|kernel-"
                  f"plain| = {err:.3e} (tolerance {ATTN_TOL[dname]:g})")
            if not err <= ATTN_TOL[dname]:
                fail(f"paged attention S={S} {dname} error {err:.3e}")
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
    train_err = check_train_kernels(gen)

    # -- 3. serve qwen3_1p7b at full width through the kernels --------------
    rcfg = get_config("qwen3_1p7b", "decode_32k")
    cfg = rcfg.model
    t0 = time.perf_counter()
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
    V = cfg.vocab_size
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
    pa.paged_flash_attention.launches = 0
    sp.topk_topp_mask.launches = 0
    reset_train_counts()
    t0 = time.perf_counter()
    out = engine.generate(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"paged_flash_attention": pa.paged_flash_attention.launches,
                "topk_topp_mask": sp.topk_topp_mask.launches}
    st = engine.scheduler.stats
    thr = engine.scheduler.throughput()
    for i, r in enumerate(out):
        if r.error is not None or len(r.output) != r.max_new_tokens:
            fail(f"request {i}: error={r.error} "
                 f"tokens={len(r.output)}/{r.max_new_tokens}")
        if not ((r.output >= 0) & (r.output < V)).all():
            fail(f"request {i}: token ids outside the vocab")
    waves = st["prefill_calls"] + st["decode_steps"]
    if launches["paged_flash_attention"] != n_layers * waves:
        fail(f"paged attention launched {launches['paged_flash_attention']}"
             f" times, want {n_layers} layers x {waves} waves")
    if min(launches.values()) <= 0:
        fail(f"a kernel of the path never launched: {launches}")
    ttft = sorted(r.ttft_s for r in out)
    n_tok = sum(len(r.output) for r in out)
    print(f"serve: 8 requests, {st['prefill_tokens']} prompt tokens "
          f"prefilled ({st['shared_tokens']} shared), {n_tok} tokens out in "
          f"{wall:.2f} s; {st['prefill_calls']} prefill + "
          f"{st['decode_steps']} decode waves")
    print(f"serve: decode {thr['decode_tok_s']:.1f} tok/s, prefill "
          f"{thr['prefill_tok_s']:.1f} tok/s, TTFT p50 {ttft[4]:.3f} s max "
          f"{ttft[-1]:.3f} s, end-to-end {n_tok / wall:.1f} tok/s")
    print(f"serve: launches {launches}; RMSNorm on the serve path "
          f"{train_counts()['rmsnorm_fwd']} forward launches")

    # one prefill + decode step, fused kernels vs the gathered path with
    # every plain version (norms included):
    # in float32 the two must agree closely; in bf16 the kernel path must
    # be no further from the float32 reference than the plain bf16 path
    # is (times STEP_BF16_FACTOR) — bf16 rounding through 34 layers of a
    # random-weight model moves logits by a few percent either way
    be = engine.backend
    rcfg32 = rcfg.replace(model=dataclasses.replace(cfg, dtype="float32"))
    variants = {"f32 fused": (engine.params, rcfg32, True),
                "f32 gathered": (engine.params, rcfg32, False),
                "bf16 fused": (be.params, rcfg, True),
                "bf16 gathered": (be.params, rcfg, False)}
    pools = {k: transformer.init_paged_cache(r, 1 + MAX_BATCH * 8, PAGE,
                                             device="cuda")
             for k, (_, r, _) in variants.items()}
    table = (1 + torch.arange(MAX_BATCH * 8, device="cuda")).reshape(
        MAX_BATCH, 8).to(torch.int32)
    lengths = torch.zeros(MAX_BATCH, dtype=torch.int32, device="cuda")
    n_new = torch.tensor([64, 50, 33, 10], device="cuda")
    for step, S in enumerate((64, 1)):
        toks = torch.from_numpy(rng.integers(0, V, (MAX_BATCH, S))).cuda()
        lg = {}
        for k, (prm, r, fused) in variants.items():
            with contextlib.nullcontext() if fused else plain_kernels():
                logit, _ = transformer.paged_decode_step(
                    prm, pools[k], toks, lengths, n_new, table, r,
                    fused=fused)
            lg[k] = logit.float()
            if not torch.isfinite(lg[k]).all():
                fail(f"non-finite logits ({k})")
        ref = lg["f32 gathered"]

        def rel(k, ref=ref, lg=lg):
            return ((lg[k] - ref).abs().max() / ref.abs().max()).item()
        e32, ek, ep = rel("f32 fused"), rel("bf16 fused"), rel("bf16 gathered")
        print(f"fused vs gathered step {step} (S={S}): float32 "
              f"max|diff|/max|logit| = {e32:.3e} (tolerance {STEP_F32_TOL:g});"
              f" bf16 vs the float32 reference: kernel path {ek:.3e}, plain "
              f"path {ep:.3e} (tolerance {STEP_BF16_FACTOR:g}x plain)")
        if not e32 <= STEP_F32_TOL or not ek <= STEP_BF16_FACTOR * ep:
            fail(f"fused and gathered steps disagree at step {step}")
        lengths = lengths + n_new.to(torch.int32)
        n_new = torch.ones(MAX_BATCH, dtype=torch.long, device="cuda")

    # where a decode wave's device time goes
    slots_len = [287, 301, 150, 64]
    scratch = be.init_state(1 + MAX_BATCH * (MAX_LEN // PAGE))
    ptab = (1 + np.arange(MAX_BATCH * (MAX_LEN // PAGE))).reshape(
        MAX_BATCH, -1).astype(np.int32)
    slots = SlotBatch.greedy(MAX_BATCH, ptab, lengths=slots_len)
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

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
    busy = sum(dev_us(e) for e in kern) / 1e6
    print(f"decode wave (B=4, contexts {slots_len}, 2 of 4 slots sampled): "
          f"{1e3 * bare / 5:.2f} ms wall ({1e3 * window / 5:.2f} ms under "
          f"the profiler), "
          + (f"device busy {1e3 * busy / 5:.2f} ms per wave = "
             f"{100 * busy / bare:.1f}% of the unprofiled wave, "
             f"{sum(e.count for e in kern) // 5} device ops per wave"
             if kern else "device busy not measured (no device events)"))
    for e in sorted(kern, key=dev_us, reverse=True)[:10]:
        print(f"  {dev_us(e) / 5 / 1e3:8.4f} ms/wave  {e.count // 5:4d}x  "
              f"{e.key[:80]}")

    # -- 4. times at the serve shapes ---------------------------------------
    flush = torch.empty(64 * 2**20 // 4, device="cuda")   # > 50 MB L2
    q, pk, pv, table, lens = attn_case(gen, MAX_BATCH, 1, slots_len,
                                       torch.bfloat16, MAX_LEN // PAGE,
                                       poison=0.0)
    P = live_bucket(slots_len, 1)
    cut = table[:, :P]
    k_ms = time_ms(lambda: pa.paged_flash_attention(q, pk, pv, cut, lens),
                   flush=flush)
    plain_ms = time_ms(lambda: pa.paged_attention_ref(q, pk, pv, cut, lens),
                       flush=flush)
    rows_idx = (cut.long()[:, :, None] * PAGE
                + torch.arange(PAGE, device="cuda")).reshape(MAX_BATCH, -1)
    g = H // HKV
    kd = pk.view(-1, HKV, HD)[rows_idx].transpose(1, 2) \
        .repeat_interleave(g, dim=1)
    vd = pv.view(-1, HKV, HD)[rows_idx].transpose(1, 2) \
        .repeat_interleave(g, dim=1)
    qd = q.transpose(1, 2)
    mask = (torch.arange(kd.shape[2], device="cuda")[None, None, None, :]
            <= lens.long()[:, None, None, None])
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_ms = time_ms(lambda: sdpa(qd, kd, vd, attn_mask=mask), flush=flush)
    a_bound, a_by = attn_bound_ms(MAX_BATCH, 1, slots_len, P, 2)
    print(f"paged_flash_attention decode B=4 S=1 bf16 P={P}: kernel "
          f"{k_ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA on the gathered "
          f"view {lib_ms:.4f} ms, bound {a_bound:.5f} ms ({a_by}); x"
          f"{n_layers} per wave")
    pre_len = [0, 37, 100, 200]
    qp, pkp, pvp, tp_, lp = attn_case(gen, MAX_BATCH, 256, pre_len,
                                      torch.bfloat16, MAX_LEN // PAGE, 0.0)
    Pp = live_bucket(pre_len, 256)
    kp_ms = time_ms(lambda: pa.paged_flash_attention(qp, pkp, pvp,
                                                     tp_[:, :Pp], lp),
                    flush=flush)
    pp_ms = time_ms(lambda: pa.paged_attention_ref(qp, pkp, pvp,
                                                   tp_[:, :Pp], lp),
                    flush=flush)
    pb, pby = attn_bound_ms(MAX_BATCH, 256, pre_len, Pp, 2)
    print(f"paged_flash_attention prefill B=4 S=256 bf16 P={Pp}: kernel "
          f"{kp_ms:.4f} ms, plain {pp_ms:.4f} ms, bound {pb:.5f} ms ({pby})")

    sl, sks, sps = sampling_case(gen, MAX_BATCH, V)
    s_ms = time_ms(lambda: sp.topk_topp_mask(sl, sks, sps), flush=flush)
    s_plain = time_ms(lambda: sp.topk_topp_mask_ref(sl, sks, sps),
                      flush=flush)
    s_sort = time_ms(lambda: apply_top_k_top_p(sl, sks, sps), flush=flush)
    s_bound = 1e3 * (2 * MAX_BATCH * V * 4 + MAX_BATCH * 8) / PEAK_BYTES_S
    print(f"topk_topp_mask B=4 V={V}: kernel {s_ms:.4f} ms, plain "
          f"{s_plain:.4f} ms, sort-based apply_top_k_top_p {s_sort:.4f} ms,"
          f" bound {s_bound:.5f} ms (bytes)")

    # -- 5. training: gradients at reduced depth, then full depth ----------
    del engine, be, params, scratch, pools, variants, lg, prm, logit
    gc.collect()
    torch.cuda.empty_cache()
    check_train_grads()
    gc.collect()
    torch.cuda.empty_cache()
    train_launches, _ = run_train()
    gc.collect()
    torch.cuda.empty_cache()

    # -- 6. training kernels' times at the training shapes -----------------
    train_rows = time_train_kernels(gen, flush, train_err)
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all")

    kernels = [
        {"name": "paged_flash_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
         "replaces": "src/repro/kernels/paged_attention.py:88",
         "launches": launches["paged_flash_attention"],
         "max_abs_err": attn_err["bfloat16"], "ms": k_ms,
         "plain_ms": plain_ms, "bound_ms": a_bound, "bound_by": a_by,
         "library_ms": lib_ms},
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
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}.cu",
            "replaces": f"src/repro/kernels/{src}.py:{line}",
            "launches": train_launches[name], "max_abs_err": train_err[name],
            "ms": km, "plain_ms": pm, "bound_ms": bm, "bound_by": by,
            "library_ms": lm})
    launches.update(train_launches)
    print("kernels: " + ", ".join(f"{k}={v}" for k, v in launches.items()))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
