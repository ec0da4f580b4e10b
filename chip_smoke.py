#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA card (H100 class).

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc`` with
``nvcc`` for ``sm_90a``, holds each against its plain PyTorch version at
the serve path's shapes, serves ``qwen3_1p7b`` at full width (random
weights from a seed) through ``ServeEngine`` with both kernels' launch
counters reset just before and read just after, compares one fused step
with the gathered plain path, and times each kernel beside its plain
version, a library yardstick and its bound. Imports ``repro_torch``,
torch and numpy only. Exits non-zero, before printing any result, when
no CUDA device is available or the repository's ``src`` is missing;
exits non-zero on any mismatch. The last line is
``{"ok": true, "device": {...}}``; the lines before it are the launch
counts, the card's name and power limit, and one JSON object with every
kernel's numbers.
"""
from __future__ import annotations

import dataclasses
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
        for line in log.splitlines():
            if "Used" in line or re.search(r"[1-9]\d* bytes spill", line):
                print(f"  {name}: {line.strip()}")

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
    print(f"serve: launches {launches}")

    # one prefill + decode step, fused kernels vs the gathered plain path:
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
            logit, _ = transformer.paged_decode_step(
                prm, pools[k], toks, lengths, n_new, table, r, fused=fused)
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
    print("kernels: " + ", ".join(f"{k}={v}" for k, v in launches.items()))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
