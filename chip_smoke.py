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
sampling mask (vocabularies of 151936, 65024, 32000 and 256206, B 1 /
4 / 64, ties, one value, +-0.0, 1e6-scaled and peaked logits;
survivors, tau_k and a second launch bitwise), the paged SSM update at
falcon_mamba_7b's and
zamba2_1p2b's full-width rows (both product orders), the training
kernels forward and backward, in float32 and bf16, at the training and
serve shapes, and the selective scan forward and backward at
falcon_mamba_7b's and zamba2_1p2b's full-width rows, with a
bit-repeatability check of every backward. Then it drives the port's
paths, each with the launch counters set to 0 just before and read just
after: it serves ``qwen3_1p7b``, then ``falcon_mamba_7b`` and
``zamba2_1p2b``, each at full width and full depth (random weights from
a seed) through ``ServeEngine``, compares one fused step with the
gathered plain path and profiles a decode wave. Then speculative
decoding: paged attention at the verify and ingest widths S = 2, 3, 5
and the paged SSM update's every-step plan (the verify recurrence) at
S = 5 against their plain versions, a commit of 1, 3 or 5 verified steps
against as many decode calls bit for bit; then each of the three models
at full width and depth in the trained regime (residual output
projections damped as ``benchmarks/bench_spec.py`` does), a plain
engine and a ``SpecConfig(cf=4, k=4)`` engine on the same weights over
the smoke queue's greedy requests (verify's logits within SPEC_GAP of
plain decode's wherever the two share a context, the streams equal
except at a first divergence on a near-tie, the draft's tokens held
against a serial forward of its params), a sampled request, and one
profiled spec wave, its draft and verify calls apart; then the same
weights damped to SPEC_ACCEPT_DAMP, where drafts are accepted, through
the same checks (accept rate above 0, a draft wave with a catch-up
ingest). Then the dense-cache decode path (phase 5c): paged attention
over a dense cache (one page of max_len rows a slot; qwen3_1p7b's and
zamba2_1p2b's heads, B 1 / 4, max_len 512 / 4096, a decode step at the
first, 63rd and last row, a 300-token chunked prefill), the paged SSM
decode kernel in place on a dense state at both full-width row shapes,
and flash at Sq = 1 / 17 against the encoder-decoder models' source
lengths, each against its plain version (writes landing only in their
layer and rows, a second launch bitwise), and timed; the three serve
models at full width and depth, the smoke queue's greedy requests and
a sampled one through the port's dense oracle (``decode_step`` +
``sample_tokens``) and the paged engine (logits within DENSE_GAP at
every shared-context position, a divergence only on a near-tie) and
``throughput_probe(paged=False)`` beside the paged probe for
qwen3_1p7b; then full-width ``mt_marian`` (B=32, 274 source tokens) and
``seamless_m4t_v2`` (B=4, 256 stub frames) encoding a source batch and
greedy-decoding 32 tokens through ``make_serve_fn`` with the encoder's
output, each step's logits against a teacher-forced serial forward
(ENCDEC_GAP), and one sampled seamless request. Then the MoE family
(phase 5d): the MoE module at qwen3_moe_235b's and grok1_314b's full
widths against its literal one-hot twin (a biased router drops tokens;
float32 dispatch bits equal; output and every cotangent within MOE_TOL;
a second call and backward bitwise) and timed; paged attention, flash,
RMSNorm and the sampling mask at the shapes these models give them
(GQA groups 16 and 6, width 6144, V = 131072) against their plain
versions; qwen3_moe_235b at 8 and grok1_314b at 4 stacked layers (full
width, bf16 storage) served through ``ServeEngine`` on the smoke queue
(qwen3-moe also through a second fresh engine, whose streams and
launches must repeat the first's bit for bit, and the step check with
its routing replayed), a profiled
decode wave, the dense oracle against the engine and, for qwen3-moe, a
``SpecConfig(4, 4)`` engine against a plain one, with the routing-flip
accounting (MOE_FLIP_MARGIN, MOE_FLIP_GAP); the gradients of qwen3-moe
at full width and 5 stacked layers (kernel path vs plain path with the
routing replayed) and three reduced-config ``Trainer`` steps. It checks the training
gradients at full width and reduced depth (kernel path vs plain path vs
direct autograd), then trains full-width, full-depth ``qwen3_1p7b`` for
three MGRIT steps through ``Trainer.train`` (adaptive probe at step 2)
and profiles one MGRIT and one serial step. It checks the SSM training
gradients the same way at reduced depth, then trains full-width
``falcon_mamba_7b`` at 26 layers (MGRIT, probe at step 2; full depth
does not fit one card) and full-width, full-depth ``zamba2_1p2b``
(serial) for three steps each, profiling one step of each mode. Last
it checks the paper's encoder and encoder-decoder families' gradients
at full width and reduced depth (bert128 at 8 layers, mt_marian at 3 +
3, the encoder's leaves included) against the plain path, then trains
full-width, full-depth ``bert128`` (MGRIT, probe at step 2), ``vit32``
and ``mt_marian`` for three steps each. The flash kernels are also held
non-causal at those models' shapes, mc_tiny's and a cross-attention
shape (Sq != Sk), and timed at bert128's.
After the MoE phase (phase 5e) it serves full-width, full-depth
qwen3_1p7b through ``ServeEngine(mesh=...)`` on a world-1 NCCL mesh
opened in this process: its streams and one decode step's logits bitwise
phase 3's engine on the same weights, no collective issued, the sync
census of a decode wave phase 3's count; and qwen3_moe_235b at 8 stacked
layers the same way on the smoke queue, its streams, a decode step's
logits and its launches bitwise phase 5d's second engine's. Phase 5f
runs with ``--mesh`` only, on 2 or more cards (``python3 chip_smoke.py
--mesh``: phases 5e, 5f, 6, 6c and 6d alone; ``--mesh serve``: 5e and
5f; ``--mesh moe``: 5f's and 6d's qwen3-moe parts alone; ``--mesh
fsdp``: 6d's granite and qwen3-moe parts alone; ``--mesh tp`` (4
cards): Megatron tensor parallelism in training, qwen3 at (1, 4) (its
(1, 2) runs in ``--mesh``'s 6d) and zamba2 at full width and depth at
(1, 4) and (2, 2), each rank's first gradient and two Trainer steps
against one card's run, the float32 split's gradient leaves and norm
and, after two float32 Trainer steps, its params and moments,
stored bytes, peak memory, step seconds, collectives and launches a
rank; ``--mesh dense``: dense decode under a mesh and a (2, 2) prefix
file loaded by a one-card engine, held to the (2, 2) engine's streams;
phase 6g (every run) trains zamba2 through a world-1 NCCL mesh bitwise
phase 7's run and holds its 6-layer gradient at (1, 2) on this card
through two gloo ranks): NCCL ranks serve
the smoke queue, fused and gathered, qwen3_1p7b at (1, 2), (2, 1), (1,
4) and (2, 2) and falcon_mamba_7b and zamba2_1p2b at (1, 2); every
rank's streams equal, each emission's logits within DENSE_GAP of the
one-card engine's and a first divergence only on a near-tie, each
rank's launches one card's; each rank's pool bytes, launches, collectives by kind and bytes and a
steady decode wave's ms printed beside one card's in the same call;
then qwen3_moe_235b (8 layers, fused) at (1, 2), (2, 1) and (2, 2), the
experts over 'data' at the last two, held the same way with the
routing-flip accounting.
Right after the qwen3_1p7b run (phase 6c) it trains the same config
two steps through ``Trainer(mesh=...)`` on a world-1 NCCL mesh opened
in this process (the losses and every param leaf's sha256 bit for bit
the one-device run's after the same two steps, the collectives of each
step printed by kind and bytes), and where 2 or more cards are visible
(phase 6d) on NCCL ranks spawned over 2 cards at (1, 2), and over 4 at
(1, 4) where 4 are visible, the vocab cut over 'model' as the training
rules say (the embeddings, zT and the state the head reads bitwise one
card's; the first batch's gradient within TP_GRAD_COS / TP_GRAD_NORM
and the losses within TP_LOSS_REL of one card's; stored bytes, step
seconds, peak memory, halo bytes); with one card it prints that 6d did
not run. 6d then holds the full-width qwen3_moe_235b gradient (5
stacked layers, B 4) gathered from NCCL ranks at (2, 1) and (4, 1), the
experts over 'data', to one card's with the routing replayed (cosine
and norm, MOE_GRAD_COS / MOE_GRAD_NORM), and trains full-width
qwen3_moe_235b two steps at (4, 1) at the depth its printed reckoning
fits (every rank's losses equal and finite); with 4 cards, full-width
granite_34b under its fsdp rules: its (4, 1) gradient at 1 + 6 + 1
layers against fsdp=None (losses bitwise, the gradient gathered whole
within GRANITE_GRAD_TOL) and two Trainer steps at (4, 1) and (2, 2) at
the depth its printed reckoning admits (stored bytes a rank, peak
memory, step seconds, gathers and reduce-scatters by kind and bytes).
Phase 6e (every run)
trains the reduced qwen3_moe_235b two steps through a world-1 NCCL mesh:
losses and every param leaf's sha256 bitwise phase 5d's Trainer, no
collective issued. Phase 6f (every run) holds flash at granite_34b's
head shape (H 48/1, S 4096) to its plain version, then trains
full-width granite_34b at the depth its printed reckoning admits on one
card (1 + 6 + 1 layers) two steps on one device and through a world-1
NCCL mesh under its fsdp rules: losses and every param leaf's sha256
bitwise, the same launches, no collective issued.
Then (phase 6b) it trains the same config
cut to CKPT_LAYERS layers for three steps uninterrupted, then from a
fresh ``Trainer(ckpt_dir=...)`` for two steps with a checkpoint after
each (each save's seconds, bytes and GB/s), restores it in place into a
second fresh ``Trainer`` (seconds, GB/s, peak memory) and trains one
more step: its loss and the sha256 of every param and optimizer-state
leaf must equal the uninterrupted run's after step 3, bit for bit. Meanwhile two
spawned worker processes at nice 19 count every train run's step on the
meta device (``repro_torch.launch.dryrun``); last (phase 9) each measured
step is printed beside its count: predicted argument bytes and the
bytes allocated after the ``Trainer``'s init, model and counted flops,
and the model-flops share of the step at the bf16 peak, then when the
last count ended beside the start of phases 6b, 7 and 8.
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
object with every kernel's numbers. The checkpoints are written into
the git-ignored ``experiments/ckpt_smoke/`` (two of ~13.5 GB each) and
removed at the end of their phase.
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
try:    # the H100 SXM's data-sheet peaks: HBM3, dense bf16 tensor cores,
        # float32 outside the tensor cores
    from repro_torch.analysis.roofline import HBM_BW as PEAK_BYTES_S
    from repro_torch.analysis.roofline import PEAK_FLOPS as PEAK_BF16_FLOP_S
    from repro_torch.analysis.roofline import \
        PEAK_F32_FLOPS as PEAK_F32_FLOP_S
except ImportError as e:
    raise SystemExit("chip_smoke: FAIL: the port is not importable next to "
                     f"this script ({e})") from None

ATTN_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
SAMPLING_TV = 1e-5              # mass of tokens the two masks disagree on
SAMPLING_KINDS = ("normal", "ties", "equal", "zeros", "scaled", "peaked")
P1_KEEP_NATS = 20.0             # at p = 1 the kernel keeps the top-k set
                                # this close to the max (its cut: ~28)
SAMPLING_EDGE_KS = (0, 40, 1, 0, None, "V+7", -3, 64, 300, 5, 2, 1000)
SAMPLING_EDGE_PS = (1.0, 0.95, 0.5, 0.9, 1.0, 1e-6, 0.95, 1.0, 0.5, 1.0,
                    1e-6, 0.95)
STEP_F32_TOL = 1e-3             # fused vs gathered f32 logits / max |logit|
STEP_BF16_FACTOR = 2.0          # bf16 kernel path error vs plain path error
H, HKV, HD, PAGE, MAX_LEN, MAX_BATCH = 16, 8, 128, 16, 512, 4
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}   # grads: x max|tensor|
FLASH_OUT_BF16 = (1e-3, 1e-2)   # bf16 out, per element: atol + rtol|plain|
RMS_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
# the bf16 RMSNorm output y is held in bf16 ulps of the plain output: at
# |y| >= 4 one ulp (0.03125) exceeds RMS_TOL's 0.02, so an absolute limit
# fails a one-ulp rounding difference there; below 4 an ulp is at most
# 0.0156, so this is no looser than 0.02 anywhere
RMS_Y_BF16_ULPS = 1.0
GRAD_REL = 1e-4                 # per leaf, x max|leaf| (float32)
TRAIN_B, TRAIN_S = 2, 4096      # train_4k's sequence, its batch cut to 2
DECODE_LENS = [287, 301, 150, 64]   # contexts of the profiled decode wave
# paged SSM update: rows and d_state of falcon-mamba-7b (mamba1, "dbx")
# and zamba2-1.2b (mamba2, 64 heads x headdim 64, "dxb"); the kernel vs
# plain tolerance is relative to max|plain| (FMA contraction and the
# card's exp2 over up to 256 sequential float32 steps)
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
# the paper's encoder and encoder-decoder attention, non-causal, as
# (B, H, Hkv, Sq, Sk, hd, causal): bert128 (B 32, S 224), vit32 (B 64,
# 193 tokens + 4 stub patches), mt_marian's self-attention (B 32, S 274)
# and cross-attention (274 target rows on 190 source keys), mc_tiny (one
# head of 128, S 2048)
PAPER_FLASH = ((32, 12, 12, 224, 224, 64, False),
               (64, 12, 12, 197, 197, 64, False),
               (32, 8, 8, 274, 274, 64, False),
               (32, 8, 8, 274, 190, 64, False),
               (8, 1, 1, 2048, 2048, 128, False))
# the paper's training runs: (arch, B, S); vit32's S is its tokens, the 4
# stub patch embeddings come before them
PAPER_TRAIN = (("bert128", 32, 224), ("vit32", 64, 193),
               ("mt_marian", 32, 274))
# (rows, width) the RMSNorm kernel sees: training ln / qk-norm rows; a
# decode wave's ln, q-norm and k-norm rows; a 512-token prefill bucket's;
# falcon-mamba-7b's training block norms and zamba2-1.2b's gated norm
RMS_SHAPES = ((8192, 2048), (8192 * H, HD),
              (MAX_BATCH, 2048), (MAX_BATCH * H, HD), (MAX_BATCH * HKV, HD),
              (MAX_BATCH * 512, 2048), (MAX_BATCH * 512 * H, HD),
              (TRAIN_B * TRAIN_S, 4096), (TRAIN_S, 4096))


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


# -- phase 0: the port's static checker; the sync census of every path ------
# STATIC holds phase 0's project and the (path, line) of every RC001 /
# RC002 finding, baselined or not; CENSUS each censused call's counts
STATIC: dict = {}
CENSUS: list = []
SERVED: dict = {}               # model name -> its last smoke-queue streams
DENSE_REF: dict = {}            # model name -> phase 5c's dense streams
MOE_REF: dict = {}              # phase 5d's qwen3-moe engine and Trainer
PHASE_START: list = []          # (phase, perf_counter at its start)
SYNC_WARNING = "called a synchronizing CUDA operation"


def static_check():
    """Phase 0: the port's static checker over ``src/repro_torch``
    through its ``run_rules`` API, held against
    ``staticcheck-torch-baseline.txt``; fails on any finding the baseline
    does not hold. Keeps the step regions and the RC001 / RC002 lines for
    the sync census."""
    from repro_torch.analysis.staticcheck import RULES, Project, run_rules
    from repro_torch.analysis.staticcheck import baseline as bl
    t0 = time.perf_counter()
    with contextlib.chdir(ROOT):          # display paths "src/repro_torch/.."
        project = Project(["src/repro_torch"])
    findings = run_rules(project)
    known = bl.load(str(ROOT / "staticcheck-torch-baseline.txt"))
    fresh, held, stale = bl.split(
        findings, {m.relpath: m.lines for m in project.iter_modules()}, known)
    print(f"static check: {len(RULES)} rules ({', '.join(sorted(RULES))}) "
          f"over {len(project.modules)} files, "
          f"{len(project.step_functions())} step regions: {len(findings)} "
          f"findings, {len(held)} held by the baseline's {len(known)} "
          f"entries ({len(stale)} stale), {len(fresh)} not baselined; "
          f"{time.perf_counter() - t0:.2f} s")
    for f in fresh:
        print(f"  {f.render()}")
    if fresh:
        fail(f"the static checker has {len(fresh)} finding(s) outside "
             "staticcheck-torch-baseline.txt")
    STATIC.update(project=project, flagged={
        (f.path, f.line) for f in findings if f.rule in ("RC001", "RC002")})


@contextlib.contextmanager
def sync_census(label):
    """Count the synchronizing CUDA calls of the block (one call of a
    path, after its warm-up): ``torch.cuda.set_sync_debug_mode("warn")``
    with every warning recorded, the mode set back to 0 after. Each
    warning is attributed to the Python line that made the call (the
    warning's own line); a line of ``repro_torch`` inside a step region
    must be an RC001 / RC002 finding of the checker (baselined or not),
    else the run fails. A warning whose line lies in torch's own Python
    (a decorator's wrapper, autograd's engine) also names the innermost
    ``repro_torch`` line on its stack, for the report only."""
    import warnings

    import torch
    records = []

    def keep(message, category, filename, lineno, file=None, line=None):
        records.append((filename, lineno, str(message), _port_frame()))
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True):
        warnings.simplefilter("always")
        warnings.showwarning = keep       # restored on leaving the block
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    census_report(label, records)


def _port_frame():
    """``path:line`` of the innermost ``repro_torch`` frame on the
    caller's stack, or None."""
    port = str(ROOT / "src" / "repro_torch") + "/"
    f = sys._getframe(2)
    while f is not None:
        name = f.f_code.co_filename
        if name.startswith(port):
            return f"{name[len(port):]}:{f.f_lineno}"
        f = f.f_back
    return None


def timed_check(check):
    """Run one of the gradient checks and print its seconds (the phase
    times printed at the end do not separate them from the runs)."""
    t0 = time.perf_counter()
    check()
    print(f"{check.__name__}: {time.perf_counter() - t0:.1f} s")


def census_report(label, records):
    """Print and keep one census: the synchronizing calls of ``records``
    ((file, line, message, innermost port line) of each warning) by port
    line, inside a step
    region or host-side, and those without a port line apart. Fails on a
    step-region line the checker does not report."""
    from collections import Counter
    port = (ROOT / "src" / "repro_torch").resolve()
    sites, outside = Counter(), Counter()
    others = []
    for file, line, msg, via in records:
        if SYNC_WARNING not in msg:
            others.append(f"{Path(file).name}:{line} {msg[:80]}")
            continue
        path = Path(file).resolve()
        if path.is_relative_to(port):
            sites[(path.relative_to(ROOT).as_posix(), line)] += 1
        else:
            torch_py = file.split("site-packages/")[-1]
            outside[f"{torch_py}:{line} via {via}" if via
                    else f"{torch_py}:{line}"] += 1
    project, flagged = STATIC["project"], STATIC["flagged"]
    step, host, missed = {}, {}, []
    for (path, line), n in sorted(sites.items()):
        where = f"{path.removeprefix('src/repro_torch/')}:{line}"
        region = project.step_region_at(path, line)
        if region is None:
            host[where] = n
        else:
            step[where] = n
            if (path, line) not in flagged:
                missed.append(f"{where} ({region})")
    n_sync = sum(sites.values()) + sum(outside.values())
    print(f"sync census {label}: {n_sync} synchronizing calls; in step "
          f"regions {step or 'none'}; host-side {host or 'none'}; without "
          f"a port line {dict(outside) or 'none'}"
          + (f"; other warnings {others}" if others else ""))
    CENSUS.append({"call": label, "syncs": n_sync, "step": step,
                   "host": host, "outside": dict(outside)})
    if missed:
        fail(f"sync census {label}: synchronizing lines inside step regions "
             f"that the static checker does not report: {missed}")


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


def check_paged_case(gen, heads, S, lengths, dtype) -> float:
    """Paged attention against its plain version at one shape, within
    ATTN_TOL; the live-bucket table and a table of 48 pages a slot (wider
    than the bucket's 32, so the split-KV path runs different grids) and
    a second launch give the same bits. Returns the max abs error."""
    import torch
    from repro_torch.kernels import paged_attention as pa
    dname = str(dtype).split(".")[1]
    case = attn_case(gen, MAX_BATCH, S, lengths, dtype, MAX_LEN // PAGE + 16,
                     poison=1e30, heads=heads)
    q, pk, pv, table, lens = case
    cut = table[:, :live_bucket(lengths, S)]
    want = pa.paged_attention_ref(q, pk, pv, cut, lens).float()
    got = pa.paged_flash_attention(q, pk, pv, cut, lens)
    full = pa.paged_flash_attention(q, pk, pv, table, lens)
    again = pa.paged_flash_attention(q, pk, pv, cut, lens)
    torch.cuda.synchronize()
    path = "split-KV" if pa.plan(dtype, MAX_BATCH, S, *heads, PAGE,
                                 cut.shape[1]).split else "multi-row"
    shape = f"H={heads[0]}/{heads[1]} hd={heads[2]} S={S:3d}"
    if not torch.equal(got, full):
        fail(f"paged attention {shape} {dname}: the live-bucket table "
             "changed the output")
    if not torch.equal(got, again):
        fail(f"paged attention {shape} {dname}: a second launch changed the "
             "output")
    err = (got.float() - want).abs().max().item()
    print(f"paged_flash_attention {shape} {dname:8s} ({path}) "
          f"max|kernel-plain| = {err:.3e} (tolerance {ATTN_TOL[dname]:g}); "
          f"live-bucket table ({cut.shape[1]} pages) == full "
          f"({table.shape[1]}) == second launch, bitwise")
    if not err <= ATTN_TOL[dname]:
        fail(f"paged attention {shape} {dname} error {err:.3e}")
    return err


def live_bucket(lengths, S) -> int:
    need = max(int(x) + S for x in lengths)
    return 1 << (max(-(-need // PAGE), 1) - 1).bit_length()


def attn_bound_ms(B, S, lengths, P, itemsize):
    """Least time of one paged attention call at qwen3_1p7b's heads for B
    = len(lengths) slots (``kernels.paged_attention.cost``)."""
    from repro_torch.analysis.roofline import bound_ms
    from repro_torch.kernels import paged_attention as pa
    assert B == len(lengths)
    return bound_ms(*pa.cost(S, H, HKV, HD, itemsize, lengths, P))


def sampling_case(gen, B, V):
    import torch
    logits = torch.randn((B, V), generator=gen, device="cuda") * 2.0
    ks = torch.tensor([0, 40, 1, 0, V, 5, 40, 0][:B], dtype=torch.int32,
                      device="cuda")
    ps = torch.tensor([1.0, 0.95, 0.5, 0.9, 0.3, 1.0, 0.95, 0.8][:B],
                      dtype=torch.float32, device="cuda")
    return logits, ks, ps


def sampling_edge(gen, kind, B, V):
    """(B, V) logits of one kind: "normal" (N(0, 2^2)), "ties" (those
    rounded to steps of 0.5), "equal" (one value), "zeros" (30% +0.0, 30%
    -0.0, 2% positive, the rest negative), "scaled" (normal x 1e6, what a
    greedy slot's temperature clamp passes), "peaked" (normal x 10: a
    top 40 spans 15-25 nats); per-row k and p cycle over
    SAMPLING_EDGE_KS / _PS, shifted each cycle, the first four rows the
    timing mix (k 0/40/1/0, p 1.0/0.95/0.5/0.9)."""
    import torch
    x = torch.randn((B, V), generator=gen, device="cuda") * 2.0
    if kind == "ties":
        x = torch.round(x * 2) / 2
    elif kind == "equal":
        x = torch.full((B, V), 0.7, device="cuda")
    elif kind == "zeros":
        r = torch.rand((B, V), generator=gen, device="cuda")
        x = torch.where(r < 0.3, 0.0, torch.where(
            r < 0.6, -0.0, torch.where(r < 0.62, x.abs(), -x.abs())))
    elif kind == "scaled":
        x = x * 1e6
    elif kind == "peaked":
        x = x * 10.0
    n = len(SAMPLING_EDGE_KS)
    ks = [V if k is None else V + 7 if k == "V+7" else k
          for k in SAMPLING_EDGE_KS]
    top_ks = torch.tensor([ks[r % n] for r in range(B)], dtype=torch.int32,
                          device="cuda")
    top_ps = torch.tensor([SAMPLING_EDGE_PS[(r + r // n) % n]
                           for r in range(B)], device="cuda")
    return x.contiguous(), top_ks, top_ps


def top_k_set_differs(logits, ks, ps, keep) -> bool:
    """Whether the survivors ``keep`` miss the plain version's tau_k: a
    survivor outside its top-k set, or a row at p = 1 that dropped a
    top-k value within P1_KEEP_NATS of its max."""
    import torch
    from repro_torch.kernels import sampling as sp
    V = logits.shape[-1]
    u = sp._sortable_u32(logits)
    k_eff = torch.where(ks <= 0, V, ks.long()).clamp(1, V)
    top_k = u >= sp._search_kth(u, k_eff)[:, None]
    near = top_k & (logits >= logits.max(-1, keepdim=True).values
                    - P1_KEEP_NATS)
    p1 = ps == 1.0
    return bool((keep & ~top_k).any()) or not torch.equal(
        keep[p1] | near[p1], keep[p1])


def check_sampling(gen):
    """The sampling kernel against its plain version at the served vocabs
    (qwen3_1p7b's 151936, falcon_mamba_7b's 65024, zamba2_1p2b's 32000)
    and seamless_m4t_v2's 256206 (the widest; the scalar loads), B 1 / 4
    / 64 (64: clusters in waves), over every ``sampling_edge`` kind:
    survivors bitwise, tau_k bitwise (``top_k_set_differs``), flipped
    mass <= SAMPLING_TV, a second launch bit-identical. Returns the
    largest survivor error (0) and flipped mass."""
    import torch
    from repro_torch.kernels import sampling as sp
    worst_tv, worst_err = 0.0, 0.0
    for V in (151936, 65024, 32000, 256206):
        for B in (1, 4, 64):
            tvs = []
            for kind in SAMPLING_KINDS:
                logits, ks, ps = sampling_edge(gen, kind, B, V)
                want = sp.topk_topp_mask_ref(logits, ks, ps)
                got = sp.topk_topp_mask(logits, ks, ps)
                again = sp.topk_topp_mask(logits, ks, ps)
                torch.cuda.synchronize()
                keep_w, keep_g = want > -1e30, got > -1e30
                both = keep_w & keep_g
                err = (got[both] - want[both]).abs().max().item()
                tv = flipped_mass(logits, keep_w, keep_g)
                what = f"topk_topp_mask {kind} B={B} V={V}"
                if err != 0.0 or not tv <= SAMPLING_TV:
                    fail(f"{what}: survivors differ by {err:.3e} or "
                         f"flipped mass {tv:.3e} > {SAMPLING_TV:g}")
                if top_k_set_differs(logits, ks, ps, keep_g):
                    fail(f"{what}: the survivors miss the plain tau_k")
                if not torch.equal(got, again):
                    fail(f"{what}: a second launch changed the output")
                worst_err, worst_tv = max(worst_err, err), max(worst_tv, tv)
                tvs.append(tv)
            print(f"topk_topp_mask V={V} B={B:2d}: {len(SAMPLING_KINDS)} "
                  f"kinds ({', '.join(SAMPLING_KINDS)}) survivors, tau_k "
                  f"and second launch bitwise; flipped mass max "
                  f"{max(tvs):.3e} (tolerance {SAMPLING_TV:g})")
    return worst_err, worst_tv


def flipped_mass(logits, keep_a, keep_b) -> float:
    import torch
    union = torch.where(keep_a | keep_b, logits.float(),
                        torch.full_like(logits.float(), -float("inf")))
    prob = torch.softmax(union, dim=-1)
    return float((prob * (keep_a != keep_b)).sum(-1).max())


def bf16_ulp(x: float) -> float:
    """The spacing of bf16 values at |x|."""
    import math
    return 2.0 ** (math.frexp(abs(x))[1] - 8)


def bf16_ulps(got, want) -> float:
    """max |got - want| in bf16 ulps of |want|: the spacing of bf16
    values at |want|, 2**(e-8) for |want| in [2**(e-1), 2**e)."""
    import torch
    w = want.float()
    _, e = torch.frexp(w.abs())
    ulp = torch.ldexp(torch.ones_like(w), e - 8)
    return ((got.float() - w).abs() / ulp).max().item()


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


def check_train_kernels(gen, paper_gen):
    """Flash attention and RMSNorm, forward and backward, against their
    plain versions (autograd of the plain version for the gradients), in
    float32 and bf16; each backward twice, bit-identical. Attention also
    runs at zamba2_1p2b's training shape, in bf16 (its dtype), and at
    the paper's non-causal shapes (PAPER_FLASH) in both dtypes, whose
    inputs come from ``paper_gen`` (so that every other case, and every
    later phase that draws from ``gen``, sees the inputs it saw before
    these cases were added). Returns the largest bf16 absolute error of
    each kernel at the causal training shapes, and of flash at
    PAPER_FLASH under "<kernel>@paper".
    """
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rn
    err = {"flash_attention_fwd": 0.0, "flash_attention_bwd": 0.0,
           "flash_attention_fwd@paper": 0.0,
           "flash_attention_bwd@paper": 0.0,
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
        cases = grid + ([zamba2_attn] if bf16 else []) + list(PAPER_FLASH)
        for case in cases:
            B, h, hkv, Sq, Sk, hd, causal = case
            paper = case in PAPER_FLASH
            g = paper_gen if paper else gen
            q, do = (torch.randn((B, h, Sq, hd), generator=g,
                                 device="cuda") * 0.5 for _ in range(2))
            k, v = (torch.randn((B, hkv, Sk, hd), generator=g,
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
            if bf16 and (paper or Sq >= 1024):
                sfx = "@paper" if paper else ""
                err[f"flash_attention_fwd{sfx}"] = max(
                    err[f"flash_attention_fwd{sfx}"], e_out)
                err[f"flash_attention_bwd{sfx}"] = max(
                    err[f"flash_attention_bwd{sfx}"],
                    *((g.float() - w.float()).abs().max().item()
                      for g, w in zip(got[1:], want[1:])))
            if paper or (bf16 and Sq >= 1024):
                qm, km, vm, dom = (x.transpose(1, 2).contiguous()
                                   for x in (q, k, v, do))
                o, lse = fa.flash_attention_fwd(qm, km, vm, causal)
                first = fa.flash_attention_bwd(qm, km, vm, o, lse, dom,
                                               causal)
                again = fa.flash_attention_bwd(qm, km, vm, o, lse, dom,
                                               causal)
                torch.cuda.synchronize()
                if not all(torch.equal(a, b) for a, b in zip(first, again)):
                    fail(f"flash attention backward {shape} {dname} is not "
                         "bit-repeatable")
                del qm, km, vm, dom, o, lse, first, again
            del q, k, v, do, want, got
        for R, D in RMS_SHAPES:
            e_y, e_dx = check_rmsnorm_shape(gen, R, D, dtype)
            if dtype == torch.bfloat16:
                err["rmsnorm_fwd"] = max(err["rmsnorm_fwd"], e_y)
                err["rmsnorm_bwd"] = max(err["rmsnorm_bwd"], e_dx)
    print("training kernels: every backward bit-identical on a second run")
    return err


def check_rmsnorm_shape(gen, R, D, dtype):
    """RMSNorm forward and backward at (R, D) against the plain version
    (autograd of it for dx and dw), y in bf16 ulps (RMS_Y_BF16_ULPS) or
    within RMS_TOL, dx and dw within RMS_TOL of max|plain|; the backward
    twice, bit-identical. Returns (max|y error|, max|dx error|)."""
    import torch
    from repro_torch.kernels import rmsnorm as rn
    dname = str(dtype).split(".")[1]
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
    if dtype == torch.bfloat16:
        u_y = bf16_ulps(got[0], want[0])
        y_ok = u_y <= RMS_Y_BF16_ULPS
        y_tol = f"y tolerance {RMS_Y_BF16_ULPS:g} bf16 ulp of |plain|"
    else:
        u_y, y_ok = None, e_y <= tol
        y_tol = f"y tolerance {tol:g}"
    print(f"rmsnorm ({R}, {D}) {dname:8s}: y max|kernel-plain| "
          f"{e_y:.3e}"
          + (f" ({u_y:g} bf16 ulp of |plain|)" if u_y is not None
             else "")
          + f", dx {e_dx:.3e}, dw {e_dw:.3e} of max|plain| "
          f"({y_tol}; dx, dw tolerance {tol:g})")
    if not (y_ok and e_dx <= tol and e_dw <= tol):
        fail(f"rmsnorm ({R}, {D}) {dname} disagrees with its plain "
             "version")
    _, rstd = rn.rmsnorm_fwd(x, w)
    first, again = (rn.rmsnorm_bwd(x, w, rstd, dy) for _ in range(2))
    torch.cuda.synchronize()
    if not (torch.equal(first[0], again[0])
            and torch.equal(first[1], again[1])):
        fail("rmsnorm backward is not bit-repeatable")
    return e_y, (got[1].float() - want[1].float()).abs().max().item()


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
    ops.ssm_scan = lambda *args, heads=None: ss.ssm_scan_ref(*args)
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


def check_paper_train_grads():
    """Full-width bert128 at 8 layers (S=224) and mt_marian at 3 + 3
    layers (S=274), B=4, in their MGRIT mode (the config's cf, levels and
    iterations; pad_to its cf): the kernel path's gradients against the
    plain path's (flash's plain version, under ``plain_kernels``), every
    leaf within GRAD_REL of its max in float32, and in bf16 the
    direction-and-norm checks of ``check_train_grads``. mt_marian's
    encoder leaves, which only the decoder's cross-attention cotangent
    reaches, are also held alone and must not vanish."""
    import numpy as np
    import torch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import SyntheticLM, shard_batch
    from repro_torch.models import transformer

    def flat(g):
        return torch.cat([g[p].float().reshape(-1) for p in sorted(g)
                          if p[-1] != "gate"])

    for arch, layers, S in (("bert128", 8, 224), ("mt_marian", 3, 274)):
        base = get_config(arch)
        encdec = base.model.family == "encdec"

        def rcfg_for(dtype, base=base, layers=layers, S=S, encdec=encdec):
            return base.replace(
                model=dataclasses.replace(
                    base.model, n_layers=layers, dtype=dtype,
                    n_dec_layers=layers if encdec else 0),
                mgrit=dataclasses.replace(base.mgrit,
                                          pad_to=base.mgrit.cf),
                shape=ShapeConfig("grads", "train", S, 4), microbatches=1)
        r32, r16 = rcfg_for("float32"), rcfg_for("bfloat16")
        mg = r32.mgrit
        depth = f"{layers} + {layers}" if encdec else f"{layers}"
        what = (f"{arch}, {depth} layers, S={S}, MGRIT cf {mg.cf} fwd "
                f"{mg.fwd_iters} / bwd {mg.bwd_iters}")
        params = transformer.init_model(r32, seed=1, device="cuda")
        batch = shard_batch(SyntheticLM(r32, seed=1).batch_at(0), "cuda")
        lk, gk = grads_of(params, batch, r32, mode="lp")
        with plain_kernels():
            lp_, gp = grads_of(params, batch, r32, mode="lp")
        e, leaf = leaf_errors(gk, gp)
        print(f"train grads, {what} f32: kernel path vs plain path: loss "
              f"{lk:.6f} vs {lp_:.6f}; worst leaf {leaf} {e:.3e} "
              f"(tolerance {GRAD_REL:g})")
        if not (e <= GRAD_REL and abs(lk - lp_) <= 1e-5 * abs(lp_)):
            fail(f"{arch} gradients differ between the kernel and plain "
                 "paths")
        if encdec:
            enc = {p: g for p, g in gp.items() if p[0] == "enc_mid"}
            e, leaf = leaf_errors(gk, enc)
            small = min(g.abs().max().item() for p, g in gk.items()
                        if p[0] == "enc_mid" and p[-1] != "gate")
            print(f"train grads, {what} f32: encoder leaves (through the "
                  f"cross-attention cotangent only): worst {leaf} {e:.3e}"
                  f"; smallest leaf max|grad| {small:.3e}")
            if not (e <= GRAD_REL and small > 0):
                fail(f"{arch}: the encoder's gradients are wrong or zero")
        lk, gk = grads_of(params, batch, r16, mode="lp")
        with plain_kernels():
            lp_, gp = grads_of(params, batch, r16, mode="lp")
        fk, fp = flat(gk), flat(gp)
        cos = (fk @ fp / (fk.norm() * fp.norm() + 1e-30)).item()
        nrel = abs(fk.norm().item() - fp.norm().item()) / fp.norm().item()
        print(f"train grads, {what} bf16: kernel path vs plain path: loss "
              f"{lk:.6f} vs {lp_:.6f}; cosine {cos:.6f} (> 0.9999), norm "
              f"rel diff {nrel:.3e} (< 1e-2)")
        if not (cos > 0.9999 and nrel < 1e-2 and np.isfinite(cos)):
            fail(f"{arch} bf16 gradients lose direction or norm on the "
                 "kernel path")
        del params, gk, gp


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


def check_scan_fwd_states(ins, shape, S):
    """The forward kernel's stored states (the state before every 64
    steps, where the backward starts its chunks) against the plain
    recurrence's within SCAN_TOL["y"] of max|plain|, and a second
    forward bit-identical (y and states)."""
    import torch
    from repro_torch.kernels import ssm_scan as ss
    _, want = ss.ssm_scan_fwd_ref(*ins)
    (y1, hc1), (y2, hc2) = (ss.ssm_scan_fwd(*ins) for _ in range(2))
    torch.cuda.synchronize()
    e_hc = _scaled_err(hc1, want)
    same = torch.equal(y1, y2) and torch.equal(hc1, hc2)
    print(f"ssm_scan_fwd {shape} S={S}: stored states max|kernel-plain|/"
          f"max|plain| {e_hc:.3e} (tolerance {SCAN_TOL['y']:g}); second "
          f"forward bit-identical {same}")
    if not (e_hc <= SCAN_TOL["y"] and same):
        fail(f"ssm_scan_fwd {shape} S={S}: stored states disagree with "
             "the plain recurrence, or a second forward differs")


def check_scan_kernel(gen):
    """The selective scan against its plain version at falcon-mamba-7b's
    and zamba2-1.2b's full-width rows: y and all six cotangents (autograd
    of the plain version) at S=1000 (15 checkpoint chunks and a ragged
    tail), a second backward bit-identical; y at the training length
    S=4096; at both lengths the forward's stored states against the
    plain recurrence's and a second forward bit-identical. Returns the
    largest abs error of y and of the cotangents."""
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
        check_scan_fwd_states(ins, shape, 1000)
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
        del want, got
        check_scan_fwd_states(ins, shape, TRAIN_S)
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
    """Least time for one scan call at ``fam``'s rows
    (``kernels.ssm_scan.cost``), dt, A, D and their cotangents counted at
    their distinct values (one per head for mamba2's rows), its float32
    operations at the non-tensor peak. The checkpoints the design stores
    are not in the bound (see ``scan_checkpoint_bytes``)."""
    from repro_torch.analysis.roofline import bound_ms
    from repro_torch.kernels import ssm_scan as ss
    Bb, R, ds, hd = SCAN_ROWS[fam]
    n_ch = R // hd if hd else R           # distinct dt and D values
    n_decay = R // hd if hd else R * ds   # distinct A values
    return bound_ms(*ss.cost(Bb, S, R, ds, n_ch=n_ch, n_decay=n_decay,
                             backward=backward), PEAK_F32_FLOP_S)


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


def paper_train_config(arch, B, S):
    """Full-width, full-depth ``arch`` (a paper config: bert128, vit32,
    mt_marian) at B x S, its own MGRIT config probed every 2 steps,
    microbatches 1."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.registry import get_config
    rcfg = get_config(arch)
    return rcfg.replace(
        shape=ShapeConfig(f"{arch}_B{B}_S{S}", "train", S, B),
        microbatches=1,
        mgrit=dataclasses.replace(rcfg.mgrit, check_every=2))


def depth_text(rcfg) -> str:
    """The stacked layers a training run holds, and its MGRIT config."""
    from repro_torch.models import transformer
    cfg, mg = rcfg.model, rcfg.mgrit
    if cfg.family == "hybrid":
        return (f"{cfg.n_layers} mamba2 layers + the shared attention "
                f"block after every {cfg.hybrid_attn_every} "
                f"({cfg.n_layers // cfg.hybrid_attn_every} applications), "
                "serial (its config)")
    mgrit = (f"MGRIT cf={mg.cf} levels={mg.levels} fwd_iters="
             f"{mg.fwd_iters} bwd_iters={mg.bwd_iters}, probe every "
             f"{mg.check_every}")
    if cfg.family == "encdec":
        enc = transformer.depth_plan(cfg.n_layers, mg)
        dec = transformer.depth_plan(cfg.n_dec_layers, mg)
        return (f"encoder ParallelNet {enc.n_mid_padded} (from "
                f"{enc.n_mid_real}) + decoder ParallelNet "
                f"{dec.n_mid_padded} (from {dec.n_mid_real}, "
                f"cross-attending); {mgrit}")
    n_layers = transformer.stacked_layer_depth(rcfg)
    n_mid = n_layers - mg.n_open - mg.n_close
    n_real = cfg.n_layers - mg.n_open - mg.n_close
    return (f"{n_layers} stacked layers ({mg.n_open} open + {n_mid} "
            f"ParallelNet, gate-0 padded from {n_real}, + {mg.n_close} "
            f"close); {mgrit}")


def run_train(rcfg, required, probe=True, census=False, profiled=None,
              record=False, device_only=False):
    """``Trainer.train(3)`` of ``rcfg``, every training launch counter set
    to 0 just before and read just after (the adaptive probe at step 2
    when MGRIT and ``probe`` are on); then one step of each mode (MGRIT
    and serial when MGRIT is on, else serial), each on the batch after
    them, under the profiler unless ``profiled`` is given and leaves the
    mode out (such a step runs timed, unprofiled), and with ``census``
    the sync census of one more step of each mode (autograd's multithreading off, so the backward's
    warnings carry their Python line). ``device_only``: the profiler
    records the device's activity alone (no host op events: in a
    host-bound step they outnumber the device ops, and the trace's cost
    is its processing, ``key_averages`` over every event, not its
    collection); the seconds the trace's collection (leaving the
    profiler) and processing took are printed and kept (``trace_s``).
    The busy share's window then holds no host-op recording, so it reads
    a share of a less inflated step than a host-and-device trace's.
    Fails unless each kernel in
    ``required`` launched, every loss and forward residual norm is
    finite and, under MGRIT with ``probe``, the probe ran at step 2.
    Returns (launches over the 3 steps, {mode: launches in its one
    step}, peak GiB, info): info holds the bytes allocated after the
    ``Trainer``'s init, the three steps' seconds and modes, each
    profiled step's wall seconds (``profiled_s``), each unprofiled
    one's (``unprofiled_s``) and the seconds of each part of the run
    (``parts_s``: init, the three steps, each mode's step with its
    trace's processing); with ``record`` the first two steps'
    losses and the sha256 of every param leaf after them
    (``at_step_2``), which phase 6c holds its mesh run to."""
    import numpy as np
    import torch
    from repro_torch.data.pipeline import shard_batch
    from repro_torch.launch.steps import make_train_fn
    from repro_torch.train.trainer import Trainer
    from repro_torch.tree import leaves_with_paths
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cfg, mg = rcfg.model, rcfg.mgrit
    B, S = rcfg.shape.global_batch, rcfg.shape.seq_len
    t0 = time.perf_counter()
    trainer = Trainer(rcfg, seed=0)
    torch.cuda.synchronize()
    info = {"init_bytes": torch.cuda.memory_allocated(), "profiled_s": {},
            "unprofiled_s": {}, "trace_s": {},
            "parts_s": {"init": time.perf_counter() - t0}}
    n_params = sum(p.numel() for _, p in
                   leaves_with_paths(trainer.params))
    print(f"train: {cfg.name} d_model={cfg.d_model} {depth_text(rcfg)}; "
          f"{n_params / 1e9:.3f} B params; B={B} S={S} (shape "
          f"{rcfg.shape.name}, microbatches 1), {cfg.dtype} compute, "
          f"f32 params; init {time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB")
    torch.cuda.reset_peak_memory_stats()
    reset_train_counts()
    t0 = time.perf_counter()
    if record:
        rep = trainer.train(2, log_every=0, probe=probe)
        t_digest = time.perf_counter()
        info["at_step_2"] = {"losses": list(rep.losses),
                             "digest": state_digest(trainer.params, {
                                 "step": trainer.opt_state["step"]})}
        t_digest = time.perf_counter() - t_digest
        rest = trainer.train(1, log_every=0, probe=probe)
        rep = dataclasses.replace(
            rest, **{k: getattr(rep, k) + getattr(rest, k) for k in (
                "losses", "mode_trace", "step_seconds", "fwd_norms")})
    else:
        t_digest = 0.0
        rep = trainer.train(3, log_every=0, probe=probe)
    torch.cuda.synchronize()
    info["parts_s"]["train(3)"] = time.perf_counter() - t0 - t_digest
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
    if mg.enabled and probe and \
            [h[0] for h in rep.controller_history] != [2]:
        fail(f"{cfg.name}: the probe did not run at step 2: "
             f"{rep.controller_history}")
    if min(launches[k] for k in required) <= 0:
        fail(f"{cfg.name}: a training kernel never launched: {launches}")
    info.update(step_s=rep.step_seconds, modes=rep.mode_trace)

    modes = [("serial", rcfg.replace(
        mgrit=dataclasses.replace(mg, enabled=False)))]
    if mg.enabled:
        modes.insert(0, ("MGRIT (lp)", rcfg))
    per_mode = {}
    for mode, step_rcfg in modes:
        t_part = time.perf_counter()
        traced = profiled is None or mode in profiled
        step_fn = make_train_fn(step_rcfg)
        batch = shard_batch(trainer.pipeline.batch_at(trainer.step),
                            "cuda")
        before = train_counts()
        acts = [ProfilerActivity.CUDA] if device_only else \
            [ProfilerActivity.CPU, ProfilerActivity.CUDA]
        with profile(activities=acts) if traced \
                else contextlib.nullcontext() as prof:
            t0 = time.perf_counter()
            _, _, metrics = step_fn(trainer.params, trainer.opt_state,
                                    batch)
            loss = metrics["loss"].item()
            window = time.perf_counter() - t0
        collect = time.perf_counter() - t0 - window
        info["profiled_s" if traced else "unprofiled_s"][mode] = window
        how = "under the profiler" if traced else "(not profiled)"
        if not np.isfinite(loss):
            fail(f"the {cfg.name} {mode} step {how}: loss {loss}")
        per_step = {k: v - before[k] for k, v in train_counts().items()
                    if k in required}
        per_mode[mode] = per_step
        t_avg = time.perf_counter()
        kern = [e for e in prof.key_averages()
                if getattr(e, "device_type", None) == DeviceType.CUDA] \
            if traced else []
        if traced:
            info["trace_s"][mode] = (collect, time.perf_counter() - t_avg)
            print(f"  the {mode} step's trace ("
                  f"{'device only' if device_only else 'host and device'}"
                  f"): collection {collect:.1f} s, processing "
                  f"{info['trace_s'][mode][1]:.1f} s")
        busy = sum(dev_us(e) for e in kern) / 1e6
        print(f"one {cfg.name} {mode} train step {how}: loss "
              f"{loss:.4f}, {window:.2f} s wall, "
              + (f"device busy {busy:.2f} s = {100 * busy / window:.1f}%, "
                 f"{sum(e.count for e in kern)} device ops" if kern else
                 "device busy not measured (no device events)" if traced
                 else "no trace")
              + f"; launches in this step {per_step}")
        if min(per_step.values()) <= 0:
            fail(f"{cfg.name}: the {mode} step launched no "
                 f"{min(per_step, key=per_step.get)}: {per_step}")
        for e in sorted(kern, key=dev_us, reverse=True)[:10]:
            print(f"  {dev_us(e) / 1e6:8.3f} s  {e.count:6d}x  {e.key[:80]}")
        info["parts_s"][f"{'profiled' if traced else 'unprofiled'} "
                        f"{mode}"] = time.perf_counter() - t_part
        if census:
            with torch.autograd.set_multithreading_enabled(False), \
                    sync_census(f"{cfg.name} {mode} train step"):
                step_fn(trainer.params, trainer.opt_state, batch)
    del trainer
    print(f"train {cfg.name}: seconds by part " + ", ".join(
        f"{k} {v:.1f}" for k, v in info["parts_s"].items())
        + (f" (+{t_digest:.1f} s for the param digest at step 2)"
           if record else ""))
    return launches, per_mode, peak, info


def flash_bound_ms(B, h, hkv, S, hd, itemsize, backward=False,
                   causal=True):
    """Least time at a training shape (Sq = Sk = S)
    (``kernels.flash_attention.cost``): (4 fwd, 10 bwd) x hd flops a
    visible pair over the bf16 peak, vs the bytes moved."""
    from repro_torch.analysis.roofline import bound_ms
    from repro_torch.kernels import flash_attention as fa
    return bound_ms(*fa.cost(B, S, S, h, hkv, hd, itemsize, causal=causal,
                             backward=backward))


def time_flash(gen, flush, err, name, B, h, hkv, hd, S=TRAIN_S,
               causal=True, err_key=""):
    """The bf16 flash kernels at one training shape (S=4096 causal unless
    given): held against the plain version (``err``'s
    "flash_attention_{fwd,bwd}<err_key>" take the largest abs errors of
    out and of dq/dk/dv), then kernel, plain, SDPA and
    bound times, and the device times of the kernel and of SDPA
    (``device_ms``). Returns {"fwd"/"bwd": (kernel, plain, library,
    bound ms, bound by, kernel device, library device ms)}."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    bf = torch.bfloat16
    q, do = (torch.randn((B, S, h, hd), generator=gen,
                         device="cuda").to(bf) for _ in range(2))
    k, v = (torch.randn((B, S, hkv, hd), generator=gen,
                        device="cuda").to(bf) for _ in range(2))
    o, lse = fa.flash_attention_fwd(q, k, v, causal)

    def kfwd():
        return fa.flash_attention_fwd(q, k, v, causal)

    def kbwd():
        return fa.flash_attention_bwd(q, k, v, o, lse, do, causal)
    k_fwd, k_bwd = time_ms(kfwd, 5, flush), time_ms(kbwd, 5, flush)
    kd_fwd, kd_bwd = device_ms(kfwd, 5, flush), device_ms(kbwd, 5, flush)
    qt, kt, vt, dot = (x.transpose(1, 2) for x in (q, k, v, do))
    qr, kr, vr = (x.detach().requires_grad_(True) for x in (qt, kt, vt))
    plain_fwd = time_ms(lambda: fa.flash_attention_ref(qt, kt, vt,
                                                       causal=causal), 3,
                        flush)
    po = fa.flash_attention_ref(qr, kr, vr, causal=causal)
    plain_bwd = time_ms(lambda: torch.autograd.grad(
        po, (qr, kr, vr), dot, retain_graph=True), 3, flush)
    want = (po, *torch.autograd.grad(po, (qr, kr, vr), dot))
    got = (o, *fa.flash_attention_bwd(q, k, v, o, lse, do, causal))
    got = [x.transpose(1, 2) for x in got]
    torch.cuda.synchronize()
    e_out, out_ok = flash_out_check(got[0], want[0], "bfloat16")
    e_grad = max(_scaled_err(g, w) for g, w in zip(got[1:], want[1:]))
    shape = (f"B={B} H={h}/{hkv} Sq=Sk={S} hd={hd} "
             f"{'causal' if causal else 'full'} bfloat16")
    print(f"flash_attention {shape} ({name}): out max|kernel-plain| "
          f"{e_out:.3e}, dq/dk/dv max|kernel-plain|/max|plain| {e_grad:.3e} "
          f"({flash_tol_text('bfloat16')})")
    if not (out_ok and e_grad <= FLASH_TOL["bfloat16"]):
        fail(f"flash attention disagrees with its plain version at {name}")
    fk, bk = (f"flash_attention_{part}{err_key}" for part in ("fwd", "bwd"))
    err[fk] = max(err[fk], e_out)
    err[bk] = max(err[bk], max((g.float() - w.float()).abs().max().item()
                               for g, w in zip(got[1:], want[1:])))
    del po, want, got
    sdpa = F.scaled_dot_product_attention
    qc, kc, vc = (x.contiguous() for x in (qt, kt, vt))

    def lfwd():
        return sdpa(qc, kc, vc, is_causal=causal, enable_gqa=True)
    ql, kl, vl = (x.detach().requires_grad_(True) for x in (qc, kc, vc))
    lo = sdpa(ql, kl, vl, is_causal=causal, enable_gqa=True)
    doc = dot.contiguous()

    def lbwd():
        return torch.autograd.grad(lo, (ql, kl, vl), doc, retain_graph=True)
    lib_fwd, lib_bwd = time_ms(lfwd, 5, flush), time_ms(lbwd, 5, flush)
    ld_fwd, ld_bwd = device_ms(lfwd, 5, flush), device_ms(lbwd, 5, flush)
    del lo
    pairs = B * h * (S * (S + 1) // 2 if causal else S * S)
    rows = {}
    for part, km, pm, lm, kd, ld, per_pair in (
            ("fwd", k_fwd, plain_fwd, lib_fwd, kd_fwd, ld_fwd, 6),
            ("bwd", k_bwd, plain_bwd, lib_bwd, kd_bwd, ld_bwd, 16)):
        bm, by = flash_bound_ms(B, h, hkv, S, hd, 2, backward=part == "bwd",
                                causal=causal)
        design = 1e3 * per_pair * hd * pairs / PEAK_BF16_FLOP_S
        rows[part] = (km, pm, lm, bm, by, kd, ld)
        print(f"flash_attention_{part} {shape} ({name}): kernel {km:.4f} "
              f"ms (device {kd:.4f}), plain {pm:.4f} ms, SDPA(enable_gqa, "
              f"is_causal={causal}) {lm:.4f} ms (device {ld:.4f}), bound "
              f"{bm:.5f} ms ({by}); the design's {per_pair} x hd flops a "
              f"pair take {design:.5f} ms at the bf16 peak")
    return rows


def time_train_kernels(gen, flush, err):
    """Kernel, plain and library times at the training shapes (bf16):
    attention causal S=4096 at qwen3_1p7b's B=2 H=16/8 hd=128 and
    zamba2_1p2b's B=1 H=32/32 hd=64 (each also held against the plain
    version, see ``time_flash``); RMSNorm forward and backward at (8192,
    2048) and at qk-norm's (131072, 128), with device times. Returns
    {kernel: (kernel, plain, library, bound ms, bound by)} (flash rows
    add the kernel's and SDPA's device times), with zamba2's flash rows
    under "<kernel>@zamba2", the RMSNorm device times (kernel,
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
    rb_fwd = 1e3 * rn.cost(R, D, 2)[1] / PEAK_BYTES_S
    rb_bwd = 1e3 * rn.cost(R, D, 2, backward=True)[1] / PEAK_BYTES_S
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
        1e3 * rn.cost(Rq, HD, 2)[1] / PEAK_BYTES_S, "bytes",
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
        1e3 * rn.cost(Rq, HD, 2, backward=True)[1] / PEAK_BYTES_S,
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


def gathered_sdpa(q, pk, pv, table, lens, S):
    """SDPA on the gathered view of a paged call (the pages gathered
    beforehand, K/V repeated over the g heads, a boolean causal mask):
    the library yardstick of paged attention, as a callable."""
    import torch
    B, hkv, hd = q.shape[0], pk.shape[2], pk.shape[3]
    rows_idx = (table.long()[:, :, None] * PAGE
                + torch.arange(PAGE, device="cuda")).reshape(B, -1)
    g = q.shape[2] // hkv
    kd = pk.view(-1, hkv, hd)[rows_idx].transpose(1, 2) \
        .repeat_interleave(g, dim=1)
    vd = pv.view(-1, hkv, hd)[rows_idx].transpose(1, 2) \
        .repeat_interleave(g, dim=1)
    qd = q.transpose(1, 2)
    qpos = lens.long()[:, None] + torch.arange(S, device="cuda")
    mask = (torch.arange(kd.shape[2], device="cuda")[None, None, None, :]
            <= qpos[:, None, :, None])
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return lambda: sdpa(qd, kd, vd, attn_mask=mask)


def time_paged(flush, q, pk, pv, table, lens, lengths, S):
    """Paged attention at one bf16 serve shape (qwen3_1p7b's heads): the
    kernel (CUDA events, and the call's device work alone,
    ``device_ms``), the plain version, SDPA on the gathered view (the
    pages gathered beforehand, K/V repeated over the g heads, a boolean
    causal mask; events and device time) and the bound."""
    from repro_torch.kernels import paged_attention as pa
    B, P = q.shape[0], table.shape[1]

    def kernel():
        return pa.paged_flash_attention(q, pk, pv, table, lens)
    library = gathered_sdpa(q, pk, pv, table, lens, S)
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
    SERVED[name] = [r.output.tolist() for r in out]
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


def step_check(engine, step, init_pool, rng, moe_replay=False):
    """One prefill (S=64) and one decode step, fused kernels vs the
    gathered path with every plain version (norms included). In float32
    the two must agree closely; in bf16 the kernel path must be no
    further from the float32 reference than the plain bf16 path is
    (times STEP_BF16_FACTOR) — bf16 rounding through a random-weight
    model's layers moves logits by a few percent either way. With
    ``moe_replay`` (an MoE model) every variant replays the float32
    gathered path's routing (``record_routes``): a routing flip between
    two variants would move a token to another expert, a difference no
    kernel made."""
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
    order = sorted(variants, key=lambda k: moe_replay and k != "f32 gathered")
    for i, S in enumerate((64, 1)):
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                             (MAX_BATCH, S))).cuda()
        lg, routes = {}, None
        for k in order:
            prm, r, fused = variants[k]
            with contextlib.ExitStack() as ctx:
                if not fused:
                    ctx.enter_context(plain_kernels())
                if moe_replay:
                    plans = ctx.enter_context(record_routes(replay=routes))
                logit, _ = step(prm, pools[k], toks, lengths, n_new, table,
                                r, fused=fused)
            if moe_replay and routes is None:
                routes = plans
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
              f"path {ep:.3e} (tolerance {STEP_BF16_FACTOR:g}x plain)"
              + ("; every variant on the f32 gathered path's routing"
                 if moe_replay else ""))
        if not e32 <= STEP_F32_TOL or not ek <= STEP_BF16_FACTOR * ep:
            fail(f"{cfg.name}: fused and gathered steps disagree at step {i}")
        lengths = lengths + n_new.to(torch.int32)
        n_new = torch.ones(MAX_BATCH, dtype=torch.long, device="cuda")


def profile_decode_wave(be, name, prefill=False):
    """Where a steady decode wave's device time goes: B=4 at contexts
    DECODE_LENS, 2 of 4 slots sampled, 5 waves under the profiler; then
    the sync census of one more wave and, with ``prefill``, of a 64-token
    prefill wave (after one warm-up call at its shape)."""
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
    # the port's paged kernels and the sampling mask, in the top rows or
    # not: their own device time per launch
    for e in kern:
        kernel = re.search(r"::((?:paged_\w+|topk_topp_mask_kernel)<[^>]*>)",
                           e.key)
        if kernel and e.count:
            print(f"  {name} decode wave: {kernel.group(1)} "
                  f"{dev_us(e) / e.count:.2f} us a launch, {e.count // 5}x "
                  "a wave")
    with sync_census(f"{name} decode wave"):
        be.step(scratch, slots, tok)
    if prefill:
        pre = SlotBatch.greedy(MAX_BATCH, ptab, n_new=[64, 50, 33, 10])
        pre.temps[1::2] = 0.8
        pre.top_ks[1::2] = 40
        pre.top_ps[1::2] = 0.95
        ptok = np.ones((MAX_BATCH, 64), np.int32)
        be.prefill(scratch, pre, ptok)
        with sync_census(f"{name} prefill wave (S=64)"):
            be.prefill(scratch, pre, ptok)


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


def ssm_table(gen):
    """MAX_BATCH slots x MAX_LEN // PAGE pages of the pool, in random
    order (page 0 is scratch)."""
    import torch
    P = MAX_LEN // PAGE
    perm = torch.randperm(MAX_BATCH * P, generator=gen, device="cuda") + 1
    return perm.reshape(MAX_BATCH, P).to(torch.int32)


def ssm_plan_of(table, lens, nn, S):
    """(read_page, live, phys_w, t_w): the compact plan the mixers build."""
    from repro_torch.models import ssm as tssm
    t_w, phys_w = tssm.compact_snapshot_steps(table, lens, nn, PAGE, S)
    read_page, live = tssm.paged_read_plan(table, lens, PAGE)
    return read_page, live, phys_w, t_w


def ssm_kernel_case(gen, order, S, lengths, n_new, table=None):
    """Full-width rows-layout inputs for one order (R, ds from SSM_ROWS)
    on a pool of MAX_BATCH slots x MAX_LEN // PAGE pages (``table``, else
    a random one), with the compact plan the mixers build. Mamba2's A is
    the per-head decay broadcast across d_state (stride 0), as on the
    main path."""
    import torch
    R, ds = SSM_ROWS[order]
    n_pages = 1 + MAX_BATCH * (MAX_LEN // PAGE)

    def r(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    dt = torch.nn.functional.softplus(r(MAX_BATCH, S, R)) * 0.2
    if order == "dbx":
        A = -torch.exp(r(R, ds))
    else:
        A = (-torch.exp(r(R // 64))).repeat_interleave(64)[:, None] \
            .expand(R, ds)
    if table is None:
        table = ssm_table(gen)
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    nn = torch.tensor(n_new, dtype=torch.int32, device="cuda")
    return (dt, r(MAX_BATCH, S, R), r(MAX_BATCH, S, ds), r(MAX_BATCH, S, ds),
            A, r(n_pages, R, ds), ssm_plan_of(table, lens, nn, S), nn)


def check_ssm_split(gen, order, split):
    """Chunked prefill == one call, bit for bit: SSM_CASES' 256-token
    chunk (a slot from 0, one mid-page, an idle one, one late; one slot
    padded past its n_new) at ``order``'s full-width rows, split in two
    calls at ``split``, gives y and the pool bit-identical to one call."""
    import torch
    from repro_torch.kernels import paged_ssm as ps
    S, lengths, n_new = SSM_CASES[2]
    table = ssm_table(gen)
    dt, x, Bm, Cm, A, pool, plan, nn = ssm_kernel_case(
        gen, order, S, lengths, n_new, table)
    pools = [pool.clone(), pool.clone()]
    one = ps.paged_ssm_update(dt, x, Bm, Cm, A, pools[0], *plan, nn,
                              order=order)
    ys = []
    at = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    for lo, hi in ((0, split), (split, S)):
        n = torch.clamp(nn - lo, 0, hi - lo).to(torch.int32)
        part = [t[:, lo:hi].contiguous() for t in (dt, x, Bm, Cm)]
        ys.append(ps.paged_ssm_update(
            *part, A, pools[1], *ssm_plan_of(table, at, n, hi - lo), n,
            order=order))
        at = (at + n).to(torch.int32)
    torch.cuda.synchronize()
    same = (torch.equal(torch.cat(ys, dim=1), one)
            and torch.equal(pools[1], pools[0]))
    print(f"paged_ssm_update {order} S={S} lengths {lengths} n_new {n_new}:"
          f" two calls split at step {split} bit-identical to one call "
          f"(y and pool) {same}")
    if not same:
        fail(f"paged_ssm_update {order}: a call split in two differs from "
             "one call")


def check_ssm_kernel(gen):
    """The paged SSM kernel against its plain version at both full-width
    shapes: y on valid rows and the non-scratch pages within SSM_TOL of
    max|plain|, pages outside the plan bit-identical, a second launch
    bit-identical; at both orders a call split in two bit-identical to
    one call. Returns the largest abs error of y per order."""
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
        # inside a page; and a last call of one step (the decode kernel)
        for split in (100, 255):
            check_ssm_split(gen, order, split)
    return err


def ssm_bound_ms(order, S, lengths, n_new, plan):
    """Least time for one paged SSM update on these inputs
    (``kernels.paged_ssm.cost``): the live read pages and the pages the
    plan writes, its float32 operations at the non-tensor peak."""
    from repro_torch.analysis.roofline import bound_ms
    from repro_torch.kernels import paged_ssm as ps
    R, ds = SSM_ROWS[order]
    assert len(n_new) == MAX_BATCH
    live = sum(1 for n in lengths if n > 0)
    written = int((plan[2] != 0).sum())
    return bound_ms(*ps.cost(order, S, R, ds, plan[2].shape[1], n_new, live,
                             written), PEAK_F32_FLOP_S)


def time_ssm_kernel(gen, flush):
    """Kernel (CUDA events around the wrapper call, and the call's
    device time, ``device_ms``, which includes the wrapper's int32
    conversions of the plan; and the kernel's alone, with the plan handed
    over as int32 already), plain and bound times of the paged SSM update
    at both full-width shapes: decode (B=4, S=1, contexts DECODE_LENS) and
    a 256-token prefill chunk. No single PyTorch call computes the paged
    scan (a snapshot-paged selective scan), so there is no library
    time."""
    import torch
    from repro_torch.kernels import paged_ssm as ps
    rows = {}
    floor = device_ms(lambda: torch.cuda._sleep(0), 20, flush)
    print(f"device_ms of an empty launch (the floor of a kernel-alone "
          f"time): {floor:.4f} ms")
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
            a32 = (*args[:6], *(t.to(torch.int32) for t in (*plan, nn)))
            a_ms = device_ms(lambda a=a32, o=order: ps.paged_ssm_update(
                *a, order=o), 20, flush)
            p_ms = time_ms(lambda a=args, o=order: ps.paged_ssm_update_ref(
                *a, order=o), iters=20 if S == 1 else 3, flush=flush)
            b_ms, by = ssm_bound_ms(order, S, lengths, n_new, plan)
            print(f"paged_ssm_update {order} R={R} ds={ds} B={MAX_BATCH} "
                  f"S={S}: kernel {k_ms:.4f} ms (device {d_ms:.4f} ms; "
                  f"kernel alone {a_ms:.4f} ms), plain {p_ms:.4f} ms, "
                  f"bound {b_ms:.5f} ms ({by}), library none")
            rows[(order, S)] = (k_ms, d_ms, p_ms, b_ms, by, a_ms)
    return rows


# -- speculative decoding (phase 5b) -------------------------------------

# the paper's near-identity "trained regime", in which the coarse grid is
# a useful draft: every residual output projection (and mamba2's gated
# norm gain) damped per family; copied from benchmarks/bench_spec.py:65-83
# (this script imports only repro_torch, torch and numpy)
_RESIDUAL_OUT = ("out_proj", "wo", "w_out", "norm_scale")
TRAINED_REGIME_DAMP = {"attn": 0.1, "ssm": 0.1, "hybrid": 0.05}


def trained_regime(params, factor: float):
    """Damp every residual output projection by ``factor``."""
    if isinstance(params, dict):
        return {k: (v * factor if k in _RESIDUAL_OUT
                    else trained_regime(v, factor))
                for k, v in params.items()}
    return params


SPEC_CF, SPEC_K = 4, 4
SPEC_S = (2, 3, 5)              # verify / ingest widths the kernels take
# verify runs the bf16 projections at M = B(k+1) rows where decode runs
# M = B (and the draft's ingest at M = B(k+1) where a serial forward runs
# M = its length), so cuBLAS may round differently: at every position
# whose context two paths share, max|logits of one - logits of the other|
# over the vocab must stay within SPEC_GAP. A greedy first divergence of
# spec from plain decode (or of the draft from a serial forward of the
# draft's params) is allowed only where the token taken lies within
# SPEC_TIE = 2 SPEC_GAP of the reference path's top logit: two logit
# vectors within SPEC_GAP of each other can flip only such a pair.
# SPEC_GAP is the largest gap read on an H100 between any two of these
# paths, 0.3047 (falcon_mamba_7b in the trained regime: a serial forward
# vs plain decode at a divergence; verify vs decode 0.2891 there),
# rounded up to 12 bf16 ulps at |logit| in [4, 8).
SPEC_GAP = 0.375
SPEC_TIE = 2 * SPEC_GAP
# the trained regime's damping was set on toy widths, where the coarse
# draft agrees with the fine model; at full width its drafts are almost
# never accepted, so every family is also served at this damping, where
# drafts are accepted and the accept-and-commit half runs
SPEC_ACCEPT_DAMP = 0.001
SPEC_REQS = 4                   # the smoke queue's greedy requests
SPEC_LENS = [16, 31, 0, 300]    # slots at a page boundary, mid-page, empty
SPEC_NNEW = [5, 3, 5, 0]        # ... and idle, at S = 5
SPEC_FAMILIES = (("qwen3_1p7b", "attn"), ("falcon_mamba_7b", "ssm"),
                 ("zamba2_1p2b", "hybrid"))


@contextlib.contextmanager
def plain_paged_ssm():
    """Route ``kernels.ops.paged_ssm_update`` to its plain version for the
    duration; fails if the kernel launches meanwhile."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import paged_ssm as ps
    saved, before = ops.paged_ssm_update, ps.paged_ssm_update.launches
    ops.paged_ssm_update = ps.paged_ssm_update_ref
    try:
        yield
    finally:
        ops.paged_ssm_update = saved
    if ps.paged_ssm_update.launches != before:
        fail("the paged SSM kernel launched on the plain path")


def spec_ssm_case(gen, order):
    """Full-width rows-layout inputs at S = 5 (SPEC_LENS / SPEC_NNEW) on
    a random table, as ``ssm_kernel_case`` builds them."""
    import torch
    table = ssm_table(gen)
    dt, x, Bm, Cm, A, pool, _, nn = ssm_kernel_case(
        gen, order, 5, SPEC_LENS, SPEC_NNEW, table)
    lens = torch.tensor(SPEC_LENS, dtype=torch.int32, device="cuda")
    return (dt, x, Bm, Cm, A), pool, table, lens, nn


def check_spec_kernels(gen):
    """The kernels at the spec path's new shapes: paged attention at
    S = 2, 3, 5 (qwen3_1p7b's and zamba2_1p2b's heads, bf16 and float32)
    as ``check_paged_case`` holds it; the paged SSM update's every-step
    plan (``models.ssm.every_step_update``, the verify recurrence) at
    S = 5 for both orders against the plain deferred recurrence (y on
    valid rows and every step's state within SSM_TOL of max|plain|, the
    pool untouched, a second launch bitwise); and a commit of n_write in
    {1, 3, 5} verified steps, whose pool must equal bit for bit what
    n_write plain decode calls (S = 1, the decode kernel) leave. Returns
    the largest abs errors."""
    import torch
    from repro_torch.kernels import paged_ssm as ps
    from repro_torch.models import ssm as tssm
    err = {"attn": 0.0}
    for heads in ((H, HKV, HD), (32, 32, 64)):
        for dtype in (torch.bfloat16, torch.float32):
            for S in SPEC_S:
                e = check_paged_case(gen, heads, S, SPEC_LENS, dtype)
                if dtype == torch.bfloat16:
                    err["attn"] = max(err["attn"], e)
    for order in ("dbx", "dxb"):
        rows, pool, table, lens, nn = spec_ssm_case(gen, order)
        kept = pool.clone()
        got = tssm.every_step_update(*rows, pool, table, lens, nn, PAGE,
                                     order=order)
        again = tssm.every_step_update(*rows, pool, table, lens, nn, PAGE,
                                       order=order)
        with plain_paged_ssm():
            want = tssm.every_step_update(*rows, pool, table, lens, nn,
                                          PAGE, order=order)
        torch.cuda.synchronize()
        valid = (torch.arange(5, device="cuda")[None, :]
                 < nn[:, None])[..., None]
        e_y = _scaled_err(got[0] * valid, want[0] * valid)
        e_h = _scaled_err(got[1] * valid[..., None], want[1] * valid[..., None])
        abs_y = ((got[0] - want[0]) * valid).abs().max().item()
        same = all(torch.equal(a, b)
                   for a, b in zip(got, again, strict=True))
        untouched = torch.equal(pool, kept)
        print(f"paged_ssm_update {order} every-step plan (verify) S=5 "
              f"lengths {SPEC_LENS} n_new {SPEC_NNEW}: y max|kernel-plain| "
              f"{abs_y:.3e} = {e_y:.3e} of max|plain|, states {e_h:.3e} "
              f"(tolerance {SSM_TOL:g}); pool untouched {untouched}, second "
              f"launch bit-identical {same}")
        if not (e_y <= SSM_TOL and e_h <= SSM_TOL and same and untouched):
            fail(f"paged_ssm_update {order}: the every-step plan disagrees "
                 "with the plain deferred recurrence")
        err[order] = abs_y
        for n_write in (1, 3, 5):
            nw = torch.clamp(nn, max=n_write)
            committed, decoded = pool.clone(), pool.clone()
            hs = tssm.every_step_update(*rows, committed, table, lens, nn,
                                        PAGE, order=order)[1]
            t, phys = tssm.snapshot_steps(table, lens, nw, PAGE)
            tssm.paged_state_write(
                committed, hs[torch.arange(MAX_BATCH, device="cuda")[:, None],
                              t], phys)
            at = lens.clone()
            for step in range(n_write):
                live = (nw > step).to(torch.int32)
                part = [a[:, step:step + 1].contiguous() for a in rows[:4]]
                ps.paged_ssm_update(*part, rows[4], decoded,
                                    *ssm_plan_of(table, at, live, 1), live,
                                    order=order)
                at = (at + live).to(torch.int32)
            torch.cuda.synchronize()
            same = torch.equal(committed[1:], decoded[1:])
            print(f"paged_ssm_update {order}: commit of {n_write} verified "
                  f"steps == {n_write} decode calls, bitwise on every page "
                  f"but scratch: {same}")
            if not same:
                fail(f"paged_ssm_update {order}: a commit of {n_write} "
                     "verified steps differs from plain decode")
    return err


def time_spec_kernels(gen, flush):
    """Rows 3c and 6c: paged attention at verify's S = 5 (B = 4, qwen3's
    heads, contexts DECODE_LENS) beside SDPA on the gathered view, and the
    paged SSM update's every-step plan at S = 5 (both orders; the kernel
    call on the prepared scratch buffer, its device time, the plain
    version; no single PyTorch call computes it)."""
    import torch
    from repro_torch.kernels import paged_ssm as ps
    from repro_torch.models import ssm as tssm
    q, pk, pv, table, lens = attn_case(gen, MAX_BATCH, 5, DECODE_LENS,
                                       torch.bfloat16, MAX_LEN // PAGE,
                                       poison=0.0)
    P = live_bucket(DECODE_LENS, 5)
    attn = time_paged(flush, q, pk, pv, table[:, :P], lens, DECODE_LENS, 5)
    print(f"paged_flash_attention verify B=4 S=5 bf16 P={P}: kernel "
          f"{attn['ms']:.4f} ms (device {attn['device_ms']:.4f}), plain "
          f"{attn['plain_ms']:.4f} ms, SDPA on the gathered view "
          f"{attn['library_ms']:.4f} ms (device "
          f"{attn['library_device_ms']:.4f}), bound {attn['bound_ms']:.5f}"
          f" ms ({attn['bound_by']})")
    rows = {}
    n_new = [5] * MAX_BATCH
    for order in ("dbx", "dxb"):
        R, ds = SSM_ROWS[order]
        table = ssm_table(gen)
        dt, x, Bm, Cm, A, pool, _, nn = ssm_kernel_case(
            gen, order, 5, DECODE_LENS, n_new, table)
        lns = torch.tensor(DECODE_LENS, dtype=torch.int32, device="cuda")
        read_page, live = tssm.paged_read_plan(table, lns, PAGE)
        seed = torch.arange(MAX_BATCH, device="cuda") * 6
        buf = torch.empty((MAX_BATCH * 6, R, ds), device="cuda")
        buf[seed] = pool[read_page.long()]
        steps = torch.arange(5, device="cuda")
        plan = (seed.to(torch.int32), live.to(torch.int32),
                (seed[:, None] + 1 + steps).to(torch.int32),
                steps[None, :].expand(MAX_BATCH, 5).to(torch.int32).contiguous())
        args = (dt, x, Bm, Cm, A, buf, *plan, nn)
        k_ms = time_ms(lambda a=args, o=order: ps.paged_ssm_update(
            *a, order=o), flush=flush)
        d_ms = device_ms(lambda a=args, o=order: ps.paged_ssm_update(
            *a, order=o), 20, flush)
        p_ms = time_ms(lambda a=args, o=order: ps.paged_ssm_update_ref(
            *a, order=o), flush=flush)
        b_ms, by = ssm_bound_ms(order, 5, DECODE_LENS, n_new, plan)
        print(f"paged_ssm_update {order} every-step plan R={R} ds={ds} "
              f"B={MAX_BATCH} S=5: kernel {k_ms:.4f} ms (device {d_ms:.4f} "
              f"ms, plan int32), plain {p_ms:.4f} ms, bound {b_ms:.5f} ms "
              f"({by}), library none")
        rows[order] = dict(ms=k_ms, device_ms=d_ms, plain_ms=p_ms,
                           bound_ms=b_ms, bound_by=by)
    return attn, rows


def profile_spec_wave(engine, reqs, card):
    """One steady speculative wave of ``engine`` (``reqs`` admitted and
    decoding), its draft call and its verify call each timed alone (wall
    with a device sync, three unprofiled waves) and then under the
    profiler (device busy, device ops, the kernels' launches in each
    call), then the sync census of each call of one more wave. Returns
    {call: launches in the profiled wave}."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    sched = engine.scheduler
    name = engine.rcfg.model.name
    for r in reqs:
        engine.submit(r)
    sched.step()                         # admission wave + a spec wave
    walls = {"draft": [], "verify": []}
    prof_rows, launches = {}, {}

    def timed(label, fn, profiled):
        def call(*a, **k):
            if profiled == "census":
                with sync_census(f"{name} spec wave, {label} call"):
                    return fn(*a, **k)
            torch.cuda.synchronize()
            before = serve_counts()
            if not profiled:
                t0 = time.perf_counter()
                out = fn(*a, **k)
                torch.cuda.synchronize()
                walls[label].append(time.perf_counter() - t0)
                return out
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                out = fn(*a, **k)
                torch.cuda.synchronize()
            kern = [e for e in prof.key_averages()
                    if getattr(e, "device_type", None) == DeviceType.CUDA]
            prof_rows[label] = (sum(dev_us(e) for e in kern) / 1e6,
                                sum(e.count for e in kern))
            launches[label] = {k: v - before[k]
                               for k, v in serve_counts().items()}
            return out
        return call

    draft, verify = sched.spec.wave, engine.backend.verify
    # each wave emits at most SPEC_K + 1 of a request's 32 tokens: after
    # the admission wave and these five, every request is still decoding
    for profiled in (False, False, False, True, "census"):
        if sched.n_active < len(reqs):
            fail(f"{name}: a request finished before the profiled spec wave")
        sched.spec.wave = timed("draft", draft, profiled)
        engine.backend.verify = timed("verify", verify, profiled)
        try:
            sched.step()
        finally:
            del sched.spec.wave, engine.backend.verify
    sched.run()
    for label in ("draft", "verify"):
        wall = sum(walls[label]) / len(walls[label])
        busy, ops = prof_rows.get(label, (0.0, 0))
        print(f"[{card}] {name} spec wave, {label} call: {1e3 * wall:.2f} ms "
              f"wall, "
              + (f"device busy {1e3 * busy:.2f} ms = {100 * busy / wall:.1f}%"
                 f", {ops} device ops" if ops else
                 "device busy not measured (no device events)")
              + f"; launches {launches[label]}")
    return launches


@contextlib.contextmanager
def record_spec_logits():
    """Keep a reference to every logits tensor the serve steps draw a
    token from (``sample_tokens`` under ``CacheBackend.prefill`` /
    ``step``; ``speculative_accept``: verify; ``draft_sample_tokens``: the
    draft wave), with its slots' seeds, emission counters and occupancy
    (``n_new``: the backend call's for prefill and decode, the window
    widths for verify). No device work is added: the tensors are read
    after the run."""
    from repro_torch.launch import steps
    from repro_torch.serve.cache import CacheBackend
    calls, live = [], [None]
    saved = (steps.sample_tokens, steps.speculative_accept,
             steps.draft_sample_tokens, CacheBackend.prefill,
             CacheBackend.step)

    def sample(logits, temps, top_ks, top_ps, seeds, counters, **kw):
        if live[0] is not None:          # not the draft's own prefill
            calls.append(("emit", logits, seeds, counters,
                          (live[0] > 0).astype(np.int64)))
        return saved[0](logits, temps, top_ks, top_ps, seeds, counters,
                        **kw)

    def accept(logits, tokens, draft_probs, temps, top_ks, top_ps, seeds,
               counters, n_new, **kw):
        calls.append(("emit", logits, seeds, counters, n_new))
        return saved[1](logits, tokens, draft_probs, temps, top_ks, top_ps,
                        seeds, counters, n_new, **kw)

    def draft(logits, temps, top_ks, top_ps, seeds, counters, **kw):
        calls.append(("draft", logits, seeds, counters, None))
        return saved[2](logits, temps, top_ks, top_ps, seeds, counters,
                        **kw)

    def occupied(call):
        def run(self, state, slots, tokens):
            live[0] = np.asarray(slots.n_new)
            try:
                return call(self, state, slots, tokens)
            finally:
                live[0] = None
        return run

    import numpy as np
    (steps.sample_tokens, steps.speculative_accept,
     steps.draft_sample_tokens) = sample, accept, draft
    CacheBackend.prefill = occupied(saved[3])
    CacheBackend.step = occupied(saved[4])
    try:
        yield calls
    finally:
        (steps.sample_tokens, steps.speculative_accept,
         steps.draft_sample_tokens, CacheBackend.prefill,
         CacheBackend.step) = saved


def emitted_rows(calls, seeds):
    """{(seed, emission index): the logits row the token was drawn from}
    for the requests whose (nonzero, distinct) seeds are given. Window
    row i of an occupied slot is emission index counter + i; the last
    call covering an index is the one that emitted it (a rejected suffix
    is verified again by the next wave, a chunked prefill ends with its
    last chunk)."""
    rows = {}
    for kind, lg, sd, ct, nn in calls:
        if kind != "emit":
            continue
        sd, ct, nn = sd.tolist(), ct.tolist(), nn.tolist()
        for b, seed in enumerate(sd):
            if seed in seeds:
                for i in range(nn[b]):
                    rows[(seed, ct[b] + i)] = (lg[b] if lg.dim() == 2
                                               else lg[b, i])
    return rows


def _row_gap(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


def check_greedy_spec(served, rcfg, greedy, outs, rows, label, card,
                      allow=None):
    """Greedy spec against plain decode on one card. At every emission
    index whose context the two runs share (up to and including a first
    divergence), the logits spec drew its token from (verify's, or the
    prefill's) must lie within SPEC_GAP of plain decode's, each run's
    token must be the argmax of its own row, and at a first divergence
    the spec token must lie within SPEC_TIE of the top logit of plain
    decode's row and of a teacher-forced serial forward's (itself within
    SPEC_GAP of decode's). ``allow`` (an MoE model, ``moe_allowance``):
    where the two runs' routes over the context differ, MOE_FLIP_GAP in
    place of SPEC_GAP and any divergence; no serial forward (its capacity
    comes from the whole sequence's S). Returns (bitwise matches, the
    largest verify-vs-decode gap over the positions whose routes agree,
    divergences)."""
    import numpy as np
    import torch
    from repro_torch.models import transformer
    name = rcfg.model.name
    matched, worst, divergences = 0, 0.0, []
    for i, (a, b) in enumerate(zip(outs["plain"], outs["spec"],
                                   strict=True)):
        seed = greedy[i].seed
        j = int(np.argmax(a != b)) if not np.array_equal(a, b) else None
        shared = len(a) if j is None else j + 1
        for m in range(shared):
            pl, sp = rows["plain"][(seed, m)], rows["spec"][(seed, m)]
            if int(pl.float().argmax()) != a[m] or \
                    int(sp.float().argmax()) != b[m]:
                fail(f"{name} {label} request {i} token {m}: the emitted "
                     "token is not the argmax of the logits it was drawn "
                     "from")
            gap = _row_gap(pl, sp)
            routed = allow(seed, m) if allow is not None else None
            limit = SPEC_GAP if routed is None else MOE_FLIP_GAP
            if routed is None:
                worst = max(worst, gap)
            else:
                print(f"[{card}] spec {name} {label} request {i} token {m}: "
                      f"routes differ ({routed[0]}, margin {routed[1]}), "
                      f"gap {gap:.4f} (limit {limit:g})")
            if gap > limit:
                fail(f"{name} {label} request {i} token {m}: verify's "
                     f"logits lie {gap:.4f} from plain decode's (limit "
                     f"{limit:g})")
        if j is None:
            matched += 1
            continue
        dec = rows["plain"][(seed, j)].float()
        if allow is not None:
            routed = allow(seed, j)
            d_tie = (dec.max() - dec[b[j]]).item()
            divergences.append(dict(request=i, token=j, decode_margin=d_tie,
                                    routes=None if routed is None
                                    else routed[0]))
            print(f"[{card}] spec {name} {label} request {i}: first "
                  f"divergence at token {j} ({a[j]} plain, {b[j]} spec); "
                  f"the spec token lies {d_tie:.4f} below plain decode's "
                  f"top logit; routes "
                  + ("agree" if routed is None else
                     f"differ ({routed[0]}, margin {routed[1]})"))
            if routed is None and not d_tie < SPEC_TIE:
                fail(f"{name} {label}: greedy spec diverged from plain "
                     f"decode away from a near-tie ({d_tie:.4f})")
            continue
        seq = np.concatenate([greedy[i].prompt, a]).astype(np.int64)
        with torch.no_grad():
            logits, _ = transformer.forward(
                served, {"tokens": torch.from_numpy(seq[None]).to(
                    dec.device)}, rcfg, mode="serial")
        ser = logits[0, len(greedy[i].prompt) + j - 1].float()
        d_tie = (dec.max() - dec[b[j]]).item()
        s_tie = (ser.max() - ser[b[j]]).item()
        gap = _row_gap(rows["spec"][(seed, j)], dec)
        divergences.append(dict(request=i, token=j, decode_margin=d_tie,
                                serial_margin=s_tie, gap=gap,
                                serial_gap=_row_gap(ser, dec)))
        print(f"[{card}] spec {name} {label} request {i}: first divergence "
              f"at token {j} ({a[j]} plain, {b[j]} spec); the spec token "
              f"lies {d_tie:.4f} below plain decode's top logit "
              f"{dec.max().item():.4f} ({d_tie / bf16_ulp(dec.max().item()):g}"
              f" bf16 ulp) and {s_tie:.4f} below the serial forward's; "
              f"max|verify - decode| there {gap:.4f}, max|serial - decode| "
              f"{divergences[-1]['serial_gap']:.4f} (limits: tie "
              f"{SPEC_TIE:g}, gap {SPEC_GAP:g})")
        if not (d_tie < SPEC_TIE and s_tie < SPEC_TIE):
            fail(f"{name} {label}: greedy spec diverged from plain decode "
                 f"away from a near-tie ({d_tie:.4f} / {s_tie:.4f})")
        if divergences[-1]["serial_gap"] > SPEC_GAP:
            fail(f"{name} {label}: the serial forward's logits lie "
                 f"{divergences[-1]['serial_gap']:.4f} from plain decode's")
    print(f"[{card}] spec {name} {label}: {matched}/{len(greedy)} greedy "
          f"requests bitwise equal to plain decode, the rest diverged on "
          f"near-ties; max|verify - decode| over every shared-context "
          f"position {worst:.4f} (limit {SPEC_GAP:g})")
    return matched, worst, divergences


def check_draft_tokens(engine, greedy, outs, waves, calls, card, label,
                       catch_up: bool):
    """Hold the draft's greedy tokens of one wave against a teacher-forced
    serial forward of the draft's own params: the wave (of a greedy
    request) with the longest catch-up ingest, its context the prompt and
    the canonical output up to the wave; each drafted token must be the
    serial forward's argmax or within SPEC_TIE of it, and the wave's
    logits within SPEC_GAP of the serial forward's. ``catch_up`` requires
    an ingest of two tokens or more (a draft accepted the wave before).
    Returns (n_in, max gap)."""
    import numpy as np
    import torch
    from repro_torch.models import transformer
    from repro_torch.tree import leaves_with_paths, unflatten
    draft = engine.scheduler.spec
    name = engine.rcfg.model.name
    by_seed = {r.seed: i for i, r in enumerate(greedy)}
    best = None
    for n_in, n_draft, seeds, counters, window, lo, hi in waves:
        for b, seed in enumerate(seeds.tolist()):
            if seed in by_seed and n_draft[b] >= 1 and (
                    best is None or n_in[b] > best[0]):
                best = (int(n_in[b]), b, by_seed[seed], int(counters[b]),
                        int(n_draft[b]), window, lo, hi)
    if best is None or (catch_up and best[0] < 2):
        fail(f"{name} {label}: no draft wave ingested "
             f"{'two or more tokens' if catch_up else 'a token'}")
    n_in, b, i, c, n, window, lo, hi = best
    steps = [lg for kind, lg, *_ in calls[lo:hi] if kind == "draft"]
    drafted = window[b, 1:1 + n].tolist()
    ctx = np.concatenate([greedy[i].prompt, outs["spec"][i][:c]])
    seq = np.concatenate([ctx, drafted[:-1]]).astype(np.int64)
    params = draft.params
    if isinstance(params.get("mid", {}).get("params"), list):
        # forward takes a stacked trunk: stack the per-layer views
        layers = [leaves_with_paths(p) for p in params["mid"]["params"]]
        params = {**params, "mid": {**params["mid"], "params": unflatten(
            (path, torch.stack([ls[n][1] for ls in layers]))
            for n, (path, _) in enumerate(layers[0]))}}
    with torch.no_grad():
        logits, _ = transformer.forward(
            params, {"tokens": torch.from_numpy(seq[None]).to(
                window.device)}, draft.rcfg, mode="serial")
    del params
    gap, ties = 0.0, []
    for t in range(n):
        ser = logits[0, len(ctx) - 1 + t].float()
        gap = max(gap, _row_gap(steps[t][b], ser))
        ties.append((ser.max() - ser[drafted[t]]).item())
    print(f"[{card}] spec {name} {label}: draft wave of request {i} at "
          f"token {c} (ingest {n_in}, {n} drafted {drafted}) vs a serial "
          f"forward of the {draft.n_coarse}-layer draft: the drafted "
          f"tokens lie {[round(x, 4) for x in ties]} below its top logits,"
          f" max|wave - serial| {gap:.4f} (limits: tie {SPEC_TIE:g}, gap "
          f"{SPEC_GAP:g})")
    if gap > SPEC_GAP or max(ties) >= SPEC_TIE:
        fail(f"{name} {label}: the draft's greedy tokens disagree with a "
             "serial forward of its params")
    return n_in, gap


def spec_greedy(rcfg, served, greedy, card, label, engine_kw=None,
                wrap_run=None, allow=None):
    """A plain engine and a ``SpecConfig(SPEC_CF, SPEC_K)`` engine on
    ``served``, both warmed; the greedy requests through each, timed
    (counters set to 0 just before, the logits recorded), each request
    finishing with its budget; then ``check_greedy_spec`` and
    ``check_draft_tokens``. For the MoE family: ``engine_kw`` (more
    engine options), ``wrap_run(mode, run)`` around each timed run, and
    ``allow`` for ``check_greedy_spec``, which also skips
    ``check_draft_tokens`` (a serial forward of the draft would call the
    MoE at another S). Returns (engines, numbers, launch counts)."""
    import statistics

    import numpy as np
    import torch
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.spec import SpecConfig
    name = rcfg.model.name
    seeds = {r.seed for r in greedy}
    if len(seeds) != len(greedy) or 0 in seeds:
        fail(f"{name}: the greedy requests' seeds do not tell them apart")
    kw = dict(max_batch=MAX_BATCH, page_size=PAGE, max_len=MAX_LEN,
              device="cuda", **(engine_kw or {}))
    engines = {"plain": ServeEngine(rcfg, served, **kw),
               "spec": ServeEngine(rcfg, served,
                                   spec=SpecConfig(cf=SPEC_CF, k=SPEC_K),
                                   **kw)}
    for e in engines.values():               # warm-up
        e.generate([dataclasses.replace(greedy[0], max_new_tokens=6)])
    torch.cuda.synchronize()
    res, outs, launches, rows, waves = {}, {}, {}, {}, []
    sched = engines["spec"].scheduler
    wave = sched.spec.wave

    def recorded_wave(ingest, n_in, n_draft, temps, top_ks, top_ps, seeds,
                      counters):
        lo = len(calls)
        window, q = wave(ingest, n_in, n_draft, temps, top_ks, top_ps,
                         seeds, counters)
        waves.append((np.array(n_in), np.array(n_draft), np.array(seeds),
                      np.array(counters), window, lo, len(calls)))
        return window, q

    for mode, e in engines.items():
        st = e.scheduler.stats
        for k in st:
            st[k] = type(st[k])(0)
        with record_spec_logits() as calls:
            if mode == "spec":
                sched.spec.wave = recorded_wave
            reset_serve_counts()
            t0 = time.perf_counter()
            try:
                def run(e=e):
                    out = e.generate([dataclasses.replace(r)
                                      for r in greedy])
                    torch.cuda.synchronize()
                    return out
                out = wrap_run(mode, run) if wrap_run else run()
            finally:
                if mode == "spec":
                    del sched.spec.wave
            wall = time.perf_counter() - t0
            launches[mode] = serve_counts()
            rows[mode] = emitted_rows(calls, seeds)
            if mode == "spec":
                spec_calls = calls
        outs[mode] = [r.output for r in out]
        thr = e.scheduler.throughput()
        res[mode] = dict(decode_tok_s=thr["decode_tok_s"],
                         ttft_p50_s=statistics.median(r.ttft_s for r in out),
                         tokens=sum(len(r.output) for r in out),
                         wall_s=wall,
                         accept_rate=e.stats["accept_rate"],
                         verify_waves=e.stats["verify_calls"],
                         draft_calls=e.stats["draft_calls"],
                         decode_waves=e.stats["decode_steps"])
        for i, r in enumerate(out):
            if r.error is not None or len(r.output) != r.max_new_tokens:
                fail(f"{name} {label} {mode} request {i}: error={r.error} "
                     f"tokens={len(r.output)}/{r.max_new_tokens}")
    sp, pl = res["spec"], res["plain"]
    print(f"[{card}] spec {name} {label} (cf={SPEC_CF}, k={SPEC_K}, "
          f"{sched.spec.n_coarse} coarse layers): {len(greedy)} greedy "
          f"requests, {sp['tokens']} tokens; decode {pl['decode_tok_s']:.1f}"
          f" tok/s plain vs {sp['decode_tok_s']:.1f} tok/s spec "
          f"({sp['decode_tok_s'] / pl['decode_tok_s']:.2f}x); accept rate "
          f"{sp['accept_rate']:.3f}; {sp['verify_waves']} verify waves and "
          f"{sp['draft_calls']} draft calls (plain: {pl['decode_waves']} "
          f"decode waves); TTFT p50 {pl['ttft_p50_s']:.3f} s plain, "
          f"{sp['ttft_p50_s']:.3f} s spec; wall {pl['wall_s']:.2f} / "
          f"{sp['wall_s']:.2f} s")
    res["matched"], res["max_gap"], res["divergences"] = check_greedy_spec(
        served, rcfg, greedy, outs, rows, label, card, allow=allow)
    if allow is None:
        res["draft_ingest"], res["draft_gap"] = check_draft_tokens(
            engines["spec"], greedy, outs, waves, spec_calls, card, label,
            catch_up=label == "accepting")
    return engines, res, launches["spec"]


def serve_spec(arch, family, seed, card):
    """Speculative decoding at full width and depth. In the trained
    regime: ``spec_greedy`` (plain vs spec greedy streams, verify's logits
    against decode's, the draft against a serial forward of its params),
    every kernel of the path launched, one sampled request finishing with
    its budget, one spec wave profiled. Then the same weights damped to
    SPEC_ACCEPT_DAMP, where drafts are accepted: ``spec_greedy`` again,
    the accept rate above 0 and a draft wave with a catch-up ingest held
    against the serial forward. Returns (spec-engine launch counts, the
    profiled wave's per-call launches, numbers)."""
    import numpy as np
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.models import transformer
    rcfg = get_config(arch, "decode_32k")
    cfg = rcfg.model
    V = cfg.vocab_size
    torch.cuda.reset_peak_memory_stats()
    params = trained_regime(transformer.init_model(rcfg, seed=seed,
                                                   device="cuda"),
                            TRAINED_REGIME_DAMP[family])
    served = transformer.serving_params(params, cfg)
    del params
    gc.collect()
    queue = make_queue(np.random.default_rng(seed), V)
    greedy = [r for r in queue if r.temperature == 0.0][:SPEC_REQS]
    sampled = next(r for r in queue if r.temperature > 0.0)
    engines, res, launches = spec_greedy(
        rcfg, served, greedy, card, f"damp {TRAINED_REGIME_DAMP[family]:g}")
    res = {"trained": res}
    need = {"attn": ("paged_flash_attention", "rmsnorm_fwd"),
            "ssm": ("paged_ssm_update", "rmsnorm_fwd"),
            "hybrid": ("paged_flash_attention", "paged_ssm_update",
                       "rmsnorm_fwd")}[family]
    if any(launches[k] <= 0 for k in need):
        fail(f"{cfg.name}: a kernel of the spec path never launched: "
             f"{launches}")
    (out,) = engines["spec"].generate([dataclasses.replace(sampled)])
    if out.error is not None or len(out.output) != out.max_new_tokens or \
            not ((out.output >= 0) & (out.output < V)).all():
        fail(f"{cfg.name}: the sampled spec request did not finish with its "
             f"budget ({out.error}, {len(out.output)}/{out.max_new_tokens})")
    print(f"[{card}] spec {cfg.name}: sampled request (temperature "
          f"{sampled.temperature}, top-k {sampled.top_k}, top-p "
          f"{sampled.top_p}) emitted {len(out.output)}/"
          f"{out.max_new_tokens} tokens")
    wave = profile_spec_wave(
        engines["spec"], [dataclasses.replace(r, max_new_tokens=32)
                          for r in greedy], card)
    # each call launches a kernel once a layer and model call: verify one
    # fine forward, the draft wave k coarse ones (ingest + k-1 steps)
    draft = engines["spec"].scheduler.spec
    dcfg = draft.rcfg.model
    if family == "hybrid":
        want = {"verify": {"paged_ssm_update": cfg.n_layers,
                           "paged_flash_attention":
                               cfg.n_layers // cfg.hybrid_attn_every},
                "draft": {"paged_ssm_update": SPEC_K * dcfg.n_layers,
                          "paged_flash_attention": SPEC_K * (
                              dcfg.n_layers // dcfg.hybrid_attn_every)}}
    else:
        kernel = "paged_flash_attention" if family == "attn" \
            else "paged_ssm_update"
        want = {"verify": {kernel: transformer.stacked_layer_depth(rcfg)},
                "draft": {kernel: SPEC_K * draft.n_coarse}}
    for call, counts in want.items():
        for k, n in counts.items():
            if wave[call][k] != n:
                fail(f"{cfg.name} spec {call} call: {k} launched "
                     f"{wave[call][k]} times, want {n}")
        if wave[call]["rmsnorm_fwd"] <= 0:
            fail(f"{cfg.name} spec {call} call: RMSNorm never launched")
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[{card}] spec {cfg.name}: peak memory {peak:.1f} GiB (both "
          "engines)")
    res["peak_gib"] = peak
    del engines, draft
    gc.collect()
    accepting = trained_regime(served,
                               SPEC_ACCEPT_DAMP / TRAINED_REGIME_DAMP[family])
    del served
    gc.collect()
    _, res["accepting"], _ = spec_greedy(
        rcfg, accepting, greedy, card, "accepting")
    if not res["accepting"]["spec"]["accept_rate"] > 0.0:
        fail(f"{cfg.name}: no draft was accepted at damping "
             f"{SPEC_ACCEPT_DAMP:g}")
    return launches, wave, res


# -- dense-cache decode (phase 5c) ---------------------------------------
#
# The dense cache's routes through the hand-written kernels, each against
# its plain version: paged attention over the cache seen as B pages of
# max_len rows (one a slot), at qwen3_1p7b's and zamba2_1p2b's heads, B 1
# and 4, max_len 512 and 4096, a decode step at the first row, at row 63
# and at the last row and a 300-token chunked prefill from row 0 and 37;
# the paged SSM update's decode kernel in place on a dense state at
# falcon_mamba_7b's and zamba2_1p2b's rows; flash attention non-causal at
# Sq = 1 and 17 new rows against mt_marian's 274 source keys and
# seamless_m4t_v2's 256 stub frames (name, B, heads, Sk; hd 64).
DENSE_HEADS = ((H, HKV, HD), (32, 32, 64))
DENSE_LENS = (512, 4096)
DENSE_CROSS = (("mt_marian", 32, 8, 274), ("seamless_m4t_v2", 4, 16, 256))
DENSE_CROSS_SQ = (1, 17)
# dense vs paged at full width and depth: the smoke queue's first
# DENSE_REQS greedy requests and its first sampled one through the
# port's dense oracle (B = 1, MAX_LEN) and through the paged engine; the
# SSM and hybrid prompts cut to DENSE_SSM_PROMPT tokens (their dense
# cache takes a token a call). The two paths run the bf16 projections at
# other row counts (M = 1 against M = the engine's slots or a prefill
# bucket), so cuBLAS may round differently: at every emission index whose
# context the two share, max|dense - paged| over the vocab must stay
# within DENSE_GAP, and a first divergence is allowed only where the
# dense token lies within DENSE_TIE = 2 DENSE_GAP of the paged row's top
# logit (for the sampled request: within DENSE_TIE / temperature of the
# paged token's Gumbel-perturbed score, or either token sits on the edge
# of the top-k / top-p mask, kept by one row's mask and dropped by the
# other's). DENSE_GAP is the largest gap read on an H100 between the two
# paths, 0.3242 (falcon_mamba_7b), rounded up to 12 bf16 ulps at |logit|
# in [4, 8), as SPEC_GAP is; the greedy divergences there took tokens
# 0-0.0312 below the paged top logit.
DENSE_REQS = 2
DENSE_SSM_PROMPT = 48
DENSE_GAP = 0.375
DENSE_TIE = 2 * DENSE_GAP
# encoder-decoder decoding at full width and depth, seeded random
# weights: (arch, B, source length), ENCDEC_NEW greedy tokens through
# make_serve_fn with the encoder's output, each step's logits against a
# teacher-forced serial forward over the decoded tokens within
# ENCDEC_GAP, a greedy token other than the serial argmax only within
# ENCDEC_TIE = 2 ENCDEC_GAP of its top logit. ENCDEC_GAP is the largest
# gap read on an H100, 0.0508 (seamless_m4t_v2; mt_marian 0.0234),
# rounded up to 4 bf16 ulps at |logit| in [4, 8); the greedy tokens off
# the serial argmax there lay 0-0.0078 below it (exact bf16 ties among
# 32000 random-weight logits are common).
ENCDEC_DECODE = (("mt_marian", 32, 274), ("seamless_m4t_v2", 4, 256))
ENCDEC_NEW = 32
ENCDEC_GAP = 0.125
ENCDEC_TIE = 2 * ENCDEC_GAP
SAMPLED_SEAMLESS = dict(temperature=0.8, top_k=40, top_p=0.95, seed=5)


def dense_cases(max_len):
    """(S, index): a decode step at the first row, at row 63 and at the
    last row; a 300-token chunked prefill from row 0 and from row 37."""
    return ((1, 0), (1, 63), (1, max_len - 1), (300, 0), (300, 37))


def check_dense_attention(gen):
    """The dense cache's attention route (``attention._cached_core``: the
    S new K/V rows written in place into the middle layer of a 3-layer
    cache, then paged attention over that layer seen as B pages of
    max_len rows) against ``dot_attention(q_offset=index)`` over the
    written layer, within ATTN_TOL. Rows past index + S hold 1e30 (never
    read); the other layers and the layer's rows outside the write must
    keep their bits, the written rows hold the new K/V bit for bit, and a
    second launch gives the same bits. Returns the max abs error per
    dtype."""
    import torch
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.models import attention as tattn
    err = {}
    for h, hkv, hd in DENSE_HEADS:
        for max_len in DENSE_LENS:
            for B in (1, MAX_BATCH):
                for dtype in (torch.bfloat16, torch.float32):
                    dname = str(dtype).split(".")[1]
                    line = []
                    for S, index in dense_cases(max_len):
                        def r(*shape):
                            return (torch.randn(shape, generator=gen,
                                                device="cuda") * 0.5
                                    ).to(dtype)
                        ck = r(3, B, max_len, hkv, hd)
                        cv = r(3, B, max_len, hkv, hd)
                        ck[:, :, index + S:] = 1e30
                        cv[:, :, index + S:] = 1e30
                        q, kn, vn = r(B, S, h, hd), r(B, S, hkv, hd), \
                            r(B, S, hkv, hd)
                        exp_k, exp_v = ck.clone(), cv.clone()
                        exp_k[1, :, index:index + S] = kn
                        exp_v[1, :, index:index + S] = vn
                        idx = torch.tensor(index, dtype=torch.int32,
                                           device="cuda")
                        got = tattn._cached_core(
                            q, kn, vn, {"k": ck[1], "v": cv[1],
                                        "index": idx})
                        table = torch.arange(B, dtype=torch.int32,
                                             device="cuda")[:, None]
                        again = kops.paged_attention(q, ck[1], cv[1], table,
                                                     idx.expand(B))
                        want = tattn.dot_attention(q, ck[1], cv[1],
                                                   causal=True,
                                                   q_offset=idx)
                        torch.cuda.synchronize()
                        shape = (f"H={h}/{hkv} hd={hd} max_len={max_len} "
                                 f"B={B} S={S} index={index} {dname}")
                        if not (torch.equal(ck, exp_k)
                                and torch.equal(cv, exp_v)):
                            fail(f"dense cache {shape}: the write touched "
                                 "rows outside its layer and range, or "
                                 "did not land")
                        if not torch.equal(got, again):
                            fail(f"dense cache attention {shape}: a second "
                                 "launch changed the output")
                        e = (got.float() - want.float()).abs().max().item()
                        if not e <= ATTN_TOL[dname]:
                            fail(f"dense cache attention {shape}: "
                                 f"max|kernel-plain| {e:.3e}")
                        path = "split" if pa.plan(dtype, B, S, h, hkv, hd,
                                                  max_len, 1).split \
                            else "rows"
                        line.append(f"S={S}@{index} ({path}) {e:.2e}")
                        err[dname] = max(err.get(dname, 0.0), e)
                    print(f"paged_flash_attention over a dense cache H={h}/"
                          f"{hkv} hd={hd} max_len={max_len} B={B} {dname}:"
                          f" max|kernel-plain| {', '.join(line)} "
                          f"(tolerance {ATTN_TOL[dname]:g}); other layers "
                          "and rows kept, written rows exact, second launch "
                          "bitwise")
    return err


def check_dense_ssm(gen):
    """The dense state's route (``ssm._cached_scan``: one paged SSM
    update over the middle layer of a 3-layer state seen as B pages,
    slot b reading and rewriting page b in place; the decode kernel at
    S = 1) at both full-width row shapes, B 1 and 4: y and the layer's
    state within SSM_TOL of max|plain| (the plain version on a copy), the
    other layers bit-identical, a second run from the same state
    bit-identical. Returns the max abs error of y per order."""
    import torch
    from repro_torch.kernels import paged_ssm as ps
    from repro_torch.models import ssm as tssm
    err = {}
    for order in ("dbx", "dxb"):
        R, ds = SSM_ROWS[order]
        for B in (1, MAX_BATCH):
            dt, x, Bm, Cm, A, h = dense_ssm_case(gen, order, B)
            h = torch.stack([h, h * 0.5, h * 2.0])
            runs = [h.clone() for _ in range(3)]
            got, again = (tssm._cached_scan(dt, x, Bm, Cm, A, s[1],
                                            order=order) for s in runs[:2])
            slots = torch.arange(B, device="cuda")
            want = ps.paged_ssm_update_ref(
                dt, x, Bm, Cm, A, runs[2][1], slots, torch.ones_like(slots),
                slots[:, None], torch.zeros_like(slots)[:, None],
                torch.ones_like(slots), order=order)
            torch.cuda.synchronize()
            e_y = _scaled_err(got, want)
            e_h = _scaled_err(runs[0][1], runs[2][1])
            kept = (torch.equal(runs[0][0], h[0])
                    and torch.equal(runs[0][2], h[2]))
            same = torch.equal(got, again) and torch.equal(runs[0], runs[1])
            abs_y = (got - want).abs().max().item()
            print(f"paged_ssm_update {order} in place on a dense state R={R}"
                  f" ds={ds} B={B} S=1: y max|kernel-plain| {abs_y:.3e} = "
                  f"{e_y:.3e} of max|plain|, state {e_h:.3e} (tolerance "
                  f"{SSM_TOL:g}); other layers kept {kept}, second run "
                  f"bit-identical {same}")
            if not (e_y <= SSM_TOL and e_h <= SSM_TOL and kept and same):
                fail(f"paged_ssm_update {order} on a dense state disagrees "
                     "with its plain version")
            err[order] = max(err.get(order, 0.0), abs_y)
    return err


def dense_ssm_case(gen, order, B):
    """One decode step's rows-layout inputs at ``order``'s full-width rows
    and a dense state (B, R, ds), as ``ssm_kernel_case`` draws them; the
    state has the page of storage before it that ``init_mamba*_cache``
    gives every layer."""
    import torch
    from repro_torch.models import ssm as tssm
    R, ds = SSM_ROWS[order]

    def r(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    dt = torch.nn.functional.softplus(r(B, 1, R)) * 0.2
    if order == "dbx":
        A = -torch.exp(r(R, ds))
    else:
        A = (-torch.exp(r(R // 64))).repeat_interleave(64)[:, None] \
            .expand(R, ds)
    h = tssm._dense_state((1, B, R, ds), "cuda")[0].copy_(r(B, R, ds))
    return dt, r(B, 1, R), r(B, 1, ds), r(B, 1, ds), A, h


def check_cross_flash(gen):
    """Cross-attention at decode: the flash kernel non-causal at Sq = 1
    and 17 new rows against mt_marian's and seamless_m4t_v2's source
    lengths at their heads (DENSE_CROSS), bf16 and float32, against the
    plain version (``flash_out_check``); a second launch bit-identical.
    Returns the max abs error per dtype."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops as kops
    err = {}
    for name, B, h, Sk in DENSE_CROSS:
        for Sq in DENSE_CROSS_SQ:
            for dtype in (torch.bfloat16, torch.float32):
                dname = str(dtype).split(".")[1]

                def r(*shape):
                    return (torch.randn(shape, generator=gen, device="cuda")
                            * 0.5).to(dtype)
                q, k, v = r(B, Sq, h, 64), r(B, Sk, h, 64), r(B, Sk, h, 64)
                with torch.no_grad():
                    got = kops.flash_attention(q, k, v, causal=False)
                    again = kops.flash_attention(q, k, v, causal=False)
                want = fa.flash_attention_ref(
                    q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                    causal=False).transpose(1, 2)
                torch.cuda.synchronize()
                e, ok = flash_out_check(got, want, dname)
                same = torch.equal(got, again)
                print(f"flash_attention cross-attention at decode ({name}) "
                      f"B={B} H={h} Sq={Sq} Sk={Sk} hd=64 {dname}: "
                      f"max|kernel-plain| {e:.3e} ({flash_tol_text(dname)});"
                      f" second launch bitwise {same}")
                if not (ok and same):
                    fail(f"flash cross-attention {name} Sq={Sq} {dname} "
                         "disagrees with its plain version")
                err[dname] = max(err.get(dname, 0.0), e)
    return err


def time_dense_kernels(gen, flush):
    """Times of the three routes at the dense path's bf16 shapes: paged
    attention over a dense cache (qwen3_1p7b's heads, B=4, max_len 512) at
    a decode step (S=1, index 300) and a 300-token prefill from row 0,
    beside SDPA on ``cache[:, :index+S]`` (K/V repeated over the g heads
    beforehand; causal for the prefill); the paged SSM update on a dense
    state (B=4, S=1) at both orders, the call as the mixer makes it (the
    plan built there) and the kernel alone (plan already int32), no
    library call computing it; flash cross-attention at mt_marian's decode
    shape (B=32, H=8, Sq=1, Sk=274, hd 64) beside SDPA. Each with its
    plain version and bound. Returns {route: numbers}."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import paged_ssm as ps
    from repro_torch.models import attention as tattn
    from repro_torch.models import ssm as tssm
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = {}
    B, g = MAX_BATCH, H // HKV
    for label, S, index in (("decode", 1, 300), ("prefill", 300, 0)):
        def r(*shape):
            return (torch.randn(shape, generator=gen, device="cuda") * 0.5
                    ).to(torch.bfloat16)
        ck, cv, q = r(B, MAX_LEN, HKV, HD), r(B, MAX_LEN, HKV, HD), \
            r(B, S, H, HD)
        idx = torch.tensor(index, dtype=torch.int32, device="cuda")
        table = torch.arange(B, dtype=torch.int32, device="cuda")[:, None]
        lens = idx.expand(B)
        kd = ck[:, :index + S].transpose(1, 2).repeat_interleave(g, dim=1)
        vd = cv[:, :index + S].transpose(1, 2).repeat_interleave(g, dim=1)
        qd = q.transpose(1, 2)

        def kernel(q=q, ck=ck, cv=cv, table=table, lens=lens):
            return kops.paged_attention(q, ck, cv, table, lens)

        def library(qd=qd, kd=kd, vd=vd, S=S):
            return sdpa(qd, kd, vd, is_causal=S > 1)
        bound, by = attn_bound_ms(B, S, [index] * B, 1, 2)
        rows[f"attn_{label}"] = {
            "ms": time_ms(kernel, flush=flush),
            "device_ms": device_ms(kernel, 20, flush),
            "plain_ms": time_ms(lambda q=q, ck=ck, cv=cv, idx=idx:
                                tattn.dot_attention(q, ck, cv, causal=True,
                                                    q_offset=idx),
                                flush=flush),
            "library_ms": time_ms(library, flush=flush),
            "library_device_ms": device_ms(library, 20, flush),
            "bound_ms": bound, "bound_by": by}
        a = rows[f"attn_{label}"]
        print(f"paged_flash_attention over a dense cache, {label} B={B} "
              f"S={S} index={index} max_len={MAX_LEN} bf16: kernel "
              f"{a['ms']:.4f} ms (device {a['device_ms']:.4f}), plain "
              f"{a['plain_ms']:.4f} ms, SDPA on cache[:, :index+S] "
              f"{a['library_ms']:.4f} ms (device "
              f"{a['library_device_ms']:.4f}), bound {bound:.5f} ms ({by})")
    for order in ("dbx", "dxb"):
        R, ds = SSM_ROWS[order]
        dt, x, Bm, Cm, A, h = dense_ssm_case(gen, order, B)
        # the route's pool: one page before h, the slots its pages 1..B
        pool = h.as_strided((B + 1, R, ds), (R * ds, ds, 1),
                            h.storage_offset() - R * ds)
        slots = torch.arange(1, B + 1, dtype=torch.int32, device="cuda")
        one = torch.ones_like(slots)
        plan = (slots, one, slots[:, None], 0 * slots[:, None], one)

        def call(a=(dt, x, Bm, Cm, A, h), o=order):
            return tssm._cached_scan(*a, order=o)

        def alone(a=(dt, x, Bm, Cm, A, pool), o=order, plan=plan):
            return ps.paged_ssm_update(*a, *plan, order=o)
        a_bytes = R * ds * 4 if order == "dbx" else R * 4
        nbytes = (3 * B * R * 4 + 2 * B * ds * 4 + a_bytes
                  + 2 * B * R * ds * 4 + 5 * B * 4)
        t_b, t_o = nbytes / PEAK_BYTES_S, 7 * B * R * ds / PEAK_F32_FLOP_S
        row = {"ms": time_ms(call, flush=flush),
               "device_ms": device_ms(call, 20, flush),
               "kernel_device_ms": device_ms(alone, 20, flush),
               "plain_ms": time_ms(lambda a=(dt, x, Bm, Cm, A,
                                             pool.clone()), o=order,
                                   plan=plan: ps.paged_ssm_update_ref(
                                       *a, *plan, order=o), flush=flush),
               "bound_ms": 1e3 * max(t_b, t_o),
               "bound_by": "bytes" if t_b >= t_o else "operations"}
        rows[f"ssm_{order}"] = row
        print(f"paged_ssm_update {order} in place on a dense state R={R} "
              f"ds={ds} B={B} S=1: kernel {row['ms']:.4f} ms (device "
              f"{row['device_ms']:.4f}; kernel alone "
              f"{row['kernel_device_ms']:.4f}), plain {row['plain_ms']:.4f} "
              f"ms, bound {row['bound_ms']:.5f} ms ({row['bound_by']}), "
              "library none")
    _, Bc, hc, Sk = DENSE_CROSS[0]

    def r(*shape):
        return (torch.randn(shape, generator=gen, device="cuda") * 0.5
                ).to(torch.bfloat16)
    q, k, v = r(Bc, 1, hc, 64), r(Bc, Sk, hc, 64), r(Bc, Sk, hc, 64)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

    def kernel():
        with torch.no_grad():
            return kops.flash_attention(q, k, v, causal=False)

    def library():
        return sdpa(qt, kt, vt)
    nbytes = 2 * (2 * Bc * hc * 64 + 2 * Bc * Sk * hc * 64) + Bc * hc * 4
    t_b, t_o = nbytes / PEAK_BYTES_S, 4 * 64 * Sk * Bc * hc / PEAK_BF16_FLOP_S
    row = {"ms": time_ms(kernel, flush=flush),
           "device_ms": device_ms(kernel, 20, flush),
           "plain_ms": time_ms(lambda: fa.flash_attention_ref(
               qt, kt, vt, causal=False), flush=flush),
           "library_ms": time_ms(library, flush=flush),
           "library_device_ms": device_ms(library, 20, flush),
           "bound_ms": 1e3 * max(t_b, t_o),
           "bound_by": "bytes" if t_b >= t_o else "operations"}
    rows["cross"] = row
    print(f"flash_attention cross-attention at decode (mt_marian) B={Bc} "
          f"H={hc} Sq=1 Sk={Sk} hd=64 bf16: kernel {row['ms']:.4f} ms "
          f"(device {row['device_ms']:.4f}), plain {row['plain_ms']:.4f} ms,"
          f" SDPA {row['library_ms']:.4f} ms (device "
          f"{row['library_device_ms']:.4f}), bound {row['bound_ms']:.5f} ms "
          f"({row['bound_by']})")
    return rows


def dense_counts():
    return {**serve_counts(),
            "flash_attention_fwd": train_counts()["flash_attention_fwd"]}


def dense_stream(served, rcfg, req, chunked):
    """The port's dense oracle for one request on the card: a dense cache
    of batch 1 and MAX_LEN rows, the prompt by one chunked-prefill call
    (``chunked``) or a token a call, then one ``sample_tokens(fused=
    True)`` draw per emitted token keyed (seed, n), each fed back.
    Returns (tokens, the logits row of each emission, decode calls)."""
    import numpy as np
    import torch
    from repro_torch.launch.steps import sample_tokens
    from repro_torch.models import transformer

    def vec(x, dtype):
        return torch.tensor([x], dtype=dtype, device="cuda")
    cache = transformer.init_cache(rcfg, 1, MAX_LEN, device="cuda")
    prompt = torch.from_numpy(req.prompt.astype(np.int64)).cuda()[None]
    feeds = [prompt] if chunked else [prompt[:, i:i + 1]
                                      for i in range(prompt.shape[1])]
    samp = (vec(req.temperature, torch.float32), vec(req.top_k, torch.int32),
            vec(req.top_p, torch.float32), vec(req.seed, torch.long))
    out, rows = [], []
    with torch.no_grad():
        for f in feeds:
            lg, cache = transformer.decode_step(served, cache, f, rcfg)
        for n in range(req.max_new_tokens):
            rows.append(lg[0, -1])
            tok = sample_tokens(lg[:, -1], *samp, vec(n, torch.long),
                                any_sampled=req.temperature > 0, fused=True)
            out.append(int(tok[0]))
            if n < req.max_new_tokens - 1:
                lg, cache = transformer.decode_step(
                    served, cache, tok[:, None].long(), rcfg)
    return np.asarray(out, np.int32), rows, len(feeds) + len(out) - 1


def sampled_scores(row, req, n, fused=True):
    """The Gumbel-perturbed, temperature-scaled, masked scores
    ``sample_tokens`` drew emission n of ``req`` from (``row``: that
    emission's logits; ``fused``: the kernel's mask, else the sort-based
    one of the gathered route), and the mask (True: kept)."""
    import torch
    from repro_torch.launch import prng
    from repro_torch.launch.steps import temper_and_mask

    def vec(x, dtype):
        return torch.tensor([x], dtype=dtype, device=row.device)
    scaled = temper_and_mask(row.float()[None],
                             vec(req.temperature, torch.float32),
                             vec(req.top_k, torch.int32),
                             vec(req.top_p, torch.float32), fused=fused)[0]
    keys = prng.fold_in(prng.PRNGKey(vec(req.seed, torch.long)),
                        vec(n, torch.long))
    return scaled + prng.gumbel(keys, row.shape[-1])[0], scaled > -1e30


def check_dense_streams(name, reqs, paged, dense, card, allow=None,
                        paged_fused=True, gap_limit=DENSE_GAP,
                        tie_limit=DENSE_TIE):
    """Dense oracle vs paged engine, one request at a time: at every
    emission index whose context the two share (up to and including a
    first divergence) max|dense - paged| over the vocab within DENSE_GAP;
    a greedy token the argmax of its own row; a first divergence only on
    a near-tie (the dense token within DENSE_TIE of the paged row's top
    logit; sampled: within DENSE_TIE / temperature of the paged token's
    perturbed score, or a token on the edge of the two rows' masks).
    ``paged``/``dense``: (streams, rows by (seed, n) or lists). ``allow``
    (an MoE model, ``moe_allowance``): where the two paths' routes over
    the context differ, MOE_FLIP_GAP in place of DENSE_GAP and any
    divergence. ``paged_fused``: whether ``paged`` sampled through the
    kernel's mask (else the sort-based one); ``gap_limit`` /
    ``tie_limit``: the limits in place of DENSE_GAP / DENSE_TIE. Returns (bitwise-equal
    streams, largest gap over the positions whose routes agree,
    divergences)."""
    import numpy as np
    matched, worst, divergences = 0, 0.0, []
    for i, req in enumerate(reqs):
        a, b = paged[0][i], dense[0][i]
        j = int(np.argmax(a != b)) if not np.array_equal(a, b) else None
        for m in range(len(a) if j is None else j + 1):
            pl, dn = paged[1][(req.seed, m)], dense[1][i][m]
            gap = _row_gap(pl, dn)
            routed = allow(req.seed, m) if allow is not None else None
            limit = gap_limit if routed is None else MOE_FLIP_GAP
            if routed is None:
                worst = max(worst, gap)
            else:
                print(f"[{card}] dense {name} request {i} token {m}: routes "
                      f"differ ({routed[0]}, margin {routed[1]}), gap "
                      f"{gap:.4f} (limit {limit:g})")
            if gap > limit:
                fail(f"{name} request {i} token {m}: the dense oracle's "
                     f"logits lie {gap:.4f} from the paged engine's (limit "
                     f"{limit:g})")
            if req.temperature == 0 and (
                    int(pl.float().argmax()) != a[m]
                    or int(dn.float().argmax()) != b[m]):
                fail(f"{name} request {i} token {m}: a greedy token is not "
                     "the argmax of the logits it was drawn from")
        if j is None:
            matched += 1
            continue
        pl = paged[1][(req.seed, j)].float()
        ta, tb = int(a[j]), int(b[j])
        edge = False
        if req.temperature == 0:
            margin, limit = (pl.max() - pl[tb]).item(), tie_limit
        else:
            s_p, keep_p = sampled_scores(pl, req, j, paged_fused)
            s_d, keep_d = sampled_scores(dense[1][i][j], req, j)
            if int(s_p.argmax()) != ta or int(s_d.argmax()) != tb:
                fail(f"{name} request {i} token {j}: a sampled token is not "
                     "the draw from the scores of its own row")
            margin, limit = (s_p[ta] - s_p[tb]).item(), \
                tie_limit / req.temperature
            edge = bool(keep_p[ta] != keep_d[ta] or keep_p[tb] != keep_d[tb])
        routed = allow(req.seed, j) if allow is not None else None
        divergences.append(dict(request=i, token=j, margin=margin,
                                sampled=req.temperature > 0,
                                mask_edge=edge,
                                routes=None if routed is None
                                else routed[0]))
        print(f"[{card}] dense {name} request {i}: first divergence at "
              f"token {j} ({ta} paged, {tb} dense); the dense token lies "
              f"{margin:.4f} below the paged row's "
              f"{'perturbed score' if req.temperature else 'top logit'} "
              f"(limit {limit:g})"
              + ("; one of the two tokens is kept by one row's top-k / "
                 "top-p mask and dropped by the other's" if edge else ""))
        if not (margin < limit or edge or routed is not None):
            fail(f"{name}: the dense oracle diverged from the paged engine "
                 f"away from a near-tie ({margin:.4f})")
    return matched, worst, divergences


def dense_vs_paged(arch, seed, card):
    """Full width and depth: the smoke queue's first DENSE_REQS greedy
    requests and first sampled one through the paged engine (the logits
    each token was drawn from recorded) and through the port's dense
    oracle (qwen3's prompt by one chunked-prefill call, SSM and hybrid
    prompts cut to DENSE_SSM_PROMPT tokens a call), counters set to 0
    just before the dense runs and read just after; every kernel of the
    dense route launched once a layer and call, the sampling mask once a
    sampled emission; ``check_dense_streams``. For the attention decoder
    also ``throughput_probe(paged=False)`` beside the paged probe at
    B = 4. Returns (launches, numbers)."""
    import numpy as np
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.models import transformer
    from repro_torch.serve.engine import ServeEngine
    rcfg = get_config(arch, "decode_32k")
    cfg = rcfg.model
    torch.cuda.reset_peak_memory_stats()
    params = transformer.init_model(rcfg, seed=seed, device="cuda")
    served = transformer.serving_params(params, cfg)
    del params
    gc.collect()
    engine = ServeEngine(rcfg, served, max_batch=MAX_BATCH, page_size=PAGE,
                         max_len=MAX_LEN, device="cuda")
    queue = make_queue(np.random.default_rng(seed), cfg.vocab_size)
    reqs = [r for r in queue if r.temperature == 0.0][:DENSE_REQS] \
        + [next(r for r in queue if r.temperature > 0.0)]
    chunked = cfg.family == "decoder"
    if not chunked:
        reqs = [dataclasses.replace(r, prompt=r.prompt[:DENSE_SSM_PROMPT])
                for r in reqs]
    seeds = {r.seed for r in reqs}
    if len(seeds) != len(reqs) or 0 in seeds:
        fail(f"{cfg.name}: the requests' seeds do not tell them apart")
    engine.generate([dataclasses.replace(reqs[0], max_new_tokens=4)])
    with record_spec_logits() as calls:
        out = engine.generate([dataclasses.replace(r) for r in reqs])
        torch.cuda.synchronize()
    paged = ([r.output for r in out], emitted_rows(calls, seeds))
    del calls
    reset_serve_counts()
    t0 = time.perf_counter()
    dense = ([], [])
    n_calls = 0
    for r in reqs:
        toks, rows, n = dense_stream(served, rcfg, r, chunked)
        dense[0].append(toks)
        dense[1].append(rows)
        n_calls += n
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dense_counts()
    if chunked:                 # phase 5g's reference
        DENSE_REF[cfg.name] = {"reqs": reqs, "tokens": dense[0],
                               "rows": dense[1], "launches": launches,
                               "calls": n_calls}
    if cfg.family == "hybrid":
        want = {"paged_ssm_update": cfg.n_layers,
                "paged_flash_attention": cfg.n_layers // cfg.hybrid_attn_every}
    else:
        want = {"paged_flash_attention" if chunked else "paged_ssm_update":
                transformer.stacked_layer_depth(rcfg)}
    for k, n in want.items():
        if launches[k] != n * n_calls:
            fail(f"{cfg.name} dense: {k} launched {launches[k]} times, want "
                 f"{n} a call x {n_calls} calls")
    n_sampled = sum(r.max_new_tokens for r in reqs if r.temperature > 0)
    if launches["topk_topp_mask"] != n_sampled or \
            launches["rmsnorm_fwd"] <= 0:
        fail(f"{cfg.name} dense: launches {launches}")
    for i, (r, a, b) in enumerate(zip(reqs, paged[0], dense[0],
                                      strict=True)):
        if len(a) != r.max_new_tokens or len(b) != r.max_new_tokens:
            fail(f"{cfg.name} request {i}: {len(a)} paged / {len(b)} dense "
                 f"tokens of {r.max_new_tokens}")
    matched, worst, div = check_dense_streams(cfg.name, reqs, paged, dense,
                                              card)
    n_tok = sum(len(b) for b in dense[0])
    res = dict(matched=matched, requests=len(reqs), max_gap=worst,
               divergences=div, dense_calls=n_calls, dense_wall_s=wall,
               dense_tok_s=n_tok / wall)
    if chunked:
        res["probe_dense_tok_s"] = engine.throughput_probe(MAX_BATCH,
                                                           paged=False)
        res["probe_paged_tok_s"] = engine.throughput_probe(MAX_BATCH)
    res["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    print(f"[{card}] dense {cfg.name}: {matched}/{len(reqs)} streams "
          f"bitwise equal to the paged engine's ({len(reqs) - 1} greedy, 1 "
          f"sampled; prompts {[len(r.prompt) for r in reqs]}), max|dense - "
          f"paged| over every shared-context position {worst:.4f} (limit "
          f"{DENSE_GAP:g}); {n_calls} dense decode calls, {n_tok} tokens in "
          f"{wall:.2f} s; launches {launches}"
          + (f"; throughput_probe B={MAX_BATCH}: dense "
             f"{res['probe_dense_tok_s']:.1f} tok/s, paged "
             f"{res['probe_paged_tok_s']:.1f} tok/s" if chunked else "")
          + f"; peak memory {res['peak_gib']:.1f} GiB")
    return launches, res


@contextlib.contextmanager
def record_decode_logits():
    """Keep every logits tensor ``transformer.decode_step`` returns (the
    serve step reads it by module attribute), without device work."""
    from repro_torch.models import transformer
    saved, kept = transformer.decode_step, []

    def step(*a, **kw):
        lg, cache = saved(*a, **kw)
        kept.append(lg)
        return lg, cache
    transformer.decode_step = step
    try:
        yield kept
    finally:
        transformer.decode_step = saved


def encdec_decode(arch, B, S_src, card):
    """Full-width, full-depth ``arch`` from seeded random weights: the
    encoder over a source batch (token ids, or the audio stub's frames),
    then ENCDEC_NEW greedy tokens through ``make_serve_fn(rcfg)(params,
    cache, tokens, xa)`` on a dense cache, each call timed to a device
    sync; each step's logits against a teacher-forced serial forward over
    the decoded tokens (ENCDEC_GAP, ENCDEC_TIE). seamless_m4t_v2 also
    decodes one sampled request (SAMPLED_SEAMLESS) a token a call through
    ``decode_step`` and ``sample_tokens(fused=True)``, each token inside
    its row's mask. Counters set to 0 just before the decode loops and
    read after: paged attention and flash once a decoder layer and call,
    the sampling mask once a sampled token. Returns (launches, numbers)."""
    import numpy as np
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.steps import make_serve_fn
    from repro_torch.models import transformer
    rcfg = get_config(arch)
    cfg = rcfg.model
    V = cfg.vocab_size
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = transformer.init_model(rcfg, seed=3, device="cuda")
    served = transformer.serving_params(params, cfg)
    del params
    gc.collect()
    rng = np.random.default_rng(3)
    if cfg.frontend == "audio":
        batch = {"src_embeds": torch.from_numpy(
            (rng.standard_normal((B, S_src, cfg.d_model)) * 0.1)
            .astype(np.float32)).cuda()}
    else:
        batch = {"src_tokens": torch.from_numpy(
            rng.integers(0, V, (B, S_src))).cuda()}
    start = torch.from_numpy(rng.integers(0, V, (B, 1))).cuda()
    n_dec = transformer.depth_plan(cfg.n_dec_layers, rcfg.mgrit).n_mid_padded
    reset_serve_counts()
    with torch.no_grad():
        xa, _ = transformer.encode(served, batch, rcfg)
        torch.cuda.synchronize()
        enc_flash = dense_counts()["flash_attention_fwd"]
        print(f"model: {cfg.name} {cfg.n_layers} + {cfg.n_dec_layers} layers "
              f"({n_dec} decoder layers stacked) d_model={cfg.d_model} heads="
              f"{cfg.n_heads} vocab={V} dtype={cfg.dtype}; init + encoder "
              f"(B={B}, {S_src} source positions, {enc_flash} flash "
              f"launches) {time.perf_counter() - t0:.1f} s")
        step = make_serve_fn(rcfg)
        cache = transformer.init_cache(rcfg, B, ENCDEC_NEW, device="cuda")
        tok, toks, walls = start, [], []
        reset_serve_counts()
        with record_decode_logits() as logits:
            for _ in range(ENCDEC_NEW):
                t1 = time.perf_counter()
                tok, cache = step(served, cache, tok, xa)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t1)
                toks.append(tok)
        launches = dense_counts()
        seq = torch.cat([start] + toks[:-1], dim=1)
        serial, _ = transformer.forward(served, {**batch, "tokens": seq},
                                        rcfg, mode="serial")
        out = torch.cat(toks, dim=1)
        gap, ties = 0.0, []
        for n in range(ENCDEC_NEW):
            ser = serial[:, n].float()
            gap = max(gap, _row_gap(logits[n][:, -1], ser))
            differ = (out[:, n] != ser.argmax(-1)).nonzero()[:, 0].tolist()
            for b in differ:
                ties.append((ser[b].max() - ser[b, out[b, n]]).item())
        for k, n in (("paged_flash_attention", n_dec),
                     ("flash_attention_fwd", n_dec)):
            if launches[k] != n * ENCDEC_NEW:
                fail(f"{cfg.name} decode: {k} launched {launches[k]} times, "
                     f"want {n} a call x {ENCDEC_NEW} calls")
        res = dict(B=B, src=S_src, tokens=B * ENCDEC_NEW,
                   decode_s=sum(walls), tok_s=B * ENCDEC_NEW / sum(walls),
                   call_ms=[round(1e3 * w, 3) for w in walls], max_gap=gap,
                   ties=ties)
        print(f"[{card}] encdec {cfg.name}: {ENCDEC_NEW} greedy tokens x "
              f"B={B} through make_serve_fn(xa) in {sum(walls):.3f} s "
              f"({res['tok_s']:.1f} tok/s); decode call wall ms "
              f"{res['call_ms']}; max|decode - teacher-forced serial| "
              f"{gap:.4f} (limit {ENCDEC_GAP:g}); {len(ties)} greedy tokens "
              f"off the serial argmax, margins {[round(x, 4) for x in ties]} "
              f"(limit {ENCDEC_TIE:g}); launches {launches}")
        if gap > ENCDEC_GAP or any(x >= ENCDEC_TIE for x in ties):
            fail(f"{cfg.name}: dense decode disagrees with the teacher-forced "
                 "serial forward")
        # the sync census of one more make_serve_fn call, the first
        # call's shapes on a fresh cache
        fresh = transformer.init_cache(rcfg, B, ENCDEC_NEW, device="cuda")
        with sync_census(f"{cfg.name} dense make_serve_fn call"):
            step(served, fresh, start, xa)
        del fresh
        if cfg.frontend == "audio":
            res["sampled"] = encdec_sampled(served, rcfg, batch, xa, start,
                                            card)
            launches["topk_topp_mask"] = res["sampled"]["launches"]
    torch.cuda.synchronize()
    res["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    print(f"[{card}] encdec {cfg.name}: peak memory {res['peak_gib']:.1f} GiB")
    del served, cache, xa, serial
    return launches, res


def encdec_sampled(served, rcfg, batch, xa, start, card):
    """One sampled request (source row 0, SAMPLED_SEAMLESS) decoded a
    token a call: ``decode_step`` and ``sample_tokens(fused=True)``, the
    sampling kernel at the model's whole vocabulary; every token inside
    its row's mask and in the vocab, the logits against a teacher-forced
    serial forward within ENCDEC_GAP. Returns its numbers."""
    import torch
    from repro_torch.launch.steps import sample_tokens, temper_and_mask
    from repro_torch.models import transformer
    cfg = rcfg.model
    sp = SAMPLED_SEAMLESS

    def vec(x, dtype):
        return torch.tensor([x], dtype=dtype, device="cuda")
    samp = (vec(sp["temperature"], torch.float32),
            vec(sp["top_k"], torch.int32), vec(sp["top_p"], torch.float32),
            vec(sp["seed"], torch.long))
    cache = transformer.init_cache(rcfg, 1, ENCDEC_NEW, device="cuda")
    tok, toks, rows = start[:1], [], []
    reset_serve_counts()
    t0 = time.perf_counter()
    for n in range(ENCDEC_NEW):
        lg, cache = transformer.decode_step(served, cache, tok, rcfg,
                                            xa=xa[:1])
        rows.append(lg[0, -1])
        nxt = sample_tokens(lg[:, -1], *samp, vec(n, torch.long),
                            any_sampled=True, fused=True)
        tok = nxt[:, None].long()
        toks.append(int(nxt[0]))
    wall = time.perf_counter() - t0
    n_mask = dense_counts()["topk_topp_mask"]
    src = {k: v[:1] for k, v in batch.items()}
    seq = torch.cat([start[:1], torch.tensor([toks[:-1]], device="cuda")],
                    dim=1)
    serial, _ = transformer.forward(served, {**src, "tokens": seq}, rcfg,
                                    mode="serial")
    gap = max(_row_gap(rows[n], serial[0, n]) for n in range(ENCDEC_NEW))
    inside = all(
        bool(temper_and_mask(rows[n].float()[None], *samp[:3], fused=True)
             [0, toks[n]] > -1e30) for n in range(ENCDEC_NEW))
    print(f"[{card}] encdec {cfg.name}: sampled request (temperature "
          f"{sp['temperature']}, top-k {sp['top_k']}, top-p {sp['top_p']}) "
          f"{ENCDEC_NEW} tokens in {wall:.3f} s, every token inside its "
          f"row's mask {inside}, max|decode - serial| {gap:.4f} (limit "
          f"{ENCDEC_GAP:g}); sampling mask launches {n_mask}")
    if not inside or gap > ENCDEC_GAP or n_mask != ENCDEC_NEW or \
            not all(0 <= x < cfg.vocab_size for x in toks):
        fail(f"{cfg.name}: the sampled decode failed its checks")
    return dict(tokens=toks, wall_s=wall, max_gap=gap, launches=n_mask)


def dense_kernel_rows(dl, err, rows):
    """The ``kernels`` line's rows of the dense cache's routes (phase 5c):
    launches of the dense oracle's and the encoder-decoder decode runs,
    by model (``dl``); ms/plain_ms/bound_ms at a decode step (S=1),
    prefill_* a 300-token chunked prefill, device_* the device work
    alone (device_ms); max_abs_err bf16, f32_max_abs_err float32."""
    out = [{
        "name": "paged_flash_attention@dense", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
        "replaces": "src/repro/kernels/paged_attention.py:88",
        "launches": sum(n["paged_flash_attention"] for n in dl.values()),
        "launches_by_model": {a: n["paged_flash_attention"]
                              for a, n in dl.items()},
        "max_abs_err": err["attn"]["bfloat16"],
        "f32_max_abs_err": err["attn"]["float32"],
        **rows["attn_decode"],
        **{f"prefill_{k}": v for k, v in rows["attn_prefill"].items()}}]
    for order, arch in (("dbx", "falcon_mamba_7b"), ("dxb", "zamba2_1p2b")):
        out.append({
            "name": f"paged_ssm_update_{order}@dense", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/paged_ssm.cu",
            "replaces": "src/repro/kernels/paged_ssm.py:92",
            "launches": dl[arch]["paged_ssm_update"],
            "max_abs_err": err["ssm"][order], "library_ms": None,
            **rows[f"ssm_{order}"]})
    out.append({
        "name": "flash_attention_fwd@cross_decode", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:64",
        "launches": sum(dl[a]["flash_attention_fwd"]
                        for a, _, _ in ENCDEC_DECODE),
        "launches_by_model": {a: dl[a]["flash_attention_fwd"]
                              for a, _, _ in ENCDEC_DECODE},
        "max_abs_err": err["cross"]["bfloat16"],
        "f32_max_abs_err": err["cross"]["float32"],
        **rows["cross"]})
    return out


# -- the MoE family (phase 5d) ---------------------------------------------
#
# The MoE module at both full widths against its literal one-hot twin
# (``moe.moe_apply_onehot``, the reference's dense (B, S, E, C) dispatch):
# (name, arch); B x S = 2 x 512 and 4 x 1, the router's first two
# columns raised by MOE_ROUTER_BIAS in every weight, so that tokens whose
# input sums high crowd experts 0 and 1 past their capacity and are
# dropped. float32: the plan's slots are the one-hot dispatch's set bits,
# bit for bit. Both dtypes: the output and the cotangents of x, the router
# and the three expert leaves within MOE_TOL x max|one-hot| (the index
# design sums a token's K slots in float32 in k order, the one-hot
# einsum over E x C in cuBLAS's order; bf16 also rounds products where
# the one-hot GEMM accumulates in float32); a second call and a second
# backward bit for bit.
MOE_ARCHS = ("qwen3_moe_235b", "grok1_314b")
MOE_SHAPES = ((2, 512), (4, 1))
MOE_ROUTER_BIAS = 0.05
MOE_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
# the new shapes the MoE models give the kernels: paged attention at
# qwen3-moe's GQA group of 16 (64/4 heads of 128: split-KV at decode,
# multi-row at verify S = 5 and prefill) and grok-1's 6 (48/8), flash at
# both groups (B 2, S 512, the gradient check's), RMSNorm at grok-1's
# width 6144 (a prefill bucket, the training rows, a decode wave) and
# the sampling mask at grok-1's vocabulary of 131072
MOE_HEADS = {"qwen3_moe_235b": (64, 4, 128), "grok1_314b": (48, 8, 128)}
MOE_PAGED_CASES = ((1, [300, 17, 129, 0]), (5, [95, 16, 0, 31]),
                   (256, [0, 37, 200, 256]))
MOE_RMS_SHAPES = ((1024, 6144), (4, 6144), (4 * 32, 6144))
MOE_VOCAB = 131072
# served at full width, depth cut to fit one card with bf16 storage:
# qwen3-moe 8 stacked layers (1 open + 6 ParallelNet + 1 close, pad_to 3
# = its cf: no gate-0 layer), grok-1 4 (1 + 2 + 1, pad_to 2)
MOE_SERVE = {"qwen3_moe_235b": (8, 3), "grok1_314b": (4, 2)}
# the dense-vs-paged and spec-vs-plain comparisons call the MoE at the
# same S on both paths, since capacity comes from the S of a call: every
# prompt cut to its last MOE_PROMPT tokens (a power of two, so a prefill
# bucket holds it without padding), prefix sharing off
MOE_PROMPT = 32
# routing-flip accounting: at every compared position, the two paths'
# routing plans (each layer's experts in order and kept bits) over every
# token of the context. Where they agree, DENSE_GAP / SPEC_GAP and their
# tie rules hold. Where they do not, the first layer that differs is
# read: an expert chosen by one path and not the other is a flip, whose
# margin is the larger of the two paths' router-logit gaps between the
# swapped experts; a layer that differs only in kept bits is a capacity
# difference (a verify window queues its drafted tokens before the
# verified ones). Such positions may lie up to MOE_FLIP_GAP apart and
# diverge, provided every flip of that layer lies within MOE_FLIP_MARGIN.
# Read on an H100 with both limits lifted: flips at router-logit margins
# of 0.0078-0.0312 (1-2 bf16 ulps; qwen3-moe spec vs plain, grok-1 dense
# vs paged), gaps after them up to 1.1953 (qwen3-moe spec vs plain, a
# flip in the first verified token); MOE_FLIP_MARGIN is twice the
# largest margin, 2 bf16 ulps at |logit| in [4, 8), MOE_FLIP_GAP the
# largest gap rounded up.
MOE_FLIP_MARGIN = 0.0625
MOE_FLIP_GAP = 2.0
# the gradient check at full width and reduced depth: qwen3-moe at 5
# stacked layers (1 + 3 + 1, cf 3, pad_to 3), bf16 storage, B 2, S 512,
# MGRIT; the plain path replays the kernel path's routing (a flip between
# them would move whole tokens between experts), direction and norm as
# tests/test_lp_grads.py
MOE_GRAD_LAYERS = 5
MOE_GRAD_COS, MOE_GRAD_NORM = 0.9999, 1e-2


def moe_cfg(arch, dtype):
    """The full-width model config of ``arch``, compute and storage in
    ``dtype``."""
    from repro_torch.configs.registry import get_config
    return dataclasses.replace(get_config(arch).model, dtype=dtype,
                               param_dtype=dtype)


def moe_module_case(gen, cfg, B, S):
    """Full-width MoE params (router biased), x and a cotangent."""
    import torch
    from repro_torch.models import moe
    from repro_torch.models.layers import torch_dtype
    params = moe.init_moe(gen, cfg, device="cuda")
    params["router"][:, :2] += MOE_ROUTER_BIAS
    dt = torch_dtype(cfg.dtype)
    x = torch.randn((B, S, cfg.d_model), generator=gen, device="cuda") \
        .to(dt)
    ct = torch.randn((B, S, cfg.d_model), generator=gen, device="cuda") \
        .to(dt)
    return params, x, ct


def moe_fwd_bwd(fn, params, x, ct, cfg):
    """(y, {name: cotangent}) of ``fn`` for x and every leaf."""
    import torch
    names = ["x", *params]
    leaves = [t.detach().requires_grad_(True)
              for t in (x, *params.values())]
    y = fn(dict(zip(params, leaves[1:], strict=True)), leaves[0], cfg)
    grads = torch.autograd.grad(y, leaves, ct)
    return y.detach(), dict(zip(names, grads, strict=True))


def check_moe_module(gen):
    """The index design against the one-hot twin at both full widths and
    both shapes, in float32 and bf16 (see MOE_TOL); the plan's slots
    against the one-hot dispatch bits in float32; a second call and
    backward bit for bit. Prints the dropped choices. Returns the largest
    bf16 error of the output and of the cotangents, and the dropped
    count per case."""
    import torch
    from repro_torch.models import moe
    err = {"out": 0.0, "grad": 0.0}
    dropped = {}
    for arch in MOE_ARCHS:
        for dname in ("float32", "bfloat16"):
            cfg = moe_cfg(arch, dname)
            for B, S in MOE_SHAPES:
                params, x, ct = moe_module_case(gen, cfg, B, S)
                plan = moe.routing_plan(params, x, cfg)
                n_drop = plan.n_dropped()
                dropped[f"{arch} {dname} {B}x{S}"] = n_drop
                if dname == "float32":
                    dispatch, _ = moe.onehot_dispatch(params, x, cfg)
                    E, C = cfg.moe.num_experts, plan.capacity
                    bits = torch.zeros(E * B * C + 1, dtype=torch.bool,
                                       device="cuda")
                    bits[plan.slot.reshape(-1)] = True
                    want = dispatch.permute(2, 0, 3, 1).any(-1).reshape(-1)
                    if not torch.equal(bits[:-1], want):
                        fail(f"MoE {arch} {B}x{S}: the routing plan's "
                             "slots are not the one-hot dispatch's bits")
                    del dispatch, want, bits
                del plan
                y1, g1 = moe_fwd_bwd(moe.moe_apply, params, x, ct, cfg)
                y2, g2 = moe_fwd_bwd(moe.moe_apply, params, x, ct, cfg)
                torch.cuda.synchronize()
                same = torch.equal(y1, y2) and all(
                    torch.equal(g1[k], g2[k]) for k in g1)
                del y2, g2
                if not same:
                    fail(f"MoE {arch} {dname} {B}x{S}: a second call or "
                         "backward changed a bit")
                y0, g0 = moe_fwd_bwd(moe.moe_apply_onehot, params, x, ct,
                                     cfg)
                torch.cuda.synchronize()
                e_out = _scaled_err(y1, y0)
                e_grad = {k: _scaled_err(g1[k], g0[k]) for k in g1}
                tol = MOE_TOL[dname]
                print(f"moe {arch} E={cfg.moe.num_experts} K="
                      f"{cfg.moe.top_k} D={cfg.d_model} ff={cfg.moe.d_ff} "
                      f"{dname:8s} B x S = {B} x {S} (C = "
                      f"{moe.capacity(S, cfg)}): {n_drop} of "
                      f"{B * S * cfg.moe.top_k} choices dropped; index vs "
                      f"one-hot max|diff|/max|one-hot|: out {e_out:.3e}, "
                      + ", ".join(f"d{k} {v:.3e}" for k, v in e_grad.items())
                      + f" (tolerance {tol:g}); second call and backward "
                      "bitwise equal")
                if not (e_out <= tol and max(e_grad.values()) <= tol):
                    fail(f"MoE {arch} {dname} {B}x{S}: the index design "
                         "disagrees with the one-hot version")
                if dname == "bfloat16":
                    err["out"] = max(err["out"], e_out)
                    err["grad"] = max(err["grad"], *e_grad.values())
                del params, x, ct, y1, g1, y0, g0
                gc.collect()
                torch.cuda.empty_cache()
    if not any(v > 0 for k, v in dropped.items() if "512" in k):
        fail("MoE: the biased router dropped no choice at B x S = 2 x 512")
    return err, dropped


def profiled_device_ms(fn, n: int = 5):
    """Device time (ms) and device ops of one ``fn()`` call, from the
    profiler's device rows over ``n`` calls (a call with a host sync
    cannot be queued behind ``device_ms``'s sleep)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    kern = [e for e in prof.key_averages()
            if getattr(e, "device_type", None) == DeviceType.CUDA]
    return (sum(dev_us(e) for e in kern) / n / 1e3,
            sum(e.count for e in kern) // n)


def time_moe_layer(gen, flush):
    """One bf16 MoE call at each full width and shape: its time (CUDA
    events, L2 flushed), its device time and device ops (the profiler),
    the device time of each of its four parts (routing plan, dispatch,
    experts, combine) and of the one-hot version. Bound: every expert's
    weights (empty slots are computed too) and the activations over the
    HBM rate, or the expert products over the bf16 peak."""
    import torch
    from repro_torch.models import moe
    rows = {}
    for arch in MOE_ARCHS:
        cfg = moe_cfg(arch, "bfloat16")
        E, D, ff = cfg.moe.num_experts, cfg.d_model, cfg.moe.d_ff
        for B, S in MOE_SHAPES:
            params, x, _ = moe_module_case(gen, cfg, B, S)
            with torch.no_grad():
                plan = moe.routing_plan(params, x, cfg)
                C = plan.capacity
                xe = moe._Dispatch.apply(x, plan.slot, plan.src)
                ye = moe._experts(params, xe.view(E, B * C, D),
                                  torch.bfloat16)
                parts = {
                    "plan": lambda: moe.routing_plan(params, x, cfg),
                    "dispatch": lambda: moe._Dispatch.apply(
                        x, plan.slot, plan.src),
                    "experts": lambda: moe._experts(
                        params, xe.view(E, B * C, D), torch.bfloat16),
                    "combine": lambda: moe._Combine.apply(
                        ye.reshape(-1, D), plan.gate.to(torch.bfloat16),
                        plan.slot, plan.src)}
                part_ms = {k: profiled_device_ms(f)[0]
                           for k, f in parts.items()}
                call = time_ms(lambda: moe.moe_apply(params, x, cfg),
                               flush=flush)
                dev, ops = profiled_device_ms(
                    lambda: moe.moe_apply(params, x, cfg))
                onehot = profiled_device_ms(
                    lambda: moe.moe_apply_onehot(params, x, cfg))[0]
            nbytes = 2 * (3 * E * D * ff + D * E + 2 * B * S * D)
            flops = 2 * 3 * E * B * C * D * ff
            t_b, t_o = nbytes / PEAK_BYTES_S, flops / PEAK_BF16_FLOP_S
            row = rows[(arch, B, S)] = dict(
                ms=call, device_ms=dev, device_ops=ops, parts_ms=part_ms,
                onehot_device_ms=onehot, bound_ms=1e3 * max(t_b, t_o),
                bound_by="bytes" if t_b >= t_o else "operations")
            print(f"moe {arch} bf16 B x S = {B} x {S} (C = {C}): "
                  f"{call:.4f} ms a call, device {dev:.4f} ms in {ops} "
                  f"device ops (plan {part_ms['plan']:.4f}, dispatch "
                  f"{part_ms['dispatch']:.4f}, experts "
                  f"{part_ms['experts']:.4f}, combine "
                  f"{part_ms['combine']:.4f}); one-hot version device "
                  f"{onehot:.4f} ms; bound {row['bound_ms']:.4f} ms "
                  f"({row['bound_by']}: every expert's weights, "
                  f"{nbytes / 1e9:.2f} GB)")
            del params, x, plan, xe, ye, parts
            gc.collect()
            torch.cuda.empty_cache()
    return rows


def check_moe_kernels(gen):
    """The kernels at the shapes the MoE models give them, each against
    its plain version with the phase-2 tolerances: paged attention at
    GQA groups 16 and 6 (decode, verify S = 5, prefill S = 256; split-KV
    where S x g <= 64), flash forward and backward at both groups
    (bitwise second backward), RMSNorm at width 6144, the sampling mask
    at V = 131072. Returns the largest bf16 error of each kernel."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import sampling as sp
    err = {}
    for arch, heads in MOE_HEADS.items():
        h, hkv, hd = heads
        for dtype in (torch.bfloat16, torch.float32):
            dname = str(dtype).split(".")[1]
            for S, lengths in MOE_PAGED_CASES:
                e = check_paged_case(gen, heads, S, lengths, dtype)
                want_split = S * (h // hkv) <= 64
                if pa.plan(dtype, MAX_BATCH, S, h, hkv, hd, PAGE,
                           live_bucket(lengths, S)).split != want_split:
                    fail(f"paged attention {arch} S={S}: the launcher did "
                         "not pick the design its shape asks for")
                if dname == "bfloat16":
                    err["paged_flash_attention"] = max(
                        err.get("paged_flash_attention", 0.0), e)
            B, Sq = TRAIN_B, 512
            q, do = (torch.randn((B, h, Sq, hd), generator=gen,
                                 device="cuda") * 0.5 for _ in range(2))
            k, v = (torch.randn((B, hkv, Sq, hd), generator=gen,
                                device="cuda") * 0.5 for _ in range(2))
            q, k, v, do = (x.to(dtype) for x in (q, k, v, do))
            want = _attn_grads(lambda *a: fa.flash_attention_ref(
                *a, causal=True), q, k, v, do)
            got = _attn_grads(lambda *a: _kernel_bhsd(*a, True), q, k, v,
                              do)
            qm, km, vm, dom = (x.transpose(1, 2).contiguous()
                               for x in (q, k, v, do))
            o, lse = fa.flash_attention_fwd(qm, km, vm, True)
            first = fa.flash_attention_bwd(qm, km, vm, o, lse, dom, True)
            again = fa.flash_attention_bwd(qm, km, vm, o, lse, dom, True)
            torch.cuda.synchronize()
            e_out, out_ok = flash_out_check(got[0], want[0], dname)
            e_grad = max(_scaled_err(g, w) for g, w in zip(got[1:],
                                                           want[1:]))
            print(f"flash_attention {arch} B={B} H={h}/{hkv} (g={h // hkv})"
                  f" S={Sq} hd={hd} causal {dname:8s}: out max|kernel-"
                  f"plain| {e_out:.3e}, dq/dk/dv max|kernel-plain|/max|"
                  f"plain| {e_grad:.3e} ({flash_tol_text(dname)})")
            if not (out_ok and e_grad <= FLASH_TOL[dname]):
                fail(f"flash attention at {arch}'s heads disagrees with its "
                     "plain version")
            if not all(torch.equal(a, b) for a, b in zip(first, again)):
                fail(f"flash attention backward at {arch}'s heads is not "
                     "bit-repeatable")
            if dname == "bfloat16":
                err["flash_attention_fwd"] = max(
                    err.get("flash_attention_fwd", 0.0), e_out)
                err["flash_attention_bwd"] = max(
                    err.get("flash_attention_bwd", 0.0),
                    *((g.float() - w.float()).abs().max().item()
                      for g, w in zip(got[1:], want[1:])))
            del q, k, v, do, want, got, qm, km, vm, dom, o, lse, first, again
    for dtype in (torch.float32, torch.bfloat16):
        for R, D in MOE_RMS_SHAPES:
            e_y, e_dx = check_rmsnorm_shape(gen, R, D, dtype)
            if dtype == torch.bfloat16:
                err["rmsnorm_fwd"] = max(err.get("rmsnorm_fwd", 0.0), e_y)
                err["rmsnorm_bwd"] = max(err.get("rmsnorm_bwd", 0.0), e_dx)
    for B in (1, 4, 64):
        for kind in SAMPLING_KINDS:
            logits, ks, ps = sampling_edge(gen, kind, B, MOE_VOCAB)
            want = sp.topk_topp_mask_ref(logits, ks, ps)
            got = sp.topk_topp_mask(logits, ks, ps)
            again = sp.topk_topp_mask(logits, ks, ps)
            torch.cuda.synchronize()
            keep_w, keep_g = want > -1e30, got > -1e30
            both = keep_w & keep_g
            e = (got[both] - want[both]).abs().max().item()
            tv = flipped_mass(logits, keep_w, keep_g)
            what = f"topk_topp_mask {kind} B={B} V={MOE_VOCAB}"
            if e != 0.0 or not tv <= SAMPLING_TV:
                fail(f"{what}: survivors differ by {e:.3e} or flipped mass "
                     f"{tv:.3e} > {SAMPLING_TV:g}")
            if top_k_set_differs(logits, ks, ps, keep_g):
                fail(f"{what}: the survivors miss the plain tau_k")
            if not torch.equal(got, again):
                fail(f"{what}: a second launch changed the output")
            err["topk_topp_mask"] = 0.0            # survivors bitwise
            err["topk_topp_mask_tv"] = max(err.get("topk_topp_mask_tv", 0.0),
                                           tv)
        print(f"topk_topp_mask V={MOE_VOCAB} B={B:2d}: {len(SAMPLING_KINDS)}"
              f" kinds survivors, tau_k and second launch bitwise; flipped "
              f"mass max {err['topk_topp_mask_tv']:.3e} (tolerance "
              f"{SAMPLING_TV:g})")
    return err


def time_moe_kernels(gen, flush):
    """Device times at the MoE models' new shapes: paged attention decode
    (split-KV) and a 256-token prefill chunk at groups 16 and 6 beside
    SDPA on the gathered view, and the sampling mask at V = 131072 at the
    serve wave's rows."""
    import torch
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import sampling as sp
    rows = {}
    for arch, heads in MOE_HEADS.items():
        h, hkv, hd = heads
        for S, lengths in ((1, DECODE_LENS), (256, [0, 37, 100, 200])):
            q, pk, pv, table, lens = attn_case(
                gen, MAX_BATCH, S, lengths, torch.bfloat16, MAX_LEN // PAGE,
                0.0, heads=heads)
            cut = table[:, :live_bucket(lengths, S)]
            kernel = device_ms(lambda: pa.paged_flash_attention(
                q, pk, pv, cut, lens), 20, flush)
            lib = device_ms(gathered_sdpa(q, pk, pv, cut, lens, S), 20,
                            flush)
            plain = time_ms(lambda: pa.paged_attention_ref(
                q, pk, pv, cut, lens), flush=flush)
            keys = sum(int(x) + S for x in lengths)
            nbytes = 2 * MAX_BATCH * S * h * hd * 2 + 2 * keys * hkv * hd * 2
            rows[(arch, S)] = dict(device_ms=kernel, plain_ms=plain,
                                   library_device_ms=lib,
                                   bound_ms=1e3 * nbytes / PEAK_BYTES_S)
            print(f"paged_flash_attention {arch} H={h}/{hkv} S={S} bf16 "
                  f"contexts {lengths}: device {kernel:.4f} ms, plain "
                  f"{plain:.4f} ms, SDPA on the gathered view {lib:.4f} ms "
                  f"(device), byte bound {rows[(arch, S)]['bound_ms']:.5f} "
                  "ms")
            del q, pk, pv, table, lens, cut
    logits, _, _ = sampling_case(gen, MAX_BATCH, MOE_VOCAB)
    wks = torch.tensor([0, 40, 0, 40], dtype=torch.int32, device="cuda")
    wps = torch.tensor([1.0, 0.95, 1.0, 0.95], device="cuda")
    rows["sampling"] = dict(
        device_ms=device_ms(lambda: sp.topk_topp_mask(logits, wks, wps), 20,
                            flush),
        plain_ms=time_ms(lambda: sp.topk_topp_mask_ref(logits, wks, wps),
                         flush=flush),
        bound_ms=1e3 * (2 * MAX_BATCH * MOE_VOCAB * 4) / PEAK_BYTES_S)
    print(f"topk_topp_mask B=4 V={MOE_VOCAB} (k 0/40, p 1/0.95): device "
          f"{rows['sampling']['device_ms']:.4f} ms, plain "
          f"{rows['sampling']['plain_ms']:.4f} ms, byte bound "
          f"{rows['sampling']['bound_ms']:.5f} ms")
    return rows


# -- routing plans: recording, replay, and the flip accounting --------------


@contextlib.contextmanager
def record_routes(replay=None):
    """Keep every routing plan ``moe.routing_plan`` returns, in call
    order (references only: no device work). With ``replay`` (an earlier
    recording of the same sequence of calls), each call takes the
    recorded plan's experts, positions and kept bits, its gates computed
    from this call's own router logits: two paths then route alike, and
    a difference between them is their kernels' alone."""
    import torch
    from repro_torch.models import moe
    saved, kept = moe.routing_plan, []

    def plan(params, x, cfg):
        if replay is None:
            p = saved(params, x, cfg)
        else:
            rec = replay[len(kept)]
            if tuple(rec.expert.shape[:2]) != tuple(x.shape[:2]):
                fail("routing replay: the calls do not line up")
            logits = x @ params["router"].to(x.dtype)
            gate = torch.softmax(logits.float(), -1).gather(-1, rec.expert)
            gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
            p = dataclasses.replace(rec, gate=gate, logits=logits)
        kept.append(p)
        return p
    moe.routing_plan = plan
    try:
        yield kept
    finally:
        moe.routing_plan = saved


def _host_plans(plans):
    """A call's per-layer plans as host arrays: experts (L, B, S, K), kept
    bits (L, B, S, K), router logits (L, B, S, E) in float32."""
    import numpy as np
    return (np.stack([p.expert.cpu().numpy() for p in plans]),
            np.stack([p.keep.cpu().numpy() for p in plans]),
            np.stack([p.logits.float().cpu().numpy() for p in plans]))


@contextlib.contextmanager
def record_moe_calls():
    """Every fine-model serve call (``CacheBackend.prefill`` / ``step`` /
    ``verify``) with its slots' seeds, lengths and occupancy and the
    routing plans of its layers (the draft's calls run outside these).
    Yields a list of (seeds, lengths, n_new, plans)."""
    import numpy as np
    from repro_torch.serve.cache import CacheBackend
    calls = []
    saved = {k: getattr(CacheBackend, k) for k in ("prefill", "step",
                                                   "verify")}

    def wrap(fn):
        def run(self, state, slots, tokens, *a):
            with record_routes() as plans:
                out = fn(self, state, slots, tokens, *a)
            calls.append((np.array(slots.seeds), np.array(slots.lengths),
                          np.array(slots.n_new), plans))
            return out
        return run
    for k, fn in saved.items():
        setattr(CacheBackend, k, wrap(fn))
    try:
        yield calls
    finally:
        for k, fn in saved.items():
            setattr(CacheBackend, k, fn)


def position_routes(calls, seeds):
    """{seed: {position: (experts (L, K), kept (L, K), logits (L, E))}}
    of the given requests, from recorded serve calls: window row s of an
    occupied slot is position lengths + s, the last call covering a
    position the one whose K/V stayed (a rejected draft is verified
    again)."""
    out = {s: {} for s in seeds}
    for sd, ln, nn, plans in calls:
        if not plans:
            continue
        ex, kp, lg = _host_plans(plans)
        for b, seed in enumerate(sd.tolist()):
            if seed in out:
                for s in range(int(nn[b])):
                    out[seed][int(ln[b]) + s] = (ex[:, b, s], kp[:, b, s],
                                                 lg[:, b, s])
    return out


def dense_routes(plans, n_layers, prompt_len, b=0):
    """The same map for slot ``b`` of one dense-oracle run: the first
    call a chunked prefill of the prompt, then a token a call."""
    out = {}
    for c in range(len(plans) // n_layers):
        ex, kp, lg = _host_plans(plans[c * n_layers:(c + 1) * n_layers])
        first = 0 if c == 0 else prompt_len + c - 1
        for s in range(ex.shape[2]):
            out[first + s] = (ex[:, b, s], kp[:, b, s], lg[:, b, s])
    return out


def flip_account(a, b, upto):
    """Compare two paths' routes over positions 0..``upto``: ("equal",
    None) where every layer's experts and kept bits agree; else the
    first layer that differs: ("flip", the largest margin of its flips)
    or ("capacity", None) where it differs in kept bits alone."""
    import numpy as np
    n_layers = a[0][0].shape[0]
    for layer in range(n_layers):
        flips, keep_only = [], False
        for p in range(upto + 1):
            ea, ka, la = a[p]
            eb, kb, lb = b[p]
            diff = ea[layer] != eb[layer]
            for k in np.nonzero(diff)[0]:
                x, y = int(ea[layer, k]), int(eb[layer, k])
                flips.append(max(abs(la[layer, x] - la[layer, y]),
                                 abs(lb[layer, x] - lb[layer, y])))
            if not diff.any() and (ka[layer] != kb[layer]).any():
                keep_only = True
        if flips:
            return "flip", float(max(flips))
        if keep_only:
            return "capacity", None
    return "equal", None


def moe_allowance(routes_a, routes_b, prompt_len):
    """``allow(i, m, seed)`` for the stream checks: None where the two
    paths' routes agree over the context of emission m (the normal
    limits hold), else (category, margin) after failing any flip beyond
    MOE_FLIP_MARGIN; also a tally of the categories."""
    tally = {"equal": 0, "flip": 0, "capacity": 0, "margins": []}
    seen = {}

    def allow(seed, m):
        if (seed, m) in seen:
            return seen[seed, m]
        cat, margin = flip_account(routes_a[seed], routes_b[seed],
                                   prompt_len + m - 1)
        tally[cat] += 1
        if margin is not None:
            tally["margins"].append(margin)
            if margin > MOE_FLIP_MARGIN:
                fail(f"MoE routing flip at margin {margin:.4f} (limit "
                     f"{MOE_FLIP_MARGIN:g}): a flip away from a near-tie")
        seen[seed, m] = None if cat == "equal" else (cat, margin)
        return seen[seed, m]
    return allow, tally


# -- the MoE phase's serving and training runs ------------------------------


def moe_serve_config(arch):
    """``arch``'s decode config at full width, MOE_SERVE's depth and
    pad_to, bf16 storage."""
    from repro_torch.configs.registry import get_config
    n_layers, pad_to = MOE_SERVE[arch]
    rcfg = get_config(arch, "decode_32k")
    return rcfg.replace(
        model=dataclasses.replace(rcfg.model, n_layers=n_layers,
                                  param_dtype="bfloat16"),
        mgrit=dataclasses.replace(rcfg.mgrit, pad_to=pad_to))


def moe_requests(rng, V, n_greedy, sampled):
    """The smoke queue's first ``n_greedy`` greedy requests (and its first
    sampled one), each prompt cut to its last MOE_PROMPT tokens."""
    queue = make_queue(rng, V)
    reqs = [r for r in queue if r.temperature == 0.0][:n_greedy]
    if sampled:
        reqs.append(next(r for r in queue if r.temperature > 0.0))
    reqs = [dataclasses.replace(r, prompt=r.prompt[-MOE_PROMPT:])
            for r in reqs]
    if len({r.seed for r in reqs}) != len(reqs) or 0 in {r.seed
                                                         for r in reqs}:
        fail("the MoE requests' seeds do not tell them apart")
    return reqs


def moe_dense_vs_paged(rcfg, served, reqs, card):
    """The port's dense oracle (B = 1, the prompt one chunked prefill)
    against the paged engine (prefix sharing off) on ``reqs``, with the
    routing-flip accounting; counters set to 0 just before the dense runs
    and read just after. Returns (launches, numbers)."""
    import numpy as np
    import torch
    from repro_torch.models import transformer
    from repro_torch.serve.engine import ServeEngine
    cfg = rcfg.model
    n_layers = transformer.stacked_layer_depth(rcfg)
    engine = ServeEngine(rcfg, served, max_batch=MAX_BATCH, page_size=PAGE,
                         max_len=MAX_LEN, share_prefix=False, device="cuda")
    engine.generate([dataclasses.replace(reqs[0], max_new_tokens=4)])
    seeds = [r.seed for r in reqs]
    with record_spec_logits() as calls, record_moe_calls() as moe_calls:
        out = engine.generate([dataclasses.replace(r) for r in reqs])
        torch.cuda.synchronize()
    paged = ([r.output for r in out], emitted_rows(calls, set(seeds)))
    paged_routes = position_routes(moe_calls, seeds)
    del calls, moe_calls, engine
    reset_serve_counts()
    dense, dense_routes_by_seed, n_calls = ([], []), {}, 0
    t0 = time.perf_counter()
    for r in reqs:
        with record_routes() as plans:
            toks, rows, n = dense_stream(served, rcfg, r, True)
        dense[0].append(toks)
        dense[1].append(rows)
        dense_routes_by_seed[r.seed] = dense_routes(plans, n_layers,
                                                    len(r.prompt))
        n_calls += n
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dense_counts()
    if launches["paged_flash_attention"] != n_layers * n_calls:
        fail(f"{cfg.name} dense: paged attention launched "
             f"{launches['paged_flash_attention']} times, want {n_layers} a "
             f"call x {n_calls} calls")
    allow, tally = moe_allowance(paged_routes, dense_routes_by_seed,
                                 MOE_PROMPT)
    matched, worst, div = check_dense_streams(cfg.name, reqs, paged, dense,
                                              card, allow=allow)
    res = dict(matched=matched, requests=len(reqs), max_gap=worst,
               divergences=div, routes=tally, dense_calls=n_calls,
               dense_tok_s=sum(len(b) for b in dense[0]) / wall)
    print(f"[{card}] dense {cfg.name}: {matched}/{len(reqs)} streams bitwise "
          f"equal to the paged engine's; max|dense - paged| {worst:.4f}; "
          f"routes over each compared context: {tally['equal']} equal, "
          f"{tally['flip']} with a flip (margins "
          f"{[round(x, 4) for x in tally['margins']]}), {tally['capacity']} "
          f"capacity; launches {launches}")
    return launches, res


def moe_spec_vs_plain(rcfg, served, reqs, card):
    """A plain and a ``SpecConfig(SPEC_CF, SPEC_K)`` engine (prefix sharing
    off) on the greedy ``reqs``: ``spec_greedy``'s streams, timing and
    verify-vs-decode check, with the routing-flip accounting."""
    seeds = [r.seed for r in reqs]
    routes = {}

    def accounted(mode, run):
        with record_moe_calls() as calls:
            out = run()
        routes[mode] = position_routes(calls, seeds)
        return out

    acct = {}

    def allow(seed, m):
        if not acct:                # both runs' routes are recorded by now
            acct["allow"], acct["tally"] = moe_allowance(
                routes["plain"], routes["spec"], MOE_PROMPT)
        return acct["allow"](seed, m)
    _, res, launches = spec_greedy(
        rcfg, served, reqs, card, "random init",
        engine_kw=dict(share_prefix=False), wrap_run=accounted,
        allow=allow)
    res["routes"] = tally = acct["tally"]
    print(f"[{card}] spec {rcfg.model.name}: routes over each compared "
          f"context: {tally['equal']} equal, {tally['flip']} with a flip "
          f"(margins {[round(x, 4) for x in tally['margins']]}), "
          f"{tally['capacity']} capacity")
    return res, launches


def serve_moe(arch, seed, card, full):
    """Serve ``arch`` at full width (MOE_SERVE's depth) through
    ``ServeEngine``: the smoke queue (decode tok/s, TTFT; counters set to
    0 just before), the fused-vs-gathered step check with the reference
    path's routing replayed (with ``full``), a profiled decode wave, the
    dense oracle against the engine (DENSE_REQS greedy requests and a
    sampled one with ``full``, else one greedy) and with ``full`` a
    SpecConfig engine against a plain one. Returns (launches of each
    run, numbers)."""
    import numpy as np
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.models import transformer
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.tree import leaves_with_paths
    rcfg = moe_serve_config(arch)
    cfg = rcfg.model
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = transformer.init_model(rcfg, seed=seed, device="cuda")
    engine = ServeEngine(rcfg, params, max_batch=MAX_BATCH, page_size=PAGE,
                         max_len=MAX_LEN, device="cuda")
    torch.cuda.synchronize()
    n_layers = transformer.stacked_layer_depth(rcfg)
    n_params = sum(p.numel() for _, p in leaves_with_paths(params))
    print(f"model: {cfg.name} d_model={cfg.d_model} {n_layers} stacked "
          f"layers of {cfg.n_layers} (cut from "
          f"{get_config(arch).model.n_layers}; "
          f"MGRIT pad_to {rcfg.mgrit.pad_to}, no gate-0 layer) heads="
          f"{cfg.n_heads}/{cfg.n_kv_heads} experts={cfg.moe.num_experts} "
          f"top-{cfg.moe.top_k} expert d_ff={cfg.moe.d_ff} vocab="
          f"{cfg.vocab_size}; {n_params / 1e9:.2f} B params stored in "
          f"bf16; init + engine {time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB on the card")
    rng = np.random.default_rng(seed)
    launches = {"queue": serve_queue(engine, rng, {"paged_flash_attention":
                                                   n_layers})}
    res = {"decode_tok_s": engine.scheduler.throughput()["decode_tok_s"]}
    if full:
        # a second fresh engine on the same queue repeats the streams bit
        # for bit (every padded write of a prefill bucket lands in the
        # scratch row; the last writer's bytes each time); it is phase
        # 5e's reference
        ref = ServeEngine(rcfg, params, max_batch=MAX_BATCH, page_size=PAGE,
                          max_len=MAX_LEN, device="cuda")
        streams, queue_launches = queue_run(ref, make_queue(
            np.random.default_rng(seed), cfg.vocab_size))
        same = streams == SERVED[cfg.name]
        differ = [i for i, (a, b) in enumerate(zip(streams,
                                                   SERVED[cfg.name]))
                  if a != b]
        print(f"[{card}] {cfg.name}: a second fresh engine's smoke-queue "
              f"streams " + ("bitwise the first's" if same else
                             f"DIFFER in requests {differ}")
              + f"; launches {queue_launches}")
        if not same or queue_launches != launches["queue"]:
            fail(f"{cfg.name}: two fresh engines' smoke-queue streams or "
                 f"launches differ (requests {differ})")
        res["repeat_streams_equal"] = same
        MOE_REF[arch] = {"streams": streams, "launches": queue_launches,
                         "logits": decode_step_logits(ref.backend)}
        del ref
        step_check(engine, transformer.paged_decode_step,
                   lambda r: transformer.init_paged_cache(
                       r, 1 + MAX_BATCH * 8, PAGE, device="cuda"), rng,
                   moe_replay=True)
    profile_decode_wave(engine.backend, cfg.name)
    served = engine.backend.params
    del engine, params
    gc.collect()
    reqs = moe_requests(np.random.default_rng(seed), cfg.vocab_size,
                        DENSE_REQS if full else 1, sampled=full)
    launches["dense"], res["dense"] = moe_dense_vs_paged(rcfg, served, reqs,
                                                         card)
    if full:
        greedy = moe_requests(np.random.default_rng(seed), cfg.vocab_size,
                              SPEC_REQS, sampled=False)
        res["spec"], launches["spec"] = moe_spec_vs_plain(rcfg, served,
                                                          greedy, card)
    res["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    print(f"[{card}] {cfg.name}: peak memory {res['peak_gib']:.1f} GiB")
    return launches, res


def check_moe_train_grads():
    """qwen3-moe at full width and MOE_GRAD_LAYERS stacked layers (bf16
    storage, B 2, S 512, its MGRIT config): the kernel path's gradient
    (the MGRIT adjoint), moved to host memory, against the plain path's
    with the kernel path's routing replayed: cosine and norm as
    tests/test_lp_grads.py. Returns (launches of the kernel path, cosine,
    norm difference)."""
    import torch
    from repro_torch.data.pipeline import SyntheticLM, shard_batch
    from repro_torch.models import transformer
    from repro_torch.tree import leaves_with_paths
    rcfg = moe_train_config(MOE_GRAD_LAYERS, 2)
    mg = rcfg.mgrit
    params = transformer.init_model(rcfg, seed=1, device="cuda")
    batch = shard_batch(SyntheticLM(rcfg, seed=1).batch_at(0), "cuda")
    n = sum(p.numel() for _, p in leaves_with_paths(params))
    reset_train_counts()
    with record_routes() as plans:
        lk, gk = grads_of(params, batch, rcfg, mode="lp")
    torch.cuda.synchronize()
    launches = train_counts()
    gk = {p: g.cpu() for p, g in gk.items()}
    gc.collect()
    torch.cuda.empty_cache()
    with plain_kernels(), record_routes(replay=plans):
        lp_, gp = grads_of(params, batch, rcfg, mode="lp")
    cos, nrel = grad_direction(gk, gp)
    print(f"moe train grads, qwen3-moe full width, {MOE_GRAD_LAYERS} stacked "
          f"layers ({n / 1e9:.2f} B params, bf16), B=2 S=512, MGRIT fwd "
          f"{mg.fwd_iters} / bwd {mg.bwd_iters}: kernel path vs plain path "
          f"(routing replayed, {len(plans)} MoE calls): loss {lk:.6f} vs "
          f"{lp_:.6f}; cosine {cos:.6f} (> {MOE_GRAD_COS}), norm rel diff "
          f"{nrel:.3e} (< {MOE_GRAD_NORM:g}); launches {launches}")
    if not grads_agree(cos, nrel):
        fail("MoE gradients lose direction or norm between the kernel and "
             "plain paths")
    if min(launches[k] for k in ("flash_attention_fwd", "flash_attention_bwd",
                                 "rmsnorm_fwd", "rmsnorm_bwd")) <= 0:
        fail(f"MoE gradient check: a training kernel never launched: "
             f"{launches}")
    del params, gk, gp, plans
    return launches, cos, nrel


def moe_train_config(n_layers, batch, moment_dtype="float32"):
    """qwen3-moe's train config at full width, ``n_layers`` stacked
    layers (pad_to its cf: no gate-0 layer), bf16 storage, B ``batch``,
    S 512, its MGRIT config and sharding rules (experts and FSDP over
    'data', layers over 'model'), AdamW moments in ``moment_dtype``."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.registry import get_config
    rcfg = get_config("qwen3_moe_235b", "train_4k")
    mg = rcfg.mgrit
    return rcfg.replace(
        model=dataclasses.replace(rcfg.model, n_layers=n_layers,
                                  param_dtype="bfloat16"),
        mgrit=dataclasses.replace(mg, pad_to=mg.cf),
        shape=ShapeConfig("s512", "train", 512, batch), microbatches=1,
        optimizer=dataclasses.replace(rcfg.optimizer,
                                      moment_dtype=moment_dtype))


def grads_agree(cos, nrel) -> bool:
    """The MoE gradient checks' rule: direction within MOE_GRAD_COS and
    norm within MOE_GRAD_NORM (tests/test_lp_grads.py's)."""
    import numpy as np
    return bool(np.isfinite(cos) and cos > MOE_GRAD_COS
                and nrel < MOE_GRAD_NORM)


def grad_direction(got, want):
    """(cosine, norm difference relative to ``want``'s) of two gradients
    ({path: tensor}, on the card or in host memory), summed in float64 on
    the card a piece at a time (the gate leaves left out)."""
    import numpy as np
    dot = na = nb = 0.0
    for p, g in want.items():
        if p[-1] == "gate":
            continue
        for a, b in zip(got[p].reshape(-1).split(2**27),
                        g.reshape(-1).split(2**27), strict=True):
            a, b = a.to("cuda").double(), b.to("cuda").double()
            dot += float((a * b).sum())
            na += float((a * a).sum())
            nb += float((b * b).sum())
    return (dot / (np.sqrt(na * nb) + 1e-30),
            abs(np.sqrt(na) - np.sqrt(nb)) / np.sqrt(nb))


def moe_reduced_train_config():
    """The reduced qwen3-moe config (4 experts, top-2, 10 layers) at its
    smoke shape, bf16 compute, probe at step 2."""
    from repro_torch.configs.reduce import reduce_config
    from repro_torch.configs.registry import get_config
    rcfg = reduce_config(get_config("qwen3_moe_235b"))
    return rcfg.replace(mgrit=dataclasses.replace(rcfg.mgrit,
                                                  check_every=2))


def moe_phase(gen, flush, card):
    """Phase 5d: the MoE module, the kernels at the MoE shapes, serving
    qwen3-moe and grok-1, the gradient check and three reduced Trainer
    steps. Returns (launches by run, errors, numbers)."""
    import torch
    t0 = time.perf_counter()
    mod_err, dropped = check_moe_module(gen)
    layer_rows = time_moe_layer(gen, flush)
    kern_err = check_moe_kernels(gen)
    kern_rows = time_moe_kernels(gen, flush)
    gc.collect()
    torch.cuda.empty_cache()
    launches = {}
    res = {"dropped": dropped,
           "layer": {f"{a} {b}x{s}": v for (a, b, s), v in layer_rows.items()},
           "kernels": {" S=".join(map(str, k)) if isinstance(k, tuple) else k:
                       v for k, v in kern_rows.items()}}
    for arch, full in (("qwen3_moe_235b", True), ("grok1_314b", False)):
        launches[arch], res[arch] = serve_moe(arch, 23, card, full)
        gc.collect()
        torch.cuda.empty_cache()
    launches["grads"], res["grad_cos"], res["grad_norm_rel"] = \
        check_moe_train_grads()
    gc.collect()
    torch.cuda.empty_cache()
    train = run_train(moe_reduced_train_config(),
                      ("flash_attention_fwd", "flash_attention_bwd",
                       "rmsnorm_fwd", "rmsnorm_bwd"), record=True)
    launches["train"] = train[0]
    MOE_REF["train"] = train[3]["at_step_2"]     # phase 6e's reference
    res["wall_s"] = time.perf_counter() - t0
    print(f"MoE phase: {res['wall_s']:.1f} s")
    return launches, {**mod_err, **kern_err}, res


# -- phase 6b: checkpoint and resume; phase 9: the step roofline --------

CKPT_DIR = ROOT / "experiments" / "ckpt_smoke"
CKPT_STEPS = 2                  # checkpointed steps before the resume
# qwen3_1p7b cut from 28 to 10 layers (1 open + 8 ParallelNet + 1
# close, no gate-0 layer): its params and AdamW moments are ~13.5 GB, so
# the phase's two checkpoints write ~27 GB, within the ~40 GB of disk
# writes a smoke run may make (full depth: 28 GB a checkpoint), and the
# phase keeps the script inside its time limit on a slow host
CKPT_LAYERS = 10


def ckpt_train_config():
    """qwen3_train_config's run at full width, cut to CKPT_LAYERS layers
    (MGRIT cf 2 over an 8-layer ParallelNet, pad_to 8)."""
    rcfg = qwen3_train_config()
    return rcfg.replace(
        model=dataclasses.replace(rcfg.model, n_layers=CKPT_LAYERS),
        mgrit=dataclasses.replace(rcfg.mgrit, pad_to=CKPT_LAYERS - 2))


def state_digest(params, opt_state) -> dict:
    """sha256 of every param and optimizer-state leaf's bytes, by key
    path, plus the optimizer's step: each leaf copied to the host in
    turn and hashed on a thread pool (at most 8 leaves being hashed at
    once)."""
    import hashlib
    from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor, wait
    import torch
    from repro_torch.tree import leaves_with_paths
    leaves = [(("params",) + p, t) for p, t in leaves_with_paths(params)]
    for key in ("m", "v", "master"):
        if key in opt_state:
            leaves += [((key,) + p, t)
                       for p, t in leaves_with_paths(opt_state[key])]
    out = {"step": str(opt_state["step"])}
    with ThreadPoolExecutor(8) as ex:
        pending, running = [], set()
        for path, t in leaves:
            host = t.detach().contiguous().view(-1).view(torch.uint8).cpu()
            f = ex.submit(lambda a: hashlib.sha256(a).hexdigest(),
                          host.numpy())
            pending.append((".".join(path), f))
            running.add(f)
            if len(running) >= 8:
                running = wait(running, return_when=FIRST_COMPLETED)[1]
        for name, f in pending:
            out[name] = f.result()
    return out


def dir_bytes(path) -> int:
    return sum(f.stat().st_size for f in Path(path).rglob("*")
               if f.is_file())


def checkpoint_phase(rcfg, card):
    """Phase 6b: checkpoint and resume ``rcfg`` (ckpt_train_config). The
    uninterrupted baseline: a fresh ``Trainer`` trains 3 steps (the
    probe at step 2), its losses and the digest of every leaf after
    step 3 (:func:`state_digest`) kept. A fresh
    ``Trainer(ckpt_dir=...)`` trains CKPT_STEPS steps saving after each
    (each save's seconds, bytes on disk and GB/s); LATEST must name the
    last, both step directories must be there and no ``.tmp-*``. A
    second fresh ``Trainer`` restores in place (seconds, GB/s, peak
    memory over the restore beside the state's bytes), must be at step
    CKPT_STEPS, and trains one step (the probe at step 2, as in the
    baseline): its loss and every leaf's digest must equal the
    uninterrupted run's bit for bit. The checkpoints live in CKPT_DIR,
    removed at the end."""
    import shutil
    import torch
    from repro_torch.train import checkpoint as ck
    from repro_torch.train.trainer import Trainer
    from repro_torch.tree import leaves_with_paths

    t_phase = time.perf_counter()
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    CKPT_DIR.mkdir(parents=True)
    du = shutil.disk_usage(CKPT_DIR)
    print(f"checkpoint phase ({card}): {CKPT_DIR} on a disk with "
          f"{du.free / 1e9:.1f} GB free of {du.total / 1e9:.1f} GB; "
          f"{rcfg.model.name} at full width, {depth_text(rcfg)}")
    whole = Trainer(rcfg, seed=0)
    w_rep = whole.train(3, log_every=0)
    t0 = time.perf_counter()
    base = {"losses": w_rep.losses,
            "digest": state_digest(whole.params, whole.opt_state)}
    print(f"uninterrupted: losses {w_rep.losses} ({w_rep.mode_trace}), "
          f"probe history {w_rep.controller_history}; digest of "
          f"{len(base['digest'])} leaves after step 3 in "
          f"{time.perf_counter() - t0:.1f} s ({card})")
    del whole
    gc.collect()
    torch.cuda.empty_cache()
    saves = []

    class TimedTrainer(Trainer):
        def _save(self, tag=""):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            super()._save(tag)
            sec = time.perf_counter() - t0
            saves.append((self.step, sec, dir_bytes(
                CKPT_DIR / f"step_{self.step:010d}")))

    res = {}
    try:
        trainer = TimedTrainer(rcfg, ckpt_dir=str(CKPT_DIR), seed=0)
        state = sum(t.numel() * t.element_size() for tree in (
            trainer.params, trainer.opt_state["m"], trainer.opt_state["v"])
            for _, t in leaves_with_paths(tree))
        rep = trainer.train(CKPT_STEPS, ckpt_every=1, log_every=0)
        for step, sec, nbytes in saves:
            print(f"checkpoint save at step {step}: {sec:.2f} s, "
                  f"{nbytes / 1e9:.3f} GB on disk (state "
                  f"{state / 1e9:.3f} GB), {nbytes / sec / 1e9:.3f} GB/s "
                  f"({card})")
        res["saves"] = [{"step": s, "s": sec, "bytes": b}
                        for s, sec, b in saves]
        res["state_bytes"] = state
        latest = (CKPT_DIR / "LATEST").read_text()
        names = sorted(p.name for p in CKPT_DIR.iterdir())
        want = ["LATEST"] + [f"step_{s:010d}"
                             for s in range(1, CKPT_STEPS + 1)]
        if latest != f"step_{CKPT_STEPS:010d}" or names != want:
            fail(f"checkpoint directory holds {names}, LATEST {latest!r}")
        if rep.losses != base["losses"][:CKPT_STEPS]:
            fail(f"checkpointed run's losses {rep.losses} != the "
                 f"uninterrupted run's {base['losses'][:CKPT_STEPS]}")
        del trainer
        gc.collect()
        torch.cuda.empty_cache()

        timing = {}
        real = ck.restore

        def timed_restore(*args, **kw):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            timing["before"] = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            out = real(*args, **kw)
            torch.cuda.synchronize()
            timing["s"] = time.perf_counter() - t0
            timing["peak"] = torch.cuda.max_memory_allocated()
            return out

        ck.restore = timed_restore
        try:
            resumed = Trainer(rcfg, ckpt_dir=str(CKPT_DIR), seed=0)
        finally:
            ck.restore = real
        read = dir_bytes(CKPT_DIR / f"step_{CKPT_STEPS:010d}")
        print(f"checkpoint restore of step {resumed.step}: "
              f"{timing['s']:.2f} s, {read / 1e9:.3f} GB read (page cache "
              f"warm: written just before), {read / timing['s'] / 1e9:.3f} "
              f"GB/s; device memory {timing['before'] / 2**30:.2f} GiB "
              f"before, peak {timing['peak'] / 2**30:.2f} GiB over the "
              f"restore, the state itself {state / 2**30:.2f} GiB ({card})")
        res["restore"] = {"s": timing["s"], "bytes": read,
                          "before": timing["before"], "peak": timing["peak"]}
        if resumed.step != CKPT_STEPS or \
                resumed.opt_state["step"] != CKPT_STEPS:
            fail(f"resumed at step {resumed.step} / optimizer step "
                 f"{resumed.opt_state['step']}, not {CKPT_STEPS}")
        r_rep = resumed.train(1, log_every=0)
        t0 = time.perf_counter()
        dig = state_digest(resumed.params, resumed.opt_state)
        print(f"resumed step {CKPT_STEPS} [{r_rep.mode_trace[0]}]: loss "
              f"{r_rep.losses[0]!r} (uninterrupted {base['losses'][2]!r}), "
              f"probe history {r_rep.controller_history}; digest in "
              f"{time.perf_counter() - t0:.1f} s ({card})")
        differ = sorted(k for k in base["digest"]
                        if dig.get(k) != base["digest"][k])
        same_loss = r_rep.losses[0] == base["losses"][2]
        res["bitwise"] = not differ and same_loss
        print(f"resume vs uninterrupted: loss "
              f"{'equal' if same_loss else 'DIFFERS'}"
              f", {len(base['digest']) - len(differ)} of "
              f"{len(base['digest'])} leaf digests equal"
              + (f"; differing: {differ[:8]}" if differ else ""))
        if [h[0] for h in r_rep.controller_history] != [2]:
            fail(f"the resumed run's probe did not run at step 2: "
                 f"{r_rep.controller_history}")
        if not res["bitwise"]:
            fail("the resumed run differs from the uninterrupted one")
        del resumed
    finally:
        shutil.rmtree(CKPT_DIR, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    res["wall_s"] = time.perf_counter() - t_phase
    print(f"checkpoint phase: {res['wall_s']:.1f} s ({card})")
    return res


# -- phase 6c / 6d: layer-parallel training over a mesh ---------------------
# at (1, 2) and (1, 4) each rank repeats one rank's arithmetic on its own
# chunks, and the gradient norm sums each layer's squares in layer order
# (launch/steps.norm_layers): losses and params are held bit for bit
MESH_STEPS = 2
MESH_SPAWN_S = 600.0


def mesh_counts_text(counts) -> str:
    return ", ".join(f"{k} {n}x {b / 2**20:.1f} MiB"
                     for k, (n, b) in sorted(counts.items())) or "none"


def mesh_train(mesh, device, rcfg=None, progress=False, trainer=None):
    """``Trainer(rcfg, mesh=mesh)`` (default ``qwen3_train_config()``;
    ``mesh`` None: one device; ``trainer``: that one, built already):
    MESH_STEPS steps at phase 6's seed and data, one ``train(1)`` each,
    the mesh's collective counts reset before each step and read after
    it. The training launch counters are set to 0 just before the first
    step and read after the last. With ``progress`` global rank 0 prints
    a line after the init and after each step (memory, seconds). Returns
    the losses, each step's seconds and collectives, the launches, the
    peak memory (GiB), the bytes this rank stores (params and optimizer
    state) and the trainer."""
    import torch
    from repro_torch.train.trainer import Trainer
    t0 = time.perf_counter()
    if trainer is None:
        trainer = Trainer(rcfg or qwen3_train_config(), mesh=mesh, seed=0,
                          device=device)
    say = progress and (mesh is None or torch.distributed.get_rank() == 0)

    def report(what):
        if say:
            print(f"mesh_train rank 0: {what} at {time.perf_counter() - t0:.1f}"
                  f" s; allocated {torch.cuda.memory_allocated() / 2**30:.1f}"
                  f" GiB, reserved {torch.cuda.memory_reserved() / 2**30:.1f}"
                  f" GiB, peak {torch.cuda.max_memory_allocated() / 2**30:.1f}"
                  " GiB", flush=True)
    report("init done")
    torch.cuda.reset_peak_memory_stats()
    reset_train_counts()
    losses, secs, colls = [], [], []
    for i in range(MESH_STEPS):
        if mesh is not None:
            mesh.reset_counts()
        rep = trainer.train(1, log_every=0)
        losses += rep.losses
        secs += rep.step_seconds
        colls.append({} if mesh is None else
                     {k: list(v) for k, v in mesh.counts.items()})
        report(f"step {i} done")
    torch.cuda.synchronize()
    return {"losses": losses, "step_s": secs, "collectives": colls,
            "launches": train_counts(),
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "stored_gb": stored_bytes(trainer.params, trainer.opt_state)
            / 1e9,
            "kept_whole": [".".join(p) for p in trainer.kept_whole]}, trainer


def stored_bytes(params, opt_state) -> int:
    """The bytes of a params tree and its optimizer state (m, v and an
    fp32 master copy where there is one), as stored (a rank's slices
    under a mesh; meta tensors will do)."""
    from repro_torch.tree import leaves_with_paths
    trees = [params] + [opt_state[k] for k in ("m", "v", "master")
                        if k in opt_state]
    return sum(t.numel() * t.element_size() for tree in trees
               for _, t in leaves_with_paths(tree))


def mesh_phase(card, ref):
    """Phase 6c: full-width, full-depth qwen3_1p7b trained MESH_STEPS
    steps through ``Trainer(mesh=make_host_mesh())`` over a world-1 NCCL
    group opened in this process: the losses and every param leaf's
    sha256 after them must equal phase 6's one-device run (``ref``, its
    ``at_step_2``) bit for bit, and every training kernel must launch.
    Phase 6d, where 2 or more cards are visible: the same training on
    ``spawn_host_ranks`` NCCL ranks at (1, 2), and at (1, 4) with 4
    cards (``tp_train_shape``: the vocab cut over 'model' as the rules
    say, so the head's sums cross ranks: the embeddings, zT and the
    state the head reads bitwise one card's, the first batch's gradient
    within TP_GRAD_COS / TP_GRAD_NORM and the losses within TP_LOSS_REL
    of 6c's); printed beside each rank's stored bytes, step seconds,
    peak memory, halo and hand-off bytes. Returns the phase's
    numbers."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch.hostdev import spawn_host_ranks
    from repro_torch.launch.mesh import make_host_mesh
    out = {}
    t0 = time.perf_counter()
    mesh = make_host_mesh("cuda")
    try:
        res, trainer = mesh_train(mesh, "cuda")
        digest = state_digest(trainer.params,
                              {"step": trainer.opt_state["step"]})
        del trainer
    finally:
        dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    want = ref["at_step_2"]
    same_digest = digest == want["digest"]
    print(f"[{card}] phase 6c, qwen3_1p7b through a world-1 NCCL mesh "
          f"(1, 1): losses {res['losses']} vs one device "
          f"{want['losses']}: "
          + ("bitwise" if res["losses"] == want["losses"] else "DIFFER")
          + f"; {len(digest) - 1} param leaf digests "
          + ("all equal" if same_digest else "DIFFER")
          + f"; steps {[round(x, 3) for x in res['step_s']]} s; peak "
          f"{res['peak_gib']:.1f} GiB; launches {res['launches']}; kept "
          f"whole (axes this slice does not execute) {res['kept_whole']}")
    for i, c in enumerate(res["collectives"]):
        print(f"phase 6c step {i} collectives by kind: "
              + mesh_counts_text(c))
    print("phase 6c: the halo and hand-off sends have no peer at world 1 "
          "(one rank holds every chunk): none issued, as expected")
    if res["losses"] != want["losses"] or not same_digest:
        fail("phase 6c: the world-1 mesh run is not bitwise the one-device "
             "run")
    if min(res["launches"][k] for k in ("flash_attention_fwd",
                                        "flash_attention_bwd",
                                        "rmsnorm_fwd", "rmsnorm_bwd")) <= 0:
        fail(f"phase 6c: a training kernel never launched: "
             f"{res['launches']}")
    out["6c"] = {**res, "digest_equal": same_digest,
                 "wall_s": time.perf_counter() - t0}

    n = torch.cuda.device_count()
    if n < 2:
        print(f"phase 6d: not run: {n} CUDA device visible")
        out["6d"] = None
        return out
    out["6d"] = {}
    for shape in [(1, 2)] + ([(1, 4)] if n >= 4 else []):
        out["6d"][f"{shape[0]}x{shape[1]}"] = tp_train_shape(
            card, shape, "qwen3", want["losses"])
    return out


# -- phase 6d's qwen3, --mesh tp and phase 6g (every run): Megatron tensor
# parallelism in training. Every training rule cuts the vocab over 'model'
# (the head and the loss vocab-parallel), and zamba2's tp_sharding its
# heads, MLP and Mamba2 rows too, so the sums cross ranks: the embeddings
# (one non-zero term summed with zeros) and, where only the vocab is cut,
# zT and the state the head reads stay bitwise one card's; the gradient is
# held by its direction and norm to one card's: in float32 within
# TP_GRAD_COS / TP_GRAD_NORM (the MoE checks' limits), and in bf16 within
# them too or no farther from one card's than one card's bf16 gradient lies
# from its float32 twin, computed beside it (any reordering of a
# contraction flips bf16 roundings that the adjoint carries through as
# another bf16 realization: qwen3's vocab split alone reads 0.99980 at full
# depth, one card's own bf16-vs-float32 0.99918 at 10 layers). The losses
# are held within TP_LOSS_REL. 6g (every run, one card): full-width full-depth
# zamba2 through a world-1 NCCL mesh, losses
# and every state leaf's sha256 after two steps bitwise phase 7's one-device
# run, no collective issued; then its gradient at TP_SPLIT_LAYERS layers
# (the shared attention block after the sixth) at (1, 2) on this card
# through two gloo ranks over host_staged_mesh. --mesh tp (4 cards): the
# first batch's gradient and two Trainer steps of zamba2 at full width and
# depth at (1, 4) and (2, 2), and of qwen3 at (1, 4) (6d runs its (1, 2)),
# against one card's run in this process; stored bytes a rank beside one
# card's, peak memory, step seconds, collectives by kind and bytes,
# launches.
TP_GRAD_COS, TP_GRAD_NORM = MOE_GRAD_COS, MOE_GRAD_NORM
TP_LOSS_REL = 1e-3
TP_SPLIT_LAYERS = 6
# the split in float32, held leaf by leaf against one card's: a gradient
# leaf's, and after MESH_STEPS Trainer steps each AdamW moment leaf's,
# largest error within TP_F32_LEAF of the leaf's largest magnitude (the
# gradient's measured at most 3.99e-05 under --mesh tp on 4 H100 80GB
# HBM3 at 700 W); the gradient norm the clip reads (norm_layers) within
# TP_NORM_REL of one card's. The moments are linear and quadratic in the
# clipped gradient, so they show a wrong partial sum or clip norm. AdamW
# moves an element by up to about lr a step whatever its gradient's size,
# so where a gradient is near 0 its rounding decides the direction: a
# param leaf is held to TP_F32_LEAF of its largest beyond what the steps
# can move an element apart (``tp_f32_steps``), which shows a slice out of
# place. The Trainer steps run at TP_F32_LAYERS layers: full width, a
# depth that holds every kind of leaf (zamba2's shared block after the
# sixth layer).
TP_F32_LEAF = 1e-3
TP_NORM_REL = 1e-5
TP_F32_LAYERS = {"qwen3": 10, "zamba2": TP_SPLIT_LAYERS}


def tp_config(which):
    """``qwen3``: ``qwen3_train_config()``; ``zamba2``:
    ``zamba2_train_config()`` (B 1: at (2, 2) both data ranks run the
    row); ``<name>@<n>``: either at n layers."""
    rcfg = qwen3_train_config() if which.startswith("qwen3") else \
        zamba2_train_config()
    if "@" in which:
        rcfg = rcfg.replace(model=dataclasses.replace(
            rcfg.model, n_layers=int(which.split("@")[1])))
    return rcfg


def tp_f32_config(which):
    """``tp_config(which)``'s model at TP_F32_LAYERS layers, float32
    compute."""
    name = which.split("@")[0]
    rcfg = tp_config(f"{name}@{TP_F32_LAYERS[name]}")
    return rcfg.replace(model=dataclasses.replace(rcfg.model,
                                                  dtype="float32"))


def tp_f32_reference(which, dev):
    """One device's ``Trainer`` of ``tp_f32_config(which)`` (seed 0),
    MESH_STEPS steps of one ``train(1)`` each: its losses and, in host
    memory, its params and AdamW moments after them ("params", "m",
    "v": {path: tensor})."""
    import torch
    from repro_torch.train.trainer import Trainer
    from repro_torch.tree import leaves_with_paths
    tr = Trainer(tp_f32_config(which), seed=0, device=dev)
    losses = []
    for _ in range(MESH_STEPS):
        losses += tr.train(1, log_every=0).losses
    ref = {"losses": losses}
    for k, tree in (("params", tr.params), ("m", tr.opt_state["m"]),
                    ("v", tr.opt_state["v"])):
        ref[k] = {p: t.detach().cpu() for p, t in leaves_with_paths(tree)}
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    return ref


def tp_f32_steps(mesh, dev, which, ref):
    """Every rank of ``mesh``: ``Trainer(tp_f32_config(which), mesh=mesh)``
    MESH_STEPS steps as ``tp_f32_reference`` takes them, then its params
    and moments gathered whole a leaf at a time. On global rank 0
    (``ref``: that function's result) each leaf's largest error against
    one device's over that leaf's largest magnitude; a param's less what
    two runs' steps can move an element apart, 2.02 x the sum of the
    steps' lr x (1 + weight decay x the leaf's largest magnitude) (an
    AdamW step moves an element by at most 1.0004 x lr at betas 0.9 /
    0.95, plus the decay), floored at 0. Returns
    {"f32_losses", "f32_worst": {"params" / "m" / "v": the worst leaves,
    (name, value)}} (the worst on rank 0 only)."""
    import torch
    import torch.distributed as dist
    from repro_torch.models import transformer
    from repro_torch.optim.optimizers import lr_at
    from repro_torch.parallel import params as pparams
    from repro_torch.train.trainer import Trainer
    from repro_torch.tree import leaf_at, leaves_with_paths
    r32 = tp_f32_config(which)
    opt = r32.optimizer
    moved = 2.02 * sum(lr_at(opt, t + 1) for t in range(MESH_STEPS))
    tr = Trainer(r32, mesh=mesh, seed=0, device=dev)
    losses = []
    for _ in range(MESH_STEPS):
        losses += tr.train(1, log_every=0).losses
    specs = pparams.train_specs(transformer.param_shapes(r32), r32, mesh)
    rank0 = dist.get_rank() == 0
    errs = {"params": {}, "m": {}, "v": {}}
    for name, tree in (("params", tr.params), ("m", tr.opt_state["m"]),
                       ("v", tr.opt_state["v"])):
        for p, leaf in leaves_with_paths(tree):
            whole = pparams.gather_leaf(
                leaf, p, leaf_at(specs, p), mesh, kind="check_gather",
                cfg=r32.model, sharding=r32.sharding)
            if rank0 and p[-1] != "gate":
                want = ref[name][p].to(whole.device).float()
                top = want.abs().max().item()
                err = (whole.detach().float() - want).abs().max().item()
                if name == "params":
                    err = max(0.0, err - moved * (1 + opt.weight_decay * top))
                errs[name][".".join(p)] = err / max(top, 1e-30)
            del whole
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    return {"f32_losses": losses,
            "f32_worst": {k: sorted(v.items(), key=lambda kv: -kv[1])[:4]
                          for k, v in errs.items()} if rank0 else None}


def tensor_digest(t) -> str:
    """sha256 of a tensor's bytes."""
    import hashlib
    import torch
    return hashlib.sha256(t.detach().contiguous().view(-1).view(
        torch.uint8).cpu().numpy()).hexdigest()


def tp_states(params, batch, rcfg, mesh):
    """sha256 of the token embeddings and, for a decoder, of the trunk's
    output zT and of the state the head reads (after the final norm),
    under ``mesh``'s training rules (None: one device); no gradient."""
    import contextlib
    import torch
    from repro_torch.models import transformer as tr
    from repro_torch.models.blocks import block_kind
    from repro_torch.parallel.sharding import axis_rules
    cfg = rcfg.model
    rules = contextlib.nullcontext() if mesh is None else \
        axis_rules(mesh, rcfg.sharding)
    with torch.no_grad(), rules:
        p = tr.train_params(params, rcfg)
        z = tr._embed_inputs(p, batch, cfg)
        out = {"embed": tensor_digest(z)}
        if cfg.family == "hybrid":
            return out
        kind = block_kind(cfg)
        rope = tr._rope_for(cfg, z.shape[1], z.device)
        z = tr._serial_buffer(p.get("open"), z, cfg, kind=kind,
                              causal=True, rope=rope)
        zT, _ = tr._trunk(p, "mid", z, rcfg, kind=kind, causal=True,
                          rope=rope, mode="lp", n_layers=cfg.n_layers)
        out["zT"] = tensor_digest(zT)
        del z, zT
        out["prehead"] = tensor_digest(tr.hidden_states(params, batch,
                                                        rcfg)[0])
    return out


def leaf_errors_all(got, want):
    """{leaf: max|got - want| / max|want|} (the gates left out)."""
    out = {}
    for path, w in want.items():
        if path[-1] == "gate":
            continue
        g = got[path].to(w.device)
        den = w.float().abs().max().item()
        out[".".join(path)] = (g.float() - w.float()).abs().max().item() \
            / max(den, 1e-30)
    return out


def tp_rank(shape, which, steps, staged=False):
    """One rank of a tensor-parallel training check (a spawned process:
    an NCCL rank on ``cuda:<rank>``, or with ``staged`` a gloo rank on
    cuda:0 over ``host_staged_mesh``). Global rank 0 first takes one
    card's gradients of ``tp_config(which)``'s first batch (seed 0,
    moved to host memory), in its bf16 compute and in float32, and its
    ``tp_states``; then every rank builds its slices on the mesh (the
    ``Trainer``'s where it steps), its ``tp_states`` (at (1, n), where a
    rank holds every row), the gradient of its rows of the first batch
    through ``make_grad_fn(rcfg, mesh)`` and the gradient norm (launch
    and collective counters set to 0 just before, read just after) and
    the same gradient in float32, each gathered whole (on rank 0 their
    cosines and norm differences to one card's, and their largest leaf
    errors), then ``steps`` Trainer steps (``mesh_train``) and, where
    there are steps, the float32 Trainer check (``tp_f32_reference`` on
    rank 0 first, ``tp_f32_steps``). Returns numbers only."""
    import math
    import torch
    import torch.distributed as dist
    from repro_torch.data.pipeline import make_pipeline, shard_batch
    from repro_torch.launch import steps as steps_mod
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer
    from repro_torch.optim import optimizers
    from repro_torch.parallel import params as pparams
    from repro_torch.train.trainer import Trainer
    from repro_torch.tree import leaves_with_paths, tree_map
    rcfg = tp_config(which)
    r32 = rcfg.replace(model=dataclasses.replace(rcfg.model,
                                                 dtype="float32"))
    rank = dist.get_rank()
    dev = "cuda" if staged else f"cuda:{torch.cuda.current_device()}"
    host_batch = make_pipeline(rcfg, 0).batch_at(0)
    out = {"rank": rank, "device": torch.cuda.current_device()}
    refs, ref32 = {}, None
    if rank == 0:
        t0 = time.perf_counter()
        params = transformer.init_model(rcfg, seed=0, device=dev)
        b = shard_batch(host_batch, dev)
        out["one_states"] = tp_states(params, b, rcfg, None)
        for name, cfg_ in (("bf16", rcfg), ("f32", r32)):
            out[f"one_loss_{name}"], g = grads_of(params, b, cfg_,
                                                  mode="lp")
            out[f"one_norm_{name}"] = math.sqrt(sum(
                float(x.double().square().sum()) for x in g.values()))
            refs[name] = {p: x.cpu() for p, x in g.items()}
            del g
        # the bf16 floor: one card's bf16 gradient against its float32 twin
        out["floor_cos"], out["floor_norm"] = grad_direction(refs["bf16"],
                                                             refs["f32"])
        del params, b
        gc.collect()
        torch.cuda.empty_cache()
        if steps:
            ref32 = tp_f32_reference(which, dev)
        out["one_s"] = time.perf_counter() - t0
    mesh = host_staged_mesh(shape) if staged else \
        make_mesh(shape, ("data", "model"), "cuda")
    trainer = None
    if steps:
        trainer = Trainer(rcfg, mesh=mesh, seed=0, device=dev)
        local, whole = trainer.params, trainer.kept_whole
    else:                   # a host-staged mesh is on the CPU: no Trainer
        full = transformer.init_model(rcfg, seed=0, device=dev)
        local, whole = pparams.shard_tree(
            full, pparams.train_specs(full, rcfg, mesh), mesh,
            cfg=rcfg.model, sharding=rcfg.sharding)
        del full
        out["stored_gb"] = stored_bytes(local, optimizers.init_opt_state(
            rcfg.optimizer, tree_map(lambda t: t.to("meta"), local))) / 1e9
    out["kept_whole"] = [".".join(p) for p in whole]
    batch = shard_batch(host_batch, dev, mesh, rcfg)
    out["states"] = tp_states(local, batch, rcfg, mesh) \
        if shape[0] == 1 else None
    specs = pparams.train_specs(transformer.param_shapes(rcfg), rcfg, mesh)
    for name, cfg_ in (("bf16", rcfg), ("f32", r32)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        mesh.reset_counts()
        reset_train_counts()
        t0 = time.perf_counter()
        loss, _, grads = steps_mod.make_grad_fn(cfg_, mesh)(local, batch)
        gn = optimizers.global_norm(grads, steps_mod.norm_layers(cfg_, mesh))
        torch.cuda.synchronize()
        if name == "bf16":      # the main path's numbers
            out.update(loss=loss.item(), grad_norm=gn.item(),
                       grad_s=time.perf_counter() - t0,
                       grad_launches=train_counts(),
                       grad_collectives={k: list(v) for k, v in
                                         mesh.counts.items()},
                       grad_peak_gib=torch.cuda.max_memory_allocated()
                       / 2**30)
        else:
            out.update(loss_f32=loss.item(), grad_norm_f32=gn.item())
        full_g = pparams.gather_tree(grads, specs, mesh, cfg=rcfg.model,
                                     sharding=rcfg.sharding)
        del grads
        if rank == 0:
            got = dict(leaves_with_paths(full_g))
            out[f"cos_{name}"], out[f"norm_{name}"] = grad_direction(
                got, refs[name])
            errs = leaf_errors_all(got, refs.pop(name))
            out[f"worst_{name}"] = sorted(errs.items(),
                                          key=lambda kv: -kv[1])[:4]
            del got
        del full_g
        gc.collect()
        torch.cuda.empty_cache()
    del batch, local
    if steps:
        res, trainer = mesh_train(mesh, dev, trainer=trainer)
        out.update(res)
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    if steps:
        out.update(tp_f32_steps(mesh, dev, which, ref32))
        if rank == 0:
            out["one_f32_losses"] = ref32["losses"]
        del ref32
    return out


TP_KERNELS = {"qwen3": ("flash_attention_fwd", "flash_attention_bwd",
                        "rmsnorm_fwd", "rmsnorm_bwd"),
              "zamba2": ("flash_attention_fwd", "flash_attention_bwd",
                         "rmsnorm_fwd", "rmsnorm_bwd", "ssm_scan_fwd",
                         "ssm_scan_bwd")}


def tp_train_shape(card, shape, which, ref_losses, one_gb=None,
                   staged=False):
    """``tp_rank`` on the ranks of ``shape`` (``staged``: two gloo ranks
    on this card, the gradient alone; else NCCL ranks over the cards,
    with MESH_STEPS Trainer steps held to ``ref_losses``, one card's),
    its numbers printed and held: the first batch's gradient in float32
    within TP_GRAD_COS / TP_GRAD_NORM of one card's and every leaf within
    TP_F32_LEAF of its largest magnitude, its norm as the clip reads it
    the same on every rank and within TP_NORM_REL of one card's; in bf16
    (the main path) within TP_GRAD_COS / TP_GRAD_NORM too or within one
    card's bf16-vs-float32 distance, its norm the same on every rank;
    every rank the same loss within TP_LOSS_REL of one card's, the
    embeddings (and for a decoder zT and the state the head reads)
    bitwise one card's at (1, n), every kernel of the path launched on
    every rank, a tensor-parallel collective issued, nothing kept whole,
    the Trainer's losses the same on every rank and within TP_LOSS_REL of
    ``ref_losses``; the float32 Trainer's losses the same on every rank
    and within TP_NORM_REL of one card's, its params and moments within
    TP_F32_LEAF of one card's. Returns the ranks' numbers."""
    import math
    from repro_torch.launch.hostdev import spawn_host_ranks
    t0 = time.perf_counter()
    steps = 0 if staged else MESH_STEPS
    ranks = spawn_host_ranks(shape[0] * shape[1], tp_rank, shape, which,
                             steps, staged,
                             backend="gloo" if staged else "nccl",
                             timeout=MESH_SPAWN_S)
    wall = time.perf_counter() - t0
    r0 = ranks[0]
    label = f"phase {'6g' if staged else '6d'} {which} {shape}"
    kern = TP_KERNELS[which.split("@")[0]]
    # the split's arithmetic, in float32: within the MoE checks' limits
    # of one card's float32 gradient; in bf16 (the main path) within them
    # too, or no farther from one card's bf16 gradient than that one lies
    # from its float32 twin (bf16's own rounding, which any reordering of
    # a contraction carries through the adjoint as another realization)
    ok32 = grads_agree(r0["cos_f32"], r0["norm_f32"])
    ok16 = grads_agree(r0["cos_bf16"], r0["norm_bf16"]) or (
        1 - r0["cos_bf16"] <= 1 - r0["floor_cos"]
        and r0["norm_bf16"] <= max(TP_GRAD_NORM, r0["floor_norm"]))
    rel = abs(r0["loss"] - r0["one_loss_bf16"]) / abs(r0["one_loss_bf16"])
    rel32 = abs(r0["loss_f32"] - r0["one_loss_f32"]) / abs(
        r0["one_loss_f32"])
    norm32 = abs(r0["grad_norm_f32"] - r0["one_norm_f32"]) \
        / r0["one_norm_f32"]
    leaf32 = r0["worst_f32"][0][1]
    print(f"[{card}] {label}: first batch's gradient gathered whole vs one "
          f"card's: float32 cosine {r0['cos_f32']:.9f} (> {TP_GRAD_COS}), "
          f"norm rel diff {r0['norm_f32']:.3e} (< {TP_GRAD_NORM:g}), loss "
          f"rel {rel32:.3e}; bf16 cosine {r0['cos_bf16']:.7f}, norm rel "
          f"diff {r0['norm_bf16']:.3e} (> {TP_GRAD_COS} and < "
          f"{TP_GRAD_NORM:g}, or within one card's bf16 vs float32: cosine "
          f"{r0['floor_cos']:.7f}, norm {r0['floor_norm']:.3e}), loss "
          f"{r0['loss']:.6f} vs {r0['one_loss_bf16']:.6f} (rel {rel:.3e}, < "
          f"{TP_LOSS_REL:g}); largest leaf errors float32 "
          + ", ".join(f"{k} {v:.2e}" for k, v in r0["worst_f32"])
          + f" (< {TP_F32_LEAF:g}); bf16 "
          + ", ".join(f"{k} {v:.2e}" for k, v in r0["worst_bf16"])
          + f"; float32 norm (norm_layers) {r0['grad_norm_f32']:.9f} vs one "
          f"card's {r0['one_norm_f32']:.9f} (rel {norm32:.3e}, < "
          f"{TP_NORM_REL:g}); one card's gradients and references "
          f"{r0['one_s']:.1f} s")
    if not (ok32 and ok16) or rel >= TP_LOSS_REL or rel32 >= TP_LOSS_REL \
            or not leaf32 <= TP_F32_LEAF or not norm32 <= TP_NORM_REL:
        fail(f"{label}: the mesh gradient, its norm or the loss is off one "
             "card's")
    for r in ranks:
        if r["loss"] != r0["loss"]:
            fail(f"{label}: rank {r['rank']}'s loss {r['loss']} is not rank "
                 f"0's {r0['loss']}")
        if (r["grad_norm"], r["grad_norm_f32"]) != (r0["grad_norm"],
                                                    r0["grad_norm_f32"]):
            fail(f"{label}: rank {r['rank']} clips by another norm than rank "
                 f"0: {r['grad_norm']} / {r['grad_norm_f32']} vs "
                 f"{r0['grad_norm']} / {r0['grad_norm_f32']}")
        if r["states"] is not None:
            same = {k: r["states"][k] == v
                    for k, v in r0["one_states"].items()}
            print(f"[{card}] {label} rank {r['rank']}: bitwise one card's: "
                  + ", ".join(f"{k} {'yes' if v else 'NO'}"
                              for k, v in same.items()))
            if not all(same.values()):
                fail(f"{label}: rank {r['rank']}'s states differ from one "
                     f"card's: {same}")
        gl = r["grad_launches"]
        print(f"[{card}] {label} rank {r['rank']} (cuda:{r['device']}): "
              f"gradient {r['grad_s']:.2f} s, peak "
              f"{r['grad_peak_gib']:.1f} GiB, norm {r['grad_norm']:.6f}; "
              f"stored {r['stored_gb']:.3f} GB"
              + (f" (one card {one_gb:.3f})" if one_gb else "")
              + f"; launches {gl}; collectives: "
              + mesh_counts_text(r["grad_collectives"]))
        if min(gl.get(k, 0) for k in kern) <= 0:
            fail(f"{label}: rank {r['rank']} launched no {kern} kernel: "
                 f"{gl}")
        if not any(k.startswith("tp_") for k in r["grad_collectives"]):
            fail(f"{label}: rank {r['rank']} issued no tensor-parallel "
                 "collective")
        if r["kept_whole"]:
            fail(f"{label}: rank {r['rank']} keeps {r['kept_whole']} whole")
        if not steps:
            continue
        lr = max(abs(a - b) / abs(b) for a, b in
                 zip(r["losses"], ref_losses, strict=True))
        halo = r["collectives"][-1].get("halo", [0, 0])
        hand = r["collectives"][-1].get("handoff", [0, 0])
        print(f"[{card}] {label} rank {r['rank']}: Trainer losses "
              f"{r['losses']} (one card {ref_losses}, largest rel gap "
              f"{lr:.3e}); steps {[round(x, 3) for x in r['step_s']]} s; "
              f"peak {r['peak_gib']:.1f} GiB; launches {r['launches']}; "
              f"step 1 sends: halo {halo[0]}x, hand-off {hand[0]}x; "
              "collectives by kind: " + mesh_counts_text(r["collectives"][-1]))
        if r["losses"] != r0["losses"] or lr >= TP_LOSS_REL \
                or not all(math.isfinite(x) for x in r["losses"]):
            fail(f"{label}: rank {r['rank']}'s Trainer losses {r['losses']}"
                 f" are off one card's {ref_losses} or rank 0's")
        if min(r["launches"].get(k, 0) for k in kern) <= 0:
            fail(f"{label}: rank {r['rank']} launched no training kernel: "
                 f"{r['launches']}")
        if r["f32_losses"] != r0["f32_losses"]:
            fail(f"{label}: rank {r['rank']}'s float32 Trainer losses "
                 f"{r['f32_losses']} are not rank 0's {r0['f32_losses']}")
    if steps:
        w = r0["f32_worst"]
        lr32 = max(abs(a - b) / abs(b) for a, b in
                   zip(r0["f32_losses"], r0["one_f32_losses"], strict=True))
        print(f"[{card}] {label}: float32 Trainer at "
              f"{TP_F32_LAYERS[which.split('@')[0]]} layers, {MESH_STEPS} "
              f"steps: losses {r0['f32_losses']} vs one card's "
              f"{r0['one_f32_losses']} (largest rel gap {lr32:.3e}, < "
              f"{TP_NORM_REL:g}); largest leaf errors (< {TP_F32_LEAF:g}) "
              + "; ".join(f"{name} " + ", ".join(
                  f"{k} {v:.2e}" for k, v in w[name])
                  for name in ("params", "m", "v")))
        if not (lr32 < TP_NORM_REL
                and max(w[k][0][1] for k in w) <= TP_F32_LEAF):
            fail(f"{label}: the float32 Trainer's losses, params or "
                 "moments are off one card's")
    print(f"{label}: {wall:.1f} s wall (spawn, one card's gradient, init, "
          f"gradient, {steps} steps)")
    return {"ranks": ranks, "wall_s": wall}


def tp_phase(card, ref):
    """Phase 6g (see above): ``ref`` is phase 7's zamba2 ``at_step_2``.
    Returns the phase's numbers."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    t0 = time.perf_counter()
    mesh = make_host_mesh("cuda")
    try:
        res, trainer = mesh_train(mesh, "cuda", zamba2_train_config())
        digest = state_digest(trainer.params,
                              {"step": trainer.opt_state["step"]})
        del trainer
    finally:
        dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    same = digest == ref["digest"]
    colls = [c for c in res["collectives"] if c]
    print(f"[{card}] phase 6g, zamba2_1p2b (full width and depth, "
          f"tp_sharding) through a world-1 NCCL mesh: losses "
          f"{res['losses']} vs one device {ref['losses']}: "
          + ("bitwise" if res["losses"] == ref["losses"] else "DIFFER")
          + f"; {len(digest) - 1} state leaf digests "
          + ("all equal" if same else "DIFFER")
          + f"; collectives {colls or 'none'}; launches {res['launches']}; "
          f"kept whole {res['kept_whole']}")
    if res["losses"] != ref["losses"] or not same or colls:
        fail("phase 6g: the world-1 mesh run is not bitwise the one-device "
             "run, or it issued a collective")
    w1 = time.perf_counter() - t0
    split = tp_train_shape(card, (1, 2), f"zamba2@{TP_SPLIT_LAYERS}", None,
                           staged=True)
    wall = time.perf_counter() - t0
    print(f"phase 6g: {wall:.1f} s (world 1 {w1:.1f}, the (1, 2) split "
          f"{split['wall_s']:.1f})")
    return {"world1": {**res, "digest_equal": same}, "split": split,
            "wall_s": wall}


def tp_mesh_phase(card):
    """--mesh tp (see above), with 4 cards visible: one card's Trainer
    (MESH_STEPS steps) of full-width qwen3 and zamba2 in this process,
    then NCCL ranks at each shape. Returns the numbers."""
    import torch
    n = torch.cuda.device_count()
    if n < 4:
        print(f"--mesh tp: not run: {n} CUDA devices visible (needs 4)")
        return None
    out = {}
    for which, shapes in (("qwen3", ((1, 4),)),
                          ("zamba2", ((1, 4), (2, 2)))):
        t0 = time.perf_counter()
        one, trainer = mesh_train(None, "cuda", tp_config(which))
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
        print(f"[{card}] --mesh tp {which} one card: losses {one['losses']}"
              f"; steps {[round(x, 3) for x in one['step_s']]} s; peak "
              f"{one['peak_gib']:.1f} GiB; stored {one['stored_gb']:.3f} "
              f"GB; launches {one['launches']} ({time.perf_counter() - t0:.1f}"
              " s)")
        out[which] = {"one": one}
        for shape in shapes:
            out[which][f"{shape[0]}x{shape[1]}"] = tp_train_shape(
                card, shape, which, one["losses"], one["stored_gb"])
    return out


# -- phase 6f (every run) and --mesh fsdp: granite_34b under fsdp -----------
# 6f: full-width granite_34b (MQA 48/1 heads of 128, layernorm, gelu) at
# the depth its printed reckoning admits on one card, two Trainer steps on
# one device and through a world-1 NCCL mesh under its own train sharding
# (fsdp over 'data'): losses and every param leaf's sha256 bitwise, no
# collective issued; flash at its head shape against the plain version
# first. --mesh fsdp (4 cards): that depth's gradient at (4, 1) with fsdp
# and with fsdp=None (every rank's loss bitwise, the gradient gathered
# whole within GRANITE_GRAD_TOL), then two Trainer steps at (4, 1) and
# (2, 2) at the depth the reckoning admits with fsdp, each rank's stored
# bytes, peak memory, step seconds and gathers and reduce-scatters by
# kind and bytes printed.
GRANITE_S = TRAIN_S             # train_4k's sequence
GRANITE_B = 1                   # one card's rows
GRANITE_MESH_B = 4              # the 4-card runs' rows (one or two a rank)
GRANITE_MIDS = (8, 6, 4, 2)     # ParallelNet depths tried on one card
GRANITE_MESH_MIDS = (40, 36, 32, 28, 24, 20, 16)   # ... on 4 cards
GRANITE_STATE_BYTES = 16        # float32 param, gradient, AdamW m and v
# a step's activations and gathered leaves: the (4, 1) Trainer at 1 + 32
# + 1 layers peaked 17.8 GB above its state, 6.1 GB of it a copy of the
# coarse layers that a chunk axis of one rank no longer makes
GRANITE_ACT_GIB = 16.0
GRANITE_GRAD_TOL = 1e-5         # per leaf, x max|leaf|: float32 sums of 4
                                # ranks' rows in another order
GRANITE_SPAWN_S = 900.0


def granite_train_config(mid, B, fsdp=True):
    """granite_34b's train config at full width, 1 + ``mid`` + 1 stacked
    layers (pad_to its cf: no gate-0 layer), B ``B``, S GRANITE_S, its
    MGRIT config and train sharding (layers over 'model', fsdp over
    'data'; ``fsdp=False``: fsdp=None), float32 params and moments."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.registry import get_config
    rcfg = get_config("granite_34b", "train_4k")
    return rcfg.replace(
        model=dataclasses.replace(rcfg.model, n_layers=mid + 2),
        mgrit=dataclasses.replace(rcfg.mgrit, pad_to=rcfg.mgrit.cf),
        shape=ShapeConfig("train_4k", "train", GRANITE_S, B),
        microbatches=1,
        sharding=rcfg.sharding if fsdp else dataclasses.replace(
            rcfg.sharding, fsdp=None))


def stub_mesh(shape):
    import types
    return types.SimpleNamespace(axis_names=("data", "model"),
                                 shape=dict(zip(("data", "model"), shape)),
                                 index=lambda a: 0)


def granite_reckoning(shape, mids, total_bytes):
    """The deepest 1 + mid + 1 of ``mids`` whose training a rank of a
    mesh of ``shape`` holds in ``total_bytes``: the rank's parameters
    (its slices: chunks over 'model', fsdp over 'data') times
    GRANITE_STATE_BYTES, plus GRANITE_ACT_GIB, plus, where the chunks
    split over 'model' and the level-1 coarse V-cycle runs replicated
    (``core/mgrit._vcycle``: levels 3, shard_levels 1), the coarse
    layers every rank gathers (every rank's fsdp slices of them) and the
    gather's transient for the largest leaf (its stacked slots and twice
    the gathered ones); and the Trainer's init (every rank builds the
    float32 params whole, then keeps its slices), within MOE_FIT of the
    card. Returns (mid, the reckoning's lines)."""
    from repro_torch.models import transformer
    from repro_torch.parallel import params as pparams
    from repro_torch.parallel.sharding import chunk_axis
    from repro_torch.tree import leaf_at, leaves_with_paths
    room = MOE_FIT * total_bytes
    mesh = stub_mesh(shape)
    lines = []
    for mid in mids:
        rcfg = granite_train_config(mid, GRANITE_MESH_B)
        mg = rcfg.mgrit
        pshapes = transformer.param_shapes(rcfg)
        specs = pparams.train_specs(pshapes, rcfg, mesh)
        local = {p: pparams.local_slice(t, p, leaf_at(specs, p), mesh,
                                        sharding=rcfg.sharding).numel()
                 for p, t in leaves_with_paths(pshapes)}
        full = sum(t.numel() for _, t in leaves_with_paths(pshapes))
        n = sum(local.values())
        coarse = 0
        J, P = mid // mg.cf, shape[1]
        if P > 1 and mg.levels >= 3 and J % mg.cf == 0 \
                and chunk_axis(mid, mg.cf, rcfg.sharding, mesh,
                               mg.shard_levels) \
                and not (mg.shard_levels > 1 and (J // mg.cf) % P == 0):
            trunk = [v for p, v in local.items() if p[0] == "mid"]
            coarse = (sum(trunk) * P + max(trunk) * (1 + 2 * P)) \
                // mg.cf * 4
        step = n * GRANITE_STATE_BYTES + GRANITE_ACT_GIB * 2**30 + coarse
        init = (full + n) * 4
        ok = max(step, init) <= room
        lines.append(
            f"{shape}: 1 + {mid} + 1 layers, {full / 1e9:.3f} B params, "
            f"{n / 1e9:.3f} B a rank x {GRANITE_STATE_BYTES} B + "
            f"{GRANITE_ACT_GIB:g} GiB"
            + (f" + {coarse / 1e9:.1f} GB of gathered coarse layers"
               if coarse else "")
            + f" = {step / 1e9:.1f} GB; init {init / 1e9:.1f} GB (whole + "
            f"its slices, float32); {'fits' if ok else 'does not fit'} "
            f"{room / 1e9:.1f} GB")
        if ok:
            return mid, lines
    fail("no depth of full-width granite_34b fits: " + "; ".join(lines))


def check_granite_flash(gen):
    """Flash forward and backward at granite's head shape (B 1, H 48 / 1:
    a GQA group of 48, hd 128, S GRANITE_S, causal, bf16) against the
    plain version (FLASH_TOL), the backward twice bit-identical. Returns
    the largest absolute errors of the forward and the backward."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    B, h, hkv, S, hd = GRANITE_B, 48, 1, GRANITE_S, 128
    q, do = (torch.randn((B, h, S, hd), generator=gen, device="cuda") * 0.5
             for _ in range(2))
    k, v = (torch.randn((B, hkv, S, hd), generator=gen, device="cuda")
            * 0.5 for _ in range(2))
    q, k, v, do = (x.to(torch.bfloat16) for x in (q, k, v, do))
    want = _attn_grads(lambda *a: fa.flash_attention_ref(*a, causal=True),
                       q, k, v, do)
    got = _attn_grads(lambda *a: _kernel_bhsd(*a, True), q, k, v, do)
    again = _attn_grads(lambda *a: _kernel_bhsd(*a, True), q, k, v, do)
    torch.cuda.synchronize()
    e_out, out_ok = flash_out_check(got[0], want[0], "bfloat16")
    e_grad = max(_scaled_err(g, w) for g, w in zip(got[1:], want[1:]))
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    print(f"flash_attention granite B={B} H={h}/{hkv} S={S} hd={hd} causal "
          f"bfloat16: out max|kernel-plain| {e_out:.3e}, dq/dk/dv max|"
          f"kernel-plain|/max|plain| {e_grad:.3e} "
          f"({flash_tol_text('bfloat16')}); a second launch "
          + ("bitwise" if same else "DIFFERS"))
    if not (out_ok and e_grad <= FLASH_TOL["bfloat16"] and same):
        fail("flash attention at granite's head shape disagrees with its "
             "plain version or does not repeat")
    return e_out, max((g.float() - w.float()).abs().max().item()
                      for g, w in zip(got[1:], want[1:]))


def granite_phase(card, gen):
    """Phase 6f: flash at granite's head shape (``check_granite_flash``),
    then full-width granite_34b at the depth ``granite_reckoning`` admits
    on one card, B GRANITE_B, trained MESH_STEPS steps through
    ``Trainer`` on one device and through ``Trainer(mesh=make_host_mesh())``
    on a world-1 NCCL group of this process under its own train sharding
    (fsdp over 'data': an axis of one rank, so nothing is cut): losses
    and every param leaf's sha256 bit for bit, the same launches, no
    collective issued. Returns its numbers."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    t0 = time.perf_counter()
    flash_err = check_granite_flash(gen)
    gc.collect()
    torch.cuda.empty_cache()
    total = torch.cuda.get_device_properties(0).total_memory
    mid, lines = granite_reckoning((1, 1), GRANITE_MIDS, total)
    for line in lines:
        print(f"phase 6f granite_34b reckoning on one card: {line}")
    rcfg = granite_train_config(mid, GRANITE_B)
    runs = {}
    for name in ("one device", "world-1 mesh"):
        t1 = time.perf_counter()
        mesh = make_host_mesh("cuda") if name != "one device" else None
        try:
            res, trainer = mesh_train(mesh, "cuda", rcfg)
            res["digest"] = state_digest(trainer.params,
                                         {"step": trainer.opt_state["step"]})
            del trainer
        finally:
            if mesh is not None:
                dist.destroy_process_group()
        gc.collect()
        torch.cuda.empty_cache()
        res["wall_s"] = time.perf_counter() - t1
        runs[name] = res
        print(f"[{card}] phase 6f granite_34b {name}: full width, "
              f"{depth_text(rcfg)}, B={GRANITE_B} S={GRANITE_S}: losses "
              f"{res['losses']}; steps {[round(x, 3) for x in res['step_s']]}"
              f" s; peak {res['peak_gib']:.1f} GiB; launches "
              f"{res['launches']}; {res['wall_s']:.1f} s")
    one, w1 = runs["one device"], runs["world-1 mesh"]
    same = one["losses"] == w1["losses"] and one["digest"] == w1["digest"]
    colls = [c for c in w1["collectives"] if c]
    print(f"[{card}] phase 6f: the world-1 mesh run's losses and "
          f"{len(one['digest']) - 1} param leaf digests "
          + ("bitwise the one-device run's" if same else "DIFFER")
          + f"; collectives {colls or 'none'}; kept whole "
          f"{w1['kept_whole']}; {time.perf_counter() - t0:.1f} s")
    if not same or colls or w1["launches"] != one["launches"]:
        fail("phase 6f: granite_34b's world-1 mesh run is not bitwise the "
             "one-device run, issued collectives or launched otherwise")
    if min(one["launches"][k] for k in ("flash_attention_fwd",
                                         "flash_attention_bwd")) <= 0:
        fail(f"phase 6f: a flash kernel never launched: {one['launches']}")
    for r in runs.values():
        del r["digest"]
    return {"runs": runs, "n_layers": rcfg.model.n_layers,
            "reckoning": lines, "flash_err": flash_err,
            "wall_s": time.perf_counter() - t0}


def granite_grads_rank(shape, mid):
    """One rank of --mesh fsdp's gradient check (a spawned process on
    ``cuda:<rank>``): granite_34b at 1 + ``mid`` + 1 layers, B one row a
    data rank, from the same seeded params and batch, through
    ``make_grad_fn`` on a mesh of ``shape`` with fsdp=None (its gradient
    kept whole on the card), then with fsdp (this rank's slices; each
    gradient leaf gathered whole in turn and held to the first run's).
    Returns each run's loss, seconds, peak memory and collectives, the
    fsdp-cut leaves' local and whole bytes and the largest gap."""
    import torch
    import torch.distributed as dist
    from repro_torch.data.pipeline import SyntheticLM, shard_batch
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer
    from repro_torch.parallel import params as pparams
    from repro_torch.tree import leaf_at, leaves_with_paths
    mesh = make_mesh(shape, ("data", "model"), "cuda")
    out = {"rank": dist.get_rank(), "device": torch.cuda.current_device()}
    plain, gap = None, {}
    for name in ("plain", "fsdp"):
        rcfg = granite_train_config(mid, GRANITE_MESH_B,
                                    fsdp=name == "fsdp")
        full = transformer.init_model(rcfg, seed=0, device="cuda")
        specs = pparams.train_specs(full, rcfg, mesh)
        local, _ = pparams.shard_tree(full, specs, mesh,
                                      sharding=rcfg.sharding)
        cut = pparams.fsdp_cut(full, specs, mesh, rcfg.sharding)
        del full
        gc.collect()
        torch.cuda.empty_cache()
        batch = shard_batch(SyntheticLM(rcfg, seed=1).batch_at(0), "cuda",
                            mesh, rcfg)
        torch.cuda.reset_peak_memory_stats()
        mesh.reset_counts()
        t0 = time.perf_counter()
        loss, _, grads = steps.make_grad_fn(rcfg, mesh)(local, batch)
        out[name] = {"loss": loss.item(), "grad_s": time.perf_counter() - t0,
                     "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                     "collectives": {k: list(v)
                                     for k, v in mesh.counts.items()},
                     "cut_local_gb": sum(
                         leaf_at(local, p).numel() * 4 for p in cut) / 1e9}
        del local, batch
        if plain is None:
            plain = grads
            continue
        for p, g in leaves_with_paths(grads):
            whole = pparams.gather_leaf(g, p, leaf_at(specs, p), mesh,
                                        sharding=rcfg.sharding)
            want = leaf_at(plain, p)
            gap[".".join(p)] = ((whole - want).abs().max()
                                / want.abs().max().clamp(min=1e-30)).item()
            del whole
    out["gap"] = gap
    del plain, grads
    gc.collect()
    torch.cuda.empty_cache()
    return out


def train_rank(shape, rcfg):
    """One rank of a full-width Trainer over 4 cards (6d's qwen3-moe,
    --mesh fsdp's granite; a spawned process on ``cuda:<rank>``):
    ``mesh_train`` of ``rcfg``; returns its numbers, with the bytes its
    params and optimizer state hold."""
    import torch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.tree import leaves_with_paths
    mesh = make_mesh(shape, ("data", "model"), "cuda")
    res, trainer = mesh_train(mesh, f"cuda:{torch.cuda.current_device()}",
                              rcfg, progress=True)
    state = sum(t.numel() * t.element_size() for tree in (
        trainer.params, trainer.opt_state["m"], trainer.opt_state["v"],
        trainer.opt_state.get("master")) if tree is not None
        for _, t in leaves_with_paths(tree))
    del trainer
    return {"rank": torch.distributed.get_rank(),
            "device": torch.cuda.current_device(), "state_gb": state / 1e9,
            **res}


def granite_mesh_phase(card):
    """--mesh fsdp's granite part, with 4 cards visible: the gradient at
    (4, 1) with fsdp against fsdp=None (``granite_grads_rank``; every
    rank's loss bitwise, every leaf within GRANITE_GRAD_TOL) at the
    one-card depth, then MESH_STEPS Trainer steps at (4, 1) and (2, 2)
    at the depth ``granite_reckoning`` admits with fsdp (every rank's
    losses equal and finite). Returns its numbers (None with fewer
    cards)."""
    import math
    import torch
    from repro_torch.launch.hostdev import spawn_host_ranks
    from repro_torch.models import transformer
    from repro_torch.tree import leaves_with_paths
    n = torch.cuda.device_count()
    if n < 4:
        print(f"--mesh fsdp (granite): not run: {n} CUDA devices visible, "
              "it needs 4")
        return None
    total = torch.cuda.get_device_properties(0).total_memory
    out = {}
    small, _ = granite_reckoning((1, 1), GRANITE_MIDS, total)
    t0 = time.perf_counter()
    ranks = spawn_host_ranks(4, granite_grads_rank, (4, 1), small,
                             backend="nccl", timeout=GRANITE_SPAWN_S)
    wall = time.perf_counter() - t0
    worst = max(ranks[0]["gap"].values())
    for r in ranks:
        f, p = r["fsdp"], r["plain"]
        print(f"[{card}] --mesh fsdp granite_34b gradient (4, 1), 1 + "
              f"{small} + 1 layers, rank {r['rank']} (cuda:{r['device']}): "
              f"loss fsdp {f['loss']!r} vs fsdp=None {p['loss']!r} ("
              + ("bitwise" if f["loss"] == p["loss"] else "DIFFER")
              + f"); gradient {f['grad_s']:.2f} s vs {p['grad_s']:.2f} s; "
              f"peak {f['peak_gib']:.1f} vs {p['peak_gib']:.1f} GiB; fsdp-"
              f"cut leaves {f['cut_local_gb']:.2f} GB a rank; collectives "
              f"fsdp: " + mesh_counts_text(f["collectives"])
              + "; fsdp=None: " + mesh_counts_text(p["collectives"]))
        if f["loss"] != p["loss"] or f["loss"] != ranks[0]["fsdp"]["loss"]:
            fail(f"--mesh fsdp: rank {r['rank']}'s loss with fsdp is not "
                 "bitwise the fsdp=None run's")
    print(f"[{card}] --mesh fsdp granite_34b gradient gathered whole vs "
          f"fsdp=None: largest leaf gap {worst:.3e} x max|leaf| (tolerance "
          f"{GRANITE_GRAD_TOL:g}); {wall:.1f} s wall")
    if not worst <= GRANITE_GRAD_TOL:
        fail(f"--mesh fsdp: the gathered gradient is {worst:.3e} off")
    out["grads_4x1"] = {"ranks": ranks, "wall_s": wall, "n_layers": small + 2}
    for shape in ((4, 1), (2, 2)):
        mid, lines = granite_reckoning(shape, GRANITE_MESH_MIDS, total)
        for line in lines:
            print(f"--mesh fsdp granite_34b reckoning a rank: {line}")
        rcfg = granite_train_config(mid, GRANITE_MESH_B)
        whole = sum(t.numel() for _, t in leaves_with_paths(
            transformer.param_shapes(rcfg))) * 12
        t0 = time.perf_counter()
        ranks = spawn_host_ranks(math.prod(shape), train_rank, shape,
                                 rcfg, backend="nccl",
                                 timeout=GRANITE_SPAWN_S)
        wall = time.perf_counter() - t0
        want = ranks[0]["losses"]
        for r in ranks:
            print(f"[{card}] --mesh fsdp granite_34b Trainer {shape}, full "
                  f"width, {depth_text(rcfg)}, B={rcfg.shape.global_batch} "
                  f"S={GRANITE_S}, rank {r['rank']} (cuda:{r['device']}): "
                  f"losses {r['losses']}; steps "
                  f"{[round(x, 3) for x in r['step_s']]} s; stored "
                  f"{r['state_gb']:.2f} GB of {whole / 1e9:.2f} GB "
                  f"({r['state_gb'] * 1e9 / whole:.3f}); peak "
                  f"{r['peak_gib']:.1f} GiB; launches {r['launches']}")
            for i, c in enumerate(r["collectives"]):
                print(f"  rank {r['rank']} step {i} collectives "
                      + mesh_counts_text(c))
            if r["losses"] != want or not all(math.isfinite(x)
                                              for x in want):
                fail(f"--mesh fsdp {shape}: rank {r['rank']}'s losses "
                     f"{r['losses']} are not rank 0's {want} or not finite")
            if min(r["launches"][k] for k in ("flash_attention_fwd",
                                              "flash_attention_bwd")) <= 0:
                fail(f"--mesh fsdp {shape}: rank {r['rank']} launched no "
                     f"flash kernel: {r['launches']}")
        print(f"--mesh fsdp granite_34b Trainer {shape}: {wall:.1f} s wall "
              f"(spawn, init, {MESH_STEPS} steps); kept whole "
              f"{ranks[0]['kept_whole']}")
        out[f"train_{shape[0]}x{shape[1]}"] = {
            "ranks": ranks, "wall_s": wall, "n_layers": rcfg.model.n_layers,
            "whole_gb": whole / 1e9, "reckoning": lines}
    return out


# -- phase 5e / 5f: serving under a mesh ------------------------------------
# 5e (every run): qwen3_1p7b at full width and depth through
# ServeEngine(mesh=make_host_mesh()) on a world-1 NCCL group in this
# process: its smoke-queue streams and one decode step's logits bitwise
# the one-card engine's (phase 3's), no collective issued, the sync census
# of a decode wave the one-card engine's count. 5f (``--mesh``, 2+ cards):
# NCCL ranks serve the smoke queue, fused and gathered, at each shape of
# SERVE_MESH_SHAPES the visible cards hold;
# every rank's streams equal, and against the one-card engine's
# (SERVE_REF_DIR) the logits within DENSE_GAP at every shared-context
# emission and a first divergence only on a near-tie (DENSE_TIE): the
# tensor-parallel partial sums (float32, rounded once) reorder the float32
# accumulations, as other row counts did in phase 5c. The largest gaps
# read on an H100 at (1, 2): falcon_mamba_7b 0.3252 fused, 0.3438
# gathered; qwen3 0.1562 / 0.2422; zamba2 0.1924 / 0.1797 (with the
# partials rounded to bf16 and summed in bf16: falcon 0.4219 / 0.4355).
SERVE_MESH_SHAPES = (((1, 2), ("qwen3_1p7b", "falcon_mamba_7b",
                               "zamba2_1p2b")),
                     ((2, 1), ("qwen3_1p7b",)),
                     ((1, 4), ("qwen3_1p7b",)),
                     ((2, 2), ("qwen3_1p7b",)))
SERVE_SEEDS = {"qwen3_1p7b": 0, "falcon_mamba_7b": 1, "zamba2_1p2b": 1}
SERVE_REF_DIR = ROOT / "experiments" / "serve_mesh_ref"


def decode_step_logits(be):
    """One 64-token prefill of MAX_BATCH slots (n_new 64 / 50 / 33 / 10)
    and one decode step through the backend's own paged forward (under
    its tensor-parallel rules), on a scratch pool in the engine's page
    layout; the decode step's logits on the host (float32)."""
    import numpy as np
    import torch
    from repro_torch.serve.kv_pages import region_table
    rows = be.rows
    table, n_pages = region_table(MAX_BATCH, MAX_LEN // PAGE,
                                  *((rows.n, rows.span) if rows else (1,)))
    if rows is not None:
        table = rows.table(table)
    state = be.init_state(n_pages)
    rng = np.random.default_rng(5)
    V = be.rcfg.model.vocab_size
    toks = torch.from_numpy(rng.integers(0, V, (MAX_BATCH, 64))).cuda()
    lens = torch.zeros(MAX_BATCH, dtype=torch.int32, device="cuda")
    n_new = torch.tensor([64, 50, 33, 10], device="cuda")
    tab = torch.from_numpy(table).cuda()
    step = be._decode_fn()
    with torch.no_grad(), be._rules():
        _, state = step(be.params, state, toks, lens, n_new, tab, be.rcfg)
        nxt = torch.from_numpy(rng.integers(0, V, (MAX_BATCH, 1))).cuda()
        lg, _ = step(be.params, state, nxt, lens + n_new.to(torch.int32),
                     torch.ones_like(n_new), tab, be.rcfg)
    return lg.float().cpu()


def decode_wave_slots(be):
    """(scratch pool, slots, tokens) of a steady decode wave in the
    engine's page layout: MAX_BATCH slots at contexts DECODE_LENS, 2 of
    4 sampled (temperature 0.8, top-k 40, top-p 0.95)."""
    import numpy as np
    from repro_torch.serve.cache import SlotBatch
    from repro_torch.serve.kv_pages import region_table
    rows = be.rows
    table, n_pages = region_table(MAX_BATCH, MAX_LEN // PAGE,
                                  *((rows.n, rows.span) if rows else (1,)))
    slots = SlotBatch.greedy(MAX_BATCH, table, lengths=DECODE_LENS)
    slots.temps[1::2] = 0.8
    slots.top_ks[1::2] = 40
    slots.top_ps[1::2] = 0.95
    return be.init_state(n_pages), slots, np.ones((MAX_BATCH, 1), np.int32)


def serve_reference(arch, card):
    """One card, no mesh (the reference of 5e and 5f in ``--mesh`` runs,
    phase 3's and 5's engines otherwise): ``arch`` at full width and
    depth from SERVE_SEEDS, the smoke queue through ServeEngine (fused),
    the logits row of every emission recorded; one decode step's logits
    and the sync census and milliseconds (5 waves) of a steady decode
    wave, and the queue's kernel launches. Returns its numbers and the
    rows."""
    import numpy as np
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.models import transformer
    from repro_torch.serve.engine import ServeEngine
    rcfg = get_config(arch, "decode_32k")
    cfg = rcfg.model
    t0 = time.perf_counter()
    params = transformer.init_model(rcfg, seed=SERVE_SEEDS[arch],
                                    device="cuda")
    engine = ServeEngine(rcfg, params, max_batch=MAX_BATCH, page_size=PAGE,
                         max_len=MAX_LEN, device="cuda")
    del params
    reqs = make_queue(np.random.default_rng(SERVE_SEEDS[arch]),
                      cfg.vocab_size)
    reset_serve_counts()
    with record_spec_logits() as calls:
        out = engine.generate(reqs)
        torch.cuda.synchronize()
    launches = serve_counts()
    rows = emitted_rows(calls, {r.seed for r in reqs})
    del calls
    ref = {"streams": [r.output.tolist() for r in out],
           "launches": launches,
           "logits": decode_step_logits(engine.backend)}
    scratch, slots, tok = decode_wave_slots(engine.backend)
    for _ in range(2):
        engine.backend.step(scratch, slots, tok)
    with sync_census(f"{cfg.name} one-card decode wave"):
        engine.backend.step(scratch, slots, tok)
    ref["syncs"] = CENSUS[-1]["syncs"]
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for _ in range(5):
        engine.backend.step(scratch, slots, tok)   # reads its tokens back
    ref["wave_ms"] = 1e3 * (time.perf_counter() - t1) / 5
    print(f"[{card}] serve reference {cfg.name} (one card, no mesh): "
          f"{sum(map(len, ref['streams']))} tokens, launches {launches}, "
          f"a steady decode wave {ref['wave_ms']:.2f} ms, "
          f"{time.perf_counter() - t0:.1f} s")
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return ref, {k: v.detach().cpu() for k, v in rows.items()}


def world1_serve_phase(card, ref):
    """Phase 5e: full-width, full-depth qwen3_1p7b (seed 0) through
    ``ServeEngine(mesh=make_host_mesh())`` on a world-1 NCCL group of
    this process, on the smoke queue: the streams and one decode step's
    logits must be bitwise ``ref``'s (the one-card engine's), no
    collective issued, every kernel's launches per wave phase 3's, and
    the sync census of a decode wave must count ``ref``'s synchronizing
    calls. Returns the phase's numbers."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer
    from repro_torch.serve.engine import ServeEngine
    t0 = time.perf_counter()
    rcfg = get_config("qwen3_1p7b", "decode_32k")
    mesh = make_host_mesh("cuda")
    try:
        params = transformer.init_model(rcfg, seed=0, device="cuda")
        engine = ServeEngine(rcfg, params, mesh=mesh, max_batch=MAX_BATCH,
                             page_size=PAGE, max_len=MAX_LEN)
        del params
        mesh.reset_counts()
        launches = serve_queue(engine, np.random.default_rng(0), {
            "paged_flash_attention": transformer.stacked_layer_depth(rcfg)})
        streams = SERVED[rcfg.model.name]
        logits = decode_step_logits(engine.backend)
        scratch, slots, tok = decode_wave_slots(engine.backend)
        for _ in range(2):
            engine.backend.step(scratch, slots, tok)
        with sync_census(f"{rcfg.model.name} world-1 mesh decode wave"):
            engine.backend.step(scratch, slots, tok)
        syncs = CENSUS[-1]["syncs"]
        colls = {k: list(v) for k, v in mesh.counts.items()}
        stats = engine.stats
        del engine, scratch
    finally:
        dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    same = streams == ref["streams"]
    same_logits = torch.equal(logits, ref["logits"])
    wall = time.perf_counter() - t0
    print(f"[{card}] phase 5e, qwen3_1p7b served through a world-1 NCCL "
          f"mesh: streams {'bitwise' if same else 'DIFFER from'} the "
          f"one-card engine's; one decode step's logits "
          f"{'bitwise' if same_logits else 'DIFFER'}; collectives "
          f"{colls or 'none'}; sync census of a decode wave {syncs} "
          f"(one card {ref['syncs']}); mesh stats dp {stats['mesh_dp']} "
          f"tp {stats['mesh_tp']} devices {stats['mesh_devices']}; "
          f"{wall:.1f} s")
    if not same or not same_logits:
        fail("phase 5e: the world-1 mesh engine is not bitwise the "
             "one-card engine")
    if colls or syncs != ref["syncs"]:
        fail(f"phase 5e: the world-1 mesh issued collectives {colls} or "
             f"{syncs} synchronizing calls a wave (one card "
             f"{ref['syncs']})")
    return {"streams_equal": same, "logits_equal": same_logits,
            "syncs": syncs, "launches": launches, "wall_s": wall}


def _local_calls(calls, rows):
    """``record_spec_logits``'s calls with each backend call's occupancy
    cut to this data rank's slots (the logits hold its rows only)."""
    if rows is None:
        return calls
    return [(k, lg, sd, ct, rows.local(nn) if nn is not None
             and len(nn) != lg.shape[0] else nn)
            for k, lg, sd, ct, nn in calls]


def serve_mesh_rank(shape, archs):
    """One rank of phase 5f (a spawned process on ``cuda:<rank>``): each
    of ``archs`` at full width and depth (SERVE_SEEDS) through
    ``ServeEngine(mesh=...)``, fused and gathered, on the smoke queue;
    the launches and collectives of each run, each emission's logits
    row held against the one-card reference's (SERVE_REF_DIR) for the
    requests this rank's data group served (``check_dense_streams``),
    the pool bytes, the collectives of one steady decode wave and its
    milliseconds (5 waves). Returns numbers only."""
    import numpy as np
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.kv_pages import state_leaves
    mesh = make_mesh(shape, ("data", "model"), "cuda")
    rank = torch.distributed.get_rank()
    out = {"rank": rank, "device": torch.cuda.current_device(), "runs": {}}
    for arch in archs:
        rcfg = get_config(arch, "decode_32k")
        cfg = rcfg.model
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        params = transformer.init_model(rcfg, seed=SERVE_SEEDS[arch],
                                        device="cuda")
        engines = {route: ServeEngine(rcfg, params, mesh=mesh,
                                      max_batch=MAX_BATCH, page_size=PAGE,
                                      max_len=MAX_LEN, fused=fused)
                   for route, fused in (("fused", True),
                                        ("gathered", False))}
        del params
        gc.collect()
        torch.cuda.empty_cache()
        ref = torch.load(SERVE_REF_DIR / f"{arch}.pt")
        res = {"init_s": time.perf_counter() - t0}
        for route, engine in engines.items():
            be = engine.backend
            reqs = make_queue(np.random.default_rng(SERVE_SEEDS[arch]),
                              cfg.vocab_size)
            reset_serve_counts()
            mesh.reset_counts()
            t1 = time.perf_counter()
            with record_spec_logits() as calls:
                outs = engine.generate(reqs)
                torch.cuda.synchronize()
            wall = time.perf_counter() - t1
            launches = serve_counts()
            colls = {k: list(v) for k, v in mesh.counts.items()}
            st = engine.scheduler.stats
            rows = emitted_rows(_local_calls(calls, be.rows),
                                {r.seed for r in reqs})
            del calls
            streams = [r.output.tolist() for r in outs]
            mine = [i for i, r in enumerate(reqs) if (r.seed, 0) in rows]
            label = f"{cfg.name} {route} {shape} rank {rank}"
            refs = [[ref["rows"][(reqs[i].seed, m)].cuda()
                     for m in range(len(ref["streams"][i]))] for i in mine]
            failed = None
            try:
                matched, worst, div = check_dense_streams(
                    label, [reqs[i] for i in mine],
                    ([np.asarray(streams[i]) for i in mine], rows),
                    ([np.asarray(ref["streams"][i]) for i in mine], refs),
                    label, paged_fused=route == "fused")
            except SystemExit as e:     # reported by the parent, which fails
                failed, matched, worst, div = str(e), -1, -1.0, []
            del rows, refs
            res[route] = {
                "streams": streams, "launches": launches,
                "collectives": colls, "wall_s": wall,
                "waves": st["prefill_calls"] + st["decode_steps"],
                "checked": mine, "matched": matched, "max_gap": worst,
                "failed": failed,
                "divergences": len(div),
                "pool_bytes": sum(t.numel() * t.element_size()
                                  for t in state_leaves(
                                      engine.scheduler.state))}
        be = engines["fused"].backend
        scratch, slots, tok = decode_wave_slots(be)
        for _ in range(2):
            be.step(scratch, slots, tok)
        mesh.reset_counts()
        be.step(scratch, slots, tok)
        res["wave_collectives"] = {k: list(v)
                                   for k, v in mesh.counts.items()}
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(5):
            be.step(scratch, slots, tok)      # reads its tokens back
        res["wave_ms"] = 1e3 * (time.perf_counter() - t1) / 5
        res["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        del engines, be, scratch, ref
        gc.collect()
        torch.cuda.empty_cache()
        out["runs"][arch] = res
    return out


def serve_mesh_phase(card, refs):
    """Phase 5f, with 2 or more cards visible: ``spawn_host_ranks`` NCCL
    ranks serve at each shape of SERVE_MESH_SHAPES that fits the cards
    (``serve_mesh_rank``) against the one-card references ``refs``
    (saved to SERVE_REF_DIR for the ranks, removed after): every rank's
    streams equal, fused and gathered, each emission within DENSE_GAP of
    the one-card engine's (checked on the ranks), each rank's fused
    launches the one-card queue's and its gathered route's none of the
    route kernels (the RMSNorm kernel's the one card's); printed: each
    rank's pool bytes, launches, the collectives of the run and of one
    decode wave by kind and bytes, and a steady decode wave's ms.
    Returns the phase's numbers."""
    import shutil
    import torch
    from repro_torch.launch.hostdev import spawn_host_ranks
    n = torch.cuda.device_count()
    if n < 2:
        print(f"phase 5f: not run: {n} CUDA device visible")
        return None
    SERVE_REF_DIR.mkdir(parents=True, exist_ok=True)
    try:
        for arch, (ref, rows) in refs.items():
            torch.save({"streams": ref["streams"], "rows": rows},
                       SERVE_REF_DIR / f"{arch}.pt")
        out = {}
        for shape, archs in SERVE_MESH_SHAPES:
            if shape[0] * shape[1] > n:
                continue
            t0 = time.perf_counter()
            ranks = spawn_host_ranks(shape[0] * shape[1], serve_mesh_rank,
                                     shape, archs, backend="nccl",
                                     timeout=MESH_SPAWN_S)
            wall = time.perf_counter() - t0
            for arch in archs:
                for route in ("fused", "gathered"):
                    got = [r["runs"][arch][route]["streams"] for r in ranks]
                    if any(g != got[0] for g in got):
                        fail(f"phase 5f {shape} {arch} {route}: the ranks' "
                             "streams differ")
                    for r in ranks:
                        x = r["runs"][arch][route]
                        print(f"[{card}] phase 5f {shape} {arch} {route} "
                              f"rank {r['rank']} (cuda:{r['device']}): "
                              f"streams equal on every rank, "
                              f"{x['matched']}/{len(x['checked'])} of its "
                              f"requests {x['checked']} bitwise the one-card "
                              f"engine's, max gap {x['max_gap']:.4f} (limit "
                              f"{DENSE_GAP:g}), {x['divergences']} near-tie "
                              f"divergences; {x['waves']} waves in "
                              f"{x['wall_s']:.2f} s; pool "
                              f"{x['pool_bytes'] / 2**30:.3f} GiB; launches "
                              f"{x['launches']}; collectives "
                              + mesh_counts_text(x["collectives"])
                              + (f"; FAILED: {x['failed']}" if x["failed"]
                                 else ""))
                # each rank launches one card's kernels, wave for wave;
                # the gathered route none of the fused route's
                ref_n = refs[arch][0]["launches"]
                want = {"fused": ref_n,
                        "gathered": {k: (v if k == "rmsnorm_fwd" else 0)
                                     for k, v in ref_n.items()}}
                for r in ranks:
                    for route in ("fused", "gathered"):
                        got = r["runs"][arch][route]["launches"]
                        if got != want[route]:
                            fail(f"phase 5f {shape} {arch} {route}: rank "
                                 f"{r['rank']} launched {got}, not "
                                 f"{want[route]} (one card's fused queue "
                                 f"{ref_n})")
                for r in ranks:
                    x = r["runs"][arch]
                    print(f"[{card}] phase 5f {shape} {arch} rank "
                          f"{r['rank']}: a steady decode wave (B={MAX_BATCH}"
                          f", contexts {DECODE_LENS}) {x['wave_ms']:.2f} ms "
                          f"(one card in this call "
                          f"{refs[arch][0]['wave_ms']:.2f}); "
                          f"its collectives "
                          + mesh_counts_text(x["wave_collectives"])
                          + f"; peak {x['peak_gib']:.1f} GiB; init "
                          f"{x['init_s']:.1f} s")
                for r in ranks:             # compared: keep the numbers
                    for route in ("fused", "gathered"):
                        r["runs"][arch][route].pop("streams")
            print(f"phase 5f {shape}: {wall:.1f} s wall (spawn, init, "
                  "serving)")
            failed = [x["failed"] for r in ranks for a in archs
                      for x in (r["runs"][a]["fused"],
                                r["runs"][a]["gathered"]) if x["failed"]]
            if failed:
                fail(f"phase 5f {shape}: {failed[0]}")
            out[f"{shape[0]}x{shape[1]}"] = {"ranks": ranks, "wall_s": wall}
        return out
    finally:
        shutil.rmtree(SERVE_REF_DIR, ignore_errors=True)



# -- phase 5g (every run) and --mesh dense: dense decode under a mesh --------
# 5g (every run, one card): first the lse route (the dense route's paged
# kernel with each row's log-sum-exp written, ``paged_flash_attention_lse``)
# against its plain version at row 3d's heads (DENSE_HEADS) over a cache of
# max_len DENSE_LENS cut into LSE_SPLIT slices (the slot b of a case is
# rank b's slice: local lengths index - b max_len / LSE_SPLIT for index in
# LSE_INDICES, so <= 0, inside and past the slice), at decode (S = 1,
# split-KV) and a 256-row chunk (multi-row), bf16 and float32; and at
# zamba2_1p2b's heads over one page of LSE_LONG_ROWS rows (bf16, S = 1,
# local lengths past, inside and before the page). Where a row sees a key
# the output lies within ATTN_TOL of the plain version's and, element by
# element, within LSE_OUT_REL (max|plain| + |plain|) of it (a limit that
# scales with the case: over 10^5 keys the outputs are ~1e-3), and lse
# within LSE_TOL (float32 on both sides: the products' sums in another
# order); out is the plain route's (paged_flash_attention) bit for bit;
# where it sees none the kernel writes 0 and -inf, the plain version the
# mask's uniform average and -1e30: both lse must be <= -1e29 (zero weight
# in the merge). Then the lse route is timed at qwen3's slice of a (1, 4)
# split of max_len 512 (B 4, 128 rows a slot, every row visible) and at
# zamba2's LSE_LONG_ROWS-row slice of a (1, 4) split of ZAMBA_LONG_ROWS,
# beside SDPA's efficient kernel asked for its log-sum-exp on the same
# slice (K/V repeated over the GQA group). Then full-width, full-depth
# qwen3_1p7b dense decode through make_serve_fn(rcfg, mesh) under its
# decode_32k rules (decode_sharding()) on a world-1 NCCL mesh in this
# process: phase 5c's greedy requests, their tokens and every emission's
# logits bitwise 5c's, the same launches a call, no collective. Then the
# same rules at (1, 2) on this one card: two gloo ranks spawned on cuda:0,
# their collectives staged through host memory (host_staged_mesh), the
# cache's rows cut over 'model' (MAX_LEN / 2 a rank), each rank attending
# over its rows through
# the lse route and the partials merged on the heads' owners: every rank's
# tokens equal, each emission within DENSE_GAP of 5c's (a first divergence
# only within DENSE_TIE), the lse route launched once a layer and call.
# --mesh dense (4 cards, NCCL): qwen3_1p7b the same way at
# DENSE_MESH_SHAPES; zamba2_1p2b under its long_500k rules at (1, 4) over
# a ZAMBA_LONG_ROWS-row cache and the Mamba2 state filled from a seed,
# ZAMBA_LONG_NEW tokens decoded from ZAMBA_LONG_ROWS - ZAMBA_LONG_NEW,
# against one card holding the whole cache; qwen3_moe_235b at MOE_SERVE's
# 8 layers under its decode rules (experts and fsdp over 'data') at
# (2, 2), DENSE_MOE_B requests of MOE_PROMPT tokens batched, with 5f's
# routing-flip accounting; mt_marian at (1, 2), ENCDEC_DECODE's batch and
# source; and prefix persistence: a (2, 2) qwen3 engine saves its prefix
# cache after the smoke queue, a fresh (2, 2) engine and a fresh one-card
# engine load the file, each restoring every saved page.
LSE_TOL = {"float32": 1e-4, "bfloat16": 1e-3}
# out per element: |kernel - plain| <= t (max|plain| + |plain|) over a case
LSE_OUT_REL = {"float32": 1e-4, "bfloat16": 1e-2}
LSE_SPLIT = 4
LSE_INDICES = (63, 200, 511)
LSE_LONG_ROWS = 131072
DENSE_MESH_SHAPES = ((1, 2), (1, 4), (2, 2))
ZAMBA_LONG_ROWS = 524288
ZAMBA_LONG_NEW = 64
ZAMBA_FILL_ROWS = 8192          # rows drawn by one generator (its seed)
DENSE_MOE_B, DENSE_MOE_NEW = 2, 16
DENSE_PREFIX = ROOT / "experiments" / "dense_mesh_prefix.npz"
DENSE_MESH_SPAWN_S = 900.0


def lse_counts():
    from repro_torch.kernels import paged_attention as pa
    return {**dense_counts(),
            "paged_flash_attention_lse": pa.paged_flash_attention_lse.launches}


def reset_lse_counts():
    from repro_torch.kernels import paged_attention as pa
    reset_serve_counts()
    reset_train_counts()
    pa.paged_flash_attention_lse.launches = 0


def lse_case(gen, heads, lengths, S, L, dtype):
    """The lse route against its plain version over B = len(lengths)
    pages of L rows (one a slot) at local ``lengths``: (max|out| error
    over the rows that see a key, max|lse| error over them, the largest
    out error over its per-element limit LSE_OUT_REL). Fails where a row
    that sees no key carries lse above -1e29 on either side or an output
    other than 0 from the kernel, where an element of out lies further
    from the plain version's than t (max|plain| + |plain|) (t =
    LSE_OUT_REL of the dtype; the limit scales with the case's outputs,
    which over 10^5 keys are ~1e-3, far under ATTN_TOL), where out is not
    the plain route's (``paged_flash_attention``) bit for bit, or where a
    second launch changes a bit."""
    import torch
    from repro_torch.kernels import paged_attention as pa
    h, hkv, hd = heads
    B = len(lengths)

    def r(*shape):
        return (torch.randn(shape, generator=gen, device="cuda") * 0.5
                ).to(dtype)
    q, pk, pv = r(B, S, h, hd), r(B, L, hkv, hd), r(B, L, hkv, hd)
    table = torch.arange(B, dtype=torch.int32, device="cuda")[:, None]
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    out, lse = pa.paged_flash_attention_lse(q, pk, pv, table, lens)
    out2, lse2 = pa.paged_flash_attention_lse(q, pk, pv, table, lens)
    route = pa.paged_flash_attention(q, pk, pv, table, lens)
    want, want_lse = pa.paged_attention_lse_ref(q, pk, pv, table, lens)
    torch.cuda.synchronize()
    seen = (lens[:, None] + torch.arange(S, device="cuda") >= 0)[
        ..., None].expand(B, S, h)
    label = (f"lse route H={h}/{hkv} hd={hd} L={L} S={S} lengths="
             f"{lengths} {str(dtype).split('.')[1]}")
    if not (torch.equal(out, out2) and torch.equal(lse, lse2)):
        fail(f"{label}: a second launch changed the output")
    if not torch.equal(out, route):
        fail(f"{label}: out is not the plain route's bit for bit")
    blank = ~seen
    if blank.any() and not (bool((lse[blank] <= -1e29).all())
                            and bool((want_lse[blank] <= -1e29).all())
                            and bool((out[blank] == 0).all())):
        fail(f"{label}: a row that sees no key carries weight")
    if not seen.any():
        return 0.0, 0.0, 0.0
    gap = (out.float() - want.float()).abs()[seen]
    plain = want.float().abs()[seen]
    t = LSE_OUT_REL[str(dtype).split(".")[1]]
    rel = (gap / (t * (plain.max() + plain))).max().item()
    if not rel <= 1.0:
        fail(f"{label}: out lies {rel:.3g}x its per-element limit "
             f"{t:g} (max|plain| + |plain|) from the plain version's "
             f"(max|plain| {plain.max().item():.3e})")
    o = gap.max().item()
    ls = (lse - want_lse).abs()[seen].max().item()
    return o, ls, rel


def check_lse_route(gen):
    """Phase 5g's first part (see above): returns {dtype: (out error,
    lse error, out error over its per-element limit)}."""
    import torch
    err = {}

    def keep(dname, o, ls, rel):
        e = err.get(dname, (0.0, 0.0, 0.0))
        err[dname] = (max(e[0], o), max(e[1], ls), max(e[2], rel))

    for heads in DENSE_HEADS:
        for max_len in DENSE_LENS:
            L = max_len // LSE_SPLIT
            for index in LSE_INDICES + (max_len - 1,):
                lengths = [index - b * L for b in range(LSE_SPLIT)]
                for S in (1, 256):
                    for dtype in (torch.bfloat16, torch.float32):
                        dname = str(dtype).split(".")[1]
                        o, ls, rel = lse_case(gen, heads, lengths, S, L,
                                              dtype)
                        if not (o <= ATTN_TOL[dname] and ls <= LSE_TOL[dname]):
                            fail(f"lse route H={heads[0]}/{heads[1]} "
                                 f"max_len={max_len} S={S} {lengths} "
                                 f"{dname}: out {o:.3e} lse {ls:.3e}")
                        keep(dname, o, ls, rel)
    long_lens = ([LSE_LONG_ROWS + 5000], [LSE_LONG_ROWS // 2], [-5])
    for lengths in long_lens:
        o, ls, rel = lse_case(gen, (32, 32, 64), lengths, 1, LSE_LONG_ROWS,
                              torch.bfloat16)
        print(f"lse route H=32/32 hd=64 one page of {LSE_LONG_ROWS} rows "
              f"local length {lengths[0]} bf16: max|out| {o:.3e} (limit "
              f"{ATTN_TOL['bfloat16']:g}; {rel:.3f} of its per-element "
              f"limit), max|lse| {ls:.3e} (limit {LSE_TOL['bfloat16']:g}); "
              f"out the plain route's bit for bit")
        if not (o <= ATTN_TOL["bfloat16"] and ls <= LSE_TOL["bfloat16"]):
            fail("the lse route disagrees with its plain version at "
                 "zamba2's long slice")
        keep("bfloat16", o, ls, rel)
    for dname, (o, ls, rel) in err.items():
        print(f"lse route vs plain over DENSE_HEADS x DENSE_LENS cut in "
              f"{LSE_SPLIT}, local lengths <= 0, inside and past a slice, "
              f"S 1 and 256, {dname}: max|out| {o:.3e} (limit "
              f"{ATTN_TOL[dname]:g}; {rel:.3f} of its per-element limit "
              f"{LSE_OUT_REL[dname]:g} (max|plain| + |plain|)), max|lse| "
              f"{ls:.3e} (limit {LSE_TOL[dname]:g}); out the plain route's "
              f"bit for bit")
    return err


def time_lse_route(gen, flush):
    """The lse route's times at qwen3's (1, 4) slice of max_len 512 and
    zamba2's LSE_LONG_ROWS-row slice (every row visible): kernel (events
    and device time), plain, SDPA's efficient kernel with its
    log-sum-exp on the slice (K/V repeated over the GQA group, no mask:
    every key visible), and the bound (``kernels.paged_attention.cost``:
    q, K/V of the visible keys, out once, the table and lengths, and the
    lse written once)."""
    import torch
    from repro_torch.analysis.roofline import bound_ms
    from repro_torch.kernels import paged_attention as pa
    rows = {}
    for name, (h, hkv, hd), B, L in (("qwen3", (H, HKV, HD), MAX_BATCH,
                                      MAX_LEN // LSE_SPLIT),
                                     ("zamba2", (32, 32, 64), 1,
                                      LSE_LONG_ROWS)):
        def r(*shape):
            return (torch.randn(shape, generator=gen, device="cuda") * 0.5
                    ).to(torch.bfloat16)
        q, pk, pv = r(B, 1, h, hd), r(B, L, hkv, hd), r(B, L, hkv, hd)
        table = torch.arange(B, dtype=torch.int32, device="cuda")[:, None]
        lengths = [L - 1] * B
        lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
        g = h // hkv
        qd = q.transpose(1, 2).contiguous()
        kd = pk.transpose(1, 2).repeat_interleave(g, 1).contiguous()
        vd = pv.transpose(1, 2).repeat_interleave(g, 1).contiguous()

        def kernel():
            return pa.paged_flash_attention_lse(q, pk, pv, table, lens)

        def library():
            return torch.ops.aten._scaled_dot_product_efficient_attention(
                qd, kd, vd, None, True)
        flops, nbytes = pa.cost(1, h, hkv, hd, 2, lengths, 1)
        bound, by = bound_ms(flops, nbytes + B * h * 4)   # + the lse
        row = {"ms": time_ms(kernel, flush=flush),
               "device_ms": device_ms(kernel, 20, flush),
               "plain_ms": time_ms(lambda: pa.paged_attention_lse_ref(
                   q, pk, pv, table, lens), flush=flush),
               "library_ms": time_ms(library, flush=flush),
               "library_device_ms": device_ms(library, 20, flush),
               "bound_ms": bound, "bound_by": by}
        rows[name] = row
        print(f"lse route {name} slice B={B} S=1 H={h}/{hkv} hd={hd} "
              f"rows={L} bf16: kernel {row['ms']:.4f} ms (device "
              f"{row['device_ms']:.4f}), plain {row['plain_ms']:.4f} ms, "
              f"SDPA efficient with its lse {row['library_ms']:.4f} ms "
              f"(device {row['library_device_ms']:.4f}), bound "
              f"{row['bound_ms']:.5f} ms ({by})")
        del q, pk, pv, kd, vd
        torch.cuda.empty_cache()
    return rows


def greedy_stream(step, params, cache, prompt, n_new, xa=None):
    """Greedy decode through a dense step ``step`` (``make_serve_fn``'s):
    the prompt (B, T) by one chunked-prefill call, then ``n_new`` tokens
    fed back (the last one unfed). Returns (tokens (n_new, B), each
    call's logits rows at its last position (B, V), the device seconds a
    decode call took on average after the first)."""
    import torch
    rows, toks = [], []
    with torch.no_grad(), record_decode_logits() as kept:
        nxt, cache = step(params, cache, prompt, *(() if xa is None
                                                   else (xa,)))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(n_new):
            toks.append(nxt[:, 0].tolist())
            if i < n_new - 1:
                nxt, cache = step(params, cache, nxt, *(() if xa is None
                                                        else (xa,)))
        torch.cuda.synchronize()
        per_call = (time.perf_counter() - t0) / max(n_new - 1, 1)
        rows = [lg[:, -1] for lg in kept]
    return toks, rows, per_call


def qwen3_dense_streams(mesh, reqs, device="cuda"):
    """Full-width, full-depth qwen3_1p7b (seed 0, served weights) under
    its decode_32k rules through ``make_serve_fn(rcfg, mesh)`` (None: one
    card), each request alone (B 1, MAX_LEN rows): (streams, logits rows,
    calls, launches, this rank's cache and stored bytes against the
    whole, ms a decode call)."""
    import numpy as np
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import steps
    from repro_torch.models import transformer
    rcfg = get_config("qwen3_1p7b", "decode_32k")
    params = transformer.serving_params(transformer.init_model(
        rcfg, seed=0, device=device), rcfg.model)
    whole_bytes = tree_bytes(params)
    local = params if mesh is None else \
        steps.shard_decode_params(rcfg, mesh, params)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    step = steps.make_serve_fn(rcfg, mesh)
    out = {"streams": [], "rows": [], "calls": 0, "ms": []}
    reset_lse_counts()
    if mesh is not None:
        mesh.reset_counts()
    for r in reqs:
        cache = transformer.init_cache(rcfg, 1, MAX_LEN, device=device,
                                       mesh=mesh)
        prompt = torch.from_numpy(r.prompt.astype(np.int64)).to(device)[None]
        toks, rows, per_call = greedy_stream(step, local, cache, prompt,
                                             r.max_new_tokens)
        out["streams"].append(np.asarray([t[0] for t in toks], np.int32))
        out["rows"].append([x[0] for x in rows])
        out["calls"] += r.max_new_tokens
        out["ms"].append(1e3 * per_call)
    torch.cuda.synchronize()
    out["launches"] = lse_counts()
    out["collectives"] = {} if mesh is None else {
        k: list(v) for k, v in mesh.counts.items()}
    whole_cache = transformer.init_cache(rcfg, 1, MAX_LEN, device="meta")
    out["cache_bytes"] = (tree_bytes(cache), tree_bytes(whole_cache))
    out["stored_bytes"] = (tree_bytes(local), whole_bytes)
    del local, cache
    gc.collect()
    torch.cuda.empty_cache()
    return out


def tree_bytes(tree) -> int:
    from repro_torch.tree import leaves_with_paths
    return sum(t.numel() * t.element_size()
               for _, t in leaves_with_paths(tree))


def host_rows(rows):
    """Logits rows as float32 numpy (a spawned rank returns numbers: a
    tensor would travel as a shared-memory handle its rank takes along
    when it exits)."""
    return [[x.float().cpu().numpy() for x in r] for r in rows]


def host_staged_mesh(shape):
    """A gloo mesh at ``shape`` whose collectives take CUDA tensors,
    staging each through host memory: 5g's ranks share one card, where
    NCCL takes one rank a card. The port's own :class:`Mesh` hands its
    backend the tensors as they are; only this script's one-card split
    builds this one."""
    from repro_torch.launch.mesh import Mesh, make_mesh

    class HostStagedMesh(Mesh):
        def exchange(self, kind, send, recv):
            hs = None if send is None else (send[0].cpu(), send[1])
            hr = None if recv is None else (recv[0].cpu(), recv[1])
            super().exchange(kind, hs, hr)
            if hr is not None:
                recv[0].copy_(hr[0])

        def broadcast(self, kind, t, axis, src_index):
            h = t.cpu()
            super().broadcast(kind, h, axis, src_index)
            return t.copy_(h)

        def all_sum(self, kind, t, axes):
            h = t.cpu()
            super().all_sum(kind, h, axes)
            return t.copy_(h)

        def all_gather(self, kind, t, axis, dim=0):
            return super().all_gather(kind, t.cpu(), axis, dim).to(t.device)

        def reduce_scatter(self, kind, t, axis, dim=0):
            return super().reduce_scatter(kind, t.cpu(), axis,
                                          dim).to(t.device)

        def all_to_all(self, kind, t, axis, dim=0):
            return super().all_to_all(kind, t.cpu(), axis, dim).to(t.device)

    return HostStagedMesh(make_mesh(shape, ("data", "model"),
                                    "cpu").device_mesh)


def dense_split_rank(shape, reqs):
    """One rank of 5g's one-card split (a gloo rank on cuda:0, spawned):
    ``qwen3_dense_streams`` at ``shape`` over :func:`host_staged_mesh`,
    with every stream's logits rows on the host."""
    import torch
    mesh = host_staged_mesh(shape)
    out = qwen3_dense_streams(mesh, reqs)
    out["rows"] = host_rows(out["rows"])
    out["rank"] = torch.distributed.get_rank()
    return out


def hold_dense_streams(label, reqs, got, ref, card):
    """Every rank's streams equal, and each one's logits rows against
    ``ref``'s (phase 5c's dense streams) within DENSE_GAP, a first
    divergence only on a near-tie."""
    import torch
    for r in got:
        if any(not (a == b).all() for a, b in zip(r["streams"],
                                                  got[0]["streams"])):
            fail(f"{label}: the ranks' streams differ")
    res = []
    for r in got:
        rows = {(q.seed, m): torch.as_tensor(ref["rows"][i][m]).to(
                    torch.device("cuda", 0))
                for i, q in enumerate(reqs)
                for m in range(len(ref["rows"][i]))}
        mine = [[torch.as_tensor(x).to(torch.device("cuda", 0)) for x in rs]
                for rs in r["rows"]]
        res.append(check_dense_streams(
            f"{label} rank {r.get('rank', 0)}", reqs,
            ([ref["tokens"][i] for i in range(len(reqs))], rows),
            (r["streams"], mine), card))
    return res


def dense_phase(card, gen, flush):
    """Phase 5g (see above). Returns (the lse route's kernel row, the
    phase's numbers)."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.launch.hostdev import spawn_host_ranks
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer
    t0 = time.perf_counter()
    err = check_lse_route(gen)
    times = time_lse_route(gen, flush)
    gc.collect()
    torch.cuda.empty_cache()
    ref = DENSE_REF["qwen3-1.7b"]
    reqs = [r for r in ref["reqs"] if r.temperature == 0.0]
    ref = {"tokens": ref["tokens"][:len(reqs)],
           "rows": ref["rows"][:len(reqs)], "launches": ref["launches"],
           "calls": ref["calls"]}
    # world-1 NCCL mesh: bitwise 5c's dense oracle
    t1 = time.perf_counter()
    mesh = make_host_mesh("cuda")
    try:
        w1 = qwen3_dense_streams(mesh, reqs)
    finally:
        dist.destroy_process_group()
    from repro_torch.configs.registry import get_config
    depth = transformer.stacked_layer_depth(get_config("qwen3_1p7b",
                                                       "decode_32k"))
    same = all((a == b).all() for a, b in zip(w1["streams"],
                                               ref["tokens"]))
    same_rows = all(torch.equal(x, y) for a, b in zip(w1["rows"],
                                                      ref["rows"])
                    for x, y in zip(a, b, strict=True))
    per_call = {k: v / w1["calls"] for k, v in w1["launches"].items()}
    want_pa = depth
    want_rms = ref["launches"]["rmsnorm_fwd"] / ref["calls"]
    print(f"[{card}] phase 5g, qwen3_1p7b dense decode through "
          f"make_serve_fn(rcfg, world-1 NCCL mesh) under decode_sharding: "
          f"{len(reqs)} greedy requests, tokens "
          f"{'bitwise' if same else 'DIFFER from'} phase 5c's, every "
          f"emission's logits {'bitwise' if same_rows else 'DIFFER'}; "
          f"launches a call {per_call}; collectives "
          f"{w1['collectives'] or 'none'}; "
          f"{time.perf_counter() - t1:.1f} s")
    if not (same and same_rows):
        fail("phase 5g: the world-1 dense step is not bitwise phase 5c's")
    if w1["collectives"] or per_call["paged_flash_attention"] != want_pa \
            or per_call["rmsnorm_fwd"] != want_rms \
            or w1["launches"]["paged_flash_attention_lse"]:
        fail(f"phase 5g: the world-1 dense step launched {w1['launches']} "
             f"or issued {w1['collectives']}")
    gc.collect()
    torch.cuda.empty_cache()
    # (1, 2) on this card: two gloo ranks, the lse route and the merge
    t1 = time.perf_counter()
    ranks = spawn_host_ranks(2, dense_split_rank, (1, 2), reqs,
                             backend="gloo", timeout=DENSE_MESH_SPAWN_S)
    checks = hold_dense_streams("phase 5g (1, 2) on one card", reqs, ranks,
                                ref, card)
    want_lse = depth * ranks[0]["calls"]
    for r in ranks:
        n = r["launches"]["paged_flash_attention_lse"]
        print(f"[{card}] phase 5g (1, 2) on one card rank {r['rank']}: "
              f"cache {r['cache_bytes'][0] / 2**20:.1f} MiB of "
              f"{r['cache_bytes'][1] / 2**20:.1f}, stored "
              f"{r['stored_bytes'][0] / 2**30:.3f} GiB of "
              f"{r['stored_bytes'][1] / 2**30:.3f}; launches "
              f"{r['launches']}; collectives "
              + mesh_counts_text(r["collectives"])
              + f"; ms a decode call {np.mean(r['ms']):.2f} (one card, "
              f"world-1 mesh {np.mean(w1['ms']):.2f})")
        if n != want_lse or r["launches"]["paged_flash_attention"]:
            fail(f"phase 5g (1, 2): rank {r['rank']} launched the lse route "
                 f"{n} times (want {want_lse}) or the plain route")
    print(f"phase 5g: {time.perf_counter() - t0:.1f} s ((1, 2) on one "
          f"card {time.perf_counter() - t1:.1f} s)")
    row = {
        "name": "paged_flash_attention_lse", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
        "replaces": "src/repro/kernels/paged_attention.py:88",
        # launches: phase 5g's (1, 2) split on one card (rank 0, the
        # dense decode of 5c's greedy requests); ms/plain_ms/library_ms
        # at qwen3's (1, 4) slice of max_len 512, zamba2_* at zamba2's
        # LSE_LONG_ROWS-row slice; max_abs_err bf16 out, lse_max_abs_err
        # bf16 lse, f32_* float32
        "launches": ranks[0]["launches"]["paged_flash_attention_lse"],
        "max_abs_err": err["bfloat16"][0],
        "lse_max_abs_err": err["bfloat16"][1],
        "f32_max_abs_err": err["float32"][0],
        "f32_lse_max_abs_err": err["float32"][1],
        **times["qwen3"], **{f"zamba2_{k}": v for k, v in
                             times["zamba2"].items()}}
    res = {"world1": {"streams_equal": same, "logits_equal": same_rows,
                      "ms": w1["ms"], "launches": w1["launches"]},
           "split_1x2": [{k: r[k] for k in ("launches", "collectives",
                                            "cache_bytes", "stored_bytes",
                                            "ms")} for r in ranks],
           "split_checks": checks, "lse_err": err,
           "wall_s": time.perf_counter() - t0}
    return row, res


def zamba2_long_fill(cache, rcfg, mesh):
    """Fill a zamba2_1p2b dense cache of ZAMBA_LONG_ROWS rows (this
    rank's part under ``mesh``; the whole cache without) from seeds: the
    attention K/V a block of ZAMBA_FILL_ROWS rows a generator (so that
    each rank draws only its rows and the ranks' rows together are the
    whole cache's), the Mamba2 conv window and state whole then cut; the
    index at ZAMBA_LONG_ROWS - ZAMBA_LONG_NEW."""
    import torch
    from repro_torch.models import transformer
    from repro_torch.parallel import params as pparams
    from repro_torch.parallel import tp
    from repro_torch.tree import leaf_at
    attn, mamba = cache["attn"], cache["mamba"]
    L = attn["k"].shape[2]
    off = 0
    if mesh is not None:
        with tp.active(mesh, rcfg.sharding):
            seq = tp.seq_split(ZAMBA_LONG_ROWS)
        off = seq.offset if seq else 0
    gen = torch.Generator(device="cuda")
    for layer in range(attn["k"].shape[0]):
        for c in range(L // ZAMBA_FILL_ROWS):
            blk = (off + c * ZAMBA_FILL_ROWS) // ZAMBA_FILL_ROWS
            rows = slice(c * ZAMBA_FILL_ROWS, (c + 1) * ZAMBA_FILL_ROWS)
            for j, name in enumerate(("k", "v")):
                gen.manual_seed(1_000_000 * (j + 1) + 1000 * layer + blk)
                t = attn[name][layer, :, rows]
                t.copy_(torch.randn(t.shape, generator=gen, device="cuda")
                        * 0.5)
    whole = transformer.init_cache(rcfg, 1, ZAMBA_LONG_ROWS, device="meta")
    specs = pparams.cache_specs(whole, rcfg, mesh) if mesh else None
    for name, scale, seed in (("conv", 0.5, 7), ("h", 0.1, 8)):
        gen.manual_seed(seed)
        full = torch.randn(whole["mamba"][name].shape, generator=gen,
                           device="cuda") * scale
        if mesh is not None:
            full = pparams.local_slice(
                full, ("mamba", name), leaf_at(specs, ("mamba", name)),
                mesh, executed=pparams.DECODE_EXECUTED, cfg=rcfg.model,
                logical=pparams.cache_logical)
        mamba[name].copy_(full)
    attn["index"].fill_(ZAMBA_LONG_ROWS - ZAMBA_LONG_NEW)


def zamba2_long_streams(mesh):
    """zamba2_1p2b (seed 1, served weights) under its long_500k rules:
    the filled cache (``zamba2_long_fill``), ZAMBA_LONG_NEW greedy
    tokens a call from a seeded token (B 1): (tokens, logits rows, ms a
    decode call, launches, collectives, cache bytes a rank and whole)."""
    import numpy as np
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import steps
    from repro_torch.models import transformer
    rcfg = get_config("zamba2_1p2b", "long_500k")
    params = transformer.serving_params(transformer.init_model(
        rcfg, seed=1, device="cuda"), rcfg.model)
    local = params if mesh is None else \
        steps.shard_decode_params(rcfg, mesh, params)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    cache = transformer.init_cache(rcfg, 1, ZAMBA_LONG_ROWS, device="cuda",
                                   mesh=mesh)
    zamba2_long_fill(cache, rcfg, mesh)
    start = torch.from_numpy(np.random.default_rng(9).integers(
        0, rcfg.model.vocab_size, (1, 1))).cuda()
    reset_lse_counts()
    if mesh is not None:
        mesh.reset_counts()
    toks, rows, per_call = greedy_stream(steps.make_serve_fn(rcfg, mesh),
                                         local, cache, start,
                                         ZAMBA_LONG_NEW)
    whole = transformer.init_cache(rcfg, 1, ZAMBA_LONG_ROWS, device="meta")
    out = {"streams": [np.asarray([t[0] for t in toks], np.int32)],
           "rows": host_rows([[x[0] for x in rows]]),
           "ms": [1e3 * per_call],
           "launches": lse_counts(),
           "collectives": {} if mesh is None else {
               k: list(v) for k, v in mesh.counts.items()},
           "cache_bytes": (tree_bytes(cache), tree_bytes(whole)),
           "calls": ZAMBA_LONG_NEW}
    del cache, local
    gc.collect()
    torch.cuda.empty_cache()
    return out


def moe_dense_streams(mesh):
    """qwen3_moe_235b at MOE_SERVE's depth (seed 23) under its decode
    rules: DENSE_MOE_B greedy requests' prompts (MOE_PROMPT tokens)
    batched through ``make_serve_fn(rcfg, mesh)``, DENSE_MOE_NEW tokens;
    this rank's slots' logits rows and routing plans: (tokens (B lists),
    rows by slot, routes by slot, ms a call, launches, collectives,
    stored bytes a rank and whole)."""
    import numpy as np
    import torch
    from repro_torch.launch import steps
    from repro_torch.models import transformer
    from repro_torch.parallel import tp
    rcfg = moe_serve_config("qwen3_moe_235b")
    params = transformer.serving_params(transformer.init_model(
        rcfg, seed=23, device="cuda"), rcfg.model)
    whole_bytes = tree_bytes(params)
    local = params if mesh is None else \
        steps.shard_decode_params(rcfg, mesh, params)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    reqs = moe_requests(np.random.default_rng(23), rcfg.model.vocab_size,
                        DENSE_MOE_B, False)
    prompt = torch.from_numpy(np.stack([r.prompt for r in reqs]).astype(
        np.int64)).cuda()
    cache = transformer.init_cache(rcfg, DENSE_MOE_B, MAX_LEN,
                                   device="cuda", mesh=mesh)
    slots = list(range(DENSE_MOE_B))
    if mesh is not None:
        with tp.active(mesh, rcfg.sharding):
            sp = tp.split("batch", DENSE_MOE_B)
        if sp is not None:
            per = DENSE_MOE_B // sp.n
            slots = slots[sp.r * per:(sp.r + 1) * per]
    reset_lse_counts()
    if mesh is not None:
        mesh.reset_counts()
    with record_routes() as plans:
        toks, rows, per_call = greedy_stream(
            steps.make_serve_fn(rcfg, mesh), local, cache, prompt,
            DENSE_MOE_NEW)
    depth = transformer.stacked_layer_depth(rcfg)
    out = {"tokens": toks, "slots": slots,
           "rows": {b: host_rows([[x[i] for x in rows]])[0]
                    for i, b in enumerate(slots)},
           "routes": {b: dense_routes(plans, depth, MOE_PROMPT, i)
                      for i, b in enumerate(slots)},
           "seeds": [r.seed for r in reqs], "ms": [1e3 * per_call],
           "launches": lse_counts(),
           "collectives": {} if mesh is None else {
               k: list(v) for k, v in mesh.counts.items()},
           "stored_bytes": (tree_bytes(local), whole_bytes)}
    del cache, local, plans
    gc.collect()
    torch.cuda.empty_cache()
    return out


def marian_dense_streams(mesh):
    """mt_marian (seed 3, served weights) under decode_sharding():
    ENCDEC_DECODE's batch and source through its encoder (whole weights,
    on every rank), then ENCDEC_NEW greedy tokens through
    ``make_serve_fn(rcfg, mesh)`` with ``xa``: (tokens, rows, ms a call,
    launches, collectives)."""
    import numpy as np
    import torch
    from repro_torch.configs.registry import decode_sharding, get_config
    from repro_torch.launch import steps
    from repro_torch.models import transformer
    arch, B, S_src = ENCDEC_DECODE[0]
    rcfg = get_config(arch).replace(sharding=decode_sharding())
    params = transformer.serving_params(transformer.init_model(
        rcfg, seed=3, device="cuda"), rcfg.model)
    rng = np.random.default_rng(3)
    V = rcfg.model.vocab_size
    batch = {"src_tokens": torch.from_numpy(
        rng.integers(0, V, (B, S_src))).cuda()}
    start = torch.from_numpy(rng.integers(0, V, (B, 1))).cuda()
    with torch.no_grad():
        xa, _ = transformer.encode(params, batch, rcfg)
    local = params if mesh is None else \
        steps.shard_decode_params(rcfg, mesh, params)
    del params
    gc.collect()
    cache = transformer.init_cache(rcfg, B, ENCDEC_NEW, device="cuda",
                                   mesh=mesh)
    reset_lse_counts()
    if mesh is not None:
        mesh.reset_counts()
    toks, rows, per_call = greedy_stream(steps.make_serve_fn(rcfg, mesh),
                                         local, cache, start, ENCDEC_NEW,
                                         xa=xa)
    out = {"tokens": toks,
           "rows": [x.float().cpu().numpy() for x in rows],
           "ms": [1e3 * per_call], "launches": lse_counts(),
           "collectives": {} if mesh is None else {
               k: list(v) for k, v in mesh.counts.items()}}
    del cache, local, xa
    gc.collect()
    torch.cuda.empty_cache()
    return out


def prefix_mesh_run(mesh):
    """A (2, 2) qwen3_1p7b engine (seed 0) serves the smoke queue, each
    emission's logits row recorded, and saves its prefix cache to
    DENSE_PREFIX; a fresh engine on the same mesh loads it and serves
    the queue again: (pages saved, restored, streams of both runs, and
    on a rank of model index 0 its data group's rows of the first run,
    float32 on the host, by (seed, emission index))."""
    import numpy as np
    from repro_torch.configs.registry import get_config
    from repro_torch.models import transformer
    from repro_torch.serve.engine import ServeEngine
    rcfg = get_config("qwen3_1p7b", "decode_32k")
    params = transformer.init_model(rcfg, seed=0, device="cuda")
    kw = dict(mesh=mesh, max_batch=MAX_BATCH, page_size=PAGE,
              max_len=MAX_LEN, device="cuda")
    eng = ServeEngine(rcfg, params, **kw)
    V = rcfg.model.vocab_size
    queue = make_queue(np.random.default_rng(0), V)
    with record_spec_logits() as calls:
        first = [r.output.tolist() for r in eng.generate(queue)]
    rows = {}
    if mesh.index("model") == 0:
        rows = {k: v.float().cpu().numpy() for k, v in emitted_rows(
            _local_calls(calls, eng.backend.rows),
            {r.seed for r in queue}).items()}
    del calls
    mesh.reset_counts()
    saved = eng.save_prefix_cache(str(DENSE_PREFIX))
    save_colls = {k: list(v) for k, v in mesh.counts.items()}
    del eng
    gc.collect()
    fresh = ServeEngine(rcfg, params, prefix_cache_path=str(DENSE_PREFIX),
                        **kw)
    restored = fresh.scheduler.prefix.n_cached_pages
    again = [r.output.tolist() for r in fresh.generate(
        make_queue(np.random.default_rng(0), V))]
    return {"saved": saved, "restored": restored, "first": first,
            "again": again, "first_rows": rows,
            "shared": int(fresh.scheduler.stats["shared_tokens"]),
            "save_collectives": save_colls}


def dense_mesh_rank(shape, runs):
    """One rank of --mesh dense (an NCCL rank on ``cuda:<rank>``): each
    of ``runs`` at ``shape``; logits rows on the host."""
    import torch
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh(shape, ("data", "model"), "cuda")
    out = {"rank": torch.distributed.get_rank()}
    for name in runs:
        t0 = time.perf_counter()
        if name == "qwen3":
            reqs = dense_mesh_requests()
            r = qwen3_dense_streams(mesh, reqs)
            r["rows"] = host_rows(r["rows"])
        elif name == "zamba2":
            r = zamba2_long_streams(mesh)
        elif name == "moe":
            r = moe_dense_streams(mesh)
        elif name == "marian":
            r = marian_dense_streams(mesh)
        else:
            r = prefix_mesh_run(mesh)
        r["wall_s"] = time.perf_counter() - t0
        out[name] = r
        gc.collect()
        torch.cuda.empty_cache()
    return out


def dense_mesh_requests():
    """The smoke queue's first DENSE_REQS greedy requests (seed 0), as
    phase 5c serves them."""
    import numpy as np
    from repro_torch.configs.registry import get_config
    queue = make_queue(np.random.default_rng(0), get_config(
        "qwen3_1p7b", "decode_32k").model.vocab_size)
    return [r for r in queue if r.temperature == 0.0][:DENSE_REQS]


def rows_check(label, toks_ref, rows_ref, toks, rows, card):
    """Greedy streams of one slot against one card's: logits within
    DENSE_GAP at every shared position, a first divergence only where the
    mesh's token lies within DENSE_TIE of one card's top logit. Returns
    (max gap, divergence or None)."""
    import torch
    worst = 0.0
    for m, (a, b) in enumerate(zip(toks_ref, toks, strict=True)):
        gap = _row_gap(torch.as_tensor(rows_ref[m]).float(),
                       torch.as_tensor(rows[m]).float())
        worst = max(worst, gap)
        if gap > DENSE_GAP:
            fail(f"{label} token {m}: logits {gap:.4f} from one card's "
                 f"(limit {DENSE_GAP:g})")
        if a != b:
            row = torch.as_tensor(rows_ref[m]).float()
            margin = (row.max() - row[b]).item()
            print(f"[{card}] {label}: first divergence at token {m} ({a} "
                  f"one card, {b} the mesh), margin {margin:.4f} (limit "
                  f"{DENSE_TIE:g})")
            if margin > DENSE_TIE:
                fail(f"{label}: a divergence away from a near-tie")
            return worst, m
    return worst, None


def prefix_check(card, p):
    """--mesh dense's prefix part, from the (2, 2) ranks' ``prefix_mesh_run``
    results ``p``: every rank saved and restored the same pages and
    served the same streams; a fresh one-card engine loads the file
    (every page) and serves the smoke queue, held to the (2, 2) engine's
    first run (``check_dense_streams``). Returns the numbers."""
    import numpy as np
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.models import transformer
    from repro_torch.serve.engine import ServeEngine
    if any(x["saved"] != x["restored"] for x in p) or \
            any(x["first"] != p[0]["first"] for x in p):
        fail(f"--mesh dense prefix: saved {[x['saved'] for x in p]}"
             f" restored {[x['restored'] for x in p]}, or the "
             "ranks' streams differ")
    rcfg = get_config("qwen3_1p7b", "decode_32k")
    params = transformer.init_model(rcfg, seed=0, device="cuda")
    one = ServeEngine(rcfg, params, max_batch=MAX_BATCH,
                      page_size=PAGE, max_len=MAX_LEN,
                      prefix_cache_path=str(DENSE_PREFIX),
                      device="cuda")
    restored = one.scheduler.prefix.n_cached_pages
    if restored != p[0]["saved"]:
        fail("--mesh dense prefix: the one-card engine restored "
             f"{restored} of {p[0]['saved']} pages")
    queue = make_queue(np.random.default_rng(0), rcfg.model.vocab_size)
    with record_spec_logits() as calls:
        again = [r.output.tolist() for r in one.generate(queue)]
        torch.cuda.synchronize()
    one_rows = emitted_rows(calls, {r.seed for r in queue})
    del one, params, calls
    DENSE_PREFIX.unlink(missing_ok=True)
    same = sum(a == b for a, b in zip(again, p[0]["first"]))
    # the one-card engine that loaded the (2, 2) engine's pages, held to
    # that engine's first run: logits within DENSE_GAP at every shared
    # position, a first divergence only on a near-tie (DENSE_TIE;
    # sampled: of the perturbed scores)
    mesh_rows = {k: v for x in p for k, v in x["first_rows"].items()}
    matched, worst, div = check_dense_streams(
        "--mesh dense prefix, one card from the (2, 2) file",
        queue, ([np.asarray(a) for a in again], one_rows),
        ([np.asarray(a) for a in p[0]["first"]],
         [[torch.as_tensor(mesh_rows[(q.seed, m)]).cuda()
           for m in range(len(p[0]["first"][i]))]
          for i, q in enumerate(queue)]), card)
    del one_rows, mesh_rows
    print(f"[{card}] --mesh dense prefix: one card vs the (2, 2) "
          f"engine: {matched}/8 streams bitwise, max logit gap "
          f"{worst:.4f} (limit {DENSE_GAP:g}), {len(div)} "
          "divergences, each on a near-tie or a mask's edge: "
          + "; ".join(f"request {d['request']} token {d['token']} "
                      f"margin {d['margin']:.4f}"
                      + (" (sampled)" if d["sampled"] else "")
                      + (" (mask edge)" if d["mask_edge"] else "")
                      for d in div))
    print(f"[{card}] --mesh dense prefix: a (2, 2) engine saved "
          f"{p[0]['saved']} pages (collectives "
          + mesh_counts_text(p[0]["save_collectives"])
          + f"); a fresh (2, 2) engine restored "
          f"{p[0]['restored']} ({p[0]['shared']} shared tokens "
          f"serving the queue again, "
          f"{sum(a == b for a, b in zip(p[0]['again'], p[0]['first']))}"
          f"/8 streams as before), a fresh one-card engine "
          f"{restored} ({same}/8 streams as the (2, 2) engine's "
          f"first run)")
    for x in p:
        x.pop("first_rows")
    return {"saved": p[0]["saved"], "restored": [p[0]["restored"], restored],
            "same_streams": same, "max_gap": worst, "divergences": div}


def dense_mesh_phase(card):
    """--mesh dense (see above), with 4 cards visible: the one-card
    references in this process, then NCCL ranks at each shape."""
    import numpy as np
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.hostdev import spawn_host_ranks
    from repro_torch.models import transformer
    from repro_torch.serve.engine import ServeEngine
    n = torch.cuda.device_count()
    if n < 4:
        print(f"--mesh dense: not run: {n} CUDA devices visible (needs 4)")
        return None
    t0 = time.perf_counter()
    DENSE_PREFIX.parent.mkdir(parents=True, exist_ok=True)
    reqs = dense_mesh_requests()
    ref = {"qwen3": qwen3_dense_streams(None, reqs)}
    ref["qwen3"]["rows"] = host_rows(ref["qwen3"]["rows"])
    for name, fn in (("zamba2", lambda: zamba2_long_streams(None)),
                     ("moe", lambda: moe_dense_streams(None)),
                     ("marian", lambda: marian_dense_streams(None))):
        t1 = time.perf_counter()
        ref[name] = fn()
        print(f"[{card}] --mesh dense one-card reference {name}: "
              f"{time.perf_counter() - t1:.1f} s, ms a decode call "
              f"{np.mean(ref[name]['ms']):.2f}; launches "
              f"{ref[name]['launches']}")
        gc.collect()
        torch.cuda.empty_cache()
    out = {"reference_ms": {k: v["ms"] for k, v in ref.items()}}
    plan = (((1, 2), ("qwen3", "marian")), ((1, 4), ("qwen3", "zamba2")),
            ((2, 2), ("qwen3", "moe", "prefix")))
    for shape, runs in plan:
        t1 = time.perf_counter()
        ranks = spawn_host_ranks(4 if shape != (1, 2) else 2,
                                 dense_mesh_rank, shape, runs,
                                 backend="nccl", timeout=DENSE_MESH_SPAWN_S)
        key = f"{shape[0]}x{shape[1]}"
        res = {}
        q = [r["qwen3"] for r in ranks]
        checks = hold_dense_streams(f"--mesh dense qwen3 {shape}", reqs, q,
                                    {"tokens": ref["qwen3"]["streams"],
                                     "rows": ref["qwen3"]["rows"]}, card)
        res["qwen3"] = {"checks": checks, "ranks": [
            {k: r[k] for k in ("launches", "collectives", "cache_bytes",
                               "stored_bytes", "ms", "wall_s")} for r in q]}
        for r in q:
            print(f"[{card}] --mesh dense qwen3 {shape} rank: cache "
                  f"{r['cache_bytes'][0] / 2**20:.1f} MiB of "
                  f"{r['cache_bytes'][1] / 2**20:.1f}, stored "
                  f"{r['stored_bytes'][0] / 2**30:.3f} GiB of "
                  f"{r['stored_bytes'][1] / 2**30:.3f}; ms a decode call "
                  f"{np.mean(r['ms']):.2f} (one card "
                  f"{np.mean(ref['qwen3']['ms']):.2f}); launches "
                  f"{r['launches']}; collectives a run "
                  + mesh_counts_text(r["collectives"]))
        if "zamba2" in runs:
            z = [r["zamba2"] for r in ranks]
            gaps = []
            for i, r in enumerate(z):
                if not np.array_equal(r["streams"][0], z[0]["streams"][0]):
                    fail("--mesh dense zamba2: the ranks' tokens differ")
                gaps.append(rows_check(
                    f"--mesh dense zamba2 {shape} rank {i}",
                    ref["zamba2"]["streams"][0].tolist(),
                    ref["zamba2"]["rows"][0], r["streams"][0].tolist(),
                    r["rows"][0], card))
                print(f"[{card}] --mesh dense zamba2_1p2b long_500k {shape} "
                      f"rank {i}: {ZAMBA_LONG_NEW} tokens from index "
                      f"{ZAMBA_LONG_ROWS - ZAMBA_LONG_NEW}, max gap "
                      f"{gaps[-1][0]:.4f} (limit {DENSE_GAP:g}); cache "
                      f"{r['cache_bytes'][0] / 2**30:.3f} GiB of "
                      f"{r['cache_bytes'][1] / 2**30:.3f} (one card); ms a "
                      f"decode call {r['ms'][0]:.2f} (one card "
                      f"{ref['zamba2']['ms'][0]:.2f}); launches "
                      f"{r['launches']}; collectives "
                      + mesh_counts_text(r["collectives"]))
                if 4 * r["cache_bytes"][0] > r["cache_bytes"][1] + 2**20:
                    fail("--mesh dense zamba2: a rank holds more than a "
                         "quarter of the cache")
            res["zamba2"] = {"gaps": gaps, "ranks": [
                {k: r[k] for k in ("launches", "collectives",
                                   "cache_bytes", "ms", "wall_s")}
                for r in z]}
        if "moe" in runs:
            m = [r["moe"] for r in ranks]
            mref = ref["moe"]
            if any(r["tokens"] != m[0]["tokens"] for r in m):
                fail("--mesh dense qwen3-moe: the ranks' tokens differ")
            reqs_m = [dataclasses.replace(dense_mesh_requests()[0],
                                          seed=s, prompt=np.zeros(
                                              MOE_PROMPT, np.int32),
                                          max_new_tokens=DENSE_MOE_NEW)
                      for s in mref["seeds"]]
            tallies = []
            for i, r in enumerate(m):
                for b in r["slots"]:
                    allow, tally = moe_allowance(
                        {reqs_m[b].seed: mref["routes"][b]},
                        {reqs_m[b].seed: r["routes"][b]}, MOE_PROMPT)
                    rows_ref = {(reqs_m[b].seed, k): torch.as_tensor(x).cuda()
                                for k, x in enumerate(mref["rows"][b])}
                    check_dense_streams(
                        f"--mesh dense qwen3-moe {shape} rank {i} slot {b}",
                        [reqs_m[b]],
                        ([np.asarray([t[b] for t in mref["tokens"]])],
                         rows_ref),
                        ([np.asarray([t[b] for t in r["tokens"]])],
                         [[torch.as_tensor(x).cuda()
                           for x in r["rows"][b]]]),
                        card, allow=allow)
                    tallies.append(tally)
                print(f"[{card}] --mesh dense qwen3-moe {shape} rank {i}: "
                      f"stored {r['stored_bytes'][0] / 2**30:.2f} GiB of "
                      f"{r['stored_bytes'][1] / 2**30:.2f}; ms a decode "
                      f"call {r['ms'][0]:.2f} (one card {mref['ms'][0]:.2f})"
                      f"; routing {tallies[-1]}; collectives "
                      + mesh_counts_text(r["collectives"]))
            res["moe"] = {"tallies": tallies, "ranks": [
                {k: r[k] for k in ("launches", "collectives", "stored_bytes",
                                   "ms", "wall_s")} for r in m]}
        if "marian" in runs:
            a = [r["marian"] for r in ranks]
            mref = ref["marian"]
            gaps = []
            for i, r in enumerate(a):
                if r["tokens"] != a[0]["tokens"]:
                    fail("--mesh dense mt_marian: the ranks' tokens differ")
                for b in range(len(mref["tokens"][0])):
                    gaps.append(rows_check(
                        f"--mesh dense mt_marian {shape} rank {i} slot {b}",
                        [t[b] for t in mref["tokens"]],
                        [x[b] for x in mref["rows"]],
                        [t[b] for t in r["tokens"]],
                        [x[b] for x in r["rows"]], card))
                print(f"[{card}] --mesh dense mt_marian {shape} rank {i}: "
                      f"max gap {max(g for g, _ in gaps):.4f}, "
                      f"{sum(d is not None for _, d in gaps)} near-tie "
                      f"divergences; ms a decode call {r['ms'][0]:.2f} (one "
                      f"card {mref['ms'][0]:.2f}); collectives "
                      + mesh_counts_text(r["collectives"]))
            res["marian"] = {"max_gap": max(g for g, _ in gaps)}
        if "prefix" in runs:
            res["prefix"] = prefix_check(card, [r["prefix"] for r in ranks])
        res["wall_s"] = time.perf_counter() - t1
        print(f"--mesh dense {shape}: {res['wall_s']:.1f} s")
        out[key] = res
    out["wall_s"] = time.perf_counter() - t0
    return out


# -- the MoE expert axis under a mesh (phases 5e, 5f, 6d, 6e) ---------------
# Every run: phase 5e also serves qwen3-moe (MOE_SERVE's 8 layers, seed
# 23) through a world-1 NCCL mesh, and phase 6e trains the reduced
# qwen3-moe two steps through one: streams, a decode step's logits, the
# losses and every param leaf's sha256 bitwise phase 5d's engine and
# Trainer, no collective issued. With --mesh (2+ cards): 5f serves
# qwen3-moe at MOE_SERVE_SHAPES (the experts over 'data' where named;
# the expert d_ff over 'model' wherever it has 2 ranks) on the MoE queue
# (MOE_MESH_REQS greedy requests and a sampled one, prompts cut to
# MOE_PROMPT; prefix sharing off, as 5d's comparisons: every position's
# routes are recorded), every rank's streams equal, each emission within DENSE_GAP
# of one card's with the routing-flip accounting (MOE_FLIP_MARGIN /
# MOE_FLIP_GAP), each rank's launches one card's; 6d holds the
# full-width qwen3-moe gradient at MOE_GRAD_LAYERS (B MOE_MESH_B, one row
# a rank at (4, 1)) at (2, 1) and (4, 1), the experts over 'data', to
# one card's with its routing replayed (each rank its rows of the
# recorded plans), then trains full-width qwen3-moe at (4, 1) for
# MOE_MESH_STEPS steps at the deepest depth its reckoning fits.
MOE_MESH_B = 4
MOE_MESH_STEPS = 2
MOE_MESH_REQS = 3
MOE_SERVE_SHAPES = (((1, 2), None), ((2, 1), "data"), ((2, 2), "data"))
# the full-width Trainer's reckoning a rank: 16 B a parameter with float32
# AdamW moments (bf16 param and gradient, float32 master, m and v), 12
# with bf16 moments, plus MOE_ACT_GIB for a step's activations (the
# 6d gradient check at one row a rank peaked 8.2 GB above its params and
# gradient on an H100), within MOE_FIT of the card (the rest for the
# CUDA context, NCCL's buffers and the allocator's slack: at 75.4 GB
# reckoned with 4 GiB of activations, float32 moments at 5 layers did
# not finish two steps in 600 s)
MOE_STATE_BYTES = {"float32": 16, "bfloat16": 12}
MOE_ACT_GIB, MOE_FIT = 10.0, 0.9
MOE_TRAIN_SPAWN_S = 300.0


def queue_run(engine, reqs):
    """``reqs`` through ``engine``: the streams and launches (counters
    set to 0 just before, read just after)."""
    import torch
    reset_serve_counts()
    out = engine.generate(reqs)
    torch.cuda.synchronize()
    return [r.output.tolist() for r in out], serve_counts()


def world1_moe_serve(card):
    """Phase 5e, qwen3-moe: MOE_SERVE's 8 layers (seed 23) through
    ``ServeEngine(mesh=make_host_mesh())`` on a world-1 NCCL group of
    this process, on the smoke queue: the streams, one decode step's
    logits and the queue's launches must be those of phase 5d's second
    engine (``MOE_REF``), and no collective issued. Returns its
    numbers."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer
    from repro_torch.serve.engine import ServeEngine
    ref = MOE_REF["qwen3_moe_235b"]
    t0 = time.perf_counter()
    rcfg = moe_serve_config("qwen3_moe_235b")
    mesh = make_host_mesh("cuda")
    try:
        params = transformer.init_model(rcfg, seed=23, device="cuda")
        engine = ServeEngine(rcfg, params, mesh=mesh, max_batch=MAX_BATCH,
                             page_size=PAGE, max_len=MAX_LEN, device="cuda")
        del params
        mesh.reset_counts()
        streams, launches = queue_run(engine, make_queue(
            np.random.default_rng(23), rcfg.model.vocab_size))
        logits = decode_step_logits(engine.backend)
        colls = {k: list(v) for k, v in mesh.counts.items()}
        del engine
    finally:
        dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    same = streams == ref["streams"]
    same_logits = torch.equal(logits, ref["logits"])
    wall = time.perf_counter() - t0
    print(f"[{card}] phase 5e, {rcfg.model.name} ({MOE_SERVE['qwen3_moe_235b'][0]}"
          f" layers) served through a world-1 NCCL mesh, the smoke queue "
          f"({len(streams)} requests): streams "
          f"{'bitwise' if same else 'DIFFER from'} phase 5d's engine's; one "
          f"decode step's logits {'bitwise' if same_logits else 'DIFFER'}; "
          f"launches {launches} (5d {ref['launches']}); collectives "
          f"{colls or 'none'}; {wall:.1f} s")
    if not same or not same_logits:
        fail("phase 5e: the world-1 mesh engine of qwen3-moe is not bitwise "
             "phase 5d's")
    if colls or launches != ref["launches"]:
        fail(f"phase 5e: the world-1 qwen3-moe engine issued collectives "
             f"{colls} or launched {launches}, not 5d's {ref['launches']}")
    return {"streams_equal": same, "logits_equal": same_logits,
            "launches": launches, "wall_s": wall}


def world1_moe_train(card):
    """Phase 6e: the reduced qwen3-moe (``moe_reduced_train_config``)
    trained MESH_STEPS steps through ``Trainer(mesh=make_host_mesh())``
    on a world-1 NCCL group of this process: the losses and every param
    leaf's sha256 must equal phase 5d's Trainer after the same steps
    (``MOE_REF["train"]``), no collective issued, the training kernels
    launched. Returns its numbers."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    want = MOE_REF["train"]
    t0 = time.perf_counter()
    mesh = make_host_mesh("cuda")
    try:
        res, trainer = mesh_train(mesh, "cuda", moe_reduced_train_config())
        digest = state_digest(trainer.params,
                              {"step": trainer.opt_state["step"]})
        del trainer
    finally:
        dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    same = res["losses"] == want["losses"] and digest == want["digest"]
    colls = [c for c in res["collectives"] if c]
    wall = time.perf_counter() - t0
    print(f"[{card}] phase 6e, reduced qwen3-moe through a world-1 NCCL "
          f"mesh: losses {res['losses']} vs 5d's {want['losses']}; "
          f"{len(digest) - 1} param leaf digests "
          + ("all equal (bitwise)" if same else "DIFFER")
          + f"; collectives {colls or 'none'}; launches {res['launches']}; "
          f"kept whole {res['kept_whole']}; {wall:.1f} s")
    if not same:
        fail("phase 6e: the world-1 mesh Trainer of qwen3-moe is not bitwise "
             "phase 5d's")
    if colls or min(res["launches"][k] for k in (
            "flash_attention_fwd", "flash_attention_bwd", "rmsnorm_fwd",
            "rmsnorm_bwd")) <= 0:
        fail(f"phase 6e: collectives {colls} issued or a training kernel "
             f"never launched: {res['launches']}")
    return {**res, "bitwise": same, "wall_s": wall}


@contextlib.contextmanager
def replay_expert_rows(experts, lo, hi):
    """Every ``moe.routing_plan`` call takes the experts of the recorded
    call at the same index (``experts``: (B, S, K) tensors in call order,
    from one card's run of the whole batch) at batch rows [lo, hi): the
    plan of those choices (``moe.plan_from``; capacity is per batch row,
    so a row's positions are the one card's) with gates from this call's
    own router logits. A rank then routes its rows as one card did."""
    import torch
    from repro_torch.models import moe
    saved, n = moe.routing_plan, [0]

    def plan(params, x, cfg):
        rec = experts[n[0]][lo:hi].to(x.device)
        n[0] += 1
        if tuple(rec.shape[:2]) != tuple(x.shape[:2]):
            fail("routing replay: the calls do not line up")
        logits = x @ params["router"].to(x.dtype)
        gate = torch.softmax(logits.float(), -1).gather(-1, rec)
        gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
        return moe.plan_from(rec, gate, logits, cfg)
    moe.routing_plan = plan
    try:
        yield n
    finally:
        moe.routing_plan = saved


def moe_mesh_grads_rank(shape):
    """One rank of phase 6d's MoE gradient check (a spawned process on
    ``cuda:<rank>``): global rank 0 first takes one card's gradient of
    ``moe_train_config(MOE_GRAD_LAYERS, MOE_MESH_B)`` (seed 1, the
    MGRIT adjoint; moved to host memory) with its routing recorded and
    broadcasts the plans' experts; then every rank cuts the same params
    to its slices (experts over 'data'), takes its gradient of its batch
    rows through ``make_grad_fn(rcfg, mesh)`` with its rows of the plans
    replayed (launch and collective counters set to 0 just before, read
    just after), the gradient norm, and the gradient gathered whole; on
    rank 0 its cosine and norm difference to one card's. Returns numbers
    only."""
    import torch
    import torch.distributed as dist
    from repro_torch.data.pipeline import SyntheticLM, shard_batch
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer
    from repro_torch.optim import optimizers
    from repro_torch.parallel import params as pparams
    from repro_torch.tree import leaves_with_paths
    rcfg = moe_train_config(MOE_GRAD_LAYERS, MOE_MESH_B)
    rank = dist.get_rank()
    host_batch = SyntheticLM(rcfg, seed=1).batch_at(0)
    out = {"rank": rank, "device": torch.cuda.current_device()}
    box, ref = [None], None
    if rank == 0:
        t0 = time.perf_counter()
        params = transformer.init_model(rcfg, seed=1, device="cuda")
        with record_routes() as plans:
            out["one_loss"], g1 = grads_of(
                params, shard_batch(host_batch, "cuda"), rcfg, mode="lp")
        box = [[p.expert.cpu() for p in plans]]
        ref = {p: g.cpu() for p, g in g1.items()}
        del params, g1, plans
        gc.collect()
        torch.cuda.empty_cache()
        out["one_s"] = time.perf_counter() - t0
    dist.broadcast_object_list(box, src=0)
    experts = box[0]
    mesh = make_mesh(shape, ("data", "model"), "cuda")
    full = transformer.init_model(rcfg, seed=1, device="cuda")
    specs = pparams.train_specs(full, rcfg, mesh)
    local, whole = pparams.shard_tree(full, specs, mesh,
                                      sharding=rcfg.sharding)
    del full
    gc.collect()
    torch.cuda.empty_cache()
    ep = pparams.expert_cut(transformer.param_shapes(rcfg), specs, mesh)
    out["expert_gb"] = sum(t.numel() * t.element_size() for p, t in
                           leaves_with_paths(local) if p in ep) / 1e9
    out["kept_whole"] = [".".join(p) for p in whole]
    batch = shard_batch(host_batch, "cuda", mesh, rcfg)
    rows = MOE_MESH_B // shape[0]
    d = mesh.index("data")
    torch.cuda.reset_peak_memory_stats()
    mesh.reset_counts()
    reset_train_counts()
    t0 = time.perf_counter()
    with replay_expert_rows(experts, d * rows, (d + 1) * rows) as calls:
        loss, _, grads = steps.make_grad_fn(rcfg, mesh)(local, batch)
    gn = optimizers.global_norm(grads, steps.norm_layers(rcfg, mesh))
    out.update(loss=loss.item(), grad_norm=gn.item(),
               grad_s=time.perf_counter() - t0, replayed=calls[0],
               recorded=len(experts), launches=train_counts(),
               collectives={k: list(v) for k, v in mesh.counts.items()},
               peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    del local, batch
    full_g = pparams.gather_tree(grads, specs, mesh, sharding=rcfg.sharding)
    del grads
    if rank == 0:
        out["cos"], out["norm_rel"] = grad_direction(
            dict(leaves_with_paths(full_g)), ref)
    del full_g, ref
    gc.collect()
    torch.cuda.empty_cache()
    return out


def moe_train_reckoning(shape, total_bytes):
    """The deepest full-width qwen3-moe (1 + 3k + 1 stacked layers, cf 3)
    whose state a rank of ``shape`` holds in ``total_bytes`` of card:
    each rank's parameters counted from its slices (the experts and the
    fsdp dimension of every other big leaf over 'data'), times
    MOE_STATE_BYTES, plus MOE_ACT_GIB,
    within MOE_FIT of the card; float32 moments first, bf16 only where
    no depth fits. Returns (config, the reckoning's lines)."""
    from repro_torch.models import transformer
    from repro_torch.parallel import params as pparams
    from repro_torch.tree import leaf_at, leaves_with_paths
    mesh = stub_mesh(shape)
    room = MOE_FIT * total_bytes
    lines = []
    for moment in ("float32", "bfloat16"):
        for mid in (12, 9, 6, 3):
            rcfg = moe_train_config(mid + 2, MOE_MESH_B, moment)
            shapes = transformer.param_shapes(rcfg)
            specs = pparams.train_specs(shapes, rcfg, mesh)
            n = sum(pparams.local_slice(t, p, leaf_at(specs, p), mesh,
                                        sharding=rcfg.sharding).numel()
                    for p, t in leaves_with_paths(shapes))
            need = n * MOE_STATE_BYTES[moment] + MOE_ACT_GIB * 2**30
            lines.append(f"1 + {mid} + 1 layers, {moment} moments: "
                         f"{n / 1e9:.3f} B params a rank x "
                         f"{MOE_STATE_BYTES[moment]} B + {MOE_ACT_GIB:g} GiB "
                         f"= {need / 1e9:.1f} GB of {room / 1e9:.1f} GB")
            if need <= room:
                return rcfg, lines
    fail("phase 6d: no depth of full-width qwen3-moe fits a rank: "
         + "; ".join(lines))


def moe_mesh_phase(card):
    """Phase 6d's MoE part, with 2 or more cards visible: the full-width
    qwen3-moe gradient at (2, 1) and, with 4 cards, (4, 1) against one
    card's (``moe_mesh_grads_rank``; MOE_GRAD_COS / MOE_GRAD_NORM, every
    rank's loss equal, one exchange each way a MoE call); then, with 4
    cards, full-width qwen3-moe trained MOE_MESH_STEPS steps at (4, 1)
    at the depth ``moe_train_reckoning`` picks: every rank's losses equal
    and finite, its peak memory printed against the reckoning, step
    seconds and collectives by kind and bytes. Returns its numbers."""
    import torch
    from repro_torch.launch.hostdev import spawn_host_ranks
    n = torch.cuda.device_count()
    if n < 2:
        print(f"phase 6d (MoE): not run: {n} CUDA device visible")
        return None
    out = {}
    for shape in [(2, 1)] + ([(4, 1)] if n >= 4 else []):
        t0 = time.perf_counter()
        ranks = spawn_host_ranks(shape[0] * shape[1], moe_mesh_grads_rank,
                                 shape, backend="nccl",
                                 timeout=MESH_SPAWN_S)
        wall = time.perf_counter() - t0
        r0 = ranks[0]
        print(f"[{card}] phase 6d {shape} qwen3-moe gradient, full width, "
              f"{MOE_GRAD_LAYERS} stacked layers (bf16), B={MOE_MESH_B} "
              f"S=512, experts over 'data', routing replayed "
              f"({r0['replayed']} of {r0['recorded']} recorded MoE calls): "
              f"loss {r0['loss']:.6f} vs one card {r0['one_loss']:.6f}; "
              f"cosine {r0['cos']:.6f} (> {MOE_GRAD_COS}), norm rel diff "
              f"{r0['norm_rel']:.3e} (< {MOE_GRAD_NORM:g}); one card "
              f"{r0['one_s']:.1f} s")
        for r in ranks:
            print(f"[{card}] phase 6d {shape} qwen3-moe rank {r['rank']} "
                  f"(cuda:{r['device']}): loss {r['loss']:.6f}, grad norm "
                  f"{r['grad_norm']:.6f}; {r['expert_gb']:.2f} GB of experts"
                  f"; gradient {r['grad_s']:.2f} s; peak "
                  f"{r['peak_gib']:.1f} GiB; launches {r['launches']}; "
                  f"collectives " + mesh_counts_text(r["collectives"]))
            if r["loss"] != r0["loss"] or r["replayed"] != r["recorded"]:
                fail(f"phase 6d {shape} qwen3-moe: rank {r['rank']}'s loss "
                     f"{r['loss']} (rank 0 {r0['loss']}) or its "
                     f"{r['replayed']} MoE calls of {r['recorded']}")
            c = r["collectives"]
            if c.get("ep_dispatch", [0])[0] != c.get("ep_combine", [-1])[0] \
                    or not c.get("ep_dispatch_grad", [0])[0]:
                fail(f"phase 6d {shape} qwen3-moe: rank {r['rank']}'s "
                     f"exchanges do not pair: {c}")
            if min(r["launches"][k] for k in (
                    "flash_attention_fwd", "flash_attention_bwd",
                    "rmsnorm_fwd", "rmsnorm_bwd")) <= 0:
                fail(f"phase 6d {shape} qwen3-moe: rank {r['rank']} "
                     f"launched no training kernel: {r['launches']}")
        if not grads_agree(r0["cos"], r0["norm_rel"]):
            fail(f"phase 6d {shape}: the qwen3-moe gradient gathered from "
                 "the ranks loses direction or norm against one card's")
        print(f"phase 6d {shape} qwen3-moe gradient: {wall:.1f} s wall")
        out[f"grads_{shape[0]}x{shape[1]}"] = {"ranks": ranks,
                                               "wall_s": wall}
    out["train_4x1"] = moe_mesh_train_phase(card)
    return out


def moe_mesh_train_phase(card):
    """Phase 6d's full-width qwen3-moe Trainer, with 4 cards visible:
    MOE_MESH_STEPS steps at (4, 1) at the depth ``moe_train_reckoning``
    picks (printed); every rank's losses equal and finite, its peak
    memory printed against the reckoning, step seconds and collectives
    by kind and bytes. Returns its numbers (None with fewer cards)."""
    import math
    import torch
    from repro_torch.launch.hostdev import spawn_host_ranks
    if torch.cuda.device_count() < 4:
        print("phase 6d (MoE Trainer): not run: it needs 4 cards")
        return None
    shape = (4, 1)
    total = torch.cuda.get_device_properties(0).total_memory
    rcfg, lines = moe_train_reckoning(shape, total)
    for line in lines:
        print(f"phase 6d qwen3-moe reckoning a rank at {shape}: {line}")
    cfg = rcfg.model
    moment = rcfg.optimizer.moment_dtype
    if moment != "float32":
        print(f"phase 6d qwen3-moe: moment_dtype set to {moment} (grok-1's "
              "rules use it): no depth fits with float32 moments")
    t0 = time.perf_counter()
    ranks = spawn_host_ranks(math.prod(shape), train_rank, shape,
                             rcfg, backend="nccl", timeout=MOE_TRAIN_SPAWN_S)
    wall = time.perf_counter() - t0
    want = ranks[0]["losses"]
    for r in ranks:
        print(f"[{card}] phase 6d {shape} qwen3-moe Trainer, full width, "
              f"{depth_text(rcfg)}, "
              f"B={rcfg.shape.global_batch} S={rcfg.shape.seq_len}, "
              f"{moment} moments, rank {r['rank']} (cuda:{r['device']}): "
              f"losses {r['losses']}; steps "
              f"{[round(x, 3) for x in r['step_s']]} s; state "
              f"{r['state_gb']:.1f} GB, peak {r['peak_gib']:.1f} GiB "
              f"({r['peak_gib'] * 2**30 / 1e9:.1f} GB; reckoned "
              f"{lines[-1].split('= ')[1]}); launches {r['launches']}; step "
              f"2 collectives " + mesh_counts_text(r["collectives"][-1]))
        if r["losses"] != want or not all(math.isfinite(x) for x in want):
            fail(f"phase 6d {shape} qwen3-moe Trainer: rank {r['rank']}'s "
                 f"losses {r['losses']} are not rank 0's {want} or not "
                 "finite")
    print(f"phase 6d {shape} qwen3-moe Trainer: {wall:.1f} s wall (spawn, "
          f"init, {MESH_STEPS} steps); kept whole {ranks[0]['kept_whole']}")
    return {"ranks": ranks, "wall_s": wall, "n_layers": cfg.n_layers,
            "moment_dtype": moment, "reckoning": lines}


def moe_mesh_queue(V):
    """5f's MoE queue: the smoke queue's first MOE_MESH_REQS greedy
    requests and its first sampled one, prompts cut to MOE_PROMPT."""
    import numpy as np
    return moe_requests(np.random.default_rng(23), V, MOE_MESH_REQS,
                        sampled=True)


def _local_moe_calls(calls, rows):
    """``record_moe_calls``' calls with each call's slots cut to this
    data rank's (its plans hold its rows only)."""
    if rows is None:
        return calls
    return [(rows.local(sd), rows.local(ln), rows.local(nn), plans)
            for sd, ln, nn, plans in calls]


def expert_bytes(params) -> int:
    from repro_torch.tree import leaves_with_paths
    return sum(t.numel() * t.element_size()
               for p, t in leaves_with_paths(params)
               if "moe" in p and p[-1] in ("w_in", "w_gate", "w_out"))


def moe_serve_reference(card):
    """One card, no mesh (5f's MoE reference): qwen3-moe at MOE_SERVE's
    8 layers (seed 23) through ServeEngine (fused) on the MoE queue, the
    logits row of every emission and the routes of every position
    recorded, the queue's launches (counters set to 0 just before, read
    just after), a steady decode wave's ms (5 waves) and its expert
    bytes. Returns its numbers and the rows."""
    import torch
    from repro_torch.models import transformer
    from repro_torch.serve.engine import ServeEngine
    rcfg = moe_serve_config("qwen3_moe_235b")
    t0 = time.perf_counter()
    params = transformer.init_model(rcfg, seed=23, device="cuda")
    engine = ServeEngine(rcfg, params, max_batch=MAX_BATCH, page_size=PAGE,
                         max_len=MAX_LEN, share_prefix=False, device="cuda")
    del params
    reqs = moe_mesh_queue(rcfg.model.vocab_size)
    seeds = [r.seed for r in reqs]
    reset_serve_counts()
    with record_spec_logits() as calls, record_moe_calls() as moe_calls:
        out = engine.generate(reqs)
        torch.cuda.synchronize()
    launches = serve_counts()
    rows = emitted_rows(calls, set(seeds))
    routes = position_routes(moe_calls, seeds)
    del calls, moe_calls
    ref = {"streams": [r.output.tolist() for r in out], "launches": launches,
           "routes": routes, "expert_gb": expert_bytes(
               engine.backend.params) / 1e9}
    scratch, slots, tok = decode_wave_slots(engine.backend)
    for _ in range(2):
        engine.backend.step(scratch, slots, tok)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for _ in range(5):
        engine.backend.step(scratch, slots, tok)   # reads its tokens back
    ref["wave_ms"] = 1e3 * (time.perf_counter() - t1) / 5
    print(f"[{card}] serve reference {rcfg.model.name} (one card, no mesh, "
          f"{MOE_SERVE['qwen3_moe_235b'][0]} layers): "
          f"{sum(map(len, ref['streams']))} tokens, launches {launches}, "
          f"{ref['expert_gb']:.2f} GB of experts, a steady decode wave "
          f"{ref['wave_ms']:.2f} ms, {time.perf_counter() - t0:.1f} s")
    del engine, scratch
    gc.collect()
    torch.cuda.empty_cache()
    return ref, {k: v.detach().cpu() for k, v in rows.items()}


def moe_serve_mesh_rank(shape, experts):
    """One rank of 5f's MoE part (a spawned process on ``cuda:<rank>``):
    qwen3-moe at MOE_SERVE's 8 layers (seed 23) through
    ``ServeEngine(mesh=...)`` under the serve rules with ``experts``
    (None or 'data'), fused, on the MoE queue: its launches and
    collectives (counters set to 0 just before, read just after), each
    emission's logits row held against the one card's (SERVE_REF_DIR)
    for the requests of this rank's data group with the routing-flip
    accounting, its expert bytes, one steady decode wave's collectives
    and its ms (5 waves). Returns numbers only."""
    import numpy as np
    import torch
    from repro_torch.configs.registry import serve_sharding
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer
    from repro_torch.serve.engine import ServeEngine
    mesh = make_mesh(shape, ("data", "model"), "cuda")
    rank = torch.distributed.get_rank()
    rcfg = moe_serve_config("qwen3_moe_235b")
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    params = transformer.init_model(rcfg, seed=23, device="cuda")
    engine = ServeEngine(rcfg, params, mesh=mesh, max_batch=MAX_BATCH,
                         page_size=PAGE, max_len=MAX_LEN, share_prefix=False,
                         sharding=dataclasses.replace(serve_sharding(),
                                                      experts=experts),
                         device="cuda")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    ref = torch.load(SERVE_REF_DIR / "qwen3_moe_235b.pt", weights_only=False)
    be = engine.backend
    res = {"rank": rank, "device": torch.cuda.current_device(),
           "init_s": time.perf_counter() - t0,
           "expert_gb": expert_bytes(be.params) / 1e9}
    reqs = moe_mesh_queue(rcfg.model.vocab_size)
    seeds = [r.seed for r in reqs]
    reset_serve_counts()
    mesh.reset_counts()
    t1 = time.perf_counter()
    with record_spec_logits() as calls, record_moe_calls() as moe_calls:
        outs = engine.generate(reqs)
        torch.cuda.synchronize()
    res["wall_s"] = time.perf_counter() - t1
    res["launches"] = serve_counts()
    res["collectives"] = {k: list(v) for k, v in mesh.counts.items()}
    rows = emitted_rows(_local_calls(calls, be.rows), set(seeds))
    routes = position_routes(_local_moe_calls(moe_calls, be.rows), seeds)
    del calls, moe_calls
    streams = [r.output.tolist() for r in outs]
    mine = [i for i, r in enumerate(reqs) if (r.seed, 0) in rows]
    label = f"qwen3-moe {shape} experts {experts} rank {rank}"
    refs = [[ref["rows"][(reqs[i].seed, m)].cuda()
             for m in range(len(ref["streams"][i]))] for i in mine]
    allow, tally = moe_allowance(routes, ref["routes"], MOE_PROMPT)
    res["failed"] = None
    try:
        res["matched"], res["max_gap"], div = check_dense_streams(
            label, [reqs[i] for i in mine],
            ([np.asarray(streams[i]) for i in mine], rows),
            ([np.asarray(ref["streams"][i]) for i in mine], refs), label,
            allow=allow)
    except SystemExit as e:         # reported by the parent, which fails
        res["failed"], res["matched"], res["max_gap"], div = \
            str(e), -1, -1.0, []
    res.update(streams=streams, checked=mine, divergences=len(div),
               routes=tally)
    del rows, refs
    scratch, slots, tok = decode_wave_slots(be)
    for _ in range(2):
        be.step(scratch, slots, tok)
    mesh.reset_counts()
    be.step(scratch, slots, tok)
    res["wave_collectives"] = {k: list(v) for k, v in mesh.counts.items()}
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for _ in range(5):
        be.step(scratch, slots, tok)          # reads its tokens back
    res["wave_ms"] = 1e3 * (time.perf_counter() - t1) / 5
    res["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    del engine, be, scratch, ref
    gc.collect()
    torch.cuda.empty_cache()
    return res


def moe_serve_mesh_phase(card):
    """5f's MoE part, with 2 or more cards visible: the one-card
    reference (``moe_serve_reference``, saved to SERVE_REF_DIR for the
    ranks, removed after), then NCCL ranks at each shape of
    MOE_SERVE_SHAPES that fits the cards (``moe_serve_mesh_rank``): every
    rank's streams equal, each emission within DENSE_GAP of one card's
    (the flip accounting where the routes differ; checked on the ranks),
    each rank's launches the one card's; printed: expert bytes, launches,
    the collectives of the run and of one decode wave by kind and bytes,
    a steady decode wave's ms beside one card's. Returns its numbers."""
    import math
    import shutil
    import torch
    from repro_torch.launch.hostdev import spawn_host_ranks
    n = torch.cuda.device_count()
    if n < 2:
        print(f"phase 5f (MoE): not run: {n} CUDA device visible")
        return None
    ref, rows = moe_serve_reference(card)
    SERVE_REF_DIR.mkdir(parents=True, exist_ok=True)
    out = {"one_card": {k: ref[k] for k in ("launches", "expert_gb",
                                            "wave_ms")}}
    try:
        torch.save({"streams": ref["streams"], "rows": rows,
                    "routes": ref["routes"]},
                   SERVE_REF_DIR / "qwen3_moe_235b.pt")
        del rows
        for shape, experts in MOE_SERVE_SHAPES:
            if math.prod(shape) > n:
                continue
            t0 = time.perf_counter()
            ranks = spawn_host_ranks(math.prod(shape), moe_serve_mesh_rank,
                                     shape, experts, backend="nccl",
                                     timeout=MESH_SPAWN_S)
            wall = time.perf_counter() - t0
            if any(r["streams"] != ranks[0]["streams"] for r in ranks):
                fail(f"phase 5f {shape} qwen3-moe: the ranks' streams "
                     "differ")
            for r in ranks:
                t = r["routes"]
                print(f"[{card}] phase 5f {shape} qwen3-moe experts "
                      f"{experts} rank {r['rank']} (cuda:{r['device']}): "
                      f"streams equal on every rank, {r['matched']}/"
                      f"{len(r['checked'])} of its requests {r['checked']} "
                      f"bitwise the one card's, max gap {r['max_gap']:.4f} "
                      f"(limit {DENSE_GAP:g}), {r['divergences']} "
                      f"divergences; routes {t['equal']} equal, {t['flip']} "
                      f"with a flip (margins "
                      f"{[round(x, 4) for x in t['margins']]}), "
                      f"{t['capacity']} capacity; {r['expert_gb']:.2f} GB of "
                      f"experts (one card {ref['expert_gb']:.2f}); launches "
                      f"{r['launches']}; collectives "
                      + mesh_counts_text(r["collectives"])
                      + (f"; FAILED: {r['failed']}" if r["failed"] else ""))
                print(f"[{card}] phase 5f {shape} qwen3-moe rank "
                      f"{r['rank']}: a steady decode wave (B={MAX_BATCH}, "
                      f"contexts {DECODE_LENS}) {r['wave_ms']:.2f} ms (one "
                      f"card in this call {ref['wave_ms']:.2f}); its "
                      "collectives " + mesh_counts_text(r["wave_collectives"])
                      + f"; peak {r['peak_gib']:.1f} GiB; init "
                      f"{r['init_s']:.1f} s; queue {r['wall_s']:.2f} s")
                if r["launches"] != ref["launches"]:
                    fail(f"phase 5f {shape} qwen3-moe: rank {r['rank']} "
                         f"launched {r['launches']}, not one card's "
                         f"{ref['launches']}")
                if r["failed"]:
                    fail(f"phase 5f {shape} qwen3-moe: {r['failed']}")
                r.pop("streams")
            print(f"phase 5f {shape} qwen3-moe: {wall:.1f} s wall (spawn, "
                  "init, serving)")
            out[f"{shape[0]}x{shape[1]}"] = {"ranks": ranks, "wall_s": wall,
                                             "experts": experts}
        return out
    finally:
        shutil.rmtree(SERVE_REF_DIR, ignore_errors=True)


def smoke_train_configs():
    """The train runs the smoke measures, by name: (config, ``run_train``
    result key, profiled mode)."""
    qwen3 = qwen3_train_config()
    runs = {"qwen3_1p7b MGRIT": (qwen3, "qwen3", "MGRIT (lp)"),
            "qwen3_1p7b serial": (qwen3.replace(mgrit=dataclasses.replace(
                qwen3.mgrit, enabled=False)), "qwen3", "serial"),
            "falcon_mamba_7b MGRIT": (falcon_train_config(), "falcon",
                                      "MGRIT (lp)"),
            "zamba2_1p2b serial": (zamba2_train_config(), "zamba2",
                                   "serial")}
    for arch, B, S in PAPER_TRAIN:
        runs[f"{arch} MGRIT"] = (paper_train_config(arch, B, S), arch,
                                 "MGRIT (lp)")
    return runs


def smoke_count(name):
    """The dry-run count (``repro_torch.launch.dryrun.count_step``) of the
    smoke's train run ``name`` on the meta device, with the batch the
    run's data pipeline gives (its shapes and dtypes). Runs in a worker
    process on the CPU; touches no card."""
    import torch
    torch.set_num_threads(1)
    from repro_torch.data.pipeline import make_pipeline, shard_batch
    from repro_torch.launch import dryrun
    rcfg = smoke_train_configs()[name][0]
    batch = shard_batch(make_pipeline(rcfg, 0).batch_at(0), "meta")
    return {**dryrun.count_step(rcfg, batch=batch), "done_at": time.time()}


def start_counts():
    """A pool of two spawned worker processes, at the lowest CPU priority
    (``os.nice(19)``), counting every smoke train run on meta while the
    card trains (bert128's count, the longest, first). Returns (pool,
    {name: future}); each count's result holds its ``done_at`` wall
    time, which ``count_overlap`` sets beside the timed phases'."""
    import multiprocessing
    import os
    from concurrent.futures import ProcessPoolExecutor
    pool = ProcessPoolExecutor(
        2, mp_context=multiprocessing.get_context("spawn"),
        initializer=os.nice, initargs=(19,))
    names = sorted(smoke_train_configs(), key=lambda n: n != "bert128 MGRIT")
    return pool, {n: pool.submit(smoke_count, n) for n in names}


def count_overlap(futures, marks):
    """Which timed phases the meta counts ran beside: each phase's start
    (``marks``, wall times in order) against the last count's end, in
    seconds since the first mark. Printed and returned."""
    t0 = next(iter(marks.values()))
    done = max(f.result()["done_at"] for f in futures.values())
    beside = [p for p, t in marks.items() if t < done]
    res = {"counts_done_s": done - t0,
           **{f"{p}_start_s": t - t0 for p, t in marks.items()},
           "phases_beside_counts": beside}
    print(f"dry-run counts (two workers at nice 19): the last ended "
          f"{res['counts_done_s']:.1f} s after phase 6 began; phases "
          + ", ".join(f"{p} began at {t - t0:.1f} s" for p, t in
                      marks.items())
          + "; timed phases the counts ran beside: "
          + (", ".join(beside) if beside else "none"))
    return res


def roofline_lines(futures, infos, card):
    """Phase 9: for every train step the smoke measured, the dry-run's
    predicted argument bytes beside the bytes allocated after the
    ``Trainer``'s init, model flops (6·N_active·D) beside the counted
    flops, and the model-flops share of each measured step at the bf16
    peak: those of the three ``Trainer.train`` steps that ran in the
    mode (step 2 holds the probe, and a run the probe switches to serial
    runs step 2 serially), and the profiled step of the mode."""
    out = {}
    for name, (rcfg, key, mode) in smoke_train_configs().items():
        rec = futures[name].result()
        info = infos[key]
        roof = rec["roofline"]
        mf = roof["model_flops"]
        t_mf = mf / PEAK_BF16_FLOP_S
        steps = {i: s for i, (s, m) in enumerate(zip(
            info["step_s"], info["modes"], strict=True))
            if (m == "serial") == (mode == "serial")}
        prof = info["profiled_s"][mode]
        pred = rec["argument_bytes"]["total"]
        out[name] = {
            "predicted_argument_bytes": pred,
            "allocated_after_init": info["init_bytes"],
            "model_flops": mf, "counted_flops": roof["hlo_flops"],
            "counted_bytes": roof["hlo_bytes"],
            "t_compute_ms": 1e3 * roof["t_compute"],
            "t_memory_ms": 1e3 * roof["t_memory"],
            "step_s": steps, "share": {i: t_mf / s
                                       for i, s in steps.items()},
            "profiled_s": prof, "profiled_share": t_mf / prof,
            "count_s": rec["run_s"]}
        print(f"roofline {name} ({card}): arguments predicted "
              f"{pred / 1e9:.3f} GB (params + optimizer state + batch), "
              f"allocated after init {info['init_bytes'] / 1e9:.3f} GB; "
              f"model flops {mf:.4e}, counted {roof['hlo_flops']:.4e} "
              f"({roof['hlo_flops'] / mf:.2f}x); model flops at 989 "
              f"TFLOP/s take {1e3 * t_mf:.1f} ms = "
              + ", ".join(f"{100 * t_mf / s:.2f}% of step {i} ({s:.3f} s)"
                          for i, s in steps.items())
              + (", " if steps else "")
              + f"{100 * t_mf / prof:.2f}% of the profiled {mode} step "
              f"({prof:.3f} s); counted terms compute "
              f"{1e3 * roof['t_compute']:.1f} ms, memory "
              f"{1e3 * roof['t_memory']:.1f} ms ({roof['bottleneck']}); "
              f"counted in {rec['run_s']:.1f} s on the host")
    return out


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

    PHASE_START.append(("1", time.perf_counter()))
    # -- 1. card, versions; phase 0, the static checker; build -------------
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} "
          f"device {torch.cuda.get_device_name(0)} "
          f"x{torch.cuda.device_count()}")
    static_check()
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

    PHASE_START.append(("2", time.perf_counter()))
    # -- 2. kernels vs plain versions at the serve shapes -------------------
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    # the paper families' kernel cases draw from their own generator, so
    # every earlier case keeps its inputs
    paper_gen = torch.Generator(device="cuda")
    paper_gen.manual_seed(20)
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
                attn_err[dname] = max(
                    attn_err.get(dname, 0.0),
                    check_paged_case(gen, heads, S, lengths, dtype))
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
    edge_err, edge_tv = check_sampling(gen)
    samp_err = max(samp_err, edge_err)
    ssm_err = check_ssm_kernel(gen)
    train_err = check_train_kernels(gen, paper_gen)
    train_err.update(check_scan_kernel(gen))
    gc.collect()
    torch.cuda.empty_cache()

    PHASE_START.append(("2b", time.perf_counter()))
    # -- 2b. training kernels' times at the training shapes (before the
    # long profiler sessions of the later phases) --------------------------
    flush = torch.empty(64 * 2**20 // 4, device="cuda")   # > 50 MB L2
    train_rows = time_train_kernels(gen, flush, train_err)
    scan_rows = time_scan_kernels(gen, flush, train_err)
    for part, row in time_flash(paper_gen, flush, train_err, "bert128", 32,
                                12, 12, 64, 224, False, "@paper").items():
        train_rows[f"flash_attention_{part}@bert128"] = row
    gc.collect()
    torch.cuda.empty_cache()

    PHASE_START.append(("3", time.perf_counter()))
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
    # phase 5e's reference: these streams, one decode step's logits and
    # the sync census of a decode wave (profile_decode_wave's)
    serve_ref = {"streams": SERVED[cfg.name],
                 "logits": decode_step_logits(engine.backend)}
    step_check(engine, transformer.paged_decode_step,
               lambda r: transformer.init_paged_cache(
                   r, 1 + MAX_BATCH * 8, PAGE, device="cuda"), rng)
    profile_decode_wave(engine.backend, cfg.name, prefill=True)
    serve_ref["syncs"] = next(c["syncs"] for c in CENSUS
                              if c["call"] == f"{cfg.name} decode wave")
    print(f"{cfg.name}: peak memory {torch.cuda.max_memory_allocated() / 2**30:.1f}"
          f" GiB")

    PHASE_START.append(("4", time.perf_counter()))
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
    s_dev = device_ms(lambda: sp.topk_topp_mask(sl, sks, sps), 20, flush)
    s_sort_dev = device_ms(lambda: apply_top_k_top_p(sl, sks, sps), 20,
                           flush)
    # the serve wave's rows: greedy (k 0, p 1) and sampled (k 40, p 0.95)
    wks = torch.tensor([0, 40, 0, 40], dtype=torch.int32, device="cuda")
    wps = torch.tensor([1.0, 0.95, 1.0, 0.95], device="cuda")
    s_wave = device_ms(lambda: sp.topk_topp_mask(sl, wks, wps), 20, flush)
    # each route alone (all four rows alike)
    s_rows = {}
    for row_k, row_p in ((0, 1.0), (40, 0.95), (1, 0.5), (0, 0.9)):
        rk = torch.full((MAX_BATCH,), row_k, dtype=torch.int32,
                        device="cuda")
        rp = torch.full((MAX_BATCH,), row_p, device="cuda")
        s_rows[f"k{row_k} p{row_p:g}"] = device_ms(
            lambda rk=rk, rp=rp: sp.topk_topp_mask(sl, rk, rp), 20, flush)
    s_bound = 1e3 * sp.cost(MAX_BATCH, V)[1] / PEAK_BYTES_S
    print(f"topk_topp_mask B=4 V={V} (rows k 0/40/1/0, p "
          f"1/0.95/0.5/0.9): kernel {s_ms:.4f} ms "
          f"(device {s_dev:.4f}), plain {s_plain:.4f} ms, sort-based "
          f"apply_top_k_top_p {s_sort:.4f} ms (device {s_sort_dev:.4f}), "
          f"bound {s_bound:.5f} ms (bytes); the serve wave's rows (k 0/40, "
          f"p 1/0.95) device {s_wave:.4f} ms; rows all alike, device "
          + ", ".join(f"{k} {v:.4f}" for k, v in s_rows.items()) + " ms")
    ssm_rows = time_ssm_kernel(gen, flush)
    del engine, params, q, pk, pv, qp, pkp, pvp
    gc.collect()
    torch.cuda.empty_cache()

    PHASE_START.append(("5", time.perf_counter()))
    # -- 5. serve falcon_mamba_7b and zamba2_1p2b at full width and depth ---
    ssm_launches = {}
    for arch, order in (("falcon_mamba_7b", "dbx"), ("zamba2_1p2b", "dxb")):
        ssm_launches[order] = serve_ssm(arch, seed=1)
        gc.collect()
        torch.cuda.empty_cache()

    PHASE_START.append(("5b", time.perf_counter()))
    # -- 5b. speculative decoding: the kernels at the spec path's shapes,
    # then the three families at full width and depth, plain vs spec ------
    spec_gen = torch.Generator(device="cuda")
    spec_gen.manual_seed(21)
    spec_err = check_spec_kernels(spec_gen)
    spec_attn, spec_ssm = time_spec_kernels(spec_gen, flush)
    gc.collect()
    torch.cuda.empty_cache()
    spec_launches, spec_waves, spec_res = {}, {}, {}
    for arch, family in SPEC_FAMILIES:
        spec_launches[family], spec_waves[family], spec_res[family] = \
            serve_spec(arch, family, seed=2, card=card)
        gc.collect()
        torch.cuda.empty_cache()

    PHASE_START.append(("5c", time.perf_counter()))
    # -- 5c. dense-cache decode: the dense cache's routes through the
    # kernels, dense vs paged at full width and depth, then decoding the
    # encoder-decoder family ---------------------------------------------
    t_dense = time.perf_counter()
    dense_gen = torch.Generator(device="cuda")
    dense_gen.manual_seed(22)
    dense_err = {"attn": check_dense_attention(dense_gen),
                 "ssm": check_dense_ssm(dense_gen),
                 "cross": check_cross_flash(dense_gen)}
    dense_rows = time_dense_kernels(dense_gen, flush)
    gc.collect()
    torch.cuda.empty_cache()
    dense_launches, dense_res = {}, {}
    for arch, seed in (("qwen3_1p7b", 0), ("falcon_mamba_7b", 1),
                       ("zamba2_1p2b", 1)):
        dense_launches[arch], dense_res[arch] = dense_vs_paged(arch, seed,
                                                               card)
        gc.collect()
        torch.cuda.empty_cache()
    for arch, B, S_src in ENCDEC_DECODE:
        dense_launches[arch], dense_res[arch] = encdec_decode(arch, B, S_src,
                                                              card)
        gc.collect()
        torch.cuda.empty_cache()
    print(f"dense decode phase: {time.perf_counter() - t_dense:.1f} s")

    PHASE_START.append(("5d", time.perf_counter()))
    # -- 5d. the MoE family: the module at both full widths, the kernels at
    # the MoE shapes, serving qwen3-moe and grok-1, gradients, Trainer ----
    moe_gen = torch.Generator(device="cuda")
    moe_gen.manual_seed(23)
    moe_launches, moe_err, moe_res = moe_phase(moe_gen, flush, card)
    gc.collect()
    torch.cuda.empty_cache()

    PHASE_START.append(("5e", time.perf_counter()))
    # -- 5e. serving through a world-1 NCCL mesh, bitwise phase 3's engine;
    # 5f (the ranks of a multi-card mesh) runs with --mesh only ----------
    serve_mesh_res = {"5e": world1_serve_phase(card, serve_ref), "5f": None}
    del serve_ref
    serve_mesh_res["5e_moe"] = world1_moe_serve(card)
    print("phase 5f: not run: its NCCL ranks run with --mesh on 2 or more "
          "cards")

    PHASE_START.append(("5g", time.perf_counter()))
    # -- 5g. dense-cache decode under a mesh: the lse route vs plain, qwen3
    # through a world-1 NCCL mesh bitwise 5c's, then at (1, 2) on this card
    # (two gloo ranks); --mesh dense runs the multi-card shapes -----------
    lse_gen = torch.Generator(device="cuda")
    lse_gen.manual_seed(25)
    lse_row, dense_mesh_res = dense_phase(card, lse_gen, flush)
    DENSE_REF.clear()
    gc.collect()
    torch.cuda.empty_cache()
    print("--mesh dense: not run: its NCCL ranks run with --mesh dense on "
          "4 cards")

    PHASE_START.append(("6", time.perf_counter()))
    # -- 6. training: gradients at reduced depth, then full depth; the
    # dry-run counts of every train run (phase 9) on the host meanwhile ---
    # (a failing phase exits through SystemExit, and concurrent.futures'
    # exit hook joins the workers, each after its running count at most)
    count_pool, counts = start_counts()
    marks = {"6": time.time()}
    timed_check(check_train_grads)
    gc.collect()
    torch.cuda.empty_cache()
    attn_kernels = ("flash_attention_fwd", "flash_attention_bwd",
                    "rmsnorm_fwd", "rmsnorm_bwd")
    scan_kernels = ("ssm_scan_fwd", "ssm_scan_bwd")
    train_launches, _, _, qwen3_info = run_train(qwen3_train_config(),
                                                 attn_kernels, census=True,
                                                 record=True)
    infos = {"qwen3": qwen3_info}
    gc.collect()
    torch.cuda.empty_cache()

    PHASE_START.append(("6c", time.perf_counter()))
    # -- 6c / 6d. the same training through a mesh: world 1 in this
    # process (NCCL), then NCCL ranks over 2 (and 4) cards where visible --
    marks["6c"] = time.time()
    mesh_res = mesh_phase(card, qwen3_info)

    PHASE_START.append(("6e", time.perf_counter()))
    # -- 6e. the reduced qwen3-moe Trainer through a world-1 NCCL mesh,
    # bitwise phase 5d's -------------------------------------------------
    mesh_res["6e"] = world1_moe_train(card)

    PHASE_START.append(("6f", time.perf_counter()))
    # -- 6f. full-width granite_34b on one device and through a world-1
    # NCCL mesh under fsdp, bitwise; flash at its head shape first ------
    granite_gen = torch.Generator(device="cuda")
    granite_gen.manual_seed(24)
    mesh_res["6f"] = granite_phase(card, granite_gen)

    PHASE_START.append(("6b", time.perf_counter()))
    # -- 6b. checkpoint and resume full-width qwen3_1p7b at CKPT_LAYERS ----
    marks["6b"] = time.time()
    print(f"phase 6b begins: {sum(f.done() for f in counts.values())} of "
          f"{len(counts)} dry-run counts done")
    ckpt_res = checkpoint_phase(ckpt_train_config(), card)

    PHASE_START.append(("7", time.perf_counter()))
    # -- 7. SSM training: gradients at reduced depth, then path A (falcon,
    # MGRIT) and path B (zamba2, serial) at full width ----------------------
    marks["7"] = time.time()
    timed_check(check_ssm_train_grads)
    gc.collect()
    torch.cuda.empty_cache()
    ssm_train = {}
    for fam, rcfg, need in (
            ("falcon", falcon_train_config(),
             ("rmsnorm_fwd", "rmsnorm_bwd") + scan_kernels),
            ("zamba2", zamba2_train_config(), attn_kernels + scan_kernels)):
        ssm_train[fam] = run_train(rcfg, need, record=fam == "zamba2")
        gc.collect()
        torch.cuda.empty_cache()

    PHASE_START.append(("6g", time.perf_counter()))
    # -- 6g. Megatron TP in training: zamba2 through a world-1 NCCL mesh
    # bitwise phase 7's run, then its gradient at (1, 2) on this card -----
    tp_res = tp_phase(card, ssm_train["zamba2"][3]["at_step_2"])
    gc.collect()
    torch.cuda.empty_cache()

    PHASE_START.append(("8", time.perf_counter()))
    # -- 8. the paper's encoder and encoder-decoder families: gradients at
    # reduced depth, then bert128 (MGRIT, probe at step 2), vit32 (serial
    # forward, MGRIT backward, probe at step 2) and mt_marian (MGRIT; the
    # reference has no encoder-decoder probe) at full width and depth ----
    marks["8"] = time.time()
    timed_check(check_paper_train_grads)
    gc.collect()
    torch.cuda.empty_cache()
    flash_kernels = ("flash_attention_fwd", "flash_attention_bwd")
    paper_train = {}
    for arch, B, S in PAPER_TRAIN:
        # one profiled step (MGRIT, which phase 9 reads), the serial one
        # unprofiled: these steps are host-bound (124551 device ops a
        # bert128 step) and the trace's processing (key_averages over
        # its events), not the step nor the trace's collection, took
        # most of the phase; it records the device's activity alone (the
        # busy share, the device ops and the largest rows are all phase 9
        # and PERF.md read), and its collection and processing seconds
        # are printed
        paper_train[arch] = run_train(paper_train_config(arch, B, S),
                                      flash_kernels,
                                      probe=arch != "mt_marian",
                                      profiled=("MGRIT (lp)",),
                                      device_only=True)
        gc.collect()
        torch.cuda.empty_cache()

    PHASE_START.append(("9", time.perf_counter()))
    # -- 9. the step roofline: each measured train step against the
    # dry-run's count of it --------------------------------------------
    infos.update({fam: r[3] for fam, r in ssm_train.items()})
    infos.update({arch: r[3] for arch, r in paper_train.items()})
    roof_res = roofline_lines(counts, infos, card)
    roof_res["overlap"] = count_overlap(counts, marks)
    count_pool.shutdown(wait=True)

    t_end = time.perf_counter()
    spans = [(name, nxt - t0) for (name, t0), (_, nxt) in
             zip(PHASE_START, PHASE_START[1:] + [("end", t_end)])]
    print(f"chip_smoke: {t_end - t_start:.1f} s in all; by phase "
          + ", ".join(f"{name} {sec:.1f} s" for name, sec in spans))

    kernels = [
        {"name": "paged_flash_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
         "replaces": "src/repro/kernels/paged_attention.py:88",
         "launches": launches["paged_flash_attention"],
         "max_abs_err": attn_err["bfloat16"],
         # decode (S=1, split-KV; device_ms counts the combine kernel
         # too), prefill_* a 256-token chunk (tensor cores), verify_* the
         # spec verify window (S=5, split-KV); launches_spec_* the spec
         # phase's queue (zamba2's shared attention too)
         **attn, **{f"prefill_{k}": v for k, v in pre.items()},
         **{f"verify_{k}": v for k, v in spec_attn.items()},
         "spec_max_abs_err": spec_err["attn"],
         "launches_spec_qwen3": spec_launches["attn"][
             "paged_flash_attention"],
         "launches_spec_zamba2": spec_launches["hybrid"][
             "paged_flash_attention"]},
        # launches: qwen3_1p7b's serve queue, the falcon and zamba2 queues'
        # beside it (below); device_* the device work alone (device_ms);
        # sort_* the sort-based apply_top_k_top_p (several PyTorch ops, no
        # single call computes the mask); wave_device_ms at the serve
        # wave's rows, rows_device_ms each route alone
        {"name": "topk_topp_mask", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/sampling.cu",
         "replaces": "src/repro/kernels/sampling.py:126",
         "launches": launches["topk_topp_mask"],
         "max_abs_err": samp_err, "flipped_mass": edge_tv, "ms": s_ms,
         "device_ms": s_dev, "plain_ms": s_plain, "bound_ms": s_bound,
         "bound_by": "bytes", "library_ms": None, "sort_ms": s_sort,
         "sort_device_ms": s_sort_dev, "wave_device_ms": s_wave,
         "rows_device_ms": s_rows},
    ]
    for name, src, line in (
            ("flash_attention_fwd", "flash_attention", 64),
            ("flash_attention_bwd", "flash_attention", 64),
            ("rmsnorm_fwd", "rmsnorm", 23), ("rmsnorm_bwd", "rmsnorm", 23)):
        km, pm, lm, bm, by = train_rows[name][:5]
        row = {
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}.cu",
            "replaces": f"src/repro/kernels/{src}.py:{line}",
            "launches": train_launches[name], "max_abs_err": train_err[name],
            "ms": km, "plain_ms": pm, "bound_ms": bm, "bound_by": by,
            "library_ms": lm}
        # launches_mesh*: phase 6c's world-1 mesh run (2 steps), 6d's
        # ranks (rank 0's count) where 2 or 4 cards are visible
        row["launches_mesh"] = mesh_res["6c"]["launches"][name]
        for shape, r in (mesh_res["6d"] or {}).items():
            row[f"launches_mesh_{shape}"] = r["ranks"][0]["launches"][name]
        # launches_tp_1x2: phase 6g's (1, 2) split of zamba2, a rank's
        # count over its gradient (its heads, rows and vocab columns)
        row["launches_tp_1x2"] = tp_res["split"]["ranks"][0][
            "grad_launches"][name]
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
            # device_* the device work alone (device_ms); zamba2_1p2b's
            # shape (B=1 H=32/32 hd=64) and its run's launches; bert128's
            # (B=32 S=224 H=12/12 hd=64, non-causal), the launches of the
            # paper runs' Trainer.train(3) and the largest bf16 error at
            # the paper's non-causal shapes (PAPER_FLASH and bert128's)
            row["device_ms"], row["library_device_ms"] = \
                train_rows[name][5:]
            kz, pz, lz, bz, byz = train_rows[f"{name}@zamba2"][:5]
            row.update(zamba2_ms=kz, zamba2_plain_ms=pz,
                       zamba2_library_ms=lz, zamba2_bound_ms=bz,
                       zamba2_bound_by=byz,
                       launches_zamba2=ssm_train["zamba2"][0][name])
            row.update(zip(("bert128_ms", "bert128_plain_ms",
                            "bert128_library_ms", "bert128_bound_ms",
                            "bert128_bound_by", "bert128_device_ms",
                            "bert128_library_device_ms"),
                           train_rows[f"{name}@bert128"], strict=True))
            row.update({f"launches_{arch}": paper_train[arch][0][name]
                        for arch in paper_train},
                       paper_max_abs_err=train_err[f"{name}@paper"])
        kernels.append(row)
    # one row per product order: falcon-mamba-7b's path launches "dbx",
    # zamba2-1.2b's "dxb"; ms/plain_ms/bound_ms at decode (S=1), prefill_*
    # at a 256-token chunk, device_* the device work alone, kernel_* the
    # kernel's alone (plan already int32); no single PyTorch call computes
    # the paged scan
    for order in ("dbx", "dxb"):
        km, dm, pm, bm, by, am = ssm_rows[(order, 1)]
        kp, dp, pp, bp, _, ap = ssm_rows[(order, 256)]
        kernels.append({
            "name": f"paged_ssm_update_{order}", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/paged_ssm.cu",
            "replaces": "src/repro/kernels/paged_ssm.py:92",
            "launches": ssm_launches[order]["paged_ssm_update"],
            "max_abs_err": ssm_err[order], "ms": km, "plain_ms": pm,
            "bound_ms": bm, "bound_by": by, "library_ms": None,
            "device_ms": dm, "kernel_device_ms": am, "prefill_ms": kp,
            "prefill_device_ms": dp, "prefill_kernel_device_ms": ap,
            "prefill_plain_ms": pp, "prefill_bound_ms": bp,
            # verify_*: the every-step plan at S=5 (spec verify);
            # launches_spec: the spec phase's queue of this order's model
            **{f"verify_{k}": v for k, v in spec_ssm[order].items()},
            "verify_max_abs_err": spec_err[order],
            "launches_spec": spec_launches[
                "ssm" if order == "dbx" else "hybrid"]["paged_ssm_update"]})
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
            "launches_tp_1x2": tp_res["split"]["ranks"][0][
                "grad_launches"][name],
            "launches_per_step": {
                f"{fam} {mode}": n[name] for fam in ssm_train
                for mode, n in ssm_train[fam][1].items()},
            "zamba2_ms": kz, "zamba2_plain_ms": pz, "zamba2_bound_ms": bz,
            "zamba2_bound_by": byz, "device_ms": dm,
            "zamba2_device_ms": dz})
    kernels += dense_kernel_rows(dense_launches, dense_err, dense_rows)
    kernels.append(lse_row)
    dl = dense_launches
    samp = kernels[1]
    samp["launches_dense"] = {a: n["topk_topp_mask"] for a, n in dl.items()}
    samp["launches_falcon"] = ssm_launches["dbx"]["topk_topp_mask"]
    samp["launches_zamba2"] = ssm_launches["dxb"]["topk_topp_mask"]
    counts = {"paged_flash_attention": launches["paged_flash_attention"],
              "topk_topp_mask": launches["topk_topp_mask"],
              "topk_topp_mask_falcon": samp["launches_falcon"],
              "topk_topp_mask_zamba2": samp["launches_zamba2"],
              **{k: train_launches[k] for k in attn_kernels},
              **{f"{k}_{arch}": paper_train[arch][0][k]
                 for arch in paper_train for k in flash_kernels},
              **{f"{k}_{fam}": ssm_train[fam][0][k]
                 for fam in ssm_train for k in scan_kernels},
              "paged_ssm_update_dbx":
                  ssm_launches["dbx"]["paged_ssm_update"],
              "paged_ssm_update_dxb":
                  ssm_launches["dxb"]["paged_ssm_update"],
              **{f"{k}_spec_{fam}": spec_launches[fam][k]
                 for fam in spec_launches
                 for k in ("paged_flash_attention", "paged_ssm_update",
                           "rmsnorm_fwd")},
              **{f"{k}_dense_{arch}": n[k] for arch, n in dl.items()
                 for k in ("paged_flash_attention", "paged_ssm_update",
                           "flash_attention_fwd", "topk_topp_mask")
                 if n[k]}}
    for row in kernels:
        if row["name"] == "rmsnorm_fwd":
            row.update({f"launches_spec_{fam}": spec_launches[fam][
                "rmsnorm_fwd"] for fam in spec_launches})
    # the MoE phase (5d): each kernel's launches in every MoE run (the
    # serve queue, the dense oracle, the spec engine, the gradient check's
    # kernel path, the reduced Trainer), its largest bf16 error at the MoE
    # shapes, and the times taken there
    moe_runs = {f"{arch}_{run}": n for arch in ("qwen3_moe_235b",
                                                "grok1_314b")
                for run, n in moe_launches[arch].items()}
    moe_runs.update(grads=moe_launches["grads"],
                    train=moe_launches["train"])
    for row in kernels:
        name = row["name"]
        if name in ("paged_flash_attention", "topk_topp_mask",
                    "flash_attention_fwd", "flash_attention_bwd",
                    "rmsnorm_fwd", "rmsnorm_bwd"):
            row["launches_moe"] = {run: n.get(name, 0)
                                   for run, n in moe_runs.items()}
            row["moe_max_abs_err"] = moe_err.get(name)
    # launches_mesh_serve: phase 5e's world-1 mesh serving the smoke queue
    # (qwen3; _moe: qwen3-moe); launches_mesh_moe_train: phase 6e's
    for row in kernels:
        if row["name"] in serve_mesh_res["5e"]["launches"]:
            row["launches_mesh_serve"] = \
                serve_mesh_res["5e"]["launches"][row["name"]]
            row["launches_mesh_serve_moe"] = \
                serve_mesh_res["5e_moe"]["launches"][row["name"]]
        if row["name"] in mesh_res["6e"]["launches"]:
            row["launches_mesh_moe_train"] = \
                mesh_res["6e"]["launches"][row["name"]]
    # launches_granite: phase 6f's one-device granite run (2 steps);
    # granite_max_abs_err: flash at its head shape (H 48/1, S 4096)
    granite_err = dict(zip(("flash_attention_fwd", "flash_attention_bwd"),
                           mesh_res["6f"]["flash_err"]))
    for row in kernels:
        if row["name"] in granite_err:
            row["launches_granite"] = mesh_res["6f"]["runs"]["one device"][
                "launches"][row["name"]]
            row["granite_max_abs_err"] = granite_err[row["name"]]
    kernels[0]["moe_shapes_ms"] = {k: v for k, v in moe_res[
        "kernels"].items() if k != "sampling"}
    kernels[1]["moe_shapes_ms"] = moe_res["kernels"]["sampling"]
    kernels[1]["moe_flipped_mass"] = moe_err["topk_topp_mask_tv"]
    counts.update({f"{k}_moe_{run}": n[k] for run, n in moe_runs.items()
                   for k in ("paged_flash_attention", "topk_topp_mask",
                             "flash_attention_fwd", "flash_attention_bwd",
                             "rmsnorm_fwd", "rmsnorm_bwd") if n.get(k)})
    print("spec: " + json.dumps(spec_res))
    print("dense: " + json.dumps(dense_res))
    print("moe: " + json.dumps(moe_res))
    print("checkpoint: " + json.dumps(ckpt_res))
    print("mesh: " + json.dumps(mesh_res))
    print("serve_mesh: " + json.dumps(serve_mesh_res))
    print("dense_mesh: " + json.dumps(dense_mesh_res))
    print("tp_train: " + json.dumps(tp_res))
    print("census: " + json.dumps(CENSUS))
    print("roofline: " + json.dumps(roof_res))
    print("kernels: " + ", ".join(f"{k}={v}" for k, v in counts.items()))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def main_mesh(mode: str = "") -> int:
    """``python3 chip_smoke.py --mesh``: the mesh phases alone, for a call
    on several cards (the driver's run takes no argument and runs every
    phase). The build; the one-card serving references of qwen3_1p7b,
    falcon_mamba_7b and zamba2_1p2b; phase 5e (a world-1 NCCL mesh
    bitwise the one-card qwen3 engine) and 5f (NCCL ranks over 2 / 4
    cards against the references), then 5f's qwen3-moe part; then,
    unless ``--mesh serve``, phase 6's qwen3_1p7b run without its
    profiled steps and phases 6c and 6d (layer-parallel training over
    the mesh), then 6d's qwen3-moe part (the expert-parallel gradient
    and the full-width Trainer). ``--mesh moe``: the build and the
    qwen3-moe parts of 5f and 6d alone."""
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device is available")
    from repro_torch.kernels import build
    t_start = time.perf_counter()
    card = card_line()
    print(f"card: {card} x{torch.cuda.device_count()}; torch "
          f"{torch.__version__} cuda {torch.version.cuda}")
    build.build()
    static_check()
    if mode in ("dense", "tp"):
        res = (dense_mesh_phase if mode == "dense" else tp_mesh_phase)(card)
        print(f"{mode}_mesh: " + json.dumps(res))
        print(f"chip_smoke --mesh {mode}: "
              f"{time.perf_counter() - t_start:.1f} s")
        print(card)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    serve_res = {}
    if mode in ("", "serve"):
        refs = {arch: serve_reference(arch, card) for arch in SERVE_SEEDS}
        serve_res["5e"] = world1_serve_phase(card, refs["qwen3_1p7b"][0])
        t5f = time.perf_counter()
        serve_res["5f"] = serve_mesh_phase(card, refs)
        del refs
        print(f"phase 5f: {time.perf_counter() - t5f:.1f} s")
    if mode != "fsdp":
        t5f = time.perf_counter()
        serve_res["5f_moe"] = moe_serve_mesh_phase(card)
        print(f"phase 5f (qwen3-moe): {time.perf_counter() - t5f:.1f} s")
        print("serve_mesh: " + json.dumps(serve_res))
    if mode != "serve":
        res = {}
        if mode == "":
            _, _, _, info = run_train(qwen3_train_config(), (
                "flash_attention_fwd", "flash_attention_bwd", "rmsnorm_fwd",
                "rmsnorm_bwd"), record=True, profiled=())
            gc.collect()
            torch.cuda.empty_cache()
            res = mesh_phase(card, info)
        if mode in ("", "fsdp"):
            t6d = time.perf_counter()
            res["6d_fsdp"] = granite_mesh_phase(card)
            print(f"--mesh fsdp (granite): {time.perf_counter() - t6d:.1f} "
                  "s")
        t6d = time.perf_counter()
        res["6d_moe"] = moe_mesh_phase(card)
        print(f"phase 6d (qwen3-moe): {time.perf_counter() - t6d:.1f} s")
        print("mesh: " + json.dumps(res))
    print(f"chip_smoke --mesh: {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:] in (["--mesh"], ["--mesh", "serve"], ["--mesh", "moe"],
                        ["--mesh", "fsdp"], ["--mesh", "dense"],
                        ["--mesh", "tp"]):
        sys.exit(main_mesh(mode="".join(sys.argv[2:])))
    sys.exit(main())
