#!/usr/bin/env python3
"""Do fresh one-card qwen3-moe engines repeat their smoke-queue streams?

    python3 tools/moe_stream_repeat.py

On one NVIDIA card: builds the port's kernels, then serves
``chip_smoke.py``'s smoke queue (seed 23) through two fresh
``ServeEngine``s of qwen3_moe_235b at 8 stacked layers (full width, bf16
storage, ``max_batch`` 4, page 16) in each of two modes: "old", where
every padded position's K/V row is written to the scratch row in the
device's own order (``attention.last_scratch_writer`` replaced by the
identity), and "last", the port's rule (every such write carries the
last writer's row). Prints, per engine, how many layer writes had two or
more writers of the scratch row and the digest of the pools' scratch
rows after the queue, and per mode how many of the 8 streams differ
between its two engines. Counting the writers reads them back (a host
sync a layer call): a diagnosis, not a timing.
"""
import hashlib
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("moe_stream_repeat: no CUDA device is available")
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.models import attention, transformer
    from repro_torch.serve.engine import ServeEngine
    t0 = time.perf_counter()
    print(f"card: {cs.card_line()}")
    build.build()
    torch.backends.cuda.matmul.allow_tf32 = False
    rcfg = cs.moe_serve_config("qwen3_moe_235b")
    params = transformer.init_model(rcfg, seed=23, device="cuda")
    print(f"build + init {time.perf_counter() - t0:.1f} s", flush=True)
    rule = attention.last_scratch_writer
    tally = []

    def old(flat):
        tally.append(int((flat == 0).sum()))
        return torch.arange(flat.shape[0], device=flat.device)

    def last(flat):
        tally.append(int((flat == 0).sum()))
        return rule(flat)

    res = {}
    try:
        for mode, fn in (("old", old), ("old", old), ("last", last),
                         ("last", last)):
            attention.last_scratch_writer = fn
            tally.clear()
            eng = ServeEngine(rcfg, params, max_batch=cs.MAX_BATCH,
                              page_size=cs.PAGE, max_len=cs.MAX_LEN,
                              device="cuda")
            out = eng.generate(cs.make_queue(np.random.default_rng(23),
                                             rcfg.model.vocab_size))
            torch.cuda.synchronize()
            streams = [r.output.tolist() for r in out]
            st = eng.scheduler.state
            row0 = hashlib.sha256(torch.cat(
                [st["k"][:, 0, 0].float().cpu(),
                 st["v"][:, 0, 0].float().cpu()]).numpy().tobytes()
            ).hexdigest()[:16]
            many = [n for n in tally if n > 1]
            print(f"{mode}: {len(tally)} layer writes, {len(many)} with 2+ "
                  f"scratch-row writers (max {max(tally)}); scratch rows "
                  f"after the queue {row0}", flush=True)
            res.setdefault(mode, []).append((streams, row0))
            del eng
    finally:
        attention.last_scratch_writer = rule
    for mode, ((a, ra), (b, rb)) in res.items():
        diff = [i for i in range(len(a)) if a[i] != b[i]]
        print(f"{mode}: the two engines' streams differ in {len(diff)} of "
              f"{len(a)} requests {diff}; scratch rows after the queue "
              f"{'equal' if ra == rb else 'differ'}")
    print(f"{time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
