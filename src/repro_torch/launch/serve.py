"""Serving launcher: continuous-batching generation with the ServeEngine.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3_1p7b \\
      [--device cuda] [--reduced] [--requests 8] [--new-tokens 8] \\
      [--max-batch 4] [--page-size 16] [--max-len 64] [--n-pages 0] \\
      [--temperature 0.8] [--top-k 40] [--top-p 0.95] \\
      [--priority 0,1] [--ttft-slo 0.5] [--tpot-slo 0.1] \\
      [--preempt-policy auto] \\
      [--shared-prefix-len 0] [--no-share-prefix] [--stream] \\
      [--no-partial-prefix] [--prefill-chunk-tokens 0] \\
      [--spec-cf 4 --spec-k 4] [--stats] [--mesh dp,tp] \\
      [--metrics-json metrics.json] [--trace-out trace.json]

Port of :mod:`repro.launch.serve` for attention decoders and the SSM
and hybrid families (``--arch falcon_mamba_7b``, ``--arch
zamba2_1p2b``), on one card: the model runs at the config's full width
from random weights made from
``--seed`` (``--reduced`` shrinks it for CPU runs with ``--device
cpu``). Without a CUDA device and without ``--device cpu`` it exits with
an error instead of running on the CPU. ``--spec-cf`` turns on
coarse-propagator speculative decoding (:mod:`repro_torch.serve.spec`):
the paper's coarse grid — every cf-th layer, ODE step rescaled — drafts
``--spec-k`` tokens per wave and the full model verifies them in one
call (greedy output is plain decode's).

``--mesh dp,tp`` serves on a ("data", "model") mesh of dp x tp ranks,
one process a rank, under the reference's ``serve_sharding`` rules
(Megatron tensor parallelism over ``model``, slots and page pools over
``data``). The ranks come from a launcher's environment (``torchrun
--nproc-per-node N``: RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT,
LOCAL_RANK; NCCL on the cards, rank r on ``cuda:LOCAL_RANK``, gloo with
``--device cpu``); ``--mesh 1,1`` without one opens a world-1 group in
this process. Every rank builds the same weights from ``--seed`` and
serves the same queue; rank 0 prints.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; fails without a card) or cpu")
    ap.add_argument("--reduced", action="store_true",
                    help="tiny widths for CPU runs (configs/reduce.py)")
    ap.add_argument("--requests", type=int, default=8,
                    help="number of queued requests")
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--max-batch", type=int, default=4,
                    help="in-flight decode slots")
    ap.add_argument("--page-size", type=int, default=16,
                    help="KV page size (tokens)")
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--n-pages", type=int, default=0,
                    help="page-pool size incl. scratch (0 = every slot "
                         "fits max_len; small pools exercise rejection/"
                         "skip-ahead/preemption)")
    ap.add_argument("--priority", default="0",
                    help="comma list cycled over requests, smaller = more "
                         "urgent (e.g. 0,2 alternates urgent/background)")
    ap.add_argument("--ttft-slo", type=float, default=0.0,
                    help="> 0 attaches a time-to-first-token target (s) "
                         "to every request; reported, never enforced")
    ap.add_argument("--tpot-slo", type=float, default=0.0,
                    help="> 0 attaches a per-output-token target (s)")
    ap.add_argument("--preempt-policy", default="auto",
                    choices=["auto", "spill", "recompute", "off"],
                    help="how urgent requests take pages from running "
                         "ones under pressure (docs/scheduling.md)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="0 = greedy; > 0 samples")
    ap.add_argument("--top-k", type=int, default=0, help="0 disables")
    ap.add_argument("--top-p", type=float, default=1.0, help="1 disables")
    ap.add_argument("--shared-prefix-len", type=int, default=0,
                    help="prepend this many common tokens to every prompt "
                         "(demonstrates prefix sharing)")
    ap.add_argument("--no-share-prefix", action="store_true",
                    help="disable the prefix cache / copy-on-write pages")
    ap.add_argument("--no-partial-prefix", action="store_true",
                    help="disable token-granular partial-page prefix "
                         "sharing (whole-page trie matching only)")
    ap.add_argument("--prefill-chunk-tokens", type=int, default=0,
                    help="> 0 interleaves chunked prefill with decode: "
                         "at most this many prompt tokens ingest per "
                         "scheduler wave")
    ap.add_argument("--stream", action="store_true",
                    help="stream the first request token-by-token")
    ap.add_argument("--spec-cf", type=int, default=0,
                    help="> 0 enables coarse-propagator speculative "
                         "decoding with this layer-coarsening factor")
    ap.add_argument("--spec-k", type=int, default=4,
                    help="drafted tokens per verify wave")
    ap.add_argument("--stats", action="store_true",
                    help="print the engine's full counter dict")
    ap.add_argument("--mesh", default="",
                    help="dp,tp: serve on a (data, model) mesh of that "
                         "many ranks (from a launcher's environment)")
    ap.add_argument("--metrics-json", default="",
                    help="write the metrics-registry snapshot as JSON here")
    ap.add_argument("--trace-out", default="",
                    help="write the request-lifecycle trace as Chrome/"
                         "Perfetto trace-event JSON here")
    args = ap.parse_args(argv)

    from repro_torch.configs import registry
    from repro_torch.configs.reduce import reduce_config
    from repro_torch.device import resolve_device
    from repro_torch.models import transformer
    from repro_torch.serve.engine import Request, ServeEngine
    from repro_torch.serve.spec import SpecConfig

    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"error: {e}") from None
    mesh = _mesh(args.mesh, device.type) if args.mesh else None
    if mesh is not None and mesh_rank() > 0:
        sys.stdout = open(os.devnull, "w")       # rank 0 prints
    rcfg = registry.get_config(args.arch, "decode_32k")
    if args.reduced:
        rcfg = reduce_config(rcfg)
    params = transformer.init_model(rcfg, seed=args.seed, device=device)
    spec = SpecConfig(cf=args.spec_cf, k=args.spec_k) \
        if args.spec_cf > 0 else None
    engine = ServeEngine(rcfg, params, max_len=args.max_len,
                         max_batch=args.max_batch,
                         page_size=args.page_size, n_pages=args.n_pages,
                         share_prefix=not args.no_share_prefix,
                         partial_prefix=not args.no_partial_prefix,
                         prefill_chunk_tokens=args.prefill_chunk_tokens,
                         spec=spec, preempt_policy=args.preempt_policy,
                         mesh=mesh, device=device)
    del params                       # the backend holds its serving copy
    print(f"engine: paged continuous-batching via "
          f"{type(engine.backend).__name__} on {engine.device}"
          + (f", mesh {dict(mesh.shape)}" if mesh is not None else "")
          + (f" + spec decode (cf={spec.cf}, k={spec.k}, "
             f"{engine.scheduler.spec.n_coarse} coarse layers)"
             if spec else ""))
    rng = np.random.default_rng(args.seed)
    common = rng.integers(0, rcfg.model.vocab_size,
                          size=args.shared_prefix_len).astype(np.int32)
    priorities = [int(p) for p in args.priority.split(",")]
    reqs = [Request(prompt=np.concatenate([common, rng.integers(
                0, rcfg.model.vocab_size,
                size=int(rng.integers(4, 12))).astype(np.int32)]),
                    max_new_tokens=args.new_tokens,
                    temperature=args.temperature, top_k=args.top_k,
                    top_p=args.top_p, seed=int(rng.integers(0, 2**31)),
                    priority=priorities[i % len(priorities)],
                    ttft_target_s=args.ttft_slo or None,
                    tpot_target_s=args.tpot_slo or None)
            for i in range(args.requests)]
    if args.stream:
        first, rest = reqs[0], reqs[1:]
        stream = engine.submit(first, stream=True)
        rest_rids = [engine.submit(r) for r in rest]
        print("request 0 (streamed): ", end="", flush=True)
        for _tok, piece in stream:
            print(piece, end="", flush=True)
        print()
        done = engine.scheduler.run()
        for r, rid in zip(rest, rest_rids, strict=True):
            ServeEngine._finalize(r, done.pop(rid))
        out = [first] + rest
    else:
        out = engine.generate(reqs)
    for i, r in enumerate(out):
        if r.error is not None:
            print(f"request {i}: prompt[{len(r.prompt)}] FAILED: {r.error}")
            continue
        lat = f" ttft={r.ttft_s*1e3:.0f}ms lat={r.latency_s*1e3:.0f}ms" \
            if r.ttft_s is not None else ""
        prio = f" prio={r.priority}" if len(priorities) > 1 else ""
        print(f"request {i}: prompt[{len(r.prompt)}] -> "
              f"{list(map(int, r.output))}{lat}{prio}")
    thr = engine.scheduler.throughput()
    st = engine.scheduler.stats
    print(f"aggregate: prefill {thr['prefill_tok_s']:.1f} tok/s, "
          f"decode {thr['decode_tok_s']:.1f} tok/s "
          f"({thr['decode_steps']:.0f} decode steps, "
          f"{thr['prefill_calls']:.0f} prefill calls)")
    print(f"prefix sharing: {st['shared_tokens']} prompt tokens "
          f"reused, {st['pages_shared']} pages shared, "
          f"{st['pages_allocated']} pages allocated")
    if st["prefix_partial_hits"]:
        print(f"  token-granular: {st['prefix_partial_hits']} partial-"
              f"page hits, {st['prefix_partial_tokens_shared']} tokens "
              f"reused via fork_partial")
    if st["prefill_chunks"]:
        print(f"chunked prefill: {st['prefill_chunks']} ingest waves at "
              f"budget {args.prefill_chunk_tokens} tokens")
    if st["requests_failed"] or st["preemptions"]:
        print(f"overload: {st['requests_rejected']} rejected, "
              f"{st['requests_failed']} failed, "
              f"{st['preemptions']} preemptions "
              f"({st['pages_spilled']} pages spilled, "
              f"{st['pages_restored']} restored, "
              f"{st['preempt_recomputes']} recompute resumes)")

    def _pcts(hist_name):
        h = engine.obs.metrics.histogram(hist_name)
        if h is None or h.count == 0:
            return None
        p = h.percentiles()
        return (f"p50/p95/p99 = {p['p50']*1e3:.0f}/{p['p95']*1e3:.0f}/"
                f"{p['p99']*1e3:.0f} ms")
    ttft_p, tpot_p = _pcts("request.ttft_s"), _pcts("request.tpot_s")
    if ttft_p or tpot_p:
        print("latency percentiles (registry): "
              + " ".join(f"{k} {v}" for k, v in
                         (("ttft", ttft_p), ("tpot", tpot_p)) if v))
    if args.ttft_slo or args.tpot_slo:
        ok = sum(r.slo_met for r in out)
        print(f"SLO attainment: {ok}/{len(out)} requests met "
              f"ttft<={args.ttft_slo or float('inf'):g}s "
              f"tpot<={args.tpot_slo or float('inf'):g}s")
    if args.stats:
        print("engine stats:")
        for key, val in sorted(engine.stats.items()):
            print(f"  {key} = {val:.4f}" if isinstance(val, float)
                  else f"  {key} = {val}")
    if spec:
        es = engine.stats
        print(f"spec decode: {es['tokens_accepted']}/"
              f"{es['tokens_drafted']} drafted tokens accepted "
              f"({100 * es['accept_rate']:.0f}%), "
              f"{es['draft_calls']} draft calls, "
              f"{es['verify_calls']} verify waves")
    if args.metrics_json:
        import json
        with open(args.metrics_json, "w") as f:
            json.dump(engine.metrics_snapshot(), f, indent=2,
                      default=float)
        print(f"metrics snapshot -> {args.metrics_json}")
    if args.trace_out:
        n = engine.save_trace(args.trace_out)
        print(f"lifecycle trace -> {args.trace_out} ({n} events; open "
              f"at https://ui.perfetto.dev)")
    print(f"steady-state decode probe: "
          f"{engine.throughput_probe(args.max_batch):.1f} tok/s")
    return 0


def mesh_rank() -> int:
    import torch.distributed as dist
    return dist.get_rank()


def _mesh(spec: str, device_type: str):
    """The ("data", "model") mesh of ``--mesh dp,tp`` over the launcher's
    group (a world-1 group of this process for 1,1 without one)."""
    from repro_torch.launch import mesh as mesh_mod
    dp, tp = (int(x) for x in spec.split(","))
    if not mesh_mod.init_from_env(device_type):
        if dp * tp != 1:
            raise SystemExit(f"error: --mesh {spec} needs {dp * tp} ranks: "
                             "launch them with torchrun --nproc-per-node")
        return mesh_mod.make_host_mesh(device_type)
    return mesh_mod.make_mesh((dp, tp), ("data", "model"), device_type)


if __name__ == "__main__":
    sys.exit(main())
