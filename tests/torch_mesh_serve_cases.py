"""What each spawned rank of ``tests/test_torch_mesh_serve.py`` runs.

This module imports neither jax nor the JAX package: every rank is a
fresh process (``spawn``) that builds the port's engines from the
weights the test converted from JAX (numpy) and returns numbers only.
The families are the reference's ``test_serve_backends.py`` configs
(float32, ``MAX_LEN`` 32, ``max_batch`` 2, ``page_size`` 4) and the
requests its ``test_serve_mesh.py``'s.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import registry
from repro_torch.configs.base import (MGRITConfig, ModelConfig, MoEConfig,
                                      OptimizerConfig, RunConfig,
                                      ShapeConfig, SSMConfig)
from repro_torch.convert import params_from_jax
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import transformer
from repro_torch.serve import scheduler as sched_mod
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.spec import SpecConfig
from repro_torch.tree import leaves_with_paths

VOCAB = 64
MAX_LEN = 32
KW = dict(max_len=MAX_LEN, max_batch=2, page_size=4, device="cpu")
FAMILIES = {
    "decoder": dict(family="decoder"),
    "decoder_moe": dict(family="decoder",
                        moe=MoEConfig(num_experts=4, top_k=2, d_ff=64)),
    # one KV head: at tp 2 the query heads split, the KV heads stay whole
    "decoder_mqa": dict(family="decoder", n_heads=4, n_kv_heads=1),
    "ssm_mamba1": dict(family="ssm", n_layers=4, act="silu", norm="rmsnorm",
                       ssm=SSMConfig(version=1, d_state=8, d_conv=3)),
    "hybrid": dict(family="hybrid", n_layers=5, hybrid_attn_every=2,
                   act="silu", norm="rmsnorm",
                   ssm=SSMConfig(version=2, d_state=8, d_conv=3,
                                 headdim=16)),
}


def family_rcfg(name: str) -> RunConfig:
    """``test_serve_backends.family_rcfg(name)`` in the port's configs."""
    kw = dict(name=name, family="decoder", n_layers=8, d_model=32,
              n_heads=2, n_kv_heads=2, d_ff=64, vocab_size=VOCAB,
              act="gelu", norm="layernorm", dtype="float32")
    kw.update(FAMILIES[name])
    return RunConfig(
        model=ModelConfig(**kw),
        mgrit=MGRITConfig(enabled=True, cf=2, levels=2, fwd_iters=1,
                          bwd_iters=1, n_open=1, n_close=1, pad_to=2),
        optimizer=OptimizerConfig(), shape=ShapeConfig(name, "train", 16, 4))


def requests(new: int = 5, sampled: bool = True):
    """The reference mesh test's two requests: greedy [5, 9, 3, 7, 2] and
    sampled [4, 2, 9] (temperature 1.1, top-k 16, top-p 0.9, seed 7);
    ``sampled=False`` makes the second greedy too (its spec check)."""
    samp = dict(temperature=1.1, top_k=16, top_p=0.9, seed=7) if sampled \
        else {}
    return [Request(prompt=np.array([5, 9, 3, 7, 2], np.int32),
                    max_new_tokens=new),
            Request(prompt=np.array([4, 2, 9], np.int32),
                    max_new_tokens=new, **samp)]


def _streams(engine, reqs):
    return [r.output.tolist() for r in engine.generate(reqs)]


def _counts(mesh):
    return {k: list(v) for k, v in mesh.counts.items()}


def _pools(engine):
    return {".".join(p): list(t.shape)
            for p, t in leaves_with_paths(engine.scheduler.state)}


def serve_case(mesh, case):
    """One family on ``mesh``: the fused and the gathered engine's
    streams of the two requests, their collectives, the stats' mesh
    shape, the local pool shapes and the pool's page count; with
    ``spec`` also greedy plain and spec (cf 2, k 3) streams and the
    drafted count; with ``one`` (global rank 0) the no-mesh engine's
    streams beside. Without ``params``: the port's seeded init; with
    ``sharding``, those fields of the serve rules replaced."""
    rcfg = family_rcfg(case["name"])
    params = params_from_jax(case["params"], rcfg, "cpu") \
        if "params" in case else transformer.init_model(rcfg, device="cpu")
    rules = dataclasses.replace(registry.serve_sharding(),
                                **case.get("sharding", {}))
    out = {}
    for route, fused in (("fused", True), ("gathered", False)):
        mesh.reset_counts()
        eng = ServeEngine(rcfg, params, mesh=mesh, fused=fused,
                          sharding=rules, **KW)
        out[route] = _streams(eng, requests())
        out[f"{route}_flag"] = bool(eng.backend.fused)
        out[f"{route}_counts"] = _counts(mesh)
    st = eng.stats
    out["stats"] = [st["mesh_dp"], st["mesh_tp"], st["mesh_devices"]]
    out["pools"] = _pools(eng)
    # the reference's shard_state: a whole pool cut to this rank's part
    whole = ServeEngine(rcfg, params, **KW).backend.init_state(
        eng.scheduler.alloc.n_pages)
    out["shard_state"] = {".".join(p): list(t.shape) for p, t in
                          leaves_with_paths(eng.backend.shard_state(whole))}
    out["n_pages"] = eng.scheduler.alloc.n_pages
    if case.get("spec"):
        greedy = requests(6, sampled=False)
        out["plain6"] = _streams(ServeEngine(rcfg, params, mesh=mesh, **KW),
                                 greedy)
        spec = ServeEngine(rcfg, params, mesh=mesh,
                           spec=SpecConfig(cf=2, k=3), **KW)
        out["spec6"] = _streams(spec, requests(6, sampled=False))
        out["drafted"] = int(spec.stats["tokens_drafted"])
    if case.get("one") and dist.get_rank() == 0:
        out["one"] = _streams(ServeEngine(rcfg, params, **KW), requests())
    return out


def _step_logits(backend, state, rcfg):
    """One 5-token prefill of both slots then one decode step through the
    backend's own paged forward (under its rules), the logits of each."""
    table = np.asarray([[1, 2], [3, 4]], np.int32)
    if backend.rows is not None:
        table = backend.rows.table(table)
    toks = torch.tensor([[5, 9, 3, 7, 2], [4, 2, 9, 0, 0]])
    lens = torch.zeros(2, dtype=torch.int32)
    n_new = torch.tensor([5, 3])
    decode = backend._decode_fn()
    out = []
    with backend._rules():
        for t, ln, nn in ((toks, lens, n_new),
                          (torch.tensor([[11], [13]]),
                           lens + n_new.to(torch.int32),
                           torch.ones(2, dtype=torch.long))):
            lg, state = decode(backend.params, state, t, ln, nn,
                               torch.from_numpy(table), rcfg)
            out.append(lg.numpy().copy())
    return out


def logits_case(mesh, case):
    """A prefill and a decode step's logits through a mesh backend; on
    global rank 0 also through the no-mesh backend (the one-rank
    port), and the mesh's collectives of the two steps."""
    rcfg = family_rcfg(case["name"])
    params = params_from_jax(case["params"], rcfg, "cpu")
    out = {}
    runs = (("mesh", mesh),) + ((("one", None),)
                                if dist.get_rank() == 0 else ())
    for name, m in runs:
        eng = ServeEngine(rcfg, params, mesh=m, **KW)
        be = eng.backend
        if m is not None:
            m.reset_counts()
        out[name] = _step_logits(be, be.init_state(
            eng.scheduler.alloc.n_pages), eng.backend.rcfg)
        if m is not None:
            out["counts"] = _counts(m)
    return out


class _SkewedClock:
    """``time`` as the scheduler sees it on a rank whose clock runs at
    ``rate`` times real time from ``offset`` seconds."""

    def __init__(self, rate: float, offset: float):
        self.rate, self.offset = rate, offset

    def perf_counter(self):
        return self.offset + self.rate * time.perf_counter()


def skew_case(mesh, case):
    """Host decisions under skewed clocks: every rank but 0 reads a clock
    ``case["rate"]`` times as fast, from another origin. A queue of
    mixed priorities and TTFT targets, submitted with real gaps between
    them, over a pool small enough to reject, skip ahead and preempt
    (cost model 'auto'). Returns the lifecycle events without their
    times (kind, rid, slot, wave), the streams, and the prefill rate
    this rank measured beside the agreed one."""
    if dist.get_rank() > 0:
        sched_mod.time = _SkewedClock(case["rate"], 1e4)
    try:
        rcfg = family_rcfg(case["name"])
        params = params_from_jax(case["params"], rcfg, "cpu")
        eng = ServeEngine(rcfg, params, mesh=mesh, preempt_policy="auto",
                          **dict(KW, max_batch=2, n_pages=case["n_pages"]))
        rng = np.random.default_rng(3)
        reqs = []
        for i, (prio, ttft) in enumerate(case["queue"]):
            reqs.append(Request(
                prompt=rng.integers(0, VOCAB, 3 + 4 * (i % 3)).astype(
                    np.int32), max_new_tokens=6 + 2 * (i % 2),
                priority=prio, ttft_target_s=ttft))
        rids = [eng.submit(r) for r in reqs[:2]]
        eng.scheduler.step()               # two running, then the rest
        for r in reqs[2:]:
            time.sleep(case["gap_s"])
            rids.append(eng.submit(r))
        done = eng.scheduler.run()
        events = [(ev[3], ev[4], ev[5], ev[6])
                  for ev in eng.obs.trace.events() if ev[4] >= 0]
        sched = eng.scheduler
        return {"events": events,
                "streams": [done[i].out for i in rids],
                "errors": [done[i].error for i in rids],
                "stats": {k: sched.stats[k] for k in (
                    "preemptions", "pages_spilled", "preempt_recomputes",
                    "requests_rejected")},
                "rate_local": sched._prefill_rate(),
                "rate_agreed": sched._agreed[1]}
    finally:
        sched_mod.time = time


def refusal_case(mesh, case):
    """The dense probe a mesh engine runs, and what it refuses, the
    message naming its ROADMAP item: rules that split kv_seq or fsdp."""
    out = {}
    rcfg = family_rcfg("decoder")
    eng = ServeEngine(rcfg, transformer.init_model(rcfg, device="cpu"),
                      mesh=mesh, **KW)
    out["dense"] = eng.throughput_probe(2, paged=False)
    try:
        ServeEngine(rcfg, transformer.init_model(rcfg, device="cpu"),
                    mesh=mesh, sharding=registry.decode_sharding(), **KW)
    except NotImplementedError as e:
        out["kv_seq"] = str(e)
    return out


def world1_case(mesh, case):
    """A world-1 mesh against no mesh in this process: every family's
    fused streams of the two requests, one step's logits, and the
    mesh's collectives."""
    out = {}
    for name, params in case["params"].items():
        rcfg = family_rcfg(name)
        params = params_from_jax(params, rcfg, "cpu")
        res = {}
        for label, m in (("mesh", mesh), ("none", None)):
            if m is not None:
                m.reset_counts()
            eng = ServeEngine(rcfg, params, mesh=m, **KW)
            res[label] = {
                "streams": _streams(eng, requests()),
                "logits": _step_logits(eng.backend, eng.backend.init_state(
                    eng.scheduler.alloc.n_pages), eng.backend.rcfg)}
            if m is not None:
                res["counts"] = _counts(m)
        out[name] = res
    return out


CASES = {"serve": serve_case, "logits": logits_case, "skew": skew_case,
         "refusal": refusal_case, "world1": world1_case}


def run(shape, cases):
    """This rank's results of every case ``(kind, case)`` on a
    ("data", "model") mesh of ``shape``."""
    mesh = make_mesh(shape, ("data", "model"), "cpu")
    return {"rank": dist.get_rank(), "threads": torch.get_num_threads(),
            "results": [CASES[kind](mesh, case) for kind, case in cases]}

