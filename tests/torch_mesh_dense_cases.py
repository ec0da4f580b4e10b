"""What each spawned rank of ``tests/test_torch_mesh_dense.py`` runs.

This module imports neither jax nor the JAX package: every rank is a
fresh process (``spawn``) that builds the port's dense decode step, or a
mesh engine, from weights the test converted from JAX (numpy) and
returns numbers only. The families are the reference's
``test_serve_backends.py`` configs (``torch_mesh_serve_cases``; float32,
``MAX_LEN`` 32) and a reduced float32 ``mt_marian`` for the
encoder-decoder family.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist

import torch_mesh_serve_cases as serve_cases
from repro_torch.configs import registry
from repro_torch.configs.reduce import reduce_config
from repro_torch.convert import params_from_jax
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import transformer
from repro_torch.parallel import tp
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.tree import leaf_at, leaves_with_paths, unflatten

MAX_LEN = serve_cases.MAX_LEN
KW = serve_cases.KW
ATTENTION = ("decoder", "encdec")


def rcfg_of(name: str, rules=None):
    """The port's float32 config of ``name``: a serve family, ``encdec``
    (reduced mt_marian) or ``decoder_wide`` (the decoder at widths whose
    embedding and trunk leaves reach the fsdp fallback's 4M elements),
    under ``rules`` (a ShardingConfig) where given."""
    if name == "encdec":
        r = reduce_config(registry.get_config("mt_marian"))
        r = dataclasses.replace(r, model=dataclasses.replace(
            r.model, dtype="float32"))
    elif name == "decoder_wide":
        r = serve_cases.family_rcfg("decoder")
        r = r.replace(model=dataclasses.replace(
            r.model, n_layers=4, d_model=512, n_heads=4, n_kv_heads=2,
            d_ff=4096, vocab_size=8192))
    else:
        r = serve_cases.family_rcfg(name)
    return r if rules is None else r.replace(sharding=rules)


def rules_of(kind: str, name: str):
    """``decode``: the reference's ``decode_sharding()`` (the MoE family
    with its experts over ``data``, as qwen3-moe's config adds them);
    ``long``: ``decode_sharding(long_context=True)``; ``serve``: the
    engine's ``serve_sharding()``."""
    if kind == "serve":
        return registry.serve_sharding()
    rules = registry.decode_sharding(long_context=kind == "long")
    if name == "decoder_moe":
        rules = dataclasses.replace(rules, experts="data")
    return rules


def family(name: str) -> str:
    return rcfg_of(name).model.family


def _np_tree(tree):
    return {".".join(p): t.detach().cpu().numpy().copy()
            for p, t in leaves_with_paths(tree)}


def dense_run(mesh, name, params, rules, prompt, n_steps, xa=None,
              chunks=None):
    """The dense step ``make_serve_fn(rcfg, mesh)`` over a prompt (one
    chunked-prefill call for the attention families, a token a call
    otherwise) and ``n_steps`` greedy tokens fed back, or over
    ``chunks`` alone (teacher forced): each call's tokens and logits
    (the whole batch, gathered), the whole cache at the end, this rank's
    cache and param shapes and the collectives. ``mesh`` None: the step
    without a mesh. ``params`` an int: the port's own init from that
    seed (the same on every rank)."""
    rcfg = rcfg_of(name, rules)
    whole = transformer.init_model(rcfg, seed=params, device="cpu") \
        if isinstance(params, int) else params_from_jax(params, rcfg, "cpu")
    local = whole if mesh is None else \
        steps.shard_decode_params(rcfg, mesh, whole)
    if chunks is not None:
        prompt, n_steps = chunks[0], 0
    B = prompt.shape[0]
    cache = transformer.init_cache(rcfg, B, MAX_LEN, device="cpu",
                                   mesh=mesh)
    shapes = {".".join(p): list(t.shape)
              for p, t in leaves_with_paths(cache)}
    fn = steps.make_serve_fn(rcfg, mesh)
    toks = torch.from_numpy(prompt.astype(np.int64))
    feeds = [toks] if family(name) in ATTENTION else \
        [toks[:, i:i + 1] for i in range(toks.shape[1])]
    if chunks is not None:
        feeds = [torch.from_numpy(c.astype(np.int64)) for c in chunks]
    xa_t = None if xa is None else torch.from_numpy(xa)
    kept = []
    saved = transformer.decode_step

    def record(*a, **kw):
        lg, c = saved(*a, **kw)
        kept.append(lg)
        return lg, c
    if mesh is not None:
        mesh.reset_counts()
    transformer.decode_step = record
    out_tokens = []
    try:
        with torch.no_grad():
            for f in feeds:
                nxt, cache = (fn(local, cache, f) if xa is None
                              else fn(local, cache, f, xa_t))
            for _ in range(n_steps):
                out_tokens.append(nxt[:, 0].tolist())
                nxt, cache = (fn(local, cache, nxt) if xa is None
                              else fn(local, cache, nxt, xa_t))
            if n_steps:
                out_tokens.append(nxt[:, 0].tolist())
    finally:
        transformer.decode_step = saved
    counts = {} if mesh is None else {k: list(v)
                                      for k, v in mesh.counts.items()}
    logits = kept
    if mesh is not None:
        with tp.active(mesh, rcfg.sharding):
            rows = tp.split("batch", B)
        if rows is not None:
            logits = [rows.all_gather("gather", lg, 0) for lg in kept]
        cache = gather_decode_cache(rcfg, mesh, cache, B, MAX_LEN)
    return {"tokens": out_tokens,
            "logits": [lg.numpy().copy() for lg in logits],
            "cache": _np_tree(cache), "local_cache": shapes,
            "local_params": sum(t.numel() for _, t in
                                leaves_with_paths(local)),
            "counts": counts}


def gather_decode_cache(rcfg, mesh, cache, batch: int, max_len: int):
    """The whole dense cache of ``batch`` slots and ``max_len`` rows on
    every rank, from every rank's part (``transformer.init_cache(...,
    mesh=)``'s layout): the inverse of that cut."""
    from repro_torch.models.attention import gather_narrow_kv, \
        narrow_kv_split
    from repro_torch.parallel import params as pparams
    cfg = rcfg.model
    whole = transformer.init_cache(rcfg, batch, max_len, device="meta")
    specs = pparams.cache_specs(whole, rcfg, mesh)
    with tp.active(mesh, rcfg.sharding):
        # under kv_seq each rank's rows hold every KV head
        narrow = (None if tp.seq_split(max_len) is not None
                  else narrow_kv_split(cfg))

    def one(path, leaf):
        spec = leaf_at(specs, path)
        if narrow is not None and path[-1] in ("k", "v"):
            leaf = gather_narrow_kv(mesh, "gather", leaf, narrow,
                                    cfg.n_kv_heads)
            spec = spec[:3] + (None,) + spec[4:]
        return pparams.gather_leaf(leaf, path, spec, mesh,
                                   executed=pparams.DECODE_EXECUTED,
                                   cfg=cfg, logical=pparams.cache_logical)

    return unflatten((p, one(p, t)) for p, t in leaves_with_paths(cache))


def dense_case(mesh, case):
    """One family's dense step under ``case["rules"]`` (``rules_of``);
    with ``one`` also without a mesh (global rank 0)."""
    rules = rules_of(case["rules"], case["name"])
    args = (case["name"], case["params"], rules, case.get("prompt"),
            case.get("steps", 0), case.get("xa"), case.get("chunks"))
    out = {"mesh": dense_run(mesh, *args)}
    if case.get("one") and dist.get_rank() == 0:
        out["one"] = dense_run(None, *args)
    return out


def world1_case(mesh, case):
    """A world-1 mesh against no mesh in this process, under
    ``decode_sharding()``: every result of :func:`dense_run`."""
    rules = rules_of("decode", case["name"])
    return {label: dense_run(m, case["name"], case["params"], rules,
                             case["prompt"], case["steps"], case.get("xa"))
            for label, m in (("mesh", mesh), ("none", None))}


def engine_case(mesh, case):
    """A mesh engine's dense route under its own rules
    (``serve_sharding``): ``throughput_probe(paged=False)`` and the dense
    oracle's greedy streams of the requests, on the weights its backend
    holds cut."""
    rcfg = rcfg_of(case["name"])
    params = params_from_jax(case["params"], rcfg, "cpu")
    eng = ServeEngine(rcfg, params, mesh=mesh, **KW)
    mesh.reset_counts()
    streams = [eng.dense_oracle(np.asarray(p, np.int32), n).tolist()
               for p, n in case["requests"]]
    counts = {k: list(v) for k, v in mesh.counts.items()}
    rate = eng.throughput_probe(KW["max_batch"], steps=2, paged=False)
    return {"streams": streams, "counts": counts, "rate": rate}


def _requests(reqs):
    return [Request(prompt=np.asarray(p, np.int32), max_new_tokens=n)
            for p, n in reqs]


def prefix_save_case(mesh, case):
    """A mesh engine serves the requests, then saves its prefix cache to
    ``case["path"]``: the streams, the pages saved and cached."""
    rcfg = rcfg_of(case["name"])
    params = params_from_jax(case["params"], rcfg, "cpu")
    eng = ServeEngine(rcfg, params, mesh=mesh, **KW)
    streams = [r.output.tolist() for r in
               eng.generate(_requests(case["requests"]))]
    n = eng.save_prefix_cache(case["path"])
    return {"streams": streams, "saved": n,
            "cached": eng.scheduler.prefix.n_cached_pages,
            "exists": os.path.exists(case["path"])}


def prefix_load_case(mesh, case):
    """A fresh mesh engine loads ``case["path"]`` and serves the
    requests: the pages restored, the streams, the shared tokens and
    the free pages once the cache is dropped; then an engine of another
    page size refuses the file."""
    rcfg = rcfg_of(case["name"])
    params = params_from_jax(case["params"], rcfg, "cpu")
    eng = ServeEngine(rcfg, params, mesh=mesh, prefix_cache_path=case["path"],
                      **KW)
    restored = eng.scheduler.prefix.n_cached_pages
    streams = [r.output.tolist() for r in
               eng.generate(_requests(case["requests"]))]
    out = {"restored": restored, "streams": streams,
           "shared": int(eng.scheduler.stats["shared_tokens"])}
    eng.scheduler.drop_prefix_cache()
    alloc = eng.scheduler.alloc
    out["free"] = [alloc.n_free, alloc.n_pages - alloc.groups]
    other = ServeEngine(rcfg, params, mesh=mesh, **dict(KW, page_size=8))
    try:
        other.load_prefix_cache(case["path"])
    except ValueError as e:
        out["mismatch"] = str(e)
    return out


CASES = {"dense": dense_case, "world1": world1_case, "engine": engine_case,
         "prefix_save": prefix_save_case, "prefix_load": prefix_load_case}


def run(shapes_and_cases):
    """This rank's results of every (shape, [(kind, case), ...]) in
    turn, each shape a fresh ("data", "model") mesh over the same
    ranks."""
    out = []
    for shape, cases in shapes_and_cases:
        mesh = make_mesh(shape, ("data", "model"), "cpu")
        out.append([CASES[kind](mesh, case) for kind, case in cases])
    return {"rank": dist.get_rank(), "threads": torch.get_num_threads(),
            "results": out}

