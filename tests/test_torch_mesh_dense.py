"""Dense-cache decode and prefix-cache persistence under a mesh on the
CPU: the port's ``make_serve_fn(rcfg, mesh)`` (explicit SPMD over
``torch.distributed``, gloo ranks spawned by
``repro_torch.launch.hostdev.spawn_host_ranks``) against the JAX
package's single-device ``transformer.decode_step`` on the same
converted weights, and the mesh engine's dense route and prefix files
against JAX's engine.

- The reference's ``test_serve_backends.py`` families (decoder, MQA
  decoder, MoE decoder, mamba1, hybrid) and a reduced float32
  ``mt_marian`` (its ``xa`` from JAX's encoder), under
  ``decode_sharding()`` at (1, 2), (2, 1) and (2, 2) (B 2; the MoE
  family's experts over ``data``) and the long-context rules at (2, 2)
  (B 1, the cache's rows over ``data`` and ``model``): a prompt, then 3
  greedy tokens fed back. Each call's logits within 2e-5 of JAX's, the
  greedy tokens JAX's wherever its top-2 margin exceeds that, the cache
  gathered whole within 2e-5 (SSM state 1e-4); every rank's tokens
  equal. A chunk longer than a slice, and a write at the clamp
  (``max_len - S``).
- fsdp storage: the decoder widened until its embedding and trunk
  leaves reach the fsdp fallback's 4M elements, at (2, 1) and (2, 2),
  within 2e-5 of the one-rank port, its leaves gathered (``fsdp_gather``).
- A world-1 mesh is bitwise the step without one, with no collective.
- A mesh engine's ``throughput_probe(paged=False)`` and dense oracle
  under its ``serve_sharding`` rules at (1, 2) and (2, 1): the oracle's
  streams JAX's.
- The lse route's plain version against a float64 log-sum-exp, at local
  lengths <= 0, inside and past a slice.
- Prefix persistence (the mirror of ``test_serve_spec.py``'s): files
  saved by (2, 1), (1, 2) and (2, 2) engines load into JAX's
  ``ServeEngine(prefix_cache_path=...)`` and a one-rank port engine,
  which serve the requests token for token as JAX's uninterrupted
  engine, reusing the restored pages; a one-rank file loads into a
  (2, 2) engine; the (2, 2) file's arrays lie within 2e-5 of the
  one-rank file's; another page size raises on every rank.

Three spawns (2, 4 and 1 ranks; per-rank code
``tests/torch_mesh_dense_cases.py``, jax-free, one thread a rank) run in
background threads while JAX computes its side.
"""
import concurrent.futures
import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_dense_cases as cases
from repro.models import transformer as jtr
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.convert import params_from_jax
from repro_torch.kernels import paged_attention as pa
from repro_torch.launch.hostdev import spawn_host_ranks
from repro_torch.models import transformer as ttr
from repro_torch.serve.engine import Request, ServeEngine
from serve_oracle import engine_outputs
from test_serve_backends import family_rcfg as j_family
from test_torch_train import f32_configs

FAMILIES = ("decoder", "decoder_mqa", "decoder_moe", "ssm_mamba1", "hybrid",
            "encdec")
LONG = ("decoder", "decoder_mqa", "ssm_mamba1", "hybrid", "encdec")
TOL = 2e-5
SSM_TOL = 1e-4
B, PROMPT, STEPS, SRC = 2, 5, 3, 7
SPAWN_S = 300.0
ENGINE_FAMILIES = ("decoder", "ssm_mamba1")
PREFIX_SAVES = (((2, 1), "decoder"), ((1, 2), "decoder"),
                ((2, 2), "decoder"), ((1, 2), "ssm_mamba1"))
COMMON = np.arange(1, 9, dtype=np.int32) % cases.serve_cases.VOCAB
PREFIX_REQS = [(np.concatenate([COMMON, np.array([20 + i], np.int32)]), 4)
               for i in range(2)]
# chunks of 20, 8 and 5 rows into 32 at (1, 2) (16 a slice): the first
# longer than a slice, the last starting at 28, clamped to 27
CLAMP_CHUNKS = (20, 8, 5)


def j_rcfg(name):
    if name == "encdec":
        return f32_configs("mt_marian")[0]
    if name == "decoder_mqa":
        r = j_family("decoder")
        return dataclasses.replace(r, model=dataclasses.replace(
            r.model, name=name, n_heads=4, n_kv_heads=1))
    return j_family(name)


@functools.lru_cache(maxsize=None)
def j_params(name):
    """JAX's config of ``name`` and weights in JAX's tree, drawn by the
    port's seeded init (the trees match leaf for leaf; JAX's own eager
    init takes seconds a family)."""
    tree = ttr.init_model(cases.rcfg_of(name), seed=sum(map(ord, name)),
                          device="cpu")
    return j_rcfg(name), jax.tree.map(lambda t: jnp.asarray(t.numpy()),
                                      tree)


def encoder_out(jr, jp, batch):
    """X_enc from JAX's serial encoder over a numpy source."""
    cfg = jr.model
    src = np.random.default_rng(7).integers(
        0, cfg.vocab_size, (batch, SRC)).astype(np.int32)
    xe = jtr.embed_tokens(jp["embed"], jnp.asarray(src), cfg)
    xN, _ = jtr._trunk(jp["enc_mid"], xe, jr, kind="attn_mlp",
                       causal=False, rope=jtr._rope_for(cfg, SRC),
                       mode="serial")
    return np.asarray(xN)


def prompt_of(name, batch):
    vocab = j_rcfg(name).model.vocab_size
    return np.random.default_rng(3).integers(
        0, vocab, (batch, PROMPT)).astype(np.int32)


def jax_decode(name, batch, chunks=None):
    """JAX's single-device decode over the prompt (one chunk for the
    attention families, a token a call otherwise) and STEPS greedy
    tokens fed back, or over ``chunks`` (teacher forced): (logits of
    every call, tokens, the final cache flattened)."""
    rcfg, params = j_params(name)
    xa = encoder_out(rcfg, params, batch) if name == "encdec" else None
    attn = cases.family(name) in cases.ATTENTION

    def step(p, c, t):
        return jtr.decode_step(p, c, t, rcfg, xa=xa)
    if not attn:
        # a token a call: one compile beats many eager steps; a few
        # chunked calls run faster eagerly than compiled
        step = jax.jit(step)
    cache = jtr.init_cache(rcfg, batch, cases.MAX_LEN)
    if chunks is not None:
        feeds, n = list(chunks), 0
    else:
        prompt = prompt_of(name, batch)
        feeds = [prompt] if attn else [prompt[:, i:i + 1]
                                       for i in range(PROMPT)]
        n = STEPS
    logits, tokens = [], []
    for f in feeds:
        lg, cache = step(params, cache, jnp.asarray(f))
        logits.append(np.asarray(lg))
    for _ in range(n):
        nxt = np.asarray(jnp.argmax(lg[:, -1], -1), np.int32)
        tokens.append(nxt.tolist())
        lg, cache = step(params, cache, jnp.asarray(nxt[:, None]))
        logits.append(np.asarray(lg))
    if n:
        tokens.append(np.asarray(jnp.argmax(lg[:, -1], -1)).tolist())
    return logits, tokens, flatten(jax.tree.map(np.asarray, cache))


def flatten(tree, path=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flatten(v, f"{path}.{k}".lstrip(".")))
        return out
    return {path: tree}


def np_params(name):
    return jax.tree.map(np.asarray, j_params(name)[1])


def dense_todo(name, rules, batch, **kw):
    case = {"name": name, "params": np_params(name), "rules": rules,
            "prompt": prompt_of(name, B)[:batch], "steps": STEPS, **kw}
    if name == "encdec":
        rcfg, params = j_params(name)
        case["xa"] = encoder_out(rcfg, params, B)[:batch]
    return ("dense", case)


def spawn(n, todo):
    """Spawn ``n`` ranks over ``todo``: [(shape, [(label, (kind, case)),
    ...]), ...]; returns each rank's results by (shape, label)."""
    plan = [(shape, [kc for _, kc in items]) for shape, items in todo]
    res = spawn_host_ranks(n, cases.run, plan, threads=1, timeout=SPAWN_S)
    assert [r["rank"] for r in res] == list(range(n))
    assert all(r["threads"] == 1 for r in res)
    return [{(shape, label): r["results"][i][j]
             for i, (shape, items) in enumerate(todo)
             for j, (label, _) in enumerate(items)} for r in res]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every spawn's per-rank results, JAX's decode of every family, and
    the prefix files with JAX's streams."""
    tmp = tmp_path_factory.mktemp("mesh_dense")
    wide = {"name": "decoder_wide", "params": 5,
            "prompt": prompt_of("decoder", B) * 97 % 8192, "steps": STEPS,
            "one": True}
    files = {(s, n): str(tmp / f"{s[0]}x{s[1]}_{n}.npz")
             for s, n in PREFIX_SAVES}
    # a one-rank port file, for the (2, 2) engine to load
    one_path = str(tmp / "one_rank.npz")
    rcfg = cases.rcfg_of("decoder")
    one = ServeEngine(rcfg, params_from_jax(np_params("decoder"), rcfg,
                                            "cpu"), **cases.KW)
    one.generate([Request(prompt=p, max_new_tokens=n)
                  for p, n in PREFIX_REQS])
    one_saved = one.save_prefix_cache(one_path)

    def saves(shape):
        return [(("save", n), ("prefix_save", {
            "name": n, "params": np_params(n), "requests": PREFIX_REQS,
            "path": files[(s, n)]})) for s, n in PREFIX_SAVES if s == shape]

    engine = [(("engine", n), ("engine", {
        "name": n, "params": np_params(n),
        "requests": [(p, 4) for p, _ in PREFIX_REQS]}))
        for n in ENGINE_FAMILIES]
    decode = [(("decode", n), dense_todo(n, "decode", B)) for n in FAMILIES]
    clamp = np.random.default_rng(4).integers(
        0, cases.serve_cases.VOCAB, (B, sum(CLAMP_CHUNKS))).astype(np.int32)
    edges = np.cumsum((0,) + CLAMP_CHUNKS)
    chunks = [clamp[:, a:b] for a, b in zip(edges[:-1], edges[1:])]
    todo = {
        2: [((1, 2), decode + [(("clamp", None), ("dense", {
                "name": "decoder", "params": np_params("decoder"),
                "rules": "decode", "chunks": chunks}))]
             + engine + saves((1, 2))),
            ((2, 1), decode + [(("wide", None),
                                ("dense", dict(wide, rules="decode")))]
             + engine + saves((2, 1)))],
        4: [((2, 2), decode
             + [(("long", n), dense_todo(n, "long", 1)) for n in LONG]
             + [(("wide", None), ("dense", dict(wide, rules="decode")))]
             + saves((2, 2))
             + [(("load", None), ("prefix_load", {
                 "name": "decoder", "params": np_params("decoder"),
                 "requests": PREFIX_REQS, "path": one_path}))])],
        1: [((1, 1), [(("world1", n), ("world1", dense_todo(n, "decode",
                                                             B)[1]))
                      for n in ("decoder", "hybrid", "encdec")])],
    }
    with concurrent.futures.ThreadPoolExecutor(len(todo)) as pool:
        futs = {n: pool.submit(spawn, n, t) for n, t in todo.items()}
        ref = {(n, B): jax_decode(n, B) for n in FAMILIES}
        ref["clamp"] = jax_decode("decoder", B, chunks)
        jprefix = {}
        for n in sorted({n for _, n in PREFIX_SAVES}):
            rcfg, p = j_params(n)
            _, out = engine_outputs(rcfg, p, PREFIX_REQS,
                                    max_len=cases.MAX_LEN, max_batch=2,
                                    page_size=4)
            jprefix[n] = [o.tolist() for o in out]
        got = {n: f.result() for n, f in futs.items()}
    return {"ranks": got, "jax": ref, "files": files,
            "jprefix": jprefix, "one": (one_path, one_saved)}


def at(runs, n, shape, label):
    """[each rank's result] of case ``label`` at ``shape`` (spawn of
    ``n`` ranks)."""
    return [r[(shape, label)] for r in runs["ranks"][n]]


def check_stream(got, want_logits, want_tokens) -> bool:
    """One rank's dense run against JAX's: the greedy tokens JAX's up to
    a near-tie (JAX's top-2 margin within TOL), after which the streams
    may part, and every call's logits within TOL until then. Returns
    whether the streams stayed together."""
    n_prompt = len(want_logits) - max(len(want_tokens) - 1, 0)
    upto = len(want_logits)
    for j, (g, w) in enumerate(zip(got["tokens"], want_tokens,
                                   strict=True)):
        if g != w:
            top2 = np.sort(want_logits[n_prompt - 1 + j][:, -1], -1)[:, -2:]
            assert np.all(top2[:, 1] - top2[:, 0] <= TOL), (j, g, w)
            upto = n_prompt + j
            break
    for i in range(upto):
        np.testing.assert_allclose(got["logits"][i], want_logits[i],
                                   atol=TOL, rtol=0, err_msg=f"call {i}")
    return upto == len(want_logits)


def row0(ref):
    """JAX's B 2 decode as its first slot's alone (the slots do not mix:
    a B 1 run gives the same numbers within TOL)."""
    logits, tokens, cache = ref
    return ([lg[:1] for lg in logits], [t[:1] for t in tokens],
            {k: v if v.ndim == 0 else v[:, :1] for k, v in cache.items()})


def check_cache(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        tol = SSM_TOL if k.split(".")[-1] == "h" else TOL
        np.testing.assert_allclose(got[k], w, atol=tol, rtol=0, err_msg=k)


@pytest.mark.parametrize("shape,n", [((1, 2), 2), ((2, 1), 2),
                                     ((2, 2), 4)])
@pytest.mark.parametrize("name", FAMILIES)
def test_decode_rules_match_jax(runs, shape, n, name):
    """``decode_sharding()``: every rank's tokens equal, each call's
    logits and the whole cache JAX's (B 2)."""
    ranks = at(runs, n, shape, ("decode", name))
    logits, tokens, cache = runs["jax"][(name, B)]
    for r in ranks:
        assert r["mesh"]["tokens"] == ranks[0]["mesh"]["tokens"]
        if check_stream(r["mesh"], logits, tokens):
            check_cache(r["mesh"]["cache"], cache)
    counts = ranks[0]["mesh"]["counts"]
    attn = cases.family(name) != "ssm"
    # the cache's rows over model wherever the model axis has 2 ranks
    assert ("kv_seq_combine" in counts) == (attn and shape[1] > 1)
    assert ("dp_tokens" in counts) == (shape[0] > 1)


@pytest.mark.parametrize("name", LONG)
def test_long_context_rules_match_jax(runs, name):
    """``decode_sharding(long_context=True)`` at (2, 2), B 1: the cache's
    rows over data and model (a quarter a rank), the combine over both
    axes."""
    ranks = at(runs, 4, (2, 2), ("long", name))
    logits, tokens, cache = row0(runs["jax"][(name, B)])
    for r in ranks:
        assert r["mesh"]["tokens"] == ranks[0]["mesh"]["tokens"]
        if check_stream(r["mesh"], logits, tokens):
            check_cache(r["mesh"]["cache"], cache)
    if cases.family(name) != "ssm":
        key = "attn.k" if cases.family(name) == "hybrid" else "k"
        assert ranks[0]["mesh"]["local_cache"][key][2] == cases.MAX_LEN // 4
        assert "kv_seq_combine" in ranks[0]["mesh"]["counts"]


def test_write_clamp_across_a_slice_edge(runs):
    """Chunks of 20, 8 and 5 rows at (1, 2), 16 rows a rank: the first
    longer than a slice, the last starting at 28, clamped to 27 as
    dynamic_update_slice clamps it: logits and cache JAX's."""
    logits, _, cache = runs["jax"]["clamp"]
    for r in at(runs, 2, (1, 2), ("clamp", None)):
        for g, w in zip(r["mesh"]["logits"], logits, strict=True):
            np.testing.assert_allclose(g, w, atol=TOL, rtol=0)
        check_cache(r["mesh"]["cache"], cache)


@pytest.mark.parametrize("shape,n", [((2, 1), 2), ((2, 2), 4)])
def test_fsdp_storage_matches_one_rank(runs, shape, n):
    """The widened decoder under ``decode_sharding()``: the leaves the
    fsdp fallback cuts stored a slice a data rank and gathered for each
    use; tokens, logits and cache within TOL of the one-rank port."""
    ranks = at(runs, n, shape, ("wide", None))
    one = ranks[0]["one"]
    for r in ranks:
        m = r["mesh"]
        assert m["tokens"] == one["tokens"]
        for g, w in zip(m["logits"], one["logits"], strict=True):
            np.testing.assert_allclose(g, w, atol=TOL, rtol=0)
        check_cache(m["cache"], one["cache"])
        assert m["counts"]["fsdp_gather"][0] > 0
        assert m["local_params"] < one["local_params"]


@pytest.mark.parametrize("name", ("decoder", "hybrid", "encdec"))
def test_world1_mesh_is_bitwise_no_mesh(runs, name):
    (r,) = at(runs, 1, (1, 1), ("world1", name))
    assert r["mesh"]["tokens"] == r["none"]["tokens"]
    for a, b in zip(r["mesh"]["logits"], r["none"]["logits"], strict=True):
        np.testing.assert_array_equal(a, b)
    for k in r["none"]["cache"]:
        np.testing.assert_array_equal(r["mesh"]["cache"][k],
                                      r["none"]["cache"][k])
    assert r["mesh"]["counts"] == {}


@pytest.mark.parametrize("shape", [(1, 2), (2, 1)])
@pytest.mark.parametrize("name", ENGINE_FAMILIES)
def test_engine_dense_route_under_a_mesh(runs, shape, name):
    """A mesh engine's dense oracle (its ``serve_sharding`` rules, its
    backend's weights) streams the greedy tokens of JAX's engine (whose
    greedy streams are its dense oracle's) on every rank, and
    ``throughput_probe(paged=False)`` runs."""
    for r in at(runs, 2, shape, ("engine", name)):
        assert r["streams"] == runs["jprefix"][name]
        assert r["rate"] > 0
        assert "kv_seq_combine" not in r["counts"]


@pytest.mark.parametrize("lens", [[-3, -40], [0, 5], [7, 40], [31, 2]])
def test_lse_plain_version_matches_float64(lens):
    """``paged_attention_lse_ref`` on one page of 32 rows a slot (a
    rank's slice) at local lengths before the slice (<= 0: no key seen),
    inside it (the rank that owns the index) and past it: the output is
    ``paged_attention_ref``'s bit for bit and lse a float64 log-sum-exp
    within 1e-5; a row that sees no key carries lse <= -1e29."""
    g = torch.Generator().manual_seed(11)
    Bq, S, H, Hkv, hd, L = 2, 3, 4, 2, 16, 32
    q = torch.randn((Bq, S, H, hd), generator=g)
    pk = torch.randn((Bq, L, Hkv, hd), generator=g)
    pv = torch.randn((Bq, L, Hkv, hd), generator=g)
    table = torch.arange(Bq, dtype=torch.int32)[:, None]
    lengths = torch.tensor(lens, dtype=torch.int32)
    out, lse = pa.paged_attention_lse_ref(q, pk, pv, table, lengths)
    torch.testing.assert_close(out, pa.paged_attention_ref(
        q, pk, pv, table, lengths), rtol=0, atol=0)
    qd, kd = q.double().numpy(), pk.double().numpy()
    for b in range(Bq):
        for s in range(S):
            seen = min(L, lens[b] + s + 1)
            for h in range(H):
                if seen <= 0:
                    assert lse[b, s, h] <= -1e29
                    continue
                x = kd[b, :seen, h // (H // Hkv)] @ qd[b, s, h] * hd ** -0.5
                want = x.max() + np.log(np.exp(x - x.max()).sum())
                assert abs(float(lse[b, s, h]) - want) <= 1e-5


def test_prefix_files_load_in_jax_and_one_rank(runs):
    """Each file a mesh engine saved (after serving the requests every
    rank's streams JAX's uninterrupted engine's) restores its pages in
    JAX's engine and in a one-rank port engine, which serve the requests
    token for token as JAX's uninterrupted engine, reusing at least the
    common prefix."""
    for (shape, name), path in runs["files"].items():
        n = 2 if shape != (2, 2) else 4
        ranks = at(runs, n, shape, ("save", name))
        want = runs["jprefix"][name]
        for r in ranks:
            assert r["streams"] == want, (shape, name)
            assert r["saved"] == ranks[0]["cached"] > 0
        assert os.path.exists(path)
        rcfg, params = j_params(name)
        eng = JServeEngine(rcfg, params, max_len=cases.MAX_LEN, max_batch=2,
                           page_size=4, prefix_cache_path=path)
        assert eng.scheduler.prefix.n_cached_pages == ranks[0]["saved"]
        out = eng.generate([JRequest(prompt=p, max_new_tokens=m)
                            for p, m in PREFIX_REQS])
        assert [o.output.tolist() for o in out] == want, (shape, name)
        assert eng.scheduler.stats["shared_tokens"] >= len(COMMON)
        trc = cases.rcfg_of(name)
        port = ServeEngine(trc, params_from_jax(np_params(name), trc, "cpu"),
                           prefix_cache_path=path, **cases.KW)
        assert port.scheduler.prefix.n_cached_pages == ranks[0]["saved"]
        got = port.generate([Request(prompt=p, max_new_tokens=m)
                             for p, m in PREFIX_REQS])
        assert [o.output.tolist() for o in got] == want, (shape, name)
        assert port.scheduler.stats["shared_tokens"] >= len(COMMON)


def test_prefix_arrays_match_one_rank_file(runs):
    """The (2, 2) engine's file holds the trie and page contents of the
    one-rank port's, whole heads, within 2e-5."""
    one = np.load(runs["one"][0])
    mesh = np.load(runs["files"][((2, 2), "decoder")])
    assert set(one.files) == set(mesh.files)
    for k in one.files:
        if k.startswith("leaf_"):
            np.testing.assert_allclose(mesh[k], one[k], atol=TOL, rtol=0)
        elif k not in ("pages", "tail_pages"):
            np.testing.assert_array_equal(mesh[k], one[k], err_msg=k)


def test_one_rank_file_loads_into_a_2x2_engine(runs):
    """A one-rank port file restores every page on a (2, 2) engine (each
    root's subtree in one data rank's range), which then serves the
    requests as JAX's engine, reusing the prefix; the cache dropped, the
    pool is whole again; an engine of page size 8 refuses the file on
    every rank."""
    want = runs["jprefix"]["decoder"]
    for r in at(runs, 4, (2, 2), ("load", None)):
        assert r["restored"] == runs["one"][1]
        assert r["streams"] == want
        assert r["shared"] >= len(COMMON)
        assert r["free"][0] == r["free"][1]
        assert "page_size" in r["mismatch"]
