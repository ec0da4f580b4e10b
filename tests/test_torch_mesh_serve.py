"""Serving under a mesh on the CPU: the port's ``ServeEngine(mesh=...)``
(explicit SPMD over ``torch.distributed``, gloo ranks spawned by
``repro_torch.launch.hostdev.spawn_host_ranks``) against the JAX
package's single-device dense oracle and the port's own one-rank
engine.

The mirror of ``tests/test_serve_mesh.py``: the decoder, mamba1 and
hybrid families (``test_serve_backends.py``'s float32 configs and
weights), a data split (2, 1) and a tensor-parallel split (1, 2), the
reference's two requests (greedy and seeded sampled). Every rank's
streams must equal the oracle's token for token (the reference's own
contract; its mesh engine fails on this JAX, ROADMAP Queue 3), fused
must equal gathered, greedy spec (cf 2, k 3) must equal plain at
(1, 2) with drafts made, and the pools must really be split: pages over
``data``, heads / di over ``model`` (mamba2's B and C whole). Besides:
a world-1 mesh is bitwise the engine without one (tokens and logits, no
collective issued); TP logits stay within 2e-5 of the one-rank port's
(a cross-rank sum reorders a reduction); ranks whose clocks are skewed
take identical waves; the local layout round-trips bitwise; the
decode shardings equal the reference's; the serve CLI runs at
``--mesh 1,2`` under a launcher's environment. One spawn a mesh shape
(``tests/torch_mesh_serve_cases.py``, jax-free), each rank on one
thread, started in background threads while JAX decodes its oracle.
"""
import concurrent.futures
import dataclasses
import os
import socket
import subprocess
import sys
import types

import jax
import numpy as np
import pytest
import torch

import torch_mesh_serve_cases as cases
from repro.configs import registry as jregistry
from repro.launch import specs as jspecs
from repro.models import transformer as jtr
from repro.parallel import params as jparams
from repro.serve.engine import Request as JRequest
from repro_torch.configs import registry
from repro_torch.launch import specs as tspecs
from repro_torch.launch import steps
from repro_torch.launch.hostdev import spawn_host_ranks
from repro_torch.parallel import params as tparams
from repro_torch.parallel import tp
from repro_torch.tree import leaves_with_paths
from serve_oracle import dense_decode_oracle
from test_serve_backends import family_rcfg as j_family

FAMILIES = ("decoder", "ssm_mamba1", "hybrid")
SPAWN_S = 240.0
TP_LOGITS = 2e-5          # absolute, float32 logits of O(1)


def j_params(name):
    rcfg = j_family(name)
    return rcfg, jtr.init_model(
        jax.random.PRNGKey(sum(map(ord, name)) % 1000), rcfg)


def spawn(shape, todo):
    res = spawn_host_ranks(shape[0] * shape[1], cases.run, shape, todo,
                           threads=1, timeout=SPAWN_S)
    assert [r["rank"] for r in res] == list(range(len(res)))
    assert all(r["threads"] == 1 for r in res)
    return [r["results"] for r in res]


@pytest.fixture(scope="module")
def runs():
    """Every mesh shape's per-rank results (spawned in background threads)
    and the JAX oracle's streams of each family's two requests."""
    params = {}
    for name in FAMILIES:
        params[name] = jax.tree.map(np.asarray, j_params(name)[1])
    skew = {"name": "decoder", "params": params["decoder"], "rate": 1e-6,
            "n_pages": 12, "gap_s": 0.04,
            "queue": [(2, None), (2, None), (1, 0.05), (1, 0.02),
                      (0, None), (1, None)]}
    todo = {
        (2, 1): [("serve", {"name": n, "params": params[n], "one": True})
                 for n in FAMILIES] + [("skew", skew)],
        (1, 2): [("serve", {"name": n, "params": params[n], "spec": True,
                          "one": True})
                 for n in FAMILIES]
        + [("logits", {"name": n, "params": params[n]}) for n in FAMILIES]
        + [("skew", skew), ("serve", {"name": "decoder_mqa", "one": True})],
        (1, 1): [("world1", {"params": params}), ("refusal", {})],
    }
    with concurrent.futures.ThreadPoolExecutor(len(todo)) as pool:
        futs = {shape: pool.submit(spawn, shape, t)
                for shape, t in todo.items()}
        oracle = {}
        for name in FAMILIES:
            rcfg, p = j_params(name)
            step = jax.jit(lambda p, c, t, _r=rcfg: jtr.decode_step(
                p, c, t, _r))
            oracle[name] = [dense_decode_oracle(rcfg, p, step, r,
                                                cases.MAX_LEN).tolist()
                            for r in jax_requests()]
        got = {shape: f.result() for shape, f in futs.items()}
    return {"oracle": oracle, **got}


def jax_requests():
    return [JRequest(prompt=r.prompt, max_new_tokens=r.max_new_tokens,
                     temperature=r.temperature, top_k=r.top_k,
                     top_p=r.top_p, seed=r.seed) for r in cases.requests()]


def results(runs, shape, kind, name=None):
    """[rank 0's, rank 1's, ...] results of one case."""
    todo_kinds = {(2, 1): [("serve", n) for n in FAMILIES] + [("skew", None)],
                  (1, 2): [("serve", n) for n in FAMILIES]
                  + [("logits", n) for n in FAMILIES] + [("skew", None),
                                                        ("serve",
                                                         "decoder_mqa")],
                  (1, 1): [("world1", None), ("refusal", None)]}[shape]
    i = todo_kinds.index((kind, name))
    return [rank[i] for rank in runs[shape]]


@pytest.mark.parametrize("shape", [(2, 1), (1, 2)])
@pytest.mark.parametrize("name", FAMILIES)
def test_mesh_streams_match_the_dense_oracle(runs, shape, name):
    """Every rank, fused and gathered, greedy and sampled: the JAX
    single-device dense oracle's tokens; the engine's stats give the
    mesh shape and the one-rank port agrees."""
    dp, tp_ = shape
    ranks = results(runs, shape, "serve", name)
    want = runs["oracle"][name]
    for r, res in enumerate(ranks):
        assert res["fused"] == want, (shape, name, r)
        assert res["gathered"] == want, (shape, name, r)
        assert res["fused_flag"] and not res["gathered_flag"]
        assert res["stats"] == [dp, tp_, dp * tp_]
    assert ranks[0]["one"] == want
    # every wave agrees its clock once; data splits gather tokens, model
    # splits sum and gather activations
    counts = ranks[0]["fused_counts"]
    assert counts["clock"][0] > 0
    assert ("dp_tokens" in counts) == (dp > 1)
    assert ("tp_logits" in counts) == (tp_ > 1)


def test_mesh_pools_are_split(runs):
    """(2, 1): each rank's pool leaves hold pool_pages(17) / 2 = 9 pages
    (17 rounded up to divide over data); (1, 2): the heads / di halved,
    mamba2's B and C whole in its conv pool. ``shard_state`` cuts a
    whole pool to the same shapes."""
    for name in FAMILIES:
        for res in results(runs, (2, 1), "serve", name):
            assert res["n_pages"] == 18
            assert {s[1] for s in res["pools"].values()} == {9}, name
    di, ds = 64, 8
    want = {"decoder": {"k": [8, 17, 4, 1, 16], "v": [8, 17, 4, 1, 16]},
            "ssm_mamba1": {"conv": [4, 17, 2, di // 2],
                           "h": [4, 17, di // 2, ds]},
            "hybrid": {"mamba.conv": [5, 17, 2, di // 2 + 2 * ds],
                       "mamba.h": [5, 17, 2, 16, ds],
                       "attn.k": [2, 17, 4, 1, 16],
                       "attn.v": [2, 17, 4, 1, 16]}}
    for name in FAMILIES:
        for res in results(runs, (1, 2), "serve", name):
            assert res["pools"] == want[name], name
    for shape in ((2, 1), (1, 2)):
        for name in FAMILIES:
            for res in results(runs, shape, "serve", name):
                assert res["shard_state"] == res["pools"], (shape, name)


def test_tp2_with_kv_heads_whole_matches_one_rank(runs):
    """One KV head at (1, 2): the query heads split, the KV heads (and
    their pools) stay whole on both ranks, each rank's query heads
    attend them; fused and gathered streams are the one-rank engine's."""
    ranks = results(runs, (1, 2), "serve", "decoder_mqa")
    for res in ranks:
        assert res["fused"] == res["gathered"] == ranks[0]["one"]
        assert res["pools"]["k"] == [8, 17, 4, 1, 8]
    assert ranks[0]["fused_counts"]["tp_attn"][0] > 0


def test_mesh_spec_equals_plain_at_tp2(runs):
    """Greedy spec decode (cf 2, k 3) == greedy plain decode under
    (1, 2), on every rank, with tokens drafted."""
    drafted = 0
    for name in FAMILIES:
        for res in results(runs, (1, 2), "serve", name):
            assert res["spec6"] == res["plain6"], name
        drafted += res["drafted"]
    assert drafted > 0


def test_tp_logits_near_the_one_rank_port(runs):
    """A prefill and a decode step's logits at (1, 2) against the
    no-mesh port on the same weights: within TP_LOGITS (the partial sums
    over heads / di / vocab reorder float32 reductions); both ranks
    identical (the logits are gathered whole)."""
    for name in FAMILIES:
        r0, r1 = results(runs, (1, 2), "logits", name)
        for got, got1, want in zip(r0["mesh"], r1["mesh"], r0["one"],
                                   strict=True):
            np.testing.assert_array_equal(got, got1)
            assert np.abs(got - want).max() <= TP_LOGITS, name
        assert r0["counts"]["tp_logits"][0] == 2


def test_world1_mesh_is_bitwise_no_mesh(runs):
    """A (1, 1) mesh serves bitwise like no mesh: streams and one step's
    logits, with no collective issued."""
    (res,) = results(runs, (1, 1), "world1")
    for name in FAMILIES:
        r = res[name]
        assert r["mesh"]["streams"] == r["none"]["streams"] \
            == runs["oracle"][name]
        for a, b in zip(r["mesh"]["logits"], r["none"]["logits"],
                        strict=True):
            np.testing.assert_array_equal(a, b)
        assert r["counts"] == {}, name


def test_mesh_refuses_moe_and_the_dense_route(runs):
    """The dense route runs on a mesh engine now (its probe measures a
    rate); the paged engine still refuses rules beyond serve_sharding's
    axes, naming its ROADMAP item and the dense step that runs them."""
    (res,) = results(runs, (1, 1), "refusal")
    assert res["dense"] > 0
    assert "ROADMAP Queue 1, the paged engine under rules beyond " \
        "serve_sharding" in res["kv_seq"]
    assert "make_serve_fn(rcfg, mesh)" in res["kv_seq"]


@pytest.mark.parametrize("shape", [(2, 1), (1, 2)])
def test_skewed_clocks_take_identical_waves(runs, shape):
    """Rank 1's scheduler clock runs 1e-6 as fast from another origin:
    its own measured prefill rate is a million times rank 0's, and its
    submit gaps vanish (the TTFT-slack order would flip). The ranks still
    take the same waves (every admit, preempt, resume and finish in the
    same slot at the same wave), preempt with rank 0's spill-or-recompute
    choice and emit the same tokens."""
    r0, r1 = results(runs, shape, "skew")
    assert r0["events"] == r1["events"]
    assert r0["streams"] == r1["streams"]
    assert r0["errors"] == r1["errors"] == [None] * 6
    assert r0["stats"] == r1["stats"]
    assert r0["stats"]["preemptions"] > 0
    assert r1["rate_local"] > 1e4 * r0["rate_local"]
    assert r0["rate_agreed"] == r1["rate_agreed"]
    kinds = [e[0] for e in r0["events"]]
    assert "preempt" in kinds and "resume" in kinds


def _stand_in(shape, index):
    return types.SimpleNamespace(
        axis_names=("data", "model"), shape=dict(zip(("data", "model"),
                                                     shape)),
        index=dict(zip(("data", "model"), index)).get)


class _Gatherer:
    """A stand-in mesh whose all_gather returns every rank's piece of
    the leaf being gathered (computed up front), concatenated."""

    def __init__(self, pieces):
        self.pieces = pieces
        self.axis_names = ("data", "model")
        self.shape = {"data": 1, "model": len(pieces)}

    def all_gather(self, kind, t, axis, dim=0):
        return torch.cat(self.pieces, dim=dim)


@pytest.mark.parametrize("name", FAMILIES)
def test_local_layout_round_trips_bitwise(name):
    """Every params leaf and every pool leaf of the three families, cut
    for each rank of a (1, 2) mesh in the serving layout (the serve
    rules; a Mamba mixer's per-row vectors over its rows), then put back
    together by gather_leaf: bitwise the whole leaf. mamba1's in_proj is
    cut [x | z], mamba2's [z | x | B C | dt] (B and C on both ranks).
    Where the reference's spec names a mesh axis, the serving layout's
    is the reference's."""
    rcfg = cases.family_rcfg(name).replace(sharding=registry.serve_sharding())
    cfg = rcfg.model
    g = torch.Generator().manual_seed(0)
    full = {p: torch.randn(t.shape, generator=g)
            for p, t in leaves_with_paths(tspecs.params_specs(rcfg))}
    from repro_torch.models import transformer as ttr
    pools = {("pool",) + p: t.normal_(generator=g) for p, t in
             leaves_with_paths(_pool(rcfg, ttr))}
    mesh = _stand_in((1, 2), (0, 0))
    n_split = 0
    for path, leaf in list(full.items()) + list(pools.items()):
        pool = path[0] == "pool"
        p = path[1:] if pool else path
        kw = dict(executed=tparams.SERVE_EXECUTED, cfg=cfg,
                  logical=tparams.pool_logical if pool
                  else tparams.serve_logical_axes_for)
        if pool:
            spec = tparams.paged_state_specs({p[-1]: leaf}, rcfg,
                                             mesh)[p[-1]]
        else:
            spec = _at(tparams.param_specs(_tree(p, leaf), rcfg, mesh,
                                           kw["logical"]), p)
            ref = _at(tparams.param_specs(_tree(p, leaf), rcfg, mesh), p)
            assert any(ref) <= (spec == ref), path
        pieces = [tparams.local_slice(leaf, p, spec,
                                      _stand_in((1, 2), (0, r)), **kw)
                  for r in range(2)]
        n_split += pieces[0].shape != leaf.shape
        back = tparams.gather_leaf(pieces[0], p, spec, _Gatherer(pieces),
                                   **kw)
        assert torch.equal(back, leaf), path
    assert n_split >= {"decoder": 9, "ssm_mamba1": 12, "hybrid": 15}[name]
    if name == "hybrid":
        di, ds, nh = 64, 8, 4
        w = full[("backbone", "mixer", "in_proj")]
        spec = _at(tparams.param_specs(_tree(
            ("backbone", "mixer", "in_proj"), w), rcfg, mesh),
            ("backbone", "mixer", "in_proj"))
        mine = tparams.local_slice(w, ("backbone", "mixer", "in_proj"), spec,
                                   _stand_in((1, 2), (0, 1)), executed=kw[
                                       "executed"], cfg=cfg)
        z, x, bc, dt = w.split([di, di, 2 * ds, nh], dim=-1)
        want = torch.cat([z[..., 32:], x[..., 32:], bc, dt[..., 2:]], -1)
        assert torch.equal(mine, want)


def _pool(rcfg, ttr):
    if rcfg.model.family == "ssm":
        return ttr.init_paged_ssm_cache(rcfg, 6, device="cpu")
    if rcfg.model.family == "hybrid":
        return ttr.init_paged_hybrid_cache(rcfg, 6, 4, device="cpu")
    return ttr.init_paged_cache(rcfg, 6, 4, device="cpu")


def _tree(path, leaf):
    t = leaf
    for k in reversed(path):
        t = {k: t}
    return t


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def test_shardings_for_decode_match_the_reference(monkeypatch):
    """``launch.steps.shardings_for_decode``'s params and dense-cache
    specs, entry for entry the reference's, for the three serve archs at
    full width under decode_32k's rules on a (2, 4) and a (16, 16)
    stand-in mesh; the serve rules' page pools split over 'data'."""
    monkeypatch.setattr(jparams, "NamedSharding",
                        lambda mesh, spec: tuple(spec))
    import repro.launch.steps as jsteps
    monkeypatch.setattr(jsteps, "NamedSharding",
                        lambda mesh, spec: tuple(spec))
    monkeypatch.setattr(jsteps, "P", lambda *a: tuple(a))
    for arch in ("qwen3_1p7b", "falcon_mamba_7b", "zamba2_1p2b"):
        jr = jregistry.get_config(arch, "decode_32k")
        tr = registry.get_config(arch, "decode_32k")
        for shape in ((2, 4), (16, 16)):
            mesh = _stand_in(shape, (0, 0))
            wp, wc, wt = jsteps.shardings_for_decode(
                jr, mesh, jspecs.params_specs(jr), jspecs.decode_specs(jr)[0])
            gp, gc, gt = steps.shardings_for_decode(
                tr, mesh, tspecs.params_specs(tr), tspecs.decode_specs(tr)[0])
            assert _flat_ref(wp) == dict(leaves_with_paths(gp)), arch
            assert _flat_ref(wc) == dict(leaves_with_paths(gc)), arch
            assert gt == wt == (None, None)
        pools = {"k": torch.empty(4, 18, 16, 8, 128, device="meta")}
        sv = tr.replace(sharding=registry.serve_sharding())
        assert tparams.paged_state_specs(pools, sv, _stand_in(
            (2, 1), (0, 0)))["k"][1] == "data"


def _flat_ref(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, tuple))
    return {tuple(k.key for k in path): spec for path, spec in flat}


def test_tp_split_and_take():
    """The run-time split: None outside ``tp.active``, on an axis of one
    rank or where the dimension does not divide; a rank takes its piece
    of a dimension of blocks (``slice_blocks``: each split block's part,
    each whole block entire) and ``join_blocks`` puts every rank's back
    together."""
    sv = registry.serve_sharding()
    mesh = _stand_in((1, 2), (0, 1))
    assert tp.split("heads", 4) is None
    with tp.active(mesh, sv):
        sp = tp.split("heads", 4)
        assert (sp.axis, sp.n, sp.r) == ("model", 2, 1)
        assert tp.split("heads", 3) is None
        assert tp.split("batch", 4) is None           # data has 1 rank
    w = torch.arange(12.).reshape(2, 6)
    blocks = [(2, True), (2, False), (2, True)]
    mine = tp.slice_blocks(w, -1, blocks, sp.n, sp.r)
    assert mine.tolist() == [[1, 2, 3, 5], [7, 8, 9, 11]]
    assert tp.local_size(blocks, sp.n) == mine.shape[-1] == 4
    parts = [tp.slice_blocks(w, -1, blocks, 2, r) for r in range(2)]
    assert torch.equal(tp.join_blocks(parts, -1, blocks), w)
    with pytest.raises(ValueError):
        tp.slice_blocks(w[:, :5], -1, blocks, sp.n, sp.r)


@pytest.mark.parametrize("n_kv,tp_,want", [
    (4, 2, [(0, 2), (2, 4)]),                    # the KV heads split
    (2, 4, [(0, 1), (0, 1), (1, 2), (1, 2)]),    # a KV head a GQA group
    (1, 4, [(0, 1)] * 4),                        # MQA
])
def test_kv_split_reads_only_its_groups_kv_heads(n_kv, tp_, want):
    """Each rank attends its own query heads (8 over ``tp_`` ranks)
    against the KV heads their GQA group reads, and stores only those;
    a split where neither head count divides the other raises."""
    from repro_torch.models import attention
    cfg = cases.family_rcfg("decoder").model
    cfg = dataclasses.replace(cfg, n_heads=8, n_kv_heads=n_kv)
    sv = registry.serve_sharding()
    for r in range(tp_):
        with tp.active(_stand_in((1, tp_), (0, r)), sv):
            sq, kv = attention.kv_split(cfg)
            assert (sq.n, sq.r, kv) == (tp_, r, want[r])
            pool = attention.init_paged_kv_cache(cfg, 1, 2, 4, device="cpu")
            assert pool["k"].shape[-2] == kv[1] - kv[0]
    with tp.active(_stand_in((1, 4), (0, 1)), sv), \
            pytest.raises(NotImplementedError, match="unevenly"):
        attention.kv_split(dataclasses.replace(cfg, n_heads=12,
                                               n_kv_heads=6))


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_serve_cli_mesh_under_a_launcher_env():
    """``launch/serve.py --mesh 1,2`` as a launcher starts it (RANK,
    WORLD_SIZE, MASTER_ADDR, MASTER_PORT, LOCAL_RANK; gloo with
    ``--device cpu``): rank 0 prints the same tokens as the run without
    a mesh; rank 1 prints nothing."""
    args = [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
            "qwen3_1p7b", "--reduced", "--device", "cpu", "--requests",
            "3", "--max-batch", "2", "--page-size", "8", "--max-len", "64",
            "--new-tokens", "4"]
    base = dict(os.environ, PYTHONPATH="src", OMP_NUM_THREADS="1")
    port = str(_free_port())
    procs = [subprocess.Popen(
        args + ["--mesh", "1,2"], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
        env=dict(base, MASTER_ADDR="localhost", MASTER_PORT=port,
                 RANK=str(r), WORLD_SIZE="2", LOCAL_RANK=str(r)))
        for r in range(2)]
    plain = subprocess.run(args, capture_output=True, text=True, env=base,
                           timeout=120)
    outs = [p.communicate(timeout=120) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs[0][1][-2000:]

    def tokens(text):
        return [ln.split(" ttft")[0] for ln in text.splitlines()
                if ln.startswith("request ")]
    assert tokens(outs[0][0]) == tokens(plain.stdout) != []
    assert "mesh {'data': 1, 'model': 2}" in outs[0][0]
    assert outs[1][0] == ""


def test_serve_sharding_rules_are_the_reference():
    assert dataclasses.asdict(registry.serve_sharding()) == \
        dataclasses.asdict(jregistry.serve_sharding())


def test_sh001_covers_the_serving_axis_names(tmp_path):
    """The static checker's SH001 reads the run-time tensor-parallel
    queries and the tuples of executed axes: a mistyped name there is a
    finding, a ``str.split`` is not."""
    from repro_torch.analysis.staticcheck import Project, run_rules
    mod = tmp_path / "mod.py"
    mod.write_text(
        "from repro_torch.parallel import tp\n"
        "SERVE_EXECUTED = ('batch', 'page')\n"
        "def f(mesh, cfg):\n"
        "    return (tp.split('head', 4), tp.axis_of(mesh, cfg, 'vocb'),\n"
        "            tp.split('heads', 4), 'a,b'.split(','))\n")
    project = Project([str(mod)], known_axes={"batch", "pages", "heads",
                                              "vocab"})
    found = run_rules(project, select={"SH001"})
    assert sorted(f.message.split("`")[1] for f in found) == \
        ["head", "page", "vocb"]
