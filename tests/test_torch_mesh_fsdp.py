"""fsdp in training across ranks on the CPU: big leaves stored one even
piece per 'data' rank, gathered whole for each use and their gradients
reduce-scattered, against the same mesh without fsdp, one rank and the
JAX package.

Two spawns of gloo ranks (``repro_torch.launch.hostdev.spawn_host_ranks``,
per-rank code ``tests/torch_mesh_fsdp_cases.py``, jax-free, one thread a
rank) run in background threads while JAX computes its side: two ranks
at (2, 1) and (1, 2), four at (2, 2). fsdp cuts only leaves of at least
``1 << 22`` elements, so the configs are the reduced ones widened
(``torch_mesh_fsdp_cases.config``): granite-shaped (d_model 512, d_ff
2048, vocab 8192, 1 + 4 + 1 layers; its embeddings and trunk MLP cut)
and grok-shaped (the same widths, 4 whole experts of d_ff 2048 cut on
their d_ff, in the trunk and the buffers), float32, each under its own
train sharding (``fsdp="data"``).

Tolerances: each rank's loss bitwise the same mesh's ``fsdp=None`` run;
every gathered gradient leaf and the gradient norm within CROSS (1e-6 of
the leaf's largest magnitude) of that run; against JAX's one-device
``value_and_grad`` the float32 training tolerances, loss 1e-5 and every
leaf 1e-4 of its largest magnitude; a Trainer's state within CROSS of one
rank's; a checkpoint restored bit for bit.
"""
import concurrent.futures
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_mesh_fsdp_cases as cases
from repro.configs.base import MoEConfig as JMoEConfig
from repro.configs.reduce import reduce_config as j_reduce
from repro.configs.registry import get_config as j_get_config
from repro.models import transformer as jtr
from repro.parallel import params as jparams
from repro_torch.launch.hostdev import spawn_host_ranks
from repro_torch.models import transformer as ttr
from repro_torch.parallel import params as tparams
from repro_torch.train.trainer import Trainer
from repro_torch.tree import leaves_with_paths
from test_torch_mesh_moe import to_jax

GRANITE, GROK = "granite_34b", "grok1_314b"
CROSS = 1e-6
LOSS_TOL = 1e-5
LEAF_REL = 1e-4
SPAWN_S = 240.0
# (arch, mode, mesh) of every gradient case, its spawn by the mesh's size
GRADS = [(GRANITE, "lp", (2, 1)), (GRANITE, "serial", (2, 1)),
         (GRANITE, "lp", (2, 2)), (GROK, "lp", (2, 2))]
# the leaves fsdp cuts (each with its dimension) in both configs
CUT = {GRANITE: {"embed.tok": 1, "embed.out": 1, "mid.params.mlp.w_in": 2,
                 "mid.params.mlp.w_out": 1},
       GROK: {"embed.tok": 1, "embed.out": 1,
              **{f"{root}.moe.{k}": d for root in ("open", "close",
                                                   "mid.params")
                 for k, d in (("w_in", 3), ("w_gate", 3), ("w_out", 2))}}}


def j_config(arch, mode="lp"):
    """``cases.config``'s JAX twin."""
    rcfg = j_reduce(j_get_config(arch))
    m = dataclasses.replace(rcfg.model, dtype="float32", **cases.WIDE)
    if m.moe is not None:
        m = dataclasses.replace(m, moe=JMoEConfig(num_experts=4, top_k=2,
                                                  d_ff=2048))
    return rcfg.replace(model=m, mgrit=dataclasses.replace(
        rcfg.mgrit, pad_to=4, enabled=mode == "lp"))


def mesh_of(shape):
    axes = ("data", "model")
    return types.SimpleNamespace(axis_names=axes,
                                 shape=dict(zip(axes, shape)))


def spawn(n, todo):
    res = spawn_host_ranks(n, cases.run, todo, threads=1, timeout=SPAWN_S)
    assert [r["rank"] for r in res] == list(range(n))
    assert all(r["threads"] == 1 for r in res)
    return [r["results"] for r in res]


def todo_of(batch, ckpt):
    """The cases of each spawn (by its number of ranks), in run order."""
    grads = [(shape, "grads", {"arch": a, "mode": m, "batch": batch})
             for a, m, shape in GRADS]
    train = {"arch": GRANITE, "dir": ckpt, "steps": 2}
    return {2: [((2, 1), "reduce_scatter", {}),
                ((2, 1), "refusal", {"arch": GRANITE, "batch": batch}),
                *[g for g in grads if g[0] == (2, 1)],
                ((2, 1), "train", train), ((1, 2), "restore", train)],
            4: [g for g in grads if g[0] == (2, 2)]}


def at(runs, n, shape, kind, nth=0):
    keys = [(s, k) for s, k, _ in runs["todo"][n]]
    i = [j for j, key in enumerate(keys) if key == (shape, kind)][nth]
    return [rank[i] for rank in runs[n]]


def grads_of(runs, arch, mode, shape):
    n = shape[0] * shape[1]
    nth = [(a, m) for a, m, s in GRADS if s == shape].index((arch, mode))
    return at(runs, n, shape, "grads", nth)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both spawns' per-rank results, and JAX's loss and gradients of
    each (arch, mode) on the same params and batch (computed while the
    ranks run)."""
    rcfg = cases.config(GRANITE)
    rng = np.random.default_rng(0)
    B, S, V = rcfg.shape.global_batch, rcfg.shape.seq_len, \
        rcfg.model.vocab_size
    batch = {"tokens": rng.integers(0, V, (B, S)).astype(np.int32),
             "labels": rng.integers(0, V, (B, S)).astype(np.int32)}
    ckpt = str(tmp_path_factory.mktemp("fsdp_ckpt"))
    todo = todo_of(batch, ckpt)
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        futs = {n: pool.submit(spawn, n, t) for n, t in todo.items()}
        out = {"todo": todo, "ckpt": ckpt, "jax": {}}
        for arch, mode in {(a, m) for a, m, _ in GRADS}:
            jr = j_config(arch, mode)
            params = to_jax(ttr.init_model(cases.config(arch, mode=mode),
                                           seed=0, device="cpu"), jr)
            (loss, _), grads = jax.jit(jax.value_and_grad(
                lambda p: jtr.loss_fn(p, jax.tree.map(jnp.asarray, batch),
                                      jr, mode=mode), has_aux=True))(params)
            out["jax"][arch, mode] = {
                "loss": float(loss),
                "grads": {".".join(k.key for k in path): np.asarray(g)
                          for path, g in
                          jax.tree_util.tree_flatten_with_path(grads)[0]}}
        for n, f in futs.items():
            out[n] = f.result()
    return out


def rel_err(got, want) -> float:
    return float(np.abs(np.asarray(got) - np.asarray(want)).max()
                 / max(np.abs(np.asarray(want)).max(), 1e-30))


@pytest.mark.parametrize("arch", [GRANITE, GROK])
@pytest.mark.parametrize("shape", [(2, 1), (2, 2)])
def test_fsdp_specs_match_reference(arch, shape, monkeypatch):
    """The port's train specs of the widened configs equal the
    reference's ``param_specs`` leaf for leaf, the fsdp placements
    included; ``fsdp_cut`` names exactly the leaves whose fsdp dimension
    the fallback placed over 'data'."""
    monkeypatch.setattr(jparams, "NamedSharding",
                        lambda mesh, spec: tuple(spec))
    mesh = mesh_of(shape)
    tr, jr = cases.config(arch), j_config(arch)
    shapes = ttr.param_shapes(tr)
    specs = tparams.train_specs(shapes, tr, mesh)
    got = dict(leaves_with_paths(specs))
    jtree = jax.eval_shape(lambda k: jtr.init_model(k, jr),
                           jax.random.PRNGKey(0))
    flat, _ = jax.tree_util.tree_flatten_with_path(
        jparams.param_specs(jtree, jr, mesh),
        is_leaf=lambda x: isinstance(x, tuple))
    want = {tuple(k.key for k in path): spec for path, spec in flat}
    assert got == want
    cut = tparams.fsdp_cut(shapes, specs, mesh, tr.sharding)
    assert {".".join(p): d for p, (d, _) in cut.items()} == CUT[arch]
    assert all(ax == "data" and got[p][d] == "data"
               for p, (d, ax) in cut.items())
    one = mesh_of((1, 2))           # an fsdp axis of one rank cuts nothing
    assert tparams.fsdp_cut(shapes, tparams.train_specs(shapes, tr, one),
                            one, tr.sharding) == {}


def test_reduce_scatter_order_and_counts(runs):
    """Each rank gets the sum over the ranks of its own piece (piece r
    on rank r) along dim 0 and dim 1, counted one call a call with the
    bytes contributed; on an axis of one rank the tensor itself."""
    ranks = at(runs, 2, (2, 1), "reduce_scatter")
    total = sum(r["sent"] for r in ranks)
    for r in ranks:
        want = total.reshape(2, -1, 3)[r["r"]]
        np.testing.assert_array_equal(r["dim0"], want)
        np.testing.assert_array_equal(r["dim1"], want.T)
        assert r["one_rank_same"]
        assert r["counts"] == {"rs": [2, 2 * r["sent"].nbytes]}


def test_params_with_the_fsdp_dimension_whole_raise(runs):
    """Params cut without the rules' fsdp dimension (``shard_tree``
    without ``sharding``) would skip the data all-reduce of those
    leaves: ``make_grad_fn`` names the first such leaf instead."""
    for msg in at(runs, 2, (2, 1), "refusal"):
        assert msg.startswith("embed.tok: dimension 1 holds 512, not this "
                              "rank's fsdp piece of 256"), msg


@pytest.mark.parametrize("arch,mode,shape", GRADS)
def test_fsdp_grads_match_plain_mesh_one_rank_and_jax(runs, arch, mode,
                                                      shape):
    """Each rank's loss is bitwise the same mesh's ``fsdp=None`` run;
    every gathered gradient leaf and the gradient norm lie within CROSS
    of that run, and within the float32 tolerances of JAX's one-device
    gradient. Each fsdp-cut leaf and its gradient are 1/n of the whole
    on a rank; the leaves kept whole are only those whose vocab the spec
    puts over 'model' (not executed); the fsdp-cut gradients are
    reduce-scattered (never in the data all-reduce) and the layers
    gathered for each F evaluation."""
    ranks = grads_of(runs, arch, mode, shape)
    f, p = ranks[0]["fsdp"], ranks[0]["plain"]
    for r in ranks:
        assert r["fsdp"]["loss"] == r["plain"]["loss"] == f["loss"]
    assert rel_err(f["global_norm"], p["global_norm"]) <= CROSS
    assert set(f["grads"]) == set(p["grads"])
    for path, g in p["grads"].items():
        assert rel_err(f["grads"][path], g) <= CROSS, path
    ref = runs["jax"][arch, mode]
    np.testing.assert_allclose(f["loss"], ref["loss"], rtol=LOSS_TOL)
    assert set(ref["grads"]) == set(f["grads"])
    for path, want in ref["grads"].items():
        err = np.abs(f["grads"][path] - want).max()
        assert err <= LEAF_REL * np.abs(want).max(), (path, err)
    assert f["cut"] == CUT[arch] and p["cut"] == {}
    for r in ranks:
        res = r["fsdp"]
        for path, d in res["cut"].items():
            assert res["local"][path][d] * shape[0] == res["full"][path][d]
            assert res["grad_local"][path] == res["local"][path]
        assert set(res["whole"]) <= {"embed.tok", "embed.out"}
        assert res["whole"] == r["plain"]["whole"]
        c = res["counts"]
        trunk = [k for k in CUT[arch] if k.startswith("mid.")]
        assert c["fsdp_grad"][0] == len(CUT[arch]) - len(trunk) \
            + len(trunk) * 4 // shape[1]        # one a trunk layer
        assert c["fsdp_gather"][0] > c["fsdp_grad"][0]
        assert c["grad_norm_fsdp"][0] == 1
        assert c["grad_mean"][0] + len(CUT[arch]) == \
            r["plain"]["counts"]["grad_mean"][0]


def test_trainer_fsdp_steps_checkpoint_and_restore(runs):
    """Two Trainer steps at (2, 1), the probe at step 1: the losses
    within CROSS of one rank's and the same on both ranks; the probe's
    convergence factors within CROSS of one rank's where below 1 (there
    they are ratios of residual norms near rounding, ~4e-7, which the
    data ranks' sums order differently); the params gathered whole
    within CROSS of one rank's (absolute: a zero-initialised layernorm
    bias is ~9e-6 after two warm-up steps, and AdamW's per-element
    normalization carries an element's gradient rounding into its update
    whole). Each rank stores 1/2 of every fsdp-cut leaf and of its
    moments. The checkpoint restores bit for bit at (1, 2) and on one
    rank."""
    r0, r1 = at(runs, 2, (2, 1), "train")
    mesh, one = r0["mesh"], r0["one"]
    assert r1["mesh"]["losses"] == mesh["losses"]
    assert mesh["modes"] == one["modes"]
    assert [h[0] for h in mesh["history"]] == [h[0] for h in one["history"]]
    np.testing.assert_allclose(mesh["losses"], one["losses"], rtol=CROSS)
    for got, want in zip(mesh["history"], one["history"], strict=True):
        for a, b in zip(got[1:], want[1:], strict=True):
            assert abs(a - b) <= CROSS * max(abs(b), 1.0)
    for path, a in one["params"].items():
        assert np.abs(mesh["params"][path] - a).max() <= CROSS, path
    for r in (r0, r1):
        assert set(r["kept_whole"]) <= {"embed.tok", "embed.out"}
        for part in ("params", "m", "v"):
            assert set(r["local"][part]) == set(CUT[GRANITE])
            for path, shape in r["local"][part].items():
                want = list(one["params"][path].shape)
                want[CUT[GRANITE][path]] //= 2
                assert shape == want, (part, path)
    rcfg = cases.config(GRANITE, check_every=1)
    tr = Trainer(rcfg, seed=0, device="cpu", ckpt_dir=runs["ckpt"])
    restored = [*at(runs, 2, (1, 2), "restore"),
                cases._state(tr, rcfg, None)]
    for got in restored:
        assert got["step"] == mesh["step"] == 2
        for part in ("params", "opt"):
            assert set(got[part]) == set(mesh[part])
            for path, a in mesh[part].items():
                np.testing.assert_array_equal(got[part][path], a,
                                              err_msg=path)
