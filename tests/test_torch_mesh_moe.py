"""The MoE expert axis across ranks on the CPU: expert parallelism over
``data`` (the all-to-all dispatch and combine of ``models/moe.py``) in
training and serving, against the one-rank port and the JAX package.

Two spawns of gloo ranks (``repro_torch.launch.hostdev.spawn_host_ranks``,
per-rank code ``tests/torch_mesh_moe_cases.py``, jax-free, each rank on
one thread) run in background threads while JAX computes its side: two
ranks at (2, 1) and (1, 2), four at (2, 2). Reduced float32 configs:
qwen3-moe (4 experts, top-2) for training, the serving tests' MoE family
(4 experts, top-2) for serving.

Tolerances: the MoE module's output and every cotangent within 2e-5 of
their largest magnitude (``test_torch_moe.py``'s); the loss, every
gathered gradient leaf and the gradient norm within CROSS (1e-6
relative) of the one-rank port, the batch mean being a sum over data
ranks; against JAX the float32 training tolerances, loss 1e-5 and every
leaf 1e-4 of its largest magnitude; the restored checkpoint bit for bit;
served streams token for token.
"""
import concurrent.futures
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_mesh_moe_cases as cases
import torch_mesh_serve_cases as serve_cases
from repro.configs.base import ModelConfig as JModelConfig
from repro.configs.base import MoEConfig as JMoEConfig
from repro.configs.reduce import reduce_config as j_reduce
from repro.configs.registry import get_config as j_get_config
from repro.models import moe as jmoe
from repro.models import transformer as jtr
from repro.optim import optimizers as joptim
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JEngine
from repro.train import checkpoint as jck
from repro_torch.launch.hostdev import spawn_host_ranks
from repro_torch.models import transformer as ttr
from repro_torch.train.trainer import Trainer
from repro_torch.tree import leaves_with_paths
from test_serve_backends import family_rcfg as j_family

ARCH = "qwen3_moe_235b"
MOE_TOL = 2e-5
CROSS = 1e-6
TP_REL = 5e-6       # the vocab cut over 'model' (measured: 1.12e-6 at (2, 2))
LOSS_TOL = 1e-5
LEAF_REL = 1e-4
SPAWN_S = 240.0
EXPERTS = ("w_in", "w_gate", "w_out")


def j_train_config():
    rcfg = j_reduce(j_get_config(ARCH))
    return dataclasses.replace(rcfg, model=dataclasses.replace(
        rcfg.model, dtype="float32"))


def module_inputs():
    """The module's params (router raised on experts 0 and 1, so that
    some choices are dropped) and inputs, from a seed with numpy: 4 rows,
    S = 16."""
    rng = np.random.default_rng(0)
    p = {"router": rng.standard_normal((32, 4)) * 0.2,
         "w_in": rng.standard_normal((4, 32, 64)) * 0.1,
         "w_gate": rng.standard_normal((4, 32, 64)) * 0.1,
         "w_out": rng.standard_normal((4, 64, 32)) * 0.1}
    p["router"][:, :2] += 0.3
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.standard_normal((4, 16, 32)).astype(np.float32)
    ct = rng.standard_normal((4, 16, 32)).astype(np.float32)
    return p, x, ct


def j_module_cfg():
    return JModelConfig(name="m", family="decoder", n_layers=2, d_model=32,
                        n_heads=2, n_kv_heads=2, d_ff=64, vocab_size=64,
                        dtype="float32",
                        moe=JMoEConfig(num_experts=4, top_k=2, d_ff=64))


def to_jax(port_params, jr):
    """The port's params (every rank's seeded init) as JAX's tree for
    ``jr``, leaf for leaf by key path."""
    flat = {p: t.numpy() for p, t in leaves_with_paths(port_params)}
    shapes = jax.eval_shape(lambda k: jtr.init_model(k, jr),
                            jax.random.PRNGKey(0))
    return jax.tree_util.tree_map_with_path(
        lambda path, _: jnp.asarray(flat[tuple(k.key for k in path)]),
        shapes)


def spawn(n, todo):
    res = spawn_host_ranks(n, cases.run, todo, threads=1, timeout=SPAWN_S)
    assert [r["rank"] for r in res] == list(range(n))
    assert all(r["threads"] == 1 for r in res)
    return [r["results"] for r in res]


def todo_of(batch, ckpt):
    """The cases of each spawn (by its number of ranks), in run order:
    (mesh shape, kind, case). The ranks init the weights themselves (the
    port's seeded init); the test hands the same weights to JAX."""
    mp, x, ct = module_inputs()
    module = {"x": x, "ct": ct, "params": mp}
    grads = {"arch": ARCH, "batch": batch}
    serve = {"name": "decoder_moe", "one": True}
    ep = dict(serve, sharding={"experts": "data"})
    train = {"arch": ARCH, "dir": ckpt, "steps": 2}
    return {
        2: [((2, 1), "a2a", {"axis": "data"}),
            ((2, 1), "a2a", {"axis": "model"}),
            ((2, 1), "module", module),
            ((2, 1), "grads", grads),
            ((2, 1), "train", train),
            ((1, 2), "restore", train),
            ((2, 1), "serve", ep),
            ((1, 2), "serve", serve)],
        4: [((2, 2), "module", module),
            ((2, 2), "grads", grads),
            ((2, 2), "serve", ep),
            ((2, 2), "refusal", {})]}


def at(runs, n, shape, kind, nth=0):
    """[rank 0's, rank 1's, ...] results of the ``nth`` case ``kind`` on
    ``shape`` in spawn ``n``."""
    keys = [(s, k) for s, k, _ in runs["todo"][n]]
    i = [j for j, key in enumerate(keys) if key == (shape, kind)][nth]
    return [rank[i] for rank in runs[n]]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both spawns' per-rank results, and JAX's module, gradients and
    served streams on the same inputs (computed while the ranks run)."""
    jr = j_train_config()
    rng = np.random.default_rng(0)
    B, S, V = jr.shape.global_batch, jr.shape.seq_len, jr.model.vocab_size
    batch = {"tokens": rng.integers(0, V, (B, S)).astype(np.int32),
             "labels": rng.integers(0, V, (B, S)).astype(np.int32)}
    ckpt = str(tmp_path_factory.mktemp("moe_ckpt"))
    todo = todo_of(batch, ckpt)
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        futs = {n: pool.submit(spawn, n, t) for n, t in todo.items()}
        out = {"todo": todo, "ckpt": ckpt}
        mp, x, ct = module_inputs()
        cfg = j_module_cfg()

        def module_vjp(p, xx, cot):
            y, vjp = jax.vjp(lambda p_, x_: jmoe.moe_apply(p_, x_, cfg), p,
                             xx)
            return y, vjp(cot)
        y, (gp, gx) = jax.jit(module_vjp)(
            jax.tree.map(jnp.asarray, mp), jnp.asarray(x), jnp.asarray(ct))
        out["jax_module"] = {"y": np.asarray(y), "x": np.asarray(gx),
                             **{k: np.asarray(v) for k, v in gp.items()}}
        tr = cases.train_cases.f32_config(ARCH)
        (loss, _), grads = jax.jit(jax.value_and_grad(
            lambda p: jtr.loss_fn(p, jax.tree.map(jnp.asarray, batch), jr,
                                  mode="lp"), has_aux=True))(
            to_jax(ttr.init_model(tr, device="cpu"), jr))
        out["jax_grads"] = {
            "loss": float(loss),
            "grads": {".".join(k.key for k in path): np.asarray(g)
                      for path, g in
                      jax.tree_util.tree_flatten_with_path(grads)[0]}}
        srcfg = j_family("decoder_moe")
        sp = to_jax(ttr.init_model(serve_cases.family_rcfg("decoder_moe"),
                                   device="cpu"), srcfg)
        reqs = [JRequest(prompt=r.prompt, max_new_tokens=r.max_new_tokens,
                         temperature=r.temperature, top_k=r.top_k,
                         top_p=r.top_p, seed=r.seed)
                for r in serve_cases.requests()]
        kw = {k: v for k, v in serve_cases.KW.items() if k != "device"}
        out["jax_streams"] = [r.output.tolist() for r in JEngine(
            srcfg, sp, fused=False, **kw).generate(reqs)]
        for n, f in futs.items():
            out[n] = f.result()
    return out


def rel_err(got, want) -> float:
    return float(np.abs(np.asarray(got) - np.asarray(want)).max()
                 / max(np.abs(np.asarray(want)).max(), 1e-30))


def test_all_to_all_order_and_counts(runs):
    """Piece g of every rank's tensor lands on rank g, the pieces in rank
    order, along dim 0 and dim 1; one call counted a call with the bytes
    sent; on an axis of one rank the tensor itself, nothing counted."""
    ranks = at(runs, 2, (2, 1), "a2a")
    sent = [r["sent"] for r in ranks]
    for g, r in enumerate(ranks):
        want = np.concatenate([s.reshape(2, -1, 3)[g] for s in sent])
        np.testing.assert_array_equal(r["dim0"], want)
        np.testing.assert_array_equal(r["dim1"], want.T)
        assert r["counts"] == {"a2a": [2, 2 * sent[0].nbytes]}
    for r in at(runs, 2, (2, 1), "a2a", 1):          # 'model': one rank
        assert r["n"] == 1 and r["same"] and r["counts"] == {}


@pytest.mark.parametrize("n,shape", [(2, (2, 1)), (4, (2, 2))])
def test_moe_module_and_cotangents_across_ranks(runs, n, shape):
    """Each rank's output and x cotangent rows, its experts' leaf
    cotangents (every rank's tokens), and the router's (summed over the
    data ranks): the one-rank port's and JAX's within MOE_TOL; served
    with the expert d_ff also cut over 'model' the same output. Each
    rank holds E/n experts; one exchange each way a call, and their
    backward."""
    ranks = at(runs, n, shape, "module")
    one, ref = ranks[0]["one"], runs["jax_module"]
    lead = list({tuple(r["rows"]): r for r in reversed(ranks)}.values())
    lead.sort(key=lambda r: r["rows"])          # one rank a data index
    for name, want in (("one", one), ("jax", ref)):
        for r in ranks:
            a, b = r["rows"]
            for key in ("y", "x"):
                assert rel_err(r["train"][key], want[key][a:b]) <= \
                    MOE_TOL, (name, key)
            assert rel_err(r["serve_y"], want["y"][a:b]) <= MOE_TOL, name
        for k in EXPERTS:
            got = np.concatenate([r["train"][k] for r in lead])
            assert rel_err(got, want[k]) <= MOE_TOL, (name, k)
        got = sum(r["train"]["router"] for r in lead)
        assert rel_err(got, want["router"]) <= MOE_TOL, name
    for r in ranks:
        assert r["shapes"]["w_in"] == [2, 32, 64]
        assert r["shapes"]["router"] == [32, 4]
        assert set(r["train_counts"]) == {"ep_dispatch", "ep_combine",
                                          "ep_dispatch_grad",
                                          "ep_combine_grad"}
        assert all(c[0] == 1 for c in r["train_counts"].values())
        assert r["serve_counts"]["ep_dispatch"][0] == 1
        assert ("tp_moe" in r["serve_counts"]) == (shape[1] > 1)


@pytest.mark.parametrize("n,shape", [(2, (2, 1)), (4, (2, 2))])
def test_expert_parallel_grads_match_one_rank_and_jax(runs, n, shape):
    """The loss, every gathered gradient leaf and the gradient norm of
    the reduced qwen3-moe (MGRIT forward and adjoint) within CROSS of
    the one-rank port (TP_REL at (2, 2), where the vocab is cut over
    'model') and within the float32 tolerances of JAX's
    ``value_and_grad(loss_fn, mode="lp")``; every rank the same loss.
    Each rank stores E/n experts of every expert leaf, the routers are
    kept whole (listed), and the data-parallel gradient mean moves
    exactly the other leaves' bytes: no expert-cut gradient is summed
    over 'data'."""
    ranks = at(runs, n, shape, "grads")
    res = ranks[0]
    one, mesh = res["one"], res["mesh"]
    # at (2, 2) the training rules cut the vocab over 'model' too: the
    # head's sums cross ranks (test_torch_mesh_train.py's TP_REL)
    tol = CROSS if shape[1] == 1 else TP_REL
    assert rel_err(mesh["loss"], one["loss"]) <= tol
    assert rel_err(mesh["global_norm"], one["global_norm"]) <= tol
    assert set(mesh["grads"]) == set(one["grads"])
    for path, g in one["grads"].items():
        assert rel_err(mesh["grads"][path], g) <= tol, path
    ref = runs["jax_grads"]
    np.testing.assert_allclose(mesh["loss"], ref["loss"], rtol=LOSS_TOL)
    for path, want in ref["grads"].items():
        err = np.abs(mesh["grads"][path] - want).max()
        assert err <= LEAF_REL * np.abs(want).max(), (path, err)
    for r in ranks[1:]:
        assert r["mesh"]["loss"] == mesh["loss"]
    cut = res["expert_cut"]
    assert sorted(cut) == sorted(f"{root}.moe.{k}" for root in (
        "open", "close", "mid.params") for k in EXPERTS)
    assert all(ax == ["data"] for ax in cut.values())
    for path in cut:                  # (layers, E/n, ...)
        assert res["local_shapes"][path][1] == 2, path
    assert {"open.moe.router", "close.moe.router",
            "mid.params.moe.router"} <= set(res["whole"])
    for r in ranks:
        assert r["counts"]["grad_mean"][1] == r["mean_bytes"]
        assert r["counts"]["ep_dispatch"][0] > 0
        assert r["counts"]["ep_dispatch_grad"][0] > 0
        assert r["counts"]["grad_norm_ep"][0] == 1


def test_trainer_steps_checkpoint_and_restore(runs):
    """Two Trainer steps at (2, 1), the probe at step 1 (its switch to
    serial taken as on one rank): losses and probe history within CROSS
    of one rank, the same on both ranks; each
    rank holds E/n experts' weights and AdamW moments. The checkpoint
    restores bit for bit at (1, 2), on one rank and in JAX's restore."""
    r0, r1 = at(runs, 2, (2, 1), "train")
    mesh, one = r0["mesh"], r0["one"]
    assert r1["mesh"]["losses"] == mesh["losses"]
    assert mesh["modes"] == one["modes"] and mesh["modes"][0] == "lp"
    assert [h[0] for h in mesh["history"]] == [1]
    np.testing.assert_allclose(mesh["losses"], one["losses"], rtol=CROSS)
    for got, want in zip(mesh["history"][0][1:], one["history"][0][1:]):
        assert abs(got - want) <= CROSS * max(abs(want), 1e-30)
    for part in ("params", "opt"):
        for path, a in one[part].items():
            assert rel_err(mesh[part][path], a) <= CROSS, (part, path)
    for r in (r0, r1):
        for part in ("params", "m", "v"):
            for path, shape in r["local"][part].items():
                assert shape[1] == 2, (part, path)   # (layers, E/n, ...)
        assert "mid.params.moe.router" in r["kept_whole"]
    # restored at (1, 2) and on one rank: the saved state bit for bit
    rcfg = cases.train_cases.f32_config(ARCH, check_every=1)
    tr = Trainer(rcfg, seed=0, device="cpu", ckpt_dir=runs["ckpt"])
    restored = [*at(runs, 2, (1, 2), "restore"),
                cases.train_cases._state(tr, rcfg, None)]
    for got in restored:
        assert got["step"] == mesh["step"] == 2
        for part in ("params", "opt"):
            assert set(got[part]) == set(mesh[part])
            for path, a in mesh[part].items():
                np.testing.assert_array_equal(got[part][path], a,
                                              err_msg=path)
    jr = j_train_config()
    jparams = to_jax(ttr.init_model(rcfg, device="cpu"), jr)
    jopt = joptim.init_opt_state(jr.optimizer, jparams)
    params, opt, step, _ = jck.restore(runs["ckpt"], jparams, jopt)
    assert step == 2
    for tree, part in ((params, "params"), ({"m": opt["m"],
                                            "v": opt["v"]}, "opt")):
        for path, a in jax.tree_util.tree_flatten_with_path(tree)[0]:
            key = ".".join(k.key for k in path)
            np.testing.assert_array_equal(np.asarray(a), mesh[part][key],
                                          err_msg=key)


@pytest.mark.parametrize("n,shape,ep", [(2, (1, 2), False),
                                        (2, (2, 1), True),
                                        (4, (2, 2), True)])
def test_moe_family_served_under_a_mesh_equals_jax(runs, n, shape, ep):
    """The MoE family's two requests (greedy and seeded sampled) on every
    rank, fused and gathered: JAX's single-device gathered engine's
    streams token for token (capacity follows each call's S on both
    sides); the no-mesh port's too. With the experts over 'data' each
    wave exchanges its rows; with 'model' split the expert products'
    partials are summed once a layer call."""
    ranks = at(runs, n, shape, "serve")
    want = runs["jax_streams"]
    for r in ranks:
        assert r["fused"] == want and r["gathered"] == want, shape
        assert r["stats"] == [shape[0], shape[1], n]
    assert ranks[0]["one"] == want
    counts = ranks[0]["fused_counts"]
    assert ("ep_dispatch" in counts) == ep
    assert ("tp_moe" in counts) == (shape[1] > 1)
    assert "ep_dispatch_grad" not in counts


def test_experts_off_the_batch_axis_raise(runs):
    for r in at(runs, 4, (2, 2), "refusal"):
        for key in ("train", "serve"):
            assert "experts over mesh axis 'model'" in r[key]
            assert "the batch over 'data'" in r[key]
