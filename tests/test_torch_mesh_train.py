"""Layer-parallel training across ranks on the CPU: the port's mesh path
(``torch.distributed`` over gloo, ranks spawned by
``repro_torch.launch.hostdev.spawn_host_ranks``) against the one-rank
port and the JAX package's single-device ``loss_fn``.

One spawn a mesh shape runs every case of that shape
(``tests/torch_mesh_cases.py``), each rank on one thread, the one-rank
comparison in the same process. Every spawn has a time limit (each
collective and the whole call), so a collective that deadlocks fails
the test instead of hanging the run. Reduced configs, float32.

Tolerances: bitwise where each rank repeats one rank's arithmetic on
its own chunks (the loss, every gradient leaf and the gradient norm at
(1, 2) and (1, 4), the params and moments after two updates at (1, 2));
1e-6 relative where a cross-rank sum changes the order of a reduction
(the forward residual norms, and on mt_marian the leaves reached
through the cross-attention cotangent, summed over the layers of every
rank, and with them the gradient norm; at (2, 1) and (2, 2) every number, the batch mean
being a sum over data ranks); against JAX the repo's float32
tolerances, loss 1e-5 and every leaf 1e-4 of its largest magnitude.
"""
import concurrent.futures
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_mesh_cases as cases
from repro.configs.reduce import reduce_config as j_reduce
from repro.configs.registry import get_config as j_get_config
from repro.models import transformer as jtr
from repro.optim import optimizers as joptim
from repro.train import checkpoint as jck
from repro_torch.launch import train as train_cli
from repro_torch.launch.hostdev import spawn_host_ranks

CROSS = 1e-6            # relative, a sum across ranks
LOSS_TOL = 1e-5         # against JAX
LEAF_REL = 1e-4
SPAWN_S = 180.0


def j_config(arch):
    rcfg = j_reduce(j_get_config(arch))
    return dataclasses.replace(rcfg, model=dataclasses.replace(
        rcfg.model, dtype="float32"))


def batch_for(rcfg, seed=0):
    rng = np.random.default_rng(seed)
    V, B, S = (rcfg.model.vocab_size, rcfg.shape.global_batch,
               rcfg.shape.seq_len)
    batch = {"tokens": rng.integers(0, V, (B, S)).astype(np.int32),
             "labels": rng.integers(0, V, (B, S)).astype(np.int32)}
    if rcfg.model.family == "encdec":
        batch["src_tokens"] = rng.integers(0, V, (B, S)).astype(np.int32)
    return batch


@pytest.fixture(scope="module")
def jax_inputs():
    """Per arch: the JAX params (numpy) and the batch."""
    out = {}
    for arch in ("qwen3_1p7b", "falcon_mamba_7b"):
        jr = j_config(arch)
        params = jtr.init_model(jax.random.PRNGKey(0), jr)
        out[arch] = {"params": jax.tree.map(np.asarray, params),
                     "batch": batch_for(jr)}
    return out


def spawn(shape, todo):
    res = spawn_host_ranks(shape[0] * shape[1], cases.run, shape, todo,
                           threads=1, timeout=SPAWN_S)
    assert [r["rank"] for r in res] == list(range(len(res)))
    assert all(r["threads"] == 1 for r in res)
    return [r["results"] for r in res]


def grads_cases(ji):
    marian = j_config("mt_marian")
    return [
        ("grads", {"arch": "qwen3_1p7b", **ji["qwen3_1p7b"]}),
        ("grads", {"arch": "falcon_mamba_7b", **ji["falcon_mamba_7b"]}),
        ("grads", {"arch": "mt_marian", "batch": batch_for(marian)}),
        ("grads", {"arch": "qwen3_1p7b", "mode": "serial",
                   **ji["qwen3_1p7b"]}),
        # levels 3: the coarse level's V-cycle sharded (shard_levels 2,
        # J1 = 2 chunks over 2 ranks) or gathered and replicated
        ("grads", {"arch": "qwen3_1p7b", "cfg": {"levels": 3,
                                                 "shard_levels": 2},
                   "batch": ji["qwen3_1p7b"]["batch"]}),
    ]


@pytest.fixture(scope="module")
def meshes(jax_inputs, tmp_path_factory):
    """Every mesh shape's spawn, started in two background threads (the
    checkpoint saved at 1x2 before 1x4 and 1x1 restore it): {shape:
    future of the per-rank results, "ckpt": its directory}. The JAX
    side compiles in the test's own thread meanwhile."""
    ji = jax_inputs
    ckpt = str(tmp_path_factory.mktemp("mesh_ckpt"))
    q = ji["qwen3_1p7b"]["batch"]
    todo = {
        "1x2": grads_cases(ji) + [
            ("grads", {"arch": "qwen3_1p7b", "cfg": {"levels": 3},
                       "batch": q}),
            # 8 layers - 2 buffers: J 3 chunks at cf 2, not over 2 ranks
            ("grads", {"arch": "qwen3_1p7b", "cfg": {"n_layers": 8,
                                                     "pad_to": 2},
                       "batch": q}),
            ("ckpt", {"arch": "qwen3_1p7b", "dir": ckpt, "save": True,
                      "steps": 2})],
        "1x4": grads_cases(ji) + [
            ("ckpt", {"arch": "qwen3_1p7b", "dir": ckpt, "save": False})],
        "1x1": [("ckpt", {"arch": "qwen3_1p7b", "dir": ckpt,
                          "save": False}),
                ("trainer", {"arch": "qwen3_1p7b", "steps": 3,
                             "cfg": {"check_every": 2}})],
        # a threshold of 0 trips at the first probe (step 2): the step
        # after it runs serial, through the rank-to-rank hand-off
        "2x2": [("trainer", {"arch": "qwen3_1p7b", "steps": 3,
                             "cfg": {"check_every": 2,
                                     "switch_threshold": 0.0}})],
        "2x1": [("grads", {"arch": "qwen3_1p7b", **ji["qwen3_1p7b"]})]}
    pool = concurrent.futures.ThreadPoolExecutor(2)
    futures = {}

    def chain(names):
        for name in names:
            if name == "1x1":                # restores 1x2's checkpoint
                concurrent.futures.wait([futures["1x2"]])
            shape = tuple(int(n) for n in name.split("x"))
            try:
                futures[name].set_result(spawn(shape, todo[name]))
            except BaseException as e:     # read by the tests
                futures[name].set_exception(e)
    for name in todo:
        futures[name] = concurrent.futures.Future()
    futures["ckpt"] = ckpt
    pool.submit(chain, ["1x2", "1x4"])
    pool.submit(chain, ["2x2", "2x1", "1x1"])
    yield futures
    pool.shutdown(wait=True)


@pytest.fixture(scope="module")
def jax_runs(meshes, jax_inputs):
    """JAX's loss and gradients in lp mode (compiled while the ranks
    run)."""
    out = {}
    for arch, ji in jax_inputs.items():
        jr = j_config(arch)
        (loss, _), grads = jax.jit(jax.value_and_grad(
            lambda p: jtr.loss_fn(p, jax.tree.map(jnp.asarray, ji["batch"]),
                                  jr, mode="lp"), has_aux=True))(
            jax.tree.map(jnp.asarray, ji["params"]))
        flat = {".".join(k.key for k in path): np.asarray(g) for path, g in
                jax.tree_util.tree_flatten_with_path(grads)[0]}
        out[arch] = {"loss": float(loss), "grads": flat}
    return out


def results(meshes, name):
    return meshes[name].result(timeout=4 * SPAWN_S)


def rel_err(got, want) -> float:
    return float(np.abs(np.asarray(got) - np.asarray(want)).max()
                 / max(np.abs(np.asarray(want)).max(), 1e-30))


def assert_bitwise_grads(res, cross=()):
    """The mesh run's loss and gradients against the one-rank run's:
    bitwise, except leaves under ``cross`` (within CROSS of their
    largest magnitude); the gradient norm bitwise unless ``cross`` (it
    sums each layer's squares in layer order), the forward residual
    norms within CROSS."""
    one, mesh = res["one"], res["mesh"]
    assert mesh["loss"] == one["loss"]
    assert set(mesh["grads"]) == set(one["grads"])
    for path, g in one["grads"].items():
        if path.split(".")[0] in cross:
            assert rel_err(mesh["grads"][path], g) <= CROSS, path
        else:
            np.testing.assert_array_equal(mesh["grads"][path], g,
                                          err_msg=path)
    assert rel_err(mesh["fwd_norms"], one["fwd_norms"]) <= CROSS
    if cross:
        assert rel_err(mesh["global_norm"], one["global_norm"]) <= CROSS
    else:
        assert mesh["global_norm"] == one["global_norm"]


def assert_matches_jax(res, ref):
    mesh = res["mesh"]
    np.testing.assert_allclose(mesh["loss"], ref["loss"], rtol=LOSS_TOL)
    assert set(mesh["grads"]) == set(ref["grads"])
    for path, want in ref["grads"].items():
        err = np.abs(mesh["grads"][path] - want).max()
        assert err <= LEAF_REL * np.abs(want).max(), (path, err)


@pytest.mark.parametrize("shape", ["1x2", "1x4"])
@pytest.mark.parametrize("case,arch", [(0, "qwen3_1p7b"),
                                       (1, "falcon_mamba_7b")])
def test_lp_grads_bitwise_one_rank_and_near_jax(shape, case, arch,
                                                meshes, jax_runs):
    res = results(meshes, shape)[0][case]
    assert_bitwise_grads(res)
    assert_matches_jax(res, jax_runs[arch])
    # the embedding's vocab axis names 'model' too: kept whole
    assert res["whole"] == ["embed.tok", "embed.out"]


@pytest.mark.parametrize("shape", ["1x2", "1x4"])
def test_encdec_grads_bitwise_but_the_xa_cotangent(shape, meshes):
    """mt_marian: the decoder's leaves bitwise; the encoder's and the
    shared embedding's take the cross-attention cotangent, summed over
    every rank's layers."""
    assert_bitwise_grads(results(meshes, shape)[0][2],
                         cross=("enc_mid", "embed"))


@pytest.mark.parametrize("shape", ["1x2", "1x4"])
def test_serial_mode_hands_the_state_from_rank_to_rank(shape, meshes):
    res = results(meshes, shape)[0][3]
    assert_bitwise_grads(res)
    # rank 0 hands the forward state on once; the adjoint ends on it
    assert res["counts"]["handoff"][0] == 1
    assert "halo" not in res["counts"]


@pytest.mark.parametrize("shape,case", [("1x2", 4), ("1x4", 4),
                                        ("1x2", 5)])
def test_three_levels_sharded_or_gathered_coarse_level(shape, case,
                                                       meshes):
    """levels 3 with shard_levels 2 (1x2: the coarse V-cycle over both
    ranks; 1x4: J1 = 2 does not divide over 4, gathered) and with
    shard_levels 1 (1x2, gathered): the one-rank run's numbers."""
    res = results(meshes, shape)[0][case]
    assert_bitwise_grads(res)
    gathered = "coarse_gather" in res["counts"]
    assert gathered == (shape == "1x4" or case == 5)


def test_non_divisible_chunks_run_replicated(meshes):
    res = results(meshes, "1x2")[0][6]
    assert_bitwise_grads(res)
    assert "halo" not in res["counts"] and "handoff" not in res["counts"]


def test_data_parallel_grads_within_a_sum_of_the_one_rank_run(meshes,
                                                              jax_runs):
    per_rank = [r[0] for r in results(meshes, "2x1")]
    res = per_rank[0]
    one, mesh = res["one"], res["mesh"]
    assert rel_err(mesh["loss"], one["loss"]) <= CROSS
    for path, g in one["grads"].items():
        assert rel_err(mesh["grads"][path], g) <= CROSS, path
    assert_matches_jax(res, jax_runs["qwen3_1p7b"])
    assert per_rank[1]["mesh"]["loss"] == mesh["loss"]


def test_trainer_2x2_agrees_across_ranks_and_switches_like_one_rank(
        meshes):
    runs = [r[0] for r in results(meshes, "2x2")]
    mesh = [r["mesh"] for r in runs]
    one = runs[0]["one"]
    for r in mesh[1:]:
        assert r["losses"] == mesh[0]["losses"]
        assert r["history"] == mesh[0]["history"]
        assert r["modes"] == mesh[0]["modes"]
    assert mesh[0]["modes"] == one["modes"] == ["lp", "lp", "serial"]
    assert [h[0] for h in mesh[0]["history"]] == [2]
    for got, want in zip(mesh[0]["history"][0][1:], one["history"][0][1:]):
        assert abs(got - want) <= CROSS * max(abs(want), 1e-30)
    np.testing.assert_allclose(mesh[0]["losses"], one["losses"], rtol=CROSS)


def test_world_one_mesh_trains_bitwise_like_no_mesh(meshes):
    res = results(meshes, "1x1")[0][1]
    assert res["mesh"]["losses"] == res["one"]["losses"]
    assert res["mesh"]["history"] == res["one"]["history"]
    assert res["mesh"]["fwd_norms"] == res["one"]["fwd_norms"]


@pytest.mark.parametrize("shape", ["1x1", "1x4"])
def test_checkpoint_from_1x2_restores_bitwise_elsewhere(shape, meshes):
    saved = results(meshes, "1x2")[0][-1]
    got = results(meshes, shape)[0][0 if shape == "1x1" else -1]
    assert got["step"] == saved["step"] == 2
    assert got["opt_step"] == saved["opt_step"] == 2
    for part in ("params", "opt"):
        assert set(got[part]) == set(saved[part])
        for path, a in saved[part].items():
            np.testing.assert_array_equal(got[part][path], a,
                                          err_msg=path)


def test_mesh_updates_bitwise_like_one_rank(meshes):
    """Two Trainer steps at (1, 2), gradient clipping and AdamW included:
    every param and moment leaf, gathered, is the one-rank Trainer's bit
    for bit (the clip scale comes from the same per-layer norm)."""
    saved = results(meshes, "1x2")[0][-1]
    one = saved["one"]
    assert saved["opt_step"] == one["opt_step"] == 2
    for part in ("params", "opt"):
        assert set(saved[part]) == set(one[part])
        for path, a in one[part].items():
            np.testing.assert_array_equal(saved[part][path], a,
                                          err_msg=path)


def test_jax_restore_reads_the_mesh_checkpoint(meshes):
    saved = results(meshes, "1x2")[0][-1]
    jr = j_config("qwen3_1p7b")
    jparams = jtr.init_model(jax.random.PRNGKey(0), jr)
    jopt = joptim.init_opt_state(jr.optimizer, jparams)
    params, opt, step, _ = jck.restore(meshes["ckpt"], jparams, jopt)
    assert step == 2 and int(opt["step"]) == 2
    for tree, part in ((params, "params"), ({"m": opt["m"],
                                            "v": opt["v"]}, "opt")):
        flat = {".".join(k.key for k in path): np.asarray(a) for path, a in
                jax.tree_util.tree_flatten_with_path(tree)[0]}
        assert set(flat) == set(saved[part])
        for path, a in flat.items():
            np.testing.assert_array_equal(a, saved[part][path],
                                          err_msg=path)


def test_cli_production_mesh_needs_its_ranks():
    """Without a launched group of 256 ranks, --mesh single raises the
    reference's device-count error before anything is built."""
    with pytest.raises(RuntimeError,
                       match=r"need 256 devices for mesh \(16, 16\); have 1"):
        train_cli.main(["--arch", "qwen3_1p7b", "--reduced", "--device",
                        "cpu", "--mesh", "single", "--steps", "1"])
    with pytest.raises(RuntimeError,
                       match=r"need 512 devices for mesh \(2, 16, 16\)"):
        train_cli.main(["--arch", "qwen3_1p7b", "--reduced", "--device",
                        "cpu", "--mesh", "multi", "--steps", "1"])
