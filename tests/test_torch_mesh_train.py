"""Layer-parallel and tensor-parallel training across ranks on the CPU:
the port's mesh path (``torch.distributed`` over gloo, ranks spawned by
``repro_torch.launch.hostdev.spawn_host_ranks``) against the one-rank
port and the JAX package's single-device ``loss_fn``.

One spawn a mesh shape runs every case of that shape
(``tests/torch_mesh_cases.py``), each rank on one thread, the one-rank
comparison in the same process. Every spawn has a time limit (each
collective and the whole call), so a collective that deadlocks fails
the test instead of hanging the run. Reduced configs, float32.

Every training rule maps the vocab to 'model', and the reduced vocab
(256) divides over 2 and 4 ranks: there the head's sums cross ranks
(the vocab-parallel loss, the head's input cotangent summed over the
vocab's ranks). zamba2 trains under ``tp_sharding``: its heads, MLP
and Mamba2 rows are cut over 'model' too.

Tolerances: bitwise where each rank repeats one rank's arithmetic on
its own chunks: with a vocab that does not divide over 'model' (255,
the head replicated) the loss, every gradient leaf and the gradient
norm at (1, 2) and (1, 4) and the params and moments after two updates
at (1, 2); with the vocab cut, the embeddings (a sum of one non-zero
term with zeros) and, where only the vocab is cut, the state the head
reads. 1e-6 relative (CROSS) where a cross-rank sum changes the order
of a reduction (the forward residual norms, and on mt_marian the
leaves reached through the cross-attention cotangent, summed over the
layers of every rank, and with them the gradient norm; at (2, 1) and
(2, 2) every number, the batch mean being a sum over data ranks).
TP_REL (5e-6 of a leaf's largest magnitude; measured before it was
set: at most 9.0e-7 on the vocab-cut qwen3 / falcon / mt_marian cases,
3.00e-6 on zamba2's ``backbone.mixer.norm_scale`` at (1, 4)) where the
Megatron split's sums cross ranks: the vocab-cut cases' loss, leaves and
gradient norm, zamba2's at (1, 2), (1, 4) and (2, 2), and every param
and AdamW moment leaf after two updates (measured before it was set: at
most 1.81e-6 / 1.31e-6 on qwen3, 1.14e-6 / 2.22e-6 on zamba2), but
zamba2's zero-initialised ``conv_b`` and ``dt_bias``: after two warm-up
steps such a param is AdamW's updates alone, and an element whose
gradient lies near 0 moves by about lr in a direction that follows the
gradient's rounding, so they are held within ZERO_INIT_REL of their
largest magnitude (1e-4; measured 1.82e-5 / 5.12e-6), their moments
within TP_REL. Against JAX the repo's float32 tolerances, loss 1e-5 and
every leaf 1e-4 of its largest magnitude.
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
TP_REL = 5e-6           # relative to a leaf's max, the Megatron split
ZERO_INIT_REL = 1e-4    # ... a zero-initialised param after two updates
LOSS_TOL = 1e-5         # against JAX
LEAF_REL = 1e-4
SPAWN_S = 180.0


ODD = {"vocab_size": 255}      # does not divide over 2 or 4 ranks
QWEN, FALCON, MARIAN, ZAMBA = ("qwen3_1p7b", "falcon_mamba_7b",
                               "mt_marian", "zamba2_1p2b")


def j_config(arch):
    rcfg = j_reduce(j_get_config(arch))
    return dataclasses.replace(rcfg, model=dataclasses.replace(
        rcfg.model, dtype="float32"))


def batch_for(rcfg, seed=0, vocab=None):
    rng = np.random.default_rng(seed)
    V, B, S = (vocab or rcfg.model.vocab_size, rcfg.shape.global_batch,
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
    for arch in (QWEN, FALCON, ZAMBA):
        jr = j_config(arch)
        params = jtr.init_model(jax.random.PRNGKey(0), jr)
        out[arch] = {"params": jax.tree.map(np.asarray, params),
                     "batch": batch_for(jr)}
    return out


def spawn(shape, todo):
    res = spawn_host_ranks(shape[0] * shape[1], cases.run, shape,
                           [c for _, c in todo], threads=1, timeout=SPAWN_S)
    assert [r["rank"] for r in res] == list(range(len(res)))
    assert all(r["threads"] == 1 for r in res)
    return [dict(zip((name for name, _ in todo), r["results"],
                     strict=True)) for r in res]


def odd(arch, **cfg):
    """A grads case of ``arch`` (the port's params) with the vocab of
    255, which the rules cannot cut over 'model'."""
    return ("grads", {"arch": arch, "cfg": {"model": ODD, **cfg},
                      "batch": batch_for(j_config(arch), vocab=255)})


def grads_cases(ji):
    """The (1, 2) and (1, 4) spawns' shared cases, by name."""
    q = ji[QWEN]
    return [
        ("qwen3", ("grads", {"arch": QWEN, "states": True, **q})),
        ("falcon", ("grads", {"arch": FALCON, "states": True,
                              **ji[FALCON]})),
        ("marian", odd(MARIAN)),
        ("serial", ("grads", {"arch": QWEN, "mode": "serial",
                              "cfg": {"model": ODD},
                              "batch": batch_for(j_config(QWEN),
                                                 vocab=255)})),
        # levels 3: the coarse level's V-cycle sharded (shard_levels 2,
        # J1 = 2 chunks over 2 ranks) or gathered and replicated
        ("levels3s2", odd(QWEN, levels=3, shard_levels=2)),
        ("qwen3_odd", odd(QWEN)),
        ("falcon_odd", odd(FALCON)),
        ("zamba2", ("grads", {"arch": ZAMBA, "states": True,
                              **ji[ZAMBA]})),
    ]


@pytest.fixture(scope="module")
def meshes(jax_inputs, tmp_path_factory):
    """Every mesh shape's spawn, started in two background threads (the
    checkpoints saved at 1x2 before 1x4, 2x1 and 1x1 restore them):
    {shape: future of the per-rank results by case name, "ckpt" /
    "ckpt_odd" / "ckpt_zamba2": their directories}. The JAX side
    compiles in the test's own thread meanwhile."""
    ji = jax_inputs
    dirs = {k: str(tmp_path_factory.mktemp(k))
            for k in ("ckpt", "ckpt_odd", "ckpt_zamba2")}
    q = ji[QWEN]["batch"]
    restore = [("ckpt", ("ckpt", {"arch": QWEN, "dir": dirs["ckpt"],
                                  "save": False})),
               ("ckpt_zamba2", ("ckpt", {"arch": ZAMBA, "save": False,
                                         "dir": dirs["ckpt_zamba2"]}))]
    todo = {
        "1x2": grads_cases(ji) + [
            ("levels3", odd(QWEN, levels=3)),
            # 8 layers - 2 buffers: J 3 chunks at cf 2, not over 2 ranks
            ("chunks_odd", odd(QWEN, n_layers=8, pad_to=2)),
            ("marian_cut", ("grads", {"arch": MARIAN,
                                      "batch": batch_for(j_config(MARIAN))})),
            ("ckpt", ("ckpt", {"arch": QWEN, "dir": dirs["ckpt"],
                               "save": True, "steps": 2})),
            ("ckpt_odd", ("ckpt", {"arch": QWEN, "cfg": {"model": ODD},
                                   "dir": dirs["ckpt_odd"], "save": True,
                                   "steps": 2})),
            ("ckpt_zamba2", ("ckpt", {"arch": ZAMBA, "save": True,
                                      "dir": dirs["ckpt_zamba2"],
                                      "steps": 2}))],
        "1x4": grads_cases(ji) + restore,
        "1x1": restore + [
            ("trainer", ("trainer", {"arch": QWEN, "steps": 3,
                                     "cfg": {"check_every": 2}})),
            ("trainer_zamba2", ("trainer", {"arch": ZAMBA, "steps": 2}))],
        # a threshold of 0 trips at the first probe (step 2): the step
        # after it runs serial, through the rank-to-rank hand-off
        "2x2": [("trainer", ("trainer", {"arch": QWEN, "steps": 3,
                                         "cfg": {"check_every": 2,
                                                 "switch_threshold": 0.0}})),
                ("zamba2", ("grads", {"arch": ZAMBA, **ji[ZAMBA]}))],
        "2x1": [("qwen3", ("grads", {"arch": QWEN, **ji[QWEN]})),
                restore[1]]}
    pool = concurrent.futures.ThreadPoolExecutor(2)
    futures = {}

    def chain(names):
        for name in names:
            if name in ("1x1", "2x1"):       # restore 1x2's checkpoints
                concurrent.futures.wait([futures["1x2"]])
            shape = tuple(int(n) for n in name.split("x"))
            try:
                futures[name].set_result(spawn(shape, todo[name]))
            except BaseException as e:     # read by the tests
                futures[name].set_exception(e)
    for name in todo:
        futures[name] = concurrent.futures.Future()
    futures.update(dirs)
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


def assert_near_one_rank(res, bound=TP_REL):
    """The mesh run's loss, every gradient leaf (gathered) and the
    gradient norm within ``bound`` of the one-rank run's (a leaf: of its
    largest magnitude), the forward residual norms within CROSS.
    Returns the leaves' errors."""
    one, mesh = res["one"], res["mesh"]
    assert rel_err(mesh["loss"], one["loss"]) <= bound
    assert rel_err(mesh["global_norm"], one["global_norm"]) <= bound
    assert rel_err(mesh["fwd_norms"], one["fwd_norms"]) <= CROSS
    assert set(mesh["grads"]) == set(one["grads"])
    errs = {path: rel_err(mesh["grads"][path], g)
            for path, g in one["grads"].items()}
    for path, e in errs.items():
        assert e <= bound, (path, e)
    return errs


def assert_states_bitwise(res, prehead=True):
    """The embeddings (one non-zero term summed with zeros over the
    vocab's ranks) bitwise one rank's; with ``prehead`` the state the
    head reads too (nothing but the vocab is cut)."""
    one, mesh = res["one_states"], res["mesh_states"]
    np.testing.assert_array_equal(mesh["embed"], one["embed"])
    if prehead:
        np.testing.assert_array_equal(mesh["prehead"], one["prehead"])


@pytest.mark.parametrize("shape", ["1x2", "1x4"])
@pytest.mark.parametrize("case,arch", [(0, "qwen3_1p7b"),
                                       (1, "falcon_mamba_7b")])
def test_lp_grads_bitwise_one_rank_and_near_jax(shape, case, arch,
                                                meshes, jax_runs):
    """The vocab (256) cut over 'model' as the training rules say: every
    rank holds its vocab rows of ``embed.tok`` / ``embed.out`` (none kept
    whole), the head and the loss run vocab-parallel. The embeddings and
    the state the head reads bitwise one rank's; the loss, every leaf
    and the gradient norm within TP_REL (the head's sums cross ranks);
    JAX's tolerances unchanged. With a vocab that does not divide the
    old contract holds bit for bit
    (``test_lp_grads_bitwise_with_a_vocab_that_does_not_divide``)."""
    res = results(meshes, shape)[0][("qwen3", "falcon")[case]]
    assert_states_bitwise(res)
    assert_near_one_rank(res)
    assert_matches_jax(res, jax_runs[arch])
    assert res["whole"] == []
    assert res["counts"]["tp_loss"][0] == 1
    assert res["counts"]["tp_head_in_grad"][0] == 1


@pytest.mark.parametrize("shape", ["1x2", "1x4"])
@pytest.mark.parametrize("arch", ["qwen3", "falcon"])
def test_lp_grads_bitwise_with_a_vocab_that_does_not_divide(shape, arch,
                                                            meshes):
    """vocab 255: the rules cannot cut it over 'model', the head runs
    whole on every rank and the MGRIT trunk's chunk arithmetic is one
    rank's: loss, every leaf and the gradient norm bit for bit; the
    spec drops the mapping, so the embeddings are whole by their spec
    (none listed) and no tensor-parallel collective runs."""
    res = results(meshes, shape)[0][arch + "_odd"]
    assert_bitwise_grads(res)
    assert res["whole"] == []
    assert not any(k.startswith("tp_") for k in res["counts"])


@pytest.mark.parametrize("shape", ["1x2", "1x4"])
def test_encdec_grads_bitwise_but_the_xa_cotangent(shape, meshes):
    """mt_marian (vocab 255, not cut): the decoder's leaves bitwise; the
    encoder's and the shared embedding's take the cross-attention
    cotangent, summed over every rank's layers."""
    assert_bitwise_grads(results(meshes, shape)[0]["marian"],
                         cross=("enc_mid", "embed"))


def test_encdec_vocab_parallel_lookups_near_one_rank(meshes):
    """mt_marian with the vocab cut at (1, 2): the encoder's and the
    decoder's lookups of the one shared table vocab-parallel, its rows
    cut; loss, leaves and gradient norm within TP_REL of one rank."""
    res = results(meshes, "1x2")[0]["marian_cut"]
    assert_near_one_rank(res)
    assert res["whole"] == []
    assert res["counts"]["tp_embed"][0] == 2


@pytest.mark.parametrize("shape", ["1x2", "1x4"])
def test_serial_mode_hands_the_state_from_rank_to_rank(shape, meshes):
    res = results(meshes, shape)[0]["serial"]
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
    shard_levels 1 (1x2, gathered): the one-rank run's numbers (vocab
    255)."""
    res = results(meshes, shape)[0][{4: "levels3s2", 5: "levels3"}[case]]
    assert_bitwise_grads(res)
    gathered = "coarse_gather" in res["counts"]
    assert gathered == (shape == "1x4" or case == 5)


def test_non_divisible_chunks_run_replicated(meshes):
    res = results(meshes, "1x2")[0]["chunks_odd"]
    assert_bitwise_grads(res)
    assert "halo" not in res["counts"] and "handoff" not in res["counts"]


ZAMBA_PARTIAL = {"backbone.mixer." + k for k in (
    "in_proj", "conv_w", "conv_b", "dt_bias", "D", "A_log", "norm_scale")}


def _zamba2_cut():
    """zamba2's TP-cut leaves, each with its local size along the cut
    dimension from the whole size and the ranks: an even cut, or
    mamba2's packed ``[z | x | B C | dt]`` / ``[x | B C]`` with B C
    whole on every rank."""
    s = cases.f32_config(ZAMBA).model.ssm

    def even(full, n):
        return full // n

    def packed(full, n):
        return (full - 2 * s.d_state) // n + 2 * s.d_state

    return {"embed.tok": even, "embed.out": even,
            "backbone.mixer.out_proj": even,
            "backbone.mixer.in_proj": packed,
            "backbone.mixer.conv_w": packed,
            **{f"shared_attn.attn.{k}": even
               for k in ("wq", "wk", "wv", "wo")},
            **{f"shared_attn.mlp.{k}": even
               for k in ("w_in", "w_gate", "w_out")}}


ZAMBA_CUT = _zamba2_cut()


@pytest.mark.parametrize("shape", ["1x2", "1x4", "2x2"])
def test_zamba2_tensor_parallel_grads_near_one_rank_and_jax(shape, meshes,
                                                           jax_runs):
    """zamba2 under its own ``tp_sharding``: the shared block's heads and
    MLP columns, the Mamba2 backbone's heads and rows and the vocab cut
    over 'model', forward and backward. The loss, every gathered leaf
    (the leaves the ranks read in part among them: the B C blocks of
    ``in_proj`` and ``conv_w``, ``conv_b``, the per-head ``dt_bias`` /
    ``D`` / ``A_log`` and the gated norm's ``norm_scale``, summed over
    'model') and the gradient norm within TP_REL of the one-rank port
    and within JAX's tolerances; every rank the same loss; the
    embeddings bitwise one rank's (at (1, x), where the rows are the
    same); nothing kept whole."""
    ranks = [r["zamba2"] for r in results(meshes, shape)]
    res = ranks[0]
    errs = assert_near_one_rank(res)
    assert ZAMBA_PARTIAL <= set(errs)
    assert_matches_jax(res, jax_runs[ZAMBA])
    assert {r["mesh"]["loss"] for r in ranks} == {res["mesh"]["loss"]}
    if shape != "2x2":
        assert_states_bitwise(res, prehead=False)
    assert res["whole"] == []
    c = res["counts"]
    assert c["grad_tp"][0] == 1 and c["grad_norm_tp"][0] == 1
    # each forward sum has its backward sum: 2 shared-block calls, 8
    # Mamba2 layers
    for fwd, bwd, n in (("tp_attn", "tp_attn_in_grad", 2),
                        ("tp_mlp", "tp_mlp_in_grad", 2),
                        ("tp_ssm_out", "tp_ssm_in_grad", 8),
                        ("tp_ssm_norm", "tp_ssm_norm_grad", 8)):
        assert c[fwd][0] == c[bwd][0] == n, fwd


def test_data_parallel_grads_within_a_sum_of_the_one_rank_run(meshes,
                                                              jax_runs):
    per_rank = [r["qwen3"] for r in results(meshes, "2x1")]
    res = per_rank[0]
    one, mesh = res["one"], res["mesh"]
    assert rel_err(mesh["loss"], one["loss"]) <= CROSS
    for path, g in one["grads"].items():
        assert rel_err(mesh["grads"][path], g) <= CROSS, path
    assert_matches_jax(res, jax_runs["qwen3_1p7b"])
    assert per_rank[1]["mesh"]["loss"] == mesh["loss"]


def test_trainer_2x2_agrees_across_ranks_and_switches_like_one_rank(
        meshes):
    runs = [r["trainer"] for r in results(meshes, "2x2")]
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


def assert_world_one_bitwise(res):
    """A (1, 1) mesh's Trainer is the meshless one's bit for bit, and
    issues no collective (its every axis has one rank)."""
    assert res["mesh"]["losses"] == res["one"]["losses"]
    assert res["mesh"]["history"] == res["one"]["history"]
    assert res["mesh"]["fwd_norms"] == res["one"]["fwd_norms"]
    assert res["counts"] == {}


def test_world_one_mesh_trains_bitwise_like_no_mesh(meshes):
    assert_world_one_bitwise(results(meshes, "1x1")[0]["trainer"])


def test_world_one_mesh_trains_zamba2_bitwise_like_no_mesh(meshes):
    """zamba2 under ``tp_sharding``, whose heads, MLP and rows no axis of
    one rank cuts."""
    assert_world_one_bitwise(results(meshes, "1x1")[0]["trainer_zamba2"])


@pytest.mark.parametrize("shape", ["1x1", "1x4"])
def test_checkpoint_from_1x2_restores_bitwise_elsewhere(shape, meshes):
    """qwen3's checkpoint, saved at (1, 2) with the vocab cut, restored
    bit for bit on one rank and at (1, 4), where each rank stores a
    quarter of ``embed.tok`` / ``embed.out`` and of their moments and
    nothing is kept whole."""
    saved = results(meshes, "1x2")[0]["ckpt"]
    got = results(meshes, shape)[0]["ckpt"]
    if shape == "1x4":
        assert got["kept_whole"] == []
        for part in ("params", "m", "v"):
            for leaf in ("embed.tok", "embed.out"):
                assert got["local"][part][leaf][0] * 4 == \
                    saved["params"][leaf].shape[0], (part, leaf)
    assert got["step"] == saved["step"] == 2
    assert got["opt_step"] == saved["opt_step"] == 2
    for part in ("params", "opt"):
        assert set(got[part]) == set(saved[part])
        for path, a in saved[part].items():
            np.testing.assert_array_equal(got[part][path], a,
                                          err_msg=path)


def test_mesh_updates_bitwise_like_one_rank(meshes):
    """Two Trainer steps at (1, 2), gradient clipping and AdamW included,
    with a vocab (255) that the rules cannot cut: every param and moment
    leaf, gathered, is the one-rank Trainer's bit for bit (the clip scale
    comes from the same per-layer norm)."""
    saved = results(meshes, "1x2")[0]["ckpt_odd"]
    one = saved["one"]
    assert saved["opt_step"] == one["opt_step"] == 2
    for part in ("params", "opt"):
        assert set(saved[part]) == set(one[part])
        for path, a in one[part].items():
            np.testing.assert_array_equal(saved[part][path], a,
                                          err_msg=path)


def assert_state_near(got, one, zero_init=()):
    """Every param and AdamW moment leaf of a Trainer's state (gathered)
    within TP_REL of the one-rank Trainer's, relative to the leaf's own
    largest magnitude (an all-zero leaf: exactly); the params named in
    ``zero_init`` within ZERO_INIT_REL."""
    for part in ("params", "opt"):
        assert set(got[part]) == set(one[part])
        for path, a in one[part].items():
            err = np.abs(got[part][path] - a).max()
            bound = ZERO_INIT_REL if part == "params" and path in zero_init \
                else TP_REL
            assert err <= bound * np.abs(a).max(), (part, path, err)


def test_mesh_updates_with_the_vocab_cut_near_one_rank(meshes):
    """The same two steps with the vocab (256) cut over 'model': every
    param and moment leaf within TP_REL of the one-rank Trainer's,
    relative to the leaf's largest magnitude; the moments' step the
    same."""
    saved = results(meshes, "1x2")[0]["ckpt"]
    one = saved["one"]
    assert saved["opt_step"] == one["opt_step"] == 2
    assert_state_near(saved, one)


@pytest.mark.parametrize("shape", ["1x1", "2x1", "1x4"])
def test_zamba2_trainer_checkpoint_restores_on_any_mesh(shape, meshes):
    """zamba2's two Trainer steps at (1, 2) under ``tp_sharding``: every
    param and moment leaf within TP_REL of one rank's Trainer, relative
    to the leaf's largest magnitude, the zero-initialised ``conv_b`` and
    ``dt_bias`` params within ZERO_INIT_REL; each rank storing half of
    every TP-cut leaf and of its AdamW moments.
    The checkpoint (leaves saved whole, the JAX package's format)
    restores bit for bit on one rank, at (2, 1) and at (1, 4), where a
    rank stores a quarter of every TP-cut leaf and its moments and
    nothing is kept whole."""
    saved = results(meshes, "1x2")[0]["ckpt_zamba2"]
    one = saved["one"]
    assert_state_near(saved, one, zero_init={
        "backbone.mixer.conv_b", "backbone.mixer.dt_bias"})
    got = results(meshes, shape)[0]["ckpt_zamba2"]
    assert got["step"] == saved["step"] == 2
    for part in ("params", "opt"):
        assert set(got[part]) == set(saved[part])
        for path, a in saved[part].items():
            np.testing.assert_array_equal(got[part][path], a,
                                          err_msg=path)
    for res, n in ((saved, 2), (got, 4 if shape == "1x4" else 1)):
        assert res["kept_whole"] == []
        for part in ("params", "m", "v"):
            for path, local in res["local"][part].items():
                full = list(one["params"][path].shape)
                cut = [i for i, (a, b) in enumerate(zip(local, full))
                       if a != b]
                assert len(cut) == (n > 1 and path in ZAMBA_CUT), \
                    (part, path, local)
                if cut:
                    d = cut[0]
                    want = ZAMBA_CUT[path](full[d], n)
                    assert local[d] == want, (part, path, local, want)


def test_jax_restore_reads_the_mesh_checkpoint(meshes):
    saved = results(meshes, "1x2")[0]["ckpt"]
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
