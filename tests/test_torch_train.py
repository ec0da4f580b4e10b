"""The port's training path against the JAX package, float32 on the CPU,
plus torch mirrors of the reference's MGRIT, adjoint-gradient and runtime
tests.

Inputs are made with numpy from a seed; JAX params are converted with
``repro_torch.convert.params_from_jax`` and optimizer state starts at
zeros on both sides. Tolerances: 2e-5 for attention and a block's F (the
repo's float32 attention tolerance), 1e-5 for the MGRIT solves on a toy
step, per gradient leaf ``max|port - jax| <= 1e-4 * max|jax leaf|``
through a whole model, 1e-6 for one optimizer update, 1e-3 relative for
losses after three optimizer steps (float32 summation order compounds
through the updates).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import (ModelConfig as JModelConfig,
                                OptimizerConfig as JOptimizerConfig)
from repro.configs.reduce import reduce_config as j_reduce
from repro.configs.registry import get_config as j_get_config
from repro.core import mgrit as jmgrit
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.models import attention as jattn
from repro.models import blocks as jblocks
from repro.models import transformer as jtr
from repro.optim import optimizers as joptim
from repro.train.trainer import Trainer as JTrainer
from repro_torch.configs.base import (MGRITConfig, ModelConfig,
                                      OptimizerConfig, RunConfig,
                                      ShapeConfig)
from repro_torch.configs.reduce import reduce_config as t_reduce
from repro_torch.configs.registry import get_config as t_get_config
from repro_torch.convert import params_from_jax
from repro_torch.core import lp, mgrit
from repro_torch.core.adaptive import AdaptiveController, convergence_factor
from repro_torch.data.pipeline import SyntheticLM, shard_batch
from repro_torch.models import attention as tattn
from repro_torch.models import blocks as tblocks
from repro_torch.models import transformer as ttr
from repro_torch.models.layers import norm_apply, unembed
from repro_torch.optim import optimizers
from repro_torch.train.trainer import Trainer
from repro_torch.tree import leaves_with_paths, unflatten

torch.set_num_threads(2)
ATTN_TOL = 2e-5
SOLVE_TOL = 1e-5
GRAD_REL = 1e-4
ARCHS = ["deepseek_7b", "qwen3_1p7b", "gpt2_nanogpt"]


def rnd(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale) \
        .astype(np.float32)


def t(a):
    return torch.from_numpy(np.array(a))


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=tol, atol=tol)


def f32_configs(arch, **mgrit_kw):
    """The reduced config of ``arch`` in float32, for both packages."""
    def one(get, reduce):
        rcfg = reduce(get(arch))
        return dataclasses.replace(
            rcfg, model=dataclasses.replace(rcfg.model, dtype="float32"),
            mgrit=dataclasses.replace(rcfg.mgrit, **mgrit_kw))
    return one(j_get_config, j_reduce), one(t_get_config, t_reduce)


def torch_value_and_grad(params, batch, rcfg, mode):
    paths, leaves = zip(*leaves_with_paths(params))
    leaves = [p.detach().requires_grad_(True) for p in leaves]
    loss, diag = ttr.loss_fn(unflatten(zip(paths, leaves)), batch, rcfg,
                             mode=mode)
    grads = torch.autograd.grad(loss, leaves)
    return loss, diag, dict(zip(paths, grads))


def assert_grads_close(got: dict, want_tree, rel=GRAD_REL):
    want = dict(leaves_with_paths(np_tree(want_tree)))
    assert set(got) == set(want)
    for path, w in want.items():
        err = np.abs(got[path].numpy() - w).max()
        assert err <= rel * np.abs(w).max(), (path, err, np.abs(w).max())


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------


def attn_setup(seed, S=16, hkv=2, **kw):
    base = dict(d_model=32, n_heads=4, n_kv_heads=hkv, d_ff=64,
                vocab_size=64, head_dim=8, dtype="float32", qk_norm=True)
    base.update(kw)
    jc, tc = JModelConfig(**base), ModelConfig(**base)
    jp = jattn.init_attention(jax.random.PRNGKey(seed), jc)
    x = rnd(seed, (2, S, 32))
    pos = np.arange(S, dtype=np.int32)
    rope_j = jattn.rope_freqs(8, jc.rope_theta, jnp.asarray(pos))
    rope_t = tuple(t(np.asarray(r)) for r in rope_j)
    return jc, tc, jp, {k: t(v) for k, v in np_tree(jp).items()}, x, \
        rope_j, rope_t


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hkv", [1, 2, 4])
def test_attention_apply_matches_jax(causal, hkv):
    jc, tc, jp, tp, x, rope_j, rope_t = attn_setup(hkv, hkv=hkv)
    want, _ = jattn.attention_apply(jp, jnp.asarray(x), jc, causal=causal,
                                    rope=rope_j)
    got = tattn.attention_apply(tp, t(x), tc, causal=causal, rope=rope_t)
    close(got, want, ATTN_TOL)


def test_attention_apply_takes_the_chunked_branch_like_jax():
    """At S >= attn_chunk both packages switch to chunked attention."""
    jc, tc, jp, tp, x, rope_j, rope_t = attn_setup(5, S=512,
                                                   attn_chunk=512)
    want, _ = jattn.attention_apply(jp, jnp.asarray(x), jc, causal=True,
                                    rope=rope_j)
    got = tattn.attention_apply(tp, t(x), tc, causal=True, rope=rope_t)
    close(got, want, ATTN_TOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("H,Hkv", [(4, 2), (4, 1)])
def test_chunked_attention_matches_jax(causal, H, Hkv):
    q, k, v = (rnd(s, (2, 32, h, 8)) for s, h in ((1, H), (2, Hkv),
                                                   (3, Hkv)))
    want = jattn.chunked_attention(*map(jnp.asarray, (q, k, v)),
                                   causal=causal, q_block=8, k_block=16)
    got = tattn.chunked_attention(t(q), t(k), t(v), causal=causal,
                                  q_block=8, k_block=16)
    close(got, want, ATTN_TOL)
    close(got, tattn.dot_attention(t(q), t(k), t(v), causal=causal),
          ATTN_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_block_F_matches_jax(arch):
    jr, tr = f32_configs(arch)
    jp = jblocks.init_block(jax.random.PRNGKey(3), jr.model)
    tp = jax.tree.map(lambda a: t(np.asarray(a)), jp)
    z = rnd(4, (2, 16, jr.model.d_model))
    rope = jattn.rope_freqs(jr.model.resolved_head_dim, jr.model.rope_theta,
                            jnp.arange(16, dtype=jnp.int32))
    want, _ = jblocks.block_F(jp, jnp.asarray(z), jr.model, kind="attn_mlp",
                              causal=True, rope=rope)
    got = tblocks.block_F(tp, t(z), tr.model, kind="attn_mlp", causal=True,
                          rope=tuple(t(np.asarray(r)) for r in rope))
    close(got, want, ATTN_TOL)


def toy_setup(seed, N=16, B=4, D=8, h=0.25):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((N, D, D)) * 0.3).astype(np.float32)
    b = (rng.standard_normal((N, D)) * 0.1).astype(np.float32)
    z0 = rng.standard_normal((B, D)).astype(np.float32)
    jstack = {"params": {"w": jnp.asarray(w), "b": jnp.asarray(b)},
              "gate": jnp.ones((N,))}
    tstack = mgrit.slots({"params": {"w": t(w), "b": t(b)},
                          "gate": torch.ones(N)})
    return jstack, tstack, z0, h


def j_toy_step(slot, z, h):
    f = jnp.tanh(z @ slot["params"]["w"] + slot["params"]["b"])
    return z + jnp.asarray(h, z.dtype) * slot["gate"].astype(z.dtype) * f


def toy_step(slot, z, h):
    """Nonlinear toy Phi: z + h*gate*tanh(z @ W + b)."""
    f = torch.tanh(z @ slot["params"]["w"] + slot["params"]["b"])
    return z + h * slot["gate"].to(z.dtype) * f


@pytest.mark.parametrize("cf,levels,iters", [(2, 2, 1), (4, 2, 2),
                                             (2, 3, 2)])
def test_mgrit_and_serial_solve_match_jax(cf, levels, iters):
    jstack, tstack, z0, h = toy_setup(cf * 10 + levels)
    jstates, jzT = jmgrit.serial_solve(j_toy_step, jstack, jnp.asarray(z0),
                                       h)
    states, zT = mgrit.serial_solve(toy_step, tstack, t(z0), h)
    close(states, jstates, SOLVE_TOL)
    close(zT, jzT, SOLVE_TOL)
    jspec = jmgrit.MGRITSpec(cf=cf, levels=levels, iters=iters, h=h,
                             shard=False, znames=(None, None))
    js, jz, jn = jmgrit.mgrit_solve(j_toy_step, jstack, jnp.asarray(z0),
                                    jspec)
    spec = mgrit.MGRITSpec(cf=cf, levels=levels, iters=iters, h=h)
    s, z, n = mgrit.mgrit_solve(toy_step, tstack, t(z0), spec)
    close(s, js, SOLVE_TOL)
    close(z, jz, SOLVE_TOL)
    close(n, jn, SOLVE_TOL)


# ---------------------------------------------------------------------------
# The whole model: loss, fwd_norms and every gradient leaf
# ---------------------------------------------------------------------------


def model_setup(arch, seed=0, **mgrit_kw):
    jr, tr = f32_configs(arch, **mgrit_kw)
    jparams = jtr.init_model(jax.random.PRNGKey(seed), jr)
    tparams = params_from_jax(np_tree(jparams), tr, "cpu")
    rng = np.random.default_rng(seed)
    V = jr.model.vocab_size
    batch = {"tokens": rng.integers(0, V, (2, 16)).astype(np.int32),
             "labels": rng.integers(0, V, (2, 16)).astype(np.int32)}
    return jr, tr, jparams, tparams, batch


@pytest.mark.parametrize("mode", ["lp", "serial"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_fn_and_grads_match_jax(arch, mode):
    jr, tr, jparams, tparams, batch = model_setup(arch)
    (jl, jdiag), jg = jax.jit(jax.value_and_grad(
        lambda p: jtr.loss_fn(p, jax.tree.map(jnp.asarray, batch), jr,
                              mode=mode), has_aux=True))(jparams)
    loss, diag, grads = torch_value_and_grad(
        tparams, shard_batch(batch, "cpu"), tr, mode)
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    close(diag["fwd_norms"], jdiag["fwd_norms"], 1e-4 * max(
        1.0, float(np.abs(np.asarray(jdiag["fwd_norms"])).max())))
    assert_grads_close(grads, jg)


def test_apply_updates_matches_jax():
    cfg = dict(name="adamw", lr=1e-2, warmup_steps=2, total_steps=10)
    jcfg, tcfg = JOptimizerConfig(**cfg), OptimizerConfig(**cfg)
    p = {"a": rnd(1, (3, 4)), "mid": {"w": rnd(2, (5,)),
                                      "gate": np.ones(2, np.float32)}}
    g = {"a": rnd(3, (3, 4), 3.0), "mid": {"w": rnd(4, (5,), 3.0),
                                           "gate": rnd(5, (2,))}}
    jp = jax.tree.map(jnp.asarray, p)
    js = joptim.init_opt_state(jcfg, jp)
    tp = jax.tree.map(t, p)
    ts = optimizers.init_opt_state(tcfg, tp)
    for step in range(3):
        gs = jax.tree.map(lambda a: a * (step + 1), g)
        jp, js, jm = joptim.apply_updates(jcfg, jp, jax.tree.map(
            jnp.asarray, gs), js)
        tp, ts, tm = optimizers.apply_updates(tcfg, tp, jax.tree.map(t, gs),
                                              ts)
        for path, want in leaves_with_paths(np_tree(jp)):
            got = dict(leaves_with_paths(tp))[path]
            close(got, want, 1e-6)
        for key in ("m", "v"):
            for path, want in leaves_with_paths(np_tree(js[key])):
                close(dict(leaves_with_paths(ts[key]))[path], want, 1e-6)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(tm["lr"], float(jm["lr"]), rtol=1e-6)


def test_synthetic_lm_batches_byte_equal():
    jr, tr = f32_configs("qwen3_1p7b")
    for seed, step in ((0, 0), (3, 17)):
        jb = JSyntheticLM(jr, seed).batch_at(step)
        tb = SyntheticLM(tr, seed).batch_at(step)
        assert set(jb) == set(tb)
        for k in jb:
            assert jb[k].dtype == tb[k].dtype
            assert jb[k].tobytes() == tb[k].tobytes()


def test_trainer_three_steps_match_jax():
    jr, tr = f32_configs("qwen3_1p7b")
    jt = JTrainer(jr, seed=0)
    tt = Trainer(tr, seed=0, device="cpu")
    tt.params = params_from_jax(np_tree(jt.params), tr, "cpu")
    tt.opt_state = optimizers.init_opt_state(tr.optimizer, tt.params)
    jrep = jt.train(3, log_every=0, probe=False)
    trep = tt.train(3, log_every=0, probe=False)
    np.testing.assert_allclose(trep.losses, jrep.losses, rtol=1e-3)


# ---------------------------------------------------------------------------
# Mirrors of tests/test_mgrit.py (toy step, torch only)
# ---------------------------------------------------------------------------


def make_toy(seed, N=16, B=4, D=8, h=0.25):
    return toy_setup(seed, N, B, D, h)[1:]


@pytest.mark.parametrize("cf,levels", [(2, 2), (4, 2), (2, 3)])
def test_mgrit_exactness_after_J_iterations(cf, levels):
    stacked, z0, h = make_toy(0, N=16)
    z0 = t(z0)
    serial_states, zT_serial = mgrit.serial_solve(toy_step, stacked, z0, h)
    spec = mgrit.MGRITSpec(cf=cf, levels=levels, iters=16 // cf, h=h)
    states, zT, _ = mgrit.mgrit_solve(toy_step, stacked, z0, spec)
    close(zT, zT_serial, 1e-5)
    close(states, serial_states, 1e-5)


def test_mgrit_residual_contracts():
    stacked, z0, h = make_toy(1, N=32, h=0.2)
    spec = mgrit.MGRITSpec(cf=4, levels=2, iters=6, h=h)
    _, _, norms = mgrit.mgrit_solve(toy_step, stacked, t(z0), spec)
    norms = norms.numpy()
    assert norms[-1] < norms[0]
    assert norms[-1] < 1e-3 * norms[0]


def test_mgrit_more_iters_reduce_error():
    stacked, z0, h = make_toy(2, N=32, h=0.25)
    _, zT_serial = mgrit.serial_solve(toy_step, stacked, t(z0), h)
    errs = []
    for iters in (1, 2, 4):
        spec = mgrit.MGRITSpec(cf=4, levels=2, iters=iters, h=h)
        _, zT, _ = mgrit.mgrit_solve(toy_step, stacked, t(z0), spec)
        errs.append(float(torch.linalg.norm(zT - zT_serial)))
    assert errs[2] < errs[1] < errs[0] or errs[2] < 1e-6


def test_serial_solve_matches_manual_loop():
    stacked, z0, h = make_toy(3, N=8, B=2, D=4)
    z = t(z0)
    states, zT = mgrit.serial_solve(toy_step, stacked, z, h)
    for n in range(8):
        assert torch.allclose(states[n], z, atol=1e-6)
        z = toy_step(stacked[n], z, h)
    close(zT, z, 1e-6)


def test_gates_make_identity_layers():
    stacked, z0, h = make_toy(4, N=8, B=2, D=4)
    for n in range(4, 8):
        stacked[n] = dict(stacked[n], gate=torch.tensor(0.0))
    _, zT = mgrit.serial_solve(toy_step, stacked, t(z0), h)
    _, zT4 = mgrit.serial_solve(toy_step, stacked[:4], t(z0), h)
    close(zT, zT4, 1e-6)


# ---------------------------------------------------------------------------
# Mirrors of tests/test_lp_grads.py (reduced deepseek_7b, bf16 compute)
# ---------------------------------------------------------------------------


def tiny_rcfg(fwd_iters, bwd_iters):
    rcfg = t_reduce(t_get_config("deepseek_7b"))
    mg = dataclasses.replace(rcfg.mgrit, fwd_iters=fwd_iters,
                             bwd_iters=bwd_iters)
    return dataclasses.replace(rcfg, mgrit=mg)


def lp_setup(seed, rcfg):
    params = ttr.init_model(rcfg, seed=seed, device="cpu")
    rng = np.random.default_rng(seed)
    V = rcfg.model.vocab_size
    return params, {"tokens": torch.from_numpy(rng.integers(0, V, (2, 8))),
                    "labels": torch.from_numpy(rng.integers(0, V, (2, 8)))}


def flat(grads: dict):
    return np.concatenate([g.float().reshape(-1).numpy()
                           for p, g in sorted(grads.items())
                           if p[-1] != "gate"])


def test_serial_adjoint_matches_direct_ad():
    """Exact adjoint (iters=0) == autograd through the serial loop."""
    rcfg = tiny_rcfg(0, 0)
    params, batch = lp_setup(0, rcfg)
    cfg = rcfg.model

    def loss_direct(p):
        static = lp.LPStatic(cfg=cfg, mgrit=rcfg.mgrit, kind="attn_mlp")
        z = ttr._embed_inputs(p, batch, cfg)
        rope = ttr._rope_for(cfg, 8, z.device)
        z = ttr._serial_buffer(p.get("open"), z, cfg, kind="attn_mlp",
                               causal=True, rope=rope)
        mid = [{"params": s, "gate": p["mid"]["gate"][n]}
               for n, s in enumerate(mgrit.slots(p["mid"]["params"]))]
        _, zT = mgrit.serial_solve(lp.make_fwd_step(static, {"rope": rope}),
                                   mid, z, rcfg.mgrit.h)
        zT = ttr._serial_buffer(p.get("close"), zT, cfg, kind="attn_mlp",
                                causal=True, rope=rope)
        zT = norm_apply(p["final_norm"], zT, cfg)
        return ttr.lm_loss(unembed(p["embed"], zT, cfg), batch["labels"])

    paths, leaves = zip(*leaves_with_paths(params))
    leaves = [x.detach().requires_grad_(True) for x in leaves]
    la, _ = ttr.loss_fn(unflatten(zip(paths, leaves)), batch, rcfg,
                        mode="serial")
    ga = dict(zip(paths, torch.autograd.grad(la, leaves)))
    ld = loss_direct(unflatten(zip(paths, leaves)))
    gd = dict(zip(paths, torch.autograd.grad(ld, leaves,
                                             allow_unused=True)))
    np.testing.assert_allclose(la.item(), ld.item(), rtol=1e-5)
    fa, fd = flat(ga), flat(gd)
    cos = float(np.dot(fa, fd)
                / (np.linalg.norm(fa) * np.linalg.norm(fd) + 1e-30))
    assert cos > 0.9999, f"cosine {cos}"
    np.testing.assert_allclose(np.linalg.norm(fa), np.linalg.norm(fd),
                               rtol=1e-2)
    np.testing.assert_allclose(fa, fd, rtol=5e-2, atol=5e-3)


def grads_of(params, batch, rcfg, mode):
    return torch_value_and_grad(params, batch, rcfg, mode)[2]


@pytest.mark.parametrize("iters,min_cos", [(1, 0.90), (4, 0.999)])
def test_mgrit_grads_converge_to_exact(iters, min_cos):
    params, batch = lp_setup(1, tiny_rcfg(0, 0))
    fe = flat(grads_of(params, batch, tiny_rcfg(0, 0), "serial"))
    fl = flat(grads_of(params, batch, tiny_rcfg(iters, iters), "lp"))
    cos = float(np.dot(fe, fl)
                / (np.linalg.norm(fe) * np.linalg.norm(fl) + 1e-30))
    assert cos > min_cos, f"cosine {cos} too low at iters={iters}"


def test_padded_layers_receive_zero_grads():
    rcfg = tiny_rcfg(1, 1)
    rcfg = dataclasses.replace(
        rcfg, mgrit=dataclasses.replace(rcfg.mgrit, pad_to=12, cf=2))
    params, batch = lp_setup(2, rcfg)
    grads = grads_of(params, batch, rcfg, "lp")
    pad_idx = np.where(params["mid"]["gate"].numpy() == 0.0)[0]
    assert pad_idx.size > 0
    for path, g in grads.items():
        if path[:2] == ("mid", "params"):
            assert torch.all(g[pad_idx] == 0), f"{path}: padded layer grad"


def test_fwd_residual_norms_exposed():
    rcfg = tiny_rcfg(3, 1)
    params, batch = lp_setup(3, rcfg)
    with torch.no_grad():
        _, diag = ttr.loss_fn(params, batch, rcfg, mode="lp")
    norms = diag["fwd_norms"].numpy()
    assert norms.shape == (3,)
    assert np.all(np.isfinite(norms))


# ---------------------------------------------------------------------------
# Mirrors of tests/test_runtime.py (the port trains decoder models, so the
# tiny model is the reference's with family="decoder")
# ---------------------------------------------------------------------------


def runtime_rcfg(lp_on=True, steps=30):
    model = ModelConfig(name="t", family="decoder", n_layers=8, d_model=32,
                        n_heads=2, n_kv_heads=2, d_ff=64, vocab_size=64,
                        act="gelu", norm="layernorm")
    return RunConfig(
        model=model,
        mgrit=MGRITConfig(enabled=lp_on, cf=2, levels=2, fwd_iters=1,
                          bwd_iters=1, pad_to=8, check_every=10),
        optimizer=OptimizerConfig(name="sgd", lr=0.05, warmup_steps=2,
                                  total_steps=steps),
        shape=ShapeConfig("t", "train", 16, 4))


def test_data_pipeline_deterministic():
    rcfg = runtime_rcfg()
    p1, p2 = SyntheticLM(rcfg, seed=3), SyntheticLM(rcfg, seed=3)
    np.testing.assert_array_equal(p1.batch_at(17)["tokens"],
                                  p2.batch_at(17)["tokens"])
    assert not np.array_equal(p1.batch_at(17)["tokens"],
                              p1.batch_at(18)["tokens"])


def test_trainer_loss_decreases():
    tr = Trainer(runtime_rcfg(), seed=0, device="cpu")
    rep = tr.train(30, log_every=0, probe=False)
    assert np.mean(rep.losses[-5:]) < np.mean(rep.losses[:5])


def test_adaptive_controller_switches():
    c = AdaptiveController(MGRITConfig(check_every=10, switch_threshold=1.0))
    assert c.should_probe(10)
    assert not c.should_probe(5)
    assert c.observe(10, np.array([1.0, 0.5]), np.array([1.0, 0.4])) == "ok"
    assert c.state.mode == "lp"
    assert c.observe(20, np.array([1.0, 1.5]), np.array([1.0, 0.4])) \
        == "switched"
    assert c.state.mode == "serial"
    assert c.state.step_of_switch == 20


def test_convergence_factor_floor():
    assert convergence_factor(np.array([1e-32, 1e-33])) == 0.0
    assert convergence_factor(np.array([1.0, 0.25])) == pytest.approx(0.25)


def test_optimizer_adamw_descends_quadratic():
    cfg = OptimizerConfig(name="adamw", lr=0.1, warmup_steps=0,
                          total_steps=100, schedule="constant",
                          weight_decay=0.0)
    params = {"w": torch.tensor([3.0, -2.0])}
    state = optimizers.init_opt_state(cfg, params)
    for _ in range(100):
        grads = {"w": 2 * params["w"]}
        params, state, _ = optimizers.apply_updates(cfg, params, grads,
                                                    state)
    assert float(params["w"].abs().max()) < 0.3


def test_trainer_lp_and_serial_equivalent_when_converged():
    """fwd_iters large enough for exactness -> LP step == serial step."""
    rcfg = runtime_rcfg()
    rcfg = dataclasses.replace(
        rcfg, mgrit=dataclasses.replace(rcfg.mgrit, fwd_iters=4,
                                        bwd_iters=4))
    r_lp = Trainer(rcfg, seed=0, device="cpu").train(5, log_every=0,
                                                     probe=False)
    r_s = Trainer(dataclasses.replace(
        rcfg, mgrit=dataclasses.replace(rcfg.mgrit, enabled=False)),
        seed=0, device="cpu").train(5, log_every=0, probe=False)
    np.testing.assert_allclose(r_lp.losses, r_s.losses, rtol=2e-2, atol=2e-2)


def test_trainer_probe_runs_lp_diagnose():
    """The adaptive probe at ``check_every`` records (step, rho_f, rho_b)."""
    rcfg = runtime_rcfg()
    rcfg = dataclasses.replace(rcfg, mgrit=dataclasses.replace(
        rcfg.mgrit, check_every=2))
    rep = Trainer(rcfg, seed=0, device="cpu").train(3, log_every=0)
    assert [h[0] for h in rep.controller_history] == [2]
    assert all(np.isfinite(h[1]) and np.isfinite(h[2])
               for h in rep.controller_history)


def test_train_entry_points_default_to_cuda():
    """Without a card the trainer and the CLI raise instead of running on
    the CPU; ``device="cpu"`` is an explicit choice."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(runtime_rcfg())
    from repro_torch.launch import train as train_cli
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main(["--arch", "qwen3_1p7b", "--reduced", "--steps", "1"])
    with pytest.raises(NotImplementedError, match="checkpoints"):
        Trainer(runtime_rcfg(), ckpt_dir="/nonexistent", device="cpu")


def test_unported_families_raise_naming_their_slice():
    rcfg = t_reduce(t_get_config("seamless_m4t_v2"))
    with pytest.raises(NotImplementedError, match="remaining-families"):
        ttr.forward({}, {}, rcfg)
    rcfg = t_reduce(t_get_config("falcon_mamba_7b"))
    with pytest.raises(NotImplementedError, match="SSM and hybrid slice"):
        ttr.forward({}, {}, rcfg)

