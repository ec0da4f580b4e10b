"""The MoE family in the port against the JAX package, float32 on the CPU:
the module (routing plan, dispatch, experts, combine, and their
backward) and training of the reduced ``qwen3_moe_235b`` and
``grok1_314b``.

Inputs are made with numpy from a seed; JAX params are converted by
``params_from_jax`` (or passed leaf by leaf). Tolerances: 2e-5 for the
MoE output, every input's and leaf's cotangent (relative to its max) and
the logits; ``test_torch_train.py``'s for a whole model: loss rtol 1e-5,
each gradient leaf within 1e-4 of its max. Also the mirrors of
``test_models_extra.py``'s three MoE tests, with their tolerances.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JModelConfig
from repro.configs.base import MoEConfig as JMoEConfig
from repro.models import moe as jmoe
from repro.models import transformer as jtr
from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.convert import params_from_jax
from repro_torch.data.pipeline import SyntheticLM, shard_batch
from repro_torch.launch import train as train_cli
from repro_torch.models import moe
from repro_torch.models import transformer as ttr
from repro_torch.optim import optimizers
from repro_torch.train.trainer import Trainer
from test_torch_train import (assert_grads_close, close, f32_configs,
                              np_tree, rnd, t, torch_value_and_grad)

torch.set_num_threads(2)
MOE_TOL = 2e-5
LOGITS_TOL = 2e-5
MODEL_ARCHS = ["qwen3_moe_235b", "grok1_314b"]


def moe_cfgs(group_size=0, **kw):
    """``test_models_extra.py``'s MoE config (4 experts, top-2, d 32) in
    float32, for both packages."""
    base = dict(name="m", family="decoder", n_layers=2, d_model=32,
                n_heads=2, n_kv_heads=2, d_ff=64, vocab_size=64,
                dtype="float32", **kw)
    m = dict(num_experts=4, top_k=2, d_ff=64, group_size=group_size)
    return (JModelConfig(**base, moe=JMoEConfig(**m)),
            ModelConfig(**base, moe=MoEConfig(**m)))


# (group_size, router bias on experts 0 and 1, zero rows) of each case
CASES = {"plain": (0, 0.0, False), "grouped": (8, 0.0, False),
         "drops": (0, 10.0, False), "ties": (0, 0.0, True)}


def moe_case(name):
    group, bias, zero = CASES[name]
    jc, tc = moe_cfgs(group)
    jp = jmoe.init_moe(jax.random.PRNGKey(0), jc)
    # a router biased towards experts 0 and 1 sends every token's two
    # choices there, past the capacity of 10 at S = 16
    jp["router"] = jp["router"].at[:, :2].add(bias)
    x = rnd(1, (2, 16, 32))
    if zero:
        # all-zero rows: every router logit 0, every expert tied
        x[:, ::3] = 0.0
    ct = rnd(2, x.shape)
    return jc, tc, jp, {k: t(v) for k, v in np_tree(jp).items()}, x, ct


@pytest.mark.parametrize("name", sorted(CASES))
def test_moe_apply_and_grads_match_jax(name):
    """The index design and the literal one-hot twin against JAX's
    ``moe_apply``, and the index design's cotangents (x and every leaf,
    through ``_Dispatch`` / ``_Combine``) against ``jax.vjp``."""
    jc, tc, jp, tp, x, ct = moe_case(name)

    def jax_vjp(p, xx, cot):
        y, vjp = jax.vjp(lambda p_, x_: jmoe.moe_apply(p_, x_, jc), p, xx)
        return y, vjp(cot)
    want, (jgp, jgx) = jax.jit(jax_vjp)(jp, jnp.asarray(x),
                                        jnp.asarray(ct))
    close(moe.moe_apply_onehot(tp, t(x), tc), want, MOE_TOL)
    leaves = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    xt = t(x).requires_grad_(True)
    got = moe.moe_apply(leaves, xt, tc)
    close(got.detach(), want, MOE_TOL)
    got.backward(t(ct))
    close(xt.grad, jgx, MOE_TOL * np.abs(np.asarray(jgx)).max())
    for k, g in np_tree(jgp).items():
        close(leaves[k].grad, g, MOE_TOL * np.abs(g).max())
    plan = moe.routing_plan(tp, t(x), tc)
    dispatch, _ = moe.onehot_dispatch(tp, t(x), tc)
    E, B, C = tc.moe.num_experts, x.shape[0], plan.capacity
    bits = torch.zeros(E * B * C + 1, dtype=torch.bool)
    bits[plan.slot.reshape(-1)] = True
    # the plan's slots are the one-hot dispatch's set bits (ungrouped)
    want_bits = dispatch.permute(2, 0, 3, 1).any(-1).reshape(-1)
    assert torch.equal(bits[:-1], want_bits)
    if name == "drops":
        assert plan.n_dropped() > 0
    if name == "ties":
        # equal probabilities: the K choices are the lowest expert indices
        zero_rows = plan.expert[:, ::3]
        assert torch.equal(zero_rows, torch.arange(2).expand_as(zero_rows))


@pytest.mark.parametrize("seq", [1, 5, 16, 128, 4096])
def test_capacity_matches_jax(seq):
    jc, tc = moe_cfgs()
    assert moe.capacity(seq, tc) == jmoe.capacity(seq, jc)


def test_load_balance_loss_matches_jax():
    _, tc = moe_cfgs()
    jc, _ = moe_cfgs()
    logits = rnd(3, (2, 16, 4))
    idx = np.random.default_rng(4).integers(0, 4, (2, 16, 2)).astype(
        np.int32)
    want = jmoe.load_balance_loss(jnp.asarray(logits), jnp.asarray(idx), jc)
    got = moe.load_balance_loss(t(logits), t(idx), tc)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


# ---------------------------------------------------------------------------
# Mirrors of test_models_extra.py's MoE tests (the port alone)
# ---------------------------------------------------------------------------


def port_moe(group_size=0):
    _, tc = moe_cfgs(group_size)
    gen = torch.Generator().manual_seed(0)
    return tc, moe.init_moe(gen, tc)


def test_moe_batch_permutation_equivariance():
    tc, params = port_moe()
    x = t(rnd(1, (4, 8, 32), 0.5))
    y = moe.moe_apply(params, x, tc)
    perm = torch.tensor([2, 0, 3, 1])
    np.testing.assert_allclose(y[perm].numpy(),
                               moe.moe_apply(params, x[perm], tc).numpy(),
                               rtol=2e-2, atol=2e-2)


def test_moe_grouping_close_to_ungrouped():
    """With ample capacity, 8-token groups route like whole-sequence
    dispatch (same experts, same gates)."""
    tc0, params = port_moe()
    tcg = dataclasses.replace(
        tc0, moe=dataclasses.replace(tc0.moe, group_size=8))
    x = t(rnd(1, (2, 16, 32), 0.5))
    close_share = np.isclose(moe.moe_apply(params, x, tc0).numpy(),
                             moe.moe_apply(params, x, tcg).numpy(),
                             rtol=2e-2, atol=2e-2).mean()
    assert close_share > 0.9, f"only {close_share:.2%} matched"


def test_moe_capacity_bounds():
    tc, _ = port_moe()
    c = moe.capacity(128, tc)
    assert 4 <= c <= 128
    assert c >= 128 * tc.moe.top_k / tc.moe.num_experts


# ---------------------------------------------------------------------------
# Whole models: logits, loss and gradients, then three Trainer steps
# ---------------------------------------------------------------------------


# the mode whose JAX gradient is computed for each arch (a jit of MGRIT
# or of the serial solve under value_and_grad, the file's largest cost):
# MGRIT's adjoint for one, the serial backward for the other; the other
# mode's logits and loss come from a jit of the forward alone
GRAD_MODES = {"qwen3_moe_235b": ("lp",), "grok1_314b": ("serial",)}


@pytest.fixture(scope="module")
def jax_models():
    """{arch: (configs, JAX params, port params, batch, {mode: (loss,
    logits, grads or None, the jitted value-and-grad or None)})}, the JAX
    side once."""
    out = {}
    for arch in MODEL_ARCHS:
        jr, tr = f32_configs(arch)
        jp = jtr.init_model(jax.random.PRNGKey(0), jr)
        batch = SyntheticLM(tr, 0).batch_at(0)
        jb = jax.tree.map(jnp.asarray, batch)
        runs = {}
        for mode in ("lp", "serial"):
            def loss(p, b, mode=mode):
                logits, _ = jtr.forward(p, b, jr, mode=mode)
                return jtr.lm_loss(logits, b["labels"]), logits
            if mode in GRAD_MODES[arch]:
                fn = jax.jit(jax.value_and_grad(loss, has_aux=True))
                (jl, jlog), jg = fn(jp, jb)
            else:
                fn = jg = None
                jl, jlog = jax.jit(loss)(jp, jb)
            runs[mode] = (float(jl), np.asarray(jlog), jg, fn)
        out[arch] = (jr, tr, jp, params_from_jax(np_tree(jp), tr, "cpu"),
                     batch, runs)
    return out


@pytest.mark.parametrize("mode", ["lp", "serial"])
@pytest.mark.parametrize("arch", MODEL_ARCHS)
def test_model_logits_and_loss_match_jax(jax_models, arch, mode):
    """The reduced configs (4 experts, top-2, 10 layers, MGRIT cf 2):
    logits within 2e-5 and the loss within 1e-5."""
    _, tr, _, tp, batch, runs = jax_models[arch]
    jl, jlog, _, _ = runs[mode]
    logits, _ = ttr.forward(tp, shard_batch(batch, "cpu"), tr, mode=mode)
    close(logits, jlog, LOGITS_TOL)
    np.testing.assert_allclose(
        ttr.lm_loss(logits, shard_batch(batch, "cpu")["labels"]).item(), jl,
        rtol=1e-5)


@pytest.mark.parametrize("arch,mode", [(a, m) for a in MODEL_ARCHS
                                       for m in GRAD_MODES[a]])
def test_model_grads_match_jax(jax_models, arch, mode):
    """Every gradient leaf, the ``moe`` leaves of every layer included,
    within 1e-4 of its max (MGRIT's adjoint in lp mode)."""
    _, tr, _, tp, batch, runs = jax_models[arch]
    jl, _, jg, _ = runs[mode]
    loss, _, grads = torch_value_and_grad(tp, shard_batch(batch, "cpu"),
                                          tr, mode)
    np.testing.assert_allclose(loss.item(), jl, rtol=1e-5)
    assert {p[-1] for p in grads if "moe" in p} == {
        "router", "w_in", "w_gate", "w_out"}
    assert_grads_close(grads, jg)


def test_trainer_three_steps_match_jax(jax_models):
    """``Trainer.train(3)`` (MGRIT, AdamW) from JAX's init: the first
    step's loss is JAX's on the same batch (rtol 1e-5; the optimizer
    update is held to JAX's in ``test_torch_train.py``), and the three
    losses are finite."""
    _, tr, _, tp, _, runs = jax_models["qwen3_moe_235b"]
    trainer = Trainer(tr, seed=0, device="cpu")
    trainer.params = tp
    trainer.opt_state = optimizers.init_opt_state(tr.optimizer, tp)
    losses = trainer.train(3, log_every=0, probe=False).losses
    np.testing.assert_allclose(losses[0], runs["lp"][0], rtol=1e-5)
    assert len(losses) == 3 and np.isfinite(losses).all()


@pytest.mark.parametrize("arch", MODEL_ARCHS)
def test_train_cli_runs_moe_on_cpu(capsys, arch):
    assert train_cli.main(["--arch", arch, "--reduced", "--device", "cpu",
                           "--steps", "2"]) == 0
    assert "done on cpu: 2 steps" in capsys.readouterr().out
