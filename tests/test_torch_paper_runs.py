"""Runs of the paper's encoder and encoder-decoder families in the port,
against the JAX package, float32 on the CPU (reduced configs): serial
logits of the configs no gradient test covers, three ``Trainer`` steps
of ``bert128`` with the adaptive probe, the encoder-decoder probe's
refusal and the train CLI on ``mt_marian``.

The serial-logits test also holds the decoder configs the port builds
but no other test holds to JAX (``phi4_mini_3p8b``, ``granite_34b`` and
``qwen2_vl_7b`` with its vision stub). Tolerances are
``test_torch_train.py``'s: 2e-5 for logits, loss rtol 1e-5, 1e-3
relative for losses and convergence factors after optimizer steps.
"""
import jax
import numpy as np
import pytest
import torch

from repro.models import transformer as jtr
from repro.train.trainer import Trainer as JTrainer
from repro_torch.convert import params_from_jax
from repro_torch.data.pipeline import shard_batch
from repro_torch.models import transformer as ttr
from repro_torch.optim import optimizers
from repro_torch.train.trainer import Trainer
from test_torch_paper import jax_batch, paper_setup
from test_torch_train import ATTN_TOL, close, f32_configs, np_tree

torch.set_num_threads(2)
LOGIT_ARCHS = ["vit32", "mc_tiny", "seamless_m4t_v2", "phi4_mini_3p8b",
               "granite_34b", "qwen2_vl_7b"]


@pytest.mark.parametrize("arch", LOGIT_ARCHS)
def test_serial_logits_match_jax(arch):
    """Serial forward logits (and the loss over the label positions):
    vit32 and qwen2_vl_7b carry the vision stub's 4 positions before the
    S tokens, seamless_m4t_v2 the audio stub's source frames."""
    jr, tr, jparams, tparams, batch = paper_setup(arch)
    jb = jax_batch(batch)
    want, _ = jax.jit(lambda p: jtr.forward(p, jb, jr, mode="serial"))(
        jparams)
    jl, _ = jax.jit(lambda p: jtr.loss_fn(p, jb, jr, mode="serial"))(
        jparams)
    tb = shard_batch(batch, "cpu")
    with torch.no_grad():
        got, _ = ttr.forward(tparams, tb, tr, mode="serial")
        loss, _ = ttr.loss_fn(tparams, tb, tr, mode="serial")
    S = batch["tokens"].shape[1]
    assert got.shape[1] == S + (4 if tr.model.frontend == "vision" else 0)
    close(got, want, ATTN_TOL)
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)


def test_trainer_probe_matches_jax_on_bert128():
    """Three steps of reduced bert128 with the adaptive probe at step 2
    (non-causal, as the reference's probe): losses, the probe's rho_fwd
    and rho_bwd, and the mode it leaves."""
    jr, tr = f32_configs("bert128", check_every=2)
    jt = JTrainer(jr, seed=0)
    tt = Trainer(tr, seed=0, device="cpu")
    tt.params = params_from_jax(np_tree(jt.params), tr, "cpu")
    tt.opt_state = optimizers.init_opt_state(tr.optimizer, tt.params)
    jrep = jt.train(3, log_every=0)
    trep = tt.train(3, log_every=0)
    np.testing.assert_allclose(trep.losses, jrep.losses, rtol=1e-3)
    assert [h[0] for h in trep.controller_history] == \
        [h[0] for h in jrep.controller_history] == [2]
    np.testing.assert_allclose(
        np.array([h[1:] for h in trep.controller_history], np.float64),
        np.array([h[1:] for h in jrep.controller_history], np.float64),
        rtol=1e-3)
    assert trep.mode_trace == jrep.mode_trace
    assert trep.switched_at == jrep.switched_at


def test_encdec_probe_raises_naming_the_reference():
    """The reference has no encoder-decoder probe (its reads
    params["mid"]); the port refuses by name, and training without the
    probe is unaffected."""
    _, tr = f32_configs("mt_marian", check_every=1)
    tt = Trainer(tr, seed=0, device="cpu")
    with pytest.raises(NotImplementedError, match="reference.*_probe"):
        tt.train(2, log_every=0)
    rep = Trainer(tr, seed=0, device="cpu").train(2, log_every=0,
                                                  probe=False)
    assert len(rep.losses) == 2 and np.all(np.isfinite(rep.losses))


def test_train_cli_runs_mt_marian_on_cpu(capsys):
    from repro_torch.launch import train as train_cli
    assert train_cli.main(["--arch", "mt_marian", "--reduced", "--device",
                           "cpu", "--steps", "2"]) == 0
    out = capsys.readouterr().out
    assert "done on cpu: 2 steps" in out

