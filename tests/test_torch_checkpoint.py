"""Checkpoint and resume of the port's training against the JAX package,
float32 on the CPU.

The on-disk format is the JAX package's, so checkpoints move both ways:
the port's ``Trainer`` resumes one written by the JAX ``Trainer`` (every
leaf bitwise equal on restore; after three more steps on both sides,
losses within 1e-5 and every leaf within 1e-4 of its max, as in
``test_torch_train.py``), reads a bfloat16 leaf JAX's ``save`` wrote,
and the JAX ``restore`` reads a port-written float32 checkpoint bit for
bit (the reference cannot read a bfloat16 leaf back: ROADMAP Queue 3).
Then the port alone: a resumed run equals an uninterrupted one bit for
bit, and rotation, ``LATEST``, a failed save and the emergency
checkpoint behave as the reference's (``tests/test_runtime.py``).
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.reduce import reduce_config as j_reduce
from repro.configs.registry import get_config as j_get_config
from repro.models import transformer as jtr
from repro.optim import optimizers as joptim
from repro.train import checkpoint as jck
from repro.train.trainer import Trainer as JTrainer
from repro_torch.configs.reduce import reduce_config as t_reduce
from repro_torch.configs.registry import get_config as t_get_config
from repro_torch.launch import train as train_cli
from repro_torch.optim import optimizers
from repro_torch.train import checkpoint as ck
from repro_torch.train.trainer import Trainer
from repro_torch.tree import leaves_with_paths

torch.set_num_threads(2)
LOSS_TOL = 1e-5
LEAF_REL = 1e-4


def configs(**model_kw):
    """Reduced qwen3_1p7b (a decoder, AdamW, MGRIT) for both packages,
    float32 unless ``model_kw`` says otherwise."""
    def one(get, reduce):
        rcfg = reduce(get("qwen3_1p7b"))
        return dataclasses.replace(rcfg, model=dataclasses.replace(
            rcfg.model, dtype="float32", **model_kw))
    return one(j_get_config, j_reduce), one(t_get_config, t_reduce)


def np_leaves(tree):
    """{key path: numpy array} of a JAX tree (bfloat16 as its bits)."""
    out = {}
    for path, a in leaves_with_paths(jax.tree.map(np.asarray, tree)):
        out[path] = a.view(np.uint16) if a.dtype.name == "bfloat16" else a
    return out


def t_leaves(tree):
    """{key path: numpy array} of a port tree (bfloat16 as its bits)."""
    out = {}
    for path, t in leaves_with_paths(tree):
        t = t.detach()
        out[path] = t.view(torch.int16).numpy().view(np.uint16) \
            if t.dtype == torch.bfloat16 else t.numpy()
    return out


def assert_bitwise(got: dict, want: dict):
    assert set(got) == set(want)
    for path, w in want.items():
        assert got[path].dtype == w.dtype, path
        assert got[path].tobytes() == w.tobytes(), path


def state_leaves(params, opt_state) -> dict:
    """Every tensor leaf of params and optimizer state, keyed by path."""
    out = {("params",) + p: a for p, a in t_leaves(params).items()}
    for key in ("m", "v", "master"):
        if key in opt_state:
            out.update({(key,) + p: a
                        for p, a in t_leaves(opt_state[key]).items()})
    return out


# ---------------------------------------------------------------------------
# Across the two packages
# ---------------------------------------------------------------------------


def test_port_resumes_a_jax_trainer_checkpoint(tmp_path):
    jr, tr = configs()
    jt = JTrainer(jr, ckpt_dir=str(tmp_path), seed=0)
    jt.train(3, ckpt_every=3, log_every=0, probe=False)
    assert jck.latest_step(str(tmp_path)) == 3

    tt = Trainer(tr, ckpt_dir=str(tmp_path), seed=0, device="cpu")
    assert tt.step == 3 and tt.opt_state["step"] == 3
    assert tt.controller.state.mode == jt.controller.state.mode == "lp"
    assert_bitwise(t_leaves(tt.params), np_leaves(jt.params))
    for key in ("m", "v"):
        assert_bitwise(t_leaves(tt.opt_state[key]),
                       np_leaves(jt.opt_state[key]))

    jrep = jt.train(3, log_every=0, probe=False)
    trep = tt.train(3, log_every=0, probe=False)
    np.testing.assert_allclose(trep.losses, jrep.losses, rtol=LOSS_TOL,
                               atol=LOSS_TOL)
    for got_tree, want_tree in ((tt.params, jt.params),
                                (tt.opt_state["m"], jt.opt_state["m"]),
                                (tt.opt_state["v"], jt.opt_state["v"])):
        got, want = t_leaves(got_tree), np_leaves(want_tree)
        for path, w in want.items():
            err = np.abs(got[path] - w).max()
            assert err <= LEAF_REL * max(np.abs(w).max(), 1e-30), \
                (path, err)
    assert tt.opt_state["step"] == int(jt.opt_state["step"]) == 6


def test_port_reads_a_jax_bfloat16_checkpoint(tmp_path):
    """bf16 stored params (so a float32 master exists) written by JAX's
    ``save`` as raw 2-byte leaves, read back by the port's restore into
    its bf16 template; the moments are made nonzero so that every leaf
    carries information."""
    jr, tr = configs(param_dtype="bfloat16")
    jparams = jtr.init_model(jax.random.PRNGKey(3), jr)
    jopt = joptim.init_opt_state(jr.optimizer, jparams)
    assert "master" in jopt
    rng = np.random.default_rng(3)
    for key in ("m", "v"):
        jopt[key] = jax.tree.map(lambda a: jnp.asarray(
            rng.standard_normal(a.shape).astype(np.float32)), jopt[key])
    jopt["step"] = jnp.asarray(7, jnp.int32)
    jck.save(str(tmp_path), 7, jparams, jopt,
             extra={"controller_mode": "serial", "tag": ""})

    tt = Trainer(tr, ckpt_dir=str(tmp_path), seed=0, device="cpu")
    assert tt.step == 7 and tt.opt_state["step"] == 7
    assert tt.controller.state.mode == "serial"
    assert any(p.dtype == torch.bfloat16
               for _, p in leaves_with_paths(tt.params))
    assert_bitwise(t_leaves(tt.params), np_leaves(jparams))
    for key in ("m", "v", "master"):
        assert_bitwise(t_leaves(tt.opt_state[key]), np_leaves(jopt[key]))
    rep = tt.train(1, log_every=0, probe=False)
    assert np.isfinite(rep.losses[0]) and rep.mode_trace == ["serial"]


def test_jax_restore_reads_a_port_checkpoint(tmp_path):
    jr, tr = configs()
    tt = Trainer(tr, ckpt_dir=str(tmp_path), seed=1, device="cpu")
    tt.train(2, ckpt_every=2, log_every=0, probe=False)
    jparams = jtr.init_model(jax.random.PRNGKey(0), jr)
    jopt = joptim.init_opt_state(jr.optimizer, jparams)
    params, opt, step, extra = jck.restore(str(tmp_path), jparams, jopt)
    assert step == 2 and extra == {"controller_mode": "lp", "tag": ""}
    assert opt["step"].shape == () and opt["step"].dtype == jnp.int32
    assert int(opt["step"]) == 2
    assert_bitwise(t_leaves(tt.params), np_leaves(params))
    for key in ("m", "v"):
        assert_bitwise(t_leaves(tt.opt_state[key]), np_leaves(opt[key]))


# ---------------------------------------------------------------------------
# The port alone
# ---------------------------------------------------------------------------


def test_resumed_run_equals_uninterrupted_bitwise(tmp_path):
    _, tr = configs()
    whole = Trainer(tr, seed=0, device="cpu")
    w_rep = whole.train(4, log_every=0, probe=False)

    first = Trainer(tr, ckpt_dir=str(tmp_path), seed=0, device="cpu")
    f_rep = first.train(2, ckpt_every=2, log_every=0, probe=False)
    del first
    resumed = Trainer(tr, ckpt_dir=str(tmp_path), seed=0, device="cpu")
    assert resumed.step == 2
    r_rep = resumed.train(2, log_every=0, probe=False)
    assert f_rep.losses + r_rep.losses == w_rep.losses
    assert_bitwise(state_leaves(resumed.params, resumed.opt_state),
                   state_leaves(whole.params, whole.opt_state))
    assert resumed.opt_state["step"] == whole.opt_state["step"] == 4


def test_restore_writes_into_the_callers_tensors(tmp_path):
    """Restore copies into the template's tensors: the optimizer updates
    them in place, so identity must survive."""
    _, tr = configs()
    src = Trainer(tr, seed=0, device="cpu")
    src.train(1, log_every=0, probe=False)
    ck.save(str(tmp_path), 1, src.params, src.opt_state)
    dst = Trainer(tr, seed=5, device="cpu")
    before = [t for _, t in leaves_with_paths(dst.params)] \
        + [t for _, t in leaves_with_paths(dst.opt_state["m"])]
    params, opt, step, _ = ck.restore(str(tmp_path), dst.params,
                                      dst.opt_state)
    after = [t for _, t in leaves_with_paths(params)] \
        + [t for _, t in leaves_with_paths(opt["m"])]
    assert step == 1 and opt["step"] == 1
    assert all(a is b for a, b in zip(after, before, strict=True))
    assert_bitwise(state_leaves(params, opt),
                   state_leaves(src.params, src.opt_state))


def test_rotation_keeps_k_and_latest(tmp_path):
    d = str(tmp_path)
    params = {"w": torch.arange(6.0).reshape(2, 3), "none": None}
    opt = {"step": 0, "m": {"w": torch.zeros(2, 3)}}
    assert ck.latest_step(d) is None and ck.restore(d, params, opt) is None
    for s in range(1, 5):
        ck.save(d, s, params, opt, keep=2)
    assert sorted(x for x in os.listdir(d) if x.startswith("step_")) == \
        ["step_0000000003", "step_0000000004"]
    with open(os.path.join(d, "LATEST")) as f:
        assert f.read() == "step_0000000004"
    assert ck.latest_step(d) == 4
    with np.load(os.path.join(d, "step_0000000004", "params.npz")) as z:
        assert z.files == ["a0"]       # the None subtree holds no leaf
    with pytest.raises(ValueError, match="rcfg"):
        ck.restore(d, params, opt, mesh=object())


def test_failed_save_leaves_latest_readable(tmp_path, monkeypatch):
    d = str(tmp_path)
    params = {"b": torch.ones(3), "a": torch.full((2,), 2.0)}
    opt = {"step": 1, "m": {"a": torch.zeros(2), "b": torch.zeros(3)}}
    ck.save(d, 1, params, opt)
    calls = []
    real = np.lib.format.write_array

    def boom(*a, **kw):
        calls.append(1)
        if len(calls) == 2:
            raise OSError("disk full")
        return real(*a, **kw)

    monkeypatch.setattr(np.lib.format, "write_array", boom)
    with pytest.raises(OSError, match="disk full"):
        ck.save(d, 2, {"b": torch.zeros(3), "a": torch.zeros(2)}, opt)
    monkeypatch.undo()
    assert not [x for x in os.listdir(d) if x.startswith(".tmp-")]
    assert ck.latest_step(d) == 1
    fresh = {"b": torch.zeros(3), "a": torch.zeros(2)}
    got, _, step, _ = ck.restore(d, fresh, {"step": 0, "m": {
        "a": torch.zeros(2), "b": torch.zeros(3)}})
    assert step == 1 and torch.equal(got["b"], torch.ones(3))
    assert torch.equal(got["a"], torch.full((2,), 2.0))


def test_step_exception_writes_emergency_checkpoint(tmp_path):
    _, tr = configs()
    tt = Trainer(tr, ckpt_dir=str(tmp_path), seed=0, device="cpu")
    tt.train(1, log_every=0, probe=False)
    tt.controller.state.mode = "serial"

    def failing(*_):
        raise RuntimeError("node lost")
    tt._steps["serial"] = failing
    with pytest.raises(RuntimeError, match="node lost"):
        tt.train(2, ckpt_every=5, log_every=0, probe=False)
    assert ck.latest_step(str(tmp_path)) == 1
    with open(tmp_path / "step_0000000001" / "meta.json") as f:
        meta = json.load(f)
    assert meta["extra"] == {"controller_mode": "serial",
                             "tag": "emergency"}
    back = Trainer(tr, ckpt_dir=str(tmp_path), seed=9, device="cpu")
    assert back.step == 1 and back.controller.state.mode == "serial"
    assert_bitwise(state_leaves(back.params, back.opt_state),
                   state_leaves(tt.params, tt.opt_state))


@pytest.mark.parametrize("where", ["mid_update", "before_update"])
def test_emergency_never_replaces_a_checkpoint(tmp_path, monkeypatch,
                                               capsys, where):
    """A step that raises after step 1's periodic checkpoint: inside the
    optimizer's in-place update once one leaf is written (the state is
    torn: no emergency checkpoint at all), or before the update (the
    state is step 1's, already on disk). Either way ``step_0000000001``
    stays as the periodic save wrote it and a resume reads step 1's
    state bit for bit."""
    _, tr = configs()
    d = str(tmp_path)
    tt = Trainer(tr, ckpt_dir=d, seed=0, device="cpu")
    tt.train(1, ckpt_every=1, log_every=0, probe=False)
    saved = {k: v.copy() for k, v in
             state_leaves(tt.params, tt.opt_state).items()}
    with open(tmp_path / "step_0000000001" / "params.npz", "rb") as f:
        params_npz = f.read()
    if where == "mid_update":
        real, calls = optimizers._clipped, []

        def clipped(g, scale):
            calls.append(1)
            if len(calls) == 2:    # the first leaf (one slice) is written
                raise RuntimeError("CUDA out of memory")
            return real(g, scale)
        monkeypatch.setattr(optimizers, "_clipped", clipped)
    else:
        def failing(*_):
            raise RuntimeError("CUDA out of memory")
        tt._steps[tt.controller.state.mode] = failing
    with pytest.raises(RuntimeError, match="out of memory"):
        tt.train(1, ckpt_every=5, log_every=0, probe=False)
    monkeypatch.undo()
    out = capsys.readouterr().out
    if where == "mid_update":
        assert tt.opt_state["step"] is None
        assert "[emergency] no checkpoint" in out
        torn = state_leaves(tt.params, tt.opt_state)
        assert any(torn[p].tobytes() != saved[p].tobytes() for p in torn)
    else:
        assert "step 1 is already checkpointed" in out
    assert sorted(x for x in os.listdir(d) if not x.startswith(".")) == [
        "LATEST", "step_0000000001"]
    with open(tmp_path / "step_0000000001" / "meta.json") as f:
        assert json.load(f)["extra"]["tag"] == ""
    with open(tmp_path / "step_0000000001" / "params.npz", "rb") as f:
        assert f.read() == params_npz
    back = Trainer(tr, ckpt_dir=d, seed=9, device="cpu")
    assert back.step == 1
    assert_bitwise(state_leaves(back.params, back.opt_state), saved)


def test_train_cli_checkpoints_and_resumes(tmp_path, capsys):
    d = str(tmp_path / "ck")
    base = ["--arch", "qwen3_1p7b", "--reduced", "--device", "cpu",
            "--ckpt", d, "--ckpt-every", "1"]
    assert train_cli.main(base + ["--steps", "2"]) == 0
    assert "starting at step 0" in capsys.readouterr().out
    assert ck.latest_step(d) == 2
    assert train_cli.main(base + ["--steps", "1"]) == 0
    out = capsys.readouterr().out
    assert "starting at step 2" in out and "1 steps" in out
    assert ck.latest_step(d) == 3
