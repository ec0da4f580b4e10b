"""What each spawned rank of ``tests/test_torch_mesh_train.py`` runs.

This module imports neither jax nor the JAX package: every rank is a
fresh process (``spawn``), and the JAX side of each comparison runs in
the test's own process on the numpy results returned here. Each rank
runs the one-rank port too, in the same process and at the same thread
count, so that a bitwise comparison compares equal arithmetic.
"""
from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.reduce import reduce_config
from repro_torch.configs.registry import get_config
from repro_torch.convert import params_from_jax
from repro_torch.data.pipeline import shard_batch
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import layers, transformer
from repro_torch.optim import optimizers
from repro_torch.parallel import params as pparams
from repro_torch.parallel.sharding import axis_rules
from repro_torch.train.trainer import Trainer
from repro_torch.tree import leaves_with_paths


def f32_config(arch, n_layers=None, model=None, **mgrit_kw):
    """The reduced config of ``arch`` in float32 (``n_layers`` and
    ``model`` override the model, ``mgrit_kw`` the MGRIT config)."""
    rcfg = reduce_config(get_config(arch))
    m = dataclasses.replace(rcfg.model, dtype="float32", **(model or {}))
    if n_layers is not None:
        m = dataclasses.replace(m, n_layers=n_layers)
    return dataclasses.replace(
        rcfg, model=m, mgrit=dataclasses.replace(rcfg.mgrit, **mgrit_kw))


def _np(tree) -> dict:
    return {".".join(p): t.detach().numpy().copy()
            for p, t in leaves_with_paths(tree)}


def _runs(mesh):
    """The one-rank run (on global rank 0 only), then the mesh run."""
    return ((("one", None),) if dist.get_rank() == 0 else ()) \
        + (("mesh", mesh),)


def _states(params, batch, rcfg, mesh, mode):
    """The token embeddings and the state the head reads (after the final
    norm), this rank's rows, under ``mesh``'s rules (numpy)."""
    rules = contextlib.nullcontext() if mesh is None else \
        axis_rules(mesh, rcfg.sharding)
    with torch.no_grad(), rules:
        emb = layers.embed_tokens(transformer.train_params(
            params, rcfg)["embed"], batch["tokens"], rcfg.model)
        z, _ = transformer.hidden_states(params, batch, rcfg, mode)
    return {"embed": emb.numpy().copy(), "prehead": z.numpy().copy()}


def grads_case(mesh, case):
    """Loss, forward residual norms, gradient norm and every gradient
    leaf (gathered) of one step's gradients, under ``mesh`` and on one
    rank, from the params tree (numpy) and batch of ``case`` (without
    params: the port's, seed 0); with ``states`` also the embeddings and
    the state the head reads (:func:`_states`)."""
    rcfg = f32_config(case["arch"], **case.get("cfg", {}))
    if case.get("mode") == "serial":
        rcfg = rcfg.replace(mgrit=dataclasses.replace(rcfg.mgrit,
                                                      enabled=False))
    full = params_from_jax(case["params"], rcfg, "cpu") \
        if "params" in case else transformer.init_model(rcfg, device="cpu")
    out = {}
    for name, m in _runs(mesh):
        params = full
        if m is not None:
            specs = pparams.train_specs(full, rcfg, m)
            params, whole = pparams.shard_tree(full, specs, m,
                                               cfg=rcfg.model)
            out["whole"] = [".".join(p) for p in whole]
            m.reset_counts()
        batch = shard_batch(case["batch"], "cpu", m, rcfg)
        loss, diag, grads = steps.make_grad_fn(rcfg, m)(params, batch)
        gn = optimizers.global_norm(grads, steps.norm_layers(rcfg, m))
        if m is not None:
            out["counts"] = {k: list(v) for k, v in m.counts.items()}
        if case.get("states"):
            out[name + "_states"] = _states(
                params, batch, rcfg, m, "serial" if case.get(
                    "mode") == "serial" else "lp")
        if m is not None:
            grads = pparams.gather_tree(grads, specs, m, cfg=rcfg.model)
        out[name] = {"loss": loss.item(), "fwd_norms": diag[
            "fwd_norms"].numpy().copy(), "global_norm": gn.item(),
            "grads": _np(grads)}
    return out


def _local_shapes(tr):
    """The shapes this rank stores of every params leaf and AdamW
    moment."""
    return {part: {".".join(p): list(t.shape) for p, t in
                   leaves_with_paths(tree)}
            for part, tree in (("params", tr.params),
                               ("m", tr.opt_state["m"]),
                               ("v", tr.opt_state["v"]))}


def trainer_case(mesh, case):
    """``Trainer.train`` under ``mesh`` and on one rank: losses, modes,
    the probe's history and forward norms; the leaves kept whole and the
    mesh run's collectives."""
    rcfg = f32_config(case["arch"], **case.get("cfg", {}))
    out = {}
    for name, m in _runs(mesh):
        if m is not None:
            m.reset_counts()
        tr = Trainer(rcfg, mesh=m, seed=0, device="cpu")
        rep = tr.train(case["steps"], log_every=0)
        out[name] = {"losses": rep.losses, "modes": rep.mode_trace,
                     "history": [list(h) for h in rep.controller_history],
                     "fwd_norms": rep.fwd_norms}
    out["kept_whole"] = [".".join(p) for p in tr.kept_whole]
    out["counts"] = {k: list(v) for k, v in mesh.counts.items()}
    return out


def _state(tr, rcfg, mesh):
    """A Trainer's step, its params and optimizer moments, every leaf
    gathered whole (numpy)."""
    if mesh is not None:
        specs = pparams.train_specs(transformer.param_shapes(rcfg), rcfg,
                                    mesh)
    opt = {k: v for k, v in tr.opt_state.items() if k != "step"}
    params = tr.params if mesh is None else \
        pparams.gather_tree(tr.params, specs, mesh, cfg=rcfg.model)
    opt = opt if mesh is None else \
        pparams.gather_tree(opt, {k: specs for k in opt}, mesh,
                            cfg=rcfg.model)
    return {"step": tr.step, "opt_step": tr.opt_state["step"],
            "params": _np(params), "opt": _np(opt)}


def ckpt_case(mesh, case):
    """Save (``case["save"]``) after ``case["steps"]`` steps, or restore
    from ``case["dir"]``, and return the state (:func:`_state`), the
    shapes this rank stores (:func:`_local_shapes`) and the leaves kept
    whole; with ``save`` also the one-rank Trainer's state after the
    same steps."""
    rcfg = f32_config(case["arch"], **case.get("cfg", {}))
    tr = Trainer(rcfg, mesh=mesh, seed=0, device="cpu",
                 ckpt_dir=case["dir"])
    if case["save"]:
        tr.train(case["steps"], log_every=0, probe=False)
        tr._save()
    out = _state(tr, rcfg, mesh)
    out["local"] = _local_shapes(tr)
    out["kept_whole"] = [".".join(p) for p in tr.kept_whole]
    if case["save"] and dist.get_rank() == 0:
        one = Trainer(rcfg, seed=0, device="cpu")
        one.train(case["steps"], log_every=0, probe=False)
        out["one"] = _state(one, rcfg, None)
    return out


CASES = {"grads": grads_case, "trainer": trainer_case, "ckpt": ckpt_case}


def run(shape, cases):
    """This rank's results of every case ``(kind, case)`` on a
    ("data", "model") mesh of ``shape``."""
    mesh = make_mesh(shape, ("data", "model"), "cpu")
    res = [CASES[kind](mesh, case) for kind, case in cases]
    return {"rank": dist.get_rank(), "threads": torch.get_num_threads(),
            "results": res}
