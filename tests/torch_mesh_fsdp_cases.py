"""What each spawned rank of ``tests/test_torch_mesh_fsdp.py`` runs.

Like ``torch_mesh_cases.py``, this module imports neither jax nor the
JAX package: every rank is a fresh process and returns numbers only.
fsdp cuts only leaves of at least ``1 << 22`` elements, which the
reduced configs never reach, so the configs here are the reduced ones
widened until some leaves cross it (:func:`config`), in float32.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

import torch_mesh_cases as train_cases
from repro_torch.configs.base import MoEConfig
from repro_torch.configs.reduce import reduce_config
from repro_torch.configs.registry import get_config
from repro_torch.data.pipeline import shard_batch
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import transformer
from repro_torch.optim import optimizers
from repro_torch.parallel import params as pparams
from repro_torch.train.trainer import Trainer
from repro_torch.tree import leaves_with_paths

# d_model 512, vocab 8192: the embeddings hold 1 << 22 elements; d_ff
# 2048: a 4-layer trunk's MLP (or a MoE buffer layer's 4 experts) too
WIDE = {"d_model": 512, "d_ff": 2048, "vocab_size": 8192, "n_layers": 6}


def config(arch, fsdp=True, mode="lp", **mgrit_kw):
    """``arch``'s reduced train config (its own train sharding) widened
    to WIDE, 1 + 4 + 1 layers (cf 2, no gate-0 layer), float32; a MoE
    config keeps 4 experts of d_ff 2048. ``fsdp=False``: the same rules
    without the fsdp axis; ``mode="serial"``: MGRIT off."""
    rcfg = reduce_config(get_config(arch))
    m = dataclasses.replace(rcfg.model, dtype="float32", **WIDE)
    if m.moe is not None:
        m = dataclasses.replace(m, moe=MoEConfig(num_experts=4, top_k=2,
                                                 d_ff=2048))
    mg = dataclasses.replace(rcfg.mgrit, pad_to=4,
                             enabled=mode == "lp", **mgrit_kw)
    sh = rcfg.sharding if fsdp else dataclasses.replace(rcfg.sharding,
                                                        fsdp=None)
    return rcfg.replace(model=m, mgrit=mg, sharding=sh)


def _np(tree) -> dict:
    return {".".join(p): t.detach().numpy().copy()
            for p, t in leaves_with_paths(tree)}


def _shapes(tree, paths) -> dict:
    return {".".join(p): list(t.shape) for p, t in leaves_with_paths(tree)
            if p in paths}


def grads_case(mesh, case):
    """One gradient step of ``case["arch"]`` (its ``mode``) under
    ``mesh``, with its fsdp rules and with ``fsdp=None``, from the same
    seeded params and ``case["batch"]``: each run's loss, gradient norm,
    collective counts, the leaves kept whole, the fsdp-cut leaves (path
    -> dimension) with their local and whole shapes; on global rank 0
    also every gradient leaf gathered whole."""
    out = {}
    full = transformer.init_model(config(case["arch"], mode=case["mode"]),
                                  seed=0, device="cpu")
    for name, fsdp in (("fsdp", True), ("plain", False)):
        rcfg = config(case["arch"], fsdp, case["mode"])
        specs = pparams.train_specs(full, rcfg, mesh)
        cut = pparams.fsdp_cut(full, specs, mesh, rcfg.sharding)
        local, whole = pparams.shard_tree(full, specs, mesh,
                                          sharding=rcfg.sharding)
        mesh.reset_counts()
        loss, _, grads = steps.make_grad_fn(rcfg, mesh)(
            local, shard_batch(case["batch"], "cpu", mesh, rcfg))
        gn = optimizers.global_norm(grads, steps.norm_layers(rcfg, mesh))
        res = {"loss": loss.item(), "global_norm": gn.item(),
               "counts": {k: list(v) for k, v in mesh.counts.items()},
               "whole": [".".join(p) for p in whole],
               "cut": {".".join(p): d for p, (d, _) in cut.items()},
               "local": _shapes(local, cut), "grad_local": _shapes(grads, cut),
               "full": _shapes(full, cut)}
        grads = pparams.gather_tree(grads, specs, mesh,
                                    sharding=rcfg.sharding)
        if dist.get_rank() == 0:
            res["grads"] = _np(grads)
        out[name] = res
    return out


def _state(tr, rcfg, mesh):
    """``torch_mesh_cases._state`` with the fsdp dimensions gathered."""
    if mesh is None:
        return train_cases._state(tr, rcfg, None)
    specs = pparams.train_specs(transformer.param_shapes(rcfg), rcfg, mesh)
    opt = {k: v for k, v in tr.opt_state.items() if k != "step"}
    kw = {"sharding": rcfg.sharding}
    return {"step": tr.step, "opt_step": tr.opt_state["step"],
            "params": _np(pparams.gather_tree(tr.params, specs, mesh, **kw)),
            "opt": _np(pparams.gather_tree(opt, {k: specs for k in opt},
                                           mesh, **kw))}


def train_case(mesh, case):
    """Two ``Trainer`` steps of ``case["arch"]`` under ``mesh`` with the
    probe at step 1, saved to ``case["dir"]``: losses, modes, the state
    gathered whole, the leaves kept whole and the local shapes of the
    fsdp-cut leaves and their AdamW moments; on global rank 0 the
    one-rank Trainer's losses and state."""
    rcfg = config(case["arch"], check_every=1)
    out = {}
    for name, m in train_cases._runs(mesh):
        tr = Trainer(rcfg, mesh=m, seed=0, device="cpu",
                     ckpt_dir=case["dir"] if m is not None else "")
        rep = tr.train(case["steps"], log_every=0)
        if m is not None:
            tr._save()
            cut = pparams.fsdp_cut(transformer.param_shapes(rcfg),
                                   pparams.train_specs(
                                       transformer.param_shapes(rcfg), rcfg,
                                       m), m, rcfg.sharding)
            out["kept_whole"] = [".".join(p) for p in tr.kept_whole]
            out["local"] = {part: _shapes(tree, cut) for part, tree in (
                ("params", tr.params), ("m", tr.opt_state["m"]),
                ("v", tr.opt_state["v"]))}
        out[name] = {"losses": rep.losses, "modes": rep.mode_trace,
                     "history": [list(h) for h in rep.controller_history],
                     **_state(tr, rcfg, m)}
    return out


def restore_case(mesh, case):
    """A Trainer restored from ``case["dir"]`` under ``mesh``: its state
    gathered whole."""
    rcfg = config(case["arch"], check_every=1)
    tr = Trainer(rcfg, mesh=mesh, seed=0, device="cpu",
                 ckpt_dir=case["dir"])
    return _state(tr, rcfg, mesh)


def reduce_scatter_case(mesh, case):
    """``Mesh.reduce_scatter`` over 'data' along dim 0 and dim 1 of a
    tensor whose entries name (sender, element), and its counts."""
    n, r = mesh.shape["data"], mesh.index("data")
    t = (1000 * (r + 1) + torch.arange(4 * n * 3, dtype=torch.float32)
         ).view(4 * n, 3)
    mesh.reset_counts()
    out0 = mesh.reduce_scatter("rs", t, "data")
    out1 = mesh.reduce_scatter("rs", t.T, "data", dim=1)
    one = mesh.reduce_scatter("rs", t, "model")
    return {"n": n, "r": r, "sent": t.numpy().copy(),
            "dim0": out0.numpy().copy(), "dim1": out1.numpy().copy(),
            "one_rank_same": one is t,
            "counts": {k: list(v) for k, v in mesh.counts.items()}}


def refusal_case(mesh, case):
    """The error ``make_grad_fn`` raises on params whose fsdp dimension
    was not cut (``shard_tree`` without ``sharding``)."""
    rcfg = config(case["arch"])
    full = transformer.init_model(rcfg, seed=0, device="cpu")
    local, _ = pparams.shard_tree(full, pparams.train_specs(full, rcfg,
                                                            mesh), mesh)
    try:
        steps.make_grad_fn(rcfg, mesh)(
            local, shard_batch(case["batch"], "cpu", mesh, rcfg))
    except ValueError as e:
        return str(e)
    return None


CASES = {"grads": grads_case, "train": train_case, "restore": restore_case,
         "reduce_scatter": reduce_scatter_case, "refusal": refusal_case}


def run(todo):
    """This rank's results of every ``(shape, kind, case)`` of ``todo``,
    on a ("data", "model") mesh of each shape (built once a shape)."""
    meshes, res = {}, []
    for shape, kind, case in todo:
        if shape not in meshes:
            meshes[shape] = make_mesh(shape, ("data", "model"), "cpu")
        res.append(CASES[kind](meshes[shape], case))
    return {"rank": dist.get_rank(), "threads": torch.get_num_threads(),
            "results": res}
