"""What each spawned rank of ``tests/test_torch_mesh_moe.py`` runs.

Like ``torch_mesh_cases.py`` and ``torch_mesh_serve_cases.py`` (whose
cases it reuses), this module imports neither jax nor the JAX package:
every rank is a fresh process and returns numbers only. One spawn may
run cases on several mesh shapes of its world (``run``), each shape's
mesh built once.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

import torch_mesh_cases as train_cases
import torch_mesh_serve_cases as serve_cases
from repro_torch.configs import registry
from repro_torch.configs.base import ModelConfig, MoEConfig, ShardingConfig
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import moe, transformer
from repro_torch.parallel import params as pparams
from repro_torch.parallel import tp
from repro_torch.parallel.sharding import axis_rules
from repro_torch.train.trainer import Trainer
from repro_torch.tree import leaves_with_paths

EXPERT_LEAVES = ("w_in", "w_gate", "w_out")


def module_cfg() -> ModelConfig:
    """``test_torch_moe.moe_cfgs``' port config: 4 experts, top-2,
    d_model 32, expert d_ff 64, float32."""
    return ModelConfig(name="m", family="decoder", n_layers=2, d_model=32,
                       n_heads=2, n_kv_heads=2, d_ff=64, vocab_size=64,
                       dtype="float32",
                       moe=MoEConfig(num_experts=4, top_k=2, d_ff=64))


def _counts(mesh):
    return {k: list(v) for k, v in mesh.counts.items()}


def a2a_case(mesh, case):
    """``Mesh.all_to_all`` over ``case["axis"]`` of a tensor whose
    entries name (sender, piece, element): dim 0 and dim 1; the counts
    of both calls."""
    ax = case["axis"]
    n, r = mesh.shape[ax], mesh.index(ax)
    t = (100 * r + torch.arange(4 * n * 3, dtype=torch.float32)).view(
        4 * n, 3)
    mesh.reset_counts()
    out0 = mesh.all_to_all("a2a", t, ax)
    out1 = mesh.all_to_all("a2a", t.T.contiguous(), ax, dim=1)
    return {"n": n, "r": r, "sent": t.numpy().copy(),
            "dim0": out0.numpy().copy(), "dim1": out1.numpy().copy(),
            "same": out0 is t, "counts": _counts(mesh)}


def _local_params(params, mesh, rules, cfg):
    """This rank's slice of the MoE params: its experts where ``rules``
    map them, its columns of ``w_in`` / ``w_gate`` and rows of ``w_out``
    where ``mlp`` is cut (serving)."""
    out = {k: torch.from_numpy(v) for k, v in params.items()}
    ax = tp.axis_of(mesh, rules, "experts")
    if ax is not None:
        n, r = mesh.shape[ax], mesh.index(ax)
        e = cfg.moe.num_experts // n
        for k in EXPERT_LEAVES:
            out[k] = out[k][r * e:(r + 1) * e]
    ax = tp.axis_of(mesh, rules, "mlp")
    if ax is not None:
        n, r = mesh.shape[ax], mesh.index(ax)
        f = cfg.moe.d_ff // n
        for k, d in (("w_in", -1), ("w_gate", -1), ("w_out", -2)):
            out[k] = out[k].narrow(d, r * f, f)
    return {k: v.contiguous() for k, v in out.items()}


def module_case(mesh, case):
    """``moe_apply`` on this data rank's rows of ``case["x"]`` under the
    training rules (batch and experts over ``data``): the output, and
    the cotangents of its rows, of the router (its own tokens') and of
    its experts' leaves; under serving's rules with the experts over
    ``data`` (``mlp`` over ``model``) the output. The exchange's
    counts; on global rank 0 the one-rank port's output and cotangents
    on the whole batch."""
    cfg = module_cfg()
    x, ct = case["x"], case["ct"]
    d, nd = mesh.index("data"), mesh.shape["data"]
    rows = slice(d * x.shape[0] // nd, (d + 1) * x.shape[0] // nd)
    out = {"rows": [rows.start, rows.stop]}
    names = ["x", "router", *EXPERT_LEAVES]

    def fwd_bwd(params, xx, cc):
        leaves = [torch.from_numpy(xx).requires_grad_(True)] + [
            params[k].requires_grad_(True) for k in names[1:]]
        y = moe.moe_apply(dict(zip(names[1:], leaves[1:])), leaves[0], cfg)
        grads = torch.autograd.grad(y, leaves, torch.from_numpy(cc))
        return {"y": y.detach().numpy().copy(),
                **{k: g.numpy().copy() for k, g in zip(names, grads)}}

    train = ShardingConfig(batch="data", experts="data")
    params = _local_params(case["params"], mesh, train, cfg)
    out["shapes"] = {k: list(v.shape) for k, v in params.items()}
    mesh.reset_counts()
    with axis_rules(mesh, train):
        out["train"] = fwd_bwd(params, x[rows], ct[rows])
    out["train_counts"] = _counts(mesh)
    serve = dataclasses.replace(registry.serve_sharding(), experts="data")
    params = _local_params(case["params"], mesh, serve, cfg)
    mesh.reset_counts()
    with torch.no_grad(), tp.active(mesh, serve):
        out["serve_y"] = moe.moe_apply(params, torch.from_numpy(x[rows]),
                                       cfg).numpy().copy()
    out["serve_counts"] = _counts(mesh)
    if dist.get_rank() == 0:
        out["one"] = fwd_bwd({k: torch.from_numpy(v) for k, v in
                              case["params"].items()}, x, ct)
    return out


def grads_case(mesh, case):
    """``torch_mesh_cases.grads_case`` (the loss, residual norms,
    gradient norm and every gathered gradient leaf, under ``mesh`` and
    on one rank) of the reduced float32 qwen3-moe, with what this rank
    stores: its expert-cut leaves' shapes, the leaves kept whole, and
    the bytes a data-parallel gradient mean of every other leaf moves
    (float32)."""
    out = train_cases.grads_case(mesh, case)
    rcfg = train_cases.f32_config(case["arch"])
    shapes = transformer.param_shapes(rcfg)
    specs = pparams.train_specs(shapes, rcfg, mesh)
    ep = pparams.expert_cut(shapes, specs, mesh)
    local, _ = pparams.shard_tree(transformer.init_model(rcfg, device="cpu"),
                                  specs, mesh)
    out["expert_cut"] = {".".join(p): list(ax) for p, ax in ep.items()}
    out["local_shapes"] = {".".join(p): list(t.shape)
                           for p, t in leaves_with_paths(local)}
    out["mean_bytes"] = sum(t.numel() * 4 for p, t in
                            leaves_with_paths(local) if p not in ep)
    return out


def train_case(mesh, case):
    """Two ``Trainer`` steps of the reduced float32 qwen3-moe under
    ``mesh`` (the probe at step 1) saved to ``case["dir"]``: the losses,
    modes and probe history, the state gathered whole, the local shapes
    of the expert leaves and their AdamW moments, the leaves kept whole;
    on global rank 0 the one-rank Trainer's losses and state."""
    rcfg = train_cases.f32_config(case["arch"], check_every=1)
    out = {}
    for name, m in train_cases._runs(mesh):
        tr = Trainer(rcfg, mesh=m, seed=0, device="cpu",
                     ckpt_dir=case["dir"] if m is not None else "")
        rep = tr.train(case["steps"], log_every=0)
        if m is not None:
            tr._save()
            out["kept_whole"] = [".".join(p) for p in tr.kept_whole]
            out["local"] = {
                part: {".".join(p): list(t.shape) for p, t in
                       leaves_with_paths(tree) if p[-1] in EXPERT_LEAVES}
                for part, tree in (("params", tr.params),
                                   ("m", tr.opt_state["m"]),
                                   ("v", tr.opt_state["v"]))}
        out[name] = {"losses": rep.losses, "modes": rep.mode_trace,
                     "history": [list(h) for h in rep.controller_history],
                     **train_cases._state(tr, rcfg, m)}
    return out


def restore_case(mesh, case):
    """A Trainer restored from ``case["dir"]`` under ``mesh``: its state
    gathered whole."""
    rcfg = train_cases.f32_config(case["arch"], check_every=1)
    tr = Trainer(rcfg, mesh=mesh, seed=0, device="cpu",
                 ckpt_dir=case["dir"])
    return train_cases._state(tr, rcfg, mesh)


def refusal_case(mesh, case):
    """``experts`` over ``model`` while the batch is over ``data``: the
    error ``moe_apply`` raises under training's and serving's rules."""
    cfg = module_cfg()
    x = torch.zeros(2, 4, cfg.d_model)
    params = moe.init_moe(torch.Generator().manual_seed(0), cfg)
    out = {}
    for name, ctx in (
            ("train", axis_rules(mesh, ShardingConfig(batch="data",
                                                      experts="model"))),
            ("serve", tp.active(mesh, dataclasses.replace(
                registry.serve_sharding(), experts="model")))):
        try:
            with ctx:
                moe.moe_apply(params, x, cfg)
        except NotImplementedError as e:
            out[name] = str(e)
    return out


CASES = {"a2a": a2a_case, "module": module_case, "grads": grads_case,
         "train": train_case, "restore": restore_case,
         "serve": serve_cases.serve_case,
         "refusal": refusal_case}


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
