"""Optimizers (AdamW / SGD+momentum) with schedules and global-norm
clipping.

Port of :mod:`repro.optim.optimizers`, with the same arithmetic per
element (float32 master values and moments, the reference's operation
order). One difference: :func:`apply_updates` writes the new values into
the params and state tensors in place, where the reference returns new
trees. At full width a second copy of params and both moments would not
fit beside the first on one card; only one leaf's temporaries are live
at a time.
"""
from __future__ import annotations

import math
from typing import Any, Tuple

import torch

from repro_torch.configs.base import OptimizerConfig
from repro_torch.tree import leaves_with_paths, tree_map

_F32 = torch.float32


def lr_at(cfg: OptimizerConfig, step: int) -> float:
    """Learning rate at ``step`` (float32 arithmetic, as the reference)."""
    step_t = torch.tensor(step, dtype=_F32)
    warm = torch.clamp(step_t / max(cfg.warmup_steps, 1), max=1.0)
    if cfg.schedule in ("cosine", "linear"):
        t = torch.clamp((step_t - cfg.warmup_steps)
                        / max(cfg.total_steps - cfg.warmup_steps, 1),
                        0.0, 1.0)
        if cfg.schedule == "cosine":
            decay = 0.1 + 0.9 * (0.5 * (1.0 + torch.cos(math.pi * t)))
        else:
            decay = 1.0 - 0.9 * t
    else:
        decay = torch.tensor(1.0, dtype=_F32)
    return float(cfg.lr * warm * decay)


def global_norm(tree):
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for _, x in leaves_with_paths(tree)))


def _clip_scale(grads, max_norm: float):
    gn = global_norm(grads)
    return torch.clamp(max_norm / torch.clamp(gn, min=1e-12), max=1.0), gn


def _clipped(g, scale):
    return (g.float() * scale).to(g.dtype)


def clip_by_global_norm(grads, max_norm: float):
    scale, gn = _clip_scale(grads, max_norm)
    return tree_map(lambda g: _clipped(g, scale), grads), gn


def init_opt_state(cfg: OptimizerConfig, params, moment_dtype=None):
    """Zero moments (and an fp32 master copy for bf16-stored params).
    ``step`` is a host integer: the schedule is computed on the host."""
    mdt = moment_dtype or getattr(torch, cfg.moment_dtype)
    if cfg.name not in ("adamw", "adam", "sgd"):
        raise ValueError(cfg.name)

    def zeros(p):
        return torch.zeros(p.shape, dtype=mdt, device=p.device)

    state = {"step": 0, "m": tree_map(zeros, params)}
    if cfg.name in ("adamw", "adam"):
        state["v"] = tree_map(zeros, params)
    if any(p.dtype == torch.bfloat16 for _, p in leaves_with_paths(params)):
        state["master"] = tree_map(lambda p: p.float(), params)
    return state


def _freeze_structural(grads):
    """Zero the gradients of structural (non-trainable) leaves: the 0/1
    layer gates of the padded ParallelNet. They neither update nor decay
    (:func:`apply_updates` skips them)."""
    def walk(tree, key=None):
        if tree is None:
            return None
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        return torch.zeros_like(tree) if key == "gate" else tree
    return walk(grads)


def apply_updates(cfg: OptimizerConfig, params, grads, state
                  ) -> Tuple[Any, Any, Any]:
    """One optimizer step, in place. Returns (params, state, metrics) —
    the same params and state objects, updated."""
    grads = _freeze_structural(grads)
    # clipped one leaf at a time below: a clipped copy of every gradient
    # would not fit beside the rest at full width
    scale, gn = _clip_scale(grads, cfg.grad_clip)
    step = state["step"] + 1
    lr = lr_at(cfg, step)
    b1, b2 = cfg.beta1, cfg.beta2
    step_t = torch.tensor(float(step), dtype=_F32)
    bc1 = float(1.0 - torch.tensor(b1, dtype=_F32) ** step_t)
    bc2 = float(1.0 - torch.tensor(b2, dtype=_F32) ** step_t)
    g_at = dict(leaves_with_paths(grads))
    m_at = dict(leaves_with_paths(state["m"]))
    v_at = dict(leaves_with_paths(state.get("v")))
    w_at = dict(leaves_with_paths(state.get("master", params)))

    with torch.no_grad():
        for path, stored in leaves_with_paths(params):
            if path[-1] == "gate":
                continue    # structural: passes through untouched
            p, m = w_at[path], m_at[path]
            g32 = _clipped(g_at[path], scale).float()
            if cfg.name in ("adamw", "adam"):
                v = v_at[path]
                m2 = b1 * m.float() + (1 - b1) * g32
                v2 = b2 * v.float() + (1 - b2) * g32 * g32
                u = (m2 / bc1) / (torch.sqrt(v2 / bc2) + cfg.eps)
                if cfg.name == "adamw":
                    u = u + cfg.weight_decay * p.float()
                v.copy_(v2)
            else:  # sgd + momentum
                m2 = 0.9 * m.float() + g32
                u = m2
            p.copy_(p.float() - lr * u)
            m.copy_(m2)
            if p is not stored:          # bf16 storage of an fp32 master
                stored.copy_(p)
    state["step"] = step
    return params, state, {"grad_norm": gn, "lr": lr}
