"""Optimizers (AdamW / SGD+momentum) with schedules and global-norm
clipping.

Port of :mod:`repro.optim.optimizers`, with the same arithmetic per
element (float32 master values and moments, the reference's operation
order). One difference: :func:`apply_updates` writes the new values into
the params and state tensors in place, where the reference returns new
trees. At full width a second copy of params and both moments would not
fit beside the first on one card; only one leaf's temporaries are live
at a time, and a large leaf (falcon-mamba-7b's in_proj stack holds
6.4 GB) is updated in pieces of 2**26 elements, which changes no number
(every operation is elementwise).
"""
from __future__ import annotations

import math
from typing import Any, Tuple

import torch

from repro_torch.configs.base import OptimizerConfig
from repro_torch.tree import leaves_with_paths, tree_map

_F32 = torch.float32
_SLICE_ELEMS = 1 << 26     # leaves update in flat pieces of this size


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


def _sum_sq(x):
    return torch.sum(torch.square(x.float()))


def global_norm(tree, layers=None):
    """sqrt of the sum over leaves, in leaf order, of each leaf's sum of
    squares. ``layers`` (:func:`repro_torch.launch.steps.norm_layers`):
    ({key path: whether the leaf is stacked on a layer axis} of the
    leaves completed apart, a function that turns {path: this rank's
    sums} into every layer's, in layer order, and {key path: a function
    from the leaf to the pieces of it that this rank counts}). Such a
    leaf's sum of squares is the sum of its layers' (one, unless
    stacked) in layer order, one reduction a layer: the same bits
    whichever ranks hold which layers."""
    leaves = leaves_with_paths(tree)
    paths, complete, parts = layers if layers is not None else ({}, None,
                                                                {})

    def sq(p, x):
        if p not in parts:
            return _sum_sq(x)
        return sum(_sum_sq(t) for t in parts[p](x))

    sums = {p: _sum_sq(x) for p, x in leaves if p not in paths}
    per_layer = {p: torch.stack([sq(p, x[n]) for n in range(x.shape[0])])
                 if paths[p] else sq(p, x).reshape(1)
                 for p, x in leaves if p in paths}
    if per_layer:
        sums.update({p: v.sum() for p, v in complete(per_layer).items()})
    return torch.sqrt(sum(sums[p] for p, _ in leaves))


def _clip_scale(grads, max_norm: float, layers=None):
    gn = global_norm(grads, layers)
    return torch.clamp(max_norm / torch.clamp(gn, min=1e-12), max=1.0), gn


def _clipped(g, scale):
    return (g.float() * scale).to(g.dtype)


def _slices(t):
    """Views of ``t``'s flat elements in pieces of ``_SLICE_ELEMS`` (one
    piece for a small leaf): the update's float32 temporaries stay one
    piece in size. ``view`` raises on a non-contiguous leaf rather than
    copying it, so the in-place writes always land in the leaf."""
    return t.view(-1).split(_SLICE_ELEMS)


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


def apply_updates(cfg: OptimizerConfig, params, grads, state, layers=None
                  ) -> Tuple[Any, Any, Any]:
    """One optimizer step, in place. Returns (params, state, metrics) —
    the same params and state objects, updated. While the leaves are
    written ``state["step"]`` is None, so a state an exception left
    half-updated says so (the Trainer checkpoints no such state).
    ``layers``: :func:`global_norm`'s, for leaves stacked on a layer
    axis (every rank then clips by the same norm)."""
    grads = _freeze_structural(grads)
    # clipped one leaf at a time below: a clipped copy of every gradient
    # would not fit beside the rest at full width
    scale, gn = _clip_scale(grads, cfg.grad_clip, layers)
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

    adam = cfg.name in ("adamw", "adam")
    state["step"] = None
    with torch.no_grad():
        for path, stored in leaves_with_paths(params):
            if path[-1] == "gate":
                continue    # structural: passes through untouched
            written = [w_at[path], m_at[path], stored]
            if adam:
                written.append(v_at[path])
            g_pieces = g_at[path].reshape(-1).split(_SLICE_ELEMS)
            for g, p, m, st, *v in zip(g_pieces, *map(_slices, written)):
                g32 = _clipped(g, scale).float()
                if adam:
                    m2 = b1 * m.float() + (1 - b1) * g32
                    v2 = b2 * v[0].float() + (1 - b2) * g32 * g32
                    u = (m2 / bc1) / (torch.sqrt(v2 / bc2) + cfg.eps)
                    if cfg.name == "adamw":
                        u = u + cfg.weight_decay * p.float()
                    v[0].copy_(v2)
                else:  # sgd + momentum
                    m2 = 0.9 * m.float() + g32
                    u = m2
                p.copy_(p.float() - lr * u)
                m.copy_(m2)
                if written[0] is not stored:    # bf16 storage of an fp32 master
                    st.copy_(p)
    state["step"] = step
    return params, state, {"grad_norm": gn, "lr": lr}
