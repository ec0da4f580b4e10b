"""Step functions — port of :mod:`repro.launch.steps`: the train step
(gradients, microbatch accumulation, optimizer), top-k/top-p masking,
per-slot sampling and the paged serve step.

The JAX package traces these into one jitted call; the port runs them
eagerly on the tensors' device. Host inputs (numpy slot arrays) are
uploaded once per wave in :func:`make_paged_serve_fn`.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import RunConfig
from repro_torch.kernels import ops as kops
from repro_torch.launch import prng
from repro_torch.models import transformer
from repro_torch.optim import optimizers
from repro_torch.tree import leaves_with_paths, unflatten

_MASKED = -1e30          # matches the attention-mask convention


def make_train_fn(rcfg: RunConfig):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics). Params and optimizer state are updated in place
    (:func:`repro_torch.optim.optimizers.apply_updates`). Gradient
    accumulation over ``rcfg.microbatches`` bounds the live MGRIT state
    memory (a loop where the reference scans)."""
    mode = "lp" if rcfg.mgrit.enabled else "serial"
    nmb = rcfg.microbatches

    def value_and_grad(params, batch):
        paths, leaves = zip(*leaves_with_paths(params))
        leaves = [p.detach().requires_grad_(True) for p in leaves]
        loss, diag = transformer.loss_fn(unflatten(zip(paths, leaves)),
                                         batch, rcfg, mode=mode)
        grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), diag, paths, grads

    def train_step(params, opt_state, batch):
        if nmb > 1:
            lsum, g_acc = 0.0, None
            for i in range(nmb):
                b_i = {k: a.reshape(nmb, a.shape[0] // nmb, *a.shape[1:])[i]
                       for k, a in batch.items()}
                l, diag, paths, grads = value_and_grad(params, b_i)
                grads = [g.float() for g in grads]
                g_acc = grads if g_acc is None else \
                    [a + g for a, g in zip(g_acc, grads)]
                lsum = lsum + l
            grads = [g / nmb for g in g_acc]
            lval = lsum / nmb
        else:
            lval, diag, paths, grads = value_and_grad(params, batch)
        params, opt_state, om = optimizers.apply_updates(
            rcfg.optimizer, params, unflatten(zip(paths, grads)), opt_state)
        metrics = {"loss": lval, "fwd_norms": diag["fwd_norms"], **om}
        return params, opt_state, metrics

    return train_step


def apply_top_k_top_p(logits, k, p):
    """Fused top-k + nucleus mask driven by one descending sort per row
    (the sort-based path; ``fused=False`` sampling uses it). Masked
    entries become -1e30; the argmax always survives. logits: (B, V);
    k: (B,) int (<= 0 disables); p: (B,) float in (0, 1]."""
    B, V = logits.shape
    srt, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    k = k.long()
    k_eff = torch.where(k <= 0, torch.full_like(k, V), k).clamp(1, V)
    keep = torch.arange(V, device=logits.device)[None, :] < k_eff[:, None]
    probs = torch.softmax(
        torch.where(keep, srt, torch.full_like(srt, _MASKED)).float(), dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep &= (cum - probs) < p.float()[:, None]   # mass before token < p
    keep[:, 0] = True                            # argmax always survives
    masked_sorted = torch.where(keep, srt, torch.full_like(srt, _MASKED))
    return torch.zeros_like(logits).scatter_(1, idx, masked_sorted)


def sample_tokens(logits, temps, top_ks, top_ps, seeds, counters, *,
                  any_sampled: bool, fused: bool = False):
    """Vectorized per-slot sampling: (B, V) logits -> (B,) int32 tokens.

    Slots with ``temps <= 0`` take the exact greedy argmax. Others scale
    by temperature, apply the top-k/top-p mask and draw by Gumbel-argmax
    with key ``fold_in(PRNGKey(seed), counter)`` — bit-exact with the JAX
    package's stream (:mod:`repro_torch.launch.prng`), so a seeded
    request reproduces its tokens in any slot, batch or framework.

    ``fused`` swaps the sort for the sort-free threshold mask
    (:func:`repro_torch.kernels.ops.topk_topp_mask`: the CUDA kernel on
    the card). ``any_sampled`` is the all-greedy skip, decided on the
    host from the slots' temperatures before upload (the reference's
    ``lax.cond``), so it costs no device sync.
    """
    lf = logits.float()
    greedy = torch.argmax(lf, dim=-1).to(torch.int32)
    if not any_sampled:
        return greedy
    scaled = lf / torch.clamp(temps, min=1e-6)[:, None]
    if fused:
        scaled = kops.topk_topp_mask(scaled, top_ks, top_ps)
    else:
        scaled = apply_top_k_top_p(scaled, top_ks, top_ps)
    keys = prng.fold_in(prng.PRNGKey(seeds), counters)
    sampled = torch.argmax(scaled + prng.gumbel(keys, lf.shape[-1]), dim=-1)
    return torch.where(temps <= 0.0, greedy, sampled.to(torch.int32))


def make_paged_serve_fn(rcfg: RunConfig, decode_fn, fused: bool = False,
                        device=None):
    """Paged-state step: one function serves both chunked prefill
    (S = prompt bucket) and steady-state decode (S = 1); slot occupancy
    is the ``n_new`` mask.

    ``decode_fn`` is the family's paged forward (e.g.
    ``transformer.paged_decode_step``), called as ``decode_fn(params,
    state, tokens, lengths, n_new, page_table, rcfg)``. The returned
    callable takes the host (numpy) slot arrays, uploads them to
    ``device``, runs the forward and the sampler, and returns (next
    (B, 1) int32 on the device, state).
    """

    def up(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device, dtype)

    def paged_serve_step(params, state, tokens, lengths, n_new, page_table,
                         temps, top_ks, top_ps, seeds, counters):
        any_sampled = bool(np.any(np.asarray(temps) > 0.0))
        # lengths and the table in int32: the attention kernel's types
        logits, state = decode_fn(
            params, state, up(tokens, torch.long), up(lengths, torch.int32),
            up(n_new, torch.long), up(page_table, torch.int32), rcfg)
        nxt = sample_tokens(logits, up(temps, torch.float32),
                            up(top_ks, torch.int32),
                            up(top_ps, torch.float32),
                            up(seeds, torch.long), up(counters, torch.long),
                            fused=fused, any_sampled=any_sampled)
        return nxt[:, None], state

    return paged_serve_step
