"""Step functions — port of :mod:`repro.launch.steps`: the train step
(gradients, microbatch accumulation, optimizer), the prefill step, the
dense-cache serve step (the serial-forward oracle), top-k/top-p masking,
per-slot sampling, the paged serve step and speculative decoding's
draft wave, acceptance and verify step.

The JAX package traces these into one jitted call; the port runs them
eagerly on the tensors' device. Host inputs (numpy slot arrays) are
uploaded once per call in :func:`make_paged_serve_fn`,
:func:`make_paged_verify_fn` and :func:`make_draft_wave_fn`.

Under a mesh (explicit SPMD, one process a rank) those three run the
model tensor-parallel (:func:`repro_torch.parallel.tp.active`) on this
data rank's slots only (:class:`SlotRows`): each rank uploads its own
rows of the slot arrays with its page table in its own page ids, every
rank of a data group samples the same whole-vocab rows, and the sampled
tokens are gathered over ``data`` before the host reads them.

The dense-cache serve step (:func:`make_serve_fn`) takes the mesh too,
as the reference's does: under ``rcfg.sharding`` (the reference's
``decode_sharding``, or the serve engine's rules) it runs on this rank's
part of the weights (:func:`shard_decode_params`) and of the cache
(``transformer.init_cache(..., mesh=)``), its slots cut over the batch's
axis, the cache's rows over ``kv_seq``'s, the fsdp-cut leaves gathered
for each layer (:func:`decode_fsdp_plan`).
"""
from __future__ import annotations

import contextlib
import functools
import math

import numpy as np
import torch

from repro_torch.configs.base import RunConfig
from repro_torch.kernels import ops as kops
from repro_torch.launch import prng
from repro_torch.models import transformer
from repro_torch.optim import optimizers
from repro_torch.parallel import tp
from repro_torch.serve.kv_pages import SCRATCH_PAGE, state_leaves
from repro_torch.tree import leaf_at, leaves_with_paths, unflatten

_MASKED = -1e30          # matches the attention-mask convention


def make_grad_fn(rcfg: RunConfig, mesh=None):
    """Returns grad_step(params, batch) -> (loss, diagnostics, grads):
    the loss (a 0-d tensor) and the gradients (a tree like ``params``) of
    the batch, accumulated over ``rcfg.microbatches`` (a loop where the
    reference scans).

    Under ``mesh`` (a :class:`repro_torch.launch.mesh.Mesh`) the step
    runs under the config's sharding rules on this rank's slices
    (:func:`repro_torch.parallel.params.shard_tree`): the trunk's chunks
    over the chunk axis, the batch rows over the data axes, the experts
    over theirs. The gradients and the loss are then averaged over the
    data axes of more than one rank (the mean of equal row shards is the
    global mean). A leaf cut over a tensor-parallel axis (``heads``,
    ``kv_heads``, ``mlp``, ``vocab``: the Megatron split, each rank its
    heads, columns or vocab rows) holds this rank's slice of the
    gradient, averaged over the data axes only; a leaf, or a whole
    block of a cut leaf, that the ranks of such an axis read in part
    (:func:`repro_torch.parallel.params.tp_partial`) is first summed over
    it (``grad_tp``, one all-reduce an axis). An expert-cut leaf's
    gradient holds every rank's tokens of its experts already (the
    exchange's backward brought them): it is divided by the ranks and
    not summed over its expert axis, where a sum would add other
    experts' gradients of the same shape. So is an fsdp-cut leaf's (:mod:`repro_torch.parallel.fsdp`):
    its gather's backward reduce-scattered it over the fsdp axis, a data
    axis, which summed the data ranks' rows into this rank's piece."""
    mode = "lp" if rcfg.mgrit.enabled else "serial"
    nmb = rcfg.microbatches
    # key path -> the data axes whose ranks' rows a leaf's gradient holds
    # already (its experts' axis, its fsdp axis)
    rules, data, summed, pieces = contextlib.nullcontext, (), {}, {}
    partial, slices = {}, {}
    if mesh is not None:
        from repro_torch.parallel import params as pparams
        from repro_torch.parallel.sharding import (axis_rules, axis_tuple,
                                                   spec_for)
        rules = functools.partial(axis_rules, mesh, rcfg.sharding)
        data = tuple(a for a in axis_tuple(spec_for(
            ("batch",), rcfg.sharding, mesh, (rcfg.shape.global_batch,))[0])
            if mesh.shape[a] > 1)
        shapes = transformer.param_shapes(rcfg)
        specs = pparams.train_specs(shapes, rcfg, mesh)
        summed = pparams.expert_cut(shapes, specs, mesh)
        stray = {a for axes in summed.values() for a in axes} - set(data)
        if stray:
            raise NotImplementedError(
                f"the experts split over {sorted(stray)} and the batch of "
                f"{rcfg.shape.global_batch} rows over {list(data)}: expert "
                "parallelism needs the batch rows split over the experts' "
                "axis")
        fs = pparams.fsdp_cut(shapes, specs, mesh, rcfg.sharding)
        stray = {ax for _, ax in fs.values()} - set(data)
        if stray:
            raise NotImplementedError(
                f"fsdp over {sorted(stray)} and the batch of "
                f"{rcfg.shape.global_batch} rows over {list(data)}: the "
                "gradients' reduce-scatter sums the batch shards only "
                "where the fsdp axis is a data axis")
        for p, (d, ax) in fs.items():
            summed[p] = summed.get(p, ()) + (ax,)
            pieces[p] = (d, leaf_at(shapes, p).shape[d] // mesh.shape[ax])
        partial = pparams.tp_partial(shapes, mesh, rcfg)
        if set(partial) & set(fs):
            raise NotImplementedError(
                f"{sorted('.'.join(p) for p in set(partial) & set(fs))}: "
                "fsdp cuts a leaf that the tensor-parallel ranks read in "
                "part")
        cut = pparams.tp_cut(shapes, specs, mesh, rcfg.model, rcfg.sharding)
        slices = {p: tuple(pparams.local_slice(
            leaf_at(shapes, p), p, leaf_at(specs, p), mesh,
            cfg=rcfg.model, sharding=rcfg.sharding).shape) for p in cut}

    def value_and_grad(params, batch):
        paths, leaves = zip(*leaves_with_paths(params))
        leaves = [p.detach().requires_grad_(True) for p in leaves]
        with rules():
            loss, diag = transformer.loss_fn(unflatten(zip(paths, leaves)),
                                             batch, rcfg, mode=mode)
            grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), diag, paths, grads

    def grad_step(params, batch):
        for p, (d, n) in pieces.items():
            if leaf_at(params, p).shape[d] != n:
                raise ValueError(
                    f"{'.'.join(p)}: dimension {d} holds "
                    f"{leaf_at(params, p).shape[d]}, not this rank's fsdp "
                    f"piece of {n}: cut the params with shard_tree(..., "
                    "sharding=rcfg.sharding)")
        for p, want in slices.items():
            got = tuple(leaf_at(params, p).shape)
            if got != want:
                raise ValueError(
                    f"{'.'.join(p)}: holds {got}, not this rank's "
                    f"tensor-parallel slice {want}: cut the params with "
                    "shard_tree(..., cfg=rcfg.model, sharding=rcfg.sharding)")
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
        if partial:
            grads = _sum_partial(mesh, paths, list(grads), partial)
        if data:
            n = math.prod(mesh.shape[a] for a in data)
            grads = [mesh.all_sum("grad_mean", g.contiguous(), tuple(
                a for a in data if a not in summed.get(p, ()))) / n
                for p, g in zip(paths, grads)]
            lval = mesh.all_sum("loss_mean", lval.reshape(1).clone(),
                                data)[0] / n
        return lval, diag, unflatten(zip(paths, grads))

    return grad_step


def _sum_partial(mesh, paths, grads, partial):
    """``grads`` with each leaf (or last-dimension range) of ``partial``
    (:func:`repro_torch.parallel.params.tp_partial`) summed over its
    axis: one all-reduce an axis of every such piece, flattened."""
    at = dict(zip(paths, range(len(paths))))
    for ax in sorted({a for a, _ in partial.values()}):
        mine = [(at[p], rng) for p, (a, rng) in partial.items() if a == ax]
        views = [grads[i] if rng is None else grads[i][..., rng[0]:rng[1]]
                 for i, rng in mine]
        flat = mesh.all_sum("grad_tp", torch.cat(
            [v.reshape(-1) for v in views]), (ax,))
        o = 0
        for (i, rng), v in zip(mine, views):
            piece = flat[o:o + v.numel()].view(v.shape)
            o += v.numel()
            if rng is None:
                grads[i] = piece
            else:
                g = grads[i].clone()
                g[..., rng[0]:rng[1]] = piece
                grads[i] = g
    return grads


def norm_layers(rcfg: RunConfig, mesh=None):
    """:func:`repro_torch.optim.optimizers.global_norm`'s ``layers``:
    the key paths of the leaves whose sums of squares are completed
    apart, each with whether it is stacked on a trunk's layer axis (one
    sum a layer; else one sum), and the function that completes them:
    the stacked leaves, and under ``mesh`` the expert-cut, fsdp-cut and
    tensor-parallel-cut ones; and the leaves of which this rank counts
    only some pieces (a function a leaf: the pieces). Under ``mesh`` an
    expert-cut leaf's sums (this rank's experts') are summed over its
    expert axis, in rank order, from one all-gather an axis; an fsdp-cut
    leaf's (this rank's piece) over its fsdp axis the same way, a
    tensor-parallel-cut one's over its axis too (a whole block of such a
    leaf, the same on every rank once summed, counted by the axis's
    first rank only); then a leaf held in chunk pieces takes every
    rank's sums from one all-gather a chunk axis (all such leaves at
    once); else its sums are complete (a leaf held whole counted once).
    Every rank then clips by the same norm."""
    from repro_torch.parallel import params as pparams
    from repro_torch.parallel.sharding import axis_tuple
    shapes = transformer.param_shapes(rcfg)
    stacked = {path for path, leaf in leaves_with_paths(shapes)
               if pparams.logical_axes_for(path, leaf.shape)[0] == "layers"}
    axis, ep, fs, tpc, parts = {}, {}, {}, {}, {}
    if mesh is not None:
        specs = pparams.train_specs(shapes, rcfg, mesh)
        axis = {p: axis_tuple(leaf_at(specs, p)[0])[0] for p in stacked
                if leaf_at(specs, p)[0] is not None}
        ep = pparams.expert_cut(shapes, specs, mesh)
        fs = {p: (ax,) for p, (_, ax) in pparams.fsdp_cut(
            shapes, specs, mesh, rcfg.sharding).items()}
        tpc = pparams.tp_cut(shapes, specs, mesh, rcfg.model,
                             rcfg.sharding)
        for p, (ax, rng) in pparams.tp_partial(shapes, mesh, rcfg).items():
            if rng is not None and mesh.index(ax) != 0:
                parts[p] = functools.partial(_around, *rng)
    layered = {p: p in stacked
               for p in stacked | set(ep) | set(fs) | set(tpc)}

    def gathered(kind, per_layer, paths, ax):
        """(ranks, sums) of each of ``paths`` from one all-gather."""
        local = torch.cat([per_layer[p] for p in paths])
        parts = mesh.all_gather(kind, local, ax).view(-1, local.numel())
        o, out = 0, {}
        for p in paths:
            n = per_layer[p].numel()
            out[p] = parts[:, o:o + n]
            o += n
        return out

    def complete(per_layer):
        out = dict(per_layer)
        for kind, cut in (("grad_norm_ep", ep), ("grad_norm_fsdp", fs),
                          ("grad_norm_tp", tpc)):
            for ax in sorted({a for axes in cut.values() for a in axes}):
                paths = [p for p in out if ax in cut.get(p, ())]
                out.update({p: v.sum(0) for p, v in gathered(
                    kind, out, paths, ax).items()})
        for ax in sorted(set(axis.values())):
            paths = [p for p in out if axis.get(p) == ax]
            out.update({p: v.reshape(-1) for p, v in gathered(
                "grad_norm", out, paths, ax).items()})
        return out

    return layered, complete, parts


def _around(lo: int, hi: int, x):
    """``x`` without its last dimension's range [lo, hi), in pieces."""
    return [x[..., :lo], x[..., hi:]]


def make_train_fn(rcfg: RunConfig, mesh=None):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics): :func:`make_grad_fn`'s gradients, then the optimizer, in
    place (:func:`repro_torch.optim.optimizers.apply_updates`). The
    gradient norm sums a trunk leaf layer by layer
    (:func:`norm_layers`), so every rank of ``mesh`` clips by the one-rank
    run's norm, bit for bit."""
    grad_step = make_grad_fn(rcfg, mesh)
    layers = norm_layers(rcfg, mesh)

    def train_step(params, opt_state, batch):
        lval, diag, grads = grad_step(params, batch)
        params, opt_state, om = optimizers.apply_updates(
            rcfg.optimizer, params, grads, opt_state, layers=layers)
        metrics = {"loss": lval, "fwd_norms": diag["fwd_norms"], **om}
        return params, opt_state, metrics

    return train_step


def shardings_for_train(rcfg: RunConfig, mesh, params_sds, opt_sds,
                        batch_sds):
    """The reference's train shardings as spec trees: params, the
    optimizer state (``m`` / ``v`` / ``master`` following params, the
    ``step`` replicated) and the batch."""
    from repro_torch.parallel import params as pparams
    ps = pparams.param_specs(params_sds, rcfg, mesh)
    os_ = {"step": ()}
    for k in ("m", "v", "master"):
        if k in opt_sds:
            os_[k] = ps
    return ps, os_, pparams.batch_specs(batch_sds, rcfg, mesh)


def shardings_for_decode(rcfg: RunConfig, mesh, params_sds, cache_sds):
    """The reference's decode shardings as spec trees: params, the dense
    decode cache, and the (batch, 1) token feed replicated."""
    from repro_torch.parallel import params as pparams
    return (pparams.param_specs(params_sds, rcfg, mesh),
            pparams.cache_specs(cache_sds, rcfg, mesh), (None, None))


def shard_decode_params(rcfg: RunConfig, mesh, params):
    """This rank's part of the whole ``params`` for
    :func:`make_serve_fn` ``(rcfg, mesh)``: the reference's param specs
    under ``rcfg.sharding`` executed as the serve engine executes them
    (Megatron tensor parallelism over the heads' axis, the experts where
    mapped, a Mamba mixer's per-row vectors cut with its rows), and the
    leaves the fsdp fallback storage-shards stored one slice a rank of
    its axis."""
    from repro_torch.parallel import params as pparams
    logical = pparams.serve_logical_axes_for
    specs = pparams.param_specs(params, rcfg, mesh, logical)
    return pparams.shard_tree(params, specs, mesh,
                              executed=pparams.DECODE_EXECUTED,
                              cfg=rcfg.model, logical=logical,
                              sharding=rcfg.sharding)[0]


def decode_fsdp_plan(rcfg: RunConfig, mesh):
    """The :class:`repro_torch.parallel.fsdp.Plan` of the leaves
    :func:`shard_decode_params` stores one slice a rank of (None where
    the rules cut none over an axis of more than one rank)."""
    from repro_torch.parallel import fsdp
    from repro_torch.parallel import params as pparams
    shapes = transformer.param_shapes(rcfg)
    specs = pparams.param_specs(shapes, rcfg, mesh,
                                pparams.serve_logical_axes_for)
    return fsdp.plan_of(pparams.fsdp_cut(shapes, specs, mesh,
                                         rcfg.sharding), mesh)


class SlotRows:
    """A mesh engine's slots and pages on this rank: its data group's
    contiguous range of the ``max_batch`` slots (``batch`` over
    ``data``) and of the ``pool_pages`` global page ids (``pages`` over
    the same axis), whose first page is the group's scratch page (page 0
    of the local pool). Without a data split every slot and page is
    local.

    ``local`` takes this rank's rows of a host slot array, ``table`` its
    rows of a page table in local page ids (global 0, the unmapped
    entry, stays the scratch page; an id outside the range raises, since
    no rank could read it), and ``gather`` puts the per-slot results of
    every data group back in slot order."""

    def __init__(self, mesh, sharding, max_batch: int, pool_pages: int):
        ax = tp.axis_of(mesh, sharding, "batch")
        if tp.axis_of(mesh, sharding, "pages") != ax:
            raise NotImplementedError(
                "the slots and the page pools split over different axes: "
                "a slot's pages must live on the rank that runs it")
        n = mesh.shape[ax] if ax else 1
        if max_batch % n or pool_pages % n:
            raise ValueError(f"max_batch {max_batch} and the pool's "
                             f"{pool_pages} pages must divide over the "
                             f"{n} data ranks")
        self.mesh, self.axis, self.n = mesh, ax, n
        self.index = r = mesh.index(ax) if ax else 0
        per = max_batch // n
        self.rows = slice(r * per, (r + 1) * per)
        self.span = pool_pages // n
        self.base = r * self.span

    def local(self, a):
        return np.asarray(a)[self.rows]

    def table(self, t):
        t = np.asarray(t)[self.rows]
        lo, hi = self.base, self.base + self.span
        mapped = np.not_equal(t, SCRATCH_PAGE)
        if np.any(mapped & ((t <= lo) | (t >= hi))):
            raise ValueError(f"a page table {np.asarray(t).tolist()} maps "
                             f"pages outside this rank's ({lo}, {hi})")
        return np.where(mapped, t - lo, SCRATCH_PAGE).astype(t.dtype)

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        if self.axis is None:
            return t
        return self.mesh.all_gather("dp_tokens", t, self.axis, dim=0)


def _mesh_io(rcfg: RunConfig, device, mesh, rows):
    """(upload of this rank's rows of a host slot array, of its page
    table, the tensor-parallel context of a call, the gather of its
    per-slot results): the whole batch and no context without a mesh."""
    up = _uploader(device)
    if mesh is None:
        return up, up, contextlib.nullcontext, lambda t: t

    def up_rows(a, dtype):
        return up(rows.local(a), dtype)

    def up_table(t, dtype):
        return up(rows.table(t), dtype)

    return (up_rows, up_table,
            functools.partial(tp.active, mesh, rcfg.sharding), rows.gather)


def make_prefill_fn(rcfg: RunConfig):
    """Returns prefill_step(params, batch) -> (next (B,) greedy tokens at
    the last position, logits (B, S, V)): the serial forward."""
    def prefill_step(params, batch):
        logits = transformer.prefill(params, batch, rcfg)
        return torch.argmax(logits[:, -1].float(), dim=-1), logits

    return prefill_step


def make_serve_fn(rcfg: RunConfig, mesh=None):
    """Dense greedy decode step: (params, cache, tokens (B, T)) -> (next
    (B, 1), cache), tokens and cache on one device. T > 1 chunk-prefills
    the prompt into the cache in one call (attention kinds). This is the
    serial-forward oracle the paged backends are held against, and the
    engine's dense comparison probe; production decode goes through
    :func:`make_paged_serve_fn` and a ``repro_torch.serve.cache``
    backend. The encoder-decoder family's step takes the encoder output
    too: (params, cache, tokens, xa).

    Under ``mesh`` (explicit SPMD, one process a rank, the rules
    ``rcfg.sharding``): ``params`` is this rank's part
    (:func:`shard_decode_params`, or a mesh engine's backend's), ``cache``
    its part (``transformer.init_cache(..., mesh=mesh)``), ``tokens`` and
    ``xa`` the whole batch; the rank runs its slots (the batch's axis)
    tensor-parallel, the cache cut along the sequence where ``kv_seq``
    maps, the fsdp-cut leaves gathered for each layer, and every rank
    returns the whole batch's next tokens (one all-gather over the
    batch's axis, ``dp_tokens``). A world-1 mesh runs the step without
    one, bit for bit."""
    if mesh is None:
        def step(params, cache, tokens, xa=None):
            return transformer.decode_step(params, cache, tokens, rcfg,
                                           xa=xa)
        rules = contextlib.nullcontext
    else:
        plan = decode_fsdp_plan(rcfg, mesh)
        rules = functools.partial(tp.active, mesh, rcfg.sharding)

        def step(params, cache, tokens, xa=None):
            rows = tp.split("batch", tokens.shape[0])
            if rows is not None:
                per = tokens.shape[0] // rows.n
                tokens = tokens[rows.r * per:(rows.r + 1) * per]
                if xa is not None:
                    xa = xa[rows.r * per:(rows.r + 1) * per]
            return transformer.decode_step(params, cache, tokens, rcfg,
                                           xa=xa, fsdp_plan=plan)

    def serve_step(params, cache, tokens, xa=None):
        with rules():
            logits, cache = step(params, cache, tokens, xa)
            nxt = torch.argmax(logits[:, -1].float(), dim=-1)[:, None]
            rows = None if mesh is None else \
                tp.split("batch", tokens.shape[0])
            if rows is not None:
                nxt = rows.all_gather("dp_tokens", nxt, 0)
        return nxt, cache

    if rcfg.model.family == "encdec":
        return serve_step
    return lambda params, cache, tokens: serve_step(params, cache, tokens)


def apply_top_k(logits, k):
    """Mask all but each row's k highest logits to -1e30. logits: (B, V);
    k: (B,) int, ``k <= 0`` (or ``>= V``) disables the row's filter.
    Ties at the k-th value are kept."""
    V = logits.shape[-1]
    srt = torch.sort(logits, dim=-1).values                 # ascending
    k = k.long()
    k_eff = torch.where(k <= 0, torch.full_like(k, V), k).clamp(1, V)
    kth = torch.gather(srt, 1, (V - k_eff)[:, None])
    return torch.where(logits < kth, torch.full_like(logits, _MASKED),
                       logits)


def apply_top_p(logits, p):
    """Nucleus mask: keep each row's smallest descending-probability set
    whose cumulative mass reaches p (the argmax always survives), mask
    the rest to -1e30. logits: (B, V); p: (B,) in (0, 1]."""
    srt, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    probs = torch.softmax(srt.float(), dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep = (cum - probs) < p.float()[:, None]   # mass before token < p
    keep[:, 0] = True
    masked_sorted = torch.where(keep, srt, torch.full_like(srt, _MASKED))
    return torch.zeros_like(logits).scatter_(1, idx, masked_sorted)


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


def temper_and_mask(lf, temps, top_ks, top_ps, *, fused: bool = False):
    """The sampled rows' target logits: (B, V) float32 logits scaled by
    temperature, then the top-k/top-p mask (``fused``: the sort-free
    threshold mask, the CUDA kernel on the card; else the sort)."""
    scaled = lf / torch.clamp(temps, min=1e-6)[:, None]
    if fused:
        return kops.topk_topp_mask(scaled, top_ks, top_ps)
    return apply_top_k_top_p(scaled, top_ks, top_ps)


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
    scaled = temper_and_mask(lf, temps, top_ks, top_ps, fused=fused)
    keys = prng.fold_in(prng.PRNGKey(seeds), counters)
    sampled = torch.argmax(scaled + prng.gumbel(keys, lf.shape[-1]), dim=-1)
    return torch.where(temps <= 0.0, greedy, sampled.to(torch.int32))


def make_paged_serve_fn(rcfg: RunConfig, decode_fn, fused: bool = False,
                        device=None, mesh=None, rows=None):
    """Paged-state step: one function serves both chunked prefill
    (S = prompt bucket) and steady-state decode (S = 1); slot occupancy
    is the ``n_new`` mask.

    ``decode_fn`` is the family's paged forward (e.g.
    ``transformer.paged_decode_step``), called as ``decode_fn(params,
    state, tokens, lengths, n_new, page_table, rcfg)``. The returned
    callable takes the host (numpy) slot arrays, uploads them to
    ``device``, runs the forward and the sampler, and returns (next
    (B, 1) int32 on the device, state).

    Under ``mesh`` (with ``rows``, this rank's :class:`SlotRows`) the
    forward runs tensor-parallel on this data rank's slots and local
    pools; each rank samples its slots' whole-vocab rows, and the tokens
    come back gathered over ``data``, the whole batch on every rank.
    """
    up, up_table, rules, gather = _mesh_io(rcfg, device, mesh, rows)

    def paged_serve_step(params, state, tokens, lengths, n_new, page_table,
                         temps, top_ks, top_ps, seeds, counters):
        # over every slot, this rank's or not: a greedy row samples
        # greedily either way
        any_sampled = bool(np.any(np.asarray(temps) > 0.0))
        with rules():
            # lengths and the table in int32: the attention kernel's types
            logits, state = decode_fn(
                params, state, up(tokens, torch.long),
                up(lengths, torch.int32), up(n_new, torch.long),
                up_table(page_table, torch.int32), rcfg)
        nxt = sample_tokens(logits, up(temps, torch.float32),
                            up(top_ks, torch.int32),
                            up(top_ps, torch.float32),
                            up(seeds, torch.long), up(counters, torch.long),
                            fused=fused, any_sampled=any_sampled)
        return gather(nxt[:, None]), state

    return paged_serve_step


def _uploader(device):
    def up(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device, dtype)
    return up


def _sampling_args(up, temps, top_ks, top_ps, seeds):
    return (up(temps, torch.float32), up(top_ks, torch.int32),
            up(top_ps, torch.float32), up(seeds, torch.long))


# ---------------------------------------------------------------------------
# Speculative decoding: draft sampling + acceptance (the paper's coarse
# propagator as a self-speculative draft, see repro_torch.serve.spec)
# ---------------------------------------------------------------------------


def draft_sample_tokens(logits, temps, top_ks, top_ps, seeds, counters, *,
                        any_sampled: bool):
    """Draft-side sampling: (B, V) logits -> (tokens (B,) int32, probs
    (B, V) float32), ``probs`` the draft's true proposal distribution
    (the verifier's rejection sampling needs q(d) and the whole q).

    Greedy slots propose the argmax with a one-hot q. Sampled slots draw
    from the temperature-scaled, top-k/top-p-masked (sort-based)
    distribution with the request's draft stream ``fold_in(fold_in(
    PRNGKey(seed), counter), 2)``, disjoint from the canonical stream
    (fold 0: acceptance uniforms and the bonus Gumbel; fold 1: the
    leftover Gumbel). ``any_sampled`` is the all-greedy skip, decided on
    the host."""
    lf = logits.float()
    V = lf.shape[-1]
    greedy = torch.argmax(lf, dim=-1)
    g_probs = torch.nn.functional.one_hot(greedy, V).float()
    if not any_sampled:
        return greedy.to(torch.int32), g_probs
    masked = temper_and_mask(lf, temps, top_ks, top_ps)
    probs = torch.softmax(masked, dim=-1)
    keys = prng.fold_in(prng.fold_in(prng.PRNGKey(seeds), counters), 2)
    samp = torch.argmax(masked + prng.gumbel(keys, V), dim=-1)
    greedy_row = temps <= 0.0
    tok = torch.where(greedy_row, greedy, samp)
    return (tok.to(torch.int32),
            torch.where(greedy_row[:, None], g_probs, probs))


def speculative_accept(logits, tokens, draft_probs, temps, top_ks, top_ps,
                       seeds, counters, n_new, *, any_sampled: bool):
    """Accept a drafted prefix against the fine model's own targets.

    logits: (B, S, V) fine logits over the verify window; tokens: (B, S)
    = [pending, d_1..d_k]; draft_probs: (B, k, V); n_new: (B,) = drafted
    count + 1 (0 = idle slot). Position i of the window is the request's
    emission index ``counters[b] + i``, so every draw is keyed exactly as
    plain decode keys it.

    Greedy slots accept the longest prefix where d_{i+1} equals the fine
    argmax: the emitted tokens are plain decode's. Sampled slots run
    speculative rejection sampling: accept d with probability min(1,
    p(d)/q(d)); at the first rejection draw from the normalized leftover
    max(p - q, 0); when every draft survives, draw the bonus token from p
    at the next position with plain decode's key. The emitted
    distribution is exactly p (Leviathan et al. 2023).

    Returns (accepted (B,) int32 in [0, n_new-1], next_token (B,) int32).
    """
    B, S, V = logits.shape
    k = S - 1
    dev = logits.device
    lf = logits.float()
    drafts = tokens[:, 1:].long()
    n_draft = torch.clamp(n_new.long() - 1, min=0)
    pos_ok = torch.arange(k, device=dev)[None, :] < n_draft[:, None]
    greedy_t = torch.argmax(lf, dim=-1)                           # (B, S)
    g_match = (drafts == greedy_t[:, :k]) & pos_ok
    g_acc = torch.cumprod(g_match.long(), dim=1).sum(dim=1)
    g_next = torch.gather(greedy_t, 1, g_acc[:, None])[:, 0]
    if not any_sampled:
        return g_acc.to(torch.int32), g_next.to(torch.int32)

    rows = torch.arange(B, device=dev)
    masked = temper_and_mask(
        lf.reshape(B * S, V), temps.repeat_interleave(S),
        top_ks.repeat_interleave(S),
        top_ps.repeat_interleave(S)).reshape(B, S, V)
    p = torch.softmax(masked, dim=-1)
    q = draft_probs.float()                                       # (B, k, V)
    keys = prng.fold_in(
        prng.PRNGKey(seeds)[:, None, :].expand(B, S, 2),
        counters.long()[:, None] + torch.arange(S, device=dev)[None, :])
    u = prng.uniform(keys[:, :k].reshape(B * k, 2), 1).reshape(B, k)
    p_d = torch.gather(p[:, :k], 2, drafts[..., None])[..., 0]
    q_d = torch.gather(q, 2, drafts[..., None])[..., 0]
    ok = (u < p_d / torch.clamp(q_d, min=1e-30)) & pos_ok
    j = torch.cumprod(ok.long(), dim=1).sum(dim=1)    # first rejection
    p_j = p[rows, j]
    q_j = torch.cat([q, q.new_zeros(B, 1, V)], dim=1)[rows, j]
    rejected = j < n_draft
    res = torch.clamp(p_j - q_j, min=0.0)
    rs = res.sum(dim=-1, keepdim=True)
    res = torch.where(rs > 0, res / torch.clamp(rs, min=1e-30), p_j)
    dist = torch.where(rejected[:, None], res, p_j)
    key_j = keys[rows, j]
    gkey = torch.where(rejected[:, None], prng.fold_in(key_j, 1), key_j)
    s_next = torch.argmax(torch.log(torch.clamp(dist, min=1e-30))
                          + prng.gumbel(gkey, V), dim=-1)
    sampled = temps > 0.0
    acc = torch.where(sampled, j, g_acc)
    nxt = torch.where(sampled, s_next, g_next)
    return acc.to(torch.int32), nxt.to(torch.int32)


def make_paged_verify_fn(rcfg: RunConfig, verify_fn, commit_fn=None,
                         device=None, mesh=None, rows=None):
    """Speculative verification: one occupancy-masked call of the full
    model over each slot's pending token + k drafted tokens, the
    per-position targets and the accepted prefix
    (:func:`speculative_accept`), then the state commit for exactly the
    accepted prefix.

    ``verify_fn`` is the family's verify forward
    (``transformer.{paged,ssm_paged,hybrid_paged}_verify_step``);
    ``commit_fn`` its deferred snapshot commit, or None where rollback is
    host-side length truncation (attention KV). The returned callable
    takes the verify tokens (B, k+1) and draft_probs (B, k, V) on the
    device and the host slot arrays, and returns (accepted (B,), next
    token (B,), state) — the tokens on the device, the pools updated in
    place. Under ``mesh`` the device inputs are this data rank's rows
    (:func:`make_draft_wave_fn`'s), and the two results come back
    gathered over ``data`` (:func:`make_paged_serve_fn`)."""
    up, up_table, rules, gather = _mesh_io(rcfg, device, mesh, rows)

    def paged_verify_step(params, state, tokens, lengths, n_new, page_table,
                          temps, top_ks, top_ps, seeds, counters,
                          draft_probs):
        # over every slot, this rank's or not: a greedy row samples
        # greedily either way
        any_sampled = bool(np.any(np.asarray(temps) > 0.0))
        lengths_d = up(lengths, torch.int32)
        n_new_d = up(n_new, torch.long)
        table = up_table(page_table, torch.int32)
        with rules():
            logits, state, art = verify_fn(params, state, tokens, lengths_d,
                                           n_new_d, table, rcfg)
        acc, nxt = speculative_accept(
            logits, tokens, draft_probs,
            *_sampling_args(up, temps, top_ks, top_ps, seeds),
            up(counters, torch.long), n_new_d, any_sampled=any_sampled)
        if commit_fn is not None:
            n_write = torch.where(n_new_d > 0,
                                  torch.minimum(acc.long() + 1, n_new_d), 0)
            state = commit_fn(state, art, table, lengths_d, n_write)
        return gather(acc), gather(nxt), state

    return paged_verify_step


def make_draft_wave_fn(rcfg: RunConfig, decode_fn, *, k: int, page_size: int,
                       snapshot_state: bool, device=None, mesh=None,
                       rows=None):
    """A whole draft wave of the coarse propagator: (1) the catch-up
    ingest (canonical tokens the draft has not cached yet plus the
    pending token, S = k+1 occupancy-masked), which commits true state
    and proposes d_1; (2) k-1 autoregressive speculative steps (a Python
    loop where the reference scans) proposing d_2..d_k. Slots stop at
    their own ``n_draft``, so near-finished requests never write past
    their pages.

    On snapshot backends the page holding the post-ingest state is saved
    before speculation and copied back (``index_copy_``) before
    returning, so the next wave's ingest resumes from true state (KV
    drafts skip this: rows beyond the committed length are masked and
    later overwritten). Returns (drafted (B, k) int32, draft_probs
    (B, k, V), state), on the device. Under ``mesh`` the wave runs
    tensor-parallel on this data rank's slots (``rows``, in the draft
    pool's page ids) and returns this rank's rows only: the verify call
    consumes them where they are."""
    up = _uploader(device)
    rules = contextlib.nullcontext if mesh is None else \
        functools.partial(tp.active, mesh, rcfg.sharding)

    def draft_wave(params, state, tokens, lengths, n_in, page_table,
                   temps, top_ks, top_ps, seeds, counters, n_draft):
        if mesh is not None:
            page_table = rows.table(page_table)
            tokens, lengths, n_in, temps, top_ks, top_ps, seeds, \
                counters, n_draft = map(rows.local, (
                    tokens, lengths, n_in, temps, top_ks, top_ps, seeds,
                    counters, n_draft))
        any_sampled = bool(np.any(np.asarray(temps) > 0.0))
        samp = _sampling_args(up, temps, top_ks, top_ps, seeds)
        counters_d = up(counters, torch.long)
        table = up(page_table, torch.int32)
        with rules():
            logits, state = decode_fn(params, state, up(tokens, torch.long),
                                      up(lengths, torch.int32),
                                      up(n_in, torch.long), table, rcfg)
        tok, probs = draft_sample_tokens(logits, *samp, counters_d,
                                         any_sampled=any_sampled)
        committed = np.asarray(lengths) + np.asarray(n_in)
        if snapshot_state:
            P = page_table.shape[1]
            slot = np.clip((committed - 1) // page_size, 0, P - 1)
            part = up(np.asarray(page_table)[np.arange(len(slot)), slot],
                      torch.long)
            saved = [leaf[:, part] for leaf in state_leaves(state)]
        toks, qs = [tok], [probs]
        ln = committed
        for i in range(k - 1):
            live = ((np.asarray(n_in) > 0)
                    & (np.asarray(n_draft) >= i + 2)).astype(np.int32)
            with rules():
                lg, state = decode_fn(params, state,
                                      toks[-1][:, None].long(),
                                      up(ln, torch.int32),
                                      up(live, torch.long), table, rcfg)
            t2, p2 = draft_sample_tokens(lg, *samp, counters_d + i + 1,
                                         any_sampled=any_sampled)
            toks.append(t2)
            qs.append(p2)
            ln = ln + live
        if snapshot_state:
            for leaf, s in zip(state_leaves(state), saved, strict=True):
                leaf.index_copy_(1, part, s)
        return torch.stack(toks, dim=1), torch.stack(qs, dim=1), state

    return draft_wave
