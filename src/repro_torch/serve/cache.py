"""``CacheBackend`` API — the decode-state protocol of the serve engine.

Port of :mod:`repro.serve.cache`: attention decoders
(:class:`PagedKVBackend`), the ssm family (:class:`SSMStateBackend`) and
the hybrid family (:class:`HybridBackend`). The scheduler and engine
never mention model families; they talk to a backend, which owns

  device half  ``init(max_batch, n_pages) -> state`` (the page pools on
               the backend's device) and the occupancy-masked step —
               ``prefill(state, slots, tokens)`` (S = prompt bucket) and
               ``step(state, slots, tokens)`` (S = 1), both returning
               ``(state, next_tokens)`` with per-request sampling applied;
  host half    the page ops ``alloc_view / share / fork / release`` over a
               refcounted :class:`~repro_torch.serve.kv_pages.PageAllocator`.

Speculative decoding's device half is here too: ``verify`` (the fine
model over a drafted window, acceptance, the commit of the accepted
prefix), ``coarse_draft`` and ``init_draft_state``
(:mod:`repro_torch.serve.spec`).

The pools are updated in place, where the JAX package donates them to a
jitted call: every method that takes ``state`` returns the same tensors.

Under a mesh (:class:`repro_torch.launch.mesh.Mesh`, one process a rank,
the reference's ``serve_sharding`` rules by default) the backend runs
explicit SPMD: its weights are cut Megatron-style over ``model`` (heads,
KV heads, MLP and SSM inner dims, vocab; :func:`repro_torch.parallel.
params.shard_tree`), its pools hold this rank's heads or rows and this
data rank's range of the pages (:meth:`pool_pages` rounds the pool so
that the ranges are equal), and its calls run on this data rank's slots
(:class:`repro_torch.launch.steps.SlotRows`), the tokens gathered back
over ``data``. The host half takes global page ids as before; the
device copies of a fork, a spill and a restore touch the pages this
rank holds. The MoE family's experts run their ``d_ff`` over ``model``
and, where the rules map ``experts`` (to the slots' axis), each data
rank holds its E/n experts and exchanges the rows of its slots with the
others (:mod:`repro_torch.models.moe`). The prefix cache's contents
are read and written through the backend (:meth:`CacheBackend.
page_contents` / :meth:`CacheBackend.write_page_contents`), whole heads
and global pages, so that a file saved on any mesh loads on any other.
Not under a mesh: the encoder-decoder family, and rules beyond
``serve_sharding``'s axes (``kv_seq`` and ``fsdp`` run only through the
dense step, :func:`repro_torch.launch.steps.make_serve_fn`).
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import RunConfig
from repro_torch.configs.registry import serve_sharding
from repro_torch.device import resolve_device
from repro_torch.launch import steps as steps_mod
from repro_torch.models import attention as attn_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import transformer
from repro_torch.models.blocks import block_kind
from repro_torch.obs import profile as obs_profile
from repro_torch.parallel import params as pparams
from repro_torch.parallel import tp
from repro_torch.serve.kv_pages import (PageAllocator, _from_numpy,
                                        _to_numpy, read_pages, state_leaves,
                                        write_pages)
from repro_torch.tree import leaf_at, leaves_with_paths, unflatten

MESH_KV_SEQ = ("the paged engine executes serve_sharding's axes only: rules "
               "that split kv_seq or store leaves over fsdp (decode_sharding)"
               " run through the dense step, launch.steps.make_serve_fn("
               "rcfg, mesh); ROADMAP Queue 1, the paged engine under rules "
               "beyond serve_sharding")


@dataclasses.dataclass
class SlotBatch:
    """Host-side view of the decode slots for one step: decode
    coordinates (per-slot position, occupancy, page mapping) plus the
    vectorized per-request sampling parameters."""
    lengths: np.ndarray        # (B,)   cached tokens per slot
    n_new: np.ndarray          # (B,)   new tokens this call (0 = idle slot)
    page_table: np.ndarray     # (B, P) physical page ids (0 = scratch)
    temps: np.ndarray          # (B,)   0 = exact greedy argmax path
    top_ks: np.ndarray         # (B,)   0 disables
    top_ps: np.ndarray         # (B,)   1 disables
    seeds: np.ndarray          # (B,)   per-request PRNG stream
    counters: np.ndarray       # (B,)   tokens already emitted

    @classmethod
    def greedy(cls, batch: int, page_table, lengths=None, n_new=None):
        """All-greedy slots (probes, tests)."""
        return cls(
            lengths=np.zeros((batch,), np.int32) if lengths is None
            else np.asarray(lengths, np.int32),
            n_new=np.ones((batch,), np.int32) if n_new is None
            else np.asarray(n_new, np.int32),
            page_table=np.asarray(page_table, np.int32),
            temps=np.zeros((batch,), np.float32),
            top_ks=np.zeros((batch,), np.int32),
            top_ps=np.ones((batch,), np.float32),
            seeds=np.zeros((batch,), np.int32),
            counters=np.zeros((batch,), np.int32))


def copy_state_page(state, src: int, dst: int):
    """Copy-on-write fork, device half: duplicate physical page ``src``
    into ``dst`` across every pool leaf (page axis 1 by convention), in
    place. The host half is ``PageAllocator.fork`` via
    :meth:`CacheBackend.fork`."""
    for leaf in state_leaves(state):
        leaf[:, dst] = leaf[:, src]
    return state


class CacheBackend:
    """Base backend: subclasses set ``snapshot_state`` and implement
    ``init_state`` (device pools) + ``_decode_fn`` (the family's paged
    forward, signature of ``transformer.paged_decode_step``).

    Args:
        rcfg: the model's RunConfig.
        params: model weights (the port's tree, any device). The backend
            keeps its own copy on ``device`` with the matmul weights in
            the compute dtype (:func:`transformer.serving_params`).
        page_size: tokens per KV page.
        fused: route decode/prefill through the paged kernels
            (:mod:`repro_torch.kernels.ops`: the CUDA kernels on the card,
            their plain versions on the CPU) with the page table sliced to
            the live-page bucket, and the sort-free sampling mask. False
            runs the gathered dense-view attention and the sort-based
            mask.
        obs: optional :class:`repro_torch.obs.Observability` bundle
            (profiler spans; its compile counters stay empty).
        device: where the pools and weights live; None means ``cuda``
            (raises without a CUDA device), ``"cpu"`` runs the plain
            versions. Under a mesh it must be the mesh's device type:
            an NCCL mesh serves on ``cuda:<current device>``, a gloo mesh
            needs ``"cpu"``.
        mesh: a ("data", "model") :class:`repro_torch.launch.mesh.Mesh`
            over every rank (each rank builds the same backend from the
            same whole ``params``); None serves on one device.
        sharding: the ``ShardingConfig`` under the mesh; None means
            :func:`repro_torch.configs.registry.serve_sharding`.
    """

    #: pages are state snapshots (SSM/hybrid): no intra-wave sharing, no
    #: tail forks on full-prompt prefix hits, no ``fork_partial``
    snapshot_state = False

    def __init__(self, rcfg: RunConfig, params, mesh=None,
                 page_size: int = 16, sharding=None, fused: bool = True,
                 obs=None, device=None):
        self.device = resolve_device(device)
        if self.device.type == "meta":
            raise ValueError("the serve engine reads tokens back: it runs "
                             "on cuda or cpu, not meta")
        self.mesh = mesh
        self.rows: Optional[steps_mod.SlotRows] = None   # set by init
        if mesh is not None:
            rcfg = rcfg.replace(sharding=sharding or serve_sharding())
            params = self._shard_params(rcfg, params)
        elif sharding is not None:
            rcfg = rcfg.replace(sharding=sharding)
        self.rcfg = rcfg
        self.params = transformer.serving_params(
            _to_device(params, self.device), rcfg.model)
        self.page_size = page_size
        self.fused = fused
        self.alloc: Optional[PageAllocator] = None
        self.compile_counts = obs.compile_counts if obs is not None \
            else {}
        self._span = obs.span if obs is not None \
            else obs_profile.span_factory(False)
        self._step_fn = None if mesh is not None else \
            steps_mod.make_paged_serve_fn(rcfg, self._decode_fn(),
                                          fused=fused, device=self.device)
        self._verify_fn = None          # built on first use (spec only)

    def _shard_params(self, rcfg: RunConfig, params):
        """Checks the mesh against the device and the family, and cuts
        the whole ``params`` to this rank's part, once: the reference's
        ``param_specs`` executed over ``data`` and ``model``, a Mamba
        mixer's per-row vectors cut with its rows
        (``serve_logical_axes_for``). The model code reads the leaves
        as they are."""
        mesh = self.mesh
        if mesh.device_type != self.device.type:
            raise ValueError(f"the mesh is on {mesh.device_type}, the "
                             f"engine on {self.device.type}: an NCCL mesh "
                             "serves on cuda, a gloo mesh needs "
                             "device='cpu'")
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        if rcfg.sharding.kv_seq is not None or rcfg.sharding.fsdp is not None:
            raise NotImplementedError(MESH_KV_SEQ)
        axes = {tp.axis_of(mesh, rcfg.sharding, a)
                for a in ("heads", "kv_heads", "mlp", "vocab")} - {None}
        if len(axes) > 1:
            raise NotImplementedError(
                f"heads, KV heads, mlp and vocab split over different axes "
                f"{axes}")
        logical = pparams.serve_logical_axes_for
        specs = pparams.param_specs(params, rcfg, mesh, logical)
        return pparams.shard_tree(params, specs, mesh,
                                  executed=pparams.SERVE_EXECUTED,
                                  cfg=rcfg.model, logical=logical)[0]

    def _rules(self):
        """The tensor-parallel context of this backend's model code."""
        if self.mesh is None:
            return contextlib.nullcontext()
        return tp.active(self.mesh, self.rcfg.sharding)

    # -- device half --------------------------------------------------------

    def _decode_fn(self):
        raise NotImplementedError

    def init_state(self, n_pages: int):
        """Fresh device page pools (no allocator) — probes and tests use
        this for scratch state. Under a mesh this rank's part of a pool
        of ``n_pages`` pages: its heads or rows (:meth:`_init_pools`
        under the tensor-parallel rules), its data range of the pages."""
        with self._rules():
            return self._init_pools(self._local_pages(n_pages))

    def _init_pools(self, n_pages: int, device=None):
        raise NotImplementedError

    def shard_state(self, state):
        """This rank's part of a whole page-pool state tree (pages over
        'data', head / inner dims over 'model': ``paged_state_specs``;
        KV heads the spec keeps whole narrowed to the one this rank's
        query heads read, as :meth:`init_state` holds them); identity
        without a mesh."""
        if self.mesh is None:
            return state
        cfg = self.rcfg.model
        specs = pparams.paged_state_specs(state, self.rcfg, self.mesh)
        local, _ = pparams.shard_tree(
            state, specs, self.mesh, executed=pparams.SERVE_EXECUTED,
            cfg=cfg, logical=pparams.pool_logical)
        with self._rules():
            sq, kv = attn_mod.kv_split(cfg)
            whole_kv = sq is not None and not tp.split("kv_heads",
                                                       cfg.n_kv_heads)
        if whole_kv:            # the KV head this rank's query heads read
            local = unflatten(
                (p, t[..., kv[0]:kv[1], :].clone() if p[-1] in ("k", "v")
                 else t) for p, t in leaves_with_paths(local))
        return local

    def _data_ranks(self) -> int:
        """The data ranks the page pools split over (1 without)."""
        ax = tp.axis_of(self.mesh, self.rcfg.sharding, "pages") \
            if self.mesh is not None else None
        return self.mesh.shape[ax] if ax else 1

    def pool_pages(self, n_pages: int) -> int:
        """Round a pool size up so the physical-page axis divides its
        mesh axis (the reference's rounding): an indivisible size would
        keep every page on every rank. Identity without a mesh (or with
        'pages' unmapped); the extra pages are ordinary capacity."""
        size = self._data_ranks()
        return -(-n_pages // size) * size

    def _local_pages(self, n_pages: int) -> int:
        size = self._data_ranks()
        if n_pages % size:
            raise ValueError(f"{n_pages} pages do not divide over {size} "
                             "data ranks (pool_pages rounds them)")
        return n_pages // size

    def init(self, max_batch: int, n_pages: int):
        """Set up the host allocator and return the device state.
        ``n_pages`` includes scratch page 0; under a mesh it must divide
        over the data ranks (:meth:`pool_pages`), and each data rank
        holds its range, with its own scratch page, and its
        ``max_batch`` share of the slots."""
        if self.mesh is None:
            self.alloc = PageAllocator(n_pages)
            return self.init_state(n_pages)
        self.rows = steps_mod.SlotRows(self.mesh, self.rcfg.sharding,
                                       max_batch, n_pages)
        self.alloc = PageAllocator(n_pages, groups=self.rows.n)
        self._step_fn = steps_mod.make_paged_serve_fn(
            self.rcfg, self._decode_fn(), fused=self.fused,
            device=self.device, mesh=self.mesh, rows=self.rows)
        return self.init_state(n_pages)

    def agree(self, values):
        """Rank 0's ``values`` (floats) on every rank of a mesh of more
        than one rank (one broadcast), for the host decisions that read
        the clock; None without one (nothing to agree on)."""
        if self.mesh is None or self.mesh.size == 1:
            return None
        t = torch.tensor(values, dtype=torch.float64,
                         device=self.device)
        return self.mesh.broadcast("clock", t, None, 0).tolist()

    def host_rows(self, t: torch.Tensor) -> np.ndarray:
        """Per-slot device results of this data rank's slots (a draft
        window) as the whole batch on the host."""
        if self.rows is not None:
            t = self.rows.gather(t)
        return t.cpu().numpy()

    def _table_view(self, slots: SlotBatch):
        """The page-table columns this call needs. Unfused backends keep
        the full width; fused backends slice to the power-of-two bucket
        covering ``max(lengths + n_new)`` — masked-out key slots
        contribute exactly-zero softmax mass, so truncating dead columns
        leaves every output unchanged while the kernel (or the plain
        gather on the CPU) only touches live pages."""
        table = slots.page_table
        if not self.fused:
            return table
        P = table.shape[1]
        need = int(np.max(slots.lengths + slots.n_new, initial=1))
        p_eff = 1 << (max(-(-need // self.page_size), 1) - 1).bit_length()
        return table[:, :min(P, p_eff)]

    def _apply(self, state, slots: SlotBatch, tokens,
               label: str = "serve.step"):
        with self._span(label):
            nxt, state = self._step_fn(
                self.params, state, np.asarray(tokens, np.int32),
                slots.lengths, slots.n_new, self._table_view(slots),
                slots.temps, slots.top_ks, slots.top_ps, slots.seeds,
                slots.counters)
            nxt = nxt.cpu().numpy()          # the host needs the tokens
        return state, nxt

    def prefill(self, state, slots: SlotBatch, tokens):
        """Chunked prefill: tokens (B, S) with per-slot occupancy in
        ``slots.n_new``; returns (state, first sampled token (B, 1))."""
        return self._apply(state, slots, tokens, "serve.prefill")

    def step(self, state, slots: SlotBatch, tokens):
        """Steady-state decode: tokens (B, 1); returns (state, next
        (B, 1)). The same step as prefill at S == 1."""
        return self._apply(state, slots, tokens, "serve.decode")

    # -- device half: speculative decoding ----------------------------------

    def _verify_fns(self):
        """(verify forward, deferred commit or None) for this family: the
        two halves :func:`repro_torch.launch.steps.make_paged_verify_fn`
        joins into the verify call."""
        raise NotImplementedError(
            f"{type(self).__name__} does not support speculative decoding")

    def verify(self, state, slots: SlotBatch, tokens, draft_probs):
        """Multi-token speculative verification: tokens (B, k+1) =
        [pending, d_1..d_k] per slot on the device, with ``slots.n_new``
        real entries (0 = idle); draft_probs (B, k, V) the drafts'
        proposal distributions. One occupancy-masked call scores every
        position with the full model, accepts the longest valid prefix
        (greedy: exact match, so plain decode's tokens; sampled:
        rejection sampling with leftover redraws) and commits state for
        exactly the accepted prefix (KV: rows beyond ``lengths`` stay
        masked; snapshot pools: the deferred commit never writes the
        rejected suffix). Returns (state, accepted (B,), next_token (B,))
        as host arrays; the host advances each slot by ``accepted + 1``
        tokens. Under a mesh ``tokens`` and ``draft_probs`` are this data
        rank's rows (the draft wave's) and the results the whole
        batch."""
        if self._verify_fn is None:
            self._verify_fn = steps_mod.make_paged_verify_fn(
                self.rcfg, *self._verify_fns(), device=self.device,
                mesh=self.mesh, rows=self.rows)
        with self._span("serve.verify"):
            acc, nxt, state = self._verify_fn(
                self.params, state, tokens, slots.lengths, slots.n_new,
                self._table_view(slots), slots.temps, slots.top_ks,
                slots.top_ps, slots.seeds, slots.counters, draft_probs)
            acc, nxt = acc.cpu().numpy(), nxt.cpu().numpy()
        return state, acc, nxt

    def coarse_draft(self, cf: int):
        """(draft_params, draft_rcfg, n_coarse): the paper's coarse
        propagator over this backend's weights (every cf-th layer, ODE
        step rescaled); see ``transformer.coarse_draft_params``."""
        return transformer.coarse_draft_params(self.params, self.rcfg, cf)

    def init_draft_state(self, draft_rcfg: RunConfig, n_layers: int,
                         n_pages: int):
        """Fresh page pools for a coarse-depth twin of this backend's
        state (the draft's private, allocator-free pool); under a mesh
        this rank's part, as :meth:`init_state`."""
        with self._rules():
            return self._init_draft_pools(draft_rcfg, n_layers,
                                          self._local_pages(n_pages))

    def _init_draft_pools(self, draft_rcfg: RunConfig, n_layers: int,
                          n_pages: int):
        raise NotImplementedError

    # -- host half: page ops ------------------------------------------------
    # Refcount lifecycle: alloc_view -> 1 per page, share -> +1, release
    # -> -1 (the LAST release returns the page to the pool; releasing at 0
    # raises). Invariant the scheduler upholds: any page inside a slot's
    # write range [lengths, lengths + n_new) is private (refcount 1) when
    # the step launches — fork() first if other readers remain.

    def alloc_view(self, n: int, group: int = 0):
        """n private pages (refcount 1 each) of page ``group`` (a data
        rank's range; the only one without a data split) or None when
        the pool can't serve them right now."""
        return self.alloc.alloc(n, group)

    def share(self, pages):
        """Map already-written pages read-only into another view."""
        self.alloc.share(pages)

    def release(self, pages):
        """Drop one reference per page; the last reference frees it."""
        self.alloc.free(pages)

    def fork(self, state, page: int):
        """Copy-on-write detach: returns (state, private page id) — the
        same id if ``page`` had one reader, a device-copied fresh page
        otherwise, or (state, None) when the pool is empty."""
        dst = self.alloc.fork(page)
        if dst is None or dst == page:
            return state, dst
        return self._copy_page(state, page, dst), dst

    def fork_partial(self, state, page: int, n_valid: int):
        """Token-granular copy-on-write: copy ``page`` into a fresh
        private page whose first ``n_valid`` tokens the caller reuses
        (``1 <= n_valid < page_size``). The whole page is copied; entries
        beyond ``n_valid`` are stale but invisible (overwritten before
        any position attends to them). ``page`` keeps all its
        references. Returns (state, fresh page id) or (state, None)."""
        if not 1 <= n_valid < self.page_size:
            raise ValueError(
                f"fork_partial n_valid={n_valid} outside [1, "
                f"{self.page_size}): a 0-token copy is pointless and a "
                f"full-page copy is fork()'s job")
        if self.snapshot_state:
            raise ValueError("fork_partial on a snapshot-state backend")
        dst = self.alloc.fork_partial(page)
        if dst is None:
            return state, None
        return self._copy_page(state, page, dst), dst

    def _local_ids(self, pages):
        """``pages`` (global ids of one data rank's range) in this rank's
        pool ids, or None where another data rank holds them."""
        pages = np.asarray(pages, np.int64)
        if self.rows is None:
            return pages
        if not pages.size or self.alloc.group_of(int(pages[0])) \
                != self.rows.index:
            return None
        return pages - self.rows.base

    def _copy_page(self, state, src: int, dst: int):
        """The device half of a fork (both pages in one data rank's
        range: a fork stays in its source's range)."""
        ids = self._local_ids([src, dst])
        return state if ids is None else \
            copy_state_page(state, int(ids[0]), int(ids[1]))

    # -- preemption: spill / restore ----------------------------------------

    def spill(self, state, pages):
        """Read the given physical pages out of every pool leaf into host
        memory; returns the ``restore`` payload (one host tensor per
        leaf, :func:`state_leaves` order). Under a mesh the data rank
        holding the pages sends its part to the other data ranks, so the
        request may resume in any rank's slots."""
        ids = self._local_ids(pages)
        out = []
        for leaf in state_leaves(state):
            if ids is not None:
                part = leaf[:, torch.as_tensor(ids, device=leaf.device)]
            else:
                part = leaf.new_empty((leaf.shape[0], len(pages),
                                       *leaf.shape[2:]))
            if self.rows is not None and self.rows.n > 1:
                part = self.rows.mesh.broadcast(
                    "spill", part.contiguous(), self.rows.axis,
                    self.alloc.group_of(int(pages[0])))
            out.append(part.cpu())
        return out

    def restore(self, state, pages, leaves):
        """Scatter spilled page contents into ``pages`` (freshly
        allocated ids, same order/count as the ``spill`` call), in place
        and bit-identically (on the data rank holding them). Returns the
        state."""
        ids = self._local_ids(pages)
        if ids is None:
            return state
        for leaf, d in zip(state_leaves(state), leaves, strict=True):
            idx = torch.as_tensor(ids, device=leaf.device)
            leaf[:, idx] = d.to(leaf.device, leaf.dtype)
        return state

    # -- prefix-cache persistence: whole pages on the host ----------------

    def _narrow_kv(self):
        """The split of the query heads where each rank's KV pools hold
        only the one KV head its query heads read (the spec keeps them
        whole), else None."""
        with self._rules():
            return attn_mod.narrow_kv_split(self.rcfg.model)

    def _page_specs(self, state):
        """(key path, spec with the page axis whole) of each pool leaf in
        :func:`state_leaves` order: the tensor-parallel cut of the
        pages' contents."""
        whole = self._init_pools(self.alloc.n_pages, torch.device("meta"))
        specs = pparams.paged_state_specs(whole, self.rcfg, self.mesh)
        paths = _state_paths(state)
        return [(p, tuple(None if d == 1 else a for d, a in enumerate(
            leaf_at(specs, p)))) for p in paths]

    def page_contents(self, state, pages):
        """The contents of the global ``pages`` in every pool leaf, one
        host array a leaf (:func:`~repro_torch.serve.kv_pages.
        state_leaves` order, page axis 1), whole: every KV head, every SSM
        row. Under a mesh every rank calls it and gets the same arrays:
        each data rank gives the pages of its range (one all-gather over
        ``data``, ``prefix_io``) and each model rank its heads or rows."""
        if self.mesh is None:
            return read_pages(state, pages)
        pages = np.asarray(pages, np.int64)
        rows, mesh, cfg = self.rows, self.mesh, self.rcfg.model
        owner = np.asarray([self.alloc.group_of(int(p)) for p in pages],
                           np.int64)
        mine = np.nonzero(owner == rows.index)[0]
        narrow = self._narrow_kv()
        out = []
        for (path, spec), leaf in zip(self._page_specs(state),
                                      state_leaves(state), strict=True):
            part = leaf.new_zeros((leaf.shape[0], len(pages),
                                   *leaf.shape[2:]))
            part[:, torch.as_tensor(mine, device=leaf.device)] = leaf[
                :, torch.as_tensor(pages[mine] - rows.base,
                                   device=leaf.device)]
            if rows.n > 1:
                every = mesh.all_gather("prefix_io", part[None], rows.axis)
                part = every[torch.as_tensor(owner, device=leaf.device), :,
                             torch.arange(len(pages), device=leaf.device)
                             ].movedim(0, 1)
            if narrow is not None and path[-1] in ("k", "v"):
                part = attn_mod.gather_narrow_kv(mesh, "prefix_io", part,
                                                 narrow, cfg.n_kv_heads)
            else:
                part = pparams.gather_leaf(
                    part, path, spec, mesh, "prefix_io",
                    executed=pparams.SERVE_EXECUTED, cfg=cfg,
                    logical=pparams.pool_logical)
            out.append(_to_numpy(part))
        return out

    def write_page_contents(self, state, pages, arrays):
        """The inverse of :meth:`page_contents`: whole ``arrays`` (one a
        leaf) written into the global ``pages``, in place; under a mesh
        each rank writes the pages of its data range, its own heads or
        rows of them, and nothing else."""
        if self.mesh is None:
            write_pages(state, pages, arrays)
            return state
        pages = np.asarray(pages, np.int64)
        rows, cfg = self.rows, self.rcfg.model
        mine = np.nonzero(np.asarray([self.alloc.group_of(int(p))
                                      for p in pages]) == rows.index)[0]
        if not mine.size:
            return state
        kv = None
        if self._narrow_kv() is not None:
            with self._rules():
                kv = attn_mod.kv_split(cfg)[1]
        for (path, spec), leaf, a in zip(self._page_specs(state),
                                         state_leaves(state), arrays,
                                         strict=True):
            whole = _from_numpy(a[:, mine], leaf)
            if kv is not None and path[-1] in ("k", "v"):
                local = whole[:, :, :, kv[0]:kv[1]]
            else:
                local = pparams.local_slice(
                    whole, path, spec, self.mesh,
                    executed=pparams.SERVE_EXECUTED, cfg=cfg,
                    logical=pparams.pool_logical)
            leaf[:, torch.as_tensor(pages[mine] - rows.base,
                                    device=leaf.device)] = local
        return state

    def page_nbytes(self, state) -> int:
        """Bytes one physical page occupies across every pool leaf (this
        rank's part of it under a mesh)."""
        return sum(leaf.element_size() * leaf.numel() // leaf.shape[1]
                   for leaf in state_leaves(state))


def _state_paths(state, prefix=()):
    """Key paths of a state tree's leaves in :func:`state_leaves`
    order."""
    if isinstance(state, dict):
        return [p for k in sorted(state)
                for p in _state_paths(state[k], prefix + (k,))]
    return [prefix]


def _to_device(tree, device):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


class PagedKVBackend(CacheBackend):
    """Attention decoders (attn_mlp / attn_moe): block/paged KV cache."""

    snapshot_state = False

    def _decode_fn(self):
        return functools.partial(transformer.paged_decode_step,
                                 fused=self.fused)

    def _init_pools(self, n_pages: int, device=None):
        return transformer.init_paged_cache(self.rcfg, n_pages,
                                            self.page_size,
                                            device=device or self.device)

    def _verify_fns(self):
        # rollback = truncate lengths: stale KV beyond them is masked
        return (functools.partial(transformer.paged_verify_step,
                                  fused=self.fused),
                None)

    def _init_draft_pools(self, draft_rcfg: RunConfig, n_layers: int,
                          n_pages: int):
        return attn_mod.init_paged_kv_cache(
            draft_rcfg.model, n_layers, n_pages, self.page_size,
            device=self.device)


class SSMStateBackend(CacheBackend):
    """Mamba1/mamba2 models: recurrent state as snapshot pages."""

    snapshot_state = True

    def _decode_fn(self):
        return functools.partial(transformer.ssm_paged_decode_step,
                                 page_size=self.page_size,
                                 fused=self.fused)

    def _init_pools(self, n_pages: int, device=None):
        return transformer.init_paged_ssm_cache(self.rcfg, n_pages,
                                                device=device or self.device)

    def _verify_fns(self):
        # rollback = the deferred commit publishes the accepted prefix only
        return (functools.partial(transformer.ssm_paged_verify_step,
                                  page_size=self.page_size,
                                  fused=self.fused),
                functools.partial(transformer.ssm_paged_commit_step,
                                  page_size=self.page_size))

    def _init_draft_pools(self, draft_rcfg: RunConfig, n_layers: int,
                          n_pages: int):
        cfg = draft_rcfg.model
        return ssm_mod.init_paged_ssm_pool(cfg, n_layers, n_pages,
                                           cfg.ssm.version,
                                           device=self.device)


class HybridBackend(CacheBackend):
    """Hybrid (zamba2): mamba2 snapshot pools + shared-attention KV pools
    composed per block kind, one page table for both."""

    snapshot_state = True

    def _decode_fn(self):
        return functools.partial(transformer.hybrid_paged_decode_step,
                                 page_size=self.page_size,
                                 fused=self.fused)

    def _init_pools(self, n_pages: int, device=None):
        return transformer.init_paged_hybrid_cache(
            self.rcfg, n_pages, self.page_size,
            device=device or self.device)

    def _verify_fns(self):
        return (functools.partial(transformer.hybrid_paged_verify_step,
                                  page_size=self.page_size,
                                  fused=self.fused),
                functools.partial(transformer.hybrid_paged_commit_step,
                                  page_size=self.page_size))

    def _init_draft_pools(self, draft_rcfg: RunConfig, n_layers: int,
                          n_pages: int):
        # draft_rcfg carries the coarse n_layers / attention cadence
        return transformer.init_paged_hybrid_cache(
            draft_rcfg, n_pages, self.page_size, device=self.device)


def make_backend(rcfg: RunConfig, params, mesh=None, page_size: int = 16,
                 sharding=None, fused: bool = True, obs=None,
                 device=None) -> CacheBackend:
    """The only family dispatch in the serve stack."""
    cfg = rcfg.model
    kind = block_kind(cfg)
    if cfg.family == "decoder" and kind in ("attn_mlp", "attn_moe"):
        return PagedKVBackend(rcfg, params, mesh, page_size, sharding,
                              fused, obs, device)
    if cfg.family == "ssm" and kind in ("mamba1", "mamba2"):
        return SSMStateBackend(rcfg, params, mesh, page_size, sharding,
                               fused, obs, device)
    if cfg.family == "hybrid":
        return HybridBackend(rcfg, params, mesh, page_size, sharding,
                             fused, obs, device)
    raise NotImplementedError(
        f"no CacheBackend for family={cfg.family!r} (kind={kind!r}): "
        "encoder models have no autoregressive decode, and encdec needs "
        "per-request encoder state — use transformer.decode_step "
        "directly")
