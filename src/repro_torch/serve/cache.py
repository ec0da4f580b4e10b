"""``CacheBackend`` API — the decode-state protocol of the serve engine.

Port of :mod:`repro.serve.cache` for attention decoders
(:class:`PagedKVBackend`). The scheduler and engine never mention model
families; they talk to a backend, which owns

  device half  ``init(max_batch, n_pages) -> state`` (the page pools on
               the backend's device) and the occupancy-masked step —
               ``prefill(state, slots, tokens)`` (S = prompt bucket) and
               ``step(state, slots, tokens)`` (S = 1), both returning
               ``(state, next_tokens)`` with per-request sampling applied;
  host half    the page ops ``alloc_view / share / fork / release`` over a
               refcounted :class:`~repro_torch.serve.kv_pages.PageAllocator`.

The pools are updated in place, where the JAX package donates them to a
jitted call: every method that takes ``state`` returns the same tensors.
Not ported: meshes (one card; multi-device is the last slice),
speculative decoding (``verify`` / ``coarse_draft``, a later slice), and
the SSM / hybrid backends (the SSM slice). Without a mesh the
reference's ``shard_state`` / ``pool_pages`` are identities, so callers
skip them.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import RunConfig
from repro_torch.device import resolve_device
from repro_torch.launch import steps as steps_mod
from repro_torch.models import transformer
from repro_torch.models.blocks import block_kind
from repro_torch.obs import profile as obs_profile
from repro_torch.serve.kv_pages import PageAllocator, state_leaves

SPEC_SLICE = ("speculative decoding is not ported yet: it comes with the "
              "serve-features slice of the port (ROADMAP Queue 1)")
MESH_SLICE = ("meshes and sharding are not ported: the port serves on one "
              "card (multi-device is the last slice, ROADMAP Queue 1)")


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
            versions.
        mesh / sharding: not supported (raise).
    """

    #: pages are state snapshots (SSM/hybrid) — never true in this port
    snapshot_state = False

    def __init__(self, rcfg: RunConfig, params, mesh=None,
                 page_size: int = 16, sharding=None, fused: bool = True,
                 obs=None, device=None):
        if mesh is not None or sharding is not None:
            raise NotImplementedError(MESH_SLICE)
        self.device = resolve_device(device)
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
        self._step_fn = steps_mod.make_paged_serve_fn(
            rcfg, self._decode_fn(), fused=fused, device=self.device)

    # -- device half --------------------------------------------------------

    def _decode_fn(self):
        raise NotImplementedError

    def init_state(self, n_pages: int):
        """Fresh device page pools (no allocator) — probes and tests use
        this for scratch state."""
        raise NotImplementedError

    def init(self, max_batch: int, n_pages: int):
        """Set up the host allocator and return the device state.
        ``n_pages`` includes scratch page 0."""
        del max_batch                      # geometry is pool-global
        self.alloc = PageAllocator(n_pages)
        return self.init_state(n_pages)

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

    # -- host half: page ops ------------------------------------------------
    # Refcount lifecycle: alloc_view -> 1 per page, share -> +1, release
    # -> -1 (the LAST release returns the page to the pool; releasing at 0
    # raises). Invariant the scheduler upholds: any page inside a slot's
    # write range [lengths, lengths + n_new) is private (refcount 1) when
    # the step launches — fork() first if other readers remain.

    def alloc_view(self, n: int):
        """n private pages (refcount 1 each) or None when the pool can't
        serve them right now."""
        return self.alloc.alloc(n)

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
        return copy_state_page(state, page, dst), dst

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
        return copy_state_page(state, page, dst), dst

    # -- preemption: spill / restore ----------------------------------------

    def spill(self, state, pages):
        """Read the given physical pages out of every pool leaf into host
        memory; returns the ``restore`` payload (one host tensor per
        leaf, :func:`state_leaves` order)."""
        out = []
        for leaf in state_leaves(state):
            idx = torch.as_tensor(np.asarray(pages, np.int64),
                                  device=leaf.device)
            out.append(leaf[:, idx].cpu())
        return out

    def restore(self, state, pages, leaves):
        """Scatter spilled page contents into ``pages`` (freshly
        allocated ids, same order/count as the ``spill`` call), in place
        and bit-identically. Returns the state."""
        for leaf, d in zip(state_leaves(state), leaves, strict=True):
            idx = torch.as_tensor(np.asarray(pages, np.int64),
                                  device=leaf.device)
            leaf[:, idx] = d.to(leaf.device, leaf.dtype)
        return state

    def page_nbytes(self, state) -> int:
        """Bytes one physical page occupies across every pool leaf."""
        return sum(leaf.element_size() * leaf.numel() // leaf.shape[1]
                   for leaf in state_leaves(state))


def _to_device(tree, device):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


class PagedKVBackend(CacheBackend):
    """Attention decoders (attn_mlp): block/paged KV cache."""

    snapshot_state = False

    def _decode_fn(self):
        return functools.partial(transformer.paged_decode_step,
                                 fused=self.fused)

    def init_state(self, n_pages: int):
        return transformer.init_paged_cache(self.rcfg, n_pages,
                                            self.page_size,
                                            device=self.device)


def make_backend(rcfg: RunConfig, params, mesh=None, page_size: int = 16,
                 sharding=None, fused: bool = True, obs=None,
                 device=None) -> CacheBackend:
    """The only family dispatch in the serve stack."""
    cfg = rcfg.model
    kind = block_kind(cfg)
    if cfg.family == "decoder" and kind == "attn_mlp":
        return PagedKVBackend(rcfg, params, mesh, page_size, sharding,
                              fused, obs, device)
    raise NotImplementedError(
        f"no CacheBackend for family={cfg.family!r} (kind={kind!r}) in the "
        "port yet: this slice serves attn_mlp decoders; MoE, SSM and "
        "hybrid backends come in later slices")
