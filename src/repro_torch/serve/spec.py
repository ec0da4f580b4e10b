"""Coarse-propagator speculative decoding — the paper's multilevel
hierarchy as a decode accelerator.

Port of :mod:`repro.serve.spec`. The MGRIT coarse grid approximates the
fine network with every ``cf``-th layer and the ODE step rescaled by
``cf``. That is a free draft model: no extra parameters, no training,
the same tokenizer and embedding. The serve engine drafts ``k`` tokens
with the coarse propagator and verifies them with one occupancy-masked
full-model call per wave.

Wave protocol (two device calls and one host sync):

1. **draft wave** (:func:`repro_torch.launch.steps.make_draft_wave_fn`):
   the coarse model ingests the canonical tokens it has not cached yet
   plus the pending token (committing true draft state), then runs k-1
   autoregressive steps proposing ``d_1..d_k`` with their proposal
   distributions ``q_i``. On snapshot backends the partial state page is
   saved after the ingest and restored before returning.
2. **verify** (:meth:`repro_torch.serve.cache.CacheBackend.verify`): the
   fine model scores ``[pending, d_1..d_k]`` in one call, accepts the
   longest valid prefix (greedy: exact argmax match, so the emitted
   tokens are plain decode's; sampled: rejection sampling keyed off the
   canonical ``fold_in(seed, n_emitted)`` streams, so the emitted
   distribution is the target), emits ``accepted + 1`` tokens and
   commits fine state for exactly the accepted prefix (KV: host-side
   length truncation; snapshot pools: the deferred commit).

The draft's decode state is a private linear page region per slot (no
allocator, no prefix trie, no copy-on-write) of ``max_batch *
pages_per_slot`` pages of the coarse stack. Draft quality moves only the
acceptance rate; verification carries correctness. The coarse grid is a
good draft when the weights sit in the near-identity trained regime the
paper's coarsening assumes; on raw random init acceptance is
tie-breaking luck. This module never touches weight values.

The reference's jit and compile counters are gone: the port runs
eagerly and counts no captures. Under a mesh the draft serves on the
fine backend's mesh and rules: its weights are the backend's local
leaves, its pool this rank's part (each data rank the slots it runs,
one scratch page each), and a wave's window and proposal distributions
stay on the data rank whose slots they are, where the verify call
consumes them.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.launch import steps as steps_mod
from repro_torch.serve.cache import CacheBackend
from repro_torch.serve.kv_pages import region_table


@dataclasses.dataclass(frozen=True)
class SpecConfig:
    """Speculative-decoding knobs: ``cf`` is the layer-coarsening factor
    of the draft (the paper's c_f), ``k`` the number of tokens drafted
    per verify wave."""
    cf: int = 4
    k: int = 4

    def __post_init__(self):
        if self.cf < 1:
            raise ValueError("spec cf must be >= 1")
        if self.k < 1:
            raise ValueError("spec k must be >= 1")


class CoarseDraft:
    """Self-speculative draft model and its private decode state.

    Built from a fine :class:`~repro_torch.serve.cache.CacheBackend`: the
    draft params are the backend's weights restricted to every ``cf``-th
    layer (``transformer.coarse_draft_params``), the decode function is
    the backend's own family step, and the state is a coarse-depth page
    pool with a fixed per-slot page table. ``lengths[b]`` counts the
    draft's committed canonical tokens for slot b: never above the fine
    scheduler's lengths, and re-synced by each wave's catch-up ingest.
    """

    def __init__(self, backend: CacheBackend, spec: SpecConfig,
                 max_batch: int, pages_per_slot: int):
        self.spec = spec
        self.backend = backend
        self.max_batch = max_batch
        params_d, rcfg_d, n_coarse = backend.coarse_draft(spec.cf)
        self.params = params_d
        self.rcfg = rcfg_d
        self.n_coarse = n_coarse
        # one page range a data rank, each with its scratch page
        self.table, n_pages = region_table(
            max_batch, pages_per_slot,
            backend.rows.n if backend.rows is not None else 1)
        self.state = backend.init_draft_state(rcfg_d, n_coarse, n_pages)
        self.rows = None if backend.mesh is None else steps_mod.SlotRows(
            backend.mesh, rcfg_d.sharding, max_batch, n_pages)
        self.lengths = np.zeros((max_batch,), np.int32)
        decode_fn = backend._decode_fn()
        mesh = backend.mesh
        self._prefill_fn = steps_mod.make_paged_serve_fn(
            rcfg_d, decode_fn, device=backend.device, mesh=mesh,
            rows=self.rows)
        self._wave_fn = steps_mod.make_draft_wave_fn(
            rcfg_d, decode_fn, k=spec.k, page_size=backend.page_size,
            snapshot_state=backend.snapshot_state, device=backend.device,
            mesh=mesh, rows=self.rows)
        self._greedy = (np.zeros((max_batch,), np.float32),
                        np.zeros((max_batch,), np.int32),
                        np.ones((max_batch,), np.float32),
                        np.zeros((max_batch,), np.int32),
                        np.zeros((max_batch,), np.int32))

    def reset_slot(self, slot: int) -> None:
        """Forget a reaped slot's committed draft length (its page region
        is reused in place by the next admission)."""
        self.lengths[slot] = 0

    def prefill(self, tokens: np.ndarray, n_new: np.ndarray) -> None:
        """One call writes every admitted slot's full prompt into the
        draft pools from position 0 (the draft has no prefix trie). The
        sampled output is discarded."""
        lengths = np.zeros((self.max_batch,), np.int32)
        temps, top_ks, top_ps, seeds, counters = self._greedy
        _, self.state = self._prefill_fn(
            self.params, self.state, np.asarray(tokens, np.int32), lengths,
            np.asarray(n_new, np.int32), self.table, temps, top_ks, top_ps,
            seeds, counters)
        self.lengths[:] = np.where(n_new > 0, n_new, self.lengths)

    def wave(self, ingest, n_in, n_draft, temps, top_ks, top_ps, seeds,
             counters):
        """Catch-up ingest + k drafted tokens. Returns the verify window
        (B, k+1) = [pending, d_1..d_k] per slot (the pending token is each
        ingest row's last) and draft_probs (B, k, V), both on the device
        (this data rank's rows under a mesh), and advances the committed
        draft lengths by ``n_in``."""
        d, q, self.state = self._wave_fn(
            self.params, self.state, np.asarray(ingest, np.int32),
            self.lengths.copy(), np.asarray(n_in, np.int32), self.table,
            temps, top_ks, top_ps, seeds, np.asarray(counters, np.int32),
            np.asarray(n_draft, np.int32))
        n_in = np.asarray(n_in, np.int32)
        self.lengths += n_in
        pending = np.asarray(ingest)[np.arange(len(n_in)),
                                     np.maximum(n_in - 1, 0)]
        if self.rows is not None:
            pending = self.rows.local(pending)
        window = torch.cat([torch.from_numpy(pending).to(
            d.device, torch.long)[:, None], d.long()], dim=1)
        return window, q
