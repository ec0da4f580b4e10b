"""Continuous-batching scheduler over a :class:`~repro_torch.serve.cache.CacheBackend`.

Port of :mod:`repro.serve.scheduler`: host Python, ported whole.

Under a mesh every rank runs its own scheduler over the same requests,
and every rank must take the same host decisions, or the ranks would
issue different collectives and hang. The scheduler's decisions read
only host state that all ranks share, except two that read the clock:
the queue order's TTFT slack and the recompute-vs-restore cost model's
measured prefill rate. Under a mesh of more than one rank both take
rank 0's values (its clock, its rate and its submit times), agreed by
one small broadcast a wave (``CacheBackend.agree``). A mesh whose page
pools split over ``data`` gives each data rank a range of the slots and
of the pages (``PageAllocator(groups=...)``): a slot's pages, its forks
and its prefix-trie matches come from its own rank's range, and a
request is placed in the free slot whose range has the most free pages.
The trie's hit counters may then differ from one rank's engine; the
tokens do not.

The scheduler is backend-agnostic: it never mentions model families. All
decode state (attention KV pages, SSM state-snapshot pages, hybrid
composition) lives behind the CacheBackend protocol — the scheduler only
plans page views, occupancy, and sampling parameters.

The decode step always runs with a fixed (max_batch, 1) shape; which slots
are alive is the ``n_new`` occupancy mask, so admitting or evicting a
request never recompiles. One scheduler iteration:

  1. admit — order the queue by (priority, deadline slack, arrival), pop
     requests into free slots while the page pool has room — scanning a
     bounded distance past an unservable head so small requests are not
     blocked behind a big one (skip-ahead; aging promotes a starving
     head, see docs/scheduling.md) — then **batched chunked prefill**:
     every request admitted this wave shares ONE jitted
     (max_batch, bucket) call that writes all their prompts into the
     pages and yields each one's first token (prompt remainder padded to
     a power-of-two bucket clamped at max_len, so compile count is
     O(log max_len), not O(T) and not O(queue)).
  2. decode — one lock-step call over all occupied slots; with
     ``spec=SpecConfig(cf, k)`` this becomes a **speculative wave**
     (:mod:`repro_torch.serve.spec`): the coarse-propagator draft proposes
     k tokens per slot and one full-model verify call accepts a per-slot
     prefix, so each slot advances by ``accepted + 1`` tokens per
     iteration (greedy output stays plain decode's).
  3. reap — finished sequences (max_new reached or EOS) release their
     pages and slot immediately; the next iteration refills them.

**Failure isolation**: no per-request condition is engine-fatal. A request
that can never fit the pool is rejected at :meth:`Scheduler.submit_request`
(``ScheduledRequest.error`` set, surfaced on the engine's ``Request``);
a runtime admission failure on an otherwise idle engine fails that one
request the same way. Every other queued and in-flight request keeps
serving either way — overload degrades service, it never crashes the
engine.

**Preemption**: when a more urgent request (smaller ``priority``) cannot
get a slot or pages, least-recently-matched trie leaves are evicted
first, then a strictly-less-urgent running request is preempted: its
live pages are spilled to host memory (``CacheBackend.spill``) or
dropped for recompute — whichever the recompute-vs-restore cost model
predicts is cheaper — its refcounts released, and the request re-enters
the queue to resume later (``CacheBackend.restore`` scatters spilled
pages back bit-identically, so a resumed greedy request emits exactly
the tokens it would have undisturbed).

**Prefix sharing / copy-on-write**: full prompt pages are published in a
trie (``kv_pages.PrefixCache``); a later request whose prompt starts with a
cached prefix maps those physical pages read-only (refcount +1) and
prefills only the remainder. When the remainder would write into a shared
page (a page-aligned full-prompt hit still recomputes the final token for
its logits), the page is forked first — ``CacheBackend.fork`` picks a
private copy and duplicates the device page. On backends whose pages are
state *snapshots* (``backend.snapshot_state``: SSM, hybrid) a snapshot
cannot be rewound to recompute just the final token, and cannot be read in
the same call that writes it — those matches drop the offending pages and
recompute their tokens instead. Under pool pressure, least-recently-matched
trie leaves are evicted.

**Token-granular partial sharing** (``partial_prefix``, KV backends
only): finished prompts also publish their partial tail page
(``PrefixCache.insert_tail``); a later prompt matching only the first n
tokens of such a page reuses them via ``CacheBackend.fork_partial`` — a
whole-page COW *copy* (the source keeps all its references) appended to
the new request's table with n tokens valid. Snapshot backends fall
back to whole-page matching (docs/cache-backends.md).

**Chunked prefill / decode interleaving** (``prefill_chunk_tokens`` >
0, Sarathi-style): an admission wave plans pages and fills slots but
ingests each prompt in budget-bounded chunks — one ingest call of at
most the budget per scheduler wave, *before* that wave's decode, with
mid-ingest slots skipped by decode/spec waves — so a long prompt never
stalls in-flight decode by more than one chunk. Intermediate chunks'
sampled tokens are discarded; the completing chunk emits the first
token with counter 0 from the last prompt token's logits, so streams
stay bitwise identical to serial admission (the differential harness in
``tests/serve_oracle.py`` pins this; docs/scheduling.md has the wave
ordering and starvation interaction).

**Sampling** is per-request and lives inside the jitted step
(``launch.steps.sample_tokens``): temperature 0 slots take the exact
greedy argmax path, others draw from the temperature-scaled,
top-k/top-p-masked distribution with key fold_in(PRNGKey(seed), n_emitted)
— reproducible regardless of slot placement or batch composition.
"""
from __future__ import annotations

import collections
import dataclasses
import os
import time
from typing import Deque, Dict, List, Optional, Set, Tuple

import numpy as np

from repro_torch.configs.base import RunConfig
from repro_torch.obs import Observability
from repro_torch.obs import profile as obs_profile
from repro_torch.serve.cache import CacheBackend, SlotBatch, make_backend
from repro_torch.serve.kv_pages import (SCRATCH_PAGE, PrefixCache,
                                        SpilledPages, pages_needed)
from repro_torch.serve.spec import CoarseDraft, SpecConfig

#: assumed host->device replay bandwidth (bytes/s) for the preemption
#: cost model's restore side when no better estimate exists — only the
#: *ratio* against the measured prefill rate matters, so a conservative
#: constant is fine (docs/scheduling.md).
HOST_RESTORE_BYTES_S = 4e9


class COWViolationError(RuntimeError):
    """A decode slot was about to write into a page other readers can
    still see — an internal copy-on-write invariant violation (a
    scheduler bug), not a per-request failure. Raised by the
    debug-gated check in ``Scheduler._decode_once`` (``REPRO_SERVE_DEBUG=0``
    disables it); unlike the bare ``assert`` it replaced, it survives
    ``python -O`` and names the slot/page/refcount."""


@dataclasses.dataclass
class ScheduledRequest:
    """Scheduler-internal view of one request: prompt + sampling params
    + SLO fields (priority, TTFT/TPOT targets) + the growing ``out``
    token list (the streaming path watches it) + submit/first-token/done
    timestamps. Produced by :meth:`Scheduler.submit_request`; the engine
    converts finished ones back into :class:`repro.serve.engine.Request`
    results. ``error`` is set — instead of anything raising — when the
    request is rejected or fails admission (failure isolation)."""
    rid: int
    prompt: np.ndarray               # (T,) int32
    max_new_tokens: int
    eos_id: Optional[int] = None
    temperature: float = 0.0         # 0 = greedy (exact argmax path)
    top_k: int = 0                   # 0 = disabled
    top_p: float = 1.0               # 1 = disabled
    seed: int = 0                    # per-request sampling stream
    priority: int = 0                # smaller = more urgent (nice-style)
    ttft_target_s: Optional[float] = None   # SLO: time to first token
    tpot_target_s: Optional[float] = None   # SLO: seconds per output token
    out: List[int] = dataclasses.field(default_factory=list)
    t_submit: float = 0.0
    t_first: float = 0.0             # first token produced (end of prefill)
    t_done: float = 0.0
    error: Optional[str] = None      # set iff the request failed
    skips: int = 0                   # admission waves this request waited
    preemptions: int = 0
    spill: Optional[SpilledPages] = None   # host copy of preempted state
    t_order: Optional[float] = None  # rank 0's t_submit, under a mesh

    @property
    def done(self) -> bool:
        return self.t_done > 0.0

    @property
    def failed(self) -> bool:
        return self.error is not None

    @property
    def ttft(self) -> Optional[float]:
        """Time to first token — None when the request never reached
        prefill (rejected, or cancelled while queued), instead of the
        negative ``0 - t_submit`` it used to report."""
        if self.t_first <= 0.0:
            return None
        return self.t_first - self.t_submit

    @property
    def latency(self) -> Optional[float]:
        """Submit-to-done wall time (None while still in flight)."""
        if self.t_done <= 0.0:
            return None
        return self.t_done - self.t_submit

    @property
    def tpot(self) -> Optional[float]:
        """Mean seconds per output token after the first; None before
        completion or when fewer than two tokens were emitted."""
        if self.t_done <= 0.0 or self.t_first <= 0.0 or len(self.out) < 2:
            return None
        return (self.t_done - self.t_first) / (len(self.out) - 1)

    @property
    def slo_met(self) -> bool:
        """Whether a finished request met its declared targets (absent
        targets pass trivially; failed requests never count)."""
        if self.error is not None:
            return False
        if self.ttft_target_s is not None and (
                self.ttft is None or self.ttft > self.ttft_target_s):
            return False
        if self.tpot_target_s is not None and (
                self.tpot is not None and self.tpot > self.tpot_target_s):
            return False
        return True

    @property
    def resume_seq(self) -> np.ndarray:
        """The token sequence whose state must be in the cache before
        the pending token is fed: the prompt for a fresh request; prompt
        + emitted tokens except the last (which decode feeds next) for a
        request resuming after preemption."""
        if not self.out:
            return self.prompt
        return np.concatenate(
            [self.prompt, np.asarray(self.out[:-1], np.int32)])


def bucket_len(n: int, lo: int = 8, hi: int = 0) -> int:
    """Next power-of-two prompt bucket (bounds distinct prefill traces).
    ``hi`` > 0 clamps the bucket: a prompt just under the cap would
    otherwise round up PAST it (e.g. 191 tokens under max_len 192
    tracing a 256-wide prefill) — the clamped bucket adds at most one
    extra trace at exactly ``hi``."""
    b = lo
    while b < n:
        b *= 2
    return min(b, max(n, hi)) if hi else b


class Scheduler:
    """Continuous-batching slot scheduler (see module docstring): admits
    queued requests into ``max_batch`` decode slots in SLO order, plans/
    maps pages host-side, and drives the backend's jitted calls — one
    batched prefill per admission wave, one decode (or draft+verify)
    call per iteration, reaping finished slots in between. Family- and
    mesh-blind: everything device-shaped lives behind ``self.backend``."""

    def __init__(self, rcfg: RunConfig, params, *, max_batch: int = 8,
                 page_size: int = 16, max_len: int = 0, n_pages: int = 0,
                 mesh=None, sharding=None, share_prefix: bool = True,
                 partial_prefix: bool = True,
                 prefill_chunk_tokens: int = 0,
                 backend: Optional[CacheBackend] = None,
                 spec: Optional[SpecConfig] = None, fused: bool = True,
                 admit_lookahead: int = 8, starvation_limit: int = 16,
                 age_every: int = 4, preempt_policy: str = "auto",
                 debug_checks: Optional[bool] = None,
                 obs: Optional[Observability] = None, device=None):
        """Args:
            rcfg / params: model config and weights (under a mesh the
                backend re-places the weights tensor-parallel).
            max_batch: in-flight decode slots (the static batch shape).
            page_size: tokens per state page.
            max_len: per-request prompt+output cap; defaults to
                min(model max_seq_len, 4096).
            n_pages: physical page-pool size incl. scratch page 0;
                defaults to every slot holding a max_len sequence.
            mesh / sharding: SPMD placement, forwarded to
                ``make_backend`` (one scheduler a rank, see the module
                docstring).
            share_prefix: publish full prompt pages in the prefix trie.
            partial_prefix: token-granular prefix sharing (positional-
                page backends only): publish each finished request's
                partial prompt-tail page and match near-miss prefixes by
                longest common token prefix, reusing them via
                ``CacheBackend.fork_partial``. Snapshot backends
                (SSM/hybrid) ignore this and keep whole-page matching —
                a snapshot is only valid at a page boundary. False
                restores exact whole-page-only matching (the
                differential harness's control arm).
            prefill_chunk_tokens: > 0 interleaves chunked prefill with
                decode (Sarathi-style): an admission wave maps pages and
                fills slots but ingests each prompt in budget-bounded
                chunks — at most this many tokens per scheduler wave
                across all ingesting slots, between decode waves — so a
                long prompt never stalls in-flight decode by more than
                one chunk. Chunk buckets reuse ``bucket_len``'s shape
                universe (no new jit shapes); emitted token streams are
                bitwise identical to serial admission (0, the default:
                one whole-prompt batched prefill per admission wave,
                exactly the pre-chunking path).
            backend: pre-built CacheBackend (tests); otherwise built via
                ``make_backend``.
            spec: SpecConfig to enable coarse-propagator speculative
                decoding.
            fused: forwarded to ``make_backend`` — fused paged-decode
                kernels (default) vs the gathered dense-view path.
            admit_lookahead: how many unservable queue entries one admit
                wave may scan past (bounded skip-ahead).
            starvation_limit: admission waves an unservable head may be
                skipped before it blocks all skip-ahead (aging — the
                head then drains the pool and admits; no starvation).
            age_every: every this many skipped waves a queued request's
                *effective* priority (queue ordering only) improves by
                one level.
            preempt_policy: 'auto' (recompute-vs-restore cost model),
                'spill' / 'recompute' (force one side), or 'off'
                (never preempt).
            debug_checks: run the host-side copy-on-write invariant
                check each decode wave; defaults to on unless
                ``REPRO_SERVE_DEBUG=0`` (cheap — O(max_batch) refcount
                lookups — and survives ``python -O``).
            obs: :class:`repro.obs.Observability` bundle. The metrics
                registry owns ``self.stats`` (and the trie counters),
                the trace buffer receives every request-lifecycle event,
                and the backend's jitted callables register compile
                counters. Defaults to a fresh enabled bundle;
                ``Observability(enabled=False)`` turns every emission
                site into a no-op (docs/observability.md).
            device: where the backend's pools and weights live (None
                means ``cuda``; ``"cpu"`` runs the plain versions).
        """
        self.rcfg = rcfg
        self.max_len = max_len or min(rcfg.model.max_seq_len, 4096)
        self.page_size = page_size
        self.max_batch = max_batch
        if preempt_policy not in ("auto", "spill", "recompute", "off"):
            raise ValueError(f"bad preempt_policy {preempt_policy!r}")
        if prefill_chunk_tokens < 0:
            raise ValueError("prefill_chunk_tokens must be >= 0 "
                             "(0 disables chunked-prefill interleaving)")
        self.prefill_chunk_tokens = int(prefill_chunk_tokens)
        self.admit_lookahead = admit_lookahead
        self.starvation_limit = starvation_limit
        self.age_every = max(int(age_every), 1)
        self.preempt_policy = preempt_policy
        self._debug_checks = debug_checks if debug_checks is not None \
            else os.environ.get("REPRO_SERVE_DEBUG", "1") != "0"
        self.obs = obs if obs is not None else Observability()
        self.trace = self.obs.trace
        self.backend = backend if backend is not None else \
            make_backend(rcfg, params, mesh=mesh, page_size=page_size,
                         sharding=sharding, fused=fused, obs=self.obs,
                         device=device)
        if self.backend.page_size != page_size:
            raise ValueError(
                f"backend page_size {self.backend.page_size} != scheduler "
                f"page_size {page_size}: page-table indices would not "
                "agree across the allocator and the backend pools")
        self.pages_per_slot = pages_needed(self.max_len, page_size)
        # default pool: every slot can hold a max_len sequence, + scratch;
        # under a mesh the size is rounded up so the page axis divides
        # the data ranks (pool_pages)
        n_pages = self.backend.pool_pages(
            n_pages or 1 + max_batch * self.pages_per_slot)
        self.state = self.backend.init(max_batch, n_pages)
        self.alloc = self.backend.alloc
        # slots a page group (a data rank's range; all of them on one)
        self._group_slots = max_batch // self.alloc.groups
        self._unagreed: List[ScheduledRequest] = []
        self._agreed: Optional[Tuple[float, float]] = None
        self._page_nbytes = 0            # filled lazily (preempt cost model)
        self.prefix: Optional[PrefixCache] = \
            PrefixCache(self.alloc, page_size,
                        stats=self.obs.metrics.stats_dict(
                            "trie", {"hit_pages": 0, "miss_prompts": 0,
                                     "evicted": 0})) \
            if share_prefix else None
        # token-granular tails apply to positional pages only; snapshot
        # backends fall back to whole-page matching (docs/cache-backends.md)
        self.partial_prefix = bool(partial_prefix) and share_prefix \
            and not self.backend.snapshot_state
        self._pending: Set[int] = set()   # pages this admit wave will write
        self._ingest: Dict[int, np.ndarray] = {}   # slot -> target sequence
        self._wave_preempted: Set[int] = set()   # rids preempted this wave

        self.page_table = np.full((max_batch, self.pages_per_slot),
                                  SCRATCH_PAGE, np.int32)
        self.lengths = np.zeros((max_batch,), np.int32)
        self.slot_req: List[Optional[ScheduledRequest]] = [None] * max_batch
        self.slot_pages: List[List[int]] = [[] for _ in range(max_batch)]
        # per-slot sampling parameters, fed to the jitted step every call
        self.temps = np.zeros((max_batch,), np.float32)
        self.top_ks = np.zeros((max_batch,), np.int32)
        self.top_ps = np.ones((max_batch,), np.float32)
        self.seeds = np.zeros((max_batch,), np.int32)
        self.spec: Optional[CoarseDraft] = None
        if spec is not None:
            self.spec = CoarseDraft(self.backend, spec, max_batch,
                                    self.pages_per_slot)
        self.queue: Deque[ScheduledRequest] = collections.deque()
        self.finished: Dict[int, ScheduledRequest] = {}
        self._next_rid = 0
        self._wave = 0                 # scheduler iteration (trace scoping)
        self._last_counters = None     # last (free_pages, queue_depth) sampled
        # the metrics registry owns this dict (single-owner contract,
        # docs/observability.md); it stays a plain dict the hot path
        # mutates in place, so existing `stats[k] += n` / reset-to-zero
        # code (and every external reader) is unchanged
        self.stats = self.obs.metrics.stats_dict(
            "scheduler",
            {"prefill_tokens": 0, "prefill_s": 0.0,
             "prefill_calls": 0, "decode_tokens": 0,
             "decode_s": 0.0, "decode_steps": 0,
             "shared_tokens": 0, "pages_allocated": 0,
             "pages_shared": 0, "draft_calls": 0,
             "verify_calls": 0, "tokens_drafted": 0,
             "tokens_accepted": 0, "requests_rejected": 0,
             "requests_failed": 0, "preemptions": 0,
             "pages_spilled": 0, "pages_restored": 0,
             "preempt_recomputes": 0, "prefix_partial_hits": 0,
             "prefix_partial_tokens_shared": 0, "prefill_chunks": 0})
        m = self.obs.metrics
        m.gauge("pool.free_pages", lambda: self.alloc.n_free)
        m.gauge("scheduler.queue_depth", lambda: len(self.queue))
        m.gauge("scheduler.n_active", lambda: self.n_active)
        m.gauge("scheduler.accept_rate", self.accept_rate)
        m.gauge("trie.hit_rate", self._trie_hit_rate)
        m.gauge("engine.compiles_per_callable",
                lambda: obs_profile.compiles_per_callable(
                    self.backend.compile_counts))

    # -- submission ---------------------------------------------------------

    def submit(self, prompt: np.ndarray, max_new_tokens: int,
               eos_id: Optional[int] = None, *, temperature: float = 0.0,
               top_k: int = 0, top_p: float = 1.0, seed: int = 0,
               priority: int = 0, ttft_target_s: Optional[float] = None,
               tpot_target_s: Optional[float] = None) -> int:
        """Queue a request; returns its rid. max_new_tokens is capped so
        prompt + output fits max_len (the engine-wide Request contract)."""
        return self.submit_request(
            prompt, max_new_tokens, eos_id, temperature=temperature,
            top_k=top_k, top_p=top_p, seed=seed, priority=priority,
            ttft_target_s=ttft_target_s, tpot_target_s=tpot_target_s).rid

    def submit_request(self, prompt: np.ndarray, max_new_tokens: int,
                       eos_id: Optional[int] = None, *,
                       temperature: float = 0.0, top_k: int = 0,
                       top_p: float = 1.0, seed: int = 0, priority: int = 0,
                       ttft_target_s: Optional[float] = None,
                       tpot_target_s: Optional[float] = None) \
            -> ScheduledRequest:
        """Like :meth:`submit` but returns the live ScheduledRequest (the
        streaming path watches its ``out`` list grow).

        Malformed parameters raise ``ValueError`` (a caller contract
        bug). A well-formed request the pool can *never* hold is instead
        rejected — returned already finished with ``error`` set — so one
        oversized request can't take down anything else (failure
        isolation; the old engine-wide ``RuntimeError`` is gone)."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if len(prompt) >= self.max_len:
            raise ValueError(f"prompt ({len(prompt)}) >= max_len "
                             f"({self.max_len})")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1 (prefill always "
                             "yields the first token)")
        if temperature < 0.0:
            raise ValueError("temperature must be >= 0")
        if top_k < 0:
            raise ValueError("top_k must be >= 0 (0 disables)")
        if not 0.0 < top_p <= 1.0:
            raise ValueError("top_p must be in (0, 1]")
        if ttft_target_s is not None and ttft_target_s <= 0:
            raise ValueError("ttft_target_s must be > 0 (None disables)")
        if tpot_target_s is not None and tpot_target_s <= 0:
            raise ValueError("tpot_target_s must be > 0 (None disables)")
        max_new = min(int(max_new_tokens), self.max_len - len(prompt))
        req = ScheduledRequest(self._next_rid, prompt, max_new, eos_id,
                               temperature=float(temperature),
                               top_k=int(top_k), top_p=float(top_p),
                               seed=int(seed) & 0x7FFFFFFF,
                               priority=int(priority),
                               ttft_target_s=ttft_target_s,
                               tpot_target_s=tpot_target_s,
                               t_submit=time.perf_counter())
        self._next_rid += 1
        if self.trace is not None:
            self.trace.instant("submit", req.rid, args={
                "prompt_len": len(prompt), "max_new": max_new,
                "priority": req.priority,
                "ttft_target_s": ttft_target_s,
                "tpot_target_s": tpot_target_s})
        total = pages_needed(len(prompt) + max_new, self.page_size)
        limit = self.alloc.capacity
        if total > limit:
            self.stats["requests_rejected"] += 1
            self._fail(req, f"unservable: needs {total} pages "
                            f"({len(prompt)} prompt + {max_new} new tokens "
                            f"at page_size {self.page_size}) but the pool "
                            f"holds {limit}", rejected=True)
            return req
        self.queue.append(req)
        self._unagreed.append(req)
        if self.trace is not None:
            self.trace.instant("queued", req.rid, wave=self._wave)
        return req

    def _fail(self, req: ScheduledRequest, msg: str,
              rejected: bool = False) -> None:
        """Per-request failure isolation: mark THIS request failed and
        finished; the engine and every other request keep serving.
        ``rejected`` distinguishes submit-time rejection in the trace."""
        req.error = msg
        req.t_done = time.perf_counter()
        self.finished[req.rid] = req
        self.stats["requests_failed"] += 1
        if self.trace is not None:
            self.trace.instant("fail", req.rid, wave=self._wave, args={
                "reason": msg, "rejected": rejected,
                "n_out": len(req.out), "ttft_s": req.ttft,
                "tpot_s": req.tpot, "latency_s": req.latency})
        self._observe_terminal(req)

    def _observe_terminal(self, req: ScheduledRequest) -> None:
        """Record a finished request's latency samples (histograms skip
        None — e.g. a request cancelled before prefill has no ttft)."""
        m = self.obs.metrics
        m.observe("request.ttft_s", req.ttft)
        m.observe("request.tpot_s", req.tpot)
        m.observe("request.latency_s", req.latency)

    def _trie_hit_rate(self) -> float:
        """Fraction of prompt tokens served from the prefix trie."""
        shared = self.stats["shared_tokens"]
        total = shared + self.stats["prefill_tokens"]
        return shared / total if total else 0.0

    # -- scheduler iteration ------------------------------------------------

    @property
    def n_active(self) -> int:
        """Occupied decode slots (in-flight requests, excluding queue)."""
        return sum(r is not None for r in self.slot_req)

    def effective_priority(self, req: ScheduledRequest) -> int:
        """Queue-ordering priority with aging applied: every
        ``age_every`` skipped admission waves promote the request one
        level, so low-priority work cannot starve behind a steady stream
        of later, nominally-higher-priority arrivals. Preemption
        compares *base* priorities only — aging orders the queue, it
        never evicts running work."""
        return req.priority - req.skips // self.age_every

    def _queue_key(self, req: ScheduledRequest, now: float):
        """(effective priority, deadline slack, arrival). Slack is how
        much of the TTFT budget remains (requests without a target sort
        last within their priority class); a preempted request resuming
        mid-generation sorts first — it holds spilled state and its
        tokens are already owed."""
        if req.out:
            slack = float("-inf")
        elif req.ttft_target_s is not None:
            t = req.t_submit if req.t_order is None else req.t_order
            slack = t + req.ttft_target_s - now
        else:
            slack = float("inf")
        return (self.effective_priority(req), slack, req.rid)

    def _agree_wave(self) -> None:
        """Under a mesh of several ranks: take rank 0's clock, measured
        prefill rate and the submit times of the requests queued since
        the last wave (one broadcast; see the module docstring)."""
        fresh, self._unagreed = self._unagreed, []
        vals = self.backend.agree(
            [time.perf_counter(), self._prefill_rate()]
            + [r.t_submit for r in fresh])
        if vals is None:
            return
        self._agreed = (vals[0], vals[1])
        for r, t in zip(fresh, vals[2:], strict=True):
            r.t_order = t

    def _prefill_rate(self) -> float:
        """Measured batched-prefill tokens/s (1e4 before any prefill)."""
        s = self.stats
        return s["prefill_tokens"] / s["prefill_s"] \
            if s["prefill_s"] > 0 else 1e4

    def _order_queue(self) -> None:
        if len(self.queue) > 1:
            now = time.perf_counter() if self._agreed is None \
                else self._agreed[0]
            self.queue = collections.deque(
                sorted(self.queue, key=lambda r: self._queue_key(r, now)))

    def _group(self, slot: int) -> int:
        """The page group (data rank's range) of ``slot``'s pages."""
        return slot // self._group_slots

    def _free_slot(self) -> Optional[int]:
        """A free slot: the lowest; with several page groups, the lowest
        of the group with the most free pages."""
        free = [s for s in range(self.max_batch) if self.slot_req[s] is None]
        if not free or self.alloc.groups == 1:
            return free[0] if free else None
        return max(free, key=lambda s: (
            self.alloc.n_free_in(self._group(s)), -s))

    def _match_prefix(self, req: ScheduledRequest,
                      group: int) -> List[int]:
        """Longest usable trie match for this prompt (pages of ``group``
        only), with backend-capability adjustments applied, shared
        (refcount +1) before any allocator traffic could free the
        pages."""
        ps = self.page_size
        T = len(req.prompt)
        shared = self.prefix.match(req.prompt, group)
        if self.backend.snapshot_state:
            # snapshot pages are read at scan start, before this wave's
            # writes land: anything written by this same admission wave
            # is unusable — truncate the chain at the first pending page
            for i, p in enumerate(shared):
                if p in self._pending:
                    shared = shared[:i]
                    break
            # a full-prompt hit must recompute the final token, but a
            # snapshot can't rewind mid-page: drop the last page and
            # recompute its page_size tokens (no fork needed)
            if shared and len(shared) * ps >= T:
                shared.pop()
        elif shared and len(shared) * ps >= T and shared[-1] in self._pending:
            # KV pages: only a tail fork reads pages mid-flight; pending
            # pages can't be forked (their KV lands on device mid-call)
            shared.pop()
        self.backend.share(shared)
        return shared

    def _plan_admit(self, req: ScheduledRequest, slot: int) \
            -> Optional[Tuple[List[int], int]]:
        """Map pages for one fresh request: the longest trie-cached
        prompt prefix is shared read-only, fresh pages cover the rest,
        and a COW fork detaches the last shared page when the recomputed
        tail must write into it. With token-granular sharing on, a
        partial-tail / near-miss match past the last full shared page is
        copied into a fresh private page (``fork_partial``) so only the
        genuinely-unshared remainder is recomputed. Returns
        (pages, cached_len) or None when the pool cannot serve the
        request right now. Every page comes from ``slot``'s group."""
        ps = self.page_size
        T = len(req.prompt)
        group = self._group(slot)
        total = pages_needed(T + req.max_new_tokens, ps)
        shared: List[int] = []
        if self.prefix is not None:
            shared = self._match_prefix(req, group)
        shared_len = len(shared) * ps
        fork_src = None
        if shared and shared_len >= T:
            # page-aligned full-prompt hit (positional pages only): the
            # final prompt token is recomputed for its logits, writing
            # into the last shared page -> COW fork
            shared_len = T - 1
            fork_src = shared[-1]
        partial = None                    # (src_page, n_tokens)
        if self.partial_prefix and fork_src is None:
            partial = self.prefix.match_tail(req.prompt, len(shared),
                                             self._pending, group)
            if partial is not None:
                # hold the source across any eviction below: a
                # trie-only page (refcount 1) would otherwise be an
                # eviction candidate while we still need its content
                self.alloc.share([partial[0]])
        n_fresh = total - len(shared) - (partial is not None)
        fresh = self.backend.alloc_view(n_fresh, group)
        if fresh is None and self.prefix is not None:
            self.prefix.evict(n_fresh - self.alloc.n_free_in(group), group)
            fresh = self.backend.alloc_view(n_fresh, group)
        if fresh is None:
            if partial is not None:
                self.alloc.free([partial[0]])
            self.backend.release(shared)
            return None
        if fork_src is not None:
            self.state, dst = self.backend.fork(self.state, fork_src)
            if dst is None and self.prefix is not None:
                self.prefix.evict(1, group)      # same fallback as alloc
                self.state, dst = self.backend.fork(self.state, fork_src)
            if dst is None:                      # needs one more page
                self.backend.release(fresh + shared)
                return None
            if dst != fork_src:
                self.stats["pages_allocated"] += 1
            shared[-1] = dst
        if partial is not None:
            src, n_tok = partial
            self.state, dst = self.backend.fork_partial(self.state, src,
                                                        n_tok)
            if dst is None and self.prefix is not None:
                self.prefix.evict(1, group)
                self.state, dst = self.backend.fork_partial(
                    self.state, src, n_tok)
            self.alloc.free([src])               # drop the eviction hold
            if dst is None:                      # needs one more page
                self.backend.release(fresh + shared)
                return None
            shared.append(dst)
            shared_len += n_tok
            self.stats["pages_allocated"] += 1
            self.stats["prefix_partial_hits"] += 1
            self.stats["prefix_partial_tokens_shared"] += n_tok
        self.stats["pages_allocated"] += n_fresh
        self.stats["pages_shared"] += len(shared) \
            - (fork_src is not None) - (partial is not None)
        self.stats["shared_tokens"] += shared_len
        return shared + fresh, shared_len

    def _plan_resume(self, req: ScheduledRequest, slot: int) \
            -> Optional[Tuple[List[int], int]]:
        """Map pages for a preempted request re-entering a slot: its
        full capacity is allocated fresh (resumes never touch the trie —
        their sequence mixes prompt and generated tokens), the spilled
        pages are scattered back if it spilled, and the remainder — the
        whole sequence for a recompute resume — is re-prefilled."""
        total = pages_needed(len(req.prompt) + req.max_new_tokens,
                             self.page_size)
        group = self._group(slot)
        fresh = self.backend.alloc_view(total, group)
        if fresh is None and self.prefix is not None:
            self.prefix.evict(total - self.alloc.n_free_in(group), group)
            fresh = self.backend.alloc_view(total, group)
        if fresh is None:
            return None
        self.stats["pages_allocated"] += total
        cached = req.spill.length if req.spill is not None else 0
        return fresh, cached

    def _plan(self, req: ScheduledRequest, slot: int) \
            -> Optional[Tuple[List[int], int]]:
        if req.out:
            return self._plan_resume(req, slot)
        return self._plan_admit(req, slot)

    # -- preemption ---------------------------------------------------------

    def _pick_victim(self, priority: int, protected: Set[int],
                     group: Optional[int] = None) -> Optional[int]:
        """Least-urgent, latest-arrival running slot whose *base*
        priority is strictly less urgent than ``priority`` — or None
        (nothing may be preempted for an equal-or-less-urgent request).
        Slots filled this same wave are protected: their prefill hasn't
        run yet. With ``group`` only slots whose pages it holds."""
        best = None
        for slot, r in enumerate(self.slot_req):
            if r is None or slot in protected or r.priority <= priority \
                    or (group is not None and self._group(slot) != group):
                continue
            key = (r.priority, r.rid)
            if best is None or key > best[0]:
                best = (key, slot)
        return None if best is None else best[1]

    def _restore_beats_recompute(self, n_pages: int, n_tokens: int) -> bool:
        """The preemption cost model: restoring spilled pages costs a
        host->device copy of their bytes; recomputing costs re-prefilling
        ``n_tokens`` at the measured batched-prefill rate. 'spill' /
        'recompute' policies force one side (tests pin paths with them;
        both resume bit-identically)."""
        if self.preempt_policy == "spill":
            return True
        if self.preempt_policy == "recompute":
            return False
        prefill_rate = self._prefill_rate() if self._agreed is None \
            else self._agreed[1]
        if not self._page_nbytes:
            self._page_nbytes = self.backend.page_nbytes(self.state)
        t_restore = n_pages * self._page_nbytes / HOST_RESTORE_BYTES_S
        return t_restore < n_tokens / prefill_rate

    def _preempt(self, slot: int) -> None:
        """Evict the running request in ``slot``: spill (or drop, per
        the cost model) its live pages, release its refcounts, and put
        it back on the queue to resume later. No timestamps are touched
        — the request is still in flight, just not resident."""
        req = self.slot_req[slot]
        L = int(self.lengths[slot])
        live = pages_needed(L, self.page_size)
        pages = self.slot_pages[slot]
        # a mid-ingest victim (chunked prefill, no token emitted yet)
        # always recomputes: it re-enters _plan_admit as a fresh request
        # whose page layout (trie shares + partial fork) need not match
        # a spill's, so a restored copy would scatter into the wrong map
        if req.out and self._restore_beats_recompute(live, L):
            req.spill = SpilledPages(
                length=L, leaves=self.backend.spill(self.state,
                                                    pages[:live]))
            self.stats["pages_spilled"] += live
        else:
            req.spill = None
            self.stats["preempt_recomputes"] += 1
        req.preemptions += 1
        self.stats["preemptions"] += 1
        self.backend.release(pages)
        self._clear_slot(slot)
        self._wave_preempted.add(req.rid)
        self.queue.append(req)       # re-ordered at the next admit wave
        if self.trace is not None:
            self.trace.instant(
                "preempt", req.rid, slot, self._wave,
                args={"mode": "recompute" if req.spill is None
                      else "spill", "tokens": L, "pages": live})

    def _plan_or_preempt(self, req: ScheduledRequest, slot: int,
                         protected: Set[int]) \
            -> Optional[Tuple[List[int], int]]:
        """Plan pages for ``req`` in ``slot``, preempting
        strictly-less-urgent running requests of the slot's page group
        one at a time (worst first) until the plan fits or no victim
        remains."""
        plan = self._plan(req, slot)
        if self.preempt_policy == "off":
            return plan
        while plan is None:
            victim = self._pick_victim(req.priority, protected,
                                       self._group(slot))
            if victim is None:
                return None
            self._preempt(victim)
            plan = self._plan(req, slot)
        return plan

    # -- admission ----------------------------------------------------------

    def _fill_slot(self, slot: int, req: ScheduledRequest,
                   pages: List[int], cached: int) -> None:
        self.slot_req[slot] = req
        self.slot_pages[slot] = pages
        self.page_table[slot, :] = SCRATCH_PAGE
        self.page_table[slot, :len(pages)] = pages
        self.lengths[slot] = cached
        self.temps[slot] = req.temperature
        self.top_ks[slot] = req.top_k
        self.top_ps[slot] = req.top_p
        self.seeds[slot] = req.seed
        if self.trace is not None:
            self.trace.instant("resume" if req.out else "admit",
                               req.rid, slot, self._wave,
                               args={"cached_tokens": cached,
                                     "pages": len(pages)})
        if req.spill is not None:
            # spilled resume: scatter the host copy back bit-identically
            live = pages_needed(req.spill.length, self.page_size)
            self.state = self.backend.restore(self.state, pages[:live],
                                              req.spill.leaves)
            self.stats["pages_restored"] += live
            req.spill = None
            if self.trace is not None:
                self.trace.instant("restore", req.rid, slot, self._wave,
                                   args={"pages": live})
        elif not req.out and self.prefix is not None \
                and self.prefill_chunk_tokens == 0:
            n_full = len(req.prompt) // self.page_size
            self.prefix.insert(req.prompt, pages[:n_full])
            self._pending.update(pages[cached // self.page_size:n_full])
            # chunked mode (prefill_chunk_tokens > 0) defers this insert
            # to ingest completion (_prefill_chunk): the pages hold no
            # content yet and nothing marks them pending across waves

    def _admit(self) -> int:
        """Fill free slots from the queue in (priority, slack, arrival)
        order, then prefill every admitted request in ONE batched jitted
        call. An unservable candidate is scanned past (bounded
        skip-ahead) so smaller requests behind it still admit — unless
        it has aged past ``starvation_limit``, which blocks skip-ahead
        until the pool drains for it. Returns how many were admitted (a
        request may finish during its own prefill, so admitted > 0 with
        n_active == 0 afterwards is normal — the caller re-admits)."""
        self._order_queue()
        self._wave_preempted.clear()
        t0 = time.perf_counter()
        plans = []
        deferred: List[ScheduledRequest] = []
        filled: Set[int] = set()
        scan = self.admit_lookahead
        while self.queue:
            req = self.queue[0]
            if req.rid in self._wave_preempted:
                # preempted moments ago for someone this wave — let it
                # re-enter next wave, not bounce straight back in
                deferred.append(self.queue.popleft())
                continue
            slot = self._free_slot()
            if slot is None:
                # every slot busy: a strictly-more-urgent head may
                # preempt its way in; anyone else waits for a reap
                victim = self._pick_victim(req.priority, filled) \
                    if self.preempt_policy != "off" else None
                if victim is None:
                    break
                self._preempt(victim)
                slot = victim
            plan = self._plan_or_preempt(req, slot, filled)
            if plan is None:           # pool full for this request
                req.skips += 1
                if scan <= 0 or req.skips > self.starvation_limit:
                    break              # aged head: no skip-ahead past it
                scan -= 1
                deferred.append(self.queue.popleft())
                continue
            self.queue.popleft()
            req.skips = 0
            pages, cached = plan
            self._fill_slot(slot, req, pages, cached)
            filled.add(slot)
            plans.append((slot, req, cached))
        self.queue.extendleft(reversed(deferred))
        if plans:
            if self.spec is not None:
                self._draft_prefill(plans)
            if self.prefill_chunk_tokens > 0:
                # chunked mode: the admission wave only maps pages; the
                # prompts ingest in budget-bounded chunks between decode
                # waves (_prefill_chunk). Fully-cached resumes (restored
                # spills) have nothing to ingest and decode immediately.
                for slot, req, cached in plans:
                    if len(req.resume_seq) - cached > 0:
                        self._ingest[slot] = req.resume_seq
            else:
                self._batched_prefill(plans)
            self._pending.clear()
            if self.trace is not None:
                self.trace.span("admit_wave", t0, time.perf_counter(),
                                wave=self._wave,
                                args={"admitted": len(plans)})
        return len(plans)

    def _slot_batch(self, n_new, counters) -> SlotBatch:
        return SlotBatch(self.lengths.copy(), n_new, self.page_table,
                         self.temps, self.top_ks, self.top_ps, self.seeds,
                         counters)

    def _draft_prefill(self, plans) -> None:
        """Mirror an admission wave into the coarse draft: one
        coarse-model call writes every admitted slot's full sequence into
        the draft's private pages (the draft has no prefix trie and no
        spill state, so its bucket is the whole prompt — or, for a
        resumed request, prompt + committed output)."""
        seqs = [(slot, req.resume_seq) for slot, req, _ in plans]
        S = bucket_len(max(len(s) for _, s in seqs), hi=self.max_len)
        toks = np.zeros((self.max_batch, S), np.int32)
        n_new = np.zeros((self.max_batch,), np.int32)
        for slot, seq in seqs:
            toks[slot, :len(seq)] = seq
            n_new[slot] = len(seq)
        self.spec.prefill(toks, n_new)
        self.stats["draft_calls"] += 1

    def _batched_prefill(self, plans) -> None:
        """One jitted (max_batch, bucket) call writes every admitted
        sequence's non-cached remainder into its pages and samples each
        first token. Slots mid-decode ride along masked out (n_new == 0),
        so the call count per wave is 1 regardless of queue depth.
        Restored-resume slots (already fully cached) skip the call;
        recompute-resume slots re-ingest their sequence but discard the
        sampled token — their pending token was already emitted."""
        work = [(slot, req, req.resume_seq, cached)
                for slot, req, cached in plans
                if len(req.resume_seq) - cached > 0]
        if not work:
            return
        S = bucket_len(max(len(seq) - c for _, _, seq, c in work),
                       hi=self.max_len)
        toks = np.zeros((self.max_batch, S), np.int32)
        n_new = np.zeros((self.max_batch,), np.int32)
        counters = np.zeros((self.max_batch,), np.int32)
        for slot, req, seq, c in work:
            n = len(seq) - c
            toks[slot, :n] = seq[c:]
            n_new[slot] = n
            counters[slot] = len(req.out)
        t0 = time.perf_counter()
        self.state, nxt = self.backend.prefill(
            self.state, self._slot_batch(n_new, counters), toks)
        nxt = np.asarray(nxt)
        now = time.perf_counter()
        self.stats["prefill_tokens"] += int(n_new.sum())
        self.stats["prefill_s"] += now - t0
        self.stats["prefill_calls"] += 1
        self.obs.metrics.observe("wave.prefill_s", now - t0)
        if self.trace is not None:
            self.trace.span("prefill", t0, now, wave=self._wave,
                            args={"tokens": int(n_new.sum()),
                                  "bucket": S, "slots": len(work)})
            for slot, req, seq, c in work:
                self.trace.span("prefill", t0, now, req.rid, slot,
                                self._wave, args={"tokens": len(seq) - c})
        for slot, req, seq, _ in work:
            self.lengths[slot] = len(seq)
            if req.out:                # recompute resume: state only
                continue
            req.t_first = now
            tok = int(nxt[slot, 0])
            req.out.append(tok)
            if self.trace is not None:
                self.trace.instant("first_token", req.rid, slot,
                                   self._wave)
            if self._is_done(req, tok):
                self._reap(slot)

    def _prefill_chunk(self) -> None:
        """One budget-bounded ingest wave (chunked-prefill interleaving,
        ``prefill_chunk_tokens > 0``): take up to the budget of pending
        prompt tokens across the ingesting slots — lowest slot first —
        and write them with ONE jitted (max_batch, bucket) prefill call,
        exactly the shape universe ``_batched_prefill`` uses (no new jit
        shapes). A slot whose sequence completes this wave emits its
        first token from this call's logits; incomplete slots discard
        the mid-prompt sample (the sampling key folds in the emitted-
        token counter, not the call count, so the final chunk's sample
        is bitwise the serial prefill's). Decode waves run in the same
        scheduler iteration for every non-ingesting slot, so a long
        prompt delays decode by at most one chunk budget."""
        budget = self.prefill_chunk_tokens
        work = []                        # (slot, req, seq, start, take)
        for slot in sorted(self._ingest):
            if budget <= 0:
                break
            req = self.slot_req[slot]
            seq = self._ingest[slot]
            start = int(self.lengths[slot])
            take = min(len(seq) - start, budget)
            if take <= 0:
                continue
            budget -= take
            work.append((slot, req, seq, start, take))
        if not work:
            return
        S = bucket_len(max(t for *_, t in work), hi=self.max_len)
        toks = np.zeros((self.max_batch, S), np.int32)
        n_new = np.zeros((self.max_batch,), np.int32)
        counters = np.zeros((self.max_batch,), np.int32)
        for slot, req, seq, start, take in work:
            toks[slot, :take] = seq[start:start + take]
            n_new[slot] = take
            counters[slot] = len(req.out)
        t0 = time.perf_counter()
        self.state, nxt = self.backend.prefill(
            self.state, self._slot_batch(n_new, counters), toks)
        nxt = np.asarray(nxt)
        now = time.perf_counter()
        self.stats["prefill_tokens"] += int(n_new.sum())
        self.stats["prefill_s"] += now - t0
        self.stats["prefill_calls"] += 1
        self.stats["prefill_chunks"] += 1
        self.obs.metrics.observe("wave.prefill_s", now - t0)
        if self.trace is not None:
            self.trace.span("prefill_chunk", t0, now, wave=self._wave,
                            args={"tokens": int(n_new.sum()),
                                  "bucket": S, "slots": len(work)})
            for slot, req, _, start, take in work:
                self.trace.span("prefill_chunk", t0, now, req.rid, slot,
                                self._wave, args={"tokens": take})
        for slot, req, seq, start, take in work:
            self.lengths[slot] = start + take
            if start + take < len(seq):
                continue                 # more chunks to go
            del self._ingest[slot]
            if not req.out and self.prefix is not None:
                # the deferred trie publish: pages now hold real content
                n_full = len(req.prompt) // self.page_size
                self.prefix.insert(req.prompt,
                                   self.slot_pages[slot][:n_full])
            if req.out:                  # recompute resume: state only
                continue
            req.t_first = now
            tok = int(nxt[slot, 0])
            req.out.append(tok)
            if self.trace is not None:
                self.trace.instant("first_token", req.rid, slot,
                                   self._wave)
            if self._is_done(req, tok):
                self._reap(slot)

    def _check_cow(self, slot: int, req: ScheduledRequest) -> None:
        """COW invariant: the page this slot is about to write must be
        private. Replaces the bare ``assert`` (stripped under
        ``python -O``) with a debug-gated diagnostic raise."""
        page = int(self.page_table[slot,
                                   self.lengths[slot] // self.page_size])
        rc = self.alloc.refcount(page)
        if rc != 1:
            raise COWViolationError(
                f"slot {slot} (rid {req.rid}) is about to write page "
                f"{page} with refcount {rc}; pages in a slot's write "
                f"range must be private (refcount 1) when the decode "
                f"call launches")

    def _decode_once(self) -> None:
        toks = np.zeros((self.max_batch, 1), np.int32)
        n_new = np.zeros((self.max_batch,), np.int32)
        counters = np.zeros((self.max_batch,), np.int32)
        for slot, req in enumerate(self.slot_req):
            # mid-ingest slots (chunked prefill) have no pending token
            # yet — they ride along masked out (n_new == 0)
            if req is not None and slot not in self._ingest:
                toks[slot, 0] = req.out[-1]
                n_new[slot] = 1
                counters[slot] = len(req.out)
                if self._debug_checks:
                    self._check_cow(slot, req)
        t0 = time.perf_counter()
        self.state, nxt = self.backend.step(
            self.state, self._slot_batch(n_new, counters), toks)
        nxt = np.asarray(nxt)
        dt = time.perf_counter() - t0
        n_act = int(n_new.sum())
        self.stats["decode_tokens"] += n_act
        self.stats["decode_s"] += dt
        self.stats["decode_steps"] += 1
        self.obs.metrics.observe("wave.decode_s", dt)
        if self.trace is not None:
            # per-slot spans before the reap loop clears slots
            self.trace.span("decode", t0, t0 + dt, wave=self._wave,
                            args={"n_active": n_act})
            for slot, req in enumerate(self.slot_req):
                if req is not None and slot not in self._ingest:
                    self.trace.span("decode", t0, t0 + dt, req.rid,
                                    slot, self._wave)
        for slot, req in enumerate(self.slot_req):
            if req is None or slot in self._ingest:
                continue
            self.lengths[slot] += 1       # last token now lives in the cache
            tok = int(nxt[slot, 0])
            req.out.append(tok)
            if self._is_done(req, tok):
                self._reap(slot)

    def _spec_wave(self) -> None:
        """One speculative decode wave: a coarse-propagator draft of up
        to ``k`` tokens per slot + one full-model verify call; each slot
        advances by ``accepted + 1`` tokens (greedy slots emit what plain
        decode would). Two device calls and one host sync for up to k+1
        tokens per slot."""
        sp = self.spec
        k = sp.spec.k
        B = self.max_batch
        n_draft = np.zeros((B,), np.int32)
        n_in = np.zeros((B,), np.int32)
        ingest = np.zeros((B, k + 1), np.int32)
        counters = np.zeros((B,), np.int32)
        for b, req in enumerate(self.slot_req):
            if req is None or b in self._ingest:
                # mid-ingest slots (chunked prefill) have nothing to
                # verify yet: masked out like empty slots (n_in == 0)
                continue
            # never draft past the request's budget: accepted+1 <= room
            n_draft[b] = min(k, req.max_new_tokens - len(req.out) - 1)
            # canonical tokens the draft has not cached yet + the pending
            # token (position L); the catch-up is <= last wave's accepted
            # count, so k+1 columns always suffice
            row = req.out[int(sp.lengths[b]) - len(req.prompt):]
            if not 1 <= len(row) <= k + 1:
                raise COWViolationError(
                    f"spec ingest row for slot {b} has {len(row)} tokens "
                    f"(want 1..{k + 1}): draft cache length "
                    f"{int(sp.lengths[b])} drifted from the canonical "
                    "output — a previous wave committed the wrong count")
            ingest[b, :len(row)] = row
            n_in[b] = len(row)
            counters[b] = len(req.out)
            if self._debug_checks:
                self._check_cow(b, req)
        t0 = time.perf_counter()
        # verify window [pending, d_1..d_k]: the drafts never leave the
        # device before verification
        window, q = sp.wave(ingest, n_in, n_draft, self.temps,
                            self.top_ks, self.top_ps, self.seeds, counters)
        slots = self._slot_batch(np.where(n_in > 0, n_draft + 1, 0),
                                 counters)
        self.state, acc, nxt = self.backend.verify(self.state, slots,
                                                   window, q)
        d_host = self.backend.host_rows(window[:, 1:])
        dt = time.perf_counter() - t0
        self.stats["draft_calls"] += 1
        self.stats["verify_calls"] += 1
        self.stats["tokens_drafted"] += int(n_draft.sum())
        self.stats["decode_s"] += dt
        self.stats["decode_steps"] += 1
        self.obs.metrics.observe("wave.decode_s", dt)
        if self.trace is not None:
            self.trace.span("spec_wave", t0, t0 + dt, wave=self._wave,
                            args={"drafted": int(n_draft.sum())})
            for b, req in enumerate(self.slot_req):
                if req is not None and b not in self._ingest:
                    self.trace.span("spec_wave", t0, t0 + dt, req.rid,
                                    b, self._wave)
        for b, req in enumerate(self.slot_req):
            if req is None or b in self._ingest:
                continue
            a = int(acc[b])
            self.stats["tokens_accepted"] += a
            self.lengths[b] += a + 1   # committed: pending + accepted
            for tok in [*d_host[b, :a], nxt[b]]:
                req.out.append(int(tok))
                self.stats["decode_tokens"] += 1
                if self._is_done(req, int(tok)):
                    self._reap(b)
                    break

    def _is_done(self, req: ScheduledRequest, tok: int) -> bool:
        return (len(req.out) >= req.max_new_tokens
                or (req.eos_id is not None and tok == req.eos_id))

    def _clear_slot(self, slot: int) -> None:
        """Reset one slot's host bookkeeping (shared by reap/preempt/
        cancel; page refcounts are the caller's business)."""
        self.slot_pages[slot] = []
        self.slot_req[slot] = None
        self.page_table[slot, :] = SCRATCH_PAGE
        self.lengths[slot] = 0
        self._ingest.pop(slot, None)
        self.temps[slot] = 0.0
        self.top_ks[slot] = 0
        self.top_ps[slot] = 1.0
        self.seeds[slot] = 0
        if self.spec is not None:
            self.spec.reset_slot(slot)

    def _reap(self, slot: int, outcome: str = "finish") -> None:
        """Release a slot and finish its request. ``outcome`` names the
        trace's terminal event — 'finish' for normal completion,
        'cancel' when the caller aborted a running request (the trace
        lifecycle invariant needs the distinction; the counters don't)."""
        req = self.slot_req[slot]
        req.t_done = time.perf_counter()
        self.finished[req.rid] = req
        if (self.partial_prefix and self.prefix is not None
                and int(self.lengths[slot]) >= len(req.prompt)
                and len(req.prompt) % self.page_size):
            # token-granular publish: the prompt's partial tail page is
            # fully ingested by now (the length guard excludes a request
            # cancelled mid-ingest), so index it in the trie before the
            # release below could free it
            self.prefix.insert_tail(
                req.prompt,
                self.slot_pages[slot][len(req.prompt) // self.page_size])
        self.backend.release(self.slot_pages[slot])
        self._clear_slot(slot)
        if self.trace is not None:
            self.trace.instant(outcome, req.rid, slot, self._wave, args={
                "n_out": len(req.out), "ttft_s": req.ttft,
                "tpot_s": req.tpot, "latency_s": req.latency})
        self._observe_terminal(req)

    def cancel(self, req: ScheduledRequest) -> None:
        """Abort a queued or in-flight request: its slot and pages return
        to the pool immediately and nothing more is generated (streaming
        early termination). Finished/unknown requests are a no-op; a
        never-prefilled cancel reports ``ttft``/``tpot`` of None, not a
        negative time."""
        if req.done:
            return
        try:
            self.queue.remove(req)
            req.spill = None             # drop any preempted host copy
            req.t_done = time.perf_counter()
            self.finished[req.rid] = req
            if self.trace is not None:
                self.trace.instant("cancel", req.rid, wave=self._wave,
                                   args={"n_out": len(req.out),
                                         "ttft_s": req.ttft,
                                         "tpot_s": req.tpot,
                                         "latency_s": req.latency})
            self._observe_terminal(req)
            return
        except ValueError:
            pass
        for slot, r in enumerate(self.slot_req):
            if r is req:
                self._reap(slot, outcome="cancel")
                return

    def drop_prefix_cache(self) -> None:
        """Release every trie-pinned page (pages still mapped by live
        requests stay allocated until those finish). Used between
        benchmark phases and by tests verifying the pool drains."""
        if self.prefix is not None:
            self.prefix.clear()

    def step(self) -> bool:
        """One scheduler iteration (admit wave + one decode). Returns
        False when idle (nothing queued or running). Never raises for a
        per-request condition: a request the pool cannot serve even on
        an idle engine fails alone (``ScheduledRequest.error``) while
        everything else keeps decoding."""
        if not self.queue and not self.n_active:
            return False
        self._wave += 1
        self._agree_wave()
        admitted = self._admit()
        if self._ingest:
            # chunked-prefill interleaving: one budget-bounded ingest
            # call, then the decode wave below still runs for every
            # slot that is not mid-ingest
            self._prefill_chunk()
        if self.trace is not None:
            # counter tracks sample on change only: at steady state (no
            # admissions/reaps) both values repeat wave after wave, and
            # Perfetto counter tracks render step-wise anyway
            sample = (self.alloc.n_free, len(self.queue))
            if sample != self._last_counters:
                self._last_counters = sample
                self.trace.counter("pool.free_pages", sample[0])
                self.trace.counter("scheduler.queue_depth", sample[1])
        if self.n_active:
            # skip the decode call when every occupied slot is still
            # ingesting its prompt (nothing has a pending token)
            if any(r is not None and s not in self._ingest
                   for s, r in enumerate(self.slot_req)):
                if self.spec is not None:
                    self._spec_wave()
                else:
                    self._decode_once()
        elif self.queue and admitted == 0:
            # nothing running and nothing admissible: the ordered head
            # cannot get pages even with the machine to itself (e.g.
            # pages pinned outside the scheduler). Fail it alone and
            # keep draining the rest — never kill the engine.
            req = self.queue.popleft()
            self._fail(req, f"admission failed on an idle engine: needs "
                            f"{pages_needed(len(req.prompt) + req.max_new_tokens, self.page_size)} "
                            f"pages, pool holds {self.alloc.capacity} "
                            f"({self.alloc.n_free} free)")
        return True

    def run(self) -> Dict[int, ScheduledRequest]:
        """Drain the queue; returns {rid: finished request} (failed
        requests included, with ``error`` set)."""
        while self.step():
            pass
        return self.finished

    # -- reporting ----------------------------------------------------------

    def accept_rate(self) -> float:
        """Fraction of spec-drafted tokens the verifier accepted (0 when
        spec decode is off) — the single owner of this derivation."""
        return self.stats["tokens_accepted"] / max(
            self.stats["tokens_drafted"], 1)

    def throughput(self) -> Dict[str, float]:
        """Aggregate rates derived from the counters: prefill/decode
        tokens per second of call wall-time, call counts, prompt tokens
        reused via prefix sharing, and the spec-decode accept rate."""
        s = self.stats
        return {
            "prefill_tok_s": s["prefill_tokens"] / max(s["prefill_s"], 1e-9),
            "decode_tok_s": s["decode_tokens"] / max(s["decode_s"], 1e-9),
            "decode_steps": float(s["decode_steps"]),
            "prefill_calls": float(s["prefill_calls"]),
            "shared_tokens": float(s["shared_tokens"]),
            "accept_rate": self.accept_rate(),
        }
