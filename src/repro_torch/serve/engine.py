"""Continuous-batching serving engine.

Port of :mod:`repro.serve.engine`. Attention decoders and the SSM and
hybrid families serve through the paged path on one card: **batched
chunked prefill** (all admitted prompts -> KV or state pages in one
call), a
**refcounted page pool** (KV pages or recurrent-state snapshot pages,
sequences of different lengths share one pool, common prompt prefixes
share physical pages copy-on-write), **per-request sampling**
(temperature / top-k / top-p / seed vectorized inside the step;
temperature 0 is the exact greedy path), and the **scheduler** (admit
from queue into in-flight decode slots, evict finished sequences
mid-decode, refill — fixed batch shape, dynamic occupancy mask). The
engine and scheduler are family-blind: everything state-shaped lives
behind the :class:`repro_torch.serve.cache.CacheBackend` protocol. The
engine runs on ``cuda`` unless built with ``device="cpu"``. With
``mesh=`` (a :class:`repro_torch.launch.mesh.Mesh`; one process a rank,
each building the same engine from the same weights and submitting the
same requests) it serves as explicit SPMD under the reference's
``serve_sharding`` rules: Megatron tensor parallelism over ``model``,
the slots and page pools over ``data``; every rank returns every
request's tokens; its dense probe and dense oracle run the dense step
under the same rules (:func:`repro_torch.launch.steps.make_serve_fn`
``(rcfg, mesh)``) on the weights the backend holds cut, and its prefix
cache saves and loads whole pages (one file, the reference's format,
any mesh shape on either side).
``spec=SpecConfig(cf, k)`` turns on coarse-propagator speculative
decoding (:mod:`repro_torch.serve.spec`): the paper's coarse grid drafts
k tokens per wave from the same weights and the full model verifies
them in one call (greedy output is plain decode's).

:meth:`ServeEngine.submit` with ``stream=True`` returns an iterator
yielding ``(token_id, text_piece)`` as tokens are emitted, with
incremental detokenization; dropping it cancels the request and frees
its pages. ``prefix_cache_path`` restores a persisted prefix cache
(:meth:`save_prefix_cache` / ``PrefixCache.save``) so restarts begin
warm.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import RunConfig
from repro_torch.launch import steps as steps_mod
from repro_torch.models import transformer
from repro_torch.obs import Observability
from repro_torch.obs import profile as obs_profile
from repro_torch.serve.cache import SlotBatch
from repro_torch.serve.kv_pages import region_table
from repro_torch.serve.scheduler import Scheduler, bucket_len
from repro_torch.serve.spec import SpecConfig



@dataclasses.dataclass
class Request:
    """One generation request. Generation stops early at ``eos_id`` and is
    capped so prompt + output never exceeds the engine's max_len — len(
    output) can be < max_new_tokens in both cases.

    Sampling (every backend): ``temperature`` 0 is the exact greedy argmax
    path; > 0 samples from the temperature-scaled distribution restricted
    by ``top_k`` (0 disables) then ``top_p`` (1 disables). ``seed`` names
    the request's private RNG stream — the same (prompt, sampling params,
    seed) yields the same tokens in any slot and any batch composition.

    SLO fields: ``priority`` orders admission (smaller = more urgent,
    nice-style; urgent requests may preempt strictly-less-urgent running
    ones under pool pressure) and ``ttft_target_s`` / ``tpot_target_s``
    declare latency targets used for deadline-slack ordering and goodput
    reporting (``slo_met``) — targets never cause a request to be dropped.
    A request the engine cannot serve fails ALONE: ``error`` is set and
    ``output`` is empty, while every other request keeps decoding
    (failure isolation — nothing in the serve path raises engine-wide
    for a per-request condition).
    """
    prompt: np.ndarray           # (T,) int32
    max_new_tokens: int = 16
    eos_id: Optional[int] = None
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0
    priority: int = 0
    ttft_target_s: Optional[float] = None
    tpot_target_s: Optional[float] = None
    output: Optional[np.ndarray] = None
    ttft_s: Optional[float] = None      # None if never prefilled
    latency_s: Optional[float] = None
    tpot_s: Optional[float] = None      # mean s/token after the first
    error: Optional[str] = None         # set iff the request failed

    @property
    def slo_met(self) -> bool:
        """Whether the finished request met its declared targets (absent
        targets pass trivially; failed requests never count)."""
        if self.error is not None:
            return False
        if self.ttft_target_s is not None and (
                self.ttft_s is None or self.ttft_s > self.ttft_target_s):
            return False
        if self.tpot_target_s is not None and (
                self.tpot_s is not None and self.tpot_s > self.tpot_target_s):
            return False
        return True


def default_detokenize(ids) -> str:
    """Placeholder id->text mapping (this repro carries no tokenizer):
    renders every id as one printable piece. Swap in a real detokenizer
    via ``ServeEngine(..., detokenize=...)`` — any callable mapping the
    full id list to text works; streaming emits the text diff."""
    return "".join(f"⟨{int(i)}⟩" for i in ids)


class ServeEngine:
    """User-facing serving API over the :class:`~repro.serve.scheduler.
    Scheduler`: batch generation (:meth:`generate`), queued submission
    and streaming (:meth:`submit`), prefix-cache persistence, merged
    counters (:attr:`stats`), and the throughput/prefill probes the
    benchmarks use. One engine = one model + one page pool + one device
    (or one rank's part of a mesh)."""

    def __init__(self, rcfg: RunConfig, params, mesh=None,
                 max_len: int = 0, max_batch: int = 8, page_size: int = 16,
                 n_pages: int = 0, share_prefix: bool = True, sharding=None,
                 detokenize: Optional[Callable] = None,
                 spec: Optional[SpecConfig] = None,
                 prefix_cache_path: Optional[str] = None,
                 fused: bool = True, preempt_policy: str = "auto",
                 partial_prefix: bool = True,
                 prefill_chunk_tokens: int = 0,
                 observability: bool = True,
                 trace_capacity: int = 65536,
                 device=None):
        """Args:
            rcfg / params: model config and weights (the port's tree —
                :func:`repro_torch.models.transformer.init_model` or
                :func:`repro_torch.convert.params_from_jax`).
            mesh / sharding: a ("data", "model")
                :class:`repro_torch.launch.mesh.Mesh` and its
                ``ShardingConfig`` (None:
                :func:`repro_torch.configs.registry.serve_sharding`):
                heads, KV heads, MLP, expert and SSM inner dims and the
                vocab split over ``model``, the slots and page pools over
                ``data`` (with ``experts="data"`` the MoE experts too).
                Every rank builds its engine with the same arguments and
                drives it with the same calls; the device follows the
                mesh (NCCL: ``cuda``; gloo: pass ``device="cpu"``).
            max_len / max_batch / page_size / n_pages / share_prefix:
                forwarded to the :class:`~repro.serve.scheduler.Scheduler`
                (``n_pages`` sizes the page pool; 0 = every slot can hold
                a max_len sequence — smaller pools exercise overload
                handling: rejection, skip-ahead, preemption).
            detokenize: ids -> text callable for streaming (defaults to
                rendering each id as ``⟨id⟩``).
            spec: SpecConfig enabling speculative decoding.
            prefix_cache_path: restore a persisted prefix cache npz.
            fused: the paged kernels (default: the CUDA kernels on the
                card, their plain versions on the CPU — bitwise-identical
                greedy output to the gathered path there) vs the
                gathered dense-view decode path.
            preempt_policy: 'auto' (recompute-vs-restore cost model),
                'spill' / 'recompute' (force one side), or 'off' (never
                preempt) — see docs/scheduling.md.
            partial_prefix: token-granular prefix sharing on
                positional-page backends (trie tail entries +
                ``CacheBackend.fork_partial``; snapshot backends keep
                whole-page matching either way — docs/cache-backends.md).
                False restores exact whole-page-only matching.
            prefill_chunk_tokens: > 0 interleaves chunked prefill with
                decode — at most this many prompt tokens ingest per
                scheduler wave, between decode waves, so a long prompt's
                admission never stalls in-flight decode by more than one
                chunk (docs/scheduling.md). 0 (default) keeps serial
                whole-prompt admission. Token streams are bitwise
                identical either way (tests/test_serve_equivalence.py).
            observability: build the engine's :class:`repro_torch.obs.
                Observability` bundle (metrics registry + lifecycle
                trace; docs/observability.md). False collapses every
                emission site to a no-op.
            trace_capacity: lifecycle-trace ring size in events (oldest
                events drop first, counted); 0 disables tracing while
                keeping metrics.
            device: None means ``cuda`` (raises without a CUDA device);
                ``"cpu"`` runs the plain PyTorch versions.
        """
        self.rcfg = rcfg
        self.mesh = mesh
        # under a mesh the backend holds this rank's part, nothing the whole
        self.params = params if mesh is None else None
        self.max_len = max_len or min(rcfg.model.max_seq_len, 4096)
        self.detokenize = detokenize or default_detokenize
        self.obs = Observability(enabled=observability,
                                 trace_capacity=trace_capacity)
        self.scheduler = Scheduler(
            rcfg, params, max_batch=max_batch, page_size=page_size,
            max_len=self.max_len, n_pages=n_pages, mesh=mesh,
            sharding=sharding, share_prefix=share_prefix, spec=spec,
            fused=fused, preempt_policy=preempt_policy,
            partial_prefix=partial_prefix,
            prefill_chunk_tokens=prefill_chunk_tokens, obs=self.obs,
            device=device)
        self.backend = self.scheduler.backend
        self.device = self.backend.device
        # dense-cache decode fn: the serial-forward oracle and the
        # comparison probe (throughput_probe(paged=False)), under the
        # backend's rules on a mesh
        self._decode = steps_mod.make_serve_fn(self.backend.rcfg, mesh)
        if prefix_cache_path and os.path.exists(prefix_cache_path):
            self.load_prefix_cache(prefix_cache_path)

    # -- prefix-cache persistence -------------------------------------------

    def save_prefix_cache(self, path: str) -> int:
        """Persist the prefix trie + the device contents of its pinned
        pages to ``path`` (npz). Returns the number of pages saved. Under
        a mesh every rank calls it: the ranks give their pages and heads
        (:meth:`~repro_torch.serve.cache.CacheBackend.page_contents`),
        global rank 0 writes the file, whole heads and global contents,
        and every rank returns once it is written."""
        sched = self.scheduler
        if sched.prefix is None:
            raise ValueError("engine was built with share_prefix=False")
        if self.mesh is None:
            return sched.prefix.save(path, sched.state)
        import torch.distributed as dist
        n = sched.prefix.save(path, sched.state,
                              read=self.backend.page_contents,
                              write_file=dist.get_rank() == 0)
        self.mesh.barrier()
        return n

    def load_prefix_cache(self, path: str) -> int:
        """Restore a saved prefix cache into this engine's (empty) trie
        and page pool — a warm restart: prompts whose prefixes were
        cached before the restart skip their prefill again. Returns the
        number of pages restored (pages that no longer fit the pool are
        dropped with their subtrees; a file saved with another page size
        raises). Under a mesh every rank reads the file: each saved
        root's subtree
        goes to one data rank's page range, whose ranks write its pages,
        each its own heads."""
        sched = self.scheduler
        if sched.prefix is None:
            raise ValueError("engine was built with share_prefix=False")
        sched.state, n = sched.prefix.load(
            path, sched.state, write=self.backend.write_page_contents)
        return n

    # -- reporting ----------------------------------------------------------

    @property
    def stats(self) -> Dict[str, float]:
        """One merged counter dict: scheduler counters (prefill/decode/
        spec-decode: draft_calls, verify_calls, tokens_drafted/accepted)
        + prefix-trie counters (hit/miss/evictions) + the mesh shape the
        engine decodes on (``mesh_dp``/``mesh_tp``/``mesh_devices``, all
        1 without a mesh) +
        ``compiles_per_callable`` (always 0: the port captures no graphs
        yet, see :mod:`repro_torch.obs.profile`). Every key keeps the
        JAX package's name and meaning."""
        s = dict(self.scheduler.stats)
        prefix = self.scheduler.prefix
        s["trie_hit_pages"] = prefix.stats["hit_pages"] if prefix else 0
        s["trie_miss_prompts"] = prefix.stats["miss_prompts"] if prefix \
            else 0
        s["trie_evictions"] = prefix.stats["evicted"] if prefix else 0
        s["accept_rate"] = self.scheduler.accept_rate()
        shape = dict(self.mesh.shape) if self.mesh is not None else {}
        s["mesh_dp"] = int(shape.get("data", 1))
        s["mesh_tp"] = int(shape.get("model", 1))
        s["mesh_devices"] = self.mesh.size if self.mesh is not None else 1
        s["compiles_per_callable"] = obs_profile.compiles_per_callable(
            self.backend.compile_counts)
        return s

    def metrics_snapshot(self) -> Dict[str, object]:
        """JSON-able snapshot of the metrics registry: every counter,
        gauge (sampled now), and histogram (count/sum/p50/p95/p99).
        Empty when the engine was built with ``observability=False``."""
        return self.obs.metrics.snapshot()

    def metrics_prometheus(self) -> str:
        """Prometheus text exposition of the same registry."""
        return self.obs.metrics.to_prometheus()

    def save_trace(self, path: str) -> int:
        """Write the request-lifecycle trace as Chrome/Perfetto
        trace-event JSON (load at https://ui.perfetto.dev). Returns the
        number of trace events written; raises when tracing is off."""
        if self.obs.trace is None:
            raise ValueError("engine has no trace buffer (built with "
                             "observability=False or trace_capacity=0)")
        return self.obs.trace.save(path)

    # -- generation ---------------------------------------------------------

    def _validate(self, requests: List[Request]) -> None:
        # validate the whole batch before any request is queued, so a bad
        # request can't leave earlier ones orphaned in the scheduler
        for r in requests:
            if r.max_new_tokens < 1:
                raise ValueError("max_new_tokens must be >= 1")
            if len(r.prompt) >= self.max_len:
                raise ValueError(f"prompt ({len(r.prompt)}) >= max_len "
                                 f"({self.max_len})")
            if r.temperature < 0.0 or r.top_k < 0 \
                    or not 0.0 < r.top_p <= 1.0:
                raise ValueError("bad sampling params: need temperature "
                                 ">= 0, top_k >= 0, top_p in (0, 1]")
            for target in (r.ttft_target_s, r.tpot_target_s):
                if target is not None and target <= 0:
                    raise ValueError("SLO targets must be > 0 (None "
                                     "disables)")

    def _submit_one(self, r: Request):
        return self.scheduler.submit_request(
            r.prompt, r.max_new_tokens, r.eos_id, temperature=r.temperature,
            top_k=r.top_k, top_p=r.top_p, seed=r.seed, priority=r.priority,
            ttft_target_s=r.ttft_target_s, tpot_target_s=r.tpot_target_s)

    @staticmethod
    def _finalize(r: Request, fin) -> Request:
        r.output = np.asarray(fin.out, np.int32)
        r.ttft_s = fin.ttft
        r.latency_s = fin.latency
        r.tpot_s = fin.tpot
        r.error = fin.error
        return r

    def generate(self, requests: List[Request]) -> List[Request]:
        """Queue every request, drain the scheduler, and return the same
        Request objects with ``output`` / ``ttft_s`` / ``latency_s``
        filled in (order preserved). The whole batch is validated before
        anything is queued, so a bad request can't orphan earlier ones."""
        self._validate(requests)
        sched = self.scheduler
        rids = [self._submit_one(r).rid for r in requests]
        done = sched.run()
        return [self._finalize(r, done.pop(rid))
                for r, rid in zip(requests, rids, strict=True)]

    def submit(self, request: Request, *, stream: bool = False,
               detokenize: Optional[Callable] = None):
        """Queue one request. ``stream=False`` returns its rid (drain with
        ``engine.scheduler.run()``). ``stream=True`` returns a generator
        yielding ``(token_id, text_piece)`` as tokens are emitted — pulling
        it drives the scheduler, so queued requests decode lock-step with
        the streamed one; on exhaustion the Request's output/ttft/latency
        fields are filled in."""
        self._validate([request])
        sreq = self._submit_one(request)
        if not stream:
            return sreq.rid
        return self._stream(sreq, request, detokenize or self.detokenize)

    def _stream(self, req, request: Request, detokenize: Callable):
        """Incremental detokenization: each new token re-detokenizes the
        full emitted prefix and yields the text *diff*, so multi-byte /
        multi-token pieces surface as soon as they are complete.

        Dropping the iterator mid-generation (``close()`` / GeneratorExit
        / an exception in the consumer) cancels the request: its slot and
        pages go back to the pool immediately instead of leaking until
        someone else happens to drive the scheduler."""
        sched = self.scheduler
        emitted, text = 0, ""
        try:
            while True:
                while emitted < len(req.out):
                    tok = req.out[emitted]
                    emitted += 1
                    full = detokenize(req.out[:emitted])
                    piece = full[len(text):] if full.startswith(text) \
                        else full
                    text = full
                    yield int(tok), piece
                if req.done:
                    break
                sched.step()     # never raises for pool pressure: an
                # unservable request finishes with req.error set instead
        finally:
            if not req.done:
                sched.cancel(req)
            self._finalize(request, req)

    # -- probes -------------------------------------------------------------

    def throughput_probe(self, batch: int, steps: int = 8,
                         paged: bool = True,
                         table_pages: int = 0) -> float:
        """tokens/sec of steady-state decode at the given batch.
        ``paged=False`` measures the dense-cache decode step instead (the
        seed design) for apples-to-apples comparison. ``table_pages``
        widens each slot's page table to the given production width and
        starts decode at a quarter of that context depth, so
        fused-vs-gathered probes measure realistic mid-sequence decode
        rather than an empty-table best case. Both probes run the
        weights the backend serves with and end synchronized with the
        device: the paged step reads its tokens back, the dense one
        synchronizes before and after its steps."""
        if paged:
            return self._paged_probe(batch, steps, table_pages)
        cache = transformer.init_cache(self.backend.rcfg, batch,
                                       self.max_len, device=self.device,
                                       mesh=self.mesh)
        tok = torch.ones((batch, 1), dtype=torch.long, device=self.device)
        params = self.backend.params
        tok, cache = self._decode(params, cache, tok)          # warm-up
        _sync(self.device)
        t0 = time.perf_counter()
        for _ in range(steps):
            tok, cache = self._decode(params, cache, tok)
        _sync(self.device)
        return batch * steps / (time.perf_counter() - t0)

    def dense_oracle(self, prompt, max_new_tokens: int) -> np.ndarray:
        """The greedy stream of one request through the dense step (the
        serial-forward oracle the paged engine is held against), on the
        weights the backend serves with and, under a mesh, its rules:
        a dense cache of one slot and ``max_len`` rows, the prompt by one
        chunked-prefill call (attention families) or a token a call (SSM,
        hybrid). Every rank returns the same tokens."""
        rcfg = self.backend.rcfg
        cache = transformer.init_cache(rcfg, 1, self.max_len,
                                       device=self.device, mesh=self.mesh)
        toks = torch.as_tensor(np.asarray(prompt, np.int64),
                               device=self.device)[None]
        attn = rcfg.model.family == "decoder"
        feeds = [toks] if attn else [toks[:, i:i + 1]
                                     for i in range(toks.shape[1])]
        with torch.no_grad():
            for f in feeds:
                nxt, cache = self._decode(self.backend.params, cache, f)
            out = [nxt]
            for _ in range(max_new_tokens - 1):
                nxt, cache = self._decode(self.backend.params, cache, nxt)
                out.append(nxt)
        return torch.cat(out, dim=1)[0].cpu().numpy().astype(np.int32)

    def _scratch_table(self, batch: int, n_tokens: int,
                       min_pages: int = 0):
        """(page table giving every slot n_tokens of capacity, the pool
        size it needs): host-only. Under a mesh the probe runs the
        engine's slots in a scratch pool of the engine's size, each data
        rank's slots in its own page range
        (:func:`~repro_torch.serve.kv_pages.region_table`)."""
        per = max(min_pages, 1, -(-n_tokens // self.scheduler.page_size))
        rows = self.backend.rows
        if rows is None:
            return region_table(batch, per)
        if batch != self.scheduler.max_batch:
            raise ValueError(f"under a mesh a probe runs the engine's "
                             f"{self.scheduler.max_batch} slots, not {batch}")
        return region_table(batch, per, rows.n, rows.span)

    def _paged_probe(self, batch: int, steps: int,
                     table_pages: int = 0) -> float:
        """Steady-state paged decode at full occupancy on a probe-local
        scratch state (the host reads each step's tokens, so every step
        ends synchronized)."""
        ps = self.scheduler.page_size
        start = (table_pages * ps) // 4 if table_pages else 0
        table, n_pages = self._scratch_table(batch, start + steps + 1,
                                             table_pages)
        state = self.backend.init_state(n_pages)
        slots = SlotBatch.greedy(
            batch, table, lengths=np.full((batch,), start, np.int32))
        tok = np.ones((batch, 1), np.int32)
        state, tok = self.backend.step(state, slots, tok)   # warm-up
        t0 = time.perf_counter()
        for _ in range(steps):
            slots.lengths = slots.lengths + 1
            state, tok = self.backend.step(state, slots, tok)
        return batch * steps / (time.perf_counter() - t0)

    def prefill_probe(self, prompt_len: int, batch: int = 1,
                      iters: int = 3) -> float:
        """tokens/sec of chunked prefill at the given prompt length: one
        call writes the whole prompt."""
        rcfg = self.rcfg
        S = bucket_len(prompt_len)
        rng = np.random.default_rng(0)
        toks = rng.integers(0, rcfg.model.vocab_size, (batch, S),
                            dtype=np.int32)
        table, n_pages = self._scratch_table(batch, S)
        slots = SlotBatch.greedy(
            batch, table, n_new=np.full((batch,), prompt_len, np.int32))

        def call():
            state = self.backend.init_state(n_pages)
            return self.backend.prefill(state, slots, toks)

        call()                       # warm-up; returns host tokens (synced)
        ts = []
        for _ in range(iters):
            t0 = time.perf_counter()
            call()
            ts.append(time.perf_counter() - t0)
        return batch * prompt_len / float(np.median(ts))


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
