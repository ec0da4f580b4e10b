"""Typed metrics registry for the serve layer.

One process-wide catalog (:data:`METRIC_CATALOG`) declares every metric
the serve stack may emit — name, kind, help string. The registry is the
single owner of what used to be scattered across ``scheduler.stats``,
``PrefixCache.stats``, and the spec counters: the scheduler asks the
registry for its counter dicts (:meth:`MetricsRegistry.stats_dict`), so
the *same* plain-dict objects the rest of the code mutates are what the
registry reads at snapshot time. Nothing on the hot path goes through a
method call per increment — counters stay ``stats["k"] += n`` — which is
how the observability overhead stays within the ≤3% contract
(``serve/obs_overhead`` bench row).

Three kinds:

- **counter** — monotone int/float, owned by a registered stats dict.
- **gauge** — a zero-arg callable sampled at snapshot time (queue depth,
  free pages, derived rates). Never called on the hot path.
- **histogram** — fixed log-spaced buckets (4/decade across 1e-5..1e2
  seconds) for Prometheus exposition **plus** the raw samples for exact
  p50/p95/p99 readout (:meth:`Histogram.quantile` reproduces
  ``numpy.percentile``'s default linear interpolation bit-for-bit; past
  ``sample_cap`` it degrades to seeded reservoir sampling so memory
  stays bounded).

Export surfaces: :meth:`MetricsRegistry.snapshot` (JSON-able dict,
``--metrics-json``) and :meth:`MetricsRegistry.to_prometheus`
(text exposition format).

This module is **stdlib-only** (no numpy/jax): the docs drift gate
(``tests/test_docs.py``) imports the catalog inside the lint CI job,
which installs nothing but ruff + pytest.
"""
from __future__ import annotations

import math
import random
from typing import Callable, Dict, List, Optional, Tuple

#: histogram bucket upper bounds: 4 per decade, 1e-5 s .. 1e2 s — wide
#: enough for a sub-50us fused decode wave and a 100 s overloaded tail.
DEFAULT_BUCKETS: Tuple[float, ...] = tuple(
    10.0 ** (e / 4.0) for e in range(-20, 9))

#: raw samples kept per histogram before switching to reservoir
#: sampling (exact quantiles below the cap; tests stay under it).
SAMPLE_CAP = 262144

#: every metric the serve stack may emit: name -> (kind, help).
#: ``docs/observability.md`` documents exactly this set and
#: ``tests/test_docs.py`` enforces the equality in both directions;
#: :meth:`MetricsRegistry.stats_dict` enforces the runtime half (a
#: stats key that is not in the catalog raises at construction).
METRIC_CATALOG: Dict[str, Tuple[str, str]] = {
    # scheduler counters (the legacy scheduler.stats keys, 1:1)
    "scheduler.prefill_tokens": (
        "counter", "prompt tokens written by batched chunked prefill"),
    "scheduler.prefill_s": (
        "counter", "wall seconds inside jitted prefill calls"),
    "scheduler.prefill_calls": (
        "counter", "batched prefill calls (one per admission wave)"),
    "scheduler.decode_tokens": (
        "counter", "tokens emitted by decode/verify waves"),
    "scheduler.decode_s": (
        "counter", "wall seconds inside jitted decode/verify calls"),
    "scheduler.decode_steps": (
        "counter", "decode (or speculative) waves executed"),
    "scheduler.shared_tokens": (
        "counter", "prompt tokens reused via the prefix trie"),
    "scheduler.pages_allocated": (
        "counter", "fresh pages taken from the pool"),
    "scheduler.pages_shared": (
        "counter", "pages mapped read-only from the prefix trie"),
    "scheduler.draft_calls": (
        "counter", "coarse-draft jitted calls (spec decode)"),
    "scheduler.verify_calls": (
        "counter", "full-model verify waves (spec decode)"),
    "scheduler.tokens_drafted": (
        "counter", "tokens proposed by the coarse draft"),
    "scheduler.tokens_accepted": (
        "counter", "drafted tokens the verifier accepted"),
    "scheduler.requests_rejected": (
        "counter", "requests rejected at submit (can never fit the pool)"),
    "scheduler.requests_failed": (
        "counter", "requests finished with error set (incl. rejections)"),
    "scheduler.preemptions": (
        "counter", "running requests evicted for a more urgent one"),
    "scheduler.pages_spilled": (
        "counter", "preempted pages copied to host memory"),
    "scheduler.pages_restored": (
        "counter", "spilled pages scattered back on resume"),
    "scheduler.preempt_recomputes": (
        "counter", "preemptions resolved by re-prefill instead of spill"),
    "scheduler.prefix_partial_hits": (
        "counter", "admissions that reused a token-granular partial page"),
    "scheduler.prefix_partial_tokens_shared": (
        "counter", "prompt tokens reused via partial-page fork_partial"),
    "scheduler.prefill_chunks": (
        "counter", "budget-bounded prefill ingest waves (chunked mode)"),
    # prefix-trie counters (legacy PrefixCache.stats keys, 1:1)
    "trie.hit_pages": (
        "counter", "physical pages served from the prefix trie"),
    "trie.miss_prompts": (
        "counter", "prompts with no usable trie prefix"),
    "trie.evicted": (
        "counter", "trie-pinned pages evicted under pool pressure"),
    # request/wave latency histograms
    "request.ttft_s": (
        "histogram", "time to first token per finished request (s)"),
    "request.tpot_s": (
        "histogram", "mean seconds per output token after the first"),
    "request.latency_s": (
        "histogram", "submit-to-done wall time per finished request (s)"),
    "wave.prefill_s": (
        "histogram", "wall seconds per batched prefill call"),
    "wave.decode_s": (
        "histogram", "wall seconds per decode/verify wave"),
    # gauges (sampled at snapshot time, never on the hot path)
    "pool.free_pages": (
        "gauge", "free pages in the physical page pool"),
    "scheduler.queue_depth": (
        "gauge", "requests waiting for admission"),
    "scheduler.n_active": (
        "gauge", "occupied decode slots"),
    "scheduler.accept_rate": (
        "gauge", "fraction of drafted tokens accepted (0 when spec off)"),
    "trie.hit_rate": (
        "gauge", "shared / (shared + prefilled) prompt tokens"),
    "engine.compiles_per_callable": (
        "gauge", "mean XLA traces per jitted serve callable"),
}


class Histogram:
    """Log-spaced bucket counts + raw samples for exact quantiles.

    ``observe`` is O(log buckets) + one list append; quantiles sort
    lazily at readout. Below :data:`SAMPLE_CAP` samples,
    :meth:`quantile` is exact and matches ``numpy.percentile(...,
    method='linear')``; past the cap, a fixed-seed reservoir keeps the
    estimate unbiased at bounded memory.
    """

    def __init__(self, name: str, help_: str = "",
                 buckets: Tuple[float, ...] = DEFAULT_BUCKETS):
        self.name = name
        self.help = help_
        self.bounds = tuple(sorted(buckets))
        self.bucket_counts = [0] * (len(self.bounds) + 1)  # +1: +Inf
        self.count = 0
        self.sum = 0.0
        self._samples: List[float] = []
        self._sorted = True
        self._reservoir = random.Random(0)

    def observe(self, value: float) -> None:
        v = float(value)
        self.count += 1
        self.sum += v
        lo, hi = 0, len(self.bounds)
        while lo < hi:                      # first bound >= v
            mid = (lo + hi) // 2
            if self.bounds[mid] < v:
                lo = mid + 1
            else:
                hi = mid
        self.bucket_counts[lo] += 1
        if len(self._samples) < SAMPLE_CAP:
            self._samples.append(v)
            self._sorted = False
        else:
            j = self._reservoir.randrange(self.count)
            if j < SAMPLE_CAP:
                self._samples[j] = v
                self._sorted = False

    def quantile(self, q: float) -> Optional[float]:
        """Exact q-quantile (0 <= q <= 1) of the retained samples, with
        numpy's default linear interpolation; None when empty."""
        if not self._samples:
            return None
        if not self._sorted:
            self._samples.sort()
            self._sorted = True
        s = self._samples
        h = (len(s) - 1) * q
        lo = math.floor(h)
        hi = min(lo + 1, len(s) - 1)
        return s[lo] + (s[hi] - s[lo]) * (h - lo)

    def percentiles(self) -> Dict[str, Optional[float]]:
        return {"p50": self.quantile(0.50), "p95": self.quantile(0.95),
                "p99": self.quantile(0.99)}


class MetricsRegistry:
    """Owner of every serve-layer metric (see module docstring).

    ``enabled=False`` turns the registry into a shell: ``stats_dict``
    hands back plain unregistered dicts, ``observe`` is a no-op, and
    ``snapshot()`` is empty — the zero-overhead arm of the
    ``serve/obs_overhead`` bench row.
    """

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._stats: Dict[str, Dict] = {}            # namespace -> dict
        self._gauges: Dict[str, Callable[[], float]] = {}
        self._hists: Dict[str, Histogram] = {}
        if enabled:
            for name, (kind, help_) in METRIC_CATALOG.items():
                if kind == "histogram":
                    self._hists[name] = Histogram(name, help_)

    @staticmethod
    def _check(name: str, kind: str) -> None:
        got = METRIC_CATALOG.get(name)
        if got is None or got[0] != kind:
            raise KeyError(
                f"metric {name!r} is not a catalogued {kind} — add it to "
                "METRIC_CATALOG (and docs/observability.md; the docs "
                "drift gate enforces the catalog in both directions)")

    def stats_dict(self, namespace: str, initial: Dict) -> Dict:
        """A counter dict registered under ``namespace`` — the caller
        keeps mutating it in place (``d[k] += n``); the registry reads
        it at snapshot time. Every ``namespace.key`` must be in the
        catalog. Returns ``initial`` itself, so existing code that
        resets counters via ``stats[k] = 0`` keeps working."""
        if self.enabled:
            for key in initial:
                self._check(f"{namespace}.{key}", "counter")
            self._stats[namespace] = initial
        return initial

    def gauge(self, name: str, fn: Callable[[], float]) -> None:
        """Register a zero-arg sampler called only at snapshot time."""
        if self.enabled:
            self._check(name, "gauge")
            self._gauges[name] = fn

    def histogram(self, name: str) -> Optional[Histogram]:
        return self._hists.get(name)

    def observe(self, name: str, value) -> None:
        """Record one histogram sample (no-op when disabled or None)."""
        if not self.enabled or value is None:
            return
        self._hists[name].observe(value)

    # -- export surfaces ----------------------------------------------------

    def snapshot(self) -> Dict[str, object]:
        """JSON-able view of every registered metric: counters as
        numbers, gauges sampled now, histograms as
        {count, sum, p50, p95, p99}."""
        out: Dict[str, object] = {}
        for ns, d in self._stats.items():
            for k, v in d.items():
                out[f"{ns}.{k}"] = v
        for name, fn in self._gauges.items():
            out[name] = float(fn())
        for name, h in self._hists.items():
            out[name] = {"count": h.count, "sum": h.sum, **h.percentiles()}
        return out

    def to_prometheus(self, prefix: str = "repro") -> str:
        """Prometheus text exposition of the same metrics (counters get
        the ``_total`` suffix, histograms the cumulative ``_bucket`` /
        ``_sum`` / ``_count`` triple)."""
        lines: List[str] = []

        def emit(name: str, kind: str, help_: str):
            flat = f"{prefix}_{name.replace('.', '_')}"
            lines.append(f"# HELP {flat} {help_}")
            lines.append(f"# TYPE {flat} {kind}")
            return flat

        for ns, d in self._stats.items():
            for k, v in d.items():
                name = f"{ns}.{k}"
                flat = emit(name, "counter", METRIC_CATALOG[name][1])
                lines.append(f"{flat}_total {v}")
        for name, fn in self._gauges.items():
            flat = emit(name, "gauge", METRIC_CATALOG[name][1])
            lines.append(f"{flat} {float(fn())}")
        for name, h in self._hists.items():
            flat = emit(name, "histogram", METRIC_CATALOG[name][1])
            cum = 0
            for bound, c in zip(h.bounds, h.bucket_counts[:-1],
                                strict=True):
                cum += c
                lines.append(f'{flat}_bucket{{le="{bound:.6g}"}} {cum}')
            lines.append(f'{flat}_bucket{{le="+Inf"}} {h.count}')
            lines.append(f"{flat}_sum {h.sum}")
            lines.append(f"{flat}_count {h.count}")
        return "\n".join(lines) + "\n"
