"""Serve-layer observability: metrics registry, lifecycle tracing,
profiler hooks — the port's copy of :mod:`repro.obs`.

- :mod:`repro_torch.obs.metrics` — the typed registry that owns every
  serve counter/gauge/histogram (a verbatim copy; stdlib only).
- :mod:`repro_torch.obs.trace` — the bounded request-lifecycle event
  ring, exported as Chrome/Perfetto trace-event JSON (a copy; stdlib).
- :mod:`repro_torch.obs.profile` — ``torch.profiler`` span hooks and the
  (always-zero, see there) compile counters.

``Observability(enabled=False)`` collapses the whole stack to no-ops.
"""
from __future__ import annotations

from repro_torch.obs import profile
from repro_torch.obs.metrics import METRIC_CATALOG, Histogram, MetricsRegistry
from repro_torch.obs.trace import (RequestOutcome, TraceBuffer,
                                   lifecycle_violations, request_outcomes)

__all__ = ["METRIC_CATALOG", "Histogram", "MetricsRegistry",
           "Observability", "RequestOutcome", "TraceBuffer",
           "lifecycle_violations", "request_outcomes", "profile"]


class Observability:
    """Per-engine observability bundle.

    Attributes:
        metrics: the :class:`~repro_torch.obs.metrics.MetricsRegistry`
            (a disabled shell when ``enabled=False``).
        trace: the :class:`~repro_torch.obs.trace.TraceBuffer`, or None
            when disabled or ``trace_capacity=0``.
        compile_counts: ``{callable name: captures}``; empty in this
            port (see :mod:`repro_torch.obs.profile`).
        span: ``name -> context manager`` for profiler annotations.
    """

    def __init__(self, enabled: bool = True, trace_capacity: int = 65536,
                 profile_spans=None):
        self.enabled = enabled
        self.metrics = MetricsRegistry(enabled=enabled)
        self.trace = TraceBuffer(trace_capacity) \
            if enabled and trace_capacity > 0 else None
        self.compile_counts: dict = {}
        self.span = profile.span_factory(
            enabled and profile.spans_enabled(profile_spans))
