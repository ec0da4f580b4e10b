"""Bounded ring-buffer request-lifecycle event log + Perfetto export.

The scheduler appends one small host-side tuple per lifecycle edge —
submit → queued → admit → prefill → decode waves → preempt/spill/restore
→ finish/fail/cancel — with monotonic (``time.perf_counter``) timestamps
and wave-scoped spans. Appends are O(1) into a bounded deque (oldest
events drop first, counted in :attr:`TraceBuffer.dropped`); nothing here
ever touches a device array, so tracing adds no sync points to the
jitted hot path.

Event tuples are ``(ph, ts, dur, kind, rid, slot, wave, args)``:

- ``ph`` — "i" instant, "X" complete span, "C" counter sample
  (deliberately the Chrome trace-event phase letters).
- ``ts`` / ``dur`` — perf_counter seconds (span start + duration).
- ``kind`` — the lifecycle edge (see :data:`EVENT_KINDS`) or, for
  counters, the counter name.
- ``rid`` / ``slot`` / ``wave`` — request id, decode slot, scheduler
  wave; -1 where not applicable.
- ``args`` — small dict of host scalars (or None).

**Lifecycle invariant** (tested across seeded fuzz scenarios): every
submitted rid emits *exactly one* terminal event — ``finish``, ``fail``
or ``cancel``. :func:`request_outcomes` folds a buffer into per-request
outcome records and :func:`lifecycle_violations` checks the invariant;
``bench_traffic`` recomputes its goodput/preemption/rejection accounting
from these records and asserts exact agreement with the scheduler's
counters (silent event loss fails the bench).

:meth:`TraceBuffer.to_perfetto` renders the buffer as Chrome/Perfetto
trace-event JSON — load the file at https://ui.perfetto.dev (or
``chrome://tracing``): one track per decode slot, a scheduler-wave
track, an allocator counter track, and one async span per request from
submit to its terminal event.

Stdlib-only, like :mod:`repro_torch.obs.metrics` (the lint CI job imports
this package without numpy/jax installed).
"""
from __future__ import annotations

import collections
import json
import time
from dataclasses import dataclass
from typing import Deque, Dict, List, Optional, Tuple

INSTANT, SPAN, COUNTER = "i", "X", "C"

#: request-lifecycle instants the scheduler emits (counter names and
#: span kinds — prefill/prefill_chunk/decode/spec_wave/admit_wave —
#: ride alongside).
EVENT_KINDS = ("submit", "queued", "admit", "resume", "first_token",
               "preempt", "restore", "finish", "fail", "cancel")

#: exactly one of these per submitted request (the lifecycle invariant)
TERMINAL_KINDS = ("finish", "fail", "cancel")

#: Perfetto track (tid) layout: per-slot tracks start at _SLOT_TID0
_SCHED_TID, _ALLOC_TID, _SLOT_TID0 = 0, 1, 100


class TraceBuffer:
    """Bounded append-only event ring (see module docstring)."""

    def __init__(self, capacity: int = 65536):
        if capacity < 1:
            raise ValueError("trace capacity must be >= 1")
        self.capacity = capacity
        self.dropped = 0                 # evicted oldest-first, counted
        self._events: Deque[Tuple] = collections.deque()

    def __len__(self) -> int:
        return len(self._events)

    def _push(self, ev: Tuple) -> None:
        if len(self._events) >= self.capacity:
            self._events.popleft()
            self.dropped += 1
        self._events.append(ev)

    def instant(self, kind: str, rid: int = -1, slot: int = -1,
                wave: int = -1, args: Optional[Dict] = None) -> None:
        self._push((INSTANT, time.perf_counter(), 0.0, kind, rid, slot,
                    wave, args))

    def span(self, kind: str, t0: float, t1: float, rid: int = -1,
             slot: int = -1, wave: int = -1,
             args: Optional[Dict] = None) -> None:
        self._push((SPAN, t0, max(t1 - t0, 0.0), kind, rid, slot, wave,
                    args))

    def counter(self, name: str, value) -> None:
        self._push((COUNTER, time.perf_counter(), 0.0, name, -1, -1, -1,
                    {"value": value}))

    def events(self) -> List[Tuple]:
        return list(self._events)

    # -- Perfetto export ----------------------------------------------------

    def to_perfetto(self) -> Dict:
        """Chrome trace-event JSON (dict form): pid 1, tid 0 = scheduler
        waves, tid 1 = allocator counters, tid 100+slot = decode slots;
        plus one async ("b"/"e") span per request spanning submit to its
        terminal event."""
        evs: List[Dict] = []
        slots_seen = set()

        def tid_of(slot: int, kind: str) -> int:
            if slot >= 0:
                slots_seen.add(slot)
                return _SLOT_TID0 + slot
            return _ALLOC_TID if kind.startswith("pool.") else _SCHED_TID

        open_async: Dict[int, bool] = {}
        for ph, ts, dur, kind, rid, slot, wave, args in self._events:
            ts_us = ts * 1e6
            a = {k: v for k, v in (args or {}).items() if v is not None}
            if rid >= 0:
                a["rid"] = rid
            if wave >= 0:
                a["wave"] = wave
            if ph == COUNTER:
                evs.append({"name": kind, "ph": "C", "pid": 1,
                            "tid": _ALLOC_TID, "ts": ts_us,
                            "args": {"value": a.get("value", 0)}})
                continue
            base = {"name": kind, "ph": ph, "pid": 1,
                    "tid": tid_of(slot, kind), "ts": ts_us, "args": a}
            if ph == SPAN:
                base["dur"] = dur * 1e6
            else:
                base["s"] = "t"          # instant scope: thread
            evs.append(base)
            if rid >= 0 and ph == INSTANT:
                if kind == "submit":
                    open_async[rid] = True
                    evs.append({"name": f"req {rid}", "cat": "request",
                                "ph": "b", "id": rid, "pid": 1,
                                "tid": _SCHED_TID, "ts": ts_us,
                                "args": a})
                elif kind in TERMINAL_KINDS and open_async.pop(rid, False):
                    evs.append({"name": f"req {rid}", "cat": "request",
                                "ph": "e", "id": rid, "pid": 1,
                                "tid": _SCHED_TID, "ts": ts_us,
                                "args": {"outcome": kind, **a}})
        meta = [{"name": "process_name", "ph": "M", "pid": 1,
                 "args": {"name": "repro.serve"}},
                {"name": "thread_name", "ph": "M", "pid": 1,
                 "tid": _SCHED_TID, "args": {"name": "scheduler"}},
                {"name": "thread_name", "ph": "M", "pid": 1,
                 "tid": _ALLOC_TID, "args": {"name": "allocator"}}]
        for slot in sorted(slots_seen):
            meta.append({"name": "thread_name", "ph": "M", "pid": 1,
                         "tid": _SLOT_TID0 + slot,
                         "args": {"name": f"slot {slot}"}})
        return {"traceEvents": meta + evs, "displayTimeUnit": "ms"}

    def save(self, path: str) -> int:
        """Write the Perfetto JSON to ``path``; returns the number of
        trace events written."""
        doc = self.to_perfetto()
        with open(path, "w") as f:
            json.dump(doc, f, default=float)
        return len(doc["traceEvents"])


@dataclass
class RequestOutcome:
    """Per-request fold of the lifecycle events (``request_outcomes``)."""
    rid: int
    submitted: bool = False
    terminal: Optional[str] = None       # finish / fail / cancel
    terminals: int = 0                   # should be exactly 1
    n_out: int = 0
    ttft_s: Optional[float] = None
    tpot_s: Optional[float] = None
    latency_s: Optional[float] = None
    preemptions: int = 0
    rejected: bool = False               # failed at submit (unservable)
    ttft_target_s: Optional[float] = None
    tpot_target_s: Optional[float] = None

    @property
    def slo_met(self) -> bool:
        """SLO attainment recomputed purely from trace events — the
        cross-check ``bench_traffic`` runs against the scheduler's own
        ``slo_met`` accounting (same semantics as
        ``ScheduledRequest.slo_met``)."""
        if self.terminal != "finish":
            return False
        if self.ttft_target_s is not None and (
                self.ttft_s is None or self.ttft_s > self.ttft_target_s):
            return False
        if self.tpot_target_s is not None and (
                self.tpot_s is not None
                and self.tpot_s > self.tpot_target_s):
            return False
        return True


def request_outcomes(events) -> Dict[int, RequestOutcome]:
    """Fold a buffer's events into {rid: RequestOutcome}."""
    out: Dict[int, RequestOutcome] = {}
    for ph, _ts, _dur, kind, rid, _slot, _wave, args in events:
        if rid < 0 or ph != INSTANT:
            continue
        o = out.setdefault(rid, RequestOutcome(rid))
        a = args or {}
        if kind == "submit":
            o.submitted = True
            o.ttft_target_s = a.get("ttft_target_s")
            o.tpot_target_s = a.get("tpot_target_s")
        elif kind == "preempt":
            o.preemptions += 1
        elif kind in TERMINAL_KINDS:
            o.terminals += 1
            o.terminal = kind
            o.n_out = int(a.get("n_out", 0))
            o.ttft_s = a.get("ttft_s")
            o.tpot_s = a.get("tpot_s")
            o.latency_s = a.get("latency_s")
            if kind == "fail" and a.get("rejected"):
                o.rejected = True
    return out


def lifecycle_violations(events, rids=None) -> List[str]:
    """Messages for every submitted request violating the exactly-one-
    terminal-event invariant (empty list = invariant holds). ``rids``
    restricts the check to that id set (e.g. one benchmark leg — the
    same buffer may hold earlier warmup traffic)."""
    msgs = []
    for rid, o in sorted(request_outcomes(events).items()):
        if rids is not None and rid not in rids:
            continue
        if not o.submitted:
            msgs.append(f"rid {rid}: events without a submit")
        if o.terminals != 1:
            msgs.append(f"rid {rid}: {o.terminals} terminal events "
                        f"(want exactly 1; last={o.terminal})")
    return msgs
