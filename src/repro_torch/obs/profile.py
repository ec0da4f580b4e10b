"""Compile-event counters and opt-in ``torch.profiler`` span hooks.

**Compile counters.** The JAX package counts XLA traces of every jitted
serve callable. The port runs eagerly: it has no ``torch.compile`` and
no CUDA graphs yet, so nothing is ever registered in a backend's
``compile_counts`` and :func:`compiles_per_callable` reads 0. The key
stays in ``ServeEngine.stats`` (and the ``engine.compiles_per_callable``
gauge) so a later capture of the decode step has its counter ready.

**Profiler spans** are opt-in (``REPRO_PROFILE=1`` or an explicit flag):
:func:`span_factory` returns a ``name -> context manager`` callable that
is a shared no-op ``nullcontext`` when disabled and
``torch.profiler.record_function`` when enabled, so the prefill/decode
dispatches show up named in a ``torch.profiler`` trace.
"""
from __future__ import annotations

import contextlib
import os
from typing import Callable, Dict

_NULL = contextlib.nullcontext()


def compiles_per_callable(counts: Dict[str, int]) -> float:
    """Mean captures per registered callable (0 while nothing is
    captured, which is always so in this port today)."""
    if not counts:
        return 0.0
    return sum(counts.values()) / len(counts)


def spans_enabled(flag=None) -> bool:
    """Profiler spans are opt-in: an explicit flag wins, else the
    ``REPRO_PROFILE=1`` environment switch."""
    if flag is not None:
        return bool(flag)
    return os.environ.get("REPRO_PROFILE", "0") == "1"


def span_factory(enabled: bool) -> Callable:
    """``name -> context manager`` for annotating host dispatch regions.
    Disabled: one shared reusable nullcontext (no per-call allocation).
    Enabled: ``torch.profiler.record_function``."""
    if not enabled:
        return lambda name: _NULL
    import torch

    return lambda name: torch.profiler.record_function(name)
