"""Local ranks on one host: the port's counterpart of
:mod:`repro.launch.hostdev`.

The JAX package fakes N host devices in one process
(``--xla_force_host_platform_device_count``); ``torch.distributed`` runs
one process a rank instead. :func:`spawn_host_ranks` starts N of them
(``torch.multiprocessing``'s ``spawn`` start method), joins them through
a ``FileStore`` in a fresh temporary directory, runs ``fn(*args)`` on
each and returns each rank's result. gloo serves CPU ranks, NCCL cuda
ranks (rank r on ``cuda:r``).

Every rank has a wall-clock limit twice over: its process group's
``timeout`` (a collective that waits longer raises in the rank), and
the parent's deadline, after which it kills every child still alive and
raises ``TimeoutError``. A rank that raises fails the call with its
traceback, and the others are killed: they may be blocked in a
collective that will never complete.

The one failure retried is the group's formation on gloo: its TCP
transport's full-mesh connect now and then fails with "Connection
closed by peer" on a busy host (2 of 48 spawns in a row of 4- and
2-rank groups, before ``fn`` ran). Then every rank is killed and the
group formed anew, at most ``_GLOO_INIT_RETRIES`` times; ``fn`` has not run on any
rank. NCCL groups are never retried.
"""
from __future__ import annotations

import datetime
import os
import queue
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, List

import torch.multiprocessing as mp

_GLOO_INIT_RETRIES = 2


def _child(rank: int, n: int, store_path: str, backend: str,
           timeout_s: float, threads: int, fn: Callable, args, out):
    import torch
    import torch.distributed as dist
    try:
        if threads:
            torch.set_num_threads(threads)
        if backend == "nccl":
            torch.cuda.set_device(rank)
        store = dist.FileStore(store_path, n)
        try:
            dist.init_process_group(
                backend, store=store, rank=rank, world_size=n,
                timeout=datetime.timedelta(seconds=timeout_s))
        except RuntimeError:
            out.put((rank, "init", traceback.format_exc()))
            return
        try:
            out.put((rank, "ok", fn(*args)))
        finally:
            dist.destroy_process_group()
    except BaseException:    # reported to the parent, which re-raises
        out.put((rank, "error", traceback.format_exc()))


def spawn_host_ranks(n: int, fn: Callable, *args, backend: str = "gloo",
                     timeout: float = 300.0,
                     threads: int = 0) -> List[Any]:
    """Run ``fn(*args)`` on ``n`` local ranks of a fresh process group;
    returns ``[result of rank 0, ..., rank n-1]``.

    ``fn`` and ``args`` are pickled (``fn`` by import path) and each
    result comes back pickled. ``backend``: ``"gloo"`` (CPU tensors) or
    ``"nccl"`` (rank r on ``cuda:r``). ``timeout`` (seconds) bounds each
    collective and the whole call. ``threads`` > 0 sets each rank's
    ``torch.set_num_threads``. Raises ``RuntimeError`` with the
    traceback of the first rank that failed, ``TimeoutError`` when the
    ranks did not all finish in time."""
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend {backend!r}: gloo or nccl")
    deadline = time.monotonic() + timeout
    for _ in range(_GLOO_INIT_RETRIES + 1 if backend == "gloo" else 1):
        status, val = _spawn_once(n, fn, args, backend, timeout, threads,
                                  deadline)
        if status == "ok":
            return val
        if status != "init":
            break
    raise RuntimeError(val)


def _spawn_once(n, fn, args, backend, timeout, threads, deadline):
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="ranks-")
    procs = []
    try:
        for r in range(n):
            p = ctx.Process(target=_child, daemon=True, args=(
                r, n, os.path.join(tmp, "store"), backend, timeout, threads,
                fn, args, out))
            p.start()
            procs.append(p)
        results = {}
        while len(results) < n:
            try:
                rank, status, val = out.get(timeout=max(
                    0.1, min(1.0, deadline - time.monotonic())))
            except queue.Empty:
                if time.monotonic() >= deadline:
                    raise TimeoutError(
                        f"{n - len(results)} of {n} ranks did not finish "
                        f"within {timeout} s") from None
                dead = [p.pid for p in procs if p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"rank processes {dead} died "
                                       "without a result") from None
                continue
            if status != "ok":
                return status, f"rank {rank} of {n} failed:\n{val}"
            results[rank] = val
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
        return "ok", [results[r] for r in range(n)]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        shutil.rmtree(tmp, ignore_errors=True)
