"""The port's SLO scheduler held to the reference's, call for call.

The mirror of ``tests/test_serve_slo.py``'s overload paths, each run
twice on the same weights (the port's seeded init, handed to the
reference as the same numbers in its own tree): once through the
reference's ``Scheduler`` and once through the port's
(``device="cpu"``), with the same calls in the same order. The expected values are what the reference returns: every
request's tokens, error text, first-token / done flags and skip count,
the scheduler's integer counters, and the lifecycle trace without its
times (each admit, preempt, resume, restore, first token and finish,
by request, slot and wave). Covered: oversized rejection beside an
in-flight request, the idle-engine admission failure, skip-ahead and
its starvation limit, the preemption victim order (least urgent, then
latest arrival) with spill and recompute resumes, a request cancelled
while queued, the COW-violation diagnostic, the ``bucket_len`` clamp and
the mixed-priority overload through ``ServeEngine``. The decoder family
of the reference's tiny float32 config (its ``make_setup``).
"""
import jax.numpy as jnp
import numpy as np
import pytest

from repro.serve import scheduler as jsched
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JEngine
from repro_torch.models import transformer as ttr
from repro_torch.serve import scheduler as tsched
from repro_torch.serve.engine import Request as TRequest
from repro_torch.serve.engine import ServeEngine as TEngine
from test_serve_slo import MAX_LEN, VOCAB

COUNTERS = ("prefill_tokens", "prefill_calls", "decode_tokens",
            "decode_steps", "shared_tokens", "pages_allocated",
            "pages_shared", "requests_rejected", "requests_failed",
            "preemptions", "pages_spilled", "pages_restored",
            "preempt_recomputes")


def decoder_rcfg(port: bool):
    """``make_setup("decoder")``'s config, in the port's classes or the
    reference's."""
    from repro.configs import base as jbase
    from repro_torch.configs import base as tbase
    b = tbase if port else jbase
    return b.RunConfig(
        model=b.ModelConfig(name="slo_decoder", family="decoder",
                            n_layers=4, d_model=16, n_heads=2, n_kv_heads=2,
                            d_ff=32, vocab_size=VOCAB, act="gelu",
                            norm="layernorm", dtype="float32"),
        mgrit=b.MGRITConfig(enabled=True, cf=2, levels=2, fwd_iters=1,
                            bwd_iters=1, n_open=1, n_close=1, pad_to=2),
        optimizer=b.OptimizerConfig(),
        shape=b.ShapeConfig("decoder", "train", 16, 4))


def to_jax(tree):
    """The port's params tree as the reference's (the same keys)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: to_jax(v) for k, v in tree.items()}
    return jnp.asarray(tree.numpy())


@pytest.fixture(scope="module")
def both():
    """(reference rcfg, its params, the port's rcfg, its params): the
    port's seeded init, the same numbers in both trees."""
    tr = decoder_rcfg(port=True)
    tp = ttr.init_model(tr, seed=0, device="cpu")
    return decoder_rcfg(port=False), to_jax(tp), tr, tp


class Pair:
    """The reference's scheduler and the port's, built alike; ``call``
    makes one call on both and returns both results."""

    def __init__(self, both, **kw):
        jr, jp, tr, tp = both
        kw = dict(page_size=4, max_len=MAX_LEN, **kw)
        self.j = jsched.Scheduler(jr, jp, **kw)
        self.t = tsched.Scheduler(tr, tp, device="cpu", **kw)

    def call(self, name, *args, **kw):
        return (getattr(self.j, name)(*args, **kw),
                getattr(self.t, name)(*args, **kw))

    def submit(self, *args, **kw):
        return self.call("submit_request", *args, **kw)

    def step(self, n=1):
        for _ in range(n):
            self.call("step")

    def run(self):
        return self.call("run")

    def check(self, reqs=()):
        """The port's counters, trace and every given request pair equal
        the reference's."""
        for k in COUNTERS:
            assert self.t.stats[k] == self.j.stats[k], k
        assert events(self.t) == events(self.j)
        for a, b in reqs:
            assert request_view(b) == request_view(a), a.rid


def events(sched):
    return [(ev[3], ev[4], ev[5], ev[6]) for ev in sched.trace.events()
            if ev[3] not in ("pool.free_pages", "scheduler.queue_depth")]


def request_view(r):
    return {"rid": r.rid, "out": list(map(int, r.out)), "error": r.error,
            "done": r.done, "failed": r.failed, "first": r.t_first > 0.0,
            "skips": r.skips, "preemptions": r.preemptions,
            "ttft_none": r.ttft is None, "tpot_none": r.tpot is None,
            "latency_ok": r.latency is not None and r.latency >= 0.0,
            "slo_met": r.slo_met}


def test_oversized_rejection_and_idle_failure_match_reference(both):
    """An unservable request fails at submit beside an in-flight one
    (which decodes on untouched); one that cannot get pages on an idle
    engine fails alone with the reference's message."""
    p = Pair(both, max_batch=2, n_pages=1 + 4)
    live = p.submit(np.arange(1, 8, dtype=np.int32), 6)
    p.step()
    big = p.submit(np.arange(20, dtype=np.int32) % VOCAB, max_new_tokens=4)
    assert big[1].failed and big[1].out == []
    p.run()
    p.check([live, big])

    p = Pair(both, max_batch=2, n_pages=1 + 6, share_prefix=False)
    pinned = [s.alloc.alloc(4) for s in (p.j, p.t)]
    stuck = p.submit(np.arange(8, dtype=np.int32), max_new_tokens=4)
    ok = p.submit(np.array([1, 2, 3], np.int32), max_new_tokens=2)
    p.run()
    assert "idle engine" in stuck[1].error
    assert stuck[1].error == stuck[0].error
    p.check([stuck, ok])
    for s, pages in zip((p.j, p.t), pinned):
        s.alloc.free(pages)
    assert p.t.alloc.n_free == p.t.alloc.n_pages - 1


@pytest.mark.parametrize("limit", [16, 0])
def test_skip_ahead_and_starvation_limit_match_reference(both, limit):
    """A small request admits past an unservable head (skip-ahead), or,
    with the head past ``starvation_limit``, waits behind it: the same
    waves, skips and tokens as the reference."""
    p = Pair(both, max_batch=2, n_pages=1 + 7, share_prefix=False,
             preempt_policy="off", starvation_limit=limit)
    hog = p.submit(np.arange(8, dtype=np.int32), max_new_tokens=8)
    p.step()
    big = p.submit(np.arange(12, dtype=np.int32) % VOCAB, max_new_tokens=4)
    small = p.submit(np.array([9, 8, 7], np.int32), max_new_tokens=2)
    p.step()
    assert (small[1].t_first > 0.0) == (limit > 0)
    p.run()
    p.check([hog, big, small])


@pytest.mark.parametrize("policy", ["spill", "recompute"])
def test_victim_order_and_resumes_match_reference(both, policy):
    """Three running requests (priorities 2, 3, 3); an urgent one (0)
    preempts the least urgent, latest arrival (rid 2), a second urgent
    one the next (rid 1); an equal-priority arrival preempts nobody.
    Every resume (spilled pages restored, or recomputed) emits what the
    reference emits."""
    p = Pair(both, max_batch=3, share_prefix=False, preempt_policy=policy)
    run = [p.submit(np.arange(2 + i, 7 + i, dtype=np.int32), 8,
                    priority=prio) for i, prio in enumerate((2, 3, 3))]
    p.step(2)
    urgent = [p.submit(np.array([5, 4, 3, 2], np.int32), 3, priority=0)]
    p.step()
    urgent.append(p.submit(np.array([1, 2, 3], np.int32), 3, priority=0))
    same = p.submit(np.array([6, 6, 6], np.int32), 2, priority=2)
    p.step()
    preempted = [e[1] for e in events(p.t) if e[0] == "preempt"]
    assert preempted == [2, 1]
    p.run()
    p.check(run + urgent + [same])
    assert p.t.stats["pages_spilled" if policy == "spill"
                     else "preempt_recomputes"] > 0


def test_cancel_while_queued_matches_reference(both):
    p = Pair(both, max_batch=1)
    running = p.submit(np.arange(5, dtype=np.int32), 4)
    p.step()
    queued = p.submit(np.array([7, 6], np.int32), 4)
    p.j.cancel(queued[0])
    p.t.cancel(queued[1])
    assert queued[1].ttft is None and queued[1].tpot is None
    p.run()
    p.check([running, queued])


def test_cow_violation_and_bucket_len_match_reference(both):
    """The debug-gated COW check raises the reference's diagnostic; the
    prefill bucket is the reference's for every length and cap."""
    p = Pair(both, max_batch=1, debug_checks=True)
    p.submit(np.arange(5, dtype=np.int32), 6)
    p.step()
    msgs = []
    for s, err in ((p.j, jsched.COWViolationError),
                   (p.t, tsched.COWViolationError)):
        page = int(s.page_table[0, int(s.lengths[0]) // 4])
        s.alloc.share([page])
        with pytest.raises(err) as e:
            s.step()
        msgs.append(str(e.value))
        s.alloc.free([page])
    assert msgs[1] == msgs[0] and "refcount 2" in msgs[1]
    for hi in (0, 24, 192, 4096):
        for n in range(1, 300, 7):
            assert tsched.bucket_len(n, hi=hi) == jsched.bucket_len(n, hi=hi)


def test_mixed_priority_overload_matches_reference(both):
    """The reference's acceptance workload through both engines: the
    unservable request fails alone, everything else finishes with the
    reference's tokens and SLO verdicts, and the pool drains."""
    jr, jp, tr, tp = both
    rng = np.random.default_rng(3)
    specs = [(rng.integers(0, VOCAB, size=int(rng.integers(3, 10))).astype(
        np.int32), int(rng.integers(2, 6)), i % 3) for i in range(8)]
    specs[3] = (rng.integers(0, VOCAB, size=20).astype(np.int32), 8, 0)

    def reqs(cls):
        return [cls(prompt=pr, max_new_tokens=n, priority=prio,
                    ttft_target_s=30.0 if i != 3 else None,
                    tpot_target_s=30.0 if i != 3 else None)
                for i, (pr, n, prio) in enumerate(specs)]
    kw = dict(max_batch=2, page_size=4, max_len=MAX_LEN, n_pages=1 + 5)
    je = JEngine(jr, jp, **kw)
    te = TEngine(tr, tp, device="cpu", **kw)
    jo, to = je.generate(reqs(JRequest)), te.generate(reqs(TRequest))
    for a, b in zip(jo, to, strict=True):
        assert b.output.tolist() == a.output.tolist()
        assert b.error == a.error and b.slo_met == a.slo_met
    assert to[3].error is not None
    for k in COUNTERS:
        assert te.stats[k] == je.stats[k], k
    assert events(te.scheduler) == events(je.scheduler)
    te.scheduler.drop_prefix_cache()
    assert te.scheduler.alloc.n_free == te.scheduler.alloc.n_pages - 1
