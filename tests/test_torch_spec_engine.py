"""Speculative decoding through the port's ``ServeEngine``: against the
JAX package's spec engine, and the reference's internal contracts kept
inside the port.

Models are the reduced ``qwen3_1p7b``, ``falcon_mamba_7b`` and
``zamba2_1p2b`` in float32 on the CPU. Against JAX (weights converted by
``params_from_jax``), the port's spec engine must emit identical token
streams, greedy and seeded sampled, and equal spec counters. Inside the
port (its own seeded init): greedy spec decode equals plain paged decode
bit for bit over the reference's cf/k grid (cf = 1 accepts every draft);
EOS truncates as plain decode does; top_k = 1 collapses sampling to
greedy; sampled streams do not depend on slot placement; fused equals
gathered, chunked prefill and preemption leave the streams unchanged,
all with spec on; and the serve CLI runs spec on the CPU.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs.reduce import reduce_config as j_reduce
from repro.configs.registry import get_config as j_get_config
from repro.models import transformer as jtr
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JEngine
from repro.serve.spec import SpecConfig as JSpec
from repro_torch.configs.reduce import reduce_config as t_reduce
from repro_torch.configs.registry import get_config as t_get_config
from repro_torch.convert import params_from_jax
from repro_torch.launch import serve as serve_cli
from repro_torch.models import transformer as ttr
from repro_torch.serve.engine import Request as TRequest
from repro_torch.serve.engine import ServeEngine as TEngine
from repro_torch.serve.spec import SpecConfig

torch.set_num_threads(2)
ARCHS = {"decoder": "qwen3_1p7b", "ssm": "falcon_mamba_7b",
         "hybrid": "zamba2_1p2b"}
KW = dict(max_len=32, max_batch=2, page_size=4)
COUNTERS = ("draft_calls", "verify_calls", "tokens_drafted",
            "tokens_accepted")
# the reference's MIXED_REQS (tests/test_serve_spec.py) plus two seeded
# sampled requests: mixed prompt lengths, more requests than slots
MIXED = [(np.array([5, 9, 3, 7, 2, 11], np.int32), 9, {}),
         (np.array([1, 2, 3], np.int32), 7,
          dict(temperature=0.9, top_k=20, seed=3)),
         (np.array([4], np.int32), 5, {}),
         (np.array([8, 8, 1, 30], np.int32), 8,
          dict(temperature=1.1, top_p=0.9, seed=7))]
GREEDY = [(p, n, {}) for p, n, _ in MIXED]


def f32(rcfg):
    return rcfg.replace(model=dataclasses.replace(rcfg.model,
                                                  dtype="float32"))


def run(engine, cls, reqs):
    return [r.output.tolist() for r in engine.generate(
        [cls(prompt=p, max_new_tokens=n, **kw) for p, n, kw in reqs])]


def port(name, seed=0):
    tr = f32(t_reduce(t_get_config(ARCHS[name], "decode_32k")))
    return tr, ttr.init_model(tr, seed=seed, device="cpu")


def t_engine(tr, tp, **kw):
    return TEngine(tr, tp, device="cpu", **{**KW, **kw})


# ---------------------------------------------------------------------------
# 1. The port's spec engine against JAX's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_spec_engine_streams_and_counters_equal_jax(name):
    """Greedy and seeded sampled streams are identical, and so are the
    draft/verify call counts and the drafted/accepted token counts (JAX's
    gathered engine; the port's default fused one)."""
    arch = ARCHS[name]
    jr = f32(j_reduce(j_get_config(arch, "decode_32k")))
    tr = f32(t_reduce(t_get_config(arch, "decode_32k")))
    jp = jax.jit(jtr.init_model, static_argnums=1)(jax.random.PRNGKey(1), jr)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tr, "cpu")
    je = JEngine(jr, jp, fused=False, spec=JSpec(cf=2, k=3), **KW)
    want = run(je, JRequest, MIXED)
    te = t_engine(tr, tp, spec=SpecConfig(cf=2, k=3))
    assert run(te, TRequest, MIXED) == want
    assert {k: te.stats[k] for k in COUNTERS} == \
        {k: je.stats[k] for k in COUNTERS}
    assert te.stats["verify_calls"] > 0


# ---------------------------------------------------------------------------
# 2. Internal contracts (no JAX)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_spec_greedy_equals_plain_and_fused_equals_gathered(name):
    """Temperature 0: spec decode emits plain paged decode's tokens on
    every family, in fewer decode waves than tokens; with spec on, the
    fused engine equals the gathered one on the mixed queue (sampled
    requests included)."""
    tr, tp = port(name)
    plain = run(t_engine(tr, tp), TRequest, GREEDY)
    eng = t_engine(tr, tp, spec=SpecConfig(cf=2, k=3))
    assert run(eng, TRequest, GREEDY) == plain
    st = eng.stats
    assert st["verify_calls"] > 0 and st["tokens_drafted"] > 0
    assert st["decode_steps"] < sum(len(o) for o in plain)
    fused, gathered = (run(t_engine(tr, tp, fused=f,
                                    spec=SpecConfig(cf=2, k=3)),
                           TRequest, MIXED) for f in (True, False))
    assert fused == gathered


@pytest.mark.parametrize("cf,k", [(1, 1), (1, 4), (3, 2), (4, 5)])
def test_spec_cf_k_grid_stays_bitwise(cf, k):
    """cf = 1 (draft == fine model, every draft accepted) and ragged
    cf/k pairs all emit plain decode's greedy tokens."""
    tr, tp = port("decoder")
    plain = run(t_engine(tr, tp), TRequest, GREEDY)
    eng = t_engine(tr, tp, spec=SpecConfig(cf=cf, k=k))
    assert run(eng, TRequest, GREEDY) == plain
    if cf == 1:
        assert eng.stats["accept_rate"] == 1.0


def test_spec_eos_and_topk1_and_placement():
    """EOS inside an accepted burst truncates where plain decode stops;
    top_k = 1 at any temperature reproduces greedy; seeded sampled
    streams are the same in a reversed queue (slot placement does not
    leak into them)."""
    tr, tp = port("decoder")
    kw = dict(max_batch=1)
    prompt = np.array([3, 1, 4], np.int32)
    (probe,) = run(t_engine(tr, tp, **kw), TRequest, [(prompt, 8, {})])
    eos = probe[2]
    reqs = [(prompt, 8, dict(eos_id=eos))]
    (ref,) = run(t_engine(tr, tp, **kw), TRequest, reqs)
    (got,) = run(t_engine(tr, tp, spec=SpecConfig(cf=2, k=4), **kw),
                 TRequest, reqs)
    assert got == ref and len(got) == 3 and got[-1] == eos

    trs, tps = port("ssm")
    hot = [(p, n, dict(temperature=0.9, top_k=1, seed=11 + i))
           for i, (p, n, _) in enumerate(GREEDY)]
    assert run(t_engine(trs, tps, spec=SpecConfig(cf=2, k=3)), TRequest,
               hot) == run(t_engine(trs, tps), TRequest, GREEDY)

    sampled = [(np.array([7, 7, 2], np.int32), 6,
                dict(temperature=1.2, top_k=8, seed=5)),
               (np.array([9, 1], np.int32), 6,
                dict(temperature=0.7, top_p=0.9, seed=6))]
    spec = SpecConfig(cf=2, k=3)
    a = run(t_engine(tr, tp, spec=spec), TRequest, sampled)
    b = run(t_engine(tr, tp, spec=spec), TRequest, sampled)
    c = run(t_engine(tr, tp, spec=spec), TRequest, sampled[::-1])
    assert a == b == c[::-1]


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_spec_chunked_prefill_and_preemption_equal_without(name):
    """With spec on, chunked prefill emits the same streams as whole-
    prompt admission; a small pool with an urgent late request forces
    preemption (spill and recompute), and every request still emits its
    undisturbed tokens."""
    tr, tp = port(name, seed=3)
    spec = SpecConfig(cf=2, k=3)
    rng = np.random.default_rng(3)
    vocab = tr.model.vocab_size
    reqs = [(rng.integers(0, vocab, 14).astype(np.int32), 14 - 4 * (i // 2),
             dict(temperature=0.8 * (i % 2), top_k=20, seed=i))
            for i in range(3)]
    want = run(t_engine(tr, tp, spec=spec, max_len=48), TRequest, reqs)
    assert run(t_engine(tr, tp, spec=spec, max_len=48,
                        prefill_chunk_tokens=4), TRequest, reqs) == want

    solo = [run(t_engine(tr, tp, spec=spec, max_len=48), TRequest, [r])[0]
            for r in reqs]
    assert solo == want
    for policy in ("spill", "recompute"):
        eng = t_engine(tr, tp, spec=spec, max_len=48, n_pages=9,
                       preempt_policy=policy, share_prefix=False)
        rids = [eng.submit(TRequest(prompt=p, max_new_tokens=n,
                                    priority=2, **kw))
                for p, n, kw in reqs[:2]]
        eng.scheduler.step()
        p, n, kw = reqs[2]
        rids.append(eng.submit(TRequest(prompt=p, max_new_tokens=n,
                                        priority=0, **kw)))
        done = eng.scheduler.run()
        assert eng.stats["preemptions"] >= 1, policy
        assert [done[r].out for r in rids] == solo, policy


def test_serve_cli_runs_spec_on_cpu(capsys):
    assert serve_cli.main(["--arch", "zamba2_1p2b", "--reduced", "--device",
                           "cpu", "--requests", "3", "--max-batch", "2",
                           "--page-size", "4", "--new-tokens", "5",
                           "--spec-cf", "2", "--spec-k", "3",
                           "--stats"]) == 0
    out = capsys.readouterr().out
    assert "HybridBackend on cpu + spec decode (cf=2, k=3" in out
    assert out.count("-> [") == 3
    assert "spec decode: " in out and "verify waves" in out
    for key in ("accept_rate", "tokens_drafted", "verify_calls"):
        assert f"  {key} = " in out
