"""The MoE family's serving paths in the port against the JAX package's,
float32 on the CPU: reduced ``qwen3_moe_235b`` (4 experts, top-2, 10
layers), weights converted by ``params_from_jax``.

Capacity comes from the S of each call (``moe.capacity``: C = 4 for a
decode call of one token, for a verify window of 5 and for a 2-token
chunk, 5 for an 8-token prefill bucket), so a choice dropped in a
prefill bucket, a chunk or a verify window can be kept by a decode
call. The reference's own contracts therefore break on this family:
on ``MIXED`` (below) its paged engine leaves its dense oracle at the
first token of request 0 (245 vs 180), its 2-token chunked prefill
leaves whole-prompt prefill at token 7 of request 0 (127 vs 35), and
spec decoding at cf = 1, k = 4 leaves plain decode at token 1 of
request 3 (214 vs 129). The port is held to JAX's stream in each of
these configurations, and keeps internally only the contracts JAX keeps
on these weights: fused == gathered, spec (cf 2, k 3) == plain at
temperature 0, prefix sharing and partial-tail sharing on == off, a
request alone == in a batch, and a preempted request (spill and
recompute) == undisturbed. ROADMAP Queue 3 lists the broken ones.

Cross-framework tolerance: tokens identical (greedy and seeded
sampled) and equal spec counters; ``decode_step`` as
``test_torch_decode.py`` holds the other families (2e-5).
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
from repro_torch.serve.cache import PagedKVBackend
from repro_torch.serve.engine import Request as TRequest
from repro_torch.serve.engine import ServeEngine as TEngine
from repro_torch.serve.spec import SpecConfig
from serve_oracle import dense_decode_oracle as jax_dense_oracle
from test_torch_decode import check_decode_step, jax_decode  # noqa: F401
from test_torch_decode_engine import dense_decode_oracle

torch.set_num_threads(2)
ARCH = "qwen3_moe_235b"
MAX_LEN = 32
KW = dict(max_len=MAX_LEN, max_batch=2, page_size=4)
COUNTERS = ("draft_calls", "verify_calls", "tokens_drafted",
            "tokens_accepted")
# test_torch_spec_engine.py's queue: mixed prompt lengths, more requests
# than slots, greedy and seeded sampled
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


def t_engine(tr, tp, **kw):
    return TEngine(tr, tp, device="cpu", **{**KW, **kw})


@pytest.fixture(scope="module")
def served():
    """JAX's weights (both packages) and JAX's gathered engines' streams
    on MIXED: plain, 2-token chunked prefill, spec (cf 2, k 3) with its
    counters; and JAX's dense oracle for request 0."""
    jr = f32(j_reduce(j_get_config(ARCH, "decode_32k")))
    tr = f32(t_reduce(t_get_config(ARCH, "decode_32k")))
    jp = jax.jit(jtr.init_model, static_argnums=1)(jax.random.PRNGKey(1), jr)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tr, "cpu")
    want = {"plain": run(JEngine(jr, jp, fused=False, **KW), JRequest,
                         MIXED),
            "chunked": run(JEngine(jr, jp, fused=False,
                                   prefill_chunk_tokens=2, **KW),
                           JRequest, MIXED)}
    je = JEngine(jr, jp, fused=False, spec=JSpec(cf=2, k=3), **KW)
    want["spec"] = run(je, JRequest, MIXED)
    want["spec_counters"] = {k: je.stats[k] for k in COUNTERS}
    p, n, kw = MIXED[0]
    step = jax.jit(lambda pp, c, tok: jtr.decode_step(pp, c, tok, jr))
    want["dense0"] = jax_dense_oracle(
        jr, jp, step, JRequest(prompt=p, max_new_tokens=n, **kw),
        MAX_LEN).tolist()
    return tr, tp, want


def test_moe_decode_step_matches_jax(jax_decode):  # noqa: F811
    """``decode_step``'s logits (a 5-token chunked prefill, then 4 greedy
    tokens) and the final KV cache within 2e-5 of JAX's."""
    check_decode_step(jax_decode, ARCH)


@pytest.mark.parametrize("fused", [True, False])
def test_paged_engine_equals_jax(served, fused):
    """The port's paged engine (fused: the kernel routes; gathered: the
    plain views) emits JAX's gathered engine's streams on MIXED."""
    tr, tp, want = served
    eng = t_engine(tr, tp, fused=fused)
    assert isinstance(eng.backend, PagedKVBackend)
    assert run(eng, TRequest, MIXED) == want["plain"]


def test_chunked_prefill_and_dense_oracle_equal_jax(served):
    """Where the reference leaves its own streams (capacity from the S of
    the call), the port follows it: 2-token chunked prefill gives JAX's
    chunked streams, and the dense oracle JAX's dense stream for
    request 0."""
    tr, tp, want = served
    assert run(t_engine(tr, tp, prefill_chunk_tokens=2), TRequest,
               MIXED) == want["chunked"]
    p, n, kw = MIXED[0]
    assert dense_decode_oracle(
        tr, tp, TRequest(prompt=p, max_new_tokens=n, **kw),
        MAX_LEN).tolist() == want["dense0"]


def test_spec_engine_equals_jax(served):
    """``SpecConfig(cf=2, k=3)``: JAX's spec streams and counters (draft
    and verify calls, drafted and accepted tokens), and at temperature 0
    plain decode's tokens, which JAX's spec engine keeps here."""
    tr, tp, want = served
    eng = t_engine(tr, tp, spec=SpecConfig(cf=2, k=3))
    assert run(eng, TRequest, MIXED) == want["spec"]
    assert {k: eng.stats[k] for k in COUNTERS} == want["spec_counters"]
    assert eng.stats["verify_calls"] > 0
    spec = t_engine(tr, tp, spec=SpecConfig(cf=2, k=3))
    assert run(spec, TRequest, GREEDY) == run(t_engine(tr, tp), TRequest,
                                               GREEDY)


def test_engine_contracts_jax_keeps(served):
    """On these weights the reference keeps these contracts, and so does
    the port: prefix and partial-tail sharing on == off over prompts that
    share 9 tokens; three requests alone == together; a small pool with a
    late urgent request preempts (spill, then recompute), and every
    request still emits its undisturbed stream."""
    tr, tp, _ = served
    rng = np.random.default_rng(0)
    common = rng.integers(0, 256, 9).astype(np.int32)
    shared = [(np.concatenate([common, rng.integers(
        0, 256, int(rng.integers(1, 4))).astype(np.int32)]), 6,
        dict(temperature=0.8 * (i % 2), top_k=20, seed=i)) for i in range(4)]
    want = run(t_engine(tr, tp), TRequest, shared)
    for kw in (dict(share_prefix=False), dict(partial_prefix=False)):
        assert run(t_engine(tr, tp, **kw), TRequest, shared) == want, kw

    rng = np.random.default_rng(3)
    reqs = [(rng.integers(0, 256, 14).astype(np.int32), 14 - 4 * (i // 2),
             dict(temperature=0.8 * (i % 2), top_k=20, seed=i))
            for i in range(3)]
    solo = [run(t_engine(tr, tp, max_len=48), TRequest, [r])[0]
            for r in reqs]
    assert run(t_engine(tr, tp, max_len=48), TRequest, reqs) == solo
    for policy in ("spill", "recompute"):
        eng = t_engine(tr, tp, max_len=48, n_pages=9, preempt_policy=policy,
                       share_prefix=False)
        rids = [eng.submit(TRequest(prompt=p, max_new_tokens=n, priority=2,
                                    **kw)) for p, n, kw in reqs[:2]]
        eng.scheduler.step()
        p, n, kw = reqs[2]
        rids.append(eng.submit(TRequest(prompt=p, max_new_tokens=n,
                                        priority=0, **kw)))
        done = eng.scheduler.run()
        assert eng.stats["preemptions"] >= 1, policy
        assert [done[r].out for r in rids] == solo, policy


@pytest.mark.parametrize("arch", ["qwen3_moe_235b", "grok1_314b"])
def test_serve_cli_runs_moe_on_cpu(capsys, arch):
    assert serve_cli.main(["--arch", arch, "--reduced", "--device", "cpu",
                           "--requests", "3", "--max-batch", "2",
                           "--page-size", "4", "--new-tokens", "4",
                           "--spec-cf", "2", "--spec-k", "3"]) == 0
    out = capsys.readouterr().out
    assert "PagedKVBackend on cpu + spec decode (cf=2, k=3" in out
    assert out.count("-> [") == 3
