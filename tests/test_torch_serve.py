"""The slice as a whole: the port's ``ServeEngine(device="cpu")`` against
the JAX package's ``ServeEngine`` on the same queue, plus the engine
contracts the port keeps internally (fused == gathered, preemption and
chunked prefill bitwise-neutral, streaming/cancel, prefix-cache
persistence) and its refusals (no card, mesh).

Cross-framework tolerance: emitted tokens identical — greedy and seeded
sampled (the port's threefry stream is bit-exact with ``jax.random``).

The JAX reference engine runs with ``fused=False`` when prompts share a
prefix inside one admission wave: its fused ref-mode "view" path reads
shared prefix pages from views gathered before the wave wrote them, so
its own fused and gathered engines disagree there (ROADMAP Queue 3).
Its fused path is held against the port on a queue without sharing.
"""
import dataclasses
import types

import jax
import numpy as np
import pytest
import torch

from repro.configs.reduce import reduce_config as j_reduce
from repro.configs.registry import get_config as j_get_config
from repro.models import transformer as jtr
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JEngine
from repro_torch.configs.base import MGRITConfig as TMGRIT
from repro_torch.configs.base import ModelConfig as TModelConfig
from repro_torch.configs.base import OptimizerConfig as TOpt
from repro_torch.configs.base import RunConfig as TRunConfig
from repro_torch.configs.base import ShapeConfig as TShape
from repro_torch.configs.reduce import reduce_config as t_reduce
from repro_torch.configs.registry import get_config as t_get_config
from repro_torch.convert import params_from_jax
from repro_torch.launch import serve as serve_cli
from repro_torch.serve.engine import Request as TRequest
from repro_torch.serve.engine import ServeEngine as TEngine
from test_serve import MAX_LEN as TINY_MAX_LEN
from test_serve import VOCAB as TINY_VOCAB
from test_serve import tiny_rcfg

torch.set_num_threads(2)
MAX_LEN, MAX_BATCH, PAGE = 64, 3, 8


def f32(rcfg):
    return rcfg.replace(model=dataclasses.replace(rcfg.model,
                                                  dtype="float32"))


def queue(vocab, seed=0, n=7, shared=True, sampled=True):
    """Mixed prompt lengths, more requests than slots, a shared 20-token
    prefix on every other prompt, greedy and seeded sampled requests."""
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, vocab, 20).astype(np.int32)
    specs = []
    for i in range(n):
        p = rng.integers(0, vocab, int(rng.integers(3, 30))).astype(np.int32)
        if shared and i % 2 == 0:
            p = np.concatenate([prefix, p])
        samp = sampled and i % 3 != 0
        specs.append(dict(
            prompt=p, max_new_tokens=int(rng.integers(4, 10)),
            temperature=0.8 if samp else 0.0, top_k=20 if samp else 0,
            top_p=0.9 if samp else 1.0, seed=int(rng.integers(0, 2**31))))
    return specs


def outputs(engine, cls, specs):
    return [r.output.tolist() for r in engine.generate(
        [cls(**s) for s in specs])]


@pytest.fixture(scope="module")
def qwen(tmp_path_factory):
    """Reduced qwen3_1p7b in float32: JAX params, their conversion, the
    JAX engines' outputs on both queues and the gathered engine's saved
    prefix cache (computed once)."""
    jr = f32(j_reduce(j_get_config("qwen3_1p7b", "decode_32k")))
    tr = f32(t_reduce(t_get_config("qwen3_1p7b", "decode_32k")))
    jp = jax.jit(jtr.init_model, static_argnums=1)(jax.random.PRNGKey(0), jr)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tr, "cpu")
    V = jr.model.vocab_size
    shared_q, plain_q = queue(V), queue(V, seed=1, shared=False)
    kw = dict(max_len=MAX_LEN, max_batch=MAX_BATCH, page_size=PAGE)
    jeng = JEngine(jr, jp, fused=False, **kw)
    want_shared = outputs(jeng, JRequest, shared_q)
    jax_npz = str(tmp_path_factory.mktemp("jax_prefix") / "prefix.npz")
    jeng.save_prefix_cache(jax_npz)
    want_plain = outputs(JEngine(jr, jp, **kw), JRequest, plain_q)
    return tr, tp, shared_q, plain_q, want_shared, want_plain, jax_npz


def t_engine(tr, tp, **kw):
    args = dict(max_len=MAX_LEN, max_batch=MAX_BATCH, page_size=PAGE,
                device="cpu")
    args.update(kw)
    return TEngine(tr, tp, **args)


@pytest.mark.parametrize("fused", [True, False])
def test_engine_tokens_equal_jax_shared_prefix_queue(qwen, fused):
    tr, tp, shared_q, _, want, _, _ = qwen
    assert outputs(t_engine(tr, tp, fused=fused), TRequest, shared_q) == want


def test_engine_tokens_equal_jax_fused_queue(qwen):
    tr, tp, _, plain_q, _, want, _ = qwen
    assert outputs(t_engine(tr, tp), TRequest, plain_q) == want


def test_engine_contracts_bitwise_neutral(qwen):
    """Chunked prefill, whole-page-only sharing and no sharing at all
    emit the same streams as the default engine (the reference's
    differential contracts, kept internal to the port)."""
    tr, tp, shared_q, _, want, _, _ = qwen
    for kw in (dict(prefill_chunk_tokens=8), dict(partial_prefix=False),
               dict(share_prefix=False)):
        assert outputs(t_engine(tr, tp, **kw), TRequest, shared_q) == want, kw


def test_preemption_spill_and_recompute_resume_bitwise(qwen):
    """A small pool with an urgent late request forces preemption; the
    preempted requests resume to exactly their undisturbed tokens."""
    tr, tp, *_ = qwen
    rng = np.random.default_rng(3)
    specs = [dict(prompt=rng.integers(0, 256, 20).astype(np.int32),
                  max_new_tokens=12, priority=2) for _ in range(2)]
    urgent = dict(prompt=rng.integers(0, 256, 20).astype(np.int32),
                  max_new_tokens=6, priority=0)
    solo = [outputs(t_engine(tr, tp), TRequest, [s])[0]
            for s in specs + [urgent]]
    for policy in ("spill", "recompute"):
        eng = t_engine(tr, tp, max_batch=2, n_pages=9,
                       preempt_policy=policy, share_prefix=False)
        reqs = [TRequest(**s) for s in specs]
        rids = [eng.submit(r) for r in reqs]
        for _ in range(3):
            eng.scheduler.step()
        rids.append(eng.submit(TRequest(**urgent)))
        done = eng.scheduler.run()
        assert eng.stats["preemptions"] >= 1, policy
        assert [done[r].out for r in rids] == solo, policy


def test_streaming_and_cancel_free_pages(qwen):
    tr, tp, shared_q, _, want, _, _ = qwen
    eng = t_engine(tr, tp)
    free0 = eng.scheduler.alloc.n_free
    got = [tok for tok, _ in eng.submit(TRequest(**shared_q[1]),
                                        stream=True)]
    assert got == want[1]
    stream = eng.submit(TRequest(**dict(shared_q[3], max_new_tokens=9)),
                        stream=True)
    next(stream)
    stream.close()                       # cancel mid-generation
    eng.scheduler.drop_prefix_cache()
    assert eng.scheduler.alloc.n_free == free0
    assert eng.scheduler.n_active == 0


def test_prefix_cache_save_load_roundtrip(qwen, tmp_path):
    tr, tp, shared_q, _, want, _, _ = qwen
    eng = t_engine(tr, tp)
    outputs(eng, TRequest, shared_q[:2])
    path = str(tmp_path / "prefix.npz")
    n = eng.save_prefix_cache(path)
    assert n > 0
    warm = t_engine(tr, tp, prefix_cache_path=path)
    assert warm.scheduler.prefix.n_cached_pages == n
    assert outputs(warm, TRequest, shared_q) == want
    assert warm.stats["trie_hit_pages"] > 0


def test_prefix_cache_saved_by_jax_loads_into_the_port(qwen):
    """Same npz format: the JAX engine's persisted trie restores into a
    port engine, which then serves the queue from it unchanged."""
    tr, tp, shared_q, _, want, _, jax_npz = qwen
    eng = t_engine(tr, tp, prefix_cache_path=jax_npz)
    n = eng.scheduler.prefix.n_cached_pages
    assert n > 0
    assert outputs(eng, TRequest, shared_q) == want
    assert eng.stats["trie_hit_pages"] > 0


def test_npz_page_helpers_keep_bfloat16_bits():
    """bf16 pools save widened to float32 and load back bit-exact; a
    2-byte void array (bf16 written by a numpy that knew the type) is
    reinterpreted bit for bit."""
    from repro_torch.serve.kv_pages import _from_numpy, _to_numpy
    x = torch.randn(3, 5).to(torch.bfloat16)
    like = torch.empty(0, dtype=torch.bfloat16)
    assert torch.equal(_from_numpy(_to_numpy(x), like), x)
    void = x.view(torch.int16).numpy().view(np.dtype("V2"))
    assert torch.equal(_from_numpy(void, like), x)


def test_tiny_layernorm_gelu_greedy_equals_jax():
    """``test_serve.py``'s tiny config (layernorm + gelu), greedy."""
    jr = tiny_rcfg()
    tr = TRunConfig(
        model=TModelConfig(**dataclasses.asdict(jr.model)),
        mgrit=TMGRIT(**dataclasses.asdict(jr.mgrit)),
        optimizer=TOpt(), shape=TShape("srv", "train", 16, 4))
    jp = jax.jit(jtr.init_model, static_argnums=1)(jax.random.PRNGKey(0), jr)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tr, "cpu")
    specs = [dict(s, temperature=0.0, top_k=0, top_p=1.0,
                  prompt=s["prompt"][:12])
             for s in queue(TINY_VOCAB, seed=4, n=5)]
    kw = dict(max_len=TINY_MAX_LEN, max_batch=2, page_size=4)
    want = outputs(JEngine(jr, jp, **kw), JRequest, specs)
    got = outputs(TEngine(tr, tp, device="cpu", **kw), TRequest, specs)
    assert got == want


def test_entry_points_refuse_to_leave_the_card(qwen, monkeypatch):
    """Without a CUDA device, the default device raises (never a silent
    CPU run); a mesh on another device than the engine's is refused."""
    tr, tp, *_ = qwen
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TEngine(tr, tp, max_len=MAX_LEN)
    from repro_torch.models import transformer as ttr
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttr.init_model(tr)
    with pytest.raises(SystemExit):
        serve_cli.main(["--arch", "qwen3_1p7b", "--reduced"])
    with pytest.raises(ValueError, match="the mesh is on cuda"):
        t_engine(tr, tp, mesh=types.SimpleNamespace(device_type="cuda"))


def test_serve_cli_runs_on_cpu(capsys):
    assert serve_cli.main(["--arch", "qwen3_1p7b", "--reduced", "--device",
                           "cpu", "--requests", "4", "--max-batch", "2",
                           "--page-size", "8", "--new-tokens", "3",
                           "--temperature", "0.7", "--top-k", "10",
                           "--stats"]) == 0
    out = capsys.readouterr().out
    assert "PagedKVBackend on cpu" in out
    assert out.count("-> [") == 4
