"""The reference's paged-equals-dense contracts, kept inside the port.

``dense_decode_oracle`` below is the port's twin of
``tests/serve_oracle.py::dense_decode_oracle``: the port's
``transformer.decode_step`` a token a call (prompt, then every emitted
token) plus the port's ``sample_tokens`` keyed by the request's (seed,
tokens emitted) counter. Every stream the port's paged engine emits must
equal it token for token, greedy and seeded sampled, on the decoder,
SSM (mamba1, mamba2) and hybrid families — the mirrors of
``test_serve_backends.py::test_every_family_samples_and_temp0_is_greedy``,
``test_serve_fuzz.py::test_backend_conformance_fuzz_seeded`` and
``test_serve_sampling.py``'s engine tests, on the same tiny float32
configs. One cross-framework anchor per family holds the port's oracle
to JAX's ``dense_decode_oracle`` on the greedy request (weights
converted by ``params_from_jax``). Also: the dense
``throughput_probe(paged=False)`` on the CPU, ``make_backend``'s refusal
of the encoder-decoder family, and the dense entry points' refusal to
leave the card.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs.base import MGRITConfig as JMGRIT
from repro.configs.base import ModelConfig as JModel
from repro.configs.base import MoEConfig as JMoE
from repro.configs.base import OptimizerConfig as JOpt
from repro.configs.base import RunConfig as JRun
from repro.configs.base import ShapeConfig as JShape
from repro.configs.base import SSMConfig as JSSM
from repro.models import transformer as jtr
from repro_torch.configs.base import (MGRITConfig, ModelConfig, MoEConfig,
                                      OptimizerConfig, RunConfig,
                                      ShapeConfig, SSMConfig)
from repro_torch.configs.reduce import reduce_config as t_reduce
from repro_torch.configs.registry import get_config as t_get_config
from repro_torch.convert import params_from_jax
from repro_torch.launch.steps import sample_tokens
from repro_torch.models import transformer as ttr
from repro_torch.serve.cache import (HybridBackend, PagedKVBackend,
                                     SSMStateBackend, make_backend)
from repro_torch.serve.engine import Request, ServeEngine
from serve_oracle import dense_decode_oracle as jax_dense_oracle

torch.set_num_threads(2)
VOCAB = 64
MAX_LEN = 32

# test_serve_backends.py's FAMILY_MODELS, as keyword arguments of either
# package's configs
FAMILIES = {
    "decoder": dict(family="decoder"),
    "decoder_moe": dict(family="decoder",
                        moe=dict(num_experts=4, top_k=2, d_ff=64)),
    "ssm_mamba1": dict(family="ssm", n_layers=4, act="silu", norm="rmsnorm",
                       ssm=(1, dict(d_state=8, d_conv=3))),
    "ssm_mamba2": dict(family="ssm", n_layers=4, act="silu", norm="rmsnorm",
                       ssm=(2, dict(d_state=8, d_conv=3, headdim=16))),
    "hybrid": dict(family="hybrid", n_layers=5, hybrid_attn_every=2,
                   act="silu", norm="rmsnorm",
                   ssm=(2, dict(d_state=8, d_conv=3, headdim=16))),
}
EXPECTED_BACKEND = {"decoder": PagedKVBackend,
                    "decoder_moe": PagedKVBackend,
                    "ssm_mamba1": SSMStateBackend,
                    "ssm_mamba2": SSMStateBackend, "hybrid": HybridBackend}


def family_rcfg(name, *, port=True, vocab=VOCAB, **over):
    """The reference's tiny float32 family config (``test_serve_backends.
    py``'s; ``over`` gives ``test_serve_fuzz.py``'s narrower one)."""
    Model, SSM, MoE, MG, Opt, Shape, Run = (
        (ModelConfig, SSMConfig, MoEConfig, MGRITConfig, OptimizerConfig,
         ShapeConfig, RunConfig) if port
        else (JModel, JSSM, JMoE, JMGRIT, JOpt, JShape, JRun))
    kw = dict(name=name, family="decoder", n_layers=8, d_model=32,
              n_heads=2, n_kv_heads=2, d_ff=64, vocab_size=vocab,
              act="gelu", norm="layernorm", dtype="float32")
    kw.update(FAMILIES[name])
    kw.update(over)
    if "ssm" in kw:
        version, skw = kw["ssm"]
        kw["ssm"] = SSM(version=version, **skw)
    if "moe" in kw:
        kw["moe"] = MoE(**kw["moe"])
    return Run(model=Model(**kw),
               mgrit=MG(enabled=True, cf=2, levels=2, fwd_iters=1,
                        bwd_iters=1, n_open=1, n_close=1, pad_to=2),
               optimizer=Opt(), shape=Shape(name, "train", 16, 4))


def dense_decode_oracle(rcfg, params, req, max_len: int,
                        fused: bool = False) -> np.ndarray:
    """Greedy-or-sampled reference stream of one request (any object with
    prompt / max_new_tokens / temperature / top_k / top_p / seed /
    eos_id): the dense cache of batch 1 filled a token a call, then one
    ``sample_tokens`` draw per emitted token, keyed (seed, n). ``fused``
    picks the sampler's mask (the reference's oracle sorts)."""
    dev = next(iter(params["embed"].values())).device
    cache = ttr.init_cache(rcfg, 1, max_len, device=dev)
    prompt = torch.as_tensor(np.asarray(req.prompt, np.int64),
                             device=dev)[None]
    lg = None
    for i in range(prompt.shape[1]):
        lg, cache = ttr.decode_step(params, cache, prompt[:, i:i + 1], rcfg)

    def vec(x, dtype):
        return torch.tensor([x], dtype=dtype, device=dev)

    out = []
    for n in range(req.max_new_tokens):
        nxt = sample_tokens(lg[:, -1], vec(req.temperature, torch.float32),
                            vec(req.top_k, torch.int32),
                            vec(req.top_p, torch.float32),
                            vec(req.seed, torch.long), vec(n, torch.long),
                            any_sampled=req.temperature > 0, fused=fused)
        tok = int(nxt[0])
        out.append(tok)
        if req.eos_id is not None and tok == req.eos_id:
            break
        if n < req.max_new_tokens - 1:
            lg, cache = ttr.decode_step(
                params, cache, torch.tensor([[tok]], device=dev), rcfg)
    return np.asarray(out, np.int32)


def port_family(name, seed=0, **over):
    rcfg = family_rcfg(name, **over)
    return rcfg, ttr.init_model(rcfg, seed=seed, device="cpu")


def engine(rcfg, params, **kw):
    return ServeEngine(rcfg, params, device="cpu",
                       **{"max_len": MAX_LEN, "max_batch": 2,
                          "page_size": 4, **kw})


GREEDY = dict(prompt=np.array([5, 9, 3, 7, 2], np.int32), max_new_tokens=5)
SAMPLED = dict(prompt=np.array([4, 2, 9], np.int32), max_new_tokens=5,
               temperature=1.1, top_k=16, top_p=0.9, seed=7)


# ---------------------------------------------------------------------------
# 1. The paged engine equals the port's dense oracle
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_every_family_samples_and_temp0_is_greedy(name):
    """Every family's backend serves a greedy and a seeded sampled request
    whose streams equal the dense oracle's token for token."""
    rcfg, params = port_family(name)
    eng = engine(rcfg, params)
    assert isinstance(eng.backend, EXPECTED_BACKEND[name])
    reqs = [Request(**GREEDY), Request(**SAMPLED)]
    for r in eng.generate(reqs):
        np.testing.assert_array_equal(
            r.output, dense_decode_oracle(rcfg, params, r, MAX_LEN))


@pytest.mark.parametrize("fam,seed", [("ssm_mamba1", 0), ("hybrid", 1),
                                      ("decoder", 2)])
def test_backend_conformance_fuzz_seeded(fam, seed):
    """``test_serve_fuzz.py``'s seeded twin of the conformance suite: three
    waves of random mixed queues (a shared prefix, greedy and seeded
    sampled, EOS-free) through one engine, every stream the dense
    oracle's; the slots drain."""
    vocab, max_len = 32, 24
    over = dict(n_layers=4, d_model=16, d_ff=32, vocab=vocab, act="gelu",
                norm="layernorm")
    if fam == "hybrid":
        over["n_layers"] = 5
    rcfg, params = port_family(fam, seed=10 + seed, **over)
    eng = engine(rcfg, params, max_len=max_len)
    rng = np.random.default_rng(seed)
    common = rng.integers(0, vocab, size=8).astype(np.int32)
    for _ in range(3):                     # waves reuse the prefix trie
        reqs = []
        for _ in range(int(rng.integers(1, 4))):
            tail = rng.integers(0, vocab, size=int(
                rng.integers(1, 6))).astype(np.int32)
            prompt = np.concatenate([common, tail]) \
                if rng.random() < 0.5 else tail
            sampled = rng.random() < 0.4
            reqs.append(Request(
                prompt=prompt, max_new_tokens=int(rng.integers(1, 5)),
                temperature=0.9 if sampled else 0.0,
                top_k=int(rng.choice([0, 8])) if sampled else 0,
                top_p=float(rng.choice([1.0, 0.9])) if sampled else 1.0,
                seed=int(rng.integers(0, 100))))
        for r in eng.generate(reqs):
            np.testing.assert_array_equal(
                r.output, dense_decode_oracle(rcfg, params, r, max_len))
    assert eng.scheduler.n_active == 0


@pytest.fixture(scope="module")
def smp():
    """``test_serve_sampling.py``'s engine config (the decoder family)."""
    return port_family("decoder")


def test_temperature_zero_matches_greedy_engine(smp):
    """Temperature 0 with top-k / top-p set is the greedy path, which is
    the dense oracle's."""
    rcfg, params = smp
    prompt = np.array([5, 9, 3, 7, 2, 11], np.int32)
    eng = engine(rcfg, params)
    ref = eng.generate([Request(prompt=prompt, max_new_tokens=6)])[0]
    got = eng.generate([Request(prompt=prompt, max_new_tokens=6,
                                temperature=0.0, top_k=3, top_p=0.5,
                                seed=9)])[0]
    np.testing.assert_array_equal(got.output, ref.output)
    np.testing.assert_array_equal(
        ref.output, dense_decode_oracle(rcfg, params, ref, MAX_LEN))


def test_same_seed_same_output_in_any_slot(smp):
    """A seeded request emits the same stream alone and behind fillers in
    another slot, and it is the dense oracle's (with the mask the engine
    runs, ``fused=True``, and the sort)."""
    rcfg, params = smp
    target = dict(prompt=np.array([4, 2, 9, 1], np.int32), max_new_tokens=6,
                  temperature=1.0, top_k=16, top_p=0.95, seed=123)
    solo = engine(rcfg, params, max_batch=3).generate(
        [Request(**target)])[0]
    fillers = [Request(prompt=np.array([7, 7, 3], np.int32),
                       max_new_tokens=8, temperature=0.7, seed=i)
               for i in range(2)]
    crowd = engine(rcfg, params, max_batch=3).generate(
        fillers + [Request(**target)])
    np.testing.assert_array_equal(solo.output, crowd[-1].output)
    for fused in (False, True):
        np.testing.assert_array_equal(
            solo.output, dense_decode_oracle(rcfg, params, solo, MAX_LEN,
                                             fused=fused))
    for r in crowd[:-1]:
        np.testing.assert_array_equal(
            r.output, dense_decode_oracle(rcfg, params, r, MAX_LEN))


def test_mixed_greedy_sampled_batch_keeps_greedy_exact(smp):
    """A sampled neighbour does not perturb a greedy slot; both streams
    are the dense oracle's."""
    rcfg, params = smp
    gprompt = np.array([1, 2, 3, 4, 5, 6], np.int32)
    eng = engine(rcfg, params)
    ref = eng.generate([Request(prompt=gprompt, max_new_tokens=6)])[0]
    mixed = eng.generate([
        Request(prompt=gprompt, max_new_tokens=6),
        Request(prompt=np.array([9, 8, 7], np.int32), max_new_tokens=6,
                temperature=1.3, top_k=8, seed=5)])
    np.testing.assert_array_equal(mixed[0].output, ref.output)
    for r in mixed:
        np.testing.assert_array_equal(
            r.output, dense_decode_oracle(rcfg, params, r, MAX_LEN))


def test_bad_sampling_params_rejected(smp):
    rcfg, params = smp
    eng = engine(rcfg, params)
    for bad in (dict(temperature=-0.1), dict(top_k=-1), dict(top_p=0.0),
                dict(top_p=1.5)):
        with pytest.raises(ValueError):
            eng.generate([Request(prompt=np.array([1, 2], np.int32),
                                  max_new_tokens=2, **bad)])


# ---------------------------------------------------------------------------
# 2. The port's oracle is the reference's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_dense_oracle_matches_jax(name):
    """On JAX's weights the port's dense oracle emits JAX's
    ``dense_decode_oracle`` stream for the greedy request."""
    jr = family_rcfg(name, port=False)
    tr = family_rcfg(name)
    jp = jax.jit(jtr.init_model, static_argnums=1)(jax.random.PRNGKey(3), jr)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tr, "cpu")
    step = jax.jit(lambda p, c, t: jtr.decode_step(p, c, t, jr))
    req = Request(**GREEDY)
    np.testing.assert_array_equal(
        dense_decode_oracle(tr, tp, req, MAX_LEN),
        jax_dense_oracle(jr, jp, step, req, MAX_LEN))


# ---------------------------------------------------------------------------
# 3. Probe, refusals
# ---------------------------------------------------------------------------


def test_dense_throughput_probe_on_cpu(smp):
    """``throughput_probe(paged=False)`` runs the dense step on the
    engine's device and returns a positive rate."""
    rcfg, params = smp
    eng = engine(rcfg, params)
    assert eng.throughput_probe(2, steps=3, paged=False) > 0
    assert eng.throughput_probe(2, steps=3, paged=True) > 0


def test_make_backend_refuses_encdec_naming_the_reference():
    """The encoder-decoder family decodes through decode_step(xa=...), not
    the paged engine: make_backend says why, as the reference does."""
    rcfg = t_reduce(t_get_config("mt_marian"))
    with pytest.raises(NotImplementedError,
                       match="per-request encoder state.*decode_step"):
        make_backend(rcfg, {}, device="cpu")


def test_dense_entry_points_refuse_to_leave_the_card(smp):
    """Without a card ``init_cache`` raises unless given ``device="cpu"``;
    decode_step runs where its cache lives."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    rcfg, params = smp
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttr.init_cache(rcfg, 1, 8)
    cache = ttr.init_cache(rcfg, 1, 8, device="cpu")
    lg, cache = ttr.decode_step(params, cache, torch.ones((1, 1),
                                                          dtype=torch.long),
                                rcfg)
    assert lg.device.type == "cpu" and int(cache["index"]) == 1
