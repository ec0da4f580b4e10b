"""Speculative decoding in the port, function by function, against the
JAX package: the coarse draft's params, the draft sampler, the
acceptance rule, and each family's verify step and deferred commit.

Models are the reduced ``qwen3_1p7b`` (decoder), ``falcon_mamba_7b``
(mamba1) and ``zamba2_1p2b`` (mamba2 + shared attention) in float32,
with the JAX init's weights converted by ``params_from_jax``; every
other input is made with numpy from a seed.

Tolerances: the draft's params are the fine weights (or, for the hybrid
``out_proj``, the weights times a small integer), so they are compared
bit for bit. Sampled tokens and accepted counts are equal; proposal
probabilities within 1e-6 (the Gumbel noise differs from JAX's by at
most 2**-20, ROADMAP "Accepted differences"). Verify logits, artifacts
and the pools after the commit within 2e-5 (rtol and atol; each
framework runs its own matmuls). Within the port, the fused and the
gathered verify are bitwise equal on the CPU.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.reduce import reduce_config as j_reduce
from repro.configs.registry import get_config as j_get_config
from repro.launch import steps as jsteps
from repro.models import transformer as jtr
from repro_torch.configs.reduce import reduce_config as t_reduce
from repro_torch.configs.registry import get_config as t_get_config
from repro_torch.convert import params_from_jax
from repro_torch.launch import steps as tsteps
from repro_torch.models import transformer as ttr
from repro_torch.serve.kv_pages import state_leaves

torch.set_num_threads(2)
PAGE, B, P = 4, 3, 4
ARCHS = {"decoder": "qwen3_1p7b", "ssm": "falcon_mamba_7b",
         "hybrid": "zamba2_1p2b"}
TOL = dict(rtol=2e-5, atol=2e-5)


def f32(rcfg):
    return rcfg.replace(model=dataclasses.replace(rcfg.model,
                                                  dtype="float32"))


@pytest.fixture(scope="module", params=sorted(ARCHS))
def fam(request):
    """(family, JAX rcfg, JAX params, port rcfg, port params)."""
    arch = ARCHS[request.param]
    jr = f32(j_reduce(j_get_config(arch, "decode_32k")))
    tr = f32(t_reduce(t_get_config(arch, "decode_32k")))
    jp = jax.jit(jtr.init_model, static_argnums=1)(jax.random.PRNGKey(2), jr)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tr, "cpu")
    return request.param, jr, jp, tr, tp


# ---------------------------------------------------------------------------
# 1. The coarse draft's params, leaf for leaf
# ---------------------------------------------------------------------------


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        return [pl for k in sorted(tree) for pl in _leaves(tree[k],
                                                           prefix + (k,))]
    return [(prefix, tree)]


@pytest.mark.parametrize("cf", [3, 4])
def test_coarse_draft_params_match_jax(fam, cf):
    """Every leaf of the draft equals JAX's; the restricted layers are
    views of the fine weights (the draft copies none but the hybrid's
    rescaled ``out_proj``); the draft rcfg and depth agree."""
    name, jr, jp, tr, tp = fam
    jd, jrc, jn = jtr.coarse_draft_params(jp, jr, cf)
    td, trc, tn = ttr.coarse_draft_params(tp, tr, cf)
    assert tn == jn
    assert trc.model.n_layers == jrc.model.n_layers
    assert trc.model.hybrid_attn_every == jrc.model.hybrid_attn_every
    jl = dict(_leaves(jax.tree.map(np.asarray, jd)))
    if name == "hybrid":
        tl = dict(_leaves(td))
        assert sorted(tl) == sorted(jl)
        for path, t in tl.items():
            np.testing.assert_array_equal(t.numpy(), jl[path], str(path))
        fine = tp["backbone"]["mixer"]["in_proj"]
        assert td["backbone"]["mixer"]["in_proj"].data_ptr() == \
            fine.data_ptr()
        return
    layers = td["mid"]["params"]
    assert isinstance(layers, list) and len(layers) == tn
    np.testing.assert_array_equal(td["mid"]["gate"].numpy(),
                                  jl[("mid", "gate")])
    fine, _ = ttr._all_layers_stacked(tp)
    for j, layer in enumerate(layers):
        for path, t in _leaves(layer):
            np.testing.assert_array_equal(
                t.numpy(), jl[("mid", "params") + path][j], str(path))
            src = dict(_leaves(fine[j * cf]))[path]
            assert t.data_ptr() == src.data_ptr()        # a view, no copy
    for key in ("embed", "final_norm"):
        assert td[key] is tp[key]


# ---------------------------------------------------------------------------
# 2. Draft sampling and acceptance on seeded logits
# ---------------------------------------------------------------------------

V = 64
SAMPLING = {    # temps, top_ks, top_ps per slot
    "greedy": ([0.0, 0.0, 0.0, 0.0], [0, 0, 0, 0], [1.0] * 4),
    "sampled": ([0.8, 1.3, 0.0, 0.6], [0, 0, 0, 0], [1.0] * 4),
    "top_k": ([0.9, 1.1, 0.7, 0.0], [5, 1, 12, 0], [1.0] * 4),
    "top_p": ([1.0, 0.7, 0.0, 1.4], [0, 0, 0, 7], [0.9, 0.5, 1.0, 0.8]),
}


def _sampling(kind, n=4):
    temps, ks, ps = SAMPLING[kind]
    rng = np.random.default_rng(len(kind))
    return (np.asarray(temps[:n], np.float32), np.asarray(ks[:n], np.int32),
            np.asarray(ps[:n], np.float32),
            rng.integers(0, 2**31, n).astype(np.int32),
            rng.integers(0, 40, n).astype(np.int32))


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


@pytest.mark.parametrize("kind", sorted(SAMPLING))
def test_draft_sample_tokens_match_jax(kind):
    rng = np.random.default_rng(3)
    logits = (3 * rng.standard_normal((4, V))).astype(np.float32)
    samp = _sampling(kind)
    jt, jq = jsteps.draft_sample_tokens(jnp.asarray(logits),
                                        *map(jnp.asarray, samp))
    tt, tq = tsteps.draft_sample_tokens(
        *_t(logits, *samp), any_sampled=bool(np.any(samp[0] > 0)))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), rtol=0,
                               atol=1e-6)
    greedy = samp[0] <= 0
    np.testing.assert_array_equal(tq.numpy()[greedy].max(-1), 1.0)


def _accept_case(kind, k=4):
    """Four slots: idle (n_new 0); every draft accepted (the drafts sit on
    a dominant logit, each proposed one-hot); rejection at position 0
    (the first draft's logit 30 below the rest, top-k excluding it where
    a top-k is set); and random drafts with a random proposal."""
    rng = np.random.default_rng(17 + len(kind))
    S = k + 1
    logits = (2 * rng.standard_normal((4, S, V))).astype(np.float32)
    tokens = rng.integers(0, V, (4, S)).astype(np.int32)
    q = rng.random((4, k, V)).astype(np.float32)
    q /= q.sum(-1, keepdims=True)
    for i in range(k):
        d = tokens[1, i + 1]
        logits[1, i, d] = 40.0
        q[1, i] = 0.0
        q[1, i, d] = 1.0
    logits[2, 0, tokens[2, 1]] = logits[2, 0].min() - 30.0
    q[2, 0] = 0.0
    q[2, 0, tokens[2, 1]] = 1.0
    n_new = np.asarray([0, S, S, 3], np.int32)
    return logits, tokens, q, n_new


@pytest.mark.parametrize("kind", sorted(SAMPLING))
def test_speculative_accept_matches_jax(kind):
    logits, tokens, q, n_new = _accept_case(kind)
    temps, ks, ps, seeds, counters = _sampling(kind)
    if kind == "top_k":
        ks[2] = 3          # the rejected draft is outside the top 3
    samp = (temps, ks, ps, seeds, counters)
    ja, jn = jsteps.speculative_accept(
        jnp.asarray(logits), jnp.asarray(tokens), jnp.asarray(q),
        *map(jnp.asarray, samp), jnp.asarray(n_new))
    ta, tn = tsteps.speculative_accept(
        *_t(logits, tokens, q, *samp, n_new),
        any_sampled=bool(np.any(temps > 0)))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    acc = ta.numpy()
    assert acc[0] == 0                      # idle slot
    assert acc[1] == 4                      # every draft accepted
    assert acc[2] == 0                      # rejected at position 0
    assert 0 <= acc[3] <= 2                 # n_new 3: at most 2 drafts


# ---------------------------------------------------------------------------
# 3. Verify steps and the deferred commit
# ---------------------------------------------------------------------------


def _fns(name, jr, tr):
    """(JAX init, decode, verify, commit), the port's likewise."""
    n_pages = 1 + B * P
    if name == "decoder":
        return ((lambda: jtr.init_paged_cache(jr, n_pages, PAGE),
                 jtr.paged_decode_step, jtr.paged_verify_step, None),
                (lambda: ttr.init_paged_cache(tr, n_pages, PAGE),
                 ttr.paged_decode_step, ttr.paged_verify_step, None))
    if name == "ssm":
        return ((lambda: jtr.init_paged_ssm_cache(jr, n_pages),
                 jtr.ssm_paged_decode_step, jtr.ssm_paged_verify_step,
                 jtr.ssm_paged_commit_step),
                (lambda: ttr.init_paged_ssm_cache(tr, n_pages),
                 ttr.ssm_paged_decode_step, ttr.ssm_paged_verify_step,
                 ttr.ssm_paged_commit_step))
    return ((lambda: jtr.init_paged_hybrid_cache(jr, n_pages, PAGE),
             jtr.hybrid_paged_decode_step, jtr.hybrid_paged_verify_step,
             jtr.hybrid_paged_commit_step),
            (lambda: ttr.init_paged_hybrid_cache(tr, n_pages, PAGE),
             ttr.hybrid_paged_decode_step, ttr.hybrid_paged_verify_step,
             ttr.hybrid_paged_commit_step))


def _kw(name):
    return {} if name == "decoder" else {"page_size": PAGE}


def _pools_close(t_state, j_state):
    """Every pool page but scratch page 0 within TOL."""
    j_leaves = jax.tree.leaves(j_state)
    for t, j in zip(state_leaves(t_state), j_leaves, strict=True):
        np.testing.assert_allclose(t[:, 1:].numpy(), np.asarray(j)[:, 1:],
                                   **TOL)


def test_verify_and_commit_match_jax(fam):
    """A prefill, then a verify window of k+1 = 5 over slots at lengths
    6 / 3 / 0 (the last idle): logits at the real positions, the SSM
    artifacts and the pools within TOL of JAX's; the snapshot pools are
    untouched by the verify. Then a commit of 3 / 2 / 0 steps: pools
    within TOL again. The port runs the fused and the gathered path,
    which agree bit for bit."""
    name, jr, jp, tr, tp = fam
    (j_init, j_dec, j_ver, j_com), (t_init, t_dec, t_ver, t_com) = \
        _fns(name, jr, tr)
    kw = _kw(name)
    rng = np.random.default_rng(4)
    vocab = tr.model.vocab_size
    table = (1 + np.arange(B * P)).reshape(B, P).astype(np.int32)
    pre = rng.integers(0, vocab, (B, 8)).astype(np.int32)
    pre_n = np.asarray([6, 3, 0], np.int32)
    ver = rng.integers(0, vocab, (B, 5)).astype(np.int32)
    ver_n = np.asarray([5, 3, 0], np.int32)
    n_write = np.asarray([3, 2, 0], np.int32)
    zeros = np.zeros((B,), np.int32)

    def jit(fn):
        return jax.jit(lambda *a: fn(*a, jr, **kw))

    jstate = j_init()
    _, jstate = jit(j_dec)(jp, jstate, pre, zeros, pre_n, table)
    j_logits, jstate, j_art = jit(j_ver)(jp, jstate, ver, pre_n, ver_n,
                                         table)
    if j_com is not None:
        jstate_c = jax.jit(lambda *a: j_com(*a, **kw))(
            jstate, j_art, table, pre_n, n_write)

    sp = ttr.serving_params(tp, tr.model)
    tab = torch.from_numpy(table)
    got = {}
    for fused in (True, False):
        state = t_init()
        t_dec(sp, state, *_t(pre), torch.from_numpy(zeros),
              torch.from_numpy(pre_n).long(), tab, tr, fused=fused, **kw)
        snap = state if name != "hybrid" else state["mamba"]
        before = [leaf.clone() for leaf in state_leaves(snap)]
        logits, state, art = t_ver(
            sp, state, torch.from_numpy(ver).long(), torch.from_numpy(pre_n),
            torch.from_numpy(ver_n).long(), tab, tr, fused=fused, **kw)
        valid = (np.arange(5)[None, :] < ver_n[:, None])[..., None]
        np.testing.assert_allclose(logits.numpy() * valid,
                                   np.asarray(j_logits) * valid, **TOL)
        if name == "decoder":
            assert art is None
            _pools_close(state, jstate)
            got[fused] = (logits, [], [leaf.clone() for leaf in
                                       state_leaves(state)])
            continue
        assert all(torch.equal(a, b) for a, b in
                   zip(before, state_leaves(snap), strict=True))
        if name == "hybrid":
            _pools_close(state["attn"], jstate["attn"])
        for key in ("xp", "hs"):
            assert len(art[key]) == np.asarray(j_art[key]).shape[0]
            for i, a in enumerate(art[key]):
                np.testing.assert_allclose(a.numpy(),
                                           np.asarray(j_art[key][i]), **TOL)
        state = t_com(state, art, tab, torch.from_numpy(pre_n),
                      torch.from_numpy(n_write).long(), page_size=PAGE)
        _pools_close(state, jstate_c)
        got[fused] = (logits, [a.clone() for key in ("xp", "hs")
                               for a in art[key]],
                      [leaf.clone() for leaf in state_leaves(state)])
    assert torch.equal(got[True][0], got[False][0])
    for a, b in zip(got[True][1], got[False][1], strict=True):
        assert torch.equal(a, b)
    # pool leaves past page 0, the scratch page
    for a, b in zip(got[True][2], got[False][2], strict=True):
        assert torch.equal(a[:, 1:], b[:, 1:])
