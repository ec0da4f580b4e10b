"""The port's model layers against the JAX package's, float32 on the CPU.

Inputs are made with numpy from a seed; JAX params are converted with
``repro_torch.convert.params_from_jax``. Tolerances: 1e-5 for the
elementwise layers, 2e-5 for attention (the repo's float32 attention
tolerance), 1e-4 for a whole paged step's logits.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JModelConfig
from repro.configs.reduce import reduce_config as j_reduce
from repro.configs.registry import get_config as j_get_config
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import mlp as jmlp
from repro.models import transformer as jtr
from repro_torch.configs.base import ModelConfig as TModelConfig
from repro_torch.configs.reduce import reduce_config as t_reduce
from repro_torch.configs.registry import get_config as t_get_config
from repro_torch.convert import params_from_jax
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import mlp as tmlp
from repro_torch.models import transformer as ttr

torch.set_num_threads(2)
TOL = 1e-5
ATTN_TOL = 2e-5
LOGIT_TOL = 1e-4


def cfgs(**kw):
    base = dict(d_model=32, n_heads=4, n_kv_heads=2, d_ff=64,
                vocab_size=64, head_dim=8, dtype="float32", qk_norm=True)
    base.update(kw)
    return JModelConfig(**base), TModelConfig(**base)


def rnd(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale) \
        .astype(np.float32)


def t(a):
    return torch.from_numpy(np.array(a))


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm"])
def test_norm_apply_matches_jax(norm):
    jc, tc = cfgs(norm=norm)
    x = rnd(0, (2, 5, 32), 3.0)
    p = {"scale": rnd(1, (32,)) + 1.0, "bias": rnd(2, (32,))}
    if norm == "rmsnorm":
        del p["bias"]
    want = jlayers.norm_apply(jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                              jc)
    got = tlayers.norm_apply({k: t(v) for k, v in p.items()}, t(x), tc)
    close(got, want, TOL)


def test_rms_norm_matches_jax():
    x, s = rnd(3, (2, 5, 4, 8), 2.0), rnd(4, (8,)) + 1.0
    close(tlayers.rms_norm(t(x), t(s)),
          jlayers.rms_norm(jnp.asarray(x), jnp.asarray(s)), TOL)


@pytest.mark.parametrize("per_slot", [False, True])
def test_rope_matches_jax(per_slot):
    hd, theta = 16, 1e6
    pos = np.arange(7, dtype=np.int32) + 3
    if per_slot:
        pos = pos[None, :] + np.asarray([[0], [40]], np.int32)
    jc, js = jlayers.rope_freqs(hd, theta, jnp.asarray(pos))
    tc_, ts = tlayers.rope_freqs(hd, theta, t(pos))
    close(tc_, jc, TOL)
    close(ts, js, TOL)
    x = rnd(5, (2, 7, 4, hd))
    close(tlayers.apply_rope(t(x), tc_, ts),
          jlayers.apply_rope(jnp.asarray(x), jc, js), TOL)


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_mlp_apply_matches_jax(act):
    jc, tc = cfgs(act=act)
    p = jmlp.init_mlp(jax.random.PRNGKey(0), jc)
    x = rnd(6, (2, 5, 32))
    want = jmlp.mlp_apply(p, jnp.asarray(x), jc)
    got = tmlp.mlp_apply(jax.tree.map(lambda a: t(a), np_tree(p)), t(x), tc)
    close(got, want, TOL)


def paged_case(seed, B=3, S=4, page_size=4, pages_per_slot=4):
    rng = np.random.default_rng(seed)
    jc, tc = cfgs()
    hd, hkv = jc.resolved_head_dim, jc.n_kv_heads
    n_pages = 1 + B * pages_per_slot
    x = rnd(seed, (B, S, jc.d_model))
    pk = rnd(seed + 1, (n_pages, page_size, hkv, hd), 0.5)
    pv = rnd(seed + 2, (n_pages, page_size, hkv, hd), 0.5)
    table = (1 + rng.permutation(B * pages_per_slot)).reshape(
        B, pages_per_slot).astype(np.int32)
    lengths = np.asarray([0, 5, 9][:B], np.int32)
    n_new = np.asarray([S, 1, 0][:B], np.int32)        # prefill/decode/idle
    pos = lengths[:, None] + np.arange(S)[None, :]
    return jc, tc, x, pk, pv, table, lengths, n_new, pos


@pytest.mark.parametrize("fused", [False, True])
def test_paged_attention_apply_matches_jax(fused):
    jc, tc, x, pk, pv, table, lengths, n_new, pos = paged_case(7)
    p = jattn.init_attention(jax.random.PRNGKey(1), jc)
    jrope = jlayers.rope_freqs(jc.resolved_head_dim, jc.rope_theta,
                               jnp.asarray(pos))
    y, npk, npv = jattn.paged_attention_apply(
        p, jnp.asarray(x), jc, rope=jrope, pk=jnp.asarray(pk),
        pv=jnp.asarray(pv), page_table=jnp.asarray(table),
        lengths=jnp.asarray(lengths), n_new=jnp.asarray(n_new), fused=fused)
    tpk, tpv = t(pk), t(pv)
    trope = tlayers.rope_freqs(tc.resolved_head_dim, tc.rope_theta, t(pos))
    got = tattn.paged_attention_apply(
        jax.tree.map(lambda a: t(a), np_tree(p)), t(x), tc, rope=trope,
        pk=tpk, pv=tpv, page_table=t(table), lengths=t(lengths),
        n_new=t(n_new), fused=fused)
    valid = np.arange(x.shape[1])[None, :] < n_new[:, None]
    close(got.numpy()[valid], np.asarray(y)[valid], ATTN_TOL)
    # the in-place pool writes equal the reference's new pools (scratch
    # page 0 takes the discarded rows in unspecified order: excluded)
    close(tpk.numpy()[1:], np.asarray(npk)[1:], ATTN_TOL)
    close(tpv.numpy()[1:], np.asarray(npv)[1:], ATTN_TOL)


@pytest.fixture(scope="module")
def qwen_reduced():
    """Reduced qwen3_1p7b in float32, JAX params and their conversion."""
    jr = j_reduce(j_get_config("qwen3_1p7b", "decode_32k"))
    jr = jr.replace(model=dataclasses.replace(jr.model, dtype="float32"))
    tr = t_reduce(t_get_config("qwen3_1p7b", "decode_32k"))
    tr = tr.replace(model=dataclasses.replace(tr.model, dtype="float32"))
    jp = jax.jit(jtr.init_model, static_argnums=1)(jax.random.PRNGKey(0), jr)
    tp = params_from_jax(np_tree(jp), tr, "cpu")
    return jr, tr, jp, tp


@pytest.mark.parametrize("fused", [False, True])
def test_paged_decode_step_logits_match_jax(qwen_reduced, fused):
    """One prefill step (S = bucket, ragged n_new) then one decode step
    (S = 1) on the same pools: last-token logits within 1e-4."""
    jr, tr, jp, tp = qwen_reduced
    B, ps, pages_per_slot = 3, 8, 4
    rng = np.random.default_rng(11)
    n_pages = 1 + B * pages_per_slot
    table = (1 + np.arange(B * pages_per_slot)).reshape(B, -1) \
        .astype(np.int32)
    jpages = jtr.init_paged_cache(jr, n_pages, ps)
    tpages = ttr.init_paged_cache(tr, n_pages, ps, device="cpu")
    lengths = np.zeros((B,), np.int32)
    n_new = np.asarray([13, 16, 5], np.int32)
    V = jr.model.vocab_size
    for S in (16, 1):
        toks = rng.integers(0, V, (B, S)).astype(np.int32)
        jl, jpages = jtr.paged_decode_step(
            jp, jpages, jnp.asarray(toks), jnp.asarray(lengths),
            jnp.asarray(n_new), jnp.asarray(table), jr, fused=fused)
        tl, tpages = ttr.paged_decode_step(
            tp, tpages, t(toks).long(), t(lengths), t(n_new).long(),
            t(table), tr, fused=fused)
        close(tl, jl, LOGIT_TOL)
        lengths = lengths + n_new
        n_new = np.ones((B,), np.int32)


def test_params_from_jax_checks_paths_and_shapes(qwen_reduced):
    jr, tr, jp, _ = qwen_reduced
    tree = np_tree(jp)
    tree["mid"]["params"]["attn"]["wq"] = tree["mid"]["params"]["attn"][
        "wq"][:, :1]
    with pytest.raises(ValueError, match="mid.params.attn.wq"):
        params_from_jax(tree, tr, "cpu")
    tree = np_tree(jp)
    del tree["final_norm"]
    with pytest.raises(ValueError, match="keys"):
        params_from_jax(tree, tr, "cpu")


def test_init_model_shapes_match_jax(qwen_reduced):
    """The port's own init has the JAX tree's key paths, shapes, gates
    and the config's param dtype (its numbers differ: torch's
    generator)."""
    jr, tr, jp, _ = qwen_reduced
    tp = ttr.init_model(tr, seed=0, device="cpu")
    jleaves = jax.tree_util.tree_leaves_with_path(jp)
    tflat = {}

    def walk(tree, path):
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, path + (k,))
        elif tree is not None:
            tflat[path] = tree
    walk(tp, ())
    assert len(tflat) == len(jleaves)
    for path, leaf in jleaves:
        key = tuple(p.key for p in path)
        assert tuple(tflat[key].shape) == leaf.shape, key
        assert str(tflat[key].dtype) == f"torch.{leaf.dtype}", key
    np.testing.assert_array_equal(tp["mid"]["gate"].numpy(),
                                  np.asarray(jp["mid"]["gate"]))
