"""The port's dense-cache decode path against the JAX package's, float32
on the CPU (reduced configs, weights converted by ``params_from_jax``,
inputs from numpy seeds).

- ``attention_apply``'s cache branch (T = 1 at index 0 and 9, T = 5 at
  index 0 and 7) and the mamba1 / mamba2 mixers with a cache (4 steps):
  outputs and the updated caches.
- ``decode_step`` after a prompt plus 4 greedy steps for the decoder
  (qwen3_1p7b, deepseek_7b; the prompt as one chunked prefill), SSM
  (falcon_mamba_7b), hybrid (zamba2_1p2b; SSM and hybrid a token a call)
  and encoder-decoder families (mt_marian, seamless_m4t_v2, with the
  encoder's output as ``xa``): logits of every call, the whole cache at
  the end, and the greedy tokens.
- Mirrors, inside the port, of the reference's dense tests, with its
  tolerances (``test_smoke_archs.py::test_decode_step`` and
  ``::test_decode_matches_prefill_deepseek``,
  ``test_models_extra.py::test_encdec_decode_matches_teacher_forced``,
  ``test_serve.py::test_chunked_prefill_matches_*``).
- ``apply_top_k`` / ``apply_top_p`` against JAX's on the inputs of
  ``test_serve_sampling.py``'s mask tests, and the mirror of its
  ``test_fused_mask_matches_sequential_reference``.

Tolerances are ``test_torch_train.py``'s: 2e-5 for attention and logits,
1e-4 for the SSM recurrence.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import steps as jsteps
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import ssm as jssm
from repro.models import transformer as jtr
from repro_torch.configs.base import (MGRITConfig, ModelConfig,
                                      OptimizerConfig, RunConfig,
                                      ShapeConfig)
from repro_torch.configs.reduce import reduce_config as t_reduce
from repro_torch.configs.registry import get_config as t_get_config
from repro_torch.convert import params_from_jax
from repro_torch.launch import steps as tsteps
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as ttr
from test_torch_train import ATTN_TOL, close, f32_configs, np_tree, rnd

torch.set_num_threads(2)
SSM_TOL = 1e-4
DECODE_ARCHS = ["qwen3_1p7b", "deepseek_7b", "falcon_mamba_7b",
                "zamba2_1p2b", "mt_marian", "seamless_m4t_v2"]
B, PROMPT, STEPS, MAX_LEN, SRC = 2, 5, 4, 16, 7


def t(a):
    return torch.from_numpy(np.array(a))


def layer0(tree):
    return jax.tree.map(lambda a: np.asarray(a)[0], tree)


def torch_tree(np_layer):
    return jax.tree.map(t, np_layer)


@functools.lru_cache(maxsize=None)
def jax_setup(arch, seed=0):
    jr, tr = f32_configs(arch)
    jp = jax.jit(jtr.init_model, static_argnums=1)(
        jax.random.PRNGKey(seed), jr)
    return jr, tr, jp, params_from_jax(np_tree(jp), tr, "cpu")


# ---------------------------------------------------------------------------
# 1. attention_apply's cache branch and the mixers with a cache
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def qwen():
    return jax_setup("qwen3_1p7b")


@pytest.mark.parametrize("T,index", [(1, 0), (1, 9), (5, 0), (5, 7)])
def test_attention_cache_branch_matches_jax(qwen, T, index):
    """qwen3's attention (GQA 4/2, qk-norm) over a cache whose rows before
    ``index`` hold earlier keys: the output and the whole cache after the
    write, within 2e-5 (rows past index + T stay as they were)."""
    jr, tr, jp, _ = qwen
    cfg_j, cfg_t = jr.model, tr.model
    pa = layer0(jp["mid"]["params"]["attn"])
    hkv, hd = cfg_t.n_kv_heads, cfg_t.resolved_head_dim
    x = rnd(1, (B, T, cfg_t.d_model))
    ck = rnd(2, (B, MAX_LEN, hkv, hd))
    cv = rnd(3, (B, MAX_LEN, hkv, hd))
    pos = np.arange(index, index + T)
    jrope = jlayers.rope_freqs(hd, cfg_j.rope_theta, jnp.asarray(pos))
    jy, jc = jattn.attention_apply(
        pa, jnp.asarray(x), cfg_j, causal=True, rope=jrope,
        cache={"k": jnp.asarray(ck), "v": jnp.asarray(cv),
               "index": jnp.asarray(index, jnp.int32)})
    trope = tlayers.rope_freqs(hd, cfg_t.rope_theta, t(pos))
    cache = {"k": t(ck), "v": t(cv),
             "index": torch.tensor(index, dtype=torch.int32)}
    ty, tc = tattn.attention_apply(torch_tree(pa), t(x), cfg_t, causal=True,
                                   rope=trope, cache=cache)
    close(ty, jy, ATTN_TOL)
    assert tc["k"] is cache["k"] and tc["v"] is cache["v"]   # in place
    close(tc["k"], jc["k"], ATTN_TOL)
    close(tc["v"], jc["v"], ATTN_TOL)
    assert int(tc["index"]) == int(jc["index"]) == index + T
    np.testing.assert_array_equal(tc["k"][:, index + T:],
                                  ck[:, index + T:])


@pytest.mark.parametrize("arch", ["falcon_mamba_7b", "zamba2_1p2b"])
def test_mixer_with_cache_matches_jax(arch):
    """Four decode steps of layer 0's mixer from a random conv window and
    state: y at every step and both caches at the end, within 1e-4."""
    jr, tr, jp, _ = jax_setup(arch)
    cfg_j, cfg_t = jr.model, tr.model
    version = cfg_t.ssm.version
    stack = jp["mid"]["params"] if version == 1 else jp["backbone"]
    pm = layer0(stack["mixer"])
    japply, tapply = ((jssm.mamba1_apply, tssm.mamba1_apply) if version == 1
                      else (jssm.mamba2_apply, tssm.mamba2_apply))
    init = tssm.init_mamba1_cache if version == 1 else tssm.init_mamba2_cache
    tc = {k: v[0] for k, v in init(cfg_t, B, 1, device="cpu").items()}
    conv0 = rnd(4, tuple(tc["conv"].shape), 0.5)
    h0 = rnd(5, tuple(tc["h"].shape), 0.5)
    jc = {"conv": jnp.asarray(conv0), "h": jnp.asarray(h0)}
    tc["conv"].copy_(t(conv0))
    tc["h"].copy_(t(h0))      # keeps the spare page before the state
    tpm = torch_tree(pm)
    for step in range(STEPS):
        x = rnd(10 + step, (B, 1, cfg_t.d_model))
        jy, jc = japply(pm, jnp.asarray(x), cfg_j, cache=jc)
        ty, tc2 = tapply(tpm, t(x), cfg_t, cache=tc)
        assert tc2 is tc
        close(ty, jy, SSM_TOL)
    close(tc["conv"], jc["conv"], SSM_TOL)
    close(tc["h"], jc["h"], SSM_TOL)


# ---------------------------------------------------------------------------
# 2. decode_step, every family, against JAX
# ---------------------------------------------------------------------------


def encoder_out(jr, jp, seed=7):
    """The encoder-decoder family's X_enc from JAX's serial encoder over
    a numpy source (token ids, or the audio stub's frames)."""
    cfg = jr.model
    rng = np.random.default_rng(seed)
    if cfg.frontend == "audio":
        xe = jnp.asarray(rng.standard_normal((B, SRC, cfg.d_model)) * 0.1,
                         jnp.dtype(cfg.dtype))
    else:
        src = rng.integers(0, cfg.vocab_size, (B, SRC)).astype(np.int32)
        xe = jtr.embed_tokens(jp["embed"], jnp.asarray(src), cfg)
    xN, _ = jtr._trunk(jp["enc_mid"], xe, jr, kind="attn_mlp",
                       causal=False, rope=jtr._rope_for(cfg, SRC),
                       mode="serial")
    return xN


def _flatten(tree, path=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, f"{path}.{k}".lstrip(".")))
        return out
    return {path: tree}


@pytest.fixture(scope="module")
def jax_decode():
    """{arch: (port rcfg, port params, xa, prompt, tokens fed, JAX logits
    of every call, JAX's final cache as numpy)}, computed once."""
    out = {}

    def run(arch):
        if arch in out:
            return out[arch]
        jr, tr, jp, tp = jax_setup(arch)
        cfg = jr.model
        xa = encoder_out(jr, jp) if cfg.family == "encdec" else None
        step = jax.jit(lambda p, c, tok: jtr.decode_step(p, c, tok, jr,
                                                         xa=xa))
        prompt = np.random.default_rng(3).integers(
            0, cfg.vocab_size, (B, PROMPT)).astype(np.int32)
        chunked = cfg.family in ("decoder", "encdec")
        feeds = [prompt] if chunked else [prompt[:, i:i + 1]
                                          for i in range(PROMPT)]
        cache = jtr.init_cache(jr, B, MAX_LEN)
        logits = []
        for f in feeds:
            lg, cache = step(jp, cache, jnp.asarray(f))
            logits.append(np.asarray(lg))
        for _ in range(STEPS):
            nxt = np.asarray(jnp.argmax(lg[:, -1], -1), np.int32)[:, None]
            feeds.append(nxt)
            lg, cache = step(jp, cache, jnp.asarray(nxt))
            logits.append(np.asarray(lg))
        out[arch] = (tr, tp, None if xa is None else np.asarray(xa), feeds,
                     logits, {k: np.asarray(v)
                              for k, v in _flatten(cache).items()})
        return out[arch]

    return run


@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_decode_step_matches_jax(jax_decode, arch):
    """The logits of every call (the prompt, then 4 greedy tokens) within
    2e-5 and the port's greedy token equal to JAX's at every step; then
    every leaf of the cache (KV and index, or conv window and state),
    within 2e-5 too."""
    check_decode_step(jax_decode, arch)


def check_decode_step(jax_decode, arch):
    """The body of :func:`test_decode_step_matches_jax` (the MoE family's
    case is in ``test_torch_moe_serve.py``)."""
    tr, tp, xa, feeds, want, jcache = jax_decode(arch)
    cache = ttr.init_cache(tr, B, MAX_LEN, device="cpu")
    xa_t = None if xa is None else t(xa)
    for i, (f, w) in enumerate(zip(feeds, want, strict=True)):
        lg, cache = ttr.decode_step(tp, cache, t(f).long(), tr, xa=xa_t)
        close(lg, w, ATTN_TOL)
        if i + 1 < len(feeds) and i + 1 >= len(feeds) - STEPS:
            np.testing.assert_array_equal(
                torch.argmax(lg[:, -1], -1).numpy(), feeds[i + 1][:, 0])
    got = {k: v.numpy() for k, v in _flatten(cache).items()}
    assert sorted(got) == sorted(jcache)
    for k, w in jcache.items():
        close(got[k], w, ATTN_TOL)


# ---------------------------------------------------------------------------
# 3. Mirrors of the reference's dense tests, inside the port
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["deepseek_7b", "falcon_mamba_7b",
                                  "zamba2_1p2b", "seamless_m4t_v2",
                                  "qwen3_moe_235b"])
def test_decode_step(arch):
    """``test_smoke_archs.py::test_decode_step``: two steps at the reduced
    bf16 config, finite logits of shape (B, 1, V)."""
    rcfg = t_reduce(t_get_config(arch))
    cfg = rcfg.model
    params = ttr.init_model(rcfg, seed=0, device="cpu")
    cache = ttr.init_cache(rcfg, B, 32, device="cpu")
    toks = torch.ones((B, 1), dtype=torch.long)
    xa = None
    if cfg.family == "encdec":
        xa = (torch.randn((B, 8, cfg.d_model),
                          generator=torch.Generator().manual_seed(0))
              * 0.1).to(tlayers.torch_dtype(cfg.dtype))
    logits, cache = ttr.decode_step(params, cache, toks, rcfg, xa=xa)
    assert logits.shape == (B, 1, cfg.vocab_size)
    assert torch.isfinite(logits.float()).all()
    logits3, _ = ttr.decode_step(params, cache, toks, rcfg, xa=xa)
    assert torch.isfinite(logits3.float()).all()


def test_decode_matches_prefill_deepseek():
    """``test_smoke_archs.py::test_decode_matches_prefill_deepseek``:
    token-by-token decode reproduces the serial forward's logits (bf16,
    rtol = atol = 2e-2)."""
    rcfg = t_reduce(t_get_config("deepseek_7b"))
    params = ttr.init_model(rcfg, seed=0, device="cpu")
    T = 8
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, rcfg.model.vocab_size, (B, T)))
    full, _ = ttr.forward(params, {"tokens": toks}, rcfg, mode="serial")
    cache = ttr.init_cache(rcfg, B, T, device="cpu")
    outs = []
    for i in range(T):
        lg, cache = ttr.decode_step(params, cache, toks[:, i:i + 1], rcfg)
        outs.append(lg[:, 0])
    np.testing.assert_allclose(torch.stack(outs, 1).float().numpy(),
                               full.float().numpy(), rtol=2e-2, atol=2e-2)


def test_encdec_decode_matches_teacher_forced():
    """``test_models_extra.py::test_encdec_decode_matches_teacher_forced``:
    seamless_m4t_v2 (bf16) decoded a token a call with cross-attention to
    the encoder's output equals the serial forward (rtol = atol = 3e-2)."""
    rcfg = t_reduce(t_get_config("seamless_m4t_v2"))
    cfg = rcfg.model
    params = ttr.init_model(rcfg, seed=0, device="cpu")
    T = 6
    rng = np.random.default_rng(1)
    src = torch.from_numpy(
        (rng.standard_normal((B, 8, cfg.d_model)) * 0.1).astype(np.float32))
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, T)))
    full, _ = ttr.forward(params, {"src_embeds": src, "tokens": toks}, rcfg,
                          mode="serial")
    xN, _ = ttr.encode(params, {"src_embeds": src}, rcfg)
    cache = ttr.init_cache(rcfg, B, T, device="cpu")
    step = tsteps.make_serve_fn(rcfg)
    outs = []
    for i in range(T):
        lg, cache = ttr.decode_step(params, cache, toks[:, i:i + 1], rcfg,
                                    xa=xN)
        outs.append(lg[:, 0])
    np.testing.assert_allclose(torch.stack(outs, 1).float().numpy(),
                               full.float().numpy(), rtol=3e-2, atol=3e-2)
    # make_serve_fn takes xa for this family, as the reference's does
    nxt, _ = step(params, ttr.init_cache(rcfg, B, T, device="cpu"),
                  toks[:, :1], xN)
    np.testing.assert_array_equal(
        nxt[:, 0].numpy(), torch.argmax(outs[0].float(), -1).numpy())


VOCAB = 64


@pytest.fixture(scope="module")
def tiny():
    """``test_serve.py``'s tiny float32 layernorm/gelu decoder."""
    rcfg = RunConfig(
        model=ModelConfig(name="srv", family="decoder", n_layers=8,
                          d_model=32, n_heads=2, n_kv_heads=2, d_ff=64,
                          vocab_size=VOCAB, act="gelu", norm="layernorm",
                          dtype="float32"),
        mgrit=MGRITConfig(enabled=True, cf=2, levels=2, fwd_iters=1,
                          bwd_iters=1, n_open=1, n_close=1, pad_to=2),
        optimizer=OptimizerConfig(),
        shape=ShapeConfig("srv", "train", 16, 4))
    return rcfg, ttr.init_model(rcfg, seed=0, device="cpu")


def test_chunked_prefill_matches_serial_forward(tiny):
    """One decode_step call over a 12-token prompt == the serial forward
    (rtol = atol = 1e-4); the index advances by 12."""
    rcfg, params = tiny
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, VOCAB, (2, 12)))
    full, _ = ttr.forward(params, {"tokens": toks}, rcfg, mode="serial")
    cache = ttr.init_cache(rcfg, 2, 32, device="cpu")
    lg, cache2 = ttr.decode_step(params, cache, toks, rcfg)
    np.testing.assert_allclose(lg.numpy(), full.numpy(), rtol=1e-4,
                               atol=1e-4)
    assert int(cache2["index"]) == toks.shape[1]


def test_chunked_prefill_matches_per_token_loop(tiny):
    """Chunked prefill fills the cache as the token-by-token loop does:
    the greedy continuations are equal."""
    rcfg, params = tiny
    prompts = torch.from_numpy(np.stack(
        [np.arange(1, 9) % VOCAB, np.arange(11, 19) % VOCAB]))
    step = tsteps.make_serve_fn(rcfg)

    def greedy(chunked):
        cache = ttr.init_cache(rcfg, 2, 32, device="cpu")
        if chunked:
            cur, cache = step(params, cache, prompts)
        else:
            for i in range(prompts.shape[1]):
                cur, cache = step(params, cache, prompts[:, i:i + 1])
        outs = [cur]
        for _ in range(4):
            cur, cache = step(params, cache, cur)
            outs.append(cur)
        return torch.cat(outs, 1).numpy()

    np.testing.assert_array_equal(greedy(True), greedy(False))


def test_prefill_fn_matches_serial_forward(tiny):
    """make_prefill_fn: the serial forward's logits and their last
    position's argmax."""
    rcfg, params = tiny
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, VOCAB, (2, 9)))
    nxt, lg = tsteps.make_prefill_fn(rcfg)(params, {"tokens": toks})
    full, _ = ttr.forward(params, {"tokens": toks}, rcfg, mode="serial")
    torch.testing.assert_close(lg, full, rtol=0, atol=0)
    np.testing.assert_array_equal(nxt.numpy(),
                                  full[:, -1].argmax(-1).numpy())


# ---------------------------------------------------------------------------
# 4. apply_top_k / apply_top_p against JAX's
# ---------------------------------------------------------------------------


def top_p_inputs():
    rng = np.random.default_rng(1)
    return (rng.normal(size=(3, 16)).astype(np.float32) * 3,
            np.array([0.5, 0.9, 1.0], np.float32))


def near_p(logits, p, tol=1e-6):
    """Tokens whose mass-before (in descending order) lies within tol of
    p: there the cumsum order of XLA and torch may decide differently."""
    srt = -np.sort(-logits, axis=-1)
    e = np.exp(srt - srt[:, :1])
    probs = e / e.sum(-1, keepdims=True)
    before = np.cumsum(probs, -1) - probs
    near_sorted = np.abs(before - p[:, None]) <= tol
    order = np.argsort(-logits, axis=-1, kind="stable")
    near = np.zeros_like(near_sorted)
    np.put_along_axis(near, order, near_sorted, axis=-1)
    return near


def test_top_k_mask_matches_jax():
    """The inputs of ``test_top_k_mask_excludes_out_of_set``: the masked
    logits are bit-equal to JAX's (k = 0 disables a row)."""
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(4, 32)).astype(np.float32)
    k = np.array([1, 3, 8, 0], np.int32)
    want = np.asarray(jsteps.apply_top_k(logits, k))
    got = tsteps.apply_top_k(t(logits), t(k)).numpy()
    np.testing.assert_array_equal(got, want)
    assert ((got > -1e29).sum(-1) == [1, 3, 8, 32]).all()


def test_top_p_mask_matches_jax():
    """The inputs of ``test_top_p_mask_is_minimal_nucleus``: masks equal
    to JAX's except where a token's mass-before is within 1e-6 of p, and
    the survivors' logits unchanged."""
    logits, p = top_p_inputs()
    want = np.asarray(jsteps.apply_top_p(logits, p)) > -1e29
    out = tsteps.apply_top_p(t(logits), t(p)).numpy()
    got = out > -1e29
    differ = got != want
    assert not (differ & ~near_p(logits, p)).any()
    np.testing.assert_array_equal(out[got], logits[got])


def test_fused_mask_matches_sequential_reference():
    """``test_serve_sampling.py::test_fused_mask_matches_sequential_
    reference``: the one-sort mask equals apply_top_p(apply_top_k(x))."""
    rng = np.random.default_rng(3)
    logits = t(rng.normal(size=(6, 48)).astype(np.float32) * 2)
    k = t(np.array([0, 1, 4, 16, 48, 7], np.int32))
    p = t(np.array([1.0, 0.3, 0.7, 0.05, 0.99, 0.5], np.float32))
    ref = tsteps.apply_top_p(tsteps.apply_top_k(logits, k), p).numpy()
    fused = tsteps.apply_top_k_top_p(logits, k, p).numpy()
    np.testing.assert_array_equal(fused > -1e29, ref > -1e29)
    np.testing.assert_allclose(np.where(fused > -1e29, fused, 0.0),
                               np.where(ref > -1e29, ref, 0.0), rtol=1e-6)


@pytest.mark.parametrize("arch", ["falcon_mamba_7b", "zamba2_1p2b"])
def test_dense_state_spare_page_is_never_written(arch):
    """``init_cache``'s SSM state starts one page into its storage (the
    paged SSM kernel takes each layer's slots as pool pages 1..B and
    never writes page 0): after three decode steps the page before it is
    still zero, and every layer's state has moved."""
    rcfg = t_reduce(t_get_config(arch))
    params = ttr.init_model(rcfg, seed=0, device="cpu")
    cache = ttr.init_cache(rcfg, B, 8, device="cpu")
    h = cache["mamba"]["h"] if "mamba" in cache else cache["h"]
    page = h[0, 0].numel()
    assert h.storage_offset() == page
    for _ in range(3):
        _, cache = ttr.decode_step(params, cache,
                                   torch.ones((B, 1), dtype=torch.long), rcfg)
    spare = h.as_strided((page,), (1,), 0)
    assert not spare.any()
    assert all(h[i].abs().sum() > 0 for i in range(h.shape[0]))
