"""The SSM and hybrid serving slice: the port's paged SSM update, mamba
mixers, paged steps and ``ServeEngine`` against the JAX package, plus
the port's own fused == gathered contract.

Inputs are made with numpy from a seed and handed to both frameworks;
models are the reduced ``falcon_mamba_7b`` (mamba1, 10 layers) and
``zamba2_1p2b`` (mamba2 + shared attention every 3 of 8 layers) in
float32, with the JAX init's weights converted by ``params_from_jax``.

Tolerances: the paged SSM update's plain version holds JAX's ref and
interpret modes to the reference's own rtol 1e-5 / atol 1e-6, on valid
rows and on the non-scratch pool pages (scratch page 0 takes duplicate
writes in unspecified order); the mixers to rtol 1e-4 / atol 1e-5 (the
repo's float32 scan tolerance; projections run through each framework's
own matmul). Within the port, on the CPU, fused and gathered paths are
bitwise equal. Engines: emitted tokens identical, greedy and seeded
sampled. On the shared-prefix queue the port is held to JAX's gathered
engine (``fused=False``): JAX's fused CPU path has an intra-wave sharing
fault (ROADMAP Queue 3); its fused engine is held against the port on a
queue without sharing.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.reduce import reduce_config as j_reduce
from repro.configs.registry import get_config as j_get_config
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.paged_ssm import max_write_pages as j_max_write_pages
from repro.kernels.paged_ssm import paged_ssm_update_ref as j_paged_ref
from repro.kernels.ssm_scan import ssm_scan as j_ssm_scan
from repro.models import ssm as jssm
from repro.models import transformer as jtr
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JEngine
from repro_torch.configs.reduce import reduce_config as t_reduce
from repro_torch.configs.registry import get_config as t_get_config
from repro_torch.convert import params_from_jax
from repro_torch.kernels import ops as tops
from repro_torch.kernels import paged_ssm as tps
from repro_torch.kernels import ssm_scan as tss
from repro_torch.launch import serve as serve_cli
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as ttr
from repro_torch.serve.cache import (HybridBackend, SSMStateBackend,
                                     make_backend)
from repro_torch.serve.engine import Request as TRequest
from repro_torch.serve.engine import ServeEngine as TEngine
from test_torch_gpu import (SSM_CASES, ssm_case, ssm_plan, ssm_scan_case,
                            to_torch)

torch.set_num_threads(2)
MAX_LEN, MAX_BATCH, PAGE = 48, 3, 4
ARCHS = {"falcon": "falcon_mamba_7b", "zamba2": "zamba2_1p2b"}


def f32(rcfg):
    return rcfg.replace(model=dataclasses.replace(rcfg.model,
                                                  dtype="float32"))


@pytest.fixture(scope="module", params=sorted(ARCHS))
def fam(request):
    """(JAX rcfg, JAX params, port rcfg, port params) for one family."""
    arch = ARCHS[request.param]
    jr = f32(j_reduce(j_get_config(arch, "decode_32k")))
    tr = f32(t_reduce(t_get_config(arch, "decode_32k")))
    jp = jax.jit(jtr.init_model, static_argnums=1)(jax.random.PRNGKey(1), jr)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tr, "cpu")
    return request.param, jr, jp, tr, tp


# ---------------------------------------------------------------------------
# 1. Kernel contract: plain version vs JAX ref and Pallas interpret
# ---------------------------------------------------------------------------


def _jax_plan(table, lengths, n_new, page_size, S):
    t_w, phys_w = jssm.compact_snapshot_steps(
        jnp.asarray(table), jnp.asarray(lengths), jnp.asarray(n_new),
        page_size, S)
    read_page, live = jssm.paged_read_plan(jnp.asarray(table),
                                           jnp.asarray(lengths), page_size)
    return read_page, live, phys_w, t_w


@pytest.mark.parametrize("order", ["dbx", "dxb"])
@pytest.mark.parametrize("S,lengths,n_new", SSM_CASES)
def test_paged_ssm_update_plain_matches_jax(order, S, lengths, n_new):
    dt, x, Bm, Cm, A, pool, table, lens, nn = ssm_case(
        7 * S + lengths[0], 2, S, 8, 4, 3, lengths, n_new)
    jplan = _jax_plan(table, lens, nn, 4, S)
    tplan = ssm_plan(*to_torch(table, lens, nn), 4, S)
    for j, t in zip(jplan, tplan, strict=True):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    jargs = [jnp.asarray(a) for a in (dt, x, Bm, Cm, A, pool)]
    tpool = torch.from_numpy(pool.copy())
    got = tps.paged_ssm_update_ref(*to_torch(dt, x, Bm, Cm, A), tpool,
                                   *tplan, torch.from_numpy(nn),
                                   order=order).numpy()
    valid = (np.arange(S)[None, :] < nn[:, None])[..., None]
    for mode in ("ref", "interpret"):
        y, new_pool = jops.paged_ssm_update(*jargs, *jplan, jnp.asarray(nn),
                                            order=order, mode=mode)
        np.testing.assert_allclose(got * valid, np.asarray(y) * valid,
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(tpool.numpy()[1:],
                                   np.asarray(new_pool)[1:],
                                   rtol=1e-5, atol=1e-6)


def test_paged_ssm_update_touches_only_planned_pages():
    """Pages outside phys_w (and scratch) come back bit-identical — idle
    slots' state survives the in-place update."""
    dt, x, Bm, Cm, A, pool, table, lens, nn = to_torch(*ssm_case(
        7, 2, 1, 8, 4, 3, [3, 6], [1, 0]))
    plan = ssm_plan(table, lens, nn, 4, 1)
    new_pool = pool.clone()
    tps.paged_ssm_update_ref(dt, x, Bm, Cm, A, new_pool, *plan, nn,
                             order="dbx")
    planned = set(plan[2].reshape(-1).tolist()) | {0}
    assert len(planned) > 1
    for page in range(pool.shape[0]):
        if page not in planned:
            assert torch.equal(new_pool[page], pool[page]), page


def test_paged_ssm_dispatch_cpu_plain_and_kernel_refuses_cpu():
    """``ops.paged_ssm_update`` takes the plain version for CPU tensors;
    the kernel wrapper raises on them and counts nothing."""
    dt, x, Bm, Cm, A, pool, table, lens, nn = to_torch(*ssm_case(
        8, 2, 4, 8, 4, 3, [2, 5], [4, 0]))
    plan = ssm_plan(table, lens, nn, 4, 4)
    pa, pb = pool.clone(), pool.clone()
    before = tps.paged_ssm_update.launches
    ya = tops.paged_ssm_update(dt, x, Bm, Cm, A, pa, *plan, nn, order="dxb")
    yb = tps.paged_ssm_update_ref(dt, x, Bm, Cm, A, pb, *plan, nn,
                                  order="dxb")
    assert torch.equal(ya, yb) and torch.equal(pa, pb)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        tps.paged_ssm_update(dt, x, Bm, Cm, A, pa, *plan, nn, order="dxb")
    with pytest.raises(ValueError, match="order"):
        tps.paged_ssm_update_ref(dt, x, Bm, Cm, A, pa, *plan, nn,
                                 order="xdb")
    assert tps.paged_ssm_update.launches == before
    for S, ps in ((1, 16), (64, 16), (256, 16), (5, 4)):
        assert tps.max_write_pages(S, ps) == j_max_write_pages(S, ps)


# ---------------------------------------------------------------------------
# 1b. The kernels' lane plans (csrc/ssm_scan.cu forward, csrc/paged_ssm.cu),
#     emulated in float32 on the CPU
# ---------------------------------------------------------------------------

def _lane_sum(p):
    """Sum over the last axis (a row's lanes) in the order of the kernels'
    reduce-scatter: lanes l and l + n/2 first, then those pairs at n/4,
    down to neighbours; the same order for every step of a batch."""
    while p.shape[-1] > 1:
        half = p.shape[-1] // 2
        p = p[..., :half] + p[..., half:]
    return p[..., 0]


def _row_readout(h, c, lanes):
    """sum_s h[.., s] c[.., s] as the kernels read it out: each of
    ``lanes`` lanes sums its ds/lanes consecutive states in order, then
    the lanes' partials go through :func:`_lane_sum`."""
    p = (h * c).reshape(h.shape[:-1] + (lanes, -1))
    part = p[..., 0]
    for i in range(1, p.shape[-1]):
        part = part + p[..., i]
    return _lane_sum(part)


def _decay(d, A, stride0):
    """exp(d A) as the kernels take it: one exp a (row, state), or a row
    (broadcast over states) for a stride-0 decay."""
    if stride0:
        return torch.exp(d * A[:, 0])[..., None]
    return torch.exp(d[..., None] * A)


def _scan_fwd_lanes(dt, x, A, B, C, D, stride0):
    """The forward kernel's plan: ds/4 lanes a row, 4 states a lane; one
    exp a (row, state, step), or a (row, step) for a stride-0 decay, h's
    update (d x) B, the readout by lanes, y = sum + D x; the state before
    every CHUNK steps kept as (Bb, nC, ds, di)."""
    Bb, S, di = x.shape
    lanes = A.shape[1] // 4
    h = torch.zeros(Bb, di, A.shape[1])
    ys, hc = [], []
    for t in range(S):
        if t % tss.CHUNK == 0:
            hc.append(h.transpose(1, 2))
        d = dt[:, t]
        h = _decay(d, A, stride0) * h \
            + (d * x[:, t])[..., None] * B[:, t, None, :]
        ys.append(_row_readout(h, C[:, t, None, :], lanes) + D * x[:, t])
    return torch.stack(ys, dim=1), torch.stack(hc, dim=1)


def _paged_lanes(dt, x, Bm, Cm, A, h_pool, read_page, live, phys_w, t_w,
                 n_new, *, order, stride0):
    """The paged kernel's plan: ds/G lanes a row, G states a lane (4, 8
    at ds 64); h from
    the read page (zero where not live), the masked update with the
    order's product grouping and one exp a (row, step) for a stride-0
    "dxb" decay, the readout by lanes, each snapshot written after its
    step. Updates h_pool in place, returns y."""
    B, S, R = dt.shape
    ds = h_pool.shape[-1]
    lanes = ds // (8 if ds == 64 else 4)
    h = torch.where(live.bool()[:, None, None], h_pool[read_page.long()],
                    torch.zeros(()))
    ys = []
    for t in range(S):
        d, xv, b_t = dt[:, t], x[:, t], Bm[:, t, None, :]
        a = _decay(d, A, stride0 and order == "dxb")
        term = (d[..., None] * b_t) * xv[..., None] if order == "dbx" \
            else (d * xv)[..., None] * b_t
        h = torch.where((t < n_new)[:, None, None], a * h + term, h)
        ys.append(_row_readout(h, Cm[:, t, None, :], lanes))
        for b, w in zip(*torch.nonzero((t_w == t) & (phys_w != 0),
                                       as_tuple=True)):
            h_pool[phys_w[b, w]] = h[b]
    return torch.stack(ys, dim=1)


# (Bb, S, di, ds, stride-0 decay, JAX chunk): three 64-step chunks, a
# ragged tail, 4 lanes a row (ds 16), 16 (ds 64, mamba2's stride-0
# decay), 2 with a short sequence
SCAN_LANES_CASES = [(2, 192, 12, 16, False, 64), (1, 150, 8, 64, True, 50),
                    (2, 70, 6, 8, False, 35)]


@pytest.mark.parametrize("Bb,S,di,ds,stride0,chunk", SCAN_LANES_CASES)
def test_scan_fwd_lanes_plan_matches_jax(Bb, S, di, ds, stride0, chunk):
    """The forward kernel's lane plan, emulated in float32, gives y within
    1e-5 of max|y| of JAX's Pallas kernel (interpret mode) and its jnp
    oracle, and the stored states within 1e-5 of the plain recurrence's
    (``ssm_scan_fwd_ref``, whose y is ``ssm_scan_ref``'s bit for bit)."""
    dt, x, A, B, C, D, _ = ssm_scan_case(3 * S + ds, Bb, S, di, ds)
    if stride0:
        A = np.repeat(A[:, :1], ds, axis=1)
    ins = to_torch(dt, x, A, B, C, D)
    got_y, got_hc = _scan_fwd_lanes(*ins, stride0)
    want_y, want_hc = tss.ssm_scan_fwd_ref(*ins)
    assert torch.equal(want_y, tss.ssm_scan_ref(*ins))
    assert got_hc.shape == want_hc.shape == (Bb, -(-S // 64), ds, di)
    assert (got_hc - want_hc).abs().max() <= 1e-5 * want_hc.abs().max()
    jargs = [jnp.asarray(a) for a in (dt, x, A, B, C, D)]
    for want in (j_ssm_scan(*jargs, chunk=chunk, interpret=True),
                 jref.ssm_scan_ref(*jargs)):
        want = np.asarray(want)
        assert np.abs(got_y.numpy() - want).max() <= 1e-5 * np.abs(want).max()


def _paged_lanes_case(order, S, lengths, n_new, ds, seed):
    """ssm_case at B=2, R=8, page size 4, 3 pages a slot (as
    test_torch_gpu's SSM_CASES); mamba2's A one decay a row."""
    dt, x, Bm, Cm, A, pool, table, lens, nn = ssm_case(
        seed, 2, S, 8, ds, 3, lengths, n_new)
    if order == "dxb":
        A = np.repeat(A[:, :1], ds, axis=1)
    return dt, x, Bm, Cm, A, pool, table, lens, nn


@pytest.mark.parametrize("ds", [4, 16, 64])
@pytest.mark.parametrize("order", ["dbx", "dxb"])
@pytest.mark.parametrize("S,lengths,n_new", SSM_CASES)
def test_paged_lanes_plan_matches_jax(order, S, lengths, n_new, ds):
    """The paged kernel's lane plan (4 or 8 states a lane), emulated in
    float32, gives y on valid rows and the non-scratch pages within 1e-5
    of max|JAX| of ``repro.kernels.paged_ssm.paged_ssm_update_ref``."""
    dt, x, Bm, Cm, A, pool, table, lens, nn = _paged_lanes_case(
        order, S, lengths, n_new, ds, 5 * S + ds)
    jplan = _jax_plan(table, lens, nn, 4, S)
    y, new_pool = j_paged_ref(*(jnp.asarray(a)
                                for a in (dt, x, Bm, Cm, A, pool)),
                              *jplan, jnp.asarray(nn), order=order)
    y, new_pool = np.asarray(y), np.asarray(new_pool)
    tpool = torch.from_numpy(pool.copy())
    got = _paged_lanes(*to_torch(dt, x, Bm, Cm, A), tpool,
                       *ssm_plan(*to_torch(table, lens, nn), 4, S),
                       torch.from_numpy(nn), order=order,
                       stride0=order == "dxb").numpy()
    valid = (np.arange(S)[None, :] < nn[:, None])[..., None]
    assert np.abs((got - y) * valid).max() <= 1e-5 * np.abs(y * valid).max()
    assert np.abs(tpool.numpy()[1:] - new_pool[1:]).max() \
        <= 1e-5 * np.abs(new_pool[1:]).max()


@pytest.mark.parametrize("split", [1, 3, 5])
@pytest.mark.parametrize("order,ds", [("dbx", 16), ("dxb", 64)])
def test_paged_lanes_plan_split_call_is_bitwise_one_call(order, ds, split):
    """The paged kernel's plan gives bitwise the same y and pool when a
    7-token call is split in two at ``split`` (page size 4: inside a page,
    the second call crossing a boundary), slots starting at 0 and mid-page
    beside an idle one: every step runs the same arithmetic wherever it
    falls in a call."""
    S = 7
    dt, x, Bm, Cm, A, pool, table, lens, nn = to_torch(*_paged_lanes_case(
        order, S, [0, 2], [S, 0], ds, 11 + split))
    kw = dict(order=order, stride0=order == "dxb")
    pools = [pool.clone(), pool.clone()]
    one = _paged_lanes(dt, x, Bm, Cm, A, pools[0],
                       *ssm_plan(table, lens, nn, 4, S), nn, **kw)
    ys, at = [], lens
    for lo, hi in ((0, split), (split, S)):
        n = torch.clamp(nn - lo, 0, hi - lo).to(torch.int32)
        part = [t[:, lo:hi] for t in (dt, x, Bm, Cm)]
        ys.append(_paged_lanes(*part, A, pools[1],
                               *ssm_plan(table, at, n, 4, hi - lo), n, **kw))
        at = (at + n).to(torch.int32)
    assert not torch.equal(pools[0], pool)
    assert torch.equal(torch.cat(ys, dim=1), one)
    assert torch.equal(pools[1], pools[0])


# ---------------------------------------------------------------------------
# 2. Mixers: a prefill chunk, then decode steps, port vs JAX
# ---------------------------------------------------------------------------

# (tokens S, lengths, n_new) at B=2, page_size 4, 4 pages per slot
MIXER_STEPS = [(6, [0, 0], [6, 3]), (1, [6, 3], [1, 1]),
               (1, [7, 4], [1, 0])]


def _mixer_fns(name):
    if name == "falcon":
        return jssm.mamba1_paged_apply, tssm.mamba1_paged_apply, 1
    return jssm.mamba2_paged_apply, tssm.mamba2_paged_apply, 2


def _layer0(tree):
    """The first stacked layer's mixer params (either framework)."""
    p = tree["backbone"] if "backbone" in tree else tree["open"]
    return {k: v[0] for k, v in p["mixer"].items()}


@pytest.mark.parametrize("fused", [True, False])
def test_mixer_matches_jax_over_prefill_and_decode(fam, fused):
    name, jr, jp, tr, tp = fam
    jfn, tfn, version = _mixer_fns(name)
    cfg_j, cfg_t = jr.model, tr.model
    jm, tm = _layer0(jp), _layer0(tp)
    table = (1 + np.arange(8)).reshape(2, 4).astype(np.int32)
    jpool = jssm.init_paged_ssm_pool(cfg_j, 1, 9, version)
    jconv, jh = jpool["conv"][0], jpool["h"][0]
    tpool = tssm.init_paged_ssm_pool(cfg_t, 1, 9, version)
    rng = np.random.default_rng(11)
    for S, lengths, n_new in MIXER_STEPS:
        x = rng.standard_normal((2, S, cfg_t.d_model)).astype(np.float32)
        lens, nn = np.asarray(lengths, np.int32), np.asarray(n_new, np.int32)
        want, jconv, jh = jfn(jm, jnp.asarray(x), cfg_j, conv_pool=jconv,
                              h_pool=jh, page_table=jnp.asarray(table),
                              lengths=jnp.asarray(lens),
                              n_new=jnp.asarray(nn), page_size=PAGE,
                              fused=fused)
        got = tfn(tm, torch.from_numpy(x), cfg_t,
                  conv_pool=tpool["conv"][0], h_pool=tpool["h"][0],
                  page_table=torch.from_numpy(table),
                  lengths=torch.from_numpy(lens),
                  n_new=torch.from_numpy(nn).long(), page_size=PAGE,
                  fused=fused)
        valid = (np.arange(S)[None, :] < nn[:, None])[..., None]
        np.testing.assert_allclose(got.numpy() * valid,
                                   np.asarray(want) * valid,
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(tpool["h"][0, 1:].numpy(),
                                   np.asarray(jh)[1:], rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(tpool["conv"][0, 1:].numpy(),
                                   np.asarray(jconv)[1:], rtol=1e-4,
                                   atol=1e-5)


# ---------------------------------------------------------------------------
# 3. The port's own contract: fused == gathered, bitwise, on the CPU
# ---------------------------------------------------------------------------


def _step_fn(name):
    if name == "falcon":
        return ttr.ssm_paged_decode_step, \
            lambda r, n: ttr.init_paged_ssm_cache(r, n)
    return ttr.hybrid_paged_decode_step, \
        lambda r, n: ttr.init_paged_hybrid_cache(r, n, PAGE)


def test_fused_step_bitwise_equals_gathered(fam):
    """Logits of a prefill step and two decode steps, and every pool page
    but scratch page 0, are bitwise equal between the fused path (the
    kernel's plain version, compact plan) and the gathered scan."""
    name, _, _, tr, tp = fam
    step, init = _step_fn(name)
    sp = ttr.serving_params(tp, tr.model)
    table = torch.from_numpy((1 + np.arange(8)).reshape(2, 4)
                             .astype(np.int32))
    states = {f: init(tr, 9) for f in (True, False)}
    rng = np.random.default_rng(5)
    for S, lengths, n_new in MIXER_STEPS:
        toks = torch.from_numpy(rng.integers(0, tr.model.vocab_size,
                                             (2, S)))
        lens = torch.tensor(lengths, dtype=torch.int32)
        nn = torch.tensor(n_new)
        logits = {f: step(sp, states[f], toks, lens, nn, table, tr,
                          page_size=PAGE, fused=f)[0] for f in states}
        assert torch.equal(logits[True], logits[False])
    leaves = [tssm_leaves(states[f]) for f in (True, False)]
    for a, b in zip(*leaves, strict=True):
        assert torch.equal(a[:, 1:], b[:, 1:])


def tssm_leaves(state):
    from repro_torch.serve.kv_pages import state_leaves
    return state_leaves(state)


GREEDY = [(np.array([5, 9, 3, 7, 2, 11], np.int32), 8),
          (np.array([1, 2, 3], np.int32), 6),
          (np.array([4], np.int32), 5)]


def test_fused_greedy_engine_bitwise_equals_gathered(fam):
    """Temperature-0 tokens through the port's engine: fused == gathered
    (mixed prompt lengths, continuous batching, page crossings)."""
    _, _, _, tr, tp = fam
    outs = []
    for fused in (True, False):
        eng = TEngine(tr, tp, max_len=MAX_LEN, max_batch=2, page_size=PAGE,
                      fused=fused, device="cpu")
        outs.append([r.output.tolist() for r in eng.generate(
            [TRequest(prompt=p, max_new_tokens=n) for p, n in GREEDY])])
    assert outs[0] == outs[1]


# ---------------------------------------------------------------------------
# 4. Engine against JAX
# ---------------------------------------------------------------------------


def queue(vocab, seed, n, shared):
    """Mixed prompt lengths, more requests than slots, an 8-token shared
    prefix (two pages) on every other prompt when ``shared``, greedy and
    seeded sampled requests."""
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, vocab, 8).astype(np.int32)
    specs = []
    for i in range(n):
        p = rng.integers(0, vocab, int(rng.integers(2, 14))).astype(np.int32)
        if shared and i % 2 == 0:
            p = np.concatenate([prefix, p])
        samp = i % 3 != 0
        specs.append(dict(
            prompt=p, max_new_tokens=int(rng.integers(3, 7)),
            temperature=0.8 if samp else 0.0, top_k=20 if samp else 0,
            top_p=0.9 if samp else 1.0, seed=int(rng.integers(0, 2**31))))
    return specs


def outputs(engine, cls, specs):
    return [r.output.tolist() for r in engine.generate(
        [cls(**s) for s in specs])]


@pytest.mark.parametrize("shared", [True, False])
def test_engine_tokens_equal_jax(fam, shared):
    name, jr, jp, tr, tp = fam
    specs = queue(tr.model.vocab_size, 3 + shared, 5, shared)
    kw = dict(max_len=MAX_LEN, max_batch=MAX_BATCH, page_size=PAGE)
    want = outputs(JEngine(jr, jp, fused=not shared, **kw), JRequest, specs)
    eng = TEngine(tr, tp, device="cpu", **kw)
    assert outputs(eng, TRequest, specs) == want
    if shared:
        assert eng.stats["shared_tokens"] > 0


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_prefix_sharing_matches_no_sharing(name):
    """Snapshot-page prefix sharing computes fewer prefill tokens and
    never changes outputs; the pool drains once the trie lets go."""
    tr = f32(t_reduce(t_get_config(ARCHS[name], "decode_32k")))
    tp = ttr.init_model(tr, seed=2, device="cpu")
    common = np.arange(1, 9, dtype=np.int32)               # 2 pages of 4

    def reqs():
        return [TRequest(prompt=np.concatenate(
                    [common, np.array([20 + i], np.int32)]),
                         max_new_tokens=4) for i in range(4)]
    kw = dict(max_len=MAX_LEN, max_batch=2, page_size=PAGE, device="cpu")
    base = TEngine(tr, tp, share_prefix=False, **kw)
    shared = TEngine(tr, tp, **kw)
    for a, b in zip(base.generate(reqs()), shared.generate(reqs()),
                    strict=True):
        np.testing.assert_array_equal(a.output, b.output)
    sb, ss = base.scheduler.stats, shared.scheduler.stats
    assert ss["prefill_tokens"] < sb["prefill_tokens"]
    assert ss["shared_tokens"] > 0
    assert not shared.scheduler.partial_prefix       # snapshot backend
    shared.scheduler.drop_prefix_cache()
    assert shared.scheduler.alloc.n_free == shared.scheduler.alloc.n_pages - 1


def test_ssm_full_prompt_hit_recomputes_last_page_only(fam):
    """A page-aligned full-prompt hit on a snapshot backend drops the last
    shared page and recomputes exactly page_size tokens."""
    _, _, _, tr, tp = fam
    prompt = np.arange(1, 9, dtype=np.int32)                # exactly 2 pages
    eng = TEngine(tr, tp, max_len=MAX_LEN, max_batch=1, page_size=PAGE,
                  device="cpu")
    a = eng.generate([TRequest(prompt=prompt, max_new_tokens=5)])[0]
    pt0 = eng.scheduler.stats["prefill_tokens"]
    b = eng.generate([TRequest(prompt=prompt, max_new_tokens=5)])[0]
    np.testing.assert_array_equal(a.output, b.output)
    assert eng.scheduler.stats["prefill_tokens"] == pt0 + PAGE
    with pytest.raises(ValueError, match="snapshot"):
        eng.backend.fork_partial(eng.scheduler.state, 1, 2)
    eng.scheduler.drop_prefix_cache()
    assert eng.scheduler.alloc.n_free == eng.scheduler.alloc.n_pages - 1


# ---------------------------------------------------------------------------
# 5. Conversion, backends, CLI
# ---------------------------------------------------------------------------


def test_params_from_jax_checks_paths_and_shapes(fam):
    name, jr, jp, tr, tp = fam
    expect = ttr.param_shapes(tr)
    key = "backbone" if name == "zamba2" else "mid"
    assert set(tp) == set(expect)
    tree = jax.tree.map(np.asarray, jp)
    bad = dict(tree, final_norm={"scale": tree["final_norm"]["scale"][:-1]})
    with pytest.raises(ValueError, match="final_norm.scale: shape"):
        params_from_jax(bad, tr, "cpu")
    sub = dict(tree[key])
    sub["extra"] = sub.pop(next(iter(sub)))
    with pytest.raises(ValueError, match=f"{key}: keys"):
        params_from_jax(dict(tree, **{key: sub}), tr, "cpu")


def test_make_backend_picks_the_family_and_refuses_spec(fam):
    """The family's backend, with its speculative-decoding hooks: a
    verify forward and a deferred commit, and coarse-depth draft pools
    (the name predates the spec slice, when both were refused)."""
    name, _, _, tr, tp = fam
    be = make_backend(tr, tp, page_size=PAGE, device="cpu")
    assert type(be) is (SSMStateBackend if name == "falcon"
                        else HybridBackend)
    assert be.snapshot_state
    verify, commit = be._verify_fns()
    assert verify.func is (ttr.ssm_paged_verify_step if name == "falcon"
                           else ttr.hybrid_paged_verify_step)
    assert commit.func is (ttr.ssm_paged_commit_step if name == "falcon"
                           else ttr.hybrid_paged_commit_step)
    _, rcfg_d, n_coarse = be.coarse_draft(2)
    state = be.init_draft_state(rcfg_d, n_coarse, 4)
    mamba = state if name == "falcon" else state["mamba"]
    assert mamba["h"].shape[:2] == (n_coarse, 4)


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_serve_cli_runs_on_cpu_and_refuses_without_card(name, capsys,
                                                        monkeypatch):
    assert serve_cli.main(["--arch", ARCHS[name], "--reduced", "--device",
                           "cpu", "--requests", "3", "--max-batch", "2",
                           "--page-size", "4", "--new-tokens", "3",
                           "--shared-prefix-len", "8", "--temperature",
                           "0.7", "--top-k", "10"]) == 0
    out = capsys.readouterr().out
    cls = "SSMStateBackend" if name == "falcon" else "HybridBackend"
    assert f"{cls} on cpu" in out
    assert out.count("-> [") == 3
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit):
        serve_cli.main(["--arch", ARCHS[name], "--reduced"])
