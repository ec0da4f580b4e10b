"""The SSM and hybrid training slice: the port's selective scan, dense
mamba mixers, mamba blocks, whole-model loss and gradients and
``Trainer`` against the JAX package, float32 on the CPU.

Inputs are made with numpy from a seed and handed to both frameworks;
models are the reduced ``falcon_mamba_7b`` (mamba1, 10 layers: 1 open, 8
ParallelNet, 1 close) and ``zamba2_1p2b`` (mamba2, shared attention
every 3 of 8 layers), with the JAX init's weights converted by
``params_from_jax``; the JAX side is jitted and run once per case.

Tolerances: the scan's plain version holds JAX's Pallas kernel
(interpret mode) and its jnp oracle to the reference's own 1e-4 (float32)
and 5e-2 (bf16) of ``tests/test_kernels.py``, and its autograd
cotangents hold ``jax.vjp`` of the oracle to 1e-4 of each cotangent's
largest magnitude (long float32 sums in another order). The mixers:
rtol 1e-4 / atol 1e-5, as the serving mixers; the port adds mamba1's
``D * x`` in float32 before rounding, the reference after (ulps in
float32). Whole models: per gradient leaf ``max|port - jax| <= 1e-4 *
max|jax leaf|``, the loss within 1e-5 relative; three optimizer steps
within 1e-3 relative. Each CUDA kernel against its plain version on a
card: ``test_torch_gpu.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.reduce import reduce_config as j_reduce
from repro.configs.registry import get_config as j_get_config
from repro.kernels import ref as jref
from repro.kernels.ssm_scan import ssm_scan as j_ssm_scan
from repro.models import blocks as jblocks
from repro.models import ssm as jssm
from repro.models import transformer as jtr
from repro.train.trainer import Trainer as JTrainer
from repro_torch.configs.reduce import reduce_config as t_reduce
from repro_torch.configs.registry import get_config as t_get_config
from repro_torch.convert import params_from_jax
from repro_torch.data.pipeline import shard_batch
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ssm_scan as tss
from repro_torch.models import blocks as tblocks
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as ttr
from repro_torch.optim import optimizers
from repro_torch.train.trainer import Trainer
from repro_torch.tree import leaves_with_paths, unflatten
from test_torch_gpu import ssm_scan_case, to_torch

torch.set_num_threads(2)
GRAD_REL = 1e-4
ARCHS = {"falcon": "falcon_mamba_7b", "zamba2": "zamba2_1p2b"}
# (Bb, S, di, ds, chunk): the grid of tests/test_kernels.py
SCAN_GRID = [(2, 128, 64, 16, 32), (1, 64, 128, 8, 64),
             (2, 256, 32, 16, 128)]


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def f32_configs(arch):
    """The reduced config of ``arch`` in float32, for both packages."""
    def one(get, reduce):
        rcfg = reduce(get(arch))
        return rcfg.replace(model=dataclasses.replace(rcfg.model,
                                                      dtype="float32"))
    return one(j_get_config, j_reduce), one(t_get_config, t_reduce)


# ---------------------------------------------------------------------------
# 1. The selective scan: plain version vs the JAX kernel and its oracle
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4),
                                       ("bfloat16", 5e-2)])
@pytest.mark.parametrize("Bb,S,di,ds,chunk", SCAN_GRID)
def test_ssm_scan_plain_matches_jax(Bb, S, di, ds, chunk, dtype, tol):
    dt, x, A, B, C, D, _ = ssm_scan_case(S + di, Bb, S, di, ds)
    jargs = [jnp.asarray(a) for a in (dt, x, A, B, C, D)]
    targs = to_torch(dt, x, A, B, C, D)
    for i in (0, 1, 3, 4):            # dt, x, B, C in the working dtype
        jargs[i] = jargs[i].astype(dtype)
        targs[i] = targs[i].to(getattr(torch, dtype))
    got = tss.ssm_scan_ref(*targs)
    assert got.dtype == targs[1].dtype
    for want in (j_ssm_scan(*jargs, chunk=chunk, interpret=True),
                 jref.ssm_scan_ref(*jargs)):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   rtol=tol, atol=tol)


@pytest.mark.parametrize("Bb,S,di,ds", [(2, 48, 32, 16), (1, 70, 24, 8)])
def test_ssm_scan_plain_grads_match_jax_vjp(Bb, S, di, ds):
    dt, x, A, B, C, D, gy = ssm_scan_case(3 * S + di, Bb, S, di, ds)
    _, vjp = jax.vjp(jref.ssm_scan_ref,
                     *map(jnp.asarray, (dt, x, A, B, C, D)))
    want = vjp(jnp.asarray(gy))
    args = [a.requires_grad_(True) for a in to_torch(dt, x, A, B, C, D)]
    got = torch.autograd.grad(tss.ssm_scan_ref(*args), args,
                              torch.from_numpy(gy))
    for name, g, w in zip(("dt", "x", "A", "B", "C", "D"), got, want):
        w = np.asarray(w)
        err = np.abs(g.numpy() - w).max()
        assert err <= GRAD_REL * np.abs(w).max(), (name, err)


def test_ssm_scan_dispatch_cpu_to_plain_and_kernels_refuse_cpu():
    """ops sends CPU tensors to the plain scan (differentiable through
    autograd); the kernel wrappers raise on CPU tensors and count
    nothing."""
    args = to_torch(*ssm_scan_case(4, 1, 9, 8, 4)[:6])
    before = (tss.ssm_scan_fwd.launches, tss.ssm_scan_bwd.launches)
    assert torch.equal(tops.ssm_scan(*args), tss.ssm_scan_ref(*args))
    for fn in (tss.ssm_scan, tss.ssm_scan_fwd):
        with pytest.raises(ValueError, match="CUDA tensors only"):
            fn(*args)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        tss.ssm_scan_bwd(*args, torch.zeros(1, 1, 8, 8), args[1])
    assert (tss.ssm_scan_fwd.launches, tss.ssm_scan_bwd.launches) == before


def _scan_bwd_plan(dt, x, A, B, C, D, gy, chunk=tss.CHUNK, sub=8,
                   tile=tss.TILE):
    """float32 emulation of the backward plan of ``csrc/ssm_scan.cu``:
    (1) per chunk k >= 1, the chunk walked backwards with no cotangent
    from the right gives c_k and sum dt; (2) lam_k right to left, lam_{k-1}
    = c_k + exp(A sum dt) lam_k; (3) per chunk, h from the stored state
    hc[k] forward to every ``sub``-step start, then each sub-chunk
    recomputed and walked backwards from lam_k; gB/gC as one partial per
    (t, tile of ``tile`` rows), gA/gD as one per (b, k), each added in a
    fixed order. Returns the six cotangents and P_k = exp(A sum dt) of
    chunks 1.. (Bb, nC - 1, di, ds)."""
    Bb, S, di = x.shape
    ds = A.shape[1]
    n_c, n_t = -(-S // chunk), -(-di // tile)
    a = torch.exp(dt[..., None] * A)                  # (Bb, S, di, ds)
    inp = (dt * x)[..., None] * B[:, :, None, :]
    h, hc = torch.zeros(Bb, di, ds), []
    for t in range(S):                                # the forward's states
        if t % chunk == 0:
            hc.append(h)
        h = a[:, t] * h + inp[:, t]
    c, dsum = torch.zeros(Bb, n_c, di, ds), torch.zeros(Bb, n_c, di)
    for k in range(1, n_c):                           # phase 1
        gc = torch.zeros(Bb, di, ds)
        for t in reversed(range(k * chunk, min(S, (k + 1) * chunk))):
            gc = a[:, t] * (gy[:, t, :, None] * C[:, t, None, :] + gc)
            dsum[:, k] += dt[:, t]
        c[:, k] = gc
    P = torch.exp(A * dsum[:, 1:, :, None])
    lam, lk = torch.zeros_like(c), torch.zeros(Bb, di, ds)
    for k in range(n_c - 1, 0, -1):                   # phase 2
        lam[:, k] = lk
        lk = c[:, k] + P[:, k - 1] * lk
    lam[:, 0] = lk
    gdt, gx = torch.zeros(Bb, S, di), torch.zeros(Bb, S, di)
    part = torch.zeros(Bb, S, n_t, 2, ds)
    gA_part, gD_part = torch.zeros(Bb, n_c, di, ds), torch.zeros(Bb, n_c, di)
    for k in range(n_c):                              # phase 3
        t0, t1 = k * chunk, min(S, (k + 1) * chunk)
        starts, hh = {}, hc[k]
        for t in range(t0, t1):
            if (t - t0) % sub == 0:
                starts[t] = hh
            hh = a[:, t] * hh + inp[:, t]
        gc = lam[:, k]
        for j0 in reversed(range(t0, t1, sub)):
            hs, hp = [], starts[j0]
            for t in range(j0, min(j0 + sub, t1)):    # recompute
                hp = a[:, t] * hp + inp[:, t]
                hs.append(hp)
            for i in reversed(range(len(hs))):
                t = j0 + i
                prev = hs[i - 1] if i else starts[j0]
                g = gy[:, t, :, None] * C[:, t, None, :] + gc
                gc = a[:, t] * g
                th = gc * prev
                s1 = (g * B[:, t, None, :]).sum(-1)
                gx[:, t] = dt[:, t] * s1 + D * gy[:, t]
                gdt[:, t] = x[:, t] * s1 + (A * th).sum(-1)
                gA_part[:, k] += dt[:, t, :, None] * th
                gbc = (g * (dt * x)[:, t, :, None], gy[:, t, :, None] * hs[i])
                for q in range(n_t):
                    rows = slice(q * tile, (q + 1) * tile)
                    for j, v in enumerate(gbc):
                        part[:, t, q, j] = v[:, rows].sum(1)
        gD_part[:, k] = (gy * x)[:, t0:t1].sum(1)
    gBC = part[:, :, 0]
    for q in range(1, n_t):
        gBC = gBC + part[:, :, q]
    gA, gD = torch.zeros(di, ds), torch.zeros(di)
    for b in range(Bb):
        for k in range(n_c):
            gA, gD = gA + gA_part[b, k], gD + gD_part[b, k]
    return (gdt, gx, gA, gBC[:, :, 0], gBC[:, :, 1], gD), P


# (Bb, S, di, ds, stride-0 decay, underflow, tile): three chunks with a
# ragged tail, S below one chunk, mamba2's stride-0 decay, and a decay
# large enough that whole chunks' products are exactly 0
SCAN_PLAN_CASES = [(2, 150, 12, 16, False, False, 4),
                   (1, 40, 10, 8, False, False, 4),
                   (1, 150, 16, 8, True, False, 8),
                   (2, 150, 12, 4, False, True, 4)]


@pytest.mark.parametrize("Bb,S,di,ds,stride0,underflow,tile",
                         SCAN_PLAN_CASES)
def test_ssm_scan_bwd_plan_matches_autograd_and_jax_vjp(
        Bb, S, di, ds, stride0, underflow, tile):
    """The chunk-parallel backward plan of the scan kernel, emulated in
    float32, gives every cotangent of the plain version's autograd and of
    jax.vjp of the reference within 1e-4 of each cotangent's largest
    magnitude."""
    dt, x, A, B, C, D, gy = ssm_scan_case(7 * S + di, Bb, S, di, ds)
    if stride0:
        A = np.repeat(A[:, :1], ds, axis=1)
    if underflow:                     # rows whose chunk products are 0
        A[: di // 2] *= 200.0
    ins = to_torch(dt, x, A, B, C, D)
    tA = ins[2][:, :1].expand(di, ds) if stride0 else ins[2]
    got, P = _scan_bwd_plan(ins[0], ins[1], tA, *ins[3:],
                            torch.from_numpy(gy), tile=tile)
    if underflow:
        assert (P[:, :, : di // 2] == 0).all() and (P[:, :, di // 2:] > 0).all()
    args = [t.clone().requires_grad_(True) for t in ins]
    want_t = torch.autograd.grad(tss.ssm_scan_ref(*args), args,
                                 torch.from_numpy(gy))
    _, vjp = jax.vjp(jref.ssm_scan_ref,
                     *map(jnp.asarray, (dt, x, A, B, C, D)))
    want_j = vjp(jnp.asarray(gy))
    for name, g, wt, wj in zip(("dt", "x", "A", "B", "C", "D"), got, want_t,
                               want_j):
        for w in (wt.numpy(), np.asarray(wj)):
            assert g.shape == w.shape, name
            err = np.abs(g.numpy() - w).max()
            assert err <= GRAD_REL * np.abs(w).max(), (name, err)


# ---------------------------------------------------------------------------
# 2. Dense mixers and mamba blocks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fam", sorted(ARCHS))
def test_dense_mixer_matches_jax(fam):
    jr, tr = f32_configs(ARCHS[fam])
    version = jr.model.ssm.version
    init = jssm.init_mamba1 if version == 1 else jssm.init_mamba2
    jp = init(jax.random.PRNGKey(5), jr.model)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    x = np.random.default_rng(5).standard_normal(
        (2, 20, jr.model.d_model)).astype(np.float32)
    japply = jssm.mamba1_apply if version == 1 else jssm.mamba2_apply
    tapply = tssm.mamba1_apply if version == 1 else tssm.mamba2_apply
    want, _ = jax.jit(lambda p, v: japply(p, v, jr.model))(jp,
                                                           jnp.asarray(x))
    got = tapply(tp, torch.from_numpy(x), tr.model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("kind", ["mamba1", "mamba2"])
def test_mamba_block_F_matches_jax(kind):
    jr, tr = f32_configs(ARCHS["falcon" if kind == "mamba1" else "zamba2"])
    jp = jblocks.init_block(jax.random.PRNGKey(6), jr.model, kind)
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp)
    z = np.random.default_rng(6).standard_normal(
        (2, 16, jr.model.d_model)).astype(np.float32)
    want, _ = jax.jit(lambda p, v: jblocks.block_F(
        p, v, jr.model, kind=kind, causal=True))(jp, jnp.asarray(z))
    got = tblocks.block_F(tp, torch.from_numpy(z), tr.model, kind=kind,
                          causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# 3. The whole model: loss, fwd_norms and every gradient leaf; Trainer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fam,mode", [("falcon", "lp"),
                                      ("falcon", "serial"),
                                      ("zamba2", "serial")])
def test_loss_fn_and_grads_match_jax(fam, mode):
    jr, tr = f32_configs(ARCHS[fam])
    jparams = jax.jit(jtr.init_model, static_argnums=1)(
        jax.random.PRNGKey(0), jr)
    tparams = params_from_jax(np_tree(jparams), tr, "cpu")
    rng = np.random.default_rng(0)
    V = jr.model.vocab_size
    batch = {"tokens": rng.integers(0, V, (2, 16)).astype(np.int32),
             "labels": rng.integers(0, V, (2, 16)).astype(np.int32)}
    (jl, jdiag), jg = jax.jit(jax.value_and_grad(
        lambda p: jtr.loss_fn(p, jax.tree.map(jnp.asarray, batch), jr,
                              mode=mode), has_aux=True))(jparams)
    paths, leaves = zip(*leaves_with_paths(tparams))
    leaves = [p.detach().requires_grad_(True) for p in leaves]
    loss, diag = ttr.loss_fn(unflatten(zip(paths, leaves)),
                             shard_batch(batch, "cpu"), tr, mode=mode)
    grads = dict(zip(paths, torch.autograd.grad(loss, leaves)))
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    jn = np.asarray(jdiag["fwd_norms"])
    np.testing.assert_allclose(diag["fwd_norms"].numpy(), jn,
                               rtol=1e-4 * max(1.0, np.abs(jn).max()),
                               atol=1e-4 * max(1.0, np.abs(jn).max()))
    want = dict(leaves_with_paths(np_tree(jg)))
    assert set(grads) == set(want)
    for path, w in want.items():
        err = np.abs(grads[path].numpy() - w).max()
        assert err <= GRAD_REL * np.abs(w).max(), (path, err,
                                                   np.abs(w).max())


def test_trainer_three_steps_match_jax():
    jr, tr = f32_configs(ARCHS["falcon"])
    jt = JTrainer(jr, seed=0)
    tt = Trainer(tr, seed=0, device="cpu")
    tt.params = params_from_jax(np_tree(jt.params), tr, "cpu")
    tt.opt_state = optimizers.init_opt_state(tr.optimizer, tt.params)
    jrep = jt.train(3, log_every=0, probe=False)
    trep = tt.train(3, log_every=0, probe=False)
    np.testing.assert_allclose(trep.losses, jrep.losses, rtol=1e-3)


def test_apply_updates_in_pieces_is_bitwise_whole(monkeypatch):
    """A large leaf is updated in flat pieces (falcon-mamba-7b's 6.4 GB
    in_proj stack would not fit its temporaries beside the model on one
    card): params and both moments come out bit-identical to a whole-leaf
    update, a non-contiguous gradient included."""
    cfg = t_get_config("falcon_mamba_7b").optimizer
    rng = np.random.default_rng(8)
    shapes = {"stack": (3, 40, 60), "embed": (70, 30), "norm": (5,)}
    params = {k: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
              for k, s in shapes.items()}
    grads = {k: torch.from_numpy(rng.standard_normal(s[::-1]).astype(
        np.float32)).permute(*reversed(range(len(s))))
        for k, s in shapes.items()}
    runs = []
    for piece in (1 << 40, 256):
        monkeypatch.setattr(optimizers, "_SLICE_ELEMS", piece)
        p = {k: v.clone() for k, v in params.items()}
        state = optimizers.init_opt_state(cfg, p)
        for _ in range(2):
            optimizers.apply_updates(cfg, p, grads, state)
        runs.append((p, state))
    (p1, s1), (p2, s2) = runs
    for k in shapes:
        assert torch.equal(p1[k], p2[k])
        assert torch.equal(s1["m"][k], s2["m"][k])
        assert torch.equal(s1["v"][k], s2["v"][k])


def test_apply_updates_refuses_non_contiguous_leaf():
    """The in-place update writes through flat views of params and
    moments: a non-contiguous param raises instead of updating a copy."""
    cfg = t_get_config("falcon_mamba_7b").optimizer
    params = {"w": torch.ones(6, 4).t()}
    grads = {"w": torch.ones(4, 6)}
    state = optimizers.init_opt_state(cfg, params)
    with pytest.raises(RuntimeError):
        optimizers.apply_updates(cfg, params, grads, state)
