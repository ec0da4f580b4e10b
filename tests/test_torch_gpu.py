"""The port's CUDA kernels against their plain PyTorch versions, on a
card. The kernels have no CPU mode, so every test here needs CUDA and
skips with a reason elsewhere; this file imports no jax, so it also runs
where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances: float32 2e-5 (the repo's float32 attention tolerance);
bfloat16 2e-2 (the flash kernels multiply bf16 tiles on the tensor cores
and round P and dS to bf16 in the backward; the plain version works in
float32). The bf16 attention output is also held per element to
1e-3 + 1e-2 x |plain| (the later causal rows hold values far below
2e-2). Gradients are held to the same numbers times each tensor's
largest magnitude; RMSNorm to 1e-5 in float32. Paged attention must also
give the same bits for the live-page table and a wider one, for pools
poisoned past each slot's last visible key, and on a second launch (the
split-KV decode path merges its splits in a fixed order, no atomics). Backward kernels must
also give bit-identical gradients on a second run (fixed summation
order, no atomics). Sampling: survivors bit-equal; the kernel sums the nucleus
mass in another order, so tokens whose cumulative mass lies within float
rounding of p may flip — their total probability per row must stay
below 1e-5 (the two masks' sampling distributions are that close in
total variation). Paged SSM update: y on valid rows and the non-scratch
pool pages within 1e-5 of the plain version's largest magnitude (nvcc
contracts multiply-adds into FMAs and the card's expf is not the CPU's,
over up to S sequential steps); pages outside the write plan bit-equal;
the pool updated in place; a second launch bit-identical. Selective scan: y
within 1e-5 and each of the six cotangents within 1e-4 of the plain
version's largest magnitude (FMAs, expf, and float32 sums over up to
8192 rows and S steps in another order); a second backward
bit-identical. The input builders are shared with
``test_torch_kernels.py``, ``test_torch_ssm.py`` and
``test_torch_ssm_train.py``.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import paged_attention as tpa
from repro_torch.kernels import paged_ssm as tps
from repro_torch.kernels import rmsnorm as trn
from repro_torch.kernels import sampling as tsp
from repro_torch.kernels import ssm_scan as tss
from repro_torch.models import ssm as tssm


def attn_case(seed, B, S, H, Hkv, hd, page_size=4, pages_per_slot=4,
              dtype=np.float32):
    """Random pool + disjoint per-slot page tables + mixed lengths
    (numpy), the grid of ``tests/test_kernels_paged.py``."""
    rng = np.random.default_rng(seed)
    n_pages = 1 + B * pages_per_slot                   # page 0 = scratch
    q = (rng.standard_normal((B, S, H, hd)) * 0.5).astype(dtype)
    pk = (rng.standard_normal((n_pages, page_size, Hkv, hd)) * 0.5) \
        .astype(dtype)
    pv = (rng.standard_normal((n_pages, page_size, Hkv, hd)) * 0.5) \
        .astype(dtype)
    table = (1 + np.arange(B * pages_per_slot)).reshape(
        B, pages_per_slot).astype(np.int32)
    cap = pages_per_slot * page_size
    lengths = np.minimum(np.arange(B) * 3 + 1, cap - S).astype(np.int32)
    return q, pk, pv, table, lengths


def ssm_case(seed, B, S, R, ds, pages_per_slot, lengths, n_new):
    """dt/x/Bm/Cm/A/h_pool (float32) and page table, lengths, n_new
    (int32), numpy: the paged SSM cases of ``tests/test_kernels_paged.py``
    (the write plan is the caller's, for its page size)."""
    rng = np.random.default_rng(seed)
    n_pages = 1 + B * pages_per_slot                   # page 0 = scratch

    def r(*shape):
        return rng.standard_normal(shape).astype(np.float32)
    dt = (np.log1p(np.exp(r(B, S, R))) * 0.2).astype(np.float32)
    A = (-np.exp(r(R, ds))).astype(np.float32)
    table = (1 + np.arange(B * pages_per_slot)).reshape(
        B, pages_per_slot).astype(np.int32)
    return (dt, r(B, S, R), r(B, S, ds), r(B, S, ds), A,
            r(n_pages, R, ds), table, np.asarray(lengths, np.int32),
            np.asarray(n_new, np.int32))


def ssm_plan(table, lengths, n_new, page_size, S):
    """(read_page, live, phys_w, t_w) from the port's planners."""
    t_w, phys_w = tssm.compact_snapshot_steps(table, lengths, n_new,
                                              page_size, S)
    read_page, live = tssm.paged_read_plan(table, lengths, page_size)
    return read_page, live, phys_w, t_w


# (S, lengths, n_new) at B=2, R=8, ds=4, page_size 4, 3 pages per slot:
# a decode step crossing a page boundary; chunked prefill + an idle slot;
# an empty slot (no live read page)
SSM_CASES = [(1, [3, 0], [1, 1]), (4, [2, 5], [4, 0]), (1, [0, 7], [1, 1])]


def flash_case(seed, B, H, Hkv, Sq, Sk, hd):
    """q (B, H, Sq, hd), k/v (B, Hkv, Sk, hd) and an output cotangent
    (numpy, float32): the TPU kernel's layout."""
    rng = np.random.default_rng(seed)

    def r(*shape):
        return (rng.standard_normal(shape) * 0.5).astype(np.float32)
    return r(B, H, Sq, hd), r(B, Hkv, Sk, hd), r(B, Hkv, Sk, hd), \
        r(B, H, Sq, hd)


def rms_case(seed, R, D):
    """x (R, D), w (D,) near 1 and an output cotangent (numpy)."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((R, D)) * 2.0).astype(np.float32), \
        (1.0 + 0.1 * rng.standard_normal(D)).astype(np.float32), \
        rng.standard_normal((R, D)).astype(np.float32)


# (B, H, Hkv, Sq, Sk, hd, causal): the CPU grid (S <= 32) — GQA, MQA,
# non-causal with Sq != Sk, hd = 128
FLASH_GRID = [(2, 4, 2, 32, 32, 16, True),
              (1, 8, 1, 32, 32, 16, True),
              (1, 2, 2, 16, 32, 16, False),
              (1, 2, 2, 16, 16, 128, True)]


def ssm_scan_case(seed, Bb, S, di, ds):
    """dt (softplus, x0.2), x, A (-exp), B, C, D near 1 and an output
    cotangent gy (numpy, float32): the inputs of ``repro.kernels.ssm_scan``
    as ``tests/test_kernels.py`` draws them."""
    rng = np.random.default_rng(seed)

    def r(*shape):
        return rng.standard_normal(shape).astype(np.float32)
    dt = (np.log1p(np.exp(r(Bb, S, di))) * 0.2).astype(np.float32)
    return (dt, r(Bb, S, di), (-np.exp(r(di, ds))).astype(np.float32),
            r(Bb, S, ds), r(Bb, S, ds), (1.0 + 0.1 * r(di)).astype(np.float32),
            r(Bb, S, di))


def to_torch(*arrays, device="cpu"):
    return [torch.from_numpy(np.array(a)).to(device) for a in arrays]


def sampling_case(seed, B=4, V=128):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((B, V)) * 1.5).astype(np.float32)
    top_ks = np.asarray([0, 5, 1, V, 40, 0, 3, 7], np.int32)[:B]
    top_ps = np.asarray([1.0, 0.9, 0.5, 0.73, 0.95, 0.3, 1.0, 0.6],
                        np.float32)[:B]
    return logits, top_ks, top_ps


def flipped_mass(logits, keep_a, keep_b) -> float:
    """Largest per-row probability (softmax over the union of both
    survivor sets) of the tokens the two masks disagree on."""
    union = torch.where(keep_a | keep_b, logits.float(),
                        torch.full_like(logits.float(), -float("inf")))
    prob = torch.softmax(union, dim=-1)
    return float((prob * (keep_a != keep_b)).sum(-1).max())


SAMPLING_TV = 1e-5
GRID = [(2, 1, 2, 2, 16),       # plain decode step
        (2, 4, 4, 2, 16),       # chunked prefill, GQA
        (3, 2, 4, 1, 32),       # MQA
        (2, 4, 4, 2, 64)]       # GQA, wider heads


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(np.float32, 2e-5),
                                       ("bfloat16", 2e-2)])
@pytest.mark.parametrize("B,S,H,Hkv,hd,page_size,pages", [
    *(g + (4, 4) for g in GRID),
    (4, 1, 16, 8, 128, 16, 8),          # qwen3_1p7b decode
    (4, 64, 16, 8, 128, 16, 8),         # qwen3_1p7b prefill chunk
    (4, 1, 32, 32, 64, 16, 8),          # zamba2_1p2b shared attn decode
    (4, 64, 32, 32, 64, 16, 8),         # zamba2_1p2b prefill chunk
    (4, 128, 32, 32, 64, 16, 16),       # zamba2_1p2b prefill, multi-row
    (2, 1, 48, 1, 128, 16, 8),          # MQA decode: 12 split row tiles
    (2, 4, 48, 1, 128, 16, 8)])         # MQA verify: 192 multi-row rows
def test_paged_flash_attention_matches_plain_on_card(
        B, S, H, Hkv, hd, page_size, pages, dtype, tol):
    _need_card()
    case = to_torch(*attn_case(B + S, B, S, H, Hkv, hd, page_size, pages),
                    device="cuda")
    if dtype == "bfloat16":
        case[:3] = [t.to(torch.bfloat16) for t in case[:3]]
    want = tpa.paged_attention_ref(*case).float()
    got = tpa.paged_flash_attention(*case).float()
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= tol


def _split_keys() -> int:
    return tpa.plan(torch.bfloat16, 1, 1, 1, 1, 128, 16, 1).split_keys


def _poison_past_length(pk, pv, table, lengths, S):
    """Copies of the pools whose rows past each slot's last visible key
    hold 1e30."""
    pk, pv = pk.clone(), pv.clone()
    ps = pk.shape[1]
    for b in range(table.shape[0]):
        rows = (table[b].long()[:, None] * ps
                + torch.arange(ps, device=pk.device)).reshape(-1)
        dead = rows[int(lengths[b]) + S:]
        pk.view(-1, *pk.shape[2:])[dead] = 1e30
        pv.view(-1, *pv.shape[2:])[dead] = 1e30
    return pk, pv


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("g", [1, 3, 48])
def test_paged_decode_split_edges_match_plain_on_card(g, dtype, tol):
    """The split-KV decode path at contexts on both sides of a split
    boundary (0, 1, kSplitKeys - 1, kSplitKeys, kSplitKeys + 1), at
    g = 1, 3 and 48 (MQA: 12 row tiles), hd 128, one KV head, pages in
    random order: within the tolerance of the plain version; the
    live-bucket table and a table twice as wide give the same bits, and
    so do pools poisoned past each slot's last visible key."""
    _need_card()
    ks = _split_keys()
    ctx = [0, 1, ks - 1, ks, ks + 1]
    B, ps = len(ctx), 16
    live = -(-(ks + 2) // ps)
    q, pk, pv, _, _ = attn_case(g + 7, B, 1, g, 1, 128, ps, 2 * live)
    table = (1 + np.random.default_rng(g).permutation(B * 2 * live)) \
        .reshape(B, 2 * live).astype(np.int32)
    q, pk, pv, table, lens = to_torch(q, pk, pv, table,
                                      np.asarray(ctx, np.int32),
                                      device="cuda")
    q, pk, pv = (t.to(dtype) for t in (q, pk, pv))
    assert tpa.plan(dtype, B, 1, g, 1, 128, ps, 2 * live).split
    want = tpa.paged_attention_ref(q, pk, pv, table, lens).float()
    got = tpa.paged_flash_attention(q, pk, pv, table, lens)
    cut = tpa.paged_flash_attention(q, pk, pv, table[:, :live], lens)
    poisoned = tpa.paged_flash_attention(
        q, *_poison_past_length(pk, pv, table, lens, 1), table, lens)
    torch.cuda.synchronize()
    assert (got.float() - want).abs().max().item() <= tol
    assert torch.equal(got, cut)
    assert torch.equal(got, poisoned)


@pytest.mark.gpu
@pytest.mark.parametrize("S,lengths", [(1, [287, 301, 150, 64]),
                                       (256, [0, 37, 100, 200])])
def test_paged_flash_attention_is_bit_repeatable_on_card(S, lengths):
    """qwen3_1p7b's heads in bf16: a second launch gives the same bits on
    the split-KV decode path (S = 1) and the tensor-core multi-row path
    (a 256-token prefill chunk)."""
    _need_card()
    q, pk, pv, table, _ = attn_case(S, 4, S, 16, 8, 128, 16, 32)
    case = to_torch(q, pk, pv, table, np.asarray(lengths, np.int32),
                    device="cuda")
    case[:3] = [t.to(torch.bfloat16) for t in case[:3]]
    assert tpa.plan(torch.bfloat16, 4, S, 16, 8, 128, 16, 32).split \
        == (S == 1)
    first = tpa.paged_flash_attention(*case)
    second = tpa.paged_flash_attention(*case)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.gpu
def test_topk_topp_mask_matches_plain_on_card():
    _need_card()
    case = to_torch(*sampling_case(12, B=8, V=151936), device="cuda")
    want = tsp.topk_topp_mask_ref(*case)
    got = tsp.topk_topp_mask(*case)
    torch.cuda.synchronize()
    keep_w, keep_g = want > -1e30, got > -1e30
    assert torch.equal(got[keep_w & keep_g], want[keep_w & keep_g])
    assert flipped_mass(case[0], keep_w, keep_g) <= SAMPLING_TV


def _grads(fn, q, k, v, do):
    q, k, v = (x.detach().requires_grad_(True) for x in (q, k, v))
    out = fn(q, k, v)
    return (out, *torch.autograd.grad(out, (q, k, v), do))


def _kernel_bhsd(q, k, v, causal):
    """The flash kernel path on the TPU kernel's layout (B, H, S, hd)."""
    return tfa.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2), causal=causal) \
        .transpose(1, 2)


def _scaled_err(got, want):
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max().clamp(min=1e-30)).item()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("B,H,Hkv,Sq,Sk,hd,causal", [
    (1, 4, 4, 128, 128, 64, True),
    (2, 4, 2, 128, 128, 32, True),      # GQA
    (1, 8, 1, 256, 256, 64, True),      # MQA
    (1, 2, 2, 128, 256, 64, False),     # non-causal, Sq != Sk
    (2, 2, 2, 384, 384, 128, True),     # hd = 128
    (1, 4, 2, 100, 77, 64, True),       # ragged tiles, top-left causal
    (1, 4, 2, 77, 100, 16, False),
    (1, 4, 2, 200, 333, 128, True),     # Sq != Sk, not multiples of tiles
    (2, 16, 8, 1024, 1024, 128, True)])  # qwen3_1p7b widths
def test_flash_attention_fwd_bwd_match_plain_on_card(
        B, H, Hkv, Sq, Sk, hd, causal, dtype, tol):
    _need_card()
    _check_flash_on_card(B, H, Hkv, Sq, Sk, hd, causal, dtype, tol)


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,Hkv,Sq,Sk,hd,causal", [
    (2, 16, 8, 4096, 4096, 128, True),  # qwen3_1p7b's training shape
    (1, 32, 32, 4096, 4096, 64, True)])  # zamba2_1p2b's shared attention
def test_flash_attention_bf16_training_shapes_match_plain_on_card(
        B, H, Hkv, Sq, Sk, hd, causal):
    _need_card()
    _check_flash_on_card(B, H, Hkv, Sq, Sk, hd, causal, torch.bfloat16, 2e-2)


def _check_flash_on_card(B, H, Hkv, Sq, Sk, hd, causal, dtype, tol):
    q, k, v, do = (x.to(dtype) for x in to_torch(
        *flash_case(Sq + hd, B, H, Hkv, Sq, Sk, hd), device="cuda"))
    want = _grads(lambda *a: tfa.flash_attention_ref(*a, causal=causal),
                  q, k, v, do)
    got = _grads(lambda *a: _kernel_bhsd(*a, causal), q, k, v, do)
    torch.cuda.synchronize()
    d = (got[0].float() - want[0].float()).abs()
    assert d.max().item() <= tol
    if dtype == torch.bfloat16:
        assert bool((d <= 1e-3 + 1e-2 * want[0].float().abs()).all())
    for name, g, w in zip(("dq", "dk", "dv"), got[1:], want[1:]):
        assert g.dtype == dtype and g.shape == w.shape
        assert _scaled_err(g, w) <= tol, name


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_backward_is_deterministic_on_card(dtype):
    _need_card()
    q, k, v, do = (x.to(dtype).transpose(1, 2).contiguous()
                   for x in to_torch(*flash_case(5, 2, 16, 8, 1024, 1024,
                                                 128), device="cuda"))
    o, lse = tfa.flash_attention_fwd(q, k, v, True)
    first = tfa.flash_attention_bwd(q, k, v, o, lse, do, True)
    second = tfa.flash_attention_bwd(q, k, v, o, lse, do, True)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("R,D", [(256, 512), (100, 64), (8192, 2048),
                                 (8192 * 16, 128), (4, 2048), (64, 128)])
def test_rmsnorm_fwd_bwd_match_plain_on_card(R, D, dtype, tol):
    _need_card()
    x, w, dy = to_torch(*rms_case(R + D, R, D), device="cuda")
    x, dy = x.to(dtype), dy.to(dtype)

    def run(fn):
        xx = x.detach().requires_grad_(True)
        ww = w.detach().requires_grad_(True)
        y = fn(xx, ww)
        return (y, *torch.autograd.grad(y, (xx, ww), dy))
    want = run(trn.rmsnorm_ref)
    got = run(trn.rmsnorm)
    torch.cuda.synchronize()
    assert (got[0].float() - want[0].float()).abs().max().item() <= tol
    assert got[1].dtype == dtype and got[2].dtype == torch.float32
    assert _scaled_err(got[1], want[1]) <= tol
    assert _scaled_err(got[2], want[2]) <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("R,D,offset", [
    (512, 4096, 0),                     # wide rows: 2 or 4 warps a row
    (300, 2050, 0),                     # D not a multiple of the vector
    (257, 100, 0),                      # float32 vectors, bf16 scalar
    (256, 2048, 1),                     # rows off a 16-byte boundary
    (1000, 128, 1)])
def test_rmsnorm_fwd_vector_and_scalar_paths_match_plain_on_card(
        R, D, offset, dtype, tol):
    """The forward's vector and scalar paths: y within the tolerance of
    the plain version and rstd = rsqrt(mean(x^2) + eps) within 1e-5
    relative, also for x taken ``offset`` elements into a flat buffer."""
    _need_card()
    x, w, _ = to_torch(*rms_case(R * D + offset, R, D), device="cuda")
    x = x.to(dtype)
    if offset:
        flat = torch.empty(R * D + offset, dtype=dtype, device="cuda")
        flat[offset:] = x.reshape(-1)
        x = flat[offset:].view(R, D)
        assert x.is_contiguous() and x.data_ptr() % 16
    y, rstd = trn.rmsnorm_fwd(x, w)
    want = trn.rmsnorm_ref(x, w)
    want_rstd = torch.rsqrt(x.float().square().mean(-1) + trn.EPS)
    torch.cuda.synchronize()
    assert y.dtype == dtype and rstd.dtype == torch.float32
    assert (y.float() - want.float()).abs().max().item() <= tol
    assert ((rstd - want_rstd).abs() / want_rstd).max().item() <= 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("R,D,offset", [
    (512, 4096, 0),                     # wide rows: 2 or 4 warps a row
    (300, 2050, 0),                     # D not a multiple of the vector
    (257, 100, 0),                      # float32 vectors, bf16 scalar
    (256, 2048, 1),                     # rows off a 16-byte boundary
    (1000, 128, 1)])
def test_rmsnorm_bwd_vector_and_scalar_paths_match_plain_on_card(
        R, D, offset, dtype, tol):
    """The backward's vector and scalar paths, at the forward test's
    shapes and offsets: dx and dw within the tolerance of the plain
    version's autograd, times each one's largest magnitude, also for x
    and dy taken ``offset`` elements into flat buffers."""
    _need_card()
    x, w, dy = to_torch(*rms_case(R * D + offset + 1, R, D), device="cuda")
    x, dy = x.to(dtype), dy.to(dtype)
    if offset:
        def shifted(t):
            flat = torch.empty(R * D + offset, dtype=dtype, device="cuda")
            flat[offset:] = t.reshape(-1)
            return flat[offset:].view(R, D)
        x, dy = shifted(x), shifted(dy)
        assert x.is_contiguous() and x.data_ptr() % 16
    _, rstd = trn.rmsnorm_fwd(x, w)
    dx, dw = trn.rmsnorm_bwd(x, w, rstd, dy)
    xx = x.detach().requires_grad_(True)
    ww = w.detach().requires_grad_(True)
    want = torch.autograd.grad(trn.rmsnorm_ref(xx, ww), (xx, ww), dy)
    torch.cuda.synchronize()
    assert dx.dtype == dtype and dw.dtype == torch.float32
    assert _scaled_err(dx, want[0]) <= tol
    assert _scaled_err(dw, want[1]) <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("R,D", [(8192 * 16, 128), (8192, 2048)])
def test_rmsnorm_backward_is_deterministic_on_card(R, D, dtype):
    _need_card()
    x, w, dy = to_torch(*rms_case(6, R, D), device="cuda")
    x, dy = x.to(dtype), dy.to(dtype)
    _, rstd = trn.rmsnorm_fwd(x, w)
    first = trn.rmsnorm_bwd(x, w, rstd, dy)
    second = trn.rmsnorm_bwd(x, w, rstd, dy)
    torch.cuda.synchronize()
    assert torch.equal(first[0], second[0])
    assert torch.equal(first[1], second[1])


@pytest.mark.gpu
@pytest.mark.parametrize("order", ["dbx", "dxb"])
@pytest.mark.parametrize("B,S,R,ds,page_size,pages,lengths,n_new", [
    *((2, S, 8, 4, 4, 3, L, N) for S, L, N in SSM_CASES),
    (4, 1, 8192, 16, 16, 4, [31, 16, 5, 0], [1, 1, 0, 1]),    # falcon rows
    (4, 40, 4096, 64, 16, 4, [0, 9, 16, 3], [40, 17, 0, 33])])  # zamba2
def test_paged_ssm_update_matches_plain_on_card(
        B, S, R, ds, page_size, pages, lengths, n_new, order):
    _need_card()
    dt, x, Bm, Cm, A, pool, table, lens, nn = to_torch(*ssm_case(
        R + S, B, S, R, ds, pages, lengths, n_new), device="cuda")
    if order == "dxb":            # mamba2: one decay per row, stride 0
        A = A[:, :1].expand(R, ds)
    plan = ssm_plan(table, lens, nn, page_size, S)
    pools = [pool.clone() for _ in range(3)]
    ptr = pools[1].data_ptr()

    def run(fn, p):
        return fn(dt, x, Bm, Cm, A, p, *plan, nn, order=order)
    want = run(tps.paged_ssm_update_ref, pools[0])
    got = run(tps.paged_ssm_update, pools[1])
    again = run(tps.paged_ssm_update, pools[2])
    torch.cuda.synchronize()
    assert pools[1].data_ptr() == ptr
    valid = (torch.arange(S, device="cuda")[None, :]
             < nn[:, None])[..., None]
    assert _scaled_err(got * valid, want * valid) <= 1e-5
    assert _scaled_err(pools[1][1:], pools[0][1:]) <= 1e-5
    planned = set(plan[2].reshape(-1).tolist()) | {0}
    for page in range(pool.shape[0]):
        if page not in planned:
            assert torch.equal(pools[1][page], pool[page]), page
    assert torch.equal(got, again) and torch.equal(pools[1], pools[2])


@pytest.mark.gpu
def test_mamba2_fused_updates_pool_view_in_place_on_card():
    """The mixer hands the kernel a (n_pages, R, ds) *view* of the
    (n_pages, nh, headdim, ds) pool: the update lands in the pool, and
    matches the gathered plain scan."""
    _need_card()
    from repro_torch.configs.reduce import reduce_config
    from repro_torch.configs.registry import get_config
    from repro_torch.models import transformer
    rcfg = reduce_config(get_config("zamba2_1p2b", "decode_32k"))
    cfg = dataclasses.replace(rcfg.model, dtype="float32")
    params = transformer.init_model(rcfg, seed=3, device="cuda")
    mixer = {k: v[0] for k, v in params["backbone"]["mixer"].items()}
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((2, 5, cfg.d_model)).astype(
        np.float32)).cuda()
    table = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32, device="cuda")
    kw = dict(page_table=table, lengths=torch.tensor([3, 0], device="cuda"),
              n_new=torch.tensor([5, 2], device="cuda"), page_size=4)
    pools = [tssm.init_paged_ssm_pool(cfg, 1, 5, 2, device="cuda")
             for _ in range(2)]
    pools[0]["h"].normal_()
    pools[1]["h"].copy_(pools[0]["h"])
    ptr = pools[0]["h"].data_ptr()
    before = pools[0]["h"].clone()
    got = tssm.mamba2_paged_apply(mixer, x, cfg, conv_pool=pools[0]["conv"][0],
                                  h_pool=pools[0]["h"][0], fused=True, **kw)
    want = tssm.mamba2_paged_apply(mixer, x, cfg,
                                   conv_pool=pools[1]["conv"][0],
                                   h_pool=pools[1]["h"][0], fused=False, **kw)
    torch.cuda.synchronize()
    assert pools[0]["h"].data_ptr() == ptr
    assert not torch.equal(pools[0]["h"][0, 1:], before[0, 1:])
    assert _scaled_err(got, want) <= 1e-5
    assert _scaled_err(pools[0]["h"][0, 1:], pools[1]["h"][0, 1:]) <= 1e-5


# (Bb, S, di, ds, broadcast A, A scale): ragged chunk tails, a partial
# block of rows, every d_state the kernel is built for, mamba2's stride-0
# decay, falcon-mamba-7b's and zamba2-1.2b's full-width rows, at S = 1,
# one step short of a chunk (63) and the training length 4096, and decays
# 200x larger, whose products over a chunk underflow to 0
SCAN_CASES = [(2, 100, 64, 8, False, 1.0), (1, 130, 96, 16, False, 1.0),
              (2, 64, 128, 4, False, 1.0), (1, 70, 64, 32, False, 1.0),
              (1, 200, 256, 64, True, 1.0), (2, 1000, 8192, 16, False, 1.0),
              (1, 1000, 4096, 64, True, 1.0), (2, 1, 8192, 16, False, 1.0),
              (2, 63, 8192, 16, False, 1.0),
              (2, 4096, 8192, 16, False, 1.0),
              (2, 300, 1024, 16, False, 200.0),
              (1, 300, 1024, 64, True, 200.0)]


@pytest.mark.gpu
@pytest.mark.parametrize("Bb,S,di,ds,broadcast_A,a_scale", SCAN_CASES)
def test_ssm_scan_fwd_bwd_match_plain_on_card(Bb, S, di, ds, broadcast_A,
                                              a_scale):
    _need_card()
    *ins, gy = to_torch(*ssm_scan_case(S + di + ds, Bb, S, di, ds),
                        device="cuda")
    ins[2] = ins[2] * a_scale
    if broadcast_A:                 # mamba2: one decay per row, stride 0
        ins[2] = ins[2][:, :1].expand(di, ds)

    def run(fn):
        args = [t.detach().requires_grad_(True) for t in ins]
        y = fn(*args)
        return (y, *torch.autograd.grad(y, args, gy))
    want = run(tss.ssm_scan_ref)
    got = run(tss.ssm_scan)
    torch.cuda.synchronize()
    assert _scaled_err(got[0], want[0]) <= 1e-5
    for name, g, w in zip(("dt", "x", "A", "B", "C", "D"), got[1:],
                          want[1:]):
        assert g.shape == w.shape, name
        assert _scaled_err(g, w) <= 1e-4, name


@pytest.mark.gpu
@pytest.mark.parametrize("di,ds,broadcast_A", [(8192, 16, False),
                                               (4096, 64, False),
                                               (4096, 64, True)])
def test_ssm_scan_backward_is_deterministic_on_card(di, ds, broadcast_A):
    """A second backward is bit-identical (fixed-order sums, no
    atomics), also with mamba2's stride-0 decay."""
    _need_card()
    *ins, gy = to_torch(*ssm_scan_case(di + ds, 2, 300, di, ds),
                        device="cuda")
    if broadcast_A:
        ins[2] = ins[2][:, :1].expand(di, ds)
    _, hc = tss.ssm_scan_fwd(*ins)
    first = tss.ssm_scan_bwd(*ins, hc, gy)
    second = tss.ssm_scan_bwd(*ins, hc, gy)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)
