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
order, no atomics). Sampling: survivors bit-equal; the kernel sums the
nucleus mass in 64-bit fixed point, the plain version in float32, so
tokens whose cumulative mass lies within rounding of p may flip — their
total probability per row must stay below 1e-5 (the two masks' sampling
distributions are that close in total variation); tau_k is bit-equal:
every survivor lies in the plain version's top-k set, and at p = 1 every
top-k value within 20 nats of the row max survives (the kernel drops
only values ~28 nats below, whose fixed-point weight is 0; the plain
version drops the tail its float32 total cannot hold, so the two masks
need not be equal whole there); a second launch is bit-identical
(integer sums, no float atomics). Paged SSM update: y on valid rows and
the non-scratch
pool pages within 1e-5 of the plain version's largest magnitude (nvcc
contracts multiply-adds into FMAs and sums in another order, over up to
S sequential steps); pages outside the write plan bit-equal;
the pool updated in place; a second launch bit-identical; a call split
in two bit-identical to one call (chunked prefill == serial, the port's
bitwise contract). Selective scan: y and the forward's stored states
within 1e-5 and each of the six cotangents within 1e-4 of the plain
version's largest magnitude (FMAs, the backward's exp2, and float32 sums
over up to 8192 rows and S steps in another order); a second forward and
a second backward bit-identical. The input builders are shared with
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
from repro_torch.models import moe as tmoe
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


SAMPLING_KINDS = ("normal", "ties", "equal", "zeros", "scaled", "peaked")
P1_KEEP_NATS = 20.0        # at p = 1 the kernel keeps the top-k set this
                           # close to the row max (its cut is ~28 nats)
_EDGE_KS = (0, 40, 1, 0, None, "V+7", -3, 64, 300, 5, 2, 1000)
_EDGE_PS = (1.0, 0.95, 0.5, 0.9, 1.0, 1e-6, 0.95, 1.0, 0.5, 1.0, 1e-6, 0.95)


def sampling_edge_case(seed, kind, B, V):
    """(B, V) float32 logits of one kind — "normal" (N(0, 2²)), "ties"
    (those rounded to steps of 0.5), "equal" (one value), "zeros" (30%
    +0.0, 30% -0.0, 2% positive, the rest negative), "scaled" (normal x
    1e6, what a greedy slot's temperature clamp passes), "peaked" (normal
    x 10: a top 40 spans 15-25 nats, as real LM logits can) — and per-row
    k and p cycling over k in {0, 40, 1, V, V+7, -3, 64, 300, 5, 2, 1000}
    and p in {1e-6, 0.5, 0.9, 0.95, 1.0}, shifted each cycle so B = 64
    meets most pairs. The first four rows are the smoke's mix: k
    0/40/1/0, p 1.0/0.95/0.5/0.9."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((B, V)) * 2.0).astype(np.float32)
    if kind == "ties":
        x = (np.round(x * 2) / 2).astype(np.float32)
    elif kind == "equal":
        x = np.full((B, V), 0.7, np.float32)
    elif kind == "zeros":
        r = rng.random((B, V))
        x = np.where(r < 0.3, np.float32(0.0), np.where(
            r < 0.6, np.float32(-0.0), np.where(r < 0.62, np.abs(x),
                                                -np.abs(x))))
        x = x.astype(np.float32)
    elif kind == "scaled":
        x = (x * np.float32(1e6)).astype(np.float32)
    elif kind == "peaked":
        x = (x * np.float32(10.0)).astype(np.float32)
    n = len(_EDGE_KS)
    ks = [V if k is None else V + 7 if k == "V+7" else k for k in _EDGE_KS]
    top_ks = np.asarray([ks[r % n] for r in range(B)], np.int32)
    top_ps = np.asarray([_EDGE_PS[(r + r // n) % n] for r in range(B)],
                        np.float32)
    return x, top_ks, top_ps


def top_k_set(logits, top_ks):
    """The plain version's top-k set, ``u >= tau_k`` (ties kept), as a
    (B, V) bool tensor."""
    V = logits.shape[-1]
    u = tsp._sortable_u32(logits)
    ks = top_ks.long()
    k_eff = torch.where(ks <= 0, torch.full_like(ks, V), ks).clamp(1, V)
    return u >= tsp._search_kth(u, k_eff)[:, None]


def check_top_k_set(logits, top_ks, top_ps, keep):
    """tau_k bit for bit: the survivors ``keep`` lie in the plain top-k
    set, and rows at p = 1 keep every value of it within P1_KEEP_NATS of
    the row max. Returns an error message, or None."""
    top_k = top_k_set(logits, top_ks)
    if (keep & ~top_k).any():
        return "a survivor lies outside the plain version's top-k set"
    near = top_k & (logits.float() >= logits.float().max(-1, keepdim=True)
                    .values - P1_KEEP_NATS)
    p1 = top_ps == 1.0
    if not torch.equal(keep[p1] | near[p1], keep[p1]):
        return (f"a row at p = 1 dropped a top-k value within "
                f"{P1_KEEP_NATS:g} nats of its max")
    return None


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
    (2, 4, 48, 1, 128, 16, 8),          # MQA verify: 192 multi-row rows
    (4, 1, 64, 4, 128, 16, 8),          # qwen3-moe decode: g = 16, split
    (4, 5, 64, 4, 128, 16, 8),          # qwen3-moe verify: 80 rows
    (4, 1, 48, 8, 128, 16, 8),          # grok-1 decode: g = 6
    (4, 5, 48, 8, 128, 16, 8)])         # grok-1 verify: 30 rows, split
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
@pytest.mark.parametrize("dtype,tol,lse_tol", [(torch.float32, 2e-5, 1e-4),
                                               (torch.bfloat16, 2e-2, 1e-3)])
@pytest.mark.parametrize("S", [1, 256])
def test_paged_lse_route_matches_plain_on_card(S, dtype, tol, lse_tol):
    """The lse route over one page of 128 rows a slot (a rank's slice of
    the dense cache) at local lengths before, inside and past it: out
    within ``tol`` and lse within ``lse_tol`` of the plain version where
    a row sees a key; out 0 and lse -inf (the plain version's -1e30)
    where it sees none; the plain route's out bit for bit."""
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(S)
    lens = torch.tensor([-300, -1, 0, 63, 127, 500], dtype=torch.int32,
                        device="cuda")
    B, L, H, Hkv, hd = len(lens), 128, 16, 8, 128

    def r(*shape):
        return (torch.randn(shape, generator=g, device="cuda") * 0.5
                ).to(dtype)
    q, pk, pv = r(B, S, H, hd), r(B, L, Hkv, hd), r(B, L, Hkv, hd)
    table = torch.arange(B, dtype=torch.int32, device="cuda")[:, None]
    out, lse = tpa.paged_flash_attention_lse(q, pk, pv, table, lens)
    plain = tpa.paged_flash_attention(q, pk, pv, table, lens)
    want, want_lse = tpa.paged_attention_lse_ref(q, pk, pv, table, lens)
    torch.cuda.synchronize()
    seen = (lens[:, None] + torch.arange(S, device="cuda") >= 0)[
        ..., None].expand(B, S, H)
    assert torch.equal(out, plain)
    assert (out.float() - want.float()).abs().amax(-1)[seen].max() <= tol
    assert (lse - want_lse).abs()[seen].max() <= lse_tol
    assert bool((out[~seen] == 0).all())
    assert bool((lse[~seen] == -float("inf")).all())
    assert bool((want_lse[~seen] <= -1e29).all())


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


def _check_sampling_on_card(logits, top_ks, top_ps):
    """Survivors bit-equal, flipped mass <= SAMPLING_TV, tau_k bit for bit
    (``check_top_k_set``), a second launch bit-identical."""
    want = tsp.topk_topp_mask_ref(logits, top_ks, top_ps)
    got = tsp.topk_topp_mask(logits, top_ks, top_ps)
    again = tsp.topk_topp_mask(logits, top_ks, top_ps)
    torch.cuda.synchronize()
    keep_w, keep_g = want > -1e30, got > -1e30
    assert torch.equal(got[keep_w & keep_g], want[keep_w & keep_g])
    assert flipped_mass(logits, keep_w, keep_g) <= SAMPLING_TV
    assert check_top_k_set(logits, top_ks, top_ps, keep_g) is None
    assert torch.equal(got, again)


@pytest.mark.gpu
def test_topk_topp_mask_matches_plain_on_card():
    _need_card()
    _check_sampling_on_card(*to_torch(*sampling_case(12, B=8, V=151936),
                                      device="cuda"))


@pytest.mark.gpu
@pytest.mark.parametrize("B", [1, 4, 64])
@pytest.mark.parametrize("V", [151936, 65024, 32000, 256206, 131072])
@pytest.mark.parametrize("kind", SAMPLING_KINDS)
def test_topk_topp_mask_edge_cases_on_card(kind, V, B):
    """The served vocabs (qwen3_1p7b's 151936, falcon_mamba_7b's 65024,
    zamba2_1p2b's 32000) and seamless_m4t_v2's 256206 (the widest; the
    scalar-load path) at B 1 / 4 / 64 (64: clusters in waves) over ties,
    one value, +-0.0, 1e6-scaled and peaked logits and k, p at their
    edges (``sampling_edge_case``)."""
    _need_card()
    _check_sampling_on_card(*to_torch(*sampling_edge_case(
        V + B, kind, B, V), device="cuda"))


@pytest.mark.gpu
def test_topk_topp_mask_unaligned_rows_and_widest_row_on_card():
    """At B = 4, aligned rows and logits 4 bytes off 16-byte alignment
    (the scalar loads) agree the same way; a row wider than
    ``max_vocab()`` raises, naming V and the limit, and launches
    nothing."""
    _need_card()
    x, ks, ps = to_torch(*sampling_edge_case(3, "ties", 4, 151936),
                         device="cuda")
    flat = torch.empty(x.numel() + 1, device="cuda")
    flat[1:] = x.reshape(-1)
    for logits in (x, flat[1:].view(x.shape)):
        want = tsp.topk_topp_mask_ref(logits, ks, ps)
        got = tsp.topk_topp_mask(logits, ks, ps)
        keep_w, keep_g = want > -1e30, got > -1e30
        assert torch.equal(got[keep_w & keep_g], want[keep_w & keep_g])
        assert flipped_mass(logits, keep_w, keep_g) <= SAMPLING_TV
        assert torch.equal(got, tsp.topk_topp_mask(logits, ks, ps))
    V = tsp.max_vocab() + 4
    before = tsp.topk_topp_mask.launches
    with pytest.raises(ValueError,
                       match=rf"V={V} does not fit .*at most {V - 4}\)"):
        tsp.topk_topp_mask(torch.zeros((1, V), device="cuda"), ks[:1],
                           ps[:1])
    assert tsp.topk_topp_mask.launches == before


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
    (2, 16, 8, 1024, 1024, 128, True),  # qwen3_1p7b widths
    (2, 64, 4, 512, 512, 128, True),    # qwen3-moe: g = 16
    (2, 48, 8, 512, 512, 128, True)])   # grok-1: g = 6
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


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("B,H,Hkv,Sq,Sk,hd", [
    (32, 12, 12, 224, 224, 64),         # bert128
    (64, 12, 12, 197, 197, 64),         # vit32: 193 tokens + 4 patches
    (32, 8, 8, 274, 274, 64),           # mt_marian self-attention
    (32, 8, 8, 274, 190, 64),           # mt_marian cross-attention
    (8, 1, 1, 2048, 2048, 128)])        # mc_tiny
def test_flash_attention_paper_shapes_match_plain_on_card(
        B, H, Hkv, Sq, Sk, hd, dtype, tol):
    """The paper's encoder and encoder-decoder attention: non-causal,
    ragged last tiles, B > 1 (TMA's zero fill at each batch's edge);
    a second backward bit-identical."""
    _need_card()
    _check_flash_on_card(B, H, Hkv, Sq, Sk, hd, False, dtype, tol)
    q, k, v, do = (x.to(dtype).transpose(1, 2).contiguous()
                   for x in to_torch(*flash_case(Sq + 1, B, H, Hkv, Sq, Sk,
                                                 hd), device="cuda"))
    o, lse = tfa.flash_attention_fwd(q, k, v, False)
    first = tfa.flash_attention_bwd(q, k, v, o, lse, do, False)
    second = tfa.flash_attention_bwd(q, k, v, o, lse, do, False)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


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
                                 (8192 * 16, 128), (4, 2048), (64, 128),
                                 (1024, 6144), (4, 6144)])
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
@pytest.mark.parametrize("dtype,tol", [(np.float32, 2e-5),
                                       ("bfloat16", 2e-2)])
@pytest.mark.parametrize("S,H,Hkv,hd", [(2, 16, 8, 128), (5, 16, 8, 128),
                                        (3, 32, 32, 64), (5, 32, 32, 64)])
def test_paged_flash_attention_at_verify_widths_matches_plain_on_card(
        S, H, Hkv, hd, dtype, tol):
    """Speculative decoding's verify and draft-ingest windows (S = k+1 at
    k = 4, and shorter) at qwen3_1p7b's and zamba2_1p2b's heads: within
    the tolerance of the plain version, the live-page table and a second
    launch bit-identical to a wider table."""
    _need_card()
    q, pk, pv, table, lengths = to_torch(*attn_case(
        7 * S + H, 4, S, H, Hkv, hd, 16, 8), device="cuda")
    if dtype == "bfloat16":
        q, pk, pv = (t.to(torch.bfloat16) for t in (q, pk, pv))
    lengths = torch.tensor([95, 16, 0, 31], dtype=torch.int32,
                           device="cuda")
    want = tpa.paged_attention_ref(q, pk, pv, table, lengths).float()
    got = tpa.paged_flash_attention(q, pk, pv, table[:, :7], lengths)
    wide = tpa.paged_flash_attention(q, pk, pv, table, lengths)
    again = tpa.paged_flash_attention(q, pk, pv, table[:, :7], lengths)
    torch.cuda.synchronize()
    assert (got.float() - want).abs().max().item() <= tol
    assert torch.equal(got, wide) and torch.equal(got, again)


@pytest.mark.gpu
@pytest.mark.parametrize("order,R,ds", [("dbx", 8192, 16), ("dxb", 4096, 64)])
def test_every_step_plan_matches_plain_on_card(order, R, ds):
    """The verify recurrence (``models.ssm.every_step_update``: the
    kernel with a write plan storing every local step into a scratch
    buffer) at S = 5 against the same call on the plain version: y on
    valid rows and every step's state within 1e-5 of max|plain|, the pool
    untouched, a second launch bit-identical; and the state after each
    step bit-identical to one-step decode calls on the pool."""
    _need_card()
    S, lengths, n_new = 5, [16, 31, 0, 7], [5, 3, 5, 0]
    dt, x, Bm, Cm, A, pool, table, lens, nn = to_torch(*ssm_case(
        R + 5, 4, S, R, ds, 4, lengths, n_new), device="cuda")
    if order == "dxb":            # mamba2: one decay per row, stride 0
        A = A[:, :1].expand(R, ds)
    rows = (dt, x, Bm, Cm, A)
    kept = pool.clone()

    def run():
        return tssm.every_step_update(*rows, pool, table, lens, nn, 16,
                                      order=order)
    got, again = run(), run()
    from repro_torch.kernels import ops
    saved, ops.paged_ssm_update = ops.paged_ssm_update, \
        tps.paged_ssm_update_ref
    try:
        want = run()
    finally:
        ops.paged_ssm_update = saved
    torch.cuda.synchronize()
    valid = (torch.arange(S, device="cuda")[None, :] < nn[:, None])
    assert _scaled_err(got[0] * valid[..., None],
                       want[0] * valid[..., None]) <= 1e-5
    assert _scaled_err(got[1] * valid[..., None, None],
                       want[1] * valid[..., None, None]) <= 1e-5
    assert torch.equal(pool, kept)
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
    # one decode call (S = 1) from each step's predecessor state
    read_page, live = tssm.paged_read_plan(table, lens, 16)
    one = torch.ones(1, dtype=torch.int32, device="cuda")
    for b in range(4):
        for t in range(int(nn[b])):
            scratch = torch.zeros((2, R, ds), device="cuda")
            if t:
                scratch[1] = got[1][b, t - 1]
            elif live[b]:
                scratch[1] = pool[read_page[b]]
            tps.paged_ssm_update(
                *(a[b:b + 1, t:t + 1].contiguous() for a in rows[:4]), A,
                scratch, one, one if t or live[b] else 0 * one,
                one[:, None], 0 * one[:, None], one, order=order)
            assert torch.equal(scratch[1], got[1][b, t]), (b, t)


@pytest.mark.gpu
@pytest.mark.parametrize("split", [1, 7, 25, 39])
@pytest.mark.parametrize("order,R,ds", [("dbx", 8192, 16), ("dxb", 4096, 64)])
def test_paged_ssm_update_split_call_is_bitwise_one_call_on_card(
        order, R, ds, split):
    """Chunked prefill == one call, bit for bit, on the card: 40 tokens
    a slot at full-width rows (mamba2's stride-0 decay for "dxb"), page
    size 16, split in two calls at ``split`` (inside a page; the second
    call crosses a page boundary; at 1 and 39 one of the calls is a
    single step, which the launcher gives its decode kernel) give y and
    the pool bit-identical to one call; an idle slot keeps its frozen
    readout."""
    _need_card()
    S, lengths, n_new = 40, [0, 9, 16, 3], [40, 40, 0, 40]
    dt, x, Bm, Cm, A, pool, table, lens, nn = to_torch(*ssm_case(
        R + split, 4, S, R, ds, 4, lengths, n_new), device="cuda")
    if order == "dxb":
        A = A[:, :1].expand(R, ds)
    pools = [pool.clone(), pool.clone()]
    one = tps.paged_ssm_update(dt, x, Bm, Cm, A, pools[0],
                               *ssm_plan(table, lens, nn, 16, S), nn,
                               order=order)
    ys, at = [], lens
    for lo, hi in ((0, split), (split, S)):
        n = torch.clamp(nn - lo, 0, hi - lo).to(torch.int32)
        part = [t[:, lo:hi].contiguous() for t in (dt, x, Bm, Cm)]
        ys.append(tps.paged_ssm_update(
            *part, A, pools[1], *ssm_plan(table, at, n, 16, hi - lo), n,
            order=order))
        at = (at + n).to(torch.int32)
    torch.cuda.synchronize()
    assert not torch.equal(pools[0], pool)
    assert torch.equal(torch.cat(ys, dim=1), one)
    assert torch.equal(pools[1], pools[0])


@pytest.mark.gpu
@pytest.mark.parametrize("S", [1, 4])
def test_paged_ssm_update_writes_every_window_of_a_step_on_card(S):
    """A plan with two windows ending at one step (no compact plan has
    one) gets that step's state in both pages, as the plain version
    writes it; at S = 1 too (the decode kernel)."""
    _need_card()
    dt, x, Bm, Cm, A, pool, table, lens, nn = to_torch(*ssm_case(
        31 + S, 2, S, 8, 4, 3, [2, 5], [S, S]), device="cuda")
    pool = torch.cat([pool, pool[:1]])                # page 7: no table's
    rp, live, phys_w, t_w = ssm_plan(table, lens, nn, 4, S)
    phys_w = torch.cat([phys_w, torch.tensor([[7], [0]], device="cuda")], 1)
    t_w = torch.cat([t_w, torch.full((2, 1), S - 1, device="cuda")], 1)
    pools = [pool.clone(), pool.clone()]
    want = tps.paged_ssm_update_ref(dt, x, Bm, Cm, A, pools[0], rp, live,
                                    phys_w, t_w, nn, order="dbx")
    got = tps.paged_ssm_update(dt, x, Bm, Cm, A, pools[1], rp, live, phys_w,
                               t_w, nn, order="dbx")
    torch.cuda.synchronize()
    last = phys_w[0, :-1][(t_w[0, :-1] == S - 1) & (phys_w[0, :-1] != 0)]
    assert last.numel() == 1
    assert torch.equal(pools[1][7], pools[1][last[0]])
    assert _scaled_err(got, want) <= 1e-5
    assert _scaled_err(pools[1][1:], pools[0][1:]) <= 1e-5


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


@pytest.mark.gpu
@pytest.mark.parametrize("S", [1000, 4096])
@pytest.mark.parametrize("Bb,di,ds,broadcast_A", [(2, 8192, 16, False),
                                                  (1, 4096, 64, True)])
def test_ssm_scan_fwd_checkpoints_match_plain_states_on_card(
        Bb, di, ds, broadcast_A, S):
    """The forward's stored states hc (the state before every CHUNK
    steps, where the backward starts its chunks) and y within 1e-5 of
    the plain recurrence's largest magnitude, at falcon-mamba-7b's and
    zamba2-1.2b's full-width rows (stride-0 decay); a second forward
    gives the same bits."""
    _need_card()
    ins = to_torch(*ssm_scan_case(S + di, Bb, S, di, ds)[:6], device="cuda")
    if broadcast_A:
        ins[2] = ins[2][:, :1].expand(di, ds)
    want_y, want_hc = tss.ssm_scan_fwd_ref(*ins)
    y, hc = tss.ssm_scan_fwd(*ins)
    y2, hc2 = tss.ssm_scan_fwd(*ins)
    torch.cuda.synchronize()
    assert hc.shape == want_hc.shape == (Bb, -(-S // tss.CHUNK), ds, di)
    assert _scaled_err(hc, want_hc) <= 1e-5
    assert _scaled_err(y, want_y) <= 1e-5
    assert torch.equal(y, y2) and torch.equal(hc, hc2)


@pytest.mark.gpu
@pytest.mark.parametrize("di,offset", [(96, 0), (90, 0), (96, 1)])
def test_ssm_scan_fwd_vector_and_scalar_paths_match_plain_on_card(
        di, offset):
    """Rows a multiple of 4 with 16-byte aligned dt, x take the 16-byte
    copies; di = 90, or dt and x starting 4 bytes off, the 4-byte ones.
    Both give y and hc within 1e-5 of the plain version's largest
    magnitude."""
    _need_card()
    ins = to_torch(*ssm_scan_case(di + offset, 2, 150, di, 16)[:6],
                   device="cuda")
    for i in (0, 1) if offset else ():
        buf = torch.empty(ins[i].numel() + offset, device="cuda")
        ins[i] = buf[offset:].view(ins[i].shape).copy_(ins[i])
        assert ins[i].data_ptr() % 16
    want_y, want_hc = tss.ssm_scan_fwd_ref(*ins)
    y, hc = tss.ssm_scan_fwd(*ins)
    torch.cuda.synchronize()
    assert _scaled_err(y, want_y) <= 1e-5
    assert _scaled_err(hc, want_hc) <= 1e-5


# ---------------------------------------------------------------------------
# The dense decode cache's routes through the kernels
# ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("H,Hkv,hd", [(16, 8, 128), (32, 32, 64)])
@pytest.mark.parametrize("max_len", [512, 4096])
@pytest.mark.parametrize("S,where", [(1, "first"), (1, "mid"), (1, "last"),
                                     (300, "first"), (300, "mid")])
def test_paged_attention_over_dense_cache_matches_plain_on_card(
        S, where, max_len, H, Hkv, hd, dtype, tol):
    """The dense cache's attention (``models.attention._cached_core``:
    the new rows written in place into one layer of a stacked cache, then
    the paged kernel over it as one page of max_len rows a slot) against
    ``dot_attention(q_offset=index)`` over the written layer, at a decode
    step on the first, a middle (63) and the last row and a 300-token
    prefill from rows 0 and 37; rows past index + S hold 1e30; the other
    layer and rows outside the write keep their bits; a second launch is
    bit-identical."""
    _need_card()
    from repro_torch.kernels import ops
    from repro_torch.models import attention as tattn
    index = {"first": 0, "mid": 63 if S == 1 else 37,
             "last": max_len - 1}[where]
    B = 2
    g = torch.Generator(device="cuda").manual_seed(S + max_len + H)

    def r(*shape):
        return (torch.randn(shape, generator=g, device="cuda") * 0.5) \
            .to(dtype)
    ck, cv = r(2, B, max_len, Hkv, hd), r(2, B, max_len, Hkv, hd)
    ck[:, :, index + S:] = 1e30
    cv[:, :, index + S:] = 1e30
    q, kn, vn = r(B, S, H, hd), r(B, S, Hkv, hd), r(B, S, Hkv, hd)
    want_k, want_v = ck.clone(), cv.clone()
    want_k[1, :, index:index + S] = kn
    want_v[1, :, index:index + S] = vn
    idx = torch.tensor(index, dtype=torch.int32, device="cuda")
    got = tattn._cached_core(q, kn, vn, {"k": ck[1], "v": cv[1],
                                         "index": idx})
    table = torch.arange(B, dtype=torch.int32, device="cuda")[:, None]
    again = ops.paged_attention(q, ck[1], cv[1], table, idx.expand(B))
    want = tattn.dot_attention(q, ck[1], cv[1], causal=True, q_offset=idx)
    torch.cuda.synchronize()
    assert torch.equal(ck, want_k) and torch.equal(cv, want_v)
    assert (got.float() - want.float()).abs().max().item() <= tol
    assert torch.equal(got, again)


@pytest.mark.gpu
@pytest.mark.parametrize("order,R,ds", [("dbx", 8192, 16), ("dxb", 4096, 64)])
def test_ssm_decode_in_place_on_dense_state_on_card(order, R, ds):
    """The dense state's recurrence (``models.ssm._cached_scan``: the
    paged SSM decode kernel over one layer of a stacked state seen as B
    pages, slot b reading and rewriting page b in place) against the same
    plan on the plain version: y and the updated state within 1e-5 of
    max|plain|, the other layer bit-unchanged, a second run from the same
    state bit-identical."""
    _need_card()
    B = 4
    dt, x, Bm, Cm, A, pool, *_ = to_torch(*ssm_case(
        R + 3, B, 1, R, ds, 1, [0] * B, [1] * B), device="cuda")
    if order == "dxb":            # mamba2: one decay per row, stride 0
        A = A[:, :1].expand(R, ds)
    h = torch.stack([pool[1:], pool[1:] * 0.5])            # (2, B, R, ds)
    runs = [h.clone() for _ in range(3)]
    got, again = (tssm._cached_scan(dt, x, Bm, Cm, A, s[1], order=order)
                  for s in runs[:2])
    slots = torch.arange(B, device="cuda")
    want = tps.paged_ssm_update_ref(
        dt, x, Bm, Cm, A, runs[2][1], slots, torch.ones_like(slots),
        slots[:, None], torch.zeros_like(slots)[:, None],
        torch.ones_like(slots), order=order)
    torch.cuda.synchronize()
    assert _scaled_err(got, want) <= 1e-5
    assert _scaled_err(runs[0][1], runs[2][1]) <= 1e-5
    assert torch.equal(runs[0][0], h[0])
    assert torch.equal(got, again) and torch.equal(runs[0], runs[1])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("B,H,Sq,Sk", [(32, 8, 1, 274), (32, 8, 17, 274),
                                       (4, 16, 1, 256)])
def test_flash_cross_attention_at_decode_matches_plain_on_card(
        B, H, Sq, Sk, dtype, tol):
    """Encoder-decoder decoding's cross-attention: the flash forward
    non-causal at Sq = 1 and 17 new rows against mt_marian's 274 source
    keys and seamless_m4t_v2's 256 frames (hd 64), against the plain
    version (bf16 also per element to 1e-3 + 1e-2 |plain|); a second
    launch bit-identical."""
    _need_card()
    from repro_torch.kernels import ops
    q, k, v, _ = (x.to(dtype) for x in to_torch(
        *flash_case(Sq + Sk, B, H, H, Sq, Sk, 64), device="cuda"))
    qm, km, vm = (t.transpose(1, 2) for t in (q, k, v))  # model layout
    with torch.no_grad():
        got = ops.flash_attention(qm, km, vm, causal=False)
        again = ops.flash_attention(qm, km, vm, causal=False)
    want = tfa.flash_attention_ref(q, k, v, causal=False).transpose(1, 2)
    torch.cuda.synchronize()
    d = (got.float() - want.float()).abs()
    assert d.max().item() <= tol
    if dtype == torch.bfloat16:
        assert bool((d <= 1e-3 + 1e-2 * want.float().abs()).all())
    assert torch.equal(got, again)


# the MoE family at full width: (experts, top-k, d_model, expert d_ff) of
# qwen3-moe and grok-1; the index design against the literal one-hot
# version within 1e-5 (float32) / 2e-2 (bf16) of max|one-hot|, output and
# every cotangent (x, router, the three expert leaves)
MOE_WIDTHS = {"qwen3_moe_235b": (128, 8, 4096, 1536),
              "grok1_314b": (8, 2, 6144, 32768)}


def _moe_grads(fn, params, x, ct, cfg):
    leaves = [t.detach().requires_grad_(True) for t in (x, *params.values())]
    y = fn(dict(zip(params, leaves[1:])), leaves[0], cfg)
    return (y.detach(), *torch.autograd.grad(y, leaves, ct))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 2e-2)])
@pytest.mark.parametrize("B,S", [(2, 512), (4, 1)])
@pytest.mark.parametrize("arch", sorted(MOE_WIDTHS))
def test_moe_index_design_matches_onehot_on_card(arch, B, S, dtype, tol):
    """A router biased towards experts 0 and 1 (tokens dropped at 2 x
    512); the plan's slots are the one-hot dispatch's bits; a second
    forward and backward bit-identical (no atomics)."""
    _need_card()
    from repro_torch.configs.base import ModelConfig, MoEConfig
    E, K, D, ff = MOE_WIDTHS[arch]
    cfg = ModelConfig(d_model=D, dtype=dtype, param_dtype=dtype,
                      moe=MoEConfig(num_experts=E, top_k=K, d_ff=ff))
    gen = torch.Generator(device="cuda").manual_seed(B * S)
    params = tmoe.init_moe(gen, cfg, device="cuda")
    params["router"][:, :2] += 0.05
    x, ct = (torch.randn((B, S, D), generator=gen, device="cuda")
             .to(getattr(torch, dtype)) for _ in range(2))
    plan = tmoe.routing_plan(params, x, cfg)
    dispatch, _ = tmoe.onehot_dispatch(params, x, cfg)
    bits = torch.zeros(plan.n_slots + 1, dtype=torch.bool, device="cuda")
    bits[plan.slot.reshape(-1)] = True
    assert torch.equal(bits[:-1],
                       dispatch.permute(2, 0, 3, 1).any(-1).reshape(-1))
    if S > 1:
        assert plan.n_dropped() > 0
    del plan, dispatch, bits
    first = _moe_grads(tmoe.moe_apply, params, x, ct, cfg)
    again = _moe_grads(tmoe.moe_apply, params, x, ct, cfg)
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    del again
    want = _moe_grads(tmoe.moe_apply_onehot, params, x, ct, cfg)
    torch.cuda.synchronize()
    for got, w in zip(first, want):
        assert _scaled_err(got, w) <= tol
