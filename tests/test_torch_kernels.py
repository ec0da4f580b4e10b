"""The port's kernels: plain PyTorch versions vs the JAX package's Pallas
kernels (interpret mode) and jnp refs, their gradients against
``jax.vjp`` of the refs, and device dispatch. Each CUDA kernel against
its plain version on a card: ``test_torch_gpu.py``.

Inputs are made with numpy from a seed and handed to both frameworks
(the builders are shared with ``test_torch_gpu.py``). Tolerances:
attention 2e-5 (the repo's float32 tolerance,
``tests/test_kernels_paged.py``) and 1e-4 for its gradients (autograd
of the plain version vs ``jax.vjp``: dense float32 softmax backward,
summed in another order); RMSNorm 1e-5 forward and backward; the
sampling mask is exact (identical
survivor sets, survivors bit-equal) on distinct logits. The bf16
flash-attention kernels' rounding points, emulated in plain torch, are
held to the card's bf16 tolerances (out 2e-2 and 1e-3 + 1e-2 |plain| per
element, gradients 2e-2 of their max). The paged-attention decode
kernel's split-KV plan, emulated in float32, is held to the plain version
and to JAX within 2e-5, and to itself bit for bit across table widths.
The sampling kernel's radix plan (``-k radix``: per-CTA histograms,
the candidates' early exit, fixed-point masses, every tau_p route),
emulated in numpy over the kernel's 16 CTAs a row, matches the plain
version and JAX bit for bit in tau_k and the top-k survivors, and
within 1e-5 of flipped mass in the nucleus.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention_bhsd
from repro.kernels.rmsnorm import rmsnorm_2d
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.kernels import paged_attention as tpa
from repro_torch.kernels import rmsnorm as trn
from repro_torch.kernels import sampling as tsp
from repro_torch.launch.steps import apply_top_k_top_p
from repro.kernels import sampling as jsp
from test_torch_gpu import (FLASH_GRID, GRID, SAMPLING_KINDS, SAMPLING_TV,
                            attn_case, check_top_k_set, flash_case,
                            flipped_mass, rms_case, sampling_case,
                            sampling_edge_case, to_torch)

torch.set_num_threads(2)
ATTN_TOL = 2e-5


@pytest.mark.parametrize("mode", ["ref", "interpret"])
@pytest.mark.parametrize("B,S,H,Hkv,hd", GRID)
def test_paged_attention_plain_matches_jax(B, S, H, Hkv, hd, mode):
    case = attn_case(B * 100 + S, B, S, H, Hkv, hd)
    want = np.asarray(jops.paged_attention(*map(jnp.asarray, case),
                                           mode=mode))
    got = tpa.paged_attention_ref(*to_torch(*case)).numpy()
    np.testing.assert_allclose(got, want, rtol=ATTN_TOL, atol=ATTN_TOL)


def test_paged_attention_plain_ignores_garbage_beyond_length():
    """Pool rows past each slot's causal frontier carry exactly-zero
    probability mass: poisoning them with huge values moves no output
    bit, and the result still matches the JAX kernel."""
    q, pk, pv, table, lengths = attn_case(4, 2, 1, 2, 2, 16)
    clean = tpa.paged_attention_ref(*to_torch(q, pk, pv, table, lengths))
    page_size = pk.shape[1]
    rows = (table[:, :, None] * page_size
            + np.arange(page_size)).reshape(2, -1)
    dead = np.arange(rows.shape[1])[None, :] > lengths[:, None]
    pk_p = pk.reshape(-1, *pk.shape[2:]).copy()
    pv_p = pv.reshape(-1, *pv.shape[2:]).copy()
    for b in range(2):
        pk_p[rows[b][dead[b]]] = 1e30
        pv_p[rows[b][dead[b]]] = 1e30
    pk_p, pv_p = pk_p.reshape(pk.shape), pv_p.reshape(pv.shape)
    poisoned = tpa.paged_attention_ref(*to_torch(q, pk_p, pv_p, table,
                                                 lengths))
    assert torch.equal(poisoned, clean)
    want = np.asarray(jops.paged_attention(
        *map(jnp.asarray, (q, pk_p, pv_p, table, lengths)),
        mode="interpret"))
    np.testing.assert_allclose(poisoned.numpy(), want, rtol=ATTN_TOL,
                               atol=ATTN_TOL)


def test_paged_attention_plain_truncated_table_preserves_output():
    """Slicing the table to the live-page bucket (``_table_view``) is
    exact: dropping columns no slot has reached changes no bit."""
    q, pk, pv, table, lengths = to_torch(*attn_case(5, 2, 1, 2, 2, 16))
    full = tpa.paged_attention_ref(q, pk, pv, table, lengths)
    cut = tpa.paged_attention_ref(q, pk, pv, table[:, :2], lengths)
    assert torch.equal(cut, full)


def _split_kv_partials(q, pk, pv, table, lengths, split_keys):
    """float32 emulation of the split-KV decode plan of
    ``csrc/paged_attention.cu``: splits of ``split_keys`` keys at fixed
    offsets from key 0, ceil(P x page_size / split_keys) of them, keys past
    the table zero-filled; per split and row the partial (m, l, acc), a
    masked key adding p = 0, and a split that starts past the slot's last
    visible key neutral (m = -1e30, l = 0, acc = 0). Returns the partials
    in split order, each (B, Hkv, g, S[, hd])."""
    B, S, H, hd = q.shape
    ps, Hkv = pk.shape[1], pk.shape[2]
    g, P = H // Hkv, table.shape[1]
    n_split = -(-P * ps // split_keys)
    rows = (table.long()[:, :, None] * ps + torch.arange(ps)).reshape(B, -1)
    pad = (0, 0, 0, 0, 0, n_split * split_keys - P * ps)
    kd = torch.nn.functional.pad(pk.reshape(-1, Hkv, hd)[rows].float(), pad)
    vd = torch.nn.functional.pad(pv.reshape(-1, Hkv, hd)[rows].float(), pad)
    qs = q.float().reshape(B, S, Hkv, g, hd) * hd ** -0.5
    qpos = lengths.long()[:, None] + torch.arange(S)
    n_keys = torch.clamp(lengths.long() + S, max=P * ps)
    parts = []
    for k0 in range(0, n_split * split_keys, split_keys):
        kpos = k0 + torch.arange(split_keys)
        ks = kd[:, k0:k0 + split_keys].contiguous()
        vs = vd[:, k0:k0 + split_keys].contiguous()
        sc = torch.einsum("bqhgd,bkhd->bhgqk", qs, ks)
        vis = ((kpos <= qpos[:, :, None])
               & (kpos < n_keys[:, None, None]))[:, None, None]
        m = torch.where(vis, sc, tpa.NEG_INF).amax(-1)
        p = torch.where(vis, torch.exp(sc - m[..., None]), 0.0)
        acc = torch.einsum("bhgqk,bkhd->bhgqd", p, vs)
        dead = (k0 >= n_keys)[:, None, None, None]
        parts.append((torch.where(dead, tpa.NEG_INF, m),
                      torch.where(dead, 0.0, p.sum(-1)),
                      torch.where(dead[..., None], 0.0, acc)))
    return parts


def _split_kv_combine(parts):
    """The combine kernel's merge, in split order: out = acc / max(l,
    1e-30) in model layout (B, S, H, hd)."""
    m = torch.stack([pm for pm, _, _ in parts]).amax(0)
    l, acc = torch.zeros_like(m), torch.zeros_like(parts[0][2])
    for pm, pl, pa in parts:
        c = torch.exp(pm - m)
        l = l + pl * c
        acc = acc + pa * c[..., None]
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    B, Hkv, g, S, hd = out.shape
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, Hkv * g, hd)


@pytest.mark.parametrize("split_keys", [4, 64])
@pytest.mark.parametrize("B,S,H,Hkv,hd", GRID)
def test_paged_split_kv_plan_matches_plain_and_jax(B, S, H, Hkv, hd,
                                                    split_keys):
    """The decode kernel's split-KV plan, emulated in float32 (4 keys a
    split: several splits a slot; 64: one split, past the table
    zero-filled), is the plain version's function within 2e-5, and JAX's
    Pallas kernel's (interpret mode)."""
    case = attn_case(B * 100 + S, B, S, H, Hkv, hd)
    got = _split_kv_combine(_split_kv_partials(*to_torch(*case),
                                               split_keys))
    want = tpa.paged_attention_ref(*to_torch(*case))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=ATTN_TOL,
                               atol=ATTN_TOL)
    jax_out = np.asarray(jops.paged_attention(*map(jnp.asarray, case),
                                              mode="interpret"))
    np.testing.assert_allclose(got.numpy(), jax_out, rtol=ATTN_TOL,
                               atol=ATTN_TOL)


def test_paged_split_kv_plan_is_bitwise_independent_of_table_width():
    """Split boundaries do not depend on P and a neutral partial adds
    exactly +0: the emulated plan gives the same bits for the live-page
    table and wider ones, and a neutral split, at the end (where a wider
    table puts them) or between live ones, moves no bit."""
    q, pk, pv, table, lengths = to_torch(*attn_case(13, 3, 2, 4, 2, 16,
                                                    page_size=4,
                                                    pages_per_slot=6))
    parts = _split_kv_partials(q, pk, pv, table, lengths, 4)
    full = _split_kv_combine(parts)
    live = -(-int((lengths + 2).max()) // 4)
    for P in range(live, table.shape[1]):
        cut = _split_kv_combine(_split_kv_partials(q, pk, pv, table[:, :P],
                                                   lengths, 4))
        assert torch.equal(cut, full)
    m, l, acc = parts[0]
    neutral = (torch.full_like(m, tpa.NEG_INF), torch.zeros_like(l),
               torch.zeros_like(acc))
    assert torch.equal(_split_kv_combine(parts + [neutral]), full)
    assert torch.equal(_split_kv_combine(parts[:1] + [neutral] + parts[1:]),
                       full)
    np.testing.assert_allclose(
        full.numpy(), tpa.paged_attention_ref(q, pk, pv, table,
                                              lengths).numpy(),
        rtol=ATTN_TOL, atol=ATTN_TOL)


@pytest.mark.parametrize("seed", [9, 10, 11])
def test_topk_topp_mask_plain_matches_jax_interpret(seed):
    logits, top_ks, top_ps = sampling_case(seed, B=8)
    want = np.asarray(jops.topk_topp_mask(
        *map(jnp.asarray, (logits, top_ks, top_ps)), mode="interpret"))
    got = tsp.topk_topp_mask_ref(*to_torch(logits, top_ks, top_ps)).numpy()
    np.testing.assert_array_equal(got, want)


def test_topk_topp_mask_plain_matches_sort_based_masking():
    """The port's own contract, as in the reference: the threshold mask
    equals the sort-based ``apply_top_k_top_p`` bit for bit."""
    logits, top_ks, top_ps = to_torch(*sampling_case(8, B=8))
    assert torch.equal(tsp.topk_topp_mask_ref(logits, top_ks, top_ps),
                       apply_top_k_top_p(logits, top_ks, top_ps))


RADIX_CAND = 255           # candidates a CTA takes pairwise (kCand)
_FIX = 2.0 ** 40           # e's fixed-point scale
_U64_MAX = 2 ** 64 - 1


def _radix_u(x):
    """The sortable encoding as uint64 (numpy)."""
    b = x.astype(np.float32).view(np.uint32).astype(np.uint64)
    return np.where(b >> 31 != 0, b ^ 0xFFFFFFFF, b ^ 0x80000000)


def _radix_x(u):
    b = np.where(u >> 31 != 0, u ^ 0x80000000, u ^ 0xFFFFFFFF)
    return b.astype(np.uint32).view(np.float32)


def _radix_bins(u, w, parts, shift, prefix):
    """256 bins of digit (u >> shift) & 255, weights w, over the values
    whose higher digits equal ``prefix`` (all of them for the top digit):
    one histogram a part (a CTA's slice), summed as the exchange does.
    Returns the total bins, their suffix sums (suf[256] = 0) and each
    part's bins, as Python ints."""
    per = []
    for s in parts:
        us, ws = u[s], w[s]
        sel = (np.ones(us.shape, bool) if shift == 24
               else (us >> (shift + 8)) == prefix)
        h = np.zeros(256, np.uint64)
        np.add.at(h, ((us[sel] >> shift) & 255).astype(np.int64), ws[sel])
        per.append([int(v) for v in h])
    tot = [sum(h[d] for h in per) for d in range(256)]
    suf = [0] * 257
    for d in range(255, -1, -1):
        suf[d] = suf[d + 1] + tot[d]
    return tot, suf, per


def _radix_target(p, z):
    """The kernel's integer bound for mass < p * z."""
    if not p > 0:
        return 0
    if p == 1:
        return z
    if p > 1:
        return _U64_MAX
    return int(np.ceil(float(p) * float(z)))


def _radix_mass_select(u, w, parts, p):
    """tau_p by radix select on mass: the least digit whose strictly-
    greater mass (above the prefix, plus the bins above it) is < p_z."""
    above, prefix, bound = 0, 0, 0
    for shift in (24, 16, 8, 0):
        _, suf, _ = _radix_bins(u, w, parts, shift, prefix)
        if shift == 24:
            bound = _radix_target(p, suf[0])
        cnt = sum(above + s < bound for s in suf[1:])
        if cnt == 0:
            return 0xFFFFFFFF
        d = 256 - cnt
        above += suf[d + 1]
        prefix = (prefix << 8) | d
    return prefix


def _radix_row(x, k, p, cluster=16):
    """One row through ``csrc/sampling.cu``'s plan: CTA slices of
    ceil(V / cluster) rounded up to 4. tau_k by radix select on counts
    (8-bit digits from the top; the row min when k is off or >= V), each
    digit from the cluster's bins, until the values from the chosen
    bucket up number at most RADIX_CAND: then each CTA mails its
    candidates (its place counted from the per-CTA bins) and tau_k is the
    candidate with fewer than k above it and at least k from it up. m is
    the row max; e enters as round(e x 2^40). tau_p, the least threshold
    whose strictly-greater mass is < p_z: over mailed candidates,
    pairwise ("direct": each survivor's u, and 0, is a threshold); else,
    at p = 1, the least u of positive weight ("p1"); else by radix select
    on mass over the cluster ("cluster"). Returns (masked row, tau_k,
    route)."""
    V = x.size
    u = _radix_u(x)
    S = -(-(-(-V // cluster)) // 4) * 4
    parts = [slice(min(c * S, V), min((c + 1) * S, V))
             for c in range(cluster)]
    k_eff = min(max(V if k <= 0 else k, 1), V)
    cand = None
    if k_eff == V:
        tau_k, n_k = int(u.min()), V
        if V <= RADIX_CAND:
            cand = u
    else:
        prefix, need, above = 0, k_eff, 0
        src_above = [0] * cluster
        for shift in (24, 16, 8, 0):
            tot, suf, per = _radix_bins(u, np.ones(V, np.uint64), parts,
                                        shift, prefix)
            d = sum(s >= need for s in suf[:256]) - 1
            from_d = above + suf[d]
            need -= suf[d + 1]
            above += suf[d + 1]
            prefix = (prefix << 8) | d
            src_cand = [a + sum(h[d:])
                        for a, h in zip(src_above, per, strict=True)]
            src_above = [a + sum(h[d + 1:])
                         for a, h in zip(src_above, per, strict=True)]
            if from_d <= RADIX_CAND:
                cand = u[(u >> shift) >= prefix]
                assert cand.size == from_d == sum(src_cand)
                break
        if cand is None:
            tau_k, n_k = prefix, above + tot[d]
        else:
            gt = (cand[None, :] > cand[:, None]).sum(1)
            ge = (cand[None, :] >= cand[:, None]).sum(1)
            kth = (gt < k_eff) & (k_eff <= ge)
            tau_k, n_k = int(cand[kth][0]), int(ge[kth][0])
    masked = np.float32(tsp._MASKED)
    xmax = _radix_x(np.asarray([u.max()], np.uint64))[0]
    m = xmax if n_k == V else np.maximum(xmax, masked)

    def weight(uu):
        e = np.exp(np.where(uu >= tau_k, _radix_x(uu), masked) - m)
        return np.rint(e.astype(np.float32).astype(np.float64)
                       * _FIX).astype(np.uint64)
    w_masked = int(np.rint(float(np.exp(masked - m)) * _FIX))
    if cand is not None and w_masked == 0:
        route, w = "direct", weight(cand)
        bound = _radix_target(p, int(w.sum()))
        tau_p = min([int(c) for c in [*cand.tolist(), 0]
                     if int(w[cand > c].sum()) < bound], default=0xFFFFFFFF)
    elif p == 1:
        route, w = "p1", weight(u)
        tau_p = int(u[w > 0].min())
    else:
        route = "cluster"
        tau_p = _radix_mass_select(u, weight(u), parts, p)
    out = np.where(u >= max(tau_k, tau_p), x, masked).astype(np.float32)
    return out, tau_k, route


_jax_mask = jax.jit(jsp.topk_topp_mask_ref)


def _jax_kth(x, k_eff):
    return np.asarray(jsp._search_kth(jsp._sortable_u32(jnp.asarray(x)),
                                      jnp.asarray(k_eff)))


@pytest.mark.parametrize("p", [1e-6, 0.5, 0.95, 1.0])
@pytest.mark.parametrize("V", [5, 1003, 4100])
@pytest.mark.parametrize("kind", SAMPLING_KINDS)
def test_radix_plan_matches_plain_and_jax(kind, V, p):
    """The kernel's plan, emulated, against the plain version and JAX's
    ``topk_topp_mask_ref``: tau_k and the top-k survivors bit for bit (k
    in {<= 0, 1, 40, 64, 300, V, V + 7}; at p = 1 every top-k value within
    20 nats of the max kept, ``check_top_k_set``); the mask within
    SAMPLING_TV of flipped mass (fixed-point sums against float32 ones,
    and at p = 1 each side's far tail). V = 5 leaves CTAs empty; 1003 and
    4100 are off a multiple of the cluster (1003 of 4 too)."""
    ks = np.asarray([0, 1, 40, V, V + 7, -3, 300, 64], np.int32)
    x, _, _ = sampling_edge_case(29, kind, len(ks), V)
    ps = np.full(len(ks), p, np.float32)
    rows = [_radix_row(x[i], int(ks[i]), ps[i]) for i in range(len(ks))]
    got = torch.from_numpy(np.stack([r[0] for r in rows]))
    lf, tk, tp = to_torch(x, ks, ps)
    k_eff = torch.where(tk <= 0, torch.full_like(tk, V), tk.long()).clamp(1, V)
    want_kth = tsp._search_kth(tsp._sortable_u32(lf), k_eff)
    assert [r[1] for r in rows] == want_kth.tolist()
    assert [r[1] for r in rows] == _jax_kth(x, k_eff.numpy()).tolist()
    keep_top_k = tsp._sortable_u32(lf) >= want_kth[:, None]
    for name, want in (
            ("plain", tsp.topk_topp_mask_ref(lf, tk, tp)),
            ("jax", torch.from_numpy(np.array(_jax_mask(
                *map(jnp.asarray, (x, ks, ps))))))):
        keep_w, keep_g = want > -1e30, got > -1e30
        assert not (keep_g & ~keep_top_k).any(), name
        assert torch.equal(got[keep_w & keep_g], want[keep_w & keep_g]), name
        assert flipped_mass(lf, keep_w, keep_g) <= SAMPLING_TV, name
    assert check_top_k_set(lf, tk, tp, got > -1e30) is None


def test_radix_plan_takes_every_route():
    """The routes the parametrised test runs: candidates mailed after the
    first digit or a later one, or the whole row of a small vocab, taken
    pairwise; without candidates, the least-weight route at p = 1 and
    radix on mass over the cluster."""
    x, _, _ = sampling_edge_case(29, "normal", 1, 4100)
    assert _radix_row(x[0][:1003], 1, 0.95)[2] == "direct"
    assert _radix_row(x[0], 40, 0.95)[2] == "direct"
    assert _radix_row(x[0][:5], 0, 0.95)[2] == "direct"
    assert _radix_row(x[0], 300, 0.95)[2] == "cluster"
    assert _radix_row(x[0], 0, 1.0)[2] == "p1"
    assert _radix_row(x[0], 0, 0.9)[2] == "cluster"


@pytest.mark.parametrize("kind", SAMPLING_KINDS)
def test_radix_plan_is_bitwise_independent_of_the_cluster_size(kind):
    """Integer counts and fixed-point masses sum in any order: the row
    split over the kernel's 16 CTAs gives the same bits as over 1 or 4,
    on every tau_p route."""
    V = 2051
    x, ks, ps = sampling_edge_case(31, kind, 12, V)
    for i in range(len(ks)):
        want = _radix_row(x[i], int(ks[i]), ps[i], 16)
        for cluster in (1, 4):
            got = _radix_row(x[i], int(ks[i]), ps[i], cluster)
            assert np.array_equal(got[0].view(np.uint32),
                                  want[0].view(np.uint32))
            assert got[1:] == want[1:]


def test_ops_dispatch_cpu_goes_to_plain_and_kernels_refuse_cpu():
    """CPU tensors take the plain versions through ``ops``; the kernel
    wrappers raise on them (no fallback either way) and count nothing."""
    case = to_torch(*attn_case(6, 2, 1, 2, 2, 16))
    before = (tpa.paged_flash_attention.launches,
              tsp.topk_topp_mask.launches)
    assert torch.equal(tops.paged_attention(*case),
                       tpa.paged_attention_ref(*case))
    with pytest.raises(ValueError, match="CUDA tensors only"):
        tpa.paged_flash_attention(*case)
    s_case = to_torch(*sampling_case(7))
    assert torch.equal(tops.topk_topp_mask(*s_case),
                       tsp.topk_topp_mask_ref(*s_case))
    with pytest.raises(ValueError, match="CUDA tensors only"):
        tsp.topk_topp_mask(*s_case)
    assert (tpa.paged_flash_attention.launches,
            tsp.topk_topp_mask.launches) == before


@pytest.mark.parametrize("B,H,Hkv,Sq,Sk,hd,causal", FLASH_GRID)
def test_flash_attention_plain_matches_jax(B, H, Hkv, Sq, Sk, hd, causal):
    q, k, v, do = flash_case(Sq + hd, B, H, Hkv, Sq, Sk, hd)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    got = tfa.flash_attention_ref(*to_torch(q, k, v), causal=causal)
    for want in (flash_attention_bhsd(jq, jk, jv, causal=causal,
                                      interpret=True),
                 jref.flash_attention_ref(jq, jk, jv, causal=causal)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=ATTN_TOL, atol=ATTN_TOL)


@pytest.mark.parametrize("B,H,Hkv,Sq,Sk,hd,causal", FLASH_GRID)
def test_flash_attention_plain_grads_match_jax_vjp(B, H, Hkv, Sq, Sk, hd,
                                                   causal):
    q, k, v, do = flash_case(Sq * 3 + hd, B, H, Hkv, Sq, Sk, hd)
    _, vjp = jax.vjp(lambda *a: jref.flash_attention_ref(*a, causal=causal),
                     *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(do))
    tq, tk, tv = (x.requires_grad_(True) for x in to_torch(q, k, v))
    out = tfa.flash_attention_ref(tq, tk, tv, causal=causal)
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4)


LOG2E = 1.4426950408889634


def _bf16_flash_emulated(q, k, v, do, causal, split_p=True, block=128):
    """The bf16 tensor-core kernels' arithmetic in plain torch, rounding
    where they round: products of bf16 operands summed in float32, the
    scale applied to S in float32, the online softmax in base 2 over
    128-key tiles, P fed to P V as a bf16 high part plus a bf16 remainder
    (``split_p``; else rounded once), the output rounded to bf16; in the
    backward P and dS rounded to bf16 before dV = P^T dO, dK = dS^T Q and
    dQ = dS K, dS from the float32 P. q/do (B, H, Sq, hd), k/v (B, Hkv,
    Sk, hd), all bf16. Returns (o, dq, dk, dv) in bf16."""
    B, H, Sq, hd = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    g = H // Hkv
    scale = np.float32(1.0 / np.sqrt(hd))
    sl = float(scale * np.float32(LOG2E))
    rb = lambda x: x.to(torch.bfloat16).float()  # noqa: E731
    qf = q.float().reshape(B, Hkv, g, Sq, hd)
    dof = do.float().reshape(B, Hkv, g, Sq, hd)
    kf, vf = k.float(), v.float()
    rows = torch.arange(Sq)[:, None]
    m = torch.full((B, Hkv, g, Sq), -float("inf"))
    l = torch.zeros((B, Hkv, g, Sq))
    acc = torch.zeros((B, Hkv, g, Sq, hd))
    for k0 in range(0, Sk, block):
        s = torch.einsum("bhgqd,bhkd->bhgqk", qf, kf[:, :, k0:k0 + block])
        s = s * sl
        if causal:
            cols = torch.arange(k0, min(k0 + block, Sk))[None, :]
            s = s.masked_fill(cols > rows, -float("inf"))
        mx = torch.maximum(m, s.amax(-1))
        corr = torch.exp2(m - mx)
        p = torch.exp2(s - mx[..., None])
        l = l * corr + p.sum(-1)
        pv = rb(p) + rb(p - rb(p)) if split_p else rb(p)
        acc = acc * corr[..., None] + torch.einsum(
            "bhgqk,bhkd->bhgqd", pv, vf[:, :, k0:k0 + block])
        m = mx
    o = (acc / l[..., None]).to(torch.bfloat16)
    lse2 = m + torch.log2(l)                   # lse in base 2

    s = torch.einsum("bhgqd,bhkd->bhgqk", qf, kf) * sl
    p = torch.exp2(s - lse2[..., None])
    if causal:
        p = p.masked_fill(torch.arange(Sk)[None, :] > rows, 0.0)
    delta = (dof * o.float().reshape(B, Hkv, g, Sq, hd)).sum(-1)
    dp = torch.einsum("bhgqd,bhkd->bhgqk", dof, vf)
    ds = p * (dp - delta[..., None])
    dv = torch.einsum("bhgqk,bhgqd->bhkd", rb(p), dof)
    dk = torch.einsum("bhgqk,bhgqd->bhkd", rb(ds), qf) * scale
    dq = torch.einsum("bhgqk,bhkd->bhgqd", rb(ds), kf) * scale
    return (o.reshape(B, H, Sq, hd), dq.reshape(B, H, Sq, hd)
            .to(torch.bfloat16), dk.to(torch.bfloat16), dv.to(torch.bfloat16))


def _flash_bf16_errors(hd, split_p, seed):
    """(worst out excess over 1e-3 + 1e-2 |plain| per element, max out
    error, worst gradient error / max |plain gradient|) of the emulated
    kernels against autograd of the plain version, causal GQA S=512
    H=4/2, bf16 inputs made with numpy."""
    q, k, v, do = (t.to(torch.bfloat16) for t in to_torch(
        *flash_case(seed, 1, 4, 2, 512, 512, hd)))
    tq, tk, tv = (x.clone().requires_grad_(True) for x in (q, k, v))
    want = tfa.flash_attention_ref(tq, tk, tv, causal=True)
    wgrads = torch.autograd.grad(want, (tq, tk, tv), do)
    o, *grads = _bf16_flash_emulated(q, k, v, do, True, split_p=split_p)
    d = (o.float() - want.float()).abs()
    excess = (d - (1e-3 + 1e-2 * want.float().abs())).max().item()
    g_err = max(((g.float() - w.float()).abs().max()
                 / w.float().abs().max()).item()
                for g, w in zip(grads, wgrads))
    return excess, d.max().item(), g_err


@pytest.mark.parametrize("hd", [64, 128])
def test_flash_bf16_rounding_plan_within_card_tolerance(hd):
    """Where the bf16 kernels round, emulated on the CPU, stays inside the
    tolerances the card holds them to: out within 2e-2 and, per element,
    1e-3 + 1e-2 |plain|; dq/dk/dv within 2e-2 of their max."""
    excess, out_err, g_err = _flash_bf16_errors(hd, True, 1)
    assert excess <= 0.0 and out_err <= 2e-2
    assert g_err <= 2e-2


def test_flash_bf16_single_rounding_of_p_breaks_out_tolerance():
    """Why the forward feeds P V a bf16 high part plus a bf16 remainder:
    with P rounded once to bf16, rows that see few keys leave the
    per-element output tolerance on this input (the split stays inside,
    as the test above shows for the same seed)."""
    excess, _, _ = _flash_bf16_errors(128, False, 1)
    assert excess > 0.0


@pytest.mark.parametrize("R,D", [(64, 128), (32, 256), (16, 2048)])
def test_rmsnorm_plain_and_grads_match_jax(R, D):
    x, w, dy = rms_case(R + D, R, D)
    got_y = trn.rmsnorm_ref(*to_torch(x, w))
    for want in (rmsnorm_2d(jnp.asarray(x), jnp.asarray(w), row_block=16,
                            interpret=True),
                 jref.rmsnorm_ref(jnp.asarray(x), jnp.asarray(w))):
        np.testing.assert_allclose(got_y.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)
    _, vjp = jax.vjp(jref.rmsnorm_ref, jnp.asarray(x), jnp.asarray(w))
    want_dx, want_dw = vjp(jnp.asarray(dy))
    tx, tw = (a.requires_grad_(True) for a in to_torch(x, w))
    got = torch.autograd.grad(trn.rmsnorm_ref(tx, tw), (tx, tw),
                              torch.from_numpy(dy))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want_dx),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want_dw),
                               rtol=1e-5, atol=1e-5 * float(
                                   np.abs(np.asarray(want_dw)).max()))


def test_training_kernels_dispatch_cpu_to_plain_and_refuse_cpu():
    """ops sends CPU tensors to the plain flash-attention and RMSNorm
    versions (model layout for attention); the kernel wrappers raise on
    CPU tensors and count nothing."""
    q, k, v, _ = to_torch(*flash_case(7, 1, 4, 2, 8, 8, 16))
    before = (tfa.flash_attention_fwd.launches,
              tfa.flash_attention_bwd.launches, trn.rmsnorm_fwd.launches,
              trn.rmsnorm_bwd.launches)
    got = tops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2), causal=True)
    assert torch.equal(got.transpose(1, 2),
                       tfa.flash_attention_ref(q, k, v, causal=True))
    for fn in (tfa.flash_attention, tfa.flash_attention_fwd):
        with pytest.raises(ValueError, match="CUDA tensors only"):
            fn(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
    x, w, _ = to_torch(*rms_case(8, 4, 16))
    assert torch.equal(tops.rmsnorm(x, w), trn.rmsnorm_ref(x, w))
    for fn in (trn.rmsnorm, trn.rmsnorm_fwd):
        with pytest.raises(ValueError, match="CUDA tensors only"):
            fn(x, w)
    assert (tfa.flash_attention_fwd.launches,
            tfa.flash_attention_bwd.launches, trn.rmsnorm_fwd.launches,
            trn.rmsnorm_bwd.launches) == before
