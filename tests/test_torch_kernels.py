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
survivor sets, survivors bit-equal) on distinct logits.
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
from test_torch_gpu import (FLASH_GRID, GRID, attn_case, flash_case,
                            rms_case, sampling_case, to_torch)

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
