"""The port's CUDA kernels against their plain PyTorch versions, on a
card. The kernels have no CPU mode, so every test here needs CUDA and
skips with a reason elsewhere; this file imports no jax, so it also runs
where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances: float32 2e-5 (the repo's float32 attention tolerance);
bfloat16 2e-2 (the plain version rounds the probabilities to bf16 before
the value product, as the reference does, the kernel keeps them in
float32). The bf16 attention output is also held per element to
1e-3 + 1e-2 x |plain| (the later causal rows hold values far below
2e-2). Gradients are held to the same numbers times each tensor's
largest magnitude; RMSNorm to 1e-5 in float32. Backward kernels must
also give bit-identical gradients on a second run (fixed summation
order, no atomics). Sampling: survivors bit-equal; the kernel sums the nucleus
mass in another order, so tokens whose cumulative mass lies within float
rounding of p may flip — their total probability per row must stay
below 1e-5 (the two masks' sampling distributions are that close in
total variation). The input builders are shared with
``test_torch_kernels.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import paged_attention as tpa
from repro_torch.kernels import rmsnorm as trn
from repro_torch.kernels import sampling as tsp


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
    (4, 64, 16, 8, 128, 16, 8)])        # qwen3_1p7b prefill chunk
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
    (2, 16, 8, 1024, 1024, 128, True)])  # qwen3_1p7b widths
def test_flash_attention_fwd_bwd_match_plain_on_card(
        B, H, Hkv, Sq, Sk, hd, causal, dtype, tol):
    _need_card()
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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_backward_is_deterministic_on_card(dtype):
    _need_card()
    x, w, dy = to_torch(*rms_case(6, 8192 * 16, 128), device="cuda")
    x, dy = x.to(dtype), dy.to(dtype)
    _, rstd = trn.rmsnorm_fwd(x, w)
    first = trn.rmsnorm_bwd(x, w, rstd, dy)
    second = trn.rmsnorm_bwd(x, w, rstd, dy)
    torch.cuda.synchronize()
    assert torch.equal(first[0], second[0])
    assert torch.equal(first[1], second[1])
