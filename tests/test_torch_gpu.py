"""The port's CUDA kernels against their plain PyTorch versions, on a
card. The kernels have no CPU mode, so every test here needs CUDA and
skips with a reason elsewhere; this file imports no jax, so it also runs
where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances: float32 2e-5 (the repo's float32 attention tolerance);
bfloat16 2e-2 (the plain version rounds the probabilities to bf16 before
the value product, as the reference does, the kernel keeps them in
float32). Sampling: survivors bit-equal; the kernel sums the nucleus
mass in another order, so tokens whose cumulative mass lies within float
rounding of p may flip — their total probability per row must stay
below 1e-5 (the two masks' sampling distributions are that close in
total variation). The input builders are shared with
``test_torch_kernels.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import paged_attention as tpa
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
