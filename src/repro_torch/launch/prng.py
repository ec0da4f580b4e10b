"""Threefry-2x32 keys and Gumbel noise, bit-exact with ``jax.random``.

The serve engine's sampling contract is ``gumbel(fold_in(PRNGKey(seed),
counter), (V,), float32)`` per slot (``repro.launch.steps.
sample_tokens``): a request's token stream depends only on its own seed
and how many tokens it has emitted. For seeded streams to match the JAX
package token for token, this module reproduces JAX's default threefry
PRNG as of JAX 0.9 (``jax_threefry_partitionable=True``):

- ``PRNGKey(seed)`` for a 32-bit seed is the key ``(0, seed)``;
- ``fold_in(key, d)`` is ``threefry2x32(key, (0, d))``;
- random bits of shape (V,) hash the counters ``(0, i)``,
  i = 0..V-1, and take ``bits_hi ^ bits_lo``;
- uniform(tiny, 1) sets the mantissa of 1.0 from the top 23 bits, and
  gumbel is ``-log(-log(u))``.

uint32 arithmetic runs in int64 tensors (masked to 32 bits), on either
device, vectorized over a batch of keys.
"""
from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_TINY = float(torch.finfo(torch.float32).tiny)


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k0, k1, x0, x1):
    """The Threefry-2x32 block cipher (20 rounds), elementwise over
    broadcastable int64 tensors holding uint32 values."""
    ks = (k0, k1, (k0 ^ k1 ^ 0x1BD11BDA) & _M32)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def PRNGKey(seed, device=None):
    """Raw threefry keys (..., 2) int64 from non-negative 32-bit seeds."""
    s = torch.as_tensor(seed, dtype=torch.int64, device=device) & _M32
    return torch.stack([torch.zeros_like(s), s], dim=-1)


def fold_in(key, data):
    """``jax.random.fold_in`` for keys (..., 2) and data (...,)."""
    d = torch.as_tensor(data, dtype=torch.int64, device=key.device) & _M32
    h0, h1 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(d), d)
    return torch.stack([h0, h1], dim=-1)


def random_bits(key, n: int):
    """``jax.random.bits(key, (n,), uint32)`` for keys (B, 2): (B, n)
    int64 holding uint32 values."""
    i = torch.arange(n, dtype=torch.int64, device=key.device)[None, :]
    b0, b1 = threefry2x32(key[:, 0:1], key[:, 1:2], torch.zeros_like(i), i)
    return b0 ^ b1


def uniform(key, n: int, minval: float = 0.0, maxval: float = 1.0):
    """``jax.random.uniform(key, (n,), float32, minval, maxval)`` for
    keys (B, 2): (B, n) float32."""
    bits = (random_bits(key, n) >> 9) | 0x3F800000       # 1.0's exponent
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=key.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=key.device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


def gumbel(key, n: int):
    """``jax.random.gumbel(key, (n,), float32)`` for keys (B, 2): (B, n)."""
    return -torch.log(-torch.log(uniform(key, n, _TINY, 1.0)))
