"""The port's threefry PRNG against ``jax.random`` (the installed JAX,
``jax_threefry_partitionable=True``).

Keys, ``fold_in`` and random bits must be bit-equal; the uniform draw
is bit-equal too. Gumbel noise is ``-log(-log(u))``: XLA's CPU ``log``
and torch's differ by at most 1 ulp per call, so each log is checked to
1 ulp and the composed noise to 2**-20 absolute (a few ulps at |g| <= 8).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.launch import prng

torch.set_num_threads(2)
SEEDS = [0, 1, 12345, 2**31 - 1]
COUNTERS = [0, 5, 77, 1000]
N = 4096
TINY = float(np.finfo(np.float32).tiny)


def ulps(a, b):
    ai = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    bi = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(ai - bi)


def jax_keys():
    return [jax.random.fold_in(jax.random.PRNGKey(s), c)
            for s in SEEDS for c in COUNTERS]


def torch_keys():
    s = torch.tensor([s for s in SEEDS for _ in COUNTERS])
    c = torch.tensor([c for _ in SEEDS for c in COUNTERS])
    return prng.fold_in(prng.PRNGKey(s), c)


def test_prngkey_and_fold_in_equal_jax():
    for s in SEEDS:
        np.testing.assert_array_equal(
            prng.PRNGKey(torch.tensor([s]))[0].numpy(),
            np.asarray(jax.random.PRNGKey(s)).astype(np.int64))
    want = np.stack([np.asarray(k) for k in jax_keys()]).astype(np.int64)
    np.testing.assert_array_equal(torch_keys().numpy(), want)


def test_fold_in_chains_equal_jax():
    k = jax.random.PRNGKey(7)
    t = prng.PRNGKey(torch.tensor([7]))
    for d in (0, 1, 2, 123456, 2**31 - 1):
        k = jax.random.fold_in(k, d)
        t = prng.fold_in(t, torch.tensor([d]))
        np.testing.assert_array_equal(t[0].numpy(),
                                      np.asarray(k).astype(np.int64))


def test_random_bits_equal_jax():
    want = np.stack([np.asarray(jax.random.bits(k, (N,), jnp.uint32))
                     for k in jax_keys()]).astype(np.int64)
    np.testing.assert_array_equal(prng.random_bits(torch_keys(), N).numpy(),
                                  want)


def test_uniform_equal_jax():
    want = np.stack([np.asarray(jax.random.uniform(
        k, (N,), jnp.float32, minval=TINY, maxval=1.0))
        for k in jax_keys()])
    got = prng.uniform(torch_keys(), N, TINY, 1.0).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("step", ["inner", "outer"])
def test_gumbel_logs_within_one_ulp(step):
    u = np.stack([np.asarray(jax.random.uniform(
        k, (N,), jnp.float32, minval=TINY, maxval=1.0))
        for k in jax_keys()])
    x = u if step == "inner" else \
        np.asarray(-jnp.log(jnp.asarray(u)))       # the outer log's input
    want = np.asarray(jnp.log(jnp.asarray(x)))
    got = torch.log(torch.from_numpy(x.copy())).numpy()
    assert ulps(got, want).max() <= 1


def test_gumbel_close_to_jax():
    want = np.stack([np.asarray(jax.random.gumbel(k, (N,), jnp.float32))
                     for k in jax_keys()])
    got = prng.gumbel(torch_keys(), N).numpy()
    assert np.abs(got - want).max() <= 2.0 ** -20
