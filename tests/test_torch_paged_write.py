"""The paged KV write's rule for the scratch row, against the JAX package.

Every padded prompt position and every idle slot writes its K/V row to
flat row 0 of the pool (the scratch page's first row). Which of several
writes to one row lands is undefined on CUDA, and a padded query can
read that row, so the port gives every such write the last writer's row
(``attention.last_scratch_writer``): the row then holds the last
writer's bytes whatever order the writes land in, as JAX's scatter
leaves it on the CPU. Inputs are dyadic (small integers over powers of
two) and rope is the identity, so K and V are exact in float32 and the
pools can be held bitwise, the scratch page included.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JModelConfig
from repro.models import attention as jattn
from repro_torch.configs.base import ModelConfig as TModelConfig
from repro_torch.models import attention as tattn

torch.set_num_threads(2)


def dyadic(rng, shape, denom):
    return (rng.integers(-3, 4, shape) / denom).astype(np.float32)


@pytest.mark.parametrize("fused", [False, True])
def test_prefill_bucket_pools_bitwise_jax_scratch_page_included(fused):
    """A prefill bucket of S = 8 over three slots: one full, one with
    three tokens and five padded positions, one idle (thirteen writers
    of the scratch row): the port's page pools equal JAX's
    ``paged_attention_apply`` pools bit for bit, scratch page
    included."""
    kw = dict(d_model=32, n_heads=4, n_kv_heads=2, d_ff=64, vocab_size=64,
              head_dim=8, dtype="float32", qk_norm=False)
    jc, tc = JModelConfig(**kw), TModelConfig(**kw)
    rng = np.random.default_rng(0)
    B, S, page, per_slot, hkv, hd = 3, 8, 4, 4, 2, 8
    n_pages = 1 + B * per_slot
    params = {"wq": dyadic(rng, (32, 4, hd), 8),
              "wk": dyadic(rng, (32, hkv, hd), 8),
              "wv": dyadic(rng, (32, hkv, hd), 8),
              "wo": dyadic(rng, (4, hd, 32), 8)}
    x = dyadic(rng, (B, S, 32), 4)
    pk = dyadic(rng, (n_pages, page, hkv, hd), 2)
    pv = dyadic(rng, (n_pages, page, hkv, hd), 2)
    table = (1 + rng.permutation(B * per_slot)).reshape(
        B, per_slot).astype(np.int32)
    lengths = np.asarray([0, 3, 5], np.int32)
    n_new = np.asarray([8, 3, 0], np.int32)
    assert int((S - n_new).sum()) == 13
    rope = (np.ones((B, S, hd // 2), np.float32),
            np.zeros((B, S, hd // 2), np.float32))
    _, npk, npv = jattn.paged_attention_apply(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x), jc,
        rope=tuple(map(jnp.asarray, rope)), pk=jnp.asarray(pk),
        pv=jnp.asarray(pv), page_table=jnp.asarray(table),
        lengths=jnp.asarray(lengths), n_new=jnp.asarray(n_new), fused=fused)
    tpk, tpv = torch.from_numpy(pk.copy()), torch.from_numpy(pv.copy())
    tattn.paged_attention_apply(
        {k: torch.from_numpy(v) for k, v in params.items()},
        torch.from_numpy(x), tc, rope=tuple(map(torch.from_numpy, rope)),
        pk=tpk, pv=tpv, page_table=torch.from_numpy(table),
        lengths=torch.from_numpy(lengths), n_new=torch.from_numpy(n_new),
        fused=fused)
    np.testing.assert_array_equal(tpk.numpy(), np.asarray(npk))
    np.testing.assert_array_equal(tpv.numpy(), np.asarray(npv))
    assert not np.array_equal(tpk.numpy()[0], pk[0])   # row 0 written


def test_last_scratch_writer_lands_the_same_row_in_any_order():
    """Each writer of flat row 0 takes the last one's row, every other
    write its own; written in (slot, position) order or reversed, the
    pool is JAX's ``.at[flat].set`` bit for bit. Without the rule the
    reversed order leaves another row there."""
    flat = torch.tensor([0, 5, 0, 7, 0, 2, 0])
    rows = torch.arange(7 * 3, dtype=torch.float32).view(7, 3)
    src = tattn.last_scratch_writer(flat)
    assert src.tolist() == [6, 1, 6, 3, 6, 5, 6]
    want = np.asarray(jnp.zeros((8, 3)).at[jnp.asarray(flat.numpy())].set(
        jnp.asarray(rows.numpy())))
    back = torch.arange(6, -1, -1)
    for order in (torch.arange(7), back):
        pool = torch.zeros(8, 3)
        pool.index_copy_(0, flat[order], rows[src][order])
        np.testing.assert_array_equal(pool.numpy(), want)
    pool = torch.zeros(8, 3)
    pool.index_copy_(0, flat[back], rows[back])
    assert not np.array_equal(pool.numpy(), want)
    # no scratch writer: every write its own row
    assert tattn.last_scratch_writer(torch.tensor([3, 1, 2])).tolist() == \
        [0, 1, 2]
