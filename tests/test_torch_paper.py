"""The paper's own encoder and encoder-decoder families in the port,
against the JAX package, float32 on the CPU (reduced configs).

``bert128``, ``vit32`` and ``mc_tiny`` are encoders (non-causal
attention; ``vit32`` prepends the vision stub's four patch embeddings),
``mt_marian`` and ``seamless_m4t_v2`` encoder-decoders (paper Eq. 2-3:
the decoder block cross-attends to the encoder's output, whose cotangent
is summed over the decoder's layers and flows into the encoder trunk's
MGRIT adjoint; ``seamless_m4t_v2`` reads the audio stub's
``src_embeds``). The decoder configs that the port builds but no other
test holds to JAX ride along in ``test_torch_paper_runs.py``'s
serial-logits test; that file also holds the trainer, probe and CLI
runs. The JAX gradients run once per config and mode (a module-scoped
fixture). Tolerances are ``test_torch_train.py``'s: loss rtol 1e-5 and
each gradient leaf within 1e-4 of its max, 2e-5 for attention and a
block's F.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro.models import blocks as jblocks
from repro.models import transformer as jtr
from repro_torch.convert import params_from_jax
from repro_torch.data.pipeline import SyntheticLM, shard_batch
from repro_torch.models import attention as tattn
from repro_torch.models import blocks as tblocks
from repro_torch.tree import leaves_with_paths
from test_torch_train import (ATTN_TOL, assert_grads_close, attn_setup,
                              close, f32_configs, np_tree, rnd, t,
                              torch_value_and_grad)

torch.set_num_threads(2)
GRAD_ARCHS = ["bert128", "mt_marian"]


def paper_setup(arch, seed=0, **mgrit_kw):
    """Reduced float32 configs of ``arch`` for both packages, the JAX
    init converted into the port's params, and one SyntheticLM batch
    (``src_tokens`` / ``src_embeds`` / ``mm_embeds`` as the config
    asks)."""
    jr, tr = f32_configs(arch, **mgrit_kw)
    jparams = jtr.init_model(jax.random.PRNGKey(seed), jr)
    tparams = params_from_jax(np_tree(jparams), tr, "cpu")
    batch = SyntheticLM(tr, seed).batch_at(0)
    return jr, tr, jparams, tparams, batch


def jax_batch(batch):
    return jax.tree.map(jnp.asarray, batch)


@pytest.fixture(scope="module")
def jax_grads():
    """{(arch, mode): (setup, loss, fwd_norms, grads)} from JAX, once."""
    out = {}
    for arch in GRAD_ARCHS:
        setup = paper_setup(arch)
        jr, _, jparams, _, batch = setup
        for mode in ("lp", "serial"):
            (jl, jdiag), jg = jax.jit(jax.value_and_grad(
                lambda p, mode=mode: jtr.loss_fn(p, jax_batch(batch), jr,
                                                 mode=mode),
                has_aux=True))(jparams)
            out[arch, mode] = (setup, float(jl),
                               np.asarray(jdiag["fwd_norms"]), jg)
    return out


@pytest.mark.parametrize("mode", ["lp", "serial"])
@pytest.mark.parametrize("arch", GRAD_ARCHS)
def test_loss_fn_and_grads_match_jax(jax_grads, arch, mode):
    """Loss, forward residual norms and every gradient leaf; for
    mt_marian that includes the encoder's (``enc_mid``), which only the
    decoder's ``xa`` cotangent reaches."""
    (jr, tr, _, tparams, batch), jl, jnorms, jg = jax_grads[arch, mode]
    loss, diag, grads = torch_value_and_grad(
        tparams, shard_batch(batch, "cpu"), tr, mode)
    np.testing.assert_allclose(loss.item(), jl, rtol=1e-5)
    close(diag["fwd_norms"], jnorms, 1e-4 * max(1.0, np.abs(jnorms).max()))
    assert_grads_close(grads, jg)
    if tr.model.family == "encdec":
        enc = [g for p, g in grads.items()
               if p[0] == "enc_mid" and p[-1] != "gate"]
        assert enc and all(float(g.abs().max()) > 0 for g in enc)


def test_encdec_block_F_matches_jax():
    """Paper Eq. 2 (self-attention, cross-attention to X_enc, MLP), with
    the encoder output longer than the decoder's input."""
    jr, tr = f32_configs("mt_marian")
    jp = jblocks.init_block(jax.random.PRNGKey(3), jr.model, "encdec_dec")
    tp = jax.tree.map(lambda a: t(np.asarray(a)), jp)
    D = jr.model.d_model
    z, xa = rnd(4, (2, 16, D)), rnd(5, (2, 24, D))
    rope = jattn.rope_freqs(jr.model.resolved_head_dim, jr.model.rope_theta,
                            jnp.arange(16, dtype=jnp.int32))
    want, _ = jblocks.block_F(jp, jnp.asarray(z), jr.model,
                              kind="encdec_dec", causal=True, rope=rope,
                              xa=jnp.asarray(xa))
    got = tblocks.block_F(tp, t(z), tr.model, kind="encdec_dec",
                          causal=True,
                          rope=tuple(t(np.asarray(r)) for r in rope),
                          xa=t(xa))
    close(got, want, ATTN_TOL)


@pytest.mark.parametrize("hkv", [1, 4])
def test_cross_attention_matches_jax(hkv):
    """K and V from ``xa`` (Sk = 24 != Sq = 16), no rope, no mask; the
    caller's ``causal=True`` is dropped as in the reference."""
    jc, tc, jp, tp, x, rope_j, rope_t = attn_setup(hkv, hkv=hkv)
    xa = rnd(9, (2, 24, 32))
    want, _ = jattn.attention_apply(jp, jnp.asarray(x), jc, causal=True,
                                    rope=rope_j, xa=jnp.asarray(xa))
    got = tattn.attention_apply(tp, t(x), tc, causal=True, rope=rope_t,
                                xa=t(xa))
    close(got, want, ATTN_TOL)


@pytest.mark.parametrize("arch", ["bert128", "vit32", "mt_marian",
                                  "seamless_m4t_v2"])
def test_params_from_jax_covers_encoder_and_encdec_trees(arch):
    """Every JAX leaf lands on the port's path with its values:
    ``enc_mid`` / ``dec_mid``, ``xattn``, ``ln3`` and the layernorm
    ``bias`` leaves included; a missing leaf is refused by name."""
    jr, tr = f32_configs(arch)
    jtree = np_tree(jtr.init_model(jax.random.PRNGKey(1), jr))
    got = dict(leaves_with_paths(params_from_jax(jtree, tr, "cpu")))
    want = dict(leaves_with_paths(jtree))
    assert set(got) == set(want)
    for path, w in want.items():
        assert torch.equal(got[path], t(w)), path
    names = {k for path in got for k in path}
    need = {"bias", "ln1", "ln2", "attn", "mlp"}
    if tr.model.family == "encdec":
        need |= {"enc_mid", "dec_mid", "xattn", "ln3"}
    assert need <= names
    if tr.model.family == "encdec":
        del jtree["dec_mid"]["params"]["ln3"]
        with pytest.raises(ValueError, match="dec_mid.params"):
            params_from_jax(jtree, tr, "cpu")
