"""The port's sharding rules and gradient compression against the JAX
package's (``repro.parallel``), on the CPU, in one process.

Specs are held entry for entry against the reference's
``PartitionSpec`` for five configurations at full width (params on
meta / ``jax.eval_shape``), three sharding rules and two meshes. The
meshes are stand-ins exposing ``axis_names`` and ``shape``, all that
either package's rules read; the reference's ``NamedSharding`` wrapper
(which wants a real device mesh) is replaced by a pass-through of the
spec for the call. Compression: ``q`` and ``scale`` bitwise, and error
feedback within 1 ulp of float32 over five steps.
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.launch import specs as jspecs
from repro.parallel import compression as jcomp
from repro.parallel import params as jparams
from repro.parallel import sharding as jsharding
from repro_torch.configs import registry
from repro_torch.configs.base import ShardingConfig
from repro_torch.launch import specs as tspecs
from repro_torch.launch import steps
from repro_torch.parallel import compression as tcomp
from repro_torch.parallel import params as tparams
from repro_torch.parallel import sharding as tsharding
from repro_torch.tree import leaves_with_paths

ARCHS = ["deepseek_7b", "qwen3_moe_235b", "falcon_mamba_7b", "qwen3_1p7b",
         "zamba2_1p2b"]
RULES = {"train": "train_sharding", "tp": "tp_sharding",
         "decode": "decode_sharding"}
MESHES = [(2, 4), (16, 16)]
LOGICAL = ["batch", "layers", "heads", "kv_heads", "mlp", "embed", "vocab",
           "experts", "kv_seq", "seq", "head_dim", "state", "conv", "pages",
           None]


def mesh_of(shape, axes=("data", "model")):
    return types.SimpleNamespace(axis_names=tuple(axes),
                                 shape=dict(zip(axes, shape)))


@pytest.fixture
def ref_specs(monkeypatch):
    """The reference's NamedSharding(mesh, spec) becomes the spec as a
    tuple, so its rules run on a stand-in mesh."""
    monkeypatch.setattr(jparams, "NamedSharding",
                        lambda mesh, spec: tuple(spec))


def configs(arch, rule):
    j, t = jregistry.get_config(arch), registry.get_config(arch)
    return (j.replace(sharding=getattr(jregistry, RULES[rule])()),
            t.replace(sharding=getattr(registry, RULES[rule])()))


def ref_flat(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, tuple))
    return {tuple(k.key for k in path): spec for path, spec in flat}


def port_flat(tree) -> dict:
    return dict(leaves_with_paths(tree))


@pytest.mark.parametrize("rule", list(RULES))
def test_resolve_axis_and_spec_for_match_reference(rule):
    cfg_j = getattr(jregistry, RULES[rule])()
    cfg_t = getattr(registry, RULES[rule])()
    for shape, axes in [((2, 4), ("data", "model")),
                        ((16, 16), ("data", "model")),
                        ((2, 16, 16), ("pod", "data", "model"))]:
        mesh = mesh_of(shape, axes)
        for name in LOGICAL:
            assert tsharding.resolve_axis(name, cfg_t, mesh) == \
                jsharding.resolve_axis(name, cfg_j, mesh), (name, shape)
        for names, dims in [(("batch", "seq", "embed"), (32, 128, 64)),
                            (("batch", "kv_seq", "kv_heads", "head_dim"),
                             (32, 4096, 8, 128)),
                            (("layers", "heads", "mlp"), (12, 48, 96)),
                            (("vocab", "embed"), (151936, 2048)),
                            (("batch", "batch"), (64, 64))]:
            for shp in (None, dims):
                want = tuple(jsharding.spec_for(names, cfg_j, mesh, shp))
                assert tsharding.spec_for(names, cfg_t, mesh, shp) == \
                    want, (names, shp, shape)


@pytest.mark.parametrize("rule", list(RULES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_reference(arch, rule, ref_specs):
    """Every leaf's logical axes and spec, at full width, on both
    meshes; build_spec's FSDP choice included (decode_sharding)."""
    jr, tr = configs(arch, rule)
    jtree, ttree = jspecs.params_specs(jr), tspecs.params_specs(tr)
    jleaves = {tuple(k.key for k in p): leaf for p, leaf in
               jax.tree_util.tree_flatten_with_path(jtree)[0]}
    tleaves = port_flat(ttree)
    assert set(jleaves) == set(tleaves)
    for path, leaf in tleaves.items():
        assert tuple(leaf.shape) == tuple(jleaves[path].shape), path
        jpath = tuple(jax.tree_util.DictKey(k) for k in path)
        assert tparams.logical_axes_for(path, leaf.shape) == \
            jparams.logical_axes_for(jpath, jleaves[path].shape), path
    for shape in MESHES:
        mesh = mesh_of(shape)
        want = ref_flat(jparams.param_specs(jtree, jr, mesh))
        got = port_flat(tparams.param_specs(ttree, tr, mesh))
        assert got == want, (shape, {p: (got[p], want[p]) for p in got
                                     if got[p] != want[p]})


@pytest.mark.parametrize("arch", ARCHS)
def test_batch_cache_and_pool_specs_match_reference(arch, ref_specs):
    jr, tr = configs(arch, "train")
    jd, td = (jregistry.get_config(arch, "decode_32k"),
              registry.get_config(arch, "decode_32k"))
    pools = {"k": (4, 64, 16, 8, 128), "v": (4, 64, 16, 8, 128),
             "conv": (4, 64, 3, 8192), "h": (4, 64, 8192, 16)}
    h5 = {"h": (4, 64, 64, 64, 64)}
    for shape in MESHES:
        mesh = mesh_of(shape)
        want = jparams.batch_specs(jspecs.train_batch_specs(jr), jr, mesh)
        got = tparams.batch_specs(tspecs.train_batch_specs(tr), tr, mesh)
        assert got == want
        want = ref_flat(jparams.cache_specs(jspecs.decode_specs(jd)[0], jd,
                                            mesh))
        got = port_flat(tparams.cache_specs(tspecs.decode_specs(td)[0], td,
                                            mesh))
        assert got == want
        for tree in (pools, h5):
            want = ref_flat(jparams.paged_state_specs(
                {k: jax.ShapeDtypeStruct(s, jnp.bfloat16)
                 for k, s in tree.items()}, jd, mesh))
            got = port_flat(tparams.paged_state_specs(
                {k: torch.empty(s, device="meta") for k, s in tree.items()},
                td, mesh))
            assert got == want


def test_shardings_for_train_and_the_layer_sharded_count(ref_specs):
    """The reference's ``test_sharding_rules_subprocess`` counts the
    leaves whose first entry is 'model' at (2, 4) under train_4k; the
    port counts the same leaves, and the optimizer state follows the
    params with ``step`` replicated."""
    mesh = mesh_of((2, 4))
    for arch in ("deepseek_7b", "qwen3_moe_235b", "falcon_mamba_7b"):
        jr = jregistry.get_config(arch, "train_4k")
        tr = registry.get_config(arch, "train_4k")
        want = ref_flat(jparams.param_specs(jspecs.params_specs(jr), jr,
                                            mesh))
        params = tspecs.params_specs(tr)
        opt = {"step": 0, "m": params, "v": params}
        ps, os_, bs = steps.shardings_for_train(
            tr, mesh, params, opt, tspecs.train_batch_specs(tr))
        got = port_flat(ps)
        n = sum(1 for s in got.values() if len(s) and s[0] == "model")
        assert n == sum(1 for s in want.values()
                        if len(s) and s[0] == "model") and n >= 5, arch
        assert os_["step"] == () and os_["m"] is ps and os_["v"] is ps
        assert bs["tokens"][0] == "data"


def test_train_specs_and_shard_tree_execute_layers_and_batch_only():
    """The storage training executes: a trunk leaf's layer axis (where
    the chunks divide over 'model'), a batch's rows, an expert leaf's
    experts (qwen3-moe's over 'data', with its layers over 'model') and
    the tensor-parallel axes (a vocab over 'model' cut to this rank's
    rows); the router, whose experts dimension is never cut, is kept
    whole and listed (the fsdp dimension, executed too, is held in
    test_torch_mesh_fsdp.py; the heads, MLP and Mamba2 rows in
    test_torch_mesh_train.py)."""
    assert tparams.EXECUTED == ("layers", "batch", "experts", "fsdp",
                                "heads", "kv_heads", "mlp", "vocab")
    tr = registry.get_config("qwen3_1p7b")          # 32 mid layers, cf 2
    mesh = mesh_of((2, 4))
    mesh.index = {"data": 1, "model": 3}.get
    moe = registry.get_config("qwen3_moe_235b")     # 96 mid layers, cf 3
    mspecs = tparams.train_specs(tspecs.params_specs(moe), moe, mesh)
    mid = mspecs["mid"]["params"]["moe"]
    assert mid["w_in"] == mid["w_out"] == ("model", "data", None, None)
    assert mid["router"] == ("model", None, "data")
    assert mspecs["open"]["moe"]["w_gate"] == (None, "data", None, None)
    specs_t = {"mid": {"params": {"moe": {
        "w_in": ("model", "data", None, None),
        "router": ("model", None, "data")}}}}
    full_t = {"mid": {"params": {"moe": {
        "w_in": torch.arange(8 * 4 * 2.).reshape(8, 4, 2, 1),
        "router": torch.arange(8 * 2 * 4.).reshape(8, 2, 4)}}}}
    local, whole = tparams.shard_tree(full_t, specs_t, mesh)
    got = local["mid"]["params"]["moe"]
    assert torch.equal(got["w_in"], full_t["mid"]["params"]["moe"][
        "w_in"][6:8, 2:4])
    assert torch.equal(got["router"], full_t["mid"]["params"]["moe"][
        "router"][6:8])
    assert whole == [("mid", "params", "moe", "router")]
    assert tparams.expert_cut(full_t, specs_t, mesh) == {
        ("mid", "params", "moe", "w_in"): ("data",)}
    specs = tparams.train_specs(tspecs.params_specs(tr), tr, mesh)
    assert specs["mid"]["gate"] == ("model",)
    assert specs["embed"]["tok"] == ("model", None)
    full = {"mid": {"gate": torch.arange(32.)},
            "embed": {"tok": torch.zeros(8, 2)}}
    local, whole = tparams.shard_tree(
        full, {"mid": {"gate": ("model",)},
               "embed": {"tok": ("model", None)}}, mesh)
    assert local["mid"]["gate"].tolist() == list(range(24, 32))
    assert torch.equal(local["embed"]["tok"], full["embed"]["tok"][6:8])
    assert whole == []
    rows = np.arange(12).reshape(6, 2)
    assert tparams.local_slice(rows, ("tokens",), ("data", None),
                               mesh).tolist() == [[6, 7], [8, 9], [10, 11]]
    # 28 - 2 buffers = 26 layers unpadded: J = 13 chunks at cf 2 do not
    # divide over 4 ranks, so the trunk runs (and is stored) replicated
    odd = tr.replace(mgrit=dataclasses.replace(tr.mgrit, pad_to=2))
    assert tparams.train_specs(tspecs.params_specs(odd), odd,
                               mesh)["mid"]["gate"] == (None,)
    assert tsharding.chunk_axis(26, 2, tr.sharding, mesh) is None
    assert tsharding.chunk_axis(32, 2, tr.sharding, mesh) == "model"
    assert tsharding.chunk_axis(32, 2, tr.sharding, mesh,
                                shard_levels=0) is None


def test_logical_constraint_keeps_the_rank_check():
    x = torch.zeros(2, 3)
    assert tsharding.logical_constraint(x, ("batch",)) is x   # no rules
    with tsharding.axis_rules(mesh_of((2, 4)), ShardingConfig()):
        assert tsharding.logical_constraint(x, ("batch", None)) is x
        assert tsharding.current_rules()[1] == ShardingConfig()
        with pytest.raises(ValueError, match="rank 2"):
            tsharding.logical_constraint(x, ("batch",))
    assert tsharding.current_rules() == (None, None)
    sh = tsharding.tree_shardings(mesh_of((2, 4)),
                                  registry.train_sharding(),
                                  {"a": ("batch", None), "b": ("layers",)})
    assert sh["a"].spec == ("data", None) and sh["b"].spec == ("model",)


@pytest.mark.parametrize("n", [5000, 2048, 7])
def test_quantize_int8_is_bitwise_the_reference(n):
    rng = np.random.default_rng(n)
    x = (rng.standard_normal(n) * 3).astype(np.float32)
    x[:5] = [127.0, 0.5, -2.5, 1.5, 0.0]   # scale 1: ties round to even
    jq, js = jcomp.quantize_int8(jnp.asarray(x))
    tq, ts = tcomp.quantize_int8(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        tcomp.dequantize_int8(tq, ts, (n,)).numpy(),
        np.asarray(jcomp.dequantize_int8(jq, js, (n,))))


def test_compress_tree_error_feedback_within_an_ulp():
    rng = np.random.default_rng(1)
    shapes = {"a": (3, 1000), "b": {"c": (4097,)}}

    def draw():
        return {"a": rng.standard_normal(shapes["a"]).astype(np.float32),
                "b": {"c": rng.standard_normal(4097).astype(np.float32)}}
    g0 = draw()
    je = jcomp.init_error_state(jax.tree.map(jnp.asarray, g0))
    te = tcomp.init_error_state(
        {"a": torch.from_numpy(g0["a"]), "b": {"c": torch.from_numpy(
            g0["b"]["c"])}})
    for _ in range(5):
        g = draw()
        jg, je = jcomp.compress_tree(jax.tree.map(jnp.asarray, g), je)
        tg, te = tcomp.compress_tree(
            {"a": torch.from_numpy(g["a"]),
             "b": {"c": torch.from_numpy(g["b"]["c"])}}, te)
        ref = {"g": jg, "e": je}
        for path, got in leaves_with_paths({"g": tg, "e": te}):
            want = ref
            for k in path:
                want = want[k]
            want = np.asarray(want)
            ulp = np.spacing(np.abs(want).astype(np.float32))
            assert np.all(np.abs(got.numpy() - want) <= ulp), path


def test_mamba1_rows_split_raises_under_a_gradient():
    """A mamba1 mixer's rows cut over 'model' is serving's layout (no
    training rules map its mlp): under training rules that would cut
    them, the mixer raises where a gradient is to flow, before any
    collective (serving's no-grad steps are held in
    test_torch_mesh_serve.py and test_torch_mesh_dense.py)."""
    from repro_torch.configs.reduce import reduce_config
    from repro_torch.models import ssm, transformer
    rcfg = reduce_config(registry.get_config("falcon_mamba_7b"))
    cfg = dataclasses.replace(rcfg.model, dtype="float32")
    mesh = mesh_of((1, 2))
    mesh.index = {"data": 0, "model": 0}.get
    rules = ShardingConfig(batch="data", mlp="model", layers=None)
    mixer = {k: v[0] for k, v in transformer.init_model(
        rcfg, seed=0, device="cpu")["open"]["mixer"].items()}
    x = torch.zeros(1, 4, cfg.d_model, requires_grad=True)
    with tsharding.axis_rules(mesh, rules):
        assert ssm.inner_split(cfg) is not None
        with pytest.raises(NotImplementedError, match="serving layout"):
            ssm.mamba1_apply(mixer, x, cfg)
