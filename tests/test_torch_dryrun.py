"""The one-card dry-run tools of the port against the JAX package's, on
the CPU: input and param specs (shapes and dtypes by key path), the
roofline's model flops, the dry-run of reduced cells on the meta device
(no storage allocated), each kernel's counted flops and bytes against
its cost formula, a serial step's counted flops against its closed form,
and the perf variants.
"""
import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from repro.analysis import roofline as j_roofline
from repro.configs import registry as j_registry
from repro.configs.base import SHAPES as J_SHAPES
from repro.configs.reduce import reduce_config as j_reduce
from repro.launch import specs as j_specs
from repro_torch.analysis import roofline as t_roofline
from repro_torch.configs import registry as t_registry
from repro_torch.configs.base import ShapeConfig as TShape
from repro_torch.configs.reduce import reduce_config as t_reduce
from repro_torch.kernels import ops
from repro_torch.launch import dryrun, perf
from repro_torch.launch import specs as t_specs
from repro_torch.tree import leaves_with_paths

torch.set_num_threads(2)
META = "meta"
SPEC_ARCHS = ("qwen3_1p7b", "seamless_m4t_v2", "qwen2_vl_7b",
              "falcon_mamba_7b", "zamba2_1p2b")


def both_configs(arch, kind, S, B):
    """The reduced config of ``arch`` for both packages at a shape of
    ``kind`` with S x B."""
    def one(get, reduce, shape_cls):
        rcfg = reduce(get(arch))
        return dataclasses.replace(rcfg, shape=shape_cls("t", kind, S, B))
    from repro.configs.base import ShapeConfig as JShape
    return (one(j_registry.get_config, j_reduce, JShape),
            one(t_registry.get_config, t_reduce, TShape))


def j_leaves(tree):
    """{key path: (shape, dtype name)} of a tree of ShapeDtypeStructs."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {tuple(getattr(k, "key", getattr(k, "idx", None)) for k in p):
            (tuple(a.shape), np.dtype(a.dtype).name) for p, a in flat}


def t_leaves(tree, prefix=()):
    """The same of a port tree of meta tensors (tuples indexed)."""
    if isinstance(tree, (tuple, list)):
        out = {}
        for i, x in enumerate(tree):
            out.update(t_leaves(x, prefix + (i,)))
        return out
    return {prefix + p: (tuple(t.shape), str(t.dtype).split(".")[1])
            for p, t in leaves_with_paths(tree)}


def assert_all_meta(tree):
    for _, t in leaves_with_paths(tree if not isinstance(tree, tuple)
                                  else dict(enumerate(tree))):
        assert t.is_meta


# ---------------------------------------------------------------------------
# specs and params
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", SPEC_ARCHS)
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_input_specs_match_jax(arch, kind):
    jr, tr = both_configs(arch, kind, 320, 2)
    want = j_leaves(j_specs.input_specs(jr))
    got_tree = t_specs.input_specs(tr)
    assert_all_meta(got_tree)
    assert t_leaves(got_tree) == want


@pytest.mark.parametrize("arch", t_registry.ARCH_IDS)
def test_params_specs_match_jax(arch):
    jr, tr = both_configs(arch, "train", 16, 2)
    got = t_specs.params_specs(tr)
    assert_all_meta(got)
    assert t_leaves(got) == j_leaves(j_specs.params_specs(jr))


def test_params_specs_full_width_match_jax():
    jr = j_registry.get_config("qwen3_1p7b")
    tr = t_registry.get_config("qwen3_1p7b")
    assert t_leaves(t_specs.params_specs(tr)) == \
        j_leaves(j_specs.params_specs(jr))


def test_mm_tokens_match_the_reference():
    from repro.configs.qwen2_vl_7b import MM_TOKENS as J_MM
    assert t_specs.MM_TOKENS == J_MM


@pytest.mark.parametrize("shape", [s.name for s in J_SHAPES])
def test_model_flops_match_jax(shape):
    for arch in t_registry.ARCH_IDS:
        jr = j_registry.get_config(arch, shape)
        tr = t_registry.get_config(arch, shape)
        tokens = 12345
        assert t_roofline.model_flops_train(tr, tokens) == \
            j_roofline.model_flops_train(jr, tokens), arch


# ---------------------------------------------------------------------------
# The dry-run on meta
# ---------------------------------------------------------------------------


def reduced(kind):
    """A mutate for ``run_cell``: the reduced config at a small shape of
    the cell's kind (decode keeps its kind, its cache 64 long)."""
    def mutate(rcfg):
        r = t_reduce(rcfg)
        S = 64 if kind == "decode" else 32
        return dataclasses.replace(r, shape=TShape("t", kind, S, 2))
    return mutate


@pytest.mark.parametrize("arch,kernels", [
    ("qwen3_1p7b", {"flash_attention_fwd", "rmsnorm_fwd"}),
    ("falcon_mamba_7b", {"ssm_scan_fwd", "rmsnorm_fwd"}),
    ("qwen3_moe_235b", {"flash_attention_fwd", "rmsnorm_fwd"}),
    ("seamless_m4t_v2", {"flash_attention_fwd"})])
@pytest.mark.parametrize("shape,kind", [("train_4k", "train"),
                                        ("decode_32k", "decode")])
def test_dryrun_reduced_cells_allocate_nothing(arch, kernels, shape, kind):
    rec = dryrun.run_cell(arch, shape, verbose=False, mutate=reduced(kind))
    assert rec["status"] == "ok" and rec["mesh"] == "h100x1"
    # no op made a tensor off meta but the schedule's 0-d host scalars
    assert rec["host_numel"] <= 1
    roof = rec["roofline"]
    assert roof["hlo_flops"] > 0 and roof["hlo_bytes"] > 0
    assert roof["t_collective"] == 0.0 and roof["bottleneck"] in (
        "compute", "memory")
    held = rec["argument_bytes"]
    assert held["total"] == sum(v for k, v in held.items() if k != "total")
    assert rec["fits"]
    if kind == "train":
        assert kernels <= set(rec["kernels"])
        if "flash_attention_fwd" in kernels:
            assert rec["kernels"]["flash_attention_bwd"]["calls"] > 0
    else:
        want = {"falcon_mamba_7b": "paged_ssm_update"}.get(
            arch, "paged_flash_attention")
        assert rec["kernels"][want]["calls"] > 0


def test_meta_is_explicit_and_the_runtimes_refuse_it():
    """``meta`` is an explicit device (the dry-run's); the Trainer and the
    serve engine read numbers back and refuse it."""
    from repro_torch.device import resolve_device
    from repro_torch.models import transformer
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.train.trainer import Trainer
    assert resolve_device("meta").type == "meta"
    rcfg = t_reduce(t_registry.get_config("qwen3_1p7b"))
    with pytest.raises(ValueError, match="not meta"):
        Trainer(rcfg, device="meta")
    params = transformer.param_shapes(rcfg)
    with pytest.raises(ValueError, match="not meta"):
        ServeEngine(rcfg, params, device="meta")


def test_dryrun_cli_writes_one_record_per_cell(tmp_path):
    """A full-size cell (zamba2's 512k-token decode, on meta) and a
    skipped one."""
    out = tmp_path / "dr"
    for arch, shape in (("zamba2_1p2b", "long_500k"),
                        ("bert128", "decode_32k")):
        assert dryrun.main(["--arch", arch, "--shape", shape,
                            "--outdir", str(out)]) == 0
    assert sorted(os.listdir(out)) == ["bert128__decode_32k__h100x1.json",
                                       "zamba2_1p2b__long_500k__h100x1.json"]
    rec = json.loads((out / "bert128__decode_32k__h100x1.json").read_text())
    assert rec["status"] == "skip" and "encoder-only" in rec["reason"]
    rec = json.loads((out / "zamba2_1p2b__long_500k__h100x1.json")
                     .read_text())
    assert rec["status"] == "ok" and rec["host_numel"] == 0
    assert rec["kernels"]["paged_ssm_update"]["calls"] == 38
    assert rec["kernels"]["paged_flash_attention"]["calls"] == 6


def test_dryrun_refuses_meshes_beyond_one_card():
    with pytest.raises(NotImplementedError, match="multi-device slice"):
        dryrun.main(["--mesh", "multi"])
    with pytest.raises(NotImplementedError, match="multi-device slice"):
        dryrun.run_cell("qwen3_1p7b", "train_4k", mesh="pod16x16")
    with pytest.raises(NotImplementedError, match="multi-device slice"):
        perf.main(["--arch", "qwen3_1p7b", "--variant", "baseline",
                   "--mesh", "single"])


# ---------------------------------------------------------------------------
# Kernel costs: the formulas of PERF.md's Bound column, written out
# ---------------------------------------------------------------------------


def chip_smoke():
    """``chip_smoke.py`` as a module (imported, never run on the card
    here)."""
    import importlib.util
    path = os.path.join(os.path.dirname(__file__), "..", "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke_t", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def meta(*shape, dtype=torch.bfloat16, grad=False):
    return torch.empty(shape, dtype=dtype, device=META,
                       requires_grad=grad)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("Sq,Sk,H,Hkv", [(64, 64, 4, 2), (17, 40, 6, 6),
                                         (40, 17, 4, 1)])
def test_flash_counts_match_formula(causal, Sq, Sk, H, Hkv):
    B, hd = 2, 32
    q, k, v = (meta(B, Sq, H, hd, grad=True), meta(B, Sk, Hkv, hd, grad=True),
               meta(B, Sk, Hkv, hd, grad=True))
    with ops.KernelCounts() as kc:
        o = ops.flash_attention(q, k, v, causal=causal)
        assert o.shape == q.shape and o.dtype == q.dtype and o.is_meta
        dq, dk, dv = torch.autograd.grad(o, (q, k, v), torch.empty_like(o))
    assert dq.shape == q.shape and dk.shape == k.shape
    pairs = sum(min(i + 1, Sk) for i in range(Sq)) if causal else Sq * Sk
    n_q, n_kv, lse = B * Sq * H * hd * 2, 2 * B * Sk * Hkv * hd * 2, \
        B * H * Sq * 4
    assert kc.by_name["flash_attention_fwd"] == {
        "calls": 1, "flops": 4 * hd * pairs * B * H, "f32_flops": 0,
        "bytes": 2 * n_q + n_kv + lse}
    assert kc.by_name["flash_attention_bwd"] == {
        "calls": 1, "flops": 10 * hd * pairs * B * H, "f32_flops": 0,
        "bytes": 4 * n_q + 2 * n_kv + lse}


def test_rmsnorm_counts_match_formula():
    x, w = meta(3, 5, 64, grad=True), meta(64, dtype=torch.float32,
                                           grad=True)
    with ops.KernelCounts() as kc:
        y = ops.rmsnorm(x, w)
        y.sum().backward()
    R, D = 15, 64
    assert x.grad.shape == x.shape and w.grad.shape == w.shape
    assert kc.by_name["rmsnorm_fwd"]["bytes"] == 2 * R * D * 2 + D * 4 + R * 4
    assert kc.by_name["rmsnorm_bwd"]["bytes"] == \
        3 * R * D * 2 + R * 4 + 2 * D * 4
    assert kc.total("flops") == kc.total("f32_flops") == 0


@pytest.mark.parametrize("broadcast_A", [False, True])
def test_scan_counts_match_formula(broadcast_A):
    """mamba1's rows (dt, A and D a value a row, A one a state element)
    and mamba2's (heads of 4 rows: dt, D and the stride-0 decay one value
    a head, repeated), dt, A and D counted at their distinct values."""
    Bb, S, di, ds = 2, 50, 24, 8
    heads = di // 4 if broadcast_A else None
    f32 = torch.float32
    A = meta(di, 1, dtype=f32, grad=True).expand(di, ds) if broadcast_A \
        else meta(di, ds, dtype=f32, grad=True)
    ins = [meta(Bb, S, di, dtype=f32, grad=True),
           meta(Bb, S, di, dtype=f32, grad=True), A,
           meta(Bb, S, ds, dtype=f32, grad=True),
           meta(Bb, S, ds, dtype=f32, grad=True),
           meta(di, dtype=f32, grad=True)]
    with ops.KernelCounts() as kc:
        y = ops.ssm_scan(*ins, heads=heads)
        grads = torch.autograd.grad(y, ins, torch.empty_like(y))
    assert [g.shape for g in grads] == [t.shape for t in ins]
    n_ch = heads or di
    n_decay = heads or di * ds
    ins_b = Bb * S * (di + n_ch) * 4 + 2 * Bb * S * ds * 4 + n_decay * 4 \
        + n_ch * 4
    x = Bb * S * di * 4
    assert kc.by_name["ssm_scan_fwd"] == {
        "calls": 1, "flops": 0, "bytes": ins_b + x,
        "f32_flops": Bb * S * (5 * di * ds + 2 * n_decay)}
    assert kc.by_name["ssm_scan_bwd"] == {
        "calls": 1, "flops": 0, "bytes": 2 * ins_b + x,
        "f32_flops": Bb * S * (18 * di * ds + 2 * n_decay)}


def test_zamba2_scan_count_is_the_bound_columns():
    """A full-width zamba2 mamba2 mixer on meta counts its scan as
    chip_smoke.py's ``scan_bound_ms("zamba2", S)`` does: dt, A and D
    one value a head."""
    from repro_torch.analysis.roofline import bound_ms
    from repro_torch.kernels import ssm_scan as ss
    from repro_torch.models import ssm
    cs = chip_smoke()
    cfg = t_registry.get_config("zamba2_1p2b").model
    Bb, R, ds, hd = cs.SCAN_ROWS["zamba2"]
    S = 4096
    params = ssm.init_mamba2(None, cfg, device=torch.device("meta"))
    x = meta(Bb, S, cfg.d_model)
    with ops.KernelCounts() as kc:
        ssm.mamba2_apply(params, x, cfg)
    want = ss.cost(Bb, S, R, ds, n_ch=R // hd, n_decay=R // hd)
    row = kc.by_name["ssm_scan_fwd"]
    assert (row["f32_flops"], row["bytes"]) == want
    assert bound_ms(*want, cs.PEAK_F32_FLOP_S) == cs.scan_bound_ms("zamba2", S)


def test_paged_kernel_counts_match_formula():
    """The serve kernels on meta: lengths are unknown, so every slot
    counts its table full (P pages of context less the S new rows)."""
    B, S, H, Hkv, hd, page, P = 3, 2, 8, 2, 16, 4, 5
    q = meta(B, S, H, hd)
    pool = meta(11, page, Hkv, hd)
    table = meta(B, P, dtype=torch.int32)
    lengths = meta(B, dtype=torch.int32)
    R, ds, W = 12, 4, 3
    f32 = torch.float32
    with ops.KernelCounts() as kc:
        out = ops.paged_attention(q, pool, pool, table, lengths)
        y = ops.paged_ssm_update(
            meta(B, S, R, dtype=f32), meta(B, S, R, dtype=f32),
            meta(B, S, ds, dtype=f32), meta(B, S, ds, dtype=f32),
            meta(R, ds, dtype=f32), meta(9, R, ds, dtype=f32),
            meta(B, dtype=torch.long), meta(B, dtype=torch.long),
            meta(B, W, dtype=torch.long), meta(B, W, dtype=torch.long),
            meta(B, dtype=torch.long), order="dbx")
        m = ops.topk_topp_mask(meta(B, 100, dtype=f32),
                               meta(B, dtype=torch.int32), meta(B, dtype=f32))
    assert out.shape == q.shape and y.shape == (B, S, R) and m.shape == \
        (B, 100)
    ctx = P * page - S
    pairs = B * (ctx * S + S * (S + 1) // 2)
    keys = B * (ctx + S)
    assert kc.by_name["paged_flash_attention"] == {
        "calls": 1, "flops": 4 * hd * H * pairs, "f32_flops": 0,
        "bytes": 2 * B * S * H * hd * 2 + 2 * keys * Hkv * hd * 2
        + B * P * 4 + B * 4}
    steps = B * S
    assert kc.by_name["paged_ssm_update"] == {
        "calls": 1, "flops": 0, "f32_flops": 7 * steps * R * ds,
        "bytes": 2 * steps * R * 4 + B * S * R * 4 + 2 * B * S * ds * 4
        + R * ds * 4 + (B + B * W) * R * ds * 4 + B * (3 + 2 * W) * 4}
    assert kc.by_name["topk_topp_mask"] == {
        "calls": 1, "flops": 0, "f32_flops": 0,
        "bytes": 2 * B * 100 * 4 + B * 8}


def test_serial_step_flops_match_closed_form():
    """A serial step of reduced qwen3_1p7b (tied embeddings off, no
    gate-0 layer: 1 open + 8 ParallelNet + 1 close) counts exactly the
    closed form 6·N·D + attention's S² term, corrected by three terms
    the code explains: (1) the input embedding's V·d of N does no
    matmul (a lookup); (2) the ParallelNet is the paper's adjoint with
    an exact serial solve, so each of its layers runs F three times (the
    forward solve, the adjoint's VJP, the parameter VJP) and two
    backwards (dz only, then dtheta and dz): 12·P·D a layer where plain
    autograd spends 6·P·D; (3) the flash backward recomputes q.k: 10
    flops a pair per hd where the textbook counts 8. With these the
    tolerance is 0."""
    rcfg = t_reduce(t_registry.get_config("qwen3_1p7b"), seq=64, batch=2)
    rcfg = rcfg.replace(mgrit=dataclasses.replace(rcfg.mgrit,
                                                  enabled=False))
    cfg, mg = rcfg.model, rcfg.mgrit
    rec = dryrun.count_step(rcfg)
    B, S = 2, 64
    D = B * S
    N = cfg.active_param_count()
    V, d, H, hd = cfg.vocab_size, cfg.d_model, cfg.n_heads, \
        cfg.resolved_head_dim
    L = cfg.n_layers
    n_mid = L - mg.n_open - mg.n_close
    P = (N - 2 * V * d) // L                   # matmul params a layer
    pairs = S * (S + 1) // 2
    closed = 6 * N * D + 12 * hd * pairs * B * H * L
    attn_one = hd * pairs * B * H
    counted = rec["roofline"]["hlo_flops"]
    explained = (closed - 6 * V * d * D + 6 * n_mid * P * D
                 + 2 * attn_one * (L - n_mid) + (32 - 12) * attn_one * n_mid)
    assert counted == explained
    assert 1.0 < counted / closed < 2.0


# ---------------------------------------------------------------------------
# perf variants
# ---------------------------------------------------------------------------


def j_apply_variant():
    """The reference's ``apply_variant``. Importing ``repro.launch.perf``
    appends a 512-device flag to XLA_FLAGS; the backend is started first
    (so the flag cannot take effect) and the variable restored."""
    jax.devices()
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import perf as j_perf
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return j_perf.apply_variant


@pytest.mark.parametrize("arch,variant", [
    ("qwen3_1p7b", "baseline"), ("phi4_mini_3p8b", "cf8+iters2x2"),
    ("qwen3_1p7b", "bf16params"), ("qwen3_moe_235b", "moegroup"),
    ("qwen3_1p7b", "cf4"), ("qwen3_1p7b", "mb2"),
    ("qwen3_1p7b", "iters3x2"), ("grok1_314b", "moegroup+bf16params+cf8")])
def test_apply_variant_matches_reference(arch, variant):
    j = j_apply_variant()(j_registry.get_config(arch), variant)
    t = perf.apply_variant(t_registry.get_config(arch), variant)
    assert t.microbatches == j.microbatches
    for name in ("attn_chunk", "param_dtype"):
        assert getattr(t.model, name) == getattr(j.model, name)
    for name in ("cf", "fwd_iters", "bwd_iters"):
        assert getattr(t.mgrit, name) == getattr(j.mgrit, name)
    if j.model.moe is not None:
        assert t.model.moe.group_size == j.model.moe.group_size


def test_apply_variant_refuses_mesh_settings():
    with pytest.raises(NotImplementedError, match="multi-device slice"):
        perf.apply_variant(t_registry.get_config("qwen3_1p7b"), "shardl1")


def test_apply_variant_refuses_flashattn():
    """``attn_chunk`` selects a branch of the CPU path only: the dry-run
    counts the flash kernel either way, so the variant is refused."""
    with pytest.raises(ValueError, match="flash kernel"):
        perf.apply_variant(t_registry.get_config("qwen3_1p7b"),
                           "baseline+flashattn")


# ---------------------------------------------------------------------------
# chip_smoke.py's Bound column reads the same cost functions
# ---------------------------------------------------------------------------


def test_chip_smoke_bounds_are_the_cost_functions():
    """chip_smoke.py's bound functions, which read ``kernels/*.cost``
    and ``analysis/roofline.py``'s peaks, give the same floats as the
    Bound column's formulas written out: the flash backward's bytes each
    input and output once (q, o, dO, dq; k, v, dk, dv; the lse)."""
    cs = chip_smoke()
    HBM, BF16, F32 = 3.35e12, 989e12, 67e12
    assert (cs.PEAK_BYTES_S, cs.PEAK_BF16_FLOP_S, cs.PEAK_F32_FLOP_S) == \
        (HBM, BF16, F32)

    def bound(nbytes, ops, peak):
        t_b, t_o = nbytes / HBM, ops / peak
        return 1e3 * max(t_b, t_o), "bytes" if t_b >= t_o else "operations"

    for B, h, hkv, S, hd in ((2, 16, 8, 4096, 128), (1, 32, 32, 4096, 64),
                             (32, 12, 12, 224, 64)):
        for bw in (False, True):
            for causal in (True, False):
                pairs = S * (S + 1) // 2 if causal else S * S
                n_q, n_kv = B * S * h * hd * 2, 2 * B * S * hkv * hd * 2
                lse = B * h * S * 4
                nbytes = (4 * n_q + 2 * n_kv + lse) if bw else \
                    (2 * n_q + n_kv + lse)
                want = bound(nbytes, (10 if bw else 4) * hd * pairs * B * h,
                             BF16)
                assert cs.flash_bound_ms(B, h, hkv, S, hd, 2, backward=bw,
                                         causal=causal) == want
    for fam, (Bb, R, ds, hd) in cs.SCAN_ROWS.items():
        for bw in (False, True):
            S = 4096
            n_ch = R // hd if hd else R
            n_decay = R // hd if hd else R * ds
            x, dt, bc = Bb * S * R * 4, Bb * S * n_ch * 4, 2 * Bb * S * ds * 4
            ins = dt + x + bc + n_decay * 4 + n_ch * 4
            ops_ = Bb * S * ((18 if bw else 5) * R * ds + 2 * n_decay)
            want = bound(2 * ins + x if bw else ins + x, ops_, F32)
            assert cs.scan_bound_ms(fam, S, bw) == want
    for lengths, S, P in (([287, 301, 150, 64], 1, 32),
                          ([0, 37, 100, 200], 256, 32), ([300] * 4, 1, 1)):
        B = len(lengths)
        keys = sum(x + S for x in lengths)
        nbytes = (2 * B * S * cs.H * cs.HD * 2 + 2 * keys * cs.HKV * cs.HD * 2
                  + B * P * 4 + B * 4)
        pairs = sum(x + i + 1 for x in lengths for i in range(S))
        want = bound(nbytes, 4 * cs.HD * cs.H * pairs, BF16)
        assert cs.attn_bound_ms(B, S, lengths, P, 2) == want
    phys = np.array([[3, 0, 5], [0, 0, 0], [7, 8, 0], [1, 2, 3]])
    for order, (R, ds) in cs.SSM_ROWS.items():
        for S, lengths, n_new in cs.SSM_CASES:
            steps = sum(min(S, n) for n in n_new)
            live = sum(1 for n in lengths if n > 0)
            written, W = int((phys != 0).sum()), phys.shape[1]
            a_bytes = R * ds * 4 if order == "dbx" else R * 4
            nbytes = (2 * steps * R * 4 + 4 * S * R * 4 + 2 * 4 * S * ds * 4
                      + a_bytes + (live + written) * R * ds * 4
                      + 4 * (3 + 2 * W) * 4)
            want = bound(nbytes, 7 * steps * R * ds, F32)
            assert cs.ssm_bound_ms(order, S, lengths, n_new,
                                   (None, None, phys)) == want


def test_perf_cli_writes_the_variant_record(tmp_path):
    assert perf.main(["--arch", "zamba2_1p2b", "--shape", "long_500k",
                      "--variant", "baseline+mb2", "--outdir",
                      str(tmp_path)]) == 0
    rec = json.loads((tmp_path / "zamba2_1p2b__long_500k__baseline_mb2.json")
                     .read_text())
    assert rec["status"] == "ok" and rec["variant"] == "baseline+mb2"
