"""One-card dry-run: every (arch x shape) cell's step function run once on
the meta device, its work counted. Port of :mod:`repro.launch.dryrun`,
which lowers and compiles each cell for a TPU pod mesh.

  PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch A]
      [--shape S] [--outdir DIR]

Each cell builds params, optimizer state and inputs on meta (shapes and
dtypes, no storage: :mod:`repro_torch.launch.specs`), runs the cell's
step function (``make_train_fn`` / ``make_prefill_fn`` /
``make_serve_fn``) once under ``FlopCounterMode`` (matmul flops), a
byte counter over every aten op and the kernels' own counts
(:class:`repro_torch.kernels.ops.KernelCounts`), and writes one JSON
record: the arguments' bytes (params + optimizer state + batch or
cache) and whether they fit the card's 80 GB — a lower bound on the
step's memory, since activations are not counted —, the counted flops
and bytes and the H100 roofline terms
(:func:`repro_torch.analysis.roofline.from_counts`). A step that reads a
value back to the host (``.item()``, ``float(tensor)``, ``.tolist()``)
raises on meta, so a cell that runs has none. Only the one-card mesh
(``h100x1``) exists; the pod meshes come with the multi-device slice.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.analysis import roofline as rl
from repro_torch.configs import registry
from repro_torch.configs.base import SHAPES
from repro_torch.kernels.ops import KernelCounts
from repro_torch.launch import specs as specs_mod
from repro_torch.launch import steps as steps_mod
from repro_torch.optim import optimizers
from repro_torch.tree import leaves_with_paths

OUTDIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                      "experiments", "dryrun_torch")
MESH = "h100x1"
MULTI_DEVICE = ("meshes beyond one card come with the port's multi-device "
                "slice (ROADMAP Queue 1)")

ASSIGNED = ("zamba2_1p2b", "deepseek_7b", "phi4_mini_3p8b", "qwen3_1p7b",
            "granite_34b", "qwen2_vl_7b", "grok1_314b", "qwen3_moe_235b",
            "seamless_m4t_v2", "falcon_mamba_7b")

_aten = torch.ops.aten
# ops that move no data: allocation without a write, and views the schema
# does not mark as such
_NO_TRAFFIC = {_aten.empty.memory_format, _aten.empty_like.default,
               _aten.empty_strided.default, _aten.new_empty.default,
               _aten.new_empty_strided.default, _aten._unsafe_view.default}
_WRITE_ONLY = {"copy_", "fill_", "zero_"}        # self written, not read
_SCATTER = {"index_copy_", "index_put_", "scatter_", "index_add_",
            "scatter_add_"}                       # self written where indexed


def _distinct_bytes(t: torch.Tensor) -> int:
    """Bytes of ``t``'s distinct elements (a broadcast axis counts once)."""
    n = 1
    for size, stride in zip(t.shape, t.stride(), strict=True):
        if stride != 0:
            n *= size
    return n * t.element_size() if t.numel() else 0


class ByteCounter(TorchDispatchMode):
    """Bytes read and written by every aten op on meta tensors, each input
    read and each output written once (views and bare allocations move
    nothing; ``copy_`` / ``fill_`` write their target without reading
    it; an indexed write writes as many elements as its source holds).
    ``host_numel`` is the largest non-meta tensor any op made (the
    schedule's 0-d host scalars): the no-allocation check reads it."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.ops = 0
        self.host_numel = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins = [t for t in pytree.tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        outs = [t for t in pytree.tree_leaves(out)
                if isinstance(t, torch.Tensor)]
        for t in outs:
            if not t.is_meta:
                self.host_numel = max(self.host_numel, t.numel())
        if func.is_view or func in _NO_TRAFFIC or \
                not any(t.is_meta for t in ins + outs):
            return out
        name = func.overloadpacket.__name__
        if name in _WRITE_ONLY:
            read, written = sum(map(_distinct_bytes, ins[1:])), \
                _distinct_bytes(ins[0])
        elif name in _SCATTER and len(ins) > 1:
            read = sum(map(_distinct_bytes, ins[1:]))
            written = ins[-1].numel() * ins[0].element_size()
        else:
            read = sum(map(_distinct_bytes, ins))
            written = sum(map(_distinct_bytes, outs))
        self.ops += 1
        self.bytes += read + written
        return out


def tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size()
               for _, t in leaves_with_paths(tree)
               if isinstance(t, torch.Tensor))


def _step(rcfg, batch=None):
    """(step function, its meta arguments, {name: bytes}, tokens)."""
    params = specs_mod.params_specs(rcfg)
    kind = rcfg.shape.kind
    B, S = rcfg.shape.global_batch, rcfg.shape.seq_len
    held = {"params": tree_bytes(params)}
    if kind == "train":
        batch = specs_mod.input_specs(rcfg) if batch is None else batch
        opt = optimizers.init_opt_state(rcfg.optimizer, params)
        held.update(opt_state=tree_bytes(opt), inputs=tree_bytes(batch))
        return steps_mod.make_train_fn(rcfg), (params, opt, batch), held, \
            B * S
    if kind == "prefill":
        batch = specs_mod.input_specs(rcfg)
        held["inputs"] = tree_bytes(batch)
        return steps_mod.make_prefill_fn(rcfg), (params, batch), held, B * S
    dec = specs_mod.input_specs(rcfg)
    held.update(cache=tree_bytes(dec[0]),
                inputs=sum(tree_bytes(x) for x in dec[1:]))
    return steps_mod.make_serve_fn(rcfg), (params, *dec), held, B


def count_step(rcfg, arch=None, shape=None, batch=None):
    """Run ``rcfg``'s step once on meta and count it. Returns the record
    (without the cell's status). ``batch``: a train step's meta batch in
    place of the spec's (a data pipeline's shapes and dtypes)."""
    t0 = time.perf_counter()
    fn, args, held, tokens = _step(rcfg, batch)
    with KernelCounts() as kc, ByteCounter() as bc, \
            FlopCounterMode(display=False) as fc:
        fn(*args)
    aten_flops = fc.get_total_flops()
    kernel_flops = kc.total("flops") + kc.total("f32_flops")
    nbytes = bc.bytes + kc.total("bytes")
    arg_bytes = sum(held.values())
    roof = rl.from_counts(
        arch or rcfg.model.name, shape or rcfg.shape.name, MESH, 1, rcfg,
        tokens, flops=aten_flops + kernel_flops, nbytes=nbytes,
        f32_flops=kc.total("f32_flops"), memory=arg_bytes,
        detail={"aten_flops": float(aten_flops),
                "aten_bytes": float(bc.bytes),
                "kernel_flops": float(kernel_flops),
                "kernel_bytes": float(kc.total("bytes"))})
    return {
        "mesh": MESH, "chips": 1,
        "run_s": round(time.perf_counter() - t0, 3),
        "argument_bytes": {**held, "total": arg_bytes},
        "fits": arg_bytes <= rl.HBM_BYTES,
        "memory_note": ("arguments only (params, optimizer state, batch "
                        "or cache): a lower bound on the step's memory; "
                        "activations are not counted"),
        "aten_ops": bc.ops, "host_numel": bc.host_numel,
        "kernels": kc.by_name,
        "roofline": json.loads(roof.to_json()),
    }


def one_card(mesh: str):
    """Refuse every mesh but the one card's."""
    if mesh != MESH:
        raise NotImplementedError(f"mesh {mesh!r}: {MULTI_DEVICE}")


def run_cell(arch: str, shape: str, mesh: str = MESH, verbose: bool = True,
             mutate=None):
    one_card(mesh)
    skip = registry.shape_supported(arch, shape)
    if skip:
        return {"arch": arch, "shape": shape, "mesh": mesh,
                "status": "skip", "reason": skip}
    rcfg = registry.get_config(arch, shape)
    if mutate is not None:
        rcfg = mutate(rcfg)
    rec = {"arch": arch, "shape": shape, "status": "ok",
           **count_step(rcfg, arch, shape)}
    if verbose:
        roof = rec["roofline"]
        print(f"[{arch} x {shape} x {mesh}] counted in {rec['run_s']} s: "
              f"arguments {rec['argument_bytes']['total'] / 1e9:.2f} GB "
              f"({'fit' if rec['fits'] else 'do not fit'} 80 GB); flops "
              f"{roof['hlo_flops']:.3e} (model {roof['model_flops']:.3e}),"
              f" bytes {roof['hlo_bytes']:.3e}; terms (ms) compute="
              f"{roof['t_compute'] * 1e3:.2f} memory="
              f"{roof['t_memory'] * 1e3:.2f} -> {roof['bottleneck']}")
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default=MESH)
    ap.add_argument("--outdir", default=OUTDIR)
    args = ap.parse_args(argv)
    one_card(args.mesh)

    archs = ASSIGNED if args.arch == "all" else [args.arch]
    shapes = [s.name for s in SHAPES] if args.shape == "all" else [args.shape]
    os.makedirs(args.outdir, exist_ok=True)
    failures = []
    for arch in archs:
        for shape in shapes:
            tag = f"{arch}__{shape}__{MESH}"
            try:
                rec = run_cell(arch, shape)
            except Exception as e:  # a failure here is a bug in the port
                traceback.print_exc()
                rec = {"arch": arch, "shape": shape, "mesh": MESH,
                       "status": "FAIL", "error": repr(e)}
                failures.append(tag)
            with open(os.path.join(args.outdir, tag + ".json"), "w") as f:
                json.dump(rec, f, indent=1)
    if failures:
        print("FAILURES:", failures)
        return 1
    print("dry-run: all requested cells counted")
    return 0


if __name__ == "__main__":
    sys.exit(main())
