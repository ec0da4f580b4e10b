"""Perf variants over the one-card dry-run (port of
:mod:`repro.launch.perf`): count one (arch, shape) cell under a named
optimization variant and record its roofline terms beside the
paper-faithful baseline's. Variants compose via --variant a+b+c.

  PYTHONPATH=src python -m repro_torch.launch.perf --arch qwen3_1p7b \\
      --shape train_4k --variant bf16params+mb2

  baseline    the paper-faithful configuration (as in configs/<arch>.py)
  bf16params  bf16 stored params + fp32 master in the optimizer
  moegroup    GShard dispatch groups of 512 tokens
  cf<k>       override the MGRIT coarsening factor
  mb<k>       gradient-accumulation microbatches
  iters<f>x<b>  MGRIT forward / backward iterations

Two of the reference's variants raise: ``flashattn`` (chunked attention
from 2k seq, ``attn_chunk``) selects a branch of the CPU path only, and
the card and the dry-run always run the flash kernel, so it would count
the baseline again; ``shardl1`` (shard the first coarse MGRIT level) is
a mesh setting, as is ``--mesh`` beyond one card (see
:func:`repro_torch.launch.dryrun.one_card`).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

from repro_torch.launch import dryrun

OUTDIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                      "experiments", "perf_torch")


def apply_variant(rcfg, name: str):
    for part in name.split("+"):
        if part == "baseline":
            continue
        elif part == "flashattn":
            raise ValueError(
                "flashattn sets attn_chunk, which only the CPU path reads: "
                "the card and the dry-run always run the flash kernel")
        elif part == "bf16params":
            rcfg = dataclasses.replace(
                rcfg, model=dataclasses.replace(rcfg.model,
                                                param_dtype="bfloat16"))
        elif part == "moegroup":
            if rcfg.model.moe is None:
                raise ValueError("moegroup: the model has no MoE layers")
            rcfg = dataclasses.replace(
                rcfg, model=dataclasses.replace(
                    rcfg.model, moe=dataclasses.replace(
                        rcfg.model.moe, group_size=512)))
        elif part == "shardl1":
            raise NotImplementedError(
                f"shardl1 shards an MGRIT level over a mesh: "
                f"{dryrun.MULTI_DEVICE}")
        elif part.startswith("cf"):
            rcfg = dataclasses.replace(
                rcfg, mgrit=dataclasses.replace(rcfg.mgrit,
                                                cf=int(part[2:])))
        elif part.startswith("mb"):
            rcfg = dataclasses.replace(rcfg, microbatches=int(part[2:]))
        elif part.startswith("iters"):
            f, b = part[5:].split("x")
            rcfg = dataclasses.replace(
                rcfg, mgrit=dataclasses.replace(
                    rcfg.mgrit, fwd_iters=int(f), bwd_iters=int(b)))
        else:
            raise ValueError(f"unknown variant {part}")
    return rcfg


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--variant", required=True)
    ap.add_argument("--mesh", default=dryrun.MESH)
    ap.add_argument("--outdir", default=OUTDIR)
    args = ap.parse_args(argv)

    rec = dryrun.run_cell(args.arch, args.shape, args.mesh,
                          mutate=lambda r: apply_variant(r, args.variant))
    rec["variant"] = args.variant
    os.makedirs(args.outdir, exist_ok=True)
    tag = f"{args.arch}__{args.shape}__{args.variant.replace('+', '_')}"
    with open(os.path.join(args.outdir, tag + ".json"), "w") as f:
        json.dump(rec, f, indent=1)
    print("wrote", tag, rec["status"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
