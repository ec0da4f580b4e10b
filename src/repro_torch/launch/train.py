"""Training launcher (port of :mod:`repro.launch.train`).

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3_1p7b \\
      --shape train_4k --steps 100 [--serial] [--reduced] [--device cpu]

Runs on the card unless ``--device cpu`` (use ``--reduced`` there).
``--mesh single|multi`` (production meshes) and ``--ckpt`` raise: meshes
and checkpoints come in later slices of the port.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--mesh", choices=["host", "single", "multi"],
                    default="host")
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--serial", action="store_true",
                    help="disable layer-parallel (exact serial baseline)")
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-scale config (CPU-friendly)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--data", default="", help="memmap token file")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    if args.mesh != "host":
        raise SystemExit(f"--mesh {args.mesh}: meshes come with the port's "
                         "multi-device slice (ROADMAP Queue 1); use "
                         "--mesh host (one device)")

    from repro_torch.configs import registry
    from repro_torch.configs.reduce import reduce_config
    from repro_torch.train.trainer import Trainer

    rcfg = registry.get_config(args.arch, args.shape)
    if args.reduced:
        rcfg = reduce_config(rcfg)
    if args.serial:
        rcfg = dataclasses.replace(
            rcfg, mgrit=dataclasses.replace(rcfg.mgrit, enabled=False))

    trainer = Trainer(rcfg, ckpt_dir=args.ckpt, seed=args.seed,
                      data_path=args.data, device=args.device)
    report = trainer.train(args.steps, ckpt_every=args.ckpt_every,
                           log_every=10)
    print(f"done on {trainer.device}: {len(report.losses)} steps, "
          f"final loss {report.losses[-1]:.4f}, "
          f"{report.steps_per_sec:.2f} steps/s, "
          f"switched_at={report.switched_at}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
