"""Training launcher (port of :mod:`repro.launch.train`).

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3_1p7b \\
      --shape train_4k --steps 100 [--serial] [--reduced] [--device cpu] \\
      [--ckpt DIR --ckpt-every N]

Runs on the card unless ``--device cpu`` (use ``--reduced`` there).
``--ckpt DIR`` resumes from DIR's latest checkpoint when it has one and
saves every ``--ckpt-every`` steps (and an emergency checkpoint when a
step raises), in the JAX package's format. ``--mesh single|multi``
builds the production mesh ((16, 16) or (2, 16, 16) ranks) over the
group a launcher started (``torchrun``'s environment; one process a
card), as the reference builds it over its devices; with fewer ranks it
raises the reference's device-count error. ``--mesh host`` (default)
runs one process on one device. Under a mesh the config's own train
rules run as they are, ``fsdp`` included (granite_34b, grok1_314b and
qwen3_moe_235b store their big leaves one slice a 'data' rank); fsdp
cuts only leaves of 4M elements or more, which no ``--reduced`` width
reaches, so a ``--reduced`` run cuts nothing.
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

    from repro_torch.configs import registry
    from repro_torch.configs.reduce import reduce_config
    from repro_torch.train.trainer import Trainer

    rcfg = registry.get_config(args.arch, args.shape)
    if args.reduced:
        rcfg = reduce_config(rcfg)
    if args.serial:
        rcfg = dataclasses.replace(
            rcfg, mgrit=dataclasses.replace(rcfg.mgrit, enabled=False))

    mesh = None
    if args.mesh in ("single", "multi"):
        from repro_torch.device import resolve_device
        from repro_torch.launch.mesh import init_from_env, make_production_mesh
        dev = resolve_device(args.device).type
        init_from_env(dev)
        mesh = make_production_mesh(multi_pod=args.mesh == "multi",
                                    device_type=dev)
        if dev == "cuda":
            import torch
            args.device = f"cuda:{torch.cuda.current_device()}"

    trainer = Trainer(rcfg, mesh=mesh, ckpt_dir=args.ckpt, seed=args.seed,
                      data_path=args.data, device=args.device)
    if args.ckpt:
        print(f"checkpoints in {args.ckpt}: starting at step "
              f"{trainer.step}")
    report = trainer.train(args.steps, ckpt_every=args.ckpt_every,
                           log_every=10)
    print(f"done on {trainer.device}: {len(report.losses)} steps, "
          f"final loss {report.losses[-1]:.4f}, "
          f"{report.steps_per_sec:.2f} steps/s, "
          f"switched_at={report.switched_at}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
