"""Device resolution shared by every entry point of the port.

Entry points (``ServeEngine``, ``Trainer``, ``init_model``, the serve
and train CLIs) run on ``cuda`` unless the caller asks for the CPU.
Without a CUDA device they raise instead of carrying on on the CPU: a
run that silently left the card would report CPU numbers under a GPU's
name. ``"meta"`` (shapes and dtypes, no storage) is an explicit choice
too, for the dry-run (:mod:`repro_torch.launch.dryrun`); the ``Trainer``
and the serve engine refuse it, since they read numbers back.
"""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) \
        -> torch.device:
    """``None`` means ``cuda``. A CUDA device that is not available
    raises ``RuntimeError``; ``"cpu"`` and ``"meta"`` are only ever
    explicit choices."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU explicitly")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev}")
    return dev
