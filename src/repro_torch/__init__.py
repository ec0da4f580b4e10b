"""PyTorch + CUDA port of :mod:`repro` for one NVIDIA Hopper card.

The layout mirrors ``src/repro/`` module for module
(``repro_torch/models/attention.py`` ports ``repro/models/attention.py``).
The package imports torch, numpy and the stdlib only: never jax and
nothing of ``repro`` (it keeps its own copies of the jax-free modules).
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
see :func:`repro_torch.device.resolve_device`.
"""
