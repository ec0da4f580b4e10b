"""Weight conversion from the JAX package's params pytree.

The port keeps its parameters as stacked tensors (layer axis first)
under the JAX pytree's key paths, so conversion is a 1:1 mapping. The
caller turns the JAX tree into numpy first (``jax.tree.map(np.asarray,
params)``); this module never imports jax.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from repro_torch.configs.base import RunConfig
from repro_torch.models import transformer


def _leaf(a: np.ndarray, device, dtype: Optional[torch.dtype]):
    a = np.array(a)                  # a writable copy torch can own
    if a.dtype.name == "bfloat16":            # ml_dtypes' bfloat16 numpy
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device=device, dtype=dtype or t.dtype)


def params_from_jax(np_tree, rcfg: RunConfig, device,
                    dtype: Optional[torch.dtype] = None):
    """The port's params from the JAX ``transformer.init_model`` tree as
    numpy arrays. Key paths and shapes are checked against the port's own
    init (:func:`transformer.param_shapes`); a mismatch raises
    ``ValueError`` naming the path. ``dtype`` (default: keep each leaf's
    dtype) casts every leaf."""
    expect = transformer.param_shapes(rcfg)

    def walk(src: Any, ref: Any, path: str):
        if ref is None:
            if src is not None:
                raise ValueError(f"{path}: unexpected subtree")
            return None
        if isinstance(ref, dict):
            if not isinstance(src, dict) or set(src) != set(ref):
                got = sorted(src) if isinstance(src, dict) else type(src)
                raise ValueError(f"{path or '<root>'}: keys {got} != "
                                 f"{sorted(ref)}")
            return {k: walk(src[k], ref[k], f"{path}.{k}".lstrip("."))
                    for k in ref}
        if tuple(np.shape(src)) != tuple(ref.shape):
            raise ValueError(f"{path}: shape {tuple(np.shape(src))} != "
                             f"{tuple(ref.shape)}")
        return _leaf(src, device, dtype)

    return walk(np_tree, expect, "")
