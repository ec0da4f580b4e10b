"""Fault-tolerant checkpointing (port of :mod:`repro.train.checkpoint`).

The protocol is the reference's:
  * atomic write: serialize into ``<dir>/.tmp-<step>-*``, fsync
    ``meta.json``, rename to ``step_%010d`` — a crash mid-write never
    corrupts the latest checkpoint; on an exception the temporary
    directory is removed and the exception re-raised;
  * a ``LATEST`` pointer file and keep-k rotation;
  * resume contract: (params, opt_state, step, extra); the data pipeline
    is step-indexed, so the stream replays exactly.

Under a mesh the reference's elastic contract holds: stored arrays are
full and logical. :func:`save` gathers each leaf split across ranks
(leaf by leaf, every rank taking part) and rank 0 writes; every rank
waits at a barrier after. :func:`restore` reads the full arrays on
every rank and keeps this rank's slices, so a checkpoint saved on one
mesh restores onto any other (or onto none).

The on-disk format is the JAX package's, so a checkpoint moves between
the two packages in both directions: ``params.npz`` and ``opt.npz``, each
leaf ``a{i}`` in ``jax.tree.flatten`` order (dict keys sorted at every
level, ``None`` subtrees holding no leaf). The optimizer's ``step``, a
host int here, is written as the reference's 0-d int32 leaf and read back
as an int. A bfloat16 leaf is written as the raw 2-byte ``|V2`` array
numpy makes of ``ml_dtypes``' bfloat16 (which this package does not
need) and read back by a view into the template leaf's dtype.

Two differences, both for memory at full width (qwen3-1.7b's float32
params and AdamW moments are ~28 GB): :func:`save` streams each leaf off
the device into the zip as it is written (``np.savez`` holds every leaf
on the host at once), and :func:`restore` copies each stored leaf into
the tensor the caller already holds (``copy_``), one leaf on the host at
a time and no second copy of the state on the device. The optimizer
updates those tensors in place, so their identity must survive a
restore.
"""
from __future__ import annotations

import contextlib
import json
import os
import shutil
import tempfile
import zipfile
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.tree import Path, leaf_at


def _mesh_specs(mesh, rcfg, opt_state):
    """(params specs, optimizer-state specs) of the trees a rank of
    ``mesh`` holds: what :func:`repro_torch.parallel.params.shard_tree`
    cut them by."""
    from repro_torch.models import transformer
    from repro_torch.parallel import params as pparams
    ps = pparams.train_specs(transformer.param_shapes(rcfg), rcfg, mesh)
    return ps, {k: (() if k == "step" else ps) for k in opt_state}


def _leaves(tree, prefix: Path = ()) -> List[Tuple[Path, Any]]:
    """Leaves with their key paths in ``jax.tree.flatten`` order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [pl for k in sorted(tree)
                for pl in _leaves(tree[k], prefix + (k,))]
    return [(prefix, tree)]


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, int):                 # the optimizer's host step
        return np.asarray(leaf, np.int32)
    t = leaf.detach()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).cpu().numpy().view(np.dtype("V2"))
    return t.cpu().numpy()


def _write_npz(path: Optional[str], tree, full=None):
    """``np.savez``'s layout, one leaf on the host at a time.
    ``full(path, leaf)`` gathers a leaf split across ranks (a collective
    every rank calls in the same leaf order); only a rank given a
    ``path`` writes."""
    with (zipfile.ZipFile(path, "w", compression=zipfile.ZIP_STORED,
                          allowZip64=True) if path
          else contextlib.nullcontext()) as zf:
        for i, (p, leaf) in enumerate(_leaves(tree)):
            if full is not None and isinstance(leaf, torch.Tensor):
                leaf = full(p, leaf)
            if zf is not None:
                with zf.open(f"a{i}.npy", "w", force_zip64=True) as f:
                    np.lib.format.write_array(f, _to_numpy(leaf),
                                              allow_pickle=False)


def save(ckpt_dir: str, step: int, params, opt_state,
         extra: Optional[Dict[str, Any]] = None, keep: int = 3,
         mesh=None, rcfg=None) -> str:
    """Write ``step_<step>`` atomically and point LATEST at it. Under
    ``mesh`` (with ``rcfg``, whose sharding cut the trees) every rank
    calls this: split leaves are gathered and rank 0 writes."""
    if mesh is not None and rcfg is None:
        raise ValueError("saving from a mesh needs the rcfg whose sharding "
                         "cut the trees")
    final = os.path.join(ckpt_dir, f"step_{step:010d}")
    writer = mesh is None or torch.distributed.get_rank() == 0
    gathers = (None, None)
    if mesh is not None:
        from repro_torch.parallel.params import gather_leaf
        gathers = tuple(
            (lambda p, leaf, sp=sp: gather_leaf(
                leaf, p, leaf_at(sp, p), mesh, kind="ckpt_gather",
                cfg=rcfg.model, sharding=rcfg.sharding))
            for sp in _mesh_specs(mesh, rcfg, opt_state))
    if not writer:
        _write_npz(None, params, gathers[0])
        _write_npz(None, opt_state, gathers[1])
        mesh.barrier()
        return final
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=f".tmp-{step}-", dir=ckpt_dir)
    try:
        _write_npz(os.path.join(tmp, "params.npz"), params, gathers[0])
        _write_npz(os.path.join(tmp, "opt.npz"), opt_state, gathers[1])
        meta = {"step": step, "extra": extra or {}}
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    with open(os.path.join(ckpt_dir, "LATEST"), "w") as f:
        f.write(os.path.basename(final))
    _rotate(ckpt_dir, keep)
    if mesh is not None:
        mesh.barrier()
    return final


def _rotate(ckpt_dir: str, keep: int):
    steps = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_"))
    for d in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def latest_step(ckpt_dir: str) -> Optional[int]:
    ptr = os.path.join(ckpt_dir, "LATEST")
    if not os.path.exists(ptr):
        return None
    with open(ptr) as f:
        name = f.read().strip()
    if not os.path.exists(os.path.join(ckpt_dir, name, "meta.json")):
        return None
    return int(name.split("_")[1])


def _load_into(a: np.ndarray, leaf, path: Path):
    """The stored array ``a`` in the template leaf's place: an int leaf
    (the optimizer's step) comes back as an int, a tensor is overwritten
    in place with ``a`` in its own dtype."""
    if isinstance(leaf, int):
        return int(a)
    if tuple(a.shape) != tuple(leaf.shape):
        raise ValueError(f"{'.'.join(path)}: stored shape {a.shape} != "
                         f"the template's {tuple(leaf.shape)}")
    if a.dtype.kind == "V":                   # raw bfloat16
        if a.dtype.itemsize != 2 or leaf.dtype != torch.bfloat16:
            raise ValueError(f"{'.'.join(path)}: raw {a.dtype} leaf for a "
                             f"{leaf.dtype} template")
        src = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        src = torch.from_numpy(np.ascontiguousarray(a))
    with torch.no_grad():
        leaf.copy_(src)
    return leaf


def _load_npz(path: str, template, local=None):
    """The template tree with every leaf overwritten from ``path``;
    ``local(path, array)`` cuts a stored (full) array to the template's
    slice."""
    pairs = _leaves(template)
    with np.load(path, allow_pickle=False) as arrs:
        if len(arrs.files) != len(pairs):
            raise ValueError(f"{path}: {len(arrs.files)} leaves stored, the "
                             f"template has {len(pairs)}")
        loaded = {}
        for i, (p, leaf) in enumerate(pairs):
            a = arrs[f"a{i}"]
            if local is not None and isinstance(leaf, torch.Tensor):
                a = local(p, a)
            loaded[p] = _load_into(a, leaf, p)

    def walk(tree, prefix: Path = ()):
        if isinstance(tree, dict):
            return {k: walk(v, prefix + (k,)) for k, v in tree.items()}
        return None if tree is None else loaded[prefix]
    return walk(template)


def restore(ckpt_dir: str, params_template, opt_template,
            mesh=None, rcfg=None) -> Optional[Tuple[Any, Any, int, Dict]]:
    """Restore the latest checkpoint into the templates' tensors, in
    place: returns (params, opt_state, step, extra) holding the
    templates' own tensors (``opt_state["step"]`` the stored int), or
    None when ``ckpt_dir`` has none. Under ``mesh`` (with ``rcfg``) the
    templates are this rank's slices: each stored array is cut to them
    (the reference's elastic re-sharding onto the current mesh)."""
    if mesh is not None and rcfg is None:
        raise ValueError("restoring onto a mesh needs the rcfg whose "
                         "sharding cut the templates")
    step = latest_step(ckpt_dir)
    if step is None:
        return None
    d = os.path.join(ckpt_dir, f"step_{step:010d}")
    with open(os.path.join(d, "meta.json")) as f:
        meta = json.load(f)
    cuts = (None, None)
    if mesh is not None:
        from repro_torch.parallel.params import local_slice
        cuts = tuple(
            (lambda p, a, sp=sp: local_slice(a, p, leaf_at(sp, p), mesh,
                                             cfg=rcfg.model,
                                             sharding=rcfg.sharding))
            for sp in _mesh_specs(mesh, rcfg, opt_template))
    params = _load_npz(os.path.join(d, "params.npz"), params_template,
                       cuts[0])
    opt_state = _load_npz(os.path.join(d, "opt.npz"), opt_template, cuts[1])
    return params, opt_state, meta["step"], meta.get("extra", {})
