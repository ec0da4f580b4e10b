"""Meshes over ``torch.distributed``: the port's counterpart of
:mod:`repro.launch.mesh`.

Single pod: (16, 16) = ("data", "model"); multi-pod: (2, 16, 16) =
("pod", "data", "model"). The ``model`` axis carries the paper's
layer-parallel (MGRIT chunk) dimension in training; ``data`` (+ ``pod``)
the batch.

The JAX package's mesh is a device array that GSPMD compiles against;
this one is the process group of the caller's rank, cut into one
subgroup an axis (``init_device_mesh``). :class:`Mesh` wraps it for the
rest of the port: the sharding rules read only ``axis_names`` and
``shape`` (as they read a JAX mesh), and every collective the port
issues goes through one of its methods, which counts it by kind with
its bytes (:attr:`Mesh.counts`). A collective over an axis of one rank
moves nothing: it is neither issued nor counted. One process is one
rank; its tensors live on the mesh's device type (gloo on the CPU, NCCL
on the card).

Functions, not module constants: importing this module opens no group.
"""
from __future__ import annotations

import collections
import math
import os
import tempfile
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist


class Mesh:
    """A named mesh over the initialized default process group."""

    def __init__(self, device_mesh):
        self.device_mesh = device_mesh
        self.axis_names: Tuple[str, ...] = tuple(device_mesh.mesh_dim_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names,
                                              device_mesh.mesh.shape))
        self.device_type: str = device_mesh.device_type
        self.size: int = math.prod(self.shape.values())
        # kind -> [calls, bytes this rank sent or contributed]
        self.counts: Dict[str, list] = collections.defaultdict(
            lambda: [0, 0])

    def index(self, axis: str) -> int:
        """This rank's coordinate along ``axis``."""
        return self.device_mesh.get_local_rank(axis)

    def group(self, axis: str):
        return self.device_mesh.get_group(axis)

    def global_rank(self, axis: str, index: int) -> int:
        """The global rank at ``index`` along ``axis``, this rank's
        coordinates elsewhere (P2P peers are global ranks)."""
        return dist.get_global_rank(self.group(axis), index)

    def reset_counts(self):
        self.counts.clear()

    def _count(self, kind: str, t: torch.Tensor):
        c = self.counts[kind]
        c[0] += 1
        c[1] += t.numel() * t.element_size()

    # -- collectives (each counted) ------------------------------------

    def exchange(self, kind: str, send: Optional[Tuple[torch.Tensor, int]],
                 recv: Optional[Tuple[torch.Tensor, int]]):
        """Point-to-point: send ``send[0]`` to global rank ``send[1]``
        and receive into ``recv[0]`` from global rank ``recv[1]``, either
        absent; returns when both are done."""
        ops = []
        if send is not None:
            self._count(kind, send[0])
            ops.append(dist.P2POp(dist.isend, send[0].contiguous(),
                                  send[1]))
        if recv is not None:
            ops.append(dist.P2POp(dist.irecv, recv[0], recv[1]))
        if ops:
            for w in dist.batch_isend_irecv(ops):
                w.wait()

    def broadcast(self, kind: str, t: torch.Tensor, axis: Optional[str],
                  src_index: int) -> torch.Tensor:
        """``t`` of the rank at ``src_index`` along ``axis``, on every
        rank of that axis (in place; ``t`` is returned). ``axis`` None is
        the whole mesh, ``src_index`` a global rank."""
        if axis is None:
            if self.size == 1:
                return t
            self._count(kind, t)
            dist.broadcast(t, src_index)
            return t
        if self.shape[axis] == 1:
            return t
        self._count(kind, t)
        dist.broadcast(t, self.global_rank(axis, src_index),
                       group=self.group(axis))
        return t

    def all_sum(self, kind: str, t: torch.Tensor,
                axes: Sequence[str]) -> torch.Tensor:
        """The sum of ``t`` over the ranks of ``axes`` (in place, one
        all-reduce an axis; ``t`` is returned). Every rank ends with the
        same bits."""
        for a in axes:
            if self.shape[a] == 1:
                continue
            self._count(kind, t)
            dist.all_reduce(t, group=self.group(a))
        return t

    def all_gather(self, kind: str, t: torch.Tensor, axis: str,
                   dim: int = 0) -> torch.Tensor:
        """The pieces of ``axis``'s ranks concatenated along ``dim``, in
        the axis's order (``t`` itself on a one-rank axis)."""
        t = t.contiguous()
        if self.shape[axis] == 1:
            return t
        self._count(kind, t)
        parts = [torch.empty_like(t) for _ in range(self.shape[axis])]
        dist.all_gather(parts, t, group=self.group(axis))
        return torch.cat(parts, dim=dim)

    def reduce_scatter(self, kind: str, t: torch.Tensor, axis: str,
                       dim: int = 0) -> torch.Tensor:
        """The sum of ``t`` over ``axis``'s ranks, cut into
        ``shape[axis]`` equal pieces along ``dim``: the piece at this
        rank's index (``t`` itself on a one-rank axis). The inverse of
        :meth:`all_gather`'s layout."""
        n = self.shape[axis]
        if n == 1:
            return t
        if t.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(t.shape)} does not cut "
                             f"into {n} equal pieces")
        front = t.movedim(dim, 0).contiguous()
        self._count(kind, front)
        out = front.new_empty((front.shape[0] // n, *front.shape[1:]))
        dist.reduce_scatter_tensor(out, front, group=self.group(axis))
        return out.movedim(0, dim)

    def all_to_all(self, kind: str, t: torch.Tensor, axis: str,
                   dim: int = 0) -> torch.Tensor:
        """``t`` cut into ``shape[axis]`` equal pieces along ``dim``,
        piece g sent to the rank at index g of ``axis``; the pieces this
        rank receives, concatenated along ``dim`` in the axis's order
        (``t`` itself on a one-rank axis)."""
        n = self.shape[axis]
        if n == 1:
            return t
        if t.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(t.shape)} does not cut "
                             f"into {n} equal pieces")
        front = t.movedim(dim, 0).contiguous()
        self._count(kind, front)
        out = torch.empty_like(front)
        dist.all_to_all_single(out, front, group=self.group(axis))
        return out.movedim(0, dim)

    def barrier(self):
        dist.barrier()


def backend_for(device_type: str) -> str:
    return "nccl" if device_type == "cuda" else "gloo"


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              device_type: Optional[str] = None) -> Mesh:
    """The counterpart of ``jax.make_mesh`` over the initialized default
    group, whose world size must equal the mesh's size. ``device_type``
    defaults to ``cuda`` on an NCCL group, else ``cpu``."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group "
                           "(torch.distributed.init_process_group)")
    from torch.distributed.device_mesh import init_device_mesh
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    n, world = math.prod(shape), dist.get_world_size()
    if n != world:
        raise ValueError(f"mesh {tuple(shape)} needs {n} ranks; the group "
                         f"has {world}")
    mesh = Mesh(init_device_mesh(device_type, tuple(shape),
                                 mesh_dim_names=tuple(axes)))
    # the world group's first collective, made here by every rank at
    # once: NCCL sets up a group's communicator on its first collective,
    # and a batched send / receive (the MGRIT halo and hand-off) may not
    # be that first one unless every rank of the group takes part
    dist.all_reduce(torch.zeros(1, device=device_type))
    return mesh


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: Optional[str] = None) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = math.prod(shape)
    have = dist.get_world_size() if dist.is_initialized() else 1
    if have < n:
        raise RuntimeError(
            f"need {n} devices for mesh {shape}; have {have}. Launch {n} "
            "ranks (one a card, e.g. torchrun --nproc-per-node on each "
            "host) before building the production mesh.")
    if have != n:
        raise RuntimeError(f"mesh {shape} needs exactly {n} ranks; the "
                           f"group has {have}")
    return make_mesh(shape, axes, device_type)


def make_host_mesh(device_type: str = "cuda") -> Mesh:
    """1x1 mesh on this process's device (tests, examples). Opens a
    world-1 group (gloo on the CPU, NCCL on the card) if none is
    initialized."""
    if not dist.is_initialized():
        store = dist.FileStore(os.path.join(
            tempfile.mkdtemp(prefix="host-mesh-"), "store"), 1)
        dist.init_process_group(backend_for(device_type), store=store,
                                rank=0, world_size=1)
    if dist.get_world_size() != 1:
        raise RuntimeError("make_host_mesh is the world-1 mesh; the group "
                           f"has {dist.get_world_size()} ranks")
    return make_mesh((1, 1), ("data", "model"), device_type)


def init_from_env(device_type: str) -> bool:
    """Join the group a launcher described in the environment
    (``torchrun``: RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT, LOCAL_RANK)
    when there is one and no group is open yet; rank r takes
    ``cuda:LOCAL_RANK`` on the card. Returns whether a group is open."""
    if dist.is_initialized():
        return True
    if "WORLD_SIZE" not in os.environ:
        return False
    if device_type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group(backend_for(device_type), init_method="env://")
    return True
