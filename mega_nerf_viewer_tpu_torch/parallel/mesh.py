"""Meshes of ranks and the collectives the sharded frames run over them.

Counterpart of ``mega_nerf_viewer_tpu/parallel/mesh.py``.  JAX's mesh is a
grid of devices inside one program; here it is a grid of processes (ranks)
of a ``torch.distributed`` group, one device each, laid out as a
:class:`torch.distributed.device_mesh.DeviceMesh` with the axes ``rays``
(ray data parallelism) and ``model`` (the tensor-parallel MLP).  Rank ``r``
drives ``cuda:{local_rank % device_count}`` unless ``device=`` says
otherwise.  The backend is NCCL on the card and gloo on the CPU; a caller
may ask for gloo on the card (two ranks sharing one card, which NCCL
refuses): gloo takes CUDA tensors for the three collectives used here
(all_reduce, all_gather, broadcast) and copies through host memory
itself.  NCCL is never replaced by gloo behind the caller's back: asking
for it where it is missing raises.

Every rank computes its own shard, and the sharded frames hand every rank
the full result, as JAX's caller gets one global array.  Host-side
decisions (segment layouts, chunk deals, budgets) are derived by every
rank from the same replicated inputs, so they agree without a collective.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..device import resolve_device
from ..utils import profiling

RAY_AXIS = "rays"
MODEL_AXIS = "model"

# the device this process's group was started for (init_world)
_world_device: Optional[torch.device] = None

# the meshes made over the standing group, by (shape, axis names, device):
# a DeviceMesh makes process groups, each a collective, so a mesh is built
# once per group and dropped when a new group stands
_meshes: dict = {}
_meshes_world = None


def backend_for(device) -> str:
    """The backend for ranks on ``device``: NCCL on the card, gloo
    elsewhere."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def local_device(device=None, rank: Optional[int] = None) -> torch.device:
    """This rank's device: ``device`` when given, else the device the
    group was started for, else ``cuda:{local_rank % device_count}``
    (``LOCAL_RANK`` from the launcher, else ``rank``).  Raises without a
    card unless ``device`` is given."""
    if device is not None:
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        return device
    if _world_device is not None:
        return _world_device
    resolve_device(None)
    if rank is None:
        rank = dist.get_rank() if dist.is_initialized() else 0
    local = int(os.environ.get("LOCAL_RANK", rank))
    return torch.device("cuda", local % torch.cuda.device_count())


def init_world(device=None, backend: Optional[str] = None,
               init_method: Optional[str] = None,
               world_size: Optional[int] = None,
               rank: Optional[int] = None) -> torch.device:
    """Start this process's group unless one stands; returns the rank's
    device.  Without ``init_method`` and without a launcher's environment
    (``WORLD_SIZE``) it is a world of one, in-process, as JAX's default
    mesh takes the local devices.  ``backend`` defaults to
    :func:`backend_for` the device; NCCL where it is missing raises."""
    global _world_device
    if dist.is_initialized():
        return local_device(device)
    env_rank = rank if rank is not None else (
        int(os.environ["RANK"]) if "RANK" in os.environ else None)
    dev = local_device(device, env_rank)
    backend = backend or backend_for(dev)
    if backend == "nccl" and not dist.is_nccl_available():
        raise RuntimeError("NCCL was asked for but this PyTorch has no NCCL; "
                           "pass backend='gloo' to use gloo")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if init_method is None and "WORLD_SIZE" not in os.environ:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    else:
        # -1: from the launcher's environment
        dist.init_process_group(
            backend, init_method=init_method,
            world_size=-1 if world_size is None else world_size,
            rank=-1 if rank is None else rank)
    _world_device = dev
    return dev


class Mesh:
    """A grid of ranks with named axes over a :class:`DeviceMesh`.

    ``shape`` maps each axis to its size (JAX's ``mesh.shape``), ``size``
    is the number of ranks, ``device`` this rank's device.
    :meth:`index` is this rank's coordinate on an axis and :meth:`group`
    the process group of the ranks that share its other coordinates."""

    def __init__(self, device_mesh: DeviceMesh, device: torch.device):
        self.device_mesh = device_mesh
        self.device = device
        self.axis_names = tuple(device_mesh.mesh_dim_names)
        self.shape = {n: device_mesh.size(i)
                      for i, n in enumerate(self.axis_names)}
        self.size = int(np.prod(list(self.shape.values())))

    def group(self, axis: str):
        return self.device_mesh.get_group(axis)

    def index(self, axis: str) -> int:
        return self.device_mesh.get_local_rank(axis)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, device={self.device})"


def _rank_device(devices: Optional[Sequence], device):
    """This rank's entry of ``devices`` (the ranks' devices in rank order),
    unless ``device`` names it."""
    if devices is None or device is not None:
        return device
    devices = list(devices)
    rank = (dist.get_rank() if dist.is_initialized()
            else int(os.environ.get("RANK", 0)))
    if rank >= len(devices):
        raise ValueError(f"rank {rank} has no entry in {len(devices)} "
                         f"devices")
    return devices[rank]


def make_mesh(shape: Sequence[int], axis_names: Sequence[str],
              devices: Optional[Sequence] = None, *, device=None) -> Mesh:
    """A mesh of ``shape`` over every rank of the group, in rank order
    (starting a world of one if no group stands).  Its size must be the
    world's: a rank outside a mesh would have no part in its frames.  The
    same arguments over the same group return the same mesh, so a frame
    called without one makes no process group after the first.

    ``devices`` takes the place of JAX's list of ``jax.Device``s: the
    ranks' torch devices (or their names) in rank order, of which this
    rank drives its own entry.  ``device`` (port-only) names this rank's
    device directly and wins over ``devices``."""
    dev = init_world(_rank_device(devices, device))
    n = int(np.prod(shape))
    world = dist.get_world_size()
    if n > world:
        raise ValueError(
            f"mesh of {n} devices requested, only {world} available")
    if n < world:
        raise ValueError(f"mesh of {n} devices over a world of {world}: a "
                         f"mesh spans every rank")
    global _meshes_world
    if _meshes_world is not dist.group.WORLD:
        _meshes.clear()
        _meshes_world = dist.group.WORLD
    key = (tuple(shape), tuple(axis_names), dev)
    if key not in _meshes:
        dm = DeviceMesh(dev.type, torch.arange(n).reshape(tuple(shape)),
                        mesh_dim_names=tuple(axis_names))
        _meshes[key] = Mesh(dm, dev)
    return _meshes[key]


def default_mesh(devices: Optional[Sequence] = None,
                 model_parallel: int = 1, *, device=None) -> Mesh:
    """Every rank as (rays, model); ``model_parallel`` = 1 is pure data
    parallelism.  Uses the group that stands, else a world of one.
    ``devices`` and ``device`` as in :func:`make_mesh`."""
    device = _rank_device(devices, device)
    init_world(device)
    n = dist.get_world_size()
    if n % model_parallel:
        raise ValueError("device count not divisible by model_parallel")
    return make_mesh((n // model_parallel, model_parallel),
                     (RAY_AXIS, MODEL_AXIS), device=device)


# ----------------------------------------------------------------------
# Collectives
# ----------------------------------------------------------------------
_OPS = {"max": dist.ReduceOp.MAX, "sum": dist.ReduceOp.SUM}


# each collective runs inside a span named after it, so that a trace
# shows the collectives' share of a frame
def all_reduce(t: torch.Tensor, op: str, group) -> torch.Tensor:
    """``t`` reduced over ``group`` with ``op`` ("max" or "sum"); a new
    tensor on ``t``'s device."""
    with profiling.annotate("parallel.all_reduce"):
        buf = t.detach().contiguous().clone()
        dist.all_reduce(buf, op=_OPS[op], group=group)
        return buf


def all_gather(t: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``t`` (equal shapes) concatenated along dim 0 in the
    group's rank order, on ``t``'s device."""
    with profiling.annotate("parallel.all_gather"):
        buf = t.detach().contiguous()
        parts = [torch.empty_like(buf)
                 for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, buf, group=group)
        return torch.cat(parts, 0)


def broadcast(t: torch.Tensor, src: int = 0, group=None) -> torch.Tensor:
    """Rank ``src``'s ``t`` on every rank (``t`` is the receive buffer
    elsewhere); a tensor on ``t``'s device."""
    group = group or dist.group.WORLD
    with profiling.annotate("parallel.broadcast"):
        buf = t.detach().contiguous().clone()
        dist.broadcast(buf, src=src, group=group)
        return buf


def ray_shard(mesh: Mesh, n_rows: int) -> slice:
    """This rank's contiguous rows of ``n_rows`` split over the ray axis
    (``n_rows`` divisible by its size)."""
    n = mesh.shape[RAY_AXIS]
    if n_rows % n:
        raise ValueError(f"{n_rows} rows do not split over the "
                         f"'{RAY_AXIS}' axis of size {n}")
    per = n_rows // n
    s = mesh.index(RAY_AXIS)
    return slice(s * per, (s + 1) * per)


def gather_rays(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """Each ray shard's rows concatenated over the ray axis."""
    return all_gather(t, mesh.group(RAY_AXIS))


def reduce_mesh(mesh: Mesh, t: torch.Tensor, op: str = "max",
                ray_op: Optional[str] = None) -> torch.Tensor:
    """``t`` reduced over the ray axis with ``ray_op`` (default ``op``),
    then over every other axis with ``op`` (JAX's ``pmax``/``psum`` over
    ``rays`` and then the other axes)."""
    t = all_reduce(t, ray_op or op, mesh.group(RAY_AXIS))
    for axis in mesh.axis_names:
        if axis != RAY_AXIS:
            t = all_reduce(t, op, mesh.group(axis))
    return t
