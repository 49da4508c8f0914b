"""Multi-host execution: one ``torch.distributed`` group over several
processes, possibly on several hosts.

Counterpart of ``mega_nerf_viewer_tpu/parallel/multihost.py``.  The recipe
is JAX's:

1. :func:`initialize` joins the group on every process (onto
   ``init_process_group``: ``tcp://`` with a coordinator address, else the
   launcher's environment, as ``torchrun`` sets it);
2. :func:`broadcast` sends process 0's octree and MLP weights to every
   rank once at start-up, the only start-up data movement (tree and weights
   are replicated; frames never cross ranks but for their gather), and
   :func:`replicate` puts them on each rank's device once;
3. the frames are the single-host sharded frames over :func:`global_mesh`.

JAX needs separate multi-host programs because a global array spans
processes; with one process per device the sharded frames of
``parallel.render`` and ``parallel.guided`` already are multi-host
programs, so the two frames here are those, over the global mesh.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

from ..models.meganerf import MLPParams
from ..options import RenderOptions
from .guided import guided_frame_sharded
from .mesh import (RAY_AXIS, Mesh, broadcast as broadcast_tensor,
                   init_world, local_device, make_mesh)
from .render import render_frame_fast_sharded


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None, device=None) -> torch.device:
    """Join the group (``multihost.py:318-325``): ``coordinator_address``
    (``host:port``) with ``num_processes`` and ``process_id``, or the
    launcher's environment (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``,
    ``WORLD_SIZE``).  The backend is NCCL on the card and gloo on the CPU
    unless ``backend`` says otherwise.  Returns this rank's device."""
    init_method = (f"tcp://{coordinator_address}" if coordinator_address
                   else "env://")
    return init_world(device, backend, init_method, num_processes,
                      process_id)


def global_mesh(axis: str = RAY_AXIS, device=None) -> Mesh:
    """A 1-D mesh over every rank of every process (a world of one if no
    group stands)."""
    init_world(device)
    return make_mesh((dist.get_world_size(),), (axis,), device=device)


def _split(obj, leaves: list):
    """``obj`` as a picklable skeleton with its tensors replaced by their
    index in ``leaves`` (appended)."""
    if isinstance(obj, torch.Tensor):
        leaves.append(obj)
        return ("tensor", len(leaves) - 1)
    if isinstance(obj, MLPParams):
        return ("mlp", [_split(w, leaves) for w in obj.weights],
                [_split(b, leaves) for b in obj.biases], obj.skips)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return ("dataclass", type(obj),
                {f.name: _split(getattr(obj, f.name), leaves)
                 for f in dataclasses.fields(obj)})
    if isinstance(obj, (list, tuple)):
        return ("seq", type(obj), [_split(o, leaves) for o in obj])
    if isinstance(obj, dict):
        return ("dict", {k: _split(v, leaves) for k, v in obj.items()})
    return ("value", obj)


def _join(skel, leaves: list):
    """The object of a :func:`_split` skeleton with ``leaves`` put back."""
    kind = skel[0]
    if kind == "tensor":
        return leaves[skel[1]]
    if kind == "mlp":
        return MLPParams([_join(w, leaves) for w in skel[1]],
                         [_join(b, leaves) for b in skel[2]], skel[3])
    if kind == "dataclass":
        return skel[1](**{k: _join(v, leaves) for k, v in skel[2].items()})
    if kind == "seq":
        items = [_join(o, leaves) for o in skel[2]]
        if hasattr(skel[1], "_fields"):        # a NamedTuple
            return skel[1](*items)
        return skel[1](items)
    if kind == "dict":
        return {k: _join(v, leaves) for k, v in skel[1].items()}
    return skel[1]


def broadcast(pytree, *, device=None):
    """Process 0's ``pytree`` on every rank (``multihost.py:333-341``): an
    :class:`~..n3tree.N3Tree`, :class:`~..models.meganerf.MLPParams`,
    leaf map, tensor, or lists, tuples and dicts of them.  Rank 0 first
    sends the structure with every tensor's shape and dtype
    (``broadcast_object_list``), then each tensor; the other ranks receive
    into new tensors on ``device`` (default: where their own copy's
    tensors lie, else the rank's device), whatever their own copy held."""
    leaves: list = []
    skel = _split(pytree, leaves)
    if device is None:
        device = leaves[0].device if leaves else local_device()
    meta = [(skel, [(tuple(t.shape), t.dtype) for t in leaves])]
    dist.broadcast_object_list(meta, src=0)
    skel, specs = meta[0]
    if dist.get_rank() == 0:
        recv = [t.to(device) for t in leaves]
    else:
        recv = [torch.empty(shape, dtype=dtype, device=device)
                for shape, dtype in specs]
    # as raw bytes: gloo takes no int16 (the tree's sample counts)
    return _join(skel, [
        broadcast_tensor(t.contiguous().reshape(-1).view(torch.uint8), 0)
        .view(t.dtype).reshape(t.shape) for t in recv])


def replicate(pytree, mesh: Optional[Mesh] = None):
    """``pytree`` with every tensor on the mesh's device (``multihost.py:
    356-364``).  Do it once per tree and model: tensors already there pass
    through, so the frames never copy them again."""
    device = (mesh.device if mesh is not None else local_device())
    leaves: list = []
    skel = _split(pytree, leaves)
    return _join(skel, [t.to(device) for t in leaves])


def process_ray_slice(n_rows: int) -> slice:
    """The contiguous rows this process owns (``multihost.py:376-382``):
    rows dealt to processes in rank order."""
    n_proc = dist.get_world_size()
    per = n_rows // n_proc
    pid = dist.get_rank()
    return slice(pid * per, (pid + 1) * per)


def render_frame_fast_sharded_multihost(tree, leaf_map, camera,
                                        opt: RenderOptions,
                                        mesh: Optional[Mesh] = None,
                                        max_dense: int = 32,
                                        chunk_size: int = 0):
    """The fast frame with the rays split over the global mesh
    (``multihost.py:438-467``): :func:`~.render.render_frame_fast_sharded`
    over :func:`global_mesh`, which already returns the full frame on every
    rank.  The caller gives every rank the same tree and leaf map
    (:func:`broadcast` once).  Returns (img [H, W, 4], overflow count)."""
    return render_frame_fast_sharded(
        tree, leaf_map, camera, opt,
        mesh if mesh is not None else global_mesh(device=tree.device),
        max_dense=max_dense, chunk_size=chunk_size)


def guided_frame_sharded_multihost(tree, leaf_map, model, camera,
                                   opt: RenderOptions,
                                   mesh: Optional[Mesh] = None,
                                   budget: int = 1 << 14,
                                   chunk_size: int = 0):
    """The guided frame over the global mesh (``multihost.py:510-543``):
    :func:`~.guided.guided_frame_sharded` over :func:`global_mesh`.  It
    broadcasts nothing: the caller gives every rank the same tree, leaf
    map and weights, by :func:`broadcast` (and :func:`replicate`) once
    before the first frame, as JAX's caller does.  Returns (img [H, W, 4]
    on every rank, overflow int: call again with a doubled ``budget`` when
    set)."""
    img, overflow = guided_frame_sharded(
        tree, leaf_map, model, camera, opt,
        mesh if mesh is not None else global_mesh(device=tree.device),
        budget=budget, chunk_size=chunk_size)
    return img, int(overflow)
