"""Sharded guided sampling: collect, MLP query and composite per shard.

Counterpart of ``mega_nerf_viewer_tpu/parallel/guided.py``.  Each rank owns
a contiguous ray shard and runs the whole compact guided pipeline on it
with the single-device functions: the collect march (kernel C on the card),
the compact reconstruction,
the grouped MLP query (weights replicated) and the compact composite
(kernel D).  The only collectives are the MAX of the per-shard overflow
flags and the gather of the composited rows.

The compact budget is per shard and fixed by the caller; a shard whose
sample count exceeds it raises the overflow flag, and the caller doubles
the budget and calls again, the fast path's escalation protocol.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..models.meganerf import query_grouped
from ..n3tree.tree import N3Tree
from ..ops import guided as G
from ..ops.accel import LeafMap
from ..options import RenderOptions
from .mesh import RAY_AXIS, Mesh, default_mesh, gather_rays, ray_shard, \
    reduce_mesh
from .render import _frame_rays


def guided_frame_sharded(tree: N3Tree, leaf_map: LeafMap, model, camera,
                         opt: RenderOptions, mesh: Optional[Mesh] = None,
                         budget: int = 1 << 18, chunk_size: int = 0):
    """One sharded guided frame (``guided.py:75-109``): rays split over the
    ``rays`` axis, collect -> compact reconstruct -> MLP -> composite on
    each rank.  Returns ([H, W, 4] f32 on every rank, overflow bool); on
    overflow, call again with a doubled per-shard ``budget``."""
    if mesh is None:
        mesh = default_mesh(device=tree.device)
    dev = tree.device
    dirs, vdirs, cen, R = _frame_rays(
        tree, camera, opt, mesh.shape[RAY_AXIS] * max(chunk_size, 1))
    sl = ray_shard(mesh, dirs.shape[0])
    dirs, vdirs = dirs[sl], vdirs[sl]
    t_buf, ns = G.collect_t_fast(tree, leaf_map, dirs, cen, opt,
                                 chunk_size=chunk_size)
    x, cids, z_c, ray_of_p, offs = G._compact_reconstruct(
        tree, dirs, vdirs, cen, t_buf, ns,
        torch.as_tensor(model.grid_dim, device=dev),
        torch.as_tensor(model.min_position, device=dev),
        torch.as_tensor(model.range, device=dev), opt, budget)
    res_c = query_grouped(model.params, cids, x)
    # a shard over its budget (flagged below) composites the samples that
    # fit: each ray's run is cut at the budget, so no row past it is read
    end = offs.clamp_max(budget)
    out = G.composite_results_compact(
        res_c, z_c, ray_of_p, end, end - (offs - ns).clamp_max(budget),
        vdirs, opt, tree.data_format.basis_dim,
        tree.data_format.format == "SH")
    overflow = reduce_mesh(mesh, (ns.sum() > budget).to(torch.int32), "max")
    out = gather_rays(mesh, out)
    return out[:R].reshape(camera.height, camera.width, 4), bool(overflow)
