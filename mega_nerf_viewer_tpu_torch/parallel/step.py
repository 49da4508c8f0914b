"""The multi-device frame and refinement step.

Counterpart of ``mega_nerf_viewer_tpu/parallel/step.py``: one iteration of
the reference's event loop (render -> vote -> expand,
``cuda_renderer.cpp:68-163``) over a (rays, model) mesh.  The exact march
runs with the rays split over the ``rays`` axis and visit marks combined by
MAX (kernel E on the card); the refinement fill's MLP is data-parallel over
``rays`` and tensor-parallel over ``model`` (``parallel.model``); the tree
update is replicated, every rank applying the same expansion to the same
votes.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..n3tree.tree import N3Tree
from ..ops import refine
from ..options import RenderOptions
from .mesh import RAY_AXIS, Mesh, gather_rays, ray_shard
from .model import mlp_forward_all_tp, tp_param_specs
from .render import render_rays_sharded


def make_frame_refine_step(mesh: Mesh, opt: RenderOptions):
    """The step ``(tree, params, grid_dim, min_position, pos_range, dirs,
    vdirs, cen, visit_tracker, generator=None, rnd=None) -> (rgba [R, 4],
    tree, visit_tracker, n_added)`` (``step.py:36-92``).

    Raises ``ValueError`` up front when the fill's sample batch
    (``split_batch_size * 8 * samples_per_corner``) does not split over the
    ``rays`` axis.  The fill's uniform draws come from ``generator`` or
    ``rnd`` [K, 8, spc, 3] as in ``ops.refine.expand_voxels_jit``: every
    rank must pass the same ones."""
    dp = mesh.shape[RAY_AXIS]
    fill_rows = opt.split_batch_size * 8 * opt.samples_per_corner
    if fill_rows % dp:
        raise ValueError(
            f"split_batch_size*8*samples_per_corner ({fill_rows}) must "
            f"divide the '{RAY_AXIS}' mesh axis ({dp}); adjust "
            f"split_batch_size or samples_per_corner")

    def step(tree: N3Tree, params, grid_dim, min_position, pos_range,
             dirs: torch.Tensor, vdirs: torch.Tensor, cen: torch.Tensor,
             visit_tracker: torch.Tensor,
             generator: Optional[torch.Generator] = None,
             rnd: Optional[torch.Tensor] = None):
        res = render_rays_sharded(tree, dirs, vdirs, cen, opt, mesh,
                                  track_visit=True)
        visit_tracker = torch.maximum(visit_tracker, res.visited)
        local = tp_param_specs(params, mesh)

        def mlp_apply(_params, cluster_ids, x):
            sl = ray_shard(mesh, x.shape[0])
            return gather_rays(mesh, mlp_forward_all_tp(
                local, cluster_ids[sl], x[sl], mesh=mesh))

        new_tree, tracker, n_added = refine.expand_voxels_jit(
            tree, params, grid_dim, min_position, pos_range, opt,
            res.split_vote, visit_tracker, generator=generator, rnd=rnd,
            mlp_apply=mlp_apply)
        return res.out, new_tree, tracker, n_added

    return step
