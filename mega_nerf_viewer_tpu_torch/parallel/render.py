"""Multi-device frames: rays sharded over the ranks of a mesh.

Counterpart of ``mega_nerf_viewer_tpu/parallel/render.py``.  Rays
(pixels) are split over the mesh's ``rays`` axis; the octree, the leaf
map and the options are replicated, one copy per rank.  Each rank marches
its shard with the single-device functions (and so with kernels A, B and
E on the card); the per-frame collectives are the MAX of the visit marks
and of the overflow counts and the gather of the shards' rows, after which
every rank holds the full frame, as JAX's caller holds one global array.
Votes and per-ray hints ride back with their rays.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..n3tree.tree import N3Tree
from ..ops.accel import (FastRenderResult, LeafMap, _frame_core,
                         render_rays_fast, segment_chunks)
from ..ops.rays import rodrigues, screen2worlddir
from ..ops.render import (DEFAULT_MAX_LEVELS, RenderResult,
                          composite_background, render_rays)
from ..options import RenderOptions
from .mesh import (RAY_AXIS, Mesh, default_mesh, gather_rays, ray_shard,
                   reduce_mesh)


def _frame_rays(tree: N3Tree, camera, opt: RenderOptions, quantum: int):
    """The frame's world rays padded to a multiple of ``quantum`` with
    copies of the last ray.  Returns (dirs, vdirs, cen, R)."""
    transform = torch.as_tensor(camera.transform, dtype=torch.float32,
                                device=tree.device)
    dirs, cen = screen2worlddir(camera.width, camera.height, camera.fx,
                                camera.fy, camera.cx, camera.cy, transform)
    vdirs = rodrigues(opt.rot_dirs, dirs)
    R = dirs.shape[0]
    pad = (-R) % quantum
    if pad:
        dirs = torch.cat([dirs, dirs[-1:].expand(pad, 3)])
        vdirs = torch.cat([vdirs, vdirs[-1:].expand(pad, 3)])
    return dirs, vdirs, cen, R


def render_rays_sharded(tree: N3Tree, dirs: torch.Tensor,
                        vdirs: torch.Tensor, cen_world: torch.Tensor,
                        opt: RenderOptions, mesh: Mesh,
                        track_visit: bool = False,
                        max_levels: int = DEFAULT_MAX_LEVELS
                        ) -> RenderResult:
    """The exact march with the ray batch split over the ``rays`` axis
    (``render.py:57-71``; kernel E on the card).  Visit marks are combined
    by MAX over every axis; ``out`` and the votes are gathered.  R must be
    divisible by the axis size (pad upstream)."""
    sl = ray_shard(mesh, dirs.shape[0])
    res = render_rays(tree, dirs[sl], vdirs[sl], cen_world, opt,
                      track_visit=track_visit, max_levels=max_levels)
    return RenderResult(gather_rays(mesh, res.out),
                        gather_rays(mesh, res.split_vote),
                        gather_rays(mesh, res.sample_vote),
                        reduce_mesh(mesh, res.visited, "max"))


def render_rays_fast_sharded(tree: N3Tree, leaf_map: LeafMap,
                             dirs: torch.Tensor, vdirs: torch.Tensor,
                             cen_world: torch.Tensor, opt: RenderOptions,
                             mesh: Mesh, max_dense: int = 32,
                             chunk_size: int = 0,
                             skip_table: Optional[torch.Tensor] = None
                             ) -> FastRenderResult:
    """The leaf-map fast march with the rays split over the ``rays`` axis
    (``render.py:112-131``); ``skip_table`` runs the entry-skip prepass
    per shard.  The overflow count is combined by MAX; the per-ray outputs
    are gathered."""
    sl = ray_shard(mesh, dirs.shape[0])
    res = render_rays_fast(tree, leaf_map, dirs[sl], vdirs[sl], cen_world,
                           opt, max_dense=max_dense, chunk_size=chunk_size,
                           skip_table=skip_table)
    return FastRenderResult(
        gather_rays(mesh, res.out), reduce_mesh(mesh, res.overflow, "max"),
        gather_rays(mesh, res.steps), res.split_vote, res.sample_vote,
        gather_rays(mesh, res.nrec), gather_rays(mesh, res.skips))


def render_frame_fast_sharded(tree: N3Tree, leaf_map: LeafMap, camera,
                              opt: RenderOptions,
                              mesh: Optional[Mesh] = None,
                              max_dense: int = 32, chunk_size: int = 0,
                              skip_table: Optional[torch.Tensor] = None):
    """A full sharded fast frame (``render.py:134-162``).  Returns
    ([H, W, 4] f32, overflow count i32 [])."""
    if mesh is None:
        mesh = default_mesh(device=tree.device)
    n = mesh.shape[RAY_AXIS]
    dirs, vdirs, cen, R = _frame_rays(tree, camera, opt,
                                      n * max(chunk_size, 1))
    res = render_rays_fast_sharded(tree, leaf_map, dirs, vdirs, cen, opt,
                                   mesh, max_dense=max_dense,
                                   chunk_size=chunk_size,
                                   skip_table=skip_table)
    img = composite_background(res.out[:R], opt)
    return img.reshape(camera.height, camera.width, 4), res.overflow


def deal_chunks_balanced(chunk_costs, seg_counts, n_shards: int):
    """Cost-balanced chunk-to-shard assignment, stratified by budget class
    (``render.py:165-214``, host numpy, the same arithmetic): greedy LPT
    within each ``(n_chunks, budget)`` stratum, the heaviest chunk first
    onto the lightest shard with room left, equal chunk counts per shard.
    Every count must be a multiple of ``n_shards``.  Every rank derives
    the same deal from the same costs (a stable sort, no randomness).

    Returns (slot_of_chunk i32 [n_chunks], per_shard_seg_counts): chunk g
    lands at flat slot ``slot_of_chunk[g]`` = shard * per_shard_chunks +
    its position within the shard, where chunks keep ascending global
    order, so every shard has the layout ``(n / n_shards, budget)``."""
    costs = np.asarray(chunk_costs, np.float64)
    n_chunks = costs.shape[0]
    if sum(n for n, _ in seg_counts) != n_chunks:
        raise ValueError(f"seg_counts {seg_counts} do not cover "
                         f"{n_chunks} chunks")
    per_shard_chunks = n_chunks // n_shards
    shard_of = np.empty(n_chunks, np.int64)
    load = np.zeros(n_shards)
    start = 0
    for n, _md in seg_counts:
        if n % n_shards:
            raise ValueError(f"a stratum of {n} chunks does not split over "
                             f"{n_shards} shards")
        idx = np.arange(start, start + n)
        cap = np.full(n_shards, n // n_shards)
        for g in idx[np.argsort(-costs[idx], kind="stable")]:
            cands = np.flatnonzero(cap > 0)
            s = cands[np.argmin(load[cands])]
            shard_of[g] = s
            load[s] += costs[g]
            cap[s] -= 1
        start += n
    slot_of_chunk = np.empty(n_chunks, np.int32)
    for s in range(n_shards):
        mine = np.flatnonzero(shard_of == s)
        slot_of_chunk[mine] = s * per_shard_chunks + np.arange(len(mine))
    per_shard = tuple((n // n_shards, md) for n, md in seg_counts)
    return slot_of_chunk, per_shard


def segmented_shard_body(tree: N3Tree, lm: LeafMap, pix: torch.Tensor,
                         camera, opt: RenderOptions, skip, *, seg_counts,
                         chunk_size: int):
    """One shard of the segmented sharded frame (``render.py:217-261``):
    the single-device segmented frame (``ops.accel._frame_core``) on the
    shard's pixel ids ``pix``, whole chunks, left in ``pix`` order (the
    composite is elementwise, so the rows are the frame's).  Returns (rows
    [per, 4] composited, seg_overflow i32 [n_segments])."""
    res = _frame_core(tree, lm, pix, None, camera, opt, skip,
                      seg_counts=seg_counts, chunk_size=chunk_size,
                      return_hints=False, sorted_output=True)
    return res["img"], res["seg_overflow"]


def render_frame_fast_segmented_sharded(
        tree: N3Tree, leaf_map: LeafMap, camera, opt: RenderOptions,
        order, segments, mesh: Optional[Mesh] = None,
        chunk_size: int = 1920, skip_table: Optional[torch.Tensor] = None,
        sorted_output: bool = False, seg_counts: Optional[tuple] = None,
        chunk_costs=None):
    """The record-sorted segmented frame with the rays dealt to shards at
    chunk granularity (``render.py:297-397``): the sorted order is cut into
    ``chunk_size`` chunks, and shard s takes chunks s, s+n, s+2n, ... (the
    stride deal), so every shard gets an equal mix of cheap and expensive
    chunks and each chunk stays contiguous in sorted order.  Within a shard
    the rays stay sorted, so the per-segment budgets apply locally; the
    per-segment overflow counts are combined by MAX.  Raygen runs per shard
    from pixel ids.

    ``seg_counts`` (with ``chunk_costs``, host [n_chunks] costs of the
    sorted chunks) switches to the chunk-exact scheme: global
    ``((n_chunks, budget), ...)`` strata whose counts are multiples of the
    shard count, dealt by :func:`deal_chunks_balanced` instead of the
    stride.  Pixels are the same either way.

    Returns (img [H, W, 4], seg_overflow i32 [n_segments]), or with
    ``sorted_output`` (rows [R_padded, 4] in the shard-dealt order,
    seg_overflow, index_map [R]) where ``rows[index_map]`` is the
    pixel-order frame, bit for bit.  Every rank returns the full frame."""
    if mesh is None:
        mesh = default_mesh(device=tree.device)
    n = mesh.shape[RAY_AXIS]
    w, h = camera.width, camera.height
    R = w * h
    dev = tree.device
    perm, inv = (torch.as_tensor(o, device=dev).long() for o in order)
    cs = chunk_size
    pad = (-R) % (n * cs)
    pix = perm if not pad else torch.cat([perm, perm[-1:].expand(pad)])
    per = (R + pad) // n
    if seg_counts is not None:
        if chunk_costs is None:
            raise ValueError("the chunk-exact sharded frame needs "
                             "chunk_costs for the deal")
        slot_of_chunk, seg_counts = deal_chunks_balanced(
            chunk_costs, tuple(seg_counts), n)
        chunk_at_slot = torch.from_numpy(
            np.argsort(slot_of_chunk, kind="stable")).to(dev)
        pix_str = pix.reshape(-1, cs)[chunk_at_slot].reshape(-1)
        slot_tab = torch.from_numpy(slot_of_chunk.astype(np.int64)).to(dev)
        inv_str = slot_tab[torch.div(inv, cs, rounding_mode="floor")] * cs \
            + inv % cs
    else:
        pix_str = pix.reshape(-1, n, cs).transpose(0, 1).reshape(-1)
        # the pixel at sorted rank r lands at
        # ((r // cs) % n) * per + (r // (n * cs)) * cs + r % cs
        inv_str = (torch.div(inv, cs, rounding_mode="floor") % n) * per \
            + torch.div(inv, n * cs, rounding_mode="floor") * cs + inv % cs
        seg_counts = segment_chunks(per // cs, tuple(segments))
    s = mesh.index(RAY_AXIS)
    out, seg_ov = segmented_shard_body(
        tree, leaf_map, pix_str[s * per:(s + 1) * per], camera, opt,
        skip_table, seg_counts=seg_counts, chunk_size=cs)
    seg_ov = reduce_mesh(mesh, seg_ov, "max")
    rows = gather_rays(mesh, out)
    if sorted_output:
        return rows, seg_ov, inv_str
    return rows[inv_str].reshape(h, w, 4), seg_ov


def render_frame_sharded(tree: N3Tree, camera, opt: RenderOptions,
                         mesh: Optional[Mesh] = None,
                         track_visit: bool = False) -> torch.Tensor:
    """A full sharded exact frame (``render.py:400-423``): raygen, the
    sharded march, gather, background composite.  Returns [H, W, 4] f32."""
    if mesh is None:
        mesh = default_mesh(device=tree.device)
    dirs, vdirs, cen, R = _frame_rays(tree, camera, opt,
                                      mesh.shape[RAY_AXIS])
    res = render_rays_sharded(tree, dirs, vdirs, cen, opt, mesh,
                              track_visit=track_visit)
    img = composite_background(res.out[:R], opt)
    return img.reshape(camera.height, camera.width, 4)
