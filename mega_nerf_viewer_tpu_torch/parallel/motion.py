"""Sharded re-hint motion frames over the ranks of a mesh.

Counterpart of ``mega_nerf_viewer_tpu/parallel/motion.py``.  A moved pose
is a quarter-resolution count march (kernel A at budget 0, after the
prepass B), a sort by the measured keys and the segmented march at steady
budgets (``ops/accel._motion_core``).  Everything is shard-local except
one step: a shard's pixels take their sort keys from neighbouring quarter
samples that other shards measured.  So a pose runs one data collective,
the SUM of the shards' disjoint quarter-key scatters (JAX's ``psum``),
then the SUM of the per-segment overflow counts; the rows, the sorted
pixel ids and the next quarter order are gathered so every rank holds
the full frame.

Full-resolution and quarter pixels are chunk-dealt to the shards once per
episode from a steady order (:func:`motion_episode_layout`), and each shard
re-sorts its own pixels every pose.  The segment layout is the same on
every rank, derived from the same ``segments``.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..n3tree.tree import N3Tree
from ..ops.accel import (LeafMap, _sort_by_key, pack_hints, render_rays_fast,
                         segment_chunks)
from ..ops.rays import rodrigues, screen2worlddir_indices
from ..options import RenderOptions
from .mesh import (RAY_AXIS, Mesh, all_reduce, default_mesh, gather_rays,
                   reduce_mesh)
from .render import segmented_shard_body

# the pixel id of a dealt padding row: raygen clips it to a real ray, the
# scatters drop it, and its sort key pins it to the last segment
_PAD = 1 << 30
_PAD_KEY = 1 << 26        # above any packed hint key (26 bits)


def _deal(perm: torch.Tensor, n: int, cs: int) -> torch.Tensor:
    """A sorted pixel order dealt to ``n`` shards at ``cs`` granularity
    (shard s takes sorted chunks s, s+n, ...), padded with ``_PAD``
    (``motion.py:52-62``).  Returns the flat [Rp] layout, shard-major."""
    perm = torch.as_tensor(perm).to(torch.int32)
    pad = (-perm.shape[0]) % (n * cs)
    pix = perm if not pad else torch.cat(
        [perm, perm.new_full((pad,), _PAD)])
    return pix.reshape(-1, n, cs).transpose(0, 1).reshape(-1)


def motion_episode_layout(order: tuple, qperm: torch.Tensor,
                          mesh: Optional[Mesh] = None,
                          chunk_size: int = 2176,
                          hint_chunk: int = 2176) -> tuple:
    """The shard layout of a motion episode (``motion.py:65-80``):
    ``order`` = (perm, inv) at the episode's steady pose and ``qperm`` the
    steady quarter order (``accel.quarter_order_from_packed``), both dealt
    once.  Returns (pix_str [Rp], qpix_str [Qp]) i32, shard-major."""
    if mesh is None:
        mesh = default_mesh(device=torch.as_tensor(qperm).device)
    n = mesh.shape[RAY_AXIS]
    return _deal(order[0], n, chunk_size), _deal(qperm, n, hint_chunk)


def _raygen(p, transform, intr, rot_dirs, width: int, R_full: int):
    """Raygen from pixel ids; ``_PAD`` clips to the last pixel."""
    pc = torch.clamp_max(p, R_full - 1)
    dirs_p, cen = screen2worlddir_indices(pc, width, *intr, transform)
    return rodrigues(rot_dirs, dirs_p), dirs_p, cen


def _quarter_shard_body(tree, lm, qpix, transform, intr, rot_dirs, skip, *,
                        opt: RenderOptions, hint_chunk: int, width: int,
                        qw: int, qh: int):
    """Pass 1 of a shard (``motion.py:94-122``): the quarter count march
    and the shard's part of the quarter key image (a disjoint scatter the
    caller sums).  Returns (qimg_part [qh*qw] i32, qpix_next)."""
    Q = qpix.shape[0]
    qpad = (-Q) % hint_chunk
    qpix_p = qpix if not qpad else torch.cat(
        [qpix, qpix.new_full((qpad,), _PAD)])
    vq, dq, cen = _raygen(qpix_p, transform, intr, rot_dirs, width,
                          width * qh * 2)
    qres = render_rays_fast(
        tree, lm, dq, vq, cen, opt, max_dense=0,
        chunk_size=hint_chunk if qpix_p.shape[0] > hint_chunk else 0,
        skip_table=skip)
    real = qpix < _PAD
    qkey = pack_hints(qres.steps, qres.nrec, qres.skips)[:Q]
    qkey = torch.where(real, qkey, torch.full_like(qkey, _PAD_KEY))
    # the shard's fresh quarter order, for the next pose's pass 1
    qpix_next = _sort_by_key(qkey, qpix)
    qy = torch.div(qpix, width, rounding_mode="floor")
    qx = qpix - qy * width
    qidx = torch.where(real, (qy >> 1) * qw + (qx >> 1),
                       torch.full_like(qpix, qw * qh)).long()
    qimg = torch.zeros((qw * qh + 1,), dtype=torch.int32, device=qpix.device)
    qimg[qidx] = qkey
    return qimg[:qw * qh], qpix_next


def _full_shard_body(tree, lm, qimg, pix, camera, skip, *,
                     opt: RenderOptions, seg_counts, chunk_size: int,
                     qw: int, qh: int):
    """Pass 2 of a shard (``motion.py:125-171``): pool the summed quarter
    image, sort the shard's pixels by the pooled keys, march the segments
    (:func:`~.render.segmented_shard_body`; ``_PAD`` clips to the last
    pixel).  Returns (rows, seg_overflow, pix_sorted, cdf [6])."""
    width = camera.width
    q = qimg.reshape(qh, qw)
    # forward 2x2 max: a block's pixels lie between forward samples
    for ax in (0, 1):
        q = torch.maximum(q, torch.roll(q, -1, ax))
    qflat = q.reshape(-1)
    # each pooled cell covers 4 pixels: counts x4, the max unchanged
    cls = qflat >> 18
    cdf = torch.stack([(cls <= c).sum().to(torch.int32) * 4
                       for c in (0, 1, 2, 4, 8)] + [cls.max()])
    real = pix < _PAD
    py = torch.div(pix, width, rounding_mode="floor")
    px = pix - py * width
    key_pix = torch.where(
        real, q[(py >> 1).clamp_max(qh - 1).long(),
                (px >> 1).clamp_max(qw - 1).long()],
        torch.full_like(pix, _PAD_KEY))
    pix_sorted = _sort_by_key(key_pix, pix)
    rows, seg_ov = segmented_shard_body(
        tree, lm, torch.clamp_max(pix_sorted, width * qh * 2 - 1), camera,
        opt, skip, seg_counts=seg_counts, chunk_size=chunk_size)
    return rows, seg_ov, pix_sorted, cdf


def render_frame_motion_sharded(
        tree: N3Tree, leaf_map: LeafMap, camera, opt: RenderOptions,
        qpix_str: torch.Tensor, pix_str: torch.Tensor, segments,
        mesh: Optional[Mesh] = None, chunk_size: int = 2176,
        hint_chunk: int = 2176, skip_table: Optional[torch.Tensor] = None,
        sorted_output: bool = False):
    """One sharded re-hint motion pose (``motion.py:226-275``).

    ``pix_str`` / ``qpix_str`` come from :func:`motion_episode_layout`; the
    returned ``qpix_next`` is the next pose's ``qpix_str`` (it stays
    dealt).  ``segments`` should be a margin-1 ``segments_from_hint_cdf``
    derivation, refreshed from the returned ``cdf`` as on one device.
    Frame sizes must be even.

    Returns (img [H, W, 4], seg_overflow i32 [n_segments] summed over the
    shards, qpix_next, cdf [6]); with ``sorted_output``, (rows [Rp, 4] in
    the shard-dealt sorted order, pix_sorted [Rp], seg_overflow,
    qpix_next, cdf), where ``pix_sorted`` maps each row to its pixel."""
    w, h = camera.width, camera.height
    if w % 2 or h % 2:
        raise ValueError("sharded motion needs even frame dimensions")
    if mesh is None:
        mesh = default_mesh(device=tree.device)
    n = mesh.shape[RAY_AXIS]
    R = w * h
    dev = tree.device
    pix_str = torch.as_tensor(pix_str, device=dev).to(torch.int32)
    qpix_str = torch.as_tensor(qpix_str, device=dev).to(torch.int32)
    per = pix_str.shape[0] // n
    qper = qpix_str.shape[0] // n
    seg_counts = segment_chunks(per // chunk_size, tuple(segments))
    s = mesh.index(RAY_AXIS)
    transform = torch.as_tensor(camera.transform, dtype=torch.float32,
                                device=dev)
    intr = (camera.fx, camera.fy, camera.cx, camera.cy)
    qw, qh = w // 2, h // 2
    qimg, qpix_next = _quarter_shard_body(
        tree, leaf_map, qpix_str[s * qper:(s + 1) * qper], transform, intr,
        opt.rot_dirs, skip_table, opt=opt, hint_chunk=hint_chunk, width=w,
        qw=qw, qh=qh)
    qimg = all_reduce(qimg, "sum", mesh.group(RAY_AXIS))
    rows, seg_ov, pix_sorted, cdf = _full_shard_body(
        tree, leaf_map, qimg, pix_str[s * per:(s + 1) * per], camera,
        skip_table, opt=opt, seg_counts=seg_counts, chunk_size=chunk_size,
        qw=qw, qh=qh)
    seg_ov = reduce_mesh(mesh, seg_ov, "max", ray_op="sum")
    rows = gather_rays(mesh, rows)
    pix_sorted = gather_rays(mesh, pix_sorted)
    qpix_next = gather_rays(mesh, qpix_next)
    if sorted_output:
        return rows, pix_sorted, seg_ov, qpix_next, cdf
    img = torch.zeros((R + 1, 4), dtype=torch.float32, device=dev)
    img[pix_sorted.clamp_max(R).long()] = rows
    return img[:R].reshape(h, w, 4), seg_ov, qpix_next, cdf

