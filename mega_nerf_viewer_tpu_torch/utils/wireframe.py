"""Headless octree wireframe overlay (a copy of
``mega_nerf_viewer_tpu/utils/wireframe.py``: host numpy, float64
intermediates, so the buffers are bit-equal to the JAX package's).

Replaces the reference's GL mesh pass (``src/mesh.cpp`` +
``maybe_gen_wire``, cuda_renderer.cpp:545-551): the octree leaf AABBs are
projected with the camera's K / w2c and rasterized as depth-tested lines
into a color + linear-depth overlay.  The volume renderer then composites
against it exactly like the CUDA kernel composites against the mesh
surfaces: the line depth becomes the per-ray ``tmax_bg``
(renderer_kernel.cu:277-280) and the line color is the pre-existing
framebuffer color read by ``composite_and_write``
(renderer_kernel.cu:260-263).

Segments crossing the near plane are CLIPPED at it in camera space (the
GL clipper's behavior) and depth is interpolated perspective-correctly
along the screen-space line, matching the GL rasterizer's varying
interpolation of ``FragPos`` (the shader stores ``length(FragPos.xyz)``).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

# The 12 edges of a box as corner-index pairs (corners indexed by xyz bits)
_EDGES = [(0, 1), (0, 2), (0, 4), (1, 3), (1, 5), (2, 3), (2, 6),
          (3, 7), (4, 5), (4, 6), (5, 7), (6, 7)]

_Z_NEAR = np.float32(1e-3)


def rasterize_boxes(boxes: np.ndarray, camera,
                    color=(0.0, 0.0, 0.0),
                    max_depth_px: float = 1e9
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Rasterize world AABB wireframes.

    Args:
      boxes: [n, 6] world AABBs (min_xyz, max_xyz) from
        ``N3Tree.gen_wireframe``.
      camera: Camera (uses w2c and intrinsics).

    Returns (color [H, W, 3] f32, depth [H, W] f32 Euclidean camera
    distance, 1e9 where no line).  Matches the reference mesh shader,
    which writes ``length(FragPos.xyz)`` to its depth attachment and
    black unlit vertex color for the wire grid (``src/mesh.cpp`` frag
    shader; ``_push_wireframe_bb`` zero color, ``n3tree.cpp:249-259``).
    """
    h, w = camera.height, camera.width
    color_buf = np.zeros((h, w, 3), np.float32)
    depth_buf = np.full((h, w), max_depth_px, np.float32)
    if len(boxes) == 0:
        return color_buf, depth_buf

    # corners [n, 8, 3]
    lo, hi = boxes[:, :3], boxes[:, 3:]
    corners = np.stack([
        np.where(np.array([(i >> 2) & 1, (i >> 1) & 1, i & 1], bool),
                 hi, lo) for i in range(8)], axis=1)

    w2c = camera.w2c  # [4,4]
    cam_pts = corners @ w2c[:3, :3].T + w2c[:3, 3]      # [n, 8, 3]
    ea = np.array([a for a, _ in _EDGES])
    eb = np.array([b for _, b in _EDGES])
    p0 = cam_pts[:, ea].reshape(-1, 3)                  # [n*12, 3]
    p1 = cam_pts[:, eb].reshape(-1, 3)
    draw_lines_cam(color_buf, depth_buf, p0, p1, camera,
                   np.asarray(color, np.float32))
    return color_buf, depth_buf


def draw_lines_cam(color_buf, depth_buf, p0, p1, camera, col):
    """Depth-tested line rasterization of camera-space segments.

    Vectorized over segments and steps.  Near-plane crossing segments are
    clipped at z == _Z_NEAR in camera space before projection; depth is
    the perspective-correct Euclidean distance along the line.
    """
    h, w = depth_buf.shape
    z0 = -p0[:, 2]
    z1 = -p1[:, 2]
    keep = (z0 > _Z_NEAR) | (z1 > _Z_NEAR)
    p0, p1, z0, z1 = p0[keep], p1[keep], z0[keep], z1[keep]
    if len(p0) == 0:
        return
    # clip the behind endpoint to the near plane (lerp in camera space)
    denom = np.where(z1 == z0, 1.0, z1 - z0)
    tc = (_Z_NEAR - z0) / denom
    clip0 = z0 <= _Z_NEAR
    clip1 = z1 <= _Z_NEAR
    pc = p0 + (p1 - p0) * tc[:, None]
    p0 = np.where(clip0[:, None], pc, p0)
    p1 = np.where(clip1[:, None], pc, p1)
    z0 = np.maximum(z0, _Z_NEAR)
    z1 = np.maximum(z1, _Z_NEAR)

    x0 = camera.cx + camera.fx * (p0[:, 0] / z0)
    y0 = camera.cy - camera.fy * (p0[:, 1] / z0)
    x1 = camera.cx + camera.fx * (p1[:, 0] / z1)
    y1 = camera.cy - camera.fy * (p1[:, 1] / z1)
    d0 = np.linalg.norm(p0, axis=-1)
    d1 = np.linalg.norm(p1, axis=-1)

    length = np.maximum(np.abs(x1 - x0), np.abs(y1 - y0))
    n_steps = np.clip(length.astype(np.int64) + 1, 1, 4 * max(h, w))
    # flatten (segment, step) pairs: seg_of[k], step_of[k]
    total = int(n_steps.sum()) + len(n_steps)
    seg_of = np.repeat(np.arange(len(n_steps)), n_steps + 1)
    ends = np.cumsum(n_steps + 1)
    step_of = np.arange(total) - np.repeat(ends - (n_steps + 1),
                                           n_steps + 1)
    t = step_of / n_steps[seg_of]                        # [total] in [0,1]
    xs = np.round(x0[seg_of] + (x1 - x0)[seg_of] * t).astype(np.int64)
    ys = np.round(y0[seg_of] + (y1 - y0)[seg_of] * t).astype(np.int64)
    # perspective-correct depth: lerp(p/z) / lerp(1/z), GL-style
    iz = (1.0 - t) / z0[seg_of] + t / z1[seg_of]
    dz = (1.0 - t) * (d0 / z0)[seg_of] + t * (d1 / z1)[seg_of]
    zs = (dz / iz).astype(np.float32)
    ok = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    xs, ys, zs = xs[ok], ys[ok], zs[ok]
    # two-pass depth test: min-reduce, then write color where we won
    np.minimum.at(depth_buf, (ys, xs), zs)
    won = zs <= depth_buf[ys, xs]
    color_buf[ys[won], xs[won]] = col


def grid_overlay(tree, camera, grid_max_depth: int):
    """Wireframe overlay for ``show_grid`` (RenderOptions.show_grid /
    grid_max_depth; reference main.cpp:230-238)."""
    boxes = tree.gen_wireframe(grid_max_depth)
    return rasterize_boxes(boxes, camera)
