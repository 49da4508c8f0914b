"""Headless render API (counterpart of ``mega_nerf_viewer_tpu/api.py``).

Replaces the reference's GLFW/ImGui event loop and ``VolumeRenderer`` facade
(``include/renderer/renderer.hpp:9-40``) with a functional API matching the
reference CLI's octree_path semantics and pixel output.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .camera import Camera
from .n3tree import N3Tree
from .options import RenderOptions
from .ops import accel
from .ops.render import render_frame, to_rgba8
from .utils.png import write_png


def load_tree(octree_path: str, max_capacity: Optional[int] = None,
              bounds_only: bool = False, device=None) -> N3Tree:
    """Load a PlenOctree npz onto ``device`` (``None``: the CUDA card;
    reference ``N3Tree::open`` + ``move_to_device``)."""
    return N3Tree.open(octree_path, max_capacity=max_capacity,
                       bounds_only=bounds_only, device=device)


def render(tree: N3Tree,
           camera: Optional[Camera] = None,
           options: Optional[RenderOptions] = None,
           out_path: Optional[str] = None,
           fast: bool = False,
           leaf_map=None) -> np.ndarray:
    """Render one frame on the tree's device; optionally write a PNG.

    Returns the ``[H, W, 4]`` float32 RGBA image (background-composited),
    the reference's offscreen pixel output (``renderer_kernel.cu:215-241``).
    ``fast=True`` takes the leaf-map path (pass a prebuilt ``leaf_map`` to
    reuse it) and falls back to the exact renderer when the record budget
    overflows, so the pixels are the exact frame's either way."""
    camera = camera or Camera()
    options = options or RenderOptions()
    camera._update()
    exact_args = (tree, camera.width, camera.height, camera.fx, camera.fy,
                  camera.cx, camera.cy, camera.transform, options)
    if fast:
        if leaf_map is None:
            leaf_map = accel.build_leaf_map(tree)
        img, overflow, _ = accel.render_frame_fast(tree, leaf_map, camera,
                                                   options)
        if int(overflow):
            img, _ = render_frame(*exact_args)
    else:
        img, _ = render_frame(*exact_args)
    if out_path is not None:
        write_png(out_path, to_rgba8(img).cpu().numpy())
    return img.cpu().numpy()
