"""The reference of a kept voxel frame (the displayed frame of the leaf-map
or exact path): :func:`render.voxel_frame`, unchanged."""

import torch

from perfbench.reference.render import voxel_frame


def frame(tree, cam: dict, opt: dict, shade_dtype=torch.float32,
          model=None):
    """The voxel frame [H, W, 4] at ``cam``; a voxel frame reads no
    model."""
    return voxel_frame(tree, cam, opt, shade_dtype=shade_dtype)
