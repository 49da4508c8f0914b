"""Camera ray generation and view-direction utilities.

Counterpart of ``mega_nerf_viewer_tpu/ops/rays.py``: ``screen2worlddir``
(reference ``src/cuda/renderer_kernel.cu:31-38``) and the Rodrigues
view-direction shift (``renderer_kernel.cu:40-61``), vectorized over the
pixels on the tensors' device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import host_tensor
from .fp import fma_f32


def sq_norm(v: torch.Tensor) -> torch.Tensor:
    """``x*x + y*y + z*z`` of ``[n, 3]`` rows, accumulated with fused
    multiply-adds in the order of the JAX reference's reduction."""
    return fma_f32(v[:, 2], v[:, 2],
                   fma_f32(v[:, 1], v[:, 1], v[:, 0] * v[:, 0]))


def _cam_to_world(u: torch.Tensor, v: torch.Tensor,
                  transform: torch.Tensor):
    """Camera-space ``(u, v, -1)`` -> unit world directions ``[n, 3]``."""
    rot = transform[:3, :].to(torch.float32)             # rows r, u, b
    world = (u[:, None] * rot[0][None, :] + v[:, None] * rot[1][None, :]
             - rot[2][None, :])
    return world / torch.sqrt(sq_norm(world))[:, None]


def screen2worlddir(width: int, height: int, fx, fy, cx, cy,
                    transform: torch.Tensor):
    """Unit world-space ray directions for every pixel, row-major.

    ``transform`` is the ``[4, 3]`` camera-to-world matrix, rows (right,
    up, back, center).  Returns (dirs ``[H*W, 3]``, cen ``[3]``).
    """
    dev = transform.device
    pix = torch.arange(width * height, device=dev)
    return screen2worlddir_indices(pix, width, fx, fy, cx, cy, transform)


def screen2worlddir_indices(pix: torch.Tensor, width: int, fx, fy, cx, cy,
                            transform: torch.Tensor):
    """Ray directions for the flat pixel indices ``pix``, in that order."""
    f32 = torch.float32
    x = (pix % width).to(f32)
    y = torch.div(pix, width, rounding_mode="floor").to(f32)
    # one copy of the four intrinsics, f32-rounded like torch.as_tensor
    intr = host_tensor(np.asarray([float(a) for a in (fx, fy, cx, cy)],
                                  np.float32), f32, pix.device)
    fx, fy, cx, cy = intr[0], intr[1], intr[2], intr[3]
    u = (x + 0.5 - cx) / fx
    v = -(y + 0.5 - cy) / fy
    return _cam_to_world(u, v, transform), transform[3, :].to(f32)


def rodrigues(aa, dirs: torch.Tensor) -> torch.Tensor:
    """Rotate ``dirs`` by the axis-angle vector ``aa`` (Rodrigues formula);
    a no-op below angle 1e-6, like the reference."""
    aa = np.asarray(aa, np.float32).reshape(3)
    angle = np.sqrt(np.sum(aa * aa, dtype=np.float32))
    if angle < 1e-6:
        return dirs
    k_np = aa / angle
    cos_a, sin_a = float(np.cos(angle)), float(np.sin(angle))
    k = host_tensor(k_np, torch.float32, dirs.device)
    cross = torch.cross(k.expand_as(dirs), dirs, dim=-1)
    dot = (dirs * k).sum(-1, keepdim=True)
    return dirs * cos_a + cross * sin_a + k * dot * (1.0 - cos_a)
