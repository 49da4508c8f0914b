"""Scalar numpy oracle renderer — the golden correctness model (counterpart
of ``mega_nerf_viewer_tpu/ops/oracle.py``: the same scalar code; the SH
basis and the image's rays come from the port's ``ops/sh.py`` and
``ops/rays.py``, on the CPU).

A direct, deliberately-slow transliteration of the reference's per-ray
device code (``include/cuda/rt_core.cuh``) in strict float32 numpy (the
CUDA kernels run with scalar_t = float; f16 data is widened on load).
The exact renderer and its kernel are validated against this module in
tests.  It is not a production path.

Semantics covered (with reference anchors):
  * ``_dda_world`` bbox clip                      rt_core.cuh:71-86
  * ``_dda_unit`` subcube exit                    rt_core.cuh:89-100
  * ``_get_delta_scale``                          rt_core.cuh:103-115
  * ``query_single_from_root`` octree descent     rt_core.cuh:117-159
  * ``render_voxels_trace_ray`` march/composite   rt_core.cuh:162-332
    including split/sample votes, early-stop 1/(1-T) renorm, depth mode.
"""

from __future__ import annotations

import numpy as np
import torch

from ..options import RenderOptions
from .sh import eval_sh_basis

f32 = np.float32


def dda_world(cen, invdir, render_bbox):
    """Ray/bbox clip (reference rt_core.cuh:71-86)."""
    tmin, tmax = f32(0.0), f32(1e4)
    for i in range(3):
        t1 = (f32(render_bbox[i]) + f32(1e-6) - cen[i]) * invdir[i]
        t2 = (f32(render_bbox[i + 3]) - f32(1e-6) - cen[i]) * invdir[i]
        tmin = max(tmin, min(t1, t2))
        tmax = min(tmax, max(t1, t2))
    return tmin, tmax


def dda_unit(cen, invdir):
    """Exit distance from the unit cube (reference rt_core.cuh:89-100)."""
    tmax = f32(1e4)
    for i in range(3):
        t1 = -cen[i] * invdir[i]
        t2 = t1 + invdir[i]
        tmax = min(tmax, max(t1, t2))
    return tmax


def query_single_from_root(child, xyz, N):
    """Octree descent (reference rt_core.cuh:117-159).

    Returns (chunk_idx, child_idx, depth, xyz_frac, visited_chunks);
    xyz_frac is the fractional position within the found leaf.
    """
    xyz = np.clip(np.asarray(xyz, f32), f32(0.0), f32(1.0) - f32(1e-6))
    chunk = 0
    depth = 1
    visited = []
    while True:
        visited.append(chunk)
        idx = 0
        for i in range(3):
            xyz[i] = xyz[i] * f32(N)
            d = np.floor(xyz[i])
            idx = int(idx * N + d)
            xyz[i] = xyz[i] - d
        skip = int(child[chunk, idx])
        if skip == 0:
            return chunk, idx, depth, xyz, visited
        depth += 1
        chunk += skip


def _precalc_basis(fmt, opt: RenderOptions, vdir):
    if fmt.format == "SH" and fmt.basis_dim >= 1:
        basis = eval_sh_basis(
            fmt.basis_dim, torch.from_numpy(np.asarray(vdir, f32)[None]))
        basis = basis[0].numpy().astype(f32)
        lo, hi = opt.basis_minmax
        basis[:min(lo, len(basis))] = 0.0
        basis[hi + 1:] = 0.0
        return basis
    return None


def trace_ray(tree_host, dir_world, vdir, cen_world, opt: RenderOptions,
              tmax_bg: float = 1e9):
    """Render one ray (reference render_voxels_trace_ray, rt_core.cuh:162-332).

    Args:
      tree_host: dict with numpy arrays ``data [C,N3,D] f16``, ``child``,
        ``sample_counts``, ``scale [3]``, ``offset [3]``, ``N``,
        ``data_format`` (DataFormat).
      dir_world: unit world ray dir; vdir: (possibly rotated) view dir used
        for SH; cen_world: world camera center.

    Returns (out[4] rgba, split_vote[3] = [priority, chunk, child],
    sample_vote[3], visited chunk id list).
    """
    data = tree_host["data"]
    child = tree_host["child"]
    sample_counts = tree_host["sample_counts"]
    scale = np.asarray(tree_host["scale"], f32)
    offset = np.asarray(tree_host["offset"], f32)
    N = tree_host["N"]
    fmt = tree_host["data_format"]
    data_dim = data.shape[-1]
    basis_dim = fmt.basis_dim

    out = np.zeros(4, f32)
    split_vote = np.array([opt.max_depth + 1, -1.0, -1.0], f32)
    sample_vote = np.array([opt.max_sample_count + 1, -1.0, -1.0], f32)
    visited_all = []

    # world -> tree transform (renderer_kernel.cu:273-275)
    cen = offset + scale * np.asarray(cen_world, f32)
    d = np.asarray(dir_world, f32) * scale
    delta_scale = f32(1.0) / np.linalg.norm(d).astype(f32)
    d = (d * delta_scale).astype(f32)
    tmax_bg = f32(tmax_bg) / delta_scale

    invdir = (f32(1.0) / (d + f32(1e-9))).astype(f32)
    tmin, tmax = dda_world(cen, invdir, opt.render_bbox)
    tmax = min(tmax, tmax_bg)

    if tmax < 0 or tmin > tmax:
        if opt.render_depth:
            out[3] = 1.0
        return out, split_vote, sample_vote, visited_all

    basis = _precalc_basis(fmt, opt, vdir)

    T = f32(1.0)
    t = f32(tmin)
    max_weight = f32(-1.0)
    max_sample_weight = f32(-1.0)

    while t < tmax:
        pos = (cen + t * d).astype(f32)
        chunk, cidx, depth, frac, visited = query_single_from_root(
            child, pos, N)
        visited_all.extend(visited)
        cube_size = f32(N) ** f32(depth)
        t_subcube = dda_unit(frac, invdir) / cube_size
        delta_t = t_subcube + f32(opt.step_size)
        sigma = f32(data[chunk, cidx, data_dim - 1])

        if sigma > f32(opt.sigma_thresh):
            att = np.exp(f32(-delta_t * delta_scale * sigma)).astype(f32)
            weight = T * (f32(1.0) - att)

            if weight > max_weight and depth < opt.max_depth:
                split_vote[:] = (depth, chunk, cidx)
                max_weight = weight
            sc = int(sample_counts[chunk, cidx])
            if weight > max_sample_weight and sc < opt.max_sample_count:
                sample_vote[:] = (sc, chunk, cidx)
                max_sample_weight = weight

            if opt.render_depth:
                out[0] += weight * t
            else:
                leaf = data[chunk, cidx].astype(f32)
                if basis is not None:
                    for c in range(3):
                        coeff = leaf[c * basis_dim:(c + 1) * basis_dim]
                        tmp = f32(np.dot(basis, coeff))
                        out[c] += weight / (f32(1.0) + np.exp(-tmp))
                else:
                    out[:3] += leaf[:3] * weight

            T = T * att
            if T < f32(opt.stop_thresh):
                if opt.render_depth:
                    out[0] = out[1] = out[2] = min(out[0] * f32(0.3), f32(1.0))
                s = f32(1.0) / (f32(1.0) - T)
                out[:3] *= s
                out[3] = 1.0
                return out, split_vote, sample_vote, visited_all
        else:
            if max_weight == f32(-1.0) and depth < opt.max_depth:
                split_vote[:] = (depth, chunk, cidx)
            sc = int(sample_counts[chunk, cidx])
            if (max_sample_weight == f32(-1.0)
                    and sc < opt.max_sample_count):
                sample_vote[:] = (sc, chunk, cidx)

        t = t + delta_t

    if opt.render_depth:
        out[0] = out[1] = out[2] = min(out[0] * f32(0.3), f32(1.0))
        out[3] = 1.0
    else:
        out[3] = f32(1.0) - T
    return out, split_vote, sample_vote, visited_all


def tree_to_host(tree) -> dict:
    """Pull an N3Tree's live arrays to numpy for the oracle."""
    cap = int(tree.capacity)
    return dict(
        data=tree.data[:cap].cpu().numpy(),
        child=tree.child[:cap].cpu().numpy(),
        sample_counts=tree.sample_counts[:cap].cpu().numpy(),
        scale=tree.scale.cpu().numpy(),
        offset=tree.offset.cpu().numpy(),
        N=tree.N,
        data_format=tree.data_format,
    )


def render_image(tree, camera, opt: RenderOptions,
                 max_pixels: int = 1 << 22) -> np.ndarray:
    """Render a full image with the oracle (slow; tests/tiny images only).

    Applies the offscreen composite of ``composite_and_write``
    (renderer_kernel.cu:215-241): rgb += bg * (1 - alpha).
    """
    from .rays import screen2worlddir, rodrigues

    host = tree_to_host(tree)
    dirs, cen = screen2worlddir(
        camera.width, camera.height, camera.fx, camera.fy,
        camera.cx, camera.cy,
        torch.as_tensor(np.asarray(camera.transform, f32)))
    vdirs = rodrigues(opt.rot_dirs, dirs).numpy()
    dirs = dirs.numpy()
    cen = cen.numpy()
    n = dirs.shape[0]
    assert n <= max_pixels, "oracle is for tiny images only"
    img = np.zeros((n, 4), f32)
    for i in range(n):
        out, _, _, _ = trace_ray(host, dirs[i], vdirs[i], cen, opt)
        out[:3] += f32(opt.background_brightness) * (f32(1.0) - out[3])
        img[i] = out
    return img.reshape(camera.height, camera.width, 4)
