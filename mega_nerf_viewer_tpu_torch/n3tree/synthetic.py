"""Synthetic octree builders for tests and benchmarks (numpy).

Counterpart of ``mega_nerf_viewer_tpu/n3tree/synthetic.py``: the builders
are the same numpy code, so their arrays equal the JAX package's; only the
final :class:`N3Tree` holds tensors on ``device``.

The reference ships no test fixtures (it has no tests at all); these
builders construct svox-schema trees from scratch so every renderer and
refinement op can be validated hermetically.  Topology is grown exactly the
way the reference's dynamic refinement grows trees (one chunk appended at
the tail per split, relative child offsets, packed parent links —
``src/cuda/renderer_kernel.cu:170-198``), so the fixtures double as
ground truth for the refinement ops.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from .data_format import DataFormat
from .tree import N3Tree


def build_host_tree(depth_map: Callable[[np.ndarray, int], bool],
                    data_fn: Callable[[np.ndarray, float], np.ndarray],
                    data_dim: int,
                    basis_dim: int,
                    N: int = 2,
                    scale=(0.5, 0.5, 0.5),
                    offset=(0.5, 0.5, 0.5),
                    max_chunks: int = 100000):
    """Grow a tree by predicate-driven subdivision.

    Args:
      depth_map: (voxel_center_tree_coords [3], depth) -> True to subdivide
        that voxel one more level.  depth starts at 1 for root leaves
        (matching the traversal's depth convention, ``rt_core.cuh:129-158``).
      data_fn: (voxel_center_tree_coords [3], voxel_size) -> data_dim values
        (SH coeffs channel-major + sigma last).
      data_dim, basis_dim: payload geometry; data_dim == 3*basis_dim + 1.

    Returns host arrays (data, child, parent, scale, offset, fmt).
    """
    N3 = N ** 3
    child = [np.zeros(N3, np.int32)]
    parent = [np.int32(0)]
    # (corner in [0,1] tree coords, depth) of each chunk; root covers [0,1]
    chunk_corner = [np.zeros(3, np.float64)]
    chunk_depth = [1]

    # BFS expansion
    q = [0]
    while q:
        c = q.pop(0)
        corner, depth = chunk_corner[c], chunk_depth[c]
        size = float(N) ** (-depth)
        for ci in range(N3):
            dx, dy, dz = ci // (N * N), (ci // N) % N, ci % N
            vc = corner + (np.array([dx, dy, dz], np.float64) + 0.5) * size
            if depth_map(vc, depth) and len(child) < max_chunks:
                nc = len(child)
                child[c][ci] = nc - c
                child.append(np.zeros(N3, np.int32))
                parent.append(np.int32(c * N3 + ci))
                chunk_corner.append(corner + np.array(
                    [dx, dy, dz], np.float64) * size)
                chunk_depth.append(depth + 1)
                q.append(nc)

    ncap = len(child)
    data = np.zeros((ncap, N3, data_dim), np.float16)
    for c in range(ncap):
        corner, depth = chunk_corner[c], chunk_depth[c]
        size = float(N) ** (-depth)
        for ci in range(N3):
            dx, dy, dz = ci // (N * N), (ci // N) % N, ci % N
            vc = corner + (np.array([dx, dy, dz], np.float64) + 0.5) * size
            data[c, ci] = np.asarray(data_fn(vc, size), np.float32).astype(
                np.float16)
    fmt = DataFormat(format="SH", basis_dim=basis_dim)
    return (data, np.stack(child), np.asarray(parent, np.int32),
            np.asarray(scale, np.float32), np.asarray(offset, np.float32),
            fmt)


def sphere_tree(basis_dim: int = 1, depth: int = 3,
                max_capacity: Optional[int] = None,
                sigma_inside: float = 20.0,
                seed: int = 0, N: int = 2, device=None) -> N3Tree:
    """A tree refined around a sphere surface — the standard test fixture.

    Voxels near the sphere of radius 0.3 centered at (0.5,0.5,0.5) in tree
    coords are subdivided to ``depth``; inside voxels get ``sigma_inside``
    and smooth random-ish SH coefficients; outside is empty.
    """
    data_dim = 3 * basis_dim + 1

    def depth_map(vc, d):
        r = np.linalg.norm(vc - 0.5)
        return d < depth and abs(r - 0.3) < 0.9 * (N ** float(-d))

    def data_fn(vc, size):
        r = np.linalg.norm(vc - 0.5)
        out = np.zeros(data_dim, np.float32)
        if r < 0.3 + size:
            out[-1] = sigma_inside
            # deterministic smooth coefficients from position
            for c in range(3):
                out[c * basis_dim] = np.sin(
                    7.0 * vc[c] + c) * 1.5  # DC component
                for b in range(1, basis_dim):
                    out[c * basis_dim + b] = 0.3 * np.cos(
                        5.0 * vc[(c + b) % 3] + b)
        return out

    host = build_host_tree(depth_map, data_fn, data_dim, basis_dim, N=N)
    data, child, parent, scale, offset, fmt = host
    return N3Tree.from_arrays(data, child, parent, scale, offset, fmt,
                              max_capacity=max_capacity, device=device)


def shell_tree(depth: int = 7, basis_dim: int = 9,
               max_capacity: Optional[int] = None,
               radius: float = 0.35, sigma_inside: float = 40.0,
               seed: int = 0, N: int = 2,
               max_chunks: int = 8_000_000, device=None) -> N3Tree:
    """Large benchmark tree: fully-vectorized level-wise subdivision
    around a sphere shell (Mill-19-style occupancy: a thin dense surface
    inside a big empty volume).  Scales to millions of chunks — the
    recursive :func:`build_host_tree` is for tiny test fixtures only.
    """
    N3 = N ** 3
    data_dim = 3 * basis_dim + 1

    slot = np.arange(N3)
    slot_off = np.stack([slot // (N * N), (slot // N) % N, slot % N],
                        axis=-1).astype(np.float64)          # [N3, 3]

    parent_rows = [np.zeros(1, np.int32)]
    corner_rows = [np.zeros((1, 3), np.float64)]
    links = []                                        # (parents, slots, offs)
    frontier = np.array([0], np.int64)                # chunk ids at level
    frontier_corner = np.zeros((1, 3), np.float64)
    n_chunks = 1

    for d in range(1, depth):
        size = float(N) ** (-d)
        # voxel centers of all frontier slots: [F, N3, 3]
        centers = (frontier_corner[:, None, :]
                   + (slot_off[None, :, :] + 0.5) * size)
        r = np.linalg.norm(centers - 0.5, axis=-1)
        split = np.abs(r - radius) < 0.9 * size       # near the shell
        f_idx, s_idx = np.nonzero(split)
        n_new = len(f_idx)
        if n_new == 0:
            break
        if n_chunks + n_new > max_chunks:
            keep = max_chunks - n_chunks
            f_idx, s_idx = f_idx[:keep], s_idx[:keep]
            n_new = keep
        new_ids = n_chunks + np.arange(n_new)
        parents = frontier[f_idx]
        parent_rows.append((parents * N3 + s_idx).astype(np.int32))
        new_corners = frontier_corner[f_idx] + slot_off[s_idx] * size
        corner_rows.append(new_corners)
        links.append((parents, s_idx, (new_ids - parents).astype(np.int32)))
        n_chunks += n_new
        frontier = new_ids
        frontier_corner = new_corners
        if n_chunks >= max_chunks:
            break

    child = np.zeros((n_chunks, N3), np.int32)
    parent = np.concatenate(parent_rows, axis=0)
    corners = np.concatenate(corner_rows, axis=0)
    for parents, s_idx, offsets in links:
        child[parents, s_idx] = offsets

    # depth of each chunk (levels of its leaves): root leaves at depth 1
    depths = np.zeros(n_chunks, np.int32)
    start = 1
    for lvl, (parents, _, _) in enumerate(links, start=1):
        depths[start:start + len(parents)] = lvl
        start += len(parents)

    # data: empty outside, dense sigma near/inside the shell
    sizes = (float(N) ** -(depths + 1))[:, None]
    centers = corners[:, None, :] + (slot_off[None, :, :] + 0.5) * sizes[:, :, None]
    r = np.linalg.norm(centers - 0.5, axis=-1)        # [C, N3]
    inside = r < radius + sizes
    data = np.zeros((n_chunks, N3, data_dim), np.float16)
    data[..., -1] = np.where(inside, sigma_inside, 0.0).astype(np.float16)
    coeff = (0.3 * np.sin(7.0 * centers.sum(-1)))[..., None]
    for c in range(3):
        data[..., c * basis_dim] = (np.sin(5.0 * centers[..., c] + c)
                                    * inside).astype(np.float16)
        if basis_dim > 1:
            data[..., c * basis_dim + 1: (c + 1) * basis_dim] = (
                coeff * inside[..., None]).astype(np.float16)

    fmt = DataFormat(format="SH", basis_dim=basis_dim)
    return N3Tree.from_arrays(
        data, child, parent,
        np.full(3, 0.5, np.float32), np.full(3, 0.5, np.float32), fmt,
        max_capacity=max_capacity, device=device)


def field_tree_arrays(occ_fn: Callable[[np.ndarray], np.ndarray],
                      rgb_fn: Callable[[np.ndarray], np.ndarray],
                      depth: int = 8, basis_dim: int = 4,
                      sigma: float = 120.0, N: int = 2,
                      max_chunks: int = 8_000_000):
    """Vectorized level-wise builder for arbitrary occupancy fields
    (the scalable generalization of :func:`shell_tree`'s fixed shell).

    ``occ_fn``: [..., 3] tree-coord points -> bool occupancy (vectorized
    numpy).  ``rgb_fn``: [..., 3] points -> [..., 3] float64 colors in
    (0, 1).  A voxel subdivides while its 8 corners' occupancy is mixed
    (the same boundary-tracking rule the recursive
    :func:`build_host_tree` fixtures use) — so a height-field or
    CSG scene grows a realistic surface-following octree with 4^depth
    leaf scaling.  Occupied leaves get a logit-space DC so the
    sigmoid-shaded color lands on ``rgb_fn`` plus a small deterministic
    directional component, and ``sigma`` density; empty leaves are
    zero.  Returns host arrays (data, child, parent, scale, offset,
    fmt) like :func:`build_host_tree`, plus a per-chunk depth column
    (svox's ``parent_depth[:, 1]``).
    """
    N3 = N ** 3
    data_dim = 3 * basis_dim + 1
    slot = np.arange(N3)
    slot_off = np.stack([slot // (N * N), (slot // N) % N, slot % N],
                        axis=-1).astype(np.float64)          # [N3, 3]
    corner_off = np.stack(np.meshgrid(*([[-0.5, 0.5]] * 3),
                                      indexing="ij"),
                          axis=-1).reshape(8, 3)             # [8, 3]

    parent_rows = [np.zeros(1, np.int32)]
    corner_rows = [np.zeros((1, 3), np.float64)]
    links = []
    frontier = np.array([0], np.int64)
    frontier_corner = np.zeros((1, 3), np.float64)
    n_chunks = 1

    for d in range(1, depth):
        size = float(N) ** (-d)
        centers = (frontier_corner[:, None, :]
                   + (slot_off[None, :, :] + 0.5) * size)    # [F, N3, 3]
        pts = (centers[:, :, None, :]
               + corner_off[None, None, :, :] * size)        # [F, N3, 8, 3]
        occ8 = occ_fn(np.clip(pts, 0.0, 1.0).reshape(-1, 3)) \
            .reshape(centers.shape[0], N3, 8)
        split = occ8.any(-1) & ~occ8.all(-1)
        f_idx, s_idx = np.nonzero(split)
        n_new = len(f_idx)
        if n_new == 0:
            break
        if n_chunks + n_new > max_chunks:
            keep = max_chunks - n_chunks
            f_idx, s_idx = f_idx[:keep], s_idx[:keep]
            n_new = keep
        new_ids = n_chunks + np.arange(n_new)
        parents = frontier[f_idx]
        parent_rows.append((parents * N3 + s_idx).astype(np.int32))
        new_corners = frontier_corner[f_idx] + slot_off[s_idx] * size
        corner_rows.append(new_corners)
        links.append((parents, s_idx, (new_ids - parents).astype(np.int32)))
        n_chunks += n_new
        frontier = new_ids
        frontier_corner = new_corners
        if n_chunks >= max_chunks:
            break

    child = np.zeros((n_chunks, N3), np.int32)
    parent = np.concatenate(parent_rows, axis=0)
    corners = np.concatenate(corner_rows, axis=0)
    for parents, s_idx, offsets in links:
        child[parents, s_idx] = offsets
    depths = np.zeros(n_chunks, np.int32)
    start = 1
    for lvl, (parents, _, _) in enumerate(links, start=1):
        depths[start:start + len(parents)] = lvl
        start += len(parents)

    sizes = (float(N) ** -(depths + 1))[:, None]
    centers = corners[:, None, :] \
        + (slot_off[None, :, :] + 0.5) * sizes[:, :, None]   # [C, N3, 3]
    flat = centers.reshape(-1, 3)
    occ = occ_fn(flat).reshape(n_chunks, N3)
    rgb = np.clip(rgb_fn(flat).reshape(n_chunks, N3, 3), 1e-3, 1 - 1e-3)
    data = np.zeros((n_chunks, N3, data_dim), np.float16)
    c0 = 0.28209479177387814
    dc = np.log(rgb / (1.0 - rgb)) / c0                      # [C, N3, 3]
    for c in range(3):
        data[..., c * basis_dim] = (dc[..., c] * occ).astype(np.float16)
        if basis_dim > 1:
            data[..., c * basis_dim + 1] = (0.25 * np.sin(
                centers.sum(-1) * 37.0 + c) * occ).astype(np.float16)
    data[..., -1] = np.where(occ, sigma, 0.0).astype(np.float16)
    fmt = DataFormat(format="SH", basis_dim=basis_dim)
    return (data, child, parent, np.full(3, 0.5, np.float32),
            np.full(3, 0.5, np.float32), fmt, depths)


def random_tree(n_chunks: int = 64, basis_dim: int = 4,
                max_capacity: Optional[int] = None,
                seed: int = 0, density: float = 3.0, N: int = 2,
                device=None) -> N3Tree:
    """Random-topology tree: repeatedly split random leaves, random data
    (``synthetic.py:305-330`` of the JAX package: the same
    ``np.random.RandomState(seed)`` draws, so the same arrays)."""
    rng = np.random.RandomState(seed)
    N3 = N ** 3
    data_dim = 3 * basis_dim + 1
    child = np.zeros((n_chunks, N3), np.int32)
    parent = np.zeros(n_chunks, np.int32)
    for nc in range(1, n_chunks):
        # pick a random leaf slot among existing chunks
        while True:
            c = rng.randint(nc)
            ci = rng.randint(N3)
            if child[c, ci] == 0:
                break
        child[c, ci] = nc - c
        parent[nc] = c * N3 + ci
    data = (rng.randn(n_chunks, N3, data_dim) * 0.5).astype(np.float16)
    data[..., -1] = rng.gamma(1.0, density, size=(n_chunks, N3)).astype(
        np.float16)
    fmt = DataFormat(format="SH", basis_dim=basis_dim)
    return N3Tree.from_arrays(
        data, child, parent,
        np.full(3, 0.5, np.float32), np.full(3, 0.5, np.float32), fmt,
        max_capacity=max_capacity, device=device)
