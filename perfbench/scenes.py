"""The benchmark's scenes: numpy copies of the repository's generators and
an svox npz cache inside the checkout.

Two generators, each a frozen copy so that the benchmark's inputs do not
move when the program's builders do:

* ``shell``: ``n3tree/synthetic.py:shell_tree``'s level-wise subdivision
  around a sphere shell (``bench.py``'s scene is depth 8, SH9, sigma 400;
  the PlenOctree configuration takes it to depth 9, SH16).
* ``aerial_field``: ``n3tree/synthetic.py:field_tree_arrays`` over
  ``tests/fixtures/gen_fixtures.py``'s ``big_occ_v`` and ``big_rgb_v``
  (terrain, a plinth, two blocks, a ramp and a sphere), the aerial
  artifact of ``bench_torch.aerial_artifact`` (depth 11: 2,817,022 chunks).

Each scene is written once per checkout as an svox npz (the writer is a
copy of ``gen_fixtures.write_svox_npz``) under ``build/perfbench/``; every
later run opens the file.  The tree carries no randomness: ``--seed``
does not change the scene.
"""

from __future__ import annotations

import hashlib
import json
import os
import time

import numpy as np

N = 2
N3 = N ** 3
C0 = 0.28209479177387814
# bumped when a generator below changes, so that stale files rebuild
GENERATOR_VERSION = 1


# ----------------------------------------------------------------------
# the aerial scene's fields (gen_fixtures.py:99-214)
# ----------------------------------------------------------------------
def terrain_height(x, z):
    return (0.14
            + 0.06 * np.sin(6.1 * x + 1.0) * np.cos(5.3 * z)
            + 0.03 * np.sin(13.7 * x + 0.4) * np.sin(11.9 * z + 2.0)
            + 0.015 * np.sin(29.0 * x + 31.0 * z))


def aerial_occupancy(p):
    """Occupancy of tree-space points ``p`` [..., 3] -> bool."""
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    occ = y < terrain_height(x, z)
    occ |= (0.05 < y) & (y < 0.18) & (0.1 < x) & (x < 0.9) \
        & (0.1 < z) & (z < 0.9)
    occ |= (0.3 < x) & (x < 0.62) & (0.18 < y) & (y < 0.42) \
        & (0.3 < z) & (z < 0.7)
    occ |= (0.36 < x) & (x < 0.56) & (0.42 < y) & (y < 0.6) \
        & (0.38 < z) & (z < 0.62)
    occ |= (0.62 < x) & (x < 0.8) & (0.18 < y) \
        & (y < 0.18 + (0.8 - x)) & (0.34 < z) & (z < 0.66)
    occ |= ((p - np.array([0.34, 0.66, 0.5])) ** 2).sum(-1) < 0.06 ** 2
    return occ


def aerial_color(p):
    """Colour of tree-space points ``p`` [..., 3] -> [..., 3] in (0, 1)."""
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    h = terrain_height(x, z)
    g = 0.35 + 0.3 * (h - y) / np.maximum(h, 1e-3)
    rgb = np.stack([np.full_like(x, 0.35), np.clip(g, 0.05, 0.95),
                    np.full_like(x, 0.25)], axis=-1)

    def put(mask, color):
        rgb[mask] = color
    put(~(y < h) & (0.05 < y) & (y < 0.18) & (0.1 < x) & (x < 0.9)
        & (0.1 < z) & (z < 0.9), (0.55, 0.45, 0.3))
    put((0.3 < x) & (x < 0.62) & (0.18 < y) & (y < 0.42)
        & (0.3 < z) & (z < 0.7) & ~(y < h), (0.85, 0.7, 0.1))
    put((0.36 < x) & (x < 0.56) & (0.42 < y) & (y < 0.6)
        & (0.38 < z) & (z < 0.62) & ~(y < h), (0.2, 0.3, 0.8))
    put((0.62 < x) & (x < 0.8) & (0.18 < y) & (y < 0.18 + (0.8 - x))
        & (0.34 < z) & (z < 0.66) & ~(y < h), (0.7, 0.15, 0.1))
    put((((p - np.array([0.34, 0.66, 0.5])) ** 2).sum(-1) < 0.06 ** 2)
        & ~(y < h), (0.15, 0.15, 0.18))
    return rgb


# ----------------------------------------------------------------------
# level-wise builders (n3tree/synthetic.py:shell_tree, field_tree_arrays)
# ----------------------------------------------------------------------
_SLOT_OFF = np.stack([np.arange(N3) // (N * N), (np.arange(N3) // N) % N,
                      np.arange(N3) % N], axis=-1).astype(np.float64)


def _grow(split_fn, depth, max_chunks):
    """Grow the topology level by level: ``split_fn(centers [F, N3, 3],
    size)`` -> bool [F, N3] says which leaves subdivide.  Returns (child
    [C, N3] i32, parent [C] i32, corners [C, 3] f64, depths [C] i32)."""
    parent_rows = [np.zeros(1, np.int32)]
    corner_rows = [np.zeros((1, 3), np.float64)]
    links = []
    frontier = np.array([0], np.int64)
    frontier_corner = np.zeros((1, 3), np.float64)
    n_chunks = 1
    for d in range(1, depth):
        size = float(N) ** (-d)
        centers = (frontier_corner[:, None, :]
                   + (_SLOT_OFF[None, :, :] + 0.5) * size)
        f_idx, s_idx = np.nonzero(split_fn(centers, size))
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
        new_corners = frontier_corner[f_idx] + _SLOT_OFF[s_idx] * size
        corner_rows.append(new_corners)
        links.append((parents, s_idx, (new_ids - parents).astype(np.int32)))
        n_chunks += n_new
        frontier = new_ids
        frontier_corner = new_corners
        if n_chunks >= max_chunks:
            break
    child = np.zeros((n_chunks, N3), np.int32)
    for parents, s_idx, offsets in links:
        child[parents, s_idx] = offsets
    depths = np.zeros(n_chunks, np.int32)
    start = 1
    for lvl, (parents, _, _) in enumerate(links, start=1):
        depths[start:start + len(parents)] = lvl
        start += len(parents)
    return (child, np.concatenate(parent_rows, axis=0),
            np.concatenate(corner_rows, axis=0), depths)


def _leaf_centers(corners, depths):
    sizes = (float(N) ** -(depths + 1))[:, None]
    return (corners[:, None, :]
            + (_SLOT_OFF[None, :, :] + 0.5) * sizes[:, :, None]), sizes


def shell_arrays(depth=8, basis_dim=9, radius=0.35, sigma_inside=400.0,
                 max_chunks=8_000_000):
    """``shell_tree``'s arrays: (data f16 [C, 8, 3B+1], child [C, 8],
    parent [C], depths [C])."""
    def split(centers, size):
        r = np.linalg.norm(centers - 0.5, axis=-1)
        return np.abs(r - radius) < 0.9 * size

    child, parent, corners, depths = _grow(split, depth, max_chunks)
    centers, sizes = _leaf_centers(corners, depths)
    r = np.linalg.norm(centers - 0.5, axis=-1)
    inside = r < radius + sizes
    data = np.zeros((child.shape[0], N3, 3 * basis_dim + 1), np.float16)
    data[..., -1] = np.where(inside, sigma_inside, 0.0).astype(np.float16)
    coeff = (0.3 * np.sin(7.0 * centers.sum(-1)))[..., None]
    for c in range(3):
        data[..., c * basis_dim] = (np.sin(5.0 * centers[..., c] + c)
                                    * inside).astype(np.float16)
        if basis_dim > 1:
            data[..., c * basis_dim + 1: (c + 1) * basis_dim] = (
                coeff * inside[..., None]).astype(np.float16)
    return data, child, parent, depths


def field_arrays(occ_fn, rgb_fn, depth=11, basis_dim=4, sigma=120.0,
                 max_chunks=8_000_000):
    """``field_tree_arrays``' arrays: a voxel splits while its 8 corners'
    occupancy is mixed; occupied leaves get the colour's logit as DC, a
    small directional term and ``sigma``.  Returns (data, child, parent,
    depths) as :func:`shell_arrays`."""
    corner_off = np.stack(np.meshgrid(*([[-0.5, 0.5]] * 3), indexing="ij"),
                          axis=-1).reshape(8, 3)

    def split(centers, size):
        pts = centers[:, :, None, :] + corner_off[None, None, :, :] * size
        occ8 = occ_fn(np.clip(pts, 0.0, 1.0).reshape(-1, 3)) \
            .reshape(centers.shape[0], N3, 8)
        return occ8.any(-1) & ~occ8.all(-1)

    child, parent, corners, depths = _grow(split, depth, max_chunks)
    n_chunks = child.shape[0]
    centers, _ = _leaf_centers(corners, depths)
    flat = centers.reshape(-1, 3)
    occ = occ_fn(flat).reshape(n_chunks, N3)
    rgb = np.clip(rgb_fn(flat).reshape(n_chunks, N3, 3), 1e-3, 1 - 1e-3)
    data = np.zeros((n_chunks, N3, 3 * basis_dim + 1), np.float16)
    dc = np.log(rgb / (1.0 - rgb)) / C0
    for c in range(3):
        data[..., c * basis_dim] = (dc[..., c] * occ).astype(np.float16)
        if basis_dim > 1:
            data[..., c * basis_dim + 1] = (0.25 * np.sin(
                centers.sum(-1) * 37.0 + c) * occ).astype(np.float16)
    data[..., -1] = np.where(occ, sigma, 0.0).astype(np.float16)
    return data, child, parent, depths


GENERATORS = {
    "shell": lambda s: shell_arrays(
        depth=s["depth"], basis_dim=s["basis_dim"], radius=s["radius"],
        sigma_inside=s["sigma"]),
    "aerial_field": lambda s: field_arrays(
        aerial_occupancy, aerial_color, depth=s["depth"],
        basis_dim=s["basis_dim"], sigma=s["sigma"]),
}


# ----------------------------------------------------------------------
# the svox file (gen_fixtures.py:45-69) and its cache
# ----------------------------------------------------------------------
def write_svox_npz(path, data, child, parent, depths, basis_dim):
    """The svox schema: f16 ``data``, ``child`` [C, 2, 2, 2],
    ``parent_depth`` [C, 2], scalar ``invradius`` 0.5, ``offset`` 0.5."""
    cap = data.shape[0]
    fields = dict(
        data_dim=np.int64(data.shape[-1]),
        data_format=np.str_(f"SH{basis_dim}"),
        invradius=np.float32(0.5),
        offset=np.full(3, 0.5, np.float32),
        child=np.ascontiguousarray(child.reshape(cap, N, N, N)
                                   .astype(np.int32)),
        parent_depth=np.ascontiguousarray(
            np.stack([parent, depths], axis=1).astype(np.int32)),
        depth_limit=np.int32(10),
        geom_resize_fact=np.float64(1.0),
        extra_data=np.zeros((0,), np.float32),
        data=np.ascontiguousarray(data.astype(np.float16)),
    )
    tmp = path + ".tmp.npz"          # np.savez keeps a name ending in .npz
    np.savez(tmp, **fields)
    os.replace(tmp, path)


def scene_path(cache_dir: str, scene: dict) -> str:
    """The npz of ``scene`` in ``cache_dir``, named by its parameters."""
    key = json.dumps(dict(scene, version=GENERATOR_VERSION), sort_keys=True)
    tag = hashlib.sha256(key.encode()).hexdigest()[:12]
    return os.path.join(cache_dir, f"{scene['generator']}_{tag}.npz")


def ensure_scene(cache_dir: str, scene: dict) -> tuple:
    """The scene's npz, built when missing.  Returns (path, seconds spent
    building; 0.0 when the file was there)."""
    path = scene_path(cache_dir, scene)
    if os.path.exists(path):
        return path, 0.0
    t0 = time.perf_counter()
    os.makedirs(cache_dir, exist_ok=True)
    data, child, parent, depths = GENERATORS[scene["generator"]](scene)
    write_svox_npz(path, data, child, parent, depths, scene["basis_dim"])
    return path, time.perf_counter() - t0


def load_svox(path: str) -> dict:
    """The npz's arrays as the reference reads them: data f16 [C, 8, D],
    child i32 [C, 8], scale and offset f32 [3], the basis dimension."""
    with np.load(path, allow_pickle=False) as z:
        data = np.asarray(z["data"])
        cap = data.shape[0]
        fmt = str(z["data_format"])
        return dict(
            data=data.reshape(cap, N3, -1),
            child=np.asarray(z["child"]).reshape(cap, N3).astype(np.int32),
            scale=np.full(3, float(np.asarray(z["invradius"]).reshape(-1)[0]),
                          np.float32),
            offset=np.asarray(z["offset"], np.float32).reshape(3),
            basis_dim=int(fmt[2:]))
