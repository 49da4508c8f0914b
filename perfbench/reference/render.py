"""Plain-PyTorch reference of the viewer's frames.

A batched transliteration of the scalar oracle (the reference viewer's
per-ray device code, ``rt_core.cuh:71-416``): every step descends the
octree from the root, steps to the leaf's exit, composites the samples
whose sigma passes the threshold, and stops early under the transmittance
threshold.  Nothing the program derives is used: no leaf map, skip table,
ray order, hints or budgets.  The arithmetic follows the oracle in f32;
the three places where the reference viewer's compiler rounds once (the
position ``cen + t * d``, the squared norms and the reciprocal square
root) are rounded once here too, from float64.

:func:`voxel_frame` is the displayed voxel frame (SH shading up to
degree 3, early stop with the ``1 / (1 - T)`` renormalisation, the
background composite).  ``shade_dtype`` lowers the precision of the
colour arithmetic; the benchmark's control runs it and must come out as
not correct.
"""

from __future__ import annotations

import numpy as np
import torch

f32 = torch.float32
EPS_HI = float(np.float32(1.0 - 1e-6))
SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
         0.3731763325901154, -0.4570457994644658, 1.445305721320277,
         -0.5900435899266435)


# ----------------------------------------------------------------------
# rounding helpers
# ----------------------------------------------------------------------
def fma(a, b, c):
    """``a * b + c`` rounded once to f32 (the product is exact in float64;
    a float64 sum that lands halfway between two f32 values is broken
    toward the exact sum)."""
    a64, b64, c64 = a.double(), b.double(), c.double()
    p = a64 * b64
    s = p + c64
    bv = s - p
    e = (p - (s - bv)) + (c64 - bv)
    r = s.float()
    rd = r.double()
    inf = torch.full((), float("inf"), dtype=f32, device=r.device)
    nb = torch.nextafter(r, torch.where(s > rd, inf, -inf))
    nbd = nb.double()
    tie = (s != rd) & (2.0 * s == rd + nbd)
    toward = (e != 0) & ((e > 0) == (nbd > rd))
    return torch.where(tie & toward, nb, r)


def sq_norm(v):
    return fma(v[:, 2], v[:, 2], fma(v[:, 1], v[:, 1], v[:, 0] * v[:, 0]))


def pow2(depth):
    """``2 ** depth`` for integer depths, exact."""
    return ((depth.to(torch.int32) + 127) << 23).view(f32)


# ----------------------------------------------------------------------
# camera rays and the tree-space setup
# ----------------------------------------------------------------------
def camera_rays(cam: dict, device):
    """World rays of every pixel, row-major: (dirs [R, 3], cen [3]).
    ``cam`` holds width, height, fx, fy, cx, cy and the [4, 3]
    camera-to-world ``transform`` (rows right, up, back, centre)."""
    w, h = int(cam["width"]), int(cam["height"])
    pix = torch.arange(w * h, device=device)
    x = (pix % w).to(f32)
    y = torch.div(pix, w, rounding_mode="floor").to(f32)
    fx, fy, cx, cy = (torch.tensor(float(np.float32(cam[k])), dtype=f32,
                                   device=device)
                      for k in ("fx", "fy", "cx", "cy"))
    u = (x + 0.5 - cx) / fx
    v = -(y + 0.5 - cy) / fy
    rot = torch.as_tensor(np.asarray(cam["transform"], np.float32),
                          device=device)
    world = u[:, None] * rot[0][None] + v[:, None] * rot[1][None] - rot[2][None]
    return world / torch.sqrt(sq_norm(world))[:, None], rot[3].clone()


def sh_basis(basis_dim: int, dirs):
    """Real SH basis, degrees 0-3 (``rt_core.cuh:13-68``)."""
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    out = [torch.full_like(x, SH_C0)]
    if basis_dim >= 4:
        out += [-SH_C1 * y, SH_C1 * z, -SH_C1 * x]
    if basis_dim >= 9:
        xx, yy, zz = x * x, y * y, z * z
        out += [SH_C2[0] * (x * y), SH_C2[1] * (y * z),
                SH_C2[2] * (2.0 * zz - xx - yy), SH_C2[3] * (x * z),
                SH_C2[4] * (xx - yy)]
    if basis_dim >= 16:
        out += [SH_C3[0] * y * (3 * xx - yy), SH_C3[1] * (x * y) * z,
                SH_C3[2] * y * (4 * zz - xx - yy),
                SH_C3[3] * z * (2 * zz - 3 * xx - 3 * yy),
                SH_C3[4] * x * (4 * zz - xx - yy),
                SH_C3[5] * z * (xx - yy), SH_C3[6] * x * (xx - 3 * yy)]
    if basis_dim not in (1, 4, 9, 16):
        raise ValueError(f"basis_dim {basis_dim} not in (1, 4, 9, 16)")
    return torch.stack(out, -1)


class Tree:
    """The octree of an svox file on ``device``: data f16 [C, 8, D],
    child i32 [C, 8] (relative offsets, 0 a leaf), scale and offset,
    its deepest level."""

    def __init__(self, host: dict, device):
        self.data = torch.as_tensor(host["data"]).to(device)
        self.child = torch.as_tensor(host["child"]).to(device)
        self.scale = torch.as_tensor(host["scale"]).to(device)
        self.offset = torch.as_tensor(host["offset"]).to(device)
        self.basis_dim = int(host["basis_dim"])
        self.D = self.data.shape[-1]
        self.levels = _levels(host["child"])
        self.child_flat = self.child.reshape(-1)
        self.data_flat = self.data.reshape(-1, self.D)


def _levels(child: np.ndarray) -> int:
    """The number of chunk levels below and including the root."""
    level, frontier = 1, np.array([0])
    while True:
        rows = child[frontier]
        nz = rows != 0
        if not nz.any():
            return level
        frontier = (frontier[:, None] + rows)[nz]
        level += 1


def setup(tree: Tree, dirs, cen_world, opt: dict):
    """Tree-space rays: (cen, d, invdir, delta_scale, tmin, tmax, miss)."""
    cen = fma(tree.scale, cen_world, tree.offset)
    d = dirs * tree.scale[None, :]
    ds = torch.rsqrt(sq_norm(d).double()).float()
    d = d * ds[:, None]
    invdir = 1.0 / (d + float(np.float32(1e-9)))
    bbox = np.asarray(opt["render_bbox"], np.float32)
    lo = torch.as_tensor(bbox[:3] + np.float32(1e-6), device=d.device)
    hi = torch.as_tensor(bbox[3:] - np.float32(1e-6), device=d.device)
    t1 = (lo - cen)[None, :] * invdir
    t2 = (hi - cen)[None, :] * invdir
    tmin = torch.clamp_min(torch.minimum(t1, t2).amax(-1), 0.0)
    tmax = torch.clamp_max(torch.maximum(t1, t2).amin(-1), 1e4)
    tmax = torch.minimum(tmax, 1e9 / ds)
    miss = (tmax < 0) | (tmin > tmax)
    return cen, d, invdir, ds, tmin, tmax, miss


def _descend(tree: Tree, pos):
    """Root descent (``rt_core.cuh:117-159``): (frac [n, 3], node [n],
    depth [n])."""
    xyz = torch.clamp(pos, 0.0, EPS_HI)
    n = pos.shape[0]
    chunk = torch.zeros(n, dtype=torch.int64, device=pos.device)
    idx = torch.zeros_like(chunk)
    depth = torch.ones(n, dtype=torch.int32, device=pos.device)
    done = torch.zeros(n, dtype=torch.bool, device=pos.device)
    for _ in range(tree.levels):
        u = xyz * 2.0
        dg = torch.floor(u)
        cell = (dg[:, 0] * 4.0 + dg[:, 1] * 2.0 + dg[:, 2]).long()
        skip = tree.child_flat[chunk * 8 + cell].long()
        live = ~done
        xyz = torch.where(live[:, None], u - dg, xyz)
        idx = torch.where(live, cell, idx)
        go = live & (skip != 0)
        chunk = torch.where(go, chunk + skip, chunk)
        depth = torch.where(go, depth + 1, depth)
        done = done | (skip == 0)
    return xyz, chunk * 8 + idx, depth


def _step(tree: Tree, t, d, cen, invdir, step):
    """One march step at ``t``: (node, delta_t, sigma)."""
    pos = fma(t[:, None], d, cen[None, :])
    frac, node, depth = _descend(tree, pos)
    t1 = -frac * invdir
    exit_t = torch.clamp_max(torch.maximum(t1, t1 + invdir).amin(-1), 1e4)
    delta_t = exit_t / pow2(depth) + step
    sigma = tree.data_flat[node, tree.D - 1].to(f32)
    return node, delta_t, sigma


def voxel_frame(tree: Tree, cam: dict, opt: dict,
                shade_dtype=torch.float32):
    """The voxel frame [H, W, 4] f32, background composited.  Only the
    colour arithmetic (basis, the coefficient dot, the sigmoid, the
    weighted sum) runs in ``shade_dtype``."""
    dev = tree.data.device
    dirs, cen_w = camera_rays(cam, dev)
    cen, d, invdir, ds, tmin, tmax, miss = setup(tree, dirs, cen_w, opt)
    R = dirs.shape[0]
    B = tree.basis_dim
    lo, hi = opt["basis_minmax"]
    basis = sh_basis(B, dirs)
    keep_b = (torch.arange(B, device=dev) >= lo) & (torch.arange(
        B, device=dev) <= hi)
    basis = torch.where(keep_b, basis, torch.zeros((), device=dev))
    step = torch.tensor(float(np.float32(opt["step_size"])), device=dev)
    s_th = float(np.float32(opt["sigma_thresh"]))
    t_th = float(np.float32(opt["stop_thresh"]))

    acc = torch.zeros((R, 3), dtype=f32, device=dev)
    T_out = torch.ones(R, dtype=f32, device=dev)
    stopped = torch.zeros(R, dtype=torch.bool, device=dev)
    ray = torch.nonzero(~miss & (tmin < tmax)).reshape(-1)
    t, T = tmin[ray], torch.ones(ray.numel(), dtype=f32, device=dev)
    a = torch.zeros((ray.numel(), 3), dtype=shade_dtype, device=dev)
    while ray.numel():
        node, delta_t, sigma = _step(tree, t, d[ray], cen, invdir[ray], step)
        dense = sigma > s_th
        att = torch.exp(-delta_t * ds[ray] * sigma)
        weight = T * (1.0 - att)
        coeff = tree.data_flat[node, :3 * B].reshape(-1, 3, B)
        dot = (basis[ray][:, None, :].to(shade_dtype)
               * coeff.to(shade_dtype)).sum(-1)
        rgb = torch.sigmoid(dot)
        a = a + torch.where(dense[:, None],
                            weight.to(shade_dtype)[:, None] * rgb,
                            torch.zeros((), dtype=shade_dtype, device=dev))
        T = torch.where(dense, T * att, T)
        stop = dense & (T < t_th)
        t = t + delta_t
        fin = stop | (t >= tmax[ray])
        if bool(fin.any()):
            r = ray[fin]
            acc[r] = a[fin].to(f32)
            T_out[r] = T[fin]
            stopped[r] = stop[fin]
            live = ~fin
            ray, t, T, a = ray[live], t[live], T[live], a[live]
    scale = torch.where(stopped, 1.0 / (1.0 - T_out), torch.ones_like(T_out))
    alpha = torch.where(stopped, torch.ones_like(T_out),
                        torch.where(miss, torch.zeros_like(T_out),
                                    1.0 - T_out))
    rgb = acc * scale[:, None]
    bg = float(np.float32(opt["background_brightness"]))
    rgb = rgb + bg * (1.0 - alpha[:, None])
    img = torch.cat([rgb, alpha[:, None]], 1)
    return img.reshape(int(cam["height"]), int(cam["width"]), 4)
