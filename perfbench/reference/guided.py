"""Plain-PyTorch reference of the viewer's guided frame.

The reference viewer's guided sampling (``cuda_renderer.cpp:107-139``)
in three batched stages, from the scene file, the camera and the
configuration's model alone:

1. the collect (``get_samples_trace_ray``, ``rt_core.cuh:418-576``): each
   ray marches as the voxel frame does (``render.py``'s root descent and
   step) and records the ``t`` of each step whose sigma passes
   ``sigma_thresh``, up to ``max_guided_samples`` a ray; the
   transmittance falls as in the voxel frame, and the march stops under
   ``stop_thresh`` or at the ray's exit.  Each record becomes a sample
   (``rt_core.cuh:514-549``): its world depth ``z = |t d / scale|``, its
   position ``cen + z dir``, the view direction turned by ``rot_dirs``
   (with ``need_viewdir``), the appearance id as a column (where
   ``appearance_embedding`` is not -1) and its cluster id, the (y, z)
   cell of the model's ``grid_dim`` over ``min_position`` to
   ``max_position``;
2. the model's plain forward (``models/<arch>.py``'s ``reference``) on
   every sample, in blocks;
3. ``composite_nerf_results`` (``rt_core.cuh:334-416``): each sample's
   delta is the next sample's depth less its own (0 on a ray's last),
   ``wc = exp(-sigma delta)`` with sigma the output's column 3, as the
   reference viewer reads it (``rt_core.cuh:365``); the transmittance
   before a sample is the product of the ``wc`` before it, a sample
   weighs ``T (1 - wc)`` and the last one ``T``; its colour is the
   sigmoid of the SH basis of its view direction (``basis_minmax``)
   against the output's ``3 x basis_dim`` coefficients.  Alpha is 1 and
   no background is composited (``renderer_kernel.cu:316``): a ray with
   no sample is black.

Nothing the program derives is used: no leaf map, skip table, ray order,
segments or sample budget.  ``shade_dtype`` lowers the colour arithmetic
(the basis, the coefficient dot, the sigmoid, the weighted sum) and the
model's forward; the benchmark's control runs it in bfloat16.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from perfbench.reference import render as ref

f32 = torch.float32
# the reference viewer's defaults (render_options.hpp) of the options a
# configuration without guided sampling leaves out
DEFAULTS = {"max_guided_samples": 128, "need_viewdir": False,
            "appearance_embedding": -1, "rot_dirs": (0.0, 0.0, 0.0)}
# samples a forward block; the slots (rays x max_guided_samples) of a
# composite block
BLOCK = 1 << 20
SLOTS = 1 << 22


def rodrigues(aa, dirs):
    """``dirs`` turned by the axis-angle vector ``aa``; none below an angle
    of 1e-6, as the reference viewer."""
    aa = np.asarray(aa, np.float64).reshape(3)
    angle = float(np.sqrt((aa * aa).sum()))
    if angle < 1e-6:
        return dirs
    k = torch.as_tensor(aa / angle, dtype=f32, device=dirs.device)
    cos_a, sin_a = math.cos(angle), math.sin(angle)
    cross = torch.cross(k.expand_as(dirs), dirs, dim=-1)
    dot = (dirs * k).sum(-1, keepdim=True)
    return dirs * cos_a + cross * sin_a + k * dot * (1.0 - cos_a)


def collect(tree: ref.Tree, cam: dict, opt: dict):
    """The records of every ray: (dirs [R, 3], cen [3], d [R, 3] the
    tree-space unit directions, t [R, S] with the recorded ``t`` first,
    ns [R] int64)."""
    dev = tree.data.device
    dirs, cen_w = ref.camera_rays(cam, dev)
    cen, d, invdir, ds, tmin, tmax, miss = ref.setup(tree, dirs, cen_w, opt)
    R = dirs.shape[0]
    S = int(opt["max_guided_samples"])
    step = torch.tensor(float(np.float32(opt["step_size"])), device=dev)
    s_th = float(np.float32(opt["sigma_thresh"]))
    t_th = float(np.float32(opt["stop_thresh"]))
    t_rec = torch.zeros((R, S), dtype=f32, device=dev)
    ns = torch.zeros(R, dtype=torch.int64, device=dev)
    ray = torch.nonzero(~miss & (tmin < tmax)).reshape(-1)
    t, T = tmin[ray], torch.ones(ray.numel(), dtype=f32, device=dev)
    n = torch.zeros(ray.numel(), dtype=torch.int64, device=dev)
    while ray.numel():
        _, delta_t, sigma = ref._step(tree, t, d[ray], cen, invdir[ray],
                                      step)
        dense = sigma > s_th
        att = torch.exp(-delta_t * ds[ray] * sigma)
        rec = dense & (n < S)
        if bool(rec.any()):
            t_rec[ray[rec], n[rec]] = t[rec]
        n = n + rec.to(torch.int64)
        T = torch.where(dense, T * att, T)
        stop = dense & (T < t_th)
        t = t + delta_t
        fin = stop | (t >= tmax[ray])
        if bool(fin.any()):
            ns[ray[fin]] = n[fin]
            live = ~fin
            ray, t, T, n = ray[live], t[live], T[live], n[live]
    return dirs, cen_w, d, t_rec, ns


def cluster_ids(pos, spec: dict):
    """The (y, z) cell of the model's grid, ``g1 * grid_dim[1] + g2``, in
    f32 (``rt_core.cuh:541-549``)."""
    gd = [int(g) for g in spec["grid_dim"]]
    lo = np.asarray(spec["min_position"], np.float32)
    rg = np.asarray(spec["max_position"], np.float32) - lo

    def cell(v, axis, g):
        f = (v - float(lo[axis])) / float(rg[axis]) * float(g)
        return torch.clamp(f, 0.0, float(g) - 1.0).to(torch.int64)
    return cell(pos[:, 1], 1, gd[0]) * gd[1] + cell(pos[:, 2], 2, gd[1])


def frame(tree: ref.Tree, cam: dict, opt: dict, shade_dtype=f32,
          model=None):
    """The guided frame [H, W, 4] f32 at ``cam``.  ``model`` is (the
    configuration's model block, its plain forward ``(cluster_ids, x,
    dtype) -> f32 [n, out]``)."""
    if model is None:
        raise ValueError("a guided frame needs the configuration's model")
    spec, forward = model
    opt = {**DEFAULTS, **opt}
    dev = tree.data.device
    dirs, cen_w, d, t_rec, ns = collect(tree, cam, opt)
    R, S = t_rec.shape
    vdirs = rodrigues(opt["rot_dirs"], dirs)
    B = tree.basis_dim
    lo, hi = opt["basis_minmax"]
    keep_b = (torch.arange(B, device=dev) >= lo) & (
        torch.arange(B, device=dev) <= hi)
    basis = torch.where(keep_b, ref.sh_basis(B, vdirs),
                        torch.zeros((), device=dev))
    app = int(opt["appearance_embedding"])
    zero = torch.zeros((), dtype=f32, device=dev)
    rgb = torch.zeros((R, 3), dtype=f32, device=dev)
    rays_per = max(1, SLOTS // max(S, 1))
    j = torch.arange(S, device=dev)
    for r0 in range(0, R, rays_per):
        r1 = min(R, r0 + rays_per)
        n_b = ns[r0:r1]
        valid = j[None, :] < n_b[:, None]
        r_i, j_i = torch.nonzero(valid, as_tuple=True)
        if not r_i.numel():
            continue
        g = r_i + r0
        tv = t_rec[g, j_i]
        z = torch.sqrt((((tv[:, None] * d[g]) / tree.scale[None, :])
                        ** 2).sum(-1))
        pos = cen_w[None, :] + dirs[g] * z[:, None]
        cols = [pos]
        if opt["need_viewdir"]:
            cols.append(vdirs[g])
        if app != -1:
            cols.append(torch.full((g.numel(), 1), float(app), dtype=f32,
                                   device=dev))
        x = torch.cat(cols, -1)
        ids = cluster_ids(pos, spec)
        out = torch.cat([forward(ids[k:k + BLOCK], x[k:k + BLOCK],
                                 shade_dtype)
                         for k in range(0, x.shape[0], BLOCK)])
        # the samples of the block's rays as [rays, S] slots
        Rb = r1 - r0
        res = torch.zeros((Rb, S, out.shape[1]), dtype=f32, device=dev)
        res[r_i, j_i] = out.to(f32)
        zp = torch.zeros((Rb, S), dtype=f32, device=dev)
        zp[r_i, j_i] = z
        is_last = j[None, :] == (n_b[:, None] - 1)
        inner = valid & ~is_last
        z_next = torch.cat([zp[:, 1:], torch.zeros((Rb, 1), dtype=f32,
                                                   device=dev)], 1)
        delta = torch.where(inner, z_next - zp, zero)
        wc = torch.exp(-res[..., min(3, res.shape[-1] - 1)] * delta)
        wc_eff = torch.where(inner, wc, torch.ones((), device=dev))
        T = torch.cat([torch.ones((Rb, 1), dtype=f32, device=dev),
                       torch.cumprod(wc_eff, 1)[:, :-1]], 1)
        weight = torch.where(is_last & valid, T,
                             torch.where(valid, T * (1.0 - wc), zero))
        coeff = res[..., :3 * B].reshape(Rb, S, 3, B).to(shade_dtype)
        dot = (basis[r0:r1, None, None, :].to(shade_dtype) * coeff).sum(-1)
        col = weight.to(shade_dtype)[..., None] * torch.sigmoid(dot)
        col = torch.where(valid[..., None], col,
                          torch.zeros((), dtype=shade_dtype, device=dev))
        rgb[r0:r1] = col.sum(1).to(f32)
    img = torch.cat([rgb, torch.ones((R, 1), dtype=f32, device=dev)], 1)
    return img.reshape(int(cam["height"]), int(cam["width"]), 4)
