"""The exact octree renderer, ray/box helpers and the frame's composite.

Counterpart of ``mega_nerf_viewer_tpu/ops/render.py`` (the reference's
``render_voxels_kernel``, ``rt_core.cuh:162-332``):

  * :func:`render_rays` / :func:`render_frame` — the exact march.  Every
    step descends the octree from the root (:func:`_descend`, at most
    ``max_levels`` levels), steps to the leaf's exit, composites
    sigma-gated samples with SH shading (or depth), stops early, and
    keeps the per-ray split and sample votes and, with ``track_visit``,
    the visit marks of every chunk on the descent paths.
  * :func:`exact_march` — the march from the tree-space setup: on a CUDA
    tensor ``csrc/exact_march.cu`` (one thread per ray, the descent shared
    with the exact collect in ``csrc/descend_step.cuh``), on a CPU tensor
    :func:`exact_march_reference`, the JAX while loop as batched torch ops.
  * the bbox clip and unit-cube exit distance (``rt_core.cuh:71-100``),
    the background composite (``renderer_kernel.cu:215-241``) and the
    rgba8 cast.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import kernels
from ..device import host_tensor
from ..options import RenderOptions
from .fp import fma_f32, ipow_f32

# Max octree levels one descent walks (the JAX package's bound).
DEFAULT_MAX_LEVELS = 20
# clip bound of tree-space positions, f32(1 - 1e-6)
EPS_HI = float(np.float32(1.0 - 1e-6))


class RenderResult(NamedTuple):
    out: torch.Tensor          # [R, 4] f32 rgba (pre-background)
    split_vote: torch.Tensor   # [R, 3] f32 [priority, chunk, child]
    sample_vote: torch.Tensor  # [R, 3] f32
    visited: torch.Tensor      # [max_capacity] i32 visit marks (or zeros)


def _dda_world_batch(cen: torch.Tensor, invdir: torch.Tensor, bbox):
    """Batched bbox clip (``rt_core.cuh:71-86``). cen [3], invdir [R, 3]."""
    bbox = np.asarray(bbox, np.float32)
    lohi = host_tensor(np.concatenate([bbox[:3] + np.float32(1e-6),
                                       bbox[3:] - np.float32(1e-6)]),
                       torch.float32, invdir.device)
    lo, hi = lohi[:3], lohi[3:]
    t1 = (lo - cen)[None, :] * invdir
    t2 = (hi - cen)[None, :] * invdir
    tmin = torch.clamp_min(torch.minimum(t1, t2).amax(-1), 0.0)
    tmax = torch.clamp_max(torch.maximum(t1, t2).amin(-1), 1e4)
    return tmin, tmax


def _dda_unit_batch(pos: torch.Tensor, invdir: torch.Tensor) -> torch.Tensor:
    """Batched unit-cube exit distance (``rt_core.cuh:89-100``)."""
    t1 = -pos * invdir
    t2 = t1 + invdir
    return torch.clamp_max(torch.maximum(t1, t2).amin(-1), 1e4)


def composite_background(out: torch.Tensor, opt: RenderOptions,
                         bg_rgb: Optional[torch.Tensor] = None,
                         bg_value: Optional[float] = None
                         ) -> torch.Tensor:
    """Offscreen background composite: rgb += bg * (1 - alpha).
    ``bg_rgb`` [R, 3] is a per-pixel background (the overlay colours of
    the grid and mesh frame, ``renderer_kernel.cu:260-263``) and wins over
    ``bg_value``, which wins over ``opt.background_brightness``."""
    nalpha = 1.0 - out[:, 3:4]
    if bg_rgb is not None:
        return torch.cat([out[:, :3] + bg_rgb * nalpha, out[:, 3:4]], dim=1)
    bg = opt.background_brightness if bg_value is None else bg_value
    bg = float(np.float32(bg))
    return torch.cat([out[:, :3] + bg * nalpha, out[:, 3:4]], dim=1)


def to_rgba8(img: torch.Tensor) -> torch.Tensor:
    """f32 rgba -> uint8, clamped."""
    return torch.clamp(img * 255.0, 0.0, 255.0).to(torch.uint8)


# ----------------------------------------------------------------------
# The exact march
# ----------------------------------------------------------------------
def _descend(child_flat: torch.Tensor, xyz: torch.Tensor, N: int,
             max_levels: int, visited: Optional[torch.Tensor]):
    """Octree descent from the root (``render.py:49-92``; reference
    ``rt_core.cuh:117-159``).  ``xyz`` f32 [R, 3] tree-space positions,
    clipped to [0, 1 - 1e-6].  While a ray's descent is not done, the
    chunk it is in is marked in ``visited`` (when given, in place).
    Returns (frac [R, 3], chunk, cidx, depth [R] i32)."""
    N3 = N ** 3
    R = xyz.shape[0]
    dev = xyz.device
    i32 = torch.int32
    xyz = torch.clamp(xyz, 0.0, EPS_HI)
    chunk = torch.zeros((R,), dtype=i32, device=dev)
    cidx = torch.zeros((R,), dtype=i32, device=dev)
    depth = torch.ones((R,), dtype=i32, device=dev)
    done = torch.zeros((R,), dtype=torch.bool, device=dev)
    n_child = child_flat.numel()
    for _ in range(max_levels):
        if bool(done.all()):
            break
        upd = ~done
        if visited is not None:
            visited[chunk[upd].long()] = 1
        u = xyz * float(N)
        digits = torch.floor(u)
        idx = (digits[:, 0] * float(N * N) + digits[:, 1] * float(N)
               + digits[:, 2]).to(i32)
        skip = child_flat[(chunk * N3 + idx).clamp(0, n_child - 1).long()]
        leaf = skip == 0
        xyz = torch.where(upd[:, None], u - digits, xyz)
        cidx = torch.where(upd, idx, cidx)
        go = upd & ~leaf
        chunk = torch.where(go, chunk + skip, chunk)
        depth = torch.where(go, depth + 1, depth)
        done = done | leaf
    return xyz, chunk, cidx, depth


def _vote_init(R: int, first: float, dev) -> torch.Tensor:
    """[R, 3] votes ``(first, -1, -1)``: no vote yet."""
    v = torch.full((R, 3), -1.0, dtype=torch.float32, device=dev)
    v[:, 0] = first
    return v


def vote_step(max_depth: int, max_sample_count: int, state: dict, active,
              dense, weight, depth, chunk, cidx, sc) -> None:
    """One step of the split and sample vote rule (``render.py:217-236``,
    reference ``rt_core.cuh:237-252``): a ray votes for the dense sample
    of largest weight (strictly larger than the best so far), and while it
    has none, for every sample it passes (``max_w == -1``)."""
    f32 = torch.float32
    can_split = depth < max_depth
    can_sample = sc < max_sample_count
    chunk_f, cidx_f = chunk.to(f32), cidx.to(f32)
    cols_s = torch.stack([depth.to(f32), chunk_f, cidx_f], -1)
    cols_p = torch.stack([sc.to(f32), chunk_f, cidx_f], -1)
    max_w, max_sw = state["max_w"], state["max_sw"]
    vs = active & can_split & torch.where(dense, weight > max_w,
                                          max_w == -1.0)
    vp = active & can_sample & torch.where(dense, weight > max_sw,
                                           max_sw == -1.0)
    state["split_vote"] = torch.where(vs[:, None], cols_s,
                                      state["split_vote"])
    state["sample_vote"] = torch.where(vp[:, None], cols_p,
                                       state["sample_vote"])
    state["max_w"] = torch.where(active & dense & can_split
                                 & (weight > max_w), weight, max_w)
    state["max_sw"] = torch.where(active & dense & can_sample
                                  & (weight > max_sw), weight, max_sw)


def vote_state(R: int, max_depth: int, max_sample_count: int, dev) -> dict:
    """The vote carry of a march: votes (-1 filled) and the best weights."""
    return dict(split_vote=_vote_init(R, max_depth + 1, dev),
                sample_vote=_vote_init(R, max_sample_count + 1, dev),
                max_w=torch.full((R,), -1.0, dtype=torch.float32, device=dev),
                max_sw=torch.full((R,), -1.0, dtype=torch.float32,
                                  device=dev))


def fresh_visit_tracker(tree, dev=None) -> torch.Tensor:
    """A visit tracker with only the root marked."""
    v = torch.zeros((tree.max_capacity,), dtype=torch.int32,
                    device=tree.device if dev is None else dev)
    v[0] = 1
    return v


def exact_march_reference(tree, m, opt: RenderOptions,
                          track_visit: bool = False,
                          max_levels: int = DEFAULT_MAX_LEVELS,
                          max_iters: int = 0):
    """The exact march as plain torch ops: the JAX while loop
    (``render.py:182-278``) over all rays with masks.  ``m`` is the
    tree-space setup (``accel.MarchInputs``).  As in JAX, every ray
    descends at its current ``t`` in every iteration, so a ray that is
    done (or missed the box) still marks the chunks above its last
    position while others march.  Returns (out [R, 4], split_vote,
    sample_vote [R, 3], visited [max_capacity] i32, steps [R] i32)."""
    N, N3 = tree.N, tree.N3
    D = tree.data_dim
    R = m.d.shape[0]
    dev = m.d.device
    f32, i32 = torch.float32, torch.int32
    child_flat = tree.child.reshape(-1)
    data_flat = tree.data.reshape(-1, D)
    counts_flat = tree.sample_counts.reshape(-1)
    n_nodes = data_flat.shape[0]
    step = torch.tensor(m.step_size, dtype=f32, device=dev)
    s_thresh = torch.tensor(m.sigma_thresh, dtype=f32, device=dev)
    t_thresh = torch.tensor(m.stop_thresh, dtype=f32, device=dev)
    depth_mode = bool(opt.render_depth)
    B = m.basis.shape[1]

    acc = torch.zeros((R, 3), dtype=f32, device=dev)
    votes = vote_state(R, opt.max_depth, opt.max_sample_count, dev)
    visited = torch.zeros((tree.max_capacity,), dtype=i32, device=dev)
    if track_visit:
        visited[0] = 1
    t = m.tmin.clone()
    T = torch.ones((R,), dtype=f32, device=dev)
    stopped = torch.zeros((R,), dtype=torch.bool, device=dev)
    steps = torch.zeros((R,), dtype=i32, device=dev)
    active = ~m.miss & (t < m.tmax)
    it = 0
    while bool(active.any()) and (not max_iters or it < max_iters):
        it += 1
        steps = steps + active.to(i32)
        pos = fma_f32(t[:, None], m.d, m.cen[None, :])
        frac, chunk, cidx, depth = _descend(
            child_flat, pos, N, max_levels,
            visited if track_visit else None)
        node = (chunk * N3 + cidx).long().clamp(0, n_nodes - 1)
        cube = ipow_f32(N, depth)
        delta_t = _dda_unit_batch(frac, m.invdir) / cube + step
        leaf = data_flat[node].to(f32)
        sigma = leaf[:, D - 1]
        dense = sigma > s_thresh
        att = torch.exp(-delta_t * m.delta_scale * sigma)
        weight = T * (1.0 - att)
        sc = counts_flat[node].to(i32)
        vote_step(opt.max_depth, opt.max_sample_count, votes, active, dense,
                  weight, depth, chunk, cidx, sc)
        contribute = active & dense
        zero = torch.zeros((), dtype=f32, device=dev)
        if depth_mode:
            acc[:, 0] = acc[:, 0] + torch.where(contribute, weight * t, zero)
        else:
            if m.use_sh:
                coeffs = leaf[:, :3 * B].reshape(R, 3, B)
                rgb = torch.sigmoid((m.basis[:, None, :] * coeffs).sum(-1))
            else:
                rgb = leaf[:, :3]
            acc = acc + torch.where(contribute[:, None],
                                    weight[:, None] * rgb, zero)
        T = torch.where(contribute, T * att, T)
        stop_now = contribute & (T < t_thresh)
        stopped = stopped | stop_now
        t = torch.where(active, t + delta_t, t)
        active = active & ~stop_now & (t < m.tmax)
    out = postprocess(acc, T, stopped, m.miss, depth_mode)
    return (out, votes["split_vote"], votes["sample_vote"], visited, steps)


def postprocess(acc, T, stopped, miss, depth_mode: bool) -> torch.Tensor:
    """rgba from the march's sums (``render.py:265-278``, reference
    ``rt_core.cuh:295-331``): a stopped ray's colour is rescaled by
    ``1 / (1 - T)``; depth mode writes ``min(0.3 * sum(w t), 1)`` in grey
    (0 for a miss) with alpha 1."""
    f32 = torch.float32
    R = T.shape[0]
    dev = T.device
    one = torch.ones_like(T)
    scale = torch.where(stopped, 1.0 / (1.0 - T), one)
    if depth_mode:
        d0 = torch.clamp_max(acc[:, 0] * 0.3, 1.0)
        rgb = torch.where(miss[:, None], torch.zeros((), dtype=f32,
                                                     device=dev),
                          d0[:, None].expand(R, 3))
        return torch.cat([rgb * scale[:, None], one[:, None]], 1)
    alpha = torch.where(stopped, one,
                        torch.where(miss, torch.zeros_like(T), 1.0 - T))
    return torch.cat([acc * scale[:, None], alpha[:, None]], 1)


def exact_march(tree, m, opt: RenderOptions, track_visit: bool = False,
                max_levels: int = DEFAULT_MAX_LEVELS, max_iters: int = 0):
    """The exact march from the tree-space setup ``m``
    (``accel.MarchInputs``): kernel E for CUDA tensors, the plain version
    for CPU tensors.  Returns (out [R, 4], split_vote, sample_vote [R, 3],
    visited [max_capacity] i32, steps [R] i32)."""
    if m.d.device.type == "cpu":
        return exact_march_reference(tree, m, opt, track_visit, max_levels,
                                     max_iters)
    return kernels.exact_march(tree, m, opt, track_visit, max_levels,
                               max_iters)


def render_rays(tree, dirs: torch.Tensor, vdirs: torch.Tensor, cen_world,
                opt: RenderOptions, tmax_bg: Optional[torch.Tensor] = None,
                track_visit: bool = False,
                max_levels: int = DEFAULT_MAX_LEVELS,
                max_iters: int = 0) -> RenderResult:
    """March a batch of world rays through the tree (``render.py:119``).
    ``tmax_bg`` [R] is a background depth (None: 1e9); ``max_iters`` caps
    the march's iterations (0: none)."""
    from .accel import march_inputs
    m = march_inputs(tree, dirs, vdirs, cen_world, opt, tmax_bg)
    out, sv, pv, visited, _ = exact_march(tree, m, opt, track_visit,
                                          max_levels, max_iters)
    return RenderResult(out, sv, pv, visited)


def render_frame(tree, width: int, height: int, fx, fy, cx, cy,
                 transform, opt: RenderOptions, track_visit: bool = False,
                 max_levels: int = DEFAULT_MAX_LEVELS):
    """A full exact frame: raygen, march, background composite
    (``render.py:304-322``).  Returns (image [H, W, 4] f32,
    RenderResult)."""
    from .rays import rodrigues, screen2worlddir
    transform = torch.as_tensor(transform, dtype=torch.float32,
                                device=tree.device)
    dirs, cen = screen2worlddir(width, height, fx, fy, cx, cy, transform)
    vdirs = rodrigues(opt.rot_dirs, dirs)
    res = render_rays(tree, dirs, vdirs, cen, opt, track_visit=track_visit,
                      max_levels=max_levels)
    img = composite_background(res.out, opt)
    return img.reshape(height, width, 4), res
