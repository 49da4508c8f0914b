"""Dense leaf-map acceleration structure, fast march and fast frames.

Counterpart of ``mega_nerf_viewer_tpu/ops/accel.py`` for the steady
leaf-map voxel frame:

  * ``LeafMap`` — a dense grid at octree level ``L`` mapping every cell to
    its covering leaf as packed ``(node_id, meta)`` i32 pairs; ``meta``
    carries the leaf depth, an is-internal flag, a clamped sample count
    and the leaf's sigma as raw f16 bits.  Cells whose subtree is deeper
    than ``L`` store the level-``L`` chunk and the march finishes the
    descent (``deep_levels`` more levels).
  * :func:`render_rays_fast` — the fast march.  On a CUDA tensor it
    launches ``csrc/march.cu``: one thread per ray does the leaf lookup,
    the DDA step, sigma-gated compositing, early stop and SH shading of
    each sample that the JAX record buffer would keep.  On a CPU tensor
    it runs :func:`render_rays_fast_reference`, the JAX while loop as
    batched torch ops with the record buffer and deferred shading.
  * The record-sorted segmented frame (:func:`render_frame_fast_segmented`)
    sorts rays by the previous frame's hints (:func:`order_from_hints`)
    and marches each segment with its own ``max_dense`` budget.

Exactness: for N == 2 the leaf found, its depth, the in-leaf position and
sigma are those of the reference descent, so step positions and early
termination match the exact renderer.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import kernels
from ..device import resolve_device
from ..n3tree.tree import N3Tree
from ..options import RenderOptions
from .fp import fma_f32, pow2_f32, rsqrt_f32
from .rays import (rodrigues, screen2worlddir, screen2worlddir_indices,
                   sq_norm)
from .render import (_dda_unit_batch, _dda_world_batch, composite_background,
                     postprocess, vote_state, vote_step)
from .sh import masked_sh_basis
from .skip_prepass import EPS_HI, entry_skip_prepass

# meta layout (i32): bits 0-4 depth, bit 5 internal, bits 6-15 clamped
# sample count, bits 16-31 sigma as raw float16 bits.
_DEPTH_BITS = 31
_INTERNAL_BIT = 1 << 5
_COUNT_SHIFT = 6
_COUNT_MAX = 1023


@dataclasses.dataclass(frozen=True)
class LeafMap:
    rows: torch.Tensor  # i32 [G^3, 2] = (node, meta)
    level: int = 6
    deep_levels: int = 0

    @property
    def grid(self) -> int:
        return 1 << self.level


def _f16_bits_to_f32(bits: torch.Tensor) -> torch.Tensor:
    return bits.to(torch.int16).view(torch.float16).to(torch.float32)


def tree_max_depth(tree: N3Tree) -> int:
    """Max leaf depth of the live tree (host-side, build time only).

    A chunk with ``a`` ancestors holds leaves at depth a+1; parents may
    appear in any array order after pruning, so walk iteratively."""
    cap = int(tree.capacity)
    parent = tree.parent[:cap].cpu().numpy() // tree.N3
    cur = parent.copy()
    ancestors = np.ones(cap, np.int64)
    for _ in range(64):
        at_root = cur == 0
        if at_root.all():
            break
        ancestors = ancestors + (~at_root)
        cur = parent[cur]
    return int(ancestors.max()) + 1


def _up(a: torch.Tensor) -> torch.Tensor:
    """Replicate each lattice cell into its 2x2x2 children (x-major)."""
    g = a.shape[0]
    return a[:, None, :, None, :, None].expand(g, 2, g, 2, g, 2).reshape(
        2 * g, 2 * g, 2 * g)


def _build_rows(tree: N3Tree, level: int, deep_levels: int) -> torch.Tensor:
    """The (node, meta) rows by a level-wise (mip) descent.

    Cells inside an already-found leaf replicate their parent cell's
    state; each level's lattice pays one child gather, and the descent
    digit is the low bit of each cell coordinate.  N == 2 only.
    (``deep_levels`` is carried by the LeafMap; the rows do not depend on
    it.)"""
    dev = tree.device
    i32 = torch.int32
    N3 = tree.N3
    child_flat = tree.child.reshape(-1)
    n_child = child_flat.numel()

    chunk = torch.zeros((1, 1, 1), dtype=i32, device=dev)
    cidx = torch.zeros((1, 1, 1), dtype=i32, device=dev)
    depth = torch.ones((1, 1, 1), dtype=i32, device=dev)
    done = torch.zeros((1, 1, 1), dtype=torch.bool, device=dev)
    for l in range(level):
        g2 = 2 << l
        chunk, cidx, depth, done = map(_up, (chunk, cidx, depth, done))
        bx = torch.arange(g2, dtype=i32, device=dev) & 1
        idx = (bx[:, None, None] * 4 + bx[None, :, None] * 2
               + bx[None, None, :]).expand(g2, g2, g2)
        skip = child_flat[(chunk * N3 + idx).clamp(0, n_child - 1)]
        upd = ~done
        go = upd & (skip != 0)
        cidx = torch.where(upd, idx, cidx)
        chunk = torch.where(go, chunk + skip, chunk)
        depth = torch.where(go, depth + 1, depth)
        done = done | (skip == 0)

    chunk, cidx, depth, done = (a.reshape(-1)
                                for a in (chunk, cidx, depth, done))
    node = chunk * N3 + cidx
    D = tree.data_dim
    sigma_bits = tree.data.reshape(-1, D)[:, D - 1].contiguous().view(
        torch.int16).to(torch.int64) & 0xFFFF
    counts = tree.sample_counts.reshape(-1).to(torch.int64).clamp(
        0, _COUNT_MAX)
    aux = ((sigma_bits << 16) | (counts << _COUNT_SHIFT)).to(i32)
    meta = (depth.clamp(0, _DEPTH_BITS)
            | ((~done).to(i32) << 5)
            | aux[node.clamp(0, aux.numel() - 1)])
    node = torch.where(done, node, chunk)
    return torch.stack([node, meta], dim=-1).contiguous()


def build_leaf_map(tree: N3Tree, level: Optional[int] = None) -> LeafMap:
    """Build the dense leaf map (rebuild after refinement).  N == 2 only:
    the binary lattice and the march's power-of-two depth math assume it.
    ``level=None`` takes the device cap from ``utils.tuning``."""
    if tree.N != 2:
        raise ValueError(
            f"leaf-map fast path supports N == 2 only (tree has N="
            f"{tree.N}); use the exact renderer")
    max_d = tree_max_depth(tree)
    if level is None:
        from ..utils.tuning import device_tuning
        level = min(max_d, device_tuning(tree.device).leaf_map_level_cap)
    deep = max(0, max_d - level)
    return LeafMap(rows=_build_rows(tree, level, deep), level=level,
                   deep_levels=deep)


class FastRenderResult(NamedTuple):
    out: torch.Tensor         # [R, 4] rgba pre-background
    overflow: torch.Tensor    # [] i32 COUNT of rays that exceeded max_dense
    steps: torch.Tensor       # [R] i32 march iterations per ray
    split_vote: torch.Tensor  # [R, 3] with need_votes, else [0, 3]
    sample_vote: torch.Tensor  # [R, 3] with need_votes, else [0, 3]
    nrec: torch.Tensor        # [R] i32 dense samples per ray (uncapped)
    skips: torch.Tensor       # [R] i32 prepass entry-skip count


def leaf_lookup(leaf_map: LeafMap, child_flat: torch.Tensor,
                sigma_flat: torch.Tensor, posc: torch.Tensor,
                N: int, N3: int):
    """One march step's leaf resolution (reference
    ``query_single_from_root``, rt_core.cuh:117-159, restarted from the
    leaf map's level-L row).  ``posc`` = clipped tree-space positions
    [r, 3].  Returns (node, depth, sigma).  Cells deeper than the map
    resume the child-table descent from the stored chunk for
    ``deep_levels + 1`` bounded iterations."""
    G = leaf_map.grid
    cell = torch.floor(posc * float(G)).to(torch.int32)
    lin = (cell[:, 0] * G + cell[:, 1]) * G + cell[:, 2]
    row = leaf_map.rows[lin.clamp(0, leaf_map.rows.shape[0] - 1)]
    node = row[:, 0]
    meta = row[:, 1]
    depth = meta & _DEPTH_BITS
    sigma = _f16_bits_to_f32((meta >> 16) & 0xFFFF)
    if leaf_map.deep_levels > 0:
        internal = (meta & _INTERNAL_BIT) != 0
        u = posc * float(1 << leaf_map.level)
        fxyz = u - torch.floor(u)
        chunk = node
        cidx = torch.zeros_like(node)
        ddepth = depth
        done = ~internal
        n_child = child_flat.numel()
        for _ in range(leaf_map.deep_levels + 1):
            upd = ~done
            u2 = fxyz * float(N)
            digs = torch.floor(u2)
            idx2 = (digs[:, 0] * (N * N) + digs[:, 1] * N
                    + digs[:, 2]).to(torch.int32)
            skip = child_flat[(chunk * N3 + idx2).clamp(0, n_child - 1)]
            go = upd & (skip != 0)
            fxyz = torch.where(upd[:, None], u2 - digs, fxyz)
            cidx = torch.where(upd, idx2, cidx)
            chunk = torch.where(go, chunk + skip, chunk)
            ddepth = torch.where(go, ddepth + 1, ddepth)
            done = done | (skip == 0)
        node_deep = chunk * N3 + cidx
        node = torch.where(internal, node_deep, node)
        depth = torch.where(internal, ddepth, depth)
        sigma_deep = sigma_flat[node_deep.clamp(0, sigma_flat.numel() - 1)]
        sigma = torch.where(internal, sigma_deep.to(torch.float32), sigma)
    return node, depth, sigma


def _f32(x) -> float:
    """A knob as the nearest f32, kept as a Python float."""
    return float(np.float32(x))


class MarchInputs(NamedTuple):
    """Per-ray tree-space inputs of the march (and of the prepass)."""
    cen: torch.Tensor          # [3] tree-space origin
    d: torch.Tensor            # [R, 3] scaled unit directions
    invdir: torch.Tensor       # [R, 3]
    delta_scale: torch.Tensor  # [R] world length per tree-space length
    tmin: torch.Tensor         # [R]
    tmax: torch.Tensor         # [R]
    miss: torch.Tensor         # [R] bool, the ray misses the bbox
    # [R, basis_dim] masked SH basis ([R, 1] if none; None for the collect)
    basis: Optional[torch.Tensor]
    step_size: float
    sigma_thresh: float
    stop_thresh: float
    use_sh: bool
    render_depth: bool = False


_PER_RAY = ("d", "invdir", "delta_scale", "tmin", "tmax", "miss", "basis")


def slice_rays(m: MarchInputs, sl: slice) -> MarchInputs:
    """``m`` with its per-ray fields cut to the rays ``sl``."""
    return m._replace(**{k: getattr(m, k)[sl] for k in _PER_RAY
                         if getattr(m, k) is not None})


def ray_setup(tree: N3Tree, dirs: torch.Tensor, cen_world, render_bbox,
              tmax_bg: Optional[torch.Tensor] = None):
    """World rays -> tree-space (cen [3], d, invdir [R, 3], delta_scale,
    tmin, tmax [R], miss [R] bool), the setup shared by the render march
    (``accel.py:410-420``) and the guided collect (``guided.py:382-388``,
    which has no ``tmax_bg`` clamp: pass None)."""
    dev = dirs.device
    cen_world = torch.as_tensor(cen_world, dtype=torch.float32, device=dev)
    cen = fma_f32(tree.scale, cen_world, tree.offset)
    d = dirs * tree.scale[None, :]
    delta_scale = rsqrt_f32(sq_norm(d))
    d = d * delta_scale[:, None]
    invdir = 1.0 / (d + _f32(1e-9))
    tmin, tmax = _dda_world_batch(cen, invdir, render_bbox)
    if tmax_bg is not None:
        tmax = torch.minimum(tmax, tmax_bg / delta_scale)
    miss = (tmax < 0) | (tmin > tmax)
    return (cen, d.contiguous(), invdir.contiguous(), delta_scale, tmin,
            tmax, miss)


def march_inputs(tree: N3Tree, dirs: torch.Tensor, vdirs: torch.Tensor,
                 cen_world, opt: RenderOptions,
                 tmax_bg: Optional[torch.Tensor] = None,
                 dyn=None) -> MarchInputs:
    """World rays -> the march's tree-space inputs (``accel.py:399-434``).
    ``dyn`` = [step_size, sigma_thresh, stop_thresh, render_bbox*6]
    overrides those knobs of ``opt``.  In depth mode the basis is a zero
    column, as in JAX: nothing is shaded."""
    R = dirs.shape[0]
    dev = dirs.device
    basis_dim = tree.data_format.basis_dim
    use_sh = tree.data_format.format == "SH" and basis_dim >= 1
    if dyn is not None:
        dyn = [float(v) for v in dyn]
        knobs, render_bbox = dyn[:3], dyn[3:9]
    else:
        knobs = (opt.step_size, opt.sigma_thresh, opt.stop_thresh)
        render_bbox = opt.render_bbox
    step_size, sigma_thresh, stop_thresh = map(_f32, knobs)
    if tmax_bg is None:
        tmax_bg = torch.full((R,), 1e9, dtype=torch.float32, device=dev)
    cen, d, invdir, delta_scale, tmin, tmax, miss = ray_setup(
        tree, dirs, cen_world, render_bbox, tmax_bg)
    if use_sh and not opt.render_depth:
        basis = masked_sh_basis(basis_dim, vdirs, opt.basis_minmax[0],
                                opt.basis_minmax[1]).contiguous()
    else:
        basis = torch.zeros((R, 1), dtype=torch.float32, device=dev)
    return MarchInputs(cen, d, invdir, delta_scale, tmin, tmax, miss,
                       basis, step_size, sigma_thresh, stop_thresh, use_sh,
                       bool(opt.render_depth))


def _prepass(m: MarchInputs, skip_table: Optional[torch.Tensor]):
    """Advance ``m.tmin`` through entry empty space when a skip table is
    given.  Returns (inputs for the march, skips [R] i32)."""
    if skip_table is None:
        return m, torch.zeros_like(m.tmin, dtype=torch.int32)
    tmin, skips = entry_skip_prepass(skip_table, m.cen, m.d, m.invdir,
                                     m.tmin, m.tmax, ~m.miss, m.step_size)
    return m._replace(tmin=tmin), skips


def fused_march(tree: N3Tree, leaf_map: LeafMap, m: MarchInputs,
                max_dense: int, chunk_size: int = 0, votes=None):
    """The march from ``m``: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors.  ``votes`` = (max_depth, max_sample_count)
    asks for the split and sample votes.  Returns (out [R, 4], overflow
    count [] i32, nsteps [R] i32, nrec [R] i32[, split_vote, sample_vote
    [R, 3] with ``votes``])."""
    args = (tree, leaf_map, m.cen, m.d, m.invdir, m.delta_scale, m.tmin,
            m.tmax, m.miss, m.basis, m.step_size, m.sigma_thresh,
            m.stop_thresh, int(max_dense), m.use_sh)
    kw = dict(votes=votes, render_depth=m.render_depth)
    if m.d.device.type == "cpu":
        return render_rays_fast_reference(*args, chunk_size=chunk_size, **kw)
    return kernels.march(*args, **kw)


def render_rays_fast(tree: N3Tree,
                     leaf_map: LeafMap,
                     dirs: torch.Tensor,
                     vdirs: torch.Tensor,
                     cen_world: torch.Tensor,
                     opt: RenderOptions,
                     tmax_bg: Optional[torch.Tensor] = None,
                     max_dense: int = 64,
                     chunk_size: int = 0,
                     need_votes: bool = False,
                     dyn=None,
                     skip_table: Optional[torch.Tensor] = None
                     ) -> FastRenderResult:
    """Fast march: leaf-map lookup, sigma-gated compositing, SH shading.

    ``dyn`` = [step_size, sigma_thresh, stop_thresh, render_bbox*6]
    overrides those knobs of ``opt``.  ``skip_table`` (from
    :func:`..skip_prepass.build_skip_table`, valid for this
    ``sigma_thresh``) runs the entry-skip prepass first.  ``chunk_size``
    bounds the plain version's working set; the kernel has no tiles.
    ``need_votes`` adds the split and sample votes of the exact march
    (one more sample-count read per step); vote frames take no skip table
    in the viewer, since the fallback vote inspects empty leaves.
    """
    m, skips = _prepass(march_inputs(tree, dirs, vdirs, cen_world, opt,
                                     tmax_bg, dyn), skip_table)
    res = fused_march(tree, leaf_map, m, max_dense, chunk_size,
                      _vote_knobs(opt) if need_votes else None)
    out, overflow, nsteps, nrec = res[:4]
    if need_votes:
        sv, pv = res[4:]
    else:
        sv = pv = torch.zeros((0, 3), dtype=torch.float32, device=dirs.device)
    return FastRenderResult(out, overflow, nsteps, sv, pv, nrec, skips)


def _vote_knobs(opt: RenderOptions) -> tuple:
    return (int(opt.max_depth), int(opt.max_sample_count))


def render_rays_fast_reference(tree, leaf_map, cen, d, invdir, delta_scale,
                               tmin, tmax, miss, basis, step_size,
                               sigma_thresh, stop_thresh, max_dense, use_sh,
                               chunk_size: int = 0, votes=None,
                               render_depth: bool = False):
    """The march as plain torch ops: the JAX while loop's step
    (``accel.py:468-545``) over all rays with masks, a per-ray record
    buffer of up to ``max_dense`` (node or, in depth mode, t; weight)
    pairs, then deferred shading (``:565-611``).  ``votes`` =
    (max_depth, max_sample_count) keeps the exact march's split and sample
    votes (``:487-513``).  Returns (out [R, 4], overflow count [] i32,
    nsteps [R] i32, nrec [R] i32[, split_vote, sample_vote [R, 3]])."""
    R = d.shape[0]
    if chunk_size and R > chunk_size:
        parts = [render_rays_fast_reference(
            tree, leaf_map, cen, d[s], invdir[s], delta_scale[s], tmin[s],
            tmax[s], miss[s], basis[s], step_size, sigma_thresh,
            stop_thresh, max_dense, use_sh, votes=votes,
            render_depth=render_depth)
            for s in (slice(i, i + chunk_size)
                      for i in range(0, R, chunk_size))]
        return tuple(sum(p[1] for p in parts).to(torch.int32) if k == 1
                     else torch.cat([p[k] for p in parts])
                     for k in range(len(parts[0])))
    dev = d.device
    f32, i32 = torch.float32, torch.int32
    N, N3 = tree.N, tree.N3
    D = tree.data_dim
    child_flat = tree.child.reshape(-1)
    data_flat = tree.data.reshape(-1, D)
    sigma_flat = data_flat[:, D - 1]
    counts_flat = tree.sample_counts.reshape(-1)
    step = torch.tensor(step_size, dtype=f32, device=dev)
    s_thresh = torch.tensor(sigma_thresh, dtype=f32, device=dev)
    t_thresh = torch.tensor(stop_thresh, dtype=f32, device=dev)

    md = max_dense
    nodes_buf = torch.zeros((R, md), dtype=torch.int64, device=dev)
    w_buf = torch.zeros((R, md), dtype=f32, device=dev)
    t_buf = torch.zeros((R, md), dtype=f32, device=dev)
    nd = torch.zeros((R,), dtype=i32, device=dev)
    nsteps = torch.zeros((R,), dtype=i32, device=dev)
    vs = vote_state(R, *votes, dev) if votes is not None else None
    t = tmin.clone()
    T = torch.ones((R,), dtype=f32, device=dev)
    stopped = torch.zeros((R,), dtype=torch.bool, device=dev)
    overflow = torch.zeros((R,), dtype=torch.bool, device=dev)
    active = ~miss & (t < tmax)
    ray = torch.arange(R, device=dev)
    while bool(active.any()):
        nsteps = nsteps + active.to(i32)
        pos = fma_f32(t[:, None], d, cen[None, :])
        posc = torch.clamp(pos, 0.0, EPS_HI)
        node, depth, sigma = leaf_lookup(leaf_map, child_flat, sigma_flat,
                                         posc, N, N3)
        cube = pow2_f32(depth)
        u = posc * cube[:, None]
        frac = u - torch.floor(u)
        delta_t = _dda_unit_batch(frac, invdir) / cube + step
        dense = active & (sigma > s_thresh)
        att = torch.exp(-delta_t * delta_scale * sigma)
        weight = T * (1.0 - att)
        if vs is not None:
            sc = counts_flat[node.long().clamp(0, counts_flat.numel() - 1)]
            vote_step(*votes, vs, active, dense, weight, depth,
                      torch.div(node, N3, rounding_mode="floor"),
                      node % N3, sc.to(i32))
        overflow = overflow | (dense & (nd >= md))
        if md > 0:
            rec = dense & (nd < md)
            slot = nd[rec].long()
            nodes_buf[ray[rec], slot] = node[rec].long()
            w_buf[ray[rec], slot] = weight[rec]
            t_buf[ray[rec], slot] = t[rec]
        nd = nd + dense.to(i32)
        T = torch.where(dense, T * att, T)
        stop_now = dense & (T < t_thresh)
        stopped = stopped | stop_now
        t = torch.where(active, t + delta_t, t)
        active = active & ~stop_now & (t < tmax)

    zero = torch.zeros((), dtype=f32, device=dev)
    valid = torch.arange(md, device=dev)[None, :] < nd[:, None]
    if md == 0:
        # nothing recorded: rgb 0; depth mode writes alpha 1
        out = torch.zeros((R, 4), dtype=f32, device=dev)
        out[:, 3] = 1.0 if render_depth else torch.where(
            stopped, torch.ones_like(T),
            torch.where(miss, torch.zeros_like(T), 1.0 - T))
    elif render_depth:
        d0 = torch.where(valid, w_buf * t_buf, zero).sum(1)
        acc = torch.stack([d0, zero.expand(R), zero.expand(R)], 1)
        out = postprocess(acc, T, stopped, miss, True)
    else:
        leaf = data_flat[nodes_buf.clamp(0, data_flat.shape[0] - 1)].to(f32)
        if use_sh:
            B = basis.shape[1]
            coeffs = leaf[..., :3 * B].reshape(R, md, 3, B)
            rgb_s = torch.sigmoid(
                (basis[:, None, None, :] * coeffs).sum(-1))
        else:
            rgb_s = leaf[..., :3]
        rgb = torch.where(valid[..., None], w_buf[..., None] * rgb_s,
                          zero).sum(1)
        out = postprocess(rgb, T, stopped, miss, False)
    res = (out, overflow.sum().to(i32), nsteps, nd)
    if vs is not None:
        res = res + (vs["split_vote"], vs["sample_vote"])
    return res


# ----------------------------------------------------------------------
# Frames
# ----------------------------------------------------------------------
def _frame_core(tree: N3Tree, leaf_map: LeafMap,
                perm: torch.Tensor, inv: torch.Tensor,
                camera, opt: RenderOptions,
                skip_table: Optional[torch.Tensor],
                *, seg_counts: tuple, chunk_size: int,
                return_hints, group: int = 1,
                sorted_output: bool = False, need_votes: bool = False):
    """One fast frame: raygen in ``perm`` order -> setup -> (prepass) ->
    march per segment -> unpermute -> background composite.  ``seg_counts`` =
    ((n_chunks, max_dense), ...); the frame is padded to whole chunks
    with copies of the last ray.  ``group`` > 1 asserts group-structured
    (perm, inv) (``order_from_hints(..., group=g)``) and unpermutes
    [R/g, 4g] rows.  ``sorted_output`` leaves the rows in ``perm`` order
    (the composite is elementwise, so that is bit-identical).
    ``need_votes`` adds ``split_vote`` and ``sample_vote`` in pixel
    order.  ``return_hints`` adds ``steps``, ``nrec`` and ``skips`` in
    pixel order, or, as ``"packed"``, one ``hints_packed`` array in
    :func:`pack_hints` layout (``accel.py:708-723``, ``:821-822``)."""
    dev = tree.device
    R = inv.shape[0]
    n_total = sum(c for c, _ in seg_counts) * chunk_size
    pad = n_total - R
    pix = perm if not pad else torch.cat([perm, perm[-1:].expand(pad)])
    transform = torch.as_tensor(camera.transform, dtype=torch.float32,
                                device=dev)
    dirs_p, cen = screen2worlddir_indices(
        pix, camera.width, camera.fx, camera.fy, camera.cx, camera.cy,
        transform)
    vdirs_p = rodrigues(opt.rot_dirs, dirs_p)
    # the per-ray setup and the prepass run once for the whole frame;
    # each segment then marches its slice with its own budget
    m, skips = _prepass(march_inputs(tree, dirs_p, vdirs_p, cen, opt),
                        skip_table)

    outs, ovs, steps, nrec, svs, pvs = [], [], [], [], [], []
    votes = _vote_knobs(opt) if need_votes else None
    off = 0
    for c_chunks, md in seg_counts:
        if c_chunks == 0:
            # keep the overflow vector index-aligned with the segments
            ovs.append(torch.zeros((), dtype=torch.int32, device=dev))
            continue
        sl = slice(off, off + c_chunks * chunk_size)
        res = fused_march(tree, leaf_map, slice_rays(m, sl), md,
                          chunk_size, votes)
        out, overflow, st, nr = res[:4]
        if need_votes:
            svs.append(res[4])
            pvs.append(res[5])
        outs.append(out)
        ovs.append(overflow)
        steps.append(st)
        nrec.append(nr)
        off += c_chunks * chunk_size

    out = torch.cat(outs, 0)[:R]
    if sorted_output:
        pass
    elif group > 1 and R % group == 0:
        ginv = torch.div(inv[::group], group, rounding_mode="floor")
        out = out.reshape(R // group, 4 * group)[ginv].reshape(R, 4)
    else:
        out = out[inv]
    ret = dict(img=composite_background(out, opt),
               seg_overflow=torch.stack(ovs))
    if need_votes:
        ret["split_vote"] = torch.cat(svs, 0)[:R][inv]
        ret["sample_vote"] = torch.cat(pvs, 0)[:R][inv]
    if return_hints == "packed":
        # one [R] i32 and one unpermute gather instead of three
        ret["hints_packed"] = pack_hints(torch.cat(steps, 0)[:R],
                                         torch.cat(nrec, 0)[:R],
                                         skips[:R])[inv]
    elif return_hints:
        ret["steps"] = torch.cat(steps, 0)[:R][inv]
        ret["nrec"] = torch.cat(nrec, 0)[:R][inv]
        ret["skips"] = skips[:R][inv]
    return ret


def block_permutation(width: int, height: int, block: int = 16,
                      device=None):
    """Pixel permutation grouping rays into square ``block`` x ``block``
    pixel blocks, plus its inverse (int64 tensors on ``device``)."""
    device = resolve_device(device)
    ys, xs = np.meshgrid(np.arange(height), np.arange(width), indexing="ij")
    nbx = (width + block - 1) // block
    key = (((ys // block) * nbx + xs // block) * (block * block)
           + (ys % block) * block + (xs % block))
    perm = np.argsort(key.reshape(-1), kind="stable")
    inv = np.argsort(perm, kind="stable")
    return (torch.from_numpy(perm).to(device),
            torch.from_numpy(inv).to(device))


def _argsort_stable(key: torch.Tensor):
    perm = torch.sort(key, stable=True).indices
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(perm.numel(), device=perm.device)
    return perm, inv


def order_from_hints(steps, nrec, skips=None, group: int = 1):
    """(perm, inv) ray order for the segmented frame: primary key = dense
    record count, secondary = march steps, tertiary = prepass skips.

    The keys are those of the JAX package (a 12-bit steps key without
    skips and group; else nrec<=15 << 18 | steps<=511 << 9 | skips<=511),
    sorted stably, so the permutation is the same.  ``group`` sorts runs
    of ``group`` consecutive pixels by their run-max key; pass the same
    value to the frame.  Returns int64 tensors on the hints' device."""
    steps = torch.as_tensor(steps).to(torch.int64)
    nrec = torch.as_tensor(nrec).to(torch.int64).to(steps.device)
    if skips is None and group == 1:
        return _argsort_stable((nrec.clamp_max(255) << 12)
                               | steps.clamp_max(4095))
    if skips is None:
        skips = torch.zeros_like(steps)
    skips = torch.as_tensor(skips).to(torch.int64).to(steps.device)
    key = ((nrec.clamp_max(15) << 18) | (steps.clamp_max(511) << 9)
           | skips.clamp_max(511))
    if group == 1:
        return _argsort_stable(key)
    R = key.shape[0]
    if R % group:
        raise ValueError(f"ray count {R} not divisible by group {group}")
    gperm, _ = _argsort_stable(key.reshape(-1, group).amax(1))
    perm = (gperm[:, None] * group + torch.arange(
        group, device=key.device)[None, :]).reshape(-1)
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(R, device=key.device)
    return perm, inv


# Per-segment (ray fraction, max_dense) budgets for record-sorted frames,
# the JAX package's values (from the record-count CDF of the 1080p shell
# frame: about half the rays record nothing).  An overflowing segment is
# escalated by the caller (0 -> 1, then doubling) and re-rendered.
DEFAULT_SEGMENTS = ((0.515, 0), (0.35, 1), (0.065, 2),
                    (0.055, 4), (0.015, 8))


def class_ladder(top: int) -> tuple:
    """The power-of-two budget ladder (0, 1, 2, 4, ..., top) that
    CDF-derived segment tuples draw their budgets from."""
    classes = [0]
    c = 1
    while c < top:
        classes.append(c)
        c *= 2
    classes.append(int(top))
    return tuple(classes)


# ----------------------------------------------------------------------
# Hints: packing, class CDFs, budgets, motion dilation, device orders
# ----------------------------------------------------------------------
def pack_hints(steps, nrec, skips) -> torch.Tensor:
    """Per-ray (steps, nrec, skips) hints folded into one i32
    (``accel.py:939-957``): ``nrec:8 @18 | steps:9 @9 | skips:9 @0``, the
    shift layout :func:`order_from_hints_device` sorts by, so the packed
    value is the order key itself.  The nrec field's cap (255) is above
    the 128 escalation ceiling, so budget classes survive packing."""
    steps = torch.as_tensor(steps).to(torch.int32).clamp_max(511)
    nrec = torch.as_tensor(nrec).to(torch.int32).to(
        steps.device).clamp_max(255)
    skips = (torch.zeros_like(steps) if skips is None else
             torch.as_tensor(skips).to(torch.int32).to(
                 steps.device).clamp_max(511))
    return (nrec << 18) | (steps << 9) | skips


def order_from_packed_device(ph) -> tuple:
    """(perm, inv) from packed hints (``accel.py:986-996``): a stable sort
    of the packed value.  int64 tensors on the hints' device."""
    return _argsort_stable(torch.as_tensor(ph).to(torch.int32))


def hint_class_cdf(nrec, classes: tuple = (0, 1, 2, 4, 8)) -> torch.Tensor:
    """Per-class counts of ``nrec <= c`` over the budget ladder, then the
    hint max (``accel.py:1013-1023``): i32 [len(classes) + 1], on the
    hints' device."""
    nrec = torch.as_tensor(nrec).to(torch.int32)
    return torch.stack([(nrec <= c).sum().to(torch.int32) for c in classes]
                       + [nrec.max()])


def hint_class_cdf_packed(ph, classes: tuple = (0, 1, 2, 4, 8)):
    """:func:`hint_class_cdf` over the nrec field of packed hints
    (``accel.py:978-983``)."""
    return hint_class_cdf(torch.as_tensor(ph).to(torch.int32) >> 18, classes)


def segments_from_hint_cdf(cdf_counts, R: int,
                           classes: tuple = (0, 1, 2, 4, 8),
                           quant: int = 16,
                           headroom: bool = False,
                           max_budget: int = 128,
                           margin: int = 0,
                           top_headroom: bool = False) -> tuple:
    """(fraction, max_dense) segments from a hint-class CDF
    (``accel.py:1026-1100``), host arithmetic as in JAX.

    Fractions are floored to 1/``quant`` (less ``margin`` quanta) so each
    class boundary sits at or below its CDF point.  With the trailing
    hint-max entry the last class's budget covers that max, rounded up
    the power-of-two ladder to ``max_budget``; ``top_headroom`` adds one
    more step.  When the top exceeds the ladder, ``classes[-1]`` stays a
    real boundary and only the remainder pays the top (the heavy-tail
    rule, ``:1079-1085``).  ``headroom`` (motion) gives each non-zero
    class the next ladder budget."""
    counts = np.asarray(cdf_counts.cpu() if isinstance(cdf_counts,
                                                       torch.Tensor)
                        else cdf_counts)
    top = int(classes[-1])
    if counts.shape[0] == len(classes) + 1:
        need = int(counts[-1])
        counts = counts[:-1]
        while top < need and top < max_budget:
            top = max(1, top * 2)
    if top_headroom and top < max_budget:
        top = max(1, top * 2)
    boundaries = classes if top > int(classes[-1]) else classes[:-1]
    segs = []
    used = 0.0
    for i, (c, cnt) in enumerate(zip(boundaries, counts[:len(boundaries)])):
        f = max(0.0, np.floor(cnt / R * quant) - margin) / quant
        f = min(f, 1.0 - 1.0 / quant)
        if f > used:
            if headroom and c > 0:
                md = min(top, int(classes[i + 1]) if i + 1 < len(classes)
                         else int(c) * 2)
            else:
                md = int(c)
            segs.append((f - used, md))
            used = f
    segs.append((1.0 - used, top))
    return tuple(segs)


def _axis_windows(window) -> tuple:
    """A dilation window as per-axis (wy, wx); an int is isotropic
    (``accel.py:880-892``)."""
    if isinstance(window, tuple):
        return window
    return (window, window)


def _pool2d_max(img: torch.Tensor, wy: int, wx: int) -> torch.Tensor:
    """Doubling roll-max with wrap-around (``accel.py:895-905``): the reach
    per direction is window - 1."""
    for axis, w in ((0, wy), (1, wx)):
        k = 1
        while k < w:
            img = torch.maximum(img, torch.maximum(
                torch.roll(img, k, axis), torch.roll(img, -k, axis)))
            k *= 2
    return img


def dilate_hints(steps, nrec, skips=None, *, width: int, height: int,
                 window):
    """Max-dilate per-ray hints over the estimated silhouette sweep
    (``accel.py:908-936``), so that rays on a moving silhouette class by
    their neighbourhood's worst case.  ``window``: int or (wy, wx).
    Returns (steps, nrec, skips or None), [H*W] each."""
    wy, wx = _axis_windows(window)

    def pool(a):
        return _pool2d_max(torch.as_tensor(a).reshape(height, width),
                           wy, wx).reshape(-1)
    return pool(steps), pool(nrec), (None if skips is None else pool(skips))


def dilate_packed(ph, *, width: int, height: int, window) -> torch.Tensor:
    """One max dilation of packed hints (``accel.py:960-975``): the max of
    packed keys is a lexicographic (nrec, steps, skips) max, so its nrec
    field is exactly the window's nrec max."""
    wy, wx = _axis_windows(window)
    img = torch.as_tensor(ph).to(torch.int32).reshape(height, width)
    return _pool2d_max(img, wy, wx).reshape(-1)


def order_from_hints_device(steps, nrec, skips=None) -> tuple:
    """(perm, inv) from the three-part key ``min(nrec, 15) << 18 |
    min(steps, 511) << 9 | min(skips, 511)``, stable
    (``accel.py:1178-1204``); the permutation equals JAX's."""
    steps = torch.as_tensor(steps).to(torch.int32)
    nrec = torch.as_tensor(nrec).to(torch.int32).to(steps.device)
    skips = (torch.zeros_like(steps) if skips is None else
             torch.as_tensor(skips).to(torch.int32).to(steps.device))
    key = ((nrec.clamp_max(15) << 18) | (steps.clamp_max(511) << 9)
           | skips.clamp_max(511))
    return _argsort_stable(key)


def order_from_ns_steps_device(nrec, steps) -> tuple:
    """(perm, inv) for the guided collect's cost sort: key ``min(ns, 63)
    << 12 | min(steps, 4095)``, stable (``accel.py:1207-1228``)."""
    nrec = torch.as_tensor(nrec).to(torch.int32)
    steps = torch.as_tensor(steps).to(torch.int32).to(nrec.device)
    return _argsort_stable((nrec.clamp_max(63) << 12)
                           | steps.clamp_max(4095))


def render_frame_fast(tree: N3Tree, leaf_map: LeafMap,
                      camera, opt: RenderOptions,
                      max_dense: int = 64,
                      chunk_size: int = 65536,
                      block: int = 128,
                      order: Optional[tuple] = None,
                      return_nrec: bool = False,
                      skip_table: Optional[torch.Tensor] = None,
                      return_skips: bool = False,
                      need_votes: bool = False):
    """Full fast frame at one ``max_dense`` budget.

    Rays go in ``order`` = (perm, inv), or else in square pixel blocks of
    ``block``.  Ordering only affects speed; pixels are identical.
    Returns ([H, W, 4] f32, overflow count, steps [H*W] i32) and then, as
    asked, (split_vote, sample_vote [H*W, 3]) with ``need_votes``, nrec
    and skips, all in pixel order."""
    w, h = camera.width, camera.height
    R = w * h
    dev = tree.device
    if chunk_size and R > chunk_size:
        perm, inv = order if order is not None else block_permutation(
            w, h, block, device=dev)
        n_chunks = (R + chunk_size - 1) // chunk_size
        res = _frame_core(tree, leaf_map, perm, inv, camera, opt,
                          skip_table, seg_counts=((n_chunks, max_dense),),
                          chunk_size=chunk_size, return_hints=True,
                          need_votes=need_votes)
        img, overflow = res["img"], res["seg_overflow"][0]
        steps, nrec, skips = res["steps"], res["nrec"], res["skips"]
        votes = (res["split_vote"], res["sample_vote"]) if need_votes \
            else ()
    else:
        transform = torch.as_tensor(camera.transform, dtype=torch.float32,
                                    device=dev)
        dirs, cen = screen2worlddir(w, h, camera.fx, camera.fy, camera.cx,
                                    camera.cy, transform)
        vdirs = rodrigues(opt.rot_dirs, dirs)
        res = render_rays_fast(tree, leaf_map, dirs, vdirs, cen, opt,
                               max_dense=max_dense, skip_table=skip_table,
                               need_votes=need_votes)
        img = composite_background(res.out, opt)
        overflow, steps, nrec, skips = (res.overflow, res.steps, res.nrec,
                                        res.skips)
        votes = (res.split_vote, res.sample_vote) if need_votes else ()
    ret = [img.reshape(h, w, 4), overflow, steps, *votes]
    if return_nrec:
        ret.append(nrec)
    if return_skips:
        ret.append(skips)
    return tuple(ret)


def segment_chunks(n_chunks: int, segments,
                   n_rays: Optional[int] = None,
                   chunk_size: Optional[int] = None) -> tuple:
    """Resolve (fraction, max_dense) segments into whole-chunk counts.

    Boundaries are CUMULATIVE FLOORS (of ``cumfrac * n_rays / chunk_size``
    when both are given, else of ``cumfrac * n_chunks``), so each class
    boundary sits at or below its ray fraction and sorted rays fit their
    class budget.  A segment may get zero chunks; the last absorbs the
    remainder."""
    counts = []
    used = 0
    cumfrac = 0.0
    for i, (frac, md) in enumerate(segments):
        cumfrac += frac
        if i == len(segments) - 1:
            tgt = n_chunks
        elif n_rays is not None and chunk_size is not None:
            tgt = min(n_chunks, int(cumfrac * n_rays) // chunk_size)
        else:
            tgt = min(n_chunks, int(cumfrac * n_chunks))
        counts.append((max(0, tgt - used), md))
        used = max(used, tgt)
    return tuple(counts)


def render_frame_fast_segmented(tree: N3Tree, leaf_map: LeafMap,
                                camera, opt: RenderOptions,
                                order: tuple,
                                segments=DEFAULT_SEGMENTS,
                                chunk_size: int = 1 << 15,
                                skip_table: Optional[torch.Tensor] = None,
                                group: int = 1,
                                return_hints: bool = False,
                                sorted_output: bool = False,
                                need_votes: bool = False):
    """Record-sorted segmented fast frame.

    ``order`` comes from :func:`order_from_hints`; each contiguous ray
    segment marches with its own ``max_dense`` budget.  Pixels equal the
    unsegmented frame's; a ray beyond its segment's budget raises that
    segment's overflow count so the caller can escalate.

    Returns (img [H, W, 4] — or flat [R, 4] rows in ``perm`` order when
    ``sorted_output``, so ``img[inv]`` is the pixel-order frame —,
    seg_overflow i32 counts [n_segments][, split_vote, sample_vote when
    ``need_votes``][, steps, nrec, skips when ``return_hints``, or one
    :func:`pack_hints` array when ``return_hints="packed"``, as in
    ``accel.py:1480-1484``]); votes and hints in pixel order.
    """
    w, h = camera.width, camera.height
    R = w * h
    perm, inv = order
    n_chunks = (R + chunk_size - 1) // chunk_size
    if n_chunks < len(segments):
        # fewer chunks than segment classes: one march at the top budget
        res = render_frame_fast(
            tree, leaf_map, camera, opt,
            max_dense=max(md for _, md in segments), chunk_size=chunk_size,
            order=order, skip_table=skip_table, return_nrec=True,
            return_skips=True, need_votes=need_votes)
        img, overflow = res[0], res[1]
        if sorted_output:
            img = img.reshape(R, 4)[perm]
        out = (img, overflow.expand(len(segments)))
        if need_votes:
            out = out + tuple(res[3:5])
        if return_hints == "packed":
            out = out + (pack_hints(res[2], res[-2], res[-1]),)
        elif return_hints:
            out = out + (res[2], res[-2], res[-1])
        return out
    res = _frame_core(
        tree, leaf_map, perm, inv, camera, opt, skip_table,
        seg_counts=segment_chunks(n_chunks, segments, n_rays=R,
                                  chunk_size=chunk_size),
        chunk_size=chunk_size, return_hints=return_hints, group=group,
        sorted_output=sorted_output, need_votes=need_votes)
    img = res["img"] if sorted_output else res["img"].reshape(h, w, 4)
    out = (img, res["seg_overflow"])
    if need_votes:
        out = out + (res["split_vote"], res["sample_vote"])
    if return_hints == "packed":
        out = out + (res["hints_packed"],)
    elif return_hints:
        out = out + (res["steps"], res["nrec"], res["skips"])
    return out
