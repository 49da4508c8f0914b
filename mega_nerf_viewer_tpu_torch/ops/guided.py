"""Guided ray sampling on the leaf-map fast path: collect, query, composite.

Counterpart of the device-resident compact path of
``mega_nerf_viewer_tpu/ops/guided.py`` (the reference's guided-sampling
mode, ``cuda_renderer.cpp:107-139``):

  * :func:`collect_t_fast` — the collect march.  It walks each ray like
    the render march and records the tree-space ``t`` of every dense
    sample (up to ``max_guided_samples``).  On a CUDA tensor the march is
    ``csrc/collect.cu`` (one thread per ray, the render march's own step
    from ``csrc/march_step.cuh``); on a CPU tensor it is
    :func:`collect_t_fast_reference`, the JAX while loop as batched torch
    ops.  The entry-skip prepass runs first when a skip table is given.
  * :func:`_compact_reconstruct` — compacts the records into one flat
    valid-sample layout and rebuilds the MLP inputs (world position, view
    direction) and cluster ids from ``t`` (``rt_core.cuh:514-549``).
  * :func:`collect_and_query_fast` — collect, reconstruct and the grouped
    MLP query (``models.meganerf.query_grouped``), unordered, in a
    hint-sorted ray order, or segmented by per-class record budgets.
  * :func:`reconstruct_samples` — the same rebuild over every padded slot
    ``[R, S]`` (``guided.py:465-496``).
  * the host reconstruction path for a model on the eager TorchScript
    fallback (``guided.py:953-1025``), which :func:`collect_and_query_fast`
    takes for such a model: the collect march, then the rows and cluster
    ids of the valid samples only, the model's cluster-sorted query, and a
    padded cache for the padded compositor.
  * :func:`composite_frame` — composites the cached MLP outputs each
    frame with the compact compositor (``ops/compact_composite.py``,
    kernel ``csrc/compact_composite.cu``): from the cached per-sample view
    directions while they are current, else through
    :func:`composite_results_compact` from the frame's own view
    directions, gathered per sample.

and the exact half (``guided.py:48-240``, ``:1032-1066``, ``:1144-1151``),
which a refinement session runs:

  * :func:`collect_samples` — the exact collect: the exact march's root
    descent per step, the split and sample votes and the visit marks,
    recording up to S samples per ray as padded ``[R, S, 1 + dim]`` rows
    ``[z, x, y, z, (view dir), (appearance)]`` with cluster ids.  On a
    CUDA tensor the march is ``csrc/exact_collect.cu`` (the descent of
    ``csrc/descend_step.cuh``, shared with the exact march), on a CPU
    tensor :func:`exact_collect_reference`.
  * :func:`collect_and_query` — the exact collect, then the MLP on the
    valid samples, scattered back into the padded cache.
  * :func:`composite_frame` on a padded cache — the padded compositor
    (``ops/padded_composite.py``, kernel ``csrc/padded_composite.cu``),
    with depth mode.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import kernels
from ..models.meganerf import cluster_ids_from_yz, query_grouped
from ..n3tree.tree import N3Tree
from ..options import RenderOptions
from ..utils import profiling
from .accel import (LeafMap, MarchInputs, _f32, class_ladder, leaf_lookup,
                    ray_setup, segment_chunks, slice_rays)
from .compact_composite import (composite_results_compact_kernel,
                                composite_results_compact_reference)
from .fp import fma_f32, ipow_f32, pow2_f32, rsqrt_f32
from .padded_composite import composite_results_padded
from .rays import rodrigues, screen2worlddir, sq_norm
from .render import (DEFAULT_MAX_LEVELS, RenderResult, _dda_unit_batch,
                     _descend, vote_state, vote_step)
from .skip_prepass import EPS_HI, entry_skip_prepass


def collect_inputs(tree: N3Tree, dirs: torch.Tensor, cen_world,
                   opt: RenderOptions,
                   skip_table: Optional[torch.Tensor] = None,
                   tmax_bg: Optional[torch.Tensor] = None) -> MarchInputs:
    """The collects' per-ray setup (``guided.py:382-393``; the exact
    collect's ``:81-91`` adds the background clamp ``tmax_bg``): the render
    march's setup, then the entry-skip prepass when ``skip_table`` is
    given (skipped cells lie below ``sigma_thresh``, so the records are
    the same).  The collect shades nothing: ``basis`` is None and
    ``use_sh`` false."""
    step_size = _f32(opt.step_size)
    cen, d, invdir, ds, tmin, tmax, miss = ray_setup(
        tree, dirs, cen_world, opt.render_bbox, tmax_bg)
    if skip_table is not None:
        tmin, _ = entry_skip_prepass(skip_table, cen, d, invdir, tmin, tmax,
                                     ~miss, step_size)
    return MarchInputs(cen, d, invdir, ds, tmin, tmax, miss, None, step_size,
                       _f32(opt.sigma_thresh), _f32(opt.stop_thresh), False)


def collect_march(tree: N3Tree, leaf_map: LeafMap, c: MarchInputs,
                  S: int):
    """The collect march from ``c`` with record budget ``S``: the CUDA
    kernel for CUDA tensors, the plain version for CPU tensors.  Returns
    (t_buf [R, S] f32 with -1 past ns, ns [R] i32, steps [R] i32,
    overflow count [] i32)."""
    args = (tree, leaf_map, c.cen, c.d, c.invdir, c.delta_scale, c.tmin,
            c.tmax, c.miss, int(S), c.step_size, c.sigma_thresh,
            c.stop_thresh)
    if c.d.device.type == "cpu":
        return collect_t_fast_reference(*args)
    return kernels.collect(*args)


def collect_t_fast_reference(tree, leaf_map, cen, d, invdir, delta_scale,
                             tmin, tmax, miss, S, step_size, sigma_thresh,
                             stop_thresh):
    """The collect march as plain torch ops: the JAX while loop's step
    (``guided.py:410-441``) over all rays with masks.  Returns (t_buf
    [R, S] f32 with -1 past ns, ns [R] i32, steps [R] i32, overflow count
    [] i32)."""
    R = d.shape[0]
    dev = d.device
    f32, i32 = torch.float32, torch.int32
    N, N3 = tree.N, tree.N3
    D = tree.data_dim
    child_flat = tree.child.reshape(-1)
    sigma_flat = tree.data.reshape(-1, D)[:, D - 1]
    step = torch.tensor(step_size, dtype=f32, device=dev)
    s_thresh = torch.tensor(sigma_thresh, dtype=f32, device=dev)
    t_thresh = torch.tensor(stop_thresh, dtype=f32, device=dev)

    t_buf = torch.full((R, S), -1.0, dtype=f32, device=dev)
    ns = torch.zeros((R,), dtype=i32, device=dev)
    steps = torch.zeros((R,), dtype=i32, device=dev)
    over = torch.zeros((R,), dtype=torch.bool, device=dev)
    t = tmin.clone()
    T = torch.ones((R,), dtype=f32, device=dev)
    active = ~miss & (t < tmax)
    while bool(active.any()):
        steps = steps + active.to(i32)
        pos = fma_f32(t[:, None], d, cen[None, :])
        posc = torch.clamp(pos, 0.0, EPS_HI)
        _, depth, sigma = leaf_lookup(leaf_map, child_flat, sigma_flat,
                                      posc, N, N3)
        cube = pow2_f32(depth)
        u = posc * cube[:, None]
        frac = u - torch.floor(u)
        delta_t = _dda_unit_batch(frac, invdir) / cube + step
        dense = active & (sigma > s_thresh)
        att = torch.exp(-delta_t * delta_scale * sigma)
        rec = dense & (ns < S)
        over = over | (dense & (ns >= S))
        if S > 0:
            r = torch.nonzero(rec).reshape(-1)
            t_buf[r, ns[r].long()] = t[r]
        ns = ns + rec.to(i32)
        T = torch.where(dense, T * att, T)
        stop = dense & (T < t_thresh)
        t = torch.where(active, t + delta_t, t)
        active = active & ~stop & (t < tmax)
    return t_buf, ns, steps, over.sum().to(i32)


def collect_t_fast(tree: N3Tree, leaf_map: LeafMap, dirs: torch.Tensor,
                   cen_world, opt: RenderOptions, chunk_size: int = 0,
                   skip_table: Optional[torch.Tensor] = None,
                   order: Optional[tuple] = None,
                   with_overflow: bool = False,
                   segments=None, return_steps: bool = False,
                   keep_sorted: bool = False):
    """Record the tree-space ``t`` of each dense sample along each ray
    (up to ``opt.max_guided_samples`` = S), ``guided.py:250-461``.

    ``order`` = (perm, inv) marches the rays in ``perm`` order (a
    cost-sorted order from ``accel.order_from_hints``) and unpermutes the
    outputs, which equal the unordered call's; ``keep_sorted`` returns them
    in sorted order instead (rank k = ray ``perm[k]``).  ``segments`` (with
    ``order`` and ``chunk_size``) is a tuple of (ray fraction, S budget)
    classes over the sorted rays, laid out in whole chunks
    (``accel.segment_chunks``): each class marches with its own record
    budget, and a reduced-budget class raises its overflow flag when a ray
    records more (stale hints; the caller escalates).  At the full budget
    the cap is the reference's silent one (``rt_core.cuh:514``).
    ``chunk_size`` only sets that layout: the kernel has no tiles.

    Returns (t_buf [R, S] f32 with -1 fill, num_samples [R] i32
    [, steps [R] i32] [, overflow]) — overflow a bool [] with
    ``with_overflow``, or bool [n_segments] with ``segments``.
    """
    S = int(opt.max_guided_samples)
    if order is not None:
        perm, inv = (torch.as_tensor(o, device=dirs.device).long()
                     for o in order)
        R0 = dirs.shape[0]
        dirs_s = dirs[perm]

        def unperm(a):
            return a[inv][:R0]

        if segments is not None and chunk_size \
                and R0 % chunk_size == 0 and R0 > chunk_size \
                and R0 // chunk_size >= len(segments):
            seg_counts = segment_chunks(R0 // chunk_size, segments)
            # one setup and prepass for all rays; each class marches its
            # slice with its own budget and writes into the full buffer
            c = collect_inputs(tree, dirs_s, cen_world, opt, skip_table)
            dev = dirs.device
            t_s = torch.full((R0, S), -1.0, dtype=torch.float32, device=dev)
            ns_parts, st_parts, ovs = [], [], []
            off = 0
            for c_chunks, S_seg in seg_counts:
                if c_chunks == 0:
                    # keep the overflow vector index-aligned
                    ovs.append(torch.zeros((), dtype=torch.bool, device=dev))
                    continue
                n = c_chunks * chunk_size
                sl = slice(off, off + n)
                S_eff = min(int(S_seg), S)
                tb, nsb, stb, ovb = collect_march(
                    tree, leaf_map, slice_rays(c, sl), S_eff)
                t_s[sl, :S_eff] = tb
                ns_parts.append(nsb)
                st_parts.append(stb)
                # full-budget classes keep the reference's silent cap
                ovs.append(ovb > 0 if S_eff < S else
                           torch.zeros((), dtype=torch.bool, device=dev))
                off += n
            outs = (t_s, torch.cat(ns_parts)) + (
                (torch.cat(st_parts),) if return_steps else ())
            if not keep_sorted:
                outs = tuple(unperm(a) for a in outs)
            return outs + (torch.stack(ovs),)
        outs = collect_t_fast(tree, leaf_map, dirs_s, cen_world, opt,
                              chunk_size=chunk_size, skip_table=skip_table,
                              with_overflow=with_overflow,
                              return_steps=return_steps)
        ov_tail = ()
        if with_overflow:
            outs, ov_tail = outs[:-1], outs[-1:]
        if not keep_sorted:
            outs = tuple(unperm(a) for a in outs)
        if segments is not None:
            # fewer chunks than classes: one full-budget march, no flag
            return outs + (torch.zeros((len(segments),), dtype=torch.bool,
                                       device=dirs.device),)
        return outs + ov_tail
    c = collect_inputs(tree, dirs, cen_world, opt, skip_table)
    t_buf, ns, steps, over = collect_march(tree, leaf_map, c, S)
    outs = (t_buf, ns) + ((steps,) if return_steps else ())
    if with_overflow:
        return outs + (over > 0,)
    return outs


def segments_from_ns_hints(ns, max_samples: int, quant: int = 16) -> tuple:
    """CDF-matched (fraction, S budget) classes for the segmented collect
    from a previous invalidation's per-ray sample counts
    (``guided.py:597-625``).  Budgets are the power-of-two ladder up to
    ``max_samples``; each class's fraction is its CDF share floored to
    1/``quant`` less one quantum of margin, so sorted rays fit their
    class even as hints drift (escalation remains the backstop)."""
    ns = np.asarray(ns.cpu() if isinstance(ns, torch.Tensor) else ns)
    classes = class_ladder(max_samples)[:-1]
    segs = []
    used = 0.0
    for cl in classes:
        f = np.floor(float((ns <= cl).mean()) * quant) / quant \
            - 1.0 / quant
        f = max(0.0, min(f, 1.0 - 1.0 / quant))
        if f > used:
            segs.append((float(f - used), cl))
            used = f
    segs.append((float(1.0 - used), max_samples))
    return tuple(segs)


# ----------------------------------------------------------------------
# Device-resident compact guided cache
# ----------------------------------------------------------------------
def _compact_reconstruct(tree: N3Tree, dirs: torch.Tensor,
                         vdirs: torch.Tensor, cen_world: torch.Tensor,
                         t_buf: torch.Tensor, ns: torch.Tensor,
                         grid_dim, min_position, pos_range,
                         opt: RenderOptions, budget: int):
    """Compact the per-ray ``t`` records into a flat layout of ``budget``
    rows and rebuild the MLP inputs from ``t`` (``guided.py:500-574``).

    Returns (x [budget, in_dim], cluster_ids [budget] i32, z [budget],
    ray_of_p [budget] i32, offs [R] i32 inclusive cumsum of ns).  Rows at
    or past ``sum(ns)`` are padding: x, z and the cluster id are 0 there,
    and ``ray_of_p`` points at ray R-1."""
    R = dirs.shape[0]
    dev = dirs.device
    i32 = torch.int32
    offs = torch.cumsum(ns, 0).to(i32)
    total = offs[-1]
    p = torch.arange(budget, device=dev)
    # ray_of_p = searchsorted(offs, p, 'right') as a scatter-add of the
    # segment starts and a cumsum; starts repeat where a ray has no
    # samples, so the adds accumulate.  A start equal to budget lies past
    # the buffer: it lands in the extra last slot, which is dropped.
    starts = offs[:-1].long().clamp(max=budget)
    flags = torch.zeros(budget + 1, dtype=i32, device=dev).index_add_(
        0, starts, torch.ones_like(starts, dtype=i32))[:budget]
    ray_of_p = torch.cumsum(flags, 0).clamp(0, R - 1).to(i32)
    rop = ray_of_p.long()
    # |t * d / scale| = t * |d / scale| for t >= 0, d the scaled unit
    # direction (rt_core.cuh:527-534)
    d = dirs * tree.scale[None, :]
    dn = d * rsqrt_f32(sq_norm(d))[:, None]
    zfac = torch.sqrt(sq_norm(dn / tree.scale[None, :]))
    start = (offs - ns)[rop]
    S = t_buf.shape[1]
    slot = (p - start).clamp(0, S - 1)
    t_v = t_buf.reshape(-1)[(rop * S + slot).clamp(0, R * S - 1)]
    z = t_v * zfac[rop]
    pos = fma_f32(dirs[rop], z[:, None], cen_world[None, :])
    cols = [pos]
    if opt.need_viewdir:
        cols.append(vdirs[rop])
    if opt.appearance_embedding != -1:
        cols.append(torch.full((budget, 1), float(opt.appearance_embedding),
                               dtype=torch.float32, device=dev))
    x = torch.cat(cols, -1)
    valid = p < total
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    x = torch.where(valid[:, None], x, zero)
    cids = cluster_ids_from_yz(pos[:, 1], pos[:, 2], grid_dim,
                               min_position, pos_range)
    cluster_ids = torch.where(valid, cids, torch.zeros_like(cids))
    return x, cluster_ids, torch.where(valid, z, zero), ray_of_p, offs


def reconstruct_samples(tree: N3Tree, dirs: torch.Tensor,
                        vdirs: torch.Tensor, cen_world: torch.Tensor,
                        t_buf: torch.Tensor, num_samples: torch.Tensor,
                        grid_dim, min_position, pos_range,
                        opt: RenderOptions):
    """Full guided-sample rows and cluster ids rebuilt from the recorded
    ``t`` over every slot (``guided.py:465-496``; ``rt_core.cuh:514-549``).
    Returns (samples [R, S, 1+dim] f32: z, xyz, (view dir), (appearance),
    -1 past ``num_samples``; cluster_ids [R, S] i32, of every slot)."""
    R, S = t_buf.shape
    dev = dirs.device
    scale = tree.scale
    d = dirs * scale[None, :]
    d = d / torch.sqrt(sq_norm(d))[:, None]
    valid = torch.arange(S, device=dev)[None, :] < num_samples[:, None]
    tz = (t_buf[..., None] * d[:, None, :] / scale).reshape(-1, 3)
    z = torch.sqrt(sq_norm(tz)).reshape(R, S)
    pos = cen_world + dirs[:, None, :] * z[..., None]
    cols = [z[..., None], pos]
    if opt.need_viewdir:
        # the recorded view direction is the Rodrigues-shifted one; the
        # positions use the true direction (rt_core.cuh:530-533)
        cols.append(vdirs[:, None, :].expand(R, S, 3))
    if opt.appearance_embedding != -1:
        cols.append(torch.full((R, S, 1), float(opt.appearance_embedding),
                               dtype=torch.float32, device=dev))
    samples = torch.cat(cols, -1)
    samples = torch.where(valid[..., None], samples,
                          samples.new_full((), -1.0))
    cluster_ids = cluster_ids_from_yz(pos[..., 1], pos[..., 2], grid_dim,
                                      min_position, pos_range)
    return samples, cluster_ids


def _cluster_ids_host_math(model, y: torch.Tensor,
                           z: torch.Tensor) -> torch.Tensor:
    """Cluster ids in the arithmetic of the JAX package's host
    ``cluster_ids_for_points`` (``meganerf.py:314-324``): the f32
    offset-over-range times the integer grid size promotes to f64 there,
    so it does here, on the tensors' device."""
    gd = [int(g) for g in model.grid_dim]
    mp = [float(np.float32(v)) for v in model.min_position]
    rg = [float(np.float32(v)) for v in model.range]

    def cell(v, lo, r, g):
        f = ((v - lo) / r).double() * g
        return f.clamp(0.0, g - 1.0).to(torch.int32)
    return cell(y, mp[1], rg[1], gd[0]) * gd[1] + cell(z, mp[2], rg[2], gd[1])


def _collect_and_query_fast_host(tree: N3Tree, leaf_map: LeafMap, model,
                                 camera, opt: RenderOptions,
                                 chunk_size: int = 1 << 15,
                                 skip_table: Optional[torch.Tensor] = None
                                 ) -> dict:
    """The guided invalidation for a model on the eager TorchScript
    fallback (``guided.py:953-1025``).  The collect march records ``t``;
    the rows and cluster ids of the valid samples are rebuilt from it
    (the f32 math of :func:`reconstruct_samples`); the model's
    cluster-sorted :meth:`~..models.meganerf.MegaNeRFModel.query` runs on
    them; the results go back into a padded ``[R, S, out_dim]`` cache with
    ``z_vals`` (-1 past ``num_samples``), which :func:`composite_frame`
    hands to the padded compositor.  JAX rebuilds the rows in host numpy
    because its fallback runs on the host; here they stay on the tree's
    device.  The cache also carries ``collect_steps`` in pixel order, the
    Viewer's next collect order.  Returns the cache dict."""
    dev = tree.device
    transform = torch.as_tensor(camera.transform, dtype=torch.float32,
                                device=dev)
    dirs, cen = screen2worlddir(camera.width, camera.height, camera.fx,
                                camera.fy, camera.cx, camera.cy, transform)
    R = dirs.shape[0]
    pad = (-R) % chunk_size if chunk_size else 0
    dirs_p = dirs if not pad else torch.cat([dirs, dirs[-1:].expand(pad, 3)])
    t_buf, ns, steps = collect_t_fast(tree, leaf_map, dirs_p, cen, opt,
                                      chunk_size=chunk_size,
                                      skip_table=skip_table,
                                      return_steps=True)
    t_buf, ns, steps = t_buf[:R], ns[:R], steps[:R]
    vdirs = rodrigues(opt.rot_dirs, dirs)
    S = t_buf.shape[1]
    valid = torch.arange(S, device=dev)[None, :] < ns[:, None]
    ray_i, slot_i = torch.nonzero(valid, as_tuple=True)
    t_v = t_buf[ray_i, slot_i]
    d = dirs * tree.scale[None, :]
    d = d / torch.sqrt(sq_norm(d))[:, None]
    tz = t_v[:, None] * d[ray_i] / tree.scale[None, :]
    z_v = torch.sqrt(sq_norm(tz))
    pos = cen[None, :] + dirs[ray_i] * z_v[:, None]
    cols = [pos]
    if opt.need_viewdir:
        cols.append(vdirs[ray_i])
    if opt.appearance_embedding != -1:
        cols.append(torch.full((ray_i.shape[0], 1),
                               float(opt.appearance_embedding),
                               dtype=torch.float32, device=dev))
    ids = _cluster_ids_host_math(model, pos[:, 1], pos[:, 2])
    res = model.query_device(ids, torch.cat(cols, -1))
    results = torch.zeros((R, S, model.output_dim), dtype=torch.float32,
                          device=dev)
    results[ray_i, slot_i] = res
    z_vals = torch.full((R, S), -1.0, dtype=torch.float32, device=dev)
    z_vals[ray_i, slot_i] = z_v
    return dict(results=results, z_vals=z_vals, num_samples=ns,
                collect_steps=steps)


def _reconstruct_and_query(params, tree: N3Tree, dirs, vdirs, cen_world,
                           t_buf, ns, grid_dim, min_position, pos_range,
                           opt: RenderOptions, budget: int):
    """Reconstruct and grouped MLP query (``guided.py:578-594``).
    Returns (res_c [budget, out_dim], z_c, ray_of_p, offs, vdirs_c
    [budget, 3] or None)."""
    x, cids, z_c, ray_of_p, offs = _compact_reconstruct(
        tree, dirs, vdirs, cen_world, t_buf, ns, grid_dim, min_position,
        pos_range, opt, budget)
    res_c = query_grouped(params, cids, x)
    vdirs_c = x[:, 3:6].contiguous() if opt.need_viewdir else None
    return res_c, z_c, ray_of_p, offs, vdirs_c


def _budget(total: int) -> int:
    """The compact budget: the next multiple of 2^16 samples."""
    return max(1 << 16, -(-int(total) // (1 << 16)) * (1 << 16))


def _fetch_early(t: torch.Tensor):
    """Start copying ``t`` to the host; returns a function that waits for
    the copy and gives the numpy array.  On the card the wait covers only
    the work queued before this call, so work queued after it runs while
    the host waits."""
    if t.device.type != "cuda":
        return t.numpy
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    done = torch.cuda.Event()
    done.record()

    def wait():
        done.synchronize()
        return host.numpy()
    return wait


def collect_and_query_fast(tree: N3Tree, leaf_map: LeafMap, model, camera,
                           opt: RenderOptions, chunk_size: int = 1 << 15,
                           skip_table: Optional[torch.Tensor] = None,
                           order: Optional[tuple] = None, segments=None,
                           budget_hint: Optional[int] = None) -> dict:
    """Guided collection and MLP query, all on the tree's device
    (``guided.py:764-950``; reference invalidation path,
    ``cuda_renderer.cpp:107-134``).

    The collect march records per-ray ``t``; compaction, reconstruction,
    cluster ids and the grouped query follow on the device.  The host
    reads one small tensor: the sample total (which sizes the compact
    budget, the next multiple of 2^16) together with the segments'
    overflow flags.  With ``order`` the rays and every cached array stay
    in sorted order; ``num_samples`` and ``collect_steps`` are returned in
    pixel order.  With ``segments`` (and ``order``) overflowing classes
    are doubled and re-collected until none overflows; the settled tuple
    is returned as ``segments``.  The query follows the settled collect,
    at the budget of its total.  JAX's version queues it at
    ``budget_hint`` before the host reads the overflow flags and drops it
    when a class overflowed; at Mill 19's widths a query costs 0.1-0.3 s,
    against under 1 ms for kernel C at depth 11.  ``budget_hint`` is
    taken for JAX's signature and not used.

    Returns the cache dict of the JAX package: ``results_c``, ``z_c``,
    ``ray_of_p``, ``offs``, ``num_samples``, ``collect_steps``,
    ``budget_hint_next``, and as they apply ``num_samples_sorted``,
    ``order_perm``, ``order_inv``, ``segments``, ``vdirs_c``,
    ``vdirs_sig``.

    A model on the eager TorchScript fallback takes the host
    reconstruction path instead (``guided.py:782-785``), with its padded
    cache; ``order`` and ``segments`` do not apply there.
    """
    if getattr(model, "_torch_modules", None) is not None:
        return _collect_and_query_fast_host(tree, leaf_map, model, camera,
                                            opt, chunk_size, skip_table)
    dev = tree.device
    transform = torch.as_tensor(camera.transform, dtype=torch.float32,
                                device=dev)
    dirs, cen = screen2worlddir(camera.width, camera.height, camera.fx,
                                camera.fy, camera.cx, camera.cy, transform)
    R = dirs.shape[0]
    # the cluster grid as device tensors, copied before any heavy work
    grid = (torch.as_tensor(model.grid_dim, device=dev),
            torch.as_tensor(model.min_position, device=dev),
            torch.as_tensor(model.range, device=dev))
    pad = (-R) % chunk_size if chunk_size else 0
    dirs_p = dirs if not pad else torch.cat([dirs, dirs[-1:].expand(pad, 3)])
    if order is not None:
        order = tuple(torch.as_tensor(o, device=dev).long() for o in order)
        if pad:
            # pad rays copy the last pixel; they follow the sorted ranks
            tail = torch.arange(R, R + pad, device=dev)
            order = (torch.cat([order[0], tail]),
                     torch.cat([order[1], tail]))
    total = None
    steps_s = None
    settled_segs = None
    if order is not None:
        perm_r = order[0][:R]
        dirs_r = dirs_p[perm_r]
    else:
        perm_r = None
        dirs_r = dirs
    vdirs = rodrigues(opt.rot_dirs, dirs_r)
    if order is not None and segments is not None:
        segs = list(segments)
        while True:
            t_buf, ns, steps_s, seg_ov = collect_t_fast(
                tree, leaf_map, dirs_p, cen, opt, chunk_size=chunk_size,
                skip_table=skip_table, order=order, segments=tuple(segs),
                return_steps=True, keep_sorted=True)
            t_buf, ns = t_buf[:R], ns[:R]
            # the total and the flags in one read
            stats = _fetch_early(torch.cat(
                [ns.sum(dtype=torch.int32)[None], seg_ov.to(torch.int32)]))()
            total = int(stats[0])
            ov = stats[1:] > 0
            if not ov.any():
                settled_segs = tuple(segs)
                break
            for i, hit in enumerate(ov):
                if hit:
                    segs[i] = (segs[i][0],
                               max(1, min(opt.max_guided_samples,
                                          segs[i][1] * 2)))
    elif order is not None:
        t_buf, ns, steps_s = collect_t_fast(
            tree, leaf_map, dirs_p, cen, opt, chunk_size=chunk_size,
            skip_table=skip_table, order=order, return_steps=True,
            keep_sorted=True)
        t_buf, ns = t_buf[:R], ns[:R]
    else:
        t_buf, ns, steps_s = collect_t_fast(
            tree, leaf_map, dirs_p, cen, opt, chunk_size=chunk_size,
            skip_table=skip_table, return_steps=True)
        t_buf, ns, steps_s = t_buf[:R], ns[:R], steps_s[:R]
    if total is None:
        total = int(ns.sum())
    # the real samples of the query whose results the cache keeps
    profiling.count("mlp_samples", total)
    res_c, z_c, ray_of_p, offs, vdirs_c = _reconstruct_and_query(
        model.params, tree, dirs_r, vdirs, cen, t_buf, ns, *grid, opt,
        _budget(total))
    out = dict(results_c=res_c, z_c=z_c, ray_of_p=ray_of_p, offs=offs,
               num_samples=ns)
    if settled_segs is not None:
        out["segments"] = settled_segs
    if order is not None:
        inv_r = order[1][:R]
        # num_samples and collect_steps are pixel-indexed (they feed
        # order_from_hints); the compact arrays stay sorted
        out["num_samples_sorted"] = ns
        out["num_samples"] = ns[inv_r]
        out["order_perm"] = perm_r
        out["order_inv"] = inv_r
        steps_s = steps_s[:R][inv_r]
    out["collect_steps"] = steps_s
    if opt.need_viewdir:
        # the cached per-sample view directions are valid for shading
        # only while the camera and rot_dirs are those of the collect
        out["vdirs_c"] = vdirs_c
        out["vdirs_sig"] = _viewdir_signature(camera, opt)
    # JAX's key (the budget its next call queues a query at), kept for
    # the cache dict's parity
    out["budget_hint_next"] = _budget(total) + (1 << 16)
    return out


def _viewdir_signature(camera, opt: RenderOptions) -> tuple:
    """Everything per-sample view directions depend on: the camera pose
    and intrinsics and ``rot_dirs``."""
    return (np.asarray(camera.transform, np.float32).tobytes(),
            float(camera.fx), float(camera.fy),
            float(camera.cx), float(camera.cy),
            camera.width, camera.height,
            tuple(float(r) for r in opt.rot_dirs))


def composite_results_compact(res_c, z_c, ray_of_p, offs, ns, vdirs,
                              opt: RenderOptions, basis_dim: int,
                              fmt_sh: bool) -> torch.Tensor:
    """Composite the compact cache with per-RAY view directions ``vdirs``
    [R, 3] (``guided.py:650-729``), each sample shaded with its ray's
    direction: the directions are gathered per sample and go to the
    compact compositor (the kernel on the card).  Returns [R, 4] rgba
    with alpha 1."""
    vdirs_c = vdirs[ray_of_p.long()] if fmt_sh and basis_dim >= 1 else None
    return composite_results_compact_kernel(
        res_c, z_c, ray_of_p, offs, ns, vdirs_c, opt, basis_dim, fmt_sh)


def _composite_frame_compact(res_c, z_c, ray_of_p, offs, ns, camera,
                             opt: RenderOptions, basis_dim: int,
                             fmt_sh: bool, perm=None, inv=None):
    """Raygen, composite, unpermute (``guided.py:732-755``).  With
    ``perm``/``inv`` the cache is in sorted ray order: the view directions
    are permuted to it and the finished [R, 4] rows are put back in pixel
    order."""
    transform = torch.as_tensor(camera.transform, dtype=torch.float32,
                                device=res_c.device)
    dirs, _ = screen2worlddir(camera.width, camera.height, camera.fx,
                              camera.fy, camera.cx, camera.cy, transform)
    vdirs = rodrigues(opt.rot_dirs, dirs)
    if perm is not None:
        vdirs = vdirs[perm]
    out = composite_results_compact(res_c, z_c, ray_of_p, offs, ns, vdirs,
                                    opt, basis_dim, fmt_sh)
    if inv is not None:
        out = out[inv]
    return out.reshape(camera.height, camera.width, 4)


def composite_frame(tree: N3Tree, camera, opt: RenderOptions,
                    cache: dict, use_pallas=None) -> torch.Tensor:
    """Composite a frame from a compact guided cache (reference
    ``render_nerf_results``, renderer_kernel.cu:294-327).  Returns
    [H, W, 4] rgba with alpha 1.

    An SH cache with per-sample view directions that are still current
    (``vdirs_sig`` matches this camera and ``rot_dirs``) goes to the
    compact compositor (the kernel on the card); any other cache to
    :func:`_composite_frame_compact`, which shades with this frame's view
    directions.  A padded cache (``collect_and_query``) goes to the padded
    compositor with this frame's view directions (``guided.py:1144-1151``),
    in depth mode too.  Depth mode on a compact cache goes to the compact
    compositor's depth branch, which needs no view directions.
    ``use_pallas`` is JAX's switch between its Pallas compositor and XLA
    (``guided.py:1081-1091``); it is accepted and inert: every cache takes
    the route above, on the card through the kernels."""
    fmt_sh = tree.data_format.format == "SH"
    if "results_c" not in cache:
        transform = torch.as_tensor(camera.transform, dtype=torch.float32,
                                    device=cache["results"].device)
        dirs, _ = screen2worlddir(camera.width, camera.height, camera.fx,
                                  camera.fy, camera.cx, camera.cy, transform)
        vdirs = rodrigues(opt.rot_dirs, dirs)
        out = composite_results(cache["results"], cache["z_vals"],
                                cache["num_samples"], vdirs, opt,
                                tree.data_format.basis_dim, fmt_sh)
        return out.reshape(camera.height, camera.width, 4)
    basis_dim = tree.data_format.basis_dim
    # a sorted-order cache carries the pixel restore; its per-ray inputs
    # must use the sorted counts
    ns_comp = cache.get("num_samples_sorted", cache["num_samples"])
    inv = cache.get("order_inv")
    if opt.render_depth or (
            fmt_sh and cache.get("vdirs_c") is not None
            and ("vdirs_sig" not in cache
                 or cache["vdirs_sig"] == _viewdir_signature(camera, opt))):
        out = composite_results_compact_kernel(
            cache["results_c"], cache["z_c"], cache["ray_of_p"],
            cache["offs"], ns_comp,
            None if opt.render_depth else cache["vdirs_c"], opt, basis_dim,
            fmt_sh)
        if inv is not None:
            out = out[inv]
        return out.reshape(camera.height, camera.width, 4)
    return _composite_frame_compact(
        cache["results_c"], cache["z_c"], cache["ray_of_p"], cache["offs"],
        ns_comp, camera, opt, basis_dim, fmt_sh,
        perm=cache.get("order_perm"), inv=inv)


# ----------------------------------------------------------------------
# The exact collect and the padded cache
# ----------------------------------------------------------------------
class GuidedSamples(NamedTuple):
    samples: torch.Tensor      # [R, S, 1+dim] f32: z, xyz, (vdir), (app)
    cluster_ids: torch.Tensor  # [R, S] i32
    num_samples: torch.Tensor  # [R] i32
    split_vote: torch.Tensor   # [R, 3]
    sample_vote: torch.Tensor  # [R, 3]
    visited: torch.Tensor      # [max_capacity] i32


def exact_collect_reference(tree: N3Tree, m: MarchInputs,
                            dirs: torch.Tensor, vdirs: torch.Tensor,
                            cen_world: torch.Tensor, grid, opt: RenderOptions,
                            track_visit: bool = False,
                            max_levels: int = DEFAULT_MAX_LEVELS):
    """The exact collect as plain torch ops: the JAX while loop
    (``guided.py:113-183``) over all rays with masks.  ``m`` is the
    tree-space setup, ``dirs``/``vdirs``/``cen_world`` the world rays the
    records are built from, ``grid`` = (grid_dim, min_position,
    pos_range).  Returns (samples [R, S, 1+dim] f32 (-1 fill), cluster_ids
    [R, S] i32, ns [R] i32, split_vote, sample_vote [R, 3], visited
    [max_capacity] i32, steps [R] i32)."""
    N, N3 = tree.N, tree.N3
    D = tree.data_dim
    R = m.d.shape[0]
    S = int(opt.max_guided_samples)
    dev = m.d.device
    f32, i32 = torch.float32, torch.int32
    child_flat = tree.child.reshape(-1)
    sigma_flat = tree.data.reshape(-1, D)[:, D - 1]
    counts_flat = tree.sample_counts.reshape(-1)
    n_nodes = sigma_flat.numel()
    step = torch.tensor(m.step_size, dtype=f32, device=dev)
    s_thresh = torch.tensor(m.sigma_thresh, dtype=f32, device=dev)
    t_thresh = torch.tensor(m.stop_thresh, dtype=f32, device=dev)

    samples = torch.full((R, S, 1 + opt.sample_dim), -1.0, dtype=f32,
                         device=dev)
    cluster_ids = torch.zeros((R, S), dtype=i32, device=dev)
    ns = torch.zeros((R,), dtype=i32, device=dev)
    steps = torch.zeros((R,), dtype=i32, device=dev)
    votes = vote_state(R, opt.max_depth, opt.max_sample_count, dev)
    visited = torch.zeros((tree.max_capacity,), dtype=i32, device=dev)
    if track_visit:
        visited[0] = 1
    t = m.tmin.clone()
    T = torch.ones((R,), dtype=f32, device=dev)
    active = ~m.miss & (t < m.tmax)
    ray = torch.arange(R, device=dev)
    while bool(active.any()):
        steps = steps + active.to(i32)
        pos = fma_f32(t[:, None], m.d, m.cen[None, :])
        frac, chunk, cidx, depth = _descend(
            child_flat, pos, N, max_levels,
            visited if track_visit else None)
        node = (chunk * N3 + cidx).long().clamp(0, n_nodes - 1)
        cube = ipow_f32(N, depth)
        delta_t = _dda_unit_batch(frac, m.invdir) / cube + step
        sigma = sigma_flat[node].to(f32)
        dense = sigma > s_thresh
        att = torch.exp(-delta_t * m.delta_scale * sigma)
        weight = T * (1.0 - att)
        sc = counts_flat[node].to(i32)
        vote_step(opt.max_depth, opt.max_sample_count, votes, active, dense,
                  weight, depth, chunk, cidx, sc)
        record = active & dense & (ns < S)
        r = ray[record]
        if r.numel():
            z = torch.sqrt(sq_norm((t[r, None] * m.d[r]) / tree.scale[None]))
            pos_w = fma_f32(dirs[r], z[:, None], cen_world[None, :])
            cols = [z[:, None], pos_w]
            if opt.need_viewdir:
                cols.append(vdirs[r])
            if opt.appearance_embedding != -1:
                cols.append(torch.full((r.numel(), 1),
                                       float(opt.appearance_embedding),
                                       dtype=f32, device=dev))
            slot = ns[r].long()
            samples[r, slot] = torch.cat(cols, -1)
            cluster_ids[r, slot] = cluster_ids_from_yz(
                pos_w[:, 1], pos_w[:, 2], *grid)
        ns = ns + record.to(i32)
        T = torch.where(active & dense, T * att, T)
        stop_now = active & dense & (T < t_thresh)
        t = torch.where(active, t + delta_t, t)
        active = active & ~stop_now & (t < m.tmax)
    return (samples, cluster_ids, ns, votes["split_vote"],
            votes["sample_vote"], visited, steps)


def exact_collect(tree: N3Tree, m: MarchInputs, dirs, vdirs, cen_world,
                  grid, opt: RenderOptions, track_visit: bool = False,
                  max_levels: int = DEFAULT_MAX_LEVELS):
    """The exact collect from the tree-space setup ``m``: kernel F for
    CUDA tensors, the plain version for CPU tensors; the returns of
    :func:`exact_collect_reference`."""
    if m.d.device.type == "cpu":
        return exact_collect_reference(tree, m, dirs, vdirs, cen_world,
                                       grid, opt, track_visit, max_levels)
    return kernels.exact_collect(tree, m, dirs, vdirs, cen_world, grid, opt,
                                 track_visit, max_levels)


def collect_samples(tree: N3Tree, dirs: torch.Tensor, vdirs: torch.Tensor,
                    cen_world, grid_dim, min_position, pos_range,
                    opt: RenderOptions, tmax_bg=None,
                    track_visit: bool = False,
                    max_levels: int = DEFAULT_MAX_LEVELS) -> GuidedSamples:
    """Traversal-only exact march recording per-ray guided samples
    (``guided.py:60-192``)."""
    dev = dirs.device
    cen_world = torch.as_tensor(cen_world, dtype=torch.float32, device=dev)
    grid = (torch.as_tensor(grid_dim, device=dev).to(torch.int32),
            torch.as_tensor(min_position, device=dev).to(torch.float32),
            torch.as_tensor(pos_range, device=dev).to(torch.float32))
    if tmax_bg is None:
        tmax_bg = torch.full((dirs.shape[0],), 1e9, dtype=torch.float32,
                             device=dev)
    m = collect_inputs(tree, dirs, cen_world, opt, tmax_bg=tmax_bg)
    res = exact_collect(tree, m, dirs, vdirs, cen_world, grid, opt,
                        track_visit, max_levels)
    return GuidedSamples(*res[:6])


# the padded cache's compositor under its JAX name (``guided.py:196-240``)
composite_results = composite_results_padded


def collect_and_query(tree: N3Tree, model, camera, opt: RenderOptions,
                      track_visit: bool = False):
    """The exact collect, then the MLP over the valid samples
    (``guided.py:1032-1066``; reference ``cuda_renderer.cpp:107-134``).
    The compaction to the valid samples and the scatter back run on the
    device.  Returns (cache dict with ``results`` [R, S, out_dim],
    ``z_vals`` [R, S], ``num_samples`` [R]; RenderResult with the votes
    and visit marks)."""
    dev = tree.device
    transform = torch.as_tensor(camera.transform, dtype=torch.float32,
                                device=dev)
    dirs, cen = screen2worlddir(camera.width, camera.height, camera.fx,
                                camera.fy, camera.cx, camera.cy, transform)
    vdirs = rodrigues(opt.rot_dirs, dirs)
    col = collect_samples(tree, dirs, vdirs, cen, model.grid_dim,
                          model.min_position, model.range, opt,
                          track_visit=track_visit)
    R, S = col.cluster_ids.shape
    valid = torch.arange(S, device=dev)[None, :] < col.num_samples[:, None]
    flat_idx = torch.nonzero(valid.reshape(-1)).reshape(-1)
    flat_samples = col.samples.reshape(R * S, -1)[flat_idx]
    res = model.query_device(col.cluster_ids.reshape(-1)[flat_idx],
                             flat_samples[:, 1:])
    padded = torch.zeros((R * S, model.output_dim), dtype=torch.float32,
                         device=dev)
    padded[flat_idx] = res
    cache = dict(results=padded.reshape(R, S, model.output_dim),
                 z_vals=col.samples[..., 0].contiguous(),
                 num_samples=col.num_samples)
    rres = RenderResult(torch.zeros((R, 4), dtype=torch.float32, device=dev),
                        col.split_vote, col.sample_vote, col.visited)
    return cache, rres
