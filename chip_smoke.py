#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one CUDA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds the port's kernels from ``mega_nerf_viewer_tpu_torch/csrc``,
holds each kernel against its plain PyTorch version on the card at the
shapes of the main paths, and drives both paths of the port:

* the steady 1080p voxel frame (phases 2-5) — the synthetic depth-8
  shell (``bench.py``'s scene), its leaf map and skip table, the hint
  frame, the hint-sorted order and the record-sorted segmented frame,
  10 frames timed, median of 3 rounds;
* guided sampling at 1080p (phases 6-9), as
  ``benchmarks/guided1080p.py`` drives the JAX package — the depth-8
  basis-1 shell, a synthetic 8-cluster Mega-NeRF model (8 layers, 256
  wide), S = 32 samples per ray: the unordered, ordered and segmented
  invalidations (collect march, reconstruction, MLP query) and the
  per-frame compact composite;
* a dynamic octree refinement session at 1080p (phases 10-14), as
  ``Viewer.render`` and ``benchmarks/refine_throughput.py`` drive the
  JAX package — the guided scene with a capacity that runs out within
  three expands, the same model, ``split_batch_size`` 4096: vote frames
  on the fast path (kernel A with votes), split and resample with the
  leaf map rebuilt after each edit, ``refine_throughput.py``'s device
  loop, a visit-tracked exact frame (kernel E) and a prune, guided
  sampling with splitting (the exact collect, kernel F, and the padded
  compositor, kernel G) and depth mode through kernels E, A and G;
* the user-facing path (phases 15-18): the ``Viewer`` session at 1080p on
  the voxel scene (the hint frame, parked frames against phase 4's direct
  frame, a 12-pose orbit stepped as ``cli --orbit`` steps it, each pose
  against a fresh frame, rgba8 and a screenshot, ``host_unpermute``), the
  Viewer's guided frames (a stop, reuse frames, a moved pose, depth mode on
  the compact cache through kernel D's depth branch) and refinement frames
  (the last with guided sampling on, through kernels F and G),
  the CLI in a subprocess on a saved tree, kernel H (the row-gather probe)
  at ``benchmarks/dma_gather_probe.py``'s shapes, and a small Viewer
  session on the card against the CPU.

Each path runs with the launch counts set to 0 just before it and read
just after; a kernel of the path that never launched fails the run.  It
checks that the frames are finite and agree with the plain CPU path on
small frames, and prints one JSON line listing the kernels (launches,
error, times, bounds) and, last, ``{"ok": true, "device": {...}}``.  Any
failed check raises; there is no CPU fallback.  It needs no network.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
# f32 operations of one prepass step and one march step, counted from
# csrc/common.cuh and the kernels' loop bodies (position, clip, cell
# index, leaf exit, advance); a shaded sample adds 6*B + 15
PREPASS_OPS_PER_STEP = 48
MARCH_OPS_PER_STEP = 45
# f32 operations of one composited guided sample with basis_dim B and U
# unmasked basis terms, counted from csrc/compact_composite.cu: delta, wc,
# weight, T (6), three logits (6 U), three sigmoids (12), the sums (6),
# plus the SH basis evaluation of that B
COMPOSITE_OPS = 24
# f32 operations of one sample of kernel D's depth branch: delta, the
# exponential, weight, weight * T and its sum, T
DEPTH_OPS = 8
SH_EVAL_OPS = {1: 0, 4: 3, 9: 18, 16: 48, 25: 89}
# f32 operations of one exact-march step, counted from
# csrc/descend_step.cuh and csrc/exact_march.cu: position and clip (9), one
# descent level (16), the exit (13), exp, weight and the vote rule (12);
# further descent levels and a shaded sample (6*B + 15) come on top.  Its
# bytes at the least: one i32 child read, the f16 sigma and the i16 count
EXACT_OPS_PER_STEP = 50
EXACT_BYTES_PER_STEP = 8
# f32 operations of one recorded exact-collect sample (csrc/exact_collect.cu):
# z (9), the position (3), the cluster id (8)
RECORD_OPS = 20
WIDTH, HEIGHT, FOCAL = 1920, 1080, 1111.0
CENTER = (-1.4, 0.1, 1.3)
N_FRAMES, ROUNDS = 10, 3
# benchmarks/guided1080p.py: max_guided_samples and the model
GUIDED_S = 32
GUIDED_MODEL = dict(n_clusters=8, hidden=256, n_layers=8, grid_dim=(2, 4),
                    min_position=(-1.5, -1.5, -1.5),
                    max_position=(1.5, 1.5, 1.5), need_viewdir=True)
# the refinement session: benchmarks/refine_throughput.py's options with
# the guided path's samples; the capacity leaves room for three expands of
# split_batch_size chunks past the shell's 60,033
REFINE_OPT = dict(use_splitting=True, split_batch_size=4096, max_depth=16,
                  samples_per_corner=8, max_sample_count=256,
                  max_guided_samples=GUIDED_S, need_viewdir=True)
SHELL_CHUNKS = 60033
REFINE_CAPACITY = SHELL_CHUNKS + 3 * 4096
SESSION_ITERS = 5
# benchmarks/refine_throughput.py: its tree's max_capacity and iterations
THROUGHPUT_CAPACITY = 400_000
THROUGHPUT_ITERS = 5
# kernel G's synthetic cache: rays, S (the default max_guided_samples), basis
PADDED_SYNTH = (1 << 17, 128, 9)


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, n):
    """Mean device milliseconds of ``fn`` over ``n`` back-to-back calls."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def device_events(fn, n, tries=3):
    """The profiler's per-kernel device events over ``n`` calls of ``fn``
    (``key_averages`` rows with device time).  The profiler now and then
    records no device time for a whole session; such a session is run
    again, up to ``tries`` times, and an empty list means none recorded."""
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.autograd.DeviceType.CUDA
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        ev = [e for e in prof.key_averages()
              if e.device_type == cuda and e.self_device_time_total > 0]
        if ev:
            return ev
    return []


def device_ms(fn, n):
    """Device milliseconds per call of ``fn`` and how they were measured:
    the profiler's device time of every kernel ``fn`` launches, over ``n``
    calls, so the host's overhead between short launches is not counted
    (``"profiler"``); CUDA events around the calls, which count that
    overhead, only if the profiler recorded nothing (``"events"``)."""
    fn()
    torch.cuda.synchronize()
    ev = device_events(fn, n)
    if not ev:
        return cuda_ms(fn, n), "events"
    return sum(e.self_device_time_total for e in ev) / 1e3 / n, "profiler"


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def bound_ms(n_bytes, n_ops):
    t_bytes = n_bytes / PEAK_BYTES_PER_S
    t_ops = n_ops / PEAK_F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def profile_frames(frame, ms_frame, n=3, what="frame"):
    """Where a frame's device time goes: torch.profiler over ``n`` frames;
    the busy share is device time per frame over the unprofiled
    ``ms_frame`` (one stream, so kernels do not overlap)."""
    ev = device_events(frame, n)
    if not ev:
        log(f"profile ({what}): the profiler recorded no device time "
            f"(not measured)")
        return
    busy = sum(e.self_device_time_total for e in ev) / 1e3 / n
    top = sorted(ev, key=lambda e: -e.self_device_time_total)[:8]
    kernels_per_frame = sum(e.count for e in ev) / n

    def name(e):
        k = e.key.replace("void ", "").replace("at::native::", "")
        return k.replace("(anonymous namespace)::", "")[:48]

    log(f"profile ({what}): device busy {busy:.3f} ms of {ms_frame:.3f} "
        f"ms/{what} ({100 * busy / ms_frame:.1f}%), {kernels_per_frame:.0f} "
        f"kernels/{what}; top: " + "; ".join(
            f"{name(e)} {e.self_device_time_total / 1e3 / n:.3f} ms "
            f"x{e.count // n}" for e in top))


def camera(cls, w, h, f):
    cam = cls(w, h, f)
    cam.center = np.asarray(CENTER, np.float32)
    cam._update()
    return cam


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import mega_nerf_viewer_tpu_torch as P
    from mega_nerf_viewer_tpu_torch import kernels
    from mega_nerf_viewer_tpu_torch.ops import accel
    from mega_nerf_viewer_tpu_torch.ops import skip_prepass as sp
    from mega_nerf_viewer_tpu_torch.ops.rays import screen2worlddir_indices
    dev = torch.device("cuda")

    # -- 1. environment and build ------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    log(smi)
    nvcc = subprocess.run([kernels._nvcc(), "--version"], capture_output=True,
                          text=True, timeout=60).stdout.strip().splitlines()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python "
        f"{sys.version.split()[0]}; nvcc: {nvcc[-1]}")
    t0 = time.perf_counter()
    lib = kernels.build()
    log(f"build: {lib.name} in {time.perf_counter() - t0:.1f} s")

    # -- scene: bench.py's synthetic shell at full depth -------------
    t0 = time.perf_counter()
    tree = P.shell_tree(depth=8, basis_dim=9, sigma_inside=400.0)
    opt = P.RenderOptions()
    leaf_map = P.build_leaf_map(tree)
    table = P.build_skip_table(tree, opt.sigma_thresh)
    torch.cuda.synchronize()
    tune = P.device_tuning()
    cs, blk = tune.chunk_size, tune.block
    log(f"scene: shell depth 8, {tree.capacity} chunks, leaf map level "
        f"{leaf_map.level} (+{leaf_map.deep_levels} deep), chunk {cs}, "
        f"block {blk}, {time.perf_counter() - t0:.1f} s")

    # the hint frame's rays (pixel-block order, padded to whole chunks)
    cam = camera(P.Camera, WIDTH, HEIGHT, FOCAL)
    R = WIDTH * HEIGHT
    perm, _ = accel.block_permutation(WIDTH, HEIGHT, blk, device=dev)
    n_pad = -(-R // cs) * cs
    pix = torch.cat([perm, perm[-1:].expand(n_pad - R)])
    dirs, cen_world = screen2worlddir_indices(
        pix, WIDTH, cam.fx, cam.fy, cam.cx, cam.cy,
        torch.as_tensor(cam.transform, device=dev))
    m = accel.march_inputs(tree, dirs, dirs, cen_world, opt)
    live = ~m.miss
    report = []

    # -- 2. kernel B, the entry-skip prepass, against its plain version
    t_k, s_k = kernels.skip_prepass(table, m.cen, m.d, m.invdir, m.tmin,
                                    m.tmax, live, m.step_size)
    t_p, s_p = sp.entry_skip_prepass_reference(
        table, m.cen, m.d, m.invdir, m.tmin, m.tmax, live, m.step_size)
    check(torch.equal(t_k.view(torch.int32), t_p.view(torch.int32)),
          "prepass t_start not bit-equal to the plain version")
    check(torch.equal(s_k, s_p), "prepass skips differ from the plain version")
    err_b = float((t_k - t_p).abs().max())
    ms_b, by_b = device_ms(lambda: kernels.skip_prepass(
        table, m.cen, m.d, m.invdir, m.tmin, m.tmax, live, m.step_size), 20)
    plain_b = cuda_ms(lambda: sp.entry_skip_prepass_reference(
        table, m.cen, m.d, m.invdir, m.tmin, m.tmax, live, m.step_size), 2)
    skips_total = int(s_k.sum())
    bb, bb_by = bound_ms(
        nbytes(table, m.cen, m.d, m.invdir, m.tmin, m.tmax, live, t_k, s_k),
        PREPASS_OPS_PER_STEP * skips_total)
    log(f"kernel skip_prepass: bit-equal over {n_pad} rays, "
        f"{skips_total} skips; {ms_b:.4f} ms on the device ({by_b}; plain "
        f"{plain_b:.2f} ms, bound {bb:.4f} ms by {bb_by})")
    report.append(dict(
        name="skip_prepass", route="cuda",
        source="mega_nerf_viewer_tpu_torch/csrc/skip_prepass.cu",
        replaces="mega_nerf_viewer_tpu/ops/pallas_march.py:141",
        max_abs_err=err_b, ms=ms_b, ms_by=by_b, plain_ms=plain_b,
        bound_ms=bb, bound_by=bb_by, library_ms=None))

    # -- 3. kernel A, the fused march, against its plain version -----
    ma = m._replace(tmin=t_k)
    err_a = 0.0
    for md in (8, 0):
        args = (tree, leaf_map, ma.cen, ma.d, ma.invdir, ma.delta_scale,
                ma.tmin, ma.tmax, ma.miss, ma.basis, ma.step_size,
                ma.sigma_thresh, ma.stop_thresh, md, ma.use_sh)
        ok = kernels.march(*args)
        op = accel.render_rays_fast_reference(*args)
        err = float((ok[0] - op[0]).abs().max())
        log(f"kernel march md={md}: out max abs diff {err:.3e}, overflow "
            f"{int(ok[1])}/{int(op[1])}, steps {int(ok[2].sum())}, "
            f"records {int(ok[3].sum())}")
        check(torch.equal(ok[2], op[2]), f"march nsteps differ (md={md})")
        check(torch.equal(ok[3], op[3]), f"march nrec differ (md={md})")
        check(int(ok[1]) == int(op[1]), f"march overflow differs (md={md})")
        check(err <= 1e-6, f"march out differs by {err} (md={md})")
        err_a = max(err_a, err)
        if md == 8:
            steps_total = int(ok[2].sum())
            shaded = int(ok[3].clamp(max=md).sum())
            ms_a, by_a = device_ms(lambda: kernels.march(*args), 20)
            plain_a = cuda_ms(
                lambda: accel.render_rays_fast_reference(*args), 2)
            B = ma.basis.shape[1]
            ba, ba_by = bound_ms(
                nbytes(ma.d, ma.invdir, ma.delta_scale, ma.tmin, ma.tmax,
                       ma.miss, ma.basis, ok[0], ok[2], ok[3])
                + 8 * steps_total + 2 * tree.data_dim * shaded,
                MARCH_OPS_PER_STEP * steps_total + (6 * B + 15) * shaded)
            log(f"kernel march: {ms_a:.4f} ms on the device ({by_a}; plain "
                f"{plain_a:.2f} ms, bound {ba:.4f} ms by {ba_by}; "
                f"{steps_total} steps, {shaded} shaded samples)")
    report.append(dict(
        name="march", route="cuda",
        source="mega_nerf_viewer_tpu_torch/csrc/march.cu",
        replaces="mega_nerf_viewer_tpu/ops/accel.py:359",
        max_abs_err=err_a, ms=ms_a, ms_by=by_a, plain_ms=plain_a,
        bound_ms=ba, bound_by=ba_by, library_ms=None))
    del m, ma, dirs, t_p, s_p
    torch.cuda.empty_cache()

    # -- 4. the main path -------------------------------------------
    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    md = 8
    while True:
        img, overflow, steps, nrec, skips = P.render_frame_fast(
            tree, leaf_map, cam, opt, max_dense=md, chunk_size=cs,
            block=blk, return_nrec=True, skip_table=table,
            return_skips=True)
        if not int(overflow):
            break
        md *= 2
        check(md <= 512, "pathological dense-sample count")
    hint_img = img
    order = P.order_from_hints(steps, nrec, skips)
    segments = list(P.DEFAULT_SEGMENTS)
    for _ in range(16):
        img, seg_overflow = P.render_frame_fast_segmented(
            tree, leaf_map, cam, opt, order=order,
            segments=tuple(segments), chunk_size=cs, skip_table=table)
        ov = seg_overflow.cpu().numpy()
        if not ov.any():
            break
        segments = [(f, max(1, b * 2)) if hit else (f, b)
                    for (f, b), hit in zip(segments, ov)]
    check(not ov.any(), "segment budgets did not settle")
    settle_s = time.perf_counter() - t0

    def frame():
        return P.render_frame_fast_segmented(
            tree, leaf_map, cam, opt, order=order, segments=tuple(segments),
            chunk_size=cs, skip_table=table)

    rounds = sorted(cuda_ms(frame, N_FRAMES) for _ in range(ROUNDS))
    ms_frame = rounds[ROUNDS // 2]
    img, seg_overflow = frame()
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    alpha_max = float(img[..., 3].max())
    log(f"frame path: hint budget {md}, segments {segments}, settled in "
        f"{settle_s:.1f} s; {1e3 / ms_frame:.2f} fps, {ms_frame:.3f} ms/frame "
        f"(rounds {[round(r, 3) for r in rounds]}); launches {launches}; "
        f"peak memory {peak / 2**30:.2f} GiB; alpha max {alpha_max:.4f}")
    check(launches["skip_prepass"] > 0 and launches["march"] > 0,
          f"a kernel of the frame path never launched: {launches}")
    check(img.shape == (HEIGHT, WIDTH, 4), f"frame shape {img.shape}")
    check(bool(torch.isfinite(img).all()), "non-finite pixels")
    check(alpha_max > 0, "empty frame")
    check(not seg_overflow.any(), "timed frame overflowed")
    diff = float((img - hint_img).abs().max())
    log(f"segmented frame vs hint frame: max abs diff {diff:.3e}")
    check(diff <= 1e-6, "segmented frame differs from the hint frame")
    frame_launches = launches
    voxel_ref = (img, ms_frame)
    profile_frames(frame, ms_frame)

    # -- 5. a small frame against the plain path on the CPU -----------
    small = P.shell_tree(depth=6, basis_dim=9, sigma_inside=400.0,
                         device="cpu")
    on_card = P.tree_from_numpy(
        **{k: getattr(small, k).numpy() for k in
           ("data", "child", "parent", "sample_counts", "scale", "offset")},
        capacity=small.capacity, data_format=small.data_format)
    scam = camera(P.Camera, 64, 64, FOCAL * 64 / WIDTH)
    outs = []
    for t in (small, on_card):
        lm = P.build_leaf_map(t)
        tab = P.build_skip_table(t, opt.sigma_thresh)
        o = accel.block_permutation(64, 64, 16, device=t.device)
        outs.append(P.render_frame_fast_segmented(
            t, lm, scam, opt, order=o, chunk_size=256, skip_table=tab,
            segments=((1.0, 16),), return_hints=True))
    (ic, _, sc, nc, kc), (ig, _, sg, ng, kg) = outs
    same = (sc == sg.cpu()) & (nc == ng.cpu()) & (kc == kg.cpu())
    n_bad = int((~same).sum())
    err_small = float((ic - ig.cpu()).reshape(-1, 4)[same].abs().max())
    log(f"64x64 frame, card vs CPU plain path: {n_bad} rays with other "
        f"hints, max abs diff elsewhere {err_small:.3e}")
    check(n_bad <= 4, "card and CPU hints differ on more than 0.1% of rays")
    check(err_small <= 1e-5, "card and CPU frames differ")

    del img, hint_img, steps, nrec, skips, order
    torch.cuda.empty_cache()
    exact_voxel_phase(P, kernels, dev, tree, leaf_map, cam, opt, report)
    del tree, leaf_map, table
    torch.cuda.empty_cache()
    guided_launches = guided_phases(P, kernels, dev, report)
    refine_launches = refine_phases(P, kernels, dev, report)
    viewer_launches = viewer_phase(P, kernels, dev, voxel_ref)
    del voxel_ref
    torch.cuda.empty_cache()
    viewer_guided_launches = viewer_guided_phase(P, kernels, dev, report)
    probe_phase(kernels, dev, report)
    small_viewer(P, dev)

    # launches: each path's own run (phases 4, 8, 12, 15 and 16), summed
    # over the paths for the kernels that several paths run; kernel H is on
    # no path (0)
    for k in report:
        k["launches"] = sum(run.get(k["name"], 0) for run in (
            frame_launches, guided_launches, refine_launches,
            viewer_launches, viewer_guided_launches))
    log(json.dumps({"kernels": report}))
    # the one card this run drove (contract: count 1)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": 1}}))
    return 0


def exact_bound(m, outs, steps_total, shaded, data_dim):
    """Bytes and operations of one exact march from the setup ``m``: its
    per-ray inputs and ``outs`` once, EXACT_BYTES_PER_STEP and
    EXACT_OPS_PER_STEP per step, a data row and 6*B + 15 ops per shaded
    sample."""
    B = m.basis.shape[1]
    return bound_ms(
        nbytes(m.d, m.invdir, m.delta_scale, m.tmin, m.tmax, m.miss,
               m.basis, *outs)
        + EXACT_BYTES_PER_STEP * steps_total + 2 * data_dim * shaded,
        EXACT_OPS_PER_STEP * steps_total + (6 * B + 15) * shaded)


def exact_voxel_phase(P, kernels, dev, tree, leaf_map, cam, opt, report):
    """Phase 10: kernel E, the exact march, with and without visit marks,
    and kernel A with votes and in depth mode, each against its plain
    version on the 1080p voxel frame; then A's votes against E's on the
    same rays (vote frames take no skip table, so both start at tmin)."""
    from mega_nerf_viewer_tpu_torch.ops import accel, render
    from mega_nerf_viewer_tpu_torch.ops.rays import rodrigues, screen2worlddir
    dirs, cen = screen2worlddir(WIDTH, HEIGHT, cam.fx, cam.fy, cam.cx,
                                cam.cy, torch.as_tensor(cam.transform,
                                                        device=dev))
    vdirs = rodrigues(opt.rot_dirs, dirs)
    votes = (opt.max_depth, opt.max_sample_count)
    names = ("split_vote", "sample_vote", "visited", "steps")
    err_e = 0.0
    exact = {}
    for depth_mode in (False, True):
        o = opt.replace(render_depth=depth_mode)
        m = accel.march_inputs(tree, dirs, vdirs, cen, o)
        for track in ((False, True) if not depth_mode else (False,)):
            ok = kernels.exact_march(tree, m, o, track,
                                     render.DEFAULT_MAX_LEVELS, 0)
            op = render.exact_march_reference(tree, m, o, track)
            err = float((ok[0] - op[0]).abs().max())
            log(f"kernel exact_march (depth {depth_mode}, track_visit "
                f"{track}): out max abs diff {err:.3e}, steps "
                f"{int(ok[4].sum())} (max {int(ok[4].max())}), visited "
                f"chunks {int(ok[3].sum())}")
            for name, a, b in zip(names, ok[1:], op[1:]):
                check(torch.equal(a, b), f"exact march {name} differs "
                      f"(depth {depth_mode}, track_visit {track})")
            check(err <= 1e-6, f"exact march out differs by {err}")
            check(bool(torch.isfinite(ok[0]).all()), "NaN in kernel E")
            if track:
                check(int(ok[3].sum()) > 1, "no chunk marked visited")
            err_e = max(err_e, err)
            exact[(depth_mode, track)] = ok
            del op
        # kernel A with votes on the same rays, at a budget that holds
        # every dense sample, against its plain version and against E
        md = 8
        while True:
            args = (tree, leaf_map, m.cen, m.d, m.invdir, m.delta_scale,
                    m.tmin, m.tmax, m.miss, m.basis, m.step_size,
                    m.sigma_thresh, m.stop_thresh, md, m.use_sh)
            kw = dict(votes=votes, render_depth=depth_mode)
            ka = kernels.march(*args, **kw)
            if not int(ka[1]):
                break
            md *= 2
            check(md <= 512, "pathological dense-sample count")
        pa = accel.render_rays_fast_reference(*args, **kw)
        err = float((ka[0] - pa[0]).abs().max())
        for name, a, b in zip(("overflow", "nsteps", "nrec", "split_vote",
                               "sample_vote"), ka[1:], pa[1:]):
            check(torch.equal(a, b), f"march {name} differs with votes "
                  f"(depth {depth_mode})")
        check(err <= 1e-6, f"march with votes differs by {err}")
        ke = exact[(depth_mode, False)]
        err_ea = float((ka[0] - ke[0]).abs().max())
        n_sv = int((ka[4] != ke[1]).any(1).sum())
        n_pv = int((ka[5] != ke[2]).any(1).sum())
        log(f"kernel march with votes (depth {depth_mode}, md {md}): out "
            f"max abs diff {err:.3e} to plain; against kernel E: {n_sv} "
            f"rays with other split votes, {n_pv} with other sample votes, "
            f"rgba max abs diff {err_ea:.3e}")
        check(n_sv == 0 and n_pv == 0, "kernel A's votes differ from E's")
        check(torch.equal(ka[2], ke[4]), "kernel A's steps differ from E's")
        check(err_ea <= 1e-6, f"kernel A's rgba differs from E's by {err_ea}")
        if depth_mode:
            ms_ad, by_ad = device_ms(lambda: kernels.march(*args, **kw), 20)
            log(f"kernel march in depth mode with votes: {ms_ad:.4f} ms on "
                f"the device ({by_ad})")
            continue
        steps_total = int(ke[4].sum())
        shaded = int(ka[3].sum())
        ms_av, by_av = device_ms(lambda: kernels.march(*args, **kw), 20)
        ms_a0, by_a0 = device_ms(lambda: kernels.march(*args), 20)
        log(f"kernel march from tmin: {ms_av:.4f} ms with votes ({by_av}), "
            f"{ms_a0:.4f} ms without ({by_a0}); {steps_total} steps, "
            f"{shaded} dense samples")
        ms_e, by_e = device_ms(lambda: kernels.exact_march(
            tree, m, o, False, render.DEFAULT_MAX_LEVELS, 0), 10)
        ms_ev, by_ev = device_ms(lambda: kernels.exact_march(
            tree, m, o, True, render.DEFAULT_MAX_LEVELS, 0), 10)
        plain_e = cuda_ms(lambda: render.exact_march_reference(
            tree, m, o, False), 1)
        be, be_by = exact_bound(m, ke[:3] + (ke[4],), steps_total, shaded,
                                tree.data_dim)
        log(f"kernel exact_march: {ms_e:.4f} ms on the device ({by_e}), "
            f"{ms_ev:.4f} ms with visit marks ({by_ev}); plain "
            f"{plain_e:.2f} ms, bound {be:.4f} ms by {be_by}")
        del ka, pa
    report.append(dict(
        name="exact_march", route="cuda",
        source="mega_nerf_viewer_tpu_torch/csrc/exact_march.cu",
        replaces="mega_nerf_viewer_tpu/ops/render.py:119",
        max_abs_err=err_e, ms=ms_e, ms_by=by_e, plain_ms=plain_e,
        bound_ms=be, bound_by=be_by, library_ms=None))
    del exact, dirs, vdirs


def timed(fn):
    """(result, wall ms) of one call of ``fn``, the card synchronized."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t) * 1e3


def median3(fn):
    """(last result, median wall ms, the three runs) of three calls."""
    runs = []
    for _ in range(3):
        out, ms = timed(fn)
        runs.append(ms)
    return out, sorted(runs)[1], runs


def composite_bound(res_c, offs, ns, total, basis_dim, minmax, fmt_sh):
    """Bytes and operations of one compact composite: the valid rows of
    res, z and the view directions, offs, ns and the rgba out; the
    per-sample ops of csrc/compact_composite.cu."""
    R = ns.shape[0]
    out_dim = res_c.shape[1]
    n_bytes = total * (out_dim + 1 + 3) * 4 + R * (4 + 4 + 16)
    if fmt_sh:
        used = len([b for b in range(basis_dim)
                    if minmax[0] <= b <= minmax[1]])
        per = COMPOSITE_OPS + 6 * used + SH_EVAL_OPS[basis_dim]
    else:
        per = COMPOSITE_OPS
    return bound_ms(n_bytes, per * total)


def synthetic_cache(dev, M, basis_dim, seed=0):
    """A compact cache of M rows made on the card from a seed: runs of
    0-6 samples filling ~95% of M (the tail is padding), sigma >= 0,
    increasing z, unit view directions, and one opaque sample (sigma
    1e8) at the start of every run of two or more."""
    g = torch.Generator(device=dev).manual_seed(seed)
    out_dim = 3 * basis_dim + 2
    R = int(0.95 * M / 3)
    ns = torch.randint(0, 7, (R,), generator=g, device=dev,
                       dtype=torch.int32)
    offs = torch.cumsum(ns, 0).to(torch.int32)
    check(int(offs[-1]) <= M, "synthetic cache overfills its budget")
    res = torch.randn((M, out_dim), generator=g, device=dev)
    sidx = min(3, out_dim - 1)
    res[:, sidx] = res[:, sidx].abs() * 3
    starts = (offs - ns).long()[ns >= 2]
    res[starts, sidx] = 1e8
    z = torch.sort(torch.rand(M, generator=g, device=dev) * 2).values
    vd = torch.randn((M, 3), generator=g, device=dev)
    vd = vd / vd.norm(dim=1, keepdim=True)
    rop = torch.searchsorted(offs, torch.arange(M, device=dev,
                                                dtype=torch.int32),
                             right=True).clamp(0, R - 1).to(torch.int32)
    return res, z, rop, offs, ns, vd


def guided_phases(P, kernels, dev, report):
    """Phases 6-9: guided sampling at 1080p.  Returns the launch counts of
    the guided main path (phase 8)."""
    from mega_nerf_viewer_tpu_torch.ops import compact_composite as cc
    from mega_nerf_viewer_tpu_torch.ops import guided
    from mega_nerf_viewer_tpu_torch.models.meganerf import query_grouped
    from mega_nerf_viewer_tpu_torch.ops.rays import screen2worlddir

    t0 = time.perf_counter()
    tree = P.shell_tree(depth=8, basis_dim=1, sigma_inside=400.0)
    leaf_map = P.build_leaf_map(tree)
    model = P.MegaNeRFModel.synthetic(data_dim=int(tree.data_dim),
                                      **GUIDED_MODEL)
    opt = P.RenderOptions(max_guided_samples=GUIDED_S, need_viewdir=True,
                          use_guided_sampling=True)
    table = P.build_skip_table(tree, opt.sigma_thresh)
    cam = camera(P.Camera, WIDTH, HEIGHT, FOCAL)
    cs = min(1920, WIDTH)                 # benchmarks/guided1080p.py
    torch.cuda.synchronize()
    log(f"guided scene: shell depth 8 basis 1, {tree.capacity} chunks, "
        f"leaf map level {leaf_map.level}; model {model.n_clusters} "
        f"clusters x {len(model.params.weights)} layers x "
        f"{GUIDED_MODEL['hidden']}, out_dim {model.output_dim}; S "
        f"{GUIDED_S}, chunk {cs}; {time.perf_counter() - t0:.1f} s")

    # -- 6. kernel C, the collect march, against its plain version ----
    dirs, cen = screen2worlddir(
        WIDTH, HEIGHT, cam.fx, cam.fy, cam.cx, cam.cy,
        torch.as_tensor(cam.transform, device=dev))
    c = guided.collect_inputs(tree, dirs, cen, opt, table)
    err_c = 0.0
    for S in (GUIDED_S, 2, 0):
        args = (tree, leaf_map, c.cen, c.d, c.invdir, c.delta_scale, c.tmin,
                c.tmax, c.miss, S, c.step_size, c.sigma_thresh,
                c.stop_thresh)
        ok = kernels.collect(*args)
        op = guided.collect_t_fast_reference(*args)
        log(f"kernel collect S={S}: samples {int(ok[1].sum())}, steps "
            f"{int(ok[2].sum())}, overflowing rays {int(ok[3])}/{int(op[3])}")
        check(torch.equal(ok[0].view(torch.int32), op[0].view(torch.int32)),
              f"collect t_buf not bit-equal to the plain version (S={S})")
        for name, a, b in zip(("ns", "steps", "overflow"), ok[1:], op[1:]):
            check(torch.equal(a, b), f"collect {name} differs (S={S})")
        if S:
            err_c = max(err_c, float((ok[0] - op[0]).abs().max()))
        if S == 2:
            check(int(ok[3]) > 0, "S=2 should overflow")
        if S == GUIDED_S:
            steps_total = int(ok[2].sum())
            ms_c, by_c = device_ms(lambda: kernels.collect(*args), 20)
            plain_c = cuda_ms(
                lambda: guided.collect_t_fast_reference(*args), 2)
            bc, bc_by = bound_ms(
                nbytes(c.d, c.invdir, c.delta_scale, c.tmin, c.tmax, c.miss,
                       ok[0], ok[1], ok[2]) + 8 * steps_total,
                MARCH_OPS_PER_STEP * steps_total)
            log(f"kernel collect: {ms_c:.4f} ms on the device ({by_c}; plain "
                f"{plain_c:.2f} ms, bound {bc:.4f} ms by {bc_by}; "
                f"{dirs.shape[0]} rays, {steps_total} steps)")
        del ok, op
    report.append(dict(
        name="collect", route="cuda",
        source="mega_nerf_viewer_tpu_torch/csrc/collect.cu",
        replaces="mega_nerf_viewer_tpu/ops/guided.py:395",
        max_abs_err=err_c, ms=ms_c, ms_by=by_c, plain_ms=plain_c,
        bound_ms=bc, bound_by=bc_by, library_ms=None))
    del c
    torch.cuda.empty_cache()

    # -- 7. kernel D, the compact compositor, against its plain version
    first = P.collect_and_query_fast(tree, leaf_map, model, cam, opt,
                                     chunk_size=cs, skip_table=table)
    real = (first["results_c"], first["z_c"], first["ray_of_p"],
            first["offs"], first["num_samples"], first["vdirs_c"])
    total = int(first["offs"][-1])
    basis = tree.data_format.basis_dim
    err_d = 0.0
    synth = synthetic_cache(dev, 1 << 21, 9)
    cases = (("real", real, basis, opt),
             ("synthetic", synth, 9, opt.replace(basis_minmax=(1, 5))))
    for name, cache, B, o in cases:
        ok = cc.composite_results_compact_kernel(*cache, o, B, True)
        op = cc.composite_results_compact_reference(*cache, o, B, True)
        err = float((ok - op).abs().max())
        n_tot = int(cache[3][-1])
        log(f"kernel compact_composite ({name}, M={cache[0].shape[0]}, "
            f"{n_tot} samples, {cache[4].shape[0]} rays, basis {B}, "
            f"minmax {o.basis_minmax}): max abs diff {err:.3e}")
        check(bool(torch.isfinite(ok).all()), f"NaN in kernel D ({name})")
        check(bool(torch.isfinite(op).all()), f"NaN in plain D ({name})")
        check(err <= 1e-6, f"compact composite differs by {err} ({name})")
        err_d = max(err_d, err)
        ms, by = device_ms(lambda: cc.composite_results_compact_kernel(
            *cache, o, B, True), 20)
        plain = cuda_ms(lambda: cc.composite_results_compact_reference(
            *cache, o, B, True), 2)
        bd, bd_by = composite_bound(cache[0], cache[3], cache[4], n_tot, B,
                                    o.basis_minmax, True)
        log(f"kernel compact_composite ({name}): {ms:.4f} ms on the "
            f"device ({by}; plain {plain:.2f} ms, bound {bd:.4f} ms by {bd_by})")
        if name == "real":
            ms_d, by_d, plain_d, b_d, b_d_by = ms, by, plain, bd, bd_by
        del ok, op
    report.append(dict(
        name="compact_composite", route="cuda",
        source="mega_nerf_viewer_tpu_torch/csrc/compact_composite.cu",
        replaces="mega_nerf_viewer_tpu/ops/pallas_composite.py:150",
        max_abs_err=err_d, ms=ms_d, ms_by=by_d, plain_ms=plain_d,
        bound_ms=b_d, bound_by=b_d_by, library_ms=None))
    del first, real, synth, cases, cache
    torch.cuda.empty_cache()

    # -- 8. the guided main path (benchmarks/guided1080p.py:44-117) ---
    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cache = P.collect_and_query_fast(tree, leaf_map, model, cam, opt,
                                     chunk_size=cs, skip_table=table)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    ns_h = cache["num_samples"]
    order = P.order_from_hints(cache["collect_steps"], ns_h)

    def invalidate(**kw):
        return P.collect_and_query_fast(
            tree, leaf_map, model, cam, opt, chunk_size=cs,
            skip_table=table, order=order, **kw)

    invalidate()                                 # warm the ordered path
    cache, inval_ms, inval_ts = median3(invalidate)
    n_samples = int(cache["num_samples"].sum())
    segs = P.segments_from_ns_hints(ns_h, GUIDED_S)
    cache_s = invalidate(segments=segs)             # escalation settles here
    settled = cache_s["segments"]
    cache_s, inval_seg_ms, seg_ts = median3(
        lambda: invalidate(segments=settled))
    check(int(cache_s["num_samples"].sum()) == n_samples,
          "segmented sample total differs from the ordered one")

    def frame(c=cache):
        return P.composite_frame(tree, cam, opt, c)

    frame()
    rounds = sorted(cuda_ms(frame, N_FRAMES) for _ in range(ROUNDS))
    ms_frame = rounds[ROUNDS // 2]
    img = frame()
    img_s = frame(cache_s)
    # after a rot_dirs change the cached view directions are stale: the
    # frame gathers its own per sample and still composites in kernel D
    opt_rot = opt.replace(rot_dirs=(0.35, -0.2, 0.1))
    n_d = kernels.LAUNCHES["compact_composite"]
    img_rot = P.composite_frame(tree, cam, opt_rot, cache)
    check(kernels.LAUNCHES["compact_composite"] == n_d + 1,
          "the stale-view-direction frame did not run kernel D")
    ms_rot = sorted(cuda_ms(lambda: P.composite_frame(tree, cam, opt_rot,
                                                      cache), N_FRAMES)
                    for _ in range(ROUNDS))[ROUNDS // 2]
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    # the MLP query alone, on this invalidation's own inputs
    t_buf, ns_s, _ = guided.collect_t_fast(
        tree, leaf_map, dirs, cen, opt, chunk_size=cs, skip_table=table,
        order=order, return_steps=True, keep_sorted=True)
    dirs_r = dirs[order[0]]
    x, cids, _, _, _ = guided._compact_reconstruct(
        tree, dirs_r, dirs_r, cen, t_buf, ns_s, model.grid_dim,
        model.min_position, model.range, opt, cache["results_c"].shape[0])
    mlp_ms = cuda_ms(lambda: query_grouped(model.params, cids, x), 3)
    del t_buf, x, cids
    log(f"guided main path: first invalidation {first_ms:.1f} ms; ordered "
        f"invalidation {inval_ms:.3f} ms (runs "
        f"{[round(t, 3) for t in inval_ts]}); segmented invalidation "
        f"{inval_seg_ms:.3f} ms (runs {[round(t, 3) for t in seg_ts]}), "
        f"segments {segs} settled to {settled}; MLP samples {n_samples} "
        f"(budget {cache['results_c'].shape[0]}), MLP query {mlp_ms:.3f} "
        f"ms; composite {ms_frame:.3f} ms/frame, {1e3 / ms_frame:.2f} fps "
        f"(rounds {[round(r, 3) for r in rounds]}), after a rot_dirs "
        f"change {ms_rot:.3f} ms/frame; launches {launches}; "
        f"peak memory {peak / 2**30:.2f} GiB")
    for k in ("skip_prepass", "collect", "compact_composite"):
        check(launches[k] > 0,
              f"a kernel of the guided path never launched: {launches}")
    check(img.shape == (HEIGHT, WIDTH, 4), f"guided frame shape {img.shape}")
    check(bool(torch.isfinite(img).all()), "non-finite guided pixels")
    check(bool((img[..., 3] == 1).all()), "guided alpha is not 1")
    check(float(img[..., :3].max()) > 0, "black guided frame")
    diff = float((img_s - img).abs().max())
    log(f"guided frame, segmented vs ordered cache: max abs diff {diff:.3e}")
    check(diff <= 1e-6, "the segmented cache composites differently")
    # basis 1: the one SH term is constant, so the view direction does not
    # show and the rotated frame is the same
    diff = float((img_rot - img).abs().max())
    log(f"guided frame after a rot_dirs change: max abs diff {diff:.3e}")
    check(diff <= 1e-6, "the rot_dirs frame of a basis-1 cache differs")
    profile_frames(invalidate, inval_ms, n=1, what="invalidation")
    profile_frames(frame, ms_frame, what="frame")
    profile_frames(lambda: P.composite_frame(tree, cam, opt_rot, cache),
                   ms_rot, what="rot_dirs frame")
    del cache, cache_s, img, img_s, img_rot, order, dirs, dirs_r
    torch.cuda.empty_cache()

    # -- 9. a small guided frame against the plain path on the CPU ----
    small = P.shell_tree(depth=6, basis_dim=1, sigma_inside=400.0,
                         device="cpu")
    on_card = P.tree_from_numpy(
        **{k: getattr(small, k).numpy() for k in
           ("data", "child", "parent", "sample_counts", "scale", "offset")},
        capacity=small.capacity, data_format=small.data_format)
    scam = camera(P.Camera, 64, 64, FOCAL * 64 / WIDTH)
    outs = []
    for t in (small, on_card):
        m = P.MegaNeRFModel.synthetic(data_dim=int(t.data_dim),
                                      device=t.device, **GUIDED_MODEL)
        c = P.collect_and_query_fast(
            t, P.build_leaf_map(t), m, scam, opt, chunk_size=256,
            skip_table=P.build_skip_table(t, opt.sigma_thresh))
        d, cw = screen2worlddir(64, 64, scam.fx, scam.fy, scam.cx, scam.cy,
                                torch.as_tensor(scam.transform,
                                                device=t.device))
        total = int(c["offs"][-1])
        rop = c["ray_of_p"][:total].long()
        pos = cw[None, :] + d[rop] * c["z_c"][:total, None]
        cids = m.cluster_ids_device(pos[:, 1:3])
        outs.append((P.composite_frame(t, scam, opt, c).cpu(),
                     c["num_samples"].cpu(), rop.cpu(), cids.cpu()))
    (ic, nc, rc, cc_), (ig, ng, rg, cg) = outs
    bad = nc != ng
    if not bool(bad.any()):
        # the same sample layout: flag rays with a sample in another cluster
        bad[rc[cc_ != cg]] = True
    n_bad = int(bad.sum())
    err_small = float((ic - ig).reshape(-1, 4)[~bad].abs().max())
    log(f"64x64 guided frame, card vs CPU plain path: {n_bad} rays with "
        f"other sample counts or clusters, max abs diff elsewhere "
        f"{err_small:.3e}")
    check(n_bad <= 4, "card and CPU samples differ on more than 0.1% of rays")
    check(err_small <= 1e-4, "card and CPU guided frames differ")
    return launches


def synthetic_padded(dev, R, S, basis_dim, seed=0):
    """A padded cache of R rays x S slots made on the card from a seed: 0-S
    valid slots per ray, sigma >= 0, increasing z, unit view directions,
    an opaque first sample (sigma 1e8) on every 7th ray."""
    g = torch.Generator(device=dev).manual_seed(seed)
    out_dim = 3 * basis_dim + 2
    sidx = min(3, out_dim - 1)
    ns = torch.randint(0, S + 1, (R,), generator=g, device=dev,
                       dtype=torch.int32)
    res = torch.randn((R, S, out_dim), generator=g, device=dev)
    res[..., sidx] = res[..., sidx].abs() * 3
    res[::7, 0, sidx] = 1e8
    z = torch.sort(torch.rand((R, S), generator=g, device=dev) * 2,
                   dim=1).values
    vd = torch.randn((R, 3), generator=g, device=dev)
    return res, z, ns, vd / vd.norm(dim=1, keepdim=True)


def padded_bound(res, ns, B):
    """Bytes and operations of one SH padded composite: the valid slots of
    res and z, ns, the basis and the rgba out; COMPOSITE_OPS + 6 B per
    valid slot (the basis comes in computed)."""
    R, _, out_dim = res.shape
    valid = int(ns.sum())
    return bound_ms(valid * (out_dim + 1) * 4 + R * (4 + 16 + 4 * B),
                    (COMPOSITE_OPS + 6 * B) * valid)


def small_refinement(P, dev):
    """Phase 14: two expands, a resample, a visit-tracked exact frame and
    a prune of a small tree, on the card and on the CPU from the same
    uniform draws; the trees and trackers must agree (data within one f16
    ulp)."""
    from mega_nerf_viewer_tpu_torch.ops import refine
    gen = torch.Generator().manual_seed(0)
    K, spc = 64, 8
    draws = [torch.rand((K * 8, spc, 3), generator=gen) for _ in range(2)]
    draws.append(torch.rand((K, spc, 3), generator=gen))
    out = []
    for d in ("cpu", dev):
        tree = P.sphere_tree(basis_dim=1, depth=3, max_capacity=400,
                             device=d)
        model = P.MegaNeRFModel.synthetic(data_dim=4, n_clusters=4,
                                          need_viewdir=True, device=d)
        opt = P.RenderOptions(use_splitting=True, split_batch_size=K,
                              need_viewdir=True)
        cam = camera(P.Camera, 48, 48, 45.0)
        args = (cam.width, cam.height, cam.fx, cam.fy, cam.cx, cam.cy,
                cam.transform, opt)
        tracker = P.fresh_visit_tracker(tree)
        caps = [tree.capacity]
        for i in range(2):
            _, res = P.render_frame(tree, *args)
            k = len(refine.aggregate_split_votes(res.split_vote, K))
            tree, tracker, _ = P.expand_voxels(
                tree, model, opt, res.split_vote, tracker,
                rnd=draws[i][:k * 8].to(d))
            caps.append(tree.capacity)
        _, res = P.render_frame(tree, *args)
        k = len(refine.aggregate_sample_votes(res.sample_vote, K))
        tree = P.get_more_samples(tree, model, opt, res.sample_vote,
                                  rnd=draws[2][:k].to(d))
        _, res = P.render_frame(tree, *args, track_visit=True)
        tracker = torch.maximum(tracker, res.visited)
        tree, fresh = P.prune_tree(tree, tracker)
        caps.append(tree.capacity)
        out.append((tree, tracker.cpu(), fresh.cpu(), caps))
    (tc, vc, fc, cc), (tg, vg, fg, cg) = out
    log(f"small refinement, card vs CPU: capacity {cg} on the card, {cc} on "
        f"the CPU")
    check(cc == cg, "card and CPU capacities differ")
    check(cg[1] > cg[0] and cg[3] < cg[2], "no split or no prune happened")
    for k in ("child", "parent", "sample_counts"):
        check(torch.equal(getattr(tc, k), getattr(tg, k).cpu()),
              f"card and CPU {k} differ after refinement")
    check(torch.equal(vc, vg) and torch.equal(fc, fg),
          "card and CPU visit trackers differ")
    ulp = (tc.data.view(torch.int16).int()
           - tg.data.cpu().view(torch.int16).int()).abs()
    log(f"small refinement: data within {int(ulp.max())} f16 ulp")
    check(int(ulp.max()) <= 1, "card and CPU data differ by more than 1 ulp")


def refine_phases(P, kernels, dev, report):
    """Phases 11-14: dynamic octree refinement at 1080p.  Returns the
    launch counts of the session (phase 12)."""
    from mega_nerf_viewer_tpu_torch.ops import accel, guided, render
    from mega_nerf_viewer_tpu_torch.ops import padded_composite as pc
    from mega_nerf_viewer_tpu_torch.ops.rays import rodrigues, screen2worlddir
    from mega_nerf_viewer_tpu_torch.ops.sh import masked_sh_basis

    t0 = time.perf_counter()
    tree = P.shell_tree(depth=8, basis_dim=1, sigma_inside=400.0,
                        max_capacity=REFINE_CAPACITY, device=dev)
    check(tree.capacity == SHELL_CHUNKS, f"shell has {tree.capacity} chunks")
    model = P.MegaNeRFModel.synthetic(data_dim=int(tree.data_dim), seed=0,
                                      device=dev, **GUIDED_MODEL)
    opt = P.RenderOptions(**REFINE_OPT)
    cam = camera(P.Camera, WIDTH, HEIGHT, FOCAL)
    cs = P.device_tuning(dev).chunk_size
    frame_args = (WIDTH, HEIGHT, cam.fx, cam.fy, cam.cx, cam.cy,
                  cam.transform)
    dirs, cen = screen2worlddir(WIDTH, HEIGHT, cam.fx, cam.fy, cam.cx,
                                cam.cy, torch.as_tensor(cam.transform,
                                                        device=dev))
    vdirs = rodrigues(opt.rot_dirs, dirs)
    grid = (torch.as_tensor(model.grid_dim, device=dev).to(torch.int32),
            torch.as_tensor(model.min_position, device=dev).float(),
            torch.as_tensor(model.range, device=dev).float())
    torch.cuda.synchronize()
    log(f"refinement scene: shell depth 8 basis 1, {tree.capacity} chunks, "
        f"max_capacity {REFINE_CAPACITY} (split_batch_size "
        f"{opt.split_batch_size}); model {model.n_clusters} clusters x "
        f"{len(model.params.weights)} layers x {GUIDED_MODEL['hidden']}; "
        f"max_depth {opt.max_depth}, samples_per_corner "
        f"{opt.samples_per_corner}, S {opt.max_guided_samples}; "
        f"{time.perf_counter() - t0:.1f} s")

    # -- 11. kernel F, the exact collect, against its plain version ----
    m = guided.collect_inputs(tree, dirs, cen, opt)
    col_args = (tree, m, dirs, vdirs, cen, grid, opt)
    ok = kernels.exact_collect(*col_args, True, render.DEFAULT_MAX_LEVELS)
    op = guided.exact_collect_reference(*col_args, True)
    err_f = float((ok[0] - op[0]).abs().max())
    for name, a, b in zip(("cluster_ids", "ns", "split_vote", "sample_vote",
                           "visited", "steps"), ok[1:], op[1:]):
        check(torch.equal(a, b), f"exact collect {name} differs")
    check(err_f <= 1e-6, f"exact collect samples differ by {err_f}")
    n_rec, steps_total = int(ok[2].sum()), int(ok[6].sum())
    log(f"kernel exact_collect S={opt.max_guided_samples}: samples {n_rec}, "
        f"steps {steps_total}, visited chunks {int(ok[5].sum())}; samples "
        f"max abs diff {err_f:.3e}")
    ms_f, by_f = device_ms(lambda: kernels.exact_collect(
        *col_args, False, render.DEFAULT_MAX_LEVELS), 10)
    plain_f = cuda_ms(lambda: guided.exact_collect_reference(*col_args), 1)
    bf, bf_by = bound_ms(
        nbytes(m.d, m.invdir, m.delta_scale, m.tmin, m.tmax, m.miss, dirs,
               vdirs, *ok[:5], ok[6]) + 4 * dirs.shape[0]
        + EXACT_BYTES_PER_STEP * steps_total,
        EXACT_OPS_PER_STEP * steps_total + RECORD_OPS * n_rec)
    log(f"kernel exact_collect: {ms_f:.4f} ms on the device ({by_f}; with "
        f"the wrapper's fills; plain {plain_f:.2f} ms, bound {bf:.4f} ms "
        f"by {bf_by})")
    report.append(dict(
        name="exact_collect", route="cuda",
        source="mega_nerf_viewer_tpu_torch/csrc/exact_collect.cu",
        replaces="mega_nerf_viewer_tpu/ops/guided.py:60",
        max_abs_err=err_f, ms=ms_f, ms_by=by_f, plain_ms=plain_f,
        bound_ms=bf, bound_by=bf_by, library_ms=None))
    del ok, op, m
    torch.cuda.empty_cache()

    # -- 12. the session (viewer.py:368-479, refine_throughput.py) -----
    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev).manual_seed(0)
    tracker = P.fresh_visit_tracker(tree)
    state = dict(order=None, segments=list(P.DEFAULT_SEGMENTS), md=8)
    edits = []

    def vote_frame(cur, lm):
        """One vote frame as Viewer._render_fast(need_votes=True) makes
        it, without a skip table: the segmented frame on the order, else
        (first frame, or a segment overflowed) the hint frame, which
        builds the order; the exact frame if even budget 128 overflows
        (viewer.py:640-795).  Returns (img, split_vote, sample_vote)."""
        if state["order"] is not None:
            out = P.render_frame_fast_segmented(
                cur, lm, cam, opt, order=state["order"],
                segments=tuple(state["segments"]), chunk_size=cs,
                need_votes=True)
            ov = out[1].cpu().numpy()
            if not ov.any():
                return out[0], out[2], out[3]
            state["segments"] = [(f, min(max(1, b * 2), 128)) if hit
                                 else (f, b) for (f, b), hit in
                                 zip(state["segments"], ov)]
        md = state["md"]
        while True:
            img, ov, steps, sv, pv, nrec, skips = P.render_frame_fast(
                cur, lm, cam, opt, max_dense=md, chunk_size=cs,
                need_votes=True, return_nrec=True, return_skips=True)
            if not int(ov) or md >= 128:
                break
            md *= 2
        state["md"] = md
        state["order"] = P.order_from_hints(steps, nrec, skips)
        if int(ov):
            img, res = P.render_frame(cur, *frame_args, opt)
            return img, res.split_vote, res.sample_vote
        return img, sv, pv

    def edit(cur, tracker, sv, pv, what):
        """Viewer._expand_voxels: split; when nothing was added, resample
        (viewer.py:1303-1321)."""
        cap0 = cur.capacity
        torch.cuda.synchronize()
        t = time.perf_counter()
        new, tracker, added = P.expand_voxels(cur, model, opt, sv, tracker,
                                              generator=gen)
        kind = "split"
        if added == 0:
            new = P.get_more_samples(cur, model, opt, pv, generator=gen)
            kind = "resample"
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        edits.append(dict(after=what, kind=kind, added=added,
                          capacity=(cap0, new.capacity), ms=round(ms, 3)))
        return new, tracker

    def pressure(cur):
        return cur.max_capacity - cur.capacity < opt.split_batch_size

    t_sess = time.perf_counter()
    lm = P.build_leaf_map(tree)
    (img, sv, pv), first_vote_ms = timed(lambda: vote_frame(tree, lm))
    check(bool(torch.isfinite(img).all()), "non-finite vote frame")
    n_iters, pressure_at = 0, None
    for i in range(SESSION_ITERS):
        tree, tracker = edit(tree, tracker, sv, pv, f"vote frame {i}")
        n_iters += 1
        if pressure_at is None and pressure(tree):
            pressure_at = n_iters
        lm = P.build_leaf_map(tree)
        img, sv, pv = vote_frame(tree, lm)
        check(bool(torch.isfinite(img).all()), "non-finite vote frame")
        if edits[-1]["kind"] == "resample":
            break
    check(pressure_at is not None and 3 <= pressure_at <= 5,
          f"capacity pressure came after expand {pressure_at}, not 3-5")
    check(any(e["kind"] == "resample" for e in edits),
          "no resample ran in the session")
    vote_rounds = sorted(cuda_ms(lambda: vote_frame(tree, lm), N_FRAMES)
                         for _ in range(ROUNDS))
    vote_ms = vote_rounds[ROUNDS // 2]
    log(f"session steps 1-2: first vote frame {first_vote_ms:.1f} ms; "
        f"{n_iters} edits, capacity pressure after expand {pressure_at}; "
        f"leaf map level {lm.level} (+{lm.deep_levels} deep); vote frame "
        f"{vote_ms:.3f} ms/frame (rounds "
        f"{[round(r, 3) for r in vote_rounds]}), segments "
        f"{state['segments']}, hint budget {state['md']}; edits {edits}")

    # refine_throughput.py's device loop on its own tree and capacity
    cur = P.shell_tree(depth=8, basis_dim=1, sigma_inside=400.0,
                       max_capacity=THROUGHPUT_CAPACITY, device=dev)
    ttracker = P.fresh_visit_tracker(cur)

    def throughput_step(cur, ttracker):
        tlm = P.build_leaf_map(cur)
        tsv = accel.render_rays_fast(cur, tlm, dirs, vdirs, cen, opt,
                                     max_dense=32, chunk_size=4096,
                                     need_votes=True).split_vote
        return P.expand_voxels_jit(cur, model.params, *grid, opt, tsv,
                                   ttracker, generator=gen), tlm

    for _ in range(2):                    # warm-up, as the benchmark does
        (cur, ttracker, _n), tlm = throughput_step(cur, ttracker)
    warm_shape = (tlm.level, tlm.deep_levels)
    total_added = 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(THROUGHPUT_ITERS):
        (cur, ttracker, n), tlm = throughput_step(cur, ttracker)
        total_added += n
    torch.cuda.synchronize()
    dt = time.perf_counter() - t
    check(total_added > 0, "the device expand loop added nothing")
    spc = opt.samples_per_corner
    log("refine_throughput: " + json.dumps({
        "splits_per_sec": total_added / dt,
        "voxels_filled_per_sec": total_added * 8 / dt,
        "mlp_evals_per_sec": total_added * 8 * spc / dt,
        "iterations": THROUGHPUT_ITERS, "total_added": total_added,
        "final_capacity": cur.capacity, "ms_per_iteration":
        dt * 1e3 / THROUGHPUT_ITERS, "leafmap_shape_stable":
        (tlm.level, tlm.deep_levels) == warm_shape}))
    del cur, ttracker, tlm
    torch.cuda.empty_cache()

    # step 3: capacity pressure: a visit-tracked exact frame, the prune,
    # a vote frame on the pruned tree
    check(pressure(tree), "no capacity pressure before the prune")
    (img_e, res_e), exact_visit_ms = timed(lambda: P.render_frame(
        tree, *frame_args, opt, track_visit=True))
    tracker = torch.maximum(tracker, res_e.visited)
    check(bool(torch.isfinite(img_e).all()), "non-finite exact frame")
    exact_ms = sorted(cuda_ms(lambda: P.render_frame(tree, *frame_args, opt),
                              3) for _ in range(ROUNDS))[ROUNDS // 2]
    exact_visit_ms = sorted(cuda_ms(lambda: P.render_frame(
        tree, *frame_args, opt, track_visit=True), 3)
        for _ in range(ROUNDS))[ROUNDS // 2]
    cap0 = tree.capacity
    (tree, tracker), prune_ms = timed(lambda: P.prune_tree(tree, tracker))
    edits.append(dict(after="exact frame", kind="prune", added=0,
                      capacity=(cap0, tree.capacity), ms=round(prune_ms, 3)))
    check(tree.capacity < cap0, "the prune reclaimed nothing")
    lm = P.build_leaf_map(tree)
    state["order"] = None                 # the tree moved under the order
    img, sv, pv = vote_frame(tree, lm)
    check(bool(torch.isfinite(img).all()), "non-finite vote frame")
    log(f"session step 3: exact frame {exact_ms:.3f} ms, with visit marks "
        f"{exact_visit_ms:.3f} ms; visited chunks "
        f"{int(res_e.visited.sum())}; prune {prune_ms:.3f} ms, reclaimed "
        f"{cap0 - tree.capacity} chunks ({cap0} -> {tree.capacity})")
    profile_frames(lambda: P.render_frame(tree, *frame_args, opt,
                                          track_visit=True),
                   exact_visit_ms, n=1, what="exact frame")
    del img_e, res_e

    # step 4: guided sampling with splitting (viewer.py:1181-1296)
    (cache, rres), first_inval_ms = timed(lambda: P.collect_and_query(
        tree, model, cam, opt, track_visit=True))
    tracker = torch.maximum(tracker, rres.visited)
    img_g = P.composite_frame(tree, cam, opt, cache)
    check(img_g.shape == (HEIGHT, WIDTH, 4), f"guided frame {img_g.shape}")
    check(bool(torch.isfinite(img_g).all()), "non-finite guided pixels")
    check(bool((img_g[..., 3] == 1).all()), "guided alpha is not 1")
    check(float(img_g[..., :3].max()) > 0, "black guided frame")

    def invalidate():
        return P.collect_and_query(tree, model, cam, opt)

    _, inval_ms, inval_runs = median3(invalidate)

    def frame(o=opt):
        return P.composite_frame(tree, cam, o, cache)

    rounds = sorted(cuda_ms(frame, N_FRAMES) for _ in range(ROUNDS))
    comp_ms = rounds[ROUNDS // 2]
    n_samples = int(cache["num_samples"].sum())
    log(f"session step 4: first invalidation (visit marks) "
        f"{first_inval_ms:.1f} ms; invalidation {inval_ms:.3f} ms (runs "
        f"{[round(r, 3) for r in inval_runs]}); {n_samples} MLP samples; "
        f"padded composite {comp_ms:.3f} ms/frame (rounds "
        f"{[round(r, 3) for r in rounds]})")
    profile_frames(invalidate, inval_ms, n=1, what="invalidation")
    profile_frames(frame, comp_ms, what="padded frame")
    tree, tracker = edit(tree, tracker, rres.split_vote, rres.sample_vote,
                         "guided frame")

    # step 5: depth mode: an exact frame, a fast frame, a padded composite
    opt_d = opt.replace(render_depth=True)
    lm = P.build_leaf_map(tree)
    img_de, _ = P.render_frame(tree, *frame_args, opt_d)
    md = state["md"]
    while True:
        img_df, ov, _ = P.render_frame_fast(tree, lm, cam, opt_d,
                                            max_dense=md, chunk_size=cs)
        if not int(ov):
            break
        md *= 2
        check(md <= 512, "pathological dense-sample count")
    img_dg = frame(opt_d)
    for name, im in (("exact", img_de), ("fast", img_df), ("padded", img_dg)):
        check(bool(torch.isfinite(im).all()), f"non-finite {name} depth")
        check(bool((im[..., 3] == 1).all()), f"{name} depth alpha is not 1")
    err_depth = float((img_de - img_df).abs().max())
    log(f"session step 5: depth frames, exact vs fast max abs diff "
        f"{err_depth:.3e}; depth range {float(img_de[..., 0].min()):.4f} - "
        f"{float(img_de[..., 0].max()):.4f}")
    check(err_depth <= 1e-6, "exact and fast depth frames differ")
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    log(f"refinement session: {time.perf_counter() - t_sess:.1f} s; "
        f"launches {launches}; peak memory {peak / 2**30:.2f} GiB; "
        f"capacity by edit {[(e['kind'], e['capacity']) for e in edits]}")
    for k in ("march", "exact_march", "exact_collect", "padded_composite"):
        check(launches[k] > 0, f"a kernel of the session never launched: "
              f"{launches}")
    del img, img_g, img_de, img_df, img_dg, rres, sv, pv

    # -- 13. kernel G, the padded compositor, against its plain version
    real = (cache["results"], cache["z_vals"], cache["num_samples"], vdirs)
    synth = synthetic_padded(dev, *PADDED_SYNTH)
    err_g = 0.0
    B_s = PADDED_SYNTH[2]
    for name, c, B, o in (("real", real, 1, opt),
                          ("real depth", real, 1, opt_d),
                          ("synthetic", synth, B_s, opt),
                          ("synthetic depth", synth, B_s, opt_d)):
        ok = pc.composite_results_padded(*c, o, B, True)
        op = pc.composite_results_padded_reference(*c, o, B, True)
        err = float((ok - op).abs().max())
        R, S, out_dim = c[0].shape
        log(f"kernel padded_composite ({name}, {R} rays x S {S}, out_dim "
            f"{out_dim}, {int(c[2].sum())} samples): max abs diff {err:.3e}")
        check(bool(torch.isfinite(ok).all()), f"NaN in kernel G ({name})")
        check(err <= 1e-6, f"padded composite differs by {err} ({name})")
        err_g = max(err_g, err)
        del ok, op
        if o.render_depth:
            continue
        # the kernel alone, the basis computed outside as the wrapper does
        args = (c[0], c[1].contiguous(), c[2],
                masked_sh_basis(B, c[3], *o.basis_minmax).contiguous(),
                pc.MODE_SH)
        ms, by = device_ms(lambda: kernels.padded_composite(*args), 20)
        plain = cuda_ms(lambda: pc.composite_results_padded_reference(
            *c, o, B, True), 2)
        bg, bg_by = padded_bound(c[0], c[2], B)
        log(f"kernel padded_composite ({name}): {ms:.4f} ms on the device "
            f"({by}; plain {plain:.2f} ms, bound {bg:.4f} ms by {bg_by})")
        if name == "real":
            times = dict(ms=ms, ms_by=by, plain_ms=plain, bound_ms=bg,
                         bound_by=bg_by, library_ms=None)
        del args
    report.append(dict(
        name="padded_composite", route="cuda",
        source="mega_nerf_viewer_tpu_torch/csrc/padded_composite.cu",
        replaces="mega_nerf_viewer_tpu/ops/pallas_composite.py:361",
        max_abs_err=err_g, **times))
    del cache, real, synth
    torch.cuda.empty_cache()

    # -- 14. a small refinement on the card against the CPU ------------
    small_refinement(P, dev)
    return launches


def uncounted(kernels, fn):
    """``fn()`` without adding its launches to the path's counts: the
    comparisons interleaved with a path are not the path."""
    saved = dict(kernels.LAUNCHES)
    try:
        return fn()
    finally:
        kernels.LAUNCHES.update(saved)


def orbit_step(cam, n_poses):
    """One pose of ``cli --orbit`` over ``n_poses`` frames (cli.py:193-201):
    an incremental right-button drag of 2*pi/n_poses about the origin."""
    step = 2.0 * np.pi / n_poses
    cam.begin_drag(0.0, 0.0, False, True)
    cam.drag_update(-step * max(cam.width, cam.height)
                    / (2.0 * cam.movement_speed), 0.0)
    cam.end_drag()


class StepTimes:
    """Within the block, the host milliseconds of the named functions of
    ``modules`` ((module, names) pairs) that a Viewer frame calls, the card
    synchronized around each call, summed per name into ``ms``: where a
    slow frame's time goes."""

    VOXEL = ("dilate_packed", "order_from_packed_device",
             "hint_class_cdf_packed", "render_frame_fast_segmented",
             "render_frame_fast", "pack_hints", "hint_class_cdf")
    GUIDED = ("dilate_hints", "order_from_ns_steps_device", "hint_class_cdf")

    def __init__(self, *modules):
        self.saved = [(m, n, getattr(m, n)) for m, names in modules
                      for n in names]
        self.ms = {}

    def __enter__(self):
        def timed_step(name, fn):
            def call(*a, **kw):
                torch.cuda.synchronize()
                t = time.perf_counter()
                out = fn(*a, **kw)
                torch.cuda.synchronize()
                self.ms[name] = round(self.ms.get(name, 0.0) + (
                    time.perf_counter() - t) * 1e3, 3)
                return out
            return call

        for m, n, fn in self.saved:
            setattr(m, n, timed_step(n, fn))
        return self

    def __exit__(self, *exc):
        for m, n, fn in self.saved:
            setattr(m, n, fn)


def fresh_frame(P, tree, leaf_map, cam, opt, cs, skip_table):
    """A fresh ``render_frame_fast`` of the camera's pose, its budget
    doubled until nothing overflows."""
    md = 8
    while True:
        img, ov, _ = P.render_frame_fast(tree, leaf_map, cam, opt,
                                         max_dense=md, chunk_size=cs,
                                         skip_table=skip_table)
        if not int(ov):
            return img
        md *= 2
        check(md <= 512, "pathological dense-sample count")


def viewer_phase(P, kernels, dev, voxel_ref):
    """Phase 15: the Viewer session at 1080p on the voxel scene, default
    options, the sync overflow policy (viewer.py:347-795).  Returns the
    launch counts of its run."""
    from mega_nerf_viewer_tpu_torch.ops import accel
    from mega_nerf_viewer_tpu_torch.utils.png import read_png

    ref_img, ref_ms = voxel_ref
    tree = P.shell_tree(depth=8, basis_dim=9, sigma_inside=400.0)
    cam = camera(P.Camera, WIDTH, HEIGHT, FOCAL)
    v = P.Viewer(tree, camera=cam)
    cs = v.fast_chunk_size
    check(cs == P.device_tuning(dev).chunk_size and v.overflow_policy
          == "sync", "the Viewer's defaults are not the card's")
    # the dilation window of each moved frame, as the Viewer computes it
    windows = []
    estimate = v._estimate_dilation

    def spy(*a, **kw):
        windows.append(estimate(*a, **kw))
        return windows[-1]

    v._estimate_dilation = spy

    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    img, first_ms = timed(lambda: v.render(fetch=False))
    err = float((img - ref_img).abs().max())
    log(f"viewer: first frame (the hint frame and its max_dense loop) "
        f"{first_ms:.1f} ms, hint budget {v.fast_max_dense}, segments "
        f"{v._segments}; against phase 4's frame max abs diff {err:.3e}")
    check(err <= 1e-6, "the Viewer's hint frame differs from phase 4's")
    worst = 0.0
    for _ in range(N_FRAMES):
        img = v.render(fetch=False)
        worst = max(worst, float((img - ref_img).abs().max()))
    check(img.shape == (HEIGHT, WIDTH, 4), f"viewer frame {img.shape}")
    check(bool(torch.isfinite(img).all()), "non-finite viewer pixels")
    check(worst <= 1e-6, f"a parked frame differs from phase 4's by {worst}")
    rounds = sorted(cuda_ms(lambda: v.render(fetch=False), N_FRAMES)
                    for _ in range(ROUNDS))
    ms_parked = rounds[ROUNDS // 2]
    log(f"viewer parked frames: {ms_parked:.3f} ms/frame (rounds "
        f"{[round(r, 3) for r in rounds]}); each of {N_FRAMES} against "
        f"phase 4's frame: max abs diff {worst:.3e}; the Viewer adds "
        f"{ms_parked - ref_ms:.3f} ms to phase 4's {ref_ms:.3f} ms/frame")
    profile_frames(lambda: v.render(fetch=False), ms_parked,
                   what="viewer frame")

    # a 12-pose orbit, timed as a user's frames run (no step timers), each
    # pose against a fresh frame of that pose
    poses = []
    for _ in range(12):
        orbit_step(cam, 12)
        windows.clear()
        img, ms = timed(lambda: v.render(fetch=False))
        redo = v._segments_src == ("steady",)
        fresh = uncounted(kernels, lambda: fresh_frame(
            P, v.tree, v._leaf_map, cam, v.options, cs, v._skip_table))
        err = float((img - fresh).abs().max())
        poses.append(dict(ms=round(ms, 3),
                          window=windows[0] if windows else None,
                          redo=redo, err=err))
        check(err <= 1e-6, f"orbit pose differs from a fresh frame by {err}")
        check(bool(torch.isfinite(img).all()), "non-finite orbit pixels")
    pose_ms = sorted(p["ms"] for p in poses)
    log(f"viewer orbit (12 poses, cli --orbit steps): median "
        f"{pose_ms[6]:.3f} ms/pose, {sum(p['redo'] for p in poses)} sync "
        f"redos; each pose against a fresh frame: max abs diff "
        f"{max(p['err'] for p in poses):.3e}; poses {poses}")
    # six more poses, instrumented: each step timed on the host with the
    # card synchronized around it (the syncs add to these poses' times)
    inst = []
    with StepTimes((accel, StepTimes.VOXEL)) as steps:
        for _ in range(6):
            orbit_step(cam, 12)
            steps.ms.clear()
            img, ms = timed(lambda: v.render(fetch=False))
            check(bool(torch.isfinite(img).all()), "non-finite orbit pixels")
            inst.append(dict(ms=round(ms, 3), steps=dict(steps.ms)))
    log(f"viewer orbit, instrumented (6 more poses, each step "
        f"synchronized): {inst}")

    # parked again: rgba8, a screenshot, sorted delivery
    rgba = v.render_rgba8()
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "screenshot.png")
        check(v.screenshot(path), "the screenshot was not written")
        shot = read_png(path)
    check(rgba.shape == (HEIGHT, WIDTH, 4) and rgba.dtype == np.uint8,
          f"rgba8 frame {rgba.shape} {rgba.dtype}")
    check(np.array_equal(shot, rgba), "the screenshot differs from rgba8")
    plain = v.render()
    v.host_unpermute = True
    v.render()                        # fetches the inverse order once
    sorted_img = v.render()
    check(v.frame_index_map() is not None, "no sorted delivery")
    check(np.array_equal(sorted_img, plain),
          "host_unpermute frame differs from the device-unpermuted one")
    check(np.array_equal(v.render_rgba8(), rgba),
          "host_unpermute rgba8 differs")
    ms_sorted = sorted(cuda_ms(lambda: v.render(fetch=False), N_FRAMES)
                       for _ in range(ROUNDS))[ROUNDS // 2]
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    log(f"viewer rgba8 and screenshot equal; host_unpermute frames equal, "
        f"{ms_sorted:.3f} ms/frame with fetch=False; launches {launches}; "
        f"peak memory {peak / 2**30:.2f} GiB")
    check(launches["skip_prepass"] > 0 and launches["march"] > 0,
          f"a kernel of the Viewer's path never launched: {launches}")
    return launches


def depth_bound(total, R):
    """Bytes and operations of one compact depth composite: sigma and z of
    each valid sample, offs, ns and the rgba out; DEPTH_OPS per sample."""
    return bound_ms(total * 8 + R * (4 + 4 + 16), DEPTH_OPS * total)


def viewer_guided_phase(P, kernels, dev, report):
    """Phase 16: the Viewer's guided frames on the guided 1080p scene and
    model, then its refinement frames on phase 12's configuration, then
    the CLI in a subprocess on the saved tree.  Returns the launch counts
    of its run."""
    from mega_nerf_viewer_tpu_torch.ops import accel, guided
    from mega_nerf_viewer_tpu_torch.ops import compact_composite as cc
    from mega_nerf_viewer_tpu_torch.utils.png import read_png

    # room to grow: a full tree would put the Viewer under capacity
    # pressure, tracking visits on the exact collect and pruning
    tree = P.shell_tree(depth=8, basis_dim=1, sigma_inside=400.0,
                        max_capacity=2 * SHELL_CHUNKS)
    model = P.MegaNeRFModel.synthetic(data_dim=int(tree.data_dim), seed=0,
                                      **GUIDED_MODEL)
    opt = P.RenderOptions(max_guided_samples=GUIDED_S, need_viewdir=True,
                          use_guided_sampling=True)
    cam = camera(P.Camera, WIDTH, HEIGHT, FOCAL)
    v = P.Viewer(tree, camera=cam, options=opt, model=model)

    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    img, first_ms = timed(lambda: v.render(fetch=False))
    check(img.shape == (HEIGHT, WIDTH, 4), f"guided frame {img.shape}")
    check(bool(torch.isfinite(img).all()), "non-finite guided pixels")
    check(float(img[..., :3].max()) > 0, "black guided frame")
    # three stops (a step forward, then a stop), five reuse frames and a
    # moved pose, timed as a user's frames run (no step timers)
    stops = []
    for _ in range(3):
        v.key_event("W")
        _, ms = timed(lambda: v.render(fetch=False))
        stops.append(ms)
    reuse = []
    for _ in range(5):
        _, ms = timed(lambda: v.render(fetch=False))
        reuse.append(ms)
    orbit_step(cam, 12)
    img, moved_ms = timed(lambda: v.render(fetch=False))
    check(bool(torch.isfinite(img).all()), "non-finite moved guided frame")
    log(f"viewer guided: first frame {first_ms:.1f} ms; stops "
        f"{sorted(stops)[1]:.3f} ms (runs {[round(t, 3) for t in stops]}); "
        f"reuse frames {[round(t, 3) for t in reuse]} ms; a moved pose "
        f"{moved_ms:.3f} ms; guided segments {v._guided_segments}")
    # two more stops and a moved pose, instrumented: each step timed on
    # the host with the card synchronized around it
    inst = []
    with StepTimes((guided, ("collect_and_query_fast", "composite_frame")),
                   (accel, StepTimes.GUIDED)) as steps:
        for move in ("W", "W", "orbit"):
            if move == "orbit":
                orbit_step(cam, 12)
            else:
                v.key_event(move)
            steps.ms.clear()
            img, ms = timed(lambda: v.render(fetch=False))
            check(bool(torch.isfinite(img).all()), "non-finite guided frame")
            inst.append(dict(move=move, ms=round(ms, 3), steps=dict(steps.ms)))
    log(f"viewer guided, instrumented (two stops and a moved pose, each "
        f"step synchronized): {inst}")

    # depth mode on the compact cache: kernel D's depth branch
    v.options = v.options.replace(render_depth=True)
    n_d = kernels.LAUNCHES["compact_composite_depth"]
    img_d, depth_ms = timed(lambda: v.render(fetch=False))
    check(kernels.LAUNCHES["compact_composite_depth"] == n_d + 1,
          "the depth frame did not run kernel D's depth branch")
    cache = v._guided_cache[0]
    c_args = (cache["results_c"], cache["z_c"], cache["ray_of_p"],
              cache["offs"], cache.get("num_samples_sorted",
                                       cache["num_samples"]), None)
    ref = cc.composite_results_compact_reference(*c_args, v.options, 1, True)
    inv = cache.get("order_inv")
    ref = (ref if inv is None else ref[inv]).reshape(HEIGHT, WIDTH, 4)
    err_dd = float((img_d - ref).abs().max())
    log(f"viewer guided depth frame: {depth_ms:.3f} ms; against the plain "
        f"compositor max abs diff {err_dd:.3e}; depth range "
        f"{float(img_d[..., 0].min()):.4f} - {float(img_d[..., 0].max()):.4f}")
    check(bool(torch.isfinite(img_d).all()), "non-finite depth frame")
    check(err_dd <= 1e-6, f"kernel D depth differs by {err_dd}")
    total = int(cache["offs"][-1])
    R = c_args[4].shape[0]
    o_d = v.options
    ms_dd, by_dd = uncounted(kernels, lambda: device_ms(
        lambda: cc.composite_results_compact_kernel(*c_args, o_d, 1, True),
        20))
    plain_dd = cuda_ms(lambda: cc.composite_results_compact_reference(
        *c_args, o_d, 1, True), 2)
    b_dd, b_dd_by = depth_bound(total, R)
    log(f"kernel compact_composite (depth, {total} samples, {R} rays): "
        f"{ms_dd:.4f} ms on the device ({by_dd}; plain {plain_dd:.2f} ms, "
        f"bound {b_dd:.4f} ms by {b_dd_by})")
    report.append(dict(
        name="compact_composite_depth", route="cuda",
        source="mega_nerf_viewer_tpu_torch/csrc/compact_composite.cu",
        replaces="mega_nerf_viewer_tpu/ops/guided.py:706",
        max_abs_err=err_dd, ms=ms_dd, ms_by=by_dd, plain_ms=plain_dd,
        bound_ms=b_dd, bound_by=b_dd_by, library_ms=None))
    del v, cache, c_args, ref, img, img_d, tree
    torch.cuda.empty_cache()

    # refinement frames on phase 12's configuration
    tree = P.shell_tree(depth=8, basis_dim=1, sigma_inside=400.0,
                        max_capacity=REFINE_CAPACITY)
    cam = camera(P.Camera, WIDTH, HEIGHT, FOCAL)
    v = P.Viewer(tree, camera=cam, options=P.RenderOptions(**REFINE_OPT),
                 model=model)
    # three splitting frames (the prune fires after the third), then guided
    # sampling toggled on (key R): the fourth frame is a guided splitting
    # frame that tracks visits after the prune (the exact collect, kernel
    # F, and the padded compositor, kernel G)
    frames = []
    for i in range(4):
        if i == 3:
            v.key_event("R")
        cap0 = v.tree.capacity
        n_f = kernels.LAUNCHES["exact_collect"]
        img, ms = timed(lambda: v.render(fetch=False))
        check(bool(torch.isfinite(img).all()), "non-finite split frame")
        frames.append(dict(ms=round(ms, 1), capacity=(cap0, v.tree.capacity),
                           pruned=v._prune_happened,
                           guided=v.options.use_guided_sampling,
                           visits=v._visits_valid))
    check(kernels.LAUNCHES["exact_collect"] > n_f and frames[3]["visits"],
          "the guided splitting frame did not track visits on kernel F")
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    log(f"viewer splitting frames (the fourth guided): {frames}; launches "
        f"{launches}; peak memory {peak / 2**30:.2f} GiB")
    check(frames[0]["capacity"][1] > SHELL_CHUNKS, "the first frame split "
          "nothing")
    check(frames[2]["pruned"], "the prune did not fire")
    check(frames[3]["capacity"][1] > frames[3]["capacity"][0],
          "the guided splitting frame split nothing")
    for k in ("skip_prepass", "collect", "compact_composite",
              "compact_composite_depth", "exact_march", "march",
              "exact_collect", "padded_composite"):
        check(launches[k] > 0, f"a kernel of the Viewer's guided and "
              f"splitting frames never launched: {launches}")

    # the session saved and restored, then the CLI on the saved tree
    with tempfile.TemporaryDirectory() as td:
        state, npz = os.path.join(td, "state.json"), os.path.join(td, "t.npz")
        v.save_state(state, tree_path=npz)
        v2 = P.Viewer(max_tree_capacity=REFINE_CAPACITY)
        v2.load_state(state)
        check(v2.tree.capacity == v.tree.capacity and torch.equal(
            v2.tree.child[:v.tree.capacity], v.tree.child[:v.tree.capacity]),
            "the restored session's tree differs")
        del v, v2
        torch.cuda.empty_cache()
        out = os.path.join(td, "orbit.png")
        t0 = time.perf_counter()
        run = subprocess.run(
            [sys.executable, "-m", "mega_nerf_viewer_tpu_torch.cli", npz,
             "-w", str(WIDTH), "--height", str(HEIGHT), "--frames", "4",
             "--orbit", "-o", out], cwd=os.path.dirname(
                 os.path.abspath(__file__)), capture_output=True, text=True,
            timeout=600)
        cli_s = time.perf_counter() - t0
        log(f"cli --frames 4 --orbit at {WIDTH}x{HEIGHT}: exit "
            f"{run.returncode} in {cli_s:.1f} s; {run.stdout.strip()[-300:]}"
            + (f"; stderr {run.stderr.strip()[-2000:]}" if run.returncode
               else ""))
        check(run.returncode == 0, "the CLI failed")
        for f in range(4):
            png = read_png(os.path.join(td, f"orbit_{f:04d}.png"))
            check(png.shape == (HEIGHT, WIDTH, 4), f"CLI frame {f} {png.shape}")
            check(int(png[..., :3].max()) > 0, f"CLI frame {f} is black")
    return launches


def probe_phase(kernels, dev, report):
    """Phase 17: kernel H, the row-gather probe, at
    benchmarks/dma_gather_probe.py's shapes (M 2^20, N 2^21, W 8 and
    128), bit-equal to its plain version and to the library's gather."""
    from mega_nerf_viewer_tpu_torch.probes import gather_probe as gp
    idx, tables = gp.probe_inputs(21, dev)
    N = idx.shape[0]
    rows = {}
    for W, table in tables:
        got = gp.gather_chunk_sums(table, idx)
        want = gp.gather_chunk_sums_reference(table, idx)
        lib = gp.gather_chunk_sums_library(table, idx)
        check(torch.equal(got, want), f"kernel H differs at W={W}")
        check(torch.equal(lib, want), f"the library's sums differ at W={W}")
        ms, by = device_ms(lambda: gp.gather_chunk_sums(table, idx), 20)
        plain = cuda_ms(lambda: gp.gather_chunk_sums_reference(table, idx), 3)
        lib_ms, lib_by = device_ms(
            lambda: gp.gather_chunk_sums_library(table, idx), 5)
        b, b_by = bound_ms(gp.bound_bytes(N, W) + nbytes(got), N * W)
        log(f"kernel gather_chunk_sums W={W} (M {table.shape[0]}, N {N}): "
            f"bit-equal; {ms:.4f} ms on the device ({by}), "
            f"{ms * 1e6 / N:.4f} ns/row; library (index_select and the sum) "
            f"{lib_ms:.4f} ms ({lib_by}); plain {plain:.2f} ms; bound "
            f"{b:.4f} ms by {b_by}")
        rows[W] = dict(ms=ms, ms_by=by, plain_ms=plain, bound_ms=b,
                       bound_by=b_by, library_ms=lib_ms)
        del got, want, lib
    del idx, tables
    torch.cuda.empty_cache()
    report.append(dict(
        name="gather_chunk_sums", route="cuda",
        source="mega_nerf_viewer_tpu_torch/csrc/gather_probe.cu",
        replaces="benchmarks/dma_gather_probe.py:54", max_abs_err=0.0,
        width=8, **rows[8], w128=rows[128]))


class SameDraws:
    """Within the block, the Viewer's refinement takes its uniform draws
    from one CPU generator (seed 0) as ``rnd``, so that a session on the
    card and one on the CPU fill their splits from the same numbers (the
    two devices' generators draw differently)."""

    def __init__(self, refine):
        self.refine = refine
        self.saved = (refine.expand_voxels, refine.get_more_samples)

    def __enter__(self):
        refine = self.refine
        expand, resample = self.saved
        gen = torch.Generator().manual_seed(0)

        def draw(shape, dev):
            return torch.rand(shape, generator=gen).to(dev)

        def expand_same(tree, model, opt, split_vote, tracker, **kw):
            K = len(refine.aggregate_split_votes(split_vote,
                                                 opt.split_batch_size))
            return expand(tree, model, opt, split_vote, tracker, rnd=draw(
                (K * tree.N3, opt.samples_per_corner, 3), tree.device))

        def resample_same(tree, model, opt, sample_vote, **kw):
            K = len(refine.aggregate_sample_votes(sample_vote,
                                                  opt.split_batch_size))
            return resample(tree, model, opt, sample_vote, rnd=draw(
                (K, opt.samples_per_corner, 3), tree.device))

        refine.expand_voxels = expand_same
        refine.get_more_samples = resample_same
        return self

    def __exit__(self, *exc):
        self.refine.expand_voxels, self.refine.get_more_samples = self.saved


def small_viewer(P, dev):
    """Phase 18: a small Viewer session (64x48, sphere trees) on the card
    and on the CPU: parked and orbit frames, guided frames, split frames
    and guided split frames.  On every frame the hints or sample counts,
    orders, segments and capacity are equal and the frames within 1e-5;
    refined data within one f16 ulp, and split frames within 1e-5 while
    the data they render stays bit-equal."""
    from mega_nerf_viewer_tpu_torch.ops import refine

    def cam():
        c = P.Camera(64, 48, 50.0)
        c.center = np.asarray((-1.5, 0.1, 1.4), np.float32)
        c._update()
        return c

    def host(x):
        return x.cpu() if isinstance(x, torch.Tensor) else torch.as_tensor(x)

    def split_viewer(d, **opt_kw):
        v = P.Viewer(P.sphere_tree(basis_dim=1, depth=3, max_capacity=400,
                                   device=d), camera=cam(),
                     options=P.RenderOptions(use_splitting=True,
                                             split_batch_size=64,
                                             need_viewdir=True, **opt_kw),
                     model=P.MegaNeRFModel.synthetic(
                         data_dim=4, n_clusters=4, need_viewdir=True,
                         device=d), device=d)
        v.fast_chunk_size = 256
        return v

    runs = []
    for d in ("cpu", dev):
        rec = dict(voxel=[], guided=[], split=[], guided_split=[])
        # parked and orbit frames
        v = P.Viewer(P.sphere_tree(basis_dim=4, depth=5, device=d),
                     camera=cam(), device=d)
        v.fast_chunk_size = 256
        for i in range(5):
            if i >= 2:
                orbit_step(v.camera, 12)
            img = host(v.render(fetch=False))
            rec["voxel"].append((img, host(v._hints_packed),
                                 [host(t) for t in v._ray_order],
                                 list(v._segments)))
        # guided frames: a stop, a reuse, a moved pose
        gopt = P.RenderOptions(use_guided_sampling=True,
                               max_guided_samples=16, need_viewdir=True)
        v = P.Viewer(P.sphere_tree(basis_dim=1, depth=4, max_capacity=20000,
                                   device=d), camera=cam(), options=gopt,
                     model=P.MegaNeRFModel.synthetic(
                         data_dim=4, n_clusters=4, need_viewdir=True,
                         device=d), device=d)
        v.fast_chunk_size = 256
        for i in range(3):
            if i == 2:
                orbit_step(v.camera, 12)
            img = host(v.render(fetch=False))
            cache = v._guided_cache[0]
            rec["guided"].append((img, host(cache["num_samples"]),
                                  [host(t) for t in v._guided_order],
                                  v._guided_segments))
        # split frames, then guided split frames (the exact collect and
        # the padded compositor), each from the same draws
        for key, kw in (("split", {}), ("guided_split", dict(
                use_guided_sampling=True, max_guided_samples=16))):
            v = split_viewer(d, **kw)
            with SameDraws(refine):
                for i in range(4):
                    img = host(v.render(fetch=False))
                    t = v.tree
                    rec[key].append((img, t.capacity, v._prune_happened,
                                     host(t.child), host(t.data)))
        runs.append(rec)
    cpu, card = runs

    for i, (a, b) in enumerate(zip(cpu["voxel"], card["voxel"])):
        n_bad = int((a[1] != b[1]).sum())
        err = float((a[0] - b[0]).abs().max())
        log(f"small viewer frame {i}: {n_bad} rays with other hints, max "
            f"abs diff {err:.3e}")
        check(n_bad == 0, f"card and CPU hints differ at frame {i}")
        check(err <= 1e-5, f"card and CPU viewer frames differ at frame {i}")
        check(all(torch.equal(x, y) for x, y in zip(a[2], b[2]))
              and a[3] == b[3], f"card and CPU orders or segments differ at "
              f"frame {i}")
    for i, (a, b) in enumerate(zip(cpu["guided"], card["guided"])):
        n_bad = int((a[1] != b[1]).sum())
        err = float((a[0] - b[0]).abs().max())
        log(f"small viewer guided frame {i}: {n_bad} rays with other sample "
            f"counts, max abs diff {err:.3e}")
        check(n_bad == 0, f"card and CPU sample counts differ at guided "
              f"frame {i}")
        check(err <= 1e-5, f"card and CPU guided viewer frames differ at "
              f"frame {i}")
        check(all(torch.equal(x, y) for x, y in zip(a[2], b[2]))
              and a[3] == b[3], f"card and CPU guided orders or segments "
              f"differ at frame {i}")
    for key in ("split", "guided_split"):
        exact_data = True
        for i, (a, b) in enumerate(zip(cpu[key], card[key])):
            err = float((a[0] - b[0]).abs().max())
            ulp = int((a[4].view(torch.int16).int()
                       - b[4].view(torch.int16).int()).abs().max())
            log(f"small viewer {key} frame {i}: capacity {b[1]} (CPU "
                f"{a[1]}), pruned {b[2]}, max abs diff {err:.3e}, data "
                f"within {ulp} f16 ulp")
            check(a[1] == b[1] and a[2] == b[2] and torch.equal(a[3], b[3]),
                  f"card and CPU trees differ after {key} frame {i}")
            check(ulp <= 1, "card and CPU data differ by more than one f16 "
                  "ulp")
            if exact_data:
                # a frame rendered on bit-equal data
                check(err <= 1e-5, f"card and CPU {key} frames differ by "
                      f"{err}")
            exact_data = exact_data and ulp == 0
        check(cpu[key][-1][1] > cpu[key][0][1], f"no split happened ({key})")


if __name__ == "__main__":
    sys.exit(main())
