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
  session on the card against the CPU;
* the moving camera (phase 19): the Viewer at 1080p under the device
  policy (a 12-pose orbit, each pose against a fresh frame, the budgets
  starved once so that the gated fallback march of kernel A is taken),
  the async policy with the re-hint and the dilate motion modes on
  ``benchmarks/motion1080p.py``'s 24 poses at 3 degrees (each pose off a
  fresh frame on no more pixels than its own flags report, then parked
  frames against fresh ones), the turbo map (parked within 1e-3 of phase
  4's frame with fewer march steps, then an orbit against fresh turbo
  frames) and chunk-exact budgets (within 1e-6 of phase 4's frame); the
  device-fallback frame and the stride-2 motion frame run under sync
  debug mode "error"; then kernel A's gated launch, closed and taken,
  against its plain version;
* the rest of the user-facing path (phase 20): foveated frames at f = 4
  and 2 against f = 1 on ``benchmarks/foveated1080p.py``'s protocol (the
  centre window against the f = 1 frame, the periphery block-constant),
  a foveated guided stop (kernels C and D on the stop only) and a moved
  guided pose gated off, the grid frame (kernel E with the overlay depth
  as each ray's ``tmax``; the cached overlay, an orbit, a cube mesh, and a
  96x54 grid frame against the CPU), ``WebViewer(port=0)`` in-process (the
  served 1080p frame against ``render_rgba8``, 12 events read back, grid
  and foveation edits) and ``cli --serve 0`` in a subprocess, a
  ``trace()`` holding the kernels' names, and the native loader built from
  ``native/nerfview_native.cpp`` and held against numpy;
* multi-device frames and the eager TorchScript fallback (phase 21): on
  the scenes of phases 4, 8 and 12, every sharded path of
  ``mega_nerf_viewer_tpu_torch.parallel`` (the exact frame with visit marks,
  the fast frame, the segmented frame with the stride and the chunk-exact
  deals and sorted output, three re-hint motion poses, the guided frame,
  the frame-refine step) at a world of one under NCCL in-process, each
  against the single-device frame of the same pose, with the collectives'
  share of a frame from the profiler; a container that does not convert,
  loaded through the fallback, its query, the host guided invalidation at
  1080p (kernel G's padded composite) and a Viewer guided frame;
  ``_query_grouped`` beside ``query_grouped``; ``cli --sharded`` in a
  subprocess; then the same sharded paths at a world of two, two gloo
  processes sharing the card (this script started again with
  ``--sharded-rank``), gloo's collectives on CUDA tensors checked first,
  both ranks' outputs bit-equal;
* the Viewer's execution switches (phase 22), each turned off against the
  default at 1080p on the scenes of phases 15 and 16: ``use_prepass`` (a
  parked frame, bit-equal, kernel B not launched), ``use_fast_path`` (a
  parked frame through kernel E, guided stops through kernels F and G),
  ``use_device_order`` (phase 15's orbit under sync, each pose against a
  fresh frame, redos counted), ``use_guided_segments`` (stops in one
  ordered collect launch, equal to the segmented stops),
  ``use_dynamic_knobs`` and ``use_pallas_composite`` (frames equal to the
  default), and foveation at f = 2 with the prepass off (B not launched in
  the subs);
* the aerial artifact (phase 23): ``gen_fixtures.make_big_scene_npz``'s
  175,656-chunk SH4 tree of depth 9, built without JAX
  (``bench_torch.aerial_artifact``) and loaded by ``N3Tree.open``; the
  committed goldens (the exact 160x160 frame through kernel E, the fast
  512x512 frame through A and B), ``bench.py``'s 1080p protocol with
  chunk-exact budgets, A and B against their plain versions on its rays,
  the exact frame and a level-7 map (A's resumed descent) against the
  leaf-map frame, and the three frames' times (and the leaf-map frame in
  ray order) with A's, B's and E's alone;
* ``bench_torch.py`` (phase 24), the port's benchmark entry point: its
  timed loop under sync debug mode "error" on the shell and the aerial
  artifact, then ``python3 bench_torch.py`` with no arguments in a fresh
  process, its one JSON line checked and printed;
* the benchmark scripts and the examples (phase 25): each
  ``benchmarks_torch/`` script at its defaults in a fresh process (its one
  JSON line with the JAX script's keys less the named drops, no ``smoke``
  or ``error``, the kernels it reaches launched, its invariant: equal
  ordered and segmented sample counts, every parity probe within 1e-3,
  hint rebuilds, refinement growth, one device), then
  ``examples/quickstart_torch.py`` (every PNG written) and
  ``examples/multihost_render_torch.py`` as two gloo ranks sharing the
  card (this script started again with ``--multihost-rank``), both ranks'
  frames against the single-device frame; each line logged with the
  script's wall seconds beside the card's name and power limit.  In this
  process, uncounted: ``orbit4k.py``'s first pose at 3840x2160 (its hint
  frame and its settled sharded frame) and ``refine_throughput.py``'s
  vote frame, each through the script's own calls with kernels A and B
  and again with their plain versions on the same card inputs;
* the motion probes (phase 26): each ``tools_torch/`` probe at its
  defaults in a fresh process, its lines forwarded: ``motion_phase_timing.py``
  (stages A-G of the 1080p motion loop, each alone, device and host ms and
  launches), ``motion_viewer_probe.py`` (the Viewer's moved poses split by
  its wrapped calls: re-hint poses into ``motion``, dilate poses into
  ``dilate``, ``order`` and ``frame``; the headroom experiment) and
  ``probe_motion_margin.py`` on phase 23's aerial artifact (the world-of-one
  sharded re-hint pose at margin 1 and 0); then, in this process and
  uncounted, ``motion_phase_timing.py``'s C3 frame against the same call
  with kernels A and B swapped for their plain versions;
* the depth-11 regime (phase 27): ``gen_fixtures.make_huge_scene_npz``'s
  2,817,022-chunk SH4 tree of depth 11, built without JAX into
  ``build/aerial_sh4_d11.npz`` (an earlier run's file is reused when it
  holds that tree); its level-10 leaf map (``deep_levels``
  1, rows [2^30, 2] i32), the turbo map and a level-9 map, each build's
  seconds and peak memory; ``bench.py``'s 1080p protocol on it, A and B
  against their plain versions, the level-10 frame bit-equal to the
  level-9 frame and to E's exact frame of a 256x256 crop (E against its
  plain version there), ten alternating pairs of the level-10 and level-9
  frames and of pixel and ray order; one guided stop (C and D against
  their plain versions); the Viewer's parked frames, async re-hint poses
  (each exact outside its flagged rays, the truncation logged against the
  tolerance at the default flag interval and held within it with the
  flags read every pose), a splitting frame and the level-10 rebuild
  after it; then ``bench_torch.py`` and
  ``tools_torch/probe_motion_margin.py`` on the artifact in fresh
  processes.

Each path runs with the launch counts set to 0 just before it and read
just after; a kernel of the path that never launched fails the run.  It
checks that the frames are finite and agree with the plain CPU path on
small frames, and prints one JSON line listing the kernels (launches,
error, times, bounds) and, last, ``{"ok": true, "device": {...}}``.  Any
failed check raises; there is no CPU fallback.  It needs no network.
"""

import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time
from types import SimpleNamespace

import numpy as np
import torch

from bench_torch import AERIAL_DEPTH, aerial_artifact

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
ROOT = os.path.dirname(os.path.abspath(__file__))
# the aerial artifact (tests/fixtures/gen_fixtures.py make_big_scene_npz)
# and gen_fixtures.aerial_camera()'s pose
AERIAL_FOCAL = 150.0
AERIAL_CENTER = (-0.9, 1.1, 1.5)
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
# kernels B's, G's, E's and F's device ms in their first designs (B and G
# one thread per ray, E and F the descent from the root at every step), as
# PERF.md records them for an NVIDIA H100 80GB HBM3 at 700 W; printed
# beside this run's
FIRST_DESIGN_MS = {"skip_prepass": 0.1326, "padded_composite real": 0.4694,
                   "padded_composite synthetic": 1.0098,
                   "exact_march": 0.3522, "exact_march marks": 0.4553,
                   "exact_collect": 1.0506}


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


def device_events(fn, n, tries=5):
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


def aerial_camera(cls, w, h):
    """``gen_fixtures.aerial_camera()``'s pose (160x160, f = 150) at
    ``w`` x ``h``, the focal length scaled with the width."""
    cam = cls(w, h, AERIAL_FOCAL * w / 160.0)
    cam.center = np.asarray(AERIAL_CENTER, np.float32)
    cam.v_back = cam.center / np.linalg.norm(cam.center)
    cam._update()
    return cam


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--sharded-rank"]:
        # a rank of phase 21's two-rank run, started by phase 21 itself
        return sharded_rank_main(int(sys.argv[2]), sys.argv[3], sys.argv[4])
    if sys.argv[1:2] == ["--multihost-rank"]:
        # a rank of phase 25's multihost example, started by phase 25
        return multihost_rank_main(int(sys.argv[2]), sys.argv[3],
                                   sys.argv[4])
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
        f"{plain_b:.2f} ms, bound {bb:.4f} ms by {bb_by}; "
        f"{100 * bb / ms_b:.0f}% of the bound; the first design "
        f"{FIRST_DESIGN_MS['skip_prepass']} ms)")
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
    motion_launches = motion_phase(P, kernels, dev, voxel_ref, report)
    del voxel_ref
    torch.cuda.empty_cache()
    viewer_guided_launches = viewer_guided_phase(P, kernels, dev, report)
    probe_phase(kernels, dev, report)
    small_viewer(P, dev)
    torch.cuda.empty_cache()
    rest_launches = rest_phase(P, kernels)
    torch.cuda.empty_cache()
    sharded_launches = sharded_phase(P, kernels, dev)
    torch.cuda.empty_cache()
    switches_launches = switches_phase(P, kernels)
    torch.cuda.empty_cache()
    aerial_launches = aerial_phase(P, kernels, dev, smi)
    torch.cuda.empty_cache()
    bench_launches = bench_phase(
        dev, os.path.join(ROOT, "build", "aerial_sh4_d9.npz"))
    torch.cuda.empty_cache()
    scripts_launches = scripts_phase(P, kernels, smi)
    torch.cuda.empty_cache()
    probes_launches = probes_phase(
        kernels, smi, os.path.join(ROOT, "build", "aerial_sh4_d9.npz"))
    torch.cuda.empty_cache()
    deep_launches = deep_phase(P, kernels, dev)

    # launches: each path's own run (phases 4, 8, 12, 15, 16, 19, 20, 21,
    # 22, 23, 24, 25, 26 and 27), summed over the paths for the kernels that
    # several paths run; kernel H is on no path (0)
    for k in report:
        k["launches"] = sum(run.get(k["name"], 0) for run in (
            frame_launches, guided_launches, refine_launches,
            viewer_launches, viewer_guided_launches, motion_launches,
            rest_launches, sharded_launches, switches_launches,
            aerial_launches, bench_launches, scripts_launches,
            probes_launches, deep_launches))
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
        regs = kernels.exact_attributes()
        log(f"kernel exact_march: {ms_e:.4f} ms on the device ({by_e}), "
            f"{ms_ev:.4f} ms with visit marks ({by_ev}); plain "
            f"{plain_e:.2f} ms, bound {be:.4f} ms by {be_by}, "
            f"{100 * be / ms_e:.0f}% of it (first design "
            f"{FIRST_DESIGN_MS['exact_march']} ms, "
            f"{FIRST_DESIGN_MS['exact_march marks']} with marks); registers "
            f"and local bytes per thread {regs['exact_march']} with the "
            f"restarted descent, {regs['exact_march root']} with the "
            f"descent from the root")
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


def padded_frame_steps(kernels, dev, cam, opt, cache, comp_ms):
    """Where the padded frame's time goes: each step of ``composite_frame``
    on the padded cache run alone, back to back (CUDA events, so each
    step's host launch time counts where it exceeds its device time), and
    the frame's rest.  The cache is f32 and contiguous as built, so the
    wrapper's ``float().contiguous()`` copies nothing (checked)."""
    from mega_nerf_viewer_tpu_torch.ops import padded_composite as pc
    from mega_nerf_viewer_tpu_torch.ops.rays import rodrigues, screen2worlddir
    from mega_nerf_viewer_tpu_torch.ops.sh import masked_sh_basis
    res, z, ns = cache["results"], cache["z_vals"], cache["num_samples"]
    check(res.float().contiguous().data_ptr() == res.data_ptr()
          and z.float().contiguous().data_ptr() == z.data_ptr()
          and ns.dtype == torch.int32 and ns.is_contiguous(),
          "the padded cache is copied on every frame")
    transform = torch.as_tensor(cam.transform, dtype=torch.float32,
                                device=dev)
    dirs, _ = screen2worlddir(WIDTH, HEIGHT, cam.fx, cam.fy, cam.cx, cam.cy,
                              transform)
    vdirs = rodrigues(opt.rot_dirs, dirs)
    basis = masked_sh_basis(1, vdirs, *opt.basis_minmax).contiguous()
    steps = {
        "transform upload": lambda: torch.as_tensor(
            cam.transform, dtype=torch.float32, device=dev),
        "screen2worlddir": lambda: screen2worlddir(
            WIDTH, HEIGHT, cam.fx, cam.fy, cam.cx, cam.cy, transform),
        "rodrigues": lambda: rodrigues(opt.rot_dirs, dirs),
        "masked_sh_basis": lambda: masked_sh_basis(
            1, vdirs, *opt.basis_minmax).contiguous(),
        "padded_composite (kernel G)": lambda: kernels.padded_composite(
            res, z, ns, basis, pc.MODE_SH),
    }
    ms = {k: uncounted(kernels, lambda f=f: cuda_ms(f, N_FRAMES))
          for k, f in steps.items()}
    rest = comp_ms - sum(ms.values())
    log("padded frame steps (each alone, ms): " + ", ".join(
        f"{k} {v:.3f}" for k, v in ms.items())
        + f"; sum {sum(ms.values()):.3f} of {comp_ms:.3f} ms/frame, rest "
        f"{rest:.3f}")


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
    regs = kernels.exact_attributes()["exact_collect"]
    log(f"kernel exact_collect: {ms_f:.4f} ms on the device ({by_f}; with "
        f"the wrapper's fills; plain {plain_f:.2f} ms, bound {bf:.4f} ms "
        f"by {bf_by}, {100 * bf / ms_f:.0f}% of it (first design "
        f"{FIRST_DESIGN_MS['exact_collect']} ms); registers and local bytes "
        f"per thread {regs})")
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
    padded_frame_steps(kernels, dev, cam, opt, cache, comp_ms)
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
            f"({by}; plain {plain:.2f} ms, bound {bg:.4f} ms by {bg_by}; "
            f"{100 * bg / ms:.0f}% of the bound; the first design "
            f"{FIRST_DESIGN_MS['padded_composite ' + name]} ms)")
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


def motion_step(cam, deg):
    """One pose of ``benchmarks/motion1080p.py``'s orbit: a right-button
    drag of ``deg`` degrees about the origin."""
    cam.begin_drag(0.0, 0.0, False, True)
    cam.drag_update(-np.deg2rad(deg) * cam.width / 2.0, 0.0)
    cam.end_drag()


def no_host_sync(fn):
    """``fn()`` under sync debug mode "error": any host sync raises."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")


def motion_phase(P, kernels, dev, voxel_ref, report):
    """Phase 19: the moving camera at 1080p on the voxel scene, through
    the Viewer at the card's chunk size (viewer.py:560-1127): the device
    policy on a 12-pose orbit with the budgets starved once (the gated
    fallback march), the async policy with the re-hint and the dilate
    motion modes on motion1080p.py's 24 poses at 3 degrees, the turbo map
    parked and on an orbit, and chunk-exact budgets on the settled hints.
    Then kernel A's gated launch, closed and taken, against its plain
    version.  Returns the launch counts of the path's run."""
    from mega_nerf_viewer_tpu_torch import viewer as VI
    from mega_nerf_viewer_tpu_torch.ops import accel
    from mega_nerf_viewer_tpu_torch.ops.rays import screen2worlddir_indices

    ref_img = voxel_ref[0]
    tree = P.shell_tree(depth=8, basis_dim=9, sigma_inside=400.0)
    cs = P.device_tuning(dev).chunk_size
    starved = [(0.75, 0), (0.25, 1)]

    def viewer(policy, mode="rehint", turbo=False):
        v = P.Viewer(tree, camera=camera(P.Camera, WIDTH, HEIGHT, FOCAL))
        check(v.fast_chunk_size == cs, "the Viewer's chunk is not the card's")
        v.overflow_policy, v.motion_mode, v.use_turbo_map = policy, mode, turbo
        return v

    def fresh(v):
        return uncounted(kernels, lambda: fresh_frame(
            P, v.tree, v._leaf_map, v.camera, v.options, cs, v._skip_table))

    def render(v):
        """(frame, host ms, this frame's seg_overflow sum and fb_overflow,
        or None for a frame that left no flags: a hint frame)."""
        before = v._pending_ov
        img, ms = timed(lambda: v.render(fetch=False))
        p = v._pending_ov
        if p is None or p is before:
            return img, ms, None
        fb = None if p[2] is None else int(VI._host_array(p[2]))
        return img, ms, (int(VI._host_array(p[1]).sum()), fb)

    def parked(v, what, n=N_FRAMES):
        """Twelve frames to settle, each off a fresh frame on no more pixels
        than its flags report (a parked async frame may truncate once: the
        clean-streak budgets of viewer.py:1085-1109 keep the motion order),
        then ``n`` within 1e-6 of the fresh frame."""
        want = fresh(v)
        for _ in range(12):
            img, _, fl = render(v)
            n_diff = int(((img - want).abs() > 1e-6).any(-1).sum())
            check(n_diff <= (0 if fl is None else fl[0]),
                  f"{what}: {n_diff} parked pixels off, flags {fl}")
        worst = 0.0
        for _ in range(n):
            img = v.render(fetch=False)
            worst = max(worst, float((img - want).abs().max()))
        check(worst <= 1e-6, f"{what}: a parked frame differs from a fresh "
              f"frame by {worst}")
        return worst

    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()

    # -- the device policy: every frame right, the fallback on the card
    v = viewer("device")
    v.render(fetch=False)
    img = v.render(fetch=False)
    check(float((img - ref_img).abs().max()) <= 1e-6,
          "the device policy's parked frame differs from phase 4's")
    v._segments, v._pending_ov = list(starved), None
    img, ms_starved, fl = render(v)
    err = float((img - ref_img).abs().max())
    check(fl is not None and fl[0] > 0, "the starved frame did not overflow")
    check(err <= 1e-6, f"the starved frame differs from phase 4's by {err}")
    taken = 1
    poses = []
    for _ in range(12):
        orbit_step(v.camera, 12)
        img, ms, fl = render(v)
        err = float((img - fresh(v)).abs().max())
        check(err <= 1e-6, f"a device-policy pose differs from a fresh frame "
              f"by {err}")
        check(bool(torch.isfinite(img).all()), "non-finite pixels")
        taken += fl is not None and fl[0] > 0
        poses.append(dict(ms=round(ms, 3), flags=fl, err=err))
    med = sorted(p["ms"] for p in poses)[6]
    profile_frames(lambda: (orbit_step(v.camera, 12), v.render(fetch=False)),
                   med, what="device-policy pose")
    log(f"motion, device policy: starved frame {ms_starved:.3f} ms (gated "
        f"fallback taken, each pixel within 1e-6 of phase 4's); 12-pose "
        f"orbit median {med:.3f} ms/pose, fallback taken on {taken} frames; "
        f"each pose against a fresh frame: max abs diff "
        f"{max(p['err'] for p in poses):.3e}; poses {poses}")
    v.render(fetch=False)
    check(v._ray_order is not None, "no ray order after the orbit")
    out = uncounted(kernels, lambda: no_host_sync(
        lambda: P.render_frame_fast_segmented(
            tree, v._leaf_map, v.camera, v.options, order=v._ray_order,
            segments=tuple(starved), chunk_size=cs,
            skip_table=v._skip_table, device_fallback=True,
            return_hints="packed")))
    err = float((out[0] - fresh(v)).abs().max())
    check(bool(out[1].any()) and int(out[2]) == 0 and err <= 1e-6,
          f"the sync-free device_fallback frame: overflow {out[1].tolist()}, "
          f"fb {int(out[2])}, max abs diff {err}")
    log(f"device_fallback frame under sync debug mode 'error': no host "
        f"sync; seg_overflow {out[1].tolist()}, fb_overflow 0, max abs diff "
        f"{err:.3e} against a fresh frame")
    fallback_order = v._ray_order
    del v, out

    # -- the async policy, re-hint and dilate, on motion1080p.py's orbit
    for mode in ("rehint", "dilate"):
        v = viewer("async", mode)
        v.render(fetch=False)
        v.render(fetch=False)
        poses = []
        for _ in range(24):
            motion_step(v.camera, 3.0)
            img, ms, fl = render(v)
            want = fresh(v)
            n_diff = int(((img - want).abs() > 1e-6).any(-1).sum())
            allowed = 0 if fl is None else fl[0]
            check(n_diff <= allowed, f"async {mode} pose: {n_diff} pixels "
                  f"differ from a fresh frame, its flags report {allowed}")
            check(bool(torch.isfinite(img).all()), "non-finite pixels")
            poses.append(dict(ms=round(ms, 3), diff=n_diff, flags=allowed))
        med = sorted(p["ms"] for p in poses)[12]
        profile_frames(lambda: (motion_step(v.camera, 3.0),
                                v.render(fetch=False)),
                       med, what=f"async {mode} pose")
        worst = parked(v, f"async {mode}")
        log(f"motion, async policy, {mode}: 24 poses at 3 deg, median "
            f"{med:.3f} ms/pose; pixels off a fresh frame {sum(p['diff'] for p in poses)} "
            f"in all, never more than the pose's flags; parked again: "
            f"{N_FRAMES} frames within {worst:.3e} of a fresh frame; poses "
            f"{poses}")
        if mode == "rehint":
            motion_step(v.camera, 3.0)
            v.camera._update()
            segs = accel.segments_from_hint_cdf(v._last_cdf, WIDTH * HEIGHT,
                                                margin=1)
            img, ov, _, _, q = uncounted(kernels, lambda: no_host_sync(
                lambda: P.render_frame_motion(
                    tree, v._leaf_map, v.camera, v.options, v._qperm,
                    segments=segs, chunk_size=cs, skip_table=v._skip_table,
                    hint_stride=2)))
            want = fresh(v)
            n_diff = int(((img - want).abs() > 1e-6).any(-1).sum())
            check(n_diff <= int(ov.sum()) and q.shape[0] * 4 == WIDTH * HEIGHT,
                  f"the sync-free motion frame: {n_diff} pixels off, "
                  f"overflow {ov.tolist()}")
            log(f"render_frame_motion(hint_stride=2) under sync debug mode "
                f"'error': no host sync; seg_overflow {ov.tolist()}, "
                f"{n_diff} pixels off a fresh frame")
        del v

    # -- the turbo map: parked within 1e-3 of phase 4's frame, fewer steps
    v = viewer("sync", turbo=True)
    v.render(fetch=False)
    img = v.render(fetch=False)
    err_turbo = float((img - ref_img).abs().max())
    check(err_turbo <= 1e-3, f"the turbo frame differs from phase 4's by "
          f"{err_turbo}")
    ms_turbo = sorted(cuda_ms(lambda: v.render(fetch=False), N_FRAMES)
                      for _ in range(ROUNDS))[ROUNDS // 2]

    def steps_of(leaf_map):
        return int(P.render_frame_fast(
            tree, leaf_map, v.camera, v.options, max_dense=128,
            chunk_size=cs, skip_table=v._skip_table)[2].sum())
    st_turbo = uncounted(kernels, lambda: steps_of(v._leaf_map))
    st_plain = uncounted(kernels, lambda: steps_of(P.build_leaf_map(tree)))
    check(st_turbo < st_plain, f"the turbo map marched {st_turbo} steps, "
          f"the plain map {st_plain}")
    errs = []
    for _ in range(12):
        orbit_step(v.camera, 12)
        img = v.render(fetch=False)
        errs.append(float((img - fresh(v)).abs().max()))
        check(errs[-1] <= 1e-6, f"a turbo pose differs from a fresh turbo "
              f"frame by {errs[-1]}")
    log(f"turbo map: parked {ms_turbo:.3f} ms/frame, against phase 4's "
        f"frame max abs diff {err_turbo:.3e}; march steps {st_turbo} "
        f"(plain map {st_plain}); 12-pose sync orbit against fresh turbo "
        f"frames: max abs diff {max(errs):.3e}")
    del v

    # -- chunk-exact budgets from the settled sorted hints
    v = viewer("sync")
    v.render(fetch=False)
    v.render(fetch=False)
    ms_ladder = sorted(cuda_ms(lambda: v.render(fetch=False), N_FRAMES)
                       for _ in range(ROUNDS))[ROUNDS // 2]
    hints, order = v._hints_packed, v._ray_order
    sc = P.seg_counts_from_hints((hints >> 18)[order[0]], cs)

    def exact_frame():
        return P.render_frame_fast_segmented(
            tree, v._leaf_map, v.camera, v.options, order=order,
            seg_counts=sc, chunk_size=cs, skip_table=v._skip_table,
            return_hints="packed")
    img, ov, ph = exact_frame()
    err_exact = float((img - ref_img).abs().max())
    check(not ov.any() and torch.equal(ph, hints) and err_exact <= 1e-6,
          f"the chunk-exact frame: overflow {ov.tolist()}, max abs diff "
          f"{err_exact}")
    ms_exact = sorted(cuda_ms(exact_frame, N_FRAMES)
                      for _ in range(ROUNDS))[ROUNDS // 2]
    log(f"chunk-exact budgets {sc}: {ms_exact:.3f} ms/frame (the Viewer's "
        f"ladder segments {v._segments}: {ms_ladder:.3f} ms/frame); against "
        f"phase 4's frame max abs diff {err_exact:.3e}, hints equal")
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    log(f"motion path: launches {launches}; peak memory "
        f"{peak / 2**30:.2f} GiB")
    check(launches["skip_prepass"] > 0 and launches["march"] > 0
          and launches["march_gated"] > 0,
          f"a kernel of the motion path never launched: {launches}")
    del v

    # -- kernel A's gated launch, closed and taken, on the fallback's rays
    perm = fallback_order[0]
    n_pad = -(-perm.shape[0] // cs) * cs
    pix = torch.cat([perm, perm[-1:].expand(n_pad - perm.shape[0])])
    cam = camera(P.Camera, WIDTH, HEIGHT, FOCAL)
    opt = P.RenderOptions()
    leaf_map = P.build_leaf_map(tree)
    table = P.build_skip_table(tree, opt.sigma_thresh)
    dirs, cen = screen2worlddir_indices(
        pix, WIDTH, cam.fx, cam.fy, cam.cx, cam.cy,
        torch.as_tensor(cam.transform, device=dev))
    m, _ = accel._prepass(accel.march_inputs(tree, dirs, dirs, cen, opt),
                          table)
    args = (tree, leaf_map, m.cen, m.d, m.invdir, m.delta_scale, m.tmin,
            m.tmax, m.miss, m.basis, m.step_size, m.sigma_thresh,
            m.stop_thresh, accel._FALLBACK_MD, m.use_sh)
    bufs = kernels.march(*args)
    into = (bufs[0], bufs[2], bufs[3])
    closed = torch.zeros(len(starved), dtype=torch.int32, device=dev)
    opened = torch.tensor([1, 0], dtype=torch.int32, device=dev)
    sentinel = tuple(b.clone().fill_(-7) for b in into)
    res = kernels.march(*args, gate=closed, into=sentinel)
    torch.cuda.synchronize()
    check(all(bool((b == -7).all()) for b in sentinel) and int(res[1]) == 0,
          "the closed gate wrote its buffers")
    res = kernels.march(*args, gate=opened, into=sentinel)
    plain = accel.render_rays_fast_reference(*args)
    err_g = float((res[0] - plain[0]).abs().max())
    check(torch.equal(res[2], plain[2]) and torch.equal(res[3], plain[3])
          and int(res[1]) == int(plain[1]) and err_g <= 1e-6
          and all(torch.equal(a, b) for a, b in zip(res, bufs)),
          f"the taken gated march differs: max abs diff {err_g}")
    ms_open, by_open = device_ms(
        lambda: kernels.march(*args, gate=opened, into=into), 20)
    ms_closed, by_closed = device_ms(
        lambda: kernels.march(*args, gate=closed, into=into), 20)
    ms_plain_launch, by_plain = device_ms(lambda: kernels.march(*args), 20)
    plain_g = cuda_ms(lambda: accel.render_rays_fast_reference(*args), 2)
    steps_total = int(res[2].sum())
    shaded = int(res[3].clamp(max=accel._FALLBACK_MD).sum())
    B = m.basis.shape[1]
    bg, bg_by = bound_ms(
        nbytes(m.d, m.invdir, m.delta_scale, m.tmin, m.tmax, m.miss,
               m.basis, res[0], res[2], res[3])
        + 8 * steps_total + 2 * tree.data_dim * shaded,
        MARCH_OPS_PER_STEP * steps_total + (6 * B + 15) * shaded)
    log(f"kernel march_gated ({n_pad} rays, budget {accel._FALLBACK_MD}): "
        f"taken {ms_open:.4f} ms ({by_open}), closed {ms_closed:.4f} ms "
        f"({by_closed}), the ungated launch {ms_plain_launch:.4f} ms "
        f"({by_plain}); plain {plain_g:.2f} ms, bound {bg:.4f} ms by "
        f"{bg_by}; max abs diff {err_g:.3e}, integers equal, bit-equal to "
        f"the ungated launch, the closed gate left its buffers untouched")
    report.append(dict(
        name="march_gated", route="cuda",
        source="mega_nerf_viewer_tpu_torch/csrc/march.cu",
        replaces="mega_nerf_viewer_tpu/ops/accel.py:780",
        max_abs_err=err_g, ms=ms_open, ms_by=by_open, closed_ms=ms_closed,
        plain_ms=plain_g, bound_ms=bg, bound_by=bg_by, library_ms=None))
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
    ev_dd = uncounted(kernels, lambda: cuda_ms(
        lambda: cc.composite_results_compact_kernel(*c_args, o_d, 1, True),
        20))
    b_dd, b_dd_by = depth_bound(total, R)
    log(f"kernel compact_composite (depth, {total} samples, {R} rays): "
        f"{ms_dd:.4f} ms on the device ({by_dd}; {ev_dd:.4f} ms by CUDA "
        f"events around the calls; plain {plain_dd:.2f} ms, bound "
        f"{b_dd:.4f} ms by {b_dd_by}, {100 * b_dd / ms_dd:.0f}% of it)")
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
    and on the CPU: parked and orbit frames, async re-hint poses, a device
    policy frame on starved budgets, guided frames, split frames and guided
    split frames.  On every frame the hints or sample counts,
    orders, segments and capacity are equal and the frames within 1e-5;
    refined data within one f16 ulp, and split frames within 1e-5 while
    the data they render stays bit-equal."""
    from mega_nerf_viewer_tpu_torch import viewer as VI
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
        # the async policy's re-hint poses and the device policy's starved
        # frame (the gated fallback)
        for key, policy in (("rehint", "async"), ("device", "device")):
            v = P.Viewer(P.sphere_tree(basis_dim=4, depth=5, device=d),
                         camera=cam(), device=d)
            v.fast_chunk_size = 256
            v.overflow_policy = policy
            rec[key] = []
            for i in range(5):
                if i == 2 and policy == "device":
                    v._segments = [(0.75, 0), (0.25, 1)]
                elif i >= 2:
                    motion_step(v.camera, 3.0)
                img = host(v.render(fetch=False))
                p = v._pending_ov
                rec[key].append((
                    img, [host(t) for t in v._ray_order],
                    None if v._qperm is None else host(v._qperm),
                    v._segments_motion, v._segments,
                    None if p is None else VI._host_array(p[1])))
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
    for key in ("rehint", "device"):
        for i, (a, b) in enumerate(zip(cpu[key], card[key])):
            err = float((a[0] - b[0]).abs().max())
            log(f"small viewer {key} frame {i}: max abs diff {err:.3e}, "
                f"flags {None if b[5] is None else b[5].tolist()}")
            check(err <= 1e-5, f"card and CPU {key} frames differ at frame "
                  f"{i}")
            check(all(torch.equal(x, y) for x, y in zip(a[1], b[1]))
                  and (a[2] is None) == (b[2] is None)
                  and (a[2] is None or torch.equal(a[2], b[2]))
                  and a[3] == b[3] and a[4] == b[4]
                  and (a[5] is None) == (b[5] is None)
                  and (a[5] is None or np.array_equal(a[5], b[5])),
                  f"card and CPU {key} orders, quarter orders, segments or "
                  f"flags differ at frame {i}")
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


# -- phase 20: the rest of the user-facing path ----------------------
FOV_PROTOCOL = dict(steady_reps=10, warm_poses=3, poses=20, deg=3.0)


def fov_viewer(P, tree, fov):
    """``benchmarks/foveated1080p.py``'s Viewer at the card's chunk: the
    async policy, flags read every 8 frames."""
    v = P.Viewer(tree, camera=camera(P.Camera, WIDTH, HEIGHT, FOCAL))
    v.foveation = fov
    v.overflow_policy = "async"
    v.overflow_check_interval = 8
    return v


def fov_window(f, frac=0.5):
    """(rows, cols) slices of the foveated centre window at 1080p."""
    q = 2 * f
    w1 = max(q, int(WIDTH * frac) // q * q)
    h1 = max(q, int(HEIGHT * frac) // q * q)
    x0, y0 = (WIDTH - w1) // 2, (HEIGHT - h1) // 2
    return slice(y0, y0 + h1), slice(x0, x0 + w1)


def fov_run(v):
    """foveated1080p.py's protocol: two warm frames and ``steady_reps``
    parked frames, then ``warm_poses`` orbit poses and ``poses`` timed
    ones at ``deg`` degrees; host clock, the card synchronized once per
    timed run.  Returns (parked ms/frame, the parked frame, pose ms, the
    poses' frames all finite)."""
    pr = FOV_PROTOCOL
    v.render(fetch=False)
    v.render(fetch=False)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(pr["steady_reps"]):
        img = v.render(fetch=False)
    torch.cuda.synchronize()
    ms_parked = (time.perf_counter() - t) * 1e3 / pr["steady_reps"]
    parked = img.clone()
    for _ in range(pr["warm_poses"]):
        motion_step(v.camera, pr["deg"])
        v.render(fetch=False)
    finite = []
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(pr["poses"]):
        motion_step(v.camera, pr["deg"])
        finite.append(torch.isfinite(v.render(fetch=False)).all())
    torch.cuda.synchronize()
    ms_pose = (time.perf_counter() - t) * 1e3 / pr["poses"]
    return ms_parked, parked, ms_pose, bool(torch.stack(finite).all())


def read_launches(kernels, names, what):
    """The counts since the last reset; fails unless each of ``names``
    launched."""
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    missing = [n for n in names if launches[n] == 0]
    check(not missing, f"{what}: {missing} never launched: {launches}")
    return launches


def add_launches(total, run):
    for k, n in run.items():
        total[k] = total.get(k, 0) + n


def cube_mesh(mesh_mod, center, half, color=(0.9, 0.2, 0.1)):
    """A cube's 12 triangles around ``center``, one colour."""
    c = np.asarray(center, np.float64)
    corners = np.array([[x, y, z] for x in (-1, 1) for y in (-1, 1)
                        for z in (-1, 1)], np.float64) * half + c
    quads = [(0, 1, 3, 2), (4, 6, 7, 5), (0, 4, 5, 1), (2, 3, 7, 6),
             (0, 2, 6, 4), (1, 5, 7, 3)]
    verts = []
    for q in quads:
        n = np.cross(corners[q[1]] - corners[q[0]],
                     corners[q[2]] - corners[q[0]])
        n = n / np.linalg.norm(n)
        for tri in ((q[0], q[1], q[2]), (q[0], q[2], q[3])):
            for i in tri:
                verts.append(np.concatenate([corners[i], color, n]))
    return mesh_mod.Mesh(vert=np.asarray(verts, np.float32), face_size=3)


def foveation_path(P, kernels, tree):
    """Foveated frames at f = 4 and 2 against f = 1 (foveated1080p.py).
    Returns the launch counts of the foveated runs."""
    base = uncounted(kernels, lambda: fov_run(fov_viewer(P, tree, 1)))
    full = base[1]
    log(f"foveation f=1: parked {base[0]:.3f} ms/frame, 3-degree orbit "
        f"{base[2]:.3f} ms/pose ({FOV_PROTOCOL})")
    check(base[3], "non-finite f=1 motion frames")
    kernels.reset_launch_counts()
    rows = {}
    for f in (4, 2):
        v = fov_viewer(P, tree, f)
        ms_parked, img, ms_pose, finite = fov_run(v)
        check(v._fov_sub is not None, f"f={f}: the foveated route not taken")
        ys, xs = fov_window(f)
        err = float((img[ys, xs] - full[ys, xs]).abs().max())
        top = img[:ys.start // f * f]
        blk = top.reshape(top.shape[0] // f, f, WIDTH // f, f, 4)
        blocky = bool((blk == blk[:, :1, :, :1]).all())
        rays = sum(s.camera.width * s.camera.height for s in v._fov_sub)
        log(f"foveation f={f}: {rays} rays ({100 * rays / (WIDTH * HEIGHT):.1f}"
            f"% of the frame; subs {[(s.camera.width, s.camera.height, s.fast_chunk_size) for s in v._fov_sub]}); "
            f"parked {ms_parked:.3f} ms/frame ({ms_parked / base[0]:.2f}x "
            f"f=1), orbit {ms_pose:.3f} ms/pose ({ms_pose / base[2]:.2f}x "
            f"f=1); centre window against the parked f=1 frame max abs diff "
            f"{err:.3e}; periphery {f}x{f} block-constant {blocky}")
        check(err <= 1e-4, f"f={f}: the centre window differs from the f=1 "
              f"frame by {err}")
        check(blocky, f"f={f}: the periphery is not block-constant")
        check(finite, f"f={f}: non-finite motion frames")
        rows[f] = (ms_parked, ms_pose)
        profile_frames(lambda: v.render(fetch=False), ms_parked,
                       what=f"f={f} parked frame")
        del v
    return read_launches(kernels, ("skip_prepass", "march"), "foveation")


def foveated_guided_path(P, kernels):
    """A guided stop at f = 2 on phase 16's guided scene: kernels C and D
    on the stop and not on the reuse frames, the centre window against the
    Viewer's exact guided frame, a moved pose gated off, and the stop when
    the camera settles.  Returns the launch counts of the foveated frames
    (the gated pose's are not counted)."""
    tree = P.shell_tree(depth=8, basis_dim=1, sigma_inside=400.0,
                        max_capacity=2 * SHELL_CHUNKS)
    model = P.MegaNeRFModel.synthetic(data_dim=int(tree.data_dim), seed=0,
                                      **GUIDED_MODEL)
    opt = P.RenderOptions(max_guided_samples=GUIDED_S, need_viewdir=True,
                          use_guided_sampling=True)

    def viewer(f):
        v = P.Viewer(tree, camera=camera(P.Camera, WIDTH, HEIGHT, FOCAL),
                     options=opt, model=model)
        v.foveation = f
        return v

    ref = uncounted(kernels, lambda: viewer(1).render(fetch=False))
    v = viewer(2)
    v.render(fetch=False)     # the first pose counts as moved: not foveated
    check(v._fov_sub is None and v._fov_motion_gated,
          "the first guided pose was foveated")
    kernels.reset_launch_counts()
    img, stop_ms = timed(lambda: v.render(fetch=False))
    stop = read_launches(kernels, ("collect", "compact_composite"),
                         "the foveated guided stop")
    check(v._fov_sub is not None, "the guided stop was not foveated")
    reuse = []
    for _ in range(3):
        img2, ms = timed(lambda: v.render(fetch=False))
        reuse.append(round(ms, 3))
    torch.cuda.synchronize()
    check(kernels.LAUNCHES == stop, f"a reuse frame launched a kernel: "
          f"{kernels.LAUNCHES} after {stop}")
    check(torch.equal(img, img2), "a reuse frame differs from the stop")
    ys, xs = fov_window(2)
    err = float((img[ys, xs] - ref[ys, xs]).abs().max())
    check(err <= 1e-4, f"the guided centre window differs from the exact "
          f"guided frame by {err}")
    orbit_step(v.camera, 12)
    moved, moved_ms = uncounted(kernels, lambda: timed(
        lambda: v.render(fetch=False)))
    check(v._fov_motion_gated and v._fov_subs_stale,
          "the moved guided pose was not gated off")
    check(bool(torch.isfinite(moved).all()), "non-finite moved guided frame")
    # the camera settles: the second stop of the subs, on their orders
    img, stop2_ms = timed(lambda: v.render(fetch=False))
    check(v._fov_sub is not None and not v._fov_subs_stale,
          "the settled guided pose was not foveated")
    check(kernels.LAUNCHES["collect"] > stop["collect"],
          "the settled stop did not collect")
    rv = viewer(1)
    orbit_step(rv.camera, 12)
    ref = uncounted(kernels, lambda: rv.render(fetch=False))
    err2 = float((img[ys, xs] - ref[ys, xs]).abs().max())
    check(err2 <= 1e-4, f"the settled centre window differs from the exact "
          f"guided frame by {err2}")
    log(f"foveated guided stop (f=2): {stop_ms:.3f} ms (the subs' first, "
        f"with no ray order), launches "
        f"{ {k: n for k, n in stop.items() if n} }; reuse frames {reuse} ms "
        f"with no launch; centre window against the exact guided frame max "
        f"abs diff {err:.3e}; a moved pose gated off, {moved_ms:.3f} ms; the "
        f"settled stop (the subs' second) {stop2_ms:.3f} ms, centre window "
        f"max abs diff {err2:.3e}")
    return read_launches(kernels, ("collect", "compact_composite"),
                         "the foveated guided stops")


def grid_path(P, kernels, tree):
    """The grid frame at the default grid_max_depth, the cached overlay, a
    3-pose orbit and a cube mesh.  Returns the launch counts."""
    from mega_nerf_viewer_tpu_torch.utils import mesh as M
    from mega_nerf_viewer_tpu_torch.utils import wireframe as W

    cam = camera(P.Camera, WIDTH, HEIGHT, FOCAL)
    depth = P.RenderOptions().grid_max_depth
    t = time.perf_counter()
    boxes = tree.gen_wireframe(depth)
    walk_ms = (time.perf_counter() - t) * 1e3
    t = time.perf_counter()
    _, line_depth = W.rasterize_boxes(boxes, cam)
    raster_ms = (time.perf_counter() - t) * 1e3
    v = P.Viewer(tree, camera=cam)
    v.options = v.options.replace(show_grid=True)
    kernels.reset_launch_counts()
    first, first_ms = timed(lambda: v.render(fetch=False))
    check(kernels.LAUNCHES["exact_march"] > 0,
          "the grid frame did not run kernel E")
    cache = v._grid_cache
    img, parked_ms = timed(lambda: v.render(fetch=False))
    check(v._grid_cache is cache and len(v.timer.records["gen_wire"]) == 1,
          "the parked grid frame drew the overlay again")
    check(torch.equal(img, first), "the parked grid frame changed")
    lines = int((line_depth < 1e9).sum())
    check(lines > WIDTH * HEIGHT // 1000 and bool(torch.isfinite(img).all()),
          f"the grid frame: {lines} line pixels")
    poses = []
    for _ in range(3):
        motion_step(cam, 3.0)
        img, ms = timed(lambda: v.render(fetch=False))
        check(bool(torch.isfinite(img).all()), "non-finite grid pose")
        poses.append(round(ms, 3))
    # a cube of 12 triangles in front of the camera, with the grid
    before = img
    v.meshes.append(cube_mesh(M, cam.center - 0.6 * cam.v_back, 0.05))
    img, mesh_ms = timed(lambda: v.render(fetch=False))
    changed = int(((img - before).abs() > 1e-3).any(-1).sum())
    check(changed > WIDTH * HEIGHT // 1000,
          f"the cube changed only {changed} pixels")
    gen_ms = v.timer.records["gen_wire"]
    log(f"grid frame (grid_max_depth {depth}): {len(boxes)} boxes, "
        f"{lines} line pixels; host gen_wire {[round(1e3 * x, 1) for x in gen_ms]} "
        f"ms (the walk {walk_ms:.1f} ms, the line raster {raster_ms:.1f} ms); "
        f"first frame {first_ms:.3f} ms, parked {parked_ms:.3f} ms (overlay "
        f"cached), 3-degree orbit poses {poses} ms; the cube mesh "
        f"{mesh_ms:.3f} ms, {changed} pixels changed")
    launches = read_launches(kernels, ("exact_march",), "the grid frame")
    # a visit-tracked grid frame: kernel E with marks
    _, res = uncounted(kernels, lambda: v._render_with_grid(True))
    check(int(res.visited.sum()) > 1, "the tracked grid frame marked nothing")
    # 96x54 on the card against the plain path on the CPU
    small = P.shell_tree(depth=6, basis_dim=9, sigma_inside=400.0,
                         device="cpu")
    outs = []
    for t in (small, P.tree_from_numpy(
            **{k: getattr(small, k).numpy() for k in
               ("data", "child", "parent", "sample_counts", "scale",
                "offset")},
            capacity=small.capacity, data_format=small.data_format)):
        sv = P.Viewer(t, camera=camera(P.Camera, 96, 54, FOCAL * 96 / WIDTH),
                      device=t.device)
        sv.options = sv.options.replace(show_grid=True)
        sv.meshes.append(cube_mesh(M, sv.camera.center
                                   - 0.6 * sv.camera.v_back, 0.05))
        outs.append(uncounted(kernels, lambda: sv.render(fetch=False)).cpu())
    err = float((outs[0] - outs[1]).abs().max())
    log(f"96x54 grid and mesh frame, card vs CPU plain path: max abs diff "
        f"{err:.3e}")
    check(err <= 1e-6, f"card and CPU grid frames differ by {err}")
    return launches


def web_path(P, kernels, tree):
    """WebViewer(port=0) in this process over a 1080p Viewer, then
    ``cli --serve 0`` in a subprocess.  Returns the launch counts of the
    served frames."""
    import urllib.request
    from mega_nerf_viewer_tpu_torch.web import WebViewer

    def get(url):
        with urllib.request.urlopen(url, timeout=120) as r:
            return r.status, dict(r.headers), r.read()

    def post(url, payload):
        req = urllib.request.Request(
            url, data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            return json.loads(r.read())

    def raw(base, after):
        status, hdrs, body = get(f"{base}/frame.bin?after={after}")
        check(status == 200, f"/frame.bin answered {status}")
        check(len(body) == WIDTH * HEIGHT * 4, f"/frame.bin gave "
              f"{len(body)} bytes")
        return int(hdrs["X-Gen"]), np.frombuffer(body, np.uint8).reshape(
            HEIGHT, WIDTH, 4)

    def state(base):
        return json.loads(get(base + "/state")[2])

    ref = uncounted(kernels, lambda: P.Viewer(
        tree, camera=camera(P.Camera, WIDTH, HEIGHT, FOCAL)).render_rgba8())
    kernels.reset_launch_counts()
    wv = WebViewer(P.Viewer(tree, camera=camera(P.Camera, WIDTH, HEIGHT,
                                                FOCAL)), port=0)
    base = f"http://127.0.0.1:{wv.start()}"
    try:
        gen, img = raw(base, -1)
        diff = int(np.abs(img.astype(np.int16) - ref.astype(np.int16)).max())
        check(diff <= 1, f"the served frame is {diff} levels off render_rgba8")
        events = []
        for i in range(12):
            if i % 2:
                x = 960.0 + 40.0 * i
                events.append([
                    {"t": "mouse", "button": "right", "pressed": True,
                     "x": 960.0, "y": 540.0},
                    {"t": "cursor", "x": x, "y": 540.0},
                    {"t": "mouse", "button": "right", "pressed": False,
                     "x": x, "y": 540.0}])
            else:
                events.append({"t": "key", "key": "WASD"[i // 2 % 4]})
        lat = []
        for ev in events:
            c0 = state(base)["camera"]["center"]
            t = time.perf_counter()
            res = post(base + "/event", ev)
            gen2, img = raw(base, gen)
            lat.append((time.perf_counter() - t) * 1e3)
            check(res["applied"] and not res["error"], f"event {ev}: {res}")
            s = state(base)
            check(gen2 > gen and s["gen"] >= gen2 and s["camera"]["center"]
                  != c0, f"event {ev} not read back")
            gen = gen2
        res = post(base + "/event", {"t": "options", "show_grid": True})
        gen2, grid = raw(base, gen)
        check(res["applied"] and not res["error"] and gen2 > gen
              and state(base)["options"]["show_grid"], f"grid edit: {res}")
        # the grid frame is not foveated: the grid goes off in the same post
        res = post(base + "/event", [{"t": "options", "show_grid": False},
                                     {"t": "viewer", "foveation": 2}])
        check(res["applied"] and not res["error"], f"foveation edit {res}")
        gen3, fov = raw(base, gen2)
        check(state(base)["viewer"]["foveation"] == 2 and gen3 > gen2
              and fov[..., 3].max() > 0, "the foveation edit did not render")
        check(wv.viewer._fov_sub is not None, "the served frame not foveated")
        log(f"browser viewer: first /frame.bin {WIDTH}x{HEIGHT}x4 bytes, "
            f"within {diff} rgba8 level of render_rgba8; 12 key and drag "
            f"events read back, event to new frame median "
            f"{sorted(lat)[6]:.1f} ms (all {[round(x, 1) for x in lat]}); "
            f"show_grid and foveation 2 edits rendered")
    finally:
        wv.stop()
    launches = read_launches(kernels, ("skip_prepass", "march",
                                       "exact_march"), "the browser viewer")
    # cli --serve 0 in a subprocess
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "small.npz")
        P.shell_tree(depth=6, basis_dim=9, sigma_inside=400.0,
                     device="cpu").save_npz(path)
        proc = subprocess.Popen(
            [sys.executable, "-m", "mega_nerf_viewer_tpu_torch.cli", path,
             "-w", str(WIDTH), "--height", str(HEIGHT), "--fx", str(FOCAL),
             "--center=" + ",".join(map(str, CENTER)), "--serve", "0"],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        try:
            t = time.perf_counter()
            line = ""
            while "Serving" not in line:
                line = proc.stdout.readline()
                check(line or proc.poll() is None, "cli --serve exited")
                check(time.perf_counter() - t < 120, "cli --serve: no port")
            url = line.split()[4].rstrip("/")
            get(url + "/frame?after=-1")          # the first frame
            s = state(url)
            check(s["backend"] == "CUDA" and s["camera"]["width"] == WIDTH,
                  f"cli --serve state {s}")
            log(f"cli --serve 0: bound {url}, /state answered after "
                f"{time.perf_counter() - t:.1f} s")
        finally:
            proc.terminate()
            proc.wait(timeout=60)
    return launches


def profiling_path(P, kernels, tree):
    """trace() around 3 Viewer frames: the trace holds the kernels' names
    and the annotate() name.  Returns the launch counts of the frames."""
    from mega_nerf_viewer_tpu_torch.utils.profiling import annotate, trace
    v = P.Viewer(tree, camera=camera(P.Camera, WIDTH, HEIGHT, FOCAL))
    kernels.reset_launch_counts()
    v.render(fetch=False)
    v.render(fetch=False)
    with tempfile.TemporaryDirectory() as td:
        t = time.perf_counter()
        with trace(td):
            for _ in range(3):
                with annotate("chip_smoke_frame"):
                    v.render(fetch=False)
        trace_s = time.perf_counter() - t
        path = os.path.join(td, os.listdir(td)[0])
        size = os.path.getsize(path)
        with open(path) as f:
            names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    kern = sorted(n for n in names if n.split("(")[0].endswith(
        ("march_kernel", "skip_prepass_kernel")))
    check(any("march_kernel" in n for n in kern)
          and any("skip_prepass_kernel" in n for n in kern),
          f"the trace lacks the kernels: {sorted(names)[:40]}")
    check("chip_smoke_frame" in names, "the trace lacks the annotation")
    log(f"profiling: trace() of 3 frames in {trace_s:.2f} s, {size} bytes, "
        f"holds {kern} and 'chip_smoke_frame'")
    return read_launches(kernels, ("skip_prepass", "march"), "profiling")


def native_path(P, tree):
    """The native loader built from native/nerfview_native.cpp and loaded;
    load_npz of the saved 1080p scene, vq_decode and argsort_counts equal
    numpy."""
    from mega_nerf_viewer_tpu_torch import native
    from mega_nerf_viewer_tpu_torch.n3tree import tree as T
    t = time.perf_counter()
    ok = native.available()
    build_s = time.perf_counter() - t
    check(ok, f"the native library did not build or load: "
          f"{native.build_error()}")
    rng = np.random.RandomState(0)
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "shell.npz")
        tree.save_npz(path)
        size = os.path.getsize(path)
        ms_native = median3(lambda: native.load_npz(path))[1]
        ms_numpy = median3(lambda: dict(np.load(path)))[1]
        got, want = native.load_npz(path), np.load(path)
        for k in want.files:
            if want[k].dtype.kind == "U":
                check(str(got[k]) == str(want[k]), f"load_npz {k} differs")
            else:
                check(np.array_equal(got[k], want[k]),
                      f"load_npz {k} differs from numpy")
        opened = P.N3Tree.open(path)
        check(torch.equal(opened.data[:tree.capacity],
                          tree.data[:tree.capacity]), "N3Tree.open differs")
    qm = rng.randint(0, 65536, (2, 4096, 8)).astype(np.uint16)
    qc = rng.randn(2, 65536, 3).astype(np.float16)
    sg = rng.rand(4096, 8).astype(np.float16)
    rt = rng.randn(1, 4096, 8).astype(np.float16)
    npz = dict(quant_colors=qc, quant_map=qm, sigma=sg, data_retained=rt)
    for bug in (True, False):
        a = native.vq_decode(qm, qc, rt, sg, 10, bug_compat=bug)
        avail = native.available
        native.available = lambda: False
        try:
            b = T._decode_vq(npz, 10, 8, bug)
        finally:
            native.available = avail
        check(np.array_equal(a, b), "vq_decode differs from numpy")
    keys = rng.randint(0, 1 << 16, 2_000_000).astype(np.int32)
    perm, inv = native.argsort_counts(keys)
    want = np.argsort(keys, kind="stable")
    check(np.array_equal(perm, want)
          and np.array_equal(inv, np.argsort(want, kind="stable")),
          "argsort_counts differs from numpy")
    log(f"native: {native.library_path().name} built and loaded in "
        f"{build_s:.1f} s; load_npz of the saved 1080p shell ({size} bytes) "
        f"{ms_native:.1f} ms against np.load {ms_numpy:.1f} ms, arrays "
        f"equal; vq_decode and argsort_counts (2M keys) equal numpy")


def rest_phase(P, kernels):
    """Phase 20: the rest of the user-facing path at 1080p on the voxel
    scene (foveation, the grid and mesh overlays, the browser viewer and
    cli --serve, profiling, the native loader).  Each path's launches are
    counted from 0 and read after it; returns their sum."""
    tree = P.shell_tree(depth=8, basis_dim=9, sigma_inside=400.0)
    total = {}
    t0 = time.perf_counter()
    add_launches(total, foveation_path(P, kernels, tree))
    add_launches(total, foveated_guided_path(P, kernels))
    torch.cuda.empty_cache()
    add_launches(total, grid_path(P, kernels, tree))
    add_launches(total, web_path(P, kernels, tree))
    add_launches(total, profiling_path(P, kernels, tree))
    native_path(P, tree)
    log(f"phase 20 in {time.perf_counter() - t0:.1f} s; launches {total}")
    return total


# ----------------------------------------------------------------------
# Phase 21: multi-device frames and the eager TorchScript fallback
# ----------------------------------------------------------------------
# the voxel scene's chunk on the H100 (device_tuning: 8 march blocks)
SHARDED_CS = 2048
# motion poses of benchmarks/motion1080p.py's orbit for the sharded path
SHARDED_POSES, SHARDED_DEG = 3, 3.0
# the two-rank run cuts the refinement fill from 4096 splits to this: gloo
# carries its row layers' all_reduces (128 MiB of f32 each at 256 splits,
# 16x that at 4096) through host memory and loopback TCP
WORLD2_SPLIT_BATCH = 256
# phase 21's kernels: A, B, C, D, E (sharded paths) and G (fallback)
SHARDED_KERNELS = ("march", "skip_prepass", "collect", "compact_composite",
                   "exact_march", "padded_composite")


def event_ms(fn):
    """(last result, median device ms of three calls by CUDA events, the
    three runs); a collective that blocks the host falls inside them."""
    runs = []
    for _ in range(3):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        runs.append(start.elapsed_time(end))
    return out, sorted(runs)[1], runs


def digest(*tensors):
    """sha256 of the tensors' bytes: two ranks' outputs compared bit for
    bit without moving them."""
    import hashlib
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def sharded_scenes(P, dev, split_batch_size):
    """The 1080p voxel scene (phase 4), the guided scene and model (phase
    8) and the refinement scene (phase 12) with ``split_batch_size``."""
    voxel = P.shell_tree(depth=8, basis_dim=9, sigma_inside=400.0,
                         device=dev)
    guided_tree = P.shell_tree(depth=8, basis_dim=1, sigma_inside=400.0,
                               device=dev)
    refine_tree = P.shell_tree(depth=8, basis_dim=1, sigma_inside=400.0,
                               max_capacity=REFINE_CAPACITY, device=dev)
    opt = P.RenderOptions()
    gopt = P.RenderOptions(max_guided_samples=GUIDED_S, need_viewdir=True,
                           use_guided_sampling=True)
    return dict(
        voxel=(voxel, P.build_leaf_map(voxel),
               P.build_skip_table(voxel, opt.sigma_thresh), opt),
        guided=(guided_tree, P.build_leaf_map(guided_tree),
                P.build_skip_table(guided_tree, gopt.sigma_thresh), gopt,
                P.MegaNeRFModel.synthetic(data_dim=int(guided_tree.data_dim),
                                          seed=0, device=dev,
                                          **GUIDED_MODEL)),
        refine=(refine_tree, P.RenderOptions(
            **dict(REFINE_OPT, split_batch_size=split_batch_size))))


def sharded_paths(P, mesh, tp_mesh, sc, say):
    """Every sharded path on ``mesh`` (the refinement step on ``tp_mesh``),
    each held to the single-device frame of the same pose on this rank:
    integers equal, pixels within 1e-6 (guided and motion 1e-5).  Returns
    (times {path: (sharded ms, single ms)}, digests {output: sha256})."""
    from mega_nerf_viewer_tpu_torch import parallel
    from mega_nerf_viewer_tpu_torch.ops import accel, guided, render
    from mega_nerf_viewer_tpu_torch.ops.rays import rodrigues, \
        screen2worlddir
    dev = mesh.device
    n = mesh.shape[parallel.RAY_AXIS]
    times, digests = {}, {}
    tree, lm, table, opt = sc["voxel"]
    cam = camera(P.Camera, WIDTH, HEIGHT, FOCAL)
    R = WIDTH * HEIGHT
    dirs, cen = screen2worlddir(WIDTH, HEIGHT, cam.fx, cam.fy, cam.cx,
                                cam.cy, torch.as_tensor(cam.transform,
                                                        device=dev))
    vdirs = rodrigues(opt.rot_dirs, dirs)

    # -- the exact march with visit marks (kernel E) and the exact frame
    res, ms, _ = event_ms(lambda: parallel.render_rays_sharded(
        tree, dirs, vdirs, cen, opt, mesh, track_visit=True))
    one, ms1, _ = event_ms(lambda: P.render_rays(tree, dirs, vdirs, cen, opt,
                                                 track_visit=True))
    err = float((res.out - one.out).abs().max())
    check(err <= 1e-6, f"sharded exact march differs by {err}")
    check(torch.equal(res.split_vote, one.split_vote),
          "sharded split votes differ")
    check(torch.equal(res.visited, one.visited), "sharded visit marks differ")
    times["exact rays, visit marks"] = (ms, ms1)
    img, ms, _ = event_ms(lambda: parallel.render_frame_sharded(
        tree, cam, opt, mesh))
    img1, ms1, _ = event_ms(lambda: P.render_frame(
        tree, WIDTH, HEIGHT, cam.fx, cam.fy, cam.cx, cam.cy, cam.transform,
        opt)[0])
    err = float((img - img1).abs().max())
    check(err <= 1e-6, f"sharded exact frame differs by {err}")
    times["exact frame"] = (ms, ms1)
    digests.update(exact=digest(res.out, res.split_vote, res.visited, img))
    say(f"exact: frame within {err:.1e}, votes and "
        f"{int(res.visited.sum())} visit marks equal")

    # -- the fast frame (kernels A and B)
    (img, ov), ms, _ = event_ms(lambda: parallel.render_frame_fast_sharded(
        tree, lm, cam, opt, mesh, max_dense=64, skip_table=table))
    ref, ms1, _ = event_ms(lambda: P.render_frame_fast(
        tree, lm, cam, opt, max_dense=64, chunk_size=0, skip_table=table))
    check(int(ov) == 0 and int(ref[1]) == 0, "fast frame overflowed")
    err = float((img - ref[0]).abs().max())
    check(err <= 1e-6, f"sharded fast frame differs by {err}")
    times["fast frame"] = (ms, ms1)
    digests["fast"] = digest(img)
    fast_ref = ref[0]

    # -- the segmented frame: stride deal, sorted output, chunk-exact
    _, _, steps, nrec, skips = P.render_frame_fast(
        tree, lm, cam, opt, max_dense=64, chunk_size=SHARDED_CS,
        block=16, return_nrec=True, skip_table=table, return_skips=True)
    order = P.order_from_hints(steps, nrec, skips)
    segments = list(P.DEFAULT_SEGMENTS)
    for _ in range(16):
        seg_img, seg_ov = P.render_frame_fast_segmented(
            tree, lm, cam, opt, order=order, segments=tuple(segments),
            chunk_size=SHARDED_CS, skip_table=table)
        if not seg_ov.any():
            break
        segments = [(f, max(1, b * 2)) if hit else (f, b)
                    for (f, b), hit in zip(segments, seg_ov.tolist())]
    check(not seg_ov.any(), "single-device segments did not settle")
    escalations = 0
    while True:
        img, ov = parallel.render_frame_fast_segmented_sharded(
            tree, lm, cam, opt, order, tuple(segments), mesh,
            chunk_size=SHARDED_CS, skip_table=table)
        if not ov.any():
            break
        escalations += 1
        check(escalations < 8, "sharded segments did not settle")
        segments = [(f, max(1, b * 2)) if hit else (f, b)
                    for (f, b), hit in zip(segments, ov.tolist())]
    (img, ov), ms, _ = event_ms(
        lambda: parallel.render_frame_fast_segmented_sharded(
            tree, lm, cam, opt, order, tuple(segments), mesh,
            chunk_size=SHARDED_CS, skip_table=table))
    _, ms1, _ = event_ms(lambda: P.render_frame_fast_segmented(
        tree, lm, cam, opt, order=order, segments=tuple(segments),
        chunk_size=SHARDED_CS, skip_table=table))
    err = float((img - fast_ref).abs().max())
    check(err <= 1e-6, f"sharded segmented frame differs by {err}")
    times["segmented frame (stride deal)"] = (ms, ms1)
    rows, ov2, index = parallel.render_frame_fast_segmented_sharded(
        tree, lm, cam, opt, order, tuple(segments), mesh,
        chunk_size=SHARDED_CS, skip_table=table, sorted_output=True)
    check(torch.equal(rows[index].reshape(HEIGHT, WIDTH, 4), img),
          "sorted output's index map does not recover the frame")
    check(torch.equal(ov2, ov), "sorted output's overflow differs")
    perm = order[0]
    counts = P.seg_counts_from_hints(nrec[perm].cpu(), SHARDED_CS,
                                     quantum=n)
    pad = (-R) % (n * SHARDED_CS)
    st = torch.cat([steps[perm], steps[perm][-1:].expand(pad)])
    costs = st.reshape(-1, SHARDED_CS).sum(1).double().cpu().numpy()
    (cimg, cov), ms, _ = event_ms(
        lambda: parallel.render_frame_fast_segmented_sharded(
            tree, lm, cam, opt, order, None, mesh, chunk_size=SHARDED_CS,
            skip_table=table, seg_counts=counts, chunk_costs=costs))
    check(not cov.any(), "chunk-exact sharded frame overflowed")
    err_c = float((cimg - fast_ref).abs().max())
    check(err_c <= 1e-6, f"chunk-exact sharded frame differs by {err_c}")
    times["segmented frame (chunk-exact deal)"] = (ms, ms1)
    digests["segmented"] = digest(img, rows, index, cimg)
    say(f"segmented: segments {segments} ({escalations} sharded "
        f"escalations), chunk-exact {counts}; frames within "
        f"{max(err, err_c):.1e}, sorted output bit-exact")

    # -- the re-hint motion poses
    ph = accel.pack_hints(steps, nrec, skips)
    mperm, minv = accel.order_from_packed_device(ph)
    qperm = accel.quarter_order_from_packed(ph, width=WIDTH)
    msegs = [(float(f), int(b)) for f, b in accel.segments_from_hint_cdf(
        accel.hint_class_cdf(nrec), R, margin=2, top_headroom=True)]
    pix_str, qpix_str = parallel.motion_episode_layout(
        (mperm, minv), qperm, mesh=mesh, chunk_size=SHARDED_CS,
        hint_chunk=SHARDED_CS)
    qsp = qperm
    mcam = camera(P.Camera, WIDTH, HEIGHT, FOCAL)
    pose_ms, single_ms, worst, m_esc = [], [], 0.0, 0
    for _ in range(SHARDED_POSES):
        motion_step(mcam, SHARDED_DEG)
        mcam._update()
        while True:
            out, pms, _ = event_ms(
                lambda: parallel.render_frame_motion_sharded(
                    tree, lm, mcam, opt, qpix_str, pix_str, tuple(msegs),
                    mesh=mesh, chunk_size=SHARDED_CS, hint_chunk=SHARDED_CS,
                    skip_table=table))
            if not out[1].any():
                break
            m_esc += 1
            check(m_esc < 8, "sharded motion segments did not settle")
            msegs = [(f, max(1, b * 2)) if hit else (f, b)
                     for (f, b), hit in zip(msegs, out[1].tolist())]
        mimg, _, qnext, cdf = out
        single, sms, _ = event_ms(lambda: P.render_frame_motion(
            tree, lm, mcam, opt, qsp, segments=tuple(msegs),
            chunk_size=SHARDED_CS, skip_table=table, hint_stride=2))
        check(torch.equal(cdf, single[3]), "sharded motion CDF differs")
        if n == 1:
            check(torch.equal(qnext[:qsp.shape[0]].long(), single[4].long()),
                  "sharded quarter order differs")
        real = qnext[qnext < (1 << 30)]
        check(torch.equal(torch.sort(real.long()).values,
                          torch.sort(qperm.long()).values),
              "the dealt quarter order is not a permutation")
        fresh = P.render_frame_fast(tree, lm, mcam, opt, max_dense=64,
                                    chunk_size=0, skip_table=table)[0]
        worst = max(worst, float((mimg - fresh).abs().max()))
        digests[f"motion pose {len(pose_ms)}"] = digest(mimg, qnext, cdf)
        pose_ms.append(pms)
        single_ms.append(sms)
        qpix_str, qsp = qnext, single[4]
    check(worst <= 1e-5, f"sharded motion frames differ by {worst}")
    times["motion pose"] = (sorted(pose_ms)[len(pose_ms) // 2],
                            sorted(single_ms)[len(single_ms) // 2])
    say(f"motion: {SHARDED_POSES} poses at {SHARDED_DEG} deg, segments "
        f"{msegs} ({m_esc} escalations), CDFs equal, frames within "
        f"{worst:.1e} of fresh frames")

    # -- the guided frame (kernels B, C and D)
    gtree, glm, _, gopt, model = sc["guided"]
    cache, ms1, _ = event_ms(lambda: guided.collect_and_query_fast(
        gtree, glm, model, cam, gopt, chunk_size=0))
    gref = guided.composite_frame(gtree, cam, gopt, cache)
    total = int(cache["num_samples"].sum())
    budget = -(-total // n // (1 << 16)) * (1 << 16)
    while True:
        (gimg, gov), ms, _ = event_ms(lambda: parallel.guided_frame_sharded(
            gtree, glm, model, cam, gopt, mesh, budget=budget))
        if not gov:
            break
        budget *= 2
    err = float((gimg - gref).abs().max())
    check(err <= 1e-5, f"sharded guided frame differs by {err}")
    times["guided frame"] = (ms, ms1)
    digests["guided"] = digest(gimg)
    say(f"guided: {total} samples, per-shard budget {budget}; frame within "
        f"{err:.1e}")

    # -- the frame-refine step (kernel E, the TP fill)
    rtree, ropt = sc["refine"]
    step = parallel.make_frame_refine_step(tp_mesh, ropt)
    K, spc = ropt.split_batch_size, ropt.samples_per_corner
    rnd = torch.rand((K, 8, spc, 3), generator=torch.Generator(
        device=dev).manual_seed(0), device=dev)
    rdirs, rcen = screen2worlddir(WIDTH, HEIGHT, cam.fx, cam.fy, cam.cx,
                                  cam.cy, torch.as_tensor(cam.transform,
                                                          device=dev))
    rv = rodrigues(ropt.rot_dirs, rdirs)
    gm = sc["guided"][4]
    grid = (gm.grid_dim, gm.min_position, gm.range)
    (out, new, tracker, n_added), ms, _ = event_ms(lambda: step(
        rtree, gm.params, *grid, rdirs, rv, rcen,
        render.fresh_visit_tracker(rtree), rnd=rnd))

    def single_step():
        r = P.render_rays(rtree, rdirs, rv, rcen, ropt, track_visit=True)
        tr = torch.maximum(render.fresh_visit_tracker(rtree), r.visited)
        return (r.out,) + P.expand_voxels_jit(
            rtree, gm.params, *grid, ropt, r.split_vote, tr, rnd=rnd)
    (out1, new1, tracker1, n1), ms1, _ = event_ms(single_step)
    check(n_added == n1 > 0, f"refine step added {n_added}, single {n1}")
    for k in ("child", "parent", "sample_counts"):
        check(torch.equal(getattr(new, k), getattr(new1, k)),
              f"refined tree's {k} differs")
    ulp = int((new.data.view(torch.int16).int()
               - new1.data.view(torch.int16).int()).abs().max())
    check(ulp <= 1, f"refined data differs by {ulp} f16 ulp")
    check(torch.equal(tracker, tracker1), "refine step's visit marks differ")
    err = float((out - out1).abs().max())
    check(err <= 1e-6, f"refine step's frame differs by {err}")
    times[f"refine step ({K} splits)"] = (ms, ms1)
    digests["refine"] = digest(out, new.child, new.data, tracker)
    say(f"refine step on {dict(tp_mesh.shape)}: {n_added} chunks added, "
        f"topology and marks equal, data within {ulp} f16 ulp")
    return times, digests


def fallback_container(path, data_dim):
    """A Mega-NeRF container at the guided model's width (8 clusters, 8
    layers, 256 wide, view directions) whose sine activations do not
    convert, saved to ``path``."""
    from torch import nn

    class SineMLP(nn.Module):
        def __init__(self):
            super().__init__()
            dims = [6] + [GUIDED_MODEL["hidden"]] * 7 + [data_dim + 1]
            self.layers = nn.ModuleList(
                nn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:]))

        def forward(self, x, sigma_only: bool = False):
            h = x
            for i, layer in enumerate(self.layers):
                h = layer(h)
                if i < 7:
                    h = torch.sin(h)
            return h

    class Container(nn.Module):
        def __init__(self):
            super().__init__()
            self.grid_dim = torch.tensor(GUIDED_MODEL["grid_dim"],
                                         dtype=torch.int32)
            self.min_position = torch.tensor(GUIDED_MODEL["min_position"])
            self.max_position = torch.tensor(GUIDED_MODEL["max_position"])
            self.centroids = torch.zeros(GUIDED_MODEL["n_clusters"], 3)
            self.need_viewdir = True
            self.need_appearance_embedding = False
            for i in range(GUIDED_MODEL["n_clusters"]):
                setattr(self, f"sub_module_{i}", torch.jit.script(SineMLP()))

    torch.manual_seed(0)
    torch.jit.save(torch.jit.script(Container()), path)


def fallback_path(P, kernels, dev, sc):
    """Items 5 and 6 on the card: a container that does not convert,
    loaded through the eager TorchScript fallback, its ``query`` against
    the eager forward, the host guided invalidation at 1080p with kernel
    G's padded composite, a Viewer guided frame, and ``_query_grouped``
    beside ``query_grouped`` on the guided scene's samples."""
    from mega_nerf_viewer_tpu_torch.models import meganerf as PM
    from mega_nerf_viewer_tpu_torch.ops import guided
    from mega_nerf_viewer_tpu_torch.ops import padded_composite as pc
    from mega_nerf_viewer_tpu_torch.ops.rays import rodrigues, \
        screen2worlddir
    tree, lm, table, opt, model = sc["guided"]
    cam = camera(P.Camera, WIDTH, HEIGHT, FOCAL)
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "sine.pt")
        fallback_container(path, int(tree.data_dim))
        fb, load_ms = timed(lambda: P.MegaNeRFModel.from_torchscript(path))
        container = torch.jit.load(path, map_location=dev)
    check(fb._torch_modules is not None, "the sine container converted")
    check(fb.output_dim == model.output_dim, "fallback output width")
    gen = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn((1 << 16, 6), generator=gen, device=dev)
    ids = torch.randint(0, fb.n_clusters, (1 << 16,), generator=gen,
                        device=dev)
    got, q_ms = timed(lambda: fb.query(ids, x))
    err = 0.0
    for c in range(fb.n_clusters):
        with torch.inference_mode():
            want = getattr(container, f"sub_module_{c}")(x[ids == c], False)
        err = max(err, float((got[ids == c] - want).abs().max()))
    check(err <= 1e-5, f"fallback query differs from the forward by {err}")
    log(f"phase 21 fallback: loaded in {load_ms:.0f} ms; query of "
        f"{x.shape[0]} samples {q_ms:.1f} ms, within {err:.1e} of the "
        f"eager forward")
    # the host invalidation against the converted model's
    conv, conv_ms, conv_runs = median3(lambda: guided.collect_and_query_fast(
        tree, lm, model, cam, opt, chunk_size=SHARDED_CS, skip_table=table))
    host, host_ms = timed(lambda: guided.collect_and_query_fast(
        tree, lm, fb, cam, opt, chunk_size=SHARDED_CS, skip_table=table))
    check(set(host) == {"results", "z_vals", "num_samples", "collect_steps"},
          f"host path cache {sorted(host)}")
    check(torch.equal(host["num_samples"], conv["num_samples"]),
          "host path sample counts differ from the device path's")
    total = int(host["num_samples"].sum())
    img, comp_ms, _ = median3(lambda: guided.composite_frame(
        tree, cam, opt, host))
    dirs, _ = screen2worlddir(WIDTH, HEIGHT, cam.fx, cam.fy, cam.cx, cam.cy,
                              torch.as_tensor(cam.transform, device=dev))
    plain = uncounted(kernels, lambda: pc.composite_results_padded_reference(
        host["results"], host["z_vals"], host["num_samples"],
        rodrigues(opt.rot_dirs, dirs), opt, tree.data_format.basis_dim,
        True))
    err_g = float((img.reshape(-1, 4) - plain).abs().max())
    check(err_g <= 1e-5, f"padded composite of the host cache off by {err_g}")
    check(bool(torch.isfinite(img).all()), "non-finite fallback frame")
    log(f"phase 21 fallback: host invalidation at {WIDTH}x{HEIGHT} "
        f"{host_ms:.1f} ms against the converted model's {conv_ms:.3f} ms "
        f"(runs {[round(r, 3) for r in conv_runs]}), {total} samples; "
        f"padded composite (kernel G) {comp_ms:.3f} ms, within {err_g:.1e} "
        f"of its plain version")
    # a Viewer guided frame with the fallback model (room to grow: no
    # capacity pressure, so the leaf-map collect and the host path)
    vtree = P.shell_tree(depth=8, basis_dim=1, sigma_inside=400.0,
                         max_capacity=2 * SHELL_CHUNKS)
    vlm = P.build_leaf_map(vtree)
    v = P.Viewer(vtree, camera=camera(P.Camera, WIDTH, HEIGHT, FOCAL),
                 options=opt, model=fb)
    vimg, v_ms = timed(lambda: v.render(fetch=False))
    direct = uncounted(kernels, lambda: guided.composite_frame(
        vtree, cam, opt, guided.collect_and_query_fast(
            vtree, vlm, fb, cam, opt, chunk_size=v.fast_chunk_size,
            skip_table=P.build_skip_table(vtree, opt.sigma_thresh))))
    err_v = float((vimg - direct).abs().max())
    check(err_v <= 1e-5, f"viewer fallback frame differs by {err_v}")
    log(f"phase 21 fallback: viewer guided frame {v_ms:.1f} ms, within "
        f"{err_v:.1e} of the direct host path")
    del v, vtree, vlm, host, img
    # the ragged_dot reference beside the production dispatcher
    dirs, cen = screen2worlddir(WIDTH, HEIGHT, cam.fx, cam.fy, cam.cx,
                                cam.cy, torch.as_tensor(cam.transform,
                                                        device=dev))
    vd = rodrigues(opt.rot_dirs, dirs)
    t_buf, ns = guided.collect_t_fast(tree, lm, dirs, cen, opt,
                                      skip_table=table)
    x, cids, *_ = guided._compact_reconstruct(
        tree, dirs, vd, cen, t_buf, ns, torch.as_tensor(model.grid_dim,
                                                        device=dev),
        torch.as_tensor(model.min_position, device=dev),
        torch.as_tensor(model.range, device=dev), opt,
        guided._budget(int(ns.sum())))
    a, a_ms, _ = median3(lambda: PM.query_grouped(model.params, cids, x))
    b, b_ms, _ = median3(lambda: PM._query_grouped(model.params, cids, x))
    err_q = float((a - b).abs().max())
    check(err_q <= 1e-4, f"_query_grouped differs by {err_q}")
    log(f"phase 21 models: _query_grouped (ragged_dot reference) "
        f"{b_ms:.3f} ms beside query_grouped {a_ms:.3f} ms on {x.shape[0]} "
        f"samples, within {err_q:.1e}")
    return host_ms, conv_ms


def collectives_share(P, mesh, sc, say):
    """The collectives' share of sharded frames on this rank: the profiler's
    ``parallel.*`` ranges (host time; under gloo, the backend's copies
    through host memory and loopback TCP included) over the host time of the same profiled frames; the frame's
    unprofiled time (CUDA events, median of 3) beside it.  Returns {frame:
    (collective ms, profiled frame ms, frame ms)}."""
    from torch.profiler import ProfilerActivity, profile
    from mega_nerf_viewer_tpu_torch import parallel
    tree, lm, table, opt = sc["voxel"]
    cam = camera(P.Camera, WIDTH, HEIGHT, FOCAL)
    out = {}
    for name, fn in (
            ("fast", lambda: parallel.render_frame_fast_sharded(
                tree, lm, cam, opt, mesh, max_dense=64, skip_table=table)),
            ("exact", lambda: parallel.render_frame_sharded(
                tree, cam, opt, mesh))):
        _, ms, _ = event_ms(fn)
        for _ in range(2):           # the first profile warms the profiler
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                torch.cuda.synchronize()
                t = time.perf_counter()
                for _ in range(3):
                    fn()
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t) * 1e3 / 3
        coll = sum(e.cpu_time_total for e in prof.key_averages()
                   if e.key.startswith("parallel.")) / 1e3 / 3
        out[name] = (coll, wall, ms)
        say(f"collectives of the {name} frame: {coll:.3f} ms of {wall:.3f} "
            f"ms a profiled frame ({100 * coll / wall:.1f}%; host time in "
            f"the parallel.* ranges); unprofiled frame {ms:.3f} ms")
    return out


def gloo_on_cuda(pm, dev, rank, say):
    """The port's collectives hand gloo CUDA tensors as they are (no copy
    of their own): check that gloo takes them in each collective the
    sharded paths run and gives the right values on the card."""
    import torch.distributed as dist
    group = dist.group.WORLD
    mine = torch.full((5,), rank + 1, dtype=torch.int32, device=dev)
    got = dict(
        all_reduce_sum=pm.all_reduce(mine.float(), "sum", group),
        all_reduce_max=pm.all_reduce(mine, "max", group),
        all_gather=pm.all_gather(mine, group),
        broadcast=pm.broadcast(mine))
    want = dict(all_reduce_sum=[3.0] * 5, all_reduce_max=[2] * 5,
                all_gather=[1] * 5 + [2] * 5, broadcast=[1] * 5)
    for name, t in got.items():
        check(t.device == dev and t.tolist() == want[name],
              f"gloo {name} on CUDA tensors gave {t}")
    say(f"gloo took CUDA tensors in {', '.join(got)}: values right, on "
        f"{dev}")


def sharded_rank_main(rank, port, outdir):
    """One of two ranks of phase 21's two-rank run: gloo on the one card
    (NCCL refuses two ranks on one device), the sharded paths on a (2,)
    mesh and the refinement step on a (1, 2) mesh; writes a JSON summary
    to ``outdir``.  A rank still running after 360 s writes every
    thread's stack to its stderr and exits, inside phase 21's 400 s wait,
    so that the phase reports where it stood."""
    import faulthandler
    import torch.distributed as dist
    faulthandler.dump_traceback_later(360, exit=True)
    import mega_nerf_viewer_tpu_torch as P
    from mega_nerf_viewer_tpu_torch import kernels, parallel
    from mega_nerf_viewer_tpu_torch.parallel import mesh as pm
    dev = torch.device("cuda", 0)
    parallel.multihost.initialize(f"127.0.0.1:{port}", 2, rank,
                                  backend="gloo", device=dev)
    check(dist.get_backend() == "gloo", "two ranks on one card run gloo")
    kernels.build()
    kernels.reset_launch_counts()
    lines = []

    def say(msg):
        lines.append(msg)
        if rank == 0:
            log(f"phase 21 world 2: {msg}")
    gloo_on_cuda(pm, dev, rank, say)
    sc = sharded_scenes(P, dev, WORLD2_SPLIT_BATCH)
    mesh = parallel.make_mesh((2,), (parallel.RAY_AXIS,))
    tp_mesh = parallel.make_mesh((1, 2), (parallel.RAY_AXIS,
                                          parallel.MODEL_AXIS))
    times, digests = sharded_paths(P, mesh, tp_mesh, sc, say)
    share = collectives_share(P, mesh, sc, say)
    torch.cuda.synchronize()
    with open(os.path.join(outdir, f"rank{rank}.json"), "w") as f:
        json.dump(dict(times=times, digests=digests, share=share,
                       launches=dict(kernels.LAUNCHES)), f)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def sharded_phase(P, kernels, dev):
    """Phase 21: multi-device frames and the eager TorchScript fallback.
    World 1 under NCCL in-process (every sharded path against the
    single-device frame of the same pose), the fallback, ``cli --sharded``
    in a subprocess, then two gloo ranks sharing the card.  Returns the
    launch counts of the in-process run."""
    import torch.distributed as dist
    from mega_nerf_viewer_tpu_torch import parallel
    from mega_nerf_viewer_tpu_torch.ops import render
    from mega_nerf_viewer_tpu_torch.utils.png import read_png
    t0 = time.perf_counter()
    kernels.reset_launch_counts()
    sc = sharded_scenes(P, dev, REFINE_OPT["split_batch_size"])
    mesh = parallel.default_mesh(device=dev)
    check(dist.get_backend() == "nccl", "world 1 on the card runs NCCL")

    def say(msg):
        log(f"phase 21 world 1: {msg}")
    times, _ = sharded_paths(P, mesh, mesh, sc, say)
    for path, (ms, ms1) in times.items():
        log(f"phase 21 world 1 (NCCL): {path} {ms:.3f} ms sharded, "
            f"{ms1:.3f} ms single-device (CUDA events, median of 3)")
    collectives_share(P, mesh, sc, say)
    host_ms, conv_ms = fallback_path(P, kernels, dev, sc)
    launches = read_launches(kernels, SHARDED_KERNELS, "phase 21")
    dist.destroy_process_group()

    # cli --sharded, run plainly: a world of one
    tree, _, _, opt = sc["voxel"]
    cam = camera(P.Camera, WIDTH, HEIGHT, FOCAL)
    ref = uncounted(kernels, lambda: render.to_rgba8(P.render_frame(
        tree, WIDTH, HEIGHT, cam.fx, cam.fy, cam.cx, cam.cy, cam.transform,
        opt)[0])).cpu().numpy().astype(np.int32)
    with tempfile.TemporaryDirectory() as td:
        npz, png = os.path.join(td, "t.npz"), os.path.join(td, "s.png")
        tree.save_npz(npz)
        del sc, tree
        torch.cuda.empty_cache()
        t = time.perf_counter()
        run = subprocess.run(
            [sys.executable, "-m", "mega_nerf_viewer_tpu_torch.cli", npz,
             "-w", str(WIDTH), "--height", str(HEIGHT), "--fx", str(FOCAL),
             "--center=" + ",".join(str(c) for c in CENTER), "--bg",
             str(opt.background_brightness), "--sharded", "-o", png],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            capture_output=True, text=True, timeout=300)
        log(f"phase 21 cli --sharded at {WIDTH}x{HEIGHT}: exit "
            f"{run.returncode} in {time.perf_counter() - t:.1f} s; "
            f"{run.stdout.strip()[-200:]}"
            + (f"; stderr {run.stderr.strip()[-2000:]}" if run.returncode
               else ""))
        check(run.returncode == 0, "cli --sharded failed")
        diff = int(np.abs(read_png(png).astype(np.int32) - ref).max())
        check(diff <= 1, f"cli --sharded PNG differs by {diff} levels")

        # two gloo ranks sharing the card
        import socket
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        t = time.perf_counter()
        errs = [open(os.path.join(td, f"rank{r}.err"), "w+")
                for r in (0, 1)]
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--sharded-rank",
             str(r), str(port), td],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            stdout=None if r == 0 else subprocess.DEVNULL, stderr=errs[r])
            for r in (0, 1)]
        deadline = time.perf_counter() + 400
        try:
            for p in procs:
                p.wait(timeout=max(1.0, deadline - time.perf_counter()))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, (p, e) in enumerate(zip(procs, errs)):
            e.seek(0)
            check(p.returncode == 0,
                  f"world-2 rank {r} failed:\n{e.read()[-3000:]}")
            e.close()
        ranks = []
        for r in (0, 1):
            with open(os.path.join(td, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    check(ranks[0]["digests"] == ranks[1]["digests"],
          "the two ranks' outputs differ")
    w2 = ranks[0]
    for path, (ms, ms1) in w2["times"].items():
        log(f"phase 21 world 2 (gloo, one card): {path} {ms:.3f} ms sharded,"
            f" {ms1:.3f} ms single-device (CUDA events, median of 3; both "
            f"ranks on the card)")
    missing = [k for k in SHARDED_KERNELS if k != "padded_composite"
               and w2["launches"][k] == 0]
    check(not missing, f"world 2: {missing} never launched")
    log(f"phase 21 world 2: both ranks bit-equal ({len(w2['digests'])} "
        f"outputs); rank 0 launches {w2['launches']}; in "
        f"{time.perf_counter() - t:.1f} s")
    log(f"phase 21 in {time.perf_counter() - t0:.1f} s; fallback "
        f"invalidation {host_ms:.1f} ms vs converted {conv_ms:.3f} ms; "
        f"launches {launches}")
    return launches


# ----------------------------------------------------------------------
# Phase 22: the Viewer's execution switches
# ----------------------------------------------------------------------
def switch_row(kernels, what, names):
    """The counts of a switch's path since the last reset, each of
    ``names`` launched, printed."""
    launches = read_launches(kernels, names, f"phase 22 {what}")
    log(f"phase 22 {what}: launches "
        f"{ {k: n for k, n in launches.items() if n} }")
    return launches


def in_turns(kernels, default, switched):
    """The default's and the switch's calls in turns (default, switch,
    switch, default), three calls a turn timed by CUDA events, the
    default's calls uncounted.  Returns (the switch's last result, the
    default's and the switch's median ms, the switch's six runs)."""
    runs = {default: [], switched: []}
    out = None
    for fn in (default, switched, switched, default):
        if fn is default:
            r = uncounted(kernels, lambda: event_ms(fn))[2]
        else:
            out, _, r = event_ms(fn)
        runs[fn] += r

    def med(r):
        return (sorted(r)[2] + sorted(r)[3]) / 2
    return (out, med(runs[default]), med(runs[switched]),
            [round(r, 3) for r in runs[switched]])


def switches_voxel(P, kernels, tree, total):
    """The voxel scene's rows: the prepass off (a parked frame), the fast
    path off (a parked frame), use_dynamic_knobs off, the device order off
    (phase 15's 12-pose orbit under sync) and foveation at f = 2 with the
    prepass off.  Each row's path is counted from 0."""
    from mega_nerf_viewer_tpu_torch.ops import accel

    def viewer(fov=1, **switches):
        v = (fov_viewer(P, tree, fov) if fov > 1 else P.Viewer(
            tree, camera=camera(P.Camera, WIDTH, HEIGHT, FOCAL)))
        for k, val in switches.items():
            setattr(v, k, val)
        v.render(fetch=False)             # the hint frame
        v.render(fetch=False)
        return v

    base = uncounted(kernels, viewer)
    ref = uncounted(kernels, lambda: base.render(fetch=False))

    def frame(v):
        return lambda: v.render(fetch=False)

    kernels.reset_launch_counts()
    v = viewer(use_prepass=False)
    img, ms_ref, ms, runs = in_turns(kernels, frame(base), frame(v))
    run = switch_row(kernels, "use_prepass off, parked frame", ("march",))
    check(run["skip_prepass"] == 0, "kernel B launched with the prepass off")
    check(torch.equal(img, ref), "the prepass-off frame is not bit-equal "
          "to the default frame")
    add_launches(total, run)
    log(f"phase 22 use_prepass off: parked {ms:.3f} ms/frame beside the "
        f"default {ms_ref:.3f} (CUDA events in turns, medians of 6; runs "
        f"{runs}); bit-equal to the default frame")
    del v

    kernels.reset_launch_counts()
    v = viewer(use_fast_path=False)
    img, ms_ref, ms, runs = in_turns(kernels, frame(base), frame(v))
    run = switch_row(kernels, "use_fast_path off, parked frame",
                     ("exact_march",))
    check(run["march"] == 0 and v._leaf_map is None,
          "the fast-path-off frame marched the leaf map")
    err = float((img - ref).abs().max())
    check(err <= 1e-5, f"the exact frame differs from the default by {err}")
    add_launches(total, run)
    log(f"phase 22 use_fast_path off: parked {ms:.3f} ms/frame (kernel E) "
        f"beside the default {ms_ref:.3f} (CUDA events in turns, medians of "
        f"6; runs {runs}); against the default frame max abs diff "
        f"{err:.3e}")
    del v

    def knobs(on):
        def fn():
            base.use_dynamic_knobs = on
            return base.render(fetch=False)
        return fn
    kernels.reset_launch_counts()
    img, ms_ref, ms, runs = in_turns(kernels, knobs(True), knobs(False))
    base.use_dynamic_knobs = True
    run = switch_row(kernels, "use_dynamic_knobs off, parked frame",
                     ("skip_prepass", "march"))
    check(torch.equal(img, ref), "use_dynamic_knobs changed the frame")
    add_launches(total, run)
    log(f"phase 22 use_dynamic_knobs off: {ms:.3f} ms/frame beside "
        f"{ms_ref:.3f} (CUDA events in turns, medians of 6; runs {runs}), "
        f"equal to the default frame")

    # phase 15's orbit, both ways in turns pose by pose (host clock), each
    # pose against a fresh frame
    host_orders = [0]
    orig = accel.order_from_hints

    def counting(*a, **kw):
        host_orders[0] += 1
        return orig(*a, **kw)

    def pose(v):
        n = host_orders[0]
        img, ms = timed(lambda: v.render(fetch=False))
        fresh = uncounted(kernels, lambda: fresh_frame(
            P, tree, v._leaf_map, v.camera, v.options, v.fast_chunk_size,
            v._skip_table))
        err = float((img - fresh).abs().max())
        check(err <= 1e-6, f"an orbit pose differs from a fresh frame by "
              f"{err}")
        return ms, host_orders[0] - n, err

    kernels.reset_launch_counts()
    v = viewer(use_device_order=False)
    with_order, without = [], []
    accel.order_from_hints = counting
    try:
        for i in range(12):
            orbit_step(base.camera, 12)
            orbit_step(v.camera, 12)
            for which in ((0, 1) if i % 2 == 0 else (1, 0)):
                if which == 0:
                    with_order.append(uncounted(kernels, lambda: pose(base)))
                else:
                    without.append(pose(v))
    finally:
        accel.order_from_hints = orig
    run = switch_row(kernels, "use_device_order off, 12-pose orbit",
                     ("skip_prepass", "march"))
    check(v._hints_packed is None, "packed hints with the device order off")
    add_launches(total, run)

    def med(poses):
        return sorted(p[0] for p in poses)[len(poses) // 2]
    log(f"phase 22 use_device_order off: orbit {med(without):.3f} ms/pose "
        f"(host clock, median of 12), {sum(p[1] for p in without)} sync "
        f"redos, beside the device order's {med(with_order):.3f} ms/pose "
        f"(in turns pose by pose); each pose against a fresh frame max abs "
        f"diff {max(p[2] for p in without):.3e}; poses (ms, redos) "
        f"{[(round(p[0], 3), p[1]) for p in without]}; the device order's "
        f"{[round(p[0], 3) for p in with_order]}")
    del v, base

    fov = uncounted(kernels, lambda: viewer(fov=2))
    ref = uncounted(kernels, lambda: fov.render(fetch=False))
    kernels.reset_launch_counts()
    v = viewer(fov=2, use_prepass=False)
    img, ms_ref, ms, runs = in_turns(kernels, frame(fov), frame(v))
    run = switch_row(kernels, "foveated f=2, use_prepass off", ("march",))
    check(run["skip_prepass"] == 0, "kernel B launched in the subs")
    check(v._fov_sub is not None
          and not any(s.use_prepass for s in v._fov_sub),
          "the subs did not take use_prepass")
    check(torch.equal(img, ref), "the foveated prepass-off frame differs")
    add_launches(total, run)
    log(f"phase 22 foveated f=2, use_prepass off: {ms:.3f} ms/frame beside "
        f"the prepass's {ms_ref:.3f} (CUDA events in turns, medians of 6; "
        f"runs {runs}); bit-equal")


def switches_guided(P, kernels, total):
    """The guided scene's rows (phase 16's scene and model): the guided
    segments off (stops in turns with the default's, then a reuse frame),
    the fast path off (stops in turns) and use_pallas_composite=False.
    Each row's path is counted from 0."""
    tree = P.shell_tree(depth=8, basis_dim=1, sigma_inside=400.0,
                        max_capacity=2 * SHELL_CHUNKS)
    model = P.MegaNeRFModel.synthetic(data_dim=int(tree.data_dim), seed=0,
                                      **GUIDED_MODEL)
    opt = P.RenderOptions(max_guided_samples=GUIDED_S, need_viewdir=True,
                          use_guided_sampling=True)

    def viewer(**switches):
        v = P.Viewer(tree, camera=camera(P.Camera, WIDTH, HEIGHT, FOCAL),
                     options=opt, model=model)
        for k, val in switches.items():
            setattr(v, k, val)
        v.render(fetch=False)
        return v

    def stop(v):
        def fn():
            v.key_event("W")
            return v.render(fetch=False)
        return fn

    base = uncounted(kernels, viewer)
    kernels.reset_launch_counts()
    v = viewer(use_guided_segments=False)
    n = kernels.LAUNCHES["collect"]
    img, ms_ref, ms, runs = in_turns(kernels, stop(base), stop(v))
    check(kernels.LAUNCHES["collect"] == n + 6,
          "an ordered stop did not take one collect launch")
    ref = base._guided_img_cache[1]
    reuse_ref = uncounted(kernels, lambda: event_ms(
        lambda: base.render(fetch=False)))[1]
    _, reuse_ms, _ = event_ms(lambda: v.render(fetch=False))
    run = switch_row(kernels, "use_guided_segments off, stops",
                     ("collect", "compact_composite"))
    check(v._guided_segments is None, "a ladder with the segments off")
    err = float((img - ref).abs().max())
    check(err <= 1e-5, f"the ordered stop differs from the segmented stop "
          f"by {err}")
    add_launches(total, run)
    log(f"phase 22 use_guided_segments off: stop {ms:.3f} ms (one ordered "
        f"collect launch) beside the segmented {ms_ref:.3f} (CUDA events in "
        f"turns, medians of 6; runs {runs}); reuse frame {reuse_ms:.3f} "
        f"beside {reuse_ref:.3f}; against the segmented stop max abs diff "
        f"{err:.3e}")
    del v

    kernels.reset_launch_counts()
    base.use_pallas_composite = False
    img, ms = timed(lambda: base.render(fetch=False))
    run = switch_row(kernels, "use_pallas_composite=False, composite",
                     ("compact_composite",))
    check(torch.equal(img, ref), "use_pallas_composite changed the frame")
    add_launches(total, run)
    log(f"phase 22 use_pallas_composite=False: the composite again through "
        f"kernel D, {ms:.3f} ms (host clock), equal to the default frame")
    del base

    base = uncounted(kernels, viewer)
    kernels.reset_launch_counts()
    v = viewer(use_fast_path=False)
    img, ms_ref, ms, runs = in_turns(kernels, stop(base), stop(v))
    run = switch_row(kernels, "use_fast_path off, stops",
                     ("exact_collect", "padded_composite"))
    check(run["collect"] == 0, "kernel C launched with the fast path off")
    check(bool(torch.isfinite(img).all()), "non-finite exact guided stop")
    err = float((img - base._guided_img_cache[1]).abs().max())
    check(err <= 1e-5, f"the exact guided stop differs from the leaf map's "
          f"by {err}")
    add_launches(total, run)
    log(f"phase 22 use_fast_path off: guided stop {ms:.3f} ms (kernels F "
        f"and G) beside the leaf map's {ms_ref:.3f} (CUDA events in turns, "
        f"medians of 6; runs {runs}); against the leaf map's stop max abs "
        f"diff {err:.3e}")


def switches_phase(P, kernels):
    """Phase 22: the Viewer's execution switches at 1080p on phase 15's
    voxel scene and phase 16's guided scene, each switched off against the
    default (viewer.py:101-197).  Returns the launch counts of the
    switches' paths, summed."""
    t0 = time.perf_counter()
    total = {}
    tree = P.shell_tree(depth=8, basis_dim=9, sigma_inside=400.0)
    switches_voxel(P, kernels, tree, total)
    del tree
    torch.cuda.empty_cache()
    switches_guided(P, kernels, total)
    torch.cuda.empty_cache()
    log(f"phase 22 in {time.perf_counter() - t0:.1f} s; launches {total}")
    return total

def alone(kernels, fn, n):
    """(device ms, how, CUDA-event ms) of ``fn`` alone, uncounted: the
    events (which also hold the host's gaps) cross-check the profiler's
    device time."""
    ms, by = uncounted(kernels, lambda: device_ms(fn, n))
    return ms, by, uncounted(kernels, lambda: cuda_ms(fn, n))


def bench_protocol(P, tree, leaf_map, cam, opt, table, cs, blk, what):
    """``bench.py``'s 1080p protocol (bench.py:261-368) on ``tree``: the
    hint frame with ``max_dense`` doubled from 8 until no ray overflows,
    ``order_from_hints``, chunk-exact ``seg_counts_from_hints`` budgets
    (the ladder ``DEFAULT_SEGMENTS`` where a chunk records beyond the
    largest chunk-exact budget, as bench.py:340-349 falls back), each
    overflowing segment's budget doubled until none overflows; the settled
    frame within 1e-6 of the hint frame.  Returns a namespace: ``md``, the
    hint frame and its hints, the order, the layout (``"chunk-exact"`` or
    ``"ladder"``) and its budgets, the settled frame ``img`` and
    ``frame(lm=leaf_map, **kw)``, which renders it."""
    md = 8
    while True:
        hint, overflow, steps, nrec, skips = P.render_frame_fast(
            tree, leaf_map, cam, opt, max_dense=md, chunk_size=cs,
            block=blk, return_nrec=True, skip_table=table,
            return_skips=True)
        if not int(overflow):
            break
        md *= 2
        check(md <= 512, "pathological dense-sample count")
    order = P.order_from_hints(steps, nrec, skips)
    try:
        budgets = [list(sc) for sc in P.seg_counts_from_hints(
            nrec.reshape(-1)[order[0]], cs)]
        layout = "chunk-exact"
    except ValueError as e:
        log(f"{what}: chunk-exact budgets unavailable ({e}); the ladder "
            f"segments")
        budgets = [list(sg) for sg in P.DEFAULT_SEGMENTS]
        layout = "ladder"

    def frame(lm=leaf_map, **kw):
        lay = tuple(tuple(b) for b in budgets)
        if layout == "chunk-exact":
            kw.update(segments=None, seg_counts=lay)
        else:
            kw.update(segments=lay)
        return P.render_frame_fast_segmented(
            tree, lm, cam, opt, order, chunk_size=cs, skip_table=table,
            **kw)

    while True:
        img, seg_overflow = frame()
        ov = seg_overflow.cpu().numpy()
        if not ov.any():
            break
        for i in np.flatnonzero(ov):
            budgets[i][1] = max(1, budgets[i][1] * 2)
            check(budgets[i][1] <= 512, "segment budget beyond 512")
    diff = float((img - hint).abs().max())
    log(f"{what}: hint budget {md}, {int(steps.sum())} steps, "
        f"{int(nrec.sum())} records, {int(skips.sum())} skips, alpha max "
        f"{float(img[..., 3].max()):.4f}; {layout} segments "
        f"{[tuple(b) for b in budgets]}; segmented frame vs hint frame: max "
        f"abs diff {diff:.3e}")
    check(bool(torch.isfinite(img).all()), f"{what}: non-finite pixels")
    check(diff <= 1e-6, f"{what}: the segmented frame differs from the hint "
          f"frame")
    return SimpleNamespace(md=md, hint=hint, steps=steps, nrec=nrec,
                           skips=skips, order=order, layout=layout,
                           budgets=budgets, img=img, frame=frame)


def hint_ray_kernels(P, kernels, dev, tree, leaf_map, table, cam, opt, cs,
                     blk, md, what):
    """Kernels B and A against their plain versions on the hint frame's
    rays (pixel-block order, padded to whole chunks), uncounted: B's ``t``
    bit-equal and its skips equal, A's overflow, steps and records equal
    and its pixels within 1e-6 at budget ``md``; then each alone with its
    bound from these rays' skip, step and record counts.  Returns a
    namespace of A's arguments, the counts and ``times``, a line of the
    two kernels' figures."""
    from mega_nerf_viewer_tpu_torch.ops import accel
    from mega_nerf_viewer_tpu_torch.ops import skip_prepass as sp
    from mega_nerf_viewer_tpu_torch.ops.rays import screen2worlddir_indices
    W, H = cam.width, cam.height
    R = W * H
    bperm, _ = accel.block_permutation(W, H, blk, device=dev)
    n_pad = -(-R // cs) * cs
    pix = torch.cat([bperm, bperm[-1:].expand(n_pad - R)])
    dirs, cen_world = screen2worlddir_indices(
        pix, W, cam.fx, cam.fy, cam.cx, cam.cy,
        torch.as_tensor(cam.transform, device=dev))
    m = accel.march_inputs(tree, dirs, dirs, cen_world, opt)
    live = ~m.miss
    b_args = (table, m.cen, m.d, m.invdir, m.tmin, m.tmax, live,
              m.step_size)
    t_k, s_k = uncounted(kernels, lambda: kernels.skip_prepass(*b_args))
    t_p, s_p = sp.entry_skip_prepass_reference(*b_args)
    check(torch.equal(t_k.view(torch.int32), t_p.view(torch.int32)),
          f"{what} prepass t not bit-equal to the plain version")
    check(torch.equal(s_k, s_p), f"{what} prepass skips differ")
    ma = m._replace(tmin=t_k)
    a_args = (tree, leaf_map, ma.cen, ma.d, ma.invdir, ma.delta_scale,
              ma.tmin, ma.tmax, ma.miss, ma.basis, ma.step_size,
              ma.sigma_thresh, ma.stop_thresh, md, ma.use_sh)
    ok = uncounted(kernels, lambda: kernels.march(*a_args))
    op = accel.render_rays_fast_reference(*a_args)
    err_a = float((ok[0] - op[0]).abs().max())
    for name, a, b in zip(("overflow", "steps", "records"), ok[1:4],
                          op[1:4]):
        check(torch.equal(a, b), f"{what} march {name} differ from the "
              f"plain version")
    check(err_a <= 1e-6, f"{what} march differs by {err_a}")
    b_steps = int(s_k.sum())
    a_steps, shaded = int(ok[2].sum()), int(ok[3].clamp(max=md).sum())
    ms_b, by_b, ev_b = alone(kernels, lambda: kernels.skip_prepass(*b_args),
                             20)
    ms_a, by_a, ev_a = alone(kernels, lambda: kernels.march(*a_args), 20)
    bb, bb_by = bound_ms(nbytes(table, m.cen, m.d, m.invdir, m.tmin, m.tmax,
                                live, t_k, s_k),
                         PREPASS_OPS_PER_STEP * b_steps)
    B = ma.basis.shape[1]
    ba, ba_by = bound_ms(
        nbytes(ma.d, ma.invdir, ma.delta_scale, ma.tmin, ma.tmax, ma.miss,
               ma.basis, ok[0], ok[2], ok[3])
        + 8 * a_steps + 2 * tree.data_dim * shaded,
        MARCH_OPS_PER_STEP * a_steps + (6 * B + 15) * shaded)
    log(f"{what} kernels against their plain versions over {n_pad} rays: "
        f"prepass t bit-equal, {b_steps} skips equal; march md {md}: "
        f"overflow, {a_steps} steps and {int(ok[3].sum())} records equal, "
        f"out max abs diff {err_a:.3e}")
    times = (f"skip_prepass {ms_b:.4f} ms ({by_b}; events {ev_b:.4f}; bound "
             f"{bb:.4f} ms by {bb_by}, {100 * bb / ms_b:.0f}%); march "
             f"{ms_a:.4f} ms ({by_a}; events {ev_a:.4f}; bound {ba:.4f} ms "
             f"by {ba_by}, {100 * ba / ms_a:.0f}%; {a_steps} steps, "
             f"{shaded} shaded samples)")
    return SimpleNamespace(a_args=a_args, b_steps=b_steps, a_steps=a_steps,
                           shaded=shaded, err_a=err_a, times=times)


def aerial_phase(P, kernels, dev, smi):
    """Phase 23: the aerial artifact (175,656 chunks, depth 9, SH4), built
    without JAX (``bench_torch.aerial_artifact``) and loaded onto the card
    by ``N3Tree.open``.  The committed goldens: the exact frame at 160x160
    through kernel E, the fast frame at 512x512 through A and B.  Then
    ``bench.py``'s 1080p protocol (bench.py:249-392): the hint frame with
    ``max_dense`` escalation, ``order_from_hints``, chunk-exact
    ``seg_counts_from_hints`` budgets and the record-sorted segmented
    frame, with A and B held against their plain versions on the hint
    frame's rays; the exact frame (one launch of E) and the same segmented
    frame on a level-7 map (A's resumed descent, two levels) against it;
    then the three frames' times and A's, B's and E's alone with their
    bounds.  Returns the path's launches."""
    from mega_nerf_viewer_tpu_torch.ops import accel, render
    from mega_nerf_viewer_tpu_torch.ops.rays import rodrigues, screen2worlddir
    from mega_nerf_viewer_tpu_torch.utils.metrics import psnr
    from mega_nerf_viewer_tpu_torch.utils.png import read_png
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    path, cap = aerial_artifact(os.path.join(ROOT, "build",
                                             "aerial_sh4_d9.npz"))
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    tree = P.N3Tree.open(path)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    opt = P.RenderOptions()
    leaf_map = P.build_leaf_map(tree)
    table = P.build_skip_table(tree, opt.sigma_thresh)
    torch.cuda.synchronize()
    depth = accel.tree_max_depth(tree)
    tree_bytes = nbytes(tree.data, tree.child, tree.parent,
                        tree.sample_counts, tree.scale, tree.offset)
    log(f"aerial artifact: {cap} chunks, depth {depth}, "
        f"{tree.data_format.to_string()}, built on the host in "
        f"{build_s:.1f} s, loaded in {load_s:.1f} s; on the device: tree "
        f"{tree_bytes / 1e6:.1f} MB, leaf map level {leaf_map.level} "
        f"(+{leaf_map.deep_levels} deep) {nbytes(leaf_map.rows) / 1e9:.3f} "
        f"GB, skip table {nbytes(table)} B")
    check(cap == 175_656 and depth == AERIAL_DEPTH
          and tree.data_format.to_string() == "SH4",
          "the aerial artifact is not the 175,656-chunk SH4 tree of depth 9")

    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    # -- the committed goldens (tests/test_golden.py:98 and :141) ------
    gopt = P.RenderOptions(background_brightness=0.9)
    fixtures = os.path.join(ROOT, "tests", "fixtures")
    gcam = aerial_camera(P.Camera, 160, 160)
    img, _ = P.render_frame(tree, gcam.width, gcam.height, gcam.fx, gcam.fy,
                            gcam.cx, gcam.cy, gcam.transform, gopt)
    check(kernels.LAUNCHES["exact_march"] > 0, "the exact golden frame did "
          "not run kernel E")
    p160 = psnr(render.to_rgba8(img).cpu().numpy().astype(np.float32)
                / 255.0, read_png(os.path.join(
                    fixtures, "aerial_sh4_d9_golden.png")) / 255.0)
    before = dict(kernels.LAUNCHES)
    gcam = aerial_camera(P.Camera, 512, 512)
    fast, overflow, _ = P.render_frame_fast(
        tree, leaf_map, gcam, gopt, max_dense=32, chunk_size=0,
        skip_table=table)
    check(not int(overflow), "the 512x512 golden frame overflowed")
    check(kernels.LAUNCHES["march"] > before["march"]
          and kernels.LAUNCHES["skip_prepass"] > before["skip_prepass"],
          "the fast golden frame did not run kernels A and B")
    p512 = psnr(render.to_rgba8(fast).cpu().numpy().astype(np.float32)
                / 255.0, read_png(os.path.join(
                    fixtures, "aerial_sh4_d9_golden512.png")) / 255.0)
    log(f"aerial goldens on the card: exact 160x160 (kernel E) PSNR "
        f"{p160:.2f} dB (> 48), fast 512x512 (A and B) PSNR {p512:.2f} dB "
        f"(> 45)")
    check(p160 > 48.0, f"exact golden PSNR {p160}")
    check(p512 > 45.0, f"fast golden PSNR {p512}")
    del img, fast

    # -- bench.py's 1080p protocol on the artifact ---------------------
    tune = P.device_tuning()
    cs, blk = tune.chunk_size, tune.block
    cam = camera(P.Camera, WIDTH, HEIGHT, FOCAL)
    bp = bench_protocol(P, tree, leaf_map, cam, opt, table, cs, blk,
                        "aerial 1080p")
    md, img, frame = bp.md, bp.img, bp.frame
    hk = hint_ray_kernels(P, kernels, dev, tree, leaf_map, table, cam, opt,
                          cs, blk, md, "aerial")
    a_args = hk.a_args

    # the exact frame: one launch of kernel E
    def exact_frame():
        return P.render_frame(tree, WIDTH, HEIGHT, cam.fx, cam.fy, cam.cx,
                              cam.cy, cam.transform, opt)[0]

    exact = exact_frame()
    diff_exact = float((exact - img).abs().max())
    log(f"aerial 1080p exact frame (kernel E) vs leaf-map frame: max abs "
        f"diff {diff_exact:.3e}")
    check(diff_exact <= 1e-5, "aerial exact frame differs from the leaf-map "
          "frame")
    transform = torch.as_tensor(cam.transform, dtype=torch.float32,
                                device=dev)
    edirs, ecen = screen2worlddir(WIDTH, HEIGHT, cam.fx, cam.fy, cam.cx,
                                  cam.cy, transform)
    me = accel.march_inputs(tree, edirs, rodrigues(opt.rot_dirs, edirs),
                            ecen, opt)
    e_args = (tree, me, opt, False, render.DEFAULT_MAX_LEVELS, 0)
    ke = uncounted(kernels, lambda: kernels.exact_march(*e_args))
    ka = uncounted(kernels, lambda: kernels.march(
        tree, leaf_map, me.cen, me.d, me.invdir, me.delta_scale, me.tmin,
        me.tmax, me.miss, me.basis, me.step_size, me.sigma_thresh,
        me.stop_thresh, md, me.use_sh))
    check(not int(ka[1]), "kernel A from tmin overflowed the hint budget")
    e_steps, e_shaded = int(ke[4].sum()), int(ka[3].sum())
    n_other = int((ka[2] != ke[4]).sum())
    ms_e, by_e, ev_e = alone(kernels, lambda: kernels.exact_march(*e_args),
                             10)
    be, be_by = exact_bound(me, ke[:3] + (ke[4],), e_steps, e_shaded,
                            tree.data_dim)
    log(f"aerial kernel E alone: {e_steps} steps (max {int(ke[4].max())}), "
        f"{e_shaded} shaded samples; kernel A from tmin: {n_other} rays "
        f"with other step counts than E")
    del ke, ka, me, edirs, ecen

    # kernel A's resumed descent: the same frame on a level-7 map
    lm7 = P.build_leaf_map(tree, level=7)
    check(lm7.deep_levels == 2, f"level-7 map has {lm7.deep_levels} deep "
          f"levels")
    out9 = frame(return_hints=True)
    out7 = frame(lm7, return_hints=True)
    diff7 = float((out7[0] - out9[0]).abs().max())
    same = [torch.equal(a, b) for a, b in zip(out7[2:], out9[2:])]
    log(f"aerial 1080p on a level-7 map (+2 deep): max abs diff "
        f"{diff7:.3e} to level 9; steps {int(out7[2].sum())} / "
        f"{int(out9[2].sum())}, records {int(out7[3].sum())} / "
        f"{int(out9[3].sum())}, skips {int(out7[4].sum())} / "
        f"{int(out9[4].sum())} (level 7 / level 9), equal per ray {same}")
    check(not out7[1].any(), "the level-7 frame overflowed")
    check(diff7 <= 1e-6, "the level-7 frame differs from the level-9 frame")
    check(all(same), "the level-7 frame's hints differ from level 9's")
    del out7, out9
    ms_a7, by_a7, ev_a7 = alone(
        kernels, lambda: kernels.march(tree, lm7, *a_args[2:]), 20)

    # times: CUDA events, 10 frames a round, the frames in turns
    rounds = {"leaf map": [], "exact": [], "level 7": []}
    for _ in range(ROUNDS):
        rounds["leaf map"].append(cuda_ms(frame, N_FRAMES))
        rounds["exact"].append(cuda_ms(exact_frame, N_FRAMES))
        rounds["level 7"].append(cuda_ms(lambda: frame(lm7), N_FRAMES))
    med = {k: sorted(v)[ROUNDS // 2] for k, v in rounds.items()}
    launches = read_launches(kernels, ("skip_prepass", "march",
                                       "exact_march"), "phase 23")
    peak = torch.cuda.max_memory_allocated()
    power = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    log(f"aerial 1080p times ({power}; phase 1: {smi}), median of "
        f"{ROUNDS} rounds of {N_FRAMES} frames: leaf-map frame "
        f"{med['leaf map']:.3f} ms, exact frame {med['exact']:.3f} ms, "
        f"level-7 frame {med['level 7']:.3f} ms (rounds "
        + "; ".join(f"{k} {[round(r, 3) for r in v]}"
                    for k, v in rounds.items()) + ")")
    log(f"aerial kernels alone ({power}): {hk.times}, on the level-7 map "
        f"{ms_a7:.4f} ms ({by_a7}; events {ev_a7:.4f}); exact_march "
        f"{ms_e:.4f} ms ({by_e}; events {ev_e:.4f}; bound {be:.4f} ms by "
        f"{be_by}, {100 * be / ms_e:.0f}%)")
    log(f"phase 23 in {time.perf_counter() - t_phase:.1f} s; launches "
        f"{launches}; peak memory {peak / 2**30:.2f} GiB")
    return launches


# ----------------------------------------------------------------------
# Phase 24: bench_torch.py, the port's benchmark entry point
# ----------------------------------------------------------------------
def bench_phase(dev, aerial_path):
    """Phase 24: ``bench_torch.py``.  First its timed loop in this process
    under sync debug mode "error" (:func:`no_host_sync`), at 1080p on the
    shell (the ladder) and on phase 23's aerial artifact (chunk-exact
    budgets), in pixel and in ray order: no frame of the loop waits on the
    card.  Then ``python3 bench_torch.py`` with no arguments in a fresh
    process, ``BENCH_AERIAL_FIXTURE`` naming the artifact: exit 0, one
    stdout line, no ``error``, ``smoke`` or ``v5e8`` key, and the shell's
    and the artifact's fps in both orders above 0.  Returns the bench
    run's kernel launches (its ``# launches`` line on stderr)."""
    import bench_torch
    t_phase = time.perf_counter()
    for source, what in ((8, "shell"), (aerial_path, "aerial")):
        s = bench_torch.setup_source(source, WIDTH, HEIGHT)
        for fn in (s.frame, s.frame_sorted):
            fn()
            acc = no_host_sync(lambda: bench_torch.chain(
                fn, N_FRAMES, torch.zeros((), device=dev)))
            check(bool(torch.isfinite(acc)), f"phase 24 {what}: checksum")
        budgets = s.seg_counts if s.seg_counts is not None else s.segments
        log(f"phase 24 {what}: the timed loop ({N_FRAMES} frames, pixel "
            f"and ray order) ran with no host sync; hint budget "
            f"{s.max_dense}, budgets {list(budgets)}")
        del s, fn
        torch.cuda.empty_cache()

    launches, wall = bench_run(
        [], ("value", "sorted_mode_fps", "aerial_fps",
             "aerial_sorted_mode_fps"), "phase 24",
        BENCH_AERIAL_FIXTURE=aerial_path)
    log(f"phase 24 in {time.perf_counter() - t_phase:.1f} s (the bench "
        f"run {wall:.1f} s); launches {launches}")
    return launches


def script_env(**extra):
    """This process's environment less the ``BENCH_`` knobs, unbuffered,
    with ``extra``: a script in a fresh process runs at its defaults."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("BENCH_")}
    env.update(PYTHONUNBUFFERED="1", **extra)
    return env


def bench_run(args, keys, what, **extra_env):
    """``python3 bench_torch.py *args`` in a fresh process: exit 0, one
    stdout line without ``error``, ``smoke`` or a ``v5e8`` key, each of
    ``keys`` above 0, kernels A and B launched; its stderr's comment lines
    and its line logged beside the card.  Returns (its launches, wall
    seconds)."""
    import bench_torch
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, os.path.join(ROOT, "bench_torch.py")] + args,
        cwd=ROOT, env=script_env(**extra_env), capture_output=True,
        text=True, timeout=900)
    wall = time.perf_counter() - t0
    for line in r.stderr.splitlines():
        if line.startswith("# "):
            log(f"{what} bench_torch.py stderr: {line}")
    check(r.returncode == 0, f"bench_torch.py {args} exited "
          f"{r.returncode}: {r.stderr[-3000:]}")
    lines = [ln for ln in r.stdout.splitlines() if ln.strip()]
    check(len(lines) == 1, f"bench_torch.py printed {len(lines)} lines")
    rec = json.loads(lines[0])
    power = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    log(f"{what} card: {power}")
    log(f"{what} {' '.join(['bench_torch.py'] + args)} line: {lines[0]}")
    check("error" not in rec and not rec.get("smoke"),
          f"bench_torch.py record: {rec}")
    for key in keys:
        check(rec.get(key, 0) > 0, f"bench_torch.py {key}: {rec.get(key)}")
    check(not [k for k in rec if "v5e8" in k], "a v5e8 key in the record")
    mark = bench_torch.LAUNCHES_MARK
    launches = json.loads(next(ln for ln in r.stderr.splitlines()
                               if ln.startswith(mark))[len(mark):])
    check(launches["skip_prepass"] > 0 and launches["march"] > 0,
          f"the bench run did not launch kernels A and B: {launches}")
    return launches, wall


# ----------------------------------------------------------------------
# Phase 25: the benchmark scripts and the examples
# ----------------------------------------------------------------------
# the kernels each benchmarks_torch/ script reaches at its defaults (its
# line's keys: benchmarks_torch/_overrides_torch.py)
SCRIPTS = {
    "guided1080p": ("skip_prepass", "collect", "compact_composite"),
    "motion1080p": ("skip_prepass", "march"),
    "motion_guided1080p": ("skip_prepass", "collect", "compact_composite"),
    "foveated1080p": ("skip_prepass", "march"),
    "refine_throughput": ("march",),
    "parity": ("march",),
    "orbit4k": ("skip_prepass", "march"),
}
QUICKSTART_KERNELS = ("skip_prepass", "march", "collect",
                      "compact_composite", "exact_march")
MULTIHOST_KERNELS = ("march",)


def script_invariants(name, rec, stderr):
    """Phase 25's check of each script's own invariant."""
    if name == "guided1080p":
        seg = [ln for ln in stderr.splitlines()
               if ln.startswith("# mlp_samples: ")]
        check(len(seg) == 1, "guided1080p printed no segmented count")
        n_seg = int(seg[0].rsplit(" ", 1)[1])
        check(n_seg == rec["mlp_samples"] > 0,
              f"guided1080p: ordered {rec['mlp_samples']} samples, "
              f"segmented {n_seg}")
    elif name == "parity":
        check(rec["frac_within_1e-3"] == 1.0 and rec["max_err"] <= 1e-3,
              f"parity: {rec}")
    elif name == "motion1080p":
        check(rec["hint_rebuilds"] > 0, "motion1080p rebuilt no hints")
    elif name == "refine_throughput":
        check(rec["total_added"] > 0, "refine_throughput added nothing")
    elif name == "orbit4k":
        check(rec["devices"] == 1, f"orbit4k on {rec['devices']} devices")


def load_script(name):
    """``benchmarks_torch/<name>.py`` loaded by file path (its prelude puts
    its helper module on ``sys.path``)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        f"torch_bench_{name}",
        os.path.join(ROOT, "benchmarks_torch", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@contextlib.contextmanager
def plain_kernels(kernels):
    """Within the block kernels A's and B's wrappers run their plain
    versions on the card's tensors (A's gated launch as the CPU path
    branches it), so a path's own calls give the plain path's result on
    the same inputs.  Fails if a kernel launched inside the block."""
    from unittest import mock
    from mega_nerf_viewer_tpu_torch.ops import accel
    from mega_nerf_viewer_tpu_torch.ops import skip_prepass as sp

    def march(*args, votes=None, render_depth=False, gate=None, into=None):
        if gate is not None and not bool((gate != 0).any()):
            return (into[0], torch.zeros((), dtype=torch.int32,
                                         device=into[0].device)) \
                + tuple(into[1:])
        res = accel.render_rays_fast_reference(
            *args, chunk_size=1 << 20, votes=votes,
            render_depth=render_depth)
        if into is None:
            return res
        for buf, r in zip(into, res[:1] + res[2:]):
            buf.copy_(r)
        return (into[0], res[1]) + tuple(into[1:])

    saved = dict(kernels.LAUNCHES)
    with mock.patch.object(kernels, "march", march), \
            mock.patch.object(kernels, "skip_prepass",
                              sp.entry_skip_prepass_reference):
        yield
    check(dict(kernels.LAUNCHES) == saved,
          "a kernel launched inside the plain path")


def script_paths_against_plain(P, kernels, dev):
    """Phase 25 in this process, uncounted: ``orbit4k.py``'s first pose at
    its defaults (3840x2160, depth 8, a world of one) and
    ``refine_throughput.py``'s first vote frame (512x512, the depth-7
    tree of capacity 400,000), each through the script's own calls with
    kernels A and B, then again with their plain versions on the same
    card inputs: integers equal, pixels within 1e-6."""
    import torch.distributed as dist
    from mega_nerf_viewer_tpu_torch.ops import accel
    t0 = time.perf_counter()
    orbit = load_script("orbit4k")
    s = orbit.scene(device=dev)
    orbit.next_pose(s, 8)
    img_k, md, *hints_k = uncounted(kernels, lambda: orbit.hint_frame(s))
    with plain_kernels(kernels):
        img_p, md_p, *hints_p = orbit.hint_frame(s, md)
    check(md_p == md, f"orbit4k plain hint frame settled at {md_p}, the "
          f"kernels' at {md}")
    for name, a, b in zip(("steps", "records", "skips"), hints_k, hints_p):
        check(torch.equal(a, b), f"orbit4k hint frame {name} differ from "
              f"the plain path")
    err_h = float((img_k - img_p).abs().max())
    check(err_h <= 1e-6, f"orbit4k hint frame differs by {err_h}")
    order = accel.order_from_hints(*hints_k)
    img_s, segments = uncounted(kernels, lambda: orbit.settle(s, order))
    with plain_kernels(kernels):
        img_sp, ov_p = orbit.sharded_frame(s, order, segments)
    check(not bool(ov_p.any()), "orbit4k plain sharded frame overflowed")
    err_s = float((img_s - img_sp).abs().max())
    err_sh = float((img_s - img_k).abs().max())
    check(err_s <= 1e-6, f"orbit4k settled sharded frame differs from the "
          f"plain path by {err_s}")
    check(err_sh <= 1e-6, f"orbit4k settled sharded frame differs from "
          f"its hint frame by {err_sh}")
    steps, nrec, skips = (int(h.sum()) for h in hints_k)
    log(f"phase 25 orbit4k pose 0 at {s.cam.width}x{s.cam.height} against "
        f"the plain path: hint frame at max_dense {md}, {steps} steps, "
        f"{nrec} records, {skips} skips equal, max abs diff {err_h:.3e}; "
        f"settled sharded frame (world {s.world}, segments "
        f"{list(segments)}) max abs diff {err_s:.3e}, {err_sh:.3e} to the "
        f"hint frame")
    del s, img_k, img_p, img_s, img_sp, hints_k, hints_p, order
    dist.destroy_process_group()
    torch.cuda.empty_cache()

    refine = load_script("refine_throughput")
    r = refine.scene(device=dev)
    lm = P.build_leaf_map(r.tree)
    vk = uncounted(kernels, lambda: refine.vote_frame(r, r.tree, lm))
    with plain_kernels(kernels):
        vp = refine.vote_frame(r, r.tree, lm)
    for name in ("overflow", "steps", "nrec", "split_vote", "sample_vote"):
        check(torch.equal(getattr(vk, name), getattr(vp, name)),
              f"refine vote frame {name} differs from the plain path")
    err_v = float((vk.out - vp.out).abs().max())
    check(err_v <= 1e-6, f"refine vote frame differs by {err_v}")
    log(f"phase 25 refine_throughput vote frame ({r.dirs.shape[0]} rays, "
        f"capacity {r.tree.max_capacity}) against the plain path: overflow "
        f"{int(vk.overflow)}, {int(vk.steps.sum())} steps, "
        f"{int(vk.nrec.sum())} records, split and sample votes equal, max "
        f"abs diff {err_v:.3e} "
        f"({time.perf_counter() - t0:.1f} s)")
    del r, lm, vk, vp
    torch.cuda.empty_cache()


def multihost_rank_main(rank, port, outdir):
    """A rank of phase 25's multihost example: the example's ``main`` (two
    ranks on the one card ask for gloo), then its kernel launches as JSON
    in ``outdir``."""
    import importlib.util
    from mega_nerf_viewer_tpu_torch import kernels
    spec = importlib.util.spec_from_file_location(
        "multihost_render_torch",
        os.path.join(ROOT, "examples", "multihost_render_torch.py"))
    ex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ex)
    kernels.reset_launch_counts()
    ex.main(rank, int(port), outdir=outdir)
    torch.cuda.synchronize()
    with open(os.path.join(outdir, f"launches{rank}.json"), "w") as f:
        json.dump(dict(kernels.LAUNCHES), f)
    return 0


def scripts_phase(P, kernels, smi):
    """Phase 25: each ``benchmarks_torch/`` script at its defaults in a
    fresh process (exit 0, ONE JSON line without ``smoke`` or ``error``,
    JAX's keys less the named drops, the kernels it reaches launched, its
    invariant), then ``examples/quickstart_torch.py`` in this process
    (every PNG written) and ``examples/multihost_render_torch.py`` as two
    ranks sharing the card under gloo (both ranks' frames equal to this
    process's single-device frame).  Returns the launches of the scripts'
    runs and the examples', summed."""
    import importlib.util
    from mega_nerf_viewer_tpu_torch.utils.png import read_png
    t_phase = time.perf_counter()
    total = {}
    env = script_env()
    mark = "# launches "
    contract = load_script("_overrides_torch")
    for name, needs in SCRIPTS.items():
        t0 = time.perf_counter()
        r = subprocess.run(
            [sys.executable, os.path.join(ROOT, "benchmarks_torch",
                                          name + ".py")],
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t0
        check(r.returncode == 0, f"{name} exited {r.returncode}: "
              f"{r.stderr[-3000:]}")
        lines = [ln for ln in r.stdout.splitlines() if ln.strip()]
        check(len(lines) == 1, f"{name} printed {len(lines)} lines")
        rec = json.loads(lines[0])
        check("smoke" not in rec and "error" not in rec,
              f"{name} record: {rec}")
        check(rec.get("metric") == contract.JAX_KEYS[name][0]
              and set(rec) == contract.port_keys(name),
              f"{name} keys {sorted(rec)} are not JAX's less the drops")
        launches = json.loads(next(
            ln for ln in r.stderr.splitlines()
            if ln.startswith(mark))[len(mark):])
        missing = [k for k in needs if launches[k] == 0]
        check(not missing, f"{name}: {missing} never launched: {launches}")
        script_invariants(name, rec, r.stderr)
        add_launches(total, launches)
        card = next((ln for ln in r.stderr.splitlines()
                     if ln.startswith("# card: ")), "# card: ?")
        log(f"phase 25 {name} ({card[2:]}; {wall:.1f} s): {lines[0]}")
        for ln in r.stderr.splitlines():
            if ln.startswith("# ") and not ln.startswith(("# card: ", mark)):
                log(f"phase 25 {name} stderr: {ln}")
        log(f"phase 25 {name} launches "
            f"{ {k: n for k, n in launches.items() if n} }")

    # two of the scripts' paths against their plain versions, uncounted
    script_paths_against_plain(P, kernels, torch.device("cuda"))

    # the quickstart, in this process
    spec = importlib.util.spec_from_file_location(
        "quickstart_torch", os.path.join(ROOT, "examples",
                                         "quickstart_torch.py"))
    qs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(qs)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as td:
        said = io.StringIO()
        with contextlib.redirect_stdout(said):
            res = qs.main(td)
        check(said.getvalue().count("wrote ") == len(qs.STEPS),
              f"quickstart said: {said.getvalue()}")
        launches = read_launches(kernels, QUICKSTART_KERNELS,
                                 "phase 25 quickstart")
        for name in qs.STEPS:
            img = read_png(os.path.join(td, f"{name}.png"))
            check(img.shape == (400, 400, 4), f"quickstart {name}.png "
                  f"{img.shape}")
        check(os.path.exists(res.state), "no session checkpoint")
    check(res.capacity[1] > res.capacity[0], "quickstart refined nothing")
    add_launches(total, launches)
    log(f"phase 25 quickstart ({smi}; {time.perf_counter() - t0:.1f} s): "
        f"{len(qs.STEPS)} PNGs of 400x400 written, refinement "
        f"{res.capacity[0]} -> {res.capacity[1]} chunks; launches "
        f"{ {k: n for k, n in launches.items() if n} }")

    # the multihost example: two ranks on the one card
    spec = importlib.util.spec_from_file_location(
        "multihost_render_torch", os.path.join(ROOT, "examples",
                                               "multihost_render_torch.py"))
    mh = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mh)
    tree = P.sphere_tree(basis_dim=4, depth=4)
    cam, opt = mh.frame_setup()
    single = uncounted(kernels, lambda: P.render_frame_fast(
        tree, P.build_leaf_map(tree), cam, opt, max_dense=32,
        chunk_size=0)[0]).cpu().numpy()
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as td:
        errs = [open(os.path.join(td, f"rank{r}.err"), "w+")
                for r in (0, 1)]
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--multihost-rank",
             str(r), str(port), td], cwd=ROOT,
            stdout=subprocess.DEVNULL, stderr=errs[r]) for r in (0, 1)]
        deadline = time.perf_counter() + 300
        try:
            for p in procs:
                p.wait(timeout=max(1.0, deadline - time.perf_counter()))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, (p, e) in enumerate(zip(procs, errs)):
            e.seek(0)
            check(p.returncode == 0,
                  f"multihost rank {r} failed:\n{e.read()[-3000:]}")
            e.close()
        frames = [np.load(os.path.join(td, f"frame_rank{r}.npy"))
                  for r in (0, 1)]
        check(os.path.exists(os.path.join(td, "multihost_frame.png")),
              "multihost rank 0 wrote no PNG")
        with open(os.path.join(td, "launches0.json")) as f:
            launches = json.load(f)
    for r, fr in enumerate(frames):
        err = float(np.abs(fr - single).max())
        check(fr.shape == single.shape and err <= 1e-6,
              f"multihost rank {r} frame differs from one process's by "
              f"{err}")
    missing = [k for k in MULTIHOST_KERNELS if launches[k] == 0]
    check(not missing, f"multihost: {missing} never launched: {launches}")
    add_launches(total, launches)
    same = all(np.array_equal(fr, single) for fr in frames)
    log(f"phase 25 multihost ({smi}; {time.perf_counter() - t0:.1f} s): "
        f"two gloo ranks on the card, both frames "
        f"{'bit-equal to' if same else 'within 1e-6 of'} the single-device "
        f"frame, alpha max {float(single[..., 3].max()):.3f}; rank 0 "
        f"launches { {k: n for k, n in launches.items() if n} }")
    log(f"phase 25 in {time.perf_counter() - t_phase:.1f} s; launches "
        f"{ {k: n for k, n in total.items() if n} }")
    return total


# ----------------------------------------------------------------------
# Phase 26: the motion probes
# ----------------------------------------------------------------------
# each tools_torch/ probe and the kernels it reaches at its defaults (the
# margin probe gets phase 23's artifact)
PROBES = {
    "motion_phase_timing": ("march",),
    "motion_viewer_probe": ("skip_prepass", "march"),
    "probe_motion_margin": ("skip_prepass", "march"),
}
PHASE_STAGES = ("A", "B", "C", "C2", "C3", "D", "D2", "E", "E2", "F", "G")
JAX_WRAPS = {"dilate", "order", "frame"}


def probe_invariants(name, rec):
    """Phase 26's check of each probe's own record."""
    if name == "motion_phase_timing":
        check(tuple(rec["stages"]) == PHASE_STAGES,
              f"motion_phase_timing stages {list(rec['stages'])}")
        check(all(st["device_ms"] is not None and st["device_ms"] >= 0
                  for st in rec["stages"].values()),
              "motion_phase_timing: a stage has no device time")
        check(rec["stages"]["C3"]["launches"].get("march", 0) > 0,
              "motion_phase_timing: the C3 frame launched no march")
    elif name == "motion_viewer_probe":
        check(set(rec["headroom"]) == {"headroom", "NO-headroom"},
              "motion_viewer_probe ran no headroom experiment")
        rehint, dilate = rec["poses"]["rehint"], rec["poses"]["dilate"]
        check(len(rehint) == len(dilate) == 6, "motion_viewer_probe poses")
        check(all(set(p["split"]) == {"motion"} for p in rehint),
              f"motion_viewer_probe: a re-hint pose did not split into "
              f"motion alone: {[p['split'] for p in rehint]}")
        check(all(p["split"] and set(p["split"]) <= JAX_WRAPS
                  for p in dilate)
              and any(set(p["split"]) == JAX_WRAPS for p in dilate),
              f"motion_viewer_probe: the dilate poses did not split into "
              f"the three JAX stages: {[p['split'] for p in dilate]}")
        check(all(p["finite"] for m in (rehint, dilate) for p in m),
              "motion_viewer_probe: a pose has non-finite pixels")
    elif name == "probe_motion_margin":
        check(rec["world"] == 1 and set(rec["margins"]) == {"1", "0"},
              f"probe_motion_margin: world {rec.get('world')}, margins "
              f"{list(rec['margins'])}")
        for m, r in rec["margins"].items():
            check(r["overflow"] <= r["tol"],
                  f"probe_motion_margin margin {m} did not settle: {r}")


def phase_c3_against_plain(kernels):
    """``motion_phase_timing.py``'s C3 frame (the directional motion order
    at headroom budgets, no skip table: kernel A) at its defaults, then the
    same call with A and B swapped for their plain versions on the same
    card inputs: overflow counts and packed hints equal, pixels within
    1e-6.  Uncounted."""
    import importlib.util
    t0 = time.perf_counter()
    spec = importlib.util.spec_from_file_location(
        "torch_tool_motion_phase_timing",
        os.path.join(ROOT, "tools_torch", "motion_phase_timing.py"))
    mpt = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mpt)
    ns = uncounted(kernels, lambda: mpt.setup(device="cuda"))

    def c3():
        return mpt.frame(ns, ns.order_md, ns.segs_motion_dir, "packed")
    img_k, ov_k, ph_k = uncounted(kernels, c3)
    with plain_kernels(kernels):
        img_p, ov_p, ph_p = c3()
    check(torch.equal(ov_k, ov_p), f"C3 overflow counts {ov_k.tolist()} "
          f"against the plain path's {ov_p.tolist()}")
    check(torch.equal(ph_k, ph_p), "C3 packed hints differ from the plain "
          "path's")
    err = float((img_k - img_p).abs().max())
    check(err <= 1e-6, f"C3 frame differs from the plain path by {err}")
    log(f"phase 26 motion_phase_timing C3 frame against the plain path: "
        f"segments {[(float(f), int(b)) for f, b in ns.segs_motion_dir]}, "
        f"overflow counts {ov_k.tolist()} equal, packed hints equal, max "
        f"abs diff {err:.3e} ({time.perf_counter() - t0:.1f} s)")
    del ns, img_k, img_p, ph_k, ph_p
    torch.cuda.empty_cache()


def probe_run(name, args, what):
    """``tools_torch/<name>.py *args`` in a fresh process at its defaults:
    exit 0, its lines forwarded, ``done`` last, one JSON line without
    ``smoke``, the kernels it reaches launched, its invariant.  Returns
    (its record, wall seconds)."""
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools_torch", name + ".py")]
        + args, cwd=ROOT, env=script_env(), capture_output=True, text=True,
        timeout=300)
    wall = time.perf_counter() - t0
    check(r.returncode == 0, f"{name} exited {r.returncode}: "
          f"{r.stderr[-3000:]}")
    lines = [ln for ln in r.stdout.splitlines() if ln.strip()]
    check(lines and lines[-1] == "done", f"{name} did not finish: "
          f"{lines[-3:]}")
    recs = [ln for ln in lines if ln.startswith("{")]
    check(len(recs) == 1, f"{name} printed {len(recs)} JSON lines")
    rec = json.loads(recs[0])
    check("smoke" not in rec, f"{name} ran as a smoke run")
    for ln in lines:
        if not ln.startswith("{") and ln != "done":
            log(f"{what} {name}: {ln}")
    missing = [k for k in PROBES[name] if rec["launches"][k] == 0]
    check(not missing, f"{name}: {missing} never launched: "
          f"{rec['launches']}")
    probe_invariants(name, rec)
    return rec, wall


def probes_phase(kernels, smi, aerial_path):
    """Phase 26: each ``tools_torch/`` probe at its defaults in a fresh
    process (exit 0, its lines forwarded, its JSON line without ``smoke``,
    the kernels it reaches launched, its invariant), the margin probe on
    phase 23's aerial artifact; then the C3 frame against the plain path.
    Returns the probes' launches, summed."""
    t_phase = time.perf_counter()
    total = {}
    for name in PROBES:
        args = [aerial_path] if name == "probe_motion_margin" else []
        rec, wall = probe_run(name, args, "phase 26")
        add_launches(total, rec["launches"])
        log(f"phase 26 {name} ({rec['card']}; {wall:.1f} s) launches "
            f"{ {k: n for k, n in rec['launches'].items() if n} }")
    phase_c3_against_plain(kernels)
    log(f"phase 26 in {time.perf_counter() - t_phase:.1f} s ({smi}); "
        f"launches { {k: n for k, n in total.items() if n} }")
    return total


# ----------------------------------------------------------------------
# Phase 27: the depth-11 regime
# ----------------------------------------------------------------------
# gen_fixtures.make_huge_scene_npz: the aerial field two levels deeper
HUGE_DEPTH = 11
# the Viewer's max_tree_capacity, make_huge_scene_npz's chunk cap
VIEWER_CAPACITY = 3_200_000
HUGE_CHUNKS = 2_817_022
# the leaf-map level device_tuning caps at on 80 GB (utils/tuning.py)
HUGE_LEVEL = 10
# the exact oracle's crop of the 1080p frame, and the Viewer's moved poses
CROP = 256
VIEWER_POSES = 6
PAIRS = 10


def built(fn):
    """(result, seconds, GiB allocated before, GiB by which the allocator's
    peak rose above that) of one call of ``fn``, the card synchronized."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (out, time.perf_counter() - t, base / 2**30,
            (torch.cuda.max_memory_allocated() - base) / 2**30)


def paired(fa, fb):
    """Medians of ``fa``'s and ``fb``'s ms a frame (CUDA events,
    N_FRAMES frames a turn) over PAIRS pairs, the order alternating, and
    the turns."""
    a, b, n = [], [], PAIRS
    for i in range(n):
        for f, out in ((fa, a), (fb, b))[::1 if i % 2 == 0 else -1]:
            out.append(cuda_ms(f, N_FRAMES))
    return sorted(a)[n // 2], sorted(b)[n // 2], a, b


def deep_maps(P, accel, tree, opt):
    """The depth-11 tree's maps, each build's seconds and memory logged:
    the default map (level 10, ``deep_levels`` 1), the turbo map beside it
    (built, held against the default map's node column, and dropped) and
    the level-9 map (``deep_levels`` 2, JAX's v5e regime)."""
    lm, s10, base, gib10 = built(lambda: P.build_leaf_map(tree))
    free = torch.cuda.mem_get_info()[0]
    check(lm.level == HUGE_LEVEL and lm.deep_levels == 1,
          f"the default map is level {lm.level} (+{lm.deep_levels} deep)")
    turbo, s_t, base_t, gib_t = built(lambda: accel.build_turbo_leaf_map(
        tree, sigma_thresh=opt.sigma_thresh))
    check(turbo.level == HUGE_LEVEL and torch.equal(turbo.rows[:, 0],
                                                    lm.rows[:, 0]),
          "the turbo map's nodes differ from the default map's")
    del turbo
    torch.cuda.empty_cache()
    lm9, s9, base9, gib9 = built(lambda: P.build_leaf_map(
        tree, level=HUGE_LEVEL - 1))
    check(lm9.deep_levels == 2, f"the level-9 map has {lm9.deep_levels} "
          f"deep levels")
    log(f"phase 27 maps: level {lm.level} (+{lm.deep_levels} deep), rows "
        f"{nbytes(lm.rows) / 2**30:.2f} GiB, built in {s10:.2f} s, peak "
        f"+{gib10:.2f} GiB over {base:.2f} GiB resident "
        f"({gib10 * 2**30 / nbytes(lm.rows):.2f}x the rows), "
        f"{free / 2**30:.2f} GiB free after it; turbo map {s_t:.2f} s, peak "
        f"+{gib_t:.2f} GiB over {base_t:.2f} GiB; level-9 map (+2 deep) "
        f"{s9:.2f} s, peak +{gib9:.2f} GiB over {base9:.2f} GiB")
    return lm, lm9


def deep_guided(P, kernels, dev, tree, lm, table, cam):
    """One guided stop on the depth-11 tree at 1080p: kernel C against its
    plain version (t bit-equal, counts equal) on the 2^30-cell map and
    alone with its bound; ``collect_and_query_fast`` with
    ``guided1080p.py``'s synthetic model (median of 3) and
    ``composite_frame``; kernel D against its plain version on the stop's
    cache and alone with its bound."""
    from mega_nerf_viewer_tpu_torch.ops import compact_composite as cc
    from mega_nerf_viewer_tpu_torch.ops import guided
    from mega_nerf_viewer_tpu_torch.ops.rays import screen2worlddir
    B = tree.data_format.basis_dim
    model = P.MegaNeRFModel.synthetic(data_dim=int(tree.data_dim),
                                      **GUIDED_MODEL)
    opt = P.RenderOptions(max_guided_samples=GUIDED_S, need_viewdir=True,
                          use_guided_sampling=True,
                          basis_minmax=(0, B - 1))
    dirs, cen = screen2worlddir(
        WIDTH, HEIGHT, cam.fx, cam.fy, cam.cx, cam.cy,
        torch.as_tensor(cam.transform, device=dev))
    c = guided.collect_inputs(tree, dirs, cen, opt, table)
    c_args = (tree, lm, c.cen, c.d, c.invdir, c.delta_scale, c.tmin, c.tmax,
              c.miss, GUIDED_S, c.step_size, c.sigma_thresh, c.stop_thresh)
    ok = uncounted(kernels, lambda: kernels.collect(*c_args))
    op = guided.collect_t_fast_reference(*c_args)
    check(torch.equal(ok[0].view(torch.int32), op[0].view(torch.int32)),
          "phase 27 collect t_buf not bit-equal to the plain version")
    for name, a, b in zip(("ns", "steps", "overflow"), ok[1:], op[1:]):
        check(torch.equal(a, b), f"phase 27 collect {name} differs")
    steps_c = int(ok[2].sum())
    ms_c, by_c, ev_c = alone(kernels, lambda: kernels.collect(*c_args), 20)
    bc, bc_by = bound_ms(
        nbytes(c.d, c.invdir, c.delta_scale, c.tmin, c.tmax, c.miss, ok[0],
               ok[1], ok[2]) + 8 * steps_c, MARCH_OPS_PER_STEP * steps_c)
    log(f"phase 27 kernel collect against its plain version over "
        f"{dirs.shape[0]} rays: t_buf bit-equal, {int(ok[1].sum())} "
        f"samples, {steps_c} steps, {int(ok[3])} overflowing rays equal; "
        f"{ms_c:.4f} ms ({by_c}; events {ev_c:.4f}; bound {bc:.4f} ms by "
        f"{bc_by}, {100 * bc / ms_c:.0f}%)")
    del c, ok, op, dirs

    def stop():
        return P.collect_and_query_fast(tree, lm, model, cam, opt,
                                        chunk_size=min(1920, WIDTH),
                                        skip_table=table)

    cache, first_ms = timed(stop)
    cache, stop_ms, runs = median3(stop)
    img = P.composite_frame(tree, cam, opt, cache)
    comp_ms = sorted(cuda_ms(lambda: P.composite_frame(tree, cam, opt,
                                                       cache), N_FRAMES)
                     for _ in range(ROUNDS))[ROUNDS // 2]
    check(bool(torch.isfinite(img).all())
          and bool((img[..., 3] == 1).all())
          and float(img[..., :3].max()) > 0, "phase 27 guided frame")
    d_args = (cache["results_c"], cache["z_c"], cache["ray_of_p"],
              cache["offs"], cache["num_samples"], cache["vdirs_c"])
    total = int(cache["offs"][-1])
    ok = uncounted(kernels, lambda: cc.composite_results_compact_kernel(
        *d_args, opt, B, True))
    op = cc.composite_results_compact_reference(*d_args, opt, B, True)
    err_d = float((ok - op).abs().max())
    check(bool(torch.isfinite(ok).all()) and err_d <= 1e-6,
          f"phase 27 compact composite differs by {err_d}")
    ms_d, by_d, ev_d = alone(kernels, lambda: (
        cc.composite_results_compact_kernel(*d_args, opt, B, True)), 20)
    bd, bd_by = composite_bound(cache["results_c"], cache["offs"],
                                cache["num_samples"], total, B,
                                opt.basis_minmax, True)
    log(f"phase 27 guided stop (S {GUIDED_S}, model {model.n_clusters} "
        f"clusters x {len(model.params.weights)} layers x "
        f"{GUIDED_MODEL['hidden']}): first {first_ms:.1f} ms, median "
        f"{stop_ms:.3f} ms (runs {[round(r, 3) for r in runs]}), "
        f"{total} MLP samples; composite {comp_ms:.3f} ms/frame; kernel "
        f"compact_composite against its plain version: max abs diff "
        f"{err_d:.3e}, {ms_d:.4f} ms ({by_d}; events {ev_d:.4f}; bound "
        f"{bd:.4f} ms by {bd_by}, {100 * bd / ms_d:.0f}%)")
    return model


def deep_viewer(P, kernels, tree, model, want):
    """The Viewer on the depth-11 tree at 1080p, ``max_tree_capacity``
    3,200,000: parked frames (settled, then timed; the last within 1e-6
    of ``want``, the direct frame); ``VIEWER_POSES`` moved poses of
    ``motion1080p.py``'s orbit under the async policy with re-hint at the
    Viewer's defaults (the flags read every ``motion_flag_interval``
    poses), then as many with the flags read every pose, each pose off a
    fresh frame on no more pixels than its flags report, its truncated
    rays logged against the tolerance (within it on every pose whose
    flags are read every pose); parked frames again, settled back
    to a fresh frame's pixels; then one splitting frame with the model (its
    exact vote frame with visit marks, the expand) and one parked frame
    that rebuilds the level-10 map on the grown tree, its build seconds
    and memory logged."""
    from mega_nerf_viewer_tpu_torch import viewer as VI
    cs = P.device_tuning().chunk_size
    v = P.Viewer(tree, camera=camera(P.Camera, WIDTH, HEIGHT, FOCAL),
                 max_tree_capacity=VIEWER_CAPACITY)
    v.overflow_policy = "async"
    R = WIDTH * HEIGHT
    tol = int(R * v.motion_overflow_tolerance)

    def flags():
        """The last frame's truncated rays per segment."""
        p = v._pending_ov
        return np.zeros(1, np.int64) if p is None else VI._host_array(p[1])

    def fresh():
        return uncounted(kernels, lambda: fresh_frame(
            P, v.tree, v._leaf_map, v.camera, v.options, cs,
            v._skip_table))

    def settle(what):
        for _ in range(12):
            v.render(fetch=False)
            if not flags().any():
                break
        check(not flags().any(), f"the Viewer's parked frames did not "
              f"settle {what}")

    v.render(fetch=False)
    settle("at the start")
    parked = [timed(lambda: v.render(fetch=False))[1]
              for _ in range(N_FRAMES)]
    img = v.render(fetch=False)
    err = float((img - want).abs().max())
    check(err <= 1e-6, f"the Viewer's parked frame differs from the direct "
          f"frame by {err}")
    check(v._leaf_map.level == HUGE_LEVEL, "the Viewer's map level")
    episodes = {}
    for interval in (v.motion_flag_interval, 1):
        v.motion_flag_interval = interval
        poses = episodes[interval] = []
        for _ in range(VIEWER_POSES):
            motion_step(v.camera, 3.0)
            img, ms = timed(lambda: v.render(fetch=False))
            fl = flags()
            trunc = int(fl.sum())
            n_diff = int(((img - fresh()).abs() > 1e-6).any(-1).sum())
            check(n_diff <= trunc, f"an async pose: {n_diff} pixels differ "
                  f"from a fresh frame, its flags report {trunc}")
            check(bool(torch.isfinite(img).all()), "non-finite pose pixels")
            poses.append(dict(ms=round(ms, 3), truncated=trunc,
                              segment_max=int(fl.max()), diff=n_diff))
    settle("after the poses")
    err_back = float((v.render(fetch=False) - fresh()).abs().max())
    check(err_back <= 1e-6, f"the parked frame after the poses differs from "
          f"a fresh frame by {err_back}")
    over = {k: sum(p["truncated"] > tol for p in ps)
            for k, ps in episodes.items()}
    # with the flags read every pose, each pose's budgets come from the
    # previous pose's measured CDF: every pose stays within the tolerance
    check(not over[1], f"async poses with the flags read every pose "
          f"truncated over the tolerance {tol}: {episodes[1]}")
    cap0 = int(v.tree.capacity)
    v.model = model
    v.options = v.options.replace(**REFINE_OPT)
    n_e = kernels.LAUNCHES["exact_march"]
    img, edit_ms = timed(lambda: v.render(fetch=False))
    cap1 = int(v.tree.capacity)
    check(kernels.LAUNCHES["exact_march"] > n_e, "the splitting frame did "
          "not run kernel E")
    check(cap1 > cap0 and bool(torch.isfinite(img).all()),
          f"the splitting frame: capacity {cap0} -> {cap1}")
    check(v._leaf_map is None, "the edit left the leaf map standing")
    v.options = v.options.replace(use_splitting=False)
    img, rebuild_s, base, gib = built(lambda: v.render(fetch=False))
    lm = v._leaf_map
    check(lm.level == HUGE_LEVEL and bool(torch.isfinite(img).all()),
          f"the rebuilt map is level {lm.level}")
    log(f"phase 27 Viewer (max_tree_capacity {VIEWER_CAPACITY}, async "
        f"re-hint): parked {sorted(parked)[N_FRAMES // 2]:.3f} ms/frame "
        f"(median of {N_FRAMES}; max abs diff {err:.3e} to the direct "
        f"frame); {VIEWER_POSES} poses at 3 degrees a flag interval, "
        f"tolerance {tol} rays, poses over it (of the frame's rays) "
        f"{over}, the parked frame after them {err_back:.3e} from a fresh "
        f"frame: " + "; ".join(
            f"interval {k}: median "
            f"{sorted(p['ms'] for p in ps)[VIEWER_POSES // 2]:.3f} ms/pose "
            f"{ps}" for k, ps in episodes.items())
        + f"; splitting frame {edit_ms:.1f} ms "
        f"({cap0} -> {cap1} chunks); the next frame {rebuild_s * 1e3:.1f} ms "
        f"rebuilt the map (level {lm.level}, +{lm.deep_levels} deep) in "
        f"{v.timer.records['leaf_map_build'][-1]:.2f} s, peak "
        f"+{gib:.2f} GiB over {base:.2f} GiB resident")
    return v


def deep_scripts(path):
    """``python3 bench_torch.py <npz>`` and
    ``tools_torch/probe_motion_margin.py <npz>`` on the depth-11 artifact,
    each in a fresh process, checked and logged.  Returns their launches,
    summed."""
    launches, wall = bench_run([path], ("value", "sorted_mode_fps"),
                               "phase 27")
    log(f"phase 27 bench_torch.py d11 run {wall:.1f} s")
    rec, wall = probe_run("probe_motion_margin", [path], "phase 27")
    log(f"phase 27 probe_motion_margin d11 ({rec['card']}; {wall:.1f} s)")
    total = dict(launches)
    add_launches(total, rec["launches"])
    return total


def deep_phase(P, kernels, dev):
    """Phase 27: the depth-11 regime.  ``make_huge_scene_npz``'s
    2,817,022-chunk SH4 tree of depth 11, built without JAX
    (``bench_torch.aerial_artifact``) into ``build/aerial_sh4_d11.npz``,
    or an earlier run's file there when it holds that tree, and loaded
    onto the card; its default leaf map (level 10,
    ``deep_levels`` 1, rows [2^30, 2] i32), the turbo map and a level-9
    map, each build's seconds and peak memory; ``bench.py``'s 1080p
    protocol on the level-10 map (the ladder where chunk-exact budgets
    raise), A and B against their plain versions on the hint frame's rays;
    the level-10 frame bit-equal to the level-9 frame and, on a 256x256
    crop, to E's exact frame of the crop, E against its plain version
    there; ten alternating pairs of the level-10 and level-9 frames and
    of the pixel-order and ray-order frames; one guided stop (C and D
    against their plain versions); the Viewer's parked frames, async
    re-hint poses, a splitting frame and the rebuild after it; then
    ``bench_torch.py`` and ``probe_motion_margin.py`` on the artifact in
    fresh processes.  Returns the path's launches."""
    from mega_nerf_viewer_tpu_torch.ops import accel, render
    from mega_nerf_viewer_tpu_torch.ops.rays import rodrigues, screen2worlddir
    t_phase = time.perf_counter()
    path = os.path.join(ROOT, "build", f"aerial_sh4_d{HUGE_DEPTH}.npz")
    tree, made = None, "reused"
    if os.path.exists(path):
        # an earlier run's file, kept if it is the depth-11 tree
        tree, load_s, _, _ = built(lambda: P.N3Tree.open(path))
        if (int(tree.capacity) != HUGE_CHUNKS
                or accel.tree_max_depth(tree) != HUGE_DEPTH):
            tree = None
    if tree is None:
        t0 = time.perf_counter()
        aerial_artifact(path, depth=HUGE_DEPTH)
        made = f"built on the host in {time.perf_counter() - t0:.1f} s"
        tree, load_s, _, _ = built(lambda: P.N3Tree.open(path))
    cap = int(tree.capacity)
    depth = accel.tree_max_depth(tree)
    tree_bytes = nbytes(tree.data, tree.child, tree.parent,
                        tree.sample_counts, tree.scale, tree.offset)
    log(f"phase 27 artifact: {cap} chunks, depth {depth}, "
        f"{tree.data_format.to_string()}, npz {os.path.getsize(path) / 1e6:.1f}"
        f" MB {made}, loaded in {load_s:.1f} s; tree "
        f"{tree_bytes / 1e6:.1f} MB on the device")
    check(cap == HUGE_CHUNKS and depth == HUGE_DEPTH
          and tree.data_format.to_string() == "SH4",
          f"the depth-11 artifact: {cap} chunks, depth {depth}")

    kernels.reset_launch_counts()
    opt = P.RenderOptions()
    lm, lm9 = deep_maps(P, accel, tree, opt)
    table = P.build_skip_table(tree, opt.sigma_thresh)
    tune = P.device_tuning()
    cs, blk = tune.chunk_size, tune.block
    cam = camera(P.Camera, WIDTH, HEIGHT, FOCAL)
    bp = bench_protocol(P, tree, lm, cam, opt, table, cs, blk,
                        "phase 27 d11 1080p")
    hk = hint_ray_kernels(P, kernels, dev, tree, lm, table, cam, opt, cs,
                          blk, bp.md, "phase 27 d11")
    ms_a9, by_a9, ev_a9 = alone(
        kernels, lambda: kernels.march(tree, lm9, *hk.a_args[2:]), 20)

    # the level-10 frame against the level-9 frame, bit for bit
    out10 = bp.frame(return_hints=True)
    out9 = bp.frame(lm9, return_hints=True)
    check(not out9[1].any(), "the level-9 frame overflowed")
    same = [torch.equal(a, b) for a, b in zip(out10[:1] + out10[2:],
                                              out9[:1] + out9[2:])]
    log(f"phase 27 level-10 frame against the level-9 frame (+2 deep): "
        f"pixels, steps, records, skips bit-equal {same}")
    check(all(same), "the level-10 frame differs from the level-9 frame")
    del out10, out9

    # a crop against the exact march: E's frame of the crop's pixels
    x0, y0 = (WIDTH - CROP) // 2, (HEIGHT - CROP) // 2
    ccx, ccy = cam.cx - x0, cam.cy - y0

    def exact_crop():
        return P.render_frame(tree, CROP, CROP, cam.fx, cam.fy, ccx, ccy,
                              cam.transform, opt)[0]

    ex = exact_crop()
    crop = bp.img[y0:y0 + CROP, x0:x0 + CROP]
    err_x = float((ex - crop).abs().max())
    check(float(crop[..., :3].max()) > 0 and torch.equal(ex, crop),
          f"the exact crop differs from the level-10 frame by {err_x}")
    transform = torch.as_tensor(cam.transform, dtype=torch.float32,
                                device=dev)
    edirs, ecen = screen2worlddir(CROP, CROP, cam.fx, cam.fy, ccx, ccy,
                                  transform)
    me = accel.march_inputs(tree, edirs, rodrigues(opt.rot_dirs, edirs),
                            ecen, opt)
    e_args = (tree, me, opt, False, render.DEFAULT_MAX_LEVELS, 0)
    ke = uncounted(kernels, lambda: kernels.exact_march(*e_args))
    pe = render.exact_march_reference(tree, me, opt, False)
    err_e = float((ke[0] - pe[0]).abs().max())
    for name, a, b in zip(("split_vote", "sample_vote", "visited", "steps"),
                          ke[1:], pe[1:]):
        check(torch.equal(a, b), f"phase 27 exact march {name} differs")
    check(err_e <= 1e-6, f"phase 27 exact march differs by {err_e}")
    ka = uncounted(kernels, lambda: kernels.march(
        tree, lm, me.cen, me.d, me.invdir, me.delta_scale, me.tmin, me.tmax,
        me.miss, me.basis, me.step_size, me.sigma_thresh, me.stop_thresh,
        bp.md, me.use_sh))
    e_steps, e_shaded = int(ke[4].sum()), int(ka[3].sum())
    ms_e, by_e, ev_e = alone(kernels, lambda: kernels.exact_march(*e_args),
                             20)
    be, be_by = exact_bound(me, ke[:3] + (ke[4],), e_steps, e_shaded,
                            tree.data_dim)
    log(f"phase 27 {CROP}x{CROP} crop at ({x0}, {y0}): E's exact frame "
        f"against the level-10 frame: bit-equal (max abs diff {err_x:.3e}); "
        f"kernel E against its plain version: "
        f"out max abs diff {err_e:.3e}, votes, marks and {e_steps} steps "
        f"equal; {ms_e:.4f} ms ({by_e}; events {ev_e:.4f}; bound {be:.4f} "
        f"ms by {be_by}, {100 * be / ms_e:.0f}%; {e_shaded} shaded samples)")
    del ex, crop, edirs, ecen, me, ke, pe, ka

    # times: CUDA events, ten pairs each, the order alternating
    t10, t9, r10, r9 = paired(bp.frame, lambda: bp.frame(lm9))
    tpix, tsort, rpix, rsort = paired(
        bp.frame, lambda: bp.frame(sorted_output=True))
    power = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    log(f"phase 27 d11 1080p times ({power}), medians of {PAIRS} "
        f"alternating pairs of {N_FRAMES} frames: level-10 frame "
        f"{t10:.3f} ms, level-9 frame {t9:.3f} ms (rounds "
        f"{[round(r, 3) for r in r10]} / {[round(r, 3) for r in r9]}); "
        f"pixel order {tpix:.3f} ms, ray order (sorted_output) {tsort:.3f} "
        f"ms, the unpermute's share {tpix - tsort:.3f} ms (rounds "
        f"{[round(r, 3) for r in rpix]} / {[round(r, 3) for r in rsort]})")
    log(f"phase 27 d11 kernels alone ({power}): {hk.times}; march on the "
        f"level-9 map {ms_a9:.4f} ms ({by_a9}; events {ev_a9:.4f})")
    del lm9
    torch.cuda.empty_cache()

    model = deep_guided(P, kernels, dev, tree, lm, table, cam)
    want = bp.img
    del bp, hk, lm, table
    torch.cuda.empty_cache()
    v = deep_viewer(P, kernels, tree, model, want)
    launches = read_launches(kernels, ("skip_prepass", "march", "collect",
                                       "compact_composite", "exact_march"),
                             "phase 27")
    del v, tree, model, want
    torch.cuda.empty_cache()
    add_launches(launches, deep_scripts(path))
    log(f"phase 27 in {time.perf_counter() - t_phase:.1f} s; launches "
        f"{ {k: n for k, n in launches.items() if n} }")
    return launches


if __name__ == "__main__":
    sys.exit(main())
