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
  per-frame compact composite.

Each path runs with the launch counts set to 0 just before it and read
just after; a kernel of the path that never launched fails the run.  It
checks that the frames are finite and agree with the plain CPU path on
small frames, and prints one JSON line listing the kernels (launches,
error, times, bounds) and, last, ``{"ok": true, "device": {...}}``.  Any
failed check raises; there is no CPU fallback.  It needs no network.
"""

import json
import subprocess
import sys
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
SH_EVAL_OPS = {1: 0, 4: 3, 9: 18, 16: 48, 25: 89}
WIDTH, HEIGHT, FOCAL = 1920, 1080, 1111.0
CENTER = (-1.4, 0.1, 1.3)
N_FRAMES, ROUNDS = 10, 3
# benchmarks/guided1080p.py: max_guided_samples and the model
GUIDED_S = 32
GUIDED_MODEL = dict(n_clusters=8, hidden=256, n_layers=8, grid_dim=(2, 4),
                    min_position=(-1.5, -1.5, -1.5),
                    max_position=(1.5, 1.5, 1.5), need_viewdir=True)


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

    del tree, leaf_map, table, img, hint_img, steps, nrec, skips, order
    torch.cuda.empty_cache()
    guided_launches = guided_phases(P, kernels, dev, report)

    # launches: each path's own run (phase 4 and phase 8), summed for the
    # prepass, which both paths run
    for k in report:
        k["launches"] = (frame_launches.get(k["name"], 0)
                         + guided_launches.get(k["name"], 0))
    log(json.dumps({"kernels": report}))
    # the one card this run drove (contract: count 1)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": 1}}))
    return 0


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

    def time_invalidation(**kw):
        ts = []
        for _ in range(3):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = invalidate(**kw)
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t) * 1e3)
        return out, sorted(ts)[1], ts

    invalidate()                                 # warm the ordered path
    cache, inval_ms, inval_ts = time_invalidation()
    n_samples = int(cache["num_samples"].sum())
    segs = P.segments_from_ns_hints(ns_h, GUIDED_S)
    cache_s = invalidate(segments=segs)             # escalation settles here
    settled = cache_s["segments"]
    cache_s, inval_seg_ms, seg_ts = time_invalidation(segments=settled)
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


if __name__ == "__main__":
    sys.exit(main())
