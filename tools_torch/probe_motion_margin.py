"""``tools/probe_motion_margin.py`` through the port: the sharded re-hint
motion pose at episode-start margin-1 budgets against the settled margin-0
budgets (``Viewer.motion_settled_margin``), on the real sharded program.

Setup (JAX's): the tree from ``argv[1]``, an ``.npz`` path
(``N3Tree.open``) or a depth (``shell_tree(depth, basis_dim=9,
sigma_inside=400)``); by default the aerial artifact
``build/aerial_sh4_d9.npz``, built by ``bench_torch.aerial_artifact`` when
missing.  Its leaf map and skip table, ``device_tuning()``'s chunk and
block, the camera at 1920x1080, f = 1111, centre (-1.4, 0.1, 1.3), and
the hint frame (kernels B and A) with ``max_dense`` doubled from 8 until no
ray overflows.

Then for margin 1 and 0: the episode layout (``motion_episode_layout``)
of the hint frame's packed order and quarter order, the segments
``segments_from_hint_cdf(cdf, R, margin=m, top_headroom=False)``, and one
moved pose (one 3-degree orbit step) through
``parallel.render_frame_motion_sharded`` (the quarter count march, the sum
of the shards' quarter keys, the segmented march).  The overflowing
segments' budgets double (at most 512) until the summed overflow is at
most the async policy's tolerance ``max(1024, R // 512)``, as JAX's probe
settles them.  The settled pose is timed with CUDA events (and the host
clock), the median of 10 after a warm call.

It runs at the world it is started in: in-process a world of one (NCCL on
the card, gloo on the CPU), as ``benchmarks_torch/orbit4k.py`` does;
under ``torchrun`` each rank prints its own figures.  JAX's probe times
the 8 shard bodies of a TPU slice on one chip and projects the slice's
figure from them; this one projects nothing: a figure of several cards is
their own run.

Usage: python tools_torch/probe_motion_margin.py [npz_path_or_depth]
Prints the setup line, one line per margin and one JSON line (both
margins, the card and its power limit, the process's launches), then
``done``.  Environment: ``_overrides_torch``'s ``BENCH_FORCE_CPU``,
``BENCH_WH`` and ``BENCH_DEPTH`` (the shell's depth when no argument
names a source); any of them marks the JSON line ``"smoke": true``.
Without ``BENCH_FORCE_CPU`` it needs a CUDA card and raises without one.
"""

import copy
import os
import sys
import time
from types import SimpleNamespace

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402

import _stages_torch as S  # noqa: E402
import _overrides_torch  # noqa: E402

AERIAL = os.path.join(S.REPO, "build", "aerial_sh4_d9.npz")
MARGINS = (1, 0)
# the largest budget a hint frame or a settled segment escalates to
BUDGET_CAP = 512
N_REPS = 10


def setup(src=AERIAL, width=S.WIDTH, height=S.HEIGHT, device=None):
    """The tree, its maps, the camera at the start pose and the hint frame
    escalated until no ray overflows."""
    import mega_nerf_viewer_tpu_torch as P
    from mega_nerf_viewer_tpu_torch.ops import accel
    from mega_nerf_viewer_tpu_torch.parallel.mesh import init_world
    from mega_nerf_viewer_tpu_torch.utils.tuning import device_tuning
    dev = init_world(device)
    src = str(src)
    if src.endswith(".npz"):
        if not os.path.exists(src):
            # each process builds its own copy and moves it in whole, so
            # ranks started together never read a half-written file
            from bench_torch import aerial_artifact
            tmp = f"{src}.{os.getpid()}.npz"
            aerial_artifact(tmp)
            os.replace(tmp, src)
        tree = P.N3Tree.open(src, device=dev)
    else:
        tree = P.shell_tree(depth=int(src), basis_dim=9, sigma_inside=400.0,
                            device=dev)
    opt = P.RenderOptions()
    leaf_map = accel.build_leaf_map(tree)
    skip_table = P.build_skip_table(tree, opt.sigma_thresh)
    tune = device_tuning(dev)
    cam = _overrides_torch.camera(width, height, S.FOCAL)
    max_dense = 8
    while True:
        _, overflow, steps, nrec, skips = accel.render_frame_fast(
            tree, leaf_map, cam, opt, max_dense=max_dense,
            chunk_size=tune.chunk_size, block=tune.block, return_nrec=True,
            skip_table=skip_table, return_skips=True)
        if not int(overflow):
            break
        max_dense *= 2
        if max_dense > BUDGET_CAP:
            raise RuntimeError("pathological dense-sample count")
    return SimpleNamespace(dev=dev, tree=tree, opt=opt, leaf_map=leaf_map,
                           skip_table=skip_table, cs=tune.chunk_size,
                           cam=cam, max_dense=max_dense, steps=steps,
                           nrec=nrec, skips=skips)


def moved(cam):
    """A copy of ``cam`` one 3-degree orbit step on."""
    cam2 = copy.deepcopy(cam)
    cam2.begin_drag(0.0, 0.0, False, True)
    cam2.drag_update(-np.deg2rad(S.DEG) * cam.width / 2.0, 0.0)
    cam2.end_drag()
    return cam2


def settle(s, margin, tol=None):
    """The margin's segments, escalated at the moved pose until the
    summed overflow is within ``tol`` (default the async policy's
    tolerance).  Returns a namespace of the
    mesh, the layout, the moved camera, the first and the settled
    segments, the last pose's outputs and the tolerance."""
    import torch.distributed as dist
    from mega_nerf_viewer_tpu_torch import parallel
    from mega_nerf_viewer_tpu_torch.ops import accel
    w, h = s.cam.width, s.cam.height
    R = w * h
    mesh = parallel.make_mesh((dist.get_world_size(),),
                              (parallel.RAY_AXIS,), device=s.dev)
    ph = accel.pack_hints(s.steps, s.nrec, s.skips)
    order = accel.order_from_packed_device(ph)
    qperm = accel.quarter_order_from_packed(ph, width=w)
    cdf = accel.hint_class_cdf(s.nrec).cpu().numpy()
    first = tuple(accel.segments_from_hint_cdf(cdf, R, margin=margin,
                                               top_headroom=False))
    pix_str, qpix_str = parallel.motion_episode_layout(
        order, qperm, mesh=mesh, chunk_size=s.cs, hint_chunk=s.cs)
    cam2 = moved(s.cam)
    tol = max(1024, R // 512) if tol is None else tol
    segments = list(first)

    def pose():
        return parallel.render_frame_motion_sharded(
            s.tree, s.leaf_map, cam2, s.opt, qpix_str, pix_str,
            tuple(segments), mesh=mesh, chunk_size=s.cs, hint_chunk=s.cs,
            skip_table=s.skip_table)

    while True:
        out = pose()
        ov = out[1].cpu().numpy()
        if int(ov.sum()) <= tol:
            break
        for i, c in enumerate(ov):
            if c:
                f, md = segments[i]
                segments[i] = (f, max(1, md * 2))
                if segments[i][1] > BUDGET_CAP:
                    raise RuntimeError(f"segment {i} escalated past "
                                       f"{BUDGET_CAP}")
    return SimpleNamespace(mesh=mesh, world=dist.get_world_size(),
                           cam2=cam2, first=first, segments=tuple(segments),
                           out=out, overflow=ov, tol=tol, pose=pose)


def run(src=AERIAL, width=S.WIDTH, height=S.HEIGHT, device=None):
    """The probe.  Returns (record without the card and the launches, the
    setup namespace, {margin: settle namespace})."""
    t0 = time.perf_counter()
    s = setup(src, width, height, device)
    S.sync(s.dev)
    print(f"setup {time.perf_counter() - t0:.1f}s  max_dense={s.max_dense} "
          f"source={os.path.basename(str(src))} chunks={s.tree.capacity} "
          f"chunk_size={s.cs}", flush=True)
    record = {"tool": "probe_motion_margin", "source": str(src),
              "width": width, "height": height, "max_dense": s.max_dense,
              "margins": {}}
    settled = {}
    for margin in MARGINS:
        t1 = time.perf_counter()
        m = settle(s, margin)
        st = S.time_stage(m.pose, s.dev, N_REPS)
        settled[margin] = m
        record["world"] = m.world
        record["margins"][str(margin)] = dict(
            segments=S.plain_segments(m.first),
            settled=S.plain_segments(m.segments),
            overflow=int(m.overflow.sum()),
            overflow_counts=m.overflow.tolist(), tol=m.tol,
            **S.stage_record(st))
        print(f"margin={margin}: device {S.fmt_ms(st.device_ms)}, host "
              f"{st.host_ms:.3f} ms (median of {N_REPS}); segments "
              f"{S.plain_segments(m.first)} settled "
              f"{S.plain_segments(m.segments)}; overflow "
              f"{int(m.overflow.sum())} (tol {m.tol}); world {m.world}; "
              f"launches {st.launches}; stage wall "
              f"{time.perf_counter() - t1:.0f}s", flush=True)
    return record, s, settled


def main(argv=None):
    import torch.distributed as dist
    argv = sys.argv[1:] if argv is None else argv
    width, height, depth, smoke, dev = _overrides_torch.apply(
        S.WIDTH, S.HEIGHT, 0)
    if argv:
        src = argv[0]
    elif os.environ.get("BENCH_DEPTH"):
        src = str(depth)
    else:
        src = AERIAL
    if dev.type == "cuda" and "WORLD_SIZE" in os.environ:
        dev = None                       # each rank takes its own card
    record, s, _ = run(src, width, height, dev)
    print(f"# card: {S.card(s.dev)}", flush=True)
    S.emit(record, s.dev, smoke)
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
