"""``tools/motion_viewer_probe.py`` through the port: where each moved pose
of the Viewer's 1080p motion loop spends its time, on one CUDA card.

Unlike ``motion_phase_timing.py`` (each piece alone, no skip table), this
wraps the Viewer's own calls in forcing timers, so a pose is split with
the production skip table, options and budget machinery.  The Viewer
looks its hint and frame functions up on the port's ``ops.accel`` module
at call time, so the wraps patch that module:

  dilate  ``accel.dilate_packed``
  order   ``accel.order_from_packed_device``
  frame   ``accel.render_frame_fast_segmented``
  motion  ``accel.render_frame_motion``

The first three are the JAX tool's.  At its settings (the async policy, an
even frame, the default ``motion_mode`` "rehint") every moved pose is a
re-hint pose: ``Viewer._render_motion_rehint`` calls
``render_frame_motion`` and none of those three, so the JAX tool's split
of such a pose is empty and the whole pose lands under ``other``.  The
``motion`` wrap splits it.  The 6 poses then run a second time with
``motion_mode = "dilate"``, the mode the JAX wraps were written for
(dilate, order, frame).  This is the probe's printout only: nothing in the
package changes.

Protocol (JAX's): the scene of ``motion_phase_timing.py`` (the depth-8
shell at 1920x1080, chunk 2176, the async policy), a parked frame and 4
orbit poses of 3 degrees, a rewind to the start pose and one frame there.
Then the headroom experiment: the directional (32, 64) dilated order of
the Viewer's hints, the motion frame at headroom and at no-headroom
budgets (the unwrapped calls, with the skip table), each timed (device and
host ms, median of 3 after a warm call) with its overflow counts.  Then 6
orbit poses under the wraps, each with its total (host ms, forced), the
split by wrap, the rest (``other``) and the Viewer's segments; then the
rewind, ``motion_mode = "dilate"``, one frame and the same 6 poses.
Forcing between stages serializes the chain, so a total is above the
benchmark's pipelined pose time; the split is what it tells.

Usage: python tools_torch/motion_viewer_probe.py
Prints the two headroom lines, one line per pose and mode and one JSON
line (all of them, the card and its power limit, the process's launches),
then ``done``.  Environment: ``_overrides_torch``'s ``BENCH_FORCE_CPU``,
``BENCH_WH`` and ``BENCH_DEPTH``; any of them marks the JSON line
``"smoke": true``.  Without ``BENCH_FORCE_CPU`` it needs a CUDA card and
raises without one.
"""

import contextlib
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402

import _stages_torch as S  # noqa: E402
import _overrides_torch  # noqa: E402

# (tag, accel function); the first three are the JAX tool's wraps
WRAPS = (("dilate", "dilate_packed"), ("order", "order_from_packed_device"),
         ("frame", "render_frame_fast_segmented"),
         ("motion", "render_frame_motion"))
JAX_WRAPS = ("dilate", "order", "frame")
MODES = ("rehint", "dilate")
N_POSES = 6


@contextlib.contextmanager
def wrapped(dev, log):
    """Within the block each function of :data:`WRAPS` on ``accel`` is
    forced after its call and appends (tag, host ms) to ``log``."""
    from unittest import mock
    from mega_nerf_viewer_tpu_torch.ops import accel
    with contextlib.ExitStack() as stack:
        for tag, name in WRAPS:
            orig = getattr(accel, name)

            def wrap(*a, _orig=orig, _tag=tag, **k):
                t0 = time.perf_counter()
                out = _orig(*a, **k)
                S.sync(dev)
                log.append((_tag, (time.perf_counter() - t0) * 1e3))
                return out
            stack.enter_context(mock.patch.object(accel, name, wrap))
        yield log


def rewind(v, pose0):
    v.camera.center, v.camera.v_back = pose0[0].copy(), pose0[1].copy()
    v.camera._update()


def headroom(v, dev):
    """The motion frame of the Viewer's directional-dilated order at
    headroom and no-headroom budgets.  Returns {tag: dict(segs,
    overflow_counts, device_ms, host_ms, launches)}."""
    from mega_nerf_viewer_tpu_torch.ops import accel
    w, h = v.camera.width, v.camera.height
    R = w * h
    dp = accel.dilate_packed(v._hints_packed, width=w, height=h,
                             window=(32, 64))
    cdf = accel.hint_class_cdf_packed(dp).cpu().numpy()
    order_x = accel.order_from_packed_device(dp)
    out = {}
    for tag, hroom in (("headroom", True), ("NO-headroom", False)):
        segs = tuple(accel.segments_from_hint_cdf(cdf, R, headroom=hroom))
        st = S.time_stage(lambda segs=segs: accel.render_frame_fast_segmented(
            v.tree, v._leaf_map, v.camera, v.options, order=order_x,
            segments=segs, chunk_size=v.fast_chunk_size, need_votes=False,
            dynamic_knobs=True, skip_table=getattr(v, "_skip_table", None),
            device_fallback=False, return_hints="packed",
            sorted_output=False), dev)
        out[tag] = dict(segs=S.plain_segments(segs),
                        overflow_counts=st.out[1].cpu().numpy().tolist(),
                        **S.stage_record(st))
    return out


def poses(v, dev, mode):
    """:data:`N_POSES` orbit poses under the wraps.  Returns one dict per pose:
    total (host ms), calls [(tag, ms)] in call order, split {tag: ms},
    other, segs, motion_segs, launches."""
    from mega_nerf_viewer_tpu_torch import kernels
    out = []
    log = []
    with wrapped(dev, log):
        for p in range(N_POSES):
            log.clear()
            S.orbit(v, v.camera.width)
            before = dict(kernels.LAUNCHES)
            t0 = time.perf_counter()
            img = v.render(fetch=False)
            S.sync(dev)
            total = (time.perf_counter() - t0) * 1e3
            split = {}
            for tag, dt in log:
                split[tag] = split.get(tag, 0.0) + dt
            rec = dict(total=total, calls=list(log), split=split,
                       other=total - sum(dt for _, dt in log),
                       segs=S.plain_segments(v._segments or ()),
                       motion_segs=S.plain_segments(
                           v._segments_motion or ()),
                       launches=S.launch_delta(before),
                       finite=bool(np.isfinite(
                           float(img.float().sum()))))
            out.append(rec)
            print(f"[{mode} pose {p}] total={total:.1f}ms split="
                  f"{ {k: round(x, 2) for k, x in split.items()} } "
                  f"other={rec['other']:.1f}ms segs={rec['segs']}"
                  + (f" motion_segs={rec['motion_segs']}"
                     if mode == "rehint" else "")
                  + f" launches={rec['launches']}", flush=True)
    return out


def run(width=S.WIDTH, height=S.HEIGHT, depth=S.DEPTH, device=None):
    """The protocol.  Returns (record without the card and the launches,
    the Viewer)."""
    from mega_nerf_viewer_tpu_torch.device import resolve_device
    dev = resolve_device(device)
    v = S.settled_viewer(width, height, depth, dev)
    cam = v.camera
    # warm-up to the settled motion regime, then rewind (the benchmark's
    # own protocol)
    pose0 = (cam.center.copy(), cam.v_back.copy())
    v.render(fetch=False)
    for _ in range(4):
        S.orbit(v, width)
        v.render(fetch=False)
    rewind(v, pose0)
    v.render(fetch=False)
    S.sync(dev)

    record = {"tool": "motion_viewer_probe", "width": width,
              "height": height, "depth": depth, "headroom": {}, "poses": {}}
    if v._hints_packed is not None and v._ray_order is not None:
        record["headroom"] = headroom(v, dev)
        for tag, r in record["headroom"].items():
            print(f"[motion frame {tag}] device {S.fmt_ms(r['device_ms'])} "
                  f"host {r['host_ms']:.3f} ms segs={r['segs']} "
                  f"overflow_counts={r['overflow_counts']} "
                  f"launches={r['launches']}", flush=True)
    for i, mode in enumerate(MODES):
        if i:
            # the same poses again, from the start pose
            v.motion_mode = mode
            rewind(v, pose0)
            v.render(fetch=False)
            S.sync(dev)
        record["poses"][mode] = poses(v, dev, mode)
    return record, v


def main(argv=None):
    width, height, depth, smoke, dev = _overrides_torch.apply(
        S.WIDTH, S.HEIGHT, S.DEPTH)
    print(f"# card: {S.card(dev)}", flush=True)
    record, _ = run(width, height, depth, dev)
    S.emit(record, dev, smoke)
    return 0


if __name__ == "__main__":
    sys.exit(main())
