"""``tools/motion_phase_timing.py`` through the port: each piece of the
1080p motion loop timed alone on one CUDA card.

The scene and the settling are JAX's: ``shell_tree(depth=8, basis_dim=9,
sigma_inside=400)`` at 1920x1080, f = 1111, the Viewer with chunk 2176
and the async policy, a parked frame and 5 orbit poses of 3 degrees and
one more frame, so the hints, order and segments reach the steady motion
regime.  From the Viewer's packed hints it derives the steady segments,
the iso-64 and the directional (32, 64) dilated hints with their headroom
segments and device orders, and times, each alone:

  A   the steady parked segmented frame, packed hints on
  B   the same frame, hints off
  C   the motion frame: iso-64 dilated order and headroom segments, hints on
  C2  the same, hints off
  C3  the motion frame with the directional (32, 64) dilation, hints on
  D   ``dilate_packed``, window 64;  D2  window (32, 64)
  E   ``order_from_packed_device`` of the iso-64 hints (sort and inverse)
  E2  ``torch.argsort(stable=True)`` alone
  F   the hint-class CDF fetched to the host
  G   the overflow flags of a C frame fetched to the host

Each frame is ``accel.render_frame_fast_segmented`` with
``skip_table=None``, as the JAX tool passes: no prepass (kernel B), only
kernel A.  The production skip table is ``motion_viewer_probe.py``'s
business.  ``dynamic_knobs=True`` is passed as JAX passes it; it changes
nothing in the port.  A stage is forced with ``torch.cuda.synchronize()``
and reports device ms (CUDA events) and host ms, the median of 3 after a
warm call, and the kernel launches of one call (``_stages_torch``).

Usage: python tools_torch/motion_phase_timing.py
Prints the three ``segments`` lines, one line per stage and one JSON line
(the segments, each stage, the card and its power limit, the process's
launches), then ``done``.  Environment: ``_overrides_torch``'s
``BENCH_FORCE_CPU``, ``BENCH_WH`` and ``BENCH_DEPTH``; any of them marks
the JSON line ``"smoke": true``.  Without ``BENCH_FORCE_CPU`` it needs a
CUDA card and raises without one.
"""

import os
import sys
from types import SimpleNamespace

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import _stages_torch as S  # noqa: E402
import _overrides_torch  # noqa: E402

# the two dilation windows: isotropic 64 and the directional window of a
# 3-degree orbit pose
ISO, DIRECTIONAL = 64, (32, 64)


def setup(width=S.WIDTH, height=S.HEIGHT, depth=S.DEPTH, device=None):
    """The settled Viewer and what the stages read: the packed hints
    ``ph``, the dilated hints ``dp`` (iso-64) and ``dp_dir``, their device
    orders, and the steady, motion and directional segments."""
    from mega_nerf_viewer_tpu_torch.device import resolve_device
    from mega_nerf_viewer_tpu_torch.ops import accel
    dev = resolve_device(device)
    v = S.settled_viewer(width, height, depth, dev)
    v.render(fetch=False)
    for _ in range(5):
        S.orbit(v, width)
        v.render(fetch=False)
    v.render(fetch=False)
    S.sync(dev)

    R = width * height
    ph = v._hints_packed
    assert ph is not None, "the settled Viewer kept no packed hints"

    def segs(h, **kw):
        cdf = accel.hint_class_cdf_packed(h).cpu().numpy()
        return tuple(accel.segments_from_hint_cdf(cdf, R, **kw))

    dp = accel.dilate_packed(ph, width=width, height=height, window=ISO)
    dp_dir = accel.dilate_packed(ph, width=width, height=height,
                                 window=DIRECTIONAL)
    ns = SimpleNamespace(
        v=v, dev=dev, width=width, height=height, ph=ph, dp=dp,
        dp_dir=dp_dir, segs_steady=segs(ph),
        segs_motion=segs(dp, headroom=True),
        segs_motion_dir=segs(dp_dir, headroom=True),
        order_m=accel.order_from_packed_device(dp),
        order_md=accel.order_from_packed_device(dp_dir))
    S.sync(dev)
    return ns


def frame(ns, order, segs, want_hints):
    """The segmented frame of the stages A-C3 (and G's flags)."""
    from mega_nerf_viewer_tpu_torch.ops import accel
    v = ns.v
    return accel.render_frame_fast_segmented(
        v.tree, v._leaf_map, v.camera, v.options, order=order,
        segments=segs, chunk_size=S.CHUNK, need_votes=False,
        dynamic_knobs=True, skip_table=None, device_fallback=False,
        return_hints=want_hints, sorted_output=False)


def stages(ns):
    """(name, what, fn) of each stage, in the JAX tool's order."""
    import torch
    from mega_nerf_viewer_tpu_torch.ops import accel
    w, h = ns.width, ns.height
    flags = {}

    def g():
        if "out" not in flags:
            flags["out"] = frame(ns, ns.order_m, ns.segs_motion, "packed")
            S.sync(ns.dev)
        return flags["out"][1].cpu().numpy()

    return [
        ("A", "steady frame, packed hints on",
         lambda: frame(ns, ns.v._ray_order, ns.segs_steady, "packed")),
        ("B", "steady frame, hints off",
         lambda: frame(ns, ns.v._ray_order, ns.segs_steady, False)),
        ("C", "motion frame (iso-64 dilated+headroom), hints on",
         lambda: frame(ns, ns.order_m, ns.segs_motion, "packed")),
        ("C2", "motion frame, hints off",
         lambda: frame(ns, ns.order_m, ns.segs_motion, False)),
        ("C3", "motion frame (DIRECTIONAL (32,64) dilated+headroom), "
         "hints on",
         lambda: frame(ns, ns.order_md, ns.segs_motion_dir, "packed")),
        ("D", "dilate packed w=64",
         lambda: accel.dilate_packed(ns.ph, width=w, height=h, window=ISO)),
        ("D2", "dilate packed (32,64)",
         lambda: accel.dilate_packed(ns.ph, width=w, height=h,
                                     window=DIRECTIONAL)),
        ("E", "order rebuild (packed)",
         lambda: accel.order_from_packed_device(ns.dp)),
        ("E2", "argsort only", lambda: torch.argsort(ns.dp, stable=True)),
        ("F", "cdf fetch",
         lambda: accel.hint_class_cdf_packed(ns.dp).cpu().numpy()),
        # G: one C frame rendered and forced once, then its flags fetched
        ("G", "flags fetch", g),
    ]


def run(width=S.WIDTH, height=S.HEIGHT, depth=S.DEPTH, device=None):
    """Settle, print the segments, time every stage.  Returns (record
    without the card and the launches, the setup namespace)."""
    ns = setup(width, height, depth, device)
    print(f"segments steady={S.plain_segments(ns.segs_steady)}", flush=True)
    print(f"segments motion={S.plain_segments(ns.segs_motion)}", flush=True)
    print(f"segments motion dir(32,64)="
          f"{S.plain_segments(ns.segs_motion_dir)}", flush=True)
    record = {
        "tool": "motion_phase_timing", "width": width, "height": height,
        "depth": depth,
        "segments": {k: S.plain_segments(getattr(ns, "segs_" + k))
                     for k in ("steady", "motion", "motion_dir")},
        "stages": {}}
    for name, what, fn in stages(ns):
        st = S.time_stage(fn, ns.dev)
        print(S.stage_line(f"{name} {what}", st), flush=True)
        record["stages"][name] = S.stage_record(st)
    return record, ns


def main(argv=None):
    width, height, depth, smoke, dev = _overrides_torch.apply(
        S.WIDTH, S.HEIGHT, S.DEPTH)
    print(f"# card: {S.card(dev)}", flush=True)
    record, _ = run(width, height, depth, dev)
    S.emit(record, dev, smoke)
    return 0


if __name__ == "__main__":
    sys.exit(main())
