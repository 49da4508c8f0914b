"""The ``guided`` kind: guided stops.  A user drags the camera about the
tree's centre and lets go; the Viewer then renders the guided frame
(the collect, the model's query, the composite) at the pose where the
drag ended.

``episodes`` lists each episode's start azimuth and direction; the seed
orders them.  An episode sets its start, renders ``settle_frames`` guided
frames (untimed), drags ``deg_per_pose`` degrees a pose for its drag's
poses (voxel frames, each timed apart and no unit), then calls
``end_drag()`` and renders once: that frame is the guided frame.  A unit
is a stop, from ``end_drag()`` to its frame's completion, synchronised.
The drag lengths are evenly spaced over ``drag_deg`` (lo, hi degrees),
each a whole number of poses, one to each listed episode by a fixed
deal: every seed runs the same episodes, and only their order is the
seed's.  The kept frames are the seeded stops (``keep`` of the
first ``keep_from``) and the last, marked ``guided``; after the window,
:func:`check_frames` renders the seeded ``check_views``.  Metric: the stop
latencies."""

import time

import numpy as np

from perfbench.cell import camera_dict, drag_x, set_azimuth
from perfbench.drive import Window, sync


def drag_poses(mix, plan) -> list:
    """The drag's poses of each of the plan's episodes, in its order.  The
    lengths are dealt to the listed episodes once, by a fixed draw that
    no seed changes."""
    lo, hi = (float(v) for v in mix["drag_deg"])
    episodes = [tuple(e) for e in mix["episodes"]]
    n = len(episodes)
    per = float(mix["deg_per_pose"])
    poses = [max(1, round((lo + (hi - lo) * (k + 0.5) / n) / per))
             for k in range(n)]
    deal = np.random.default_rng(0).permutation(n)
    dealt = {e: poses[d] for e, d in zip(episodes, deal)}
    return [dealt[e] for e in plan.episodes]


def _guided(cam) -> dict:
    snap = camera_dict(cam)
    snap["frame"] = "guided"
    return snap


def _drag(viewer, cam, step, poses, device, apart=None):
    """A drag of ``poses`` poses of ``step`` degrees, each a frame,
    synchronised; ``apart`` gets each pose's seconds."""
    cam.begin_drag(0.0, 0.0, False, True)
    for k in range(poses):
        ts = time.perf_counter()
        cam.drag_update(drag_x(cam, step * (k + 1)), 0.0)
        viewer.render(fetch=False)
        sync(device)
        if apart is not None:
            apart.append(time.perf_counter() - ts)


def warm(viewer, mix, plan, device, base_pose):
    """The start's guided frame, then one short stop in each direction."""
    cam = viewer.camera
    viewer.render(fetch=False)
    for direction in (1.0, -1.0):
        _drag(viewer, cam, direction * float(mix["deg_per_pose"]),
              int(mix["warmup"]), device)
        cam.end_drag()
        viewer.render(fetch=False)
    sync(device)


def run(viewer, mix, plan, seconds, device, base_pose):
    w = Window()
    cam = viewer.camera
    poses = drag_poses(mix, plan)
    sync(device)
    t0 = time.perf_counter()
    e = 0
    while True:
        azimuth, direction = plan.episodes[e % len(plan.episodes)]
        n = poses[e % len(poses)]
        e += 1
        set_azimuth(cam, base_pose, azimuth)
        for _ in range(int(mix["settle_frames"])):
            viewer.render(fetch=False)
        sync(device)
        _drag(viewer, cam, direction * float(mix["deg_per_pose"]), n,
              device, w.apart)
        ts = time.perf_counter()
        cam.end_drag()
        img = viewer.render(fetch=False)
        sync(device)
        te = time.perf_counter()
        w.latencies.append(te - ts)
        w.starts.append(ts)
        snap = _guided(cam)
        if w.units in plan.keep:
            w.kept.append((w.units, img, snap))
        w.units += 1
        if te - t0 >= seconds:
            break
    w.seconds = te - t0
    w.keep_last(img, snap)
    return w


def check_frames(viewer, mix, plan, base_pose, first_index):
    """After the window: at each of the plan's check azimuths,
    ``settle_frames`` guided frames and then the kept one, marked
    ``guided``."""
    out = []
    cam = viewer.camera
    for i, azimuth in enumerate(plan.check_views):
        set_azimuth(cam, base_pose, azimuth)
        for _ in range(int(mix["settle_frames"])):
            viewer.render(fetch=False)
        out.append((first_index + i, viewer.render(fetch=False),
                    _guided(cam)))
    return out
