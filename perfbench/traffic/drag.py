"""The ``drag`` kind: drags about the tree's centre, ``deg_per_pose``
degrees a pose.  ``episodes`` lists each drag's start azimuth and
direction, and each runs ``poses_per_episode`` poses; the seed orders the
episodes.  Before each, the camera is set to its start and
``settle_frames`` parked frames are rendered (untimed as poses), so that
what an episode does depends on its start alone.  Each pose is the
drag's move, then a frame, synchronised.  Metric: the pose latencies."""

import time

from perfbench.cell import camera_dict, drag_x, set_azimuth
from perfbench.drive import Window, sync


def warm(viewer, mix, plan, device, base_pose):
    """One short drag of each direction; the window's first episode then
    starts from its own pose."""
    cam = viewer.camera
    viewer.render(fetch=False)
    for direction in (1.0, -1.0):
        cam.begin_drag(0.0, 0.0, False, True)
        for k in range(int(mix["warmup"])):
            cam.drag_update(drag_x(cam, direction * mix["deg_per_pose"]
                                   * (k + 1)), 0.0)
            viewer.render(fetch=False)
        cam.end_drag()
    sync(device)


def run(viewer, mix, plan, seconds, device, base_pose):
    w = Window()
    cam = viewer.camera
    per = int(mix["poses_per_episode"])
    sync(device)
    t0 = time.perf_counter()
    done = False
    e = 0
    while not done:
        azimuth, direction = plan.episodes[e % len(plan.episodes)]
        e += 1
        set_azimuth(cam, base_pose, azimuth)
        for _ in range(int(mix["settle_frames"])):
            viewer.render(fetch=False)
        sync(device)
        step = direction * float(mix["deg_per_pose"])
        cam.begin_drag(0.0, 0.0, False, True)
        for k in range(per):
            ts = time.perf_counter()
            cam.drag_update(drag_x(cam, step * (k + 1)), 0.0)
            img = viewer.render(fetch=False)
            sync(device)
            te = time.perf_counter()
            w.latencies.append(te - ts)
            w.starts.append(ts)
            if w.units in plan.keep:
                w.kept.append((w.units, img, camera_dict(cam)))
            w.units += 1
            if te - t0 >= seconds:
                done = True
                break
        cam.end_drag()
    w.seconds = te - t0
    w.keep_last(img, camera_dict(cam))
    return w
