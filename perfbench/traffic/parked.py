"""The ``parked`` kind: the camera parks at each of ``views`` (azimuths)
in a seeded order, for an equal share of the window.  At each, after
``settle_frames`` untimed frames, frames are issued back to back, each
one's sum added to a device checksum, and the view's time ends in one
``torch.cuda.synchronize()``.  Metric: the parked time over the frames
issued."""

import time

import torch

from perfbench.cell import camera_dict, set_azimuth
from perfbench.drive import Window, sync


def warm(viewer, mix, plan, device, base_pose):
    """Parked frames, then a camera move and its settle frames, as between
    the views."""
    n = int(mix["warmup"])
    for _ in range(n):
        viewer.render(fetch=False)
    set_azimuth(viewer.camera, base_pose, plan.views[0])
    for _ in range(n):
        viewer.render(fetch=False)
    sync(device)


def run(viewer, mix, plan, seconds, device, base_pose):
    w = Window()
    cam = viewer.camera
    acc = torch.zeros((), device=device)
    share = seconds / len(plan.views)
    sync(device)
    for azimuth in plan.views:
        set_azimuth(cam, base_pose, azimuth)
        for _ in range(int(mix["settle_frames"])):
            viewer.render(fetch=False)
        snap = camera_dict(cam)
        sync(device)
        t0 = tp = time.perf_counter()
        while True:
            img = viewer.render(fetch=False)
            acc = acc + img.sum()
            if w.units in plan.keep:
                w.kept.append((w.units, img, snap))
            w.units += 1
            t = time.perf_counter()
            # the host's pace, a frame at a time (not the metric)
            w.latencies.append(t - tp)
            w.starts.append(tp)
            tp = t
            if t - t0 >= share:
                break
        sync(device)
        w.seconds += time.perf_counter() - t0
    w.keep_last(img, snap)
    w.checksum = acc
    return w
