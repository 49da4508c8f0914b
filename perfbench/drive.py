"""What every traffic mix shares: the seed's plan, the window's record and
the frames kept after the window for the output check.

A mix is a data file, ``traffic/<mix>.json``; its ``kind`` names the
driver that reads it, ``traffic/<kind>.py`` (found by name, see
``registry.kind_driver``), which offers ``warm(viewer, mix, plan,
device, base_pose)`` and ``run(viewer, mix, plan, seconds, device,
base_pose) -> Window``.  One user, closed loop: the next input comes when
the frame is done.

Every mix starts at ``start_center`` (the orbit radius and elevation of
``bench.py``'s camera, looking toward the tree's centre) turned by an
azimuth (the first of ``views``, else of the first episode).  The seed
draws which frames of the window are kept for the output check (``keep``
of the first ``keep_from``, and always the last), the order of ``views``
and ``episodes``, and, where the mix lists ``check_views``, the
``check_kept`` azimuths at which the Viewer renders once more after the
window (``settle_frames`` frames, then the kept one).  The timed work
does not depend on the seed beyond that order.
"""

from __future__ import annotations

import numpy as np
import torch

from .cell import camera_dict, set_azimuth


class Plan:
    """What the seed decides for one run of a mix."""

    def __init__(self, mix: dict, seed: int):
        rng = np.random.default_rng(int(seed))
        self.keep = set(int(i) for i in rng.choice(
            int(mix["keep_from"]), size=int(mix["keep"]), replace=False))
        self.episodes = self.views = None
        if "episodes" in mix:
            self.episodes = [tuple(mix["episodes"][i]) for i in
                             rng.permutation(len(mix["episodes"]))]
        if "views" in mix:
            self.views = [float(mix["views"][i]) for i in
                          rng.permutation(len(mix["views"]))]
        self.check_views = []
        if "check_views" in mix:
            self.check_views = [float(mix["check_views"][i]) for i in
                                rng.choice(len(mix["check_views"]),
                                           size=int(mix["check_kept"]),
                                           replace=False)]
        self.start_deg = (self.views or [e[0] for e in self.episodes])[0]


class Window:
    """What one window produced: the units issued (frames or poses), the
    host seconds, per-unit latencies and the kept frames."""

    def __init__(self):
        self.units = 0
        self.seconds = 0.0
        self.latencies = []
        self.starts = []        # host start of each timed unit
        self.apart = []         # host seconds of frames timed apart
        self.kept = []          # (index, frame tensor, camera dict)

    def keep_last(self, img, cam: dict) -> None:
        """Keep the window's last frame, once."""
        if not self.kept or self.kept[-1][0] != self.units - 1:
            self.kept.append((self.units - 1, img, cam))


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


def check_frames(viewer, mix: dict, plan: Plan, base_pose: tuple,
                 first_index: int) -> list:
    """After the window: the Viewer at each of the plan's check azimuths,
    ``settle_frames`` frames and then the kept one.  Returns the kept
    frames as ``Window.kept`` holds them, indexed from
    ``first_index``."""
    out = []
    cam = viewer.camera
    for i, azimuth in enumerate(plan.check_views):
        set_azimuth(cam, base_pose, azimuth)
        for _ in range(int(mix["settle_frames"])):
            viewer.render(fetch=False)
        out.append((first_index + i, viewer.render(fetch=False),
                    camera_dict(cam)))
    return out
