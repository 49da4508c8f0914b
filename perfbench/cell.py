"""The system under test, built for one cell from its configuration and
its traffic mix: the port's ``Viewer`` on the scene's tree, with the
configuration's model where it names one.

Only the port's public API is used: ``N3Tree.open``, ``Camera``,
``RenderOptions`` and ``Viewer`` (its ``model``); the model itself is
built by ``models/<arch>.py`` (``registry.model_module``).
"""

from __future__ import annotations

import dataclasses
import gc
import math
import os
import time

import numpy as np
import torch

from . import registry, scenes


def cache_dir(root: str) -> str:
    """Where the benchmark's scene files live: inside the checkout, at a
    fixed path, ignored by git."""
    return os.path.join(root, "build", "perfbench")


def render_options(cfg: dict) -> dict:
    """The render options the configuration states, as plain values: the
    program's ``RenderOptions`` and the reference read the same."""
    return dict(cfg["render_options"])


def program_options(options_cls, cfg: dict):
    """The program's ``options_cls`` (``RenderOptions``) with every key of
    the configuration's ``render_options`` passed by name; a list becomes
    a tuple.  A key the class has no field of is an error."""
    opts = render_options(cfg)
    names = {f.name for f in dataclasses.fields(options_cls)}
    unknown = sorted(set(opts) - names)
    if unknown:
        raise ValueError(f"render_options has no field {unknown}")
    return options_cls(**{k: tuple(v) if isinstance(v, list) else v
                          for k, v in opts.items()})


def camera_dict(cam) -> dict:
    """The camera state a frame was rendered at, for the reference."""
    return dict(width=cam.width, height=cam.height, fx=cam.fx, fy=cam.fy,
                cx=cam.cx, cy=cam.cy, transform=np.array(cam.transform,
                                                          np.float32))


def set_azimuth(cam, base: tuple, deg: float) -> None:
    """Put ``cam`` at the ``base`` pose (centre, back vector) turned by
    ``deg`` degrees about the world's up axis through the origin."""
    a = math.radians(deg)
    rz = np.array([[math.cos(a), -math.sin(a), 0.0],
                   [math.sin(a), math.cos(a), 0.0], [0.0, 0.0, 1.0]])
    cam.center = (rz @ np.asarray(base[0], np.float64)).astype(np.float32)
    cam.v_back = (rz @ np.asarray(base[1], np.float64)).astype(np.float32)
    cam._update()


def drag_x(cam, deg: float) -> float:
    """The cursor's x offset that orbits ``cam`` by ``deg`` degrees."""
    return -math.radians(deg) * max(cam.width, cam.height) / 2.0


class Program:
    """The Viewer of one cell, and what was spent setting it up."""

    def __init__(self, root: str, cfg: dict, mix: dict, device,
                 start_deg: float, base: str = registry.HERE):
        import mega_nerf_viewer_tpu_torch as P

        self.device = torch.device(device)
        marks = [("start", time.perf_counter())]
        path, self.scene_build_s = scenes.ensure_scene(cache_dir(root),
                                                       cfg["scene"])
        self.scene_path = path
        marks.append(("scene", time.perf_counter()))
        v_cfg = cfg["viewer"]
        tree = P.N3Tree.open(path, max_capacity=v_cfg.get(
            "max_tree_capacity"), device=self.device)
        marks.append(("tree", time.perf_counter()))
        r = cfg["render"]
        cam = P.Camera(r["width"], r["height"], r["focal"])
        self.base_pose = (np.asarray(mix["start_center"], np.float32),
                          cam.v_back.copy())
        set_azimuth(cam, self.base_pose, start_deg)
        opt = program_options(P.RenderOptions, cfg)
        model = None
        if "model" in cfg:
            spec = cfg["model"]
            model = registry.model_module(spec["arch"], base).build(
                spec, self.device)
            marks.append(("model", time.perf_counter()))
        v = P.Viewer(tree, camera=cam, options=opt, model=model,
                     device=self.device)
        marks.append(("viewer", time.perf_counter()))
        # seconds of each set-up step, for the log
        self.setup_steps = [(n, t - p) for (_, p), (n, t)
                            in zip(marks[:-1], marks[1:])]
        for k in ("overflow_policy", "motion_mode", "motion_flag_interval",
                  "foveation", "use_fast_path"):
            if k in v_cfg:
                setattr(v, k, v_cfg[k])
        self.viewer = v

    def free(self) -> None:
        """Drop the program's state and return its memory to the card."""
        self.viewer = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
