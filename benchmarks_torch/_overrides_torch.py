"""Smoke overrides, output and scene constants shared by the port's
benchmark scripts.

The counterpart of ``benchmarks/_overrides.py``.  Environment knobs (any of
them marks the run as a smoke run: the scripts add ``"smoke": true`` to
their JSON line, so its figures are never taken for a measurement):

* ``BENCH_FORCE_CPU=1``: the caller asks for the CPU, where the script runs
  the kernels' plain PyTorch versions.  Without it the script needs a CUDA
  card and raises where there is none; it never carries on on the CPU.
* ``BENCH_WH=WxH``: the frame size.
* ``BENCH_DEPTH=N``: the octree depth (where the script has a depth knob).

The module is not called ``_overrides``: a process that holds both
``benchmarks/`` and ``benchmarks_torch/`` on ``sys.path`` (the tests) then
imports each helper by its own name.  For the same reason the scripts
share their constants through this module, never by importing each other.
It also holds the one-line contract: each JAX script's metric and keys
(``JAX_KEYS``) and the keys each port script drops (``DROPPED``, each
named in that script's docstring), which ``chip_smoke.py`` and the tests
hold the lines to.
"""

import json
import os
import sys

import numpy as np

# the benchmarks' camera centre, and the synthetic Mega-NeRF model of the
# guided scripts (8 clusters, 8 layers of 256, seed 0)
CENTER = (-1.4, 0.1, 1.3)
GUIDED_MODEL = dict(n_clusters=8, hidden=256, n_layers=8, grid_dim=(2, 4),
                    min_position=(-1.5, -1.5, -1.5),
                    max_position=(1.5, 1.5, 1.5), need_viewdir=True)

# each JAX script's metric and keys (benchmarks/*.py, the record dicts),
# without "smoke"
JAX_KEYS = {
    "guided1080p": ("guided_sampling_1080p", {
        "metric", "invalidation_ms", "invalidation_segmented_ms",
        "mlp_samples", "composite_compact_ms", "composite_pallas_ms",
        "max_guided_samples"}),
    "motion1080p": ("motion_1080p_fps", {
        "metric", "value", "unit", "poses", "deg_per_pose", "policy",
        "motion_mode", "hint_rebuilds", "rays_per_sec"}),
    "motion_guided1080p": ("motion_guided_1080p_fps", {
        "metric", "value", "unit", "ms_per_move", "poses", "deg_per_pose",
        "max_guided_samples", "foveation", "warmup_poses"}),
    "foveated1080p": ("foveated_1080p", {
        "metric", "f", "steady_fps", "motion_fps", "exact_steady_fps",
        "exact_motion_fps", "value", "unit"}),
    "refine_throughput": ("refine_throughput", {
        "metric", "leafmap_shape_stable", "splits_per_sec",
        "voxels_filled_per_sec", "mlp_evals_per_sec", "iterations",
        "total_added", "final_capacity"}),
    "parity": ("parity_vs_oracle", {
        "metric", "max_err", "p999_err", "frac_within_1e-3", "psnr_err_db",
        "pixels_probed"}),
    "orbit4k": ("orbit_4k_frames_per_sec", {
        "metric", "value", "unit", "devices", "rays_per_sec"}),
}
# the keys a port script drops, each named in its docstring
DROPPED = {"guided1080p": {"composite_pallas_ms"}}


def port_keys(name: str) -> set:
    """The keys of the port script ``name``'s line (without "smoke")."""
    return JAX_KEYS[name][1] - DROPPED.get(name, set())


def camera(width: int, height: int, focal: float, center=CENTER):
    """The scripts' camera: ``focal`` in pixels, looking at the origin
    from ``center``."""
    from mega_nerf_viewer_tpu_torch import Camera
    cam = Camera(width, height, focal)
    cam.center = np.array(center, np.float32)
    cam._update()
    return cam


def orbit_step(v, deg: float, width: int) -> None:
    """Orbit the Viewer's camera by ``deg`` degrees, as a mouse drag of the
    scripts' protocol moves it."""
    v.camera.begin_drag(0.0, 0.0, False, True)
    v.camera.drag_update(-np.deg2rad(deg) * width / 2.0, 0.0)
    v.camera.end_drag()


def apply(width: int, height: int, depth=None):
    """Apply the environment; returns (width, height, depth, smoke,
    device).  ``device`` is ``cpu`` under ``BENCH_FORCE_CPU``, else the
    CUDA card (raises without one)."""
    from mega_nerf_viewer_tpu_torch.device import resolve_device
    smoke = False
    device = None
    if os.environ.get("BENCH_FORCE_CPU"):
        device = "cpu"
        smoke = True
    wh = os.environ.get("BENCH_WH")
    if wh:
        width, height = (int(x) for x in wh.split("x"))
        smoke = True
    d = os.environ.get("BENCH_DEPTH")
    if d:
        if depth is not None:
            depth = int(d)
        smoke = True
    return width, height, depth, smoke, resolve_device(device)


def emit(record: dict, device, smoke: bool) -> None:
    """Print ``record`` as the one stdout line (with ``"smoke": true`` on a
    smoke run); on stderr the card and its power limit, and the kernel
    launches of the whole process (``bench_torch.py``'s ``# launches``
    line)."""
    import torch
    from bench_torch import LAUNCHES_MARK, card_line
    from mega_nerf_viewer_tpu_torch import kernels
    if smoke:
        record["smoke"] = True      # env-overridden run: NOT reportable
    print(f"# card: {card_line(torch.device(device))}", file=sys.stderr,
          flush=True)
    print(json.dumps(record), flush=True)
    print(LAUNCHES_MARK + json.dumps(dict(kernels.LAUNCHES)),
          file=sys.stderr, flush=True)
