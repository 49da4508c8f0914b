"""Command-line interface (counterpart of ``mega_nerf_viewer_tpu/cli.py``).

Mirrors the reference CLI (``src/opts.cpp:13-35`` common flags +
``main.cpp:490-505`` viewer flags) with the same names, defaults and
semantics, replacing the interactive GLFW window with headless frame
output: a single PNG, numbered PNGs, or an animated PNG, optionally along
an orbit.  ``--device`` picks the device (default: the CUDA card; ``cpu``
runs the kernels' plain versions).  Run it as::

    python -m mega_nerf_viewer_tpu_torch.cli tree.npz --orbit --frames 4

Not ported yet, and refused: ``--serve`` (the browser viewer) and
``--sharded`` (ROADMAP queue 1, items 9 and 10); ``--turbo`` and
``--foveation`` > 1 make the viewer raise (items 8 and 9).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="mega-nerf-viewer-torch",
        description="Headless Mega-NeRF / PlenOctree renderer on PyTorch "
                    "and CUDA")
    # --- common opts (opts.cpp:17-32) ---
    p.add_argument("file", nargs="?", help="npz file storing octree data")
    p.add_argument("--bg", type=float, default=0.0,
                   help="background brightness 0-1")
    p.add_argument("-s", "--step_size", type=float, default=1e-4,
                   help="step size epsilon added to computed cube size")
    p.add_argument("-e", "--stop_thresh", type=float, default=1e-2,
                   help="early stopping threshold (remaining intensity)")
    p.add_argument("-a", "--sigma_thresh", type=float, default=1e-2,
                   help="sigma threshold (skip cells with < sigma)")
    p.add_argument("--model_path", type=str, default="",
                   help="TorchScript Mega-NeRF container path")
    p.add_argument("-c", "--max_tree_capacity", type=int, default=20000000,
                   help="max capacity of octree")
    p.add_argument("-x", "--split_batch_size", type=int, default=4096,
                   help="max number of splits performed per batch")
    p.add_argument("-n", "--nerf_batch_size", type=int, default=4096,
                   help="max number of nerf evals performed per batch")
    p.add_argument("-v", "--samples_per_voxel", type=int, default=8,
                   help="number of guided_samples per voxel")
    p.add_argument("-b", "--bounds_only", action="store_true",
                   help="only load bounds and scale")
    p.add_argument("-y", "--appearance_embedding", type=int, default=-1,
                   help="appearance embedding to use")
    p.add_argument("-z", "--max_guided_samples", type=int, default=128,
                   help="max guided_samples to use per ray")
    # --- viewer opts (main.cpp:490-505) ---
    p.add_argument("-w", "--width", type=int, default=800)
    p.add_argument("--height", type=int, default=800)
    p.add_argument("--fx", type=float, default=1111.0)
    p.add_argument("--fy", type=float, default=-1.0,
                   help="-1 = use fx")
    p.add_argument("--cx", type=float, default=-1.0,
                   help="-1 = use width / 2")
    p.add_argument("--cy", type=float, default=-1.0,
                   help="-1 = use height / 2")
    p.add_argument("--center", type=str, default="-3.5,0,3.5",
                   help="camera center position (world); for negative "
                        "values use --center=-3.5,0,3.5")
    p.add_argument("--back", type=str, default="-0.7071068,0,0.7071068",
                   help="camera back direction unit vector")
    p.add_argument("--origin", type=str, default="0,0,0",
                   help="origin for orbit controls")
    p.add_argument("--world_up", type=str, default="0,0,1",
                   help="world up direction, e.g. 0,0,1=blender")
    p.add_argument("--grid", type=int, default=None,
                   help="show octree wireframe overlay boxes up to depth "
                        "(not ported yet: the viewer raises)")
    # --- headless mode controls ---
    p.add_argument("-o", "--output", type=str, default="out.png",
                   help="output PNG path (or prefix for --frames > 1)")
    p.add_argument("--frames", type=int, default=1,
                   help="number of frames to render")
    p.add_argument("--orbit", action="store_true",
                   help="orbit the camera about --origin across --frames")
    p.add_argument("--fps", type=float, default=30.0,
                   help="playback rate for animated output (-o *.apng)")
    p.add_argument("--render_depth", action="store_true")
    p.add_argument("--use_splitting", action="store_true",
                   help="dynamic octree refinement (GUI key M)")
    p.add_argument("--use_guided_sampling", action="store_true",
                   help="guided ray sampling mode (GUI key R)")
    p.add_argument("--save_tree", type=str, default=None,
                   help="write the (possibly refined) tree back to npz")
    p.add_argument("--sharded", action="store_true",
                   help="shard rays across all local devices (not ported)")
    p.add_argument("--turbo", action="store_true",
                   help="max-empty-cube accelerated marching (not ported)")
    p.add_argument("--foveation", type=int, default=1,
                   help="approximate foveated mode, 1 = off (> 1 not "
                        "ported)")
    p.add_argument("--motion-mode", choices=("rehint", "dilate"),
                   default="rehint",
                   help="how async-policy moved frames regain ray order "
                        "and budgets; accepted and ignored: the CLI runs "
                        "the sync policy, which always dilates")
    p.add_argument("--host-unpermute", action="store_true",
                   help="sorted-frame display delivery: parked frames "
                        "skip the final unpermute and the PNG writer "
                        "applies the inverse ray order (same pixels)")
    p.add_argument("--serve", type=int, default=None, metavar="PORT",
                   help="serve an interactive browser viewer (not ported)")
    p.add_argument("--host", type=str, default="127.0.0.1",
                   help="bind address for --serve")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: the CUDA card; 'cpu' runs "
                        "the kernels' plain versions)")
    return p


def _vec3(s: str) -> np.ndarray:
    v = np.asarray([float(x) for x in s.split(",")], np.float32)
    if v.shape != (3,):
        raise ValueError(f"expected 3 comma-separated floats, got {s!r}")
    return v


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.serve is not None:
        raise NotImplementedError(
            "--serve (web.py, the browser viewer) is not ported yet: "
            "ROADMAP queue 1, item 9")
    if args.sharded:
        raise NotImplementedError(
            "--sharded (parallel/, multi-device frames) is not ported yet: "
            "ROADMAP queue 1, item 10")
    from .camera import Camera
    from .n3tree import N3Tree
    from .options import options_from_args
    from .utils.png import ApngEncoder, write_png
    from .viewer import Viewer

    options = options_from_args(args)
    options = options.replace(
        render_depth=args.render_depth,
        use_splitting=args.use_splitting,
        use_guided_sampling=args.use_guided_sampling,
        max_guided_samples=args.max_guided_samples,
    )

    camera = Camera(args.width, args.height, args.fx, args.fy,
                    args.cx, args.cy)
    camera.center = _vec3(args.center)
    camera.v_back = _vec3(args.back)
    camera.origin = _vec3(args.origin)
    camera.v_world_up = _vec3(args.world_up)
    camera._update()

    viewer = Viewer(camera=camera, options=options, device=args.device)
    viewer.use_turbo_map = args.turbo
    viewer.foveation = args.foveation
    viewer.host_unpermute = args.host_unpermute

    if args.model_path:
        viewer.load_model(args.model_path)

    if args.file:
        if not os.path.exists(args.file):
            # reference prints and continues without a tree
            # (n3tree.cpp:19-22); the headless CLI exits with an error
            print(f"Can't load because file does not exist: {args.file}",
                  file=sys.stderr)
            return 1
        max_cap = args.max_tree_capacity if (
            args.use_splitting or args.model_path) else None
        tree = N3Tree.open(args.file, max_capacity=max_cap,
                           bounds_only=args.bounds_only,
                           device=viewer.device)
        viewer.set(tree, max_tree_capacity=args.max_tree_capacity
                   if max_cap else None)
    else:
        print("No octree file given; rendering background only.")

    # frames reach the PNG writer as device-quantized rgba8
    animate = None
    if args.output.endswith(".apng"):
        animate = ApngEncoder(fps=args.fps)
    t0 = time.perf_counter()
    for f in range(args.frames):
        if args.orbit and args.frames > 1 and f:
            # each drag is incremental from the current pose: a constant
            # per-frame step of 2*pi/frames makes one even orbit
            step = 2.0 * np.pi / args.frames
            viewer.camera.begin_drag(0.0, 0.0, False, True)
            span = max(camera.width, camera.height)
            viewer.camera.drag_update(
                -step * span / (2.0 * viewer.camera.movement_speed), 0.0)
            viewer.camera.end_drag()
        rgba8 = viewer.render_rgba8()
        if animate is not None:
            animate.add(rgba8)
        else:
            out = (args.output.replace(".png", "") + f"_{f:04d}.png"
                   if args.frames > 1 else args.output)
            write_png(out, rgba8)
    if animate is not None and not animate.write(args.output):
        print(f"Failed to write {args.output}", file=sys.stderr)
        return 1
    dt = time.perf_counter() - t0
    print(f"Rendered {args.frames} frame(s) at "
          f"{camera.width}x{camera.height} on {viewer.get_backend()} in "
          f"{dt:.3f}s ({args.frames / dt:.2f} fps); wrote {args.output}")
    if args.save_tree and viewer.tree is not None:
        viewer.tree.save_npz(args.save_tree)
        print(f"Saved tree -> {args.save_tree}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
