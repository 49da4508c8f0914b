"""``benchmarks/foveated1080p.py`` through the port: the Viewer's foveated
approximate mode at 1080p on one CUDA card.

The periphery renders at 1/f resolution through the segmented fast path
(kernels A and B) and the centre window at full resolution, composed on the
card.  Steady fps (a parked camera: two warm frames, then 10 frames of the
full render path) and motion fps (3 warm orbit poses, then ``n_frames``
timed poses of ``deg`` degrees) at ``f``, then both for the exact f = 1
frame; each Viewer runs the async overflow policy with
``overflow_check_interval`` 8, as in JAX.  Frames stay on the card and are
summed into a checksum read once at the end of each timing.  The scene is
JAX's: ``shell_tree(depth=8, basis_dim=9, sigma_inside=400)`` at 1920x1080,
f = 1111, ``fast_chunk_size`` 2176.

Usage: python benchmarks_torch/foveated1080p.py [f] [n_frames] [deg]
Prints ONE JSON line with JAX's keys: ``metric`` ``foveated_1080p``,
``f``, ``steady_fps``, ``motion_fps``, ``exact_steady_fps``,
``exact_motion_fps``, ``value`` (= ``steady_fps``), ``unit``.
Environment: ``_overrides_torch``.  On stderr: the card and its power
limit, and the kernel launches of the run.
"""

import os
import sys
import time
from types import SimpleNamespace

sys.path[:0] = [os.path.dirname(os.path.abspath(__file__)),
                os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]

import _overrides_torch
from _overrides_torch import orbit_step


def run(f=4, n=20, deg=3.0, width=1920, height=1080, depth=8, device=None):
    """The protocol on ``device`` (``None``: the card).  Returns (record
    without ``smoke``, namespace of the two Viewers by foveation)."""
    import torch
    import mega_nerf_viewer_tpu_torch as P
    from mega_nerf_viewer_tpu_torch.device import resolve_device
    dev = resolve_device(device)
    tree = P.shell_tree(depth=depth, basis_dim=9, sigma_inside=400.0,
                        device=dev)
    results = {"metric": "foveated_1080p", "f": f}
    viewers = {}

    def build(fov):
        cam = _overrides_torch.camera(width, height, 1111.0)
        v = P.Viewer(tree, camera=cam, options=P.RenderOptions(), device=dev)
        v.fast_chunk_size = 2176
        v.foveation = fov
        v.overflow_policy = "async"
        v.overflow_check_interval = 8
        return v

    def chained(v, reps, move):
        t0 = time.perf_counter()
        acc = torch.zeros((), device=dev)
        for _ in range(reps):
            if move:
                orbit_step(v, deg, width)
            acc = acc + v.render(fetch=False).sum()
        float(acc)
        return reps / (time.perf_counter() - t0)

    def steady_fps(v, reps=10):
        v.render(fetch=False)
        v.render(fetch=False)            # absorb first-pass costs
        return chained(v, reps, False)

    def motion_fps(v):
        for _ in range(3):               # warm every path of the loop
            orbit_step(v, deg, width)
            float(v.render(fetch=False).sum())
        return chained(v, n, True)

    for fov, prefix in ((f, ""), (1, "exact_")):
        v = viewers[fov] = build(fov)
        results[prefix + "steady_fps"] = round(steady_fps(v), 2)
        results[prefix + "motion_fps"] = round(motion_fps(v), 2)
    results["value"] = results["steady_fps"]
    results["unit"] = "fps"
    return results, SimpleNamespace(viewers=viewers)


def main():
    f = int(sys.argv[1]) if len(sys.argv) > 1 else 4
    n = int(sys.argv[2]) if len(sys.argv) > 2 else 20
    deg = float(sys.argv[3]) if len(sys.argv) > 3 else 3.0
    width, height, depth, smoke, dev = _overrides_torch.apply(1920, 1080, 8)
    record, _ = run(f, n, deg, width, height, depth, dev)
    _overrides_torch.emit(record, dev, smoke)
    print(f"# foveated: the periphery at 1/{f} resolution through the "
          f"segmented fast path, the centre window exact; an approximate "
          f"mode the user opts into (Viewer.foveation, --foveation)",
          file=sys.stderr)


if __name__ == "__main__":
    main()
