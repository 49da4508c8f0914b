"""``benchmarks/motion_guided1080p.py`` through the port: guided sampling
under a moving camera at 1080p, through the Viewer on one CUDA card.

Every pose moves the camera, so each timed frame pays the whole guided
invalidation of the reference's R mode (cuda_renderer.cpp:103-139): the
collect march with CDF budgets and escalation (kernels B and C), the
compact reconstruction, the grouped MLP query (``torch.bmm``), the order
rebuild and the compact composite (kernel D).  With ``foveation`` > 1 the
periphery at 1/foveation resolution and the exact centre window each run
their own guided pipeline (kernels C and D on each sub-view).  The scene is
JAX's: ``shell_tree(depth=8, basis_dim=1, sigma_inside=400)``, a synthetic
8-cluster model of 8 layers of 256 (seed 0), ``max_tree_capacity`` four
times the tree's.

Warm-up: the first invalidation, then moved poses until one is not fresh,
at most 12.  JAX counts a pose fresh when it compiled an XLA program
(``jax_log_compiles``); that has no meaning here.  Here a pose is fresh
when it grew the caching allocator's reserve
(``torch.cuda.memory_reserved()``), the one-time cost of a first pass
through a shape (the kernel library is built and loaded by the first
invalidation, before the warm-up poses).  ``warmup_poses`` counts
the poses it took; it measures something else than JAX's and is not
compared with it.  Then ``n_poses`` timed poses, each frame left on the
card and summed into a checksum read once at the end.

Usage: python benchmarks_torch/motion_guided1080p.py [n_poses] [deg] [S]
           [foveation]
Prints ONE JSON line with JAX's keys: ``metric``
``motion_guided_1080p_fps``, ``value``, ``unit``, ``ms_per_move``,
``poses``, ``deg_per_pose``, ``max_guided_samples``, ``foveation``,
``warmup_poses``.  Environment: ``_overrides_torch``.  On stderr: the card
and its power limit, and the kernel launches of the run.
"""

import os
import sys
import time
from types import SimpleNamespace

sys.path[:0] = [os.path.dirname(os.path.abspath(__file__)),
                os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]

import _overrides_torch
from _overrides_torch import GUIDED_MODEL, orbit_step

MAX_WARMUP = 12


def run(n_poses=8, deg=3.0, S=32, foveation=1, width=1920, height=1080,
        depth=8, device=None):
    """The protocol on ``device`` (``None``: the card).  Returns (record
    without ``smoke``, namespace of the Viewer and the checksum)."""
    import torch
    import mega_nerf_viewer_tpu_torch as P
    from mega_nerf_viewer_tpu_torch.device import resolve_device
    dev = resolve_device(device)
    tree = P.shell_tree(depth=depth, basis_dim=1, sigma_inside=400.0,
                        device=dev)
    model = P.MegaNeRFModel.synthetic(data_dim=4, device=dev,
                                      **GUIDED_MODEL)
    cam = _overrides_torch.camera(width, height, 1111.0)
    # growth room: above 3/4 of the capacity a moved pose turns on visit
    # tracking, which takes the exact collect
    v = P.Viewer(tree, camera=cam, max_tree_capacity=int(tree.capacity) * 4,
                 options=P.RenderOptions(use_guided_sampling=True,
                                         need_viewdir=True,
                                         max_guided_samples=S),
                 device=dev)
    v.model = model
    v.fast_chunk_size = min(1920, width)
    v.foveation = foveation

    def reserved():
        return torch.cuda.memory_reserved(dev) if dev.type == "cuda" else 0

    v.render(fetch=False)
    warmup_poses = 0
    for _ in range(MAX_WARMUP):
        before = reserved()
        orbit_step(v, deg, width)
        float(v.render(fetch=False).sum())
        warmup_poses += 1
        if reserved() <= before:
            break

    t0 = time.perf_counter()
    acc = torch.zeros((), device=dev)
    for _ in range(n_poses):
        orbit_step(v, deg, width)
        acc = acc + v.render(fetch=False).sum()
    float(acc)
    dt = time.perf_counter() - t0

    fps = n_poses / dt
    record = {
        "metric": "motion_guided_1080p_fps",
        "value": round(fps, 3),
        "unit": "fps",
        "ms_per_move": round(dt / n_poses * 1000.0, 1),
        "poses": n_poses,
        "deg_per_pose": deg,
        "max_guided_samples": S,
        "foveation": foveation,
        "warmup_poses": warmup_poses,
    }
    return record, SimpleNamespace(viewer=v, checksum=float(acc))


def main():
    n_poses = int(sys.argv[1]) if len(sys.argv) > 1 else 8
    deg = float(sys.argv[2]) if len(sys.argv) > 2 else 3.0
    S = int(sys.argv[3]) if len(sys.argv) > 3 else 32
    foveation = int(sys.argv[4]) if len(sys.argv) > 4 else 1
    width, height, depth, smoke, dev = _overrides_torch.apply(1920, 1080, 8)
    record, _ = run(n_poses, deg, S, foveation, width, height, depth, dev)
    _overrides_torch.emit(record, dev, smoke)
    print("# a whole guided invalidation per pose: collect march, compact "
          "reconstruction, grouped MLP, order rebuild, compact composite",
          file=sys.stderr)


if __name__ == "__main__":
    main()
