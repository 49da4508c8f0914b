"""``benchmarks/orbit4k.py`` through the port: an orbit rendered at 4K with
the rays sharded over a mesh of ranks (``parallel``), the frame gathered on
every rank.

The mesh is ``parallel.make_mesh((world,), (RAY_AXIS,))``: a world of one
in-process (NCCL on the card, gloo on the CPU) unless a launcher's
``WORLD_SIZE`` names more ranks, each on its own card
(``torchrun --nproc-per-node N benchmarks_torch/orbit4k.py``).  On one card
it runs the same sharded program at a world of one, as JAX's script runs a
1-device mesh on one chip.  Only rank 0 prints the line.

The scene is JAX's: ``shell_tree(depth=8, basis_dim=9, sigma_inside=400)``
at 3840x2160 (8.29M rays), f = 2222, centre (-1.4, 0.1, 1.3).  Each of the
``n_frames`` orbit poses (a uniform step of 2 pi / n_frames) gets its hint
frame (``render_frame_fast``, ``max_dense`` 8, kernels A and B), its ray
order (``order_from_hints``) and segment budgets settled from
``DEFAULT_SEGMENTS`` by doubling the classes that overflow, through
``render_frame_fast_segmented_sharded``.  Then the poses are rendered
again with their orders and budgets, each frame's sum added to a device
checksum read once at the end, and timed.

One step differs from JAX's script, which asserts that no hint frame
overflows at ``max_dense`` 8.  At its defaults four rays of poses 0, 2, 4
and 6 record 9 or 10 dense samples: the JAX package's march gives those
counts on those rays on the CPU, as the port's does
(``tests/test_torch_benchmarks_refine.py``), so that assert fails there.
Here the hint frame doubles ``max_dense`` until no ray overflows, as
``bench.py``'s hint frame does, and says so on stderr.  The hints (steps
and uncapped record counts) and so the order do not depend on the
budget.

Usage: python benchmarks_torch/orbit4k.py [n_frames] [depth]
Prints ONE JSON line with JAX's keys: ``metric``
``orbit_4k_frames_per_sec``, ``value``, ``unit``, ``devices`` (the world
size), ``rays_per_sec``.  Environment: ``_overrides_torch``.  On stderr:
the card and its power limit, and the kernel launches of the run.
"""

import os
import sys
import time
from types import SimpleNamespace

sys.path[:0] = [os.path.dirname(os.path.abspath(__file__)),
                os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]

import numpy as np

import _overrides_torch

# the largest dense-sample budget a hint frame escalates to (bench.py's)
BUDGET_CAP = 512


def scene(width=3840, height=2160, depth=8, device=None):
    """The scene, its acceleration structures, the camera at the start
    pose and the mesh, on ``device`` (``None``: this rank's card)."""
    import torch.distributed as dist
    import mega_nerf_viewer_tpu_torch as P
    from mega_nerf_viewer_tpu_torch import parallel
    from mega_nerf_viewer_tpu_torch.ops import accel
    from mega_nerf_viewer_tpu_torch.parallel.mesh import init_world
    dev = init_world(device)
    world = dist.get_world_size()
    tree = P.shell_tree(depth=depth, basis_dim=9, sigma_inside=400.0,
                        device=dev)
    opt = P.RenderOptions()
    return SimpleNamespace(
        dev=dev, world=world, tree=tree, opt=opt,
        leaf_map=accel.build_leaf_map(tree),
        skip_table=P.build_skip_table(tree, opt.sigma_thresh),
        cam=_overrides_torch.camera(width, height, 2222.0),
        mesh=parallel.make_mesh((world,), (parallel.RAY_AXIS,), device=dev),
        cs=min(1920, width))


def next_pose(s, n_frames):
    """Orbit the camera by one uniform step of 2 pi / ``n_frames`` (each
    drag rotates relative to the current pose)."""
    step = 2.0 * np.pi / max(n_frames, 1)
    s.cam.begin_drag(0.0, 0.0, False, True)
    s.cam.drag_update(-step * s.cam.width / 2.0, 0.0)
    s.cam.end_drag()
    s.cam._update()


def hint_frame(s, max_dense=8):
    """The pose's hint frame (kernels B and A), ``max_dense`` doubled until
    no ray overflows.  Returns (image, max_dense, steps, nrec, skips)."""
    from mega_nerf_viewer_tpu_torch.ops import accel
    while True:
        img, ovh, steps, nrec, skips = accel.render_frame_fast(
            s.tree, s.leaf_map, s.cam, s.opt, max_dense=max_dense,
            chunk_size=s.cs, block=64, return_nrec=True,
            skip_table=s.skip_table, return_skips=True)
        if not int(ovh):
            return img, max_dense, steps, nrec, skips
        max_dense *= 2
        if max_dense > BUDGET_CAP:
            raise RuntimeError("pathological dense-sample count")


def sharded_frame(s, order, segments):
    """The segmented frame with the rays sharded over the mesh.  Returns
    (image, per-segment overflow)."""
    from mega_nerf_viewer_tpu_torch import parallel
    return parallel.render_frame_fast_segmented_sharded(
        s.tree, s.leaf_map, s.cam, s.opt, order=order,
        segments=tuple(segments), mesh=s.mesh, chunk_size=s.cs,
        skip_table=s.skip_table)


def settle(s, order):
    """Budgets from ``DEFAULT_SEGMENTS``, the classes that overflow doubled
    until none does.  Returns (image, settled segments)."""
    from mega_nerf_viewer_tpu_torch.ops import accel
    segments = list(accel.DEFAULT_SEGMENTS)
    while True:
        img, seg_ov = sharded_frame(s, order, segments)
        ov = seg_ov.cpu().numpy()
        if not ov.any():
            return img, tuple(segments)
        for i, hit in enumerate(ov):
            if hit:
                segments[i] = (segments[i][0], max(1, segments[i][1] * 2))


def run(n_frames=8, width=3840, height=2160, depth=8, device=None):
    """The protocol on ``device`` (``None``: this rank's card).  Returns
    (record without ``smoke``, namespace of each pose's order and settled
    segments, the last timed frame and this process's rank)."""
    import torch
    import torch.distributed as dist
    from mega_nerf_viewer_tpu_torch.ops import accel
    s = scene(width, height, depth, device)

    # each pose's hints, order and settled budgets: an orbit inverts the
    # cost map between opposite poses, so one start-pose order would march
    # most poses on mis-sorted rays
    poses = []
    for f in range(n_frames):
        next_pose(s, n_frames)
        _, md, steps, nrec, skips = hint_frame(s)
        if md > 8:
            print(f"# pose {f}: rays record more than max_dense 8; the "
                  f"hint frame took max_dense {md}", file=sys.stderr)
        order = accel.order_from_hints(steps, nrec, skips)
        img, segments = settle(s, order)
        poses.append((np.array(s.cam.transform), order, segments))
    float(img.sum())

    t0 = time.perf_counter()
    acc = torch.zeros((), device=s.dev)
    for transform, order, segments in poses:
        s.cam.transform = transform
        img, _ = sharded_frame(s, order, segments)
        acc = acc + img.sum()
    float(acc)
    dt = time.perf_counter() - t0

    record = {
        "metric": "orbit_4k_frames_per_sec",
        "value": round(n_frames / dt, 4),
        "unit": "fps",
        "devices": s.world,
        "rays_per_sec": round(n_frames * width * height / dt, 0),
    }
    return record, SimpleNamespace(
        orders=[tuple(o.cpu().numpy() for o in p[1]) for p in poses],
        segments=[p[2] for p in poses], img=img.cpu().numpy(),
        rank=dist.get_rank())


def main():
    n_frames = int(sys.argv[1]) if len(sys.argv) > 1 else 8
    depth = int(sys.argv[2]) if len(sys.argv) > 2 else 8
    width, height, depth, smoke, dev = _overrides_torch.apply(3840, 2160,
                                                              depth)
    if dev.type == "cuda" and "WORLD_SIZE" in os.environ:
        dev = None                       # each rank takes its own card
    record, out = run(n_frames, width, height, depth, dev)
    if out.rank == 0:
        _overrides_torch.emit(record, dev or "cuda", smoke)
    import torch.distributed as dist
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
