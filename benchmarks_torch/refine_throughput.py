"""``benchmarks/refine_throughput.py`` through the port: dynamic octree
refinement throughput on one CUDA card.

Each iteration rebuilds the leaf map, renders a vote frame on the fast
path (``render_rays_fast(need_votes=True)``, kernel A with votes; the
Viewer's refinement pipeline) and runs the device expand
(``refine.expand_voxels_jit``: the vote top-K, child allocation and the MLP
fill, plain PyTorch and ``torch.bmm``).  Two iterations warm up, then
``iterations`` are timed; the line reports voxels split per second.  The
scene is JAX's: ``shell_tree(depth=7, basis_dim=1, sigma_inside=400,
max_capacity=400000)`` at 512x512, f = 600, a synthetic 8-cluster model of
8 layers of 256 (seed 0), ``split_batch_size`` 4096, ``max_depth`` 16.

JAX draws each expand's uniforms from a split of ``PRNGKey(0)``; here one
``torch.Generator`` on the device, seeded 0, gives every draw in turn (the
tests hand JAX's draws over instead).  ``leafmap_shape_stable`` is false
when the leaf map's level or deep levels changed inside the timed loop.
JAX warns then of a compile inside the loop; the port compiles nothing
there, so the flag only says that the timed iterations rendered at
another leaf-map size than the warm ones.

Usage: python benchmarks_torch/refine_throughput.py [iterations]
Prints ONE JSON line with JAX's keys: ``metric`` ``refine_throughput``,
``leafmap_shape_stable``, ``splits_per_sec``, ``voxels_filled_per_sec``,
``mlp_evals_per_sec``, ``iterations``, ``total_added``,
``final_capacity``.  Environment: ``_overrides_torch``.  On stderr: the
card and its power limit, and the kernel launches of the run.
"""

import os
import sys
import time
from types import SimpleNamespace

sys.path[:0] = [os.path.dirname(os.path.abspath(__file__)),
                os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]

import _overrides_torch
from _overrides_torch import GUIDED_MODEL

WARM = 2


def scene(width=512, height=512, depth=7, device=None):
    """The tree, the model, the options and the vote frame's rays on
    ``device`` (``None``: the card)."""
    import torch
    import mega_nerf_viewer_tpu_torch as P
    from mega_nerf_viewer_tpu_torch.device import resolve_device
    from mega_nerf_viewer_tpu_torch.ops.rays import rodrigues, screen2worlddir
    dev = resolve_device(device)
    tree = P.shell_tree(depth=depth, basis_dim=1, sigma_inside=400.0,
                        max_capacity=400000, device=dev)
    model_kw = dict(GUIDED_MODEL, need_viewdir=False)
    opt = P.RenderOptions(use_splitting=True, split_batch_size=4096,
                          max_depth=16)
    cam = _overrides_torch.camera(width, height, 600.0)
    dirs, cen = screen2worlddir(cam.width, cam.height, cam.fx, cam.fy,
                                cam.cx, cam.cy,
                                torch.as_tensor(cam.transform,
                                                dtype=torch.float32,
                                                device=dev))
    return SimpleNamespace(
        dev=dev, tree=tree, opt=opt, dirs=dirs, cen=cen,
        vdirs=rodrigues(opt.rot_dirs, dirs),
        model=P.MegaNeRFModel.synthetic(data_dim=4, device=dev, **model_kw))


def vote_frame(s, cur, lm):
    """The vote frame of tree ``cur`` on its leaf map ``lm``: kernel A
    with votes, no skip table (``render_rays_fast``'s result)."""
    from mega_nerf_viewer_tpu_torch.ops import accel
    return accel.render_rays_fast(cur, lm, s.dirs, s.vdirs, s.cen, s.opt,
                                  max_dense=32, chunk_size=4096,
                                  need_votes=True)


def run(iters=5, width=512, height=512, depth=7, device=None, rnds=None):
    """The protocol on ``device`` (``None``: the card).  ``rnds`` (a list
    of ``WARM + iters`` tensors [split_batch_size, 8, spc, 3]) replaces
    the generator's draws, one per expand.  Returns (record without
    ``smoke``, namespace of the final tree, its leaf map level and each
    expand's count)."""
    import torch
    from mega_nerf_viewer_tpu_torch.ops import accel, refine
    s = scene(width, height, depth, device)
    dev, tree, model, opt = s.dev, s.tree, s.model, s.opt
    tracker = torch.zeros((tree.max_capacity,), dtype=torch.int32,
                          device=dev)
    tracker[0] = 1
    gen = torch.Generator(device=dev).manual_seed(0)
    draws = iter(rnds) if rnds is not None else None
    counts = []

    def step(cur, tracker):
        lm = accel.build_leaf_map(cur)
        sv = vote_frame(s, cur, lm).split_vote
        cur, tracker, n = refine.expand_voxels_jit(
            cur, model.params, model.grid_dim, model.min_position,
            model.range, opt, sv, tracker, generator=gen,
            rnd=None if draws is None else next(draws))
        counts.append(int(n))
        return cur, tracker, lm, int(n)

    # two warm iterations: the first expand deepens the tree past its
    # first depth, which moves the leaf map's level
    cur = tree
    for _ in range(WARM):
        cur, tracker, lm, _ = step(cur, tracker)
    warm_shape = (lm.level, lm.deep_levels)

    total_added = 0
    t0 = time.perf_counter()
    for _ in range(iters):
        cur, tracker, lm, n = step(cur, tracker)
        total_added += n
    dt = time.perf_counter() - t0
    shape_stable = (lm.level, lm.deep_levels) == warm_shape
    if not shape_stable:
        print(f"# the leaf map's size changed inside the timed loop: "
              f"{warm_shape} -> {(lm.level, lm.deep_levels)}",
              file=sys.stderr)

    record = {
        "metric": "refine_throughput",
        "leafmap_shape_stable": shape_stable,
        "splits_per_sec": round(total_added / dt, 1),
        "voxels_filled_per_sec": round(total_added * 8 / dt, 1),
        "mlp_evals_per_sec": round(
            total_added * 8 * opt.samples_per_corner / dt, 1),
        "iterations": iters,
        "total_added": total_added,
        "final_capacity": int(cur.capacity),
    }
    return record, SimpleNamespace(tree=cur, level=lm.level, counts=counts)


def main():
    iters = int(sys.argv[1]) if len(sys.argv) > 1 else 5
    width, height, depth, smoke, dev = _overrides_torch.apply(512, 512, 7)
    record, _ = run(iters, width, height, depth, dev)
    _overrides_torch.emit(record, dev, smoke)


if __name__ == "__main__":
    main()
