"""One rank of the port's multi-device cases on the CPU (gloo).

``tests/test_torch_parallel*.py`` start ``world`` copies of this script,
one per rank, and hold what they write against the JAX package's sharded
functions.  It imports the port only, never ``jax`` (so it runs as a
script, outside pytest and ``tests/conftest.py``).  Run as::

    python tests/torch_parallel_worker.py OUTDIR WORLD RANK

with ``MASTER_ADDR``, ``MASTER_PORT``, ``RANK`` and ``WORLD_SIZE`` in the
environment when WORLD > 1, as ``torchrun`` sets them; WORLD 1 starts a
world of one in-process.  Inputs that the JAX side draws (the refinement
fill's uniforms) are read from ``OUTDIR/inputs.npz``; each rank writes its
results to ``OUTDIR/rank{RANK}.npz`` and, at WORLD 1 and 2, the sharded
CLI's PNG to ``OUTDIR/cli.png`` from rank 0.
"""

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import mega_nerf_viewer_tpu_torch as P  # noqa: E402
from mega_nerf_viewer_tpu_torch import parallel  # noqa: E402
from mega_nerf_viewer_tpu_torch.ops import accel  # noqa: E402
from mega_nerf_viewer_tpu_torch.ops import guided  # noqa: E402
from mega_nerf_viewer_tpu_torch.ops.rays import (  # noqa: E402
    rodrigues, screen2worlddir)
from mega_nerf_viewer_tpu_torch.parallel import multihost  # noqa: E402

CENTER = (-1.5, 0.1, 1.4)
GUIDED_MODEL = dict(data_dim=4, n_clusters=4, grid_dim=(2, 2),
                    min_position=(-1, -1, -1), max_position=(1, 1, 1),
                    need_viewdir=True)
REFINE_MODEL = dict(data_dim=4, n_clusters=4, hidden=16, n_layers=4,
                    grid_dim=(2, 2), min_position=(-2, -2, -2),
                    max_position=(2, 2, 2))
REFINE_OPT = dict(use_splitting=True, split_batch_size=16,
                  samples_per_corner=8)


def camera(w, h, f, center=CENTER):
    cam = P.Camera(w, h, f)
    cam.center = np.asarray(center, np.float32)
    cam._update()
    return cam


def rays(cam, opt):
    dirs, cen = screen2worlddir(cam.width, cam.height, cam.fx, cam.fy,
                                cam.cx, cam.cy,
                                torch.as_tensor(cam.transform))
    return dirs, rodrigues(opt.rot_dirs, dirs), cen


def sphere(**kw):
    return P.sphere_tree(device="cpu", **kw)


def exact_cases(out, mesh):
    """Exact march with visit marks; the padded 9x7 exact frame."""
    tree = sphere(basis_dim=1, depth=3)
    opt = P.RenderOptions()
    dirs, vdirs, cen = rays(camera(16, 16, 20.0), opt)
    res = parallel.render_rays_sharded(tree, dirs, vdirs, cen, opt, mesh,
                                       track_visit=True)
    one = P.render_rays(tree, dirs, vdirs, cen, opt, track_visit=True)
    for k in ("out", "split_vote", "visited"):
        out[f"exact_{k}"] = getattr(res, k)
        out[f"exact_{k}_single"] = getattr(one, k)
    tree = sphere(basis_dim=1, depth=2)
    cam = camera(9, 7, 10.0)
    out["pad"] = parallel.render_frame_sharded(tree, cam, opt, mesh)
    out["pad_single"] = P.render_frame(
        tree, 9, 7, cam.fx, cam.fy, cam.cx, cam.cy, cam.transform, opt)[0]


def fast_cases(out, mesh):
    """The sharded fast frame, without and with the skip table."""
    tree = sphere(basis_dim=4, depth=3)
    lm = P.build_leaf_map(tree)
    opt = P.RenderOptions(background_brightness=0.3)
    cam = camera(16, 16, 20.0)
    out["fast"], out["fast_ov"] = parallel.render_frame_fast_sharded(
        tree, lm, cam, opt, mesh)
    out["fast_single"] = P.render_frame_fast(tree, lm, cam, opt,
                                             max_dense=32, chunk_size=0)[0]
    tree = sphere(basis_dim=1, depth=3)
    lm = P.build_leaf_map(tree)
    opt = P.RenderOptions()
    tab = P.build_skip_table(tree, opt.sigma_thresh)
    cam = camera(16, 16, 18.0)
    out["skip"], out["skip_ov"] = parallel.render_frame_fast_sharded(
        tree, lm, cam, opt, mesh, max_dense=16, skip_table=tab)
    out["skip_single"] = P.render_frame_fast(
        tree, lm, cam, opt, max_dense=16, chunk_size=0, skip_table=tab)[0]


def segmented_cases(out, mesh):
    """Stride deal, starved budgets, sorted output and the chunk-exact
    deal (``test_parallel.py:266``, ``:348``)."""
    n = mesh.shape[parallel.RAY_AXIS]
    tree = sphere(basis_dim=4, depth=4)
    lm = P.build_leaf_map(tree)
    opt = P.RenderOptions()
    cam = camera(32, 32, 24.0, (-1.6, 0.3, 1.5))
    img0, ov0, steps, nrec = P.render_frame_fast(
        tree, lm, cam, opt, max_dense=16, chunk_size=64, block=8,
        return_nrec=True)
    order = P.order_from_hints(steps, nrec)
    out["seg_perm"] = order[0]
    out["seg_single"] = img0
    segs = ((0.5, 2), (0.25, 4), (0.25, 16))
    out["seg"], out["seg_ov"] = parallel.render_frame_fast_segmented_sharded(
        tree, lm, cam, opt, order=order, segments=segs, mesh=mesh,
        chunk_size=64)
    _, out["seg_starved_ov"] = parallel.render_frame_fast_segmented_sharded(
        tree, lm, cam, opt, order=order,
        segments=((0.5, 0), (0.25, 0), (0.25, 1)), mesh=mesh, chunk_size=64)
    rows, out["seg_sorted_ov"], idx = \
        parallel.render_frame_fast_segmented_sharded(
            tree, lm, cam, opt, order=order, segments=segs, mesh=mesh,
            chunk_size=64, sorted_output=True)
    out["seg_rows"], out["seg_index"] = rows, idx
    # chunk-exact budgets dealt by stratified LPT over per-chunk costs
    cs = 32
    nrec_s = nrec[order[0]]
    seg_counts = P.seg_counts_from_hints(nrec_s, cs, quantum=n)
    costs = steps[order[0]].reshape(-1, cs).sum(1).double().numpy()
    out["exact_counts"] = np.asarray(seg_counts, np.int64)
    out["exact_costs"] = costs
    out["chunk_exact"], out["chunk_exact_ov"] = \
        parallel.render_frame_fast_segmented_sharded(
            tree, lm, cam, opt, order=order, segments=None, mesh=mesh,
            chunk_size=cs, seg_counts=seg_counts, chunk_costs=costs)


def guided_cases(out, mesh):
    """The sharded guided frame and its overflow (``test_parallel.py:173``)."""
    tree = sphere(basis_dim=1, depth=3)
    lm = P.build_leaf_map(tree)
    model = P.MegaNeRFModel.synthetic(device="cpu", **GUIDED_MODEL)
    opt = P.RenderOptions(max_guided_samples=16, need_viewdir=True,
                          use_guided_sampling=True)
    cam = camera(16, 16, 18.0)
    img, ov = parallel.guided_frame_sharded(tree, lm, model, cam, opt, mesh,
                                            budget=1 << 12)
    out["guided"], out["guided_ov"] = img, np.int32(ov)
    cache = guided.collect_and_query_fast(tree, lm, model, cam, opt,
                                          chunk_size=0)
    out["guided_single"] = guided.composite_frame(tree, cam, opt, cache)
    _, ov2 = parallel.guided_frame_sharded(tree, lm, model, cam, opt, mesh,
                                           budget=1)
    out["guided_starved_ov"] = np.int32(ov2)


def motion_cases(out, mesh):
    """Two re-hint poses and a sorted-output pose
    (``test_parallel.py:381``, ``:443``)."""
    tree = sphere(basis_dim=4, depth=4)
    lm = P.build_leaf_map(tree)
    opt = P.RenderOptions()
    w, h = 64, 48
    cam = camera(w, h, 70.0)
    _, _, steps, nrec, skips = P.render_frame_fast(
        tree, lm, cam, opt, max_dense=16, chunk_size=0, return_nrec=True,
        return_skips=True)
    ph = accel.pack_hints(steps, nrec, skips)
    perm, inv = accel.order_from_packed_device(ph)
    qperm = accel.quarter_order_from_packed(ph, width=w)
    segs = accel.segments_from_hint_cdf(accel.hint_class_cdf(nrec), w * h,
                                        margin=2, top_headroom=True)
    out["motion_segs"] = np.asarray(segs, np.float64)
    pix_str, qpix_str = parallel.motion_episode_layout(
        (perm, inv), qperm, mesh=mesh, chunk_size=64, hint_chunk=32)
    out["motion_pix_str"], out["motion_qpix_str0"] = pix_str, qpix_str
    qsp = qperm
    for i, pose in enumerate([(-1.45, 0.12, 1.35), (-1.42, 0.14, 1.38)]):
        cam.center = np.array(pose, np.float32)
        cam._update()
        img, ov, qpix_str, cdf = parallel.render_frame_motion_sharded(
            tree, lm, cam, opt, qpix_str, pix_str, segs, mesh=mesh,
            chunk_size=64, hint_chunk=32)
        _, ov1, _, cdf1, qsp = P.render_frame_motion(
            tree, lm, cam, opt, qsp, segments=segs, chunk_size=64,
            hint_stride=2)
        out[f"motion{i}"], out[f"motion{i}_ov"] = img, ov
        out[f"motion{i}_qpix"], out[f"motion{i}_cdf"] = qpix_str, cdf
        out[f"motion{i}_single_cdf"], out[f"motion{i}_single_ov"] = cdf1, ov1
        out[f"motion{i}_fresh"] = P.render_frame_fast(
            tree, lm, cam, opt, max_dense=16, chunk_size=0)[0]
    rows, pix_sorted, _, _, _ = parallel.render_frame_motion_sharded(
        tree, lm, cam, opt, out["motion0_qpix"], pix_str, segs, mesh=mesh,
        chunk_size=64, hint_chunk=32, sorted_output=True)
    img, _, _, _ = parallel.render_frame_motion_sharded(
        tree, lm, cam, opt, out["motion0_qpix"], pix_str, segs, mesh=mesh,
        chunk_size=64, hint_chunk=32)
    out["motion_rows"], out["motion_pix_sorted"] = rows, pix_sorted
    out["motion_sorted_img"] = img


def tp_cases(out, mesh, inputs):
    """The tensor-parallel MLP on a (rays 2, model 2) mesh, with a 4-layer
    model, a 3-layer one (last layer replicated) and one with a skip (all
    layers replicated); each ray shard's rows gathered."""
    from mega_nerf_viewer_tpu_torch.models import meganerf as PM
    from mega_nerf_viewer_tpu_torch.parallel.mesh import (gather_rays,
                                                          ray_shard)
    x = torch.from_numpy(inputs["tp_x"])
    ids = torch.from_numpy(inputs["tp_ids"])
    sl = ray_shard(mesh, x.shape[0])
    for name, n_layers in (("tp4", 4), ("tp3", 3)):
        params = P.MegaNeRFModel.synthetic(
            data_dim=4, n_clusters=4, hidden=32, n_layers=n_layers, seed=3,
            device="cpu").params
        local = parallel.tp_param_specs(params, mesh)
        out[name] = gather_rays(mesh, parallel.mlp_forward_all_tp(
            local, ids[sl], x[sl], mesh=mesh))
        out[name + "_c1"] = gather_rays(mesh, parallel.mlp_forward_tp(
            local, 1, x[sl], mesh=mesh))
    skip = PM.params_from_numpy(
        [inputs[f"skip_w{l}"] for l in range(4)],
        [inputs[f"skip_b{l}"] for l in range(4)], (2,), device="cpu")
    local = parallel.tp_param_specs(skip, mesh)
    out["tp_skip_rep"] = np.int32(all(
        torch.equal(a, b) for a, b in zip(local.weights, skip.weights)))
    out["tp_skip"] = gather_rays(mesh, parallel.mlp_forward_all_tp(
        local, ids[sl], x[sl], mesh=mesh))


def refine_case(out, mesh, inputs):
    """The frame-refine step on a (rays 2, model 2) mesh with JAX's draws
    (``test_parallel.py:92``)."""
    tree = sphere(basis_dim=1, depth=3, max_capacity=2000)
    model = P.MegaNeRFModel.synthetic(device="cpu", **REFINE_MODEL)
    opt = P.RenderOptions(**REFINE_OPT)
    step = parallel.make_frame_refine_step(mesh, opt)
    dirs, vdirs, cen = rays(camera(16, 16, 20.0), opt)
    tracker = torch.zeros((tree.max_capacity,), dtype=torch.int32)
    tracker[0] = 1
    img, new, tracker, n_added = step(
        tree, model.params, model.grid_dim, model.min_position, model.range,
        dirs, vdirs, cen, tracker, rnd=torch.from_numpy(inputs["rnd"]))
    out["refine_out"], out["refine_tracker"] = img, tracker
    out["refine_n"] = np.int32(n_added)
    out["refine_capacity"] = np.int32(new.capacity)
    for k in ("data", "child", "parent", "sample_counts"):
        out[f"refine_{k}"] = getattr(new, k)


def multihost_cases(out, mesh, rank):
    """Rank 1 starts with a wrong tree and wrong weights; after the
    broadcast every rank renders rank 0's (``mh_worker.py``)."""
    tree = sphere(basis_dim=4, depth=3, sigma_inside=0.0 if rank else 20.0)
    tree = multihost.broadcast(tree)
    lm = P.build_leaf_map(tree)
    cam = camera(32, 24, 20.0)
    opt = P.RenderOptions()
    img, _ = multihost.render_frame_fast_sharded_multihost(tree, lm, cam, opt,
                                                           max_dense=32)
    tree_g, lm_g = multihost.replicate(tree), multihost.replicate(lm)
    assert tree_g.data is tree.data
    img2, _ = multihost.render_frame_fast_sharded_multihost(
        tree_g, lm_g, cam, opt, max_dense=32)
    assert torch.equal(img, img2)
    out["mh"] = img
    out["mh_single"] = P.render_frame_fast(tree, lm, cam, opt, max_dense=32,
                                           chunk_size=0)[0]
    model = P.MegaNeRFModel.synthetic(
        data_dim=13, n_clusters=4, grid_dim=(2, 2),
        min_position=(-2, -2, -2), max_position=(2, 2, 2), seed=rank,
        device="cpu")
    params = multihost.broadcast(model.params)
    model = P.MegaNeRFModel(params, model.grid_dim, model.min_position,
                            model.max_position, model.need_viewdir,
                            model.need_appearance_embedding)
    opt_g = P.RenderOptions(max_guided_samples=8, use_guided_sampling=True)
    gimg, g_ov = multihost.guided_frame_sharded_multihost(
        tree, lm, model, cam, opt_g, budget=1 << 12)
    out["mhg"], out["mhg_ov"] = gimg, np.int32(g_ov)
    cache = guided.collect_and_query_fast(tree, lm, model, cam, opt_g,
                                          chunk_size=0)
    out["mhg_single"] = guided.composite_frame(tree, cam, opt_g, cache)


def default_mesh_case(out):
    """Frames called without a mesh reuse the default one: the second
    makes no process group (each would be a collective)."""
    import torch.distributed as dist
    tree = sphere(basis_dim=1, depth=2)
    cam = camera(9, 7, 10.0)
    opt = P.RenderOptions()
    first = parallel.render_frame_sharded(tree, cam, opt)
    groups = len(dist.distributed_c10d._world.pg_map)
    second = parallel.render_frame_sharded(tree, cam, opt)
    out["mesh_groups_made"] = np.int32(
        len(dist.distributed_c10d._world.pg_map) - groups)
    out["mesh_same"] = np.bool_(parallel.default_mesh(device="cpu")
                                is parallel.default_mesh(device="cpu"))
    out["mesh_frames"] = torch.stack([first, second])


def cli_case(outdir):
    """``cli --sharded`` on the tree the test saved; rank 0 writes."""
    from mega_nerf_viewer_tpu_torch import cli
    rc = cli.main([os.path.join(outdir, "cli_tree.npz"), "-w", "16",
                   "--height", "16", "--fx", "16", "--center=-1.5,0.1,1.4",
                   "--sharded", "--device", "cpu", "-o",
                   os.path.join(outdir, "cli.png")])
    assert rc == 0


def main():
    outdir, world, rank = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    torch.set_num_threads(1)
    inputs = dict(np.load(os.path.join(outdir, "inputs.npz")))
    if world <= 2:
        cli_case(outdir)              # joins (or starts) the group
    else:
        multihost.initialize(device="cpu")
    import torch.distributed as dist
    assert dist.get_world_size() == world and dist.get_rank() == rank
    out = {}
    mesh = parallel.make_mesh((world,), (parallel.RAY_AXIS,), device="cpu")
    exact_cases(out, mesh)
    fast_cases(out, mesh)
    segmented_cases(out, mesh)
    guided_cases(out, mesh)
    motion_cases(out, mesh)
    mesh2 = parallel.default_mesh(device="cpu")
    out["default_mesh"] = np.asarray([mesh2.shape[parallel.RAY_AXIS],
                                      mesh2.shape[parallel.MODEL_AXIS]])
    if world == 2:
        multihost_cases(out, mesh, rank)
        default_mesh_case(out)
    if world == 4:
        mesh22 = parallel.make_mesh((2, 2), (parallel.RAY_AXIS,
                                             parallel.MODEL_AXIS),
                                    device="cpu")
        tp_cases(out, mesh22, inputs)
        refine_case(out, mesh22, inputs)
    out = {k: (v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
           for k, v in out.items()}
    np.savez(os.path.join(outdir, f"rank{rank}.npz"), **out)
    dist.barrier()
    dist.destroy_process_group()
    print(f"rank {rank} of {world} ok", flush=True)


if __name__ == "__main__":
    main()
