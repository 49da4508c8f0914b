"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test here needs a CUDA device and skips without one.

Tolerances: the prepass and the collect march are bit-equal (t compared
as int32, integers equal); the march's integers are equal and its rgba
within 1e-6 (the kernel sums shaded samples in order, the plain version
reduces the record buffer; both round each op alike); the compact
compositor within 1e-6 (a running product along the ray against a
cumprod and a masked sum); the padded compositor within 1e-6 (a product
scan in tiles of 8 lanes and a butterfly sum against a cumprod and a
masked sum).  The model's fused product (kernel I) within 2e-5 of
its plain version, relative to the largest output where that exceeds 1:
both are f32 sums over K, in another order.  The march's gated launch is bit-equal to the ungated one
when taken and writes nothing when closed; the frames of the device
policy and of the re-hint motion frame run under sync debug mode
"error".
"""

import numpy as np
import pytest
import torch

import mega_nerf_viewer_tpu_torch as P
from mega_nerf_viewer_tpu_torch import kernels
from mega_nerf_viewer_tpu_torch.ops import accel
from mega_nerf_viewer_tpu_torch.ops import skip_prepass as sp
from mega_nerf_viewer_tpu_torch.ops.rays import screen2worlddir

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _scene(cuda, depth, level=None):
    tree = P.sphere_tree(basis_dim=4, depth=depth, device=cuda)
    lm = P.build_leaf_map(tree, level=level)
    table = P.build_skip_table(tree, P.RenderOptions().sigma_thresh)
    cam = P.Camera(96, 80, 70.0)
    cam.center = np.array([-1.3, 0.2, 1.2], np.float32)
    cam._update()
    dirs, cen = screen2worlddir(
        96, 80, cam.fx, cam.fy, cam.cx, cam.cy,
        torch.as_tensor(cam.transform, device=cuda))
    m = accel.march_inputs(tree, dirs, dirs, cen, P.RenderOptions())
    return tree, lm, table, m


def _prepass_case(cuda, case):
    """Prepass inputs at the kernel's edges: the 96x80 rays of a depth-4 or
    depth-7 sphere (under one resident wave of blocks), one ray, a count
    that is not a multiple of the block, the rays tiled past one resident
    wave, every ray dead, and rays whose tmax ends inside the entry skip."""
    _, _, table, m = _scene(cuda, 4 if case == "depth4" else 7)
    args = [m.cen, m.d, m.invdir, m.tmin, m.tmax, ~m.miss]
    if case == "one_ray":
        _, sk = sp.entry_skip_prepass_reference(table, *args, m.step_size)
        k = int(sk.argmax())
        args = args[:1] + [a[k:k + 1] for a in args[1:]]
    elif case == "ragged":
        args = args[:1] + [a[:7681 - 2 * 512].contiguous() for a in args[1:]]
    elif case == "past_one_wave":
        args = args[:1] + [torch.cat([a] * 60) for a in args[1:]]
    elif case == "all_dead":
        args[5] = torch.zeros_like(args[5])
    elif case == "tmax_in_skip":
        args[4] = torch.where(args[5], args[3] + 0.01, args[4])
    return [table] + args + [m.step_size]


@pytest.mark.parametrize("case", ["depth4", "depth7", "one_ray", "ragged",
                                  "past_one_wave", "all_dead",
                                  "tmax_in_skip"])
def test_prepass_kernel_bit_equal(cuda, case):
    args = _prepass_case(cuda, case)
    before = kernels.LAUNCHES["skip_prepass"]
    tk, sk = kernels.skip_prepass(*args)
    assert kernels.LAUNCHES["skip_prepass"] == before + 1
    tp, sp_ = sp.entry_skip_prepass_reference(*args)
    torch.cuda.synchronize()
    assert torch.equal(tk.view(torch.int32), tp.view(torch.int32))
    assert torch.equal(sk, sp_)
    if case == "all_dead":
        assert int(sk.sum()) == 0 and torch.equal(tk, args[4])
    else:
        assert int(sk.sum()) > 0
    if case == "tmax_in_skip":
        assert bool((args[6] & (sk > 0) & (tk >= args[5])).any())


@pytest.mark.parametrize("max_dense", [16, 2, 0])
@pytest.mark.parametrize("depth,level", [(5, None), (7, 4)])
def test_march_kernel_matches_plain(cuda, max_dense, depth, level):
    tree, lm, table, m = _scene(cuda, depth, level)
    t0, _ = kernels.skip_prepass(table, m.cen, m.d, m.invdir, m.tmin,
                                 m.tmax, ~m.miss, m.step_size)
    m = m._replace(tmin=t0)
    args = (tree, lm, m.cen, m.d, m.invdir, m.delta_scale, m.tmin, m.tmax,
            m.miss, m.basis, m.step_size, m.sigma_thresh, m.stop_thresh,
            max_dense, m.use_sh)
    ok = kernels.march(*args)
    op = accel.render_rays_fast_reference(*args)
    assert float((ok[0] - op[0]).abs().max()) <= 1e-6
    assert int(ok[1]) == int(op[1])
    assert torch.equal(ok[2], op[2]) and torch.equal(ok[3], op[3])


def test_frame_on_card_matches_cpu(cuda):
    frames = []
    for dev in ("cpu", cuda):
        tree = P.sphere_tree(basis_dim=4, depth=5, device=dev)
        lm = P.build_leaf_map(tree)
        table = P.build_skip_table(tree, P.RenderOptions().sigma_thresh)
        cam = P.Camera(64, 64, 37.0)
        cam.center = np.array([-1.4, 0.1, 1.3], np.float32)
        cam._update()
        frames.append(P.render_frame_fast(
            tree, lm, cam, P.RenderOptions(), max_dense=16, chunk_size=256,
            block=16, return_nrec=True, skip_table=table))
    (ic, oc, sc, nc), (ig, og, sg, ng) = frames
    assert int(oc) == int(og.cpu())
    same = (sc == sg.cpu()) & (nc == ng.cpu())
    assert int((~same).sum()) <= 4
    assert float((ic - ig.cpu()).reshape(-1, 4)[same].abs().max()) <= 1e-5


@pytest.mark.parametrize("S", [16, 2, 0])
@pytest.mark.parametrize("depth,level", [(5, None), (7, 4)])
def test_collect_kernel_bit_equal(cuda, S, depth, level):
    """Kernel C against its plain version: t bit-equal, integers equal."""
    from mega_nerf_viewer_tpu_torch.ops import guided
    tree, lm, table, m = _scene(cuda, depth, level)
    t0, _ = kernels.skip_prepass(table, m.cen, m.d, m.invdir, m.tmin,
                                 m.tmax, ~m.miss, m.step_size)
    args = (tree, lm, m.cen, m.d, m.invdir, m.delta_scale, t0, m.tmax,
            m.miss, S, m.step_size, m.sigma_thresh, m.stop_thresh)
    before = kernels.LAUNCHES["collect"]
    ok = kernels.collect(*args)
    assert kernels.LAUNCHES["collect"] == before + 1
    op = guided.collect_t_fast_reference(*args)
    assert torch.equal(ok[0].view(torch.int32), op[0].view(torch.int32))
    for a, b in zip(ok[1:], op[1:]):
        assert torch.equal(a, b)
    assert int(ok[1].sum()) > 0 or S == 0
    if S == 2:
        assert int(ok[3]) > 0


def _compact_cache(cuda, basis_dim, R=3000, opaque=False):
    rng = np.random.RandomState(basis_dim)
    out_dim = 3 * basis_dim + 2
    ns = rng.randint(0, 9, R).astype(np.int32)
    offs = np.cumsum(ns).astype(np.int32)
    M = int(offs[-1]) + 100                        # a padded tail
    res = rng.randn(M, out_dim).astype(np.float32)
    res[:, min(3, out_dim - 1)] = np.abs(res[:, min(3, out_dim - 1)]) * 3
    if opaque:
        starts = (offs - ns)[ns >= 2]
        res[starts, min(3, out_dim - 1)] = 1e8
    z = np.sort(rng.rand(M).astype(np.float32) * 2)
    vd = rng.randn(M, 3).astype(np.float32)
    vd /= np.linalg.norm(vd, axis=1, keepdims=True)
    rop = np.clip(np.searchsorted(offs, np.arange(M), "right"), 0, R - 1)
    return [torch.as_tensor(a).to(cuda) for a in
            (res, z, rop.astype(np.int32), offs, ns, vd)]


@pytest.mark.parametrize("basis_dim,minmax,fmt_sh,opaque", [
    (1, (0, 24), True, False), (9, (0, 24), True, False),
    (9, (1, 5), True, True), (25, (0, 24), True, False),
    (1, (0, 24), False, False)])
def test_compact_composite_kernel_matches_plain(cuda, basis_dim, minmax,
                                                fmt_sh, opaque):
    """Kernel D against its plain version within 1e-6, no NaN."""
    from mega_nerf_viewer_tpu_torch.ops import compact_composite as cc
    args = _compact_cache(cuda, basis_dim, opaque=opaque)
    opt = P.RenderOptions(basis_minmax=minmax)
    before = kernels.LAUNCHES["compact_composite"]
    ok = cc.composite_results_compact_kernel(*args, opt, basis_dim, fmt_sh)
    assert kernels.LAUNCHES["compact_composite"] == before + 1
    op = cc.composite_results_compact_reference(*args, opt, basis_dim,
                                                fmt_sh)
    assert bool(torch.isfinite(ok).all())
    assert float((ok - op).abs().max()) <= 1e-6
    empty = args[4] == 0
    assert bool((ok[empty] == torch.tensor([0.0, 0, 0, 1],
                                           device=cuda)).all())


def test_guided_frame_on_card_matches_cpu(cuda):
    """The guided path (collect, reconstruct, query, composite) on the
    card against the plain path on the CPU, at 48x40."""
    frames, caches = [], []
    for dev in ("cpu", cuda):
        tree = P.sphere_tree(basis_dim=1, depth=5, device=dev)
        lm = P.build_leaf_map(tree)
        table = P.build_skip_table(tree, P.RenderOptions().sigma_thresh)
        model = P.MegaNeRFModel.synthetic(
            data_dim=4, n_clusters=4, grid_dim=(2, 2), need_viewdir=True,
            device=dev)
        opt = P.RenderOptions(max_guided_samples=16, need_viewdir=True)
        cam = P.Camera(48, 40, 30.0)
        cam.center = np.array([-1.5, 0.1, 1.4], np.float32)
        cam._update()
        cache = P.collect_and_query_fast(tree, lm, model, cam, opt,
                                         chunk_size=64, skip_table=table)
        caches.append(cache)
        frames.append(P.composite_frame(tree, cam, opt, cache).cpu())
    c, g = caches
    same = (c["num_samples"] == g["num_samples"].cpu())
    assert int((~same).sum()) <= 2
    err = float((frames[0] - frames[1]).reshape(-1, 4)[same].abs().max())
    assert err <= 1e-4


def test_stale_viewdir_frame_launches_kernel(cuda):
    """A frame after a rot_dirs change (stale cached view directions) and a
    frame from a cache without them both composite through kernel D, and
    agree with the plain path on the CPU."""
    frames = []
    for dev in ("cpu", cuda):
        tree = P.sphere_tree(basis_dim=4, depth=4, device=dev)
        model = P.MegaNeRFModel.synthetic(
            data_dim=13, n_clusters=4, grid_dim=(2, 2), need_viewdir=True,
            device=dev)
        opt = P.RenderOptions(max_guided_samples=16, need_viewdir=True)
        cam = P.Camera(48, 40, 30.0)
        cam.center = np.array([-1.5, 0.1, 1.4], np.float32)
        cam._update()
        cache = P.collect_and_query_fast(tree, P.build_leaf_map(tree), model,
                                         cam, opt, chunk_size=64)
        rot = opt.replace(rot_dirs=(0.35, -0.2, 0.1))
        before = kernels.LAUNCHES["compact_composite"]
        stale = P.composite_frame(tree, cam, rot, cache)
        no_vdirs = P.composite_frame(tree, cam, rot,
                                     dict(cache, vdirs_c=None))
        if dev == cuda:
            assert kernels.LAUNCHES["compact_composite"] == before + 2
        frames.append((stale.cpu(), no_vdirs.cpu(),
                       cache["num_samples"].cpu()))
    (sc, vc, nc), (sg, vg, ng) = frames
    assert torch.equal(sg, vg)
    same = nc == ng
    assert int((~same).sum()) <= 2
    assert float((sc - sg).reshape(-1, 4)[same].abs().max()) <= 1e-4


# ----------------------------------------------------------------------
# Refinement slice: kernels E (exact march), F (exact collect), G (padded
# compositor) and kernel A's votes and depth mode.  Integers (votes,
# visit marks, steps, sample counts, cluster ids) equal; floats within 1e-6.
# ----------------------------------------------------------------------
def _exact_scene(cuda, depth=5, basis_dim=4, fmt=None):
    tree = P.sphere_tree(basis_dim=basis_dim, depth=depth, device=cuda)
    cam = P.Camera(96, 80, 70.0)
    cam.center = np.array([-1.3, 0.2, 1.2], np.float32)
    cam._update()
    dirs, cen = screen2worlddir(
        96, 80, cam.fx, cam.fy, cam.cx, cam.cy,
        torch.as_tensor(cam.transform, device=cuda))
    return tree, cam, dirs, cen


@pytest.mark.parametrize("track_visit,depth_mode,max_iters", [
    (False, False, 0), (True, False, 0), (True, True, 0), (True, False, 7)])
def test_exact_march_kernel_matches_plain(cuda, track_visit, depth_mode,
                                          max_iters):
    from mega_nerf_viewer_tpu_torch.ops import render
    tree, _, dirs, cen = _exact_scene(cuda)
    opt = P.RenderOptions(render_depth=depth_mode)
    m = accel.march_inputs(tree, dirs, dirs, cen, opt)
    before = kernels.LAUNCHES["exact_march"]
    ok = kernels.exact_march(tree, m, opt, track_visit, 20, max_iters)
    assert kernels.LAUNCHES["exact_march"] == before + 1
    op = render.exact_march_reference(tree, m, opt, track_visit, 20,
                                      max_iters)
    assert float((ok[0] - op[0]).abs().max()) <= 1e-6
    for a, b in zip(ok[1:], op[1:]):
        assert torch.equal(a, b)
    if track_visit:
        assert int(ok[3].sum()) > 1


_EXACT_TREES = {}


def _exact_tree(cuda, name):
    """The exact kernels' trees beyond the depth-5 sphere: a depth-3 sphere
    refined twice by ``expand_voxels`` at the leaves its exact frame votes
    for (leaves of uneven depth), and N = 4 and N = 3 spheres (the restarted
    descent, and the descent from the root)."""
    if name not in _EXACT_TREES:
        if name == "uneven":
            tree = P.sphere_tree(basis_dim=1, depth=3, max_capacity=400,
                                 device=cuda)
            model = P.MegaNeRFModel.synthetic(
                device=cuda, data_dim=4, n_clusters=4, grid_dim=(2, 2),
                min_position=(-2, -2, -2), max_position=(2, 2, 2),
                need_viewdir=True)
            opt = P.RenderOptions(use_splitting=True, split_batch_size=24,
                                  need_viewdir=True)
            gen = torch.Generator(device=cuda).manual_seed(3)
            tracker = P.fresh_visit_tracker(tree)
            _, _, dirs, cen = _exact_scene(cuda)
            for _ in range(2):
                res = P.render_rays(tree, dirs, dirs, cen, opt)
                tree, tracker, added = P.expand_voxels(
                    tree, model, opt, res.split_vote, tracker, generator=gen)
                assert added > 0
        else:
            tree = P.sphere_tree(basis_dim=4, depth=3,
                                 N=4 if name == "n4" else 3, device=cuda)
        _EXACT_TREES[name] = tree
    return _EXACT_TREES[name]


@pytest.mark.parametrize("name", ["uneven", "n4", "n3"])
@pytest.mark.parametrize("max_levels", [20, 2])
@pytest.mark.parametrize("track_visit,depth_mode", [
    (False, False), (True, False), (True, True)])
def test_exact_march_kernel_trees_match_plain(cuda, name, max_levels,
                                              track_visit, depth_mode):
    """Kernel E on trees of uneven depth and of N = 4 (the restarted
    descent) and N = 3 (the descent from the root), with max_levels cut
    below the trees' depth: integers equal, rgba within 1e-6."""
    from mega_nerf_viewer_tpu_torch.ops import render
    tree = _exact_tree(cuda, name)
    _, _, dirs, cen = _exact_scene(cuda)
    opt = P.RenderOptions(render_depth=depth_mode)
    m = accel.march_inputs(tree, dirs, dirs, cen, opt)
    ok = kernels.exact_march(tree, m, opt, track_visit, max_levels, 0)
    op = render.exact_march_reference(tree, m, opt, track_visit, max_levels)
    assert float((ok[0] - op[0]).abs().max()) <= 1e-6
    for a, b in zip(ok[1:], op[1:]):
        assert torch.equal(a, b)
    assert int(ok[4].max()) > 1
    if track_visit:
        assert int(ok[3].sum()) > 1


@pytest.mark.parametrize("name", ["sphere", "uneven", "n4", "n3"])
@pytest.mark.parametrize("max_levels", [20, 2])
def test_exact_march_trajectories_equal_exact_collect(cuda, name,
                                                      max_levels):
    """Kernels E and F share the descent (csrc/descend_step.cuh): on the
    same rays their steps, split and sample votes and visit marks are
    equal."""
    from mega_nerf_viewer_tpu_torch.ops import guided
    tree = (_exact_scene(cuda)[0] if name == "sphere"
            else _exact_tree(cuda, name))
    _, _, dirs, cen = _exact_scene(cuda)
    opt = P.RenderOptions(max_guided_samples=16, need_viewdir=True)
    grid = (torch.tensor([2, 2], dtype=torch.int32, device=cuda),
            torch.full((3,), -1.0, device=cuda),
            torch.full((3,), 2.0, device=cuda))
    me = accel.march_inputs(tree, dirs, dirs, cen, opt)
    mf = guided.collect_inputs(tree, dirs, cen, opt)
    _, sv_e, pv_e, vis_e, steps_e = kernels.exact_march(
        tree, me, opt, True, max_levels, 0)
    _, _, ns, sv_f, pv_f, vis_f, steps_f = kernels.exact_collect(
        tree, mf, dirs, dirs, cen, grid, opt, True, max_levels)
    assert torch.equal(steps_e, steps_f)
    assert torch.equal(sv_e, sv_f) and torch.equal(pv_e, pv_f)
    assert torch.equal(vis_e, vis_f)
    assert int(steps_e.max()) > 1 and int(ns.sum()) > 0


@pytest.mark.parametrize("S", [16, 2])
def test_exact_collect_kernel_matches_plain(cuda, S):
    from mega_nerf_viewer_tpu_torch.ops import guided
    tree, _, dirs, cen = _exact_scene(cuda, basis_dim=1)
    opt = P.RenderOptions(max_guided_samples=S, need_viewdir=True)
    grid = (torch.tensor([2, 2], dtype=torch.int32, device=cuda),
            torch.full((3,), -1.0, device=cuda),
            torch.full((3,), 2.0, device=cuda))
    m = guided.collect_inputs(tree, dirs, cen, opt)
    before = kernels.LAUNCHES["exact_collect"]
    ok = kernels.exact_collect(tree, m, dirs, dirs, cen, grid, opt, True, 20)
    assert kernels.LAUNCHES["exact_collect"] == before + 1
    op = guided.exact_collect_reference(tree, m, dirs, dirs, cen, grid, opt,
                                        True, 20)
    assert float((ok[0] - op[0]).abs().max()) <= 1e-6
    for a, b in zip(ok[1:], op[1:]):
        assert torch.equal(a, b)
    assert int(ok[2].sum()) > 0


@pytest.mark.parametrize("S", [1, 7, 8, 9, 32, 33, 128])
@pytest.mark.parametrize("out_dim,basis_dim", [(4, 1), (5, 1), (28, 9)])
@pytest.mark.parametrize("mode", ["sh", "depth", "rgb"])
def test_padded_composite_kernel_matches_plain(cuda, S, out_dim, basis_dim,
                                               mode):
    """Kernel G against its plain version within 1e-6, on rays with 0 and
    with S valid slots and opaque samples."""
    from mega_nerf_viewer_tpu_torch.ops import padded_composite as pc
    rng = np.random.RandomState(S + out_dim)
    R = 3001
    sidx = min(3, out_dim - 1)
    ns = rng.randint(0, S + 1, R).astype(np.int32)
    ns[:50], ns[50:100] = 0, S
    res = rng.randn(R, S, out_dim).astype(np.float32)
    res[..., sidx] = np.abs(res[..., sidx]) * 3
    res[::7, 0, sidx] = 1e8                         # opaque first samples
    res[3::11, S // 2, sidx] = 1e8                  # and mid-ray ones
    z = np.sort(rng.rand(R, S).astype(np.float32) * 2, axis=1)
    vd = rng.randn(R, 3).astype(np.float32)
    vd /= np.linalg.norm(vd, axis=1, keepdims=True)
    args = [torch.as_tensor(a, device=cuda) for a in (res, z, ns, vd)]
    opt = P.RenderOptions(render_depth=mode == "depth", basis_minmax=(0, 24))
    fmt_sh = mode != "rgb"
    before = kernels.LAUNCHES["padded_composite"]
    ok = pc.composite_results_padded(*args, opt, basis_dim, fmt_sh)
    assert kernels.LAUNCHES["padded_composite"] == before + 1
    op = pc.composite_results_padded_reference(*args, opt, basis_dim, fmt_sh)
    assert bool(torch.isfinite(ok).all())
    assert float((ok - op).abs().max()) <= 1e-6
    assert bool((ok[:50] == torch.tensor([0.0, 0, 0, 1], device=cuda)).all())


@pytest.mark.parametrize("depth_mode", [False, True])
@pytest.mark.parametrize("max_dense", [16, 0])
def test_march_kernel_votes_and_depth(cuda, depth_mode, max_dense):
    """Kernel A with votes and depth mode against its plain version, and
    its votes against kernel E's on the same rays."""
    tree, _, dirs, cen = _exact_scene(cuda, depth=6)
    lm = P.build_leaf_map(tree)
    opt = P.RenderOptions(render_depth=depth_mode)
    m = accel.march_inputs(tree, dirs, dirs, cen, opt)
    args = (tree, lm, m.cen, m.d, m.invdir, m.delta_scale, m.tmin, m.tmax,
            m.miss, m.basis, m.step_size, m.sigma_thresh, m.stop_thresh,
            max_dense, m.use_sh)
    kw = dict(votes=(opt.max_depth, opt.max_sample_count),
              render_depth=depth_mode)
    ok = kernels.march(*args, **kw)
    op = accel.render_rays_fast_reference(*args, **kw)
    assert float((ok[0] - op[0]).abs().max()) <= 1e-6
    for a, b in zip(ok[1:], op[1:]):
        assert torch.equal(a, b)
    ex = kernels.exact_march(tree, m, opt, False, 20, 0)
    assert torch.equal(ok[4], ex[1]) and torch.equal(ok[5], ex[2])
    assert torch.equal(ok[2], ex[4])
    if max_dense:
        assert float((ok[0] - ex[0]).abs().max()) <= 1e-6


def test_refinement_on_card_matches_cpu(cuda):
    """Two expands, a resample, a visit-tracked exact frame and a prune
    on the card and on the CPU, from the same uniform draws."""
    from mega_nerf_viewer_tpu_torch.ops import refine
    out = []
    gen = torch.Generator().manual_seed(0)
    draws = [torch.rand((64 * 8, 8, 3), generator=gen) for _ in range(2)]
    draws.append(torch.rand((64, 8, 3), generator=gen))
    for dev in ("cpu", cuda):
        tree = P.sphere_tree(basis_dim=1, depth=3, max_capacity=400,
                             device=dev)
        model = P.MegaNeRFModel.synthetic(data_dim=4, n_clusters=4,
                                          need_viewdir=True, device=dev)
        opt = P.RenderOptions(use_splitting=True, split_batch_size=64,
                              need_viewdir=True)
        cam = P.Camera(32, 32, 30.0)
        cam.center = np.array([-1.5, 0.1, 1.4], np.float32)
        cam._update()
        tracker = P.fresh_visit_tracker(tree)
        args = (cam.width, cam.height, cam.fx, cam.fy, cam.cx, cam.cy,
                cam.transform, opt)
        for i in range(2):
            _, res = P.render_frame(tree, *args)
            k = len(refine.aggregate_split_votes(res.split_vote, 64))
            tree, tracker, n = P.expand_voxels(
                tree, model, opt, res.split_vote, tracker,
                rnd=draws[i][:k * 8].to(dev))
        _, res = P.render_frame(tree, *args)
        k = len(refine.aggregate_sample_votes(res.sample_vote, 64))
        tree = P.get_more_samples(tree, model, opt, res.sample_vote,
                                  rnd=draws[2][:k].to(dev))
        _, res = P.render_frame(tree, *args, track_visit=True)
        tracker = torch.maximum(tracker, res.visited)
        tree, tracker = P.prune_tree(tree, tracker)
        out.append((tree, tracker.cpu()))
    (tc, vc), (tg, vg) = out
    assert tc.capacity == tg.capacity
    for k in ("child", "parent", "sample_counts"):
        assert torch.equal(getattr(tc, k), getattr(tg, k).cpu())
    assert torch.equal(vc, vg)
    ulp = (tc.data.view(torch.int16).int()
           - tg.data.cpu().view(torch.int16).int()).abs()
    assert int(ulp.max()) <= 1


# ----------------------------------------------------------------------
# The Viewer slice: kernel H (the row-gather probe), kernel D's depth
# mode, and the Viewer's parked frame on the card.
# ----------------------------------------------------------------------
@pytest.mark.parametrize("W", [8, 128, 3])
def test_gather_probe_kernel_bit_equal(cuda, W):
    from mega_nerf_viewer_tpu_torch.probes import gather_probe as gp
    g = torch.Generator(device=cuda).manual_seed(W)
    M, N = 1 << 14, 1 << 15
    table = torch.randint(0, 1 << 20, (M, W), generator=g, device=cuda,
                          dtype=torch.int32)
    idx = torch.randint(0, M, (N,), generator=g, device=cuda,
                        dtype=torch.int32)
    before = kernels.LAUNCHES["gather_chunk_sums"]
    got = gp.gather_chunk_sums(table, idx)
    assert kernels.LAUNCHES["gather_chunk_sums"] == before + 1
    assert torch.equal(got, gp.gather_chunk_sums_reference(table, idx))
    assert torch.equal(got, gp.gather_chunk_sums_library(table, idx))


@pytest.mark.parametrize("basis_dim,fmt_sh", [(9, True), (1, False)])
def test_compact_composite_depth_matches_plain(cuda, basis_dim, fmt_sh):
    """Kernel D's depth branch against its plain version within 1e-6."""
    from mega_nerf_viewer_tpu_torch.ops import compact_composite as cc
    args = _compact_cache(cuda, basis_dim, opaque=True)
    opt = P.RenderOptions(render_depth=True)
    before = kernels.LAUNCHES["compact_composite_depth"]
    ok = cc.composite_results_compact_kernel(*args, opt, basis_dim, fmt_sh)
    assert kernels.LAUNCHES["compact_composite_depth"] == before + 1
    op = cc.composite_results_compact_reference(*args, opt, basis_dim,
                                                fmt_sh)
    assert bool(torch.isfinite(ok).all())
    assert float((ok - op).abs().max()) <= 1e-6
    assert float(ok[:, 0].max()) > 0


def test_viewer_parked_frame_matches_direct_frame(cuda):
    """A card Viewer's parked frames equal the direct segmented frame on
    the Viewer's own order and segments, and launch kernels A and B."""
    tree = P.sphere_tree(basis_dim=4, depth=5, device=cuda)
    cam = P.Camera(96, 80, 70.0)
    cam.center = np.array([-1.3, 0.2, 1.2], np.float32)
    v = P.Viewer(tree, camera=cam)
    v.fast_chunk_size = 512
    v.render()                                   # the hint frame
    kernels.reset_launch_counts()
    img = v.render(fetch=False)
    assert kernels.LAUNCHES["march"] > 0
    assert kernels.LAUNCHES["skip_prepass"] > 0
    direct = P.render_frame_fast_segmented(
        tree, v._leaf_map, cam, v.options, order=v._ray_order,
        segments=tuple(v._segments), chunk_size=512,
        skip_table=v._skip_table)[0]
    assert torch.equal(img, direct)
    assert v.get_backend() == "CUDA"


# ----------------------------------------------------------------------
# the moving camera: the gated march, the turbo map, no host syncs
# ----------------------------------------------------------------------
def _march_args(cuda, depth=5, level=None, max_dense=16, turbo=False):
    tree, lm, table, m = _scene(cuda, depth, level)
    if turbo:
        lm = P.build_turbo_leaf_map(tree, level=level)
    t0, _ = kernels.skip_prepass(table, m.cen, m.d, m.invdir, m.tmin,
                                 m.tmax, ~m.miss, m.step_size)
    m = m._replace(tmin=t0)
    return (tree, lm, m.cen, m.d, m.invdir, m.delta_scale, m.tmin, m.tmax,
            m.miss, m.basis, m.step_size, m.sigma_thresh, m.stop_thresh,
            max_dense, m.use_sh)


@pytest.mark.parametrize("votes", [None, (5, 256)])
def test_gated_march_closed_gate_writes_nothing(cuda, votes):
    """Gated with every count 0: the buffers keep their sentinel bytes,
    the overflow count is 0, and the launch counts as march_gated."""
    args = _march_args(cuda)
    R = args[3].shape[0]
    into = (torch.full((R, 4), -7.0, device=cuda),
            torch.full((R,), -7, dtype=torch.int32, device=cuda),
            torch.full((R,), -7, dtype=torch.int32, device=cuda))
    if votes is not None:
        into += (torch.full((R, 3), -7.0, device=cuda),
                 torch.full((R, 3), -7.0, device=cuda))
    before = dict(kernels.LAUNCHES)
    res = kernels.march(*args, votes=votes,
                        gate=torch.zeros(5, dtype=torch.int32, device=cuda),
                        into=into)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["march_gated"] == before["march_gated"] + 1
    assert kernels.LAUNCHES["march"] == before["march"]
    assert int(res[1]) == 0
    for buf in into:
        assert bool((buf == -7).all())


@pytest.mark.parametrize("votes", [None, (5, 256)])
@pytest.mark.parametrize("max_dense", [128, 2])
def test_gated_march_open_gate_matches(cuda, votes, max_dense):
    """Gated with a count not 0: bit-equal to the ungated launch, and
    integers equal and rgba within 1e-6 of the plain version."""
    args = _march_args(cuda, max_dense=max_dense)
    R = args[3].shape[0]
    ref = kernels.march(*args, votes=votes)
    into = (torch.full((R, 4), -7.0, device=cuda),
            torch.full((R,), -7, dtype=torch.int32, device=cuda),
            torch.full((R,), -7, dtype=torch.int32, device=cuda))
    if votes is not None:
        into += (torch.full((R, 3), -7.0, device=cuda),
                 torch.full((R, 3), -7.0, device=cuda))
    gate = torch.tensor([0, 0, 3, 0], dtype=torch.int32, device=cuda)
    res = kernels.march(*args, votes=votes, gate=gate, into=into)
    torch.cuda.synchronize()
    assert all(a is b for a, b in zip(res[:1] + res[2:], into))
    for a, b in zip(res, ref):
        assert torch.equal(a, b)
    plain = accel.render_rays_fast_reference(*args, votes=votes)
    assert float((res[0] - plain[0]).abs().max()) <= 1e-6
    assert int(res[1]) == int(plain[1])
    for a, b in zip(res[2:], plain[2:]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("depth,level", [(5, None), (7, 4)])
def test_turbo_map_march_matches_plain(cuda, depth, level):
    """Kernel A reads each cell's depth from the row's meta, so a turbo
    map needs no change: integers equal, rgba within 1e-6, fewer steps."""
    args = _march_args(cuda, depth, level, turbo=True)
    ok = kernels.march(*args)
    op = accel.render_rays_fast_reference(*args)
    assert float((ok[0] - op[0]).abs().max()) <= 1e-6
    assert int(ok[1]) == int(op[1])
    assert torch.equal(ok[2], op[2]) and torch.equal(ok[3], op[3])
    plain = kernels.march(*_march_args(cuda, depth, level))
    assert int(ok[2].sum()) <= int(plain[2].sum())


def _motion_scene(dev):
    tree = P.sphere_tree(basis_dim=4, depth=5, device=dev)
    lm = P.build_leaf_map(tree)
    table = P.build_skip_table(tree, P.RenderOptions().sigma_thresh)
    cam = P.Camera(96, 80, 70.0)
    cam.center = np.array([-1.3, 0.2, 1.2], np.float32)
    cam._update()
    opt = P.RenderOptions()
    img, ov, steps, nrec, skips = P.render_frame_fast(
        tree, lm, cam, opt, max_dense=64, chunk_size=512, return_nrec=True,
        skip_table=table, return_skips=True)
    ph = accel.pack_hints(steps, nrec, skips)
    return tree, lm, table, cam, opt, ph


def test_device_fallback_frame_has_no_host_sync(cuda):
    """The device-fallback frame on starved budgets raises nothing under
    sync debug mode "error", takes the fallback on the card, one gated
    launch a non-empty segment, and equals the frame on budgets that
    fit."""
    tree, lm, table, cam, opt, ph = _motion_scene(cuda)
    order = accel.order_from_packed_device(ph)
    fit = P.render_frame_fast_segmented(
        tree, lm, cam, opt, order=order, segments=((1.0, 64),),
        chunk_size=512, skip_table=table)[0]
    torch.cuda.synchronize()
    before = kernels.LAUNCHES["march_gated"]
    torch.cuda.set_sync_debug_mode("error")
    try:
        img, seg_ov, fb = P.render_frame_fast_segmented(
            tree, lm, cam, opt, order=order,
            segments=((0.75, 0), (0.25, 1)), chunk_size=512,
            skip_table=table, device_fallback=True)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    # one gated launch a non-empty segment, each gated on its own count
    n_chunks = -(-96 * 80 // 512)
    assert kernels.LAUNCHES["march_gated"] == before + sum(
        1 for c, _ in accel.segment_chunks(
            n_chunks, ((0.75, 0), (0.25, 1)), n_rays=96 * 80,
            chunk_size=512) if c)
    assert bool(seg_ov.any()) and int(fb) == 0
    assert torch.equal(img, fit)


def test_motion_frame_has_no_host_sync(cuda):
    """render_frame_motion at stride 2 raises nothing under sync debug
    mode "error" and returns a permutation and a quarter order."""
    tree, lm, table, cam, opt, ph = _motion_scene(cuda)
    qperm = P.quarter_order_from_packed(ph, width=96)
    cam.begin_drag(0.0, 0.0, False, True)
    cam.drag_update(-2.0, 0.0)
    cam.end_drag()
    cam._update()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = P.render_frame_motion(tree, lm, cam, opt, qperm,
                                    chunk_size=512, skip_table=table,
                                    hint_stride=2)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    img, ov, (perm, inv), cdf, q = out
    assert bool(torch.isfinite(img).all())
    assert torch.equal(perm[inv], torch.arange(96 * 80, device=cuda))
    assert q.shape[0] * 4 == 96 * 80


def _orbit(cam):
    cam.begin_drag(0.0, 0.0, False, True)
    cam.drag_update(-2.0, 0.0)
    cam.end_drag()
    cam._update()


@pytest.mark.parametrize("stride", [1, 2])
def test_motion_frame_on_card_matches_cpu(cuda, stride):
    """The re-hint frame on the card against its plain version on the CPU:
    hints, perm, inv, cdf, qperm and overflow counts equal, pixels within
    1e-5."""
    outs = []
    for dev in ("cpu", cuda):
        tree, lm, table, cam, opt, ph = _motion_scene(dev)
        stale = (P.quarter_order_from_packed(ph, width=96) if stride == 2
                 else accel.order_from_packed_device(ph)[0])
        _orbit(cam)
        img, ov, (perm, inv), cdf, q = P.render_frame_motion(
            tree, lm, cam, opt, stale, chunk_size=512, skip_table=table,
            hint_stride=stride)
        outs.append([t.cpu() for t in (ph, img, ov, perm, inv, cdf)]
                    + [None if q is None else q.cpu()])
    (phc, imc, *ic), (phg, img_, *ig) = outs
    assert torch.equal(phc, phg)
    for a, b in zip(ic, ig):
        assert (a is None) == (b is None)
        if a is not None:
            assert torch.equal(a, b)
    assert float((imc - img_).abs().max()) <= 1e-5


# ----------------------------------------------------------------------
# The model slice: kernel I, the fused per-cluster product.
# ----------------------------------------------------------------------
def _gemm_case(cuda, case):
    """(a, w, b, cids, relu, keywords) at the kernel's edges: rows not a
    multiple of its 128-row tile, K of 75 and its tail, a source shared by
    every group beside a second one (the skip), the appearance table with
    ids out of range, the narrow heads into a column window, one group of
    five rows, and a cluster id per group with a repeat."""
    g = torch.Generator(device=cuda).manual_seed(len(case))

    def r(*shape):
        return torch.randn(*shape, generator=g, device=cuda)
    C, n = 4, 300
    cids = torch.tensor([2, 0, 2], device=cuda)
    kw = {}
    if case == "trunk0_ragged":
        a, w, b = r(3, n, 75), r(C, 75, 256), r(C, 256)
    elif case == "skip_shared":
        a, w, b = r(1, n, 75), r(C, 331, 256), r(C, 256)
        kw["a2"] = r(3, n, 256).relu()
    elif case == "appearance_clamped":
        a, w, b = r(3, n, 256), r(C, 304, 128), r(C, 128)
        kw["table"] = r(C, 40, 48)
        ids = torch.randint(-5, 45, (3, n, 2), generator=g,
                            device=cuda).float()
        kw["ids"] = ids[..., 1]
    elif case in ("rgb_window", "sigma_window"):
        N, col = (12, 0) if case == "rgb_window" else (1, 12)
        a, w, b = r(3, n, 128), r(C, 128, N), r(C, N)
        kw["out"], kw["col"] = torch.full((3, n, 13), 7.0, device=cuda), col
    else:                                   # one_group
        cids = torch.tensor([3], device=cuda)
        a, w, b = r(1, 5, 256), r(C, 256, 256), r(C, 256)
    return a, w, b, cids, case != "rgb_window", kw


@pytest.mark.parametrize("case", ["trunk0_ragged", "skip_shared",
                                  "appearance_clamped", "rgb_window",
                                  "sigma_window", "one_group"])
def test_mlp_gemm_kernel_matches_plain(cuda, case):
    from mega_nerf_viewer_tpu_torch.models import meganerf as PM
    a, w, b, cids, relu, kw = _gemm_case(cuda, case)
    kw_p = dict(kw, out=kw["out"].clone()) if "out" in kw else kw
    before = kernels.LAUNCHES["mlp_gemm"]
    got = PM.mlp_gemm(a, w, b, cids, relu, **kw)
    assert kernels.LAUNCHES["mlp_gemm"] == before + 1
    want = PM.mlp_gemm_reference(a, w, b, cids, relu, **kw_p)
    scale = max(1.0, float(want.abs().max()))
    assert float((got - want).abs().max()) <= 2e-5 * scale
    if "out" in kw:                 # columns outside the window untouched
        keep = torch.ones(13, dtype=torch.bool)
        keep[kw["col"]:kw["col"] + w.shape[2]] = False
        assert bool((got[..., keep] == 7.0).all())


@pytest.mark.parametrize("kind", ["nerf", "mlp"])
def test_nerf_forward_on_card_matches_cpu(cuda, kind):
    """The model's forward at Mill 19's widths through kernel I on the card
    against its plain version on the CPU, for both parameter kinds (a
    ``NeRF`` and a Linear/ReLU stack with a skip): every column of both
    routes of ``query_grouped`` (the chunked one with a small chunk).  The
    card launches kernel I once a layer on each route, and ``mlp_rows``
    is the CPU's."""
    from torch.profiler import ProfilerActivity, profile
    from mega_nerf_viewer_tpu_torch.models import meganerf as PM
    from mega_nerf_viewer_tpu_torch.utils import profiling
    rng = np.random.default_rng(9)
    C, enc, W = 8, 75, 256

    def layer(i, o):
        return (rng.standard_normal((C, i, o)) * np.sqrt(2 / i),
                rng.standard_normal((C, o)) * 0.1)
    if kind == "nerf":
        trunk = [layer(enc if l == 0 else W + (enc if l == 4 else 0), W)
                 for l in range(8)]
        arrays = {"freq_bands": 2.0 ** np.arange(12), "appearance":
                  rng.standard_normal((C, 30, 48)),
                  "trunk_w": [t[0] for t in trunk],
                  "trunk_b": [t[1] for t in trunk]}
        for k, (i, o) in {"sigma": (W, 1), "final": (W, W),
                          "dir_a": (W + 48, 128), "rgb": (128, 12)}.items():
            arrays[f"{k}_w"], arrays[f"{k}_b"] = layer(i, o)

        def make(dev):
            return PM.nerf_params_from_numpy(arrays, (4,), device=dev)
        per_forward = 8 + 4
    else:
        stack = [layer(4 if l == 0 else W + (4 if l == 4 else 0),
                       13 if l == 7 else W) for l in range(8)]

        def make(dev):
            return PM.params_from_numpy([s[0] for s in stack],
                                        [s[1] for s in stack], (4,),
                                        device=dev)
        per_forward = 8
    x = np.concatenate([rng.uniform(-1, 1, (700, 3)),
                        rng.integers(-2, 33, (700, 1))], 1).astype(np.float32)
    ids = rng.integers(0, C, 700)
    outs, counts, launches = [], [], []
    for dev in ("cpu", cuda):
        params = make(dev)
        xt, it = torch.from_numpy(x).to(dev), torch.from_numpy(ids).to(dev)
        before = kernels.LAUNCHES["mlp_gemm"]
        profiling.reset()
        with profile(activities=[ProfilerActivity.CPU]):
            outs.append([PM.mlp_forward_all(params, it, xt).cpu(),
                         PM._query_chunked(params, it, xt, 128).cpu()])
        counts.append(profiling.recorded()[1])
        profiling.reset()
        launches.append(kernels.LAUNCHES["mlp_gemm"] - before)
    assert launches == [0, 2 * per_forward]
    assert counts[1]["mlp_rows"] == counts[0]["mlp_rows"] > 700
    for a, b in zip(*outs):
        assert float((a - b).abs().max()) <= 2e-5 * max(1.0, float(
            a.abs().max()))
