"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test here needs a CUDA device and skips without one.

Tolerances: the prepass and the collect march are bit-equal (t compared
as int32, integers equal); the march's integers are equal and its rgba
within 1e-6 (the kernel sums shaded samples in order, the plain version
reduces the record buffer; both round each op alike); the compact
compositor within 1e-6 (a running product along the ray against a
cumprod and a masked sum).
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


@pytest.mark.parametrize("depth", [4, 7])
def test_prepass_kernel_bit_equal(cuda, depth):
    _, _, table, m = _scene(cuda, depth)
    args = (table, m.cen, m.d, m.invdir, m.tmin, m.tmax, ~m.miss,
            m.step_size)
    before = kernels.LAUNCHES["skip_prepass"]
    tk, sk = kernels.skip_prepass(*args)
    assert kernels.LAUNCHES["skip_prepass"] == before + 1
    tp, sp_ = sp.entry_skip_prepass_reference(*args)
    assert torch.equal(tk.view(torch.int32), tp.view(torch.int32))
    assert torch.equal(sk, sp_)
    assert int(sk.sum()) > 0


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


@pytest.mark.parametrize("basis_dim,fmt_sh,depth_mode", [
    (1, True, False), (9, True, False), (9, True, True), (1, False, False)])
def test_padded_composite_kernel_matches_plain(cuda, basis_dim, fmt_sh,
                                               depth_mode):
    from mega_nerf_viewer_tpu_torch.ops import padded_composite as pc
    rng = np.random.RandomState(basis_dim)
    R, S, out_dim = 3001, 32, 3 * basis_dim + 2
    ns = rng.randint(0, S + 1, R).astype(np.int32)
    res = rng.randn(R, S, out_dim).astype(np.float32)
    res[..., min(3, out_dim - 1)] = np.abs(res[..., min(3, out_dim - 1)]) * 3
    res[::7, 0, min(3, out_dim - 1)] = 1e8          # opaque first samples
    z = np.sort(rng.rand(R, S).astype(np.float32) * 2, axis=1)
    vd = rng.randn(R, 3).astype(np.float32)
    vd /= np.linalg.norm(vd, axis=1, keepdims=True)
    args = [torch.as_tensor(a, device=cuda) for a in (res, z, ns, vd)]
    opt = P.RenderOptions(render_depth=depth_mode, basis_minmax=(0, 24))
    before = kernels.LAUNCHES["padded_composite"]
    ok = pc.composite_results_padded(*args, opt, basis_dim, fmt_sh)
    assert kernels.LAUNCHES["padded_composite"] == before + 1
    op = pc.composite_results_padded_reference(*args, opt, basis_dim, fmt_sh)
    assert bool(torch.isfinite(ok).all())
    assert float((ok - op).abs().max()) <= 1e-6


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
