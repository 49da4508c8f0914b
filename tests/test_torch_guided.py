"""The guided-sampling slice end to end against the JAX package, on
``sphere_tree(basis_dim=1, depth=4)``, a 4-cluster synthetic Mega-NeRF
model (hidden 32) and a 24x18 camera: the compact reconstruction, the
unordered, ordered and segmented ``collect_and_query_fast``, and
``composite_frame`` on both of its routes.

Tolerances, with their reasons:
  * ``ray_of_p``, ``offs``, sample counts: equal;
  * reconstructed x and z: rtol 1e-6 (atol 1e-6 for coordinates near 0).
    XLA lowers ``d / |d|`` to an approximate rsqrt (one ulp off on some
    rays, see ``test_torch_collect.py``) and so moves z by an ulp or two;
  * cluster ids: equal except where such an ulp moves a sample across a
    cell edge, at most 0.01% of the samples;
  * MLP results: 1e-5 on samples whose cluster ids agree (f32 products
    summed in another order, on inputs an ulp apart);
  * pixels: 1e-5 (the limit is 1e-4); the test prints the measured value.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import mega_nerf_viewer_tpu.n3tree as J
import mega_nerf_viewer_tpu_torch as P
from mega_nerf_viewer_tpu.camera import Camera
from mega_nerf_viewer_tpu.models import MegaNeRFModel
from mega_nerf_viewer_tpu.options import RenderOptions
from mega_nerf_viewer_tpu.ops import accel as JA
from mega_nerf_viewer_tpu.ops import guided as JG
from mega_nerf_viewer_tpu.ops import pallas_march as JM
from mega_nerf_viewer_tpu.ops.rays import rodrigues, screen2worlddir
from mega_nerf_viewer_tpu_torch.ops import accel as PA
from mega_nerf_viewer_tpu_torch.ops import guided as PG

ARRAYS = ("data", "child", "parent", "sample_counts", "scale", "offset")
S = 16
CS = 64
RES_TOL = 1e-5
PIX_TOL = 1e-5
MODEL = dict(data_dim=4, n_clusters=4, grid_dim=(2, 2),
             min_position=(-1, -1, -1), max_position=(1, 1, 1),
             need_viewdir=True)


def _camera(cls):
    cam = cls(24, 18, 20.0)
    cam.center = np.array([-1.5, 0.1, 1.4], np.float32)
    cam._update()
    return cam


@pytest.fixture(scope="module")
def scene():
    jt = J.sphere_tree(basis_dim=1, depth=4)
    pt = P.tree_from_numpy(
        **{k: np.asarray(getattr(jt, k)) for k in ARRAYS},
        capacity=int(jt.capacity), data_format=jt.data_format, device="cpu")
    opt = RenderOptions(max_guided_samples=S, need_viewdir=True)
    return dict(
        jt=jt, pt=pt, jlm=JA.build_leaf_map(jt), plm=PA.build_leaf_map(pt),
        jtab=JM.build_skip_table(jt, opt.sigma_thresh),
        ptab=P.build_skip_table(pt, opt.sigma_thresh),
        jm=MegaNeRFModel.synthetic(**MODEL),
        pm=P.MegaNeRFModel.synthetic(device="cpu", **MODEL),
        opt=opt, popt=P.RenderOptions(max_guided_samples=S,
                                      need_viewdir=True),
        jcam=_camera(Camera), pcam=_camera(P.Camera))


@pytest.fixture(scope="module")
def unordered(scene):
    s = scene
    j = JG.collect_and_query_fast(s["jt"], s["jlm"], s["jm"], s["jcam"],
                                  s["opt"], chunk_size=CS,
                                  skip_table=s["jtab"])
    p = PG.collect_and_query_fast(s["pt"], s["plm"], s["pm"], s["pcam"],
                                  s["popt"], chunk_size=CS,
                                  skip_table=s["ptab"])
    return j, p


def _pixel_rows(cache, total):
    """Compact (z, results) rows in pixel-ray order, whatever the
    cache's ray order (``test_guided.py:273``)."""
    a = {k: (v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
         for k, v in cache.items() if k in ("z_c", "results_c", "ray_of_p",
                                            "order_perm")}
    z, res = a["z_c"][:total], a["results_c"][:total]
    if "order_perm" in a:
        pix = a["order_perm"][a["ray_of_p"][:total]]
        o = np.argsort(pix, kind="stable")
        z, res = z[o], res[o]
    return z, res


def _per_ray_route(tree, cam, opt, cache):
    """``composite_frame``'s per-ray route, whatever the cache holds."""
    return PG._composite_frame_compact(
        cache["results_c"], cache["z_c"], cache["ray_of_p"], cache["offs"],
        cache.get("num_samples_sorted", cache["num_samples"]), cam, opt,
        tree.data_format.basis_dim, tree.data_format.format == "SH",
        perm=cache.get("order_perm"), inv=cache.get("order_inv"))


def _compare_caches(j, p):
    ns = np.asarray(j["num_samples"])
    np.testing.assert_array_equal(p["num_samples"].numpy(), ns)
    np.testing.assert_array_equal(p["collect_steps"].numpy(),
                                  np.asarray(j["collect_steps"]))
    total = int(ns.sum())
    assert total > 0
    zj, rj = _pixel_rows(j, total)
    zp, rp = _pixel_rows(p, total)
    np.testing.assert_allclose(zp, zj, rtol=1e-6)
    bad = np.nonzero((np.abs(rp - rj) > RES_TOL).any(1))[0]
    print(f"results: max abs diff {np.abs(rp - rj).max():.3e}, "
          f"{len(bad)} of {total} samples beyond {RES_TOL}")
    assert len(bad) <= 1e-4 * total
    assert p["budget_hint_next"] == j["budget_hint_next"]
    assert p["results_c"].shape == tuple(j["results_c"].shape)
    return total


@pytest.mark.parametrize("viewdir,app", [(True, -1), (False, 3)])
def test_compact_reconstruct_matches_jax(scene, viewdir, app):
    """Both sides rebuild the samples from JAX's own records."""
    s = scene
    jopt = s["opt"].replace(need_viewdir=viewdir, appearance_embedding=app)
    popt = s["popt"].replace(need_viewdir=viewdir, appearance_embedding=app)
    cam = s["jcam"]
    dirs, cen = screen2worlddir(cam.width, cam.height, cam.fx, cam.fy,
                                cam.cx, cam.cy, jnp.asarray(cam.transform))
    vdirs = rodrigues(jnp.asarray((0.2, -0.1, 0.3), jnp.float32), dirs)
    t_buf, ns = JG.collect_t_fast(s["jt"], s["jlm"], dirs, cen, jopt)
    m = s["jm"]
    budget = 1024
    want = JG._compact_reconstruct(
        s["jt"], dirs, vdirs, cen, t_buf, ns, jnp.asarray(m.grid_dim),
        jnp.asarray(m.min_position), jnp.asarray(m.range), jopt, budget)
    got = PG._compact_reconstruct(
        s["pt"], *(torch.tensor(np.asarray(a)) for a in
                   (dirs, vdirs, cen, t_buf, ns)),
        m.grid_dim, m.min_position, m.range, popt, budget)
    x_j, cid_j, z_j, rop_j, offs_j = (np.asarray(a) for a in want)
    x_p, cid_p, z_p, rop_p, offs_p = (a.numpy() for a in got)
    np.testing.assert_array_equal(rop_p, rop_j)
    np.testing.assert_array_equal(offs_p, offs_j)
    assert rop_p.dtype == offs_p.dtype == cid_p.dtype == np.int32
    total = int(offs_j[-1])
    assert 0 < total < budget
    n_cid = int((cid_p != cid_j).sum())
    print(f"cluster ids: {n_cid} of {total} samples differ")
    assert n_cid <= 1e-4 * total
    assert len(np.unique(cid_p[:total])) > 1
    np.testing.assert_allclose(z_p, z_j, rtol=1e-6)
    np.testing.assert_allclose(x_p, x_j, rtol=1e-6, atol=1e-6)
    assert x_p.shape == (budget, 3 + 3 * viewdir + (app != -1))
    assert (x_p[total:] == 0).all() and (z_p[total:] == 0).all()


def test_reconstruct_start_at_budget_is_dropped():
    """A ray's start offset equal to the budget is dropped (JAX's scatter
    drops it; ``index_add_`` would raise), not wrapped."""
    jt = J.sphere_tree(basis_dim=1, depth=2)
    pt = P.tree_from_numpy(
        **{k: np.asarray(getattr(jt, k)) for k in ARRAYS},
        capacity=int(jt.capacity), data_format=jt.data_format, device="cpu")
    R, Sb, budget = 6, 4, 8
    rng = np.random.RandomState(0)
    dirs = rng.randn(R, 3).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    ns = np.array([4, 4, 0, 0, 0, 0], np.int32)     # offs[1:] == budget
    t_buf = np.where(np.arange(Sb)[None] < ns[:, None],
                     rng.rand(R, Sb), -1).astype(np.float32)
    cen = np.zeros(3, np.float32)
    opt = RenderOptions()
    want = JG._compact_reconstruct(
        jt, jnp.asarray(dirs), jnp.asarray(dirs), jnp.asarray(cen),
        jnp.asarray(t_buf), jnp.asarray(ns), jnp.asarray([2, 2]),
        jnp.asarray([-1.0, -1, -1]), jnp.asarray([2.0, 2, 2]), opt, budget)
    got = PG._compact_reconstruct(
        pt, torch.tensor(dirs), torch.tensor(dirs), torch.tensor(cen),
        torch.tensor(t_buf), torch.tensor(ns), (2, 2), (-1.0, -1, -1),
        (2.0, 2, 2), P.RenderOptions(), budget)
    for a, b in zip(want, got):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6,
                                   atol=1e-6)
    np.testing.assert_array_equal(got[3].numpy(), [0, 0, 0, 0, 1, 1, 1, 1])


def test_collect_and_query_unordered(scene, unordered):
    j, p = unordered
    _compare_caches(j, p)
    assert set(p) == set(j)
    assert p["vdirs_sig"] == j["vdirs_sig"]
    np.testing.assert_array_equal(p["ray_of_p"].numpy(),
                                  np.asarray(j["ray_of_p"]))
    np.testing.assert_allclose(p["vdirs_c"].numpy(), np.asarray(j["vdirs_c"]),
                               rtol=1e-6, atol=1e-7)


def test_composite_frame_matches_jax(scene, unordered):
    """Both routes of ``composite_frame``: the compact compositor with the
    cached per-sample view directions, and the per-ray route, which
    gathers this frame's directions per sample."""
    s = scene
    j, p = unordered
    for route, ip in (("compact compositor", PG.composite_frame(
            s["pt"], s["pcam"], s["popt"], p)),
                      ("per-ray", _per_ray_route(s["pt"], s["pcam"],
                                                 s["popt"], p))):
        ij = np.asarray(JG.composite_frame(s["jt"], s["jcam"], s["opt"], j,
                                           use_pallas=route != "per-ray"))
        ip = ip.numpy()
        err = float(np.abs(ip - ij).max())
        print(f"pixels ({route} route): max abs diff {err:.3e}")
        assert ip.shape == (18, 24, 4) and err <= PIX_TOL
        assert (ip[..., 3] == 1).all() and ip[..., :3].max() > 0.1


def test_ordered_collect_identical(scene, unordered):
    """A cost-sorted order changes nothing but speed; the sorted-order
    cache composites to the unordered frame (``test_guided.py:288``)."""
    s = scene
    j0, p0 = unordered
    R = 24 * 18
    order = PA.order_from_hints(p0["collect_steps"], p0["num_samples"])
    p = PG.collect_and_query_fast(s["pt"], s["plm"], s["pm"], s["pcam"],
                                  s["popt"], chunk_size=CS,
                                  skip_table=s["ptab"], order=order)
    jorder = JA.order_from_hints(np.asarray(j0["collect_steps"]),
                                 np.asarray(j0["num_samples"]))
    np.testing.assert_array_equal(order[0].numpy(), np.asarray(jorder[0]))
    j = JG.collect_and_query_fast(s["jt"], s["jlm"], s["jm"], s["jcam"],
                                  s["opt"], chunk_size=CS,
                                  skip_table=s["jtab"], order=jorder)
    total = _compare_caches(j, p)
    assert set(p) == set(j)
    np.testing.assert_array_equal(p["num_samples_sorted"].numpy(),
                                  np.asarray(j["num_samples_sorted"]))
    np.testing.assert_array_equal(p["order_inv"].numpy(),
                                  np.asarray(j["order_inv"]))
    for a, b in zip(_pixel_rows(p, total), _pixel_rows(p0, total)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
    base = PG.composite_frame(s["pt"], s["pcam"], s["popt"], p0)
    for img in (PG.composite_frame(s["pt"], s["pcam"], s["popt"], p),
                _per_ray_route(s["pt"], s["pcam"], s["popt"], p)):
        assert float((img - base).abs().max()) <= 1e-6
    assert p["order_perm"].shape == (R,)


def test_segmented_collect_and_speculation(scene, unordered):
    """The segmented invalidation settles to the unordered records, from
    fresh hints and from stale ones (escalation); a budget hint that fits
    is used, one that does not is redone (``test_guided.py:323``,
    ``:370``).  The class flags themselves are held against JAX in
    ``test_torch_collect.py``."""
    s = scene
    _, p0 = unordered
    ns = p0["num_samples"].numpy()
    total = int(ns.sum())
    R = ns.shape[0]
    zeros = torch.zeros(R, dtype=torch.int32)
    fresh = PA.order_from_hints(zeros, p0["num_samples"])
    stale = PA.order_from_hints(zeros, zeros)
    segs = PG.segments_from_ns_hints(ns, S)
    assert segs == JG.segments_from_ns_hints(ns, S)
    hint_ok = p0["budget_hint_next"]
    base = _pixel_rows(p0, total)
    for o, sg, hint in ((fresh, segs, None), (fresh, segs, hint_ok),
                        (fresh, segs, 1),
                        (stale, ((0.5, 0), (0.4, 1), (0.1, S)), hint_ok)):
        p = PG.collect_and_query_fast(s["pt"], s["plm"], s["pm"], s["pcam"],
                                      s["popt"], chunk_size=CS,
                                      skip_table=s["ptab"], order=o,
                                      segments=sg, budget_hint=hint)
        np.testing.assert_array_equal(p["num_samples"].numpy(), ns)
        for a, b in zip(_pixel_rows(p, total), base):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
        assert len(p["segments"]) == len(sg)
        if sg is segs:
            assert p["segments"] == segs       # fresh hints never escalate
        else:
            assert p["segments"] != sg
        used_hint = hint is not None and hint >= total
        assert p["results_c"].shape[0] == (1 << 17 if used_hint
                                           else 1 << 16)
        assert p["budget_hint_next"] == p0["budget_hint_next"]


def test_composite_route_gate_on_viewdir_change():
    """Once rot_dirs moves after the collect, the cached per-sample view
    directions are stale: the frame takes the per-ray route, which shades
    with the current directions (``test_guided.py:418``; SH4, so the view
    direction shows)."""
    jt = J.sphere_tree(basis_dim=4, depth=3)
    pt = P.tree_from_numpy(
        **{k: np.asarray(getattr(jt, k)) for k in ARRAYS},
        capacity=int(jt.capacity), data_format=jt.data_format, device="cpu")
    kw = dict(MODEL, data_dim=13)
    jm = MegaNeRFModel.synthetic(**kw)
    pm = P.MegaNeRFModel.synthetic(device="cpu", **kw)
    opt = RenderOptions(max_guided_samples=S, need_viewdir=True)
    popt = P.RenderOptions(max_guided_samples=S, need_viewdir=True)
    cams = []
    for cls in (Camera, P.Camera):
        cam = cls(12, 10, 14.0)
        cam.center = np.array([-1.5, 0.1, 1.4], np.float32)
        cam._update()
        cams.append(cam)
    j = JG.collect_and_query_fast(jt, JA.build_leaf_map(jt), jm, cams[0],
                                  opt, chunk_size=0)
    p = PG.collect_and_query_fast(pt, PA.build_leaf_map(pt), pm, cams[1],
                                  popt, chunk_size=0)
    base = PG.composite_frame(pt, cams[1], popt, p)
    rot = (0.35, -0.2, 0.1)
    auto = PG.composite_frame(pt, cams[1], popt.replace(rot_dirs=rot), p)
    plain = _per_ray_route(pt, cams[1], popt.replace(rot_dirs=rot), p)
    assert torch.equal(auto, plain)
    assert not torch.equal(auto, base)
    for img, o in ((base, opt), (auto, opt.replace(rot_dirs=rot))):
        want = np.asarray(JG.composite_frame(jt, cams[0], o, j))
        err = float(np.abs(img.numpy() - want).max())
        print(f"SH4 pixels: max abs diff {err:.3e}")
        assert err <= PIX_TOL


def test_composite_frame_not_ported_yet(scene, unordered):
    """Both caches in depth mode, which raised before: the compact cache
    (unordered and in sorted order) goes to the compact compositor's depth
    branch and matches JAX's ``composite_frame`` within 1e-5; the padded
    cache goes to the padded compositor and matches JAX's frame on JAX's
    own cache."""
    s = scene
    j, p = unordered
    depth_j, depth_p = (o.replace(render_depth=True)
                        for o in (s["opt"], s["popt"]))
    caches = [(j, p)]
    order = PA.order_from_hints(p["collect_steps"], p["num_samples"])
    jorder = JA.order_from_hints(np.asarray(j["collect_steps"]),
                                 np.asarray(j["num_samples"]))
    caches.append((
        JG.collect_and_query_fast(s["jt"], s["jlm"], s["jm"], s["jcam"],
                                  s["opt"], chunk_size=CS,
                                  skip_table=s["jtab"], order=jorder),
        PG.collect_and_query_fast(s["pt"], s["plm"], s["pm"], s["pcam"],
                                  s["popt"], chunk_size=CS,
                                  skip_table=s["ptab"], order=order)))
    for jc_, pc_ in caches:
        want = np.asarray(JG.composite_frame(s["jt"], s["jcam"], depth_j,
                                             jc_))
        got = PG.composite_frame(s["pt"], s["pcam"], depth_p, pc_)
        err = float(np.abs(got.numpy() - want).max())
        print(f"compact depth frame: max abs diff {err:.3e}")
        assert err <= PIX_TOL
        assert float(want[..., 0].max()) > 0 and (want[..., 3] == 1).all()
    jc, _ = JG.collect_and_query(s["jt"], s["jm"], s["jcam"], s["opt"])
    padded = {k: torch.tensor(np.asarray(v)) for k, v in jc.items()}
    for depth in (False, True):
        want = np.asarray(JG.composite_frame(
            s["jt"], s["jcam"], s["opt"].replace(render_depth=depth), jc))
        got = PG.composite_frame(s["pt"], s["pcam"],
                                 s["popt"].replace(render_depth=depth),
                                 padded)
        err = float(np.abs(got.numpy() - want).max())
        print(f"padded frame (depth {depth}): max abs diff {err:.3e}")
        assert err <= PIX_TOL
