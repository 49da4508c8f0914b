"""``benchmarks_torch/refine_throughput.py``, ``parity.py`` and
``orbit4k.py`` against the JAX protocols, on the CPU.

* refinement at 96x96, depth 5, one timed iteration (the vote frame needs
  ``split_batch_size`` = 4096 rays): JAX's script runs in-process, its
  ``jax.random.split`` draws handed to the port as ``rnds``, with a spy on
  its expands.  Equal: ``total_added``, ``final_capacity``,
  ``leafmap_shape_stable``, each expand's count and the final tree's
  topology; its data within one f16 ulp (``test_torch_refine.py``'s rule).
* parity at 96x96 (JAX's script fixes 800x800): JAX's steps replayed with
  its public functions.  Equal: the probed indices; ``frac_within_1e-3``
  1.0 on both sides; the frames within 1e-5 (the sphere's sigma is 20).
* the 4K orbit at 256x144, depth 5, 3 poses: JAX's steps replayed with its
  public functions on a 1-device mesh (the port's world of one).  Equal:
  each pose's order and settled segments; the last frame within BASELINE's
  1e-3 (the sigma = 400 shell, which XLA:CPU's ``exp`` moves by 2.7e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mega_nerf_viewer_tpu_torch as P
import mega_nerf_viewer_tpu.n3tree as J
from mega_nerf_viewer_tpu import parallel as JPar
from mega_nerf_viewer_tpu.camera import Camera
from mega_nerf_viewer_tpu.options import RenderOptions
from mega_nerf_viewer_tpu.ops import accel as JA
from mega_nerf_viewer_tpu.ops import oracle as JO
from mega_nerf_viewer_tpu.ops import refine as JR
from mega_nerf_viewer_tpu.ops.pallas_march import build_skip_table
from mega_nerf_viewer_tpu.ops.rays import rodrigues, screen2worlddir

from test_torch_benchmarks_contract import (  # noqa: F401 (few_threads)
    check_keys, few_threads, run_jax, run_port)
from test_torch_refine import assert_trees_equal

REFINE_ENV = dict(BENCH_WH="96x96", BENCH_DEPTH="5")
REFINE_ITERS = 1
PARITY_WH, PARITY_PROBES = 96, 300
ORBIT_W, ORBIT_H, ORBIT_DEPTH, ORBIT_POSES = 256, 144, 5, 3


def jax_draws(n, shape):
    """The uniforms of JAX's script: ``n`` splits of ``PRNGKey(0)``."""
    key = jax.random.PRNGKey(0)
    out = []
    for _ in range(n):
        key, sub = jax.random.split(key)
        out.append(torch.tensor(np.asarray(
            jax.random.uniform(sub, shape, jnp.float32))))
    return out


@pytest.fixture(scope="module")
def refinement():
    expands = []
    with pytest.MonkeyPatch.context() as mp:
        orig = JR.expand_voxels_jit

        def spy(*a, **k):
            tree, tracker, n = orig(*a, **k)
            expands.append((tree, int(n)))
            return tree, tracker, n

        mp.setattr(JR, "expand_voxels_jit", spy)
        jrec = run_jax("refine_throughput", [REFINE_ITERS], REFINE_ENV)
    rnds = jax_draws(2 + REFINE_ITERS, (4096, 8, 8, 3))
    prec, ns = run_port("refine_throughput", [REFINE_ITERS], REFINE_ENV,
                        run_kw=dict(rnds=rnds))
    return jrec, prec, ns, expands


def test_refine_line(refinement):
    jrec, prec, _, _ = refinement
    check_keys("refine_throughput", prec, jrec)
    for k in ("total_added", "final_capacity", "leafmap_shape_stable",
              "iterations"):
        assert prec[k] == jrec[k], k
    assert prec["total_added"] > 0


def test_refine_expands(refinement):
    """Each expand added what JAX's did, and the final trees agree."""
    _, _, ns, expands = refinement
    assert ns.counts == [n for _, n in expands]
    assert_trees_equal(expands[-1][0], ns.tree)


def _parity_camera(cls, w):
    cam = cls(w, w, 1111.0)
    cam.center = np.array([-1.5, 0.1, 1.4], np.float32)
    cam._update()
    return cam


@pytest.fixture(scope="module")
def parity():
    """``benchmarks/parity.py:33-64`` with the JAX package at 96x96."""
    w = PARITY_WH
    tree = J.sphere_tree(basis_dim=9, depth=5)
    opt = RenderOptions()
    cam = _parity_camera(Camera, w)
    lm = JA.build_leaf_map(tree)
    img, overflow, _ = JA.render_frame_fast(
        tree, lm, cam, opt, max_dense=32, chunk_size=1 << 15, block=64)
    assert not bool(overflow)
    img = np.asarray(img)
    dirs, cen = screen2worlddir(cam.width, cam.height, cam.fx, cam.fy,
                                cam.cx, cam.cy, jnp.asarray(cam.transform))
    vdirs = rodrigues(jnp.asarray(opt.rot_dirs, jnp.float32), dirs)
    dirs, vdirs, cen = map(np.asarray, (dirs, vdirs, cen))
    idx = np.random.RandomState(0).choice(w * w, PARITY_PROBES,
                                          replace=False)
    host = JO.tree_to_host(tree)
    flat = img.reshape(-1, 4)
    errs = []
    for i in idx:
        want, _, _, _ = JO.trace_ray(host, dirs[i], vdirs[i], cen, opt)
        want[:3] += np.float32(opt.background_brightness) * (
            np.float32(1.0) - want[3])
        errs.append(np.abs(flat[i] - want).max())
    prec, ns = run_port("parity", [PARITY_PROBES],
                        dict(BENCH_WH=f"{w}x{w}"))
    return img, idx, np.asarray(errs), prec, ns


def test_parity_line(parity):
    _, _, _, prec, _ = parity
    check_keys("parity", prec)
    assert prec["pixels_probed"] == PARITY_PROBES
    assert prec["frac_within_1e-3"] == 1.0
    assert prec["max_err"] <= 1e-3


def test_parity_probes(parity):
    img, idx, errs, _, ns = parity
    np.testing.assert_array_equal(ns.idx, idx)
    assert float(np.mean(errs < 1e-3)) == 1.0
    assert float(np.mean(ns.errs < 1e-3)) == 1.0


def test_parity_frame(parity):
    img, _, _, _, ns = parity
    assert ns.img.shape == img.shape == (PARITY_WH, PARITY_WH, 4)
    assert float(img[..., 3].max()) > 0.5
    np.testing.assert_allclose(ns.img, img, rtol=0, atol=1e-5)


def jax_orbit():
    """``benchmarks/orbit4k.py:35-99`` with the JAX package on a 1-device
    mesh: each pose's order, settled segments, and the last timed frame."""
    w, h, n = ORBIT_W, ORBIT_H, ORBIT_POSES
    cs = min(1920, w)
    tree = J.shell_tree(depth=ORBIT_DEPTH, basis_dim=9, sigma_inside=400.0)
    lm = JA.build_leaf_map(tree)
    opt = RenderOptions()
    table = build_skip_table(tree, opt.sigma_thresh)
    mesh = JPar.make_mesh((1,), (JPar.RAY_AXIS,), jax.devices()[:1])
    cam = Camera(w, h, 2222.0)
    cam.center = np.array([-1.4, 0.1, 1.3], np.float32)
    cam._update()
    poses = []
    for _ in range(n):
        step = 2.0 * np.pi / n
        cam.begin_drag(0.0, 0.0, False, True)
        cam.drag_update(-step * w / 2.0, 0.0)
        cam.end_drag()
        cam._update()
        max_dense = 8
        while True:
            _, ovh, steps, nrec, skips = JA.render_frame_fast(
                tree, lm, cam, opt, max_dense=max_dense, chunk_size=cs,
                block=64, return_nrec=True, skip_table=table,
                return_skips=True)
            if not bool(ovh):
                break
            max_dense *= 2          # the port's escalation (JAX asserts)
        order = JA.order_from_hints(steps, nrec, skips)
        segments = list(JA.DEFAULT_SEGMENTS)
        while True:
            img, seg_ov = JPar.render_frame_fast_segmented_sharded(
                tree, lm, cam, opt, order=order, segments=tuple(segments),
                mesh=mesh, chunk_size=cs, skip_table=table)
            ov = np.asarray(seg_ov)
            if not ov.any():
                break
            segments = [(f, max(1, b * 2)) if hit else (f, b)
                        for (f, b), hit in zip(segments, ov)]
        poses.append((tuple(np.asarray(o) for o in order),
                      tuple(segments)))
    return poses, np.asarray(img)


@pytest.fixture(scope="module")
def orbit():
    from mega_nerf_viewer_tpu_torch.parallel import mesh as PM
    poses, img = jax_orbit()
    # the port's world of one stands in this process only for the run
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(PM, "_world_device", None)
        mp.setattr(PM, "_meshes", {})
        mp.setattr(PM, "_meshes_world", None)
        prec, ns = run_port("orbit4k", [ORBIT_POSES],
                            dict(BENCH_WH=f"{ORBIT_W}x{ORBIT_H}",
                                 BENCH_DEPTH=str(ORBIT_DEPTH)))
    return poses, img, prec, ns


def test_orbit_line(orbit):
    _, _, prec, ns = orbit
    check_keys("orbit4k", prec)
    assert prec["devices"] == 1 and ns.rank == 0
    assert prec["value"] > 0


def test_orbit_leaves_no_group(orbit):
    import torch.distributed as dist
    assert not dist.is_initialized()


@pytest.mark.parametrize("pose", range(ORBIT_POSES))
def test_orbit_pose_order_and_segments(orbit, pose):
    poses, _, _, ns = orbit
    jorder, jsegs = poses[pose]
    for a, b in zip(ns.orders[pose], jorder):
        np.testing.assert_array_equal(a, b)
    assert tuple(ns.segments[pose]) == jsegs


def test_orbit_hints_do_not_depend_on_budget():
    """The port's orbit escalates a hint frame that overflows where JAX's
    script asserts; the hints it orders by (steps, uncapped record counts,
    skips) are the same at any budget, in both packages."""
    w, h = 64, 36
    jt = J.shell_tree(depth=ORBIT_DEPTH, basis_dim=9, sigma_inside=400.0)
    pt = P.shell_tree(depth=ORBIT_DEPTH, basis_dim=9, sigma_inside=400.0,
                      device="cpu")
    hints = []
    for tree, mod, cam_cls, opt_cls, table in (
            (jt, JA, Camera, RenderOptions, build_skip_table(jt, 1e-2)),
            (pt, P, P.Camera, P.RenderOptions, P.build_skip_table(pt, 1e-2))):
        cam = cam_cls(w, h, 2222.0 * w / ORBIT_W)
        cam.center = np.array([-1.4, 0.1, 1.3], np.float32)
        cam._update()
        for md in (2, 16):
            _, ov, *hint = mod.render_frame_fast(
                tree, mod.build_leaf_map(tree), cam, opt_cls(),
                max_dense=md, chunk_size=w, block=16, return_nrec=True,
                skip_table=table, return_skips=True)
            assert bool(int(ov)) == (md == 2)
            hints.append([np.asarray(x) for x in hint])
    for x in hints[1:]:
        for a, b in zip(hints[0], x):
            np.testing.assert_array_equal(a, b)


# the rays of the 4K orbit's hint frames (3840x2160, f = 2222, depth 8)
# that record more than max_dense 8 dense samples at poses 0, 2, 4 and 6
# (pixel ids, found on the card), each one's uncapped record count, and two
# neighbours and a miss that stay within the budget
ORBIT4K_RAYS = np.array([1093166, 1097006, 1097007, 1100852, 1093165,
                         1097008, 0], np.int64)
ORBIT4K_NREC = [10, 9, 9, 9, 7, 6, 0]


@pytest.fixture(scope="module")
def orbit4k_trees():
    jt = J.shell_tree(depth=8, basis_dim=9, sigma_inside=400.0)
    pt = P.shell_tree(depth=8, basis_dim=9, sigma_inside=400.0,
                      device="cpu")
    return ((jt, JA.build_leaf_map(jt), build_skip_table(jt, 1e-2)),
            (pt, P.build_leaf_map(pt), P.build_skip_table(pt, 1e-2)))


@pytest.mark.parametrize("pose", [0, 2, 4, 6])
def test_orbit4k_hint_frame_overflows_in_jax(orbit4k_trees, pose):
    """At ``benchmarks/orbit4k.py``'s defaults the JAX package's march
    records 9-10 dense samples on four rays of every other pose, so its
    script's ``assert not bool(ovh)`` at ``max_dense`` 8 fails; the port's
    march gives the same counts (its script escalates instead).  Only those
    rays run here, through ``render_rays_fast`` with the skip table, from
    the same pixel ids as the 4K frame's ray generation."""
    from mega_nerf_viewer_tpu.ops.rays import screen2worlddir_indices as jrg
    from mega_nerf_viewer_tpu_torch.ops import accel as PA
    from mega_nerf_viewer_tpu_torch.ops.rays import (
        screen2worlddir_indices as prg)
    w, h = 3840, 2160
    cam = Camera(w, h, 2222.0)
    cam.center = np.array([-1.4, 0.1, 1.3], np.float32)
    cam._update()
    for _ in range(pose + 1):
        cam.begin_drag(0.0, 0.0, False, True)
        cam.drag_update(-2.0 * np.pi / 8 * w / 2.0, 0.0)
        cam.end_drag()
        cam._update()
    (jt, jlm, jtab), (pt, plm, ptab) = orbit4k_trees
    rg = (w, cam.fx, cam.fy, cam.cx, cam.cy)
    d, c = jrg(jnp.asarray(ORBIT4K_RAYS, jnp.int32), *rg,
               jnp.asarray(cam.transform, jnp.float32))
    jres = JA.render_rays_fast(jt, jlm, d, d, c, RenderOptions(),
                               max_dense=8, skip_table=jtab)
    d, c = prg(torch.as_tensor(ORBIT4K_RAYS), *rg,
               torch.as_tensor(np.asarray(cam.transform, np.float32)))
    pres = PA.render_rays_fast(pt, plm, d, d, c, P.RenderOptions(),
                               max_dense=8, skip_table=ptab)
    assert np.asarray(jres.nrec).tolist() == ORBIT4K_NREC
    assert int(jres.overflow) == 4
    assert pres.nrec.tolist() == ORBIT4K_NREC
    assert int(pres.overflow) == 4
    np.testing.assert_array_equal(pres.steps.numpy(), np.asarray(jres.steps))


def test_orbit_frame(orbit):
    """The last timed pose's frame (the last pose of the orbit)."""
    _, img, _, ns = orbit
    assert ns.img.shape == img.shape == (ORBIT_H, ORBIT_W, 4)
    assert float(img[..., 3].max()) > 0.5
    np.testing.assert_allclose(ns.img, img, rtol=0, atol=1e-3)
