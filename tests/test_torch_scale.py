"""The depth-10 and depth-11 aerial artifacts through the port.

``tests/test_scale.py:99`` loads ``gen_fixtures.make_huge_scene_npz``'s
2,817,022-chunk depth-11 aerial artifact (the aerial field of
``make_big_scene_npz`` two levels deeper).  Here
the port builds it without JAX (``bench_torch.aerial_artifact``) and the
file is held array-equal to JAX's, its leaf map's rows bit-equal to JAX's
(slow, as JAX marks it).  The tier-1 cases run the same regime one level
shallower, at depth 10 (704,171 chunks): the artifact, the level-7 map
(three levels of resumed descent), the per-step leaf lookup and the fast
march on a crop of the aerial camera, against JAX and against the port's
exact march.  The port's plain versions run them on the CPU.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mega_nerf_viewer_tpu.n3tree as J
import mega_nerf_viewer_tpu_torch as P
from mega_nerf_viewer_tpu.options import RenderOptions
from mega_nerf_viewer_tpu.ops import accel as JA
from mega_nerf_viewer_tpu.ops.rays import rodrigues, screen2worlddir
from mega_nerf_viewer_tpu_torch.ops import accel as PA
from mega_nerf_viewer_tpu_torch.ops import render as PR

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests", "fixtures"))
import bench_torch  # noqa: E402
import chip_smoke  # noqa: E402
import gen_fixtures  # noqa: E402
from mega_nerf_viewer_tpu import Viewer as JViewer  # noqa: E402
from mega_nerf_viewer_tpu.camera import Camera as JCamera  # noqa: E402
from mega_nerf_viewer_tpu_torch import viewer as VI  # noqa: E402
from test_torch_golden_aerial import SVOX_KEYS  # noqa: E402
from test_torch_viewer import check_motion_state, check_state  # noqa: E402

CHUNKS = {10: 704_171, 11: 2_817_022}
CROP = 32


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the plain marches run many small ops, and
    under a suite's parallel workers each op's thread team would contend
    for every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def build_both(tmp, depth):
    """The artifact of ``depth`` built by the port and by JAX's
    ``make_huge_scene_npz``: (port path, port chunks, JAX path, JAX
    chunks).  JAX's chunk cap of 3,200,000 binds at neither depth, so the
    port's default call writes the same file."""
    path, cap = bench_torch.aerial_artifact(
        str(tmp / f"aerial_sh4_d{depth}.npz"), depth=depth)
    jpath, jcap = gen_fixtures.make_huge_scene_npz(
        path=str(tmp / f"aerial_sh4_d{depth}_jax.npz"), depth=depth)
    return path, cap, jpath, jcap


def assert_files_equal(path, jpath):
    ours, theirs = np.load(path), np.load(jpath)
    assert sorted(ours.files) == sorted(theirs.files)
    for k in SVOX_KEYS:
        np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)


@pytest.fixture(scope="module")
def d10(tmp_path_factory):
    path, cap, jpath, jcap = build_both(tmp_path_factory.mktemp("d10"), 10)
    return dict(path=path, cap=cap, jpath=jpath, jcap=jcap,
                pt=P.N3Tree.open(path, device="cpu"),
                jt=J.N3Tree.open(jpath))


@pytest.fixture(scope="module")
def maps7(d10):
    return (PA.build_leaf_map(d10["pt"], level=7),
            JA.build_leaf_map(d10["jt"], level=7))


def test_depth10_artifact_equals_jax(d10):
    """The port's depth-10 artifact is array-equal to
    ``make_huge_scene_npz(depth=10)``'s file, and loads as the
    704,171-chunk SH4 tree of depth 10 in both packages."""
    assert d10["cap"] == d10["jcap"] == CHUNKS[10]
    assert_files_equal(d10["path"], d10["jpath"])
    pt = d10["pt"]
    assert int(pt.capacity) == CHUNKS[10]
    assert pt.data_format.to_string() == "SH4"
    assert PA.tree_max_depth(pt) == JA.tree_max_depth(d10["jt"]) == 10


def test_depth10_level7_rows_bit_equal(maps7):
    """The level-7 map, three levels short of the tree: rows bit-equal to
    JAX's, ``deep_levels`` 3, internal cells present."""
    lp, lj = maps7
    assert lp.deep_levels == lj.deep_levels == 3
    assert lp.rows.dtype == torch.int32
    np.testing.assert_array_equal(lp.rows.numpy(), np.asarray(lj.rows))
    assert bool(((lp.rows[:, 1] & PA._INTERNAL_BIT) != 0).any())


def lookup_points(kind, n=6000):
    """Tree-space points in [0, 1): uniform, or on the terrain surface
    where the tree is deepest."""
    rng = np.random.RandomState(7)
    if kind == "random":
        pos = rng.rand(n, 3)
    else:
        x, z = rng.rand(n), rng.rand(n)
        y = gen_fixtures.terrain_height(x, z) + 1e-3 * rng.randn(n)
        pos = np.stack([x, y, z], axis=-1)
    return np.clip(pos.astype(np.float32), 0.0, np.float32(1.0 - 1e-6))


@pytest.mark.parametrize("kind", ["random", "surface"])
def test_depth10_leaf_lookup_equals_jax(d10, maps7, kind):
    """One march step's leaf resolution on the level-7 map (the resumed
    descent): node, depth and sigma equal to JAX's ``leaf_lookup``."""
    pt, jt = d10["pt"], d10["jt"]
    lp, lj = maps7
    pos = lookup_points(kind)
    D = jt.data_dim
    nj, dj, sj = JA.leaf_lookup(
        lj, jt.child.reshape(-1), jt.data.reshape(-1, D)[:, D - 1],
        jnp.asarray(pos), 2, 8)
    npt, dpt, spt = PA.leaf_lookup(
        lp, pt.child.reshape(-1), pt.data.reshape(-1, D)[:, D - 1],
        torch.as_tensor(pos), 2, 8)
    np.testing.assert_array_equal(npt.numpy(), np.asarray(nj))
    np.testing.assert_array_equal(dpt.numpy(), np.asarray(dj))
    np.testing.assert_array_equal(spt.numpy(), np.asarray(sj))
    if kind == "surface":
        assert int(np.asarray(dj).max()) == 10     # the descent resumed


def crop_rays(size=160, crop=CROP):
    """The rays of the central ``crop`` x ``crop`` window of
    ``chip_smoke.aerial_camera`` at ``size`` x ``size`` (JAX's setup, as
    numpy)."""
    cam = chip_smoke.aerial_camera(P.Camera, size, size)
    opt = RenderOptions()
    dirs, cen = screen2worlddir(cam.width, cam.height, cam.fx, cam.fy,
                                cam.cx, cam.cy, jnp.asarray(cam.transform))
    vdirs = rodrigues(jnp.asarray(opt.rot_dirs, jnp.float32), dirs)
    lo = (size - crop) // 2
    rows = np.arange(lo, lo + crop)
    pix = (rows[:, None] * size + rows[None, :]).reshape(-1)
    return np.asarray(dirs)[pix], np.asarray(vdirs)[pix], np.asarray(cen)


def test_depth10_fast_crop_matches_exact_and_jax(d10, maps7):
    """The fast march on the level-7 map over a 32x32 crop of the aerial
    camera: no overflow, within 1e-6 of the port's exact march and within
    1e-5 of JAX's ``render_rays_fast`` on the same rays."""
    pt, jt = d10["pt"], d10["jt"]
    lp, lj = maps7
    dirs, vdirs, cen = crop_rays()
    want = JA.render_rays_fast(jt, lj, jnp.asarray(dirs),
                               jnp.asarray(vdirs), jnp.asarray(cen),
                               RenderOptions())
    assert not bool(want.overflow)
    rays = [torch.as_tensor(np.array(a)) for a in (dirs, vdirs, cen)]
    popt = P.RenderOptions()
    fast = PA.render_rays_fast(pt, lp, *rays, popt)
    exact = PR.render_rays(pt, *rays, popt).out
    assert not int(fast.overflow)
    assert float(exact[..., 3].max()) > 0.5             # the scene is hit
    assert float((fast.out - exact).abs().max()) <= 1e-6
    assert float(np.abs(fast.out.numpy() - np.asarray(want.out)).max()) \
        <= 1e-5


def test_depth10_async_rehint_poses_exceed_tolerance_like_jax(d10):
    """The async re-hint policy at the Viewers' default flag interval on
    the depth-10 tree, ``chip_smoke.py``'s 1080p camera at 160x90 and its
    3-degree orbit: the budgets derived from the parked frame go stale
    under motion, and on the poses before the first flag read both
    Viewers truncate more rays than the 1/512 tolerance, with equal
    per-segment flags; the read re-derives the budgets and the poses
    after it fall within the tolerance in both.  Frames within 1e-4, the
    aerial scene's fast-frame tolerance (``test_torch_golden_aerial``);
    orders, segments and the episode's state equal on every frame."""
    w, h = 160, 90
    viewers = []
    for cls, make, tree in ((JCamera, JViewer, d10["jt"]),
                            (P.Camera, P.Viewer, d10["pt"])):
        cam = cls(w, h, chip_smoke.FOCAL * w / chip_smoke.WIDTH)
        cam.center = np.asarray(chip_smoke.CENTER, np.float32)
        v = (make(tree, camera=cam) if make is JViewer
             else make(tree, camera=cam, device="cpu"))
        v.overflow_policy = "async"
        viewers.append(v)
    jv, pv = viewers
    interval = pv.motion_flag_interval
    assert interval == jv.motion_flag_interval == 4
    tol = int(w * h * pv.motion_overflow_tolerance)

    def flags(v):
        p = v._pending_ov
        return (np.zeros(1, np.int64) if p is None
                else np.asarray(VI._host_array(p[1])))

    def frame():
        a, b = np.asarray(jv.render()), pv.render()
        assert float(np.abs(a - b).max()) <= 1e-4
        check_state(jv, pv)
        check_motion_state(jv, pv)
        fj, fp = flags(jv), flags(pv)
        np.testing.assert_array_equal(fp, fj)
        return int(fp.sum())

    assert frame() == 0         # parked: the hint frame, exact budgets
    truncated, budgets = [], []
    for _ in range(interval + 2):
        for v in viewers:
            chip_smoke.motion_step(v.camera, 3.0)
        truncated.append(frame())
        budgets.append(pv._pending_ov[0])
    # the first ``interval`` poses run on the budgets derived at the
    # episode's start; the flag read after them re-derives the budgets
    stale = [b == budgets[0] for b in budgets]
    assert stale == [True] * interval + [False] * 2, budgets
    assert min(truncated[:interval]) > tol, (truncated, tol)
    assert max(truncated[interval:]) <= tol, (truncated, tol)


@pytest.mark.slow
def test_depth11_multimillion_chunk_loads_and_maps(tmp_path):
    """``test_scale.py:99`` through the port: the 2,817,022-chunk depth-11
    artifact, built by the port array-equal to ``make_huge_scene_npz``'s,
    loads with depth 11, and a level-6 map (``deep_levels`` 5, internal
    cells) has rows bit-equal to JAX's on the JAX-loaded tree."""
    path, cap, jpath, jcap = build_both(tmp_path, 11)
    assert cap == jcap == CHUNKS[11]
    assert_files_equal(path, jpath)
    pt = P.N3Tree.open(path, device="cpu")
    assert int(pt.capacity) >= 2_000_000
    assert pt.data_format.to_string() == "SH4"
    assert PA.tree_max_depth(pt) == 11
    lp = PA.build_leaf_map(pt, level=6)
    assert lp.deep_levels == 5
    assert bool(((lp.rows[:, 1] & PA._INTERNAL_BIT) != 0).any())
    del pt
    lj = JA.build_leaf_map(J.N3Tree.open(jpath), level=6)
    assert lj.deep_levels == 5
    np.testing.assert_array_equal(lp.rows.numpy(), np.asarray(lj.rows))
