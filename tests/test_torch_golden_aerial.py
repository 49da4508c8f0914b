"""The aerial artifact and the deep spike tree through the port.

The aerial artifact (175,656 chunks, depth 9, SH4) is
``tests/fixtures/gen_fixtures.py``'s ``make_big_scene_npz``, built here
without JAX by ``bench_torch.aerial_artifact`` (the port's
``field_tree_arrays``), as the card builds it.  The cases are the JAX
suite's: ``test_golden.py``'s exact frame at 160x160 and fast frame at
512x512 against the committed goldens, and ``test_scale.py``'s leaf map
five levels short of a depth-12 spike tree (the resumed descent).  The
port's plain versions run them on the CPU.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mega_nerf_viewer_tpu_torch as P
from mega_nerf_viewer_tpu.options import RenderOptions
from mega_nerf_viewer_tpu.ops import render as JR
from mega_nerf_viewer_tpu.ops.rays import rodrigues, screen2worlddir
from mega_nerf_viewer_tpu_torch.ops import accel as PA
from mega_nerf_viewer_tpu_torch.ops import render as PR
from mega_nerf_viewer_tpu_torch.utils.metrics import psnr
from mega_nerf_viewer_tpu_torch.utils.png import read_png

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "fixtures")
sys.path.insert(0, REPO)
sys.path.insert(0, FIXTURES)
import bench_torch  # noqa: E402
import chip_smoke  # noqa: E402
import gen_fixtures  # noqa: E402
from test_scale import _spike_tree as jax_spike_tree  # noqa: E402

SVOX_KEYS = ("data", "child", "parent_depth", "invradius", "offset",
             "data_format")
AERIAL_OPT = dict(background_brightness=0.9)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the plain marches run thousands of small ops,
    and under a suite's parallel workers each op's thread team would
    contend for every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def aerial(tmp_path_factory):
    path, cap = bench_torch.aerial_artifact(
        str(tmp_path_factory.mktemp("aerial") / "aerial_sh4_d9.npz"))
    return path, cap, P.N3Tree.open(path, device="cpu")


@pytest.fixture(scope="module")
def exact160(aerial):
    tree = aerial[2]
    cam = chip_smoke.aerial_camera(P.Camera, 160, 160)
    img, _ = PR.render_frame(tree, cam.width, cam.height, cam.fx, cam.fy,
                             cam.cx, cam.cy, cam.transform,
                             P.RenderOptions(**AERIAL_OPT))
    return cam, img


@pytest.fixture(scope="module")
def leaf_map(aerial):
    return P.build_leaf_map(aerial[2])


def test_build_equals_jax(aerial, tmp_path):
    """The port-built artifact is array-equal to ``make_big_scene_npz``'s
    file, and loads as the 175,656-chunk SH4 tree of depth 9."""
    path, cap, tree = aerial
    jpath, jcap = gen_fixtures.make_big_scene_npz(
        path=str(tmp_path / "aerial_jax.npz"))
    assert cap == jcap == 175_656
    ours, theirs = np.load(path), np.load(jpath)
    assert sorted(ours.files) == sorted(theirs.files)
    for k in SVOX_KEYS:
        np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)
    assert int(tree.capacity) == cap
    assert tree.data_format.to_string() == "SH4"
    assert PA.tree_max_depth(tree) == 9


def test_camera_is_gen_fixtures_pose():
    want = gen_fixtures.aerial_camera()
    got = chip_smoke.aerial_camera(P.Camera, 160, 160)
    assert (got.width, got.height, got.fx, got.fy, got.cx, got.cy) == (
        want.width, want.height, want.fx, want.fy, want.cx, want.cy)
    np.testing.assert_array_equal(np.asarray(got.transform),
                                  np.asarray(want.transform))


def test_exact_frame_golden_160(exact160):
    """``test_golden.py:98``: the exact frame against the committed
    160x160 golden."""
    _, img = exact160
    got = PR.to_rgba8(img).numpy().astype(np.float32) / 255.0
    want = read_png(os.path.join(FIXTURES,
                                 "aerial_sh4_d9_golden.png")) / 255.0
    assert psnr(got, want) > 48.0


def test_fast_frame_160_matches_exact(aerial, leaf_map, exact160):
    cam, img = exact160
    fast, overflow, _ = PA.render_frame_fast(
        aerial[2], leaf_map, cam, P.RenderOptions(**AERIAL_OPT),
        max_dense=32, chunk_size=0)
    assert not int(overflow)
    assert float((fast - img).abs().max()) <= 1e-4
    assert psnr(fast[..., :3].numpy(), img[..., :3].numpy()) > 60.0


def test_fast_frame_golden_512(aerial, leaf_map):
    """``test_golden.py:141``: the fast frame at 512x512 against the
    committed golden of the exact path."""
    cam = chip_smoke.aerial_camera(P.Camera, 512, 512)
    fast, overflow, _ = PA.render_frame_fast(
        aerial[2], leaf_map, cam, P.RenderOptions(**AERIAL_OPT),
        max_dense=32, chunk_size=0)
    assert not int(overflow)
    got = PR.to_rgba8(fast).numpy().astype(np.float32) / 255.0
    want = read_png(os.path.join(FIXTURES,
                                 "aerial_sh4_d9_golden512.png")) / 255.0
    assert psnr(got, want) > 45.0


# ----------------------------------------------------------------------
# The spike tree: test_scale.py's _spike_tree, built by the port
# ----------------------------------------------------------------------
TARGET = np.array([0.3371, 0.5563, 0.6117])


def port_spike_tree(depth, basis_dim=1):
    """``test_scale.py:37-61``'s tree through the port's
    ``build_host_tree``: subdivided only along the path to one point."""
    data_dim = 3 * basis_dim + 1

    def depth_map(vc, d):
        size = 2.0 ** (-d)
        return d < depth and np.all(np.abs(vc - TARGET) < 0.5 * size + 1e-9)

    def data_fn(vc, size):
        out = np.zeros(data_dim, np.float64)
        if np.all(np.abs(vc - TARGET) < size) or (0.44 < vc[1] < 0.52):
            out[0] = 1.2 * np.sin(31.0 * vc.sum())
            out[-1] = 35.0
        return out

    arrays = P.n3tree.build_host_tree(depth_map, data_fn, data_dim,
                                      basis_dim)
    return P.N3Tree.from_arrays(*arrays, device="cpu")


@pytest.mark.parametrize("depth,level", [(12, 7), (9, 5)])
def test_spike_resumed_descent(depth, level):
    """``test_scale.py:63``: a leaf map ``depth - level`` levels short of
    the spike tree.  The port's fast march equals its exact march within
    1e-6 with no overflow, and its exact march is within 1e-5 of JAX's
    ``render_rays`` on the same rays."""
    jt = jax_spike_tree(depth=depth)
    pt = port_spike_tree(depth)
    for k in ("data", "child", "parent", "scale", "offset"):
        np.testing.assert_array_equal(getattr(pt, k).numpy(),
                                      np.asarray(getattr(jt, k)), err_msg=k)
    assert PA.tree_max_depth(pt) == depth
    lm = PA.build_leaf_map(pt, level=level)
    assert lm.deep_levels == depth - level
    assert bool(((lm.rows[:, 1] & PA._INTERNAL_BIT) != 0).any())

    cam = P.Camera(24, 24, 30.0)
    cam.center = np.array([-0.6, 0.35, 1.8], np.float32)
    back = cam.center - (TARGET * 2.0 - 1.0).astype(np.float32)
    cam.v_back = back / np.linalg.norm(back)
    cam._update()
    opt = RenderOptions()
    dirs, cen = screen2worlddir(cam.width, cam.height, cam.fx, cam.fy,
                                cam.cx, cam.cy, jnp.asarray(cam.transform))
    vdirs = rodrigues(jnp.asarray(opt.rot_dirs, jnp.float32), dirs)
    want = np.asarray(JR.render_rays(jt, dirs, vdirs, cen, opt).out)

    rays = [torch.as_tensor(np.array(a)) for a in (dirs, vdirs, cen)]
    popt = P.RenderOptions()
    exact = PR.render_rays(pt, *rays, popt).out
    fast = PA.render_rays_fast(pt, lm, *rays, popt)
    assert not int(fast.overflow)
    assert float(exact[..., 3].max()) > 0.5             # the scene is hit
    assert float((fast.out - exact).abs().max()) <= 1e-6
    assert float(np.abs(exact.numpy() - want).max()) <= 1e-5
