"""The port's multi-device frames at a world size of 2 (gloo worker
processes) against the JAX package's on a 2-device virtual mesh, the
multi-host broadcast and ``cli --sharded`` under two ranks.  The cases and
tolerances are ``test_torch_parallel.py``'s; the multi-host frames are held
to each other bit-exactly and to the single-process frame within JAX's
budget (``test_parallel.py:336-345``: 1e-4 fast, 1e-3 guided)."""

import numpy as np
import pytest

import mega_nerf_viewer_tpu.n3tree as J
from mega_nerf_viewer_tpu.camera import Camera
from mega_nerf_viewer_tpu.models import MegaNeRFModel as JModel
from mega_nerf_viewer_tpu.options import RenderOptions
from mega_nerf_viewer_tpu.ops import accel as JA
from mega_nerf_viewer_tpu.ops import guided as JG

from test_torch_parallel import CASES, check_cli, run_world


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    return run_world(2, tmp_path_factory.mktemp("world2"))


@pytest.mark.parametrize("case", sorted(CASES))
def test_sharded_world2(world2, case):
    CASES[case](world2)


def test_cli_sharded_two_ranks(world2):
    """``cli --sharded`` joined from torchrun's environment; rank 0
    wrote the PNG."""
    check_cli(world2)


def test_multihost_broadcast_and_sharded_frame(world2):
    """Rank 1 started with a transparent tree and other weights; after
    ``multihost.broadcast`` both ranks render rank 0's frames, equal to
    each other, to the port's single-process frames and to the JAX
    package's."""
    a, b = (r["mh"] for r in world2["ranks"])
    np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(a, world2["ranks"][0]["mh_single"], atol=1e-4)
    assert a[..., 3].max() > 0.5         # the broadcast tree is opaque
    tree = J.sphere_tree(basis_dim=4, depth=3, sigma_inside=20.0)
    lm = JA.build_leaf_map(tree)
    cam = Camera(32, 24, 20.0)
    cam.center = np.array([-1.5, 0.1, 1.4], np.float32)
    cam._update()
    ref = JA.render_frame_fast(tree, lm, cam, RenderOptions(), max_dense=32,
                               chunk_size=0)[0]
    np.testing.assert_allclose(a, np.asarray(ref), atol=1e-4)
    ga, gb = (r["mhg"] for r in world2["ranks"])
    np.testing.assert_array_equal(ga, gb)
    assert int(world2["ranks"][0]["mhg_ov"]) == 0
    np.testing.assert_allclose(ga, world2["ranks"][0]["mhg_single"],
                               atol=1e-3)
    model = JModel.synthetic(data_dim=13, n_clusters=4, grid_dim=(2, 2),
                             min_position=(-2, -2, -2),
                             max_position=(2, 2, 2), seed=0)
    opt = RenderOptions(max_guided_samples=8, use_guided_sampling=True)
    cache = JG.collect_and_query_fast(tree, lm, model, cam, opt,
                                      chunk_size=0)
    gref = JG.composite_frame(tree, cam, opt, cache, use_pallas=False)
    np.testing.assert_allclose(ga, np.asarray(gref), atol=1e-3)


def test_default_mesh_made_once(world2):
    """``render_frame_sharded`` called twice without a mesh: the second
    call made no process group, ``default_mesh`` returns the same mesh,
    and both frames equal the frame over an explicit mesh."""
    for r in world2["ranks"]:
        assert int(r["mesh_groups_made"]) == 0
        assert bool(r["mesh_same"])
        for img in r["mesh_frames"]:
            np.testing.assert_array_equal(img, r["pad"])
