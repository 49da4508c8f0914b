"""The port's multi-device frames at a world size of 4 (gloo worker
processes) against the JAX package's on a 4-device virtual mesh, and on a
(rays 2, model 2) mesh the tensor-parallel MLP and the frame-refine step.
The cases and tolerances are ``test_torch_parallel.py``'s; the TP MLP is
held to the dense forward within rtol 1e-4 / atol 1e-5 and the step to
JAX's with the same draws: topology, ``n_added`` and visit marks equal,
data within one f16 ulp (``test_parallel.py:66``, ``:92``)."""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from jax import shard_map
from jax.sharding import PartitionSpec as Pspec

import mega_nerf_viewer_tpu.n3tree as J
from mega_nerf_viewer_tpu import parallel as JP
from mega_nerf_viewer_tpu.models import MegaNeRFModel as JModel
from mega_nerf_viewer_tpu.models import meganerf as JM
from mega_nerf_viewer_tpu.options import RenderOptions

from test_torch_parallel import CASES, _camera, _rays, run_world


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    return run_world(4, tmp_path_factory.mktemp("world4"))


@pytest.mark.parametrize("case", sorted(CASES))
def test_sharded_world4(world4, case):
    CASES[case](world4)


def _mesh22():
    return JP.make_mesh((2, 2), (JP.RAY_AXIS, JP.MODEL_AXIS),
                        jax.devices()[:4])


def _jax_tp(params, ids, x):
    pspecs = JP.tp_param_specs(params)

    @functools.partial(
        shard_map, mesh=_mesh22(),
        in_specs=(pspecs, Pspec(JP.RAY_AXIS), Pspec(JP.RAY_AXIS)),
        out_specs=Pspec(JP.RAY_AXIS), check_vma=False)
    def tp_apply(p, cid, xx):
        return JP.mlp_forward_all_tp(p, cid, xx)
    return np.asarray(tp_apply(params, jnp.asarray(ids), jnp.asarray(x)))


@pytest.mark.parametrize("n_layers", [4, 3])
def test_tp_mlp_matches_dense(world4, n_layers):
    """Column/row layers with one all_reduce per row layer (the 3-layer
    model's last layer replicated): the dense forward and JAX's TP forward
    within rtol 1e-4 / atol 1e-5, all clusters and cluster 1 alone."""
    inp = world4["inputs"]
    p = world4["ranks"][0]
    j = JModel.synthetic(data_dim=4, n_clusters=4, hidden=32,
                         n_layers=n_layers, seed=3)
    x, ids = jnp.asarray(inp["tp_x"]), jnp.asarray(inp["tp_ids"])
    dense = np.asarray(JM.mlp_forward_all(j.params, ids, x))
    got = p[f"tp{n_layers}"]
    np.testing.assert_allclose(got, dense, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got, _jax_tp(j.params, ids, x), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(
        p[f"tp{n_layers}_c1"],
        np.asarray(JM.mlp_forward(j.params, jnp.int32(1), x)), rtol=1e-4,
        atol=1e-5)


def test_tp_mlp_with_skips_replicates(world4):
    inp = world4["inputs"]
    p = world4["ranks"][0]
    jp = JM.MLPParams(weights=[jnp.asarray(inp[f"skip_w{l}"])
                               for l in range(4)],
                      biases=[jnp.asarray(inp[f"skip_b{l}"])
                              for l in range(4)], skips=(2,))
    assert int(p["tp_skip_rep"]) == 1
    dense = np.asarray(JM.mlp_forward_all(jp, jnp.asarray(inp["tp_ids"]),
                                          jnp.asarray(inp["tp_x"])))
    np.testing.assert_allclose(p["tp_skip"], dense, rtol=1e-4, atol=1e-5)


def test_frame_refine_step(world4):
    """The step on a (rays 2, model 2) mesh against JAX's with the same
    uniform draws."""
    p = world4["ranks"][0]
    tree = J.sphere_tree(basis_dim=1, depth=3, max_capacity=2000)
    model = JModel.synthetic(
        data_dim=4, n_clusters=4, hidden=16, n_layers=4, grid_dim=(2, 2),
        min_position=(-2, -2, -2), max_position=(2, 2, 2))
    opt = RenderOptions(use_splitting=True, split_batch_size=16,
                        samples_per_corner=8)
    step = JP.make_frame_refine_step(_mesh22(), opt)
    tracker = jnp.zeros((tree.max_capacity,), jnp.int32).at[0].set(1)
    out, new, tracker, n_added = step(
        tree, model.params, jnp.asarray(model.grid_dim, jnp.int32),
        jnp.asarray(model.min_position, jnp.float32),
        jnp.asarray(model.range, jnp.float32),
        *_rays(_camera(16, 16, 20.0), opt), tracker,
        jax.random.PRNGKey(0))
    assert int(p["refine_n"]) == int(n_added) > 0
    assert int(p["refine_capacity"]) == int(new.capacity) \
        == int(tree.capacity) + int(n_added)
    for k in ("child", "parent", "sample_counts"):
        np.testing.assert_array_equal(p[f"refine_{k}"],
                                      np.asarray(getattr(new, k)), err_msg=k)
    a = np.asarray(new.data).view(np.int16).astype(np.int32)
    b = p["refine_data"].view(np.int16).astype(np.int32)
    assert np.abs(a - b).max() <= 1
    np.testing.assert_array_equal(p["refine_tracker"], np.asarray(tracker))
    np.testing.assert_allclose(p["refine_out"], np.asarray(out), atol=1e-6)
