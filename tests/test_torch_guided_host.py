"""Guided sampling with a model on the eager TorchScript fallback, against
the JAX package: ``reconstruct_samples``, the host reconstruction path of
``collect_and_query_fast`` (``guided.py:953``) with its padded cache, the
padded composite of that cache, and the Viewer's guided frames.

Tolerances: sample rows and ``z_vals`` within 1e-6 (the same f32 math in
another order), cluster ids, sample counts and steps equal, MLP results
and frames within 1e-5 (``test_torch_guided.py``'s budget).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import mega_nerf_viewer_tpu.n3tree as J
import mega_nerf_viewer_tpu_torch as P
from mega_nerf_viewer_tpu import Viewer as JViewer
from mega_nerf_viewer_tpu.camera import Camera
from mega_nerf_viewer_tpu.models import MegaNeRFModel as JModel
from mega_nerf_viewer_tpu.options import RenderOptions
from mega_nerf_viewer_tpu.ops import accel as JA
from mega_nerf_viewer_tpu.ops import guided as JG
from mega_nerf_viewer_tpu.ops import pallas_march as JM
from mega_nerf_viewer_tpu_torch import kernels
from mega_nerf_viewer_tpu_torch.ops import guided as PG

from test_torch_exact import port, port_opt, world_rays
from test_torch_models import Weird, _fallback_container

S = 16
CS = 64
RES_TOL = 1e-5
Z_TOL = 1e-6


def _camera(cls, w=24, h=18, f=20.0):
    cam = cls(w, h, f)
    cam.center = np.array([-1.5, 0.1, 1.4], np.float32)
    cam._update()
    return cam


@pytest.fixture(scope="module")
def fallback_path(tmp_path_factory):
    return _fallback_container(tmp_path_factory.mktemp("fb"), Weird)


@pytest.mark.parametrize("viewdir,app", [(True, -1), (False, 3)])
def test_reconstruct_samples_matches_jax(viewdir, app):
    """Every padded slot's row from the collect's ``t``, -1 past the
    count, and every slot's cluster id."""
    jt = J.sphere_tree(basis_dim=1, depth=4)
    pt = port(jt)
    opt = RenderOptions(max_guided_samples=S, need_viewdir=viewdir,
                        appearance_embedding=app)
    cam = _camera(Camera)
    (jd, jv, jc), (pd, pv, pc) = world_rays(cam, opt)
    t_buf, ns = JG.collect_t_fast(jt, JA.build_leaf_map(jt), jd, jc, opt)
    grid = ((2, 4), (-1.5, -1.5, -1.5), (3.0, 3.0, 3.0))
    js, jids = JG.reconstruct_samples(
        jt, jd, jv, jc, t_buf, ns, jnp.asarray(grid[0], jnp.int32),
        jnp.asarray(grid[1], jnp.float32), jnp.asarray(grid[2], jnp.float32),
        opt)
    ps, pids = PG.reconstruct_samples(
        pt, pd, pv, pc, torch.tensor(np.asarray(t_buf)),
        torch.tensor(np.asarray(ns)), *grid, port_opt(opt))
    js, jids = np.asarray(js), np.asarray(jids)
    assert ps.shape == js.shape == (24 * 18, S, 4 + 3 * viewdir + (app >= 0))
    assert int(np.asarray(ns).sum()) > 0
    np.testing.assert_allclose(ps.numpy(), js, rtol=Z_TOL, atol=Z_TOL)
    np.testing.assert_array_equal(pids.numpy(), jids)


def _spy_ids(model, monkeypatch, out):
    """Record the cluster ids and rows the model is queried with."""
    query = model.query_device

    def spy(ids, x):
        out.append((np.asarray(ids.cpu() if isinstance(ids, torch.Tensor)
                               else ids).reshape(-1),
                    np.asarray(x.cpu() if isinstance(x, torch.Tensor)
                               else x)))
        return query(ids, x)
    monkeypatch.setattr(model, "query_device", spy)


@pytest.mark.parametrize("skip", [False, True])
def test_host_path_matches_jax(fallback_path, monkeypatch, skip):
    """``collect_and_query_fast`` with a fallback model on both sides: the
    padded cache (counts, ``z_vals``, results), the queried rows and their
    cluster ids, and the padded composite of the cache."""
    jt = J.sphere_tree(basis_dim=1, depth=4)
    pt = port(jt)
    opt = RenderOptions(max_guided_samples=S, need_viewdir=True,
                        use_guided_sampling=True)
    popt = port_opt(opt)
    jm = JModel.from_torchscript(fallback_path)
    pm = P.MegaNeRFModel.from_torchscript(fallback_path, device="cpu")
    assert pm._torch_modules is not None and jm._torch_modules is not None
    jq, pq = [], []
    _spy_ids(jm, monkeypatch, jq)
    _spy_ids(pm, monkeypatch, pq)
    jtab = JM.build_skip_table(jt, opt.sigma_thresh) if skip else None
    ptab = P.build_skip_table(pt, opt.sigma_thresh) if skip else None
    j = JG.collect_and_query_fast(jt, JA.build_leaf_map(jt), jm,
                                  _camera(Camera), opt, chunk_size=CS,
                                  skip_table=jtab)
    before = dict(kernels.LAUNCHES)
    p = PG.collect_and_query_fast(pt, P.build_leaf_map(pt), pm,
                                  _camera(P.Camera), popt, chunk_size=CS,
                                  skip_table=ptab)
    assert kernels.LAUNCHES == before       # CPU tensors: plain versions
    assert set(p) == {"results", "z_vals", "num_samples", "collect_steps"}
    ns = np.asarray(j["num_samples"])
    assert ns.sum() > 0
    np.testing.assert_array_equal(p["num_samples"].numpy(), ns)
    np.testing.assert_allclose(p["z_vals"].numpy(), np.asarray(j["z_vals"]),
                               rtol=Z_TOL, atol=Z_TOL)
    np.testing.assert_allclose(p["results"].numpy(),
                               np.asarray(j["results"]), rtol=RES_TOL,
                               atol=RES_TOL)
    (jids, jx), (pids, px) = jq[0], pq[0]
    np.testing.assert_array_equal(pids, jids)
    np.testing.assert_allclose(px, jx, rtol=Z_TOL, atol=Z_TOL)
    # the collect's steps, which order the Viewer's next collect
    pd, _, pc = world_rays(_camera(Camera), opt)[1]
    _, _, steps = PG.collect_t_fast(pt, P.build_leaf_map(pt), pd, pc, popt,
                                    skip_table=ptab, return_steps=True)
    np.testing.assert_array_equal(p["collect_steps"].numpy(), steps.numpy())
    a = np.asarray(JG.composite_frame(jt, _camera(Camera), opt, j))
    b = PG.composite_frame(pt, _camera(P.Camera), popt, p)
    assert b.shape == a.shape == (18, 24, 4)
    np.testing.assert_allclose(b.numpy(), a, atol=RES_TOL)


def _fallback_pair(path, headroom):
    """A JAX and a port Viewer on one sphere with the fallback model and
    ``headroom`` chunks of capacity to spare."""
    max_cap = int(J.sphere_tree(basis_dim=1, depth=3).capacity) + headroom
    jt = J.sphere_tree(basis_dim=1, depth=3, max_capacity=max_cap)
    opt = dict(use_guided_sampling=True, max_guided_samples=8,
               split_batch_size=16)
    from mega_nerf_viewer_tpu_torch.options import RenderOptions as POpt
    jv = JViewer(jt, camera=_camera(Camera, 16, 16, 20.0),
                 options=RenderOptions(**opt), max_tree_capacity=max_cap)
    pv = P.Viewer(port(jt), camera=_camera(P.Camera, 16, 16, 20.0),
                  options=POpt(**opt), max_tree_capacity=max_cap,
                  device="cpu")
    jv.load_model(path)
    pv.load_model(path)
    assert pv.model._torch_modules is not None
    return jv, pv


def test_viewer_guided_frame_fallback_exact_collect(fallback_path,
                                                    monkeypatch):
    """Under capacity pressure (less headroom than a split batch) the
    Viewer takes the exact collect with visit marks; both Viewers query
    the fallback model there, and the frames agree within 1e-5 over a stop
    and a moved pose."""
    jv, pv = _fallback_pair(fallback_path, 8)
    calls = []
    chunk = pv.model._forward_chunk
    monkeypatch.setattr(pv.model, "_forward_chunk",
                        lambda c, x: calls.append(c) or chunk(c, x))
    for _ in range(2):
        a = np.asarray(jv.render())
        n = len(calls)
        b = pv.render()
        assert len(calls) > n          # the frozen submodules ran
        np.testing.assert_allclose(b, a, atol=RES_TOL)
        assert b[..., :3].max() > 0
        for v in (jv, pv):
            v.camera.move(np.array([0.05, 0, 0]))


def test_viewer_guided_frame_fallback_fast_path(fallback_path):
    """Without capacity pressure the port's Viewer takes the leaf-map
    collect, which routes the fallback model to the host path; its frames
    equal JAX's ``collect_and_query_fast`` + ``composite_frame`` on the
    same pose within 1e-5.  (The JAX Viewer reads ``collect_steps`` from
    the cache there, which JAX's host path does not write; the port's
    does.)  The next collect is ordered by this one's steps."""
    jv, pv = _fallback_pair(fallback_path, 20000)
    jm = jv.model
    jt = jv.tree
    for i in range(2):
        b = pv.render()
        cache = pv._guided_cache[0]
        assert set(cache) == {"results", "z_vals", "num_samples",
                              "collect_steps"}
        assert pv._guided_order is not None
        cam = _camera(Camera, 16, 16, 20.0)
        cam.center = np.asarray(pv.camera.center, np.float32)
        cam.v_back = np.asarray(pv.camera.v_back, np.float32)
        cam._update()
        np.testing.assert_array_equal(cam.transform, pv.camera.transform)
        j = JG.collect_and_query_fast(jt, JA.build_leaf_map(jt), jm, cam,
                                      jv.options,
                                      chunk_size=pv.fast_chunk_size,
                                      skip_table=JM.build_skip_table(
                                          jt, jv.options.sigma_thresh))
        a = np.asarray(JG.composite_frame(jt, cam, jv.options, j))
        np.testing.assert_allclose(b, a, atol=RES_TOL)
        pv.camera.move(np.array([0.05, 0, 0]))
