"""The exact half of guided sampling against the JAX package: the exact
collect (``guided.collect_samples``, kernel F's plain version on the
CPU), ``collect_and_query`` and ``composite_frame`` on the padded cache,
in depth mode too, on ``sphere_tree`` and a random tree with a 4-cluster
synthetic Mega-NeRF model.

Tolerances, with their reasons:
  * fed JAX's own setup: sample counts, cluster ids, votes and visit
    marks equal, sample rows within 1e-6 (z is a square root of a fused
    sum of squares, as XLA fuses it; the world position one FMA);
  * from world directions: counts, votes and marks equal, rows within
    1e-6 relative (XLA:CPU's approximate ``1 / |d|`` moves some rays'
    z by an ulp or two, ``test_torch_collect.py``);
  * ``collect_and_query`` results and the padded frames: 1e-5 (f32
    MLP products summed in another order).
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
from mega_nerf_viewer_tpu.ops import guided as JG
from mega_nerf_viewer_tpu_torch.ops import guided as PG

from test_torch_exact import (jax_setup, march_inputs_from, port, port_opt,
                              world_rays)

ROW_TOL = 1e-6
RES_TOL = 1e-5
PIX_TOL = 1e-5
MODEL = dict(data_dim=4, n_clusters=4, grid_dim=(2, 2),
             min_position=(-1, -1, -1), max_position=(1, 1, 1),
             need_viewdir=True)
_SCENES = {}


def _scene(name):
    if name not in _SCENES:
        jt = {"sphere": lambda: J.sphere_tree(basis_dim=1, depth=5),
              "random": lambda: J.random_tree(n_chunks=60, basis_dim=1,
                                              seed=3, density=1.0)}[name]()
        _SCENES[name] = (jt, port(jt), MegaNeRFModel.synthetic(**MODEL),
                         P.MegaNeRFModel.synthetic(device="cpu", **MODEL))
    return _SCENES[name]


def _cams(w=24, h=20, f=18.0):
    cams = []
    for cls in (Camera, P.Camera):
        cam = cls(w, h, f)
        cam.center = np.array([-1.5, 0.1, 1.4], np.float32)
        cam._update()
        cams.append(cam)
    return cams


def _grid(jm):
    return (jnp.asarray(jm.grid_dim, jnp.int32),
            jnp.asarray(jm.min_position, jnp.float32),
            jnp.asarray(jm.range, jnp.float32))


def _port_grid(pm):
    return (torch.as_tensor(pm.grid_dim).to(torch.int32),
            torch.as_tensor(pm.min_position).float(),
            torch.as_tensor(pm.range).float())


def _compare_collect(j, p, rows_rtol=0.0):
    for k in ("num_samples", "cluster_ids", "split_vote", "sample_vote",
              "visited"):
        np.testing.assert_array_equal(getattr(p, k).numpy(),
                                      np.asarray(getattr(j, k)), err_msg=k)
    a, b = np.asarray(j.samples), p.samples.numpy()
    assert a.shape == b.shape
    err = float(np.abs(a - b).max())
    print(f"samples: max abs diff {err:.3e}, {int(p.num_samples.sum())} "
          f"recorded, {int(p.visited.sum())} chunks visited")
    np.testing.assert_allclose(b, a, rtol=rows_rtol, atol=ROW_TOL)
    assert int(p.num_samples.sum()) > 0


@pytest.mark.parametrize("name", ["sphere", "random"])
@pytest.mark.parametrize("S,viewdir,app", [(16, True, -1), (2, True, -1),
                                           (8, False, 3)])
def test_collect_samples_from_jax_setup(name, S, viewdir, app):
    jt, pt, jm, _ = _scene(name)
    opt = RenderOptions(max_guided_samples=S, need_viewdir=viewdir,
                        appearance_embedding=app)
    jcam, _ = _cams()
    jrays, prays = world_rays(jcam, opt)
    j = JG.collect_samples(jt, *jrays, *_grid(jm), opt, track_visit=True)
    m = march_inputs_from(jax_setup(jt, *jrays, opt), opt, False)
    m = m._replace(basis=None)
    p = PG.GuidedSamples(*PG.exact_collect_reference(
        pt, m, prays[0], prays[1], prays[2],
        tuple(torch.tensor(np.asarray(g)) for g in _grid(jm)),
        port_opt(opt), True)[:6])
    _compare_collect(j, p)


@pytest.mark.parametrize("name", ["sphere", "random"])
def test_collect_samples_from_world_dirs(name):
    jt, pt, jm, pm = _scene(name)
    opt = RenderOptions(max_guided_samples=16, need_viewdir=True)
    jcam, _ = _cams()
    jrays, prays = world_rays(jcam, opt)
    j = JG.collect_samples(jt, *jrays, *_grid(jm), opt, track_visit=True)
    p = P.collect_samples(pt, *prays, pm.grid_dim, pm.min_position,
                          pm.range, port_opt(opt), track_visit=True)
    _compare_collect(j, p, rows_rtol=1e-6)


@pytest.mark.parametrize("name", ["sphere", "random"])
@pytest.mark.parametrize("track", [False, True])
def test_collect_and_query_and_padded_frame(name, track):
    jt, pt, jm, pm = _scene(name)
    opt = RenderOptions(max_guided_samples=16, need_viewdir=True)
    popt = port_opt(opt)
    jcam, pcam = _cams()
    jc, jr = JG.collect_and_query(jt, jm, jcam, opt, track_visit=track)
    pc, pr = P.collect_and_query(pt, pm, pcam, popt, track_visit=track)
    np.testing.assert_array_equal(pc["num_samples"].numpy(),
                                  np.asarray(jc["num_samples"]))
    for k, tol in (("results", RES_TOL), ("z_vals", ROW_TOL)):
        err = float(np.abs(pc[k].numpy() - np.asarray(jc[k])).max())
        print(f"{k}: max abs diff {err:.3e}")
        assert err <= tol
    for k in ("split_vote", "sample_vote", "visited"):
        np.testing.assert_array_equal(getattr(pr, k).numpy(),
                                      np.asarray(getattr(jr, k)))
    for depth in (False, True):
        o = opt.replace(render_depth=depth)
        want = np.asarray(JG.composite_frame(jt, jcam, o, jc))
        got = P.composite_frame(pt, pcam, port_opt(o), pc)
        err = float(np.abs(got.numpy() - want).max())
        print(f"padded frame (depth {depth}): max abs diff {err:.3e}")
        assert got.shape == want.shape
        assert err <= PIX_TOL
        assert (got[..., 3] == 1).all()


def test_padded_frame_after_rot_dirs_uses_frame_directions():
    """The padded frame shades with the frame's own view directions, so a
    ``rot_dirs`` change moves an SH4 frame as it moves JAX's."""
    jt = J.sphere_tree(basis_dim=4, depth=4)
    pt = port(jt)
    model = dict(MODEL, data_dim=13)
    jm = MegaNeRFModel.synthetic(**model)
    pm = P.MegaNeRFModel.synthetic(device="cpu", **model)
    opt = RenderOptions(max_guided_samples=8, need_viewdir=True)
    jcam, pcam = _cams(16, 12, 12.0)
    jc, _ = JG.collect_and_query(jt, jm, jcam, opt)
    pc, _ = P.collect_and_query(pt, pm, pcam, port_opt(opt))
    base = P.composite_frame(pt, pcam, port_opt(opt), pc)
    o = opt.replace(rot_dirs=(0.3, -0.2, 0.1))
    got = P.composite_frame(pt, pcam, port_opt(o), pc)
    want = np.asarray(JG.composite_frame(jt, jcam, o, jc))
    assert not torch.equal(got, base)
    assert float(np.abs(got.numpy() - want).max()) <= PIX_TOL


def test_padded_cache_is_built_f32_contiguous():
    """``collect_and_query`` builds the padded cache f32 and contiguous with
    i32 counts, so the compositor's ``float().contiguous()`` and
    ``to(int32)`` copy nothing per frame; a cache handed over in another
    layout composites to the same frame."""
    _, pt, _, pm = _scene("sphere")
    popt = port_opt(RenderOptions(max_guided_samples=16, need_viewdir=True))
    _, pcam = _cams()
    pc, _ = P.collect_and_query(pt, pm, pcam, popt)
    res, z, ns = pc["results"], pc["z_vals"], pc["num_samples"]
    assert res.dtype == z.dtype == torch.float32 and ns.dtype == torch.int32
    assert res.is_contiguous() and z.is_contiguous() and ns.is_contiguous()
    assert res.float().contiguous().data_ptr() == res.data_ptr()
    assert z.float().contiguous().data_ptr() == z.data_ptr()
    frame = P.composite_frame(pt, pcam, popt, pc)
    other = dict(pc, results=res.transpose(0, 1).contiguous().transpose(0, 1),
                 z_vals=z.t().contiguous().t(), num_samples=ns.long())
    assert not other["results"].is_contiguous()
    assert torch.equal(P.composite_frame(pt, pcam, popt, other), frame)
