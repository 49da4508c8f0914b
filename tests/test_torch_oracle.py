"""The port's scalar oracle (``ops/oracle.py``) against the JAX package's.

``trace_ray`` on the same rays: votes and visited chunks equal, rgba within
1e-6 (the SH basis comes from each package's own ``eval_sh_basis``).
``render_image``, whose rays come from each package's ray generation:
within 1e-5 (ROADMAP's CPU tolerance)."""

import numpy as np
import pytest

import mega_nerf_viewer_tpu.n3tree as J
from mega_nerf_viewer_tpu.camera import Camera as JCamera
from mega_nerf_viewer_tpu.n3tree import DataFormat as JDataFormat
from mega_nerf_viewer_tpu.ops import oracle as JO
from mega_nerf_viewer_tpu.options import RenderOptions as JOptions
import mega_nerf_viewer_tpu_torch as P
from mega_nerf_viewer_tpu_torch.ops import oracle as PO

from test_torch_exact import port, port_opt

RAY_TOL = 1e-6
PIX_TOL = 1e-5

_CASES = {
    "sphere_sh4": (lambda: J.sphere_tree(basis_dim=4, depth=4), {}),
    "random_n3": (lambda: J.random_tree(n_chunks=40, basis_dim=4, seed=5,
                                        density=1.0, N=3), {}),
    "depth": (lambda: J.sphere_tree(basis_dim=1, depth=4),
              dict(render_depth=True)),
    "bbox_rot": (lambda: J.sphere_tree(basis_dim=9, depth=3),
                 dict(render_bbox=(0.1, 0.0, 0.0, 1.0, 0.8, 1.0),
                      rot_dirs=(0.1, -0.2, 0.05), basis_minmax=(1, 6))),
}


def _case(name):
    make, kw = _CASES[name]
    return make(), JOptions(**kw)


@pytest.mark.parametrize("name", sorted(_CASES))
def test_trace_ray_matches_jax(rng, name):
    jt, opt = _case(name)
    popt = port_opt(opt)
    jh, ph = JO.tree_to_host(jt), PO.tree_to_host(port(jt))
    for k in ("data", "child", "sample_counts", "scale", "offset"):
        np.testing.assert_array_equal(ph[k], jh[k])
    cen = np.array([-1.5, 0.1, 1.4], np.float32)
    target = rng.uniform(-0.3, 0.3, (24, 3)).astype(np.float32)
    dirs = target - cen
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    vdirs = dirs[::-1].copy()
    hit = 0
    for i in range(len(dirs)):
        want = JO.trace_ray(jh, dirs[i], vdirs[i], cen, opt, tmax_bg=2.2)
        got = PO.trace_ray(ph, dirs[i], vdirs[i], cen, popt, tmax_bg=2.2)
        np.testing.assert_allclose(got[0], want[0], rtol=0, atol=RAY_TOL)
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[2], want[2])
        assert got[3] == want[3]
        hit += want[0][3] > 0
    assert hit > 4


@pytest.mark.parametrize("name", ["sphere_sh4", "random_n3"])
def test_render_image_matches_jax(name):
    jt, opt = _case(name)
    cams = []
    for cls in (JCamera, P.Camera):
        cam = cls(12, 10, 12.0)
        cam.center = np.array([-1.5, 0.1, 1.4], np.float32)
        cam._update()
        cams.append(cam)
    want = JO.render_image(jt, cams[0], opt)
    got = PO.render_image(port(jt), cams[1], port_opt(opt))
    assert got.shape == (10, 12, 4) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=PIX_TOL)
    assert want[..., 3].max() > 0.5


def test_oracle_matches_port_exact_frame():
    """The port's exact frame against its own oracle
    (``test_render.py::test_oracle_full_image``'s check)."""
    jt = J.sphere_tree(basis_dim=4, depth=4)
    pt = port(jt)
    cam = P.Camera(12, 10, 12.0)
    cam.center = np.array([-1.5, 0.1, 1.4], np.float32)
    cam._update()
    opt = P.RenderOptions()
    want = PO.render_image(pt, cam, opt)
    got, _ = P.render_frame(pt, 12, 10, cam.fx, cam.fy, cam.cx, cam.cy,
                            cam.transform, opt)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=PIX_TOL)


def test_rgba_format_tree():
    """An RGBA-format tree (no SH basis) through both oracles."""
    t = J.random_tree(n_chunks=40, basis_dim=4, seed=5)
    jt = J.N3Tree.from_arrays(
        np.asarray(t.data), np.asarray(t.child), np.asarray(t.parent),
        np.asarray(t.scale), np.asarray(t.offset),
        JDataFormat(format="RGBA", basis_dim=-1))
    opt = JOptions()
    jh, ph = JO.tree_to_host(jt), PO.tree_to_host(port(jt))
    cen = np.array([-1.5, 0.1, 1.4], np.float32)
    d = -cen / np.linalg.norm(cen)
    want = JO.trace_ray(jh, d, d, cen, opt)
    got = PO.trace_ray(ph, d, d, cen, port_opt(opt))
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=RAY_TOL)
    np.testing.assert_array_equal(got[1], want[1])
