"""The turbo leaf map against the JAX package (``tests/test_accel.py:179-243``).

The rows must be array-equal to JAX's over several trees, map levels and
thresholds.  Turbo frames are held to JAX's turbo frames within 1e-5 with
equal step counts, march fewer steps than the plain map, and stay within
JAX's drift bound of the plain map's frame (2e-3: the skipped steps'
``step_size`` epsilons).  Trees keep sigma at 40 or less.
"""

import numpy as np
import pytest
import torch

import mega_nerf_viewer_tpu.n3tree as J
import mega_nerf_viewer_tpu_torch as P
from mega_nerf_viewer_tpu.camera import Camera
from mega_nerf_viewer_tpu.n3tree import N3Tree, build_host_tree
from mega_nerf_viewer_tpu.ops import accel as JA
from mega_nerf_viewer_tpu.ops.rays import rodrigues, screen2worlddir
from mega_nerf_viewer_tpu.options import RenderOptions
from mega_nerf_viewer_tpu_torch.ops import accel as PA

from test_torch_frame import port

PIX_TOL = 1e-5


def oversubdivided_tree():
    """test_accel.py:160's tree (fully subdivided to depth 3, dense only in
    a small ball) at sigma 40."""
    def depth_map(vc, d):
        return d < 3

    def data_fn(vc, size):
        out = np.zeros(4, np.float32)
        if np.linalg.norm(vc - 0.5) < 0.15:
            out[-1] = 40.0
            out[0] = 1.0
        return out

    return N3Tree.from_arrays(*build_host_tree(depth_map, data_fn, 4, 1))


TREES = {
    "over": oversubdivided_tree,
    "sphere3": lambda: J.sphere_tree(basis_dim=1, depth=3),
    "sphere5": lambda: J.sphere_tree(basis_dim=4, depth=5),
    "thin": lambda: J.sphere_tree(basis_dim=1, depth=4, sigma_inside=0.3),
}


@pytest.mark.parametrize("name", list(TREES))
@pytest.mark.parametrize("level", [None, 2])
@pytest.mark.parametrize("thresh", [1e-2, 0.5, 40.0])
def test_turbo_rows_equal(name, level, thresh):
    jt = TREES[name]()
    pt = port(jt)
    jm = JA.build_turbo_leaf_map(jt, level=level, sigma_thresh=thresh)
    pm = PA.build_turbo_leaf_map(pt, level=level, sigma_thresh=thresh)
    assert (pm.level, pm.deep_levels) == (jm.level, jm.deep_levels)
    np.testing.assert_array_equal(pm.rows.numpy(), np.asarray(jm.rows))
    # occupied cells keep their meta, empty cells only get shallower, and
    # nothing but the depth bits moves
    plain = PA.build_leaf_map(pt, level=level).rows
    meta_a, meta_b = plain[:, 1], pm.rows[:, 1]
    assert torch.equal(meta_a & ~31, meta_b & ~31)
    assert torch.equal(plain[:, 0], pm.rows[:, 0])
    assert bool(((meta_b & 31) <= (meta_a & 31)).all())


def _cams(w=20, h=20, f=26.0):
    out = []
    for cls in (Camera, P.Camera):
        cam = cls(w, h, f)
        cam.center = np.array([-1.5, 0.1, 1.4], np.float32)
        cam._update()
        out.append(cam)
    return out


@pytest.mark.parametrize("name,fewer", [("over", 0.6), ("sphere3", 1.0),
                                        ("thin", 1.0)])
def test_turbo_rays_match_jax(name, fewer):
    """render_rays_fast through the turbo map (test_accel.py:179)."""
    import jax.numpy as jnp
    jt = TREES[name]()
    pt = port(jt)
    jcam, pcam = _cams()
    opt, popt = RenderOptions(), P.RenderOptions()
    dirs, cen = screen2worlddir(jcam.width, jcam.height, jcam.fx, jcam.fy,
                                jcam.cx, jcam.cy, jnp.asarray(jcam.transform))
    vdirs = rodrigues(jnp.asarray(opt.rot_dirs, jnp.float32), dirs)
    jturbo = JA.render_rays_fast(jt, JA.build_turbo_leaf_map(jt), dirs,
                                 vdirs, cen, opt)
    pdirs = torch.as_tensor(np.array(dirs))
    pcen = torch.as_tensor(np.array(cen))
    pturbo = PA.render_rays_fast(pt, PA.build_turbo_leaf_map(pt), pdirs,
                                 pdirs, pcen, popt)
    pplain = PA.render_rays_fast(pt, PA.build_leaf_map(pt), pdirs, pdirs,
                                 pcen, popt)
    err = float(np.abs(np.asarray(jturbo.out) - pturbo.out.numpy()).max())
    assert err <= PIX_TOL, err
    np.testing.assert_array_equal(pturbo.steps.numpy(),
                                  np.asarray(jturbo.steps))
    assert int(pturbo.overflow) == int(jturbo.overflow)
    assert int(pturbo.steps.sum()) <= fewer * int(pplain.steps.sum())
    assert float((pturbo.out - pplain.out).abs().max()) <= 2e-3


def test_turbo_frame_with_skip_table_matches_jax():
    """The whole fast frame (prepass, chunks) on a turbo map."""
    from mega_nerf_viewer_tpu.ops import pallas_march as JM
    jt = J.sphere_tree(basis_dim=4, depth=5)
    pt = port(jt)
    jcam, pcam = _cams(48, 40, 40.0)
    opt, popt = RenderOptions(), P.RenderOptions()
    j = JA.render_frame_fast(jt, JA.build_turbo_leaf_map(jt), jcam, opt,
                             max_dense=16, chunk_size=256, block=16,
                             skip_table=JM.build_skip_table(jt, 1e-2))
    p = PA.render_frame_fast(pt, PA.build_turbo_leaf_map(pt), pcam, popt,
                             max_dense=16, chunk_size=256, block=16,
                             skip_table=P.build_skip_table(pt, 1e-2))
    assert float(np.abs(np.asarray(j[0]) - p[0].numpy()).max()) <= PIX_TOL
    assert int(p[1]) == int(j[1])
    np.testing.assert_array_equal(p[2].numpy(), np.asarray(j[2]))
