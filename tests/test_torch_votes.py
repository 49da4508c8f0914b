"""The port's fast march with votes and in depth mode (kernel A's plain
version on the CPU) against the JAX package's ``accel.render_rays_fast``,
``render_frame_fast`` and ``render_frame_fast_segmented``, and against the
port's own exact march.

Tolerances, with their reasons:
  * fed JAX's own setup: split and sample votes, steps and records equal,
    rgba within 1e-6 (the step is JAX's op for op; XLA's ``exp`` may
    round an ulp apart);
  * from world directions: rgba within 1e-5 at sigma <= 40, votes equal
    on every ray whose setup is bit-equal (XLA:CPU's approximate
    ``1 / |d|``, see ``test_torch_exact.py``);
  * the fast march against the exact march on the same setup: votes and
    steps equal, rgba within 1e-6 (the JAX package claims identical
    votes, ``accel.py:376-378``);
  * frames: pixels within 1e-5, votes equal in pixel order.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import mega_nerf_viewer_tpu.n3tree as J
import mega_nerf_viewer_tpu_torch as P
from mega_nerf_viewer_tpu.camera import Camera
from mega_nerf_viewer_tpu.options import RenderOptions
from mega_nerf_viewer_tpu.ops import accel as JA
from mega_nerf_viewer_tpu_torch.ops import accel as PA
from mega_nerf_viewer_tpu_torch.ops import render as PR

from test_torch_exact import (camera, jax_setup, march_inputs_from, port,
                              port_opt, setup_equal, world_rays)

SETUP_TOL = 1e-6
PIX_TOL = 1e-5
VOTES = ("split_vote", "sample_vote")
_SCENES = {}


def _scene(name):
    if name not in _SCENES:
        jt = {"sphere": lambda: J.sphere_tree(basis_dim=4, depth=5),
              "shell": lambda: J.shell_tree(depth=6, basis_dim=9,
                                            sigma_inside=40.0)}[name]()
        pt = port(jt)
        _SCENES[name] = (jt, pt, JA.build_leaf_map(jt), PA.build_leaf_map(pt))
    return _SCENES[name]


def _fast_from_setup(pt, plm, m, max_dense, opt):
    return PA.render_rays_fast_reference(
        pt, plm, m.cen, m.d, m.invdir, m.delta_scale, m.tmin, m.tmax, m.miss,
        m.basis, m.step_size, m.sigma_thresh, m.stop_thresh, max_dense,
        m.use_sh, votes=(opt.max_depth, opt.max_sample_count),
        render_depth=m.render_depth)


@pytest.mark.parametrize("name", ["sphere", "shell"])
@pytest.mark.parametrize("max_dense,depth", [(16, False), (2, False),
                                             (16, True), (0, True)])
def test_fast_votes_from_jax_setup(name, max_dense, depth):
    jt, pt, jlm, plm = _scene(name)
    opt = RenderOptions(render_depth=depth, max_depth=6)
    jrays, _ = world_rays(camera(20, 18, 16.0), opt)
    want = JA.render_rays_fast(jt, jlm, *jrays, opt, max_dense=max_dense,
                               need_votes=True)
    m = march_inputs_from(jax_setup(jt, *jrays, opt), opt, True)
    out, ov, steps, nrec, sv, pv = _fast_from_setup(pt, plm, m, max_dense,
                                                    opt)
    err = float(np.abs(out.numpy() - np.asarray(want.out)).max())
    print(f"{name} md {max_dense} depth {depth}: rgba max abs diff "
          f"{err:.3e}, overflow {int(ov)}")
    assert err <= SETUP_TOL
    assert int(ov) == int(want.overflow)
    np.testing.assert_array_equal(steps.numpy(), np.asarray(want.steps))
    np.testing.assert_array_equal(nrec.numpy(), np.asarray(want.nrec))
    np.testing.assert_array_equal(sv.numpy(), np.asarray(want.split_vote))
    np.testing.assert_array_equal(pv.numpy(), np.asarray(want.sample_vote))
    # the votes do not depend on the record budget; rays at max_depth vote
    # no split (priority max_depth + 1 stays)
    assert (sv.numpy()[:, 0] <= opt.max_depth + 1).all()


@pytest.mark.parametrize("name", ["sphere", "shell"])
def test_fast_votes_equal_exact_votes(name):
    """Kernel A's plain version and kernel E's on the same setup."""
    jt, pt, _, plm = _scene(name)
    opt = RenderOptions()
    jrays, _ = world_rays(camera(24, 20, 18.0), opt)
    m = march_inputs_from(jax_setup(jt, *jrays, opt), opt, True)
    fast = _fast_from_setup(pt, plm, m, 64, opt)
    assert int(fast[1]) == 0
    out, sv, pv, _, steps = PR.exact_march_reference(pt, m, port_opt(opt))
    assert torch.equal(fast[4], sv) and torch.equal(fast[5], pv)
    assert torch.equal(fast[2], steps)
    assert float((fast[0] - out).abs().max()) <= SETUP_TOL


@pytest.mark.parametrize("depth", [False, True])
def test_fast_votes_from_world_dirs(depth):
    jt, pt, jlm, plm = _scene("sphere")
    opt = RenderOptions(render_depth=depth)
    jrays, prays = world_rays(camera(20, 18, 16.0), opt)
    want = JA.render_rays_fast(jt, jlm, *jrays, opt, max_dense=16,
                               need_votes=True)
    got = PA.render_rays_fast(pt, plm, *prays, port_opt(opt), max_dense=16,
                              need_votes=True)
    err = float(np.abs(got.out.numpy() - np.asarray(want.out)).max())
    eq = setup_equal(jt, pt, jrays, prays, opt)
    print(f"depth {depth}: rgba max abs diff {err:.3e}; "
          f"{int((~eq).sum())} rays with another setup")
    assert err <= PIX_TOL
    for k in VOTES:
        np.testing.assert_array_equal(getattr(got, k).numpy()[eq],
                                      np.asarray(getattr(want, k))[eq])
    assert got.split_vote.shape == (prays[0].shape[0], 3)


def _cams():
    cams = []
    for cls in (Camera, P.Camera):
        cam = cls(24, 20, 20.0)
        cam.center = np.array([-1.5, 0.1, 1.4], np.float32)
        cam._update()
        cams.append(cam)
    return cams


@pytest.mark.parametrize("depth", [False, True])
def test_vote_frames_match_jax(depth):
    """The hint frame and the segmented frame with votes: pixels and
    votes in pixel order, as JAX returns them."""
    jt, pt, jlm, plm = _scene("sphere")
    opt = RenderOptions(render_depth=depth)
    popt = port_opt(opt)
    jcam, pcam = _cams()
    j = JA.render_frame_fast(jt, jlm, jcam, opt, max_dense=16, chunk_size=64,
                             block=8, need_votes=True, return_nrec=True,
                             return_skips=True)
    p = P.render_frame_fast(pt, plm, pcam, popt, max_dense=16, chunk_size=64,
                            block=8, need_votes=True, return_nrec=True,
                            return_skips=True)
    assert len(p) == len(j) == 7
    err = float(np.abs(p[0].numpy() - np.asarray(j[0])).max())
    print(f"hint frame (depth {depth}): max abs diff {err:.3e}")
    assert err <= PIX_TOL
    for a, b in zip(p[2:], j[2:]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    order = P.order_from_hints(p[2], p[5], p[6])
    jorder = JA.order_from_hints(j[2], j[5], j[6])
    segs = ((0.5, 2), (0.5, 16))
    js = JA.render_frame_fast_segmented(jt, jlm, jcam, opt, order=jorder,
                                        segments=segs, chunk_size=64,
                                        need_votes=True)
    ps = P.render_frame_fast_segmented(pt, plm, pcam, popt, order=order,
                                       segments=segs, chunk_size=64,
                                       need_votes=True)
    assert len(ps) == len(js) == 4
    err = float(np.abs(ps[0].numpy() - np.asarray(js[0])).max())
    print(f"segmented frame (depth {depth}): max abs diff {err:.3e}")
    assert err <= PIX_TOL
    np.testing.assert_array_equal(ps[1].numpy(), np.asarray(js[1]))
    for a, b, c in zip(ps[2:], js[2:], p[3:5]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        # the segmented frame's votes, unpermuted, are the hint frame's
        assert torch.equal(a, c)


def test_segmented_vote_frame_hints_follow_votes():
    """With votes and hints the segmented frame returns (img, flags,
    split_vote, sample_vote, steps, nrec, skips)."""
    _, pt, _, plm = _scene("sphere")
    _, pcam = _cams()
    popt = P.RenderOptions()
    h = P.render_frame_fast(pt, plm, pcam, popt, max_dense=16, chunk_size=64,
                            block=8, need_votes=True, return_nrec=True,
                            return_skips=True)
    order = P.order_from_hints(h[2], h[5], h[6])
    s = P.render_frame_fast_segmented(pt, plm, pcam, popt, order=order,
                                      segments=((1.0, 16),), chunk_size=64,
                                      need_votes=True, return_hints=True)
    assert len(s) == 7
    for a, b in zip(s[2:4], h[3:5]):
        assert torch.equal(a, b)
    for a, b in zip(s[4:], (h[2], h[5], h[6])):
        assert torch.equal(a, b)
