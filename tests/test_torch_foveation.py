"""The port's foveated Viewer frames against the JAX package's
(``tests/test_viewer.py``'s foveation cases; ``viewer.py:38-60``,
``:392-427``, ``:797-896``).

  * the foveated frames of both Viewers: within 1e-5 (``PIX_TOL``) on the
    sphere at sigma 20 (ROADMAP's CPU tolerance), parked and moving, at
    f = 2 on 64x48 and f = 4 on 66x50 (the edge pad);
  * the centre window against the f = 1 frame: within 1e-4, JAX's own test
    tolerance (``test_viewer.py:567-569``: the sub-frame's batch shape
    differs from the full frame's); the periphery f x f block-constant;
  * the guided-motion gate's flags (``_fov_motion_gated``,
    ``_fov_subs_stale``): equal to JAX's frame by frame.
"""

import numpy as np
import pytest
import torch

import mega_nerf_viewer_tpu.n3tree as J
import mega_nerf_viewer_tpu_torch as P
from mega_nerf_viewer_tpu import Viewer as JViewer
from mega_nerf_viewer_tpu import viewer as JVI
from mega_nerf_viewer_tpu.models import MegaNeRFModel as JModel
from mega_nerf_viewer_tpu.options import RenderOptions as JOptions
from mega_nerf_viewer_tpu_torch import viewer as PVI
from mega_nerf_viewer_tpu_torch.ops import accel as PA

from test_torch_exact import port
from test_torch_viewer import MODEL, PIX_TOL, _cams

CENTRE_TOL = 1e-4
CENTER = (-1.5, 0.2, 1.4)
GUIDED = dict(use_guided_sampling=True, max_guided_samples=8,
              split_batch_size=8)


def _window(W, H, f, frac=0.5):
    q = 2 * f
    w1 = max(q, int(W * frac) // q * q)
    h1 = max(q, int(H * frac) // q * q)
    x0, y0 = (W - w1) // 2, (H - h1) // 2
    return np.s_[y0:y0 + h1, x0:x0 + w1], (x0, y0, w1, h1)


def _pair(w=64, h=48, f=60.0, basis_dim=4, depth=4, model=False,
          max_cap=None, jtree=None, **opt_kw):
    jt = jtree or J.sphere_tree(basis_dim=basis_dim, depth=depth,
                                max_capacity=max_cap)
    jcam, pcam = _cams(w, h, f, CENTER)
    kw = {} if max_cap is None else dict(max_tree_capacity=max_cap)
    jv = JViewer(jt, camera=jcam, options=JOptions(**opt_kw), **kw)
    pv = P.Viewer(port(jt), camera=pcam, options=P.RenderOptions(**opt_kw),
                  device="cpu", **kw)
    if model:
        jv.model = JModel.synthetic(**MODEL)
        pv.model = P.MegaNeRFModel.synthetic(device="cpu", **MODEL)
    return jv, pv


def _frames(jv, pv, tol=PIX_TOL):
    a = np.asarray(jv.render())
    b = pv.render()
    assert b.shape == a.shape and np.isfinite(b).all()
    np.testing.assert_allclose(b, a, rtol=0, atol=tol)
    return a, b


def _blocks_constant(img, f, rows):
    """The rows ``rows`` of ``img`` are f x f block-constant."""
    W = img.shape[1] // f * f
    band = img[rows][:, :W]
    blk = band.reshape(band.shape[0] // f, f, W // f, f, 4)
    return np.array_equal(blk, np.broadcast_to(blk[:, :1, :, :1],
                                               blk.shape))


@pytest.mark.parametrize("f,w,h", [(2, 64, 48), (4, 66, 50)])
def test_foveated_frame_matches_jax(f, w, h):
    """Two parked frames, then a moved one, under the sync policy; the
    subs share the parent's maps; ``fetch=False`` is the device tensor."""
    jv, pv = _pair(w=w, h=h)
    full = pv.render()
    for v in (jv, pv):
        v.foveation = f
    for i in range(3):
        if i == 2:
            for v in (jv, pv):
                v.camera.move(np.array([0.02, 0.0, 0.0]))
        _, b = _frames(jv, pv)
        if i == 0:
            win, (x0, y0, w1, h1) = _window(w, h, f)
            np.testing.assert_allclose(b[win], full[win], rtol=0,
                                       atol=CENTRE_TOL)
            assert _blocks_constant(b, f, np.s_[:y0 // f * f])
    assert pv._fov_sub is not None
    for sub in pv._fov_sub:
        assert sub._leaf_map is pv._leaf_map
        assert sub._skip_table is pv._skip_table
        assert sub.tree is pv.tree
    (pw, ph), (cw, chh) = [(s.camera.width, s.camera.height)
                           for s in pv._fov_sub]
    assert (pw, ph) == (w // f, h // f) and (cw, chh) == (w1, h1)
    assert [s.fast_chunk_size for s in pv._fov_sub] == [
        min(pv.fast_chunk_size, max(256, a * b // 16))
        for a, b in ((pw, ph), (cw, chh))]
    img = pv.render(fetch=False)
    assert isinstance(img, torch.Tensor) and img.shape == (h, w, 4)


@pytest.mark.parametrize("w,h,f", [(64, 48, 2), (66, 50, 4), (30, 21, 4)])
def test_fov_compose_matches_jax(rng, w, h, f):
    """The upscale, the edge pad and the paste, against JAX's
    ``_fov_compose`` on the same inputs: equal."""
    win, (x0, y0, w1, h1) = _window(w, h, f)
    p = rng.rand(h // f, w // f, 4).astype(np.float32)
    c = rng.rand(h1, w1, 4).astype(np.float32)
    want = np.asarray(JVI._fov_compose(p, c, f=f, y0=y0, x0=x0, height=h,
                                       width=w))
    got = PVI._fov_compose(torch.from_numpy(p), torch.from_numpy(c), f=f,
                           y0=y0, x0=x0, height=h, width=w)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("turbo", [False, True])
def test_subs_never_rebuild_the_maps(monkeypatch, turbo):
    """The parent builds the leaf map (or the turbo map) and the skip
    table once; the subs' ``_ensure_maps`` reuse them."""
    _, pv = _pair(w=32, h=24, f=30.0)
    pv.use_turbo_map = turbo
    counts = {"leaf": 0, "turbo": 0, "skip": 0}
    for name, key in (("build_leaf_map", "leaf"),
                      ("build_turbo_leaf_map", "turbo")):
        fn = getattr(PA, name)

        def counted(*a, _fn=fn, _key=key, **kw):
            counts[_key] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(PA, name, counted)
    skip = PVI.build_skip_table

    def counted_skip(*a, **kw):
        counts["skip"] += 1
        return skip(*a, **kw)
    monkeypatch.setattr(PVI, "build_skip_table", counted_skip)
    pv.foveation = 2
    for i in range(4):
        if i == 2:
            pv.camera.move(np.array([0.02, 0.0, 0.0]))
        pv.render()
    assert counts == {"leaf": 1, "turbo": int(turbo), "skip": 1}
    assert all(s._leaf_map is pv._leaf_map for s in pv._fov_sub)


def test_foveation_is_opt_in():
    """Off by default; depth, vote and visit-tracked frames never take
    the approximate route (``test_viewer.py::test_foveated_requires_opt_in``)."""
    _, pv = _pair(w=32, h=24, f=20.0, basis_dim=1, depth=3)
    assert pv.foveation == 1 and pv._fov_sub is None
    base = pv.render()
    pv.foveation = 2
    pv.options = pv.options.replace(render_depth=True)
    assert pv.render().shape == base.shape
    assert pv._fov_sub is None
    # a vote frame (splitting with a model) is not foveated either
    _, pv = _pair(w=32, h=24, f=20.0, basis_dim=1, depth=3, model=True,
                  max_cap=2000, use_splitting=True, split_batch_size=16)
    pv.foveation = 2
    pv.render()
    assert pv._fov_sub is None
    # nor a visit-tracked frame (capacity pressure)
    _, pv = _pair(w=32, h=24, f=20.0, basis_dim=1, depth=3, model=True,
                  max_cap=80, split_batch_size=64)
    pv.foveation = 2
    pv.render()
    assert pv._fov_sub is None and pv._prune_happened


def test_tree_swap_and_edit_not_stale():
    """``set()`` drops the subs, and an edit of the tree that drops the
    parent's caches reaches them (``test_viewer.py:692-705, :778-804``)."""
    t2 = P.sphere_tree(basis_dim=1, depth=4, sigma_inside=0.0, device="cpu")
    _, pv = _pair(w=32, h=24, f=20.0, basis_dim=1, depth=4)
    pv.foveation = 2
    a = pv.render()
    subs = pv._fov_sub
    pv.set(t2)
    assert pv._fov_sub is None
    b = pv.render()
    assert pv._fov_sub is not subs
    assert b[..., 3].max() < a[..., 3].max()
    # guided: an edit that only clears _can_reuse_results
    _, pv = _pair(w=32, h=24, f=30.0, basis_dim=1, depth=4, model=True,
                  max_cap=4096, **GUIDED)
    pv.foveation = 2
    pv.render()
    a = pv.render()
    assert pv._fov_sub is not None
    pv.tree = P.sphere_tree(basis_dim=1, depth=4, sigma_inside=0.0,
                            max_capacity=4096, device="cpu")
    pv._leaf_map = None
    pv._skip_table = None
    pv._can_reuse_results = False
    b = pv.render()
    assert not np.array_equal(a, b)


def test_guided_foveated_centre_window():
    """Each sub runs its own guided pipeline: the centre window is within
    1e-4 of the exact guided frame, and a parked frame reuses the subs'
    caches (``test_viewer.py::test_foveated_guided_center_exact``)."""
    _, pv = _pair(basis_dim=1, depth=4, model=True, max_cap=4096,
                  **GUIDED)
    full = pv.render()
    pv.foveation = 2
    b = pv.render()
    assert pv._fov_sub is not None
    win, _ = _window(64, 48, 2)
    np.testing.assert_allclose(b[win], full[win], rtol=0, atol=CENTRE_TOL)
    caches = [s._guided_cache for s in pv._fov_sub]
    np.testing.assert_array_equal(pv.render(), b)
    assert [s._guided_cache for s in pv._fov_sub] == caches


def test_guided_motion_gate_matches_jax():
    """A moving guided camera is not foveated: the moved frame is the
    exact guided frame, the gate's flags equal JAX's after every frame,
    and the settled frame's centre follows the new pose
    (``test_viewer.py::test_foveation_gated_off_under_guided_motion``)."""
    jv, pv = _pair(w=32, h=24, f=30.0, basis_dim=1, depth=4, model=True,
                   max_cap=4096, **GUIDED)
    # both take the ordered collect, which gives the segmented collect's
    # frames (test_torch_viewer_guided.py::
    # test_viewer_guided_segmented_collect) and compiles fewer JAX programs
    for v in (jv, pv):
        v.use_guided_segments = False
        v.foveation = 2

    def flags(v):
        return (v._fov_motion_gated, v._fov_subs_stale)

    seen = []
    for move in (None, None, 0.15, None):
        if move:
            for v in (jv, pv):
                v.camera.move(np.array([move, 0.0, 0.0]))
        _, b = _frames(jv, pv)
        assert flags(pv) == flags(jv)
        seen.append(flags(pv))
        if move:
            moved = b
    assert seen[0] == (True, True) and seen[2] == (True, True)
    assert seen[3] == (False, False)
    win, _ = _window(32, 24, 2)
    settled = pv.render()
    np.testing.assert_allclose(settled[win], moved[win], rtol=0,
                               atol=CENTRE_TOL)
