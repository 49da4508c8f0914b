"""The port's Viewer against the JAX package's Viewer, side by side on one
camera script (the cases of ``tests/test_viewer.py`` that lie on the
port's path: the fast frame under the three overflow policies, motion with
dilated hints and with the re-hint frame, the turbo map, refinement and
the prune, state and screenshots).  The guided cases are in
``test_torch_viewer_guided.py``.

Each step renders one frame on both viewers and compares:
  * frames within 1e-5 (``PIX_TOL``; the trees are the sphere at sigma 40
    or less, ROADMAP's CPU tolerance);
  * the ray order, the segment tuples, capacity, ``_visits_valid`` and
    whether the prune fired: equal; on the motion cases also the segment
    sources, the re-hint budgets, the last CDF, the quarter order and the
    pending flags (:func:`check_motion_state`), so both viewers escalate
    on the same frame;
  * after refinement, the trees: topology and sample counts equal, data
    within one f16 ulp.  The JAX viewer draws its uniform numbers from
    ``jax.random``; the port's ``refine.expand_voxels`` and
    ``get_more_samples`` are wrapped here to take those same draws as
    ``rnd`` (:class:`JaxDraws`), and the Viewer is left as it is.
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import mega_nerf_viewer_tpu.n3tree as J
import mega_nerf_viewer_tpu_torch as P
from mega_nerf_viewer_tpu import Viewer as JViewer
from mega_nerf_viewer_tpu.camera import Camera as JCamera
from mega_nerf_viewer_tpu.models import MegaNeRFModel as JModel
from mega_nerf_viewer_tpu.n3tree import DataFormat as JDataFormat
from mega_nerf_viewer_tpu.options import RenderOptions as JOptions
from mega_nerf_viewer_tpu.utils.png import read_png as jread_png
from mega_nerf_viewer_tpu_torch import viewer as VI
from mega_nerf_viewer_tpu_torch.ops import accel as PA
from mega_nerf_viewer_tpu_torch.ops import refine as PF
from mega_nerf_viewer_tpu_torch.utils.png import read_png

from test_torch_exact import port
from test_torch_refine import assert_trees_equal

PIX_TOL = 1e-5
MODEL = dict(data_dim=4, n_clusters=4, grid_dim=(2, 2),
             min_position=(-2, -2, -2), max_position=(2, 2, 2))
CENTER = (-1.5, 0.1, 1.4)


class JaxDraws:
    """Hands the JAX viewer's uniform draws to the port's refinement: the
    JAX viewer splits its key (seeded 42) once per expand and once per
    resample; each wrapper does the same and passes the draws as ``rnd``
    in the shape JAX draws them."""

    def __init__(self, monkeypatch):
        self.key = jax.random.PRNGKey(42)
        self.expands = self.resamples = 0
        expand, resample = PF.expand_voxels, PF.get_more_samples

        def _draw(shape):
            self.key, sub = jax.random.split(self.key)
            if not shape[0]:
                return None
            return torch.tensor(np.asarray(
                jax.random.uniform(sub, shape, jnp.float32)))

        def expand_jax(tree, model, opt, split_vote, tracker, **kw):
            self.expands += 1
            K = len(PF.aggregate_split_votes(split_vote,
                                             opt.split_batch_size))
            rnd = _draw((K * tree.N3, opt.samples_per_corner, 3))
            return expand(tree, model, opt, split_vote, tracker, rnd=rnd)

        def resample_jax(tree, model, opt, sample_vote, **kw):
            self.resamples += 1
            K = len(PF.aggregate_sample_votes(sample_vote,
                                              opt.split_batch_size))
            rnd = _draw((K, opt.samples_per_corner, 3))
            return resample(tree, model, opt, sample_vote, rnd=rnd)

        monkeypatch.setattr(PF, "expand_voxels", expand_jax)
        monkeypatch.setattr(PF, "get_more_samples", resample_jax)


def _cams(w, h, f, center=CENTER):
    out = []
    for cls in (JCamera, P.Camera):
        cam = cls(w, h, f)
        cam.center = np.asarray(center, np.float32)
        out.append(cam)
    return out


def pair(depth=3, max_cap=3000, w=16, h=16, f=20.0, model=True,
         sigma_inside=None, center=CENTER, **opt_kw):
    """A JAX viewer and a port viewer (on the CPU) on the same sphere,
    camera and options; ``test_viewer.py:_viewer`` when ``model``."""
    kw = {} if sigma_inside is None else dict(sigma_inside=sigma_inside)
    jt = J.sphere_tree(basis_dim=1, depth=depth, max_capacity=max_cap, **kw)
    jcam, pcam = _cams(w, h, f, center)
    jv = JViewer(jt, camera=jcam, options=JOptions(**opt_kw),
                 max_tree_capacity=max_cap)
    pv = P.Viewer(port(jt), camera=pcam, options=P.RenderOptions(**opt_kw),
                  max_tree_capacity=max_cap, device="cpu")
    if model:
        jv.model = JModel.synthetic(**MODEL)
        pv.model = P.MegaNeRFModel.synthetic(device="cpu", **MODEL)
    return jv, pv


def _arr(a):
    if a is None:
        return None
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def check_state(jv, pv):
    """Orders, segments, capacity, visit and prune state equal."""
    assert int(jv.tree.capacity) == pv.tree.capacity
    assert jv._visits_valid == pv._visits_valid
    assert jv._prune_happened == pv._prune_happened
    jo, po = getattr(jv, "_ray_order", None), pv._ray_order
    assert (jo is None) == (po is None)
    if jo is not None:
        for a, b in zip(po, jo):
            np.testing.assert_array_equal(_arr(a), _arr(b))
    assert getattr(jv, "_segments", None) == pv._segments
    assert jv._guided_segments == pv._guided_segments
    assert jv._can_reuse_results == pv._can_reuse_results
    assert jv.fast_max_dense == pv.fast_max_dense


def step(jv, pv, tol=PIX_TOL, refined=False):
    """One frame on both viewers; frames, state (and trees) compared.
    Returns the two frames."""
    a = np.asarray(jv.render())
    b = pv.render()
    assert isinstance(b, np.ndarray) and b.shape == a.shape
    assert np.isfinite(b).all()
    err = float(np.abs(a - b).max())
    assert err <= tol, err
    check_state(jv, pv)
    if refined:
        assert_trees_equal(jv.tree, pv.tree)
        np.testing.assert_array_equal(_arr(pv._visit_tracker),
                                      _arr(jv._visit_tracker))
    return a, b


def orbit(*viewers, dx=1.5):
    for v in viewers:
        v.camera.begin_drag(0, 0, False, True)
        v.camera.drag_update(dx, 0.0)
        v.camera.end_drag()


# ----------------------------------------------------------------------
# test_viewer.py:24-101 — frames, install, resize, clear, screenshot
# ----------------------------------------------------------------------
def test_static_render():
    jv, pv = pair()
    a, b = step(jv, pv)
    assert b.shape == (16, 16, 4) and b[..., 3].max() > 0.5
    assert pv.options.basis_minmax == jv.options.basis_minmax == (0, 0)
    assert pv.get_backend() == "CPU"
    # the second frame runs the record-sorted segmented frame on the order
    # the first built; parked, the pixels stay the same
    a2, b2 = step(jv, pv)
    np.testing.assert_array_equal(b2, b)


@pytest.mark.parametrize("basis_dim", [1, 4])
def test_basis_minmax_set_on_tree_install(basis_dim):
    jt = J.sphere_tree(basis_dim=basis_dim, depth=2)
    jcam, pcam = _cams(16, 16, 20.0)
    jv = JViewer(jt, camera=jcam)
    pv = P.Viewer(port(jt), camera=pcam, device="cpu")
    assert pv.options.basis_minmax == jv.options.basis_minmax \
        == (0, basis_dim - 1)


def test_splitting_grows_tree(monkeypatch):
    draws = JaxDraws(monkeypatch)
    jv, pv = pair(use_splitting=True, split_batch_size=64)
    cap0 = pv.tree.capacity
    step(jv, pv, refined=True)
    assert pv.tree.capacity > cap0 and draws.expands == 1


def test_splitting_suppressed_while_dragging(monkeypatch):
    JaxDraws(monkeypatch)
    jv, pv = pair(use_splitting=True, split_batch_size=64)
    cap0 = pv.tree.capacity
    for v in (jv, pv):
        v.camera.begin_drag(0, 0, False, False)
    step(jv, pv)
    assert pv.tree.capacity == cap0
    for v in (jv, pv):
        v.camera.end_drag()


def test_prune_triggers_near_capacity():
    jv, pv = pair(depth=3, max_cap=None, split_batch_size=4096)
    cap0 = pv.tree.capacity
    step(jv, pv)
    assert pv._prune_happened and pv.tree.capacity <= cap0
    np.testing.assert_array_equal(pv.tree.child.numpy(),
                                  np.asarray(jv.tree.child))
    np.testing.assert_array_equal(_arr(pv._visit_tracker),
                                  _arr(jv._visit_tracker))


def test_resize_rescales_intrinsics():
    jv, pv = pair()
    for v in (jv, pv):
        v.resize(32, 48)
    assert (pv.camera.width, pv.camera.height) == (32, 48)
    for k in ("fx", "fy", "cx", "cy", "default_fx", "default_fy"):
        assert getattr(pv.camera, k) == getattr(jv.camera, k), k
    a, b = step(jv, pv)
    assert b.shape == (48, 32, 4)


def test_clear():
    jv, pv = pair()
    for v in (jv, pv):
        v.clear()
    a, b = np.asarray(jv.render()), pv.render()
    np.testing.assert_array_equal(b, a)
    np.testing.assert_allclose(b[..., :3], pv.options.background_brightness)


def test_screenshot(tmp_path):
    jv, pv = pair()
    pj, pp = str(tmp_path / "j.png"), str(tmp_path / "p.png")
    assert jv.screenshot(pj) and pv.screenshot(pp)
    a, b = jread_png(pj), read_png(pp)
    assert b.shape == (16, 16, 4)
    assert int(np.abs(a.astype(np.int16) - b).max()) <= 1


# ----------------------------------------------------------------------
# test_viewer.py:159 — a sustained refinement session with an orbit
# ----------------------------------------------------------------------
def test_sustained_refinement_session(monkeypatch):
    draws = JaxDraws(monkeypatch)
    jv, pv = pair(depth=3, max_cap=400, w=12, h=12, use_splitting=True,
                  split_batch_size=16, samples_per_corner=4)
    caps = []
    pruned = False
    for _ in range(8):
        step(jv, pv, refined=True)
        caps.append(pv.tree.capacity)
        pruned |= pv._prune_happened
        orbit(jv, pv)
    assert max(caps) > caps[0] and max(caps) <= 400
    assert draws.expands == 8
    print(f"capacities {caps}; prune fired {pruned}; "
          f"{draws.resamples} resamples")


# ----------------------------------------------------------------------
# test_viewer.py:344-463 — gates of the fast path
# ----------------------------------------------------------------------
def test_modelless_viewer_never_visit_tracks(monkeypatch):
    import mega_nerf_viewer_tpu_torch.viewer as viewer_mod
    jv, pv = pair(max_cap=None, w=12, h=12, f=16.0, model=False)
    calls = []
    orig = viewer_mod.render_frame

    def spy(*a, **k):
        calls.append(k.get("track_visit", False))
        return orig(*a, **k)
    monkeypatch.setattr(viewer_mod, "render_frame", spy)
    step(jv, pv)
    for v in (jv, pv):
        v.camera.move(np.array([0.05, 0.0, 0.0]))
    step(jv, pv)
    assert calls == []          # fast path throughout, no exact frames


def test_fast_path_gated_for_non_binary_tree():
    """An N = 3 tree takes the exact renderer; no leaf map is built."""
    n3 = 27
    data = np.zeros((1, n3, 4), np.float16)
    data[..., 3] = 5.0
    args = (data, np.zeros((1, n3), np.int32), np.zeros(1, np.int32),
            np.ones(3, np.float32) * 0.5, np.full(3, 0.25, np.float32))
    jt = J.N3Tree.from_arrays(*args, JDataFormat("SH", 1))
    pt = P.N3Tree.from_arrays(*args, P.n3tree.DataFormat("SH", 1),
                              device="cpu")
    with pytest.raises(ValueError):
        P.build_leaf_map(pt)
    jcam, pcam = _cams(8, 8, 10.0)
    jv = JViewer(jt, camera=jcam)
    pv = P.Viewer(pt, camera=pcam, device="cpu")
    a, b = step(jv, pv)
    assert b.shape == (8, 8, 4) and pv._leaf_map is None


def test_refinement_stays_on_fast_march(monkeypatch):
    import mega_nerf_viewer_tpu_torch.viewer as viewer_mod

    def _boom(*a, **k):
        raise AssertionError("exact render_frame used during splitting")

    JaxDraws(monkeypatch)
    jv, pv = pair(depth=3, max_cap=4000, w=12, h=12, use_splitting=True,
                  split_batch_size=8, samples_per_corner=4)
    monkeypatch.setattr(viewer_mod, "render_frame", _boom)
    cap0 = pv.tree.capacity
    for _ in range(4):
        step(jv, pv, refined=True)
    assert pv.tree.capacity > cap0


# ----------------------------------------------------------------------
# test_viewer.py:707-830 — budgets that settle, the dilation window
# ----------------------------------------------------------------------
def test_sync_segments_settle_heavy_recorders(monkeypatch):
    """Heavy recorders (more than 8 dense samples) settle under the sync
    policy: the CDF sizes the last class from the hint max, and parked
    frames take no second hint frame."""
    from mega_nerf_viewer_tpu_torch.ops import accel
    jt = J.sphere_tree(basis_dim=1, depth=4, sigma_inside=2.0)
    jcam, pcam = _cams(48, 36, 30.0, center=(-1.6, 0.2, 1.5))
    jv = JViewer(jt, camera=jcam)
    pv = P.Viewer(port(jt), camera=pcam, device="cpu")
    for v in (jv, pv):
        v.fast_chunk_size = 128
    step(jv, pv)
    assert max(md for _, md in pv._segments) > 8
    calls = {"rehint": 0}
    orig = accel.render_frame_fast

    def spy(*a, **k):
        if k.get("order") is None:
            calls["rehint"] += 1
        return orig(*a, **k)
    monkeypatch.setattr(accel, "render_frame_fast", spy)
    a1, b1 = step(jv, pv)
    a2, b2 = step(jv, pv)
    assert calls["rehint"] == 0
    np.testing.assert_array_equal(b1, b2)


def test_estimate_dilation_tracks_orbit():
    tree = P.sphere_tree(basis_dim=1, depth=3, device="cpu")
    jv = JViewer(J.sphere_tree(basis_dim=1, depth=3),
                 camera=JCamera(1920, 1080, 1111.0))
    pv = P.Viewer(tree, camera=P.Camera(1920, 1080, 1111.0), device="cpu")
    for v in (jv, pv):
        v.camera._update()
        assert v._estimate_dilation() == 0
        v.camera.begin_drag(0.0, 0.0, False, True)
        v.camera.drag_update(-np.deg2rad(3.0) * 1920 / 2.0, 0.0)
        v.camera.end_drag()
        v.camera._update()
    wj, wp = jv._estimate_dilation(), pv._estimate_dilation()
    assert wp == wj
    assert wp[1] == 64 and wp[0] <= 32


def test_motion_dilates_orders(monkeypatch):
    """An orbit under the sync policy: each moved frame rebuilds the order
    from dilated packed hints with headroom budgets; orders, segments and
    frames stay equal to JAX's, pose after pose."""
    jv, pv = pair(w=32, h=24, model=False, split_batch_size=16)
    for v in (jv, pv):
        v.fast_chunk_size = 128
    step(jv, pv)
    srcs = []
    for _ in range(3):
        orbit(jv, pv, dx=2.0)
        step(jv, pv)
        srcs.append(pv._segments_src)
    assert all(s[0] == "dil" for s in srcs), srcs
    assert pv._segments_src == jv._segments_src
    a, b = step(jv, pv)
    a2, b2 = step(jv, pv)
    np.testing.assert_array_equal(b, b2)


# ----------------------------------------------------------------------
# test_viewer.py:915 — sorted delivery under host_unpermute
# ----------------------------------------------------------------------
def test_host_unpermute_sorted_delivery(tmp_path):
    pt = P.sphere_tree(basis_dim=1, depth=3, device="cpu")
    v0, v1 = (P.Viewer(pt, camera=_cams(32, 32, 20.0)[1], device="cpu")
              for _ in range(2))
    v1.host_unpermute = True
    np.testing.assert_array_equal(v0.render(), v1.render())
    assert v1.frame_index_map() is None
    a = v0.render()
    b = v1.render()
    np.testing.assert_array_equal(a, b)
    assert v1.frame_index_map() is not None
    flat = v1.render(fetch=False)
    inv = v1.frame_index_map()
    assert tuple(flat.shape) == (32 * 32, 4) and inv is not None
    np.testing.assert_array_equal(flat.numpy()[inv].reshape(32, 32, 4), a)
    np.testing.assert_array_equal(v0.render_rgba8(), v1.render_rgba8())
    for v in (v0, v1):
        v.camera.center = np.array([-1.2, 0.3, 1.5], np.float32)
    np.testing.assert_array_equal(v0.render(), v1.render())
    assert v1.frame_index_map() is None
    np.testing.assert_array_equal(v0.render(), v1.render())
    assert v1.frame_index_map() is not None
    p0, p1 = str(tmp_path / "a.png"), str(tmp_path / "b.png")
    assert v0.screenshot(p0) and v1.screenshot(p1)
    np.testing.assert_array_equal(read_png(p0), read_png(p1))


# ----------------------------------------------------------------------
# the rest of the surface: input handling, state, device checks
# ----------------------------------------------------------------------
def test_key_events_and_mouse_match_jax():
    jv, pv = pair(model=False)
    for key, shift in (("W", False), ("a", True), ("E", False), ("M", False),
                       ("R", False), ("G", False), ("F", False), ("-", False),
                       ("=", False), ("3", False), ("0", False)):
        jv.key_event(key, shift)
        pv.key_event(key, shift)
    for v in (jv, pv):
        v.mouse_button("right", True, 10.0, 4.0)
        v.cursor(14.0, 7.0)
        v.mouse_button("right", False, 14.0, 7.0)
        v.scroll(-1.0)
        v.camera._update()
    np.testing.assert_array_equal(pv.camera.transform, jv.camera.transform)
    assert pv.camera.fx == jv.camera.fx
    for k in ("use_splitting", "use_guided_sampling", "grid_max_depth"):
        assert getattr(pv.options, k) == getattr(jv.options, k)


def test_save_and_load_state(tmp_path):
    jv, pv = pair(model=False)
    pv.key_event("W")
    pv.options = pv.options.replace(basis_minmax=(0, 0), step_size=2e-4)
    state, tree_path = str(tmp_path / "s.json"), str(tmp_path / "t.npz")
    pv.save_state(state, tree_path)
    v2 = P.Viewer(device="cpu")
    v2.load_state(state)
    pv.camera._update()
    assert v2.options == pv.options
    np.testing.assert_array_equal(v2.camera.transform, pv.camera.transform)
    assert v2.tree.capacity == pv.tree.capacity
    assert torch.equal(v2.tree.data[:v2.tree.capacity],
                       pv.tree.data[:pv.tree.capacity])
    # the JAX viewer resumes the same session from the port's files
    j2 = JViewer()
    j2.load_state(state)
    np.testing.assert_array_equal(np.asarray(j2.tree.child)[:v2.tree.capacity],
                                  v2.tree.child.numpy()[:v2.tree.capacity])
    a = np.asarray(j2.render())
    b = v2.render()
    assert float(np.abs(a - b).max()) <= PIX_TOL


def test_viewer_refuses_tree_on_other_device():
    tree = P.sphere_tree(basis_dim=1, depth=2, device="cpu")
    v = P.Viewer(device="cpu")
    v.set(tree)
    meta = P.tree_from_numpy(
        **{k: getattr(tree, k).numpy() for k in
           ("data", "child", "parent", "sample_counts", "scale", "offset")},
        capacity=tree.capacity, data_format=tree.data_format, device="meta")
    with pytest.raises(ValueError, match="renders on cpu"):
        v.set(meta)
    with pytest.raises(ValueError, match="renders on cpu"):
        P.Viewer(meta, device="cpu")


# ----------------------------------------------------------------------
# the moving camera: overflow policies, re-hint frames, the turbo map
# (test_viewer.py:138-420, :747-773, :843-889)
# ----------------------------------------------------------------------
def check_motion_state(jv, pv):
    """The motion episode's state equal on both viewers."""
    assert getattr(jv, "_segments_src", None) == pv._segments_src
    assert jv._segments_motion == pv._segments_motion
    assert jv._segments_motion_src == pv._segments_motion_src
    assert (jv._last_cdf is None) == (pv._last_cdf is None)
    if pv._last_cdf is not None:
        np.testing.assert_array_equal(pv._last_cdf, np.asarray(jv._last_cdf))
    assert (jv._qperm is None) == (pv._qperm is None)
    if pv._qperm is not None:
        np.testing.assert_array_equal(_arr(pv._qperm), _arr(jv._qperm))
    assert jv._clean_streak == pv._clean_streak
    jp, pp = jv._pending_ov, pv._pending_ov
    assert (jp is None) == (pp is None)
    if pp is not None:
        assert len(jp) == len(pp) and jp[0] == pp[0]
        assert tuple(jp[3:]) == tuple(pp[3:])
        np.testing.assert_array_equal(VI._host_array(pp[1]),
                                      np.asarray(jp[1]))
        if pp[2] is not None:
            assert int(VI._host_array(pp[2])) == int(np.asarray(jp[2]))


def mstep(jv, pv, tol=PIX_TOL):
    a, b = step(jv, pv, tol)
    check_motion_state(jv, pv)
    return a, b


def _exact(pv):
    cam = pv.camera
    img, _ = P.render_frame(pv.tree, cam.width, cam.height, cam.fx, cam.fy,
                            cam.cx, cam.cy, cam.transform, pv.options)
    return img.numpy()


def test_turbo_map_invalidated_on_lower_sigma_thresh():
    """test_viewer.py:138: a turbo map is kept while the threshold rises
    and rebuilt when it drops."""
    jv, pv = pair(sigma_thresh=0.5, split_batch_size=64)
    for v in (jv, pv):
        v.use_turbo_map = True
    mstep(jv, pv)
    lm1 = pv._leaf_map
    assert pv._leaf_map_turbo_thresh == jv._leaf_map_turbo_thresh == 0.5
    for v in (jv, pv):
        v.options = v.options.replace(sigma_thresh=0.8)
    mstep(jv, pv)
    assert pv._leaf_map is lm1
    for v in (jv, pv):
        v.options = v.options.replace(sigma_thresh=0.01)
    mstep(jv, pv)
    assert pv._leaf_map is not lm1
    assert pv._leaf_map_turbo_thresh == 0.01
    # switched off: the plain map again, and the frame of a plain viewer
    for v in (jv, pv):
        v.use_turbo_map = False
    a, b = mstep(jv, pv)
    assert pv._leaf_map_turbo_thresh is None
    _, plain = pair(sigma_thresh=0.01, split_batch_size=64)
    np.testing.assert_array_equal(plain.render(), b)


def _staleness_pair(policy):
    jv, pv = pair(w=32, h=32, split_batch_size=64)
    for v in (jv, pv):
        v.fast_chunk_size = 256
        v.overflow_policy = policy
    return jv, pv


def _starve(*viewers):
    for v in viewers:
        v._segments = [(0.75, 0), (0.25, 1)]
        v._pending_ov = None


def test_viewer_device_policy_keeps_frames_correct():
    """test_viewer.py:210: a frame on starved budgets is still right (the
    gated fallback march), and the next frame retunes the budgets from
    the flags."""
    jv, pv = _staleness_pair("device")
    mstep(jv, pv)
    assert pv._ray_order is not None
    _starve(jv, pv)
    a, b = mstep(jv, pv)
    # against the exact renderer: chunk shapes differ (test_viewer.py's
    # 2e-5); a truncated band would be ~1e-1
    np.testing.assert_allclose(b, _exact(pv), atol=2e-5)
    assert VI._host_array(pv._pending_ov[1]).any()
    assert int(VI._host_array(pv._pending_ov[2])) == 0
    mstep(jv, pv)                     # the deferred check fires here
    assert pv._ray_order is not None
    assert max(md for _, md in pv._segments) >= 2


def test_viewer_async_policy_recovers_next_frame():
    """test_viewer.py:232: a starved frame may be truncated, the next one
    is exact again, and clean frames keep the tuned budgets."""
    jv, pv = _staleness_pair("async")
    mstep(jv, pv)
    _starve(jv, pv)
    mstep(jv, pv)                     # transient frame (may truncate)
    assert pv._pending_ov is not None
    a, b = mstep(jv, pv)              # the deferred check fired
    assert pv._ray_order is not None
    assert max(md for _, md in pv._segments) >= 2
    np.testing.assert_allclose(b, _exact(pv), atol=2e-5)
    segs = list(pv._segments)
    mstep(jv, pv)
    assert pv._segments == segs


@pytest.mark.parametrize("policy,hroom", [("async", False), ("sync", True),
                                          ("device", True)])
def test_motion_headroom_follows_overflow_policy(policy, hroom):
    """test_viewer.py:254: the dilated episode's budgets carry one ladder
    step of headroom except under the async policy."""
    jv, pv = pair(w=32, h=24, model=False)
    for v in (jv, pv):
        v.overflow_policy = policy
        v.motion_mode = "dilate"
    mstep(jv, pv)
    assert pv._segments_src == ("steady",)
    hints_before = pv._hints_packed
    orbit(jv, pv, dx=-2.0)
    mstep(jv, pv)
    src = pv._segments_src
    assert src[0] == "dil" and src[2] is hroom, (policy, src)
    dh = PA.dilate_packed(hints_before, width=32, height=24, window=src[1])
    cdf = PA.hint_class_cdf_packed(dh).numpy()
    assert pv._segments == list(PA.segments_from_hint_cdf(
        cdf, 32 * 24, headroom=hroom))


def test_motion_rehint_exact_and_protocol(monkeypatch):
    """test_viewer.py:291: async moved frames go through the re-hint
    frame, carry the quarter order pose to pose and match the fresh
    frame; the steady budgets stay; a parked frame takes the segmented
    path on the last pose's order."""
    jv, pv = pair(w=32, h=24, model=False)
    for v in (jv, pv):
        v.overflow_policy = "async"
    assert pv.motion_mode == "rehint"
    calls = [0]
    orig = PA.render_frame_motion

    def spy(*a, **k):
        calls[0] += 1
        return orig(*a, **k)
    monkeypatch.setattr(PA, "render_frame_motion", spy)
    mstep(jv, pv)
    assert pv._segments_src == ("steady",)
    for i in range(3):
        orbit(jv, pv, dx=-2.0)
        a, b = mstep(jv, pv)
        assert calls[0] == i + 1
        ref = PA.render_frame_fast(pv.tree, pv._leaf_map, pv.camera,
                                   pv.options, max_dense=16, chunk_size=0)
        assert float(np.abs(b - ref[0].numpy()).max()) <= 1e-6
    assert pv._qperm.shape[0] * 4 == 32 * 24
    assert pv._segments_motion_src == ("rehint", 32 * 24)
    assert pv._segments_src == ("steady",)
    a, b = mstep(jv, pv)
    assert calls[0] == 3
    assert np.isfinite(b).all()


def test_motion_rehint_escalates_like_jax():
    """Re-hint poses on starved budgets: the flags read every
    motion_flag_interval frames re-derive the budgets from the measured
    CDF on the same frame on both viewers."""
    starved = [(0.9375, 0), (0.0625, 1)]
    jv, pv = pair(w=32, h=24, model=False)
    for v in (jv, pv):
        v.overflow_policy = "async"
        v.motion_flag_interval = 2
    mstep(jv, pv)
    orbit(jv, pv, dx=-3.0)
    mstep(jv, pv)
    for v in (jv, pv):
        v._segments_motion = list(starved)
    for _ in range(3):
        orbit(jv, pv, dx=-3.0)
        mstep(jv, pv)
    assert pv._segments_motion != starved
    mstep(jv, pv)


def test_async_parked_truncation_escalates():
    """test_viewer.py:747: a parked frame's band escalates at once; a
    moving frame's band within the tolerance keeps the budgets and resets
    the clean streak."""
    jv, pv = pair(w=32, h=24, model=False)
    for v in (jv, pv):
        v.overflow_policy = "async"
        v.overflow_check_interval = 1
    mstep(jv, pv)
    R = 32 * 24
    segs = [(0.5, 0), (0.5, 8)]
    for moved in (False, True):
        for v in (jv, pv):
            v._segments = list(segs)
            v._clean_streak = 5
            v._pending_ov = (list(segs), np.array([1, 0]),
                             np.asarray(False), R, moved)
            v._check_pending_overflow()
        check_state(jv, pv)
        check_motion_state(jv, pv)
        if moved:
            assert [md for _, md in pv._segments] == [0, 8]
            assert pv._clean_streak == 0
        else:
            assert pv._ray_order is None
            assert pv._segments[0][1] == 1
            mstep(jv, pv)


def test_guided_with_turbo_map_close_to_exact():
    """test_viewer.py:843: the turbo map flows into the guided collect;
    the frame equals JAX's and stays within JAX's 5e-3 of the plain map's."""
    opts = dict(use_guided_sampling=True, max_guided_samples=8,
                split_batch_size=16)
    jv, pv = pair(**opts)
    for v in (jv, pv):
        v.use_turbo_map = True
    a, b = mstep(jv, pv)
    assert pv._leaf_map_turbo_thresh is not None
    _, plain = pair(**opts)
    np.testing.assert_allclose(b, plain.render(), atol=5e-3)


@pytest.mark.parametrize("policy,turbo,guided", [
    ("sync", False, False), ("async", True, False), ("device", False, False),
    ("async", False, True), ("device", True, False)])
def test_viewer_mode_matrix_under_motion(policy, turbo, guided):
    """test_viewer.py:859 without foveation: each combination through a
    short orbit, then parked frames: the async policy may show one
    truncated parked frame and escalates on the next, so after three
    parked frames two more repeat, and (voxel frames) equal the fresh
    frame of the pose within 1e-6."""
    opts = dict(split_batch_size=16)
    if guided:
        opts.update(use_guided_sampling=True, max_guided_samples=8)
    jv, pv = pair(w=32, h=24, **opts)
    for v in (jv, pv):
        v.overflow_policy = policy
        v.use_turbo_map = turbo
        v.fast_chunk_size = 128
    for _ in range(3):
        orbit(jv, pv, dx=2.0)
        mstep(jv, pv)
    for _ in range(3):
        mstep(jv, pv)
    a, b = mstep(jv, pv)
    a2, b2 = mstep(jv, pv)
    np.testing.assert_array_equal(b, b2)
    if not guided:
        ref = PA.render_frame_fast(pv.tree, pv._leaf_map, pv.camera,
                                   pv.options, max_dense=128, chunk_size=0)
        assert float(np.abs(b - ref[0].numpy()).max()) <= 1e-6


def test_unknown_motion_mode_refused():
    pv = P.Viewer(P.sphere_tree(basis_dim=1, depth=2, device="cpu"),
                  camera=_cams(8, 8, 10.0)[1], device="cpu")
    pv.motion_mode = "predict"
    with pytest.raises(ValueError, match="motion_mode"):
        pv.render()
