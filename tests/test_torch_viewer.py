"""The port's Viewer against the JAX package's Viewer, side by side on one
camera script (the cases of ``tests/test_viewer.py`` that lie on the
port's path: the fast frame under the sync overflow policy, motion with
dilated hints, refinement and the prune, state and screenshots).  The
guided cases are in ``test_torch_viewer_guided.py``.

Each step renders one frame on both viewers and compares:
  * frames within 1e-5 (``PIX_TOL``; the trees are the sphere at sigma 40
    or less, ROADMAP's CPU tolerance);
  * the ray order, the segment tuples, capacity, ``_visits_valid`` and
    whether the prune fired: equal;
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


@pytest.mark.parametrize("gate", ["async", "async_rehint", "device",
                                  "foveation", "turbo", "grid", "meshes"])
def test_unported_modes_raise(gate):
    """Each mode the port leaves out raises NotImplementedError naming its
    ROADMAP item; none renders another way."""
    pv = P.Viewer(P.sphere_tree(basis_dim=1, depth=2, device="cpu"),
                  camera=_cams(8, 8, 10.0)[1], device="cpu")
    # the one overflow-policy gate names the deferred check, the device
    # fallback and the re-hint motion frame
    item = {"async": "items 4 and 8", "async_rehint": "_motion_core",
            "device": "device_fallback", "foveation": "item 9",
            "turbo": "item 8", "grid": "item 9", "meshes": "item 9"}[gate]
    if gate.startswith("async"):
        pv.overflow_policy = "async"
    elif gate == "device":
        pv.overflow_policy = "device"
    elif gate == "foveation":
        pv.foveation = 2
    elif gate == "turbo":
        pv.use_turbo_map = True
    elif gate == "grid":
        pv.options = pv.options.replace(show_grid=True)
    else:
        pv.meshes = [object()]
    with pytest.raises(NotImplementedError, match=item):
        pv.render()
    # no tree: the background frame needs none of them
    pv.clear()
    assert pv.render().shape == (8, 8, 4)
