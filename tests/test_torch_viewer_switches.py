"""The port's Viewer execution switches against the JAX package's Viewer
with the same switch set (``viewer.py:101-197``), side by side on one
camera script at 32x24 on the sphere (sigma 40 or less):

  * ``use_prepass`` off: the leaf-map frames march from ``tmin`` and the
    prepass never runs; pixels, orders, segments and packed hints (skips
    0) equal JAX's, and the pixels equal the port's prepass frames;
  * ``use_fast_path`` off: static frames take the exact renderer and
    guided invalidations the exact collect;
  * ``use_guided_segments`` off: one ordered collect per invalidation,
    caches and frames equal to JAX's;
  * ``use_dynamic_knobs`` off and ``use_pallas_composite=False``: the frame
    equals JAX's and the port's default frame;
  * foveation at f = 2 with the prepass off: the subs take the parent's
    switches and the frame equals JAX's.

``use_device_order`` is in ``test_torch_viewer_switches_order.py``.
Comparisons are ``test_torch_viewer.py``'s: frames within 1e-5, integer
state equal.
"""

import numpy as np
import pytest

from mega_nerf_viewer_tpu_torch import viewer as VI
from mega_nerf_viewer_tpu_torch.ops import accel as PA
from mega_nerf_viewer_tpu_torch.ops import guided as PG

from test_torch_guided import _compare_caches
from test_torch_viewer import PIX_TOL, _arr, orbit, pair, step
from test_torch_viewer_guided import _guided_pair

SWITCHES = ("use_fast_path", "use_dynamic_knobs", "use_pallas_composite",
            "use_prepass", "use_device_order", "use_guided_segments")


def _set(viewers, **switches):
    for v in viewers:
        for k, val in switches.items():
            setattr(v, k, val)


def _voxel_pair(**switches):
    """The model-less 32x24 sphere pair at chunk 128 (six chunks, so the
    segmented frame has its classes)."""
    jv, pv = pair(w=32, h=24, model=False, depth=4, sigma_inside=40.0)
    _set((jv, pv), fast_chunk_size=128, **switches)
    return jv, pv


def _count(monkeypatch, module, name):
    """Calls of ``module.name`` from now on."""
    calls = []
    orig = getattr(module, name)

    def spy(*a, **kw):
        calls.append(kw)
        return orig(*a, **kw)
    monkeypatch.setattr(module, name, spy)
    return calls


def test_switch_defaults_equal_jax():
    jv, pv = pair(model=False)
    for k in SWITCHES:
        assert getattr(pv, k) == getattr(jv, k), k


def test_prepass_off_matches_jax(monkeypatch):
    """A hint frame, a parked frame, a moved frame and a parked one: the
    prepass never runs, the hints' skip field is 0 and equal to JAX's, and
    every frame equals the prepass-on port Viewer's bit for bit."""
    jv, pv = _voxel_pair(use_prepass=False)
    _, ref = _voxel_pair()
    prepass = _count(monkeypatch, PA, "entry_skip_prepass")
    for i in range(4):
        if i == 2:
            orbit(jv, pv, ref, dx=2.0)
        n = len(prepass)
        _, b = step(jv, pv)
        assert len(prepass) == n, "the prepass ran with use_prepass off"
        np.testing.assert_array_equal(b, ref.render())
        assert pv._skip_table is None and pv._ensure_maps() is None
        ph = _arr(pv._hints_packed)
        np.testing.assert_array_equal(ph, _arr(jv._hints_packed))
        assert not (ph & 511).any()
    assert pv._segments_src == jv._segments_src


def test_fast_path_off_takes_exact_routes(monkeypatch):
    """A static frame and a moved one through the exact renderer, then a
    guided first frame and stop through the exact collect."""
    exact = _count(monkeypatch, VI, "render_frame")
    jv, pv = _voxel_pair(use_fast_path=False)
    step(jv, pv)
    orbit(jv, pv, dx=2.0)
    step(jv, pv)
    assert len(exact) == 2 and pv._leaf_map is None
    assert pv._ray_order is None
    collect = _count(monkeypatch, PG, "collect_and_query")
    fast = _count(monkeypatch, PG, "collect_and_query_fast")
    jv, pv = _guided_pair()
    _set((jv, pv), use_fast_path=False)
    step(jv, pv)
    for v in (jv, pv):
        v.key_event("W")
    step(jv, pv)
    assert len(collect) == 2 and not fast
    np.testing.assert_array_equal(
        _arr(pv._guided_cache[0]["num_samples"]),
        _arr(jv._guided_cache[0]["num_samples"]))


def test_guided_segments_off_matches_jax(monkeypatch):
    """Two invalidations (the first frame and a moved stop): one ordered
    collect each, no ladder, caches and frames equal to JAX's."""
    calls = []
    depth = [0]
    orig = PG.collect_t_fast

    def counting(*a, **kw):
        if depth[0] == 0:
            calls.append(kw.get("segments"))
        depth[0] += 1
        try:
            return orig(*a, **kw)
        finally:
            depth[0] -= 1
    monkeypatch.setattr(PG, "collect_t_fast", counting)
    jv, pv = _guided_pair()
    _set((jv, pv), use_guided_segments=False)
    step(jv, pv)
    for v in (jv, pv):
        v.camera.move(np.array([0.05, 0.0, 0.0]))
    step(jv, pv)
    assert calls == [None, None]
    assert pv._guided_segments is None and jv._guided_segments is None
    _compare_caches(jv._guided_cache[0], pv._guided_cache[0])
    np.testing.assert_array_equal(_arr(pv._guided_order[0]),
                                  _arr(jv._guided_order[0]))


@pytest.mark.parametrize("switch,value,guided", [
    ("use_dynamic_knobs", False, False),
    ("use_pallas_composite", False, True)])
def test_inert_switches_match_jax(switch, value, guided):
    """Neither switch changes a pixel: the frame equals JAX's with the
    same switch and the port's default frame; the composite switch keys
    the guided image cache."""
    # the voxel frame at 16x16 in one chunk: JAX compiles its two frames
    # again for dynamic_knobs=False, and one chunk compiles fastest
    jv, pv = _guided_pair() if guided else pair(model=False)
    _, ref = _guided_pair() if guided else pair(model=False)
    a, b = step(jv, pv)
    _set((jv, pv), **{switch: value})
    a2, b2 = step(jv, pv)
    np.testing.assert_array_equal(b2, b)
    np.testing.assert_array_equal(b2, ref.render())
    if guided:
        assert pv._guided_img_cache[0][-1] is value


def test_foveated_prepass_off_matches_jax(monkeypatch):
    """f = 2: the subs copy the parent's use_prepass, use_dynamic_knobs and
    use_pallas_composite every frame, the prepass never runs, and the
    frame equals JAX's."""
    prepass = _count(monkeypatch, PA, "entry_skip_prepass")
    jv, pv = pair(w=32, h=24, f=30.0, model=False, depth=4,
                  sigma_inside=20.0)
    _set((jv, pv), foveation=2, use_prepass=False, use_dynamic_knobs=False,
         use_pallas_composite=False)
    for i in range(2):
        a = np.asarray(jv.render())
        b = pv.render()
        np.testing.assert_allclose(b, a, rtol=0, atol=PIX_TOL)
        for js, ps in zip(jv._fov_sub, pv._fov_sub):
            for k in ("use_prepass", "use_dynamic_knobs",
                      "use_pallas_composite"):
                assert getattr(ps, k) == getattr(js, k) == getattr(pv, k)
            np.testing.assert_array_equal(_arr(ps._ray_order[0]),
                                          _arr(js._ray_order[0]))
    assert not prepass
    _set((jv, pv), use_prepass=True)
    _, b = np.asarray(jv.render()), pv.render()
    assert [s.use_prepass for s in pv._fov_sub] == [True, True]
    assert prepass
