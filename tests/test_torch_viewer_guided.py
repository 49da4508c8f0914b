"""The port's Viewer in guided-sampling mode against the JAX package's
Viewer, side by side on one camera script (``tests/test_viewer.py:64``,
``:367``, ``:406``, ``:463``, ``:507``, ``:830``, ``:890``), plus depth
mode on the compact cache and the composited-image cache.

Comparisons and tolerances are those of ``test_torch_viewer.py``: frames
within 1e-5, guided segments, orders, capacity, visit and prune state
equal, refined trees within one f16 ulp given JAX's uniform draws.
"""

import numpy as np
import torch

import mega_nerf_viewer_tpu.n3tree as J
import mega_nerf_viewer_tpu_torch as P
from mega_nerf_viewer_tpu import Viewer as JViewer
from mega_nerf_viewer_tpu.models import MegaNeRFModel as JModel
from mega_nerf_viewer_tpu.options import RenderOptions as JOptions
from mega_nerf_viewer_tpu_torch import kernels
from mega_nerf_viewer_tpu_torch.ops import guided as PG

from test_torch_exact import port
from test_torch_viewer import (MODEL, PIX_TOL, JaxDraws, _arr, _cams, orbit,
                               pair, step)

WIDE = dict(w=16, h=16, f=7.0, center=(-1.6, 0.2, 1.5))


def _guided_pair(**opt_kw):
    """``test_viewer.py:375-388``'s viewer: a wide field of view (many rays
    miss), S = 8, a split batch below the capacity headroom."""
    kw = dict(use_guided_sampling=True, max_guided_samples=8,
              split_batch_size=8)
    kw.update(opt_kw)
    return pair(**WIDE, **kw)


def test_guided_cache_invalidated_on_camera_move():
    jv, pv = pair(use_guided_sampling=True, max_guided_samples=8,
                  split_batch_size=16)
    step(jv, pv)
    assert pv._can_reuse_results
    cache1 = pv._guided_cache
    img1 = pv._guided_img_cache[1]
    step(jv, pv)
    assert pv._guided_cache is cache1              # reused
    assert pv._guided_img_cache[1] is img1         # and so is the image
    for v in (jv, pv):
        v.camera.move(np.array([0.1, 0, 0]))
    step(jv, pv)
    assert pv._guided_cache is not cache1          # recomputed


def test_viewer_guided_segmented_collect():
    """The port's Viewer always takes the segmented collect: its frames,
    orders and ladders equal the JAX Viewer's, the steady classes start
    with a zero budget, and the frames equal those of JAX's ordered
    collect (``use_guided_segments`` off).  The port's ordered collect,
    called directly on the same order, composites the same frame."""
    jv, pv = _guided_pair()
    jo = _guided_pair()[0]
    jo.use_guided_segments = False
    step(jv, pv)
    assert pv._guided_segments[0][1] == 0
    assert pv._guided_segments[0][0] > 1.0 / 16.0
    np.testing.assert_allclose(np.asarray(jo.render()), pv.render(),
                               rtol=0, atol=PIX_TOL)
    for v in (jv, pv, jo):
        v.camera.move(np.array([0.05, 0.0, 0.0]))
    img = step(jv, pv)[1]
    np.testing.assert_allclose(np.asarray(jo.render()), img, rtol=0,
                               atol=PIX_TOL)
    np.testing.assert_array_equal(_arr(pv._guided_order[0]),
                                  _arr(jo._guided_order[0]))
    cam, opt = pv.camera, pv.options
    frames = []
    for segs in (None, pv._guided_segments):
        cache = PG.collect_and_query_fast(
            pv.tree, pv._leaf_map, pv.model, cam, opt,
            chunk_size=pv.fast_chunk_size, skip_table=pv._skip_table,
            order=pv._guided_order, segments=segs)
        frames.append(_arr(PG.composite_frame(pv.tree, cam, opt, cache)))
    np.testing.assert_array_equal(frames[0], frames[1])
    np.testing.assert_array_equal(frames[1], img)


def test_guided_cache_rebuilt_when_splitting_toggled_on(monkeypatch):
    JaxDraws(monkeypatch)
    jv, pv = pair(use_guided_sampling=True, use_splitting=False,
                  split_batch_size=16, max_guided_samples=8)
    step(jv, pv)
    assert pv._can_reuse_results
    for v in (jv, pv):
        v.key_event("M")
    cap0 = pv.tree.capacity
    step(jv, pv, refined=True)
    assert pv.tree.capacity >= cap0


def test_guided_motion_no_ladder_rewalk(monkeypatch):
    """Under motion the settled segment ladder persists: one collect per
    pose once settled, the same ladder as JAX's."""
    calls = []
    depth = [0]
    orig = PG.collect_t_fast

    def counting(*a, **kw):
        # count the invalidation's collects, not the ordered collect's own
        # inner call for a frame of fewer chunks than classes
        if depth[0] == 0:
            calls.append(kw.get("segments"))
        depth[0] += 1
        try:
            return orig(*a, **kw)
        finally:
            depth[0] -= 1
    monkeypatch.setattr(PG, "collect_t_fast", counting)
    jv, pv = _guided_pair()
    step(jv, pv)
    segs_seen = []
    for i in range(4):
        for v in (jv, pv):
            v.camera.move(np.array([0.01, 0.0, 0.0]))
        calls.clear()
        step(jv, pv)
        segs_seen.append(pv._guided_segments)
        if i >= 2:
            assert len(calls) == 1, f"pose {i}: {len(calls)} collects"
    assert segs_seen[-1] == segs_seen[-2]


def test_prune_requires_tracked_visits(monkeypatch):
    jv, pv = _guided_pair(split_batch_size=4096)
    cap0 = pv.tree.capacity
    step(jv, pv)
    for _ in range(3):
        for v in (jv, pv):
            v.camera.move(np.array([0.01, 0.0, 0.0]))
        step(jv, pv)
    assert pv.tree.capacity > 1
    np.testing.assert_array_equal(_arr(pv._visit_tracker),
                                  _arr(jv._visit_tracker))
    # no pressure: capacity untouched
    jv2, pv2 = _guided_pair()
    step(jv2, pv2)
    for v in (jv2, pv2):
        v.camera.move(np.array([0.01, 0.0, 0.0]))
    step(jv2, pv2)
    assert pv2.tree.capacity == cap0


def test_prune_invalidates_guided_cache():
    jv, pv = pair(use_guided_sampling=True, max_guided_samples=8)
    step(jv, pv)
    assert pv._prune_happened
    assert pv._guided_cache is None and not pv._can_reuse_results


def test_guided_plus_splitting_session(monkeypatch):
    draws = JaxDraws(monkeypatch)
    jv, pv = pair(depth=3, max_cap=3000, w=16, h=12,
                  use_guided_sampling=True, use_splitting=True,
                  max_guided_samples=8, split_batch_size=16,
                  samples_per_corner=4)
    cap0 = pv.tree.capacity
    for _ in range(3):
        step(jv, pv, refined=True)
        orbit(jv, pv)
    assert pv.tree.capacity > cap0 and draws.expands == 3
    a, b = step(jv, pv, refined=True)
    assert np.isfinite(b).all()


def test_guided_depth_frame_on_compact_cache():
    """Depth mode on the compact guided cache (kernel D's depth branch on
    the card): the Viewer's frame equals JAX's, and toggling depth reuses
    the cache (only the composite reruns)."""
    jv, pv = _guided_pair()
    step(jv, pv)
    cache = pv._guided_cache
    assert "results_c" in cache[0]
    for v in (jv, pv):
        v.options = v.options.replace(render_depth=True)
    a, b = step(jv, pv)
    assert pv._guided_cache is cache
    assert (b[..., 3] == 1).all()
    assert np.allclose(b[..., 0], b[..., 1]) and float(b[..., 0].max()) > 0
    # moved: a fresh ordered (and segmented) collect, composited in depth
    for v in (jv, pv):
        v.camera.move(np.array([0.02, 0.0, 0.0]))
    step(jv, pv)
    assert "order_inv" in pv._guided_cache[0]
    assert kernels.LAUNCHES["compact_composite_depth"] == 0   # the CPU
