"""``Viewer.use_device_order`` off in the port against the JAX Viewer with
the same switch (``viewer.py:588-780``, ``:1100``), side by side on one
camera script under the sync policy at 32x24 on the sphere (sigma 40): the
hint frame's order is sorted on the host from hints fetched there and
uploaded, a moved camera keeps the stale order and budgets until a segment
overflows and the sync redo re-hints.  Frames within 1e-5; after each
pose the orders, segments and redo counts equal JAX's.  (A file of its
own: each escalated segment tuple is a JAX compile.)
"""

from mega_nerf_viewer_tpu.ops import accel as JA
from mega_nerf_viewer_tpu_torch.ops import accel as PA

from test_torch_viewer import orbit, pair, step
from test_torch_viewer_switches import _count, _set


def test_device_order_off_matches_jax(monkeypatch):
    """Three orbit poses under the sync policy: the order is sorted on the
    host from the hint frame's hints and kept stale across moves; after
    each pose the orders, segments and sync redos (hint frames) equal
    JAX's, and no order is built on the device."""
    jhost = _count(monkeypatch, JA, "order_from_hints")
    host = _count(monkeypatch, PA, "order_from_hints")
    device = _count(monkeypatch, PA, "order_from_packed_device")
    # a wide field of view: two segment tuples in all, each a JAX compile
    jv, pv = pair(w=32, h=24, f=12.0, model=False, depth=4,
                  sigma_inside=40.0)
    _set((jv, pv), fast_chunk_size=128, use_device_order=False)
    step(jv, pv)
    step(jv, pv)
    assert len(host) == len(jhost) >= 1
    redos = []
    for _ in range(3):
        orbit(jv, pv, dx=3.0)
        n = len(host)
        step(jv, pv)
        redos.append(len(host) - n)
        assert len(host) == len(jhost)
        assert pv._hints_packed is None and jv._hints_packed is None
        assert pv._segments_src is None
    assert not device
    assert sum(redos) >= 1, redos
    print(f"sync redos per pose {redos}; segments {pv._segments}")
