"""Hint packing, budget classes, motion dilation and device orders in the
port (``ops/accel.py``) against the JAX package (``accel.py:880-1228``), on
seeded random hints, and the ``return_hints="packed"`` frame.

Everything here is integer or host arithmetic, so every result must be
equal: packed values, CDFs, segment tuples, dilated hints and the
permutations of the stable sorts.  The packed frame's hints must equal
``pack_hints`` of the same frame's three hint arrays and JAX's packed
hints on the 64x64 sphere frame (steps, records and skips were equal on
every ray of it in ``test_torch_frame.py``).
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
from mega_nerf_viewer_tpu.ops import pallas_march as JM
from mega_nerf_viewer_tpu_torch.ops import accel as PA

from test_torch_exact import port

W, H = 24, 20


def _hints(seed, n=W * H, nrec_max=20, steps_max=700, skips_max=600):
    rng = np.random.RandomState(seed)
    steps = rng.randint(0, steps_max, n).astype(np.int32)
    nrec = rng.randint(0, nrec_max, n).astype(np.int32)
    nrec[rng.rand(n) < 0.5] = 0                 # half the rays record none
    skips = rng.randint(0, skips_max, n).astype(np.int32)
    return steps, nrec, skips


def _t(*arrays):
    return [torch.as_tensor(a) for a in arrays]


def _eq(p, j):
    np.testing.assert_array_equal(p.numpy(), np.asarray(j))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pack_hints_and_packed_order(seed):
    steps, nrec, skips = _hints(seed, nrec_max=300)
    pj = JA.pack_hints(steps, nrec, skips)
    pp = PA.pack_hints(*_t(steps, nrec, skips))
    assert pp.dtype == torch.int32
    _eq(pp, pj)
    _eq(PA.pack_hints(*_t(steps, nrec), None), JA.pack_hints(steps, nrec,
                                                             None))
    oj = JA.order_from_packed_device(pj)
    op = PA.order_from_packed_device(pp)
    _eq(op[0], oj[0])
    _eq(op[1], oj[1])


@pytest.mark.parametrize("classes", [(0, 1, 2, 4, 8), (0, 1, 2, 4, 8, 16),
                                     (0, 1, 2, 4, 8, 16, 32)])
def test_hint_class_cdfs(classes):
    steps, nrec, skips = _hints(3, nrec_max=40)
    _eq(PA.hint_class_cdf(torch.as_tensor(nrec), classes),
        JA.hint_class_cdf(jnp.asarray(nrec), classes))
    ph = JA.pack_hints(steps, nrec, skips)
    _eq(PA.hint_class_cdf_packed(torch.as_tensor(np.asarray(ph)), classes),
        JA.hint_class_cdf_packed(ph, classes))
    assert PA.class_ladder(32) == JA.class_ladder(32)


@pytest.mark.parametrize("hint_max", [4, 8, 18, 300])
@pytest.mark.parametrize("headroom,margin,top_headroom", [
    (False, 0, False), (True, 0, False), (False, 1, False),
    (False, 0, True), (True, 1, True), (False, 2, False)])
def test_segments_from_hint_cdf_equal(hint_max, headroom, margin,
                                      top_headroom):
    R = 4096
    rng = np.random.RandomState(hint_max)
    for classes in ((0, 1, 2, 4, 8), JA.class_ladder(32)):
        nrec = np.minimum(rng.geometric(0.35, R) - 1, hint_max)
        nrec[0] = hint_max
        cdf = np.asarray(JA.hint_class_cdf(jnp.asarray(nrec, jnp.int32),
                                           classes))
        kw = dict(classes=classes, headroom=headroom, margin=margin,
                  top_headroom=top_headroom)
        for c in (cdf, cdf[:-1]):                # with and without the max
            want = JA.segments_from_hint_cdf(c, R, **kw)
            assert PA.segments_from_hint_cdf(c, R, **kw) == want
            assert PA.segments_from_hint_cdf(torch.as_tensor(c), R,
                                             **kw) == want
            assert abs(sum(f for f, _ in want) - 1.0) < 1e-9


@pytest.mark.parametrize("window", [8, (8, 16), (16, 32), (2, 64), 1])
def test_dilations_equal(window):
    steps, nrec, skips = _hints(5)
    assert PA._axis_windows(window) == JA._axis_windows(window)
    kw = dict(width=W, height=H, window=window)
    js = JA.dilate_hints(steps, nrec, skips, **kw)
    ps = PA.dilate_hints(*_t(steps, nrec, skips), **kw)
    for a, b in zip(ps, js):
        _eq(a, b)
    js2 = JA.dilate_hints(steps, nrec, **kw)
    ps2 = PA.dilate_hints(*_t(steps, nrec), **kw)
    assert ps2[2] is None and js2[2] is None
    _eq(ps2[1], js2[1])
    ph = JA.pack_hints(steps, nrec, skips)
    dp = PA.dilate_packed(torch.as_tensor(np.asarray(ph)), **kw)
    _eq(dp, JA.dilate_packed(ph, **kw))
    # the nrec field of the pooled packed value is the window's nrec max
    _eq(dp >> 18, np.minimum(np.asarray(js[1]), 255))


@pytest.mark.parametrize("seed", [0, 7])
def test_device_orders_equal(seed):
    steps, nrec, skips = _hints(seed, nrec_max=80, steps_max=5000)
    for args in ((steps, nrec, skips), (steps, nrec)):
        oj = JA.order_from_hints_device(*args)
        op = PA.order_from_hints_device(*_t(*args))
        _eq(op[0], oj[0])
        _eq(op[1], oj[1])
    oj = JA.order_from_ns_steps_device(nrec, steps)
    op = PA.order_from_ns_steps_device(*_t(nrec, steps))
    _eq(op[0], oj[0])
    _eq(op[1], oj[1])
    # the host order of the port sorts by the same three-part key
    _eq(PA.order_from_hints(*_t(steps, nrec, skips))[0],
        PA.order_from_hints_device(*_t(steps, nrec, skips))[0])


def _camera(cls, w=64, h=64):
    cam = cls(w, h, 1111.0 * w / 1920)
    cam.center = np.array([-1.4, 0.1, 1.3], np.float32)
    cam._update()
    return cam


@pytest.fixture(scope="module")
def scene():
    jt = J.sphere_tree(basis_dim=4, depth=5)
    pt = port(jt)
    return dict(jt=jt, pt=pt, jlm=JA.build_leaf_map(jt),
                plm=PA.build_leaf_map(pt),
                jtab=JM.build_skip_table(jt, 1e-2),
                ptab=P.build_skip_table(pt, 1e-2))


@pytest.mark.parametrize("cs", [256, 2048])
def test_packed_frame_hints(scene, cs):
    """``return_hints="packed"``: one array equal to ``pack_hints`` of the
    three-array hints, and to JAX's packed hints; the frame is unchanged.
    cs 2048 has fewer chunks than classes (the one-march path)."""
    s = scene
    order = PA.block_permutation(64, 64, 16, device="cpu")
    jorder = JA.block_permutation(64, 64, 16)
    segs = ((0.5, 2), (0.25, 8), (0.25, 16))
    kw = dict(segments=segs, chunk_size=cs)
    three = PA.render_frame_fast_segmented(
        s["pt"], s["plm"], _camera(P.Camera), P.RenderOptions(),
        order=order, skip_table=s["ptab"], return_hints=True, **kw)
    packed = PA.render_frame_fast_segmented(
        s["pt"], s["plm"], _camera(P.Camera), P.RenderOptions(),
        order=order, skip_table=s["ptab"], return_hints="packed", **kw)
    assert len(packed) == 3
    assert torch.equal(packed[0], three[0])
    assert torch.equal(packed[1], three[1])
    assert torch.equal(packed[2], PA.pack_hints(*three[2:]))
    j = JA.render_frame_fast_segmented(
        s["jt"], s["jlm"], _camera(Camera), RenderOptions(), order=jorder,
        skip_table=s["jtab"], return_hints="packed", **kw)
    _eq(packed[1], j[1])
    bad = int((packed[2].numpy() != np.asarray(j[-1])).sum())
    assert bad <= 0.001 * 64 * 64, bad
    err = float(np.abs(packed[0].numpy() - np.asarray(j[0])).max())
    assert err <= 1e-5, err
