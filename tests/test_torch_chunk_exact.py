"""Chunk-exact budgets, the step order and the device fallback against the
JAX package (``tests/test_chunk_exact.py:25-64`` and
``tests/test_accel.py:706``).

Integers (segment layouts, permutations, overflow counts) must be equal and
pixels within 1e-5 (``test_torch_march.py`` gives the reason); frames of
one side that only differ by where the rays were cut into segments are
compared bit for bit.
"""

import jax
import numpy as np
import pytest
import torch

import mega_nerf_viewer_tpu.n3tree as J
import mega_nerf_viewer_tpu_torch as P
from mega_nerf_viewer_tpu.camera import Camera
from mega_nerf_viewer_tpu.options import RenderOptions
from mega_nerf_viewer_tpu.ops import accel as JA
from mega_nerf_viewer_tpu_torch.ops import accel as PA

from test_torch_frame import port

PIX_TOL = 1e-5
CS = 256


# ----------------------------------------------------------------------
# seg_counts_from_hints (test_chunk_exact.py:25-64)
# ----------------------------------------------------------------------
@pytest.mark.parametrize("seed,n,hi,cs,quantum", [
    (3, 5000, 19, 64, 1), (5, 64 * 21, 9, 64, 8), (7, 3000, 129, 128, 1),
    (11, 4096, 40, 256, 4), (13, 777, 3, 32, 3)])
def test_seg_counts_from_hints_equal(seed, n, hi, cs, quantum):
    rng = np.random.default_rng(seed)
    nrec = np.sort(rng.integers(0, hi, n).astype(np.int32))
    want = JA.seg_counts_from_hints(nrec, chunk_size=cs, quantum=quantum)
    got = PA.seg_counts_from_hints(torch.as_tensor(nrec), chunk_size=cs,
                                   quantum=quantum)
    assert got == want
    assert PA.CHUNK_EXACT_BUDGETS == JA.CHUNK_EXACT_BUDGETS
    # every chunk's true max fits its budget; runs strictly increase
    pad = (-n) % (cs * quantum)
    cmax = np.concatenate([nrec, np.full(pad, nrec[-1])]).reshape(
        -1, cs).max(1)
    off = 0
    for c, b in got:
        assert cmax[off:off + c].max() <= b
        off += c
    assert off == cmax.size
    assert [b for _, b in got] == sorted({b for _, b in got})
    if quantum > 1:
        assert all(c % quantum == 0 for c, _ in got)


def test_seg_counts_budget_cap_raises():
    with pytest.raises(ValueError):
        JA.seg_counts_from_hints(np.full(64, 200, np.int32), chunk_size=64)
    with pytest.raises(ValueError, match="exceeds budget cap"):
        PA.seg_counts_from_hints(np.full(64, 200, np.int32), chunk_size=64)


# ----------------------------------------------------------------------
# frames: step order, chunk-exact budgets, device fallback
# ----------------------------------------------------------------------
def _camera(cls, w=64, h=64, f=60.0, center=(-1.3, 0.2, 1.2)):
    cam = cls(w, h, f)
    cam.center = np.array(center, np.float32)
    cam._update()
    return cam


@pytest.fixture(scope="module")
def scene():
    """test_accel.py:706's sphere and camera; the hint frame on both
    sides and the hint order."""
    jt = J.sphere_tree(basis_dim=4, depth=4)
    pt = port(jt)
    s = dict(jt=jt, pt=pt, jlm=JA.build_leaf_map(jt),
             plm=PA.build_leaf_map(pt), jcam=_camera(Camera),
             pcam=_camera(P.Camera), opt=RenderOptions(),
             popt=P.RenderOptions())
    j = JA.render_frame_fast(jt, s["jlm"], s["jcam"], s["opt"], max_dense=16,
                             chunk_size=CS, block=16, return_nrec=True)
    p = PA.render_frame_fast(pt, s["plm"], s["pcam"], s["popt"],
                             max_dense=16, chunk_size=CS, block=16,
                             return_nrec=True)
    assert not int(j[1]) and not int(p[1])
    np.testing.assert_array_equal(p[2].numpy(), np.asarray(j[2]))
    np.testing.assert_array_equal(p[3].numpy(), np.asarray(j[3]))
    s.update(hint=p, jorder=JA.order_from_hints(j[2], j[3]),
             porder=PA.order_from_hints(p[2], p[3]))
    return s


def test_order_from_steps_equal(scene):
    steps = scene["hint"][2].numpy()
    rng = np.random.default_rng(1)
    for keys in (steps, rng.integers(0, 7, 999).astype(np.int32)):
        pj, ij = JA.order_from_steps(keys)
        pp, ip = PA.order_from_steps(torch.as_tensor(keys))
        np.testing.assert_array_equal(pp.numpy(), np.asarray(pj))
        np.testing.assert_array_equal(ip.numpy(), np.asarray(ij))


def test_step_hint_frame_equal(scene):
    s = scene
    steps = s["hint"][2]
    j = JA.render_frame_fast(s["jt"], s["jlm"], s["jcam"], s["opt"],
                             max_dense=16, chunk_size=CS,
                             step_hint=steps.numpy(), return_nrec=True)
    p = PA.render_frame_fast(s["pt"], s["plm"], s["pcam"], s["popt"],
                             max_dense=16, chunk_size=CS, step_hint=steps,
                             return_nrec=True)
    assert float(np.abs(np.asarray(j[0]) - p[0].numpy()).max()) <= PIX_TOL
    assert int(p[1]) == int(j[1]) == 0
    for a, b in zip(j[2:], p[2:]):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    # the order only moves rays between chunks: the pixels of the
    # block-ordered hint frame, bit for bit
    assert torch.equal(p[0], s["hint"][0])


def test_chunk_exact_frame_equal(scene):
    """Chunk-exact budgets from the settled sorted hints: the frame of the
    hint order, bit for bit on the port, and JAX's within 1e-5."""
    s = scene
    nrec = s["hint"][3]
    perm = s["porder"][0]
    sc = PA.seg_counts_from_hints(nrec[perm], chunk_size=CS)
    assert sc == JA.seg_counts_from_hints(
        np.asarray(nrec)[np.asarray(s["jorder"][0])], chunk_size=CS)
    assert len(sc) > 1
    j = JA.render_frame_fast_segmented(
        s["jt"], s["jlm"], s["jcam"], s["opt"], order=s["jorder"],
        chunk_size=CS, seg_counts=sc)
    p = PA.render_frame_fast_segmented(
        s["pt"], s["plm"], s["pcam"], s["popt"], order=s["porder"],
        chunk_size=CS, seg_counts=sc)
    np.testing.assert_array_equal(p[1].numpy(), np.asarray(j[1]))
    assert not p[1].any()
    assert float(np.abs(np.asarray(j[0]) - p[0].numpy()).max()) <= PIX_TOL
    assert torch.equal(p[0], s["hint"][0])
    with pytest.raises(ValueError, match="do not cover"):
        PA.render_frame_fast_segmented(
            s["pt"], s["plm"], s["pcam"], s["popt"], order=s["porder"],
            chunk_size=CS, seg_counts=sc[:-1])


def _both(s, segments, jopt=None, popt=None, **kw):
    j = JA.render_frame_fast_segmented(
        s["jt"], s["jlm"], s["jcam"], jopt or s["opt"],
        order=s["jorder"], segments=segments, chunk_size=CS, **kw)
    p = PA.render_frame_fast_segmented(
        s["pt"], s["plm"], s["pcam"], popt or s["popt"],
        order=s["porder"], segments=segments, chunk_size=CS, **kw)
    assert len(j) == len(p)
    return j, p


def test_device_fallback_fresh_budgets(scene):
    """Budgets that fit: the plain segmented frame, fb_overflow 0."""
    s = scene
    segs = ((0.5, 1), (0.25, 2), (0.25, 16))
    plain = PA.render_frame_fast_segmented(
        s["pt"], s["plm"], s["pcam"], s["popt"], order=s["porder"],
        segments=segs, chunk_size=CS)
    j, p = _both(s, segs, device_fallback=True)
    np.testing.assert_array_equal(p[1].numpy(), np.asarray(j[1]))
    assert not p[1].any() and int(p[2]) == int(j[2]) == 0
    assert p[2].dtype == torch.int32 and p[2].shape == ()
    assert torch.equal(p[0], plain[0])
    assert float(np.abs(np.asarray(j[0]) - p[0].numpy()).max()) <= PIX_TOL


@pytest.mark.parametrize("hints", [False, True, "packed"])
def test_device_fallback_starved_budgets(scene, hints):
    """Starved budgets: the flags fire, and the frame is the unsegmented
    one all the same; hints ride through the fallback."""
    s = scene
    j, p = _both(s, ((0.75, 0), (0.25, 1)), device_fallback=True,
                 return_hints=hints)
    np.testing.assert_array_equal(p[1].numpy(), np.asarray(j[1]))
    assert p[1].any() and int(p[2]) == int(j[2]) == 0
    assert torch.equal(p[0], s["hint"][0])
    assert float(np.abs(np.asarray(j[0]) - p[0].numpy()).max()) <= PIX_TOL
    for a, b in zip(j[3:], p[3:]):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    if hints is True:
        assert torch.equal(p[4], s["hint"][3])


def test_device_fallback_votes(scene):
    """Votes ride through the fallback as through the unsegmented frame."""
    s = scene
    jopt, popt = RenderOptions(max_depth=5), P.RenderOptions(max_depth=5)
    ref = PA.render_frame_fast(s["pt"], s["plm"], s["pcam"], popt,
                               max_dense=16, chunk_size=CS, block=16,
                               need_votes=True)
    j, p = _both(s, ((0.75, 0), (0.25, 1)), need_votes=True,
                 device_fallback=True, jopt=jopt, popt=popt)
    np.testing.assert_array_equal(p[1].numpy(), np.asarray(j[1]))
    for a, b in zip(j[2:], p[2:]):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    assert torch.equal(p[2], ref[3]) and torch.equal(p[3], ref[4])
    assert torch.equal(p[0], ref[0])


@pytest.fixture
def small_fallback_cap(monkeypatch):
    """The fallback's budget cut from 128 to 2 on both sides, so the
    sphere has rays beyond it; JAX's compiled frames are dropped before
    and after, since the cap is read when the frame is traced."""
    jax.clear_caches()
    monkeypatch.setattr(JA, "_FALLBACK_MD", 2)
    monkeypatch.setattr(PA, "_FALLBACK_MD", 2)
    yield
    jax.clear_caches()


def test_device_fallback_beyond_cap(scene, small_fallback_cap):
    s = scene
    assert int(s["hint"][3].max()) > 2
    j, p = _both(s, ((0.75, 0), (0.25, 1)), device_fallback=True)
    np.testing.assert_array_equal(p[1].numpy(), np.asarray(j[1]))
    assert int(p[2]) == int(j[2]) > 0
    assert float(np.abs(np.asarray(j[0]) - p[0].numpy()).max()) <= PIX_TOL
    # the small-frame path marches at the cap too
    cams = [_camera(cls, 16, 16, 15.0) for cls in (Camera, P.Camera)]
    j = JA.render_frame_fast_segmented(
        s["jt"], s["jlm"], cams[0], s["opt"],
        order=JA.block_permutation(16, 16, 4), chunk_size=CS,
        device_fallback=True)
    p = PA.render_frame_fast_segmented(
        s["pt"], s["plm"], cams[1], s["popt"],
        order=PA.block_permutation(16, 16, 4, device="cpu"), chunk_size=CS,
        device_fallback=True)
    np.testing.assert_array_equal(p[1].numpy(), np.asarray(j[1]))
    assert int(p[2]) == int(j[2])
    assert float(np.abs(np.asarray(j[0]) - p[0].numpy()).max()) <= PIX_TOL


def test_on_flags_sees_the_frame_counts(scene):
    s = scene
    seen = []
    out = PA.render_frame_fast_segmented(
        s["pt"], s["plm"], s["pcam"], s["popt"], order=s["porder"],
        segments=((0.75, 0), (0.25, 1)), chunk_size=CS,
        device_fallback=True, on_flags=seen.append)
    assert len(seen) == 1 and set(seen[0]) == {"seg_overflow",
                                               "fb_overflow"}
    assert torch.equal(seen[0]["seg_overflow"], out[1])
    assert torch.equal(seen[0]["fb_overflow"], out[2])


def test_device_fallback_remarches_only_the_starved_segment(
        scene, monkeypatch):
    """One starved segment between two that fit: the fallback marches
    again that segment's rays alone, at the ceiling, and the frame,
    ``fb_overflow`` and the flags are JAX's, whose fallback re-marches the
    whole frame."""
    s = scene
    segs = ((0.5, 1), (0.25, 1), (0.25, 16))
    marched = []
    march = PA.fused_march

    def spy(tree, leaf_map, m, max_dense, *a, gate=None, into=None, **k):
        if gate is not None and bool(gate.any()):
            marched.append((m.d.shape[0], max_dense))
        return march(tree, leaf_map, m, max_dense, *a, gate=gate, into=into,
                     **k)
    monkeypatch.setattr(PA, "fused_march", spy)
    j, p = _both(s, segs, device_fallback=True)
    np.testing.assert_array_equal(p[1].numpy(), np.asarray(j[1]))
    assert [bool(c) for c in p[1]] == [False, True, False]
    assert marched == [(CS * PA.segment_chunks(
        64 * 64 // CS, segs, n_rays=64 * 64, chunk_size=CS)[1][0],
        PA._FALLBACK_MD)]
    assert int(p[2]) == int(j[2]) == 0
    assert p[2].dtype == torch.int32 and p[2].shape == ()
    assert torch.equal(p[0], s["hint"][0])
    assert float(np.abs(np.asarray(j[0]) - p[0].numpy()).max()) <= PIX_TOL
