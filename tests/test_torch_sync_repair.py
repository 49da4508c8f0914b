"""The sync policy's redo in place, against the JAX Viewer's hint frame.

When a segment of the sync policy's segmented frame overflows, the port's
Viewer re-marches only the overflowed segments of the frame already queued
at budget 128 (``accel.repair_segments``) and takes the next order, hints
and budgets from the repaired frame's exact hints; the JAX Viewer renders
the whole frame again as a hint frame.  Budgets are cut to 1 (in every
segment, in the last, and once on a vote frame) on both Viewers, with
``fast_max_dense`` cut to 2 so that the hint frame's escalation loop runs:

  * the repaired frame is bit-equal to the parked frame, and its votes to
    the unsegmented frame's;
  * the Viewer's state (order, segments, ``fast_max_dense``) equals JAX's
    after the redo and after two orbit poses;
  * ``repaired_rays`` counts the overflowed segments' rays, and neither
    ``block_permutation`` nor ``render_frame_fast`` runs in the redo;
  * a repair that still overflows falls back to the hint frame, counted in
    ``redo_fallbacks``.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mega_nerf_viewer_tpu_torch.ops import accel as PA
from mega_nerf_viewer_tpu_torch.utils import profiling as PR

from test_torch_viewer import PIX_TOL, check_state, orbit, pair, step

CHUNK = 128
CUT = {"all": None, "last": -1, "votes": None}


@pytest.fixture(autouse=True)
def empty_recorder():
    PR.reset()
    yield
    PR.reset()


def parked_pair(with_jax=True):
    """JAX's and the port's Viewers at 48x36 in chunks of 128 rays (14
    chunks, so the segmented frame runs its segments through
    ``_frame_core``) on a sphere whose rays record up to more than 8
    samples, parked after the hint frame and a segmented frame (the JAX
    Viewer left unrendered without ``with_jax``)."""
    jv, pv = pair(depth=4, w=48, h=36, f=30.0, model=False,
                  sigma_inside=2.0, center=(-1.6, 0.2, 1.5))
    for v in (jv, pv):
        v.fast_chunk_size = CHUNK
    for _ in range(2):
        if with_jax:
            step(jv, pv)
        else:
            pv.render()
    return jv, pv


def frame(v, need_votes):
    """One frame of the Viewer: ``render`` or, for votes, the fast frame
    with votes; returns (image as numpy, votes or None)."""
    if not need_votes:
        return np.asarray(v.render()), None
    img, res = v._render_fast(need_votes=True)
    return np.asarray(img), (res.split_vote, res.sample_vote)


def force(jv, pv, cut):
    """Cut the budgets of the segments ``cut`` names to 1 on both Viewers,
    and ``fast_max_dense`` to 2.  Returns the cut segments."""
    segs = list(pv._segments)
    idx = range(len(segs)) if cut is None else [len(segs) + cut]
    forced = [(f, min(md, 1) if i in idx else md)
              for i, (f, md) in enumerate(segs)]
    for v in (jv, pv):
        v._segments = list(forced)
        v.fast_max_dense = 2
    return forced


def flags_of(pv, forced, need_votes):
    """The overflow flags of the cut frame, from an independent segmented
    frame on the port Viewer's order."""
    out = PA.render_frame_fast_segmented(
        pv.tree, pv._leaf_map, pv.camera, pv.options, order=pv._ray_order,
        segments=tuple(forced), chunk_size=CHUNK, need_votes=need_votes,
        skip_table=None if need_votes else pv._skip_table)
    return out[1].numpy()


def spy(monkeypatch, name):
    calls = []
    orig = getattr(PA, name)

    def wrapped(*a, **k):
        calls.append(name)
        return orig(*a, **k)
    monkeypatch.setattr(PA, name, wrapped)
    return calls


@pytest.mark.parametrize("case", sorted(CUT))
def test_sync_redo_repairs_the_overflowed_segments(monkeypatch, case):
    need_votes = case == "votes"
    jv, pv = parked_pair()
    want, want_votes = frame(pv, need_votes)
    if need_votes:
        # votes of the unsegmented frame at a budget every ray fits
        ref = PA.render_frame_fast(
            pv.tree, pv._leaf_map, pv.camera, pv.options, max_dense=128,
            chunk_size=CHUNK, need_votes=True)
        for a, b in zip(want_votes, ref[3:5]):
            assert torch.equal(a, b)
    frame(jv, need_votes)
    forced = force(jv, pv, CUT[case])
    flags = flags_of(pv, forced, need_votes)
    assert flags.any()
    calls = (spy(monkeypatch, "block_permutation")
             + spy(monkeypatch, "render_frame_fast"))
    with profile(activities=[ProfilerActivity.CPU]):
        got, got_votes = frame(pv, need_votes)
    assert calls == []
    monkeypatch.undo()
    _, counters = PR.recorded()
    assert counters["redos"] == 1
    assert counters.get("redo_fallbacks", 0) == 0
    seg_counts = PA.segment_chunks(-(-got[..., 0].size // CHUNK), forced,
                                   n_rays=got[..., 0].size,
                                   chunk_size=CHUNK)
    assert counters["repaired_rays"] == sum(
        c * CHUNK for (c, _), f in zip(seg_counts, flags) if f)
    # the hint frame's loop doubled 2 up to the hint max
    assert counters.get("budget_doublings", 0) == int(
        np.log2(pv.fast_max_dense // 2)) > 0
    np.testing.assert_array_equal(got, want)
    if need_votes:
        for a, b in zip(got_votes, want_votes):
            assert torch.equal(a, b)
    a, _ = frame(jv, need_votes)
    assert float(np.abs(a - got).max()) <= PIX_TOL
    check_state(jv, pv)
    for _ in range(2):
        orbit(jv, pv)
        step(jv, pv)


def test_repair_beyond_the_ceiling_falls_back_to_the_hint_frame(
        monkeypatch):
    """A repair whose march still overflows (its count forced to 1) falls
    back to the hint frame, with the hint frame's state and pixels."""
    jv, pv = parked_pair()
    want = np.asarray(pv.render())
    jv.render()
    force(jv, pv, None)
    march = PA.fused_march

    def beyond(*a, **k):
        res = march(*a, **k)
        if k.get("gate") is None:
            return res
        return (res[0], torch.ones_like(res[1])) + tuple(res[2:])
    monkeypatch.setattr(PA, "fused_march", beyond)
    hint_frames = spy(monkeypatch, "render_frame_fast")
    with profile(activities=[ProfilerActivity.CPU]):
        got = np.asarray(pv.render())
    monkeypatch.undo()
    _, counters = PR.recorded()
    assert counters["redos"] == counters["redo_fallbacks"] == 1
    assert counters["repaired_rays"] > 0
    assert len(hint_frames) == counters.get("budget_doublings", 0) + 1 > 1
    np.testing.assert_array_equal(got, want)
    a = np.asarray(jv.render())
    assert float(np.abs(a - got).max()) <= PIX_TOL
    check_state(jv, pv)


@pytest.mark.parametrize("case", ["all", "last"])
def test_repair_segments_equals_the_frame_at_the_ceiling(case):
    """``accel.repair_segments`` on a cut frame: pixels and packed hints
    equal to the unsegmented frame's at budget 128, the repair's overflow
    count 0, the segments it did not flag untouched."""
    _, pv = parked_pair(with_jax=False)
    forced = force(pv, pv, CUT[case])
    tree, lm, cam, opt = pv.tree, pv._leaf_map, pv.camera, pv.options
    out = PA.render_frame_fast_segmented(
        tree, lm, cam, opt, order=pv._ray_order, segments=tuple(forced),
        chunk_size=CHUNK, skip_table=pv._skip_table, return_hints="packed",
        return_repair=True)
    repair = out[-1]
    ov = out[1].numpy()
    assert ov.any() and repair.seg_counts == PA.segment_chunks(
        -(-cam.width * cam.height // CHUNK), forced,
        n_rays=cam.width * cam.height, chunk_size=CHUNK)
    kept = [b.clone() for b in repair.bufs]
    (img, seg_ov), hints, n_ov = PA.repair_segments(repair, ov)
    ref = PA.render_frame_fast(tree, lm, cam, opt, max_dense=128,
                               chunk_size=CHUNK, return_nrec=True,
                               skip_table=pv._skip_table, return_skips=True)
    assert torch.equal(img, ref[0])
    assert torch.equal(hints, PA.pack_hints(ref[2], ref[3], ref[4]))
    assert int(n_ov) == 0 and not seg_ov.any()
    off = 0
    for (c, _), f in zip(repair.seg_counts, ov):
        sl = slice(off, off + c * CHUNK)
        off = sl.stop
        if not f:
            assert all(torch.equal(a[sl], b[sl])
                       for a, b in zip(repair.bufs, kept))
