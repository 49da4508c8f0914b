"""The port's spans and counters (``utils/profiling.py``) inside its frame
path: nothing records without a profiler session; under one, each Viewer
frame is one ``viewer.render`` root over the frame's ``frame.*`` spans, the
sync policy's redos and every host read are counted, the spans sit in the
Chrome trace beside the operators, and ``idle_by_span`` sums the card's
idle gaps by the span open when each began."""

import json
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import mega_nerf_viewer_tpu_torch as P
from mega_nerf_viewer_tpu_torch.ops import accel
from mega_nerf_viewer_tpu_torch.utils import profiling as PR

FRAME = ("frame.raygen", "frame.setup", "frame.march", "frame.assemble")


@pytest.fixture(autouse=True)
def empty_recorder():
    PR.reset()
    yield
    PR.reset()


@pytest.fixture(scope="module")
def tree():
    return P.shell_tree(depth=5, basis_dim=4, sigma_inside=400.0,
                        device="cpu")


def viewer(tree, policy="sync"):
    """A 64x48 Viewer in chunks of 256 rays (12 chunks: the segmented
    frame runs its five segments through ``_frame_core``), parked after
    its hint frame and first segmented frame."""
    cam = P.Camera(64, 48, 37.0)
    cam.center = np.array([-1.4, 0.1, 1.3], np.float32)
    v = P.Viewer(tree, camera=cam, device="cpu")
    v.fast_chunk_size = 256
    v.overflow_policy = policy
    for _ in range(2):
        v.render(fetch=False)
    return v


def host_session():
    return profile(activities=[ProfilerActivity.CPU])


def by_name(spans, name):
    return [s for s in spans if s.name == name]


def self_ns(span, spans):
    kids = [s for s in spans if s.parent == span.id]
    return (span.end_ns - span.start_ns) - sum(k.end_ns - k.start_ns
                                              for k in kids)


def test_no_profiler_records_nothing(tree):
    v = viewer(tree)
    v.render(fetch=False)          # the Viewer's frames, parked and moved
    v.camera.center = v.camera.center + np.float32(0.01)
    v.render()
    assert PR.recorded() == ([], {})
    assert PR.annotate("a") is PR.annotate("b", frame=3)
    assert PR.host_sync("flags") is PR.annotate("c")
    PR.count("frames")
    with PR.annotate("viewer.render") as sp:
        sp.set(path="fast")
    assert PR.recorded() == ([], {})


@pytest.mark.parametrize("policy", ["sync", "async", "device"])
def test_parked_frames_nest_under_one_root(tree, tmp_path, policy):
    v = viewer(tree, policy)
    ids0 = v.frame_id
    with PR.trace(str(tmp_path)):
        for _ in range(3):
            v.render(fetch=False)
    spans, counters = PR.recorded()
    roots = [s for s in spans if s.parent is None]
    assert [s.name for s in roots] == ["viewer.render"] * 3
    assert [s.frame for s in roots] == [ids0 + 1, ids0 + 2, ids0 + 3]
    assert all(s.attrs == {"path": "segmented"} for s in roots)
    assert counters["frames"] == 3
    for root in roots:
        kids = [s for s in spans if s.parent == root.id]
        frame = [s for s in kids if s.name.startswith("frame.")]
        assert [s.name for s in frame] == list(FRAME)
        for a, b in zip(frame, frame[1:]):
            assert a.end_ns <= b.start_ns
        for s in [root] + kids:
            assert s.frame == root.frame
            assert root.start_ns <= s.start_ns <= s.end_ns <= root.end_ns
            assert self_ns(s, spans) >= 0
    fallback = by_name(spans, "frame.fallback")
    assert len(fallback) == (3 if policy == "device" else 0)
    assert all(next(p for p in spans if p.id == s.parent).name
               == "frame.assemble" for s in fallback)


@pytest.mark.parametrize("segment", [None, -1])
def test_sync_redo_counts_the_escalated_segments(tree, segment):
    """Budgets cut to 1 (all segments, or the last one) overflow: the
    Viewer's counters and its ``viewer.redo`` span count the redo that an
    independent segmented frame's flags call for, the redo repairs the
    overflowed segments in place (no block permutation; their rays counted
    in ``repaired_rays``), and the redone frame equals the parked frame."""
    v = viewer(tree)
    want = v.render(fetch=False)
    segs = list(v._segments)
    idx = range(len(segs)) if segment is None else [len(segs) + segment]
    forced = [(f, min(md, 1) if i in idx else md)
              for i, (f, md) in enumerate(segs)]
    out = accel.render_frame_fast_segmented(
        v.tree, v._leaf_map, v.camera, v.options, order=v._ray_order,
        segments=tuple(forced), chunk_size=v.fast_chunk_size,
        skip_table=v._skip_table)
    flags = out[1].numpy()
    assert flags.any()
    v._segments = forced
    with host_session():
        img = v.render(fetch=False)
    spans, counters = PR.recorded()
    assert torch.equal(img, want)
    assert counters["redos"] == 1 == len(by_name(spans, "viewer.redo"))
    assert counters["escalated_segments"] == int((flags > 0).sum())
    assert counters["overflow_rays"] == int(flags.sum())
    assert by_name(spans, "viewer.render")[0].attrs == {"path": "redo"}
    redo = by_name(spans, "viewer.redo")[0]
    inside = [s for s in spans if redo.start_ns <= s.start_ns
              and s.end_ns <= redo.end_ns and s is not redo]
    assert "sync.hint_cdf" in {s.name for s in inside}
    assert counters.get("block_permutations", 0) == 0
    R = v.camera.width * v.camera.height
    cs = v.fast_chunk_size
    seg_counts = accel.segment_chunks(-(-R // cs), forced, n_rays=R,
                                      chunk_size=cs)
    assert counters["repaired_rays"] == sum(
        c * cs for (c, _), f in zip(seg_counts, flags) if f)


@pytest.mark.parametrize("policy", ["sync", "async", "device"])
def test_host_syncs_count_the_sync_spans(tree, policy):
    v = viewer(tree, policy)
    for _ in range(9):                 # past the async clean streak
        v.render(fetch=False)
    with host_session():
        for _ in range(4):
            v.render(fetch=False)
    parked = PR.recorded()
    PR.reset()
    with host_session():
        for k in range(3):
            v.camera.center = (v.camera.center
                               + np.float32(0.02) * v.camera.v_right)
            v.render(fetch=False)
        v.render()
    spans, counters = PR.recorded()
    for sp, c in (parked, (spans, counters)):
        syncs = [s for s in sp if s.name.startswith("sync.")]
        assert c["host_syncs"] == len(syncs) > 0
        # a read that waits on the card ends nowhere but inside a frame
        assert all(s.frame is not None for s in syncs)
    if policy == "sync":
        assert [s.name for s in parked[0] if s.name.startswith("sync.")] \
            == ["sync.flags"] * 4
        assert parked[1]["host_syncs"] == 4 == parked[1]["frames"]
    # each move rebuilds the order: a reorder, or under async a re-hint
    assert by_name(spans, "sync.fetch")
    assert counters.get("reorders", 0) + counters.get("rehints", 0) == 3


def test_chrome_trace_holds_the_program_spans(tree, tmp_path):
    v = viewer(tree)
    with PR.trace(str(tmp_path)):
        v.render(fetch=False)
    with open(tmp_path / f"trace.{os.getpid()}.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"viewer.render", "sync.flags", *FRAME} <= names
    assert any(str(n).startswith("aten::") for n in names)


def test_async_motion_frames_are_rehints(tree):
    v = viewer(tree, "async")
    with host_session():
        for _ in range(3):
            v.camera.center = (v.camera.center
                               + np.float32(0.02) * v.camera.v_right)
            v.render(fetch=False)
    spans, counters = PR.recorded()
    assert [s.attrs for s in by_name(spans, "viewer.render")] \
        == [{"path": "motion"}] * 3
    assert counters["rehints"] == 3 == len(by_name(spans, "accel.motion"))
    # the motion frame's pass 2 is a frame of its own inside accel.motion
    for m in by_name(spans, "accel.motion"):
        assert [s.name for s in spans if s.parent == m.id] == list(FRAME)


def test_records_written_beside_the_trace(tree, tmp_path):
    """``trace`` writes the span lines and the idle seconds when it traced
    the card; here, their writer on a host session."""
    v = viewer(tree)
    with host_session() as prof:
        v.render(fetch=False)
        v.render(fetch=False)
    spans, counters = PR.recorded()
    PR._write_records(str(tmp_path), prof, spans, counters)
    pid = os.getpid()
    lines = (tmp_path / f"spans.{pid}.jsonl").read_text().splitlines()
    rows = [json.loads(ln) for ln in lines]
    assert rows[-1] == {"counters": counters}
    assert [r["name"] for r in rows[:-1]] == [s.name for s in spans]
    assert {r["frame"] for r in rows[:-1]} == {v.frame_id - 1, v.frame_id}
    # no card traced: no device interval, no gap
    assert json.loads((tmp_path / f"idle.{pid}.json").read_text()) == {}
    host, dev = PR.profile_intervals(prof, {s.name for s in spans})
    assert dev == [] and len(host) == len(spans)


def test_the_buffer_is_bounded(tree, monkeypatch):
    v = viewer(tree)
    monkeypatch.setattr(PR, "MAX_SPANS", 5)
    with host_session():
        v.render(fetch=False)
    spans, counters = PR.recorded()
    assert len(spans) == 5 and counters["dropped_spans"] > 0


# (start, end, name) host spans and (start, end) device intervals, in ns
IDLE_CASES = {
    # nested spans: each gap goes to the innermost span open at its start
    "nested": ([(0, 100, "viewer.render"), (10, 40, "frame.march"),
                (50, 90, "sync.flags")],
               [(0, 20), (30, 55), (70, 100)],
               {"frame.march": 10e-9, "sync.flags": 15e-9}),
    # a gap that starts outside every span
    "outside": ([(0, 10, "viewer.render"), (60, 90, "viewer.render")],
                [(0, 20), (50, 70), (80, 85), (95, 99)],
                {"outside": 30e-9, "viewer.render": 20e-9}),
    # overlapping device intervals make one busy stretch
    "overlap": ([(0, 200, "frame.assemble")],
                [(0, 50), (40, 80), (60, 70), (100, 120), (110, 150)],
                {"frame.assemble": 20e-9}),
}


@pytest.mark.parametrize("case", sorted(IDLE_CASES))
def test_idle_by_span(case):
    host, dev, want = IDLE_CASES[case]
    got = PR.idle_by_span(host, dev)
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k] == pytest.approx(v)


def test_mesh_collectives_are_spans():
    """``parallel.mesh``'s collectives go through the program's span (a
    world of one, in-process, as the entry points start it)."""
    from mega_nerf_viewer_tpu_torch.parallel import mesh
    mesh.init_world("cpu")
    t = torch.arange(4.0)
    mesh.all_reduce(t, "sum", None)
    assert PR.recorded() == ([], {})
    with host_session():
        mesh.all_reduce(t, "sum", None)
        mesh.all_gather(t, None)
        mesh.broadcast(t)
    assert [s.name for s in PR.recorded()[0]] == [
        "parallel.all_reduce", "parallel.all_gather", "parallel.broadcast"]
