"""The readers of the program's own spans and counters
(``program_spans.py`` and the metrics that use it): on the tiny CPU cells,
a host profiler session over the window stands in for the card's, so the
program records the window as it does in a ``--trace 1`` run; a program
without the recorder gives no reading and raises nothing."""

import contextlib
import types

import pytest
from torch.profiler import ProfilerActivity, profile

from conftest import tiny
from perfbench import harness, program_spans, registry
from perfbench.trace import Instruments

NEW = {"syn512_orbit": {"enqueue_ms.orbit", "sync_wait_ms.orbit",
                        "syncs_per_frame.orbit", "redos_per_pose.orbit",
                        "redo_ms.orbit"},
       "syn512_parked": {"enqueue_ms.parked", "sync_wait_ms.parked",
                         "syncs_per_frame.parked"},
       "d11_parked": {"enqueue_ms.parked", "sync_wait_ms.parked",
                      "syncs_per_frame.parked"}}


@pytest.fixture
def recorder():
    from mega_nerf_viewer_tpu_torch.utils import profiling
    profiling.reset()
    yield profiling
    profiling.reset()


def traced_run(cell, cache_root, monkeypatch, seconds=0.6):
    """One traced run of the tiny cell on the CPU, a host profiler session
    over exactly the window."""
    installed = Instruments.installed

    @contextlib.contextmanager
    def with_session(self, viewer):
        with installed(self, viewer) as inst, \
                profile(activities=[ProfilerActivity.CPU]):
            yield inst
    monkeypatch.setattr(Instruments, "installed", with_session)
    cfg, mix = tiny(cell)
    res, _ = harness.run_cell(cell, 2 ** 33 + 11, seconds, True,
                              device="cpu", root=cache_root, cfg=cfg,
                              mix=mix, log=lambda m: None)
    return res, mix


def test_cells_report_the_new_metrics():
    bench = registry.benchmark()
    for w in bench["workloads"]:
        got = {m["name"] for m in registry.cell_metrics(bench, w, True)}
        assert NEW[w["name"]] <= got


@pytest.mark.parametrize("cell", ["syn512_parked", "syn512_orbit"])
def test_readers_on_a_traced_tiny_cell(cell, cache_root, monkeypatch,
                                       recorder):
    res, mix = traced_run(cell, cache_root, monkeypatch)
    assert res["correct"] is True
    spans, counters = recorder.recorded()
    units = res["attempted"]
    m = {k: v["value"] for k, v in res["metrics"].items()}
    assert NEW[cell] <= set(m)
    # the recorder holds the window: its timed units and settle frames,
    # no warm-up frame and no check frame
    settle = int(mix["settle_frames"])
    roots = [s for s in spans if s.name == "viewer.render"]
    assert len(roots) == counters["frames"]
    if mix["kind"] == "parked":
        assert counters["frames"] == units + settle * len(mix["views"])
    else:
        per = int(mix["poses_per_episode"])
        episodes = -(-units // per)
        assert counters["frames"] == units + settle * episodes
    suffix = "parked" if mix["kind"] == "parked" else "orbit"
    assert m[f"syncs_per_frame.{suffix}"] == pytest.approx(
        counters["host_syncs"] / units)
    assert m[f"enqueue_ms.{suffix}"] == pytest.approx(
        program_spans.enqueue_s(spans) * 1e3 / units)
    assert m[f"enqueue_ms.{suffix}"] > 0
    assert m[f"sync_wait_ms.{suffix}"] >= 0
    if mix["kind"] == "parked":
        # parked under the sync policy: one read a frame, the flags
        assert counters["host_syncs"] == counters["frames"]
    else:
        assert m["redos_per_pose.orbit"] == pytest.approx(
            counters.get("redos", 0) / units)
        assert m["redo_ms.orbit"] >= 0


def span(name, start, end, id_, parent=None):
    return types.SimpleNamespace(name=name, start_ns=start, end_ns=end,
                                 id=id_, parent=parent)


def test_readers_on_a_known_record(monkeypatch):
    """The readers' arithmetic on a record made by hand: two poses, one
    redone; a sync span inside ``frame.march`` comes off the enqueue."""
    spans = [span("viewer.render", 0, 10_000_000, 0),
             span("frame.raygen", 0, 1_000_000, 1, 0),
             span("frame.march", 1_000_000, 4_000_000, 2, 0),
             span("sync.seg_counts", 2_000_000, 2_500_000, 3, 2),
             span("sync.flags", 5_000_000, 7_000_000, 4, 0),
             span("viewer.render", 10_000_000, 30_000_000, 5),
             span("viewer.redo", 11_000_000, 19_000_000, 6, 5),
             span("frame.assemble", 12_000_000, 13_000_000, 7, 6)]
    counters = {"frames": 2, "host_syncs": 2, "redos": 1}
    monkeypatch.setattr(program_spans, "recorded",
                        lambda: (spans, counters))
    ctx = types.SimpleNamespace(window=types.SimpleNamespace(units=2))
    got = {n: registry.metric_reader(n)(ctx) for n in
           ("enqueue_ms.orbit", "sync_wait_ms.orbit",
            "syncs_per_frame.orbit", "redos_per_pose.orbit",
            "redo_ms.orbit")}
    assert got == pytest.approx({"enqueue_ms.orbit": (1 + 3 - 0.5 + 1) / 2,
                                 "sync_wait_ms.orbit": (0.5 + 2) / 2,
                                 "syncs_per_frame.orbit": 1.0,
                                 "redos_per_pose.orbit": 0.5,
                                 "redo_ms.orbit": 8.0})


def test_a_program_without_the_recorder_gives_nothing(monkeypatch,
                                                      recorder):
    ctx = types.SimpleNamespace(window=types.SimpleNamespace(units=5))
    names = sorted(set().union(*NEW.values()))
    # nothing recorded: no frames
    assert all(registry.metric_reader(n)(ctx) is None for n in names)
    monkeypatch.delattr(recorder, "recorded")
    assert program_spans.recorded() is None
    assert all(registry.metric_reader(n)(ctx) is None for n in names)
