"""The port's profiling module (``utils/profiling.py``): ``trace`` onto
``torch.profiler`` and ``annotate`` onto ``record_function`` (the JAX
package's are ``jax.profiler``'s), and ``FrameStats``, a copy of the JAX
package's, whose summaries must be equal."""

import json
import os

import numpy as np
import pytest

from mega_nerf_viewer_tpu.utils import profiling as JPR
import mega_nerf_viewer_tpu_torch as P
from mega_nerf_viewer_tpu_torch.utils import profiling as PPR


def test_trace_holds_the_annotated_frame(tmp_path):
    """``trace`` around two Viewer frames writes a Chrome trace that holds
    the ``annotate`` region and the frames' operators."""
    cam = P.Camera(16, 12, 14.0)
    cam.center = np.array([-1.5, 0.1, 1.4], np.float32)
    v = P.Viewer(P.sphere_tree(basis_dim=1, depth=3, device="cpu"),
                 camera=cam, device="cpu")
    log_dir = str(tmp_path / "prof")
    with PPR.trace(log_dir) as prof:
        for _ in range(2):
            with PPR.annotate("viewer_frame"):
                v.render()
    assert prof is not None
    files = os.listdir(log_dir)
    assert files == [f"trace.{os.getpid()}.json"]
    with open(os.path.join(log_dir, files[0])) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert "viewer_frame" in names
    assert sum(e.get("name") == "viewer_frame" for e in events) == 2
    assert any(str(n).startswith("aten::") for n in names)


@pytest.mark.parametrize("n", [0, 1, 7, 150])
def test_frame_stats_summary_equals_jax(tmp_path, rng, n):
    times = rng.uniform(0.002, 0.05, n)
    sinks = []
    stats = []
    for mod in (JPR, PPR):
        sink = str(tmp_path / f"{mod.__name__}.jsonl")
        s = mod.FrameStats(sink=sink, max_frames=100)
        for i, t in enumerate(times):
            rec = s.record(64, 48, float(t), frame=i)
            assert rec["frame_ms"] == pytest.approx(t * 1e3)
        stats.append(s.summary())
        s.close()
        sinks.append(sink)
    assert stats[1] == stats[0]
    assert len(stats[1]) == (0 if n == 0 else 5)
    lines = [open(p).read().splitlines() for p in sinks]
    assert len(lines[1]) == n == len(lines[0])
    for a, b in zip(*lines):
        a, b = json.loads(a), json.loads(b)
        a.pop("ts"), b.pop("ts")
        assert a == b


def test_frame_stats_context_manager(tmp_path):
    p = str(tmp_path / "s.jsonl")
    with PPR.FrameStats(sink=p, max_frames=3) as s:
        for t in (0.01, 0.02, 0.03, 0.04):
            s.record(8, 8, t)
        assert len(s.frames) == 3
    assert s._sink is None
    assert len(open(p).read().splitlines()) == 4
