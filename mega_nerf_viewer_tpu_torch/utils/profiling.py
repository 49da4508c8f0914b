"""Profiling and observability (counterpart of
``mega_nerf_viewer_tpu/utils/profiling.py``).

The reference's observability is an FPS title counter (main.cpp:37-58)
and ad-hoc wall-clock prints (cuda_renderer.cpp:122-132).  The port
replaces them with:

  * :func:`trace` — a ``torch.profiler`` session over the host and, when
    CUDA is available, the card's kernels, written into ``log_dir`` as a
    Chrome trace (open it in Perfetto or ``chrome://tracing``).
  * :class:`FrameStats` — structured per-frame counters (frame time,
    rays/sec) exportable as JSON lines (a copy of the JAX package's).
  * :func:`annotate` — a named region on the trace's timeline
    (``torch.profiler.record_function``).
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Optional

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the enclosed region and write ``trace.<pid>.json`` into
    ``log_dir`` (created if missing); the card's kernels are traced
    whenever CUDA is available.  Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(
        os.path.join(log_dir, f"trace.{os.getpid()}.json"))


def annotate(name: str):
    """Named region that shows up in profiler timelines."""
    return torch.profiler.record_function(name)


class FrameStats:
    """Structured per-frame metrics with JSONL export.

    In-memory history is BOUNDED (``max_frames``, default 100k ≈ a few
    MB): long interactive sessions keep the newest records for
    ``summary()`` while the JSONL sink (if any) receives every record.
    Usable as a context manager; ``close()`` releases the sink fd."""

    def __init__(self, sink: Optional[str] = None,
                 max_frames: int = 100_000):
        self.frames = []
        self._max_frames = max_frames
        self._sink = open(sink, "a") if sink else None

    def record(self, width: int, height: int, seconds: float, **extra):
        rec = dict(
            ts=time.time(),
            width=width, height=height,
            frame_ms=seconds * 1000.0,
            fps=(1.0 / seconds) if seconds > 0 else 0.0,
            rays_per_sec=(width * height / seconds) if seconds > 0 else 0.0,
            **extra)
        self.frames.append(rec)
        if len(self.frames) > self._max_frames:
            del self.frames[:len(self.frames) - self._max_frames]
        if self._sink:
            self._sink.write(json.dumps(rec) + "\n")
            self._sink.flush()
        return rec

    def close(self):
        if self._sink:
            self._sink.close()
            self._sink = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def summary(self) -> dict:
        if not self.frames:
            return {}
        ms = sorted(f["frame_ms"] for f in self.frames)
        n = len(ms)
        return dict(
            frames=n,
            mean_ms=sum(ms) / n,
            p50_ms=ms[n // 2],
            p99_ms=ms[min(n - 1, int(n * 0.99))],
            fps=1000.0 * n / sum(ms),
        )
