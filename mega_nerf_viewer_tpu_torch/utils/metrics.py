"""Image metrics and frame-rate counters (a copy of
``mega_nerf_viewer_tpu/utils/metrics.py``).

The reference's observability is an FPS counter in the window title
(``main.cpp:37-58``) and ad-hoc stdout timing; this module provides the
headless equivalents plus PSNR for golden-image parity checks.  The
timers read the host's wall clock and never synchronise the card.
"""

from __future__ import annotations

import time
from collections import deque

import numpy as np


def psnr(a: np.ndarray, b: np.ndarray, peak: float = 1.0) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    mse = float(np.mean((a - b) ** 2))
    if mse == 0:
        return float("inf")
    return 10.0 * np.log10(peak * peak / mse)


class FpsCounter:
    """Sliding-window FPS counter (reference ``main.cpp:37-58`` updates the
    title every 0.5 s; here: query any time)."""

    def __init__(self, window: float = 0.5):
        self.window = window
        self._stamps = deque()

    def tick(self) -> None:
        now = time.perf_counter()
        self._stamps.append(now)
        while self._stamps and now - self._stamps[0] > self.window:
            self._stamps.popleft()

    @property
    def fps(self) -> float:
        if len(self._stamps) < 2:
            return 0.0
        dt = self._stamps[-1] - self._stamps[0]
        return (len(self._stamps) - 1) / dt if dt > 0 else 0.0


class FrameTimer:
    """Wall-clock section timer (reference prints guided-sampling latency,
    ``cuda_renderer.cpp:122-132``)."""

    def __init__(self):
        self.records = {}

    def time(self, name: str):
        timer = self

        class _Ctx:
            def __enter__(self):
                self.t0 = time.perf_counter()
                return self

            def __exit__(self, *exc):
                timer.records.setdefault(name, []).append(
                    time.perf_counter() - self.t0)
                return False

        return _Ctx()

    def mean_ms(self, name: str) -> float:
        rec = self.records.get(name, [])
        return 1000.0 * sum(rec) / len(rec) if rec else 0.0
