"""Profiling and observability (counterpart of
``mega_nerf_viewer_tpu/utils/profiling.py``).

The reference's observability is an FPS title counter (main.cpp:37-58)
and ad-hoc wall-clock prints (cuda_renderer.cpp:122-132).  The port
replaces them with spans and counters recorded inside its frame path,
on the profiler's timeline:

  * :func:`trace` — a ``torch.profiler`` session over the host and, when
    CUDA is available, the card's kernels, written into ``log_dir`` as a
    Chrome trace (open it in Perfetto or ``chrome://tracing``); with the
    card traced, also the program's spans as JSON lines and the card's
    idle time by span.
  * :func:`annotate` — the program's span: a named, nested host range
    that also opens a ``torch.profiler.record_function`` range, so it
    sits on the profiler's host clock beside the card's kernels.
  * :func:`count` — a named counter.
  * :func:`host_sync` — the span of a read that waits on the card.
  * :func:`recorded`, :func:`reset` — the spans and counters in memory.
  * :func:`idle_by_span` — the card's idle gaps summed by the program
    span open on the host when each gap began.

Spans and counters are recorded only while a profiler session runs
(:func:`trace`, or any ``torch.profiler.profile``): that session is the
one switch.  Without one, :func:`annotate` returns one shared no-op
context and :func:`count` returns at once, so an instrumented call costs
a check of the profiler's state.  The recorder is process-wide, like the
profiler session it follows.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from collections import defaultdict
from typing import NamedTuple, Optional

import torch

# the profiler's own state: true while any torch.profiler session runs
_profiling = torch._C._autograd._profiler_enabled

# spans kept in memory; later ones are dropped and counted
MAX_SPANS = 1_000_000


class Span(NamedTuple):
    """One recorded span.  Times are ``time.perf_counter_ns``; ``parent``
    is the enclosing span's ``id`` (None at a root); ``frame`` is the
    frame id its root was given (``Viewer.render`` gives its frame
    counter), shared by the spans of one frame."""
    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: Optional[int]
    frame: Optional[int]
    attrs: Optional[dict]


class _Recorder:
    def __init__(self):
        self.spans = []
        self.counters = defaultdict(int)
        self.ids = itertools.count()
        self.local = threading.local()

    def stack(self) -> list:
        st = getattr(self.local, "stack", None)
        if st is None:
            st = self.local.stack = []
        return st


_REC = _Recorder()


class _NoSpan:
    """The shared context returned while nothing records."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> None:
        pass


_NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("name", "attrs", "_rf", "_t0", "_id", "_parent", "_frame")

    def __init__(self, name: str, attrs: dict):
        self.name = name
        self.attrs = attrs

    def set(self, **attrs) -> None:
        """Add attributes to the open span (the Viewer's ``path``)."""
        self.attrs.update(attrs)

    def __enter__(self):
        stack = _REC.stack()
        parent = stack[-1] if stack else None
        self._id = next(_REC.ids)
        self._parent = None if parent is None else parent._id
        self._frame = self.attrs.pop(
            "frame", None if parent is None else parent._frame)
        stack.append(self)
        self._rf = torch.profiler.record_function(self.name)
        self._rf.__enter__()
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        self._rf.__exit__(*exc)
        stack = _REC.stack()
        if stack and stack[-1] is self:
            stack.pop()
        if len(_REC.spans) < MAX_SPANS:
            _REC.spans.append(Span(self.name, self._t0, t1, self._id,
                                   self._parent, self._frame,
                                   self.attrs or None))
        else:
            _REC.counters["dropped_spans"] += 1
        return False


def annotate(name: str, **attrs):
    """The program's span ``name`` around the enclosed code, with
    ``attrs`` (``frame=`` sets the frame id of the span and of the spans
    it encloses).  Recorded only while a profiler session runs; then it is
    also a ``torch.profiler`` range of the same name.  ``set(**attrs)`` on
    the context adds attributes before it closes."""
    if not _profiling():
        return _NO_SPAN
    return _Span(name, attrs)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while a profiler session runs."""
    if not _profiling():
        return
    _REC.counters[name] += n


def host_sync(site: str):
    """The span ``sync.<site>`` around a read that waits on the card (a
    device-to-host copy, an event's wait), counted in ``host_syncs``.  Its
    time is the host waiting on the card, where every other span's time
    is the host's own."""
    if not _profiling():
        return _NO_SPAN
    _REC.counters["host_syncs"] += 1
    return _Span("sync." + site, {})


def recorded() -> tuple:
    """(spans, counters): the :class:`Span` list in the order the spans
    closed, and a dict of the counters."""
    return list(_REC.spans), dict(_REC.counters)


def reset() -> None:
    """Drop every recorded span and counter."""
    _REC.spans.clear()
    _REC.counters.clear()


def idle_by_span(host_ranges, device_intervals) -> dict:
    """The card's idle seconds by host span.  ``host_ranges`` are
    (start, end, name) host spans, nested as on one thread;
    ``device_intervals`` (start, end) the card's operations, which may
    overlap; times in nanoseconds.  Each gap in the union of the device
    intervals is summed under the innermost host span open when the gap
    began, or under ``"outside"``."""
    gaps = []
    end = None
    for s, e in sorted(device_intervals):
        if end is not None and s > end:
            gaps.append((end, s))
        end = e if end is None else max(end, e)
    # at equal starts the enclosing (longer) range comes first
    ranges = sorted(host_ranges, key=lambda r: (r[0], -r[1]))
    out = defaultdict(float)
    stack = []
    i = 0
    for g0, g1 in gaps:
        while i < len(ranges) and ranges[i][0] <= g0:
            while stack and stack[-1][1] < ranges[i][0]:
                stack.pop()
            stack.append(ranges[i])
            i += 1
        while stack and stack[-1][1] < g0:
            stack.pop()
        out[stack[-1][2] if stack else "outside"] += (g1 - g0) / 1e9
    return dict(out)


def profile_intervals(prof, names) -> tuple:
    """(host_ranges, device_intervals) from a finished profiler session,
    on the profiler's clock: the host ranges of the spans named in
    ``names``, and the card's operations (the card's mirrors of host
    ranges left out)."""
    names = set(names)
    card = torch.autograd.DeviceType.CUDA
    host, dev = [], []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        s = e.start_ns()
        iv = (s, s + e.duration_ns())
        user = getattr(e, "is_user_annotation", lambda: False)()
        if e.device_type() == card:
            if not user and name not in names:
                dev.append(iv)
        elif name in names:
            host.append(iv + (name,))
    return host, dev


def _write_records(log_dir: str, prof, spans: list, counters: dict) -> None:
    """``spans.<pid>.jsonl`` (one line a span, then one line of the
    counters) and ``idle.<pid>.json`` (:func:`idle_by_span` of the
    session, from the profiler's events) into ``log_dir``."""
    pid = os.getpid()
    with open(os.path.join(log_dir, f"spans.{pid}.jsonl"), "w") as f:
        for s in spans:
            f.write(json.dumps(s._asdict()) + "\n")
        f.write(json.dumps({"counters": counters}) + "\n")
    idle = idle_by_span(*profile_intervals(prof, {s.name for s in spans}))
    with open(os.path.join(log_dir, f"idle.{pid}.json"), "w") as f:
        json.dump(dict(sorted(idle.items(), key=lambda kv: -kv[1])), f,
                  indent=1)


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the enclosed region and write ``trace.<pid>.json`` into
    ``log_dir`` (created if missing); the card's kernels are traced
    whenever CUDA is available, and then the spans and counters recorded
    in the region are written beside it (``spans.<pid>.jsonl``), with the
    card's idle seconds by span (``idle.<pid>.json``).  Yields the
    profiler."""
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    n0 = len(_REC.spans)
    c0 = dict(_REC.counters)
    with profile(activities=activities) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(
        os.path.join(log_dir, f"trace.{os.getpid()}.json"))
    if cuda:
        counters = {k: v - c0.get(k, 0) for k, v in _REC.counters.items()
                    if v != c0.get(k, 0)}
        _write_records(log_dir, prof, _REC.spans[n0:], counters)
