"""Spans, counters and kernel timings around the calls into each of the
program's layers, recorded from the benchmark's side, and the reading of
the profiler's timeline.  Installed only in a ``--trace 1`` run.

Spans (host clock, each also a ``torch.profiler`` range named ``pb:<layer
call>`` that labels the device's idle gaps):

* ``viewer.render``: the ``Viewer.render`` call, a frame at a time;
* ``accel.*``: the frame, order, hint and re-hint calls the Viewer makes
  into ``ops.accel``; ``render.render_frame``, the exact frame it falls
  back to;
* ``kernels.march``: each launch of kernel A.

Counters: the calls of ``order_from_hints``, ``order_from_hints_device``,
``order_from_packed_device`` and ``render_frame_motion`` (the method of
``benchmarks_torch/motion1080p.py``: wraps patched on ``ops.accel``).

Kernel timings: kernel A's device time from the profiler's records of
``mnv::march_kernel`` (on a host-paced frame CUDA events around a launch
would also time the host's launch overhead), and every device
operation's seconds in the window by its name (``device_ops_s``), which
the metric readers get as ``ctx.device_ops_s``.  Kernel A's launches,
rays, steps and shaded samples are counted (the sums on the device, read
once after the window).
"""

from __future__ import annotations

import bisect
import contextlib
import functools
import inspect
import time
from collections import defaultdict

import torch

# device time by kernel, from the profiler's records (CUPTI): on a
# host-paced frame, CUDA events around a launch also count the host's
# launch overhead, so a kernel's own time is read from the trace
KERNELS = {"march": "mnv::march_kernel"}
COUNTED = ("order_from_hints", "order_from_hints_device",
           "order_from_packed_device", "render_frame_motion")
# the calls the Viewer makes into ops.accel
ACCEL_SPANS = ("render_frame_fast_segmented", "render_frame_fast",
               "dilate_packed", "dilate_hints", "pack_hints",
               "hint_class_cdf", "hint_class_cdf_packed",
               "segments_from_hint_cdf", "quarter_order_from_packed",
               "order_from_ns_steps_device", "build_leaf_map") + COUNTED


class Instruments:
    """What one traced window recorded."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.spans = defaultdict(list)
        self.log = []           # (name, host start, seconds) in order
        self.counts = defaultdict(int)
        self.march_launches = 0
        self.march_rays = 0
        self.march_dims = None
        self._acc = None
        self.prof = None
        self.kernel_s = {}
        self.device_ops_s = {}

    # ------------------------------------------------------------------
    def _span(self, name, fn):
        label = "pb:" + name

        @functools.wraps(fn)
        def wrapped(*a, **kw):
            t0 = time.perf_counter()
            with torch.profiler.record_function(label):
                out = fn(*a, **kw)
            dt = time.perf_counter() - t0
            self.spans[name].append(dt)
            self.log.append((name, t0, dt))
            return out
        return wrapped

    def _counted(self, name, fn):
        inner = self._span("accel." + name, fn)

        @functools.wraps(fn)
        def wrapped(*a, **kw):
            self.counts[name] += 1
            return inner(*a, **kw)
        return wrapped

    def _add(self, key, value):
        if self._acc is None:
            self._acc = {}
        v = value.to(torch.int64)
        self._acc[key] = self._acc[key] + v if key in self._acc else v

    def _march(self, fn):
        sig = inspect.signature(fn)
        span = self._span("kernels.march", fn)

        @functools.wraps(fn)
        def wrapped(*a, **kw):
            b = sig.bind(*a, **kw)
            if b.arguments.get("gate") is not None:
                return span(*a, **kw)
            out = span(*a, **kw)
            self.march_launches += 1
            R = int(b.arguments["d"].shape[0])
            cols = int(b.arguments["basis"].shape[1])
            self.march_rays += R
            self.march_dims = (cols, bool(b.arguments["use_sh"]),
                               int(b.arguments["tree"].data_dim))
            self._add("march_steps", out[2].sum())
            self._add("march_shaded",
                      out[3].clamp(max=int(b.arguments["max_dense"])).sum())
            return out
        return wrapped

    @contextlib.contextmanager
    def installed(self, viewer):
        """Patch the wraps in for the window, and the profiler on."""
        from mega_nerf_viewer_tpu_torch import kernels
        from mega_nerf_viewer_tpu_torch import viewer as viewer_mod
        from mega_nerf_viewer_tpu_torch.ops import accel
        patches = [(viewer, "render", self._span("viewer.render",
                                                 viewer.render)),
                   (viewer_mod, "render_frame",
                    self._span("render.render_frame",
                               viewer_mod.render_frame)),
                   (kernels, "march", self._march(kernels.march))]
        for n in ACCEL_SPANS:
            fn = getattr(accel, n)
            patches.append((accel, n, self._counted(n, fn) if n in COUNTED
                            else self._span("accel." + n, fn)))
        saved = [(obj, n, obj.__dict__.get(n, None), n in obj.__dict__)
                 for obj, n, _ in patches]
        for obj, n, new in patches:
            setattr(obj, n, new)
        if self.cuda:
            from torch.profiler import ProfilerActivity, profile
            self.prof = profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA])
            self.prof.start()
        try:
            with torch.profiler.record_function("pb:window"):
                yield self
            if self.cuda:
                torch.cuda.synchronize()
        finally:
            if self.prof is not None:
                self.prof.stop()
            for obj, n, old, had in saved:
                if had:
                    setattr(obj, n, old)
                else:
                    delattr(obj, n)

    # ------------------------------------------------------------------
    def totals(self) -> dict:
        """Device sums and launch counts, read once after the window."""
        acc = {k: int(v) for k, v in (self._acc or {}).items()}
        out = dict(acc)
        if self.march_launches:
            out["march_launches"] = self.march_launches
            out["march_rays"] = self.march_rays
            out["march_dims"] = self.march_dims
        return out

    def timeline(self):
        """(busy_s, window_s, device_ops, idle_gaps) from the profiler's
        trace, or None without one.  Busy is the union of the device's
        operation intervals inside the ``pb:window`` range; idle gaps are
        summed by the innermost ``pb:`` range open on the host when each
        began."""
        if self.prof is None:
            return None
        res = self.prof.profiler.kineto_results
        dev_iv, by_name, host = [], defaultdict(float), []
        w0 = w1 = None
        for e in res.events():
            name = e.name()
            if name.startswith("pb:") or getattr(
                    e, "is_user_annotation", lambda: False)():
                # the host's ranges, and their mirrors on the device's
                # timeline, which are no device work
                if e.device_type() == torch.autograd.DeviceType.CUDA:
                    continue
                if not name.startswith("pb:"):
                    continue
                s = e.start_ns()
                iv = (s, s + e.duration_ns(), name[3:])
                if iv[2] == "window":
                    w0, w1 = iv[0], iv[1]
                else:
                    host.append(iv)
            elif e.device_type() == torch.autograd.DeviceType.CUDA:
                s = e.start_ns()
                dev_iv.append((s, s + e.duration_ns(), name))
        if w0 is None or not dev_iv:
            return None
        dev_iv.sort()
        busy, gaps = 0, []
        cur_s = cur_e = None
        for s, e, name in dev_iv:
            s, e = max(s, w0), min(e, w1)
            if e <= s:
                continue
            by_name[name] += (e - s) / 1e9
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    busy += cur_e - cur_s
                    gaps.append((cur_e, s))
                elif s > w0:
                    gaps.append((w0, s))
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            busy += cur_e - cur_s
            if cur_e < w1:
                gaps.append((cur_e, w1))
        host.sort()
        idle = defaultdict(float)
        starts = [h[0] for h in host]
        for g0, g1 in gaps:
            label = "no benchmark span"
            i = bisect.bisect_right(starts, g0)
            # the innermost range open at g0 is the latest-starting one
            # that still covers it (ranges nest: look back a bounded way)
            for h in reversed(host[max(0, i - 64):i]):
                if h[1] >= g0:
                    label = h[2]
                    break
            idle[label] += (g1 - g0) / 1e9
        self.device_ops_s = dict(by_name)
        self.kernel_s = {key: sum(v for n, v in by_name.items()
                                  if n.startswith(prefix))
                         for key, prefix in KERNELS.items()}
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        gaps_top = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
        return busy / 1e9, (w1 - w0) / 1e9, [list(t) for t in top], \
            [list(g) for g in gaps_top]
