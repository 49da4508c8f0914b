"""Stage timing and the common prelude of the port's motion probes
(``tools_torch/*.py``).

A stage is forced with ``torch.cuda.synchronize()``: nothing stands
between this process and the card, so no scalar fetch is needed to make
a stage's work finish before its clock stops.  :func:`time_stage` gives a
stage's device milliseconds by CUDA events, its host milliseconds by
``time.perf_counter()`` (each the median of ``n`` calls after one warm
call) and the kernel launches of one call (``kernels.LAUNCHES`` deltas), so
a host-paced stage reads against its launch count.  On the CPU (a smoke
run) there is no device clock: ``device_ms`` is ``None``, printed as "not
measured".

The three probes share this module and ``benchmarks_torch/
_overrides_torch.py`` (the knobs, the camera, the orbit step); they never
import each other.
"""

import json
import os
import sys
import time
from types import SimpleNamespace

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for _d in (os.path.join(REPO, "benchmarks_torch"), REPO):
    if _d not in sys.path:
        sys.path.insert(0, _d)

import numpy as np
import torch

import _overrides_torch  # noqa: E402

# the JAX tools' scene: the depth-8 shell at 1080p, f = 1111, chunk 2176,
# the async policy, 3-degree orbit poses
WIDTH, HEIGHT, DEPTH, FOCAL = 1920, 1080, 8, 1111.0
CHUNK = 2176
DEG = 3.0


def sync(dev) -> None:
    """Force every stage queued so far (a no-op on the CPU)."""
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def settled_viewer(width, height, depth, dev):
    """The JAX tools' Viewer: ``shell_tree(depth, basis_dim=9,
    sigma_inside=400)``, the camera at the benchmarks' centre, chunk 2176,
    the async policy."""
    import mega_nerf_viewer_tpu_torch as P
    tree = P.shell_tree(depth=depth, basis_dim=9, sigma_inside=400.0,
                        device=dev)
    cam = _overrides_torch.camera(width, height, FOCAL)
    v = P.Viewer(tree, camera=cam, options=P.RenderOptions(), device=dev)
    v.fast_chunk_size = CHUNK
    v.overflow_policy = "async"
    return v


def orbit(v, width) -> None:
    """One 3-degree orbit step of the Viewer's camera."""
    _overrides_torch.orbit_step(v, DEG, width)


def launch_delta(before: dict) -> dict:
    """The kernels launched since ``before`` (a copy of the counts)."""
    from mega_nerf_viewer_tpu_torch import kernels
    return {k: n - before.get(k, 0) for k, n in kernels.LAUNCHES.items()
            if n != before.get(k, 0)}


def time_stage(fn, dev, n=3) -> SimpleNamespace:
    """``fn`` once to warm, then ``n`` forced calls.  Returns
    (device_ms, host_ms: medians, device_ms ``None`` on the CPU;
    host_runs; launches of the last call; out: the last call's result)."""
    from mega_nerf_viewer_tpu_torch import kernels
    dev = torch.device(dev)
    cuda = dev.type == "cuda"
    fn()
    sync(dev)
    dev_ms, host_ms = [], []
    for _ in range(n):
        before = dict(kernels.LAUNCHES)
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        out = fn()
        if cuda:
            end.record()
        sync(dev)
        host_ms.append((time.perf_counter() - t0) * 1e3)
        if cuda:
            dev_ms.append(start.elapsed_time(end))
        launches = launch_delta(before)
    return SimpleNamespace(
        device_ms=float(np.median(dev_ms)) if cuda else None,
        host_ms=float(np.median(host_ms)), host_runs=host_ms,
        launches=launches, out=out)


def fmt_ms(ms) -> str:
    return "not measured" if ms is None else f"{ms:.3f} ms"


def stage_line(tag: str, st) -> str:
    """One printed stage: device and host medians, launches, host runs."""
    return (f"[{tag}] device {fmt_ms(st.device_ms)}  host "
            f"{st.host_ms:.3f} ms  launches {json.dumps(st.launches)}  "
            f"(host runs: {[round(x, 2) for x in st.host_runs]})")


def stage_record(st) -> dict:
    return dict(device_ms=st.device_ms, host_ms=st.host_ms,
                launches=st.launches)


def plain_segments(segs) -> list:
    """Segments as plain (float, int) pairs, for printing and JSON."""
    return [(float(f), int(md)) for f, md in segs]


def card(dev) -> str:
    """The card's name and power limit (``bench_torch.card_line``)."""
    from bench_torch import card_line
    return card_line(torch.device(dev))


def emit(record: dict, dev, smoke: bool) -> None:
    """Print the probe's summary as one JSON line (``"smoke": true`` on an
    overridden run, the card and its power limit, the whole process's
    kernel launches), then ``done``."""
    from mega_nerf_viewer_tpu_torch import kernels
    record["card"] = card(dev)
    record["launches"] = dict(kernels.LAUNCHES)
    if smoke:
        record["smoke"] = True           # env-overridden run: NOT reportable
    print(json.dumps(record), flush=True)
    print("done", flush=True)
