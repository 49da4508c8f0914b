"""One run of one cell: set up, warm up, drive the window, read the
metrics, check the outputs against the plain reference, and build the
result's line.

The order matters for what each number means:

1. set-up (``setup_s`` ends at the first timed frame): the scene file
   and the kernels (built once per checkout), the tree on the card, the
   Viewer, the warm-up frames;
2. the window, driven by the mix's kind (``traffic/<kind>.py``), with
   ``--trace 1`` under the spans, counters and the profiler of
   ``trace.py``;
3. the check frames: the Viewer once more at the seed's check views
   (the kind's own ``check_frames`` where it has one);
4. ``memory_peak_bytes`` read, the program's state freed;
5. the reference, from the scene file (and a guided frame's model, from
   its configuration) alone, at each kept frame's camera and of its kind,
   and the comparison (``check.py``).
"""

from __future__ import annotations

import statistics
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

from . import cell, check, drive, registry, scenes
from .reference import render as ref
from .trace import Instruments

FORBIDDEN = ("jax", "jaxlib", "flax", "mega_nerf_viewer_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole."""
    return sorted({m for m in sys.modules
                   if m.split(".", 1)[0] in FORBIDDEN})


def reference_options(cfg: dict, basis_dim: int) -> dict:
    o = cell.render_options(cfg)
    o.setdefault("basis_minmax", [0, basis_dim - 1])
    return o


def reference_frames(cfg: dict, scene_path: str, kept, device,
                     shade_dtype=torch.float32,
                     base: str = registry.HERE) -> list:
    """The reference's frame at each kept frame's camera, from the scene
    file alone (one frame per distinct camera and kind).  A kept frame's
    camera dict names its kind under ``frame`` (``voxel`` when it names
    none), and ``reference/<frame>.py`` renders it; the configuration's
    model, where it has one, reaches it as its ``models/<arch>.py``'s
    plain forward beside the model's block."""
    host = scenes.load_svox(scene_path)
    tree = ref.Tree(host, device)
    opt = reference_options(cfg, tree.basis_dim)
    model = None
    if "model" in cfg:
        spec = cfg["model"]
        model = (spec, registry.model_module(spec["arch"], base).reference(
            spec, device))
    out, memo = [], {}
    for _, _, cam in kept:
        kind = cam.get("frame", "voxel")
        key = (kind, cam["transform"].tobytes())
        if key not in memo:
            frame = registry.frame_reference(kind, base)
            with torch.no_grad():
                memo[key] = frame(tree, cam, opt, shade_dtype=shade_dtype,
                                  model=model)
        out.append(memo[key])
    return out


def device_block(device, chips: int) -> dict:
    if device.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": chips,
                "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}
    return {"platform": device.type, "kind": device.type, "count": chips,
            "memory_peak_bytes": 0}


def power_limit() -> str:
    import subprocess
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device="cuda", t_start: float = None, root: str = None,
             cfg: dict = None, mix: dict = None, limits: dict = None,
             control: bool = False, log=print,
             base: str = registry.HERE) -> tuple:
    """Run one cell once.  Returns (result dict, list of check lines).
    ``cfg``, ``mix`` and ``limits`` replace the cell's files (the tests'
    tiny sizes on the CPU), and ``base`` stands in for ``perfbench/``
    where the cell's parts are found (``registry``); the command line
    passes none of them.  With ``control`` the result also carries
    ``control``: the numbers the comparison gives the reference in the
    nearest lower precision (its colour arithmetic, and a model's forward,
    in bfloat16), put in the program's place."""
    t_start = time.perf_counter() if t_start is None else t_start
    root = root or registry.ROOT
    bench = registry.benchmark(root)
    wl = registry.workload(bench, workload)
    cfg = cfg or registry.config(wl["config"], base)
    mix = mix or registry.traffic(wl["traffic"], base)
    limits = limits or registry.check(workload, base)
    device = torch.device(device)
    plan = drive.Plan(mix, seed)
    kind = registry.kind_driver(mix["kind"], base)

    t_program = time.perf_counter()
    prog = cell.Program(root, cfg, mix, device, plan.start_deg, base)
    if prog.scene_build_s:
        # a checkout's first run: the check records its set-up apart
        log(f"# scene built in {prog.scene_build_s:.1f} s (inside "
            f"setup_s): {prog.scene_path}")
    v = prog.viewer
    t_warm = time.perf_counter()
    kind.warm(v, mix, plan, device, prog.base_pose)
    setup_s = time.perf_counter() - t_start
    log("# setup steps (s): imports and card "
        f"{t_program - t_start:.3f}, "
        + ", ".join(f"{n} {d:.3f}" for n, d in prog.setup_steps)
        + f", warm-up {time.perf_counter() - t_warm:.3f}")

    inst = Instruments(device) if trace else None
    if inst is None:
        win = kind.run(v, mix, plan, seconds, device, prog.base_pose)
    else:
        with inst.installed(v):
            win = kind.run(v, mix, plan, seconds, device, prog.base_pose)
    window_kept = len(win.kept)
    check_frames = getattr(kind, "check_frames", drive.check_frames)
    win.kept += check_frames(v, mix, plan, prog.base_pose, win.units)
    drive.sync(device)
    dev_info = device_block(device, int(wl["chips"]))
    totals = timeline = None
    spans, counts, span_log, device_ops_s = {}, {}, [], {}
    if inst is not None:
        totals = inst.totals()
        timeline = inst.timeline()
        totals.update({f"{k}_s": v for k, v in inst.kernel_s.items()})
        device_ops_s = dict(inst.device_ops_s)
        spans, counts, span_log = dict(inst.spans), dict(inst.counts), \
            inst.log
        inst = None             # its wraps hold the Viewer
    if timeline is not None:
        dev_info["busy_s"], dev_info["window_s"] = timeline[0], timeline[1]

    # the program's state goes before the reference runs; its kept frames
    # are its outputs and stay
    scene_path = prog.scene_path
    del v
    prog.free()
    t_ref = time.perf_counter()
    refs = reference_frames(cfg, scene_path, win.kept, device, base=base)
    verdict = check.judge([(k[1], r) for k, r in zip(win.kept, refs)],
                          limits, shares=control)
    ref_s = time.perf_counter() - t_ref
    ctl = None
    if control:
        low = reference_frames(cfg, scene_path, win.kept, device,
                               shade_dtype=torch.bfloat16, base=base)
        ctl = check.judge(list(zip(low, refs)), limits, shares=True)
    correct = bool(win.kept) and check.passed(verdict["numbers"])

    ctx = SimpleNamespace(window=win, setup_s=setup_s, mix=mix, cfg=cfg,
                          spans=spans, counts=counts,
                          totals=totals or {}, timeline=timeline,
                          device_ops_s=device_ops_s)
    metrics = {}
    for m in registry.cell_metrics(bench, wl, trace):
        val = registry.metric_reader(m["name"], base)(ctx)
        if val is not None:
            metrics[m["name"]] = {"value": val, "unit": m["unit"]}
    lat = win.latencies
    log(f"# {workload} seed {seed}: {win.units} units in {win.seconds:.3f} s"
        + (f"; latency median {1e3 * statistics.median(lat):.3f} ms, "
           f"max {1e3 * max(lat):.3f} ms" if lat else "")
        + f"; setup {setup_s:.3f} s; reference {ref_s:.1f} s over "
        f"{len(win.kept)} kept frames ({window_kept} of the window, "
        f"{len(win.kept) - window_kept} at the check views "
        f"{plan.check_views})")
    if lat:
        q = np.percentile(np.asarray(lat) * 1e3, (50, 90, 95, 97, 99))
        log("# unit ms at p50, p90, p95, p97, p99: "
            + ", ".join(f"{x:.3f}" for x in q))
        slow = sorted(range(len(lat)), key=lambda i: -lat[i])[:5]
        log("# slowest units (index, ms): "
            + ", ".join(f"({i}, {1e3 * lat[i]:.3f})" for i in slow))
        for i in slow if span_log else ():
            t0, t1 = win.starts[i], win.starts[i] + lat[i]
            parts = [f"{n} {1e3 * d:.2f}" for n, t, d in span_log
                     if t0 <= t <= t1]
            log(f"#   unit {i}: " + "; ".join(parts))
    if win.apart:
        # frames the kind times apart from its units (a stop's drag poses)
        q = np.percentile(np.asarray(win.apart) * 1e3, (50, 90, 99))
        log(f"# {len(win.apart)} frames timed apart, ms at p50, p90, p99: "
            + ", ".join(f"{x:.3f}" for x in q))
    if trace:
        log(f"# trace totals {totals}; counts {counts}")
    result = {"correct": correct, "attempted": win.units,
              "failed": int(verdict["failed"]) if win.kept else win.units,
              "metrics": metrics, "device": dev_info}
    if timeline is not None:
        result["breakdown"] = {"device_ops": timeline[2],
                               "idle_gaps": timeline[3]}
    if ctl is not None:
        result["control"] = {k: v_ for k, (v_, _) in ctl["numbers"].items()}
        result["control_shares"] = ctl["shares"]
        result["program_shares"] = verdict["shares"]
    numbers = verdict["numbers"]
    result["checked"] = {k: {"value": v_, "limit": lim}
                         for k, (v_, lim) in numbers.items()}
    lines = [f"check {k}: {v_!r} (limit {lim!r})"
             for k, (v_, lim) in numbers.items()]
    return result, lines
