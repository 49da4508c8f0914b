#!/usr/bin/env python3
"""Benchmark of the PyTorch/CUDA port: 1080p octree frames on the card.

The port's counterpart of ``bench.py``: the same scene, protocol and
one-line contract, through ``mega_nerf_viewer_tpu_torch`` on one CUDA card.
Run from the root of a checkout:

    python3 bench_torch.py            # the shell, then the aerial artifact
    python3 bench_torch.py 7          # a synthetic shell of depth 7 alone
    python3 bench_torch.py tree.npz   # one svox npz alone

It prints ONE JSON line on stdout:

  {"metric": "frames_per_sec_1080p", "value": N, "unit": "fps",
   "vs_baseline": N/30, "sorted_mode_fps": N,
   "aerial_fps": N, "aerial_vs_baseline": N/30,
   "aerial_sorted_mode_fps": N}

``value`` is the steady 1080p frame of ``shell_tree(depth=8, basis_dim=9,
sigma_inside=400)`` (bench.py's scene): a hint frame in pixel blocks, the
rays sorted by its hints, the segment budgets settled, then the
record-sorted segmented frame timed, 10 frames a round with their
checksums chained on the card and one scalar read at the end, the median
of 3 rounds after one warm frame.  ``sorted_mode_fps`` times the same frame
left in ray order (``sorted_output=True``; the display applies the inverse
order).  A run with no arguments also measures the aerial artifact
(``tests/fixtures/gen_fixtures.py`` ``make_big_scene_npz``: 175,656 chunks,
depth 9, SH4) with chunk-exact budgets into the ``aerial_*`` keys, and
builds the artifact without JAX when its file is missing.

bench.py's ``projected_v5e8_*``, ``projection_method`` and
``motion_projection_method`` keys have no counterpart: they project a TPU
v5e-8 slice from per-shard timings on one TPU chip.  A frame sharded over
several cards is measured on those cards, not projected from one.

The measurement runs in a child process that streams ``##RECORD## {json}``
lines as each figure lands.  The parent imports nothing but the standard
library (no ``torch``): it prints the best record it knows exactly once,
when the child exits, on SIGTERM or SIGINT, or at ``BENCH_DEADLINE_S``
seconds (default 3300), whichever comes first.  A record with an ``error``
key (and ``value`` 0.0, exit code 3) means that no measurement completed;
it points to the last successful run only by path, commit and date
(``build/bench_torch_last_valid.json``, written by the last full run that
ended with exit code 0), never by its figures.

Environment: ``BENCH_WH=WxH`` sets the frame size and ``BENCH_FORCE_CPU=1``
runs the plain PyTorch path on the CPU (the caller asking for it); either
marks the record ``"smoke": true``, a run whose figures are not to be
reported.  Without ``BENCH_FORCE_CPU`` the run needs a CUDA card and ends
with an ``error`` record where there is none.  ``BENCH_AERIAL_FIXTURE``
names the aerial npz (default ``tests/fixtures/.cache/aerial_sh4_d9.npz``).
On stderr the child names the card and its power limit, and at the end the
kernel launches of the whole run (``# launches {json}``).
"""

import json
import os
import selectors
import signal
import subprocess
import sys
import time
from types import SimpleNamespace

RECORD_MARK = "##RECORD## "
LAUNCHES_MARK = "# launches "
_REPO = os.path.dirname(os.path.abspath(__file__))
LAST_VALID_PATH = os.path.join(_REPO, "build", "bench_torch_last_valid.json")
AERIAL_FIXTURE = os.path.join(_REPO, "tests", "fixtures", ".cache",
                              "aerial_sh4_d9.npz")
AERIAL_DEPTH = 9
# bench.py's pose and timing
FOCAL = 1111.0
CENTER = (-1.4, 0.1, 1.3)
N_FRAMES, ROUNDS = 10, 3
# the largest dense-sample budget a hint frame or segment escalates to
BUDGET_CAP = 512


# ----------------------------------------------------------------------
# parent: the supervisor (standard library only)
# ----------------------------------------------------------------------

def _last_valid_ref():
    """Path, commit and date (no figures) of the last successful run's
    record, if one was written."""
    try:
        with open(LAST_VALID_PATH) as f:
            d = json.load(f)
    except (OSError, ValueError):
        return None
    return {"path": os.path.relpath(LAST_VALID_PATH, _REPO),
            "commit": d.get("commit"), "date": d.get("date"),
            "note": ("record of the last successful bench_torch.py run; "
                     "its numbers are not inlined here, read the file")}


def _error_record(diag: str) -> dict:
    rec = {"metric": "frames_per_sec_1080p", "value": 0.0, "unit": "fps",
           "vs_baseline": 0.0, "error": f"no measurement completed: {diag}"}
    ref = _last_valid_ref()
    if ref is not None:
        rec["last_valid_capture_ref"] = ref
    return rec


def supervise() -> int:
    state = {"record": None, "printed": False, "child": None}

    def emit():
        if state["printed"]:
            return
        state["printed"] = True
        rec = state["record"] or _error_record("child exited silently")
        sys.stdout.write(json.dumps(rec) + "\n")
        sys.stdout.flush()

    def stop_child():
        child = state["child"]
        if child is not None and child.poll() is None:
            child.kill()
            child.wait()

    def on_signal(signum, frame):
        if state["record"] is None:
            state["record"] = _error_record(
                f"killed by signal {signum} before the first measurement "
                "completed")
        emit()
        stop_child()
        os._exit(3 if "error" in state["record"] else 0)

    signal.signal(signal.SIGTERM, on_signal)
    signal.signal(signal.SIGINT, on_signal)

    deadline_s = float(os.environ.get("BENCH_DEADLINE_S", "3300"))
    deadline = time.monotonic() + deadline_s
    env = dict(os.environ, _BENCH_CHILD="1", PYTHONUNBUFFERED="1")
    child = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__)] + sys.argv[1:],
        stdout=subprocess.PIPE, env=env, cwd=_REPO)
    state["child"] = child
    # readiness sentinel: the handlers are installed and the child runs,
    # so from here on a signal always yields the one line
    print(f"# bench: supervising child pid={child.pid} "
          f"deadline={deadline_s:.0f}s", file=sys.stderr, flush=True)

    sel = selectors.DefaultSelector()
    sel.register(child.stdout, selectors.EVENT_READ)
    buf = b""

    def handle_line(raw: bytes):
        s = raw.decode(errors="replace").rstrip("\n")
        if s.startswith(RECORD_MARK):
            try:
                state["record"] = json.loads(s[len(RECORD_MARK):])
            except ValueError:
                print(f"# bench parent: unparseable record line: {s!r}",
                      file=sys.stderr)
        elif s:
            # the child's other output is a diagnostic: the one stdout
            # line is the parent's
            print(s, file=sys.stderr)

    timed_out = False
    while True:
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            timed_out = True
            break
        if sel.select(timeout=min(remaining, 5.0)):
            chunk = os.read(child.stdout.fileno(), 1 << 16)
            if not chunk:
                break                          # EOF: the child exited
            buf += chunk
            while b"\n" in buf:
                line, buf = buf.split(b"\n", 1)
                handle_line(line)
        elif child.poll() is not None:
            buf += child.stdout.read() or b""
            break
    if buf:
        handle_line(buf)

    if timed_out:
        stop_child()
        if state["record"] is None:
            state["record"] = _error_record(
                f"self-deadline {deadline_s:.0f}s expired before the first "
                "measurement completed")
        else:
            state["record"]["note"] = (
                f"self-deadline {deadline_s:.0f}s expired; the record is "
                "the last completed measurement stage")
        emit()
        return 3 if "error" in state["record"] else 0

    rc = child.wait()
    if state["record"] is None:
        state["record"] = _error_record(
            f"bench child exited rc={rc} before the first measurement "
            "completed")
    elif rc != 0 and "error" not in state["record"]:
        state["record"]["note"] = (
            f"bench child exited rc={rc} after this measurement stage; "
            "later stages may be missing")
    emit()
    return 3 if "error" in state["record"] else 0


# ----------------------------------------------------------------------
# child: the measurement (streams ##RECORD## lines)
# ----------------------------------------------------------------------

def _emit_record(record: dict):
    print(RECORD_MARK + json.dumps(record), flush=True)


def _write_last_valid(record: dict):
    """Write the record of a successful full run; smoke runs never do."""
    if record.get("smoke"):
        return
    try:
        commit = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"], capture_output=True,
            text=True, cwd=_REPO, timeout=30).stdout.strip() or None
    except (OSError, subprocess.SubprocessError):
        commit = None
    payload = {"record": record, "commit": commit,
               "date": time.strftime("%Y-%m-%d %H:%M:%S UTC", time.gmtime()),
               "argv": sys.argv[1:],
               "writer": "bench_torch.py (written by a successful run)"}
    tmp = LAST_VALID_PATH + ".tmp"
    try:
        os.makedirs(os.path.dirname(LAST_VALID_PATH), exist_ok=True)
        with open(tmp, "w") as f:
            json.dump(payload, f, indent=1)
            f.write("\n")
        os.replace(tmp, LAST_VALID_PATH)
    except OSError as e:
        print(f"# bench: could not write {LAST_VALID_PATH}: {e!r}",
              file=sys.stderr)


def card_line(device) -> str:
    """The card's name and power limit as nvidia-smi gives them, or what
    ran instead."""
    if device.type != "cuda":
        return f"{device.type} (smoke run, no card)"
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e!r})"
    index = device.index or 0
    return out[index] if len(out) > index else "nvidia-smi printed nothing"


def aerial_artifact(path, depth=AERIAL_DEPTH):
    """Build the aerial artifact into the npz ``path`` without JAX:
    ``tests/fixtures/gen_fixtures.py``'s ``make_big_scene_npz`` (its
    occupancy and colour fields, its svox writer, basis 4, sigma 120)
    over the port's ``field_tree_arrays``.  At depth 9 it is the
    175,656-chunk tree that ``bench.py`` times as its ``aerial_*`` rider.
    ``gen_fixtures`` is loaded by file path; nothing of it that imports the
    JAX package is called.  Returns (path, chunks)."""
    import importlib.util
    import numpy as np
    from mega_nerf_viewer_tpu_torch.n3tree.synthetic import field_tree_arrays
    spec = importlib.util.spec_from_file_location("gen_fixtures", os.path.join(
        _REPO, "tests", "fixtures", "gen_fixtures.py"))
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    data, child, parent, scale, offset, fmt, depths = field_tree_arrays(
        gen.big_occ_v, gen.big_rgb_v, depth=depth, basis_dim=4, sigma=120.0)
    cap = data.shape[0]
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    gen.write_svox_npz(path, data, child.reshape(cap, 2, 2, 2),
                       np.stack([parent, depths], axis=1),
                       invradius=float(scale[0]), offset=offset,
                       data_format=fmt.to_string())
    return path, cap


def setup_source(source, width, height, device=None) -> SimpleNamespace:
    """``bench.py:261-368`` through the port, up to the timed frames.

    ``source`` is an npz path (loaded by ``N3Tree.open``, with chunk-exact
    segment budgets) or a depth (``shell_tree(depth, basis_dim=9,
    sigma_inside=400)``, with the ladder ``DEFAULT_SEGMENTS``).  The hint
    frame escalates ``max_dense`` from 8; overflowing segments double
    their budgets until none overflows.  Returns a namespace whose
    ``frame`` and ``frame_sorted`` render the settled frame (pixel order;
    ray order) and return (image, segment overflow counts); ``device=None``
    is the CUDA card."""
    import numpy as np
    import mega_nerf_viewer_tpu_torch as P
    from mega_nerf_viewer_tpu_torch.device import resolve_device
    from mega_nerf_viewer_tpu_torch.ops import accel
    dev = resolve_device(device)
    t0 = time.time()
    npz = isinstance(source, str)
    if npz:
        tree = P.N3Tree.open(source, device=dev)
        depth = accel.tree_max_depth(tree)
    else:
        depth = int(source)
        tree = P.shell_tree(depth=depth, basis_dim=9, sigma_inside=400.0,
                            device=dev)
    build_s = time.time() - t0
    leaf_map = P.build_leaf_map(tree)
    opt = P.RenderOptions()
    table = P.build_skip_table(tree, opt.sigma_thresh)
    tune = P.device_tuning(dev)
    cs, blk = tune.chunk_size, tune.block
    cam = P.Camera(width, height, FOCAL)
    cam.center = np.asarray(CENTER, np.float32)
    cam._update()

    max_dense = 8
    while True:
        hint, overflow, steps, nrec, skips = P.render_frame_fast(
            tree, leaf_map, cam, opt, max_dense=max_dense, chunk_size=cs,
            block=blk, return_nrec=True, skip_table=table,
            return_skips=True)
        if not int(overflow):
            break
        max_dense *= 2
        if max_dense > BUDGET_CAP:
            raise RuntimeError("pathological dense-sample count")
    alpha = float(hint[..., 3].max())
    order = P.order_from_hints(steps, nrec, skips)
    segments = [list(s) for s in P.DEFAULT_SEGMENTS]
    seg_counts = None
    if npz:
        try:
            seg_counts = [list(s) for s in P.seg_counts_from_hints(
                nrec.reshape(-1)[order[0]], cs)]
        except ValueError as e:
            # a chunk records beyond the largest chunk-exact budget: the
            # ladder escalates per segment instead
            print(f"# chunk-exact budgets unavailable ({e}); ladder "
                  f"segments", file=sys.stderr)

    def layout():
        if seg_counts is not None:
            return dict(segments=None,
                        seg_counts=tuple(tuple(s) for s in seg_counts))
        return dict(segments=tuple(tuple(s) for s in segments))

    def render(sorted_output=False, **kw):
        return P.render_frame_fast_segmented(
            tree, leaf_map, cam, opt, order=order, chunk_size=cs,
            skip_table=table, sorted_output=sorted_output, **kw)

    while True:
        _, seg_overflow = render(**layout())
        ov = seg_overflow.cpu().numpy()
        if not ov.any():
            break
        esc = seg_counts if seg_counts is not None else segments
        for i in np.flatnonzero(ov):
            esc[i][1] = max(1, esc[i][1] * 2)
            if esc[i][1] > BUDGET_CAP:
                raise RuntimeError(f"segment {i} budget beyond {BUDGET_CAP}")
    settled = layout()
    return SimpleNamespace(
        tree=tree, depth=depth, build_s=build_s, device=dev,
        max_dense=max_dense, order=order,
        segments=settled["segments"], seg_counts=settled.get("seg_counts"),
        alpha=alpha, frame=lambda: render(**settled),
        frame_sorted=lambda: render(True, **settled))


def chain(frame_fn, n, acc):
    """``n`` frames, each one's checksum added to the device scalar ``acc``
    (nothing read on the host)."""
    for _ in range(n):
        img, _ = frame_fn()
        acc = acc + img.sum()
    return acc


def time_frames(frame_fn, device, rounds=ROUNDS):
    """fps of ``frame_fn``: one warm frame, then the median of ``rounds``
    rounds of :data:`N_FRAMES` chained frames, each forced by one scalar
    read."""
    import torch
    img, _ = frame_fn()
    float(img.sum())
    vals = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        float(chain(frame_fn, N_FRAMES, torch.zeros((), device=device)))
        vals.append(N_FRAMES / (time.perf_counter() - t0))
    return sorted(vals)[rounds // 2]


def measure_source(source, record, prefix, width, height, smoke,
                   device=None):
    """Set up and time one source into ``record`` (``value`` for the
    primary, ``<prefix>fps`` for a rider), streaming the record as each
    figure lands."""
    s = setup_source(source, width, height, device)
    fps = time_frames(s.frame, s.device)

    def put(fps):
        if prefix:
            record[prefix + "fps"] = round(fps, 3)
            record[prefix + "vs_baseline"] = round(fps / 30.0, 3)
        else:
            record.update(metric="frames_per_sec_1080p", value=round(fps, 3),
                          unit="fps", vs_baseline=round(fps / 30.0, 3))
            if smoke:
                record["smoke"] = True         # not a reportable run

    put(fps)
    _emit_record(record)
    layout = s.seg_counts if s.seg_counts is not None else s.segments
    print(f"# [{prefix or 'primary'}] card={card_line(s.device)} "
          f"chunks={int(s.tree.capacity)} depth={s.depth} "
          f"build={s.build_s:.1f}s max_dense={s.max_dense} "
          f"segments={list(layout)} {1e3 / fps:.3f} ms/frame "
          f"rays/s={fps * width * height:.3e} alpha_max={s.alpha:.3f}",
          file=sys.stderr)
    sorted_fps = time_frames(s.frame_sorted, s.device)
    # the pixel-order frame is the sorted one plus the unpermute, so a
    # primary reading far below it was disturbed: time it once more and
    # keep the better figure
    if fps < 0.75 * sorted_fps:
        print(f"# primary fps {fps:.3f} under 0.75x the sorted "
              f"{sorted_fps:.3f}; timing it again", file=sys.stderr)
        fps = max(fps, time_frames(s.frame, s.device))
        put(fps)
    record[prefix + "sorted_mode_fps"] = round(sorted_fps, 3)
    _emit_record(record)
    print(f"# [{prefix or 'primary'}] sorted-frame display mode: "
          f"{sorted_fps:.3f} fps ({1e3 / sorted_fps:.3f} ms/frame; the "
          f"frame stays in ray order)", file=sys.stderr)


def child_main() -> int:
    width, height = 1920, 1080
    wh = os.environ.get("BENCH_WH")
    if wh:
        width, height = (int(x) for x in wh.split("x"))
    force_cpu = bool(os.environ.get("BENCH_FORCE_CPU"))
    device = "cpu" if force_cpu else None
    smoke = bool(force_cpu or wh)

    source = sys.argv[1] if len(sys.argv) > 1 else 8
    if isinstance(source, str) and not source.endswith(".npz"):
        source = int(source)
    record: dict = {}
    measure_source(source, record, "", width, height, smoke, device)

    # a run with no arguments also measures the aerial artifact; a failure
    # there never costs the shell's record, already emitted
    aerial = os.environ.get("BENCH_AERIAL_FIXTURE", AERIAL_FIXTURE)
    named = "BENCH_AERIAL_FIXTURE" in os.environ
    if (len(sys.argv) <= 1 and not smoke and not named
            and not os.path.exists(aerial)):
        try:
            t0 = time.time()
            aerial_artifact(aerial)
            print(f"# aerial artifact built in {time.time() - t0:.0f} s",
                  file=sys.stderr)
        except Exception as e:
            print(f"# aerial artifact build failed: {e!r}", file=sys.stderr)
    if len(sys.argv) <= 1 and os.path.exists(aerial) and (not smoke
                                                          or named):
        try:
            measure_source(aerial, record, "aerial_", width, height, smoke,
                           device)
        except Exception as e:
            print(f"# aerial rider unavailable: {e!r}", file=sys.stderr)

    _write_last_valid(record)
    _emit_record(record)
    from mega_nerf_viewer_tpu_torch import kernels
    print(LAUNCHES_MARK + json.dumps(dict(kernels.LAUNCHES)),
          file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    if os.environ.get("_BENCH_CHILD"):
        sys.exit(child_main())
    sys.exit(supervise())
