"""The port's motion probes (``tools_torch/``) against the JAX package on
the CPU, at 160x90 on the depth-5 sigma = 400 shell.

The JAX tools run at 1080p when they are imported, so the JAX side here
replays each tool's protocol through the JAX package's ``accel``
functions, Viewer and ``parallel`` module; the port's side is each
probe's own ``run`` (and ``main`` for its printed contract).  Integers are
equal: segments, packed hints, orders, ``max_dense``, settled budgets,
overflow counts and which of the Viewer's wrapped calls fired in each
pose.  Frames are within BASELINE's 1e-3: XLA:CPU's ``exp`` moves the
sigma = 400 shell by about 2.7e-5.

The margin probe starts a process group, so it runs in a gloo worker
process at a world of one (``probe_motion_margin.main`` under
``BENCH_FORCE_CPU``), started first so it runs while JAX compiles; JAX's
sharded motion pose runs here on a one-device mesh.
"""

import contextlib
import copy
import importlib.util
import io
import json
import os
import re
import signal
import subprocess
import sys
from unittest import mock

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from mega_nerf_viewer_tpu import Viewer as JViewer
from mega_nerf_viewer_tpu import parallel as JP
from mega_nerf_viewer_tpu.camera import Camera as JCamera
from mega_nerf_viewer_tpu.n3tree import shell_tree as jshell_tree
from mega_nerf_viewer_tpu.ops import accel as JA
from mega_nerf_viewer_tpu.ops.pallas_march import build_skip_table
from mega_nerf_viewer_tpu.options import RenderOptions as JOptions
from mega_nerf_viewer_tpu.utils.tuning import device_tuning

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = os.path.join(REPO, "tools_torch")
W, H, DEPTH = 160, 90, 5
TOL = 1e-3
CENTER = (-1.4, 0.1, 1.3)
SPAWN_TIMEOUT = 240


def load_tool(name):
    """``tools_torch/<name>.py`` loaded by file path."""
    spec = importlib.util.spec_from_file_location(
        f"torch_tool_{name}", os.path.join(TOOLS, name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def segs_of(segs):
    return [(float(f), int(md)) for f, md in segs]


# ----------------------------------------------------------------------
# the JAX side: each tool's protocol through the JAX package
# ----------------------------------------------------------------------
def jax_viewer():
    tree = jshell_tree(depth=DEPTH, basis_dim=9, sigma_inside=400.0)
    cam = JCamera(W, H, 1111.0)
    cam.center = np.array(CENTER, np.float32)
    cam._update()
    v = JViewer(tree, camera=cam, options=JOptions())
    v.fast_chunk_size = 2176
    v.overflow_policy = "async"
    return v


def jax_orbit(v):
    v.camera.begin_drag(0.0, 0.0, False, True)
    v.camera.drag_update(-np.deg2rad(3.0) * W / 2.0, 0.0)
    v.camera.end_drag()


def jax_phase_timing():
    """``tools/motion_phase_timing.py:52-82`` and its C and C3 frames."""
    v = jax_viewer()
    v.render(fetch=False)
    for _ in range(5):
        jax_orbit(v)
        v.render(fetch=False)
    v.render(fetch=False)
    R = W * H
    ph = v._hints_packed
    dp = JA.dilate_packed(ph, width=W, height=H, window=64)
    dp_dir = JA.dilate_packed(ph, width=W, height=H, window=(32, 64))

    def segs(h, **kw):
        return tuple(JA.segments_from_hint_cdf(
            np.asarray(JA.hint_class_cdf_packed(h)), R, **kw))

    out = dict(ph=np.asarray(ph), segs_steady=segs(ph),
               segs_motion=segs(dp, headroom=True),
               segs_motion_dir=segs(dp_dir, headroom=True),
               order_m=JA.order_from_packed_device(dp),
               order_md=JA.order_from_packed_device(dp_dir))

    def frame(order, sg):
        res = JA.render_frame_fast_segmented(
            v.tree, v._leaf_map, v.camera, v.options, order=order,
            segments=sg, chunk_size=2176, need_votes=False,
            dynamic_knobs=True, skip_table=None, device_fallback=False,
            return_hints="packed", sorted_output=False)
        return np.asarray(res[0]), np.asarray(res[1])
    out["C"] = frame(out["order_m"], out["segs_motion"])
    out["C3"] = frame(out["order_md"], out["segs_motion_dir"])
    return out


WRAPS = (("dilate", "dilate_packed"), ("order", "order_from_packed_device"),
         ("frame", "render_frame_fast_segmented"),
         ("motion", "render_frame_motion"))


def jax_viewer_probe():
    """``tools/motion_viewer_probe.py``'s protocol on JAX's Viewer with the
    port probe's four wraps (tags only) and its second, dilate run."""
    v = jax_viewer()
    cam = v.camera
    pose0 = (cam.center.copy(), cam.v_back.copy())

    def rewind():
        v.camera.center, v.camera.v_back = pose0[0].copy(), pose0[1].copy()
        v.camera._update()
    v.render(fetch=False)
    for _ in range(4):
        jax_orbit(v)
        v.render(fetch=False)
    rewind()
    v.render(fetch=False)
    R = W * H
    dp = JA.dilate_packed(v._hints_packed, width=W, height=H,
                          window=(32, 64))
    cdf = np.asarray(JA.hint_class_cdf_packed(dp))
    order_x = JA.order_from_packed_device(dp)
    out = {"headroom": {}, "poses": {}}
    for tag, hroom in (("headroom", True), ("NO-headroom", False)):
        sg = tuple(JA.segments_from_hint_cdf(cdf, R, headroom=hroom))
        res = JA.render_frame_fast_segmented(
            v.tree, v._leaf_map, v.camera, v.options, order=order_x,
            segments=sg, chunk_size=v.fast_chunk_size, need_votes=False,
            dynamic_knobs=True, skip_table=getattr(v, "_skip_table", None),
            device_fallback=False, return_hints="packed",
            sorted_output=False)
        out["headroom"][tag] = dict(segs=segs_of(sg),
                                    overflow_counts=np.asarray(
                                        res[1]).tolist())
    log = []
    with contextlib.ExitStack() as stack:
        for tag, name in WRAPS:
            orig = getattr(JA, name)

            def wrap(*a, _orig=orig, _tag=tag, **k):
                log.append(_tag)
                return _orig(*a, **k)
            stack.enter_context(mock.patch.object(JA, name, wrap))
        for i, mode in enumerate(("rehint", "dilate")):
            if i:
                v.motion_mode = mode
                rewind()
                v.render(fetch=False)
            poses = []
            for _ in range(6):
                log.clear()
                jax_orbit(v)
                v.render(fetch=False)
                poses.append(dict(
                    calls=list(log), segs=segs_of(v._segments or ()),
                    motion_segs=segs_of(v._segments_motion or ())))
            out["poses"][mode] = poses
    return out


def jax_margin():
    """``tools/probe_motion_margin.py``'s setup, then for margin 1 and 0
    the sharded re-hint pose on a one-device mesh, escalated by
    ``bench.py:798-819``'s rule (and margin 0 again with no tolerance)."""
    tree = jshell_tree(depth=DEPTH, basis_dim=9, sigma_inside=400.0)
    lm = JA.build_leaf_map(tree)
    opt = JOptions()
    tab = build_skip_table(tree, opt.sigma_thresh)
    tune = device_tuning()
    cs = tune.chunk_size
    cam = JCamera(W, H, 1111.0)
    cam.center = np.array(CENTER, np.float32)
    cam._update()
    md = 8
    while True:
        _, ov, steps, nrec, skips = JA.render_frame_fast(
            tree, lm, cam, opt, max_dense=md, chunk_size=cs,
            block=tune.block, return_nrec=True, skip_table=tab,
            return_skips=True)
        if not bool(ov):
            break
        md *= 2
    R = W * H
    ph = JA.pack_hints(jnp.asarray(steps), jnp.asarray(nrec),
                       jnp.asarray(skips))
    order = JA.order_from_packed_device(ph)
    qperm = JA.quarter_order_from_packed(ph, width=W)
    cdf = np.asarray(JA.hint_class_cdf(jnp.asarray(nrec)))
    mesh = JP.make_mesh((1,), (JP.RAY_AXIS,), jax.devices()[:1])
    pix_str, qpix_str = JP.motion_episode_layout(
        order, qperm, mesh=mesh, chunk_size=cs, hint_chunk=cs)
    cam2 = copy.deepcopy(cam)
    cam2.begin_drag(0.0, 0.0, False, True)
    cam2.drag_update(-np.deg2rad(3.0) * W / 2.0, 0.0)
    cam2.end_drag()
    out = {"max_dense": md}
    for key, margin, tol in (("m1", 1, max(1024, R // 512)),
                             ("m0", 0, max(1024, R // 512)),
                             ("m0_tol0", 0, 0)):
        first = JA.segments_from_hint_cdf(cdf, R, margin=margin,
                                          top_headroom=False)
        sg = list(first)
        while True:
            img, seg_ov, _, _ = JP.render_frame_motion_sharded(
                tree, lm, cam2, opt, qpix_str, pix_str, tuple(sg),
                mesh=mesh, chunk_size=cs, hint_chunk=cs, skip_table=tab)
            seg_ov = np.asarray(seg_ov)
            if int(seg_ov.sum()) <= tol:
                break
            for i, c in enumerate(seg_ov):
                if c:
                    sg[i] = (sg[i][0], max(1, sg[i][1] * 2))
                    assert sg[i][1] <= 512
        out[key] = dict(first=segs_of(first), settled=segs_of(sg),
                        img=np.asarray(img), ov=seg_ov)
    return out


# ----------------------------------------------------------------------
# the port's margin probe in a gloo worker (a world of one)
# ----------------------------------------------------------------------
WORKER = r"""
import importlib.util, os, sys
import numpy as np
import torch
torch.set_num_threads(2)
outdir = sys.argv[1]
spec = importlib.util.spec_from_file_location(
    "probe_motion_margin", os.path.join("tools_torch",
                                        "probe_motion_margin.py"))
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
run = mod.run
keep = {}

def kept(*a, **k):
    rec, s, settled = run(*a, **k)
    keep.update(s=s, settled=settled, tol0=mod.settle(s, 0, tol=0))
    return rec, s, settled

mod.run = kept
mod.main(["5"])
out = {"max_dense": keep["s"].max_dense}
for key, m in (("m1", keep["settled"][1]), ("m0", keep["settled"][0]),
               ("m0_tol0", keep["tol0"])):
    out[key + "_first"] = np.asarray(m.first, np.float64)
    out[key + "_settled"] = np.asarray(m.segments, np.float64)
    out[key + "_img"] = m.out[0].numpy()
    out[key + "_ov"] = m.overflow
    out[key + "_world"] = m.world
np.savez(os.path.join(outdir, "margin.npz"), **out)
"""


@pytest.fixture(scope="module", autouse=True)
def margin_worker(tmp_path_factory):
    """Starts the port's margin probe at once; the margin test collects
    it.  Killed on teardown if it still runs."""
    outdir = str(tmp_path_factory.mktemp("margin"))
    env = {k: v for k, v in os.environ.items() if not k.startswith("BENCH_")}
    env.pop("XLA_FLAGS", None)
    env.update(OMP_NUM_THREADS="2", PYTHONUNBUFFERED="1", BENCH_FORCE_CPU="1",
               BENCH_WH=f"{W}x{H}")
    p = subprocess.Popen([sys.executable, "-c", WORKER, outdir], cwd=REPO,
                         env=env, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, start_new_session=True)
    yield p, outdir
    if p.poll() is None:
        os.killpg(p.pid, signal.SIGKILL)
        p.wait()


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads while this module runs (the suite runs several
    workers on one host)."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def one_json(stdout: str) -> dict:
    lines = [ln for ln in stdout.splitlines() if ln.startswith("{")]
    assert len(lines) == 1, stdout
    return json.loads(lines[0])


def run_main(mod, env):
    """``mod.main()`` in this process under ``env`` on the CPU; returns
    its stdout and what its ``run`` returned."""
    out = io.StringIO()
    got = []
    run = mod.run

    def keep(*a, **k):
        got.append(run(*a, **k))
        return got[-1]
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(out):
        mp.setattr(mod, "run", keep)
        for k, v in env.items():
            mp.setenv(k, v)
        assert mod.main([]) == 0
    return out.getvalue(), got[0]


ENV = dict(BENCH_FORCE_CPU="1", BENCH_WH=f"{W}x{H}", BENCH_DEPTH=str(DEPTH))


# ----------------------------------------------------------------------
# motion_phase_timing
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def phase_timing():
    """The probe's ``main`` at 160x90, depth 5 on the CPU (its stdout, and
    its ``run``'s record and setup), and JAX's side."""
    mod = load_tool("motion_phase_timing")
    out, (rec, ns) = run_main(mod, ENV)
    return mod, rec, ns, jax_phase_timing(), out


def test_phase_timing_segments_and_hints_match_jax(phase_timing):
    _, rec, ns, j, _ = phase_timing
    np.testing.assert_array_equal(ns.ph.numpy(), j["ph"])
    for k in ("steady", "motion", "motion_dir"):
        assert rec["segments"][k] == segs_of(j["segs_" + k]), k
        assert tuple(getattr(ns, "segs_" + k)) == tuple(j["segs_" + k]), k


def test_phase_timing_orders_match_jax(phase_timing):
    """E's order (perm, inv) of the iso-64 hints, and the directional
    order of C3."""
    _, _, ns, j, _ = phase_timing
    for got, want in ((ns.order_m, j["order_m"]),
                      (ns.order_md, j["order_md"])):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("stage", ["C", "C3"])
def test_phase_timing_motion_frames_match_jax(phase_timing, stage):
    mod, _, ns, j, _ = phase_timing
    order, segs = ((ns.order_m, ns.segs_motion) if stage == "C"
                   else (ns.order_md, ns.segs_motion_dir))
    img, seg_ov, _ = mod.frame(ns, order, segs, "packed")
    want_img, want_ov = j[stage]
    assert img.shape == (H, W, 4)
    np.testing.assert_allclose(img.numpy(), want_img, rtol=0, atol=TOL)
    np.testing.assert_array_equal(seg_ov.numpy(), want_ov)


def test_phase_timing_stages(phase_timing):
    """Every stage of ``tools/motion_phase_timing.py`` in its order, timed
    on the host; no device clock and no launch on the CPU."""
    _, rec, _, _, _ = phase_timing
    assert list(rec["stages"]) == ["A", "B", "C", "C2", "C3", "D", "D2",
                                   "E", "E2", "F", "G"]
    for st in rec["stages"].values():
        assert st["device_ms"] is None and st["host_ms"] > 0
        assert st["launches"] == {}


def test_phase_timing_main_prints_the_contract(phase_timing):
    """``main`` under the knobs: the three segments lines, one line per
    stage, one JSON line flagged smoke with the card and launches, then
    ``done``."""
    out = phase_timing[-1]
    lines = out.splitlines()
    assert lines[-1] == "done"
    assert sum(ln.startswith("segments ") for ln in lines) == 3
    assert sum(bool(re.match(r"\[[A-G]\d? ", ln)) for ln in lines) == 11
    rec = one_json(out)
    assert rec["smoke"] is True and rec["card"].startswith("cpu")
    assert not any(rec["launches"].values())


# ----------------------------------------------------------------------
# motion_viewer_probe
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def viewer_probe():
    """The probe's ``main`` at 160x90, depth 5 on the CPU (its stdout and
    its ``run``'s record), and JAX's side."""
    mod = load_tool("motion_viewer_probe")
    out, (rec, _) = run_main(mod, ENV)
    return mod, rec, jax_viewer_probe(), out


def test_viewer_probe_headroom_matches_jax(viewer_probe):
    _, rec, j, _ = viewer_probe
    assert set(rec["headroom"]) == {"headroom", "NO-headroom"}
    for tag, want in j["headroom"].items():
        got = rec["headroom"][tag]
        assert got["segs"] == want["segs"], tag
        assert got["overflow_counts"] == want["overflow_counts"], tag


@pytest.mark.parametrize("mode", ["rehint", "dilate"])
def test_viewer_probe_wraps_and_segments_match_jax(viewer_probe, mode):
    """Per pose: the wrapped calls in call order, the Viewer's segments and
    its motion segments equal JAX's Viewer under the same wraps."""
    _, rec, j, _ = viewer_probe
    got, want = rec["poses"][mode], j["poses"][mode]
    assert len(got) == len(want) == 6
    for p, (g, w) in enumerate(zip(got, want)):
        assert [t for t, _ in g["calls"]] == w["calls"], (mode, p)
        assert g["segs"] == w["segs"], (mode, p)
        assert g["motion_segs"] == w["motion_segs"], (mode, p)
        assert set(g["split"]) == set(w["calls"])
        assert g["total"] >= sum(g["split"].values())


def test_viewer_probe_rehint_poses_fire_no_jax_wrap(viewer_probe):
    """With the JAX tool's three wraps only, the default re-hint poses fire
    none of them, in both packages: the JAX tool's split of such a pose is
    empty and all of it lands under ``other``.  Each fires the port
    probe's ``motion`` wrap once."""
    mod, rec, j, _ = viewer_probe
    for g, w in zip(rec["poses"]["rehint"], j["poses"]["rehint"]):
        jax_only = [t for t in w["calls"] if t in mod.JAX_WRAPS]
        port_only = [t for t, _ in g["calls"] if t in mod.JAX_WRAPS]
        assert jax_only == port_only == []
        assert [t for t, _ in g["calls"]] == w["calls"] == ["motion"]
    # the dilate run is what the JAX wraps were written for
    assert any(set(w["calls"]) == set(mod.JAX_WRAPS)
               for w in j["poses"]["dilate"])


def test_viewer_probe_main_prints_the_contract(viewer_probe):
    out = viewer_probe[-1]
    lines = out.splitlines()
    assert lines[-1] == "done"
    assert sum(ln.startswith("[motion frame ") for ln in lines) == 2
    for mode in ("rehint", "dilate"):
        assert sum(ln.startswith(f"[{mode} pose ") for ln in lines) == 6
    rec = one_json(out)
    assert rec["smoke"] is True and rec["card"].startswith("cpu")
    assert all(p["finite"] for m in rec["poses"].values() for p in m)


# ----------------------------------------------------------------------
# probe_motion_margin
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def margin(margin_worker):
    want = jax_margin()
    p, outdir = margin_worker
    try:
        out, _ = p.communicate(timeout=SPAWN_TIMEOUT)
    finally:
        if p.poll() is None:
            os.killpg(p.pid, signal.SIGKILL)
            p.wait()
    out = out.decode(errors="replace")
    assert p.returncode == 0, out[-4000:]
    return dict(np.load(os.path.join(outdir, "margin.npz"))), want, out


def test_margin_budgets_match_jax(margin):
    """``max_dense``; per margin the first segments and the settled budgets
    (the async tolerance, and margin 0 escalated to no overflow)."""
    got, want, _ = margin
    assert int(got["max_dense"]) == want["max_dense"]
    for key in ("m1", "m0", "m0_tol0"):
        assert segs_of(got[key + "_first"]) == want[key]["first"], key
        assert segs_of(got[key + "_settled"]) == want[key]["settled"], key
    # the tolerance-free run escalated at least one budget
    assert want["m0_tol0"]["settled"] != want["m0_tol0"]["first"]


@pytest.mark.parametrize("key", ["m1", "m0", "m0_tol0"])
def test_margin_sharded_pose_matches_jax(margin, key):
    """The world-of-one sharded pose against JAX's on a one-device mesh:
    overflow counts equal, pixels within 1e-3."""
    got, want, _ = margin
    assert int(got[key + "_world"]) == 1
    np.testing.assert_array_equal(got[key + "_ov"], want[key]["ov"])
    assert got[key + "_img"].shape == (H, W, 4)
    np.testing.assert_allclose(got[key + "_img"], want[key]["img"], rtol=0,
                               atol=TOL)


def test_margin_main_prints_the_contract(margin):
    _, _, out = margin
    lines = out.splitlines()
    assert lines[-1] == "done"
    assert lines[0].startswith("setup ") and "max_dense=" in lines[0]
    assert [ln.split(":")[0] for ln in lines
            if ln.startswith("margin=")] == ["margin=1", "margin=0"]
    rec = one_json(out)
    assert rec["smoke"] is True and rec["world"] == 1
    assert set(rec["margins"]) == {"1", "0"}
    assert "v5e8" not in out and "projected" not in out


# ----------------------------------------------------------------------
# the smoke script
# ----------------------------------------------------------------------
def test_smoke_script_names_every_entry_point():
    """``tools_torch/smoke_benchmarks.sh`` runs ``bench_torch.py``, every
    ``benchmarks_torch/`` script and the three probes (not the gather
    probe, which takes no request for the CPU)."""
    with open(os.path.join(TOOLS, "smoke_benchmarks.sh")) as f:
        text = f.read()
    runs = [ln for ln in text.splitlines() if re.search(r"\brun python ", ln)]
    named = {ln.split("run python ", 1)[1].split()[0] for ln in runs}
    scripts = {f"benchmarks_torch/{f}" for f in os.listdir(
        os.path.join(REPO, "benchmarks_torch"))
        if f.endswith(".py") and f != "_overrides_torch.py"}
    probes = {f"tools_torch/{n}.py" for n in (
        "motion_phase_timing", "motion_viewer_probe", "probe_motion_margin")}
    assert named == {"bench_torch.py"} | scripts | probes
    assert "export BENCH_FORCE_CPU=1" in text
    assert "SMOKE FAILURE" in text and "exit $fail" in text
    assert "gather_probe" not in "".join(runs)
