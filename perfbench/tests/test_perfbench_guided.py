"""A configuration that carries a model, the ``guided`` mix kind, the
guided frame's plain reference and ``stop_ms``: on the CPU at a test's
size, from the fixtures under ``tests/base`` (a small per-cluster
Linear/ReLU model, its configuration, a guided mix and a check), which
the harness finds by name as it finds a cell's files under
``perfbench/``."""

import copy
import functools
import json
import os
import types

import numpy as np
import pytest
import torch

from perfbench import cell, drive, harness, registry
from perfbench.trace import Instruments

BASE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "base")
CELL = "fixture_guided"
SEED = 2 ** 32 + 19


@pytest.fixture
def guided_root(tmp_path):
    """A checkout-like root whose ``BENCHMARK.json`` holds the fixture cell
    beside the benchmark's own, ``stop_ms`` as the entry a guided cell
    brings with it, and a fixture per-layer metric that reads
    ``ctx.device_ops_s``."""
    b = registry.benchmark()
    b["workloads"].append({"name": CELL, "config": "fixture_guided",
                           "traffic": "fixture_stops", "chips": 1,
                           "why": "a test's guided stops"})
    b["end_to_end"].insert(-1, {"name": "stop_ms", "unit": "ms",
                                "better": "lower", "bound": 0.15,
                                "source": "host_clock", "workloads": [CELL]})
    b["per_layer"].append({"name": "collect_s", "unit": "s",
                           "better": "lower", "source": "device_trace",
                           "layer": "kernels", "moves": "stop_ms",
                           "workloads": [CELL]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    return str(tmp_path)


def run(root, seconds=0.8, trace=False, control=False, seed=SEED):
    return harness.run_cell(CELL, seed, seconds, trace, device="cpu",
                            root=root, control=control, log=lambda m: None,
                            base=BASE)[0]


def test_the_model_is_found_by_name_and_reaches_the_viewer(guided_root):
    cfg = registry.config("fixture_guided", BASE)
    mix = registry.traffic("fixture_stops", BASE)
    mod = registry.model_module(cfg["model"]["arch"], BASE)
    prog = cell.Program(guided_root, cfg, mix, torch.device("cpu"), 0.0,
                        BASE)
    model = prog.viewer.model
    assert model is not None and "model" in dict(prog.setup_steps)
    weights, biases = mod.arrays(cfg["model"])
    for got, want in zip(model.params.weights, weights):
        np.testing.assert_array_equal(got.numpy(), want)
    assert model.params.skips == tuple(cfg["model"]["skips"])
    assert prog.viewer.options.use_guided_sampling
    prog.free()


def test_render_options_pass_by_name():
    from mega_nerf_viewer_tpu_torch import RenderOptions
    cfg = registry.config("fixture_guided", BASE)
    opt = cell.program_options(RenderOptions, cfg)
    for k, v in cfg["render_options"].items():
        assert getattr(opt, k) == (tuple(v) if isinstance(v, list) else v)
    # the benchmark's own configurations read as they did
    for name in ("aerial_d11_sh4", "plenoctree_syn512_sh16"):
        c = registry.config(name)
        o = c["render_options"]
        assert cell.program_options(RenderOptions, c) == RenderOptions(
            step_size=o["step_size"], sigma_thresh=o["sigma_thresh"],
            stop_thresh=o["stop_thresh"],
            background_brightness=o["background_brightness"],
            render_bbox=tuple(o["render_bbox"]),
            basis_minmax=tuple(o["basis_minmax"]))
    bad = copy.deepcopy(cfg)
    bad["render_options"]["max_guided_sample"] = 4
    with pytest.raises(ValueError, match="max_guided_sample"):
        cell.program_options(RenderOptions, bad)


def test_kept_frames_go_to_the_reference_of_their_kind(guided_root,
                                                      monkeypatch):
    from perfbench.scenes import ensure_scene
    cfg = registry.config("fixture_guided", BASE)
    path, _ = ensure_scene(cell.cache_dir(guided_root), cfg["scene"])
    cam = {"width": 16, "height": 12, "fx": 10.0, "fy": 10.0, "cx": 8.0,
           "cy": 6.0, "transform": np.array(
               [[0, 1, 0], [0, 0, 1], [1, 0, 0], [2.5, 0, 0]], np.float32)}
    calls = []
    find = registry.frame_reference

    def spy(kind, base=registry.HERE):
        fn = find(kind, base)

        @functools.wraps(fn)
        def frame(*a, **kw):
            calls.append(kind)
            return fn(*a, **kw)
        return frame
    monkeypatch.setattr(registry, "frame_reference", spy)
    kept = [(0, None, cam), (1, None, dict(cam, frame="guided")),
            (2, None, dict(cam)), (3, None, dict(cam, frame="voxel"))]
    out = harness.reference_frames(cfg, path, kept, torch.device("cpu"),
                                   base=BASE)
    # one render a camera and kind; unmarked is a voxel frame
    assert calls == ["voxel", "guided"]
    assert out[0] is out[2] is out[3] and out[1] is not out[0]
    # a guided frame has alpha 1 and no background; the voxel frame
    # composites the background where a ray misses
    assert bool((out[1][..., 3] == 1).all())
    assert not torch.equal(out[0], out[1])


def test_the_guided_frame_agrees_with_the_reference(guided_root):
    res = run(guided_root)
    checked = {k: v["value"] for k, v in res["checked"].items()}
    assert res["correct"] is True and res["failed"] == 0, checked
    assert checked["off_px_share"] == 0.0
    assert checked["mean_abs_err"] <= 1e-6
    assert set(res["metrics"]) == {"stop_ms", "setup_s"}


def _scaled_query(monkeypatch):
    from mega_nerf_viewer_tpu_torch.ops import guided
    fn = guided.query_grouped

    def scaled(*a, **kw):
        return fn(*a, **kw) * 1.01
    monkeypatch.setattr(guided, "query_grouped", scaled)


def _dropped_sample(monkeypatch):
    from mega_nerf_viewer_tpu_torch.ops import guided
    fn = guided.collect_march

    def dropped(*a, **kw):
        t, ns, steps, over = fn(*a, **kw)
        return t, (ns - 1).clamp_min(0), steps, over
    monkeypatch.setattr(guided, "collect_march", dropped)


@pytest.mark.parametrize("fault", [_scaled_query, _dropped_sample],
                         ids=["output_scaled_1.01", "one_sample_dropped"])
def test_a_fault_makes_correct_false(fault, guided_root, monkeypatch):
    fault(monkeypatch)
    res = run(guided_root)
    assert res["correct"] is False, res["checked"]
    assert res["failed"] > 0


def test_the_bfloat16_control_fails_the_limits(guided_root):
    res = run(guided_root, control=True, seed=2 ** 31 + 5)
    assert res["correct"] is True, res["checked"]
    limits = {k: v["limit"] for k, v in res["checked"].items()}
    assert any(res["control"][k] > limits[k] for k in limits), \
        (res["control"], limits)


def test_a_stop_is_the_unit(guided_root, monkeypatch):
    kind = registry.kind_driver("guided")
    seen = {}
    find = registry.kind_driver

    def spy(name, base=registry.HERE):
        mod = find(name, base)
        orig = mod.run

        def run_(*a, **kw):
            w = orig(*a, **kw)
            seen["window"], seen["plan"] = w, a[2]
            return w
        mod.run = run_
        return mod
    monkeypatch.setattr(registry, "kind_driver", spy)
    ends = []
    from mega_nerf_viewer_tpu_torch import Camera
    end = Camera.end_drag
    monkeypatch.setattr(Camera, "end_drag",
                        lambda self: (ends.append(1), end(self))[1])
    res = run(guided_root, seconds=1.5)
    w, plan = seen["window"], seen["plan"]
    mix = registry.traffic("fixture_stops", BASE)
    units = res["attempted"]
    assert units == w.units == len(w.latencies) >= 1
    # two warm-up stops, then one release a unit
    assert len(ends) == 2 + units
    poses = kind.drag_poses(mix, plan)
    assert len(w.apart) == sum(poses[i % len(poses)] for i in range(units))
    assert len(w.apart) >= 2 * units
    assert all(c[2]["frame"] == "guided" for c in w.kept)
    assert res["metrics"]["stop_ms"]["value"] == pytest.approx(
        1e3 * float(np.median(w.latencies)))


def test_every_seed_runs_the_same_episodes():
    """The seed orders the episodes; each keeps its drag's length."""
    kind = registry.kind_driver("guided")
    mix = registry.traffic("fixture_stops", BASE)
    runs = []
    for s in (0, 7, 2 ** 31 + 9, 2 ** 40):
        plan = drive.Plan(mix, s)
        runs.append(list(zip(plan.episodes, kind.drag_poses(mix, plan))))
    assert all(sorted(r) == sorted(runs[0]) for r in runs)
    assert len({tuple(r) for r in runs}) > 1
    per = mix["deg_per_pose"]
    lengths = sorted(n for _, n in runs[0])
    assert len(set(lengths)) > 1
    assert all(mix["drag_deg"][0] <= n * per <= mix["drag_deg"][1] + per
               for n in lengths)


def test_stop_ms_is_the_median():
    read = registry.metric_reader("stop_ms")
    w = types.SimpleNamespace(latencies=[0.1, 0.9, 0.2, 0.3])
    assert read(types.SimpleNamespace(window=w)) == pytest.approx(250.0)
    w.latencies = []
    assert read(types.SimpleNamespace(window=w)) is None


def _event(name, start, dur, cuda=True):
    dt = torch.autograd.DeviceType
    return types.SimpleNamespace(
        name=lambda: name, start_ns=lambda: start, duration_ns=lambda: dur,
        device_type=lambda: dt.CUDA if cuda else dt.CPU,
        is_user_annotation=lambda: False)


def test_device_ops_s_sums_each_operation_in_the_window():
    inst = Instruments("cpu")
    events = [_event("pb:window", 1000, 10_000, cuda=False),
              _event("mnv::collect_kernel(LeafMapTree)", 2000, 3000),
              _event("mnv::collect_kernel(LeafMapTree)", 6000, 1000),
              _event("ampere_sgemm_128x64_nn", 7000, 2000),
              _event("mnv::march_kernel(LeafMapTree)", 10_500, 1000)]
    inst.prof = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: events)))
    busy, window = inst.timeline()[:2]
    assert inst.device_ops_s == pytest.approx({
        "mnv::collect_kernel(LeafMapTree)": 4e-6,
        "ampere_sgemm_128x64_nn": 2e-6,
        "mnv::march_kernel(LeafMapTree)": 0.5e-6})
    assert inst.kernel_s == pytest.approx({"march": 0.5e-6})
    assert (busy, window) == pytest.approx((6.5e-6, 1e-5))


def test_metric_readers_get_device_ops_s(guided_root, monkeypatch):
    """A traced run hands the window's device seconds by name to the
    readers: the fixture's ``collect_s`` reads the collect's kernel."""
    ops = {"mnv::collect_kernel(LeafMapTree)": 0.25, "sgemm": 1.0}

    def timeline(self):
        self.device_ops_s = dict(ops)
        return 1.25, 2.0, [[k, v] for k, v in ops.items()], []
    monkeypatch.setattr(Instruments, "timeline", timeline)
    res = run(guided_root, trace=True)
    assert res["correct"] is True
    assert res["metrics"]["collect_s"] == {"value": 0.25, "unit": "s"}
