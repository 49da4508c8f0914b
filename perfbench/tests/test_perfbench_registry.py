"""Every part of a cell is found by its name: a later configuration, mix,
metric or check is a file and an entry, and no code names it."""

import json
import os

from perfbench import registry


def test_new_parts_are_found_by_name(tmp_path):
    for sub in ("configs", "traffic", "metrics", "checks", "models",
                "reference"):
        os.makedirs(tmp_path / sub)
    (tmp_path / "models" / "new_arch.py").write_text(
        "def build(spec, device):\n    return spec['w']\n")
    (tmp_path / "reference" / "new_frame.py").write_text(
        "def frame(*a, **kw):\n    return 'framed'\n")
    (tmp_path / "traffic" / "new_kind.py").write_text(
        "def run(*a):\n    return 'ran'\n")
    (tmp_path / "configs" / "new_cfg.json").write_text(
        json.dumps({"scene": {"generator": "shell"}}))
    (tmp_path / "traffic" / "new_mix.json").write_text(
        json.dumps({"kind": "parked"}))
    (tmp_path / "checks" / "new_cell.json").write_text(
        json.dumps({"tolerance": 1e-3, "limits": {}}))
    (tmp_path / "metrics" / "new_metric.part.py").write_text(
        "def read(ctx):\n    return ctx * 2\n")
    (tmp_path / "metrics" / "shared.py").write_text(
        "def read(ctx):\n    return ctx + 1\n")
    base = str(tmp_path)
    assert registry.config("new_cfg", base)["scene"]["generator"] == "shell"
    assert registry.traffic("new_mix", base)["kind"] == "parked"
    assert registry.check("new_cell", base)["tolerance"] == 1e-3
    assert registry.metric_reader("new_metric.part", base)(21) == 42
    # a split metric reads its first part's file, unless it has its own
    assert registry.metric_reader("shared.parked", base)(1) == 2
    assert registry.metric_reader("shared.orbit", base)(2) == 3
    assert registry.kind_driver("new_kind", base).run() == "ran"
    assert registry.model_module("new_arch", base).build({"w": 3}, None) == 3
    assert registry.frame_reference("new_frame", base)() == "framed"
    # a part the base folder lacks is perfbench's own
    assert registry.kind_driver("guided", base).check_frames
    assert registry.frame_reference("voxel", base).__module__.endswith(
        "voxel")
    assert registry.config("aerial_d11_sh4", base)["name"] == \
        "aerial_d11_sh4"


def test_every_named_part_has_its_file():
    bench = registry.benchmark()
    for c in bench["configs"]:
        assert os.path.exists(os.path.join(registry.ROOT, c["file"]))
        assert registry.config(c["name"])["name"] == c["name"]
    for w in bench["workloads"]:
        mix = registry.traffic(w["traffic"])
        kind = registry.kind_driver(mix["kind"])
        assert callable(kind.warm) and callable(kind.run)
        chk = registry.check(w["name"])
        assert set(chk["limits"]) == {"off_px_share", "mean_abs_err"}
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(registry.metric_reader(m["name"]))


def test_cell_metrics_follow_their_workloads():
    bench = registry.benchmark()
    got = {w["name"]: (
        [m["name"] for m in registry.cell_metrics(bench, w, False)],
        [m["name"] for m in registry.cell_metrics(bench, w, True)])
        for w in bench["workloads"]}
    assert got["syn512_orbit"][0] == ["pose_p99_ms", "setup_s"]
    assert got["d11_parked"][0] == ["frame_ms", "setup_s"]
    assert got["syn512_parked"][0] == ["frame_ms", "setup_s"]
    assert set(got["syn512_orbit"][1]) == {
        "viewer_host_ms.orbit", "rebuilds_per_pose.orbit",
        "idle_share.orbit", "enqueue_ms.orbit", "sync_wait_ms.orbit",
        "syncs_per_frame.orbit", "redos_per_pose.orbit", "redo_ms.orbit"}
    assert set(got["syn512_parked"][1]) == set(got["d11_parked"][1]) == {
        "viewer_host_ms.parked", "march_roofline.parked", "idle_share.parked",
        "enqueue_ms.parked", "sync_wait_ms.parked", "syncs_per_frame.parked"}
    # stop_ms waits for a guided cell, which brings its entry: no cell
    # reports it yet, and its reader is found by name
    assert "stop_ms" not in [m["name"] for m in bench["end_to_end"]]
    assert all("stop_ms" not in e2e for e2e, _ in got.values())
    assert callable(registry.metric_reader("stop_ms"))
