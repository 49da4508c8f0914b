"""Every part of a cell is found by its name: a later configuration, mix,
metric or check is a file and an entry, and no code names it."""

import json
import os

from perfbench import registry


def test_new_parts_are_found_by_name(tmp_path):
    for sub in ("configs", "traffic", "metrics", "checks"):
        os.makedirs(tmp_path / sub)
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
        "idle_share.orbit"}
    assert set(got["syn512_parked"][1]) == set(got["d11_parked"][1]) == {
        "viewer_host_ms.parked", "march_roofline.parked", "idle_share.parked"}
