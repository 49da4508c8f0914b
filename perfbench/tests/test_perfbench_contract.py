"""The result's line and ``BENCHMARK.json`` against the benchmark's
contract."""

import json
import re
import subprocess
import sys

import pytest
import torch

from conftest import ROOT, tiny
from perfbench import harness, registry

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_result_line_keys(cache_root):
    cfg, mix = tiny("syn512_parked")
    res, lines = harness.run_cell("syn512_parked", 2 ** 33 + 7, 0.3, False,
                                  device="cpu", root=cache_root, cfg=cfg,
                                  mix=mix, log=lambda m: None)
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device", "checked"]
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] > 0
    assert set(res["metrics"]) == {"frame_ms", "setup_s"}
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(res["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    assert set(res["checked"]) == {"off_px_share", "mean_abs_err"}
    assert len(lines) == 2 and all("limit" in ln for ln in lines)
    json.dumps(res)


def test_run_py_refuses_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal cannot be seen here")
    p = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                        "syn512_parked", "--seed", str(2 ** 40), "--seconds",
                        "1", "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode != 0 and p.stdout == ""


def test_benchmark_json_contract():
    b = registry.benchmark()
    assert list(b) == ["command", "paths", "run_seconds", "configs",
                       "workloads", "end_to_end", "per_layer"]
    assert b["command"] == ["python3", "perfbench/run.py"]
    assert b["paths"] == ["perfbench"]
    assert 1 <= b["run_seconds"] <= 51
    full = 2 + 14 * 24
    assert full * (b["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    names = set()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("perfbench/")
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
        for k in c["reduced"]:
            assert NAME.match(k) and not k.endswith(("_dim", "_rank"))
    cfg_names = {c["name"] for c in b["configs"]}
    pairs = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["config"] in cfg_names
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in e2e and m["workloads"]
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["name"] not in names
        names.add(m["name"])
    for w in b["workloads"]:
        got = registry.cell_metrics(b, w, False)
        assert "setup_s" in {m["name"] for m in got} and len(got) >= 2
        assert registry.cell_metrics(b, w, True)
    assert len(json.dumps(b)) <= 64 * 1024


@pytest.mark.cuda
def test_run_py_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    p = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                        "syn512_parked", "--seed", str(2 ** 40 + 3),
                        "--seconds", "1", "--trace", "0"], cwd=ROOT,
                       capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-2000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"] is True
    assert res["device"]["platform"] == "gpu"
    assert list(res)[-1] == "checked"
    assert p.stderr.strip().splitlines()[-1].startswith("check ")
