"""bench_torch.py keeps bench.py's contract: ONE parseable JSON line on
stdout however the run ends (the cases of ``test_bench_contract.py``), no
TPU projection keys, and no run without a card unless the caller asks for
the CPU.

All runs here are CPU smoke runs (``BENCH_FORCE_CPU=1``,
``BENCH_WH=64x36``): tiny frames whose figures are not reportable; they
exercise the control flow, not the measurement.
"""

import json
import os
import signal
import subprocess
import sys
import time

import mega_nerf_viewer_tpu_torch as P

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(REPO, "bench_torch.py")
LAST_VALID = os.path.join(REPO, "build", "bench_torch_last_valid.json")

SMOKE_ENV = dict(os.environ, BENCH_FORCE_CPU="1", BENCH_WH="64x36",
                 PYTHONUNBUFFERED="1")


def _one_json_line(stdout: str) -> dict:
    """stdout holds exactly one line, the bench record."""
    lines = [ln for ln in stdout.splitlines() if ln.strip()]
    assert len(lines) == 1, f"expected ONE stdout line, got: {lines!r}"
    rec = json.loads(lines[0])
    assert rec["metric"] == "frames_per_sec_1080p"
    assert rec["unit"] == "fps"
    assert not [k for k in rec if "v5e8" in k]
    return rec


def _last_valid_state():
    try:
        return os.stat(LAST_VALID).st_mtime_ns
    except FileNotFoundError:
        return None


def test_sigterm_midrun_emits_json_line():
    """SIGTERM after the readiness sentinel still gives the one line."""
    p = subprocess.Popen(
        [sys.executable, BENCH, "4"], env=SMOKE_ENV, cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    deadline = time.time() + 60
    for line in p.stderr:
        if b"# bench: supervising child" in line:
            break
        assert time.time() < deadline, "no readiness sentinel within 60s"
    time.sleep(1.0)
    p.send_signal(signal.SIGTERM)
    out, _ = p.communicate(timeout=30)
    rec = _one_json_line(out.decode())
    if "error" in rec:
        assert p.returncode == 3
        assert rec["value"] == 0.0
        ref = rec.get("last_valid_capture_ref")
        if ref is not None:
            assert "value" not in ref and "fps" not in json.dumps(ref)
    else:
        # the primary measurement landed first: fine too
        assert rec["value"] > 0.0


def test_self_deadline_emits_error_record():
    env = dict(SMOKE_ENV, BENCH_DEADLINE_S="1")
    p = subprocess.run([sys.executable, BENCH, "8"], env=env, cwd=REPO,
                       capture_output=True, timeout=60)
    assert p.returncode == 3
    rec = _one_json_line(p.stdout.decode())
    assert "error" in rec and rec["value"] == 0.0
    assert "deadline" in rec["error"]


def test_noarg_run_rides_aerial_artifact(tmp_path):
    """A run with no arguments also measures ``BENCH_AERIAL_FIXTURE`` into
    the ``aerial_*`` keys (here a tiny tree saved by the port)."""
    fix = tmp_path / "tiny_aerial.npz"
    P.sphere_tree(basis_dim=1, depth=3, device="cpu").save_npz(str(fix))
    env = dict(SMOKE_ENV, BENCH_AERIAL_FIXTURE=str(fix))
    p = subprocess.run([sys.executable, BENCH], env=env, cwd=REPO,
                       capture_output=True, timeout=600)
    assert p.returncode == 0, p.stderr.decode()[-2000:]
    rec = _one_json_line(p.stdout.decode())
    assert rec["value"] > 0.0
    assert rec["aerial_fps"] > 0.0
    assert rec["aerial_sorted_mode_fps"] > 0.0


def test_completed_smoke_run_has_record():
    """A whole smoke run gives the measurement, flagged smoke, without
    projection keys, and never writes the last-valid file."""
    before = _last_valid_state()
    p = subprocess.run([sys.executable, BENCH, "4"], env=SMOKE_ENV,
                       cwd=REPO, capture_output=True, timeout=600)
    assert p.returncode == 0, p.stderr.decode()[-2000:]
    rec = _one_json_line(p.stdout.decode())
    assert rec["value"] > 0.0
    assert rec["smoke"] is True
    assert rec["vs_baseline"] > 0.0
    assert rec["sorted_mode_fps"] > 0.0
    assert _last_valid_state() == before
    if before is not None:
        with open(LAST_VALID) as f:
            assert json.load(f)["record"].get("smoke") is not True


def test_no_card_without_force_cpu_is_an_error():
    """Without ``BENCH_FORCE_CPU`` the child asks for the card; with none
    it raises, and the line is an error record with exit code 3."""
    env = dict(SMOKE_ENV, CUDA_VISIBLE_DEVICES="")
    env.pop("BENCH_FORCE_CPU")
    p = subprocess.run([sys.executable, BENCH, "4"], env=env, cwd=REPO,
                       capture_output=True, timeout=120)
    assert p.returncode == 3
    rec = _one_json_line(p.stdout.decode())
    assert "error" in rec and rec["value"] == 0.0
    assert "no CUDA device" in p.stderr.decode()
