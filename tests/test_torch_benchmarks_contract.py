"""The port's benchmark scripts (``benchmarks_torch/``) and examples keep
the JAX scripts' contract: ONE JSON line on stdout with the JAX script's
``metric`` and keys (apart from the drops each docstring names), ``"smoke":
true`` under any override, and no run without a card unless the caller
asks for the CPU (``BENCH_FORCE_CPU=1``; ``--device cpu`` for the
examples).

The runs here are CPU smoke runs at tiny sizes: they exercise the control
flow, not the measurement.  The helpers below load
a JAX script and its port by file path under distinct module names (both
directories hold the same file names) and spy on a Viewer's frames; the
``test_torch_benchmarks_*.py`` files use them.
"""

import contextlib
import importlib.util
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_DIR = os.path.join(REPO, "benchmarks")
PORT_DIR = os.path.join(REPO, "benchmarks_torch")

# each JAX script's metric and keys, and each port script's drops: one
# table, beside the scripts (the JAX lines themselves are held to it where
# a test has one, ``check_keys``)
if PORT_DIR not in sys.path:
    sys.path.insert(0, PORT_DIR)
from _overrides_torch import DROPPED, JAX_KEYS  # noqa: E402

# tiny CPU runs: (argv, environment)
SMOKE = {
    "guided1080p": (["8"], dict(BENCH_WH="48x32", BENCH_DEPTH="4")),
    "motion1080p": (["2", "3"], dict(BENCH_WH="48x32", BENCH_DEPTH="4")),
    "motion_guided1080p": (["2", "3", "8"],
                           dict(BENCH_WH="48x32", BENCH_DEPTH="4")),
    "foveated1080p": (["2", "2", "3"],
                      dict(BENCH_WH="48x32", BENCH_DEPTH="4")),
    # the vote frame needs split_batch_size (4096) rays, in JAX too
    "refine_throughput": (["1"], dict(BENCH_WH="64x64", BENCH_DEPTH="4")),
    "parity": (["50"], dict(BENCH_WH="32x32")),
    "orbit4k": (["2"], dict(BENCH_WH="64x36", BENCH_DEPTH="4")),
}
EXAMPLES = ("quickstart_torch", "multihost_render_torch")


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads while a module of these files runs: the suite
    runs several workers on one host, and torch's default of a thread per
    core in each of them oversubscribes the cores (the plain march's many
    small ops then crawl).  The ``test_torch_benchmarks_*`` files import
    it."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def load(kind: str, name: str):
    """The script ``name`` of ``benchmarks/`` (``kind`` "jax") or
    ``benchmarks_torch/`` ("torch"), loaded by file path as
    ``<kind>_bench_<name>``."""
    d = JAX_DIR if kind == "jax" else PORT_DIR
    if d not in sys.path:
        sys.path.insert(0, d)          # the script's helper module
    spec = importlib.util.spec_from_file_location(
        f"{kind}_bench_{name}", os.path.join(d, name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_jax(name: str, argv, env: dict) -> dict:
    """The JAX script ``name``'s ``main`` in this process (the CPU, as
    ``conftest.py`` forces it) with ``argv`` and the override ``env``
    (``BENCH_FORCE_CPU`` left unset); returns its JSON line."""
    mod = load("jax", name)
    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(out):
        mp.setattr(sys, "argv", [name + ".py"] + [str(a) for a in argv])
        mp.delenv("BENCH_FORCE_CPU", raising=False)
        for k, v in env.items():
            mp.setenv(k, v)
        mod.main()
    lines = [ln for ln in out.getvalue().splitlines() if ln.strip()]
    assert len(lines) == 1, lines
    return json.loads(lines[0])


def run_port(name: str, argv, env: dict, run_kw=None):
    """The port script ``name``'s ``main`` in this process on the CPU
    (``BENCH_FORCE_CPU=1``) with ``argv`` and ``env``; ``run_kw`` adds
    keywords to its ``run`` call (JAX's draws).  Checks its output: ONE
    stdout line flagged smoke with JAX's metric and keys less the drops,
    the card and the launches (none on the CPU) on stderr.  Returns
    (record, what its ``run`` returned besides the record)."""
    mod = load("torch", name)
    got = []
    run = mod.run

    def keep(*a, **k):
        rec, extra = run(*a, **k, **(run_kw or {}))
        got.append(extra)
        return rec, extra

    out, err = io.StringIO(), io.StringIO()
    with pytest.MonkeyPatch.context() as mp, \
            contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        mp.setattr(sys, "argv", [name + ".py"] + [str(a) for a in argv])
        mp.setattr(mod, "run", keep)
        mp.setenv("BENCH_FORCE_CPU", "1")
        for k, v in env.items():
            mp.setenv(k, v)
        mod.main()
    rec = _one_line(out.getvalue())
    assert rec["smoke"] is True
    check_keys(name, rec)
    err = err.getvalue()
    assert "# card: cpu" in err
    launches = [ln for ln in err.splitlines() if ln.startswith("# launches ")]
    assert len(launches) == 1
    # the CPU runs the plain versions: no kernel launched
    assert not any(json.loads(launches[0][len("# launches "):]).values())
    return rec, got[0]


@contextlib.contextmanager
def render_spy(*viewer_classes):
    """Record a host copy of every frame the outermost ``render`` call of
    the given Viewer classes returns (a foveated Viewer's sub-Viewers
    render inside it); yields the list of frames, by class."""
    frames = {cls: [] for cls in viewer_classes}
    with pytest.MonkeyPatch.context() as mp:
        for cls in viewer_classes:
            orig = cls.render
            depth = [0]

            def spy(self, *a, _orig=orig, _frames=frames[cls], _depth=depth,
                    **k):
                _depth[0] += 1
                try:
                    img = _orig(self, *a, **k)
                finally:
                    _depth[0] -= 1
                if _depth[0] == 0:
                    host = img.cpu() if hasattr(img, "cpu") else img
                    _frames.append(np.array(host, dtype=np.float32,
                                            copy=True))
                return img

            mp.setattr(cls, "render", spy)
        yield frames


def check_keys(name: str, rec: dict, jax_rec=None):
    """``rec`` has the JAX script's metric and keys less the named drops
    (and, with ``jax_rec``, exactly the keys of that JAX line less them)."""
    metric, keys = JAX_KEYS[name]
    want = keys - DROPPED.get(name, set())
    assert rec["metric"] == metric
    assert set(rec) - {"smoke"} == want
    if jax_rec is not None:
        assert set(jax_rec) - DROPPED.get(name, set()) == set(rec)
        assert jax_rec["metric"] == metric


def _one_line(stdout: str) -> dict:
    lines = [ln for ln in stdout.splitlines() if ln.strip()]
    assert len(lines) == 1, f"expected ONE stdout line, got: {lines!r}"
    return json.loads(lines[0])


def _env(**kw):
    env = {k: v for k, v in os.environ.items() if not k.startswith("BENCH_")}
    env.pop("PYTHONPATH", None)
    env["OMP_NUM_THREADS"] = "2"
    env.update(kw)
    return env


def _jax_record_keys(name: str):
    """The metric and the keys of the JAX script ``name``'s line, read from
    its source: the record dict's literal keys and the keys assigned into
    it or into a dict it spreads, without "smoke" and the npz-only "tree"
    and "chunks"."""
    import ast
    with open(os.path.join(JAX_DIR, name + ".py")) as f:
        tree = ast.parse(f.read())
    metric = None
    names, keys = set(), set()
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(isinstance(k, ast.Constant) and k.value == "metric"
                        for k in node.value.keys)):
            names.add(node.targets[0].id)
            for k, v in zip(node.value.keys, node.value.values):
                if k is None:                   # **spread: its own keys
                    names.add(v.id)
                    continue
                keys.add(k.value)
                if k.value == "metric":
                    metric = v.value
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if (isinstance(t, ast.Subscript)
                        and isinstance(t.value, ast.Name)
                        and t.value.id in names
                        and isinstance(t.slice, ast.Constant)):
                    keys.add(t.slice.value)
    return metric, keys - {"smoke", "tree", "chunks"}


@pytest.mark.parametrize("name", sorted(JAX_KEYS))
def test_key_table_is_the_jax_scripts(name):
    """``_overrides_torch.JAX_KEYS``, which the port's lines are held to,
    is what each JAX script's source writes into its line."""
    assert _jax_record_keys(name) == JAX_KEYS[name]
    assert DROPPED.get(name, set()) <= JAX_KEYS[name][1]


@pytest.mark.parametrize("name", ["motion1080p", "parity"])
def test_smoke_run_prints_one_flagged_line(name):
    """A CPU smoke run as a process: exit 0, one JSON line with JAX's
    metric and keys, ``"smoke": true``; the card line and the launches on
    stderr.  (The other scripts' lines are checked in-process, at the
    sizes their ``test_torch_benchmarks_*.py`` file runs.)"""
    argv, env = SMOKE[name]
    r = subprocess.run(
        [sys.executable, os.path.join(PORT_DIR, name + ".py")] + argv,
        env=_env(BENCH_FORCE_CPU="1", **env), cwd=REPO,
        capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    rec = _one_line(r.stdout)
    assert rec["smoke"] is True
    check_keys(name, rec)
    assert "# card: cpu" in r.stderr
    assert [ln for ln in r.stderr.splitlines()
            if ln.startswith("# launches ")]


def test_no_card_exits_non_zero():
    """Without ``BENCH_FORCE_CPU`` a script asks for the card; with none
    the process exits non-zero, says so and prints no line."""
    argv, _ = SMOKE["motion1080p"]
    r = subprocess.run(
        [sys.executable, os.path.join(PORT_DIR, "motion1080p.py")] + argv,
        env=_env(CUDA_VISIBLE_DEVICES="", BENCH_WH="32x32"), cwd=REPO,
        capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert "no CUDA device" in r.stderr
    assert not r.stdout.strip()


@pytest.mark.parametrize("script", sorted(SMOKE) + list(EXAMPLES))
def test_no_card_without_force_cpu_is_an_error(script, monkeypatch):
    """Every script and example raises before it renders anything when no
    card is present and the caller did not ask for the CPU, and prints no
    line."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for k in ("BENCH_FORCE_CPU", "BENCH_DEPTH"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("BENCH_WH", "32x32")
    if script in EXAMPLES:
        spec = importlib.util.spec_from_file_location(
            f"torch_example_{script}",
            os.path.join(REPO, "examples", script + ".py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        call = (lambda: mod.main(0)) if "multihost" in script else mod.main
    else:
        mod = load("torch", script)
        monkeypatch.setattr(sys, "argv", [script + ".py"] + SMOKE[script][0])
        call = mod.main
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert not out.getvalue().strip()


@pytest.mark.parametrize("knob", ["BENCH_FORCE_CPU", "BENCH_WH",
                                  "BENCH_DEPTH", None])
def test_overrides_mark_smoke(knob, monkeypatch):
    """Each knob marks the run as smoke; the CPU only under
    ``BENCH_FORCE_CPU``, and without it and without a card ``apply``
    raises."""
    import torch
    ov = load("torch", "_overrides_torch")
    for k in ("BENCH_FORCE_CPU", "BENCH_WH", "BENCH_DEPTH"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    value = {"BENCH_FORCE_CPU": "1", "BENCH_WH": "64x36",
             "BENCH_DEPTH": "5"}
    if knob is not None:
        monkeypatch.setenv(knob, value[knob])
    if knob != "BENCH_FORCE_CPU":
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ov.apply(1920, 1080, 8)
        monkeypatch.setenv("BENCH_FORCE_CPU", "1")
    w, h, d, smoke, dev = ov.apply(1920, 1080, 8)
    assert dev == torch.device("cpu") and smoke
    assert (w, h) == ((64, 36) if knob == "BENCH_WH" else (1920, 1080))
    assert d == (5 if knob == "BENCH_DEPTH" else 8)
    assert ov.apply(1920, 1080)[2] is None       # no depth knob
