"""Find a cell's parts by name.

``BENCHMARK.json`` names every cell (``workloads``), configuration and
metric; each part lives in a file of its own under ``perfbench/``:

* ``configs/<config>.json``: the scene and the Viewer's settings as they
  are run;
* ``traffic/<mix>.json``: a mix's parameters; its ``kind`` names the
  driver that reads them, ``traffic/<kind>.py`` (``drive.py`` holds what
  the kinds share);
* ``metrics/<metric>.py``: the reader of one metric, a function
  ``read(ctx)`` that returns a number or None; a metric split by the
  end-to-end metric it moves (``idle_share.parked``, ``idle_share.orbit``)
  shares the reader of its first part, ``metrics/idle_share.py``, unless
  a file of its whole name is there;
* ``checks/<workload>.json``: the numbers the output comparison holds the
  cell's frames to, with their limits;
* ``models/<arch>.py``: the model a configuration's ``model`` block names
  by its ``arch``: ``build(spec, device)`` gives the port's model, and
  ``reference(spec, device)`` the plain forward the reference runs;
* ``reference/<frame>.py``: the plain reference of one kind of kept frame
  (``voxel``, ``guided``), a function ``frame(tree, cam, opt, ...)``.

A later cell, mix, configuration, model or metric is added as files and
entries; no file here names one.  Each function takes a ``base`` folder
that stands in for ``perfbench/`` (the tests' fixtures); a part that is
not there is taken from ``perfbench/``.
"""

from __future__ import annotations

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return _json(os.path.join(root, "BENCHMARK.json"))


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def _find(base: str, sub: str, fname: str) -> str:
    """``<base>/<sub>/<fname>``, else ``perfbench/<sub>/<fname>``."""
    path = os.path.join(base, sub, fname)
    if os.path.exists(path):
        return path
    return os.path.join(HERE, sub, fname)


def config(name: str, base: str = HERE) -> dict:
    return _json(_find(base, "configs", f"{name}.json"))


def traffic(name: str, base: str = HERE) -> dict:
    return _json(_find(base, "traffic", f"{name}.json"))


def check(name: str, base: str = HERE) -> dict:
    return _json(_find(base, "checks", f"{name}.json"))


def _module(path: str, prefix: str):
    name = os.path.splitext(os.path.basename(path))[0]
    spec = importlib.util.spec_from_file_location(
        prefix + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def kind_driver(kind: str, base: str = HERE):
    """The driver module of a mix kind, ``traffic/<kind>.py``."""
    return _module(_find(base, "traffic", f"{kind}.py"), "perfbench_kind_")


def model_module(arch: str, base: str = HERE):
    """The module of a configuration's model, ``models/<arch>.py``."""
    return _module(_find(base, "models", f"{arch}.py"), "perfbench_model_")


def frame_reference(frame: str, base: str = HERE):
    """The ``frame`` function of ``reference/<frame>.py``: the plain
    reference of one kind of kept frame."""
    return _module(_find(base, "reference", f"{frame}.py"),
                   "perfbench_frame_").frame


def metric_reader(name: str, base: str = HERE):
    """The ``read`` function of ``metrics/<name>.py``, else of
    ``metrics/<first part of name>.py``."""
    path = _find(base, "metrics", f"{name}.py")
    if not os.path.exists(path):
        path = _find(base, "metrics", name.split(".", 1)[0] + ".py")
    return _module(path, "perfbench_metric_").read


def cell_metrics(bench: dict, wl: dict, trace: bool) -> list:
    """The metric entries the cell reports: its end-to-end metrics, or with
    ``trace`` its per-layer ones.  An entry with ``workloads`` is reported
    in those cells; one without, in every cell that reports the
    end-to-end metric it moves."""
    def applies(m):
        return wl["name"] in m["workloads"] if "workloads" in m else None

    e2e = [m for m in bench["end_to_end"]
           if applies(m) is not False]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    out = []
    for m in bench["per_layer"]:
        a = applies(m)
        if a or (a is None and m["moves"] in names):
            out.append(m)
    return out
