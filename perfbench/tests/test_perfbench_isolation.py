"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the program (top-level module names compared
whole: the port's name begins with the JAX package's)."""

import ast
import glob
import json
import os
import subprocess
import sys

from conftest import ROOT

BASE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "base")

REHEARSAL = r"""
import json, sys
sys.path.insert(0, {root!r})
sys.path.insert(0, {tests!r})
from conftest import tiny
from perfbench import harness
for wl in ("syn512_orbit", "d11_parked", "syn512_parked"):
    cfg, mix = tiny(wl)
    res, _ = harness.run_cell(wl, 99, 0.2, True, device="cpu",
                              root={cache!r}, cfg=cfg, mix=mix,
                              log=lambda m: None)
    assert res["correct"], (wl, res)
# a configuration with a model, under the guided kind
res, _ = harness.run_cell("fixture_guided", 99, 0.2, True, device="cpu",
                          root={cache!r}, base={base!r},
                          log=lambda m: None)
assert res["correct"], res
print(json.dumps(harness.forbidden_modules()))
"""


def _top(name):
    return name.split(".", 1)[0]


def test_rehearsal_of_every_mix_loads_no_jax(tmp_path):
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["workloads"].append({"name": "fixture_guided",
                               "config": "fixture_guided",
                               "traffic": "fixture_stops", "chips": 1,
                               "why": "a test's guided stops"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = REHEARSAL.format(root=ROOT, tests=os.path.dirname(__file__),
                            cache=str(tmp_path), base=BASE)
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=900, cwd=str(tmp_path))
    assert p.returncode == 0, p.stderr[-3000:]
    assert json.loads(p.stdout.strip().splitlines()[-1]) == []


def test_reference_imports_nothing_of_the_program():
    files = glob.glob(os.path.join(ROOT, "perfbench", "reference", "*.py"))
    assert files
    for f in files:
        tree = ast.parse(open(f).read())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            for n in names:
                assert _top(n) not in ("mega_nerf_viewer_tpu_torch",
                                       "mega_nerf_viewer_tpu", "jax"), (f, n)
    code = ("import sys, json; sys.path.insert(0, %r); "
            "import perfbench.reference.render; "
            "print(json.dumps(sorted({m.split('.', 1)[0] "
            "for m in sys.modules})))" % ROOT)
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    tops = set(json.loads(p.stdout))
    assert not tops & {"mega_nerf_viewer_tpu_torch", "mega_nerf_viewer_tpu",
                       "jax", "jaxlib", "flax"}


def test_a_models_reference_imports_nothing_of_the_program():
    """``models/<arch>.py`` imports the port only inside ``build``: its
    plain forward loads nothing of the program (the fixture model, as a
    later configuration's file would)."""
    code = ("import sys, json; sys.path.insert(0, %r); import torch; "
            "from perfbench import registry; "
            "spec = registry.config('fixture_guided', %r)['model']; "
            "f = registry.model_module(spec['arch'], %r).reference(spec, "
            "'cpu'); f(torch.zeros(3, dtype=torch.int64), "
            "torch.zeros(3, spec['input_dim'])); "
            "print(json.dumps([torch.backends.cuda.matmul.allow_tf32, "
            "torch.backends.cudnn.allow_tf32, sorted({m.split('.', 1)[0] "
            "for m in sys.modules})]))" % (ROOT, BASE, BASE))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    tf32, cudnn_tf32, tops = json.loads(p.stdout)
    assert tf32 is False and cudnn_tf32 is False
    assert not set(tops) & {"mega_nerf_viewer_tpu_torch",
                            "mega_nerf_viewer_tpu", "jax", "jaxlib", "flax"}


def test_forbidden_names_are_compared_whole():
    from perfbench import harness
    before = dict(sys.modules)
    try:
        sys.modules["mega_nerf_viewer_tpu_torch_probe"] = object()
        sys.modules["jaxtyping_probe"] = object()
        assert harness.forbidden_modules() == sorted(
            m for m in before if _top(m) in harness.FORBIDDEN)
        sys.modules["jax.probe"] = object()
        assert "jax.probe" in harness.forbidden_modules()
    finally:
        for k in ("mega_nerf_viewer_tpu_torch_probe", "jaxtyping_probe",
                  "jax.probe"):
            sys.modules.pop(k, None)
