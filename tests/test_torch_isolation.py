"""The port stands alone: it imports neither JAX nor the JAX package, and
its entry points never fall back to the CPU on their own."""

import os
import re
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "mega_nerf_viewer_tpu_torch")
IMPORT_RE = re.compile(
    r"^\s*(import|from)\s+(jax|mega_nerf_viewer_tpu)(\.|\s|$)", re.M)


def test_import_leaves_out_jax():
    code = ("import sys, mega_nerf_viewer_tpu_torch, "
            "mega_nerf_viewer_tpu_torch.kernels, "
            "mega_nerf_viewer_tpu_torch.ops.accel, "
            "mega_nerf_viewer_tpu_torch.ops.guided, "
            "mega_nerf_viewer_tpu_torch.ops.compact_composite, "
            "mega_nerf_viewer_tpu_torch.ops.padded_composite, "
            "mega_nerf_viewer_tpu_torch.ops.refine, "
            "mega_nerf_viewer_tpu_torch.ops.render, "
            "mega_nerf_viewer_tpu_torch.models, "
            "mega_nerf_viewer_tpu_torch.viewer, "
            "mega_nerf_viewer_tpu_torch.api, "
            "mega_nerf_viewer_tpu_torch.cli, "
            "mega_nerf_viewer_tpu_torch.utils.png, "
            "mega_nerf_viewer_tpu_torch.utils.metrics, "
            "mega_nerf_viewer_tpu_torch.utils.profiling, "
            "mega_nerf_viewer_tpu_torch.utils.wireframe, "
            "mega_nerf_viewer_tpu_torch.utils.mesh, "
            "mega_nerf_viewer_tpu_torch.web, "
            "mega_nerf_viewer_tpu_torch.native, "
            "mega_nerf_viewer_tpu_torch.ops.oracle, "
            "mega_nerf_viewer_tpu_torch.probes.gather_probe, "
            "mega_nerf_viewer_tpu_torch.probes.prepass_breakdown, "
            "mega_nerf_viewer_tpu_torch.probes.exact_breakdown, "
            "mega_nerf_viewer_tpu_torch.parallel, "
            "mega_nerf_viewer_tpu_torch.parallel.mesh, "
            "mega_nerf_viewer_tpu_torch.parallel.render, "
            "mega_nerf_viewer_tpu_torch.parallel.model, "
            "mega_nerf_viewer_tpu_torch.parallel.step, "
            "mega_nerf_viewer_tpu_torch.parallel.guided, "
            "mega_nerf_viewer_tpu_torch.parallel.motion, "
            "mega_nerf_viewer_tpu_torch.parallel.multihost\n"
            "sys.path.insert(0, 'tests')\n"
            "import torch_parallel_worker\n"
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m == 'mega_nerf_viewer_tpu' "
            "or m.startswith('mega_nerf_viewer_tpu.')]\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_aerial_artifact_leaves_out_jax(tmp_path):
    """``bench_torch.aerial_artifact`` builds the aerial artifact (here at
    depth 5) from ``gen_fixtures``' numpy fields without JAX."""
    path = str(tmp_path / "aerial_d5.npz")
    code = ("import os, sys\n"
            "sys.path.insert(0, os.getcwd())\n"
            "import bench_torch\n"
            f"_, cap = bench_torch.aerial_artifact({path!r}, depth=5)\n"
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m == 'mega_nerf_viewer_tpu' "
            "or m.startswith('mega_nerf_viewer_tpu.')]\n"
            "print(cap, bad)\n"
            "sys.exit(1 if bad or cap < 100 else 0)\n")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert os.path.exists(path)


def test_bench_parent_leaves_out_torch():
    """``bench_torch.py``'s supervisor imports the standard library only:
    neither ``torch`` nor JAX nor either package."""
    code = ("import os, sys\n"
            "sys.path.insert(0, os.getcwd())\n"
            "import bench_torch\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'jax', 'numpy', 'mega_nerf_viewer_tpu', "
            "'mega_nerf_viewer_tpu_torch')]\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def _sources():
    out = []
    for root, _, files in os.walk(PORT):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    out.append(os.path.join(REPO, "chip_smoke.py"))
    out.append(os.path.join(REPO, "bench_torch.py"))
    out.append(os.path.join(REPO, "tests", "torch_parallel_worker.py"))
    return out


def test_no_source_imports_jax():
    srcs = _sources()
    assert len(srcs) >= 10
    names = {os.path.relpath(p, PORT) for p in srcs}
    assert {os.path.join("ops", "guided.py"),
            os.path.join("ops", "compact_composite.py"),
            os.path.join("ops", "padded_composite.py"),
            os.path.join("ops", "refine.py"),
            os.path.join("ops", "render.py"),
            os.path.join("models", "meganerf.py"), "viewer.py", "api.py",
            "cli.py", os.path.join("utils", "png.py"),
            os.path.join("utils", "metrics.py"),
            os.path.join("utils", "profiling.py"),
            os.path.join("utils", "wireframe.py"),
            os.path.join("utils", "mesh.py"), "web.py", "native.py",
            "version.py", os.path.join("ops", "oracle.py"),
            os.path.join("probes", "gather_probe.py"),
            os.path.join("probes", "prepass_breakdown.py"),
            os.path.join("probes", "exact_breakdown.py"),
            os.path.join("parallel", "__init__.py"),
            os.path.join("parallel", "mesh.py"),
            os.path.join("parallel", "render.py"),
            os.path.join("parallel", "model.py"),
            os.path.join("parallel", "step.py"),
            os.path.join("parallel", "guided.py"),
            os.path.join("parallel", "motion.py"),
            os.path.join("parallel", "multihost.py"),
            os.path.join("..", "tests", "torch_parallel_worker.py"),
            os.path.join("..", "bench_torch.py")} <= names
    for path in srcs:
        with open(path) as f:
            text = f.read()
        m = IMPORT_RE.search(text)
        assert m is None, f"{path}: {m.group(0)!r}"


def test_import_pattern_is_strict():
    assert IMPORT_RE.search("import jax.numpy as jnp")
    assert IMPORT_RE.search("  from mega_nerf_viewer_tpu.ops import accel")
    assert IMPORT_RE.search("import jax")
    assert not IMPORT_RE.search("from mega_nerf_viewer_tpu_torch import x")
    assert not IMPORT_RE.search("import mega_nerf_viewer_tpu_torch")
    assert not IMPORT_RE.search("# the jax package is the reference")


def _fallback_container(tmp_path):
    """A container whose sine activation does not convert."""
    class Sine(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.l0 = torch.nn.Linear(3, 4)

        def forward(self, x, sigma_only: bool = False):
            return torch.sin(self.l0(x))

    class Container(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.grid_dim = torch.tensor([1, 1], dtype=torch.int32)
            self.min_position = torch.zeros(3)
            self.max_position = torch.ones(3)
            self.centroids = torch.zeros(1, 3)
            self.need_viewdir = False
            self.need_appearance_embedding = False
            self.sub_module_0 = torch.jit.script(Sine())

    path = str(tmp_path / "sine.pt")
    torch.jit.save(torch.jit.script(Container()), path)
    return path


def _entry_points(tmp_path):
    import mega_nerf_viewer_tpu_torch as P
    from mega_nerf_viewer_tpu_torch import api, cli, parallel
    from mega_nerf_viewer_tpu_torch.ops import accel
    from mega_nerf_viewer_tpu_torch.probes import exact_breakdown, \
        gather_probe, prepass_breakdown
    from mega_nerf_viewer_tpu_torch.utils.tuning import device_tuning
    sys.path.insert(0, REPO)
    import bench_torch
    fixture = os.path.join(REPO, "tests", "fixtures", "digger_sh4.npz")
    return [
        lambda: P.shell_tree(depth=2),
        lambda: P.sphere_tree(depth=2),
        lambda: P.N3Tree.open(fixture),
        lambda: accel.block_permutation(8, 8, 4),
        lambda: device_tuning(),
        lambda: P.MegaNeRFModel.synthetic(),
        lambda: P.MegaNeRFModel.from_torchscript(
            os.path.join(REPO, "tests", "fixtures", "meganerf_8x64.pt")),
        lambda: P.Viewer(),
        lambda: api.load_tree(fixture),
        lambda: cli.main([fixture, "-w", "8", "--height", "8"]),
        lambda: gather_probe.main(["11"]),
        lambda: prepass_breakdown.main(["1"]),
        lambda: exact_breakdown.main(["1"]),
        lambda: P.serve(port=0),
        lambda: P.WebViewer(P.Viewer(), port=0),
        lambda: cli.main([fixture, "-w", "8", "--height", "8", "--serve",
                          "0"]),
        lambda: parallel.default_mesh(),
        lambda: parallel.make_mesh((1,), (parallel.RAY_AXIS,)),
        lambda: parallel.multihost.global_mesh(),
        lambda: parallel.multihost.initialize("127.0.0.1:1", 1, 0),
        lambda: parallel.make_frame_refine_step(parallel.default_mesh(),
                                                P.RenderOptions()),
        lambda: cli.main([fixture, "-w", "8", "--height", "8",
                          "--sharded"]),
        lambda: P.MegaNeRFModel.from_torchscript(
            _fallback_container(tmp_path)),
        lambda: bench_torch.setup_source(2, 8, 8),
    ]


@pytest.mark.parametrize("i", range(24))
def test_entry_point_without_device_needs_a_card(i, monkeypatch, tmp_path):
    import torch.distributed as dist
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _entry_points(tmp_path)[i]()
    assert not dist.is_initialized()      # no group was started


def test_nccl_asked_for_is_never_gloo(monkeypatch):
    """Asking for NCCL where it is missing raises and starts no group: no
    helper swaps in gloo."""
    import torch.distributed as dist
    from mega_nerf_viewer_tpu_torch.parallel import mesh
    started = []
    monkeypatch.setattr(dist, "is_nccl_available", lambda: False)
    monkeypatch.setattr(dist, "init_process_group",
                        lambda *a, **kw: started.append((a, kw)))
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: None)
    for dev in ("cpu", "cuda:0"):
        with pytest.raises(RuntimeError, match="NCCL was asked for"):
            mesh.init_world(device=dev, backend="nccl")
    with pytest.raises(RuntimeError, match="NCCL was asked for"):
        mesh.init_world(device="cuda:0")       # the card's default
    assert not started and not dist.is_initialized()


def test_kernels_refuse_cpu_tensors():
    from mega_nerf_viewer_tpu_torch import kernels
    d = torch.zeros((4, 3))
    r = torch.zeros(4)
    before = dict(kernels.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        kernels.skip_prepass(torch.zeros((80, 128), dtype=torch.int32),
                             torch.zeros(3), d, d, r, r,
                             torch.ones(4, dtype=torch.bool), 1e-4)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        kernels.compact_composite(torch.zeros((8, 5)), torch.zeros(8),
                                  torch.zeros(4, dtype=torch.int32),
                                  torch.zeros(4, dtype=torch.int32),
                                  torch.zeros((8, 3)), 1, True, 0, 24)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        kernels.gather_chunk_sums(torch.zeros((16, 8), dtype=torch.int32),
                                  torch.zeros(2048, dtype=torch.int32))
    assert kernels.LAUNCHES == before     # a refused call launched nothing


def test_collect_kernel_refuses_cpu_tensors():
    import mega_nerf_viewer_tpu_torch as P
    from mega_nerf_viewer_tpu_torch import kernels
    tree = P.sphere_tree(depth=2, device="cpu")
    lm = P.build_leaf_map(tree)
    d = torch.zeros((4, 3))
    r = torch.zeros(4)
    before = dict(kernels.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        kernels.collect(tree, lm, torch.zeros(3), d, d, r, r, r,
                        torch.zeros(4, dtype=torch.bool), 8, 1e-4, 1e-2,
                        1e-2)
    assert kernels.LAUNCHES == before


def test_kernel_library_path_is_in_checkout():
    from mega_nerf_viewer_tpu_torch import kernels
    p = kernels.library_path()
    assert str(p).startswith(os.path.join(REPO, "build", "kernels"))
    assert "-fmad=false" in kernels.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in kernels.NVCC_FLAGS


def test_exact_kernels_refuse_cpu_tensors():
    """Kernels E, F and G take CUDA tensors only; the entry points run
    their plain versions on CPU tensors and launch nothing."""
    import numpy as np
    import mega_nerf_viewer_tpu_torch as P
    from mega_nerf_viewer_tpu_torch import kernels
    from mega_nerf_viewer_tpu_torch.ops import accel, guided
    tree = P.sphere_tree(depth=2, device="cpu")
    opt = P.RenderOptions(max_guided_samples=4)
    d = torch.nn.functional.normalize(torch.randn(4, 3), dim=1)
    cen = torch.tensor([-1.5, 0.1, 1.4])
    m = accel.march_inputs(tree, d, d, cen, opt)
    grid = (torch.tensor([1, 1], dtype=torch.int32), torch.zeros(3),
            torch.ones(3))
    before = dict(kernels.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        kernels.exact_march(tree, m, opt, True, 20, 0)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        kernels.exact_collect(tree, guided.collect_inputs(
            tree, d, cen, opt), d, d, cen, grid, opt, True, 20)
    P.render_rays(tree, d, d, cen, opt, track_visit=True)
    P.collect_samples(tree, d, d, cen, np.array([1, 1]), np.zeros(3),
                      np.ones(3), opt, track_visit=True)
    assert kernels.LAUNCHES == before


def _native_loads(monkeypatch, env):
    """The paths ``native`` hands to ``ctypes.CDLL`` when it first loads,
    with ``NERFVIEW_NATIVE_LIB`` set to ``env`` (or unset)."""
    import ctypes
    from mega_nerf_viewer_tpu_torch import native
    loaded = []
    cdll = ctypes.CDLL

    def spy(path, *a, **kw):
        loaded.append(os.path.realpath(str(path)))
        return cdll(path, *a, **kw)

    monkeypatch.setattr(ctypes, "CDLL", spy)
    if env is None:
        monkeypatch.delenv("NERFVIEW_NATIVE_LIB", raising=False)
    else:
        monkeypatch.setenv("NERFVIEW_NATIVE_LIB", env)
    monkeypatch.setattr(native, "_TRIED", False)
    monkeypatch.setattr(native, "_LIB", None)
    assert native.available(), native.build_error()
    return loaded


def test_native_never_loads_the_committed_library(monkeypatch):
    """The port builds ``native/nerfview_native.cpp`` into
    ``build/native/`` and never loads ``native/libnerfview.so`` (built
    with -march=native for another CPU)..."""
    from mega_nerf_viewer_tpu_torch import native
    committed = os.path.realpath(os.path.join(REPO, "native",
                                              "libnerfview.so"))
    loaded = _native_loads(monkeypatch, None)
    assert loaded == [os.path.realpath(str(native.library_path()))]
    assert committed not in loaded


def test_native_override_wins(monkeypatch, tmp_path):
    """...unless ``NERFVIEW_NATIVE_LIB`` names it (or any library): the
    override wins over the build, and a missing one falls back to it."""
    from mega_nerf_viewer_tpu_torch import native
    built = os.path.realpath(str(native.build()))
    committed = os.path.join(REPO, "native", "libnerfview.so")
    assert _native_loads(monkeypatch, committed) == [
        os.path.realpath(committed)]
    assert _native_loads(monkeypatch, str(tmp_path / "none.so")) == [built]
