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
            "mega_nerf_viewer_tpu_torch.probes.gather_probe\n"
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


def _sources():
    out = []
    for root, _, files in os.walk(PORT):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    out.append(os.path.join(REPO, "chip_smoke.py"))
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
            os.path.join("probes", "gather_probe.py")} <= names
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


def _entry_points():
    import mega_nerf_viewer_tpu_torch as P
    from mega_nerf_viewer_tpu_torch import api, cli
    from mega_nerf_viewer_tpu_torch.ops import accel
    from mega_nerf_viewer_tpu_torch.probes import gather_probe
    from mega_nerf_viewer_tpu_torch.utils.tuning import device_tuning
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
    ]


@pytest.mark.parametrize("i", range(11))
def test_entry_point_without_device_needs_a_card(i, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _entry_points()[i]()


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
