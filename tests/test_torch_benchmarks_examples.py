"""``examples/quickstart_torch.py`` and ``examples/multihost_render_torch.py``
against the JAX examples, on the CPU.

* The quickstart: JAX's ``examples/quickstart.py`` runs in-process at its
  400x400, the port's ``main(device="cpu")`` beside it.  The PNGs written
  before the refinement step (static, depth, grid) equal JAX's within one
  rgba8 step; the later steps draw random numbers (threefry against a
  ``torch.Generator``), so there only the refinement's growth and the
  images' shapes are held to JAX's.
* The multihost example: two CPU ranks under gloo, as two processes of the
  script; both ranks' frames equal the frame of one process and each
  other, and JAX's within its multihost budget (1e-4, as
  ``test_torch_parallel_w2.py`` holds it).
"""

import contextlib
import importlib.util
import io
import os
import re
import socket
import subprocess
import sys

import numpy as np
import pytest

import mega_nerf_viewer_tpu_torch as P
import mega_nerf_viewer_tpu.n3tree as J
from mega_nerf_viewer_tpu.camera import Camera
from mega_nerf_viewer_tpu.options import RenderOptions
from mega_nerf_viewer_tpu.ops import accel as JA
from mega_nerf_viewer_tpu_torch.utils.png import read_png

from test_torch_benchmarks_contract import few_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(REPO, "examples")
BEFORE_REFINEMENT = ("static", "depth", "grid")
STEPS = ("static", "depth", "grid", "refined", "guided", "mesh_overlay",
         "orbited")


def _load(name, file):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(EXAMPLES, file))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _capacities(text):
    a, b = re.search(r"refinement: (\d+) -> (\d+) chunks", text).groups()
    return int(a), int(b)


@pytest.fixture(scope="module")
def quickstart(tmp_path_factory):
    jdir = str(tmp_path_factory.mktemp("jax_quickstart"))
    pdir = str(tmp_path_factory.mktemp("torch_quickstart"))
    jmod = _load("jax_example_quickstart", "quickstart.py")
    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(out):
        mp.setattr(sys, "argv", ["quickstart.py", jdir])
        jmod.main()
    pmod = _load("torch_example_quickstart", "quickstart_torch.py")
    pout = io.StringIO()
    with contextlib.redirect_stdout(pout):
        res = pmod.main(pdir, device="cpu")
    return jdir, pdir, _capacities(out.getvalue()), res, pout.getvalue()


def test_quickstart_writes_every_step(quickstart):
    jdir, pdir, _, res, text = quickstart
    assert tuple(res.paths) == STEPS == tuple(res.frames)
    for name in STEPS:
        path = os.path.join(pdir, f"{name}.png")
        assert res.paths[name] == path and f"wrote {path}" in text
        img = read_png(path)
        assert img.shape == read_png(os.path.join(jdir, f"{name}.png")).shape
        assert img.shape == (400, 400, 4)
    assert os.path.exists(res.state)
    assert os.path.exists(os.path.join(pdir, "session_tree.npz"))


@pytest.mark.parametrize("name", BEFORE_REFINEMENT)
def test_quickstart_png_before_refinement(quickstart, name):
    jdir, pdir, _, _, _ = quickstart
    a = read_png(os.path.join(pdir, f"{name}.png")).astype(np.int32)
    b = read_png(os.path.join(jdir, f"{name}.png")).astype(np.int32)
    assert int(np.abs(a - b).max()) <= 1
    assert a[..., :3].std() > 1.0            # not a blank image


def test_quickstart_refinement_grows(quickstart):
    """Both start from the same tree and add chunks (how many depends on
    the draws)."""
    _, _, (j0, j1), res, _ = quickstart
    p0, p1 = res.capacity
    assert p0 == j0
    assert p1 > p0 and j1 > j0


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def multihost(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("multihost"))
    port = _free_port()
    script = os.path.join(EXAMPLES, "multihost_render_torch.py")
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "WORLD_SIZE", "RANK", "MASTER_ADDR",
                        "MASTER_PORT", "LOCAL_RANK")}
    procs = [subprocess.Popen(
        [sys.executable, script, str(pid), "--device", "cpu", "--port",
         str(port), "--outdir", out], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for pid in (0, 1)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0, 0], logs
    frames = [np.load(os.path.join(out, f"frame_rank{r}.npy"))
              for r in (0, 1)]
    return out, frames, logs


def _single_frames():
    tree = P.sphere_tree(basis_dim=4, depth=4, device="cpu")
    mod = _load("torch_example_multihost", "multihost_render_torch.py")
    cam, opt = mod.frame_setup()
    img = P.render_frame_fast(tree, P.build_leaf_map(tree), cam, opt,
                              max_dense=32, chunk_size=0)[0].numpy()
    jt = J.sphere_tree(basis_dim=4, depth=4)
    jcam = Camera(cam.width, cam.height, cam.fx)
    jcam.center = np.asarray(cam.center, np.float32)
    jcam._update()
    jimg = JA.render_frame_fast(jt, JA.build_leaf_map(jt), jcam,
                                RenderOptions(), max_dense=32,
                                chunk_size=0)[0]
    return img, np.asarray(jimg)


def test_multihost_ranks_agree(multihost):
    out, (a, b), logs = multihost
    assert "[0] 2 processes, gloo on cpu" in logs[0]
    assert "[1] 2 processes, gloo on cpu" in logs[1]
    np.testing.assert_array_equal(a, b)
    assert os.path.exists(os.path.join(out, "multihost_frame.png"))


def test_multihost_frame_equals_one_process(multihost):
    """Rank 1 started from a transparent tree: after ``broadcast`` its frame
    is rank 0's tree's, equal to the one-process frame and to JAX's."""
    _, (a, _), _ = multihost
    single, jax_frame = _single_frames()
    assert a.shape == (240, 320, 4)
    assert float(a[..., 3].max()) > 0.5
    np.testing.assert_array_equal(a, single)
    np.testing.assert_allclose(a, jax_frame, rtol=0, atol=1e-4)
