"""The port's headless API, CLI, PNG/APNG writer, metrics and tree
persistence against the JAX package (``tests/test_api.py:14-31`` and the
CLI cases of ``tests/test_viewer.py:110-135``, with ``--device cpu``).

Tolerances: frames within 1e-5 of JAX's (sphere trees, sigma <= 40);
exact and fast frames of the port within 1e-6 of each other; CLI PNGs
within one rgba8 step of JAX's CLI output (a pixel within 1e-5 can round
the other way); PNG and APNG bytes, ``psnr`` and saved trees equal.
"""

import os

import numpy as np
import pytest
import torch

import mega_nerf_viewer_tpu.n3tree as J
import mega_nerf_viewer_tpu_torch as P
from mega_nerf_viewer_tpu import api as JAPI
from mega_nerf_viewer_tpu import cli as JCLI
from mega_nerf_viewer_tpu.camera import Camera as JCamera
from mega_nerf_viewer_tpu.options import RenderOptions as JOptions
from mega_nerf_viewer_tpu.utils import metrics as JMET
from mega_nerf_viewer_tpu.utils import png as JPNG
from mega_nerf_viewer_tpu_torch import api as PAPI
from mega_nerf_viewer_tpu_torch import cli as PCLI
from mega_nerf_viewer_tpu_torch.utils import metrics as PMET
from mega_nerf_viewer_tpu_torch.utils import png as PPNG

from test_torch_exact import port

PIX_TOL = 1e-5


def _cam(cls):
    cam = cls(12, 12, 16.0)
    cam.center = np.array([-1.5, 0.1, 1.4], np.float32)
    return cam


# ----------------------------------------------------------------------
# api (test_api.py)
# ----------------------------------------------------------------------
def test_render_exact_vs_fast_identical():
    jt = J.sphere_tree(basis_dim=4, depth=3)
    pt = port(jt)
    a = PAPI.render(pt, _cam(P.Camera), P.RenderOptions())
    b = PAPI.render(pt, _cam(P.Camera), P.RenderOptions(), fast=True)
    assert isinstance(a, np.ndarray) and a.shape == (12, 12, 4)
    np.testing.assert_allclose(a, b, atol=1e-6)
    for fast, got in ((False, a), (True, b)):
        want = JAPI.render(jt, _cam(JCamera), JOptions(), fast=fast)
        assert float(np.abs(got - want).max()) <= PIX_TOL


def test_render_fast_falls_back_on_overflow(monkeypatch):
    """An overflowing fast frame is replaced by the exact frame."""
    from mega_nerf_viewer_tpu_torch.ops import accel
    pt = P.sphere_tree(basis_dim=4, depth=3, device="cpu")
    exact = PAPI.render(pt, _cam(P.Camera), P.RenderOptions())
    orig = accel.render_frame_fast

    def starved(*a, **k):
        return orig(*a, **dict(k, max_dense=0))
    monkeypatch.setattr(accel, "render_frame_fast", starved)
    got = PAPI.render(pt, _cam(P.Camera), P.RenderOptions(), fast=True)
    np.testing.assert_array_equal(got, exact)


def test_render_writes_png(tmp_path):
    jt = J.sphere_tree(basis_dim=1, depth=2)
    pp, pj = str(tmp_path / "p.png"), str(tmp_path / "j.png")
    img = PAPI.render(port(jt), _cam(P.Camera),
                      P.RenderOptions(background_brightness=0.2), out_path=pp)
    JAPI.render(jt, _cam(JCamera), JOptions(background_brightness=0.2),
                out_path=pj)
    assert img.shape == (12, 12, 4)
    a, b = JPNG.read_png(pj), PPNG.read_png(pp)
    assert b.shape == (12, 12, 4)
    assert int(np.abs(a.astype(np.int16) - b).max()) <= 1


def test_load_tree(tmp_path):
    jt = J.sphere_tree(basis_dim=1, depth=2)
    p = str(tmp_path / "t.npz")
    jt.save_npz(p)
    cap = int(jt.capacity)
    t2 = PAPI.load_tree(p, max_capacity=cap + 10, device="cpu")
    assert t2.max_capacity == cap + 10 and t2.capacity == cap
    t3 = PAPI.load_tree(p, bounds_only=True, device="cpu")
    assert t3.capacity == 1


# ----------------------------------------------------------------------
# the tree's persistence and index packing
# ----------------------------------------------------------------------
ARRAYS = ("data", "child", "parent", "sample_counts", "scale", "offset")


def _refined_tree():
    """A tree whose chunks sit at several depths (the depth fixpoint has
    work to do)."""
    return J.random_tree(n_chunks=40, basis_dim=4, seed=3, N=2)


def test_save_npz_round_trip_both_ways(tmp_path):
    jt = _refined_tree()
    pt = port(jt)
    pj, pp = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jt.save_npz(pj)
    pt.save_npz(pp)
    with np.load(pj) as a, np.load(pp) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            assert a[k].dtype == b[k].dtype, k
        depth = b["parent_depth"][:, 1]
        assert depth[0] == 0 and depth.max() >= 2
    # port save -> JAX open, JAX save -> port open
    j2 = J.N3Tree.open(pp)
    p2 = P.N3Tree.open(pj, device="cpu")
    for k in ARRAYS:
        np.testing.assert_array_equal(np.asarray(getattr(j2, k)),
                                      getattr(pt, k).numpy(), err_msg=k)
        np.testing.assert_array_equal(getattr(p2, k).numpy(),
                                      np.asarray(getattr(jt, k)), err_msg=k)
    assert p2.data_format == pt.data_format
    assert str(j2.data_format.to_string()) == pt.data_format.to_string()


@pytest.mark.parametrize("N", [2, 3])
def test_pack_unpack_index(N):
    jt = J.random_tree(n_chunks=5, basis_dim=1, seed=1, N=N)
    pt = port(jt)
    for nd, i, j, k in ((0, 0, 0, 0), (3, N - 1, 0, 1), (4, 1, N - 1, N - 1)):
        packed = pt.pack_index(nd, i, j, k)
        assert packed == jt.pack_index(nd, i, j, k)
        assert pt.unpack_index(packed) == jt.unpack_index(packed) \
            == (nd, i, j, k)
    with pytest.raises(ValueError):
        pt.pack_index(0, N, 0, 0)


# ----------------------------------------------------------------------
# PNG, APNG and metrics: the same bytes as the JAX package's encoder
# ----------------------------------------------------------------------
@pytest.mark.parametrize("shape,level", [((9, 13, 4), 1), ((9, 13, 3), 1),
                                         ((7, 5, 4), 0)])
def test_png_bytes_equal(shape, level, tmp_path):
    rng = np.random.RandomState(sum(shape))
    img = rng.randint(0, 256, shape).astype(np.uint8)
    blob = PPNG.encode_png(img, level)
    assert blob == JPNG.encode_png(img, level)
    np.testing.assert_array_equal(PPNG.decode_png(blob), img)
    p = str(tmp_path / "x.png")
    assert PPNG.write_png(p, img)
    np.testing.assert_array_equal(PPNG.read_png(p), JPNG.read_png(p))
    with pytest.raises(ValueError):
        PPNG.encode_png(img.astype(np.float32))


def test_apng_bytes_equal(tmp_path):
    rng = np.random.RandomState(4)
    frames = [rng.randint(0, 256, (6, 8, 4)).astype(np.uint8)
              for _ in range(3)]
    blob = PPNG.encode_apng(frames, fps=12.0, loops=2)
    assert blob == JPNG.encode_apng(frames, fps=12.0, loops=2)
    got, fps, loops = PPNG.decode_apng(blob)
    assert loops == 2 and abs(fps - 12.0) < 0.1
    for a, b in zip(got, frames):
        np.testing.assert_array_equal(a, b)
    enc = PPNG.ApngEncoder(fps=30.0)
    with pytest.raises(ValueError):
        enc.tobytes()
    enc.add(frames[0])
    with pytest.raises(ValueError):
        enc.add(frames[0][:, :4])
    p = str(tmp_path / "a.apng")
    assert PPNG.write_apng(p, frames)
    with open(p, "rb") as f:
        assert f.read() == JPNG.encode_apng(frames)


def test_metrics_match():
    rng = np.random.RandomState(0)
    a = rng.rand(8, 8, 3).astype(np.float32)
    b = a + rng.randn(8, 8, 3).astype(np.float32) * 0.01
    assert PMET.psnr(a, b) == JMET.psnr(a, b)
    assert PMET.psnr(a, a) == float("inf")
    fc = PMET.FpsCounter(window=10.0)
    assert fc.fps == 0.0
    for _ in range(3):
        fc.tick()
    assert fc.fps > 0
    t = PMET.FrameTimer()
    with t.time("x"):
        pass
    assert len(t.records["x"]) == 1 and t.mean_ms("x") >= 0
    assert t.mean_ms("none") == 0.0


# ----------------------------------------------------------------------
# cli (test_viewer.py:110-135), the port with --device cpu
# ----------------------------------------------------------------------
def _cli_pair(tmp_path, depth, args, out_name):
    tree = J.sphere_tree(basis_dim=1, depth=depth)
    npz = str(tmp_path / "t.npz")
    tree.save_npz(npz)
    outs = []
    for name, main, extra in (("jax", JCLI.main, []),
                              ("port", PCLI.main, ["--device", "cpu"])):
        d = tmp_path / name
        d.mkdir()
        out = str(d / out_name)
        assert main([npz, *args, "-o", out, *extra]) == 0
        outs.append(out)
    return outs


def _close_png(pj, pp):
    a, b = JPNG.read_png(pj), PPNG.read_png(pp)
    assert a.shape == b.shape
    assert int(np.abs(a.astype(np.int16) - b).max()) <= 1
    return b


def test_cli_smoke(tmp_path):
    oj, op = _cli_pair(tmp_path, 3, ["-w", "24", "--height", "24", "--fx",
                                     "30", "--center=-1.5,0.1,1.4", "--bg",
                                     "0.5"], "o.png")
    assert _close_png(oj, op).shape == (24, 24, 4)


@pytest.mark.parametrize("extra", [[], ["--host-unpermute"]])
def test_cli_orbit_frames(tmp_path, extra):
    oj, op = _cli_pair(tmp_path, 2, ["-w", "8", "--height", "8", "--fx",
                                     "10", "--frames", "3", "--orbit",
                                     *extra], "orbit.png")
    for f in range(3):
        _close_png(oj.replace(".png", f"_{f:04d}.png"),
                   op.replace(".png", f"_{f:04d}.png"))


@pytest.mark.parametrize("extra", [["--turbo"], ["--motion-mode", "dilate"],
                                   ["--turbo", "--motion-mode", "rehint"]])
def test_cli_turbo_and_motion_mode(tmp_path, extra, monkeypatch):
    """--turbo and --motion-mode render, frame by frame, the PNGs of the
    JAX CLI (within one rgba8 step); --turbo builds the turbo map."""
    from mega_nerf_viewer_tpu_torch.ops import accel as PA
    built = []
    orig = PA.build_turbo_leaf_map

    def spy(*a, **kw):
        built.append(kw.get("sigma_thresh"))
        return orig(*a, **kw)
    monkeypatch.setattr(PA, "build_turbo_leaf_map", spy)
    oj, op = _cli_pair(tmp_path, 3, ["-w", "16", "--height", "12", "--fx",
                                     "20", "--center=-1.5,0.1,1.4",
                                     "--frames", "3", "--orbit", *extra],
                       "m.png")
    for f in range(3):
        _close_png(oj.replace(".png", f"_{f:04d}.png"),
                   op.replace(".png", f"_{f:04d}.png"))
    assert bool(built) == ("--turbo" in extra)


def test_cli_apng_depth_and_save_tree(tmp_path):
    """An APNG of a depth-mode orbit, and --save_tree, against JAX's CLI."""
    tree = J.sphere_tree(basis_dim=1, depth=3)
    npz = str(tmp_path / "t.npz")
    tree.save_npz(npz)
    args = [npz, "-w", "16", "--height", "12", "--fx", "20",
            "--center=-1.5,0.1,1.4", "--frames", "2", "--orbit",
            "--render_depth"]
    blobs = []
    for name, main, extra in (("jax", JCLI.main, []),
                              ("port", PCLI.main, ["--device", "cpu"])):
        out = str(tmp_path / f"{name}.apng")
        saved = str(tmp_path / f"{name}_saved.npz")
        assert main([*args, "-o", out, "--save_tree", saved, *extra]) == 0
        with open(out, "rb") as f:
            blobs.append(JPNG.decode_apng(f.read())[0])
    for a, b in zip(*blobs):
        assert int(np.abs(a.astype(np.int16) - b).max()) <= 1
    with np.load(str(tmp_path / "jax_saved.npz")) as a, \
            np.load(str(tmp_path / "port_saved.npz")) as b:
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_cli_refuses_unported_flags(tmp_path):
    """The port leaves no CLI mode out any more (``--sharded`` is ported;
    ``test_torch_parallel.py`` holds it against the JAX CLI's); what is
    left here: a missing tree file fails with exit code 1, and the device
    defaults to the card."""
    assert PCLI.main([str(tmp_path / "missing.npz"), "--device", "cpu"]) == 1
    assert PCLI.build_parser().parse_args([]).device is None


def test_cli_module_runs(tmp_path):
    """``python -m mega_nerf_viewer_tpu_torch.cli`` as a user runs it."""
    import subprocess
    import sys
    tree = P.sphere_tree(basis_dim=1, depth=2, device="cpu")
    npz = str(tmp_path / "t.npz")
    tree.save_npz(npz)
    out = str(tmp_path / "m.png")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run(
        [sys.executable, "-m", "mega_nerf_viewer_tpu_torch.cli", npz, "-w",
         "8", "--height", "8", "--fx", "10", "-o", out, "--device", "cpu"],
        cwd=repo, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert PPNG.read_png(out).shape == (8, 8, 4)
    assert "on CPU" in r.stdout
