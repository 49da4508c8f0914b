"""``benchmarks/parity.py`` through the port: pixel parity of the fast path
on one CUDA card against the scalar oracle on the host.

The scene is JAX's CPU-runnable reference scene: ``sphere_tree(basis_dim=9,
depth=5)`` at 800x800, f = 1111, centre (-1.5, 0.1, 1.4), no MLP.  The frame
is ``render_frame_fast(max_dense=32, chunk_size=1 << 15, block=64)``
(kernels A and B on the card); ``n_probe`` pixels, drawn by
``np.random.RandomState(0)`` as in JAX, are each held against the port's
``ops/oracle.py`` ``trace_ray`` (the transliteration of the reference's
trace loop) on the tree's host copy (``tree_to_host``), with the
background composited.  The target is every probed pixel within 1e-3.

Usage: python benchmarks_torch/parity.py [n_probe_pixels]
Prints ONE JSON line with JAX's keys: ``metric`` ``parity_vs_oracle``,
``max_err``, ``p999_err``, ``frac_within_1e-3``, ``psnr_err_db``,
``pixels_probed``.  Environment: ``_overrides_torch``; unlike JAX's script,
``BENCH_WH`` sets the frame size here too (a smoke run).  On stderr: the
card and its power limit, and the kernel launches of the run.
"""

import os
import sys
from types import SimpleNamespace

sys.path[:0] = [os.path.dirname(os.path.abspath(__file__)),
                os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]

import numpy as np

import _overrides_torch

SIZE = 800
CENTER = (-1.5, 0.1, 1.4)


def probe_indices(width, height, n_probe):
    """JAX's draw of the probed pixels."""
    rng = np.random.RandomState(0)
    return rng.choice(width * height, n_probe, replace=False)


def run(n_probe=2000, width=SIZE, height=SIZE, device=None):
    """The protocol on ``device`` (``None``: the card).  Returns (record
    without ``smoke``, namespace of the frame, the probed indices and
    their errors)."""
    import torch
    import mega_nerf_viewer_tpu_torch as P
    from mega_nerf_viewer_tpu_torch.device import resolve_device
    from mega_nerf_viewer_tpu_torch.ops import accel, oracle
    from mega_nerf_viewer_tpu_torch.ops.rays import rodrigues, screen2worlddir
    dev = resolve_device(device)
    tree = P.sphere_tree(basis_dim=9, depth=5, device=dev)
    opt = P.RenderOptions()
    cam = _overrides_torch.camera(width, height, 1111.0, CENTER)

    lm = accel.build_leaf_map(tree)
    img, overflow, _ = accel.render_frame_fast(
        tree, lm, cam, opt, max_dense=32, chunk_size=1 << 15, block=64)
    assert not int(overflow)
    img = img.cpu().numpy()

    dirs, cen = screen2worlddir(cam.width, cam.height, cam.fx, cam.fy,
                                cam.cx, cam.cy,
                                torch.as_tensor(cam.transform,
                                                dtype=torch.float32))
    vdirs = rodrigues(opt.rot_dirs, dirs)
    dirs, vdirs, cen = (t.numpy() for t in (dirs, vdirs, cen))

    idx = probe_indices(width, height, n_probe)
    host = oracle.tree_to_host(tree)
    flat = img.reshape(-1, 4)
    errs = []
    for i in idx:
        want, _, _, _ = oracle.trace_ray(host, dirs[i], vdirs[i], cen, opt)
        want[:3] += np.float32(opt.background_brightness) * (
            np.float32(1.0) - want[3])
        errs.append(np.abs(flat[i] - want).max())
    errs = np.asarray(errs)
    mse = float(np.mean(errs ** 2))
    psnr = 10 * np.log10(1.0 / mse) if mse > 0 else float("inf")
    record = {
        "metric": "parity_vs_oracle",
        "max_err": float(errs.max()),
        "p999_err": float(np.quantile(errs, 0.999)),
        "frac_within_1e-3": float(np.mean(errs < 1e-3)),
        "psnr_err_db": round(psnr, 1),
        "pixels_probed": n_probe,
    }
    return record, SimpleNamespace(img=img, idx=idx, errs=errs)


def main():
    n_probe = int(sys.argv[1]) if len(sys.argv) > 1 else 2000
    width, height, _, smoke, dev = _overrides_torch.apply(SIZE, SIZE)
    record, _ = run(n_probe, width, height, dev)
    _overrides_torch.emit(record, dev, smoke)


if __name__ == "__main__":
    main()
