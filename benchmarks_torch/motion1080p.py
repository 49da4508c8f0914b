"""``benchmarks/motion1080p.py`` through the port: the 1080p moving camera
through the Viewer on one CUDA card.

Every pose moves the camera, so the Viewer pays what it takes to stay fast
under motion: stale-order marches, budget escalation, the overflow checks
of its policy, re-hint frames and order rebuilds (kernels A and B, and A's
gated launch, the device fallback, under the ``device`` policy).  The
scene is JAX's: ``shell_tree(depth, basis_dim=9, sigma_inside=400)`` at
1920x1080, f = 1111, ``fast_chunk_size`` 2176.

The protocol is JAX's: 4 warm orbit steps, a rewind to the start pose and
one settled parked frame there; then ``n_poses`` orbit steps of ``deg``
degrees under the policy given, each frame left on the card
(``Viewer.render(fetch=False)``) and its sum added to a device checksum
read once at the end.  ``hint_rebuilds`` counts the calls, inside the
timed run, of ``order_from_hints``, ``order_from_hints_device``,
``order_from_packed_device`` and ``render_frame_motion``, patched on the
port's ``ops.accel`` module, where the Viewer looks them up.

Usage: python benchmarks_torch/motion1080p.py [n_poses] [deg_per_pose]
           [depth] [policy]
Prints ONE JSON line with JAX's keys: ``metric`` ``motion_1080p_fps``,
``value``, ``unit``, ``poses``, ``deg_per_pose``, ``policy``,
``motion_mode``, ``hint_rebuilds``, ``rays_per_sec``.  Environment:
``_overrides_torch``.  On stderr: the card and its power limit, and the
kernel launches of the run.
"""

import contextlib
import os
import sys
import time
from types import SimpleNamespace
from unittest import mock

sys.path[:0] = [os.path.dirname(os.path.abspath(__file__)),
                os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]

import _overrides_torch
from _overrides_torch import orbit_step

COUNTED = ("order_from_hints", "order_from_hints_device",
           "order_from_packed_device", "render_frame_motion")


def run(n_poses=24, deg=3.0, depth=8, policy="async", width=1920,
        height=1080, device=None):
    """The protocol on ``device`` (``None``: the card).  Returns (record
    without ``smoke``, namespace of the Viewer and the checksum)."""
    import torch
    import mega_nerf_viewer_tpu_torch as P
    from mega_nerf_viewer_tpu_torch.device import resolve_device
    from mega_nerf_viewer_tpu_torch.ops import accel
    dev = resolve_device(device)
    tree = P.shell_tree(depth=depth, basis_dim=9, sigma_inside=400.0,
                        device=dev)
    cam = _overrides_torch.camera(width, height, 1111.0)
    v = P.Viewer(tree, camera=cam, options=P.RenderOptions(), device=dev)
    v.fast_chunk_size = 2176
    v.overflow_policy = policy

    # warm every path the loop reaches, then rewind to the start pose and
    # settle one parked frame there
    pose0 = (cam.center.copy(), cam.v_back.copy())
    v.render(fetch=False)
    for _ in range(4):
        orbit_step(v, deg, width)
        v.render(fetch=False)
    v.camera.center, v.camera.v_back = pose0[0].copy(), pose0[1].copy()
    v.camera._update()
    v.render(fetch=False)

    with contextlib.ExitStack() as stack:
        spies = [stack.enter_context(mock.patch.object(
            accel, n, wraps=getattr(accel, n))) for n in COUNTED]
        t0 = time.perf_counter()
        acc = torch.zeros((), device=dev)
        for _ in range(n_poses):
            orbit_step(v, deg, width)
            acc = acc + v.render(fetch=False).sum()
        float(acc)                       # force the whole chain
        dt = time.perf_counter() - t0
    rebuilds = sum(spy.call_count for spy in spies)

    fps = n_poses / dt
    record = {
        "metric": "motion_1080p_fps",
        "value": round(fps, 3),
        "unit": "fps",
        "poses": n_poses,
        "deg_per_pose": deg,
        "policy": policy,
        "motion_mode": v.motion_mode,
        "hint_rebuilds": rebuilds,
        "rays_per_sec": round(fps * width * height, 0),
    }
    return record, SimpleNamespace(viewer=v, checksum=float(acc))


def main():
    n_poses = int(sys.argv[1]) if len(sys.argv) > 1 else 24
    deg = float(sys.argv[2]) if len(sys.argv) > 2 else 3.0
    depth = int(sys.argv[3]) if len(sys.argv) > 3 else 8
    width, height, depth, smoke, dev = _overrides_torch.apply(1920, 1080,
                                                              depth)
    policy = sys.argv[4] if len(sys.argv) > 4 else "async"
    record, _ = run(n_poses, deg, depth, policy, width, height, dev)
    _overrides_torch.emit(record, dev, smoke)
    print(f"# motion loop through the Viewer: stale-order marches, budget "
          f"escalation, {policy} overflow checks and "
          f"{record['hint_rebuilds']} hint rebuild(s) inside the timed run",
          file=sys.stderr)


if __name__ == "__main__":
    main()
