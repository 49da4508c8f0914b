"""Quickstart of the PyTorch/CUDA port: every major capability in one run.

The counterpart of ``examples/quickstart.py`` through
``mega_nerf_viewer_tpu_torch``, the same seven steps.  Run from the repo
root:

    python examples/quickstart_torch.py [outdir] [--device cpu]

It renders on the CUDA card unless ``--device cpu`` is given, and writes
PNGs (default ``build/quickstart/`` of the checkout) demonstrating static
rendering, depth mode, the octree grid overlay, dynamic MLP-driven
refinement, guided ray sampling, a mesh overlay and an orbited view, then a
session checkpoint.
"""

import argparse
import os
import sys
from types import SimpleNamespace

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np
import torch

from mega_nerf_viewer_tpu_torch import Camera, RenderOptions, Viewer
from mega_nerf_viewer_tpu_torch.device import resolve_device
from mega_nerf_viewer_tpu_torch.models import MegaNeRFModel
from mega_nerf_viewer_tpu_torch.n3tree import sphere_tree
from mega_nerf_viewer_tpu_torch.ops.render import to_rgba8
from mega_nerf_viewer_tpu_torch.utils.mesh import Mesh
from mega_nerf_viewer_tpu_torch.utils.png import write_png

STEPS = ("static", "depth", "grid", "refined", "guided", "mesh_overlay",
         "orbited")


def save(img, path):
    ok = write_png(path, to_rgba8(torch.as_tensor(img)).numpy())
    if not ok:
        raise RuntimeError(f"could not write {path}")
    print(f"wrote {path}")


def main(outdir=None, device=None, width=400, height=400):
    """The seven steps on ``device`` (``None``: the card) at ``width`` x
    ``height`` (the focal length scales with the width).  Returns the
    frames by step name, the PNG paths and the capacity before and after
    the refinement step."""
    device = resolve_device(device)
    outdir = outdir or os.path.join(REPO, "build", "quickstart")
    os.makedirs(outdir, exist_ok=True)
    frames, paths = {}, {}

    def shot(name, img):
        frames[name] = np.asarray(img)
        paths[name] = os.path.join(outdir, f"{name}.png")
        save(img, paths[name])

    # a synthetic PlenOctree (or N3Tree.open("tree.npz", device=...))
    tree = sphere_tree(basis_dim=9, depth=5, max_capacity=20000,
                       device=device)
    cam = Camera(width, height, 420.0 * width / 400)
    cam.center = np.array([-1.6, 0.2, 1.5], np.float32)

    viewer = Viewer(tree, camera=cam,
                    options=RenderOptions(background_brightness=1.0),
                    max_tree_capacity=20000, device=device)

    # 1. static render (leaf-map fast path)
    shot("static", viewer.render())

    # 2. expected-depth visualization
    viewer.options = viewer.options.replace(render_depth=True)
    shot("depth", viewer.render())
    viewer.options = viewer.options.replace(render_depth=False)

    # 3. octree wireframe overlay (GUI 'show grid')
    viewer.options = viewer.options.replace(show_grid=True,
                                            grid_max_depth=3)
    shot("grid", viewer.render())
    viewer.options = viewer.options.replace(show_grid=False)

    # 4. dynamic refinement (GUI key M): needs a Mega-NeRF model; a
    #    synthetic stand-in here, MegaNeRFModel.from_torchscript(path) for
    #    real checkpoints
    viewer.model = MegaNeRFModel.synthetic(
        data_dim=28, n_clusters=4, grid_dim=(2, 2),
        min_position=(-2, -2, -2), max_position=(2, 2, 2), device=device)
    viewer.key_event("m")
    cap0 = int(viewer.tree.capacity)
    img = viewer.render()
    cap1 = int(viewer.tree.capacity)
    print(f"refinement: {cap0} -> {cap1} chunks")
    shot("refined", img)
    viewer.key_event("m")

    # 5. guided ray sampling (GUI key R): the octree places the samples,
    #    the MLP shades them
    viewer.key_event("r")
    shot("guided", viewer.render())
    viewer.key_event("r")

    # 6. overlay meshes: the reference's GL mesh layer, headless; a lit
    #    triangle composited into the volume render by depth
    tri = Mesh(face_size=3)
    c, back = viewer.camera.center, viewer.camera.v_back
    p = c - back * 0.6
    r, u = viewer.camera.v_right * 0.3, viewer.camera.v_up * 0.3
    tri.vert = np.stack([
        np.concatenate([p - r - u, [1, 0.2, 0.2], back]),
        np.concatenate([p + r - u, [1, 0.2, 0.2], back]),
        np.concatenate([p + u, [1, 0.2, 0.2], back])]).astype(np.float32)
    viewer.meshes.append(tri)
    shot("mesh_overlay", viewer.render())
    viewer.meshes.clear()

    # 7. orbit the camera and save a session checkpoint
    viewer.mouse_button("right", True, 0, 0)
    viewer.cursor(60.0, 10.0)
    viewer.mouse_button("right", False, 60.0, 10.0)
    shot("orbited", viewer.render())
    state = os.path.join(outdir, "session.json")
    viewer.save_state(state,
                      tree_path=os.path.join(outdir, "session_tree.npz"))
    print(f"session checkpoint -> {state}")
    return SimpleNamespace(frames=frames, paths=paths, state=state,
                           capacity=(cap0, cap1))


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("outdir", nargs="?", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args()
    main(args.outdir, args.device)
