"""Multi-host rendering example of the PyTorch/CUDA port: two processes, one
group of ranks, every rank receives the whole frame.

The counterpart of ``examples/multihost_render.py`` through
``mega_nerf_viewer_tpu_torch.parallel.multihost``.  Run one copy per rank
(here two local processes), from the repo root:

    python examples/multihost_render_torch.py 0 &
    python examples/multihost_render_torch.py 1

Process 0 builds the octree (a real run loads it); ``broadcast`` ships it
to every rank once at startup, ``replicate`` puts it on each rank's device,
and every rank renders the same frame with the rays split over the ranks
and receives the full image.  Rank r renders on card ``r % device_count``:
with a card per rank the ranks talk over NCCL; where ranks share a card
the example asks for gloo, since NCCL refuses two ranks on one device.
``--device cpu`` runs both ranks on the CPU under gloo.  Each rank saves
its frame as ``frame_rank<r>.npy`` and rank 0 a PNG, in ``--outdir``
(default ``build/multihost/`` of the checkout).
"""

import argparse
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np
import torch

NUM_PROCESSES = 2
CENTER = (-1.5, 0.1, 1.4)


def rank_setup(pid, device=None):
    """This rank's device and backend: ``device`` if given, else card
    ``pid % device_count``; gloo on the CPU or where ranks share a card,
    NCCL with a card per rank."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass --device "
                               "cpu to render on the CPU")
        n = torch.cuda.device_count()
        device = f"cuda:{pid % n}"
        shared = NUM_PROCESSES > n
    else:
        shared = False
    cuda = torch.device(device).type == "cuda"
    return device, "nccl" if cuda and not shared else "gloo"


def frame_setup():
    """The example's camera and options (320x240, f = 300)."""
    from mega_nerf_viewer_tpu_torch import Camera, RenderOptions
    cam = Camera(320, 240, 300.0)
    cam.center = np.array(CENTER, np.float32)
    cam._update()
    return cam, RenderOptions()


def main(pid, port=29765, device=None, outdir=None):
    """Rank ``pid``; returns its frame on the host."""
    import torch.distributed as dist
    from mega_nerf_viewer_tpu_torch.n3tree import sphere_tree
    from mega_nerf_viewer_tpu_torch.ops import accel
    from mega_nerf_viewer_tpu_torch.parallel import multihost
    device, backend = rank_setup(pid, device)
    if torch.device(device).type == "cpu":
        # the ranks share one host's cores: more threads than cores slow
        # every rank's CPU march by orders of magnitude
        torch.set_num_threads(max(1, (os.cpu_count() or 1)
                                  // NUM_PROCESSES))
    dev = multihost.initialize(f"127.0.0.1:{port}",
                               num_processes=NUM_PROCESSES, process_id=pid,
                               backend=backend, device=device)
    print(f"[{pid}] {dist.get_world_size()} processes, {backend} on {dev}")

    # process 0 owns the data; every other rank receives it
    tree = sphere_tree(basis_dim=4, depth=4, device=dev) if pid == 0 else \
        sphere_tree(basis_dim=4, depth=4, sigma_inside=0.0, device=dev)
    tree = multihost.broadcast(tree)
    lm = accel.build_leaf_map(tree)
    # lift ONCE onto the mesh's devices; reuse for every frame
    tree_g = multihost.replicate(tree)
    lm_g = multihost.replicate(lm)

    cam, opt = frame_setup()
    img, overflow = multihost.render_frame_fast_sharded_multihost(
        tree_g, lm_g, cam, opt, max_dense=32)
    img = img.cpu().numpy()
    print(f"[{pid}] frame {img.shape}, alpha max {img[..., 3].max():.3f}, "
          f"overflow {int(overflow)}")
    outdir = outdir or os.path.join(REPO, "build", "multihost")
    os.makedirs(outdir, exist_ok=True)
    np.save(os.path.join(outdir, f"frame_rank{pid}.npy"), img)
    if pid == 0:
        from mega_nerf_viewer_tpu_torch.ops.render import to_rgba8
        from mega_nerf_viewer_tpu_torch.utils.png import write_png
        out = os.path.join(outdir, "multihost_frame.png")
        write_png(out, to_rgba8(torch.as_tensor(img)).numpy())
        print(f"[0] wrote {out}")
    dist.destroy_process_group()
    return img


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("pid", nargs="?", type=int, default=0)
    ap.add_argument("--port", type=int, default=29765,
                    help="the coordinator's port on 127.0.0.1")
    ap.add_argument("--device", default=None,
                    help="torch device of this rank (default: its card)")
    ap.add_argument("--outdir", default=None)
    args = ap.parse_args()
    main(args.pid, args.port, args.device, args.outdir)
