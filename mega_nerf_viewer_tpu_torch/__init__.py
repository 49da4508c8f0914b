"""PyTorch/CUDA port of ``mega_nerf_viewer_tpu`` (the JAX package).

The port goes slice by slice.  The first slice is the steady leaf-map
voxel frame: load or build the octree, build the leaf map and the
entry-skip table, render a hint frame in pixel-block order, sort the rays
by its hints, and render the record-sorted segmented frame.  The second
is guided sampling through the Mega-NeRF MLPs: the collect march, the
compact reconstruction and grouped MLP query, and the per-frame compact
compositor.  Their hot loops are hand-written CUDA kernels for Hopper
(``csrc/``): the entry-skip prepass, the fused march, the collect march
and the compact compositor.  The third is dynamic octree refinement: the
exact renderer with votes and visit marks, vote frames on the fast path,
split, resample and prune (``ops/refine.py``), and guided sampling with
splitting through the exact collect and the padded compositor, with depth
mode; its kernels are the exact march, the exact collect and the padded
compositor, and the fused march gained votes and depth.  The fourth is the
user-facing path: the :class:`Viewer` session (``viewer.py``), the headless
``api`` and the ``cli``, with depth mode in the compact compositor and the
row-gather probe (``probes/gather_probe.py``).  Entry points run
on the CUDA card unless they are given ``device="cpu"``, where the
kernels' plain PyTorch versions run instead.
"""

from .camera import Camera
from .models import MegaNeRFModel
from .options import RenderOptions
from .n3tree import N3Tree, shell_tree, sphere_tree, tree_from_numpy
from .ops.accel import (DEFAULT_SEGMENTS, LeafMap, build_leaf_map,
                        order_from_hints, render_frame_fast,
                        render_frame_fast_segmented, render_rays_fast)
from .ops.guided import (GuidedSamples, collect_and_query,
                         collect_and_query_fast, collect_samples,
                         composite_frame, composite_results,
                         segments_from_ns_hints)
from .ops.refine import (expand_voxels, expand_voxels_jit, get_more_samples,
                         prune_tree)
from .ops.render import (RenderResult, fresh_visit_tracker, render_frame,
                         render_rays)
from .ops.skip_prepass import build_skip_table, entry_skip_prepass
from .utils.tuning import device_tuning
from .viewer import Viewer

__all__ = [
    "Camera", "RenderOptions", "N3Tree", "shell_tree", "sphere_tree",
    "tree_from_numpy", "DEFAULT_SEGMENTS", "LeafMap", "build_leaf_map",
    "order_from_hints", "render_frame_fast", "render_frame_fast_segmented",
    "render_rays_fast", "build_skip_table", "entry_skip_prepass",
    "device_tuning", "MegaNeRFModel", "collect_and_query_fast",
    "composite_frame", "segments_from_ns_hints", "GuidedSamples",
    "collect_and_query", "collect_samples", "composite_results",
    "expand_voxels", "expand_voxels_jit", "get_more_samples", "prune_tree",
    "RenderResult", "fresh_visit_tracker", "render_frame", "render_rays",
    "Viewer",
]
