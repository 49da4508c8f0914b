"""PyTorch/CUDA port of ``mega_nerf_viewer_tpu`` (the JAX package).

The port goes slice by slice.  The first slice is the steady leaf-map
voxel frame: load or build the octree, build the leaf map and the
entry-skip table, render a hint frame in pixel-block order, sort the rays
by its hints, and render the record-sorted segmented frame.  The second
is guided sampling through the Mega-NeRF MLPs: the collect march, the
compact reconstruction and grouped MLP query, and the per-frame compact
compositor.  Their hot loops are hand-written CUDA kernels for Hopper
(``csrc/``): the entry-skip prepass, the fused march, the collect march
and the compact compositor.  Entry points run on the CUDA card unless
they are given ``device="cpu"``, where the kernels' plain PyTorch
versions run instead.
"""

from .camera import Camera
from .models import MegaNeRFModel
from .options import RenderOptions
from .n3tree import N3Tree, shell_tree, sphere_tree, tree_from_numpy
from .ops.accel import (DEFAULT_SEGMENTS, LeafMap, build_leaf_map,
                        order_from_hints, render_frame_fast,
                        render_frame_fast_segmented, render_rays_fast)
from .ops.guided import (collect_and_query_fast, composite_frame,
                         segments_from_ns_hints)
from .ops.skip_prepass import build_skip_table, entry_skip_prepass
from .utils.tuning import device_tuning

__all__ = [
    "Camera", "RenderOptions", "N3Tree", "shell_tree", "sphere_tree",
    "tree_from_numpy", "DEFAULT_SEGMENTS", "LeafMap", "build_leaf_map",
    "order_from_hints", "render_frame_fast", "render_frame_fast_segmented",
    "render_rays_fast", "build_skip_table", "entry_skip_prepass",
    "device_tuning", "MegaNeRFModel", "collect_and_query_fast",
    "composite_frame", "segments_from_ns_hints",
]
