"""Ray generation, SH, the leaf-map march and the entry-skip prepass.

The imports and ``__all__`` are those of ``mega_nerf_viewer_tpu/ops``."""

from . import accel, guided, oracle, refine
from .sh import eval_sh_basis, masked_sh_basis, SUPPORTED_BASIS_DIMS
from .rays import screen2worlddir, rodrigues
from .render import (render_rays, render_frame, composite_background,
                     to_rgba8, RenderResult)
from .accel import (build_leaf_map, build_turbo_leaf_map, render_rays_fast,
                    render_frame_fast, render_frame_fast_segmented,
                    order_from_steps, order_from_hints, LeafMap,
                    FastRenderResult, DEFAULT_SEGMENTS)

__all__ = [
    "accel", "guided", "oracle", "refine",
    "eval_sh_basis", "masked_sh_basis", "SUPPORTED_BASIS_DIMS",
    "screen2worlddir", "rodrigues",
    "render_rays", "render_frame", "composite_background", "to_rgba8",
    "RenderResult",
    "build_leaf_map", "build_turbo_leaf_map", "render_rays_fast",
    "render_frame_fast", "render_frame_fast_segmented",
    "order_from_steps", "order_from_hints", "LeafMap",
    "FastRenderResult", "DEFAULT_SEGMENTS",
]
