"""Multi-device frames over ``torch.distributed``.

Counterpart of ``mega_nerf_viewer_tpu/parallel``: the JAX package's
``shard_map`` programs become one process per device, a :class:`Mesh` of
ranks over a ``DeviceMesh``, and explicit collectives (``parallel.mesh``).
"""

from .mesh import MODEL_AXIS, RAY_AXIS, Mesh, default_mesh, make_mesh
from .render import (deal_chunks_balanced, render_frame_fast_segmented_sharded,
                     render_frame_fast_sharded, render_frame_sharded,
                     render_rays_fast_sharded, render_rays_sharded)
from .model import mlp_forward_all_tp, mlp_forward_tp, tp_param_specs
from .step import make_frame_refine_step
from .guided import guided_frame_sharded
from .motion import motion_episode_layout, render_frame_motion_sharded
from . import multihost

__all__ = [
    "make_mesh", "default_mesh", "RAY_AXIS", "MODEL_AXIS",
    "render_frame_sharded", "render_rays_sharded",
    "render_frame_fast_sharded", "render_rays_fast_sharded",
    "render_frame_fast_segmented_sharded",
    "tp_param_specs", "mlp_forward_tp", "mlp_forward_all_tp",
    "make_frame_refine_step", "guided_frame_sharded",
    "motion_episode_layout", "render_frame_motion_sharded",
    "multihost",
]
