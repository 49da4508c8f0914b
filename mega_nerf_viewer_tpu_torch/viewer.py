"""Stateful headless viewer (counterpart of ``mega_nerf_viewer_tpu/viewer.py``).

Replaces the reference's interactive loop (``main.cpp:603-616`` +
``VolumeRenderer::Impl::render``, ``src/renderer/cuda_renderer.cpp:68-163``)
with a headless frame-step loop that reproduces:

  * per-frame camera change detection and visit-tracking gating
    (``cuda_renderer.cpp:99-105``),
  * dynamic splitting / resampling cadence with drag suppression
    (``cuda_renderer.cpp:145-147``),
  * capacity-pressure pruning (``cuda_renderer.cpp:149-154``),
  * guided-sampling result caching keyed on camera state
    (``can_reuse_results``, ``cuda_renderer.cpp:103-139``),
  * M/R-toggle equivalents via ``RenderOptions`` mutation.

Every frame runs through the port's kernels (the prepass, the fused march,
the collect march, the compositors, the exact march and collect).  The
frame protocol is the JAX package's, under its three overflow policies
(``overflow_policy``): the record-sorted segmented frame on a ray order
from the previous frame's packed hints, and, when a segment overflowed,

  * ``"sync"``: a redo before the frame returns, which re-marches the
    overflowed segments of the queued frame in place at budget 128 and
    takes the next order and budgets from its exact hints
    (``accel.repair_segments``), with the hint frame as its fallback;
  * ``"async"``: the frame returns as it is, and the next frame reads the
    flags and escalates (a moving frame may show a truncated band of up to
    ``motion_overflow_tolerance`` of its rays);
  * ``"device"``: the frame re-marches its overflowed segments at budget
    128 by one gated launch of the march a segment, each reading its
    segment's flag on the card (``accel.render_frame_fast_segmented``'s
    ``device_fallback``), and the next frame reads the flags to retune the
    budgets.

Under the async and device policies the flags cross to the host in a copy
issued right after the frame's march, into pinned memory, with an event
that the next frame waits on, and nothing else.  The hint frame with its
``max_dense`` escalation loop runs when there is no order, and the exact
renderer when even budget 128 overflows.  Under camera motion the order is
rebuilt on the device from the hints max-dilated by the estimated
silhouette sweep, or, under the async policy with ``motion_mode``
``"rehint"`` (the default), measured by the re-hint motion frame
(``accel.render_frame_motion``).  ``use_turbo_map`` renders on the turbo
leaf map where it is valid.

``foveation`` > 1 is an approximate mode, off by default: the periphery
renders at 1/``foveation`` resolution and is upscaled, a centre window at
full resolution (two sub-Viewers that share the tree, leaf map and skip
table).  ``show_grid`` and ``meshes`` draw the octree wireframe and mesh
overlays on the host (``utils/wireframe.py``, ``utils/mesh.py``) and
composite the frame against them through the exact renderer, the overlay
depth bounding each ray's march.

The JAX Viewer's execution switches (``viewer.py:101-197``) route frames
the same way here, with the same defaults:

  * ``use_fast_path`` (True): off, every frame of a binary tree takes the
    exact renderer (kernel E) and every guided invalidation the exact
    collect (kernel F), and foveation is off.
  * ``use_prepass`` (True): off, the leaf-map frames march kernel A from
    ``tmin`` and kernel B is not launched; the pixels are the same, and
    the hints' skip counts are 0.
  * ``use_device_order`` (True): off, the hint frame's ray order is sorted
    on the host from hints fetched there (``accel.order_from_hints``) and
    uploaded; a moved camera keeps the stale order and budgets (no
    re-hint frame, no dilated rebuild, no packed hints, no CDF budgets, no
    clean-streak re-derivation) until a segment overflows.
  * ``use_guided_segments`` (True): off, the leaf-map guided collect runs
    in one ordered launch of kernel C, with no per-class budgets.
  * ``use_dynamic_knobs`` (True) is accepted and changes nothing: in JAX it
    spares a recompile, and nothing here is compiled per knob value.
  * ``use_pallas_composite`` (None) is accepted and changes no pixel: in
    JAX it picks between a Pallas and an XLA compositor, and here each
    cache layout has one compositor, kernel D or G.  It keys the guided
    image cache, as in JAX.
"""

from __future__ import annotations

import dataclasses
import json
import logging
from typing import Optional

import numpy as np
import torch

from .camera import Camera
from .device import host_tensor, resolve_device
from .n3tree import N3Tree
from .options import RenderOptions
from .ops import accel, guided, refine
from .ops.rays import rodrigues, screen2worlddir
from .ops.render import (RenderResult, composite_background,
                         fresh_visit_tracker, render_frame, render_rays,
                         to_rgba8)
from .ops.skip_prepass import build_skip_table
from .utils import profiling
from .utils.metrics import FpsCounter
from .utils.png import write_png
from .utils.tuning import device_tuning
from .utils.wireframe import grid_overlay

_log = logging.getLogger(__name__)

OVERFLOW_POLICIES = ("sync", "async", "device")
MOTION_MODES = ("rehint", "dilate")


class _Deferred:
    """A device tensor on its way to the host: a non-blocking copy into
    pinned memory and the event after it.  :func:`_host_array` waits on
    that event only, not on the frame's later work."""

    def __init__(self, host: torch.Tensor, event):
        self.host = host
        self.event = event


def _to_host_later(tensors: dict) -> dict:
    """Start the copies of one frame's flag ``tensors`` to the host, behind
    one event; CPU tensors are kept as they are."""
    if not any(t.device.type == "cuda" for t in tensors.values()):
        return dict(tensors)
    host = {}
    for k, t in tensors.items():
        host[k] = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host[k].copy_(t, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return {k: _Deferred(h, event) for k, h in host.items()}


def _host_array(x) -> np.ndarray:
    """A numpy array from a deferred copy (waiting on its event), a tensor
    or anything numpy takes."""
    if isinstance(x, _Deferred):
        x.event.synchronize()
        return x.host.numpy()
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)


def _fov_compose(imgp: torch.Tensor, imgc: torch.Tensor, *, f: int, y0: int,
                 x0: int, height: int, width: int) -> torch.Tensor:
    """The foveated frame on the frames' device (``viewer.py:38-60``): the
    periphery ``imgp`` upscaled by ``f`` (nearest), its last row and
    column repeated when ``height`` or ``width`` is not a multiple of
    ``f``, and the centre window ``imgc`` pasted at (``y0``, ``x0``)."""
    up = imgp.repeat_interleave(f, dim=0).repeat_interleave(f, dim=1)
    ph, pw = height - up.shape[0], width - up.shape[1]
    if ph:
        up = torch.cat([up, up[-1:].expand(ph, -1, -1)], 0)
    if pw:
        up = torch.cat([up, up[:, -1:].expand(-1, pw, -1)], 1)
    up = up.contiguous()
    up[y0:y0 + imgc.shape[0], x0:x0 + imgc.shape[1]] = imgc
    return up


def _same_device(a: torch.device, b: torch.device) -> bool:
    if a.type != b.type:
        return False
    return a.index is None or b.index is None or a.index == b.index


class _Backend:
    """``Viewer.get_backend``.  On the class it is JAX's staticmethod
    (``viewer.py:262-265``) and answers the default device: "CUDA" when a
    card is visible, else "CPU".  On a viewer it answers the device that
    viewer renders on.  A descriptor rather than a staticmethod with an
    instance override set in ``__init__``: one name serves both calls, and
    no per-viewer attribute has to follow a viewer's state."""

    def __get__(self, viewer, owner=None):
        if viewer is None:
            return lambda: "CUDA" if torch.cuda.is_available() else "CPU"
        return lambda: viewer.device.type.upper()


class Viewer:
    """The headless viewer session on one device (``device=None``: the
    CUDA card; ``"cpu"`` runs the kernels' plain versions).  A tree on
    another device is refused.  Randomness (the refinement's uniform
    draws) comes from a ``torch.Generator`` seeded with 42, the
    reference's ``torch::manual_seed(42)`` (``main.cpp:522``)."""

    def __init__(self,
                 tree: Optional[N3Tree] = None,
                 camera: Optional[Camera] = None,
                 options: Optional[RenderOptions] = None,
                 max_tree_capacity: Optional[int] = None,
                 model=None,
                 device=None):
        self.device = resolve_device(device)
        self.camera = camera or Camera()
        self.options = options or RenderOptions()
        self.model = model            # models.MegaNeRFModel or None
        self.tree = None
        # honoured by set()/load_state even before a tree is given
        self.max_tree_capacity = max_tree_capacity
        self.fps = FpsCounter()
        # frames rendered: the id the spans of each frame share
        self.frame_id = 0
        # the last frame's path (the ``path`` of its ``viewer.render`` span)
        self._path = None
        self._visit_tracker = None
        # True once a visit-tracked frame has fed the tracker since its
        # last reset: a prune on an unfed tracker would delete every
        # unvisited chunk (the prune gate in render())
        self._visits_valid = False
        self._prune_happened = False
        self._can_reuse_results = False
        self._guided_cache = None
        # monotone generations: tree-derived and guided-image caches key
        # on these, never on id() (ids are reused after collection)
        self._tree_gen = 0
        self._guided_gen = 0
        self._guided_img_cache = None
        # the execution switches (module docstring)
        self.use_fast_path = True
        self.use_dynamic_knobs = True
        self.use_pallas_composite = None
        self.use_prepass = True
        self.use_device_order = True
        self.use_guided_segments = True
        self._leaf_map = None
        self._skip_table = None
        self._skip_thresh = None
        # turbo: the max-empty-cube leaf map (drift within 1e-3), valid for
        # sigma_thresh at or above the threshold it was built for
        self.use_turbo_map = False
        self._leaf_map_turbo_thresh = None
        # the approximate foveated mode (module docstring): the periphery
        # at 1/foveation resolution, a centre window of foveation_center of
        # each axis at full resolution, each a sub-Viewer
        self.foveation = 1
        self.foveation_center = 0.5
        self._fov_sub = None              # (periphery, centre) Viewers
        self._fov_key = None
        self._fov_motion_gated = False    # logged once per episode
        self._fov_subs_stale = False      # the subs missed a pose
        # overlay meshes (utils.mesh.Mesh), drawn with the grid
        self.meshes = []
        self._grid_cache = None
        # how the segmented frame meets stale budgets (module docstring):
        # "sync" redoes the frame, "async" escalates on the next frame,
        # "device" re-marches on the card and retunes on the next frame
        self.overflow_policy = "sync"
        # the last frame's (segments, seg_overflow, fb_overflow, R, moved[,
        # kind]), its flags on their way to the host
        self._pending_ov = None
        self._ov_frame = 0
        self._clean_streak = 0
        # async: the share of a moving frame's rays that may exceed their
        # class budget without escalating
        self.motion_overflow_tolerance = 1.0 / 512.0
        # async: read the flags every this many frames; re-hint poses
        # every motion_flag_interval frames at the least
        self.overflow_check_interval = 1
        self.motion_flag_interval = 4
        # margin of the re-hint budgets settled from measured CDFs
        self.motion_settled_margin = 0
        # how async moved frames regain an order: "rehint" measures it
        # (accel.render_frame_motion), "dilate" predicts it from the
        # previous pose's dilated hints; sync and device always dilate
        self.motion_mode = "rehint"
        self._qperm = None
        self._motion_cdf_dev = None
        self._last_cdf = None
        self._segments_motion = None
        self._segments_motion_src = None
        self._ray_order = None
        self._hints_packed = None
        self._order_stale = False
        self._order_back = None
        self._segments = None
        self._segments_src = None
        # CDF-budget segmented guided collect and its ray order
        self._guided_segments = None
        self._guided_seg_src = None
        self._guided_order = None
        self._guided_back = None
        # initial record budget of the hint frame (escalates on overflow)
        self.fast_max_dense = 8
        self.fast_chunk_size = device_tuning(self.device).chunk_size
        # sorted-frame delivery: parked segmented frames skip the final
        # unpermute and the display consumer applies the inverse order
        self.host_unpermute = False
        self._inv_host = None    # host copy of inv for the current order
        self._inv_src = None     # the inv tensor it was read from
        self._frame_sorted = False
        self._rng = torch.Generator(device=self.device).manual_seed(42)
        if tree is not None:
            self.set(tree, max_tree_capacity)

    # ------------------------------------------------------------------
    get_backend = _Backend()

    def _check_device(self, tree: N3Tree) -> None:
        if not _same_device(tree.device, self.device):
            raise ValueError(f"tree on {tree.device}; this viewer renders "
                             f"on {self.device}")

    def set(self, tree: N3Tree, max_tree_capacity: Optional[int] = None):
        """Install a tree (reference ``Impl::set``, cuda_renderer.cpp:498-516),
        re-padded to ``max_tree_capacity`` when that is larger."""
        self._check_device(tree)
        self.max_tree_capacity = (max_tree_capacity
                                  or self.max_tree_capacity
                                  or tree.max_capacity)
        if tree.max_capacity < self.max_tree_capacity:
            cap = int(tree.capacity)

            def host(t):
                return t[:cap].cpu().numpy()
            tree = N3Tree.from_arrays(
                host(tree.data), host(tree.child), host(tree.parent),
                tree.scale.cpu().numpy(), tree.offset.cpu().numpy(),
                tree.data_format, sample_counts=host(tree.sample_counts),
                max_capacity=self.max_tree_capacity, device=self.device)
        self.tree = tree
        self._tree_gen += 1
        self._leaf_map = None
        self._skip_table = None
        self._visit_tracker = fresh_visit_tracker(tree)
        self._visits_valid = False
        basis_dim = tree.data_format.basis_dim
        self.options = self.options.replace(
            basis_minmax=(0, max(basis_dim - 1, 0)))
        self._can_reuse_results = False
        self._guided_cache = None
        # a new tree shifts the sample-count distribution: re-derive
        self._guided_segments = None
        self._guided_seg_src = None
        # the sub-Viewers' caches and hints belong to the old tree
        self._fov_sub = None
        self._fov_key = None

    def clear(self):
        self.tree = None

    def load_model(self, model_path: str):
        """Load a Mega-NeRF TorchScript container (reference
        ``Impl::load_model``, cuda_renderer.cpp:518-543)."""
        from .models import MegaNeRFModel
        self.model = MegaNeRFModel.from_torchscript(model_path,
                                                    device=self.device)
        self.options = self.options.replace(
            need_viewdir=self.model.need_viewdir)
        if (self.options.appearance_embedding == -1
                and self.model.need_appearance_embedding):
            self.options = self.options.replace(appearance_embedding=0)
        self._can_reuse_results = False
        self._guided_cache = None
        self._fov_sub = None              # the subs cache the old model's
        self._fov_key = None

    def resize(self, width: int, height: int):
        """Resize the virtual framebuffer (reference ``Impl::resize``,
        cuda_renderer.cpp:383-458 — intrinsics rescale with the window)."""
        cam = self.camera
        if cam.width == width and cam.height == height:
            return
        wr = width / cam.width
        hr = height / cam.height
        cam.fx *= wr
        cam.default_fx *= wr
        cam.fy *= hr
        cam.default_fy *= hr
        if cam.default_cx != -1:
            cam.cx *= wr
        else:
            cam.cx = width / 2
        if cam.default_cy != -1:
            cam.cy *= hr
        else:
            cam.cy = height / 2
        cam.width, cam.height = width, height
        self._can_reuse_results = False
        self._guided_cache = None

    # ------------------------------------------------------------------
    def _check_modes(self) -> None:
        """Refuse an unknown overflow policy or motion mode."""
        if self.overflow_policy not in OVERFLOW_POLICIES:
            raise ValueError(f"overflow_policy {self.overflow_policy!r} not "
                             f"in {OVERFLOW_POLICIES}")
        if self.motion_mode not in MOTION_MODES:
            raise ValueError(f"motion_mode {self.motion_mode!r} not in "
                             f"{MOTION_MODES}")

    def render(self, fetch: bool = True):
        """Render one frame, running refinement/prune per the reference's
        frame orchestration (cuda_renderer.cpp:68-163).  Returns [H, W, 4]
        f32 RGBA as a numpy array; ``fetch=False`` returns the device
        tensor without the copy to the host (under ``host_unpermute`` a
        parked frame is then flat [R, 4] rows in ray order: pair it with
        :meth:`frame_index_map`).

        Under a profiler session the frame is the span ``viewer.render``
        with its ``frame_id`` and its ``path``: ``fast`` (the hint frame),
        ``segmented``, ``redo``, ``motion``, ``guided``, ``foveated``,
        ``grid`` or ``exact``."""
        self.frame_id += 1
        profiling.count("frames")
        self._path = None
        with profiling.annotate("viewer.render", frame=self.frame_id) as sp:
            out = self._render(fetch)
            sp.set(path=self._path)
        return out

    def _render(self, fetch: bool):
        cam = self.camera
        opt = self.options
        cam._update()
        self._frame_sorted = False
        if self.tree is None:
            bg = opt.background_brightness
            img = np.full((cam.height, cam.width, 4), bg, np.float32)
            img[..., 3] = 1.0
            self.fps.tick()
            return img
        self._check_modes()

        camera_changed = cam.has_changed()
        if camera_changed:
            self._order_stale = True
        # visit marks only feed the prune, which needs a model: a
        # model-less viewer never pays the visit-tracked exact march
        pressure = (self.max_tree_capacity - int(self.tree.capacity)
                    < opt.split_batch_size)
        track_visit = (self.model is not None
                       and (((camera_changed or not self._visits_valid)
                             and (pressure
                                  or int(self.tree.capacity)
                                  > self.max_tree_capacity * 3 // 4))
                            or self._prune_happened))
        if camera_changed:
            self._can_reuse_results = False

        needs_votes = (opt.use_splitting and not cam.is_dragging()
                       and self.model is not None)
        res = None
        fov_ok = (self.use_fast_path and self.tree.N == 2
                  and not track_visit and not needs_votes
                  and int(self.foveation) > 1 and not opt.render_depth
                  and not opt.show_grid and not self.meshes)
        # a moving guided camera is not foveated (viewer.py:398-421 of the
        # JAX package: the two subs' fixed costs outweigh the rays saved);
        # the subs miss that pose and are refreshed when foveation resumes
        if (fov_ok and opt.use_guided_sampling and self.model is not None
                and camera_changed and not cam.is_dragging()):
            fov_ok = False
            self._fov_subs_stale = True
            if not self._fov_motion_gated:
                self._fov_motion_gated = True
                _log.info("foveation gated off while a guided camera "
                          "moves; it resumes when the camera settles")
        elif not camera_changed:
            self._fov_motion_gated = False
        if fov_ok:
            self._path = "foveated"
            img = self._render_foveated(camera_changed)
        elif opt.use_guided_sampling and not cam.is_dragging() \
                and self.model is not None:
            self._path = "guided"
            img, res = self._render_guided(track_visit)
        elif opt.show_grid or self.meshes:
            self._path = "grid"
            img, res = self._render_with_grid(track_visit)
        elif self.use_fast_path and self.tree.N == 2 and not track_visit:
            # leaf-map path, votes included when refining; each expand
            # drops the map and the next frame rebuilds it
            img, res = self._render_fast(need_votes=needs_votes)
        else:
            self._path = "exact"
            img, res = render_frame(
                self.tree, cam.width, cam.height, cam.fx, cam.fy,
                cam.cx, cam.cy, cam.transform, opt,
                track_visit=track_visit)
        if track_visit and res is not None:
            self._visit_tracker = torch.maximum(self._visit_tracker,
                                                res.visited)
            self._visits_valid = True

        if opt.use_splitting and not cam.is_dragging() \
                and self.model is not None and res is not None:
            self._expand_voxels(res)

        # capacity-pressure prune (cuda_renderer.cpp:149-154), gated on a
        # refinable session and on a fed visit tracker
        if (self.model is not None and self._visits_valid
                and self.max_tree_capacity - int(self.tree.capacity)
                < opt.split_batch_size):
            self._prune()
            self._prune_happened = True
        else:
            self._prune_happened = False

        self.fps.tick()
        if not fetch:
            return img
        with profiling.host_sync("fetch"):
            img = img.cpu().numpy()
        if self._frame_sorted:
            # the display consumer applies the index map the device
            # skipped (bit-identical pixels)
            return img[self._inv_host].reshape(cam.height, cam.width, 4)
        return img

    def frame_index_map(self):
        """Host inverse ray order for the last frame when it was delivered
        sorted (``host_unpermute``), else None:
        ``flat_frame[frame_index_map()].reshape(h, w, 4)`` is the frame."""
        return self._inv_host if self._frame_sorted else None

    def render_rgba8(self) -> np.ndarray:
        """Render one frame as host rgba8 [H, W, 4]: quantized on the
        device so that only the uint8 frame crosses to the host; under
        ``host_unpermute`` the index map is applied here as one u32 numpy
        gather."""
        img = self.render(fetch=False)
        with profiling.host_sync("fetch"):
            rgba = to_rgba8(torch.as_tensor(img)).cpu().numpy()
        if self._frame_sorted:
            cam = self.camera
            flat = np.ascontiguousarray(rgba.reshape(-1, 4))
            rgba = flat.view(np.uint32)[:, 0][self._inv_host] \
                .view(np.uint8).reshape(cam.height, cam.width, 4)
        return rgba

    # ------------------------------------------------------------------
    def _ensure_maps(self, need_votes: bool = False):
        """A valid leaf map and, with ``use_prepass`` on and unless this is
        a vote frame, the skip table for the current ``sigma_thresh``
        (``viewer.py:519-557``).  A turbo map is valid for a
        ``sigma_thresh`` at or above the one it was built for and not for
        vote frames; it is rebuilt when the threshold drops, on vote frames
        and when the switch goes off, and the skip table with it.  Returns
        the skip table or None."""
        opt = self.options
        turbo_thresh = self._leaf_map_turbo_thresh
        if self._leaf_map is not None and turbo_thresh is not None and (
                opt.sigma_thresh < turbo_thresh or need_votes
                or not self.use_turbo_map):
            self._leaf_map = None
        if self._leaf_map is None:
            with profiling.annotate("viewer.leaf_map_build"):
                if self.use_turbo_map and not need_votes:
                    self._leaf_map = accel.build_turbo_leaf_map(
                        self.tree, sigma_thresh=opt.sigma_thresh)
                    self._leaf_map_turbo_thresh = opt.sigma_thresh
                else:
                    self._leaf_map = accel.build_leaf_map(self.tree)
                    self._leaf_map_turbo_thresh = None
            self._skip_table = None
        if self.use_prepass and not need_votes:
            thresh = opt.sigma_thresh
            if self._skip_table is None or self._skip_thresh != thresh:
                self._skip_table = build_skip_table(self.tree, thresh)
                self._skip_thresh = thresh
            return self._skip_table
        return None

    def _render_fast(self, need_votes: bool = False):
        """Leaf-map frame under the overflow policy (``viewer.py:560-795``);
        falls back to the exact renderer when even budget 128 overflows.
        A sync overflow with the device order is repaired in place
        (:meth:`_repair`: the overflowed segments re-marched, the rest of
        the frame kept), and only a repair that still overflows, or a frame
        with no repair, is redone as a hint frame (:meth:`_hint_frame`).
        Returns (img, res), res carrying the votes when asked, else None."""
        # whether this frame renders under a camera move
        frame_moved = bool(self._order_stale)
        policy = self.overflow_policy
        if policy != "sync":
            # the previous frame's flags retune budgets and hints first
            self._check_pending_overflow()
        skip_table = self._ensure_maps(need_votes)
        order = self._ray_order
        w, h = self.camera.width, self.camera.height
        R = w * h
        if order is not None and order[0].shape[0] != R:
            order = None
        hints = self._hints_packed
        if hints is not None and hints.shape[0] != R:
            hints = self._hints_packed = None
        # without the device order a moved camera keeps the stale order and
        # budgets until a segment overflows
        reorder = (self.use_device_order and self._order_stale
                   and order is not None and hints is not None)
        if (reorder and self.motion_mode == "rehint" and not need_votes
                and policy == "async" and w % 2 == 0 and h % 2 == 0):
            # camera moved, re-hint mode: measure this pose's record needs
            # with a quarter-resolution count march (async only: sub-sample
            # features may truncate within the tolerance band)
            return self._render_motion_rehint(hints, skip_table)
        if reorder:
            # camera moved: rebuild the order on the device from the last
            # frame's hints, max-dilated by the estimated sweep; budgets
            # follow the dilated CDF, with one ladder step of headroom
            # except under the async policy, whose tolerance absorbs the
            # rays that outrun the window
            profiling.count("reorders")
            with profiling.annotate("viewer.reorder"):
                window = self._estimate_dilation()
                if window:
                    dh = accel.dilate_packed(hints, width=w, height=h,
                                             window=window)
                    order = self._ray_order = \
                        accel.order_from_packed_device(dh)
                    hroom = policy != "async"
                    src = ("dil", window, hroom)
                    if self._segments_src != src:
                        cdf = accel.hint_class_cdf_packed(dh)
                        with profiling.host_sync("reorder_cdf"):
                            cdf = cdf.cpu().numpy()
                        self._segments = list(accel.segments_from_hint_cdf(
                            cdf, R, headroom=hroom))
                        self._segments_src = src
                else:
                    order = self._ray_order = \
                        accel.order_from_packed_device(hints)
            self._order_stale = False
        overflow = False
        redo = False
        repair = None
        if order is not None:
            self._path = "segmented"
            segments = self._segments or list(accel.DEFAULT_SEGMENTS)
            # sorted delivery only on parked frames: a moved frame's fresh
            # inv would cost a blocking [R] fetch
            use_sorted = (self.host_unpermute and not need_votes
                          and not frame_moved)
            if use_sorted and self._inv_src is not order[1]:
                with profiling.host_sync("inv"):
                    self._inv_host = order[1].cpu().numpy()
                self._inv_src = order[1]
            self._frame_sorted = use_sorted
            # packed hints feed the device order only
            want_hints = self.use_device_order
            # a sync redo repairs the overflowed segments in place, where
            # the packed hints give the next order
            want_repair = policy == "sync" and want_hints
            flags = {}
            out = accel.render_frame_fast_segmented(
                self.tree, self._leaf_map, self.camera, self.options,
                order=order, segments=tuple(segments),
                chunk_size=self.fast_chunk_size, need_votes=need_votes,
                skip_table=skip_table,
                return_hints="packed" if want_hints else False,
                sorted_output=use_sorted,
                device_fallback=policy == "device",
                on_flags=(None if policy == "sync"
                          else lambda f: flags.update(_to_host_later(f))),
                return_repair=want_repair)
            if policy != "sync":
                # the flags are read at the top of the next frame: the
                # device policy's frame is right already, the async one
                # may show a truncated band until then
                self._pending_ov = (list(segments), flags["seg_overflow"],
                                    flags.get("fb_overflow"), R, frame_moved)
                img = out[0]
                if need_votes:
                    split_vote, sample_vote = out[2], out[3]
                if want_hints:
                    self._hints_packed = out[-1]
            else:
                with profiling.host_sync("flags"):
                    ov = out[1].cpu().numpy()
                if want_repair:
                    # the repair is kept only for this frame's redo
                    out, repair = out[:-1], (out[-1] if ov.any() else None)
                if ov.any():
                    # stale budgets: escalate the overflowed segments and
                    # redo this frame (never the exact cliff)
                    profiling.count("overflow_rays", int(ov.sum()))
                    self._segments = self._escalated(segments, ov)
                    redo = True
                    order = None
                else:
                    img = out[0]
                    if need_votes:
                        split_vote, sample_vote = out[2], out[3]
                    if want_hints:
                        self._hints_packed = out[-1]
                    self._segments = segments
        if order is None:
            # no order yet (first frame at this resolution), or a redo: the
            # overflowed segments repaired in place, else one budget for
            # the whole frame, escalated until it fits
            self._path = "redo" if redo else "fast"
            if redo:
                profiling.count("redos")
            with profiling.annotate("viewer.redo" if redo
                                    else "viewer.hint_frame"):
                out = None if repair is None else self._repair(repair, ov, R)
                repair = None
                if out is not None:
                    votes = out[2:4]
                else:
                    if redo:
                        profiling.count("redo_fallbacks")
                    out, overflow = self._hint_frame(need_votes, skip_table,
                                                     R)
                    votes = out[3:5]
            img = out[0]
            if need_votes:
                split_vote, sample_vote = votes
        if overflow:
            self._path = "exact"
            self._frame_sorted = False       # exact-path fallback
            return render_frame(
                self.tree, w, h, self.camera.fx, self.camera.fy,
                self.camera.cx, self.camera.cy, self.camera.transform,
                self.options)
        if need_votes:
            return img, RenderResult(out=None, split_vote=split_vote,
                                     sample_vote=sample_vote, visited=None)
        return img, None

    @staticmethod
    def _escalated(segments, ov) -> list:
        """``segments`` with the budget of each overflowed one (``ov``,
        the host's flags) doubled, to 128 at most."""
        esc = [bool(ov[min(i, len(ov) - 1)]) for i in range(len(segments))]
        profiling.count("escalated_segments", sum(esc))
        return [(f, min(max(1, md * 2), 128) if e else md)
                for (f, md), e in zip(segments, esc)]

    def _repair(self, repair, ov, R: int):
        """The sync redo in place: the overflowed segments (``ov``, the
        host's flags) of the frame behind ``repair`` re-marched at budget
        128 (``accel.repair_segments``), and the next frames' order, hints
        and budgets from its exact hints, as :meth:`_hint_frame` leaves
        them; ``fast_max_dense`` doubles as the hint frame's loop would
        have.  Returns the frame in ``render_frame_fast_segmented``'s
        layout, or None (nothing set) when a ray needs more than 128
        records."""
        out, hints, n_ov = accel.repair_segments(repair, ov)
        cdf = accel.hint_class_cdf_packed(hints)
        with profiling.host_sync("hint_cdf"):
            read = torch.cat([cdf, n_ov.reshape(1)]).cpu().numpy()
        if read[-1]:
            return None
        self._frame_sorted = False
        self._take_hints(hints, read[:-1], R)
        self._order_stale = False
        # the hint frame's loop doubles its budget until the hint max fits
        while self.fast_max_dense < min(int(self._last_cdf[-1]), 128):
            self.fast_max_dense *= 2
            profiling.count("budget_doublings")
        return out

    def _take_hints(self, ph, cdf, R: int):
        """The next frames' device order and hints from a frame's exact
        packed hints ``ph``, and budgets matched to their class CDF
        ``cdf`` (on the host): a parked camera's steady state."""
        self._ray_order = accel.order_from_packed_device(ph)
        self._hints_packed = ph
        self._last_cdf = cdf
        self._segments = list(accel.segments_from_hint_cdf(cdf, R))
        self._segments_src = ("steady",)
        self._segments_motion = None         # re-derived per episode
        self._order_back = np.asarray(
            self.camera.transform, np.float32)[:3, :].copy()

    def _hint_frame(self, need_votes: bool, skip_table, R: int):
        """The frame at one budget for all rays, doubled from
        ``fast_max_dense`` until nothing overflows (or 128 does), and the
        next frames' order, hints and budgets from its hints.  Returns
        (``render_frame_fast``'s tuple, whether budget 128 overflowed)."""
        self._frame_sorted = False
        md = self.fast_max_dense
        while True:
            out = accel.render_frame_fast(
                self.tree, self._leaf_map, self.camera, self.options,
                max_dense=md, chunk_size=self.fast_chunk_size,
                need_votes=need_votes, return_nrec=True,
                skip_table=skip_table, return_skips=True)
            with profiling.host_sync("hint_overflow"):
                n_ov = int(out[1])
            profiling.count("overflow_rays", n_ov)
            if not n_ov or md >= 128:
                break
            md *= 2
            profiling.count("budget_doublings")
            self.fast_max_dense = md
        steps, nrec, skips = out[2], out[-2], out[-1]
        if self.use_device_order:
            ph = accel.pack_hints(steps, nrec, skips)
            cdf = accel.hint_class_cdf(nrec)
            with profiling.host_sync("hint_cdf"):
                cdf = cdf.cpu().numpy()
            self._take_hints(ph, cdf, R)
        else:
            # the host path (viewer.py:779-780): the hints fetched, the
            # order sorted on the host and uploaded
            with profiling.host_sync("host_hints"):
                hints = (steps.cpu(), nrec.cpu(), skips.cpu())
            order = accel.order_from_hints(*hints)
            self._ray_order = tuple(o.to(self.device) for o in order)
        self._order_stale = False
        return out, bool(n_ov)

    def _render_foveated(self, camera_changed: bool) -> torch.Tensor:
        """The approximate foveated frame (``viewer.py:797-896``): the
        periphery at 1/``foveation`` resolution and a centre window at full
        resolution, each through a sub-Viewer's fast (or guided) frame, then
        composed on the device.  A pinhole crop only shifts cx and cy, so
        the centre window's rays are the full frame's.  The subs share the
        tree, the leaf map and the skip table by reference; their orders,
        budgets and overflow state settle at their own resolutions."""
        cam = self.camera
        opt = self.options
        f = int(self.foveation)
        W, H = cam.width, cam.height
        q = 2 * f
        w1 = max(q, int(W * self.foveation_center) // q * q)
        h1 = max(q, int(H * self.foveation_center) // q * q)
        x0, y0 = (W - w1) // 2, (H - h1) // 2
        sizes = ((W // f, H // f), (w1, h1))
        key = (W, H, f, w1, h1)
        if self._fov_key != key or self._fov_sub is None:
            self._fov_sub = tuple(
                Viewer(camera=Camera(w, h, 1.0), options=opt,
                       device=self.device) for w, h in sizes)
            self._fov_key = key
        # the parent's knobs govern the subs, every frame
        for v, (w, h) in zip(self._fov_sub, sizes):
            v.use_prepass = self.use_prepass
            v.use_dynamic_knobs = self.use_dynamic_knobs
            v.use_pallas_composite = self.use_pallas_composite
            v.overflow_policy = self.overflow_policy
            v.overflow_check_interval = self.overflow_check_interval
            v.use_turbo_map = self.use_turbo_map
            v.fast_chunk_size = min(self.fast_chunk_size,
                                    max(256, (w * h) // 16))
        self._ensure_maps(False)
        intr = ((cam.fx / f, cam.fy / f, cam.cx / f, cam.cy / f),
                (cam.fx, cam.fy, cam.cx - x0, cam.cy - y0))
        guided_ok = (opt.use_guided_sampling and self.model is not None
                     and not cam.is_dragging())
        # whatever dropped the parent's guided cache (a camera move, an
        # edit of the tree, a resize) or a pose the subs missed drops the
        # subs' caches too
        subs_stale = self._fov_subs_stale
        if not self._can_reuse_results or subs_stale:
            self._guided_cache = None
            for v in self._fov_sub:
                v._can_reuse_results = False
                v._guided_cache = None
            self._can_reuse_results = True
            self._fov_subs_stale = False
        imgs = []
        for v, (fx, fy, cx, cy) in zip(self._fov_sub, intr):
            v.tree = self.tree
            v._leaf_map = self._leaf_map
            v._leaf_map_turbo_thresh = self._leaf_map_turbo_thresh
            v._skip_table = self._skip_table
            v._skip_thresh = self._skip_thresh
            v.options = opt
            v.model = self.model if guided_ok else None
            sc = v.camera
            sc.fx, sc.fy, sc.cx, sc.cy = fx, fy, cx, cy
            sc.center = cam.center.copy()
            sc.v_back = cam.v_back.copy()
            sc.v_world_up = cam.v_world_up.copy()
            sc._update()
            if camera_changed or subs_stale:
                v._order_stale = True
                v._can_reuse_results = False
            if guided_ok:
                img, _ = v._render_guided(False)
            else:
                img, _ = v._render_fast(need_votes=False)
            imgs.append(img)
        return _fov_compose(imgs[0], imgs[1], f=f, y0=y0, x0=x0, height=H,
                            width=W)

    def _render_with_grid(self, track_visit: bool):
        """The frame with the octree wireframe and mesh overlays
        (``viewer.py:1129-1174``): the overlay, drawn on the host and cached
        per tree generation, grid depth and camera, bounds each ray's exact
        march by its depth (``tmax_bg``, ``renderer_kernel.cu:277-280``),
        and line and mesh pixels composite against their colour
        (``composite_and_write``, ``renderer_kernel.cu:215-241``)."""
        cam = self.camera
        opt = self.options
        if opt.show_grid:
            key = (opt.grid_max_depth, self._tree_gen,
                   cam.transform.tobytes(), cam.fx, cam.fy,
                   cam.cx, cam.cy, cam.width, cam.height)
            if self._grid_cache is None or self._grid_cache[0] != key:
                with profiling.annotate("viewer.gen_wire"):
                    overlay = grid_overlay(self.tree, cam,
                                           opt.grid_max_depth)
                self._grid_cache = (key,) + overlay
            _, overlay_rgb, overlay_depth = self._grid_cache
        else:
            overlay_rgb = np.zeros((cam.height, cam.width, 3), np.float32)
            overlay_depth = np.full((cam.height, cam.width), 1e9,
                                    np.float32)
        if self.meshes:
            # the mesh layer meets the grid by depth, as in the reference's
            # shared framebuffer (mesh.cpp:135-166)
            overlay_rgb = overlay_rgb.copy()
            overlay_depth = overlay_depth.copy()
            for m in self.meshes:
                m.draw(cam, overlay_rgb, overlay_depth)
        dev = self.device
        transform = host_tensor(cam.transform, torch.float32, dev)
        dirs, cen = screen2worlddir(cam.width, cam.height, cam.fx, cam.fy,
                                    cam.cx, cam.cy, transform)
        vdirs = rodrigues(opt.rot_dirs, dirs)
        depth = host_tensor(overlay_depth.reshape(-1), torch.float32, dev)
        res = render_rays(self.tree, dirs, vdirs, cen, opt, tmax_bg=depth,
                          track_visit=track_visit)
        has_line = (depth < 1e9)[:, None]
        bg_rgb = torch.where(
            has_line, host_tensor(overlay_rgb.reshape(-1, 3), torch.float32,
                                  dev),
            float(np.float32(opt.background_brightness)))
        img = composite_background(res.out, opt, bg_rgb=bg_rgb)
        return img.reshape(cam.height, cam.width, 4), res

    def _render_motion_rehint(self, hints, skip_table):
        """One re-hint motion pose (``viewer.py:958-1002``): the quarter
        order carried pose to pose (at an episode's start from the steady
        hints), margin-1 budgets derived once per episode from the last
        known CDF, and the flags and the measured CDF left for the deferred
        check."""
        w, h = self.camera.width, self.camera.height
        R = w * h
        if self._qperm is None or self._qperm.shape[0] * 4 != R:
            self._qperm = accel.quarter_order_from_packed(hints, width=w)
        segments = self._segments_motion
        if segments is None or self._segments_motion_src != ("rehint", R):
            cdf = self._last_cdf
            if cdf is None:
                cdf = accel.hint_class_cdf_packed(hints)
                with profiling.host_sync("rehint_cdf"):
                    cdf = cdf.cpu().numpy()
            segments = list(accel.segments_from_hint_cdf(cdf, R, margin=1))
            self._segments_motion = segments
            self._segments_motion_src = ("rehint", R)
        self._frame_sorted = False
        self._path = "motion"
        profiling.count("rehints")
        flags = {}
        img, _, order, _, qperm = accel.render_frame_motion(
            self.tree, self._leaf_map, self.camera, self.options,
            self._qperm, segments=tuple(segments),
            chunk_size=self.fast_chunk_size, skip_table=skip_table,
            hint_stride=2, on_flags=lambda f: flags.update(
                _to_host_later(f)))
        self._qperm = qperm
        self._ray_order = order
        self._motion_cdf_dev = flags["cdf"]
        self._pending_ov = (list(segments), flags["seg_overflow"], None, R,
                            True, "rehint")
        self._order_stale = False
        return img, None

    def _check_pending_overflow(self):
        """The deferred check (``viewer.py:1004-1127``): the previous
        segmented frame's flags, read now, retune budgets and hints for
        the frames to come.  Under the async policy a moving frame's band
        of up to ``motion_overflow_tolerance`` of its rays is tolerated; a
        parked frame's is not.  A re-hint pose re-derives its budgets from
        its measured CDF; otherwise an overflow escalates the segments and
        drops the order, whose hints were capped."""
        pending = self._pending_ov
        if pending is None:
            return
        kind = pending[5] if len(pending) > 5 else "std"
        if self.overflow_policy == "async":
            interval = int(self.overflow_check_interval)
            if kind == "rehint":
                interval = max(interval, int(self.motion_flag_interval))
            self._ov_frame += 1
            if self._ov_frame % max(1, interval):
                return                    # keep the newest pending flags
        self._pending_ov = None
        segments, seg_ov, _, R, moved = pending[:5]
        with profiling.host_sync("pending_flags"):
            counts = _host_array(seg_ov)
        profiling.count("overflow_rays", int(counts.sum()))
        tol = 0
        if self.overflow_policy == "async" and moved:
            tol = int(R * self.motion_overflow_tolerance)
        ov = counts > tol
        if kind == "rehint":
            if self._motion_cdf_dev is None:
                return
            if ov.any():
                # the order is measured every pose: only the budgets are
                # re-derived, from the last pose's CDF
                with profiling.host_sync("pending_cdf"):
                    cdf = self._last_cdf = _host_array(self._motion_cdf_dev)
                self._segments_motion = list(accel.segments_from_hint_cdf(
                    cdf, R, margin=1))
                self._segments_motion_src = ("rehint", R)
            elif self._segments_motion is not None:
                # a clean check settles the budgets at the settled margin,
                # when that is cheaper than the running tuple
                with profiling.host_sync("pending_cdf"):
                    cdf = self._last_cdf = _host_array(self._motion_cdf_dev)
                cand = list(accel.segments_from_hint_cdf(
                    cdf, R, margin=int(self.motion_settled_margin)))

                def mass(segs):
                    return sum(f * md for f, md in segs)
                if mass(cand) < mass(self._segments_motion):
                    self._segments_motion = cand
                    self._segments_motion_src = ("rehint", R)
            return
        if not ov.any():
            # after a clean streak on a parked camera, budgets come back to
            # the steady CDF of the latest exact hints; a tolerated band is
            # not clean (its hints are capped)
            if counts.sum() == 0:
                self._clean_streak += 1
            else:
                self._clean_streak = 0
            if (self._clean_streak >= 8 and self.use_device_order
                    and not self._order_stale
                    and self._hints_packed is not None
                    and self._segments_src != ("steady",)):
                self._clean_streak = 0
                cdf = accel.hint_class_cdf_packed(self._hints_packed)
                with profiling.host_sync("pending_cdf"):
                    self._last_cdf = cdf.cpu().numpy()
                self._segments = list(accel.segments_from_hint_cdf(
                    self._last_cdf, R))
                self._segments_src = ("steady",)
                self._segments_motion = None
            return
        self._clean_streak = 0
        self._segments = self._escalated(segments, ov)
        self._segments_src = ("esc",)
        # the overflowed frame's hints are capped at the starved budgets:
        # the next frame is a hint frame (and, if even budget 128
        # overflows, the exact renderer)
        self._ray_order = None
        self._hints_packed = None

    def _estimate_dilation(self, attr: str = "_order_back"):
        """Per-axis hint-dilation windows (wy, wx) from the camera's
        rotation since the hints' pose (``viewer.py:898-956``, host numpy):
        0 when no previous pose is known.  The view-direction sweep is
        split onto the previous right/up axes, each keeps 0.3 of the
        other's sweep, and a roll adds its mean tangential sweep; each
        axis takes the smallest ladder window whose reach (window - 1)
        covers it.  ``attr`` names the last-pose attribute (the fast and
        guided paths keep their own)."""
        cam = self.camera
        # transform rows are (right, up, back, center)
        rot = np.asarray(cam.transform, np.float32)[:3, :]
        prev = getattr(self, attr)
        setattr(self, attr, rot.copy())
        if prev is None:
            return 0
        back = rot[2]
        denom = max(abs(float(np.dot(prev[2], back))), 1e-3)
        sx = cam.fx * abs(float(np.dot(prev[0], back))) / denom
        sy = cam.fy * abs(float(np.dot(prev[1], back))) / denom
        roll = abs(float(np.dot(prev[0], rot[1])))
        s_roll = 0.125 * float(np.hypot(cam.width, cam.height)) * roll
        sx, sy = max(sx, 0.3 * sy) + s_roll, max(sy, 0.3 * sx) + s_roll

        def win(shift):
            for wdw in (8, 16, 32, 64, 128):
                if shift <= wdw - 1:
                    return wdw
            return 128
        return (win(sy), win(sx))

    def _render_guided(self, track_visit: bool):
        """Guided-sampling frame (cuda_renderer.cpp:107-139,
        ``viewer.py:1176-1296``): an invalidation (collect, MLP query)
        when the cache cannot be reused, then the composite, itself cached
        while the camera, options and cache stay the same."""
        cam = self.camera
        opt = self.options
        needs_votes = opt.use_splitting
        # a cache from the vote-free fast collect cannot serve a splitting
        # frame: rebuild with votes
        if (needs_votes and self._guided_cache is not None
                and self._guided_cache[1] is None):
            self._can_reuse_results = False
        if not self._can_reuse_results or self._guided_cache is None:
            with profiling.annotate("viewer.guided_sampling"):
                if (self.use_fast_path and self.tree.N == 2
                        and not needs_votes and not track_visit):
                    cache = self._collect_fast(cam, opt)
                    res = None
                else:
                    cache, res = guided.collect_and_query(
                        self.tree, self.model, cam, opt,
                        track_visit=track_visit)
            self._guided_cache = (cache, res)
            self._guided_gen += 1
            self._can_reuse_results = True
        cache, res = self._guided_cache
        # the composite depends only on (cache, camera, options)
        key = (self._guided_gen, cam.transform.tobytes(), cam.fx, cam.fy,
               cam.cx, cam.cy, cam.width, cam.height, opt,
               self.use_pallas_composite)
        if self._guided_img_cache is not None \
                and self._guided_img_cache[0] == key:
            return self._guided_img_cache[1], res
        with profiling.annotate("viewer.nerf_composite"):
            img = guided.composite_frame(self.tree, cam, opt, cache)
        self._guided_img_cache = (key, img)
        return img, res

    def _collect_fast(self, cam, opt):
        """The leaf-map guided invalidation: the collect in the previous
        invalidation's cost order, segmented by per-class sample budgets
        once hints exist (with ``use_guided_segments`` on), then the next
        order and budgets from this collect's (ns, steps), dilated under
        camera motion."""
        R = cam.width * cam.height
        skip_table = self._ensure_maps(False)
        g_order = self._guided_order
        if g_order is not None and g_order[0].shape[0] != R:
            g_order = None
        if g_order is None:
            self._guided_segments = None
            self._guided_seg_src = None
        segs = self._guided_segments if self.use_guided_segments else None
        cache = guided.collect_and_query_fast(
            self.tree, self._leaf_map, self.model, cam, opt,
            chunk_size=self.fast_chunk_size, skip_table=skip_table,
            order=g_order, segments=segs)
        if segs is not None and "segments" in cache:
            # escalations settle here: the next invalidation starts from
            # the settled ladder
            self._guided_segments = cache["segments"]
        ns_h = cache["num_samples"]
        st_h = cache["collect_steps"]
        window = self._estimate_dilation(attr="_guided_back")
        if window:
            st_h, ns_h, _ = accel.dilate_hints(
                st_h, ns_h, width=cam.width, height=cam.height,
                window=window)
        self._guided_order = accel.order_from_ns_steps_device(ns_h, st_h)
        src = ("dil", window) if window else ("steady",)
        if self.use_guided_segments and (self._guided_segments is None
                                         or self._guided_seg_src != src):
            classes = accel.class_ladder(int(opt.max_guided_samples))
            cdf = accel.hint_class_cdf(ns_h, classes=classes)
            with profiling.host_sync("guided_cdf"):
                cdf = cdf.cpu().numpy()
            self._guided_segments = accel.segments_from_hint_cdf(
                cdf, R, classes=classes,
                headroom=bool(window))
            self._guided_seg_src = src
        return cache

    def _expand_voxels(self, res):
        """Dynamic refinement step (cuda_renderer.cpp:205-341): split, or
        resample when nothing was added."""
        new_tree, tracker, added = refine.expand_voxels(
            self.tree, self.model, self.options, res.split_vote,
            self._visit_tracker, generator=self._rng)
        self._visit_tracker = tracker
        # every branch edits the tree: the leaf map is stale
        self._leaf_map = None
        self._skip_table = None
        if added == 0:
            new_tree = refine.get_more_samples(
                self.tree, self.model, self.options, res.sample_vote,
                generator=self._rng)
        else:
            self._can_reuse_results = False
            self._guided_cache = None
        self.tree = new_tree
        self._tree_gen += 1

    def _prune(self):
        """Capacity-pressure prune (cuda_renderer.cpp:343-381)."""
        self.tree, self._visit_tracker = refine.prune_tree(
            self.tree, self._visit_tracker)
        # the tracker was reset: the next prune needs a fresh tracked frame
        self._visits_valid = False
        self._leaf_map = None
        self._skip_table = None
        self._tree_gen += 1
        # pruning compacts chunk ids: cached votes would name wrong chunks
        self._can_reuse_results = False
        self._guided_cache = None

    # ------------------------------------------------------------------
    # Interactive-equivalent input handling (reference main.cpp:268-420)
    # ------------------------------------------------------------------
    def key_event(self, key: str, shift: bool = False) -> None:
        """Headless keymap matching the reference GLFW handler
        (main.cpp:273-383): WASDQE movement, M/R toggles, G/F grid
        depth, -/=/0 focal, 1-6 world up, C prints C2W."""
        cam = self.camera
        key = key.upper() if len(key) == 1 else key
        if key in "WSADEQ":
            speed = 0.002 * (5.0 if shift else 1.0)
            if key in "SAE":
                speed = -speed
            vec = (cam.v_right if key in "AD"
                   else -cam.v_back if key in "WS"
                   else -cam.v_up)
            cam.move(vec * speed)
        elif key == "C":
            print("C2W:\n")
            for i in range(3):
                print(" ".join(f"{cam.transform[j][i]:.10f}"
                               for j in range(4)))
        elif key == "M":
            self.options = self.options.replace(
                use_splitting=not self.options.use_splitting)
        elif key == "R":
            self.options = self.options.replace(
                use_guided_sampling=not self.options.use_guided_sampling)
        elif key == "G":
            self.options = self.options.replace(
                grid_max_depth=self.options.grid_max_depth + 1)
        elif key == "F":
            self.options = self.options.replace(
                grid_max_depth=self.options.grid_max_depth - 1)
        elif key == "-":
            cam.fx *= 0.99
            cam.fy *= 0.99
        elif key == "=":
            cam.fx *= 1.01
            cam.fy *= 1.01
        elif key == "0":
            cam.fx = cam.default_fx
            cam.fy = cam.default_fy
        elif key in "123456":
            ups = {"1": (0, 0, 1), "2": (0, 0, -1), "3": (0, 1, 0),
                   "4": (0, -1, 0), "5": (1, 0, 0), "6": (-1, 0, 0)}
            cam.v_world_up = np.asarray(ups[key], np.float32)

    def mouse_button(self, button: str, pressed: bool, x: float,
                     y: float, shift: bool = False) -> None:
        """left = orbit about camera, right = orbit about origin,
        middle/shift = pan (main.cpp:387-406)."""
        if pressed:
            is_pan = shift or button == "middle"
            about_origin = (button == "right"
                            or (button == "middle" and shift))
            self.camera.begin_drag(x, y, is_pan, about_origin)
        else:
            self.camera.end_drag()

    def cursor(self, x: float, y: float) -> None:
        self.camera.drag_update(x, y)

    def scroll(self, yoffset: float) -> None:
        """Scroll moves along the view axis (main.cpp:412-420)."""
        speed_fact = 1e-1
        self.camera.move(self.camera.v_back
                         * (speed_fact if yoffset < 0 else -speed_fact))

    # ------------------------------------------------------------------
    # Session checkpoint/resume
    # ------------------------------------------------------------------
    def save_state(self, path: str, tree_path: Optional[str] = None):
        """Persist camera pose/intrinsics and render options (JSON), and
        optionally the refined tree (svox npz via ``N3Tree.save_npz``)."""
        cam = self.camera
        state = dict(
            camera=dict(
                width=cam.width, height=cam.height, fx=cam.fx,
                fy=cam.fy, cx=cam.cx, cy=cam.cy,
                center=cam.center.tolist(),
                v_back=cam.v_back.tolist(),
                v_world_up=cam.v_world_up.tolist(),
                origin=cam.origin.tolist(),
                movement_speed=cam.movement_speed),
            options=dataclasses.asdict(self.options),
            tree_path=tree_path,
        )
        with open(path, "w") as f:
            json.dump(state, f, indent=2)
        if tree_path and self.tree is not None:
            self.tree.save_npz(tree_path)

    def load_state(self, path: str, load_tree: bool = True):
        """Restore a saved session; reloads the tree if recorded."""
        with open(path) as f:
            state = json.load(f)
        c = state["camera"]
        cam = Camera(c["width"], c["height"], c["fx"], c["fy"],
                     c["cx"], c["cy"])
        cam.center = np.asarray(c["center"], np.float32)
        cam.v_back = np.asarray(c["v_back"], np.float32)
        cam.v_world_up = np.asarray(c["v_world_up"], np.float32)
        cam.origin = np.asarray(c["origin"], np.float32)
        cam.movement_speed = c["movement_speed"]
        cam._update()
        self.camera = cam
        o = state["options"]
        for k in ("render_bbox", "basis_minmax", "rot_dirs"):
            o[k] = tuple(o[k])
        if load_tree and state.get("tree_path"):
            self.set(N3Tree.open(state["tree_path"], device=self.device),
                     self.max_tree_capacity)
        # options after set(): set() resets basis_minmax to the tree's band
        self.options = RenderOptions(**o)
        self._can_reuse_results = False
        self._guided_cache = None

    # ------------------------------------------------------------------
    def screenshot(self, path: str) -> bool:
        """Render and save a PNG (reference save-screenshot dialog,
        main.cpp:138-162), through :meth:`render_rgba8`."""
        return write_png(path, self.render_rgba8())
