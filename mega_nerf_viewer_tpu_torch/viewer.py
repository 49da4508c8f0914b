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
frame protocol is the JAX package's under its ``"sync"`` overflow policy:
the record-sorted segmented frame on a ray order from the previous frame's
packed hints, a redo with escalated budgets when a segment overflows, the
hint frame with its ``max_dense`` escalation loop when there is no order,
and the exact renderer when even budget 128 overflows.  Under camera
motion the order is rebuilt on the device from the hints max-dilated by
the estimated silhouette sweep.

Not ported, and refused with ``NotImplementedError`` rather than run
another way: the ``"async"`` and ``"device"`` overflow policies and the
re-hint motion frame (ROADMAP queue 1, items 4 and 8), ``foveation`` > 1,
``use_turbo_map``, ``show_grid`` and ``meshes`` (items 8 and 9).  The JAX
``use_dynamic_knobs`` (traced knobs that spare a recompile) means nothing
without jit and is left out, as is ``use_pallas_composite``: every guided
frame goes through ``guided.composite_frame``.  So are the JAX switches
``use_fast_path``, ``use_prepass``, ``use_device_order`` and
``use_guided_segments``, which nothing turns off: a binary tree always
takes the leaf-map path, a frame without votes the prepass, ray orders
are always built on the device, and the guided collect is segmented once
budgets exist.  ``motion_mode`` is left out too: it only chooses how the
unported async policy regains an order; the sync policy always dilates.
"""

from __future__ import annotations

import dataclasses
import json
import logging
from typing import Optional

import numpy as np
import torch

from .camera import Camera
from .device import resolve_device
from .n3tree import N3Tree
from .options import RenderOptions
from .ops import accel, guided, refine
from .ops.render import (RenderResult, fresh_visit_tracker, render_frame,
                         to_rgba8)
from .ops.skip_prepass import build_skip_table
from .utils.metrics import FpsCounter, FrameTimer
from .utils.png import write_png
from .utils.tuning import device_tuning

_log = logging.getLogger(__name__)

OVERFLOW_POLICIES = ("sync", "async", "device")


def _same_device(a: torch.device, b: torch.device) -> bool:
    if a.type != b.type:
        return False
    return a.index is None or b.index is None or a.index == b.index


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
        self.timer = FrameTimer()
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
        self._leaf_map = None
        self._skip_table = None
        self._skip_thresh = None
        # refused when set (see the module docstring)
        self.use_turbo_map = False
        self.foveation = 1
        self.meshes = []
        # "sync": check the segment flags before returning each frame and
        # redo if stale, so every returned frame is exact.  The only
        # policy ported; "async" and "device" raise.
        self.overflow_policy = "sync"
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
        self._guided_budget_hint = None
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
    def get_backend(self) -> str:
        """The device type this viewer renders on ("CUDA" or "CPU")."""
        return self.device.type.upper()

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
    def _check_ported(self) -> None:
        """Refuse the modes this port does not have yet."""
        opt = self.options
        if self.overflow_policy not in OVERFLOW_POLICIES:
            raise ValueError(f"overflow_policy {self.overflow_policy!r} not "
                             f"in {OVERFLOW_POLICIES}")
        if self.overflow_policy != "sync":
            raise NotImplementedError(
                f"overflow_policy={self.overflow_policy!r} (the deferred "
                f"flag check, device_fallback and the re-hint motion frame "
                f"accel._motion_core) is not ported yet: ROADMAP queue 1, "
                f"items 4 and 8")
        if int(self.foveation) > 1:
            raise NotImplementedError(
                "foveation > 1 (_render_foveated) is not ported yet: "
                "ROADMAP queue 1, item 9")
        if self.use_turbo_map:
            raise NotImplementedError(
                "use_turbo_map (build_turbo_leaf_map) is not ported yet: "
                "ROADMAP queue 1, item 8")
        if opt.show_grid or self.meshes:
            raise NotImplementedError(
                "show_grid and meshes (_render_with_grid, utils/wireframe, "
                "utils/mesh) are not ported yet: ROADMAP queue 1, item 9")

    def render(self, fetch: bool = True):
        """Render one frame, running refinement/prune per the reference's
        frame orchestration (cuda_renderer.cpp:68-163).  Returns [H, W, 4]
        f32 RGBA as a numpy array; ``fetch=False`` returns the device
        tensor without the copy to the host (under ``host_unpermute`` a
        parked frame is then flat [R, 4] rows in ray order: pair it with
        :meth:`frame_index_map`)."""
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
        self._check_ported()

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
        if opt.use_guided_sampling and not cam.is_dragging() \
                and self.model is not None:
            img, res = self._render_guided(track_visit)
        elif self.tree.N == 2 and not track_visit:
            # leaf-map path, votes included when refining; each expand
            # drops the map and the next frame rebuilds it
            with self.timer.time("render"):
                img, res = self._render_fast(need_votes=needs_votes)
        else:
            with self.timer.time("render"):
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
        if self._frame_sorted:
            if fetch:
                # the display consumer applies the index map the device
                # skipped (bit-identical pixels)
                return img.cpu().numpy()[self._inv_host].reshape(
                    cam.height, cam.width, 4)
            return img
        return img.cpu().numpy() if fetch else img

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
        rgba = to_rgba8(torch.as_tensor(img)).cpu().numpy()
        if self._frame_sorted:
            cam = self.camera
            flat = np.ascontiguousarray(rgba.reshape(-1, 4))
            rgba = flat.view(np.uint32)[:, 0][self._inv_host] \
                .view(np.uint8).reshape(cam.height, cam.width, 4)
        return rgba

    # ------------------------------------------------------------------
    def _ensure_maps(self, need_votes: bool = False):
        """A valid leaf map and, unless this is a vote frame, the skip
        table for the current ``sigma_thresh`` (``viewer.py:519-557``
        without the turbo map).  Returns the skip table or None."""
        opt = self.options
        if self._leaf_map is None:
            with self.timer.time("leaf_map_build"):
                self._leaf_map = accel.build_leaf_map(self.tree)
            self._skip_table = None
        if not need_votes:
            thresh = opt.sigma_thresh
            if self._skip_table is None or self._skip_thresh != thresh:
                self._skip_table = build_skip_table(self.tree, thresh)
                self._skip_thresh = thresh
            return self._skip_table
        return None

    def _render_fast(self, need_votes: bool = False):
        """Leaf-map frame under the sync policy (``viewer.py:560-795``);
        falls back to the exact renderer when even budget 128 overflows.
        Returns (img, res), res carrying the votes when asked, else None."""
        # whether this frame renders under a camera move
        frame_moved = bool(self._order_stale)
        skip_table = self._ensure_maps(need_votes)
        order = self._ray_order
        w, h = self.camera.width, self.camera.height
        R = w * h
        if order is not None and order[0].shape[0] != R:
            order = None
        hints = self._hints_packed
        if hints is not None and hints.shape[0] != R:
            hints = self._hints_packed = None
        if self._order_stale and order is not None and hints is not None:
            # camera moved: rebuild the order on the device from the last
            # frame's hints, max-dilated by the estimated sweep; budgets
            # follow the dilated CDF with one ladder step of headroom
            window = self._estimate_dilation()
            if window:
                dh = accel.dilate_packed(hints, width=w, height=h,
                                         window=window)
                order = self._ray_order = accel.order_from_packed_device(dh)
                src = ("dil", window, True)
                if self._segments_src != src:
                    cdf = accel.hint_class_cdf_packed(dh)
                    self._segments = list(accel.segments_from_hint_cdf(
                        cdf.cpu().numpy(), R, headroom=True))
                    self._segments_src = src
            else:
                order = self._ray_order = accel.order_from_packed_device(
                    hints)
            self._order_stale = False
        overflow = False
        if order is not None:
            segments = self._segments or list(accel.DEFAULT_SEGMENTS)
            # sorted delivery only on parked frames: a moved frame's fresh
            # inv would cost a blocking [R] fetch
            use_sorted = (self.host_unpermute and not need_votes
                          and not frame_moved)
            if use_sorted and self._inv_src is not order[1]:
                self._inv_host = order[1].cpu().numpy()
                self._inv_src = order[1]
            self._frame_sorted = use_sorted
            out = accel.render_frame_fast_segmented(
                self.tree, self._leaf_map, self.camera, self.options,
                order=order, segments=tuple(segments),
                chunk_size=self.fast_chunk_size, need_votes=need_votes,
                skip_table=skip_table, return_hints="packed",
                sorted_output=use_sorted)
            ov = out[1].cpu().numpy()
            if ov.any():
                # stale budgets: escalate the overflowed segments and redo
                # this frame as a hint frame (never the exact cliff)
                self._segments = [
                    (f, min(max(1, md * 2), 128)
                     if ov[min(i, len(ov) - 1)] else md)
                    for i, (f, md) in enumerate(segments)]
                order = None
            else:
                img = out[0]
                if need_votes:
                    split_vote, sample_vote = out[2], out[3]
                self._hints_packed = out[-1]
                self._segments = segments
        if order is None:
            # no order yet (first frame at this resolution, or a redo):
            # one budget for the whole frame, escalated until it fits
            self._frame_sorted = False
            md = self.fast_max_dense
            while True:
                out = accel.render_frame_fast(
                    self.tree, self._leaf_map, self.camera, self.options,
                    max_dense=md, chunk_size=self.fast_chunk_size,
                    need_votes=need_votes, return_nrec=True,
                    skip_table=skip_table, return_skips=True)
                overflow = bool(out[1])
                if not overflow or md >= 128:
                    break
                md *= 2
                self.fast_max_dense = md
            if need_votes:
                img, _, steps, split_vote, sample_vote, nrec, skips = out
            else:
                img, _, steps, nrec, skips = out
            ph = accel.pack_hints(steps, nrec, skips)
            self._ray_order = accel.order_from_packed_device(ph)
            self._hints_packed = ph
            # exact hints of a parked camera: CDF-matched budgets
            cdf = accel.hint_class_cdf(nrec).cpu().numpy()
            self._segments = list(accel.segments_from_hint_cdf(cdf, R))
            self._segments_src = ("steady",)
            self._order_back = np.asarray(
                self.camera.transform, np.float32)[:3, :].copy()
            self._order_stale = False
        if overflow:
            self._frame_sorted = False       # exact-path fallback
            return render_frame(
                self.tree, w, h, self.camera.fx, self.camera.fy,
                self.camera.cx, self.camera.cy, self.camera.transform,
                self.options)
        if need_votes:
            return img, RenderResult(out=None, split_vote=split_vote,
                                     sample_vote=sample_vote, visited=None)
        return img, None

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
            with self.timer.time("guided_sampling"):
                if self.tree.N == 2 and not needs_votes and not track_visit:
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
               cam.cx, cam.cy, cam.width, cam.height, opt)
        if self._guided_img_cache is not None \
                and self._guided_img_cache[0] == key:
            return self._guided_img_cache[1], res
        with self.timer.time("nerf_composite"):
            img = guided.composite_frame(self.tree, cam, opt, cache)
        self._guided_img_cache = (key, img)
        return img, res

    def _collect_fast(self, cam, opt):
        """The leaf-map guided invalidation: the collect in the previous
        invalidation's cost order, segmented by per-class sample budgets
        once hints exist, then the next order and budgets from this
        collect's (ns, steps), dilated under camera motion."""
        R = cam.width * cam.height
        skip_table = self._ensure_maps(False)
        g_order = self._guided_order
        if g_order is not None and g_order[0].shape[0] != R:
            g_order = None
        if g_order is None:
            self._guided_segments = None
            self._guided_seg_src = None
        segs = self._guided_segments
        cache = guided.collect_and_query_fast(
            self.tree, self._leaf_map, self.model, cam, opt,
            chunk_size=self.fast_chunk_size, skip_table=skip_table,
            order=g_order, segments=segs,
            budget_hint=(self._guided_budget_hint
                         if segs is not None else None))
        if "budget_hint_next" in cache:
            self._guided_budget_hint = cache["budget_hint_next"]
        if "segments" in cache:
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
        if self._guided_segments is None or self._guided_seg_src != src:
            classes = accel.class_ladder(int(opt.max_guided_samples))
            cdf = accel.hint_class_cdf(ns_h, classes=classes)
            self._guided_segments = accel.segments_from_hint_cdf(
                cdf.cpu().numpy(), R, classes=classes,
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
