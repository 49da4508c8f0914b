"""Interactive browser viewer: HTTP frame server + embedded frontend
(counterpart of ``mega_nerf_viewer_tpu/web.py``).

Replacement for the reference's desktop app shell — the GLFW window and
event loop (``main.cpp:422-474, :517-624``), the GLFW input callbacks
(``main.cpp:268-420``) and the ImGui control panel (``main.cpp:63-262``).
A GPU server is often headless and reached over the network, so the
window is a tiny web server: the frame renders on the card, quantizes to
rgba8 there (only the 4x-smaller uint8 image crosses to the host, as in
``Viewer.screenshot``), streams to any browser, and mouse, keyboard and
panel events come back as JSON.  stdlib-only (``http.server`` +
``threading``): no GUI dependencies replace the reference's
GLFW/GLEW/ImGui stack.

Threading model
---------------
ONE render thread owns the :class:`~mega_nerf_viewer_tpu_torch.Viewer`
and every call that reaches the card: PyTorch's current CUDA stream is
per thread and the kernels launch on the caller's, and the async
policy's flag copies and their events are made and waited on by the
thread that renders.  HTTP handler threads never touch the Viewer: they
enqueue events (mouse/key/panel edits — the GLFW-callback equivalents)
and read immutable published snapshots (the latest PNG bytes + a JSON
state dict).  Each enqueued event carries a sequence number; POSTs
block until the render thread has applied the event AND published the
frame/state that reflects it, so a client (or test) observes
read-your-writes.  Consecutive cursor events coalesce — the render
thread drains the whole queue before rendering, which paces drag
updates at the frame rate exactly like the reference's
poll-events-then-render loop (``main.cpp:603-616``).

Frame delivery is long-poll (``GET /frame?after=<gen>`` waits for a
newer generation) rather than a websocket: stdlib-only, proxy-friendly,
and a render pass is ~tens of ms so the poll overhead is noise.

Endpoints
---------
``GET  /``                  the embedded single-file frontend
``GET  /state``             camera + options + tree/model info (JSON)
``GET  /frame.bin?after=N`` latest frame as raw rgba8 bytes (long-poll;
                            204 on timeout; X-Gen/X-Width/X-Height
                            headers) — what the embedded frontend
                            draws (canvas putImageData), skipping the
                            per-frame PNG encode entirely
``GET  /frame?after=N``     latest frame PNG (long-poll; 204 on
                            timeout) — for PNG-consuming clients;
                            encoded lazily per generation
``GET  /screenshot.png``    current frame as an attachment (the ImGui
                            save-screenshot dialog, ``main.cpp:106-125``)
``POST /event``             one event or a list (JSON; see _apply_event)

The server binds 127.0.0.1 by default and is meant for a trusted
operator (SSH port-forward to the GPU host): ``open``/``screenshot``
events take server-side paths, exactly like the reference's file
dialogs take paths on the render machine.
"""

from __future__ import annotations

import dataclasses
import json
import threading
import time
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

import numpy as np

from .camera import Camera
from .n3tree import N3Tree
from .options import RenderOptions
from .utils.png import encode_png

_OPTION_FIELDS = {f.name: f for f in dataclasses.fields(RenderOptions)}
# tuple-typed RenderOptions fields (JSON delivers lists)
_TUPLE_FIELDS = {"render_bbox": 6, "basis_minmax": 2, "rot_dirs": 3}
# camera scalar / vec3 attributes settable from the panel
# (ImGui camera section, main.cpp:166-201)
_CAM_SCALARS = ("fx", "fy", "cx", "cy", "movement_speed")
_CAM_VECTORS = ("center", "origin", "v_back", "v_world_up")
# Viewer execution knobs exposed in the extra "Execution" panel section
_VIEWER_FLAGS = ("use_fast_path", "use_dynamic_knobs", "use_turbo_map",
                 "use_prepass", "use_device_order", "foveation",
                 "overflow_policy", "host_unpermute", "motion_mode",
                 "motion_flag_interval")


class WebViewer:
    """Serve an interactive browsing session for one ``Viewer``.

    Parameters
    ----------
    viewer:  a constructed Viewer (tree/model optional; the ``open``
             event can load a tree later, like the ImGui dialog).
    host / port:  bind address; ``port=0`` picks an ephemeral port
             (read it back from ``.port`` after ``start()``).
    idle_interval:  seconds between renders when nothing changed but a
             mode needs continuous frames (splitting refines per frame,
             ``cuda_renderer.cpp:145-147``); pure camera-static views
             do not re-render at all (the Viewer's caches would make
             them near-free, but not rendering is freer).
    """

    def __init__(self, viewer, host: str = "127.0.0.1", port: int = 8000,
                 idle_interval: float = 0.05):
        self.viewer = viewer
        self.host = host
        self.port = port
        self.idle_interval = float(idle_interval)

        self._events = []                  # pending [(seq, dict)]
        self._next_seq = 1
        self._applied_seq = 0              # published through this seq
        self._cv = threading.Condition()   # guards the three above +
        #                                    frame/state publication
        self._frame_rgba = None            # latest frame, [H, W, 4] u8
        self._frame_gen = 0
        # PNG encodes LAZILY on first request per generation: the
        # embedded frontend consumes the raw-rgba endpoint, so the
        # ~tens-of-ms zlib pass at 1080p runs only for /frame (PNG
        # long-poll clients) and /screenshot.png — never on the render
        # thread's critical path
        self._frame_png: bytes = b""
        self._png_gen = -1
        self._state: dict = {}
        self._error: str = ""
        self._stop = threading.Event()
        self._render_thread: Optional[threading.Thread] = None
        self._httpd: Optional[ThreadingHTTPServer] = None

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    def start(self) -> int:
        """Bind, start the HTTP + render threads, return the port."""
        web = self

        class _Handler(_RequestHandler):
            server_web = web

        self._httpd = ThreadingHTTPServer((self.host, self.port), _Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._render_thread = threading.Thread(
            target=self._render_loop, name="render", daemon=True)
        self._render_thread.start()
        threading.Thread(target=self._httpd.serve_forever,
                         name="http", daemon=True).start()
        return self.port

    def stop(self):
        self._stop.set()
        with self._cv:
            self._cv.notify_all()
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
        if self._render_thread is not None:
            self._render_thread.join(timeout=30)

    def serve_forever(self):
        """Block until interrupted (CLI ``--serve`` mode)."""
        try:
            while not self._stop.is_set():
                time.sleep(0.25)
        except KeyboardInterrupt:
            pass
        finally:
            self.stop()

    # ------------------------------------------------------------------
    # handler-side API (HTTP threads)
    # ------------------------------------------------------------------
    def submit(self, events, timeout: float = 60.0) -> dict:
        """Enqueue event(s); block until applied + published."""
        if isinstance(events, dict):
            events = [events]
        with self._cv:
            for ev in events:
                self._events.append((self._next_seq, ev))
                self._next_seq += 1
            seq = self._next_seq - 1
            self._cv.notify_all()
            deadline = time.monotonic() + timeout
            while self._applied_seq < seq and not self._stop.is_set():
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return {"applied": False, "gen": self._frame_gen,
                            "error": self._error or "timeout"}
                self._cv.wait(remaining)
            return {"applied": True, "gen": self._frame_gen,
                    "error": self._error}

    def _wait_gen(self, after: int, timeout: float) -> bool:
        """Block until a frame newer than ``after`` exists (True) or
        timeout/stop (False).  Caller does NOT hold the lock."""
        after = max(after, 0)
        with self._cv:
            deadline = time.monotonic() + timeout
            while self._frame_gen <= after and not self._stop.is_set():
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._cv.wait(remaining)
            return self._frame_gen > after

    def wait_frame(self, after: int, timeout: float = 30.0):
        """Return (gen, png_bytes) once gen > after, else (after, None).

        Generation 0 means "no frame rendered yet", so ``after=-1``
        still waits for the first real frame."""
        if not self._wait_gen(after, timeout):
            return max(after, 0), None
        # lazy PNG: encode outside the lock from a snapshot, cache per
        # generation (concurrent encoders of one gen are idempotent)
        with self._cv:
            gen, rgba = self._frame_gen, self._frame_rgba
            if gen == self._png_gen:
                return gen, self._frame_png
        png = encode_png(rgba)
        with self._cv:
            if gen > self._png_gen:
                self._png_gen, self._frame_png = gen, png
        return gen, png

    def wait_frame_raw(self, after: int, timeout: float = 30.0):
        """Return (gen, rgba8 [H, W, 4]) once gen > after, else
        (after, None) — the raw-frame long poll the embedded frontend
        uses (no PNG encode; the array is replaced, never mutated, by
        the render thread, so sharing the reference is safe)."""
        if not self._wait_gen(after, timeout):
            return max(after, 0), None
        with self._cv:
            return self._frame_gen, self._frame_rgba

    def get_state(self) -> dict:
        with self._cv:
            return dict(self._state) if self._state else {}

    # ------------------------------------------------------------------
    # render thread
    # ------------------------------------------------------------------
    def _render_loop(self):
        # first frame unconditionally, then event-driven
        dirty = True
        while not self._stop.is_set():
            with self._cv:
                pending = self._events
                self._events = []
                top_seq = pending[-1][0] if pending else self._applied_seq
            batch_failed = False
            for _, ev in pending:
                try:
                    self._apply_event(ev)
                except Exception:
                    self._error = traceback.format_exc(limit=3)
                    batch_failed = True
                dirty = True
            continuous = (self.viewer.options.use_splitting
                          and not self.viewer.camera.is_dragging())
            if dirty or continuous:
                try:
                    self._render_publish()
                    if not batch_failed:
                        self._error = ""
                except Exception:
                    self._error = traceback.format_exc(limit=3)
                    self._publish_state()
                dirty = False
            with self._cv:
                self._applied_seq = max(self._applied_seq, top_seq)
                self._cv.notify_all()
                if not self._events and not self._stop.is_set():
                    self._cv.wait(self.idle_interval if continuous
                                  else 0.5)

    def _render_publish(self):
        v = self.viewer
        # render_rgba8: quantization on the card and, under the
        # host_unpermute knob, the sorted frame's index map applied here
        # on the host (this server is that display consumer)
        rgba8 = v.render_rgba8()
        with self._cv:
            self._frame_rgba = rgba8
            self._frame_gen += 1
        self._publish_state()

    def _publish_state(self):
        v = self.viewer
        cam = v.camera
        tree = v.tree
        state = {
            "backend": v.get_backend(),
            "fps": round(v.fps.fps, 2),
            "gen": self._frame_gen,
            "error": self._error,
            "camera": {
                "width": cam.width, "height": cam.height,
                "fx": cam.fx, "fy": cam.fy, "cx": cam.cx, "cy": cam.cy,
                "movement_speed": cam.movement_speed,
                "center": np.asarray(cam.center).tolist(),
                "origin": np.asarray(cam.origin).tolist(),
                "v_back": np.asarray(cam.v_back).tolist(),
                "v_world_up": np.asarray(cam.v_world_up).tolist(),
            },
            "options": dataclasses.asdict(v.options),
            "viewer": {k: getattr(v, k) for k in _VIEWER_FLAGS},
            "tree": None if tree is None else {
                "capacity": int(tree.capacity),
                "max_capacity": int(tree.max_capacity),
                "N": int(tree.N),
                "data_dim": int(tree.data_dim),
                "data_format": str(tree.data_format),
            },
            "model": v.model is not None,
        }
        with self._cv:
            self._state = state
            self._cv.notify_all()

    # ------------------------------------------------------------------
    # event application (render thread only)
    # ------------------------------------------------------------------
    def _apply_event(self, ev: dict):
        """Apply one JSON event.  Event types mirror the reference's
        input surface:

        ``key``        GLFW key callback (``main.cpp:268-385``)
        ``mouse``      button press/release (``main.cpp:387-406``)
        ``cursor``     drag update (``main.cpp:408-410``)
        ``scroll``     wheel zoom (``main.cpp:412-420``)
        ``resize``     framebuffer resize (``main.cpp:476-482``)
        ``options``    ImGui render/visualization/computation sliders
        ``camera``     ImGui camera section (+``normalize`` semantics
                       of the "normalize & update dirs" button)
        ``viewer``     execution knobs (no reference counterpart)
        ``open``       load-tree dialog (``main.cpp:129-137``)
        ``screenshot`` save-screenshot dialog (``main.cpp:138-162``)
        ``save_state`` / ``load_state``  session checkpoint (new)
        ``render``     force one frame
        """
        v = self.viewer
        t = ev.get("t")
        if t == "key":
            v.key_event(str(ev["key"]), bool(ev.get("shift", False)))
        elif t == "mouse":
            v.mouse_button(str(ev.get("button", "left")),
                           bool(ev["pressed"]),
                           float(ev.get("x", 0.0)), float(ev.get("y", 0.0)),
                           bool(ev.get("shift", False)))
        elif t == "cursor":
            v.cursor(float(ev["x"]), float(ev["y"]))
        elif t == "scroll":
            v.scroll(float(ev["dy"]))
        elif t == "resize":
            v.resize(int(ev["width"]), int(ev["height"]))
        elif t == "options":
            fields = {}
            for k, val in ev.items():
                if k == "t":
                    continue
                if k not in _OPTION_FIELDS:
                    raise KeyError(f"unknown RenderOptions field {k!r}")
                if k in _TUPLE_FIELDS:
                    if len(val) != _TUPLE_FIELDS[k]:
                        raise ValueError(f"{k} expects "
                                         f"{_TUPLE_FIELDS[k]} values")
                    val = tuple(type(d)(x) for d, x in zip(
                        getattr(v.options, k), val))
                else:
                    val = type(getattr(v.options, k))(val)
                fields[k] = val
            v.options = v.options.replace(**fields)
        elif t == "camera":
            cam = v.camera
            for k, val in ev.items():
                if k in _CAM_SCALARS:
                    setattr(cam, k, float(val))
                elif k in _CAM_VECTORS:
                    vec = np.asarray([float(x) for x in val], np.float32)
                    if vec.shape != (3,):
                        raise ValueError(f"{k} expects 3 floats")
                    if k in ("v_back", "v_world_up"):
                        # "normalize & update dirs" (main.cpp:192-197)
                        n = float(np.linalg.norm(vec))
                        if n == 0.0:
                            raise ValueError(f"{k} must be nonzero")
                        vec = vec / n
                    setattr(cam, k, vec)
                elif k != "t":
                    raise KeyError(f"unknown camera field {k!r}")
        elif t == "viewer":
            for k, val in ev.items():
                if k == "t":
                    continue
                if k not in _VIEWER_FLAGS:
                    raise KeyError(f"unknown viewer knob {k!r}")
                if k == "overflow_policy":
                    if val not in ("sync", "async", "device"):
                        raise ValueError("overflow_policy must be "
                                         "sync|async|device")
                    v.overflow_policy = val
                elif k == "motion_mode":
                    if val not in ("rehint", "dilate"):
                        raise ValueError("motion_mode must be "
                                         "rehint|dilate")
                    v.motion_mode = val
                elif k in ("foveation", "motion_flag_interval"):
                    setattr(v, k, max(1, int(val)))
                else:
                    setattr(v, k, bool(val))
        elif t == "open":
            tree = N3Tree.open(
                str(ev["path"]),
                max_capacity=ev.get("max_capacity"),
                bounds_only=bool(ev.get("bounds_only", False)),
                device=v.device)
            v.set(tree, max_tree_capacity=ev.get("max_capacity"))
        elif t == "screenshot":
            if not v.screenshot(str(ev["path"])):
                raise OSError(f"failed to write {ev['path']!r}")
        elif t == "save_state":
            v.save_state(str(ev["path"]), ev.get("tree_path"))
        elif t == "load_state":
            v.load_state(str(ev["path"]),
                         load_tree=bool(ev.get("load_tree", True)))
        elif t == "render":
            pass                      # drain+render happens regardless
        else:
            raise KeyError(f"unknown event type {t!r}")


def serve(tree: Optional[N3Tree] = None,
          camera: Optional[Camera] = None,
          options: Optional[RenderOptions] = None,
          host: str = "127.0.0.1", port: int = 8000, **viewer_kwargs
          ) -> WebViewer:
    """Convenience constructor: build a Viewer and start serving
    (``viewer_kwargs`` go to the Viewer: ``device=None`` is the CUDA
    card, ``"cpu"`` the plain path)."""
    from .viewer import Viewer
    v = Viewer(tree, camera=camera, options=options, **viewer_kwargs)
    wv = WebViewer(v, host=host, port=port)
    wv.start()
    return wv


# ----------------------------------------------------------------------
# HTTP plumbing
# ----------------------------------------------------------------------
class _RequestHandler(BaseHTTPRequestHandler):
    server_web: WebViewer = None  # bound by WebViewer.start()
    protocol_version = "HTTP/1.1"

    def log_message(self, *a):     # silence per-request stderr spam
        pass

    def _send(self, code: int, body: bytes, ctype: str,
              extra: Optional[dict] = None):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.send_header("Cache-Control", "no-store")
        for k, v in (extra or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _json(self, obj, code: int = 200):
        self._send(code, json.dumps(obj).encode(), "application/json")

    def do_GET(self):
        web = self.server_web
        url = urlparse(self.path)
        if url.path == "/":
            self._send(200, _PAGE, "text/html; charset=utf-8")
        elif url.path == "/state":
            self._json(web.get_state())
        elif url.path == "/frame":
            q = parse_qs(url.query)
            after = int(q.get("after", ["-1"])[0])
            timeout = min(120.0, float(q.get("timeout", ["30"])[0]))
            gen, png = web.wait_frame(after, timeout)
            if png is None:
                self._send(204, b"", "image/png", {"X-Gen": str(gen)})
            else:
                self._send(200, png, "image/png", {"X-Gen": str(gen)})
        elif url.path == "/frame.bin":
            q = parse_qs(url.query)
            after = int(q.get("after", ["-1"])[0])
            timeout = min(120.0, float(q.get("timeout", ["30"])[0]))
            gen, rgba = web.wait_frame_raw(after, timeout)
            if rgba is None:
                self._send(204, b"", "application/octet-stream",
                           {"X-Gen": str(gen)})
            else:
                self._send(200, rgba.tobytes(),
                           "application/octet-stream",
                           {"X-Gen": str(gen),
                            "X-Width": str(rgba.shape[1]),
                            "X-Height": str(rgba.shape[0])})
        elif url.path == "/screenshot.png":
            gen, png = web.wait_frame(-1, 30.0)
            self._send(200, png or b"", "image/png",
                       {"Content-Disposition":
                        'attachment; filename="screenshot.png"'})
        else:
            self._json({"error": "not found"}, 404)

    def do_POST(self):
        web = self.server_web
        url = urlparse(self.path)
        try:
            n = int(self.headers.get("Content-Length", "0"))
            payload = json.loads(self.rfile.read(n) or b"{}")
        except (ValueError, json.JSONDecodeError) as e:
            self._json({"error": f"bad json: {e}"}, 400)
            return
        if url.path == "/event":
            res = web.submit(payload)
            self._json(res, 200 if res["applied"] and not res["error"]
                       else 500)
        else:
            self._json({"error": "not found"}, 404)


# ----------------------------------------------------------------------
# Embedded frontend.  One file, no dependencies; panel layout mirrors
# the ImGui window (main.cpp:63-262): Camera / Render / Visualization /
# Computation sections plus an Execution section for the knobs the
# reference does not have.
# ----------------------------------------------------------------------
_PAGE = ("""<!doctype html>
<html><head><meta charset="utf-8"><title>mega-nerf-viewer-tpu</title>
<style>
 body{margin:0;display:flex;font:13px system-ui;background:#15171a;
      color:#d8dadd;height:100vh;overflow:hidden}
 #view{flex:1;display:flex;align-items:center;justify-content:center;
       overflow:auto}
 #frame{image-rendering:pixelated;cursor:grab;max-width:100%;
        max-height:100%}
 #panel{width:330px;min-width:330px;overflow-y:auto;background:#1d2025;
        padding:10px;border-left:1px solid #2c2f35}
 details{margin-bottom:6px;border:1px solid #2c2f35;border-radius:4px;
         padding:4px 8px}
 summary{cursor:pointer;font-weight:600;margin:2px 0}
 label{display:flex;align-items:center;gap:6px;margin:3px 0}
 label span.k{width:105px;color:#9aa0a8;flex:none}
 input[type=range]{flex:1}
 input[type=number],input[type=text]{width:62px;background:#15171a;
   color:#d8dadd;border:1px solid #2c2f35;border-radius:3px;padding:2px}
 input.vec{width:52px}
 input.path{flex:1;width:auto}
 button{background:#2b6cb0;color:#fff;border:0;border-radius:3px;
        padding:4px 10px;cursor:pointer;margin:2px 2px 2px 0}
 #hdr{font-weight:700;margin-bottom:6px}
 #stats{color:#9aa0a8;margin-bottom:8px;white-space:pre-line}
 #err{color:#f56565;white-space:pre-wrap;font-size:11px}
 .chk{display:inline-flex;margin-right:10px}
</style></head><body>
<div id="view"><canvas id="frame" width="0" height="0"></canvas></div>
<div id="panel">
 <div id="hdr">mega-nerf-viewer-tpu</div>
 <div id="stats"></div>
 <div>
  <button onclick="sendEv({t:'render'})">Render</button>
  <a href="/screenshot.png" download><button>Save Screenshot</button></a>
 </div>
 <label><span class="k">open npz</span>
  <input class="path" id="treepath" type="text" placeholder="/path/tree.npz">
  <button onclick="openTree()">Open</button></label>
 <details open><summary>Camera</summary>
  <label><span class="k">center</span><span id="center"></span></label>
  <label><span class="k">origin</span><span id="origin"></span></label>
  <label><span class="k">focal fx</span>
   <input type="range" min="5" max="7000" step="1" data-cam="fx">
   <input type="number" data-cam="fx"></label>
  <label><span class="k">focal fy</span>
   <input type="range" min="5" max="7000" step="1" data-cam="fy">
   <input type="number" data-cam="fy"></label>
  <label><span class="k">world_up</span><span id="wu"></span></label>
  <label><span class="k">speed</span>
   <input type="number" step="0.1" data-cam="movement_speed"></label>
 </details>
 <details open><summary>Render</summary>
  <label><span class="k">step_size</span>
   <input type="number" step="any" data-opt="step_size"></label>
  <label><span class="k">sigma_thresh</span>
   <input type="range" min="0" max="100" step="0.01"
          data-opt="sigma_thresh">
   <input type="number" step="any" data-opt="sigma_thresh"></label>
  <label><span class="k">stop_thresh</span>
   <input type="range" min="0.001" max="0.4" step="0.001"
          data-opt="stop_thresh">
   <input type="number" step="any" data-opt="stop_thresh"></label>
  <label><span class="k">background</span>
   <input type="range" min="0" max="1" step="0.01"
          data-opt="background_brightness">
   <input type="number" step="any" data-opt="background_brightness">
  </label>
 </details>
 <details open><summary>Visualization</summary>
  <div id="bbox"></div>
  <label><span class="k">decomp</span>
   <input type="number" class="vec" data-opt="basis_minmax" data-idx="0">
   <input type="number" class="vec" data-opt="basis_minmax" data-idx="1">
  </label>
  <div id="rot"></div>
  <div>
   <label class="chk"><input type="checkbox" data-opt="show_grid">grid
   </label>
   <label class="chk"><input type="checkbox" data-opt="render_depth">
    depth</label>
   <label class="chk"><input type="checkbox" data-opt="use_splitting">
    splitting</label>
   <label class="chk">
    <input type="checkbox" data-opt="use_guided_sampling">guided</label>
  </div>
  <label><span class="k">grid depth</span>
   <input type="range" min="0" max="10" step="1"
          data-opt="grid_max_depth">
   <input type="number" data-opt="grid_max_depth"></label>
 </details>
 <details><summary>Computation</summary>
  <label><span class="k">max_depth</span>
   <input type="number" data-opt="max_depth"></label>
  <label><span class="k">max samples</span>
   <input type="number" data-opt="max_sample_count"></label>
  <label><span class="k">samples/corner</span>
   <input type="number" data-opt="samples_per_corner"></label>
  <label><span class="k">split batch</span>
   <input type="number" data-opt="split_batch_size"></label>
  <label><span class="k">nerf batch</span>
   <input type="number" data-opt="nerf_batch_size"></label>
  <label><span class="k">guided/ray</span>
   <input type="number" data-opt="max_guided_samples"></label>
 </details>
 <details><summary>Execution</summary>
  <div>
   <label class="chk"><input type="checkbox" data-viewer="use_fast_path">
    fast path</label>
   <label class="chk"><input type="checkbox" data-viewer="use_prepass">
    prepass</label>
   <label class="chk"><input type="checkbox" data-viewer="use_turbo_map">
    turbo</label>
   <label class="chk">
    <input type="checkbox" data-viewer="host_unpermute">sorted</label>
  </div>
  <label><span class="k">overflow</span>
   <select data-viewer="overflow_policy">
    <option>sync</option><option>async</option><option>device</option>
   </select></label>
  <label><span class="k">foveation</span>
   <input type="number" min="1" data-viewer="foveation"></label>
  <label><span class="k">motion</span>
   <select data-viewer="motion_mode">
    <option>rehint</option><option>dilate</option>
   </select></label>
  <label><span class="k">flag int.</span>
   <input type="number" min="1" data-viewer="motion_flag_interval"></label>
 </details>
 <div id="err"></div>
</div>
<script>
"use strict";
const img = document.getElementById('frame');
const ctx = img.getContext('2d');
let gen = -1, state = null, inflight = false, queue = [];

async function post(ev){
  queue.push(ev);
  if (inflight) return;
  inflight = true;
  while (queue.length){
    const batch = queue; queue = [];
    try {
      const r = await fetch('/event', {method:'POST',
        headers:{'Content-Type':'application/json'},
        body: JSON.stringify(batch)});
      const res = await r.json();
      document.getElementById('err').textContent = res.error || '';
    } catch(e){ document.getElementById('err').textContent = String(e); }
  }
  inflight = false;
  refreshState();
}
function sendEv(ev){ post(ev); }
function openTree(){
  const p = document.getElementById('treepath').value.trim();
  if (p) post({t:'open', path:p});
}

// ---- frame long-poll loop (raw rgba8: no server-side PNG encode) ----
async function frameLoop(){
  for(;;){
    try {
      const r = await fetch('/frame.bin?after=' + gen + '&timeout=30');
      if (r.status === 200){
        gen = parseInt(r.headers.get('X-Gen'));
        const w = parseInt(r.headers.get('X-Width'));
        const h = parseInt(r.headers.get('X-Height'));
        const buf = new Uint8ClampedArray(await r.arrayBuffer());
        if (img.width !== w) img.width = w;
        if (img.height !== h) img.height = h;
        ctx.putImageData(new ImageData(buf, w, h), 0, 0);
        refreshState();
      }
    } catch(e){ await new Promise(res => setTimeout(res, 1000)); }
  }
}

// ---- state → panel ----
function fmt3(v){ return v.map(x => x.toFixed(3)).join(', '); }
async function refreshState(){
  try { state = await (await fetch('/state')).json(); } catch(e){ return; }
  if (!state || !state.camera) return;
  const t = state.tree ?
    `tree ${state.tree.capacity}/${state.tree.max_capacity} chunks, ` +
    `${state.tree.data_format}` : 'no tree';
  document.getElementById('stats').textContent =
    `backend: ${state.backend}\\nfps: ${state.fps}  frame #${state.gen}` +
    `\\n${t}${state.model ? ', model loaded' : ''}` +
    `\\n${state.camera.width}x${state.camera.height}`;
  document.getElementById('center').textContent = fmt3(state.camera.center);
  document.getElementById('origin').textContent = fmt3(state.camera.origin);
  document.getElementById('wu').textContent = fmt3(state.camera.v_world_up);
  if (document.activeElement &&
      (document.activeElement.dataset.opt ||
       document.activeElement.dataset.cam ||
       document.activeElement.dataset.viewer)) return;
  for (const el of document.querySelectorAll('[data-opt]')){
    let v = state.options[el.dataset.opt];
    if (el.dataset.idx !== undefined) v = v[+el.dataset.idx];
    if (el.type === 'checkbox') el.checked = !!v;
    else el.value = v;
  }
  for (const el of document.querySelectorAll('[data-cam]'))
    el.value = state.camera[el.dataset.cam];
  for (const el of document.querySelectorAll('[data-viewer]')){
    const v = state.viewer[el.dataset.viewer];
    if (el.type === 'checkbox') el.checked = !!v; else el.value = v;
  }
  if (state.error) document.getElementById('err').textContent = state.error;
}

// ---- build bbox / rot sliders ----
(function(){
  const bb = document.getElementById('bbox');
  ['bb_min x','bb_min y','bb_min z','bb_max x','bb_max y','bb_max z']
  .forEach((name, i) => {
    bb.insertAdjacentHTML('beforeend',
     `<label><span class="k">${name}</span>
      <input type="range" min="0" max="1" step="0.01"
       data-opt="render_bbox" data-idx="${i}">
      <input type="number" class="vec" step="any"
       data-opt="render_bbox" data-idx="${i}"></label>`);
  });
  const rot = document.getElementById('rot');
  ['viewdir x','viewdir y','viewdir z'].forEach((name, i) => {
    rot.insertAdjacentHTML('beforeend',
     `<label><span class="k">${name}</span>
      <input type="range" min="-0.785" max="0.785" step="0.01"
       data-opt="rot_dirs" data-idx="${i}">
      <input type="number" class="vec" step="any"
       data-opt="rot_dirs" data-idx="${i}"></label>`);
  });
})();

// ---- panel edits → events ----
document.getElementById('panel').addEventListener('change', e => {
  const el = e.target;
  if (el.dataset.opt){
    const f = el.dataset.opt;
    let v = el.type === 'checkbox' ? el.checked : +el.value;
    if (el.dataset.idx !== undefined){
      const cur = [...state.options[f]];
      cur[+el.dataset.idx] = v;
      v = cur;
    }
    post({t:'options', [f]: v});
  } else if (el.dataset.cam){
    post({t:'camera', [el.dataset.cam]: +el.value});
  } else if (el.dataset.viewer){
    const v = el.type === 'checkbox' ? el.checked :
              el.tagName === 'SELECT' ? el.value : +el.value;
    post({t:'viewer', [el.dataset.viewer]: v});
  }
});

// ---- mouse: left orbit, right orbit-about-origin, middle/shift pan ----
let dragging = false;
function evxy(e){
  const r = img.getBoundingClientRect();
  const sx = (state ? state.camera.width : img.width) / r.width;
  const sy = (state ? state.camera.height : img.height) / r.height;
  return {x: (e.clientX - r.left) * sx, y: (e.clientY - r.top) * sy};
}
img.addEventListener('contextmenu', e => e.preventDefault());
img.addEventListener('pointerdown', e => {
  e.preventDefault();
  img.setPointerCapture(e.pointerId);
  dragging = true;
  const p = evxy(e);
  const btn = e.button === 2 ? 'right' : e.button === 1 ? 'middle' : 'left';
  post({t:'mouse', button:btn, pressed:true, x:p.x, y:p.y,
        shift:e.shiftKey});
});
img.addEventListener('pointermove', e => {
  if (!dragging) return;
  const p = evxy(e);
  post({t:'cursor', x:p.x, y:p.y});
});
img.addEventListener('pointerup', e => {
  if (!dragging) return;
  dragging = false;
  const p = evxy(e);
  post({t:'mouse', button:'left', pressed:false, x:p.x, y:p.y});
});
img.addEventListener('wheel', e => {
  e.preventDefault();
  post({t:'scroll', dy: e.deltaY > 0 ? -1 : 1});
}, {passive: false});

// ---- keymap (reference main.cpp:268-385) ----
window.addEventListener('keydown', e => {
  if (e.target.tagName === 'INPUT' || e.target.tagName === 'SELECT')
    return;
  const k = e.key.length === 1 ? e.key.toUpperCase() : e.key;
  if ('WASDQECMRGF-=0123456'.includes(k) && k !== ''){
    post({t:'key', key:k, shift:e.shiftKey});
    e.preventDefault();
  }
});

frameLoop();
refreshState();
</script></body></html>""").encode()
