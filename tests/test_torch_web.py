"""The port's browser viewer (``mega_nerf_viewer_tpu_torch.web``): the cases
of ``tests/test_web.py`` against a live server over a port Viewer on the
CPU, plus:

  * served frames within 1 rgba8 level of the JAX Viewer's
    ``render_rgba8`` at the same pose (the JAX Viewer renders on the test's
    main thread, never on the server's render thread);
  * JAX's viewer knobs (``web.py:81-84``) reach the port's Viewer, and a
    knob neither package has answers as unknown;
  * a grid frame and a foveated frame rendered through the server;
  * ``cli --serve 0`` in a subprocess.
"""

import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

import mega_nerf_viewer_tpu.n3tree as J
import mega_nerf_viewer_tpu_torch as P
from mega_nerf_viewer_tpu import Viewer as JViewer
from mega_nerf_viewer_tpu.camera import Camera as JCamera
from mega_nerf_viewer_tpu_torch.utils.png import decode_png
from mega_nerf_viewer_tpu_torch.web import WebViewer

from test_torch_exact import port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CENTER = (-1.5, 0.1, 1.4)


def _jtree():
    return J.sphere_tree(basis_dim=1, depth=3, max_capacity=3000)


@pytest.fixture(scope="module")
def server():
    cam = P.Camera(16, 16, 20.0)
    cam.center = np.array(CENTER, np.float32)
    viewer = P.Viewer(port(_jtree()), camera=cam,
                      options=P.RenderOptions(), max_tree_capacity=3000,
                      device="cpu")
    wv = WebViewer(viewer, port=0)
    port_no = wv.start()
    yield wv, f"http://127.0.0.1:{port_no}"
    wv.stop()


def _get(url, timeout=60):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.status, dict(r.headers), r.read()


def _post(url, payload, timeout=60):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _state(base):
    return json.loads(_get(base + "/state")[2])


def _latest_raw(base):
    """The newest served frame as rgba8 and the state it was drawn at."""
    s = _state(base)
    status, hdrs, raw = _get(f"{base}/frame.bin?after={s['gen'] - 1}")
    assert status == 200 and int(hdrs["X-Gen"]) == s["gen"]
    w, h = int(hdrs["X-Width"]), int(hdrs["X-Height"])
    return np.frombuffer(raw, np.uint8).reshape(h, w, 4), s


def _jax_rgba8(state, **viewer_kw):
    """The JAX Viewer's rgba8 frame at the served pose and options, on
    this (the main) thread."""
    c = state["camera"]
    cam = JCamera(c["width"], c["height"], c["fx"], c["fy"], c["cx"],
                  c["cy"])
    for k in ("center", "origin", "v_back", "v_world_up"):
        setattr(cam, k, np.asarray(c[k], np.float32))
    from mega_nerf_viewer_tpu.options import RenderOptions as JOptions
    o = dict(state["options"])
    for k in ("render_bbox", "basis_minmax", "rot_dirs"):
        o[k] = tuple(o[k])
    jv = JViewer(_jtree(), camera=cam, options=JOptions(**o),
                 max_tree_capacity=3000)
    for k, val in viewer_kw.items():
        setattr(jv, k, val)
    jv.render_rgba8()
    return jv.render_rgba8()


def _close(a, b):
    assert a.shape == b.shape
    diff = np.abs(a.astype(np.int16) - b.astype(np.int16))
    assert int(diff.max()) <= 1, int(diff.max())


def test_index_page(server):
    _, base = server
    status, headers, body = _get(base + "/")
    assert status == 200
    assert b"mega-nerf-viewer-tpu" in body
    assert b"<summary>Execution</summary>" in body
    assert b"use_prepass" in body and b"use_fast_path" in body
    assert b"TPU" not in body
    assert "text/html" in headers["Content-Type"]


def test_first_frame_long_poll(server):
    _, base = server
    status, headers, body = _get(base + "/frame?after=-1")
    assert status == 200
    assert int(headers["X-Gen"]) >= 1
    img = decode_png(body)
    assert img.shape == (16, 16, 4)
    assert img[..., 3].max() > 128          # sphere visible


def test_served_frames_match_jax(server):
    """The parked frame and a frame after a right-button drag: within 1
    rgba8 level of the JAX Viewer's at the same pose."""
    _, base = server
    _get(base + "/frame?after=-1")
    img, s = _latest_raw(base)
    _close(img, _jax_rgba8(s))
    status, res = _post(base + "/event", [
        {"t": "mouse", "button": "right", "pressed": True, "x": 8.0,
         "y": 8.0},
        {"t": "cursor", "x": 11.0, "y": 9.0},
        {"t": "mouse", "button": "right", "pressed": False, "x": 11.0,
         "y": 9.0}])
    assert status == 200 and res["applied"] and not res["error"]
    img, s2 = _latest_raw(base)
    assert s2["camera"]["center"] != s["camera"]["center"]
    _close(img, _jax_rgba8(s2))


def test_raw_frame_endpoint_matches_png(server):
    _, base = server
    status, hdrs, png = _get(base + "/frame?after=-1")
    assert status == 200
    gen = int(hdrs["X-Gen"])
    status, hdrs, raw = _get(base + f"/frame.bin?after={gen - 1}")
    assert status == 200
    w, h = int(hdrs["X-Width"]), int(hdrs["X-Height"])
    assert int(hdrs["X-Gen"]) >= gen
    img = np.frombuffer(raw, np.uint8).reshape(h, w, 4)
    if int(hdrs["X-Gen"]) == gen:       # no interleaved render: exact
        np.testing.assert_array_equal(img, decode_png(png))
    g = _state(base)["gen"]
    status, hdrs, body = _get(f"{base}/frame.bin?after={g}&timeout=0.2")
    assert status == 204 and body == b""


def test_concurrent_pollers_and_events(server):
    """Four threads long-poll /frame and /frame.bin while key events
    fire: generations stay monotone per poller, every PNG decodes, raw
    sizes match their headers."""
    _, base = server
    stop = threading.Event()
    errors = []

    def poll(path):
        gen, seen = -1, 0
        try:
            while not stop.is_set() and seen < 6:
                status, hdrs, body = _get(
                    f"{base}{path}?after={gen}&timeout=2")
                if status == 204:
                    continue
                new_gen = int(hdrs["X-Gen"])
                assert new_gen > gen, (path, gen, new_gen)
                gen = new_gen
                if path == "/frame":
                    decode_png(body)
                else:
                    w, h = int(hdrs["X-Width"]), int(hdrs["X-Height"])
                    assert len(body) == w * h * 4
                seen += 1
        except Exception as e:               # pragma: no cover
            errors.append((path, repr(e)))

    threads = [threading.Thread(target=poll, args=(p,))
               for p in ("/frame", "/frame.bin", "/frame", "/frame.bin")]
    for t in threads:
        t.start()
    try:
        for k in "WSWSWSWS":
            status, _ = _post(base + "/event", {"t": "key", "key": k})
            assert status == 200
        time.sleep(1.0)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=60)
    assert not errors, errors
    assert not any(t.is_alive() for t in threads)


def test_frame_poll_times_out_when_static(server):
    _, base = server
    gen = _state(base)["gen"]
    status, _, body = _get(f"{base}/frame?after={gen}&timeout=0.2")
    assert status == 204 and body == b""


def test_state_contents(server):
    _, base = server
    s = _state(base)
    assert s["backend"] == "CPU"
    assert s["tree"]["capacity"] > 0
    assert s["tree"]["max_capacity"] == 3000
    assert s["camera"]["width"] == 16
    assert s["options"]["step_size"] == pytest.approx(1e-4)
    assert s["viewer"] == {
        "use_fast_path": True, "use_dynamic_knobs": True,
        "use_turbo_map": False, "use_prepass": True,
        "use_device_order": True, "foveation": 1, "overflow_policy": "sync",
        "host_unpermute": False, "motion_mode": "rehint",
        "motion_flag_interval": 4}


def test_key_event_moves_camera(server):
    _, base = server
    c0 = _state(base)["camera"]["center"]
    status, res = _post(base + "/event", {"t": "key", "key": "W"})
    assert status == 200 and res["applied"] and not res["error"]
    assert _state(base)["camera"]["center"] != c0


def test_event_renders_new_frame(server):
    _, base = server
    gen0 = _state(base)["gen"]
    _post(base + "/event", {"t": "key", "key": "S"})
    status, headers, body = _get(f"{base}/frame?after={gen0}")
    assert status == 200 and int(headers["X-Gen"]) > gen0
    decode_png(body)


def test_mouse_drag_orbits(server):
    _, base = server
    c0 = np.asarray(_state(base)["camera"]["center"])
    status, res = _post(base + "/event", [
        {"t": "mouse", "button": "right", "pressed": True, "x": 8.0,
         "y": 8.0},
        {"t": "cursor", "x": 10.0, "y": 8.0},
        {"t": "mouse", "button": "right", "pressed": False, "x": 10.0,
         "y": 8.0}])
    assert status == 200 and res["applied"]
    s = _state(base)
    c1 = np.asarray(s["camera"]["center"])
    o = np.asarray(s["camera"]["origin"])
    assert not np.allclose(c0, c1)
    assert np.linalg.norm(c0 - o) == pytest.approx(
        np.linalg.norm(c1 - o), rel=1e-4)


def test_scroll_zooms(server):
    _, base = server
    c0 = np.asarray(_state(base)["camera"]["center"])
    _post(base + "/event", {"t": "scroll", "dy": 1})
    assert not np.allclose(c0, np.asarray(_state(base)["camera"]["center"]))


def test_options_roundtrip_renders_the_grid(server):
    """An ``options`` edit to ``show_grid`` renders the grid frame (the
    lines darken the white background)."""
    _, base = server
    _post(base + "/event", {"t": "options", "background_brightness": 1.0})
    plain, _ = _latest_raw(base)
    status, res = _post(base + "/event", {
        "t": "options", "render_bbox": [0.1, 0.0, 0.0, 1.0, 1.0, 0.9],
        "show_grid": True, "grid_max_depth": 2})
    assert status == 200 and not res["error"]
    s = _state(base)
    assert s["options"]["render_bbox"][0] == pytest.approx(0.1)
    assert s["options"]["show_grid"] is True
    grid, s = _latest_raw(base)
    assert (grid[..., :3].astype(int) < plain[..., :3].astype(int) - 40).any()
    _close(grid, _jax_rgba8(s))
    _post(base + "/event", {"t": "options", "background_brightness": 0.0,
                            "render_bbox": [0, 0, 0, 1, 1, 1],
                            "show_grid": False})


def test_camera_edit_normalizes_dirs(server):
    _, base = server
    status, res = _post(base + "/event",
                        {"t": "camera", "v_world_up": [0, 0, 5]})
    assert status == 200 and not res["error"]
    assert _state(base)["camera"]["v_world_up"] == [0.0, 0.0, 1.0]


def test_viewer_knob_roundtrip_renders_foveated(server):
    """A ``viewer`` edit to ``foveation`` 2 renders the foveated frame,
    as the JAX Viewer does at that pose."""
    wv, base = server
    status, res = _post(base + "/event", {
        "t": "viewer", "overflow_policy": "async", "foveation": 2,
        "motion_mode": "dilate", "motion_flag_interval": 8})
    assert status == 200 and not res["error"]
    s = _state(base)["viewer"]
    assert s["overflow_policy"] == "async" and s["foveation"] == 2
    assert s["motion_mode"] == "dilate" and s["motion_flag_interval"] == 8
    _post(base + "/event", {"t": "render"})
    img, s = _latest_raw(base)
    assert wv.viewer._fov_sub is not None
    _close(img, _jax_rgba8(s, foveation=2, overflow_policy="async"))
    _post(base + "/event", {"t": "viewer", "overflow_policy": "sync",
                            "foveation": 1, "motion_mode": "rehint",
                            "motion_flag_interval": 4})


@pytest.mark.parametrize("knob,known", [
    ("use_fast_path", True), ("use_dynamic_knobs", True),
    ("use_prepass", True), ("use_device_order", True),
    ("use_hyperdrive", False)])
def test_absent_knobs_are_unknown(server, knob, known):
    """The JAX knobs the port's Viewer once left out now reach it: set to
    False over ``POST /event``, the state reads it back and the next render
    succeeds.  A knob neither Viewer has still answers 500."""
    wv, base = server
    status, res = _post(base + "/event", {"t": "viewer", knob: False})
    if not known:
        assert status == 500 and "unknown viewer knob" in res["error"]
        assert knob in res["error"] and not hasattr(wv.viewer, knob)
    else:
        assert status == 200 and not res["error"]
        assert _state(base)["viewer"][knob] is False
    try:
        status, res = _post(base + "/event", {"t": "render"})
        assert status == 200 and not res["error"]
        if known:
            assert getattr(wv.viewer, knob) is False
            img, _ = _latest_raw(base)
            assert img[..., 3].max() > 128
    finally:
        if known:
            _post(base + "/event", {"t": "viewer", knob: True})


def test_bad_event_reports_error(server):
    _, base = server
    status, res = _post(base + "/event", {"t": "options", "nope": 1})
    assert status == 500 and "nope" in res["error"]
    status, res = _post(base + "/event", {"t": "render"})
    assert status == 200 and not res["error"]


def test_bad_json_is_400(server):
    _, base = server
    req = urllib.request.Request(
        base + "/event", data=b"{not json",
        headers={"Content-Type": "application/json"})
    with pytest.raises(urllib.error.HTTPError) as exc:
        urllib.request.urlopen(req, timeout=30)
    assert exc.value.code == 400


def test_screenshot_endpoints(server, tmp_path):
    _, base = server
    status, headers, body = _get(base + "/screenshot.png")
    assert status == 200
    assert "attachment" in headers["Content-Disposition"]
    img = decode_png(body)
    path = str(tmp_path / "shot.png")
    status, res = _post(base + "/event", {"t": "screenshot", "path": path})
    assert status == 200 and os.path.exists(path)
    assert decode_png(open(path, "rb").read()).shape == img.shape


def test_resize(server):
    _, base = server
    _post(base + "/event", {"t": "resize", "width": 20, "height": 12})
    s = _state(base)
    assert (s["camera"]["width"], s["camera"]["height"]) == (20, 12)
    _, _, body = _get(f"{base}/frame?after={s['gen'] - 1}")
    assert decode_png(body).shape == (12, 20, 4)
    _post(base + "/event", {"t": "resize", "width": 16, "height": 16})


def test_open_tree_event(server, tmp_path):
    wv, base = server
    old = wv.viewer.tree
    path = str(tmp_path / "tree.npz")
    P.sphere_tree(basis_dim=1, depth=2, max_capacity=100,
                  device="cpu").save_npz(path)
    status, res = _post(base + "/event", {"t": "open", "path": path,
                                          "max_capacity": 100})
    assert status == 200 and not res["error"]
    assert _state(base)["tree"]["max_capacity"] == 100
    assert wv.viewer.tree.device.type == "cpu"
    status, res = _post(base + "/event",
                        {"t": "open", "path": "/nonexistent.npz"})
    assert status == 500 and res["error"]
    assert _state(base)["tree"] is not None
    wv.submit({"t": "render"})
    # the later cases compare against the JAX Viewer on the first tree
    path = str(tmp_path / "first.npz")
    old.save_npz(path)
    status, res = _post(base + "/event", {"t": "open", "path": path,
                                          "max_capacity": 3000})
    assert status == 200 and not res["error"]


def test_404(server):
    _, base = server
    with pytest.raises(urllib.error.HTTPError) as exc:
        urllib.request.urlopen(base + "/bogus", timeout=30)
    assert exc.value.code == 404


def test_unknown_event_type(server):
    _, base = server
    status, res = _post(base + "/event", {"t": "teleport"})
    assert status == 500 and "teleport" in res["error"]


def test_sorted_delivery_through_server(server):
    """``host_unpermute`` over the event API keeps served frames equal:
    the render thread applies the index map on the host."""
    _, base = server
    _, _, ref = _get(base + "/frame?after=-1")
    _post(base + "/event", {"t": "render"})
    _, _, ref = _get(base + f"/frame?after={_state(base)['gen'] - 1}")
    _post(base + "/event", {"t": "viewer", "host_unpermute": True})
    assert _state(base)["viewer"]["host_unpermute"] is True
    _post(base + "/event", {"t": "render"})
    status, _, png = _get(base + f"/frame?after={_state(base)['gen'] - 1}")
    assert status == 200
    np.testing.assert_array_equal(decode_png(png), decode_png(ref))
    _post(base + "/event", {"t": "viewer", "host_unpermute": False})


def test_cli_serve_subprocess(tmp_path):
    """``cli --serve 0`` prints the port it bound; ``GET /state`` answers;
    the process is terminated."""
    path = str(tmp_path / "t.npz")
    P.sphere_tree(basis_dim=1, depth=2, device="cpu").save_npz(path)
    proc = subprocess.Popen(
        [sys.executable, "-m", "mega_nerf_viewer_tpu_torch.cli", path,
         "--device", "cpu", "-w", "16", "--height", "16", "--fx", "20",
         "--center=-1.5,0.1,1.4", "--serve", "0"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    try:
        line = ""
        deadline = time.monotonic() + 120
        while "Serving" not in line and time.monotonic() < deadline:
            line = proc.stdout.readline()
            assert line or proc.poll() is None, "cli exited"
        assert "Serving interactive viewer at http://127.0.0.1:" in line
        url = line.split()[4].rstrip("/")
        assert int(url.rsplit(":", 1)[1]) > 0
        _get(url + "/frame?after=-1")
        s = _state(url)
        assert s["backend"] == "CPU" and s["camera"]["width"] == 16
    finally:
        proc.terminate()
        proc.wait(timeout=60)
