"""The port's octree wireframe, mesh overlay and grid frame against the JAX
package's (``tests/test_wireframe_keys.py``, ``utils/wireframe.py``,
``utils/mesh.py``, ``viewer.py:_render_with_grid``).

  * ``gen_wireframe`` boxes and ``random_tree`` arrays: equal;
  * the overlay buffers (``rasterize_boxes``, ``draw_lines_cam``,
    ``Mesh.draw``): bit-equal, both being the same host numpy;
  * the grid and mesh Viewer frames: within 1e-5 (``PIX_TOL``) on the
    sphere at sigma 20, ROADMAP's CPU tolerance; visit marks equal.
"""

import numpy as np
import pytest
import torch

import mega_nerf_viewer_tpu.n3tree as J
import mega_nerf_viewer_tpu_torch as P
from mega_nerf_viewer_tpu import Viewer as JViewer
from mega_nerf_viewer_tpu.camera import Camera as JCamera
from mega_nerf_viewer_tpu.models import MegaNeRFModel as JModel
from mega_nerf_viewer_tpu.options import RenderOptions as JOptions
from mega_nerf_viewer_tpu.utils import mesh as JM
from mega_nerf_viewer_tpu.utils import wireframe as JW
from mega_nerf_viewer_tpu_torch.utils import mesh as PM
from mega_nerf_viewer_tpu_torch.utils import wireframe as PW

from test_torch_exact import port

PIX_TOL = 1e-5
CENTER = (-1.5, 0.1, 1.4)
MODEL = dict(data_dim=4, n_clusters=4, grid_dim=(2, 2),
             min_position=(-2, -2, -2), max_position=(2, 2, 2))

_TREES = {
    "sphere2": lambda: J.sphere_tree(basis_dim=1, depth=4),
    "sphere3": lambda: J.sphere_tree(basis_dim=1, depth=3, N=3),
    "random2": lambda: J.random_tree(n_chunks=80, basis_dim=4, seed=7),
    "random3": lambda: J.random_tree(n_chunks=40, basis_dim=4, seed=5,
                                     N=3),
}


def _cams(w, h, f, center=CENTER, back=None, up=None):
    out = []
    for cls in (JCamera, P.Camera):
        cam = cls(w, h, f)
        cam.center = np.asarray(center, np.float32)
        if back is not None:
            cam.v_back = np.asarray(back, np.float32)
        if up is not None:
            cam.v_world_up = np.asarray(up, np.float32)
        cam._update()
        out.append(cam)
    np.testing.assert_array_equal(out[0].w2c, out[1].w2c)
    return out


@pytest.mark.parametrize("max_depth", [1, 4])
@pytest.mark.parametrize("name", sorted(_TREES))
def test_gen_wireframe_matches_jax(name, max_depth):
    jt = _TREES[name]()
    want = jt.gen_wireframe(max_depth)
    got = port(jt).gen_wireframe(max_depth)
    assert got.dtype == np.float32 and got.shape[1] == 6
    assert len(got) > 1
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("N", [2, 3])
def test_random_tree_arrays_equal(N):
    kw = dict(n_chunks=50, basis_dim=4, seed=11, density=2.0, N=N,
              max_capacity=64)
    jt = J.random_tree(**kw)
    pt = P.random_tree(device="cpu", **kw)
    assert pt.capacity == int(jt.capacity) and pt.N == N
    for k in ("data", "child", "parent", "sample_counts", "scale",
              "offset"):
        np.testing.assert_array_equal(getattr(pt, k).numpy(),
                                      np.asarray(getattr(jt, k)))
    assert pt.data_format.format == jt.data_format.format
    assert pt.data_format.basis_dim == jt.data_format.basis_dim


# camera inside the tree's box (boxes cross the near plane), outside, and
# looking along an axis
_POSES = {
    "outside": dict(center=CENTER),
    "inside": dict(center=(0.1, 0.05, -0.1)),
    "axis": dict(center=(-3.0, 0.0, 0.0), back=(-1.0, 0.0, 0.0)),
}


@pytest.mark.parametrize("pose", sorted(_POSES))
def test_rasterize_boxes_bit_equal(pose):
    jt = J.sphere_tree(basis_dim=1, depth=4)
    boxes = jt.gen_wireframe(3)
    jcam, pcam = _cams(48, 40, 35.0, **_POSES[pose])
    jc, jd = JW.rasterize_boxes(boxes, jcam, color=(0.2, 0.5, 0.9))
    pc, pd = PW.rasterize_boxes(boxes, pcam, color=(0.2, 0.5, 0.9))
    assert (pd < 1e9).sum() > 50
    np.testing.assert_array_equal(pd, jd)
    np.testing.assert_array_equal(pc, jc)
    jc, jd = JW.grid_overlay(jt, jcam, 2)
    pc, pd = PW.grid_overlay(port(jt), pcam, 2)
    np.testing.assert_array_equal(pd, jd)
    np.testing.assert_array_equal(pc, jc)


def test_draw_lines_near_plane_clip_bit_equal(rng):
    """Segments that cross the near plane, lie behind it or in front of
    it (``test_wireframe_keys.py::test_near_plane_clipping``)."""
    jcam, pcam = _cams(64, 64, 40.0)
    p0 = rng.uniform(-1.5, 1.5, (200, 3)).astype(np.float32)
    p1 = rng.uniform(-1.5, 1.5, (200, 3)).astype(np.float32)
    p0[:, 2] -= 1.0                    # mostly ahead of the camera
    col = np.array([1.0, 0.25, 0.0], np.float32)
    bufs = []
    for cam, mod in ((jcam, JW), (pcam, PW)):
        c = np.zeros((64, 64, 3), np.float32)
        d = np.full((64, 64), 1e9, np.float32)
        mod.draw_lines_cam(c, d, p0, p1, cam, col)
        bufs.append((c, d))
    (jc, jd), (pc, pd) = bufs
    crossing = ((-p0[:, 2] > 1e-3) != (-p1[:, 2] > 1e-3)).sum()
    assert crossing > 10 and (pd < 1e9).sum() > 100
    np.testing.assert_array_equal(pd, jd)
    np.testing.assert_array_equal(pc, jc)


def _mesh_verts(rng, n, near_cross):
    pos = rng.uniform(-0.6, 0.6, (n, 3))
    pos[:, 2] = rng.uniform(-2.5, -0.5, n)
    if near_cross:
        pos[::3, 2] = rng.uniform(0.05, 0.5, len(pos[::3]))
    col = rng.uniform(0.1, 1.0, (n, 3))
    nrm = rng.normal(size=(n, 3))
    return np.concatenate([pos, col, nrm], 1).astype(np.float32)


@pytest.mark.parametrize("face_size,unlit,near_cross", [
    (3, False, False), (3, False, True), (3, True, True), (2, False, True),
    (1, False, False)])
def test_mesh_draw_bit_equal(rng, face_size, unlit, near_cross):
    """``Mesh.draw``: Phong shading, the Sutherland-Hodgman near clip and
    the barycentric raster, lines and points; a model transform with a
    rotation, translation and scale."""
    jcam, pcam = _cams(56, 44, 40.0, center=(0.0, 0.0, 0.0),
                       back=(0.0, 0.0, 1.0), up=(0.0, 1.0, 0.0))
    verts = _mesh_verts(rng, 12 * face_size if face_size > 1 else 300,
                        near_cross)
    kw = dict(vert=verts, face_size=face_size, unlit=unlit,
              rotation=np.array([0.1, -0.2, 0.05], np.float32),
              translation=np.array([0.05, 0.0, -0.1], np.float32),
              scale=1.1)
    base_c = rng.uniform(0, 1, (44, 56, 3)).astype(np.float32)
    base_d = np.full((44, 56), 1.6, np.float32)
    (jc, jd), (pc, pd) = [
        mod.Mesh(**kw).draw(cam, base_c.copy(), base_d.copy())
        for mod, cam in ((JM, jcam), (PM, pcam))]
    assert (pd < 1.6).sum() > 5
    np.testing.assert_array_equal(PM.Mesh(**kw).transform(),
                                  JM.Mesh(**kw).transform())
    np.testing.assert_array_equal(pd, jd)
    np.testing.assert_array_equal(pc, jc)


def _cube_mesh(mod, center, half=0.15, color=(0.9, 0.2, 0.1)):
    """A cube's 12 triangles around ``center``, one colour."""
    c = np.asarray(center, np.float64)
    corners = np.array([[x, y, z] for x in (-1, 1) for y in (-1, 1)
                        for z in (-1, 1)], np.float64) * half + c
    quads = [(0, 1, 3, 2), (4, 6, 7, 5), (0, 4, 5, 1), (2, 3, 7, 6),
             (0, 2, 6, 4), (1, 5, 7, 3)]
    verts = []
    for q in quads:
        n = np.cross(corners[q[1]] - corners[q[0]],
                     corners[q[2]] - corners[q[0]])
        n = n / np.linalg.norm(n)
        for tri in ((q[0], q[1], q[2]), (q[0], q[2], q[3])):
            for i in tri:
                verts.append(np.concatenate([corners[i], color, n]))
    return mod.Mesh(vert=np.asarray(verts, np.float32), face_size=3)


def _grid_pair(w=24, h=20, f=22.0, model=False, max_cap=None, **opt_kw):
    jt = J.sphere_tree(basis_dim=4, depth=4, max_capacity=max_cap)
    jcam, pcam = _cams(w, h, f)
    kw = {} if max_cap is None else dict(max_tree_capacity=max_cap)
    jv = JViewer(jt, camera=jcam, options=JOptions(**opt_kw), **kw)
    pv = P.Viewer(port(jt), camera=pcam, options=P.RenderOptions(**opt_kw),
                  device="cpu", **kw)
    if model:
        jv.model = JModel.synthetic(**MODEL)
        pv.model = P.MegaNeRFModel.synthetic(device="cpu", **MODEL)
    return jv, pv


def _frames(jv, pv):
    a = np.asarray(jv.render())
    b = pv.render()
    assert b.shape == a.shape and np.isfinite(b).all()
    return a, b


@pytest.mark.parametrize("grid_max_depth,bg", [(2, 1.0), (4, 0.25)])
def test_grid_frame_matches_jax(grid_max_depth, bg):
    jv, pv = _grid_pair(show_grid=True, grid_max_depth=grid_max_depth,
                        background_brightness=bg)
    a, b = _frames(jv, pv)
    np.testing.assert_allclose(b, a, rtol=0, atol=PIX_TOL)
    # the lines darken the background: the overlay took part
    jv.options = jv.options.replace(show_grid=False)
    pv.options = pv.options.replace(show_grid=False)
    a0, b0 = _frames(jv, pv)
    np.testing.assert_allclose(b0, a0, rtol=0, atol=PIX_TOL)
    assert (np.abs(b - b0) > 0.1).any()


def test_mesh_frame_matches_jax():
    """A cube of 12 triangles in front of the sphere, with and without the
    grid: the mesh bounds the march and colours the background."""
    jv, pv = _grid_pair(background_brightness=0.5)
    a0, b0 = _frames(jv, pv)
    center = jv.camera.center - 0.9 * jv.camera.v_back
    jv.meshes.append(_cube_mesh(JM, center))
    pv.meshes.append(_cube_mesh(PM, center))
    a, b = _frames(jv, pv)
    np.testing.assert_allclose(b, a, rtol=0, atol=PIX_TOL)
    assert (np.abs(b - b0) > 0.1).any()
    for v in (jv, pv):
        v.options = v.options.replace(show_grid=True, grid_max_depth=3)
    a, b = _frames(jv, pv)
    np.testing.assert_allclose(b, a, rtol=0, atol=PIX_TOL)


def test_grid_cache_and_keys():
    """The overlay is drawn once per (grid depth, tree generation, camera)
    and the G and F keys move the grid depth as in the JAX viewer."""
    jv, pv = _grid_pair(show_grid=True, grid_max_depth=2)
    calls = []
    wire = P.N3Tree.gen_wireframe

    def counted(self, *a, **kw):
        calls.append(1)
        return wire(self, *a, **kw)

    P.N3Tree.gen_wireframe = counted
    try:
        first = pv.render()
        cache = pv._grid_cache
        np.testing.assert_array_equal(pv.render(), first)
        assert pv._grid_cache is cache and len(calls) == 1
        for key in ("G", "G", "F"):
            jv.key_event(key)
            pv.key_event(key)
            assert pv.options.grid_max_depth == jv.options.grid_max_depth
            a, b = _frames(jv, pv)
            np.testing.assert_allclose(b, a, rtol=0, atol=PIX_TOL)
        assert pv.options.grid_max_depth == 3 and len(calls) == 4
        pv.set(pv.tree)                        # a new tree generation
        pv.render()
        assert len(calls) == 5
        for v in (jv, pv):
            v.key_event("D")                   # the camera moves
        a, b = _frames(jv, pv)
        np.testing.assert_allclose(b, a, rtol=0, atol=PIX_TOL)
        assert len(calls) == 6
    finally:
        P.N3Tree.gen_wireframe = wire


def test_grid_frame_tracks_visits():
    """Under capacity pressure the grid frame is an exact march with visit
    marks (kernel E's marks on the card), as in JAX."""
    jv, pv = _grid_pair(model=True, max_cap=240, show_grid=True,
                        grid_max_depth=3, split_batch_size=64)
    assert pv.max_tree_capacity - pv.tree.capacity < 64
    jimg, jres = jv._render_with_grid(True)
    pimg, pres = pv._render_with_grid(True)
    np.testing.assert_allclose(pimg.numpy(), np.asarray(jimg), rtol=0,
                               atol=PIX_TOL)
    np.testing.assert_array_equal(pres.visited.numpy(),
                                  np.asarray(jres.visited))
    assert int(pres.visited.sum()) > 1
    # through render(): the tracked frame feeds the visit tracker
    a, b = _frames(jv, pv)
    np.testing.assert_allclose(b, a, rtol=0, atol=PIX_TOL)
    assert pv._visits_valid == jv._visits_valid
    assert torch.equal(pv._visit_tracker.cpu(),
                       torch.as_tensor(np.array(jv._visit_tracker)))
