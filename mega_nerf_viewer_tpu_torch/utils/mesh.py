"""Headless mesh overlay: triangles / lines / points with the reference
shader's lighting (a copy of ``mega_nerf_viewer_tpu/utils/mesh.py``: host
numpy, so the buffers are bit-equal to the JAX package's).

Software-rasterized equivalent of the reference GL mesh layer
(``src/mesh.cpp:14-166``, ``include/mesh.hpp:10-40``,
``include/shader.hpp:34-70``): a :class:`Mesh` carries the same state
(9-float vertex layout [position, color, normal], index faces, axis-angle
``rotation`` + ``translation`` + uniform ``scale`` model transform,
``face_size`` in {1, 2, 3}, ``visible``, ``unlit``) and ``draw`` renders
into (color [H, W, 3], depth [H, W]) overlay buffers the volume renderer
composites against — depth is ``length(FragPos.xyz)`` exactly like the
reference's second render target (mesh.cpp frag shader ``Depth``).

Lighting replicates the embedded GLSL (mesh.cpp:53-72): ambient 0.3 +
0.7 * lambert(light (0.5, 0.2, 1)) + 0.2 * lambert(light
(-0.5, -1, -0.5)) + 0.6 * specular(reflect, view)^32, all scaling the
interpolated vertex color; ``unlit`` bypasses shading.  Attributes are
interpolated perspective-correctly (GL varying semantics); triangles
crossing the near plane are clipped in camera space.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from .wireframe import draw_lines_cam, _Z_NEAR


@dataclasses.dataclass
class Mesh:
    vert: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0, 9), np.float32))
    faces: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0,), np.int64))
    rotation: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3, np.float32))   # axis-angle
    translation: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3, np.float32))
    scale: float = 1.0
    face_size: int = 3
    visible: bool = True
    unlit: bool = False

    # ------------------------------------------------------------------
    def update(self) -> "Mesh":
        """Normalize buffers (the GL upload step, mesh.cpp:110-133)."""
        self.vert = np.asarray(self.vert, np.float32).reshape(-1, 9)
        self.faces = np.asarray(self.faces, np.int64).reshape(-1)
        return self

    def transform(self) -> np.ndarray:
        """Model matrix: axis-angle rotation * scale, translation column
        (mesh.cpp:137-150 incl. the <1e-3 identity fallback)."""
        aa = np.asarray(self.rotation, np.float64)
        norm = np.linalg.norm(aa)
        if norm < 1e-3:
            R = np.eye(3)
        else:
            k = aa / norm
            K = np.array([[0, -k[2], k[1]],
                          [k[2], 0, -k[0]],
                          [-k[1], k[0], 0]])
            R = np.eye(3) + np.sin(norm) * K + (1 - np.cos(norm)) * K @ K
        M = np.eye(4)
        M[:3, :3] = R * self.scale
        M[:3, 3] = self.translation
        return M.astype(np.float32)

    # ------------------------------------------------------------------
    def draw(self, camera,
             color_buf: Optional[np.ndarray] = None,
             depth_buf: Optional[np.ndarray] = None
             ) -> Tuple[np.ndarray, np.ndarray]:
        """Rasterize into (and return) the overlay buffers."""
        h, w = camera.height, camera.width
        if color_buf is None:
            color_buf = np.zeros((h, w, 3), np.float32)
        if depth_buf is None:
            depth_buf = np.full((h, w), 1e9, np.float32)
        if not self.visible or len(self.vert) == 0:
            return color_buf, depth_buf
        self.update()
        M = self.transform()
        w2c = camera.w2c
        pos_w = self.vert[:, :3] @ M[:3, :3].T + M[:3, 3]
        cam_pts = pos_w @ w2c[:3, :3].T + w2c[:3, 3]
        nrm_w = self.vert[:, 6:9] @ M[:3, :3].T
        nn = np.linalg.norm(nrm_w, axis=-1, keepdims=True)
        nrm_w = nrm_w / np.maximum(nn, 1e-12)
        # world camera position (mesh.cpp:146: -V^T * V[3])
        cam_pos = -(w2c[:3, :3].T @ w2c[:3, 3])

        if self.face_size == 3:
            idx = self.faces.reshape(-1, 3) if len(self.faces) else \
                np.arange(len(self.vert)).reshape(-1, 3)
            for tri in idx:
                self._raster_triangle(camera, color_buf, depth_buf,
                                      cam_pts[tri], pos_w[tri],
                                      self.vert[tri, 3:6], nrm_w[tri],
                                      cam_pos)
        elif self.face_size == 2:
            idx = self.faces.reshape(-1, 2) if len(self.faces) else \
                np.arange(len(self.vert)).reshape(-1, 2)
            # lines use the first vertex's color (flat, like the wire grid)
            cols = self.vert[idx[:, 0], 3:6]
            for c in np.unique(cols, axis=0):
                sel = (cols == c).all(-1)
                draw_lines_cam(color_buf, depth_buf,
                               cam_pts[idx[sel, 0]], cam_pts[idx[sel, 1]],
                               camera, c)
        else:                                     # GL_POINTS
            z = -cam_pts[:, 2]
            vis = z > _Z_NEAR
            px = np.round(camera.cx
                          + camera.fx * cam_pts[vis, 0] / z[vis])
            py = np.round(camera.cy
                          - camera.fy * cam_pts[vis, 1] / z[vis])
            d = np.linalg.norm(cam_pts[vis], axis=-1).astype(np.float32)
            ok = (px >= 0) & (px < w) & (py >= 0) & (py < h)
            xs = px[ok].astype(np.int64)
            ys = py[ok].astype(np.int64)
            ds = d[ok]
            col = self._shade(pos_w[vis][ok], self.vert[vis][ok][:, 3:6],
                              nrm_w[vis][ok], cam_pts[vis][ok], cam_pos)
            np.minimum.at(depth_buf, (ys, xs), ds)
            won = ds <= depth_buf[ys, xs]
            color_buf[ys[won], xs[won]] = col[won]
        return color_buf, depth_buf

    # ------------------------------------------------------------------
    def _shade(self, pos_w, vcol, nrm, frag_cam, cam_pos):
        """The embedded GLSL lighting (mesh.cpp:53-72), vectorized."""
        if self.unlit:
            return vcol
        l1 = np.array([0.5, 0.2, 1.0])
        l1 = l1 / np.linalg.norm(l1)
        l2 = np.array([-0.5, -1.0, -0.5])
        l2 = l2 / np.linalg.norm(l2)
        ambient = 0.3
        diffuse = 0.7 * np.maximum(nrm @ l1, 0.0)
        diffuse2 = 0.2 * np.maximum(nrm @ l2, 0.0)
        view = cam_pos[None, :] - pos_w
        view = view / np.maximum(
            np.linalg.norm(view, axis=-1, keepdims=True), 1e-12)
        refl = 2.0 * (nrm @ l1)[:, None] * nrm - l1[None, :]
        spec = 0.6 * np.maximum(
            (view * refl).sum(-1), 0.0) ** 32
        k = (ambient + diffuse + diffuse2 + spec)[:, None]
        return (k * vcol).astype(np.float32)

    def _raster_triangle(self, camera, color_buf, depth_buf, cp, pw,
                         vc, nm, cam_pos):
        """One camera-space triangle, near-clipped (Sutherland-Hodgman)
        then barycentric-rasterized with perspective-correct varyings."""
        h, w = depth_buf.shape
        # clip polygon against z >= _Z_NEAR (z = -cam_z)
        poly = []          # (cam_pt, pos_w, color, normal)
        attrs = list(zip(cp, pw, vc, nm))
        for i in range(3):
            a = attrs[i]
            b = attrs[(i + 1) % 3]
            za, zb = -a[0][2], -b[0][2]
            ain, bin_ = za > _Z_NEAR, zb > _Z_NEAR
            if ain:
                poly.append(a)
            if ain != bin_:
                t = (float(_Z_NEAR) - za) / (zb - za)
                poly.append(tuple(x + (y - x) * t for x, y in zip(a, b)))
        if len(poly) < 3:
            return
        for k in range(1, len(poly) - 1):
            self._raster_clipped(camera, color_buf, depth_buf,
                                 (poly[0], poly[k], poly[k + 1]), cam_pos)

    def _raster_clipped(self, camera, color_buf, depth_buf, tri, cam_pos):
        h, w = depth_buf.shape
        cp = np.stack([t[0] for t in tri])
        z = -cp[:, 2]
        px = camera.cx + camera.fx * cp[:, 0] / z
        py = camera.cy - camera.fy * cp[:, 1] / z
        x0 = max(int(np.floor(px.min())), 0)
        x1 = min(int(np.ceil(px.max())) + 1, w)
        y0 = max(int(np.floor(py.min())), 0)
        y1 = min(int(np.ceil(py.max())) + 1, h)
        if x0 >= x1 or y0 >= y1:
            return
        xs, ys = np.meshgrid(np.arange(x0, x1) + 0.5,
                             np.arange(y0, y1) + 0.5)
        d = np.stack([px, py], 1)
        det = ((d[1, 1] - d[2, 1]) * (d[0, 0] - d[2, 0])
               + (d[2, 0] - d[1, 0]) * (d[0, 1] - d[2, 1]))
        if abs(det) < 1e-12:
            return
        b0 = ((d[1, 1] - d[2, 1]) * (xs - d[2, 0])
              + (d[2, 0] - d[1, 0]) * (ys - d[2, 1])) / det
        b1 = ((d[2, 1] - d[0, 1]) * (xs - d[2, 0])
              + (d[0, 0] - d[2, 0]) * (ys - d[2, 1])) / det
        b2 = 1.0 - b0 - b1
        inside = (b0 >= 0) & (b1 >= 0) & (b2 >= 0)
        if not inside.any():
            return
        bary = np.stack([b0[inside], b1[inside], b2[inside]], -1)  # [m,3]
        # perspective-correct: weight each vertex varying by 1/z
        wz = bary / z[None, :]
        wz = wz / wz.sum(-1, keepdims=True)
        frag_cam = wz @ cp
        pos_w = wz @ np.stack([t[1] for t in tri])
        vcol = wz @ np.stack([t[2] for t in tri])
        nrm = wz @ np.stack([t[3] for t in tri])
        nrm = nrm / np.maximum(
            np.linalg.norm(nrm, axis=-1, keepdims=True), 1e-12)
        dist = np.linalg.norm(frag_cam, axis=-1).astype(np.float32)
        col = self._shade(pos_w, vcol, nrm, frag_cam, cam_pos)
        yy, xx = np.nonzero(inside)
        yy = yy + y0
        xx = xx + x0
        np.minimum.at(depth_buf, (yy, xx), dist)
        won = dist <= depth_buf[yy, xx]
        color_buf[yy[won], xx[won]] = col[won]
