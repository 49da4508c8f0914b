"""The re-hint motion frame against the JAX package
(``accel.py:1585-1785``: ``_motion_core``, ``render_frame_motion`` and
``quarter_order_from_packed``).

At stride 1 and 2, on 32x24 and 64x48 frames, after a hint frame and an
orbit step: the fresh ``perm`` and ``inv``, the ``cdf``, the quarter order
``qperm`` and ``seg_overflow`` must be EQUAL to JAX's (stable sorts on both
sides), and the pixels within 1e-5 (``test_torch_march.py`` gives the
reason).  The sphere keeps sigma at 40 or less.
"""

import numpy as np
import pytest
import torch

import mega_nerf_viewer_tpu.n3tree as J
import mega_nerf_viewer_tpu_torch as P
from mega_nerf_viewer_tpu.camera import Camera
from mega_nerf_viewer_tpu.ops import accel as JA
from mega_nerf_viewer_tpu.ops import pallas_march as JM
from mega_nerf_viewer_tpu.options import RenderOptions
from mega_nerf_viewer_tpu_torch.ops import accel as PA

from test_torch_frame import port

PIX_TOL = 1e-5
CS = 128


def _arr(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _orbit(cam, dx):
    cam.begin_drag(0.0, 0.0, False, True)
    cam.drag_update(dx, 0.0)
    cam.end_drag()
    cam._update()


@pytest.fixture(scope="module", params=[(32, 24), (64, 48)],
                ids=["32x24", "64x48"])
def episode(request):
    """Both sides' hint frame at the first pose (packed hints, pixel
    order), then the camera moved by one orbit step."""
    w, h = request.param
    jt = J.sphere_tree(basis_dim=4, depth=4)
    pt = port(jt)
    cams = []
    for cls in (Camera, P.Camera):
        cam = cls(w, h, 0.7 * w)
        cam.center = np.array([-1.5, 0.1, 1.4], np.float32)
        cam._update()
        cams.append(cam)
    s = dict(w=w, h=h, jt=jt, pt=pt, jlm=JA.build_leaf_map(jt),
             plm=PA.build_leaf_map(pt), jtab=JM.build_skip_table(jt, 1e-2),
             ptab=P.build_skip_table(pt, 1e-2), jcam=cams[0],
             pcam=cams[1], opt=RenderOptions(), popt=P.RenderOptions())
    j = JA.render_frame_fast(jt, s["jlm"], cams[0], s["opt"], max_dense=32,
                             chunk_size=CS, return_nrec=True,
                             skip_table=s["jtab"], return_skips=True)
    p = PA.render_frame_fast(pt, s["plm"], cams[1], s["popt"], max_dense=32,
                             chunk_size=CS, return_nrec=True,
                             skip_table=s["ptab"], return_skips=True)
    assert not int(j[1]) and not int(p[1])
    s["jph"] = JA.pack_hints(*j[2:])
    s["pph"] = PA.pack_hints(*p[2:])
    np.testing.assert_array_equal(s["pph"].numpy(), np.asarray(s["jph"]))
    cdf = PA.hint_class_cdf_packed(s["pph"]).numpy()
    s["segments"] = PA.segments_from_hint_cdf(cdf, w * h, margin=1)
    for cam in cams:
        _orbit(cam, 2.0)
    return s


def test_quarter_order_equal(episode):
    s = episode
    qj = JA.quarter_order_from_packed(s["jph"], width=s["w"])
    qp = PA.quarter_order_from_packed(s["pph"], width=s["w"])
    assert qp.shape[0] * 4 == s["w"] * s["h"]
    np.testing.assert_array_equal(qp.numpy(), np.asarray(qj))


@pytest.mark.parametrize("stride", [1, 2])
def test_render_frame_motion_equal(episode, stride):
    s = episode
    if stride == 2:
        jst = JA.quarter_order_from_packed(s["jph"], width=s["w"])
        pst = PA.quarter_order_from_packed(s["pph"], width=s["w"])
    else:
        jst = JA.order_from_packed_device(s["jph"])[0]
        pst = PA.order_from_packed_device(s["pph"])[0]
    seen = []
    j = JA.render_frame_motion(s["jt"], s["jlm"], s["jcam"], s["opt"], jst,
                               segments=s["segments"], chunk_size=CS,
                               skip_table=s["jtab"], hint_stride=stride)
    p = PA.render_frame_motion(s["pt"], s["plm"], s["pcam"], s["popt"], pst,
                               segments=s["segments"], chunk_size=CS,
                               skip_table=s["ptab"], hint_stride=stride,
                               on_flags=seen.append)
    img_j, ov_j, (perm_j, inv_j), cdf_j, q_j = j
    img_p, ov_p, (perm_p, inv_p), cdf_p, q_p = p
    for a, b in ((perm_j, perm_p), (inv_j, inv_p), (cdf_j, cdf_p),
                 (ov_j, ov_p)):
        np.testing.assert_array_equal(_arr(b), np.asarray(a))
    assert (q_j is None) == (q_p is None) == (stride == 1)
    if stride == 2:
        np.testing.assert_array_equal(q_p.numpy(), np.asarray(q_j))
    err = float(np.abs(np.asarray(img_j) - img_p.numpy()).max())
    assert err <= PIX_TOL, err
    assert img_p.shape == (s["h"], s["w"], 4)
    # the flags handed over as soon as the marches are queued
    assert len(seen) == 1 and set(seen[0]) == {"seg_overflow", "cdf"}
    assert torch.equal(seen[0]["seg_overflow"], ov_p)
    assert torch.equal(seen[0]["cdf"], cdf_p)
    # no overflow: the frame is the fresh frame of this pose
    if not ov_p.any():
        fresh = PA.render_frame_fast(s["pt"], s["plm"], s["pcam"],
                                     s["popt"], max_dense=32, chunk_size=0)
        assert float((img_p - fresh[0]).abs().max()) <= 1e-6
    # the next pose starts from this pose's order
    nxt = PA.render_frame_motion(
        s["pt"], s["plm"], s["pcam"], s["popt"],
        q_p if stride == 2 else perm_p, segments=s["segments"],
        chunk_size=CS, skip_table=s["ptab"], hint_stride=stride)
    assert torch.equal(nxt[0], img_p)


def test_render_frame_motion_sizes(episode):
    """Odd frame sizes fall back to stride 1; a quarter order of the wrong
    size is refused (accel.py:1750-1753)."""
    s = episode
    pst = PA.quarter_order_from_packed(s["pph"], width=s["w"])
    with pytest.raises(ValueError, match="quarter order"):
        PA.render_frame_motion(s["pt"], s["plm"], s["pcam"], s["popt"],
                               pst[:-1], chunk_size=CS, hint_stride=2)
    cam = P.Camera(s["w"] + 1, s["h"], 0.7 * s["w"])
    cam.center = np.array([-1.5, 0.1, 1.4], np.float32)
    cam._update()
    R = (s["w"] + 1) * s["h"]
    perm = torch.arange(R)
    img, ov, (pp, ip), cdf, q = PA.render_frame_motion(
        s["pt"], s["plm"], cam, s["popt"], perm, chunk_size=CS,
        hint_stride=2)
    assert q is None and pp.shape[0] == R
    assert torch.equal(pp[ip], torch.arange(R))
