"""bench_torch.py's set-up against bench.py's, on the CPU.

``bench_torch.setup_source`` runs ``bench.py:261-368`` through the port:
the hint frame with ``max_dense`` escalation, ``order_from_hints``, the
segment budgets (the ladder on the shell, chunk-exact on an npz) settled by
doubling, and the settled frame in pixel and in ray order.  Here the same
steps run through the JAX package's public functions (the replay below),
at 160x90 (seven chunks of the CPU's 2176 rays), on both routes:

* the shell route: ``shell_tree(depth=6, basis_dim=9, sigma_inside=400)``,
  bench.py's scene cut to depth 6; its pixels get the BASELINE 1e-3
  budget, since XLA:CPU's ``exp`` moves the sigma = 400 shell by about
  2.7e-5;
* the npz route: the sigma = 40 shell of depth 6 saved by the JAX package
  and opened by both, which takes chunk-exact budgets; pixels within 1e-5.

The integers (the ``max_dense`` reached, the order, the settled budgets)
must be equal.
"""

import os
import sys
from types import SimpleNamespace

import numpy as np
import pytest

import mega_nerf_viewer_tpu_torch as P
from mega_nerf_viewer_tpu.camera import Camera
from mega_nerf_viewer_tpu.n3tree import N3Tree, shell_tree
from mega_nerf_viewer_tpu.options import RenderOptions
from mega_nerf_viewer_tpu.ops import accel
from mega_nerf_viewer_tpu.ops.pallas_march import build_skip_table
from mega_nerf_viewer_tpu.utils.tuning import device_tuning

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import bench_torch  # noqa: E402

W, H = 160, 90
DEPTH = 6
TOL = {"shell": 1e-3, "npz": 1e-5}


def jax_setup(source, width, height):
    """``bench.py:261-368`` with the JAX package's public functions."""
    npz = isinstance(source, str)
    if npz:
        tree = N3Tree.open(source)
    else:
        tree = shell_tree(depth=source, basis_dim=9, sigma_inside=400.0)
    leaf_map = accel.build_leaf_map(tree)
    opt = RenderOptions()
    skip_table = build_skip_table(tree, opt.sigma_thresh)
    tune = device_tuning()
    cs, blk = tune.chunk_size, tune.block
    cam = Camera(width, height, 1111.0)
    cam.center = np.array([-1.4, 0.1, 1.3], np.float32)
    cam._update()
    max_dense = 8
    while True:
        img, overflow, steps, nrec, skips = accel.render_frame_fast(
            tree, leaf_map, cam, opt, max_dense=max_dense, chunk_size=cs,
            block=blk, return_nrec=True, skip_table=skip_table,
            return_skips=True)
        if not bool(overflow):
            break
        max_dense *= 2
        assert max_dense <= 512
    order = accel.order_from_hints(steps, nrec, skips)
    segments = list(accel.DEFAULT_SEGMENTS)
    seg_counts = None
    if npz:
        perm_h = np.asarray(order[0])
        nrec_s = np.asarray(nrec).reshape(-1)[perm_h]
        seg_counts = list(accel.seg_counts_from_hints(nrec_s, cs))

    def frame(**kw):
        if seg_counts is not None:
            return accel.render_frame_fast_segmented(
                tree, leaf_map, cam, opt, order=order, segments=None,
                chunk_size=cs, skip_table=skip_table,
                seg_counts=tuple(tuple(s) for s in seg_counts), **kw)
        return accel.render_frame_fast_segmented(
            tree, leaf_map, cam, opt, order=order,
            segments=tuple(segments), chunk_size=cs,
            skip_table=skip_table, **kw)

    while True:
        img, seg_overflow = frame()
        ov = np.asarray(seg_overflow)
        if not ov.any():
            break
        esc = seg_counts if seg_counts is not None else segments
        for i, hit in enumerate(ov):
            if hit:
                esc[i] = (esc[i][0], max(1, esc[i][1] * 2))
                assert esc[i][1] <= 512
    return SimpleNamespace(
        max_dense=max_dense, order=tuple(np.asarray(o) for o in order),
        segments=None if npz else tuple(tuple(s) for s in segments),
        seg_counts=(None if seg_counts is None
                    else tuple(tuple(s) for s in seg_counts)),
        img=np.asarray(img),
        sorted_img=np.asarray(frame(sorted_output=True)[0]))


@pytest.fixture(scope="module", params=["shell", "npz"])
def both(request, tmp_path_factory):
    if request.param == "npz":
        source = str(tmp_path_factory.mktemp("bench") / "shell_s40.npz")
        shell_tree(depth=DEPTH, basis_dim=9, sigma_inside=40.0).save_npz(
            source)
    else:
        source = DEPTH
    j = jax_setup(source, W, H)
    p = bench_torch.setup_source(source, W, H, device="cpu")
    return request.param, j, p


def test_same_tuning():
    """Both packages lay the CPU frame out in the same chunks and blocks."""
    j, p = device_tuning(), P.device_tuning("cpu")
    assert (j.chunk_size, j.block) == (p.chunk_size, p.block)
    assert W * H > 5 * p.chunk_size            # the ladder's five segments


def test_max_dense(both):
    _, j, p = both
    assert p.max_dense == j.max_dense


def test_order(both):
    _, j, p = both
    for a, b in zip(j.order, p.order):
        np.testing.assert_array_equal(a, b.numpy())


def test_settled_budgets(both):
    route, j, p = both
    assert p.segments == j.segments
    assert p.seg_counts == j.seg_counts
    if route == "npz":
        assert p.segments is None and len(p.seg_counts) > 1
    else:
        assert p.seg_counts is None
        # the first class escalated from its budget of 0
        assert p.segments != tuple(P.DEFAULT_SEGMENTS)


def test_frame(both):
    route, j, p = both
    img, ov = p.frame()
    assert not ov.any()
    assert img.shape == (H, W, 4)
    assert float(img[..., 3].max()) > 0.5
    np.testing.assert_allclose(img.numpy(), j.img, rtol=0, atol=TOL[route])


def test_sorted_frame(both):
    """The frame in ray order, unpermuted, is the pixel-order frame bit for
    bit, and JAX's within the route's tolerance."""
    route, j, p = both
    rows, ov = p.frame_sorted()
    assert not ov.any()
    inv = p.order[1]
    got = rows[inv].reshape(H, W, 4)
    np.testing.assert_array_equal(got.numpy(), p.frame()[0].numpy())
    want = j.sorted_img[j.order[1]].reshape(H, W, 4)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL[route])


def test_chain_adds_each_checksum():
    """The timed loop's device-side checksum is the sum of the frames'."""
    import torch
    imgs = [torch.full((2, 2, 4), float(i)) for i in range(3)]
    it = iter(imgs)
    acc = bench_torch.chain(lambda: (next(it), None), 3, torch.zeros(()))
    assert float(acc) == sum(float(i.sum()) for i in imgs)
