"""Dynamic octree refinement in the port against the JAX package
(analogues of ``tests/test_refine.py:38-287``) and a whole refinement
session on the CPU: vote frames on the fast path, split, resample, a
visit-tracked exact frame, prune, the device-side expand, and guided
sampling with splitting through the padded compositor.

Randomness: JAX draws ``jax.random.uniform(key, ...)``, which torch cannot
reproduce, so each test draws JAX's numbers with the key JAX uses and
hands them to the port as ``rnd``.

Tolerances, with their reasons:
  * vote aggregations, ``node_corners``, ``child``, ``parent``,
    ``capacity``, ``sample_counts`` and the visit tracker: equal;
  * ``data``: within one f16 ulp (the MLP fill is f32 products summed in
    another order, then rounded to f16 once);
  * frames: 1e-5.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import mega_nerf_viewer_tpu.n3tree as J
import mega_nerf_viewer_tpu_torch as P
from mega_nerf_viewer_tpu.models import MegaNeRFModel
from mega_nerf_viewer_tpu.options import RenderOptions
from mega_nerf_viewer_tpu.ops import accel as JA
from mega_nerf_viewer_tpu.ops import guided as JG
from mega_nerf_viewer_tpu.ops import oracle
from mega_nerf_viewer_tpu.ops import refine as JF
from mega_nerf_viewer_tpu.ops import render as JR
from mega_nerf_viewer_tpu_torch.ops import accel as PA
from mega_nerf_viewer_tpu_torch.ops import refine as PF
from mega_nerf_viewer_tpu_torch.ops import render as PR

from test_torch_exact import camera, port, port_opt, world_rays

MODEL = dict(data_dim=4, n_clusters=4, grid_dim=(2, 2),
             min_position=(-2, -2, -2), max_position=(2, 2, 2),
             need_viewdir=True)
PIX_TOL = 1e-5


def _models():
    return (MegaNeRFModel.synthetic(**MODEL),
            P.MegaNeRFModel.synthetic(device="cpu", **MODEL))


def _opts(**kw):
    base = dict(use_splitting=True, split_batch_size=32, need_viewdir=True)
    base.update(kw)
    opt = RenderOptions(**base)
    return opt, port_opt(opt)


def _tracker(n):
    return jnp.zeros((n,), jnp.int32).at[0].set(1)


def _uniform(key, shape):
    return torch.tensor(np.asarray(
        jax.random.uniform(key, shape, jnp.float32)))


def assert_trees_equal(jt, pt, data_ulps=1):
    assert int(jt.capacity) == pt.capacity
    for k in ("child", "parent", "sample_counts"):
        np.testing.assert_array_equal(getattr(pt, k).numpy(),
                                      np.asarray(getattr(jt, k)), err_msg=k)
    a = np.asarray(jt.data).view(np.int16).astype(np.int32)
    b = pt.data.numpy().view(np.int16).astype(np.int32)
    ulp = int(np.abs(a - b).max())
    print(f"capacity {pt.capacity}; data within {ulp} f16 ulp")
    assert ulp <= data_ulps


def check_tree_invariants(tree):
    cap = tree.capacity
    child = tree.child.numpy()[:cap]
    parent = tree.parent.numpy()[:cap]
    n3 = tree.N3
    for c, ci in zip(*np.nonzero(child)):
        off = child[c, ci]
        assert off > 0, f"negative child offset at {c},{ci}"
        assert c + off < cap, f"dangling child {c},{ci}"
        assert parent[c + off] == c * n3 + ci, f"parent of {c + off}"


def _votes(jt, opt, w=20, h=20, f=26.0, track=False):
    jrays, _ = world_rays(camera(w, h, f), opt)
    return JR.render_rays(jt, *jrays, opt, track_visit=track)


# ----------------------------------------------------------------------
# vote aggregation and corners
# ----------------------------------------------------------------------
def test_aggregate_split_votes_ordering():
    votes = np.array([
        [2, 5, 1], [2, 5, 1], [2, 5, 1],
        [1, 3, 0], [1, 3, 0],
        [2, 7, 2], [2, 7, 2],
        [4, 9, 3],
        [9, -1, -1],
    ], np.float32)
    for K in (10, 2):
        got = PF.aggregate_split_votes(torch.as_tensor(votes), K)
        np.testing.assert_array_equal(got, JF.aggregate_split_votes(votes,
                                                                    K))
    got = PF.aggregate_split_votes(votes, 10)
    np.testing.assert_array_equal(got, [[5, 1], [3, 0], [7, 2]])
    assert PF.aggregate_split_votes(votes[7:], 10).shape == (0, 2)


def test_aggregate_sample_votes_ordering():
    votes = np.array([[8, 2, 1], [3, 4, 0], [5, 1, 7], [300, -1, -1]],
                     np.float32)
    got = PF.aggregate_sample_votes(torch.as_tensor(votes), 10)
    np.testing.assert_array_equal(got, JF.aggregate_sample_votes(votes, 10))
    np.testing.assert_array_equal(got, [[4, 0], [1, 7], [2, 1]])


@pytest.mark.parametrize("N", [2, 3])
def test_node_corners_match_jax(N):
    jt = J.random_tree(n_chunks=50, basis_dim=1, seed=2, N=N)
    pt = port(jt)
    rng = np.random.RandomState(N)
    chunk = rng.randint(0, 50, 64).astype(np.int32)
    cidx = rng.randint(0, N ** 3, 64).astype(np.int32)
    jc, jd = JF.node_corners(jt.parent, jnp.asarray(chunk),
                             jnp.asarray(cidx), N)
    pc, pd = PF.node_corners(pt.parent, torch.as_tensor(chunk),
                             torch.as_tensor(cidx), N)
    np.testing.assert_array_equal(pd.numpy(), np.asarray(jd))
    if N == 2:
        np.testing.assert_array_equal(pc.numpy(), np.asarray(jc))
    else:
        # XLA:CPU turns ``x / 3`` into ``x * (1 / 3)``, up to an ulp off
        # the division the port (and the reference) computes, per level
        np.testing.assert_allclose(pc.numpy(), np.asarray(jc), rtol=0,
                                   atol=1e-6)
    # the root's slot 0 sits at the origin, depth 0
    c0, d0 = PF.node_corners(pt.parent, torch.zeros(1, dtype=torch.int32),
                             torch.zeros(1, dtype=torch.int32), N)
    assert c0.abs().max() == 0 and int(d0[0]) == 0


# ----------------------------------------------------------------------
# expand, resample, prune
# ----------------------------------------------------------------------
def test_expand_voxels_matches_jax():
    jt = J.sphere_tree(basis_dim=1, depth=3, max_capacity=5000)
    pt = port(jt)
    jm, pm = _models()
    opt, popt = _opts()
    res = _votes(jt, opt)
    sv = np.asarray(res.split_vote)
    key = jax.random.PRNGKey(7)
    K = len(JF.aggregate_split_votes(sv, opt.split_batch_size))
    j1, jtr, jn = JF.expand_voxels(jt, jm, opt, sv, _tracker(5000), key=key)
    p1, ptr, pn = P.expand_voxels(pt, pm, popt, torch.tensor(sv),
                                  torch.tensor(np.asarray(_tracker(5000))),
                                  rnd=_uniform(key, (K * 8, 8, 3)))
    assert pn == jn == K > 0
    assert_trees_equal(j1, p1)
    np.testing.assert_array_equal(ptr.numpy(), np.asarray(jtr))
    check_tree_invariants(p1)
    cap0 = pt.capacity
    assert (p1.sample_counts[cap0:cap0 + pn] == 8).all()
    # the exact march still agrees with the oracle on the refined tree
    jrays, prays = world_rays(camera(20, 20, 26.0), opt)
    got = PR.render_rays(p1, *prays, popt).out.numpy()
    host = oracle.tree_to_host(j1)
    d, v, c = (np.asarray(a) for a in jrays)
    errs = [np.abs(got[i] - oracle.trace_ray(host, d[i], v[i], c, opt)[0])
            .max() for i in range(0, len(d), 7)]
    assert np.mean(np.asarray(errs) < 2e-5) >= 0.99


def test_expand_full_tree_aborts():
    pt = P.sphere_tree(basis_dim=1, depth=3, device="cpu")
    _, pm = _models()
    _, popt = _opts(split_batch_size=64)
    votes = torch.tensor([[1, 0, 0]] * 3, dtype=torch.float32)
    tracker = torch.zeros((pt.max_capacity,), dtype=torch.int32)
    new, _, added = P.expand_voxels(pt, pm, popt, votes, tracker,
                                    generator=torch.Generator())
    assert added == 0 and new is pt


def test_get_more_samples_matches_jax():
    jt = J.sphere_tree(basis_dim=1, depth=3, max_capacity=200)
    pt = port(jt)
    jm, pm = _models()
    opt, popt = _opts()
    pv = np.asarray(_votes(jt, opt).sample_vote)
    key = jax.random.PRNGKey(3)
    K = len(JF.aggregate_sample_votes(pv, opt.split_batch_size))
    j2 = JF.get_more_samples(jt, jm, opt, pv, key=key)
    p2 = P.get_more_samples(pt, pm, popt, torch.tensor(pv),
                            rnd=_uniform(key, (K, 8, 3)))
    assert K > 0
    assert_trees_equal(j2, p2)
    assert not torch.equal(p2.data, pt.data)


def test_get_more_samples_incremental_mean():
    """``old + (sum_new - spc * old) / (count + spc)`` in f32, one f16
    rounding, and the count raised by spc (``test_refine.py:141-180``)."""
    pt = P.sphere_tree(basis_dim=1, depth=2, max_capacity=100, device="cpu")

    class ConstModel:
        def cluster_ids_device(self, yz):
            return torch.zeros(yz.shape[:-1], dtype=torch.int32)

        def query_device(self, ids, samples):
            return torch.full((samples.shape[0], 5), 2.0)

    _, popt = _opts(samples_per_corner=8, split_batch_size=16)
    votes = torch.tensor([[8, 0, 3]], dtype=torch.float32)
    old = pt.data[0, 3].float()
    old_n = int(pt.sample_counts[0, 3])
    new = P.get_more_samples(pt, ConstModel(), popt, votes,
                             generator=torch.Generator().manual_seed(1))
    want = (old + (8 * 2.0 - 8 * old) / (old_n + 8)).half()
    assert torch.equal(new.data[0, 3], want)
    assert int(new.sample_counts[0, 3]) == old_n + 8
    assert torch.equal(new.data[0, 1], pt.data[0, 1])


def test_prune_matches_jax_and_keeps_the_frame():
    jt = J.sphere_tree(basis_dim=1, depth=4)
    pt = port(jt)
    opt, popt = _opts()
    res = _votes(jt, opt, track=True)
    vis = jnp.maximum(_tracker(jt.max_capacity), res.visited)
    j4, jf = JF.prune_tree(jt, vis)
    p4, pf = P.prune_tree(pt, torch.tensor(np.asarray(vis)))
    assert p4.capacity < pt.capacity
    assert_trees_equal(j4, p4, data_ulps=0)
    np.testing.assert_array_equal(pf.numpy(), np.asarray(jf))
    assert int(pf[0]) == 1 and int(pf.sum()) == 1
    check_tree_invariants(p4)
    _, prays = world_rays(camera(20, 20, 26.0), opt)
    before = PR.render_rays(pt, *prays, popt).out
    after = PR.render_rays(p4, *prays, popt).out
    assert float((before - after).abs().max()) <= 1e-6


def test_prune_nothing_to_prune():
    pt = P.sphere_tree(basis_dim=1, depth=2, device="cpu")
    new, fresh = P.prune_tree(pt, torch.ones((pt.max_capacity,),
                                             dtype=torch.int32))
    assert new is pt and int(fresh.sum()) == 1


# ----------------------------------------------------------------------
# the device-side expand
# ----------------------------------------------------------------------
def test_expand_jit_matches_jax_and_host():
    jt = J.sphere_tree(basis_dim=1, depth=3, max_capacity=5000)
    pt = port(jt)
    jm, pm = _models()
    opt, popt = _opts()
    sv = np.asarray(_votes(jt, opt).split_vote)
    key = jax.random.PRNGKey(11)
    jgrid = (jnp.asarray(jm.grid_dim, jnp.int32),
             jnp.asarray(jm.min_position, jnp.float32),
             jnp.asarray(jm.range, jnp.float32))
    j3, jtr, jn = JF.expand_voxels_jit(jt, jm.params, *jgrid, opt,
                                       jnp.asarray(sv), _tracker(5000), key)
    p3, ptr, pn = P.expand_voxels_jit(
        pt, pm.params, pm.grid_dim, pm.min_position, pm.range, popt,
        torch.tensor(sv), torch.tensor(np.asarray(_tracker(5000))),
        rnd=_uniform(key, (32, 8, 8, 3)))
    assert pn == int(jn) > 0
    assert_trees_equal(j3, p3)
    np.testing.assert_array_equal(ptr.numpy(), np.asarray(jtr))
    check_tree_invariants(p3)
    # the host expand picks the same leaves
    ph, _, nh = P.expand_voxels(pt, pm, popt, torch.tensor(sv),
                                ptr, generator=torch.Generator())
    assert nh == pn
    for k in ("child", "parent", "sample_counts"):
        assert torch.equal(getattr(ph, k), getattr(p3, k))


def test_expand_jit_aborts_when_full():
    pt = P.sphere_tree(basis_dim=1, depth=3, device="cpu")
    _, pm = _models()
    _, popt = _opts()
    votes = torch.tensor([[1, 0, 0]] * 3, dtype=torch.float32)
    tracker = torch.zeros((pt.max_capacity,), dtype=torch.int32)
    new, _, n = P.expand_voxels_jit(pt, pm.params, pm.grid_dim,
                                    pm.min_position, pm.range, popt, votes,
                                    tracker, generator=torch.Generator())
    assert n == 0 and new is pt


def test_device_vote_aggregation_not_biased_to_low_ids():
    rows = []
    for chunk in range(1, 7):
        rows += [[3.0, float(chunk), 0.0]] * 2
    rows += [[3.0, 90.0, 5.0]] * 6
    nodes, _, valid = PF.aggregate_split_votes_device(
        torch.tensor(rows), 8, 2)
    assert 90 * 8 + 5 in set(int(n) for n, ok in zip(nodes, valid) if ok)


@pytest.mark.parametrize("K", [4, 300])
def test_device_vote_aggregation_matches_host_and_jax(K):
    rng = np.random.RandomState(7)
    N3, R = 8, 600
    chunks = rng.randint(0, 25, R)
    cidx = rng.randint(0, N3, R)
    depth = ((chunks * N3 + cidx) % 5 + 1).astype(np.float32)
    votes = np.stack([depth, chunks, cidx], 1).astype(np.float32)
    votes[rng.rand(R) < 0.3, 1:] = -1
    nodes, prio, valid = PF.aggregate_split_votes_device(
        torch.as_tensor(votes), N3, K)
    jn, jp, jv = JF.aggregate_split_votes_device(jnp.asarray(votes), N3, K)
    np.testing.assert_array_equal(nodes.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(prio.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jv))
    sel = nodes.numpy()[valid.numpy()]
    host = PF.aggregate_split_votes(votes, K)
    np.testing.assert_array_equal(np.stack([sel // N3, sel % N3], 1), host)


# ----------------------------------------------------------------------
# the slice as a whole
# ----------------------------------------------------------------------
def test_refinement_session_matches_jax():
    """The Viewer's refinement order on both packages from the same draws:
    a fast vote frame, a split, a leaf-map rebuild, a second vote frame, a
    resample when nothing is added, a visit-tracked exact frame, a prune,
    a device expand, then guided sampling with splitting on the padded
    cache (its votes split once more) and the depth frames."""
    jt = J.sphere_tree(basis_dim=1, depth=3, max_capacity=120)
    pt = port(jt)
    jm, pm = _models()
    opt, popt = _opts(split_batch_size=24, max_guided_samples=8)
    jcam, pcam = camera(20, 20, 26.0), camera(20, 20, 26.0)
    pcam = P.Camera(20, 20, 26.0)
    pcam.center = jcam.center.copy()
    pcam._update()
    jtr, ptr = _tracker(120), torch.tensor(np.asarray(_tracker(120)))
    key = jax.random.PRNGKey(5)
    kinds = []

    def vote_frames(jt, pt):
        j = JA.render_frame_fast(jt, JA.build_leaf_map(jt), jcam, opt,
                                 max_dense=32, chunk_size=0,
                                 need_votes=True)
        p = P.render_frame_fast(pt, P.build_leaf_map(pt), pcam, popt,
                                max_dense=32, chunk_size=64, block=8,
                                need_votes=True)
        assert not bool(j[1]) and not int(p[1])
        assert float(np.abs(p[0].numpy() - np.asarray(j[0])).max()) \
            <= PIX_TOL
        for a, b in zip(p[3:5], j[3:5]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        return np.asarray(j[3]), np.asarray(j[4])

    for _ in range(4):
        sv, pv = vote_frames(jt, pt)
        key, sub = jax.random.split(key)
        K = len(JF.aggregate_split_votes(sv, opt.split_batch_size))
        jn_t, jtr, jn = JF.expand_voxels(jt, jm, opt, sv, jtr, key=sub)
        pn_t, ptr, pn = P.expand_voxels(
            pt, pm, popt, torch.tensor(sv), ptr,
            rnd=_uniform(sub, (max(K, 1) * 8, 8, 3)) if jn else None,
            generator=torch.Generator())
        assert pn == jn
        if jn == 0:
            key, sub = jax.random.split(key)
            K = len(JF.aggregate_sample_votes(pv, opt.split_batch_size))
            jn_t = JF.get_more_samples(jt, jm, opt, pv, key=sub)
            pn_t = P.get_more_samples(pt, pm, popt, torch.tensor(pv),
                                      rnd=_uniform(sub, (K, 8, 3)))
        kinds.append("split" if jn else "resample")
        jt, pt = jn_t, pn_t
        assert_trees_equal(jt, pt)
        np.testing.assert_array_equal(ptr.numpy(), np.asarray(jtr))
    assert "split" in kinds and "resample" in kinds

    # capacity pressure: a visit-tracked exact frame, then the prune
    jimg, jres = JR.render_frame(jt, 20, 20, jcam.fx, jcam.fy, jcam.cx,
                                 jcam.cy, jnp.asarray(jcam.transform), opt,
                                 track_visit=True)
    pimg, pres = P.render_frame(pt, 20, 20, pcam.fx, pcam.fy, pcam.cx,
                                pcam.cy, pcam.transform, popt,
                                track_visit=True)
    assert float(np.abs(pimg.numpy() - np.asarray(jimg)).max()) <= PIX_TOL
    jtr = jnp.maximum(jtr, jres.visited)
    ptr = torch.maximum(ptr, pres.visited)
    np.testing.assert_array_equal(ptr.numpy(), np.asarray(jtr))
    jt, jtr = JF.prune_tree(jt, jtr)
    pt, ptr = P.prune_tree(pt, ptr)
    assert_trees_equal(jt, pt)
    np.testing.assert_array_equal(ptr.numpy(), np.asarray(jtr))

    # the device expand on fast-path votes
    sv, _ = vote_frames(jt, pt)
    key, sub = jax.random.split(key)
    jgrid = (jnp.asarray(jm.grid_dim, jnp.int32),
             jnp.asarray(jm.min_position, jnp.float32),
             jnp.asarray(jm.range, jnp.float32))
    jt, jtr, _ = JF.expand_voxels_jit(jt, jm.params, *jgrid, opt,
                                      jnp.asarray(sv), jtr, sub)
    pt, ptr, _ = P.expand_voxels_jit(
        pt, pm.params, pm.grid_dim, pm.min_position, pm.range, popt,
        torch.tensor(sv), ptr, rnd=_uniform(sub, (24, 8, 8, 3)))
    assert_trees_equal(jt, pt)
    np.testing.assert_array_equal(ptr.numpy(), np.asarray(jtr))

    # guided sampling with splitting: exact collect, padded composite
    jc, jres = JG.collect_and_query(jt, jm, jcam, opt, track_visit=True)
    pc, pres = P.collect_and_query(pt, pm, pcam, popt, track_visit=True)
    for k in ("split_vote", "sample_vote", "visited"):
        np.testing.assert_array_equal(getattr(pres, k).numpy(),
                                      np.asarray(getattr(jres, k)))
    for depth in (False, True):
        o = opt.replace(render_depth=depth)
        want = np.asarray(JG.composite_frame(jt, jcam, o, jc))
        got = P.composite_frame(pt, pcam, port_opt(o), pc)
        assert float(np.abs(got.numpy() - want).max()) <= PIX_TOL
    sv = np.asarray(jres.split_vote)
    key, sub = jax.random.split(key)
    K = len(JF.aggregate_split_votes(sv, opt.split_batch_size))
    jt, jtr, jn = JF.expand_voxels(jt, jm, opt, sv, jtr, key=sub)
    pt, ptr, pn = P.expand_voxels(pt, pm, popt, torch.tensor(sv), ptr,
                                  rnd=_uniform(sub, (max(K, 1) * 8, 8, 3))
                                  if jn else None,
                                  generator=torch.Generator())
    assert pn == jn
    assert_trees_equal(jt, pt)
    np.testing.assert_array_equal(ptr.numpy(), np.asarray(jtr))

    # depth mode: the exact frame and the fast frame
    od = opt.replace(render_depth=True)
    jd, _ = JR.render_frame(jt, 20, 20, jcam.fx, jcam.fy, jcam.cx, jcam.cy,
                            jnp.asarray(jcam.transform), od)
    pd, _ = P.render_frame(pt, 20, 20, pcam.fx, pcam.fy, pcam.cx, pcam.cy,
                           pcam.transform, port_opt(od))
    pf = P.render_frame_fast(pt, P.build_leaf_map(pt), pcam, port_opt(od),
                             max_dense=32, chunk_size=64, block=8)[0]
    assert float(np.abs(pd.numpy() - np.asarray(jd)).max()) <= PIX_TOL
    assert float((pf - pd).abs().max()) <= 1e-6
