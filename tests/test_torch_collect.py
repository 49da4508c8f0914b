"""The port's guided collect march (plain PyTorch version on the CPU)
against the JAX package's ``guided.collect_t_fast``: unordered, in a
hint-sorted order, sorted output, and segmented, with and without the
entry-skip prepass, at record budgets 16, 2 (overflowing) and 0.

Tolerances, with their reasons:
  * overflow flags and segment flags: equal;
  * records per ray (ns) and march steps: equal on every ray except where
    the early-stop test ``T < stop_thresh`` is decided by a last-bit
    difference of XLA's ``exp``; at most 0.1% of the rays, printed;
  * t: BIT-equal where both sides march from the same setup (the march
    is the render march's step, op for op).  From world directions the
    setup itself differs on some rays: XLA lowers ``1 / |d|`` to an
    approximate rsqrt (one ulp off on ~14% of the rays here) which the
    port does not copy; those rays' t are within 1e-6 relative, and every
    ray whose setup is bit-equal has a bit-equal t.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import mega_nerf_viewer_tpu.n3tree as J
import mega_nerf_viewer_tpu_torch as P
from mega_nerf_viewer_tpu.camera import Camera
from mega_nerf_viewer_tpu.options import RenderOptions
from mega_nerf_viewer_tpu.ops import accel as JA
from mega_nerf_viewer_tpu.ops import guided as JG
from mega_nerf_viewer_tpu.ops import pallas_march as JM
from mega_nerf_viewer_tpu.ops.rays import screen2worlddir
from mega_nerf_viewer_tpu.ops.render import _dda_world_batch
from mega_nerf_viewer_tpu_torch.ops import accel as PA
from mega_nerf_viewer_tpu_torch.ops import guided as PG

ARRAYS = ("data", "child", "parent", "sample_counts", "scale", "offset")
MAX_MISMATCH = 0.001
T_RTOL = 1e-6


def port(jt):
    return P.tree_from_numpy(
        **{k: np.asarray(getattr(jt, k)) for k in ARRAYS},
        capacity=int(jt.capacity), data_format=jt.data_format, device="cpu")


_SCENES = {}


def _scene(depth):
    """sphere_tree(depth) at sigma 20 (<= 40, so a last-bit setup
    difference cannot decide a stop), its leaf maps and skip tables."""
    if depth not in _SCENES:
        jt = J.sphere_tree(basis_dim=1, depth=depth)
        pt = port(jt)
        _SCENES[depth] = dict(
            jt=jt, pt=pt, jlm=JA.build_leaf_map(jt),
            plm=PA.build_leaf_map(pt),
            jtab=JM.build_skip_table(jt, 1e-2),
            ptab=P.build_skip_table(pt, 1e-2))
    return _SCENES[depth]


# (depth, width, height, focal): a near view and a wide one
VIEWS = {4: (24, 18, 20.0), 5: (32, 32, 9.0)}


def _rays(depth):
    w, h, f = VIEWS[depth]
    cam = Camera(w, h, f)
    cam.center = np.array([-1.5, 0.1, 1.4], np.float32)
    cam._update()
    dirs, cen = screen2worlddir(w, h, cam.fx, cam.fy, cam.cx, cam.cy,
                                jnp.asarray(cam.transform))
    return (dirs, cen, torch.tensor(np.asarray(dirs)),
            torch.tensor(np.asarray(cen)))


@jax.jit
def _jax_setup(dirs, cenw, scale, offset):
    """The collect's per-ray setup, as ``guided.collect_t_fast`` writes
    it (``guided.py:382-388``)."""
    cen = offset + scale * cenw
    d = dirs * scale[None, :]
    ds = 1.0 / jnp.linalg.norm(d, axis=-1)
    d = d * ds[:, None]
    invdir = 1.0 / (d + jnp.float32(1e-9))
    tmin, tmax = _dda_world_batch(cen, invdir, (0.0, 0.0, 0.0, 1.0, 1.0, 1.0))
    miss = (tmax < 0) | (tmin > tmax)
    return cen, d, invdir, ds, tmin, tmax, miss


_jax_prepass = jax.jit(JM.entry_skip_prepass)


def _count_bad(a, b, what):
    bad = np.nonzero(a != b)[0]
    if len(bad):
        print(f"{what} mismatch on rays", bad.tolist(), "jax", a[bad],
              "port", b[bad])
    return len(bad)


def _setup_equal(s, dirs, cen, pdirs, pcen):
    """Rays whose tree-space setup (d, invdir, delta_scale, tmin, tmax)
    is bit-equal between the two sides."""
    j = _jax_setup(dirs, cen, s["jt"].scale, s["jt"].offset)
    p = PA.ray_setup(s["pt"], pdirs, pcen, (0.0, 0.0, 0.0, 1.0, 1.0, 1.0))
    eq = np.ones(pdirs.shape[0], bool)
    for a, b in zip(j[1:6], p[1:6]):
        a, b = np.asarray(a), b.numpy()
        eq &= (a.view(np.int32) == b.view(np.int32)).reshape(
            a.shape[0], -1).all(1)
    return eq


def _compare(j, p, R, setup_equal=None):
    """j, p = (t_buf, ns, steps[, ...]).  Integers equal up to the stop
    rounding; t bit-equal where the setup is (``setup_equal``), else
    within T_RTOL."""
    tj, tp = np.asarray(j[0]), p[0].numpy()
    assert tp.shape == tj.shape and tp.dtype == np.float32
    n_bad = _count_bad(np.asarray(j[1]), p[1].numpy(), "ns") \
        + _count_bad(np.asarray(j[2]), p[2].numpy(), "steps")
    assert n_bad <= MAX_MISMATCH * R
    same_ints = (np.asarray(j[1]) == p[1].numpy()) \
        & (np.asarray(j[2]) == p[2].numpy())
    bits = (tj.view(np.int32) == tp.view(np.int32)).all(1)
    exact = same_ints if setup_equal is None else same_ints & setup_equal
    n_t = int((exact & ~bits).sum())
    print(f"t: {int((~bits).sum())} of {R} rays not bit-equal, {n_t} of "
          f"them with a bit-equal setup")
    assert n_t <= MAX_MISMATCH * R
    close = np.isclose(tp, tj, rtol=T_RTOL, atol=0).all(1)
    assert (close | ~same_ints).all()
    return int(p[1].sum())


@pytest.mark.parametrize("depth", [4, 5])
def test_setup_closest_torch_form(depth):
    """No torch form of the setup reproduces XLA:CPU's: the port's
    once-rounded ``rsqrt_f32`` differs from JAX's ``1 / norm`` on fewer
    rays than ``1 / torch.sqrt`` (JAX's own form), ``1 / linalg.norm`` or
    ``torch.rsqrt``, and even from JAX's own ``d`` the plain division
    ``1 / (d + 1e-9)`` differs from XLA's on some rays (its reciprocal is
    approximate).  Prints the ray counts."""
    from mega_nerf_viewer_tpu_torch.ops.fp import rsqrt_f32
    from mega_nerf_viewer_tpu_torch.ops.rays import sq_norm
    s = _scene(depth)
    dirs, cen, pdirs, _ = _rays(depth)
    _, jd, jinv, jds = (np.asarray(a) for a in
                        _jax_setup(dirs, cen, s["jt"].scale,
                                   s["jt"].offset)[:4])
    d0 = pdirs * s["pt"].scale[None, :]
    forms = {"rsqrt_f32": rsqrt_f32(sq_norm(d0)),
             "1/sqrt": 1.0 / torch.sqrt(sq_norm(d0)),
             "1/linalg.norm": 1.0 / torch.linalg.norm(d0, dim=-1),
             "rsqrt": torch.rsqrt(sq_norm(d0))}
    n = {k: int((v.numpy().view(np.int32) != jds.view(np.int32)).sum())
         for k, v in forms.items()}
    inv = (1.0 / (torch.tensor(jd) + np.float32(1e-9))).numpy()
    n_inv = int((inv.view(np.int32) != jinv.view(np.int32)).any(1).sum())
    print(f"{pdirs.shape[0]} rays; delta_scale differs from JAX's on {n}; "
          f"invdir from JAX's own d on {n_inv}")
    assert n["rsqrt_f32"] == min(n.values())
    assert n_inv > 0


@pytest.mark.parametrize("skip", [False, True])
@pytest.mark.parametrize("S", [16, 2, 0])
def test_collect_march_bit_equal_on_jax_setup(S, skip):
    """The march alone: fed JAX's own setup (and prepass), the plain
    version's t are bit-equal to ``collect_t_fast``'s."""
    s = _scene(4)
    dirs, cen, _, _ = _rays(4)
    opt = RenderOptions(max_guided_samples=S)
    j = JG.collect_t_fast(s["jt"], s["jlm"], dirs, cen, opt,
                          skip_table=s["jtab"] if skip else None,
                          return_steps=True, with_overflow=True)
    c, d, invdir, ds, tmin, tmax, miss = _jax_setup(
        dirs, cen, s["jt"].scale, s["jt"].offset)
    if skip:
        tmin = _jax_prepass(s["jtab"], c, d, invdir, tmin, tmax, ~miss,
                            jnp.float32(opt.step_size))
    args = [torch.tensor(np.asarray(a)) for a in
            (c, d, invdir, ds, tmin, tmax, miss)]
    p = PG.collect_t_fast_reference(
        s["pt"], s["plm"], *args, S, np.float32(opt.step_size),
        np.float32(opt.sigma_thresh), np.float32(opt.stop_thresh))
    R = d.shape[0]
    total = _compare(j, p, R, setup_equal=np.ones(R, bool))
    assert bool(p[3] > 0) == bool(j[3])
    if S:
        assert total > 0
    if S == 2:
        assert int(p[3]) > 0               # the budget really overflows


@pytest.mark.parametrize("skip", [False, True])
@pytest.mark.parametrize("S", [16, 2, 0])
@pytest.mark.parametrize("depth", [4, 5])
def test_collect_t_fast_matches_jax(depth, S, skip):
    """From world directions, as the guided path calls it."""
    s = _scene(depth)
    dirs, cen, pdirs, pcen = _rays(depth)
    jopt = RenderOptions(max_guided_samples=S)
    j = JG.collect_t_fast(s["jt"], s["jlm"], dirs, cen, jopt,
                          skip_table=s["jtab"] if skip else None,
                          return_steps=True, with_overflow=True)
    p = PG.collect_t_fast(s["pt"], s["plm"], pdirs, pcen,
                          P.RenderOptions(max_guided_samples=S),
                          skip_table=s["ptab"] if skip else None,
                          return_steps=True, with_overflow=True)
    assert len(p) == 4 and p[3].dtype == torch.bool and p[3].shape == ()
    assert bool(p[3]) == bool(j[3])
    _compare(j, p, pdirs.shape[0],
             setup_equal=_setup_equal(s, dirs, cen, pdirs, pcen))
    two = PG.collect_t_fast(s["pt"], s["plm"], pdirs, pcen,
                            P.RenderOptions(max_guided_samples=S),
                            skip_table=s["ptab"] if skip else None)
    assert len(two) == 2 and torch.equal(two[0], p[0])


def test_collect_ordered_and_sorted_output():
    """An order only changes speed: outputs equal the unordered call bit
    for bit; ``keep_sorted`` returns them in rank order.  The overflow
    flag survives the ordered branch (``test_guided.py:449``)."""
    s = _scene(5)
    dirs, cen, pdirs, pcen = _rays(5)
    opt = P.RenderOptions(max_guided_samples=4)
    base = PG.collect_t_fast(s["pt"], s["plm"], pdirs, pcen, opt,
                             skip_table=s["ptab"], return_steps=True,
                             with_overflow=True)
    R = pdirs.shape[0]
    order = PA.order_from_hints(base[2], base[1])
    o = PG.collect_t_fast(s["pt"], s["plm"], pdirs, pcen, opt,
                          skip_table=s["ptab"], order=order,
                          return_steps=True, with_overflow=True)
    for a, b in zip(base, o):
        assert torch.equal(a, b)
    srt = PG.collect_t_fast(s["pt"], s["plm"], pdirs, pcen, opt,
                            skip_table=s["ptab"], order=order,
                            return_steps=True, keep_sorted=True)
    for a, b in zip(base[:3], srt):
        assert torch.equal(a[order[0]], b)
    # the same ordered call on the JAX side gives the same records
    jorder = JA.order_from_hints(base[2].numpy(), base[1].numpy())
    j = JG.collect_t_fast(s["jt"], s["jlm"], dirs, cen,
                          RenderOptions(max_guided_samples=4),
                          skip_table=s["jtab"], order=jorder,
                          return_steps=True, with_overflow=True)
    np.testing.assert_array_equal(np.asarray(jorder[0]), order[0].numpy())
    assert bool(j[3]) == bool(o[3]) and bool(o[3])
    _compare(j, o, R, setup_equal=_setup_equal(
        s, dirs[jorder[0]], cen, pdirs[order[0]], pcen)[np.asarray(jorder[1])])


@pytest.mark.parametrize("stale", [False, True])
def test_collect_segmented_matches_jax(stale):
    """Per-class budgets over the ns-sorted rays: with fresh hints the
    records equal the unsegmented call's; with stale hints the classes
    raise the same flags as JAX's, and doubling those classes settles to
    the same records.  (No prepass here: the JAX side compiles the Pallas
    prepass once per class in interpret mode, which is slow.)"""
    s = _scene(5)
    dirs, cen, pdirs, pcen = _rays(5)
    S, cs = 16, 64
    jopt = RenderOptions(max_guided_samples=S)
    popt = P.RenderOptions(max_guided_samples=S)
    base = PG.collect_t_fast(s["pt"], s["plm"], pdirs, pcen, popt,
                             skip_table=None, return_steps=True)
    R = pdirs.shape[0]
    segs = PG.segments_from_ns_hints(base[1], S)
    assert segs[0][1] == 0 and len(segs) >= 3
    if stale:
        order = PA.order_from_hints(torch.zeros(R, dtype=torch.int32),
                                    torch.zeros(R, dtype=torch.int32))
        segs = ((0.5, 0), (0.4, 1), (0.1, 16))
    else:
        order = PA.order_from_hints(torch.zeros(R, dtype=torch.int32),
                                    base[1])
    jorder = tuple(jnp.asarray(o.numpy()) for o in order)

    def both(sg):
        p = PG.collect_t_fast(s["pt"], s["plm"], pdirs, pcen, popt,
                              chunk_size=cs, skip_table=None,
                              order=order, segments=sg, return_steps=True)
        j = JG.collect_t_fast(s["jt"], s["jlm"], dirs, cen, jopt,
                              chunk_size=cs, skip_table=None,
                              order=jorder, segments=sg, return_steps=True)
        np.testing.assert_array_equal(p[3].numpy(), np.asarray(j[3]))
        return p, j

    p, _ = both(segs)
    assert bool(p[3].any()) == stale
    for _ in range(8):                 # escalate as the guided path does
        if not p[3].any():
            break
        segs = tuple((f, max(1, min(S, b * 2))) if hit else (f, b)
                     for (f, b), hit in zip(segs, p[3].numpy()))
        p = PG.collect_t_fast(s["pt"], s["plm"], pdirs, pcen, popt,
                              chunk_size=cs, skip_table=None,
                              order=order, segments=segs, return_steps=True)
    p, j = both(segs)
    assert not p[3].any()
    _compare(j, p, R, setup_equal=_setup_equal(s, dirs, cen, pdirs, pcen))
    for a, b in zip(base, p):
        assert torch.equal(a, b)
    srt = PG.collect_t_fast(s["pt"], s["plm"], pdirs, pcen, popt,
                            chunk_size=cs, skip_table=None,
                            order=order, segments=segs, keep_sorted=True)
    assert torch.equal(srt[0], base[0][order[0]])
    assert torch.equal(srt[1], base[1][order[0]])


def test_collect_segmented_small_frame():
    """Fewer chunks than classes: one full-budget march, no flags."""
    s = _scene(5)
    _, _, pdirs, pcen = _rays(5)
    popt = P.RenderOptions(max_guided_samples=16)
    base = PG.collect_t_fast(s["pt"], s["plm"], pdirs, pcen, popt,
                             skip_table=s["ptab"])
    R = pdirs.shape[0]
    order = PA.order_from_hints(torch.zeros(R, dtype=torch.int32), base[1])
    segs = PG.segments_from_ns_hints(base[1], 16)
    small = PG.collect_t_fast(s["pt"], s["plm"], pdirs, pcen, popt,
                              chunk_size=R, order=order, segments=segs,
                              skip_table=s["ptab"])
    assert torch.equal(small[0], base[0]) and torch.equal(small[1], base[1])
    assert small[2].shape == (len(segs),) and not small[2].any()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_segments_from_ns_hints_identical(seed):
    rng = np.random.RandomState(seed)
    R = 5000
    for ns in (rng.poisson(1.5, R), rng.randint(0, 33, R),
               np.where(rng.rand(R) < 0.5, 0, rng.geometric(0.2, R)),
               np.zeros(R, np.int64), np.full(R, 32)):
        ns = np.minimum(ns, 32).astype(np.int32)
        for S in (32, 16, 7):
            want = JG.segments_from_ns_hints(ns, S)
            assert PG.segments_from_ns_hints(ns, S) == want
            assert PG.segments_from_ns_hints(torch.as_tensor(ns), S) == want
    for top in (1, 2, 7, 8, 32, 128):
        assert PA.class_ladder(top) == JA.class_ladder(top)
