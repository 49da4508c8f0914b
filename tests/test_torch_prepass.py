"""The port's entry-skip prepass against the JAX package's Pallas kernel
(run in interpret mode on the CPU, as its own tests run it).

Both tolerances are zero: the skip table is BIT-equal, and ``t_start``
is bit-equal with equal skip counts, because the march must start at
exactly the ``t`` it would have reached itself.
"""

import functools
from fractions import Fraction

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import mega_nerf_viewer_tpu.n3tree as J
import mega_nerf_viewer_tpu_torch.n3tree as P
from mega_nerf_viewer_tpu.camera import Camera
from mega_nerf_viewer_tpu.options import RenderOptions
from mega_nerf_viewer_tpu.ops import pallas_march as JM
from mega_nerf_viewer_tpu.ops.rays import screen2worlddir
from mega_nerf_viewer_tpu.ops.render import _dda_world_batch
from mega_nerf_viewer_tpu_torch.ops import skip_prepass as PM
from mega_nerf_viewer_tpu_torch.ops.fp import fma_f32, pow2_f32

ARRAYS = ("data", "child", "parent", "sample_counts", "scale", "offset")


def port(jt):
    return P.tree_from_numpy(
        **{k: np.asarray(getattr(jt, k)) for k in ARRAYS},
        capacity=int(jt.capacity), data_format=jt.data_format, device="cpu")


@pytest.mark.parametrize("depth,thresh", [(3, 1e-2), (3, 1e9), (7, 1e-2),
                                          (5, 19.0)])
def test_skip_table_bit_equal(depth, thresh):
    jt = J.sphere_tree(basis_dim=1, depth=depth)
    tj = np.asarray(JM.build_skip_table(jt, thresh))
    tp = PM.build_skip_table(port(jt), thresh)
    assert tp.dtype == torch.int32 and tuple(tp.shape) == (80, 128)
    np.testing.assert_array_equal(tp.numpy(), tj)
    if depth == 7:
        assert np.any(tj[8:16] != 0) and np.any(tj[16:] != 0)


def test_skip_table_shell_bit_equal():
    jt = J.shell_tree(depth=6, basis_dim=9, sigma_inside=400.0)
    np.testing.assert_array_equal(
        PM.build_skip_table(port(jt), 1e-2).numpy(),
        np.asarray(JM.build_skip_table(jt, 1e-2)))


@jax.jit
def _setup(dirs, cenw, scale, offset):
    """The tree-space ray setup of accel.render_rays_fast, in JAX."""
    cen = offset + scale * cenw
    d = dirs * scale[None, :]
    ds = 1.0 / jnp.linalg.norm(d, axis=-1)
    d = d * ds[:, None]
    invdir = 1.0 / (d + jnp.float32(1e-9))
    tmin, tmax = _dda_world_batch(cen, invdir, (0.0, 0.0, 0.0, 1.0, 1.0, 1.0))
    tmax = jnp.minimum(tmax, 1e9 / ds)
    live = ~((tmax < 0) | (tmin > tmax))
    return cen, d, invdir, tmin, tmax, live


# one compiled reference prepass for every case (equal shapes below)
_jax_prepass = jax.jit(functools.partial(JM.entry_skip_prepass,
                                         with_count=True))


def _rays(jt, w, h, f, center):
    cam = Camera(w, h, f)
    cam.center = np.asarray(center, np.float32)
    cam._update()
    dirs, cenw = screen2worlddir(w, h, cam.fx, cam.fy, cam.cx, cam.cy,
                                 jnp.asarray(cam.transform))
    return _setup(dirs, cenw, jt.scale, jt.offset)


SCENES = {
    # the scenes of test_accel's prepass tests, at one frame size
    "sphere4_48": (lambda: J.sphere_tree(basis_dim=4, depth=4),
                   (48, 48, 45.0, (-1.3, 0.2, 1.2))),
    "sphere7_48": (lambda: J.sphere_tree(basis_dim=1, depth=7),
                   (48, 48, 45.0, (-1.3, 0.2, 1.2))),
}


@pytest.mark.parametrize("scene", sorted(SCENES))
@pytest.mark.parametrize("planes", ["4", "45", "456"])
def test_entry_skip_prepass_bit_equal(scene, planes):
    make, cam = SCENES[scene]
    jt = make()
    opt = RenderOptions()
    tab = np.array(JM.build_skip_table(jt, opt.sigma_thresh))
    if "6" not in planes:
        tab[16:] = 0
    if "5" not in planes:
        tab[8:16] = 0
    args = _rays(jt, *cam)
    step = np.float32(opt.step_size)
    tj, sj = _jax_prepass(jnp.asarray(tab), *args, step)
    targs = [torch.as_tensor(np.array(a)) for a in args]
    tp, sp = PM.entry_skip_prepass(torch.as_tensor(tab), *targs,
                                   float(step))
    tj, sj = np.asarray(tj), np.asarray(sj)
    assert int(sj.sum()) > 0
    np.testing.assert_array_equal(tp.numpy().view(np.int32),
                                  tj.view(np.int32))
    np.testing.assert_array_equal(sp.numpy(), sj)


def _f32_round(x: Fraction) -> np.float32:
    """Round an exact rational to the nearest f32, ties to even."""
    c = np.float32(float(x))
    cands = {c, np.nextafter(c, np.float32(np.inf)),
             np.nextafter(c, np.float32(-np.inf))}
    best = min(cands, key=lambda v: (abs(Fraction(float(v)) - x),
                                     int(np.array(v).view(np.int32)) & 1))
    return np.float32(best)


def test_fma_f32_single_rounding():
    rng = np.random.RandomState(0)
    a = rng.randn(3000).astype(np.float32)
    b = (rng.randn(3000) * 3).astype(np.float32)
    c = (rng.randn(3000) * 2).astype(np.float32)
    # ties of the float64 sum: c = 1, a*b = 2^-24 +/- 2^-60-ish makes the
    # f32 result hinge on the product's low bits
    a[:4] = np.float32(1 + 2.0 ** -23)
    b[:4] = [np.float32(2.0 ** -24), np.float32(-2.0 ** -24),
             np.float32(2.0 ** -25), np.float32(-2.0 ** -25)]
    c[:4] = 1.0
    got = fma_f32(*(torch.as_tensor(v) for v in (a, b, c))).numpy()
    want = np.array([_f32_round(Fraction(float(x)) * Fraction(float(y))
                                + Fraction(float(z)))
                     for x, y, z in zip(a, b, c)], np.float32)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_pow2_f32_exact():
    d = torch.arange(-20, 31, dtype=torch.int32)
    np.testing.assert_array_equal(pow2_f32(d).numpy(),
                                  (2.0 ** np.arange(-20, 31)).astype(
                                      np.float32))


def _edge_rays(case):
    """Rays of the sphere7_48 scene cut to the kernel's edge cases: every
    ray dead, one ray, rays whose tmax ends inside the entry skip, and
    a ragged count with dead rays mixed in."""
    jt = SCENES["sphere7_48"][0]()
    cen, d, invdir, tmin, tmax, live = (np.array(a) for a in
                                        _rays(jt, *SCENES["sphere7_48"][1]))
    if case == "all_dead":
        live[:] = False
    elif case == "one_ray":
        # the ray with the most skips
        tab = np.array(JM.build_skip_table(jt, RenderOptions().sigma_thresh))
        _, skips = PM.entry_skip_prepass_reference(
            torch.as_tensor(tab), *(torch.as_tensor(a) for a in
                                    (cen, d, invdir, tmin, tmax, live)),
            float(RenderOptions().step_size))
        k = int(skips.argmax())
        d, invdir, tmin, tmax, live = (a[k:k + 1] for a in
                                       (d, invdir, tmin, tmax, live))
    elif case == "end_inside_skip":
        # tmax a little past tmin: the ray stops while still skipping
        tmax = np.where(live, tmin + np.float32(0.01), tmax).astype(
            np.float32)
    elif case == "ragged_dead":
        # the last 1001 rays, which hold the frame's skipping rays
        d, invdir, tmin, tmax, live = (a[-1001:].copy() for a in
                                       (d, invdir, tmin, tmax, live))
        live[::3] = False
    return jt, (cen, d, invdir, tmin, tmax, live)


@pytest.mark.parametrize("case", ["all_dead", "one_ray", "end_inside_skip",
                                  "ragged_dead"])
def test_prepass_edge_inputs_bit_equal(case):
    """The plain prepass against the Pallas kernel on the kernel's edge
    inputs: t bit-equal, skips equal."""
    jt, args = _edge_rays(case)
    opt = RenderOptions()
    tab = np.array(JM.build_skip_table(jt, opt.sigma_thresh))
    step = np.float32(opt.step_size)
    tj, sj = JM.entry_skip_prepass(jnp.asarray(tab),
                                   *(jnp.asarray(a) for a in args), step,
                                   with_count=True)
    tp, sp = PM.entry_skip_prepass(torch.as_tensor(tab),
                                   *(torch.as_tensor(a) for a in args),
                                   float(step))
    tj, sj = np.asarray(tj), np.asarray(sj)
    np.testing.assert_array_equal(tp.numpy().view(np.int32),
                                  tj.view(np.int32))
    np.testing.assert_array_equal(sp.numpy(), sj)
    live = args[-1]
    if case == "all_dead":
        assert int(sp.sum()) == 0
        np.testing.assert_array_equal(tp.numpy(), args[3])
    else:
        assert int(sp.sum()) > 0
    if case == "end_inside_skip":
        # some rays ran out of [tmin, tmax] while still skipping
        assert (live & (sp.numpy() > 0) & (tp.numpy() >= args[4])).any()

