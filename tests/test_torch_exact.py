"""The port's exact march (plain PyTorch version on the CPU) against the
JAX package's ``render.render_rays`` / ``render_frame``, the scalar numpy
oracle (``ops/oracle.py``) and the committed digger golden image, on the
sphere, random (N = 2 and N = 3) and digger trees.

Tolerances, with their reasons:
  * fed JAX's own tree-space setup: split votes, sample votes and visit
    marks equal, rgba within 1e-6 of JAX's fast march (N = 2) and of its
    exact march up to the gap between JAX's two marches (1.07e-6 on one
    sphere ray: XLA:CPU compiles the two loops to different roundings,
    although the JAX package calls them bit-exact; ROADMAP queue 3).
    The march is JAX's step op for op (the FMA of ``cen + t * d``
    included); XLA's ``exp`` is one ulp off torch's on ~9% of inputs;
  * from world directions (the port's own setup): rgba within 1e-5 at
    sigma <= 40, votes equal on every ray whose setup is bit-equal.
    XLA:CPU lowers ``1 / |d|`` and ``1 / (d + 1e-9)`` approximately (one
    ulp off on some rays, ``test_torch_collect.py``), which moves those
    rays' steps by about an ulp;
  * against the oracle: as ``tests/test_render.py:_compare`` (2e-5 on at
    least 99.9% of the rays, votes equal where the pixels agree);
  * digger golden: PSNR > 45 dB, as ``tests/test_golden.py:69-95``;
  * depth frames: 1e-5.
"""

import dataclasses
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import mega_nerf_viewer_tpu.n3tree as J
import mega_nerf_viewer_tpu_torch as P
from mega_nerf_viewer_tpu.camera import Camera
from mega_nerf_viewer_tpu.n3tree import DataFormat
from mega_nerf_viewer_tpu.options import RenderOptions
from mega_nerf_viewer_tpu.ops import accel as JA
from mega_nerf_viewer_tpu.ops import oracle
from mega_nerf_viewer_tpu.ops import render as JR
from mega_nerf_viewer_tpu.ops.rays import rodrigues, screen2worlddir
from mega_nerf_viewer_tpu.ops.sh import masked_sh_basis
from mega_nerf_viewer_tpu.utils.metrics import psnr
from mega_nerf_viewer_tpu.utils.png import read_png
from mega_nerf_viewer_tpu_torch.ops import accel as PA
from mega_nerf_viewer_tpu_torch.ops import render as PR

ARRAYS = ("data", "child", "parent", "sample_counts", "scale", "offset")
FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures")
SETUP_TOL = 1e-6
PIX_TOL = 1e-5


def port(jt, data_format=None):
    return P.tree_from_numpy(
        **{k: np.asarray(getattr(jt, k)) for k in ARRAYS},
        capacity=int(jt.capacity),
        data_format=data_format or jt.data_format, device="cpu")


def port_opt(opt):
    """The port's RenderOptions with the same field values."""
    return P.RenderOptions(**{f.name: getattr(opt, f.name)
                              for f in dataclasses.fields(P.RenderOptions)
                              if hasattr(opt, f.name)})


def camera(w, h, f, center=(-1.5, 0.1, 1.4)):
    cam = Camera(w, h, f)
    cam.center = np.asarray(center, np.float32)
    cam._update()
    return cam


def world_rays(cam, opt):
    """(dirs, vdirs, cen) as JAX arrays and as CPU tensors."""
    dirs, cen = screen2worlddir(cam.width, cam.height, cam.fx, cam.fy,
                                cam.cx, cam.cy, jnp.asarray(cam.transform))
    vdirs = rodrigues(jnp.asarray(opt.rot_dirs, jnp.float32), dirs)
    return (dirs, vdirs, cen), tuple(torch.tensor(np.asarray(a))
                                     for a in (dirs, vdirs, cen))


def jax_setup(jt, dirs, vdirs, cen_world, opt):
    """The tree-space setup exactly as JAX's marches write it
    (``render.py:152-167``, ``accel.py:410-434``, ``guided.py:81-91``):
    cen, d, invdir, delta_scale, tmin, tmax, miss and the masked basis
    ([R, 1] zeros without SH or in depth mode)."""
    basis_dim = jt.data_format.basis_dim
    use_sh = jt.data_format.format == "SH" and basis_dim >= 1

    @jax.jit
    def setup(scale, offset, dirs, vdirs, cen_world):
        cen = offset + scale * cen_world
        d = dirs * scale[None, :]
        ds = 1.0 / jnp.linalg.norm(d, axis=-1)
        d = d * ds[:, None]
        tmax_bg = jnp.full((d.shape[0],), 1e9, jnp.float32) / ds
        invdir = 1.0 / (d + jnp.float32(1e-9))
        tmin, tmax = JR._dda_world_batch(cen, invdir, opt.render_bbox)
        tmax = jnp.minimum(tmax, tmax_bg)
        miss = (tmax < 0) | (tmin > tmax)
        if use_sh and not opt.render_depth:
            basis = masked_sh_basis(basis_dim, vdirs, opt.basis_minmax[0],
                                    opt.basis_minmax[1])
        else:
            basis = jnp.zeros((d.shape[0], 1), jnp.float32)
        return cen, d, invdir, ds, tmin, tmax, miss, basis

    return setup(jt.scale, jt.offset, dirs, vdirs, cen_world)


def march_inputs_from(setup, opt, use_sh):
    """``accel.MarchInputs`` from JAX's setup arrays."""
    t = [torch.tensor(np.asarray(a)) for a in setup]
    return PA.MarchInputs(*t, PA._f32(opt.step_size),
                          PA._f32(opt.sigma_thresh),
                          PA._f32(opt.stop_thresh), use_sh,
                          bool(opt.render_depth))


def setup_equal(jt, pt, jrays, prays, opt):
    """Rays whose setup (d, invdir, delta_scale, tmin, tmax) is bit-equal
    between JAX and the port."""
    j = jax_setup(jt, *jrays, opt)
    p = PA.ray_setup(pt, prays[0], prays[2], opt.render_bbox,
                     torch.full((prays[0].shape[0],), 1e9))
    eq = np.ones(prays[0].shape[0], bool)
    for a, b in zip(j[1:6], p[1:6]):
        a, b = np.asarray(a), b.numpy()
        eq &= (a.view(np.int32) == b.view(np.int32)).reshape(
            a.shape[0], -1).all(1)
    return eq


def _random_tree(N=2):
    if N == 2:
        return J.random_tree(n_chunks=80, basis_dim=4, seed=7, density=1.0)
    return J.random_tree(n_chunks=40, basis_dim=4, seed=5, density=1.0, N=3)


_TREES = {
    "sphere": lambda: J.sphere_tree(basis_dim=4, depth=5),
    "random": _random_tree,
    "random_n3": lambda: _random_tree(N=3),
    "digger": lambda: J.N3Tree.open(os.path.join(FIXTURES,
                                                 "digger_sh4.npz")),
}
_CACHE = {}


def _tree(name):
    if name not in _CACHE:
        jt = _TREES[name]()
        _CACHE[name] = (jt, port(jt))
    return _CACHE[name]


def _views(name):
    if name == "digger":
        cam = camera(24, 24, 26.0, center=(-1.1, 0.9, 1.6))
    else:
        cam = camera(20, 18, 16.0)
    return cam


@pytest.mark.parametrize("name", sorted(_TREES))
@pytest.mark.parametrize("depth", [False, True])
def test_exact_march_from_jax_setup(name, depth):
    """On N = 2 trees JAX's own exact and fast marches differ by up to
    1.07e-6 on a few rays of the sphere (XLA compiles the two loops
    differently); the port is held within SETUP_TOL of JAX's fast march,
    and of JAX's exact march up to that gap."""
    jt, pt = _tree(name)
    opt = RenderOptions(render_depth=depth)
    popt = port_opt(opt)
    jrays, _ = world_rays(_views(name), opt)
    want = JR.render_rays(jt, *jrays, opt, track_visit=True)
    use_sh = pt.data_format.format == "SH" and pt.basis_dim >= 1
    m = march_inputs_from(jax_setup(jt, *jrays, opt), opt, use_sh)
    out, sv, pv, visited, steps = PR.exact_march_reference(pt, m, popt,
                                                           True)
    out, jout = out.numpy(), np.asarray(want.out)
    gap = np.zeros(len(out), np.float32)
    if jt.N == 2:
        fast = JA.render_rays_fast(jt, JA.build_leaf_map(jt), *jrays, opt,
                                   max_dense=64)
        assert not bool(fast.overflow)
        fout = np.asarray(fast.out)
        gap = np.abs(jout - fout).max(1)
        assert float(np.abs(out - fout).max()) <= SETUP_TOL
    err = np.abs(out - jout).max(1)
    print(f"{name} depth {depth}: rgba max abs diff {err.max():.3e} (JAX "
          f"exact vs fast {gap.max():.3e}), visited {int(visited.sum())}")
    assert (err <= SETUP_TOL + gap).all()
    np.testing.assert_array_equal(sv.numpy(), np.asarray(want.split_vote))
    np.testing.assert_array_equal(pv.numpy(), np.asarray(want.sample_vote))
    np.testing.assert_array_equal(visited.numpy(), np.asarray(want.visited))
    assert int(visited.sum()) > 1 and int(steps.max()) > 1


@pytest.mark.parametrize("name", ["sphere", "random", "random_n3"])
def test_exact_march_from_world_dirs(name):
    jt, pt = _tree(name)
    opt = RenderOptions()
    jrays, prays = world_rays(_views(name), opt)
    want = JR.render_rays(jt, *jrays, opt, track_visit=True)
    got = PR.render_rays(pt, *prays, port_opt(opt), track_visit=True)
    err = float(np.abs(got.out.numpy() - np.asarray(want.out)).max())
    eq = setup_equal(jt, pt, jrays, prays, opt)
    print(f"{name}: rgba max abs diff {err:.3e}; {int((~eq).sum())} rays "
          f"with another setup")
    assert err <= PIX_TOL
    for k in ("split_vote", "sample_vote"):
        np.testing.assert_array_equal(getattr(got, k).numpy()[eq],
                                      np.asarray(getattr(want, k))[eq])


_ORACLE_CASES = {
    "sphere_sh1": (lambda: J.sphere_tree(basis_dim=1, depth=3),
                   dict(), (16, 16, 20.0), True),
    "sphere_sh9": (lambda: J.sphere_tree(basis_dim=9, depth=3),
                   dict(), (12, 12, 16.0), False),
    "random": (lambda: J.random_tree(n_chunks=80, basis_dim=4, seed=7,
                                     density=1.0),
               dict(), (12, 12, 14.0), False),
    "depth": (lambda: J.sphere_tree(basis_dim=1, depth=3),
              dict(render_depth=True), (10, 10, 14.0), False),
    "rgba": (lambda: J.random_tree(n_chunks=40, basis_dim=4, seed=5),
             dict(), (8, 8, 10.0), False),
    "bbox": (lambda: J.sphere_tree(basis_dim=1, depth=3),
             dict(render_bbox=(0.25, 0.0, 0.25, 0.9, 0.8, 1.0)),
             (10, 10, 14.0), False),
    "rot_dirs": (lambda: J.sphere_tree(basis_dim=4, depth=3),
                 dict(rot_dirs=(0.3, -0.2, 0.1)), (8, 8, 12.0), False),
    "minmax": (lambda: J.sphere_tree(basis_dim=9, depth=3),
               dict(basis_minmax=(1, 5)), (8, 8, 12.0), False),
}


@pytest.mark.parametrize("case", sorted(_ORACLE_CASES))
def test_exact_march_matches_oracle(case):
    """``tests/test_render.py``'s oracle cases, through the port."""
    make, kw, (w, h, f), moved = _ORACLE_CASES[case]
    jt = make()
    fmt = DataFormat("RGBA", -1) if case == "rgba" else None
    if fmt is not None:
        jt = J.N3Tree(data=jt.data, child=jt.child, parent=jt.parent,
                      sample_counts=jt.sample_counts, scale=jt.scale,
                      offset=jt.offset, capacity=jt.capacity, N=jt.N,
                      data_dim=jt.data_dim, data_format=fmt)
    pt = port(jt)
    opt = RenderOptions(**kw)
    cam = Camera(w, h, f)
    if moved:
        cam.center = np.array([-1.5, 0.1, 1.4], np.float32)
    cam._update()
    jrays, prays = world_rays(cam, opt)
    res = PR.render_rays(pt, *prays, port_opt(opt))
    got = res.out.numpy()
    host = oracle.tree_to_host(jt)
    d_np, v_np, c_np = (np.asarray(a) for a in jrays)
    want = np.zeros_like(got)
    want_sv = np.zeros((len(d_np), 3), np.float32)
    want_pv = np.zeros((len(d_np), 3), np.float32)
    for i in range(len(d_np)):
        want[i], want_sv[i], want_pv[i], _ = oracle.trace_ray(
            host, d_np[i], v_np[i], c_np, opt)
    err = np.abs(got - want).max(axis=-1)
    ok = err < 2e-5
    print(f"{case}: {int((~ok).sum())} of {len(ok)} rays beyond 2e-5")
    assert np.mean(ok) >= 0.999
    np.testing.assert_array_equal(res.split_vote.numpy()[ok], want_sv[ok])
    np.testing.assert_array_equal(res.sample_vote.numpy()[ok], want_pv[ok])


def test_digger_golden_image():
    """The exact frame of the committed svox-schema fixture reproduces
    the committed golden image (``tests/test_golden.py:69-95``)."""
    tree = P.N3Tree.open(os.path.join(FIXTURES, "digger_sh4.npz"),
                         device="cpu")
    cam = Camera(160, 160, 170.0)
    cam.center = np.array([-1.1, 0.9, 1.6], np.float32)
    cam.v_back = cam.center / np.linalg.norm(cam.center)
    cam._update()
    opt = P.RenderOptions(background_brightness=0.9)
    img, _ = P.render_frame(tree, cam.width, cam.height, cam.fx, cam.fy,
                            cam.cx, cam.cy, cam.transform, opt)
    got = PR.to_rgba8(img).numpy().astype(np.float32) / 255.0
    want = read_png(os.path.join(FIXTURES, "digger_sh4_golden.png")) / 255.0
    score = psnr(got, want)
    print(f"digger golden: PSNR {score:.2f} dB")
    assert score > 45.0


@pytest.mark.parametrize("name", ["sphere", "random_n3"])
def test_depth_frame_matches_jax(name):
    jt, pt = _tree(name)
    cam = _views(name)
    opt = RenderOptions(render_depth=True, sigma_thresh=0.01)
    want, wres = JR.render_frame(jt, cam.width, cam.height, cam.fx, cam.fy,
                                 cam.cx, cam.cy, jnp.asarray(cam.transform),
                                 opt, track_visit=True)
    got, gres = P.render_frame(pt, cam.width, cam.height, cam.fx, cam.fy,
                               cam.cx, cam.cy, cam.transform, port_opt(opt),
                               track_visit=True)
    err = float(np.abs(got.numpy() - np.asarray(want)).max())
    print(f"{name} depth frame: max abs diff {err:.3e}")
    assert got.shape == (cam.height, cam.width, 4)
    assert err <= PIX_TOL
    assert (got[..., 3] == 1).all()
    np.testing.assert_array_equal(gres.visited.numpy(),
                                  np.asarray(wres.visited))


def test_max_iters_tmax_bg_and_levels_match_jax():
    """``max_iters`` stops the loop early, ``tmax_bg`` clips each ray and
    ``max_levels`` bounds the descent, as in JAX."""
    jt, pt = _tree("sphere")
    opt = RenderOptions()
    jrays, prays = world_rays(_views("sphere"), opt)
    R = prays[0].shape[0]
    bg = np.linspace(0.5, 3.0, R).astype(np.float32)
    for kw in (dict(max_iters=4), dict(tmax_bg=bg), dict(max_levels=3)):
        jkw = {k: (jnp.asarray(v) if k == "tmax_bg" else v)
               for k, v in kw.items()}
        pkw = {k: (torch.as_tensor(v) if k == "tmax_bg" else v)
               for k, v in kw.items()}
        want = JR.render_rays(jt, *jrays, opt, track_visit=True, **jkw)
        got = PR.render_rays(pt, *prays, port_opt(opt), track_visit=True,
                             **pkw)
        err = float(np.abs(got.out.numpy() - np.asarray(want.out)).max())
        print(f"{kw.keys()}: rgba max abs diff {err:.3e}")
        assert err <= PIX_TOL
        np.testing.assert_array_equal(got.visited.numpy(),
                                      np.asarray(want.visited))


def test_fresh_visit_tracker():
    _, pt = _tree("sphere")
    v = P.fresh_visit_tracker(pt)
    assert v.shape == (pt.max_capacity,) and v.dtype == torch.int32
    assert int(v[0]) == 1 and int(v.sum()) == 1
