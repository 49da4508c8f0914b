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


# ----------------------------------------------------------------------
# The restarted descent of kernels E and F (csrc/descend_step.cuh), in a
# numpy emulation held bit-equal to the descent from the root: the port's
# ``_descend`` and the JAX ``_descend`` (render.py:49-92).
# ----------------------------------------------------------------------
PATH_CAP = 20   # csrc/descend_step.cuh kPathCap
F32 = np.float32


def _restart_bits(N):
    """csrc/descend_step.cuh:restart_bits."""
    b = 0
    while b < 31 and (1 << b) < N:
        b += 1
    return b if N >= 2 and (1 << b) == N else 0


def _pow2(e):
    return F32(2.0 ** e)


def _descend_level(child, N, chunk, f, visited):
    """csrc/descend_step.cuh:descend_level on one position: returns (skip,
    cidx) and updates the in-cell position ``f`` (3 f32) in place."""
    Nf, NNf = F32(N), F32(N * N)
    if 0 <= chunk < visited.size and visited[chunk] == 0:
        visited[chunk] = 1
    u = [f[i] * Nf for i in range(3)]
    g = [np.floor(u[i]) for i in range(3)]
    idx = int(g[0] * NNf + g[1] * Nf + g[2])
    for i in range(3):
        f[i] = u[i] - g[i]
    cidx = idx
    return int(child[min(max(chunk * N ** 3 + idx, 0), child.size - 1)]), cidx


def _descend_root(child, N, max_levels, f, visited):
    """csrc/descend_step.cuh:descend, line for line."""
    chunk, cidx, depth = 0, 0, 1
    for _ in range(max_levels):
        skip, cidx = _descend_level(child, N, chunk, f, visited)
        if skip == 0:
            return chunk, cidx, depth
        chunk += skip
        depth += 1
    return chunk, cidx, depth


def _descend_restart(child, N, b, max_levels, path, f, visited):
    """csrc/descend_step.cuh:descend_restart, line for line.  ``path`` is
    the dict {chunk: [PATH_CAP], L, p: [3 f32]} of the ray's last descent."""
    p = list(f)
    k = 0
    chunk = 0
    if path["L"] > 0:
        L = path["L"]
        s = _pow2(b * L)
        x = 0
        for i in range(3):
            x |= int(np.floor(p[i] * s)) ^ int(np.floor(path["p"][i] * s))
        bits = x.bit_length()
        k = L - (bits if b == 1 else (bits + b - 1) // b)
        if k > L - 1:
            k = L - 1
        sk = _pow2(b * k)
        for i in range(3):
            u = p[i] * sk
            f[i] = u - np.floor(u)
        chunk = path["chunk"][k]
    cidx = 0
    depth = k + 1
    L = max_levels
    for lev in range(k, max_levels):
        if lev < PATH_CAP:
            path["chunk"][lev] = chunk
        skip, cidx = _descend_level(child, N, chunk, f, visited)
        if skip == 0:
            L = lev + 1
            break
        chunk += skip
        depth += 1
    path["L"] = L if L <= PATH_CAP and b * L <= 31 else 0
    path["p"] = p
    return chunk, cidx, depth


def _emulate_step(child, N, max_levels, path, pos, visited):
    """csrc/descend_step.cuh:descend_step's descent at the clipped ``pos``:
    the restart for N = 2^b, the root descent otherwise.  Returns (frac,
    chunk, cidx, depth)."""
    b = _restart_bits(N)
    f = [F32(v) for v in pos]
    if b > 0:
        c, i, d = _descend_restart(child, N, b, max_levels, path, f, visited)
    else:
        c, i, d = _descend_root(child, N, max_levels, f, visited)
    return np.asarray(f, F32), c, i, d


def _uneven_tree():
    """A depth-3 sphere refined twice by ``ops/refine.expand_voxels`` at the
    leaves an exact frame votes for: leaves from depth 1 to 5."""
    pt = P.sphere_tree(basis_dim=1, depth=3, max_capacity=400, device="cpu")
    pm = P.MegaNeRFModel.synthetic(
        device="cpu", data_dim=4, n_clusters=4, grid_dim=(2, 2),
        min_position=(-2, -2, -2), max_position=(2, 2, 2),
        need_viewdir=True)
    popt = P.RenderOptions(use_splitting=True, split_batch_size=24,
                           need_viewdir=True)
    gen = torch.Generator().manual_seed(3)
    tracker = P.fresh_visit_tracker(pt)
    _, prays = world_rays(camera(20, 18, 16.0), popt)
    for _ in range(2):
        res = PR.render_rays(pt, *prays, popt)
        pt, tracker, added = P.expand_voxels(pt, pm, popt, res.split_vote,
                                             tracker, generator=gen)
        assert added > 0
    return pt


_RESTART_TREES = {
    "sphere_n2": lambda: P.sphere_tree(basis_dim=1, depth=5, device="cpu"),
    "sphere_n4": lambda: P.sphere_tree(basis_dim=1, depth=3, N=4,
                                       device="cpu"),
    "sphere_n3": lambda: P.sphere_tree(basis_dim=1, depth=3, N=3,
                                       device="cpu"),
    "uneven_n2": _uneven_tree,
}
_RESTART_CACHE = {}


def _restart_tree(name):
    if name not in _RESTART_CACHE:
        _RESTART_CACHE[name] = _RESTART_TREES[name]()
    return _RESTART_CACHE[name]


def _ray_trajectories(pt, max_levels, max_steps=400):
    """The clipped positions of the exact march's steps along the rays of a
    20x18 view (the descent from the root sets each step), [R, T, 3] with
    each ray's last position repeated past its end."""
    opt = P.RenderOptions()
    _, prays = world_rays(camera(20, 18, 16.0), opt)
    m = PA.march_inputs(pt, prays[0], prays[1], prays[2], opt)
    keep = ~m.miss & (m.tmin < m.tmax)
    t, d = m.tmin[keep], m.d[keep]
    invdir, tmax = m.invdir[keep], m.tmax[keep]
    child = pt.child.reshape(-1)
    active = torch.ones_like(t, dtype=torch.bool)
    traj = []
    pos = None
    for _ in range(max_steps):
        new = torch.clamp(P.ops.fp.fma_f32(t[:, None], d, m.cen[None, :]),
                          0.0, PR.EPS_HI)
        pos = new if pos is None else torch.where(active[:, None], new, pos)
        traj.append(pos)
        frac, _, _, depth = PR._descend(child, pos, pt.N, max_levels, None)
        delta = (PR._dda_unit_batch(frac, invdir)
                 / P.ops.fp.ipow_f32(pt.N, depth) + m.step_size)
        t = torch.where(active, t + delta, t)
        active = active & (t < tmax)
        if not bool(active.any()):
            break
    return torch.stack(traj, 1).numpy()


def _face_walks(N, depth, n_walks=6, length=40, seed=0):
    """Positions on cell faces of every level up to ``depth`` (coordinates
    j / N^l), at 0 and at the clip bound 1 - 1e-6, in random walks that mix
    near neighbours with far jumps.  [n_walks, length, 3] f32."""
    rng = np.random.default_rng(seed)
    top = N ** depth
    walks = np.empty((n_walks, length, 3), F32)
    for w in range(n_walks):
        cell = rng.integers(0, top, 3)
        for s in range(length):
            r = rng.random()
            if r < 0.6:
                cell = np.clip(cell + rng.integers(-1, 2, 3), 0, top - 1)
            elif r < 0.9:
                cell = rng.integers(0, top, 3)
            lev = int(rng.integers(0, depth + 1))
            q = (cell // N ** (depth - lev)).astype(np.float64) / N ** lev
            pos = q.astype(F32)
            edge = rng.random(3)
            pos[edge < 0.1] = F32(PR.EPS_HI)
            pos[edge > 0.95] = F32(0.0)
            walks[w, s] = pos
    return walks


@pytest.mark.parametrize("name,max_levels,source", [
    ("sphere_n2", 20, "rays"), ("sphere_n4", 20, "rays"),
    ("uneven_n2", 20, "rays"), ("sphere_n2", 3, "rays"),
    ("sphere_n4", 2, "rays"), ("uneven_n2", 3, "rays"),
    ("sphere_n2", 20, "faces"), ("sphere_n4", 20, "faces"),
    ("uneven_n2", 20, "faces"), ("sphere_n3", 20, "rays")])
def test_restarted_descent_bit_equal_to_root(name, max_levels, source):
    """Along each trajectory the restart (N = 2^b; N = 3 descends from the
    root) gives chunk, cidx, depth and the in-leaf fraction bit-equal to the
    port's and JAX's descents from the root, and marks the same chunks."""
    pt = _restart_tree(name)
    child_t = pt.child.reshape(-1)
    child = child_t.numpy()
    if source == "rays":
        traj = _ray_trajectories(pt, max_levels)
    else:
        traj = _face_walks(pt.N, 5 if pt.N == 2 else 3)
    R, T, _ = traj.shape
    flat = torch.from_numpy(traj.reshape(-1, 3))
    want = PR._descend(child_t, flat, pt.N, max_levels, None)
    jw = JR._descend(jnp.asarray(child), jnp.asarray(traj.reshape(-1, 3)),
                     pt.N, max_levels, jnp.zeros((pt.max_capacity,),
                                                 jnp.int32), True)
    for a, b in zip(want, jw[:4]):
        assert np.array_equal(a.numpy().view(np.int32),
                              np.asarray(b).view(np.int32))
    frac_w, chunk_w, cidx_w, depth_w = (a.numpy().reshape(R, T, -1)
                                        for a in want)
    union = np.zeros((pt.max_capacity,), np.int32)
    depths = set()
    restarted = 0
    for r in range(R):
        path = {"chunk": [0] * PATH_CAP, "L": 0, "p": [F32(0)] * 3}
        visited = np.zeros((pt.max_capacity,), np.int32)
        for s in range(T):
            if path["L"] > 0:
                restarted += 1
            f, c, i, d = _emulate_step(child, pt.N, max_levels, path,
                                       traj[r, s], visited)
            assert np.array_equal(f.view(np.int32),
                                  frac_w[r, s].view(np.int32)), (r, s)
            assert (c, i, d) == (chunk_w[r, s, 0], cidx_w[r, s, 0],
                                 depth_w[r, s, 0]), (r, s)
            depths.add(d)
        root = torch.zeros((pt.max_capacity,), dtype=torch.int32)
        PR._descend(child_t, torch.from_numpy(traj[r]), pt.N, max_levels,
                    root)
        np.testing.assert_array_equal(visited, root.numpy())
        union |= visited
    np.testing.assert_array_equal(union, np.asarray(jw[4]))
    print(f"{name} max_levels {max_levels} {source}: {R} x {T} positions, "
          f"leaf depths {sorted(depths)}, {restarted} restarted steps")
    assert restarted > (0 if _restart_bits(pt.N) else -1)
    assert (restarted == 0) == (_restart_bits(pt.N) == 0)
    if max_levels < 5:
        assert max(depths) == max_levels + 1   # cut descents were walked
