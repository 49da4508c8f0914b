"""The port's fast march (plain PyTorch version on the CPU) against the JAX
package's ``accel.render_rays_fast``, with and without the entry-skip
prepass, at record budgets 16, 2 (overflowing) and 0.

Tolerances, with their reasons:
  * overflow count and prepass skips: equal;
  * pixels: 1e-5 absolute.  The two sides round a few f32 ops
    differently — XLA's approximate ``rsqrt`` for ``1 / |d|`` (off by one
    ulp on ~13% of rays) and its ``exp`` — and a one-ulp change of a ray's
    setup moves its step lengths by about one ulp of the position; the
    alpha of a sample moves by sigma * delta_scale times that;
  * steps and records: equal on every ray except where the early-stop
    test ``T < stop_thresh`` is decided by such a last-bit difference;
    at most 0.1% of the rays may differ, and the test prints them.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import mega_nerf_viewer_tpu.n3tree as J
import mega_nerf_viewer_tpu_torch.n3tree as P
from mega_nerf_viewer_tpu.options import RenderOptions
from mega_nerf_viewer_tpu.ops import accel as JA
from mega_nerf_viewer_tpu.ops import pallas_march as JM
from mega_nerf_viewer_tpu_torch.options import RenderOptions as PRenderOptions
from mega_nerf_viewer_tpu_torch.ops import accel as PA
from mega_nerf_viewer_tpu_torch.ops import skip_prepass as PM

ARRAYS = ("data", "child", "parent", "sample_counts", "scale", "offset")
PIX_TOL = 1e-5
MAX_MISMATCH = 0.001


def port(jt):
    return P.tree_from_numpy(
        **{k: np.asarray(getattr(jt, k)) for k in ARRAYS},
        capacity=int(jt.capacity), data_format=jt.data_format, device="cpu")


def _random_rays(n, seed):
    """Rays from near the bench camera towards random points of the
    tree's cube (world = tree-space * 2 - 1)."""
    rng = np.random.RandomState(seed)
    cen = (np.array([-1.4, 0.1, 1.3]) + 0.05 * rng.randn(3)).astype(
        np.float32)
    target = rng.uniform(-0.8, 0.8, size=(n, 3))
    d = target - cen
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return d, cen


_SCENES = {}


def _scene(name):
    if name not in _SCENES:
        jt = {"sphere5": lambda: J.sphere_tree(basis_dim=4, depth=5),
              "shell6": lambda: J.shell_tree(depth=6, basis_dim=9)}[name]()
        opt = RenderOptions()
        _SCENES[name] = (jt, JA.build_leaf_map(jt),
                         JM.build_skip_table(jt, opt.sigma_thresh))
    jt, lm, tab = _SCENES[name]
    pt = port(jt)
    return jt, lm, tab, pt, PA.build_leaf_map(pt), \
        PM.build_skip_table(pt, RenderOptions().sigma_thresh)


def _compare(rj, rp, R):
    out_j = np.asarray(rj.out)
    err = float(np.abs(out_j - rp.out.numpy()).max())
    assert err <= PIX_TOL, err
    assert int(rp.overflow) == int(rj.overflow)
    np.testing.assert_array_equal(rp.skips.numpy(), np.asarray(rj.skips))
    bad = np.nonzero((rp.steps.numpy() != np.asarray(rj.steps))
                     | (rp.nrec.numpy() != np.asarray(rj.nrec)))[0]
    if len(bad):
        print("steps/nrec mismatch on rays", bad.tolist(),
              "jax", np.asarray(rj.steps)[bad], np.asarray(rj.nrec)[bad],
              "port", rp.steps.numpy()[bad], rp.nrec.numpy()[bad])
    assert len(bad) <= MAX_MISMATCH * R
    return err


@pytest.mark.parametrize("skip", [False, True])
@pytest.mark.parametrize("max_dense", [16, 2, 0])
def test_march_matches_jax_sphere(max_dense, skip):
    jt, lm, tab, pt, plm, ptab = _scene("sphere5")
    d, cen = _random_rays(4096, seed=max_dense)
    rj = JA.render_rays_fast(jt, lm, jnp.asarray(d), jnp.asarray(d),
                             jnp.asarray(cen), RenderOptions(),
                             max_dense=max_dense,
                             skip_table=tab if skip else None)
    rp = PA.render_rays_fast(pt, plm, torch.as_tensor(d),
                             torch.as_tensor(d), torch.as_tensor(cen),
                             PRenderOptions(), max_dense=max_dense,
                             skip_table=ptab if skip else None)
    _compare(rj, rp, 4096)
    if max_dense == 2:
        assert int(rp.overflow) > 0          # the budget really overflows
    if max_dense == 0:
        assert np.all(rp.out.numpy()[:, :3] == 0)
    if skip:
        assert int(rp.skips.sum()) > 0


@pytest.mark.parametrize("skip", [False, True])
def test_march_matches_jax_shell(skip):
    jt, lm, tab, pt, plm, ptab = _scene("shell6")
    d, cen = _random_rays(4096, seed=5)
    vd = np.roll(d, 1, axis=0)            # view dirs need not equal dirs
    rj = JA.render_rays_fast(jt, lm, jnp.asarray(d), jnp.asarray(vd),
                             jnp.asarray(cen), RenderOptions(),
                             max_dense=16, skip_table=tab if skip else None)
    rp = PA.render_rays_fast(pt, plm, torch.as_tensor(d),
                             torch.as_tensor(vd), torch.as_tensor(cen),
                             PRenderOptions(), max_dense=16,
                             skip_table=ptab if skip else None)
    _compare(rj, rp, 4096)
    assert float(rp.out[:, 3].max()) > 0.5


def test_march_dyn_knobs_and_deep_levels():
    """``dyn`` overrides the knobs; a forced-low map level makes every
    step resume the descent (deep_levels), with identical results."""
    jt, lm, tab, pt, plm, ptab = _scene("sphere5")
    d, cen = _random_rays(2048, seed=9)
    opt = RenderOptions(sigma_thresh=5.0, stop_thresh=0.05)
    dyn = (opt.step_size, opt.sigma_thresh, opt.stop_thresh) + \
        tuple(opt.render_bbox)
    lm3 = JA.build_leaf_map(jt, level=3)
    plm3 = PA.build_leaf_map(pt, level=3)
    assert plm3.deep_levels == 2
    rj = JA.render_rays_fast(jt, lm3, jnp.asarray(d), jnp.asarray(d),
                             jnp.asarray(cen), RenderOptions(), max_dense=8,
                             dyn=jnp.asarray(dyn, jnp.float32))
    rp = PA.render_rays_fast(pt, plm3, torch.as_tensor(d),
                             torch.as_tensor(d), torch.as_tensor(cen),
                             PRenderOptions(), max_dense=8, dyn=dyn)
    _compare(rj, rp, 2048)
    # the same knobs through opt give the same result
    rp2 = PA.render_rays_fast(pt, plm3, torch.as_tensor(d),
                              torch.as_tensor(d), torch.as_tensor(cen),
                              PRenderOptions(sigma_thresh=5.0,
                                             stop_thresh=0.05),
                              max_dense=8)
    assert torch.equal(rp.out, rp2.out)


def test_march_tmax_bg_matches_jax():
    """A background depth per ray (the onscreen mesh surface) cuts rays
    short; the march must stop where JAX stops."""
    jt, lm, tab, pt, plm, ptab = _scene("sphere5")
    d, cen = _random_rays(2048, seed=4)
    tbg = np.random.RandomState(4).uniform(1.0, 3.0, 2048).astype(
        np.float32)
    rj = JA.render_rays_fast(jt, lm, jnp.asarray(d), jnp.asarray(d),
                             jnp.asarray(cen), RenderOptions(), max_dense=8,
                             tmax_bg=jnp.asarray(tbg), skip_table=tab)
    rp = PA.render_rays_fast(pt, plm, torch.as_tensor(d),
                             torch.as_tensor(d), torch.as_tensor(cen),
                             PRenderOptions(), max_dense=8,
                             tmax_bg=torch.as_tensor(tbg), skip_table=ptab)
    _compare(rj, rp, 2048)
    full = PA.render_rays_fast(pt, plm, torch.as_tensor(d),
                               torch.as_tensor(d), torch.as_tensor(cen),
                               PRenderOptions(), max_dense=8,
                               skip_table=ptab)
    assert int(rp.steps.sum()) < int(full.steps.sum())


def test_march_reference_chunking_is_exact():
    _, _, _, pt, plm, ptab = _scene("sphere5")
    d, cen = _random_rays(1000, seed=3)
    args = (pt, plm, torch.as_tensor(d), torch.as_tensor(d),
            torch.as_tensor(cen), PRenderOptions())
    a = PA.render_rays_fast(*args, max_dense=4, skip_table=ptab)
    b = PA.render_rays_fast(*args, max_dense=4, skip_table=ptab,
                            chunk_size=256)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_march_votes_and_depth_not_ported():
    """Votes and depth mode, which raised before the refinement slice,
    now run: on these rays they match JAX (votes equal, pixels within
    PIX_TOL; ``test_torch_votes.py`` holds them in full)."""
    jt, jlm, _, pt, plm, _ = _scene("sphere5")
    d, cen = _random_rays(8, seed=0)
    args = (pt, plm, torch.as_tensor(d), torch.as_tensor(d),
            torch.as_tensor(cen))
    jargs = (jt, jlm, jnp.asarray(d), jnp.asarray(d), jnp.asarray(cen))
    for opt, kw in ((RenderOptions(), dict(need_votes=True)),
                    (RenderOptions(render_depth=True), {})):
        popt = PRenderOptions(render_depth=opt.render_depth)
        rp = PA.render_rays_fast(*args, popt, max_dense=16, **kw)
        rj = JA.render_rays_fast(*jargs, opt, max_dense=16, chunk_size=0,
                                 **kw)
        assert float(np.abs(rp.out.numpy() - np.asarray(rj.out)).max()) \
            <= PIX_TOL
        for k in ("split_vote", "sample_vote"):
            np.testing.assert_array_equal(getattr(rp, k).numpy(),
                                          np.asarray(getattr(rj, k)))
