"""The port's compact compositor (plain PyTorch version on the CPU)
against the JAX package: ``guided.composite_results_compact`` (the XLA
route) and ``pallas_composite.composite_results_compact_pallas`` (the
Pallas kernel, in interpret mode as its own tests run it).

Tolerance: 1e-6 absolute on rgba.  The two sides compose the same f32
ops per sample; only the order of the products and sums differs (JAX
scans in a tree, the port runs along each ray).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mega_nerf_viewer_tpu.options import RenderOptions
from mega_nerf_viewer_tpu.ops import guided as JG
from mega_nerf_viewer_tpu.ops.pallas_composite import \
    composite_results_compact_pallas
from mega_nerf_viewer_tpu_torch import kernels
from mega_nerf_viewer_tpu_torch.options import RenderOptions as PRenderOptions
from mega_nerf_viewer_tpu_torch.ops import compact_composite as PC
from mega_nerf_viewer_tpu_torch.ops import guided as PG

TOL = 1e-6
f32 = np.float32


def _compact_data(rng, R=500, basis_dim=9, M=4096, max_ns=7):
    """The compact layout of ``_compact_reconstruct``: sorted ray_of_p,
    inclusive offs, a padded tail (``test_pallas.py:54-71``)."""
    out_dim = 3 * basis_dim + 2
    ns = rng.randint(0, max_ns, R).astype(np.int32)
    assert int(ns.sum()) <= M
    offs = np.cumsum(ns).astype(np.int32)
    ray_of_p = np.clip(np.searchsorted(offs, np.arange(M), side="right"),
                       0, R - 1).astype(np.int32)
    res_c = rng.randn(M, out_dim).astype(f32)
    res_c[:, min(3, out_dim - 1)] = np.abs(res_c[:, min(3, out_dim - 1)]) * 3
    z = np.sort(rng.rand(M).astype(f32) * 2)
    vdirs = rng.randn(R, 3).astype(f32)
    vdirs /= np.linalg.norm(vdirs, axis=-1, keepdims=True)
    return res_c, z, ray_of_p, offs, ns, vdirs


def _jax(args, vdirs_ray, opt, basis_dim, fmt_sh=True):
    res_c, z, ray_of_p, offs, ns = args
    return np.asarray(JG.composite_results_compact(
        jnp.asarray(res_c), jnp.asarray(z), jnp.asarray(ray_of_p),
        jnp.asarray(offs), jnp.asarray(ns), jnp.asarray(vdirs_ray),
        opt, basis_dim, fmt_sh))


def _port(fn, args, vdirs, opt, basis_dim, fmt_sh=True):
    t = [torch.as_tensor(a) for a in args]
    return fn(*t, torch.as_tensor(vdirs), opt, basis_dim, fmt_sh).numpy()


def _check(got, want):
    assert got.shape == want.shape and got.dtype == np.float32
    assert np.isfinite(got).all()
    err = float(np.abs(got - want).max())
    print("max abs diff", err)
    assert err <= TOL, err


@pytest.mark.parametrize("basis_dim,minmax", [
    (1, None), (4, None), (9, None), (16, None), (25, None), (9, (1, 5))])
def test_compact_reference_matches_jax(basis_dim, minmax):
    rng = np.random.RandomState(basis_dim)
    res_c, z, ray_of_p, offs, ns, vdirs = _compact_data(
        rng, basis_dim=basis_dim)
    kw = {} if minmax is None else dict(basis_minmax=minmax)
    args = (res_c, z, ray_of_p, offs, ns)
    want = _jax(args, vdirs, RenderOptions(**kw), basis_dim)
    popt = PRenderOptions(**kw)
    # the kernel's plain version, with per-sample view directions
    _check(_port(PC.composite_results_compact_reference, args,
                 vdirs[ray_of_p], popt, basis_dim), want)
    # the per-ray route of composite_frame
    _check(_port(PG.composite_results_compact, args, vdirs, popt,
                 basis_dim), want)
    assert (want[ns == 0] == [0, 0, 0, 1]).all()


def test_compact_matches_pallas_kernel():
    """One block-multiple budget (M = 2048) through the Pallas kernel."""
    rng = np.random.RandomState(11)
    res_c, z, ray_of_p, offs, ns, vdirs = _compact_data(
        rng, R=300, basis_dim=9, M=2048)
    vdirs_c = vdirs[ray_of_p]
    args = (res_c, z, ray_of_p, offs, ns)
    opt = RenderOptions()
    want = np.asarray(composite_results_compact_pallas(
        *(jnp.asarray(a) for a in args), jnp.asarray(vdirs_c), opt, 9, True,
        interpret=True))
    _check(_port(PC.composite_results_compact_kernel, args, vdirs_c,
                 PRenderOptions(), 9), want)


def test_compact_opaque_sample_no_nan():
    """An opaque sample (exp underflows to exactly 0) must give T = 0
    after it, not NaN (``test_pallas.py:135``)."""
    rng = np.random.RandomState(7)
    res_c, z, ray_of_p, offs, ns, vdirs = _compact_data(rng, basis_dim=1)
    starts = np.concatenate([[0], offs[:-1]]).astype(np.int64)
    res_c[starts[ns >= 2], 3] = 1e8
    args = (res_c, z, ray_of_p, offs, ns)
    want = _jax(args, vdirs, RenderOptions(), 1)
    assert np.isfinite(want).all()
    got = _port(PC.composite_results_compact_reference, args,
                vdirs[ray_of_p], PRenderOptions(), 1)
    _check(got, want)
    # an opaque first sample leaves the rest of the ray nothing
    two = ns >= 2
    assert np.isfinite(got[two]).all()


def test_compact_rgba_format_and_empty_rays():
    """A cache that is not SH composites res[:, :3] as they are
    (``test_guided.py:479``); rays with no samples are (0, 0, 0, 1)."""
    rng = np.random.RandomState(3)
    R, out_dim, M = 40, 4, 2048
    ns = rng.randint(0, 9, R).astype(np.int32)
    ns[::5] = 0
    offs = np.cumsum(ns).astype(np.int32)
    ray_of_p = np.clip(np.searchsorted(offs, np.arange(M), "right"),
                       0, R - 1).astype(np.int32)
    res_c = rng.randn(M, out_dim).astype(f32)
    res_c[:, 3] = np.abs(res_c[:, 3]) * 3
    z = np.sort(rng.rand(M).astype(f32) * 2)
    vdirs = rng.randn(R, 3).astype(f32)
    args = (res_c, z, ray_of_p, offs, ns)
    want = _jax(args, vdirs, RenderOptions(), 1, fmt_sh=False)
    got = _port(PC.composite_results_compact_kernel, args, vdirs[ray_of_p],
                PRenderOptions(), 1, fmt_sh=False)
    _check(got, want)
    assert (ns == 0).sum() >= 8
    assert (got[ns == 0] == [0, 0, 0, 1]).all()
    assert (got[:, 3] == 1).all()


def test_compact_depth_mode_and_cpu_dispatch():
    """Depth mode (``guided.py:706-707``, ``:724-726``) against JAX's
    ``composite_results_compact`` with ``render_depth``, within 1e-6, with
    or without view directions (depth reads none); then the CPU dispatch."""
    rng = np.random.RandomState(5)
    res_c, z, ray_of_p, offs, ns, vdirs = _compact_data(rng, basis_dim=4)
    args = [torch.as_tensor(a) for a in (res_c, z, ray_of_p, offs, ns)]
    vd = torch.as_tensor(vdirs[ray_of_p])
    for fmt_sh in (True, False):
        want = _jax((res_c, z, ray_of_p, offs, ns), vdirs,
                    RenderOptions(render_depth=True), 4, fmt_sh)
        for v in (vd, None):
            got = PC.composite_results_compact_kernel(
                *args, v, PRenderOptions(render_depth=True), 4, fmt_sh)
            _check(got.numpy(), want)
        assert (want[:, 3] == 1).all() and (want[ns == 0, :3] == 0).all()
        assert np.array_equal(want[:, 0], want[:, 2])
        assert want[:, 0].max() > 0
    before = dict(kernels.LAUNCHES)
    a = PC.composite_results_compact_kernel(*args, vd, PRenderOptions(), 4,
                                            True)
    b = PC.composite_results_compact_reference(*args, vd, PRenderOptions(),
                                               4, True)
    assert torch.equal(a, b)
    assert kernels.LAUNCHES == before       # a CPU tensor launches nothing
    with pytest.raises(ValueError, match="CUDA tensors only"):
        kernels.compact_composite(args[0], args[1], args[3], args[4], vd, 4,
                                  True, 0, 24)
