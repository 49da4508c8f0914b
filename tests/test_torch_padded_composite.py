"""The port's padded compositor (plain PyTorch version on the CPU) against
the JAX package: ``guided.composite_results`` (the XLA route that
``composite_frame`` runs on the padded cache) and
``pallas_composite.composite_results_pallas`` (the Pallas kernel, in
interpret mode as ``tests/test_pallas.py`` runs it).

Tolerances, with their reasons:
  * against the XLA route: 1e-5 absolute on rgba.  Both sides compose the
    same f32 ops per slot with an exclusive ``cumprod`` of the same
    factors; XLA's ``exp`` and the order of the basis products may round
    an ulp apart;
  * against the Pallas kernel: rtol 2e-4 and atol 2e-5, the bounds of
    ``test_pallas.py``.  The TPU kernel forms the transmittance by a
    doubling prefix product instead of a running product.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mega_nerf_viewer_tpu.options import RenderOptions
from mega_nerf_viewer_tpu.ops import guided as JG
from mega_nerf_viewer_tpu.ops.pallas_composite import \
    composite_results_pallas
from mega_nerf_viewer_tpu_torch import kernels
from mega_nerf_viewer_tpu_torch.options import RenderOptions as PRenderOptions
from mega_nerf_viewer_tpu_torch.ops import guided as PG
from mega_nerf_viewer_tpu_torch.ops import padded_composite as PC

TOL = 1e-5
f32 = np.float32


def _data(rng, R=24, S=128, basis_dim=1):
    """The padded layout of ``test_pallas.py:17-27``: 0-S valid slots per
    ray, sigma >= 0, increasing z, unit view directions."""
    out_dim = 3 * basis_dim + 2
    results = rng.randn(R, S, out_dim).astype(f32)
    results[..., min(3, out_dim - 1)] = np.abs(
        results[..., min(3, out_dim - 1)]) * 3
    z = np.sort(rng.rand(R, S).astype(f32) * 2, axis=1)
    ns = rng.randint(0, S + 1, R).astype(np.int32)
    vdirs = rng.randn(R, 3).astype(f32)
    vdirs /= np.linalg.norm(vdirs, axis=-1, keepdims=True)
    return results, z, ns, vdirs


def _opts(**kw):
    return RenderOptions(**kw), PRenderOptions(**kw)


def _jax(data, opt, basis_dim, fmt_sh=True):
    return np.asarray(JG.composite_results(
        *(jnp.asarray(a) for a in data), opt, basis_dim, fmt_sh))


def _port(data, opt, basis_dim, fmt_sh=True):
    return PC.composite_results_padded(
        *(torch.as_tensor(a) for a in data), opt, basis_dim,
        fmt_sh).numpy()


@pytest.mark.parametrize("basis_dim,depth,fmt_sh,minmax", [
    (1, False, True, (0, 24)), (9, False, True, (0, 24)),
    (9, False, True, (1, 5)), (4, True, True, (0, 24)),
    (4, False, False, (0, 24))])
def test_padded_matches_xla(basis_dim, depth, fmt_sh, minmax):
    rng = np.random.RandomState(basis_dim + 10 * depth)
    data = _data(rng, R=40, S=32, basis_dim=basis_dim)
    jopt, popt = _opts(render_depth=depth, basis_minmax=minmax)
    want = _jax(data, jopt, basis_dim, fmt_sh)
    got = _port(data, popt, basis_dim, fmt_sh)
    err = float(np.abs(got - want).max())
    print(f"basis {basis_dim} depth {depth} sh {fmt_sh}: max abs diff "
          f"{err:.3e}")
    assert got.shape == want.shape and got.dtype == np.float32
    assert err <= TOL
    assert (got[:, 3] == 1).all()


@pytest.mark.parametrize("basis_dim,depth,R", [
    (1, False, 24), (9, False, 24), (1, True, 24), (1, False, 13),
    (9, True, 13)])
def test_padded_matches_pallas(basis_dim, depth, R):
    """Against the Pallas kernel, including row counts its 8-row tile
    does not divide (``test_pallas.py:39``, ``:122``)."""
    rng = np.random.RandomState(100 + basis_dim + R)
    data = _data(rng, R=R, S=128, basis_dim=basis_dim)
    jopt, popt = _opts(render_depth=depth)
    want = np.asarray(composite_results_pallas(
        *(jnp.asarray(a) for a in data), jopt, basis_dim, interpret=True))
    got = _port(data, popt, basis_dim)
    assert got.shape == (R, 4)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


def test_opaque_and_empty_rays():
    """An opaque sample zeroes the transmittance after it (no NaN); a ray
    without samples is (0, 0, 0, 1); the last valid slot takes all the
    remaining transmittance."""
    rng = np.random.RandomState(3)
    results, z, ns, vdirs = _data(rng, R=16, S=8, basis_dim=1)
    results[:, 0, 3] = 1e30
    ns[:4] = 0
    ns[4:8] = 1
    jopt, popt = _opts()
    got = _port((results, z, ns, vdirs), popt, 1)
    want = _jax((results, z, ns, vdirs), jopt, 1)
    assert np.isfinite(got).all()
    assert (got[:4] == [0, 0, 0, 1]).all()
    # one valid slot: weight T = 1 on it, so rgb is its sigmoid colour
    np.testing.assert_allclose(got[4:8, :3], want[4:8, :3], atol=TOL)
    assert float(np.abs(got - want).max()) <= TOL


def test_composite_results_routes_to_padded():
    """``guided.composite_results`` is the padded compositor's entry."""
    rng = np.random.RandomState(4)
    data = _data(rng, R=20, S=16, basis_dim=4)
    popt = PRenderOptions()
    a = PG.composite_results(*(torch.as_tensor(x) for x in data), popt, 4,
                             True)
    b = PC.composite_results_padded_reference(
        *(torch.as_tensor(x) for x in data), popt, 4, True)
    assert torch.equal(a, b)


def test_cpu_tensors_launch_nothing():
    rng = np.random.RandomState(5)
    data = [torch.as_tensor(a) for a in _data(rng, R=8, S=4, basis_dim=1)]
    before = dict(kernels.LAUNCHES)
    PC.composite_results_padded(*data, PRenderOptions(), 1, True)
    assert kernels.LAUNCHES == before
    with pytest.raises(ValueError, match="CUDA tensors only"):
        kernels.padded_composite(data[0], data[1], data[2],
                                 torch.zeros((8, 1)), PC.MODE_SH)
