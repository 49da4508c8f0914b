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


def _tile_order(data, opt, basis_dim, fmt_sh, W=8):
    """Kernel G's arithmetic in its order, on the CPU in f32: ray r's valid
    slots in chunks of W lanes; per chunk the inclusive product of wc (1
    on the last valid slot and past it) by W-lane doubling shifts, shifted
    to exclusive and scaled by the carry from the chunks before; each lane
    sums weight * colour over its chunks; a butterfly sums the W lanes."""
    results, z, ns, vdirs = (torch.as_tensor(a) for a in data)
    R, S, out_dim = results.shape
    sidx = min(3, out_dim - 1)
    mode = PC._mode(opt, fmt_sh, basis_dim)
    B = basis_dim
    if mode == PC.MODE_SH:
        from mega_nerf_viewer_tpu_torch.ops.sh import masked_sh_basis
        basis = masked_sh_basis(B, vdirs, opt.basis_minmax[0],
                                opt.basis_minmax[1])
    ns = ns.long()
    lane = torch.arange(W)
    one = torch.ones((), dtype=torch.float32)
    carry = torch.ones(R)
    acc = torch.zeros(R, W, 3)
    for c in range(0, S, W):
        i = c + lane                                         # [W]
        valid = i[None, :] < ns[:, None]                     # [R, W]
        last = i[None, :] == ns[:, None] - 1
        ic = i.clamp(max=S - 1)
        zi = torch.where(valid, z[:, ic], 0.0)
        zn = torch.where(i[None, :] + 1 < ns[:, None],
                         z[:, (i + 1).clamp(max=S - 1)], 0.0)
        delta = torch.where(last, 0.0, zn - zi)
        row = results[:, ic]                                 # [R, W, D]
        wc = torch.where(valid, torch.exp(-row[..., sidx] * delta), one)
        incl = torch.where(valid & ~last, wc, one)
        off = 1
        while off < W:
            up = torch.cat([torch.ones(R, off), incl[:, :-off]], 1)
            incl = torch.where(lane[None, :] >= off, incl * up, incl)
            off *= 2
        excl = torch.cat([torch.ones(R, 1), incl[:, :-1]], 1)
        T = carry[:, None] * excl
        weight = torch.where(last, T, T * (1.0 - wc))
        if mode == PC.MODE_DEPTH:
            col = (weight * T)[..., None].expand(R, W, 3)
            contrib = col
        else:
            if mode == PC.MODE_SH:
                lg = torch.zeros(R, W, 3)
                for b in range(B):
                    for k in range(3):
                        lg[..., k] = lg[..., k] + basis[:, None, b] \
                            * row[..., k * B + b]
                rgb = 1.0 / (1.0 + torch.exp(-lg))
            else:
                rgb = row[..., :3]
            contrib = weight[..., None] * rgb
        acc = acc + torch.where(valid[..., None], contrib, 0.0)
        carry = carry * incl[:, W - 1]
    off = W // 2
    while off:
        acc = acc + acc[:, lane ^ off]
        off //= 2
    rgb = acc[:, 0]
    if mode == PC.MODE_DEPTH:
        rgb = torch.clamp_max(rgb[:, :1] * 0.3, 1.0).expand(R, 3)
    return torch.cat([rgb, torch.ones(R, 1)], 1).numpy()


@pytest.mark.parametrize("S", [1, 7, 8, 9, 32, 33, 128])
@pytest.mark.parametrize("mode", ["sh", "depth", "rgb"])
def test_tile_order_matches_plain_and_pallas(S, mode):
    """Kernel G's tile order (chunks of W lanes, a doubling-shift product
    per chunk, a carry across chunks, a butterfly sum) against the plain
    version and the Pallas kernel, within 1e-6 at the kernel's W = 8; with
    rays of 0 and of S valid slots and opaque samples."""
    basis_dim = {"sh": 4, "depth": 1, "rgb": 1}[mode]
    rng = np.random.RandomState(S + 1000 * len(mode))
    results, z, ns, vdirs = _data(rng, R=16, S=S, basis_dim=basis_dim)
    ns[:2] = 0
    ns[2:5] = S
    results[5::4, 0, min(3, results.shape[2] - 1)] = 1e8   # opaque
    data = (results, z, ns, vdirs)
    fmt_sh = mode != "rgb"
    jopt, popt = _opts(render_depth=mode == "depth")
    plain = _port(data, popt, basis_dim, fmt_sh)
    pallas = None
    if fmt_sh:              # the Pallas kernel has no branch for non-SH trees
        pallas = np.asarray(composite_results_pallas(
            *(jnp.asarray(a) for a in data), jopt, basis_dim,
            interpret=True))
    got = _tile_order(data, popt, basis_dim, fmt_sh)
    assert np.isfinite(got).all()
    assert (got[:2] == [0, 0, 0, 1]).all()
    assert float(np.abs(got - plain).max()) <= 1e-6
    if pallas is not None:
        assert float(np.abs(got - pallas).max()) <= 1e-6
