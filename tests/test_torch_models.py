"""The port's Mega-NeRF MLP container against the JAX package's.

Tolerances, with their reasons:
  * weights (``synthetic``, ``from_torchscript``, ``params_from_numpy``)
    and cluster ids: equal;
  * MLP outputs: rtol 1e-5 / atol 1e-6.  Both sides run f32 matrix
    products, but the summation order inside a product differs between
    XLA and PyTorch.
"""

import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch
import torch.nn as nn

from mega_nerf_viewer_tpu.models import MegaNeRFModel as JModel
from mega_nerf_viewer_tpu.models import meganerf as JM
from mega_nerf_viewer_tpu_torch.models import MegaNeRFModel as PModel
from mega_nerf_viewer_tpu_torch.models import meganerf as PM

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "fixtures", "meganerf_8x64.pt")
RTOL, ATOL = 1e-5, 1e-6


def _params(jparams):
    return PM.params_from_numpy([np.asarray(w) for w in jparams.weights],
                                [np.asarray(b) for b in jparams.biases],
                                jparams.skips, device="cpu")


def _assert_weights_equal(jparams, pparams):
    assert pparams.skips == tuple(jparams.skips)
    assert len(pparams.weights) == len(jparams.weights)
    for a, b in zip(jparams.weights + jparams.biases,
                    pparams.weights + pparams.biases):
        assert b.dtype == torch.float32
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


@pytest.mark.parametrize("kw", [
    dict(),
    dict(data_dim=4, n_clusters=8, hidden=64, n_layers=8, grid_dim=(2, 4),
         min_position=(-1.5, -1.5, -1.5), max_position=(1.5, 1.5, 1.5),
         need_viewdir=True),
    dict(data_dim=28, n_clusters=2, grid_dim=(1, 2), seed=3,
         need_appearance_embedding=True)])
def test_synthetic_weights_array_equal(kw):
    j = JModel.synthetic(**kw)
    p = PModel.synthetic(device="cpu", **kw)
    _assert_weights_equal(j.params, p.params)
    for k in ("grid_dim", "min_position", "max_position", "range"):
        np.testing.assert_array_equal(getattr(p, k), getattr(j, k))
        assert getattr(p, k).dtype == getattr(j, k).dtype
    assert p.need_viewdir == j.need_viewdir
    assert p.need_appearance_embedding == j.need_appearance_embedding
    assert (p.n_clusters, p.output_dim) == (j.n_clusters, j.output_dim)


def test_params_from_numpy_round_trip():
    j = JModel.synthetic(data_dim=4, n_clusters=3, grid_dim=(3, 1),
                         hidden=16, n_layers=4, seed=5)
    p = _params(j.params)
    _assert_weights_equal(j.params, p)
    again = PM.params_from_numpy([w.numpy() for w in p.weights],
                                 [b.numpy() for b in p.biases], p.skips,
                                 device="cpu")
    _assert_weights_equal(j.params, again)
    assert (p.n_clusters, p.input_dim, p.output_dim) == (3, 3, 5)
    m = PM.model_from_numpy([np.asarray(w) for w in j.params.weights],
                            [np.asarray(b) for b in j.params.biases], (),
                            j.grid_dim, j.min_position, j.max_position,
                            False, False, device="cpu")
    _assert_weights_equal(j.params, m.params)
    np.testing.assert_array_equal(m.range, j.range)


def _inputs(n, in_dim, C, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, in_dim).astype(np.float32),
            rng.randint(0, C, n).astype(np.int32))


@pytest.mark.parametrize("n", [700, (1 << 16) + 77])
def test_query_grouped_matches_jax(n):
    """Both routes of the dispatcher: all-clusters select below 2^16
    samples, the chunked route at and above."""
    j = JModel.synthetic(data_dim=4, n_clusters=8, grid_dim=(2, 4),
                         hidden=32, n_layers=4, need_viewdir=True, seed=1)
    p = _params(j.params)
    x, ids = _inputs(n, 6, 8, seed=n % 7)
    want = np.asarray(JM.query_grouped(j.params, jnp.asarray(ids),
                                       jnp.asarray(x)))
    got = PM.query_grouped(p, torch.as_tensor(ids), torch.as_tensor(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_mlp_forward_and_forward_all_match_jax():
    j = JModel.synthetic(data_dim=4, n_clusters=4, hidden=32, n_layers=3,
                         seed=2)
    p = _params(j.params)
    x, ids = _inputs(300, 3, 4, seed=2)
    for c in range(4):
        want = np.asarray(JM.mlp_forward(j.params, jnp.int32(c),
                                         jnp.asarray(x)))
        got = PM.mlp_forward(p, c, torch.as_tensor(x)).numpy()
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    want = np.asarray(JM.mlp_forward_all(j.params, jnp.asarray(ids),
                                         jnp.asarray(x)))
    got = PM.mlp_forward_all(p, torch.as_tensor(ids), torch.as_tensor(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_forward_with_skips():
    """Skip-concat layers on every route (``test_models.py:163``
    analogue), with uneven and empty clusters on the chunked route."""
    rng = np.random.RandomState(4)
    C, in_dim, h = 5, 4, 16
    dims = [(in_dim, h), (h, h), (h + in_dim, h), (h, 6)]
    w = [(rng.randn(C, a, b) * 0.3).astype(np.float32) for a, b in dims]
    b = [(rng.randn(C, o) * 0.1).astype(np.float32) for _, o in dims]
    jp = JM.MLPParams(weights=[jnp.asarray(a) for a in w],
                      biases=[jnp.asarray(a) for a in b], skips=(2,))
    pp = PM.params_from_numpy(w, b, (2,), device="cpu")
    n = 1000
    x = rng.randn(n, in_dim).astype(np.float32)
    ids = rng.choice([0, 1, 3, 4], size=n,
                     p=[0.7, 0.1, 0.15, 0.05]).astype(np.int32)
    want = np.asarray(JM._query_chunked(jp, jnp.asarray(ids),
                                        jnp.asarray(x), 64))
    got = PM._query_chunked(pp, torch.as_tensor(ids), torch.as_tensor(x), 64)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    got_all = PM.mlp_forward_all(pp, torch.as_tensor(ids), torch.as_tensor(x))
    np.testing.assert_allclose(got_all.numpy(), want, rtol=RTOL, atol=ATOL)
    want0 = np.asarray(JM.mlp_forward(jp, jnp.int32(3), jnp.asarray(x[:50])))
    got0 = PM.mlp_forward(pp, 3, torch.as_tensor(x[:50]))
    np.testing.assert_allclose(got0.numpy(), want0, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("route", ["one", "all", "chunked"])
def test_mlp_forward_is_one_fused_product_a_layer(monkeypatch, route):
    """A Linear/ReLU stack runs each layer, the skip layer included, as one
    call of the fused product (``mlp_gemm``, whose plain version runs on
    the CPU) on every route, with JAX's outputs."""
    rng = np.random.RandomState(5)
    C, in_dim, h = 4, 4, 16
    dims = [(in_dim, h), (h, h), (h + in_dim, h), (h, 6)]
    w = [(rng.randn(C, a, b) * 0.3).astype(np.float32) for a, b in dims]
    b = [(rng.randn(C, o) * 0.1).astype(np.float32) for _, o in dims]
    jp = JM.MLPParams(weights=[jnp.asarray(a) for a in w],
                      biases=[jnp.asarray(a) for a in b], skips=(2,))
    pp = PM.params_from_numpy(w, b, (2,), device="cpu")
    x = rng.randn(300, in_dim).astype(np.float32)
    ids = rng.randint(0, C, 300).astype(np.int32)
    calls = []
    plain = PM.mlp_gemm_reference
    monkeypatch.setattr(PM, "mlp_gemm_reference",
                        lambda *a, **k: calls.append(a[3].numel())
                        or plain(*a, **k))
    xt, it = torch.as_tensor(x), torch.as_tensor(ids)
    if route == "one":
        got = PM.mlp_forward(pp, 2, xt)
        want = JM.mlp_forward(jp, jnp.int32(2), jnp.asarray(x))
    elif route == "all":
        got = PM.mlp_forward_all(pp, it, xt)
        want = JM.mlp_forward_all(jp, jnp.asarray(ids), jnp.asarray(x))
    else:
        got = PM._query_chunked(pp, it, xt, 64)
        want = JM._query_chunked(jp, jnp.asarray(ids), jnp.asarray(x), 64)
    assert len(calls) == pp.n_layers == 4
    # groups a call: one cluster, every cluster, or one chunk each
    assert set(calls) == {dict(one=1, all=C, chunked=-(-300 // 64) + C)[
        route]}
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_cluster_ids_equal_on_boundaries():
    """The f32 grid over (y, z), on a lattice through every cell
    boundary and outside the box, through the function and the model."""
    kw = dict(n_clusters=8, grid_dim=(2, 4), min_position=(-1.5, -1.5, -1.5),
              max_position=(1.5, 1.5, 1.5))
    j = JModel.synthetic(**kw)
    p = PModel.synthetic(device="cpu", **kw)
    edges = np.linspace(-1.5, 1.5, 13, dtype=np.float32)   # cell edges
    vals = np.concatenate([edges, np.nextafter(edges, np.float32(-9)),
                           np.nextafter(edges, np.float32(9)),
                           np.float32([-7.0, 7.0, 0.0])]).astype(np.float32)
    y, z = (a.reshape(-1) for a in np.meshgrid(vals, vals, indexing="ij"))
    yz = np.stack([y, z], -1)
    want = np.asarray(JM.cluster_ids_from_yz(
        jnp.asarray(y), jnp.asarray(z), jnp.asarray(j.grid_dim),
        jnp.asarray(j.min_position), jnp.asarray(j.range)))
    got = PM.cluster_ids_from_yz(torch.as_tensor(y), torch.as_tensor(z),
                                 p.grid_dim, p.min_position, p.range)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        p.cluster_ids_device(torch.as_tensor(yz)).numpy(), want)
    np.testing.assert_array_equal(p.cluster_ids_for_points(yz),
                                  j.cluster_ids_for_points(yz))
    assert set(np.unique(want)) == set(range(8))


def test_from_torchscript_fixture():
    """The 8x64 container with skips, viewdir and appearance: converted
    weights equal the JAX conversion; outputs agree with the TorchScript
    forward and with JAX."""
    j = JModel.from_torchscript(FIXTURE)
    p = PModel.from_torchscript(FIXTURE, device="cpu")
    _assert_weights_equal(j.params, p.params)
    assert p.params.skips == (4,)
    for k in ("grid_dim", "min_position", "max_position"):
        np.testing.assert_array_equal(getattr(p, k), getattr(j, k))
    assert p.need_viewdir and p.need_appearance_embedding
    x = np.random.RandomState(0).randn(64, 7).astype(np.float32)
    ids = np.arange(64, dtype=np.int32) % 4
    container = torch.jit.load(FIXTURE)
    got = p.query_device(ids, x).numpy()
    for c in range(4):
        with torch.inference_mode():
            want = getattr(container, f"sub_module_{c}")(
                torch.from_numpy(x), False).numpy()
        np.testing.assert_allclose(got[ids == c], want[ids == c],
                                   rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(
        got, np.asarray(j.query_device(jnp.asarray(ids), jnp.asarray(x))),
        rtol=RTOL, atol=ATOL)


def _save_container(tmp_path, sub_cls, name):
    class Container(nn.Module):
        def __init__(self):
            super().__init__()
            self.grid_dim = torch.tensor([1, 1], dtype=torch.int32)
            self.min_position = torch.tensor([-1.0, -1.0, -1.0])
            self.max_position = torch.tensor([1.0, 1.0, 1.0])
            self.centroids = torch.zeros(1, 3)
            self.need_viewdir = False
            self.need_appearance_embedding = False
            self.sub_module_0 = torch.jit.script(sub_cls())

    torch.manual_seed(1)
    path = str(tmp_path / name)
    torch.jit.save(torch.jit.script(Container()), path)
    return path


class Weird(nn.Module):
    """A graph that does not replay as Linear/ReLU (a sine activation)."""

    def __init__(self, in_dim=3, out_dim=5):
        super().__init__()
        self.l0 = nn.Linear(in_dim, 8)
        self.l1 = nn.Linear(8, out_dim)

    def forward(self, x, sigma_only: bool = False):
        return self.l1(torch.sin(self.l0(x)))


class Odd(nn.Module):
    """A width no skip rule explains."""

    def __init__(self, in_dim=3, out_dim=5):
        super().__init__()
        self.l0 = nn.Linear(in_dim, 8)
        self.l1 = nn.Linear(9, out_dim)

    def forward(self, x, sigma_only: bool = False):
        h = torch.relu(self.l0(x))
        return self.l1(torch.cat([h, x[:, :1]], -1))


def test_non_convertible_container_raises(tmp_path):
    """A container whose graph does not replay as Linear/ReLU loads through
    the eager TorchScript fallback and matches its eager forward (the name
    is kept from when the port refused such a container)."""
    x = np.random.RandomState(5).randn(40, 3).astype(np.float32)
    for cls in (Weird, Odd):
        path = _save_container(tmp_path, cls, cls.__name__ + ".pt")
        m = PModel.from_torchscript(path, device="cpu")
        assert m._torch_modules is not None and m.output_dim == 5
        with torch.inference_mode():
            want = torch.jit.load(path).sub_module_0(
                torch.from_numpy(x), False).numpy()
        got = m.query_device(np.zeros(40, np.int32), x).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def _fallback_container(tmp_path, cls, n=4, out_dim=5, viewdir=True,
                        name="fallback.pt"):
    """A 2x2-cluster container of ``cls`` submodules (seeded)."""
    in_dim = 6 if viewdir else 3

    class Container(nn.Module):
        def __init__(self):
            super().__init__()
            self.grid_dim = torch.tensor([2, n // 2], dtype=torch.int32)
            self.min_position = torch.tensor([-1.0, -1.0, -1.0])
            self.max_position = torch.tensor([1.0, 1.0, 1.0])
            self.centroids = torch.zeros(n, 3)
            self.need_viewdir = viewdir
            self.need_appearance_embedding = False
            for i in range(n):
                setattr(self, f"sub_module_{i}",
                        torch.jit.script(cls(in_dim, out_dim)))

    torch.manual_seed(3)
    path = str(tmp_path / name)
    torch.jit.save(torch.jit.script(Container()), path)
    return path


@pytest.mark.parametrize("cls", [Weird, Odd])
def test_fallback_matches_eager_forward_and_jax(tmp_path, cls):
    """The fallback's query on random samples and clusters: within 1e-5 of
    each submodule's eager forward and of the JAX package's fallback."""
    path = _fallback_container(tmp_path, cls, name=cls.__name__ + ".pt")
    p = PModel.from_torchscript(path, device="cpu")
    j = JModel.from_torchscript(path)
    assert j._torch_modules is not None
    x, ids = _inputs(333, 6, 4, seed=9)
    got = p.query(ids, x).numpy()
    container = torch.jit.load(path)
    for c in range(4):
        with torch.inference_mode():
            want = getattr(container, f"sub_module_{c}")(
                torch.from_numpy(x[ids == c]), False).numpy()
        np.testing.assert_allclose(got[ids == c], want, rtol=1e-5,
                                   atol=1e-5)
    np.testing.assert_allclose(got, np.asarray(j.query(ids, x)), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(p.query_device(ids, x).numpy(), got)
    for k in ("grid_dim", "min_position", "max_position"):
        np.testing.assert_array_equal(getattr(p, k), getattr(j, k))


@pytest.mark.parametrize("out_dim", [4, 10])
def test_fallback_output_width_probe(tmp_path, out_dim):
    """The placeholder params carry the width one probe forward reads, for
    a module emitting data_dim+1 other than 4 too (JAX's probe)."""
    path = _fallback_container(tmp_path, Weird, out_dim=out_dim,
                               viewdir=False)
    p = PModel.from_torchscript(path, device="cpu")
    j = JModel.from_torchscript(path)
    assert p.output_dim == j.output_dim == out_dim
    assert p.params.input_dim == 3 and p.params.n_layers == 1
    assert not any(bool(w.any()) for w in p.params.weights)
    x, ids = _inputs(50, 3, 4, seed=1)
    assert tuple(p.query(ids, x).shape) == (50, out_dim)


@pytest.mark.parametrize("batch", [1024, 7])
def test_query_equals_query_device(batch):
    """The cluster-sorted host loop against the grouped dispatch on a
    converted model, with chunks that split clusters (batch 7)."""
    p = PModel.synthetic(data_dim=4, n_clusters=8, grid_dim=(2, 4),
                         hidden=32, n_layers=4, need_viewdir=True, seed=6,
                         device="cpu")
    x, ids = _inputs(900, 6, 8, seed=4)
    got = p.query(ids, x, nerf_batch_size=batch)
    want = p.query_device(ids, x)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-6)
    j = JModel.synthetic(data_dim=4, n_clusters=8, grid_dim=(2, 4),
                         hidden=32, n_layers=4, need_viewdir=True, seed=6)
    np.testing.assert_allclose(got.numpy(), np.asarray(j.query(ids, x)),
                               rtol=RTOL, atol=ATOL)


def test_query_on_empty_input():
    p = PModel.synthetic(data_dim=4, n_clusters=4, device="cpu")
    out = p.query(np.zeros(0, np.int32), np.zeros((0, 3), np.float32))
    assert tuple(out.shape) == (0, 5) and out.dtype == torch.float32
    j = JModel.synthetic(data_dim=4, n_clusters=4)
    assert np.asarray(j.query(np.zeros(0, np.int32),
                              np.zeros((0, 3), np.float32))).shape == (0, 5)


@pytest.mark.parametrize("skips", [(), (2,)])
def test_query_grouped_reference_matches_jax(skips):
    """The ragged_dot reference, ``_query_grouped`` and
    ``mlp_forward_grouped``, with uneven and empty clusters, with and
    without a skip layer."""
    rng = np.random.RandomState(8 + len(skips))
    C, in_dim, h = 5, 4, 16
    dims = [(in_dim, h), (h, h), (h + (in_dim if skips else 0), h), (h, 6)]
    w = [(rng.randn(C, a, b) * 0.3).astype(np.float32) for a, b in dims]
    b = [(rng.randn(C, o) * 0.1).astype(np.float32) for _, o in dims]
    jp = JM.MLPParams(weights=[jnp.asarray(a) for a in w],
                      biases=[jnp.asarray(a) for a in b], skips=skips)
    pp = PM.params_from_numpy(w, b, skips, device="cpu")
    n = 600
    x = rng.randn(n, in_dim).astype(np.float32)
    ids = rng.choice([0, 1, 3, 4], size=n,
                     p=[0.6, 0.1, 0.25, 0.05]).astype(np.int32)
    want = np.asarray(JM._query_grouped(jp, jnp.asarray(ids),
                                        jnp.asarray(x)))
    got = PM._query_grouped(pp, torch.as_tensor(ids), torch.as_tensor(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    order = np.argsort(ids, kind="stable")
    sizes = np.bincount(ids, minlength=C).astype(np.int32)
    want_s = np.asarray(JM.mlp_forward_grouped(jp, jnp.asarray(x[order]),
                                               jnp.asarray(sizes)))
    got_s = PM.mlp_forward_grouped(pp, torch.as_tensor(x[order]),
                                   torch.as_tensor(sizes))
    np.testing.assert_allclose(got_s.numpy(), want_s, rtol=RTOL, atol=ATOL)
    # rows past the groups come out 0, as ragged_dot leaves them
    short = PM.mlp_forward_grouped(pp, torch.as_tensor(x[order]),
                                   torch.as_tensor(sizes - (sizes > 0)))
    assert not short[-1].any()


def test_f32_matmul_leaves_the_global_setting():
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        p = PModel.synthetic(device="cpu")
        p.query_device(np.zeros(4, np.int32), np.ones((4, 3), np.float32))
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(before)
