"""Mega-NeRF's ``NeRF`` submodule in the port: the converted model
against the plain reference (``tests/meganerf_reference.py``) on both
routes of ``query_grouped`` and through the fused product's plain
version, the product's argument checks, the container's conversion and
its fallback, a Viewer guided frame, and the query's span and counters.

Tolerances, with their reasons:
  * model outputs on the same rows: 2e-5 absolute and relative.  Both
    sides run f32 products (TF32 off) on the same weights, but the port's
    batched products sum in another order than ``nn.Linear``'s; the
    outputs are O(1), and the first layer's inputs include ``sin(2^11
    p)``, whose argument the same rounding of ``p`` gives on both sides;
  * the Viewer's guided frame against the frame composited from the
    reference modules: ``perfbench/check.py``'s comparison, no pixel off
    by more than 1e-3 and a mean absolute error under 1e-5.  The two
    paths rebuild a sample's position in different float32 orders (an fma
    against a product and a sum), a few ulps apart, and the encoding
    multiplies a position's last bit by up to 2^11.
"""

import sys

import numpy as np
import pytest
import torch
from torch import nn
from torch.profiler import ProfilerActivity, profile

import mega_nerf_viewer_tpu_torch as P
from mega_nerf_viewer_tpu_torch import kernels
from mega_nerf_viewer_tpu_torch.models import meganerf as PM
from mega_nerf_viewer_tpu_torch.utils import profiling

import meganerf_reference as ref

TOL = 2e-5
APPS = 6
# a guided Viewer at a test's size; the model's input is [xyz, app id]
OPT = P.RenderOptions(use_guided_sampling=True, max_guided_samples=8,
                      need_viewdir=False, appearance_embedding=1)


def _modules(n, seed=0, **kw):
    torch.manual_seed(seed)
    mods = [ref.mill19(APPS, **kw) for _ in range(n)]
    for m in mods:
        m.eval()
    return mods


def _save(tmp_path, modules, name="nerf.pt", grid=(2, 4)):
    """A container with the reference viewer's attributes
    (``cuda_renderer.cpp:518-543``) over scripted ``modules``."""
    class Container(nn.Module):
        def __init__(self):
            super().__init__()
            self.grid_dim = torch.tensor(grid, dtype=torch.int32)
            self.min_position = torch.tensor([-1.0, -1.0, -1.0])
            self.max_position = torch.tensor([1.0, 1.0, 1.0])
            self.centroids = torch.zeros(len(modules), 3)
            self.need_viewdir = False
            self.need_appearance_embedding = True
            for i, m in enumerate(modules):
                setattr(self, f"sub_module_{i}", torch.jit.script(m))

    path = str(tmp_path / name)
    torch.jit.save(torch.jit.script(Container()), path)
    return path


def _rows(n, clusters, seed=1):
    rng = np.random.default_rng(seed)
    x = np.concatenate([rng.uniform(-1, 1, (n, 3)),
                        rng.integers(0, APPS, (n, 1))], 1)
    return (torch.from_numpy(x.astype(np.float32)),
            torch.from_numpy(rng.integers(0, clusters, n)))


def _want(modules, ids, x):
    out = torch.zeros(x.shape[0], 13)
    with torch.no_grad():
        for c, m in enumerate(modules):
            rows = ids == c
            out[rows] = m(x[rows], False)
    return out


def _routes(model, ids, x):
    """The model's query under a profiler: (output, the routes of its
    ``model.query`` spans)."""
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        got = model.query_device(ids, x)
    spans = [s for s in profiling.recorded()[0] if s.name == "model.query"]
    profiling.reset()
    return got, [s.attrs["route"] for s in spans]


@pytest.fixture(scope="module")
def mill19(tmp_path_factory):
    """Eight submodules at Mill 19's widths and their loaded container."""
    mods = _modules(8)
    path = _save(tmp_path_factory.mktemp("mill19"), mods)
    return mods, P.MegaNeRFModel.from_torchscript(path, device="cpu")


def test_container_converts_without_fallback(mill19):
    mods, model = mill19
    assert model._torch_modules is None
    p = model.params
    assert isinstance(p, PM.NeRFParams)
    assert (p.n_clusters, p.n_layers, p.skips, p.output_dim) == (8, 8, (4,),
                                                                 13)
    assert p.sigma_activation == "relu"
    np.testing.assert_array_equal(
        p.freq_bands.numpy(), mods[0].embedding_xyz.freq_bands.numpy())
    np.testing.assert_array_equal(p.trunk(4)[0][3].numpy(),
                                  mods[3].xyz_encodings[4][0].weight
                                  .detach().numpy().T)
    np.testing.assert_array_equal(p.appearance[5].numpy(),
                                  mods[5].embedding_a.weight.detach().numpy())
    assert (model.need_viewdir, model.need_appearance_embedding) == (False,
                                                                     True)
    np.testing.assert_array_equal(model.grid_dim, [2, 4])


def test_all_clusters_route_at_published_widths(mill19):
    """256 rows through the all-clusters select: every column, sigma (the
    last) included, which the compositor never reads."""
    mods, model = mill19
    x, ids = _rows(256, 8)
    got, routes = _routes(model, ids, x)
    assert routes == ["all"]
    want = _want(mods, ids, x)
    assert got.shape == (256, 13)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=TOL, atol=TOL)
    assert float(want[:, 12].max()) > 0.0


@pytest.mark.parametrize("act", ["relu", "softplus"])
def test_chunked_route_at_tiny_widths(tmp_path, act):
    """2^16 + 37 rows through the cluster-pure chunked route."""
    mods = _modules(4, seed=2, layer_dim=16, pos_xyz_dim=4, layers=4,
                    skip_layers=(2,), appearance_dim=4,
                    sigma_activation=act)
    model = P.MegaNeRFModel.from_torchscript(
        _save(tmp_path, mods, grid=(2, 2)), device="cpu")
    assert model._torch_modules is None
    assert model.params.sigma_activation == act
    x, ids = _rows((1 << 16) + 37, 4, seed=3)
    got, routes = _routes(model, ids, x)
    assert routes == ["chunked"]
    np.testing.assert_allclose(got.numpy(), _want(mods, ids, x).numpy(),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("kind", ["nerf", "mlp"])
def test_chunked_route_in_blocks(tmp_path, monkeypatch, kind):
    """A query larger than one block of the chunked forward gives the
    output of one block over every chunk, and the same ``mlp_rows``."""
    if kind == "nerf":
        mods = _modules(4, seed=6, layer_dim=16, pos_xyz_dim=4, layers=4,
                        skip_layers=(2,), appearance_dim=4)
        model = P.MegaNeRFModel.from_torchscript(
            _save(tmp_path, mods, grid=(2, 2)), device="cpu")
        assert model._torch_modules is None
    else:
        model = P.MegaNeRFModel.synthetic(data_dim=12, n_clusters=4,
                                          need_appearance_embedding=True,
                                          grid_dim=(2, 2), device="cpu")
    x, ids = _rows((1 << 16) + 37, 4, seed=7)

    def query(block_rows):
        monkeypatch.setattr(PM, "BLOCK_ROWS", block_rows)
        profiling.reset()
        with profile(activities=[ProfilerActivity.CPU]):
            got = model.query_device(ids, x)
        rows = profiling.recorded()[1]["mlp_rows"]
        profiling.reset()
        return got, rows

    whole, rows = query(1 << 30)
    blocked, blocked_rows = query(3 * PM.CHUNK)
    assert rows == blocked_rows > 3 * PM.CHUNK
    torch.testing.assert_close(blocked, whole, rtol=0, atol=0)
    if kind == "nerf":
        np.testing.assert_allclose(blocked.numpy(),
                                   _want(mods, ids, x).numpy(), rtol=TOL,
                                   atol=TOL)


@pytest.mark.parametrize("route", ["chunked", "all"])
@pytest.mark.parametrize("act", ["relu", "softplus"])
@pytest.mark.parametrize("widths", ["tiny", "mill19"])
def test_nerf_forward_through_the_plain_product(monkeypatch, widths, act,
                                                route):
    """``NeRFParams.forward`` through the fused product's plain version
    (``mlp_gemm_reference``, one call a layer) against the reference
    modules on all 13 columns: the chunked route at a small chunk with
    ragged cluster segments (0, 1, 37 and 90 rows), the all-clusters route,
    the skip layers (two at the tiny widths), appearance ids out of range
    (the modules read them clamped), sigma ReLU and shifted softplus."""
    kw = dict(layer_dim=16, pos_xyz_dim=4, layers=5, skip_layers=(1, 3),
              appearance_dim=4) if widths == "tiny" else {}
    mods = _modules(4, seed=11, sigma_activation=act, **kw)
    params = PM._convert_nerf(mods, 4)
    assert params.skips == ((1, 3) if widths == "tiny" else (4,))
    rng = np.random.default_rng(12)
    ids = np.repeat(np.arange(4), [0, 1, 37, 90])
    rng.shuffle(ids)
    x = torch.from_numpy(np.concatenate([
        rng.uniform(-1, 1, (ids.size, 3)),
        rng.integers(-3, APPS + 3, (ids.size, 1))], 1).astype(np.float32))
    assert bool((x[:, 3] < 0).any() and (x[:, 3] >= APPS).any())
    ids = torch.from_numpy(ids)
    calls = []
    plain = PM.mlp_gemm_reference
    monkeypatch.setattr(PM, "mlp_gemm_reference",
                        lambda *a, **k: calls.append(1) or plain(*a, **k))
    got = PM._query_chunked(params, ids, x, 32) if route == "chunked" \
        else PM.mlp_forward_all(params, ids, x)
    assert len(calls) == params.n_layers + 4
    clamped = x.clone()
    clamped[:, 3].clamp_(0, APPS - 1)
    assert got.shape == (ids.numel(), 13)
    np.testing.assert_allclose(got.numpy(), _want(mods, ids, clamped).numpy(),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("bad", ["w_dtype", "b_shape", "a_noncontiguous",
                                 "cids_dtype", "a2_rows", "ids_dtype",
                                 "out_window", "two_sources", "on_the_cpu"])
def test_mlp_gemm_rejects_bad_inputs(bad):
    """The fused product's wrapper, and the kernel's behind it, refuse a
    wrong dtype, shape or a non-contiguous input with the argument's name
    (on the CPU as on the card); the kernel's refuses CPU tensors."""
    kw = dict(a=torch.randn(3, 10, 8), w=torch.randn(2, 8, 5),
              b=torch.randn(2, 5), cids=torch.tensor([0, 1, 1]), relu=True)
    match = {"w_dtype": "^w:", "b_shape": "^b:", "a_noncontiguous": "^a:",
             "cids_dtype": "^cids:", "a2_rows": "^a2:", "ids_dtype": "^ids:",
             "out_window": "^out: columns", "two_sources": "one second",
             "on_the_cpu": "CUDA tensors only"}[bad]
    if bad == "w_dtype":
        kw["w"] = kw["w"].double()
    elif bad == "b_shape":
        kw["b"] = torch.randn(2, 6)
    elif bad == "a_noncontiguous":
        kw["a"] = torch.randn(3, 8, 10).transpose(1, 2)
    elif bad == "cids_dtype":
        kw["cids"] = kw["cids"].int()
    elif bad == "a2_rows":
        kw["w"], kw["a2"] = torch.randn(2, 12, 5), torch.randn(3, 9, 4)
    elif bad == "ids_dtype":
        kw["w"], kw["table"] = torch.randn(2, 11, 5), torch.randn(2, 6, 3)
        kw["ids"] = torch.zeros(3, 10, dtype=torch.int64)
    elif bad == "out_window":
        kw["out"], kw["col"] = torch.zeros(3, 10, 13), 9
    elif bad == "two_sources":
        kw["a2"], kw["table"] = torch.randn(3, 10, 2), torch.randn(2, 6, 2)
        kw["ids"] = torch.zeros(3, 10)
    before = dict(kernels.LAUNCHES)
    if bad != "on_the_cpu":
        with pytest.raises(ValueError, match=match):
            PM.mlp_gemm(**kw)
    with pytest.raises(ValueError, match=match):
        kernels.mlp_gemm(**kw)
    assert kernels.LAUNCHES == before


def test_swapped_skip_order_falls_back(tmp_path):
    """The encoded input after the hidden state (not ``nerf.py``'s order):
    the widths walk, the replay does not, so the container loads through
    the eager fallback and its forward is the modules' own."""
    mods = _modules(2, seed=4, layer_dim=16, pos_xyz_dim=4, layers=4,
                    skip_layers=(2,), appearance_dim=4, skip_first=False)
    model = P.MegaNeRFModel.from_torchscript(
        _save(tmp_path, mods, grid=(1, 2)), device="cpu")
    assert model._torch_modules is not None and model.output_dim == 13
    x, ids = _rows(50, 2, seed=5)
    np.testing.assert_allclose(model.query_device(ids, x).numpy(),
                               _want(mods, ids, x).numpy(), rtol=1e-6,
                               atol=1e-6)


def _viewer(model, w=48, h=36):
    cam = P.Camera(w, h, 20.0)
    cam.center = np.array([-1.5, 0.1, 1.4], np.float32)
    cam._update()
    return P.Viewer(P.sphere_tree(basis_dim=4, depth=4, device="cpu"),
                    camera=cam, options=OPT, model=model, device="cpu")


def test_viewer_guided_frame_matches_the_reference_modules(mill19):
    """The Viewer's guided frame through the converted model (the device
    path: compact reconstruction, ``query_grouped``) against the same
    frame with the reference modules themselves (the eager fallback and
    the host reconstruction)."""
    mods, model = mill19
    fallback = PM.MegaNeRFModel(
        PM._dummy_params(8, 4, 13, "cpu"), model.grid_dim,
        model.min_position, model.max_position, False, True,
        torch_modules=mods)
    got = _viewer(model).render()
    want = _viewer(fallback).render()
    err = (torch.as_tensor(got) - torch.as_tensor(want)).abs()
    assert got.shape == (36, 48, 4)
    assert float(want[..., :3].std()) > 0.05
    assert int((err.amax(-1) > 1e-3).sum()) == 0
    assert float(err.mean()) < 1e-5


def test_profiled_stop_records_the_query(mill19):
    """A profiled guided stop: ``model.query`` and the query's counters,
    with no launch of kernel I on the CPU, where the plain product runs;
    the host syncs, queries and rows of the stop are those of the same
    stop with a Linear/ReLU model."""
    def stop(model):
        v = _viewer(model)
        v.render()
        v.camera.begin_drag(0.0, 0.0, False, True)
        v.camera.drag_update(-4.0, 0.0)
        v.render()
        profiling.reset()
        with profile(activities=[ProfilerActivity.CPU]):
            v.camera.end_drag()
            v.render()
        spans, counters = profiling.recorded()
        profiling.reset()
        return spans, counters

    launches = kernels.LAUNCHES["mlp_gemm"]
    spans, counters = stop(mill19[1])
    q = [s for s in spans if s.name == "model.query"]
    assert len(q) == counters["mlp_queries"] >= 1
    assert all(s.attrs["route"] == "all" for s in q)
    assert sum(s.attrs["rows"] for s in q) * 8 == counters["mlp_rows"]
    assert 0 < counters["mlp_samples"] <= q[-1].attrs["rows"]
    mlp = P.MegaNeRFModel.synthetic(data_dim=12, n_clusters=8,
                                    need_appearance_embedding=True,
                                    grid_dim=(2, 4), device="cpu")
    _, plain = stop(mlp)
    assert kernels.LAUNCHES["mlp_gemm"] == launches
    assert plain["mlp_rows"] == counters["mlp_rows"]
    assert counters["host_syncs"] == plain["host_syncs"]
    assert counters["mlp_queries"] == plain["mlp_queries"]


def test_reference_is_plain_torch():
    assert ref.__name__ in sys.modules
    src = open(ref.__file__).read()
    assert "mega_nerf_viewer_tpu" not in src.replace(
        "mega_nerf/models", "") and "jax" not in src


def test_an_escalated_collect_queries_once(mill19):
    """Stale hints overflow the segments: the query follows the settled
    collect, once, at the budget of its total, whatever the hint (no
    query is queued before the flags are read, to be dropped on an
    overflow)."""
    from mega_nerf_viewer_tpu_torch.ops import accel as PA
    from mega_nerf_viewer_tpu_torch.ops import guided as PG
    v = _viewer(mill19[1])
    tree, cam = v.tree, v.camera
    lm, tab = P.build_leaf_map(tree), P.build_skip_table(tree, 1e-2)
    R = cam.width * cam.height
    zeros = torch.zeros(R, dtype=torch.int32)
    stale = PA.order_from_hints(zeros, zeros)
    segs = ((0.5, 0), (0.4, 1), (0.1, OPT.max_guided_samples))

    def collect(hint):
        profiling.reset()
        with profile(activities=[ProfilerActivity.CPU]):
            out = PG.collect_and_query_fast(
                tree, lm, mill19[1], cam, OPT, chunk_size=64, skip_table=tab,
                order=stale, segments=segs, budget_hint=hint)
        n = profiling.recorded()[1]["mlp_queries"]
        profiling.reset()
        return out, n

    plain, n_plain = collect(None)
    hinted, n_hinted = collect(1 << 17)
    assert plain["segments"] != segs and hinted["segments"] == \
        plain["segments"]
    assert (n_plain, n_hinted) == (1, 1)
    assert hinted["results_c"].shape[0] == plain["results_c"].shape[0] \
        == 1 << 16
    n = int(plain["num_samples"].sum())
    torch.testing.assert_close(hinted["results_c"][:n],
                               plain["results_c"][:n], rtol=0, atol=0)
