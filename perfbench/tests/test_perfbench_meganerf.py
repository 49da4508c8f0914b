"""The ``d11_guided`` cell's parts on the CPU: ``aerial_d11_meganerf``'s
model block, whose ``build`` (the port's model) and ``reference`` (the
plain forward) agree, the cell at a test's size under a host profiler, and
the three readers of the model's layer on a window made by hand.

Tolerance of ``build`` against ``reference`` on the same rows: 2e-5
absolute and relative, the f32 products summed in another order."""

import contextlib
import copy
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from conftest import tiny
from perfbench import harness, program_spans, registry, roofline
from perfbench.trace import Instruments

READERS = ("mlp_roofline.guided", "mlp_queries_per_stop.guided",
           "mlp_rows_per_stop.guided")
TINY = {"pos_xyz_dim": 4, "layers": 4, "skip_layers": [2], "layer_dim": 16,
        "appearance_dim": 4, "appearance_count": 5, "rgb_dim": 12}


def _spec(**cut):
    spec = copy.deepcopy(registry.config("aerial_d11_meganerf")["model"])
    spec.update(cut)
    return spec


def _rows(spec, n, seed):
    rng = np.random.default_rng(seed)
    lo = np.asarray(spec["min_position"], np.float32)
    hi = np.asarray(spec["max_position"], np.float32)
    x = np.concatenate([rng.uniform(lo, hi, (n, 3)), rng.integers(
        0, spec["appearance_count"], (n, 1))], 1).astype(np.float32)
    return torch.from_numpy(x), torch.from_numpy(
        rng.integers(0, int(np.prod(spec["grid_dim"])), n))


@pytest.mark.parametrize("cut,n", [({}, 300), (TINY, (1 << 16) + 5)],
                         ids=["mill19_widths", "tiny_widths_chunked"])
def test_build_and_reference_agree(cut, n):
    spec = _spec(**cut)
    mod = registry.model_module(spec["arch"])
    model = mod.build(spec, "cpu")
    x, ids = _rows(spec, n, seed=7)
    got = model.query_device(ids, x)
    want = mod.reference(spec, "cpu")(ids, x)
    assert got.shape == want.shape == (n, spec["rgb_dim"] + 1)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-5,
                               atol=2e-5)
    # the products' operations a row: 603,392 multiply-adds at Mill 19's
    # widths (the trunk 497,152, the heads 106,240)
    if not cut:
        assert mod.work(spec)[0] == 2 * 603_392


def test_the_cell_at_a_tiny_size(cache_root, monkeypatch):
    """Correct, with the counters' readers reporting; the roofline needs
    the card's GEMM records, which a CPU run has none of."""
    installed = Instruments.installed

    @contextlib.contextmanager
    def with_session(self, viewer):
        with installed(self, viewer) as inst, \
                profile(activities=[ProfilerActivity.CPU]):
            yield inst
    monkeypatch.setattr(Instruments, "installed", with_session)
    cfg, mix = tiny("d11_guided")
    cfg["model"].update(TINY)
    res, _ = harness.run_cell("d11_guided", 2 ** 34 + 3, 0.6, True,
                              device="cpu", root=cache_root, cfg=cfg,
                              mix=mix, log=lambda m: None)
    assert res["correct"] is True, res["checked"]
    m = {k: v["value"] for k, v in res["metrics"].items()}
    assert set(m) == {"mlp_queries_per_stop.guided",
                      "mlp_rows_per_stop.guided"}
    assert m["mlp_queries_per_stop.guided"] >= 1
    assert m["mlp_rows_per_stop.guided"] >= 8 * m[
        "mlp_queries_per_stop.guided"]


def test_readers_on_a_fixture_window(monkeypatch):
    counters = {"frames": 30, "mlp_queries": 12, "mlp_rows": 64_000_000}
    monkeypatch.setattr(program_spans, "recorded", lambda: ([], counters))
    cfg = registry.config("aerial_d11_meganerf")
    ops_s = {"sm90_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize128x128x8": 2.0,
             "gemv2T_kernel_val<int, int, float, float>": 0.25,
             "void at::native::vectorized_elementwise_kernel<4>": 1.0}
    ctx = types.SimpleNamespace(window=types.SimpleNamespace(units=8),
                                cfg=cfg, device_ops_s=ops_s)
    got = {n: registry.metric_reader(n)(ctx) for n in READERS}
    ops, row_bytes, weight_bytes = registry.model_module(
        "meganerf").work(cfg["model"])
    least = roofline.least_seconds(
        64_000_000 * row_bytes + 12 * weight_bytes, 64_000_000 * ops)
    assert got == pytest.approx({
        "mlp_roofline.guided": 100.0 * least / 2.25,
        "mlp_queries_per_stop.guided": 1.5,
        "mlp_rows_per_stop.guided": 8_000_000.0})
    # the products are compute-bound at these widths
    assert least == pytest.approx(64_000_000 * ops
                                  / roofline.PEAK_F32_FLOP_PER_S)
    # a program without the counters (the parent's), or no GEMM records
    monkeypatch.setattr(program_spans, "recorded",
                        lambda: ([], {"frames": 30}))
    assert all(registry.metric_reader(n)(ctx) is None for n in READERS)
    monkeypatch.setattr(program_spans, "recorded", lambda: ([], counters))
    ctx.device_ops_s = {}
    assert registry.metric_reader(READERS[0])(ctx) is None
