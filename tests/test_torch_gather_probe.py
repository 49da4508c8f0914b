"""The row-gather probe's plain version (``probes/gather_probe.py``) against
the JAX probe (``benchmarks/dma_gather_probe.py``, imported by path):
``build_xla_gather`` and the Pallas ``build_dma_gather`` in interpret mode
(as ``tools/smoke_benchmarks.sh`` runs it on the CPU; both widths run
there), at M = 2^12, N = 2^13 with the probe's draws.

Every i32 must be equal.  The sums wrap: at W = 128 a chunk sums 2^18
values below 2^20, at W = 8 2^14 of them, both past 2^31.
"""

import importlib.util
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mega_nerf_viewer_tpu_torch import kernels
from mega_nerf_viewer_tpu_torch.probes import gather_probe as GP

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
M, N = 1 << 12, 1 << 13


def _jax_probe():
    spec = importlib.util.spec_from_file_location(
        "dma_gather_probe", os.path.join(REPO, "benchmarks",
                                         "dma_gather_probe.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def inputs():
    """The JAX probe's draws (``dma_gather_probe.py:165-170``) at M = 2^12."""
    rng = np.random.default_rng(7)
    idx = rng.integers(0, M, N, dtype=np.int32)
    tables = {W: rng.integers(0, 1 << 20, (M, W), dtype=np.int32)
              for W in (8, 128)}
    return idx, tables


@pytest.mark.parametrize("W", [8, 128])
def test_plain_version_equals_jax_probe(inputs, W):
    jp = _jax_probe()
    assert jp.CHUNK == GP.CHUNK
    idx, tables = inputs
    table = tables[W]
    want = np.asarray(jp.build_xla_gather(M, W, N)(jnp.asarray(idx),
                                                   jnp.asarray(table)))
    t, i = torch.as_tensor(table), torch.as_tensor(idx)
    before = dict(kernels.LAUNCHES)
    got = GP.gather_chunk_sums(t, i)
    assert kernels.LAUNCHES == before          # a CPU tensor launches nothing
    assert got.dtype == torch.int32 and got.shape == (N // GP.CHUNK,)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(GP.gather_chunk_sums_library(t, i).numpy(),
                                  want)
    # the sums do wrap: the exact int64 sums leave the i32 range
    exact = table[idx].reshape(N // GP.CHUNK, -1).astype(np.int64).sum(1)
    assert exact.max() > np.iinfo(np.int32).max
    # the Pallas kernel in interpret mode fetches the same rows
    dma = np.asarray(jp.build_dma_gather(M, W, N, True)(jnp.asarray(idx),
                                                        jnp.asarray(table)))
    np.testing.assert_array_equal(dma, want)


def test_probe_shapes_and_clamp():
    t = torch.arange(12, dtype=torch.int32).reshape(4, 3)
    idx = torch.full((GP.CHUNK,), 7, dtype=torch.int32)    # past M: clamped
    idx[0] = -5                                            # below 0: row 0
    got = GP.gather_chunk_sums_reference(t, idx)
    assert int(got[0]) == (GP.CHUNK - 1) * (9 + 10 + 11) + (0 + 1 + 2)
    with pytest.raises(ValueError):
        GP.gather_chunk_sums(t, idx[:100])
    assert GP.bound_bytes(1 << 21, 8) == (1 << 21) * 36
    assert GP.bound_bytes(1 << 21, 128) == (1 << 21) * 516


def test_probe_inputs_follow_the_jax_draws():
    idx, tables = GP.probe_inputs(11, device="cpu")
    rng = np.random.default_rng(7)
    np.testing.assert_array_equal(
        idx.numpy(), rng.integers(0, 1 << 20, 1 << 11, dtype=np.int32))
    assert [w for w, _ in tables] == [8, 128]
    np.testing.assert_array_equal(
        tables[0][1][:3].numpy(),
        rng.integers(0, 1 << 20, (1 << 20, 8), dtype=np.int32)[:3])
