"""Row-gather probe: the card's throughput for gathering table rows at random
indices (kernel H, ``csrc/gather_probe.cu``).

Counterpart of ``benchmarks/dma_gather_probe.py``: a table i32 [M, W] (rows
like the leaf map's, which the fused march reads once per step), indices
i32 [N] drawn uniformly, and per 2,048-index chunk the sum of every
gathered element, wrapping mod 2^32 as XLA's int32 sum does.  On a CUDA
tensor :func:`gather_chunk_sums` launches kernel H; on a CPU tensor it runs
:func:`gather_chunk_sums_reference`.  :func:`gather_chunk_sums_library` is
the same work as the JAX probe's baseline ``build_xla_gather``
(``torch.index_select`` and the chunk sum); it is a yardstick only.

Run on the card (prints one JSON line per width, as the JAX probe does)::

    python -m mega_nerf_viewer_tpu_torch.probes.gather_probe [N_log2]

The shapes are the JAX probe's: M = 2^20, W in (8, 128), N = 2^N_log2
(default 21), with indices and table from ``np.random.default_rng(7)``.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

from .. import kernels
from ..device import resolve_device

CHUNK = 2048
M_ROWS = 1 << 20
WIDTHS = (8, 128)
# H100 SXM memory rate (NVIDIA data sheet, at the 700 W limit)
PEAK_BYTES_PER_S = 3.35e12


def _wrap_i32(s: torch.Tensor) -> torch.Tensor:
    """int64 sums reduced mod 2^32 into i32 (two's complement)."""
    s = s & 0xFFFFFFFF
    return torch.where(s >= (1 << 31), s - (1 << 32), s).to(torch.int32)


def _check(table: torch.Tensor, idx: torch.Tensor) -> None:
    if table.dim() != 2 or idx.dim() != 1 or idx.shape[0] % CHUNK:
        raise ValueError(f"table {tuple(table.shape)} and idx "
                         f"{tuple(idx.shape)}: need [M, W] and [N], N a "
                         f"multiple of {CHUNK}")


def gather_chunk_sums_reference(table: torch.Tensor,
                                idx: torch.Tensor) -> torch.Tensor:
    """The plain version: ``table[idx.long()]`` (indices clamped into
    [0, M), as the kernel does), each chunk of ``CHUNK`` rows summed
    exactly in int64, then reduced mod 2^32 to i32 by keeping the low 32
    bits as a two's-complement value — XLA's wrapping int32 sum, whose
    result does not depend on the order of the adds."""
    _check(table, idx)
    rows = table[idx.long().clamp(0, table.shape[0] - 1)]
    return _wrap_i32(rows.reshape(idx.shape[0] // CHUNK, -1).to(
        torch.int64).sum(1))


def gather_chunk_sums_library(table: torch.Tensor,
                              idx: torch.Tensor) -> torch.Tensor:
    """``torch.index_select`` and the chunk sum: the work of
    ``build_xla_gather`` (a yardstick; the port never calls it)."""
    rows = torch.index_select(table, 0, idx)
    return _wrap_i32(rows.reshape(idx.shape[0] // CHUNK, -1).sum(1))


def gather_chunk_sums(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per-chunk sums of gathered rows: kernel H for CUDA tensors, the plain
    version for CPU tensors.  Returns i32 [N / CHUNK]."""
    _check(table, idx)
    if table.device.type == "cpu":
        return gather_chunk_sums_reference(table, idx)
    return kernels.gather_chunk_sums(table.to(torch.int32).contiguous(),
                                     idx.to(torch.int32).contiguous())


def bound_bytes(N: int, W: int) -> int:
    """Bytes the probe must move: each index once and each gathered row,
    at least one 32-byte sector."""
    return N * (4 + max(32, 4 * W))


def probe_inputs(n_log2: int, device=None):
    """The JAX probe's inputs from ``np.random.default_rng(7)``: idx i32
    [2^n_log2] and, per width, a table i32 [2^20, W], drawn in the JAX
    probe's order.  Returns (idx, [(W, table), ...]) on ``device``."""
    device = resolve_device(device)
    rng = np.random.default_rng(7)
    N = 1 << n_log2
    idx = torch.from_numpy(rng.integers(0, M_ROWS, N, dtype=np.int32))
    tables = [(W, torch.from_numpy(rng.integers(0, 1 << 20, (M_ROWS, W),
                                                dtype=np.int32)).to(device))
              for W in WIDTHS]
    return idx.to(device), tables


def _ms(fn, runs: int = 5) -> float:
    """Median of ``runs`` timed calls on the card (CUDA events)."""
    fn()
    ts = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return sorted(ts)[len(ts) // 2]


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    n_log2 = int(argv[0]) if argv else 21
    dev = resolve_device(None)
    idx, tables = probe_inputs(n_log2, dev)
    N = idx.shape[0]
    for W, table in tables:
        got = gather_chunk_sums(table, idx)
        want = gather_chunk_sums_reference(table, idx)
        k_ms = _ms(lambda: gather_chunk_sums(table, idx))
        l_ms = _ms(lambda: gather_chunk_sums_library(table, idx))
        b_ms = bound_bytes(N, W) / PEAK_BYTES_PER_S * 1e3
        print(json.dumps({
            "metric": "gather_chunk_sums_ns_per_row", "width": W,
            "n_rows": N, "chunk": CHUNK,
            "device": torch.cuda.get_device_name(dev),
            "kernel_ns": k_ms * 1e6 / N, "library_ns": l_ms * 1e6 / N,
            "bound_ns": b_ms * 1e6 / N, "kernel_ms": k_ms,
            "library_ms": l_ms, "bound_ms": b_ms,
            "equal": bool(torch.equal(got, want))}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
