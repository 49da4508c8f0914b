"""The yardstick: the card's peaks and the work of each measured kernel,
counted from shapes and from the counts the window produced.

Peaks: one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at the 700 W
limit): 3.35 TB/s of HBM3, 67 TFLOP/s of float32 outside the tensor cores.

Kernel A (``csrc/march.cu``, the fused march) moves at least, per launch,
its per-ray inputs and outputs once, 8 bytes a step (the leaf map or child
word and the sigma it reads) and the f16 leaf row of each shaded sample;
it computes 45 f32 operations a step and ``6 B + 15`` a shaded sample
(``B`` the SH basis size), counted from the kernel's loop body.  These are
the bounds ``chip_smoke.py`` applies to one phase, applied here to the
window's own launches.
"""

from __future__ import annotations

PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12

MARCH_OPS_PER_STEP = 45
MARCH_BYTES_PER_STEP = 8


def least_seconds(n_bytes: float, n_ops: float, peak_ops: float
                  = PEAK_F32_FLOP_PER_S) -> float:
    """The least time the card could take: the larger of the byte and the
    operation bound."""
    return max(n_bytes / PEAK_BYTES_PER_S, n_ops / peak_ops)


def march_launch_bytes(R: int, basis_cols: int) -> int:
    """Kernel A's per-ray traffic of one launch of ``R`` rays: d, invdir
    (f32 x 3 each), delta_scale, tmin, tmax (f32), miss (1 byte), the
    basis (f32 x ``basis_cols``), out (f32 x 4), nsteps and nrec (i32)."""
    return R * (12 + 12 + 4 + 4 + 4 + 1 + 4 * basis_cols + 16 + 4 + 4)


def march_work(R: int, basis_cols: int, use_sh: bool, data_dim: int,
               steps: int, shaded: int) -> tuple:
    """(bytes, operations) of kernel A's launches: ``R`` rays in all,
    ``steps`` steps and ``shaded`` shaded samples."""
    B = basis_cols if use_sh else 0
    n_bytes = (march_launch_bytes(R, basis_cols)
               + MARCH_BYTES_PER_STEP * steps + 2 * data_dim * shaded)
    n_ops = MARCH_OPS_PER_STEP * steps + (6 * B + 15) * shaded
    return n_bytes, n_ops

