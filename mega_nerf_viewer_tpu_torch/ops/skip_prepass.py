"""Entry-skip prepass: march each ray's start ``t`` through entry empty space.

Counterpart of ``mega_nerf_viewer_tpu/ops/pallas_march.py``
(``build_skip_table`` and the Pallas ``_prepass_kernel``).  Most march
steps of a frame cross shallow empty leaves between the ray's bbox entry
and its first dense sample; those steps carry no colour, only the exact
``t`` trajectory.  The prepass replays exactly those steps against a
40 KB table of three packed planes, with the march's own f32 step math,
so the march starts at a bit-equal ``t``:

  * words 0-511 — level-4 nibbles for cell (cx, cy, cz), x-major: bit 3 =
    skippable (leaf at depth <= 4 with sigma <= sigma_thresh), bits 0-2 =
    the leaf depth;
  * words 1024-2047 — level-5 bits: the cell is an empty leaf at depth
    exactly 5;
  * words 2048-10239 — level-6 bits: the cell is an empty leaf at depth
    exactly 6.

The table keeps the JAX layout, i32 ``[80, 128]``.  On a CUDA tensor
:func:`entry_skip_prepass` launches ``csrc/skip_prepass.cu`` (one thread
per ray, the table through the read-only cache); on a CPU tensor it runs
:func:`entry_skip_prepass_reference`, the same steps as torch ops.
Vote frames must not use the prepass (the reference's fallback vote
inspects empty leaves).
"""

from __future__ import annotations

import torch

from .. import kernels
from .fp import fma_f32, pow2_f32

_LEVEL = 4
_GRID = 1 << _LEVEL
_N_WORDS = _GRID ** 3 // 8        # 512
_GRID5 = 32
_N_WORDS5 = _GRID5 ** 3 // 32     # 1024
_GRID6 = 64
_N_WORDS6 = _GRID6 ** 3 // 32     # 8192
_BASE5 = 8 * 128                  # first word of the level-5 plane
_BASE6 = 16 * 128                 # first word of the level-6 plane
TABLE_SHAPE = (80, 128)
# clip bound of positions in the tree's unit cube (as in the march)
EPS_HI = float(torch.tensor(1.0 - 1e-6, dtype=torch.float32))


def build_skip_table(tree, sigma_thresh) -> torch.Tensor:
    """Pack the three-plane skippability table: i32 [80, 128]."""
    if tree.N != 2:
        raise ValueError(f"skip table requires N == 2 trees "
                         f"(got N={tree.N})")
    from .accel import _build_rows, _f16_bits_to_f32, _INTERNAL_BIT, \
        _DEPTH_BITS
    dev = tree.device
    thresh = torch.tensor(float(sigma_thresh), dtype=torch.float32,
                          device=dev)

    def fields(level):
        meta = _build_rows(tree, level, 0)[:, 1]
        depth = meta & _DEPTH_BITS
        internal = (meta & _INTERNAL_BIT) != 0
        sigma = _f16_bits_to_f32((meta >> 16) & 0xFFFF)
        return depth, internal, sigma

    def pack(vals, per_word, bits):
        shifts = torch.arange(per_word, device=dev, dtype=torch.int64) * bits
        words = (vals.to(torch.int64).reshape(-1, per_word) << shifts).sum(1)
        return words.to(torch.int32)      # wraps bit 31 into the sign

    depth, internal, sigma = fields(_LEVEL)
    skip = (~internal) & (sigma <= thresh) & (depth <= 7)
    nib = torch.where(skip, 8 | depth, torch.zeros_like(depth))
    words4 = pack(nib, 8, 4)
    words4 = torch.cat([words4, torch.zeros(_BASE5 - _N_WORDS,
                                            dtype=torch.int32, device=dev)])

    def bit_words(level):
        depth_l, internal_l, sigma_l = fields(level)
        bit = (~internal_l) & (depth_l == level) & (sigma_l <= thresh)
        return pack(bit, 32, 1)

    return torch.cat([words4, bit_words(5), bit_words(6)]).reshape(
        TABLE_SHAPE)


def entry_skip_prepass(table: torch.Tensor, cen: torch.Tensor,
                       d: torch.Tensor, invdir: torch.Tensor,
                       tmin: torch.Tensor, tmax: torch.Tensor,
                       live: torch.Tensor, step_size: float):
    """Advance each ray's start ``t`` through entry empty space.

    ``cen`` [3] is the tree-space origin, ``d``/``invdir`` [R, 3] the
    scaled unit directions, ``live`` [R] bool the rays that hit the bbox.
    Returns (t_start [R] f32 >= tmin, bit-equal to where the march would
    be after the same colourless steps; skips [R] i32, the steps taken).
    """
    if d.device.type == "cpu":
        return entry_skip_prepass_reference(table, cen, d, invdir, tmin,
                                            tmax, live, step_size)
    return kernels.skip_prepass(table, cen, d, invdir, tmin, tmax, live,
                                step_size)


def _cell(p: torch.Tensor, grid: int) -> torch.Tensor:
    c = torch.floor(p * float(grid)).to(torch.int32)
    return (c[:, 0] * grid + c[:, 1]) * grid + c[:, 2]


def entry_skip_prepass_reference(table, cen, d, invdir, tmin, tmax, live,
                                 step_size):
    """The prepass as plain torch ops: one vectorized step per iteration,
    the f32 math of ``pallas_march._prepass_kernel`` op for op."""
    flat = table.reshape(-1)
    step = torch.tensor(float(step_size), dtype=torch.float32,
                        device=d.device)
    t = tmin.clone()
    cnt = torch.zeros_like(tmin, dtype=torch.int32)
    active = live & (t < tmax)
    while bool(active.any()):
        p = fma_f32(t[:, None], d, cen[None, :])
        p = torch.clamp(p, 0.0, EPS_HI)
        idx = _cell(p, _GRID)
        nib = (flat[idx >> 3] >> ((idx & 7) * 4)) & 15
        skip4 = (nib & 8) != 0
        idx5 = _cell(p, _GRID5)
        bit5 = ((flat[_BASE5 + (idx5 >> 5)] >> (idx5 & 31)) & 1) != 0
        idx6 = _cell(p, _GRID6)
        bit6 = ((flat[_BASE6 + (idx6 >> 5)] >> (idx6 & 31)) & 1) != 0
        skip = skip4 | bit5 | bit6
        depth = torch.where(skip4, nib & 7,
                            torch.where(bit5, 5, 6).to(torch.int32))
        cube = pow2_f32(depth)
        u = p * cube[:, None]
        frac = u - torch.floor(u)
        t1 = -frac * invdir
        t2 = t1 + invdir
        tsub = torch.clamp_max(torch.maximum(t1, t2).amin(-1), 1e4) / cube
        delta = tsub + step
        adv = active & skip
        t = torch.where(adv, t + delta, t)
        cnt = cnt + adv.to(torch.int32)
        active = adv & (t < tmax)
    return t, cnt
