"""Exact f32 helpers shared by the plain PyTorch paths and the kernels.

The march's start ``t`` must be bit-equal between the entry-skip prepass,
the march, their plain versions and the JAX reference.  Two operations
need care for that:

* ``cen + t * d``: the JAX reference's compiler contracts this into one
  fused multiply-add (one rounding), which separate PyTorch ops cannot
  express.  :func:`fma_f32` computes the correctly rounded f32 FMA from
  float64 pieces; the CUDA kernels call ``__fmaf_rn`` at the same place
  and are otherwise built with ``-fmad=false``.
* ``1 / norm``: the reference's compiler turns it into a reciprocal
  square root; :func:`rsqrt_f32` is the correctly rounded one.
* ``exp2(depth)`` for an integer leaf depth: :func:`pow2_f32` builds the
  power of two from its exponent bits, exact for every depth a tree can
  have (the kernels do the same).
"""

from __future__ import annotations

import torch


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``round_f32(a * b + c)`` with a single rounding, like C ``fmaf``.

    ``a * b`` of two f32 values is exact in float64; the float64 sum is
    then rounded once more, which differs from one rounding only when it
    lands exactly halfway between two f32 values.  The sum's exact
    residual (TwoSum) breaks such ties toward the true value.
    """
    a64, b64, c64 = a.double(), b.double(), c.double()
    p = a64 * b64
    s = p + c64
    bv = s - p
    e = (p - (s - bv)) + (c64 - bv)
    r = s.float()
    rd = r.double()
    # a fill, not a host-to-device copy: a copy would wait for the card
    inf = torch.full((), float("inf"), dtype=torch.float32, device=r.device)
    nb = torch.nextafter(r, torch.where(s > rd, inf, -inf))
    nbd = nb.double()
    tie = (s != rd) & (2.0 * s == rd + nbd)
    toward_nb = (e != 0) & ((e > 0) == (nbd > rd))
    return torch.where(tie & toward_nb, nb, r)


def pow2_f32(depth: torch.Tensor) -> torch.Tensor:
    """``2 ** depth`` as f32 for integer ``depth`` in [-126, 127], exact."""
    return ((depth.to(torch.int32) + 127) << 23).view(torch.float32)


def ipow_f32(n: int, e: torch.Tensor) -> torch.Tensor:
    """``n ** e`` as f32 for an integer base ``n`` and integer ``e``,
    rounded once (exact whenever the power is an f32; the kernels compute
    it the same way).  XLA:CPU's ``power`` is exact at these arguments."""
    if n == 2:
        return pow2_f32(e)
    base = torch.full((), float(n), dtype=torch.float64, device=e.device)
    return torch.pow(base, e.to(torch.float64)).float()


def rsqrt_f32(s: torch.Tensor) -> torch.Tensor:
    """``1 / sqrt(s)`` of f32 ``s``, rounded once to f32 (from float64)."""
    return torch.rsqrt(s.double()).float()
