"""Guided compositor over the padded sample layout.

Counterpart of ``mega_nerf_viewer_tpu/ops/pallas_composite.py``
(``composite_results_pallas`` and its Pallas kernel ``_make_kernel``) and
of the XLA compositor ``guided.composite_results`` that ``composite_frame``
runs on the padded cache of ``collect_and_query`` (the reference's
``composite_nerf_results``, ``rt_core.cuh:334-416``).  Ray r owns the
slots ``[0, ns[r])`` of ``results`` [R, S, out_dim] and ``z_vals``
[R, S]; the slots past ``ns[r]`` are padding.

On a CUDA tensor :func:`composite_results_padded` launches
``csrc/padded_composite.cu`` (a tile of lanes per ray scans its valid slots);
on a CPU tensor it runs :func:`composite_results_padded_reference`, the
XLA formula with an exclusive ``torch.cumprod``.  Both cover the three
branches of ``guided.composite_results``: SH shading from the ray's view
direction (the masked ``[R, B]`` basis is computed outside the kernel, as
the Pallas wrapper does), depth mode (``d0 = sum(weight * T)``, the
reference's quirk) and the raw ``results[..., :3]`` of a tree that is not
SH.
"""

from __future__ import annotations

import torch

from .. import kernels
from .sh import masked_sh_basis

# the kernel's shading modes
MODE_SH, MODE_DEPTH, MODE_RGB = 0, 1, 2


def _mode(opt, fmt_sh: bool, basis_dim: int) -> int:
    if opt.render_depth:
        return MODE_DEPTH
    return MODE_SH if fmt_sh and basis_dim >= 1 else MODE_RGB


def composite_results_padded(results, z_vals, num_samples, vdirs, opt,
                             basis_dim: int, fmt_sh: bool) -> torch.Tensor:
    """Composite the padded cache; the arguments of
    ``guided.composite_results``.  Returns [R, 4] rgba with alpha 1."""
    if results.device.type == "cpu":
        return composite_results_padded_reference(
            results, z_vals, num_samples, vdirs, opt, basis_dim, fmt_sh)
    mode = _mode(opt, fmt_sh, basis_dim)
    basis = None
    if mode == MODE_SH:
        basis = masked_sh_basis(basis_dim, vdirs.float(), opt.basis_minmax[0],
                                opt.basis_minmax[1]).contiguous()
    return kernels.padded_composite(
        results.float().contiguous(), z_vals.float().contiguous(),
        num_samples.to(torch.int32).contiguous(), basis, mode)


def composite_results_padded_reference(results, z_vals, num_samples, vdirs,
                                       opt, basis_dim: int,
                                       fmt_sh: bool) -> torch.Tensor:
    """The plain version (``guided.py:196-240``): delta to the next slot
    (0 past the last), ``wc = exp(-sigma * delta)``, the exclusive
    transmittance as a shifted ``cumprod`` over the valid slots before
    the last (an opaque sample gives T = 0 after it, not NaN), weight T on
    the last valid slot and ``T * (1 - wc)`` before it, then the mode's
    shading and a masked sum."""
    R, S, out_dim = results.shape
    dev = results.device
    f32 = torch.float32
    results = results.to(f32)
    z = z_vals.to(f32)
    sigma_idx = min(3, out_dim - 1)
    ns = num_samples.long()
    slots = torch.arange(S, device=dev)
    valid = slots[None, :] < ns[:, None]
    is_last = slots[None, :] == (ns[:, None] - 1)
    zero = torch.zeros((), dtype=f32, device=dev)
    one = torch.ones((), dtype=f32, device=dev)
    delta = torch.cat([z[:, 1:] - z[:, :-1],
                       torch.zeros((R, 1), dtype=f32, device=dev)], 1)
    wc = torch.exp(-results[..., sigma_idx] * delta)
    wc_eff = torch.where(valid & ~is_last, wc, one)
    T = torch.cat([torch.ones((R, 1), dtype=f32, device=dev),
                   torch.cumprod(wc_eff, 1)[:, :-1]], 1)
    weight = torch.where(is_last & valid, T,
                         torch.where(valid, T * (1.0 - wc), zero))
    mode = _mode(opt, fmt_sh, basis_dim)
    if mode == MODE_DEPTH:
        d0 = (weight * T).sum(1)
        rgb = torch.clamp_max(d0 * 0.3, 1.0)[:, None].expand(R, 3)
    elif mode == MODE_SH:
        B = basis_dim
        basis = masked_sh_basis(B, vdirs.to(f32), opt.basis_minmax[0],
                                opt.basis_minmax[1])
        coeffs = results[..., :3 * B].reshape(R, S, 3, B)
        rgb_s = torch.sigmoid((basis[:, None, None, :] * coeffs).sum(-1))
        rgb = (weight[..., None] * rgb_s).sum(1)
    else:
        rgb = (weight[..., None] * results[..., :3]).sum(1)
    return torch.cat([rgb, torch.ones((R, 1), dtype=f32, device=dev)], 1)
