"""Guided compositor over the compact sample layout.

Counterpart of ``mega_nerf_viewer_tpu/ops/pallas_composite.py``
(``composite_results_compact_pallas`` and its Pallas kernel
``_make_compact_kernel``); the reference's ``composite_nerf_results``
(``rt_core.cuh:334-416``).  The compact cache of
``guided.collect_and_query_fast`` holds every valid sample once: ray r owns
rows ``[offs[r] - ns[r], offs[r])`` of ``res_c`` [M, out_dim], ``z_c`` [M]
and ``vdirs_c`` [M, 3]; rows past ``offs[-1]`` are padding.

On a CUDA tensor :func:`composite_results_compact_kernel` launches
``csrc/compact_composite.cu`` (one thread per ray walks its run); on a CPU
tensor it runs :func:`composite_results_compact_reference`, which lays the
runs out as a padded [R, max ns] view and composites with an exclusive
``torch.cumprod``.  Depth mode (``render_depth``) sums ``weight * T`` and
writes ``min(0.3 * sum, 1)`` in grey, as the JAX package's XLA route does
(``guided.py:706-707``, ``:724-726``): a branch of the same kernel that
reads no view directions.
"""

from __future__ import annotations

import torch

from .. import kernels
from .sh import masked_sh_basis


def _use_sh(opt, fmt_sh: bool, basis_dim: int) -> bool:
    """Whether the cache shades by SH (never in depth mode)."""
    return bool(fmt_sh) and basis_dim >= 1 and not opt.render_depth


def composite_results_compact_kernel(res_c, z_c, ray_of_p, offs, ns,
                                     vdirs_c, opt, basis_dim: int,
                                     fmt_sh: bool) -> torch.Tensor:
    """Composite the compact cache with per-sample view directions
    ``vdirs_c``; the arguments of ``composite_results_compact_pallas``.
    ``ray_of_p`` [M] (the ray of each row) is implied by ``offs``/``ns``
    and not read.  ``vdirs_c`` may be None for a cache that does not
    shade by SH, and in depth mode.  Returns [R, 4] rgba with alpha 1."""
    use_sh = _use_sh(opt, fmt_sh, basis_dim)
    if res_c.device.type == "cpu":
        return composite_results_compact_reference(
            res_c, z_c, ray_of_p, offs, ns, vdirs_c, opt, basis_dim, fmt_sh)
    return kernels.compact_composite(
        res_c.float().contiguous(), z_c.float().contiguous(),
        offs.to(torch.int32).contiguous(), ns.to(torch.int32).contiguous(),
        vdirs_c.float().contiguous() if use_sh else None, basis_dim, use_sh,
        opt.basis_minmax[0], opt.basis_minmax[1],
        depth=bool(opt.render_depth))


def composite_results_compact_reference(res_c, z_c, ray_of_p, offs, ns,
                                        vdirs_c, opt, basis_dim: int,
                                        fmt_sh: bool) -> torch.Tensor:
    """The plain version: gather each ray's run into a padded [R, max ns]
    view, then the padded compositor (``guided.composite_results``): delta
    to the next sample (0 on the last), ``wc = exp(-sigma * delta)``, the
    exclusive transmittance as a shifted ``cumprod`` (no division, so an
    opaque sample's ``wc == 0`` gives T = 0 after it, not NaN), weight T on
    the last sample and ``T * (1 - wc)`` before it, masked SH from the
    sample's view direction, sigmoid, and a masked sum.  Depth mode sums
    ``weight * T`` and writes ``min(0.3 * sum, 1)`` to rgb."""
    use_sh = _use_sh(opt, fmt_sh, basis_dim)
    M, out_dim = res_c.shape
    R = ns.shape[0]
    dev = res_c.device
    f32 = torch.float32
    sigma_idx = min(3, out_dim - 1)
    ns = ns.long()
    S = max(1, int(ns.max())) if R else 1
    j = torch.arange(S, device=dev)
    valid = j[None, :] < ns[:, None]
    is_last = j[None, :] == (ns[:, None] - 1)
    idx = ((offs.long() - ns)[:, None] + j[None, :]).clamp(0, max(M - 1, 0))
    res = res_c[idx].to(f32)                          # [R, S, out_dim]
    z = z_c[idx].to(f32)
    inner = valid & ~is_last
    z_next = torch.cat([z[:, 1:], torch.zeros((R, 1), dtype=f32,
                                              device=dev)], 1)
    delta = torch.where(inner, z_next - z, torch.zeros((), dtype=f32,
                                                       device=dev))
    wc = torch.exp(-res[..., sigma_idx] * delta)
    wc_eff = torch.where(inner, wc, torch.ones((), dtype=f32, device=dev))
    T = torch.cat([torch.ones((R, 1), dtype=f32, device=dev),
                   torch.cumprod(wc_eff, 1)[:, :-1]], 1)
    zero = torch.zeros((), dtype=f32, device=dev)
    weight = torch.where(is_last & valid, T,
                         torch.where(valid, T * (1.0 - wc), zero))
    if opt.render_depth:
        d = torch.where(valid, weight * T, zero).sum(1)
        rgb = torch.clamp_max(d * 0.3, 1.0)[:, None].expand(R, 3)
        return torch.cat([rgb, torch.ones((R, 1), dtype=f32, device=dev)], 1)
    if use_sh:
        B = basis_dim
        basis = masked_sh_basis(B, vdirs_c[idx].to(f32).reshape(-1, 3),
                                opt.basis_minmax[0], opt.basis_minmax[1])
        coeffs = res[..., :3 * B].reshape(R, S, 3, B)
        rgb_s = torch.sigmoid(
            (basis.reshape(R, S, 1, B) * coeffs).sum(-1))
    else:
        rgb_s = res[..., :3]
    rgb = torch.where(valid[..., None], weight[..., None] * rgb_s,
                      zero).sum(1)
    return torch.cat([rgb, torch.ones((R, 1), dtype=f32, device=dev)], 1)
