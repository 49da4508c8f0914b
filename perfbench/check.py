"""The comparison that decides ``correct``.

Each kept frame of the window (the program's own output, at the timed
size) is set beside the plain reference's frame at the same camera.  Two
numbers are compared, over every pixel of every kept frame:

* ``off_px_share``: the share of pixels whose largest channel error
  (r, g, b, alpha) exceeds the check's ``tolerance``;
* ``mean_abs_err``: the mean absolute error over all pixels and channels.

Both are steady from frame to frame: a ray whose march differs by one
step at a cell boundary moves one pixel, not the numbers.  The limits and
the tolerance are the cell's (``checks/<workload>.json``); how each was
set is in ``PERF.md``.
"""

from __future__ import annotations

import torch

NAMES = ("off_px_share", "mean_abs_err")


def frame_errors(got: torch.Tensor, want: torch.Tensor,
                 tolerance: float) -> tuple:
    """(pixels over ``tolerance``, pixels, sum of |error|, values) of one
    frame; a frame of the wrong shape, or one that is not finite, counts
    every pixel as off."""
    want = want.float()
    if got is None or tuple(got.shape) != tuple(want.shape):
        n = want.shape[0] * want.shape[1]
        return n, n, float("inf"), n * want.shape[2]
    got = got.to(want.device).float()
    err = (got - want).abs()
    err = torch.where(torch.isfinite(err), err,
                      torch.full((), float("inf"), device=err.device))
    px = err.amax(-1)
    return (int((px > tolerance).sum()), px.numel(), float(err.sum()),
            err.numel())


def judge(pairs, check: dict, shares: bool = False) -> dict:
    """``pairs``: (program frame, reference frame) of every kept frame.
    Returns ``numbers`` {name: (value, limit)}, each number beside its
    limit, ``failed`` (the kept frames over a limit) and, with ``shares``,
    the share of pixels over tolerances 1e-4, 1e-5 and 1e-6 (the readings
    a tolerance is chosen from)."""
    tol = float(check["tolerance"])
    off = n = 0
    abs_sum, vals = 0.0, 0
    failed = 0
    for got, want in pairs:
        o, p, s, v = frame_errors(got, want, tol)
        f_share, f_mean = o / p, s / v
        failed += int(f_share > check["limits"]["off_px_share"]
                      or not f_mean <= check["limits"]["mean_abs_err"])
        off, n, abs_sum, vals = off + o, n + p, abs_sum + s, vals + v
    values = {"off_px_share": off / max(n, 1),
              "mean_abs_err": abs_sum / max(vals, 1)}
    out = {"numbers": {k: (values[k], float(check["limits"][k]))
                       for k in NAMES},
           "failed": failed}
    if shares:
        out["shares"] = {t: sum(frame_errors(g, w_, t)[0] for g, w_ in pairs)
                         / max(n, 1) for t in (1e-4, 1e-5, 1e-6)}
    return out


def passed(numbers: dict) -> bool:
    return all(v <= lim for v, lim in numbers.values())
