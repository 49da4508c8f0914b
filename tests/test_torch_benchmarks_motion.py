"""``benchmarks_torch/motion1080p.py`` and ``foveated1080p.py`` against
the JAX scripts, on the CPU at ``tools/smoke_benchmarks.sh``'s sizes
(160x90 and 160x96, depth 5).

Each JAX script runs in-process through its ``main`` (``BENCH_WH`` and
``BENCH_DEPTH`` set) and each port script through its ``main`` under
``BENCH_FORCE_CPU=1`` (its line is checked by ``run_port``), with a spy on
both Viewers' ``render``.  Equal: ``hint_rebuilds`` (each script patches
its own package's ``ops.accel``), ``motion_mode`` and ``policy``.  Every
frame the Viewers rendered (the warm-up, the rewind, the timed poses;
foveated and f = 1, parked and moving) is within BASELINE's 1e-3 of JAX's:
the scene is the sigma = 400 shell, which XLA:CPU's ``exp`` moves by about
2.7e-5.
"""

import numpy as np
import pytest

import mega_nerf_viewer_tpu_torch as P
from mega_nerf_viewer_tpu import Viewer as JViewer

from test_torch_benchmarks_contract import (  # noqa: F401 (few_threads)
    check_keys, few_threads, render_spy, run_jax, run_port)

TOL = 1e-3
MOTION_ENV = dict(BENCH_WH="160x90", BENCH_DEPTH="5")
FOVEATED_ENV = dict(BENCH_WH="160x96", BENCH_DEPTH="5")


def _both(name, argv, env):
    with render_spy(JViewer) as jf:
        jrec = run_jax(name, argv, env)
    with render_spy(P.Viewer) as pf:
        prec, ns = run_port(name, argv, env)
    return jrec, prec, ns, jf[JViewer], pf[P.Viewer]


def _frames_equal(pframes, jframes, shape):
    assert len(pframes) == len(jframes)
    for i, (got, want) in enumerate(zip(pframes, jframes)):
        assert got.shape == want.shape == shape
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL,
                                   err_msg=f"frame {i}")


@pytest.fixture(scope="module", params=["async", "device"])
def motion(request):
    return _both("motion1080p", ["4", "3", "8", request.param], MOTION_ENV)


def test_motion_line(motion):
    jrec, prec, _, _, _ = motion
    check_keys("motion1080p", prec, jrec)
    for k in ("poses", "deg_per_pose", "policy", "motion_mode",
              "hint_rebuilds"):
        assert prec[k] == jrec[k], k
    assert prec["hint_rebuilds"] > 0


def test_motion_frames(motion):
    """1 + 4 warm poses, the rewound parked frame and the 4 timed poses."""
    _, prec, ns, jframes, pframes = motion
    assert len(pframes) == 6 + prec["poses"]
    _frames_equal(pframes, jframes, (90, 160, 4))
    assert float(pframes[-1][..., 3].max()) > 0.5
    assert ns.checksum == pytest.approx(
        sum(float(f.sum()) for f in pframes[-prec["poses"]:]), rel=1e-5)


@pytest.fixture(scope="module")
def foveated():
    return _both("foveated1080p", ["4", "2", "3"], FOVEATED_ENV)


def test_foveated_line(foveated):
    jrec, prec, _, _, _ = foveated
    check_keys("foveated1080p", prec, jrec)
    assert prec["f"] == jrec["f"] == 4
    assert prec["value"] == prec["steady_fps"] > 0
    for k in ("motion_fps", "exact_steady_fps", "exact_motion_fps"):
        assert prec[k] > 0


def test_foveated_frames(foveated):
    """Per Viewer (f = 4, then f = 1): 2 warm and 10 parked frames, then 3
    warm and 2 timed poses."""
    _, _, ns, jframes, pframes = foveated
    assert len(pframes) == 2 * (12 + 5)
    _frames_equal(pframes, jframes, (96, 160, 4))
    assert sorted(ns.viewers) == [1, 4]
    assert ns.viewers[4].foveation == 4
