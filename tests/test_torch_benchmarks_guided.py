"""``benchmarks_torch/guided1080p.py`` and ``motion_guided1080p.py``
against the JAX scripts, on the CPU at ``tools/smoke_benchmarks.sh``'s
sizes (160x96 and 160x90, depth 5, S = 16).

Each JAX script runs in-process through its ``main`` (``BENCH_WH`` and
``BENCH_DEPTH`` set), with spies on the JAX functions it calls; each port
script runs through its ``main`` under ``BENCH_FORCE_CPU=1`` (its line is
checked by ``run_port``).  Equal: ``mlp_samples``, the segmented collect's
sum and per-ray counts, the ``(steps, ns)`` order and the CDF segments.
The frames (the compact composite; each Viewer pose) are within BASELINE's
1e-3: the scenes are the sigma = 400 shell, which XLA:CPU's ``exp`` moves
by about 2.7e-5.
"""

import numpy as np
import pytest

import mega_nerf_viewer_tpu_torch as P
from mega_nerf_viewer_tpu import Viewer as JViewer
from mega_nerf_viewer_tpu.ops import accel as JA
from mega_nerf_viewer_tpu.ops import guided as JG

from test_torch_benchmarks_contract import (  # noqa: F401 (few_threads)
    check_keys, few_threads, render_spy, run_jax, run_port)

TOL = 1e-3
GUIDED_ENV = dict(BENCH_WH="160x96", BENCH_DEPTH="5")
GUIDED_ARGV = ["16"]
MOTION_ENV = dict(BENCH_WH="160x90", BENCH_DEPTH="5")


@pytest.fixture(scope="module")
def guided():
    seen = {"composite": [], "collect": [], "order": []}
    with pytest.MonkeyPatch.context() as mp:
        comp, coll, order = (JG.composite_frame, JG.collect_and_query_fast,
                             JA.order_from_hints)

        def spy_comp(*a, **k):
            img = comp(*a, **k)
            seen["composite"].append(np.asarray(img))
            return img

        def spy_coll(*a, **k):
            c = coll(*a, **k)
            seen["collect"].append((k.get("segments"),
                                    np.asarray(c["num_samples"])))
            return c

        def spy_order(*a, **k):
            o = order(*a, **k)
            seen["order"].append(tuple(np.asarray(x) for x in o))
            return o

        mp.setattr(JG, "composite_frame", spy_comp)
        mp.setattr(JG, "collect_and_query_fast", spy_coll)
        mp.setattr(JA, "order_from_hints", spy_order)
        jrec = run_jax("guided1080p", GUIDED_ARGV, GUIDED_ENV)
    prec, ns = run_port("guided1080p", GUIDED_ARGV, GUIDED_ENV)
    return jrec, prec, ns, seen


def test_guided_line(guided):
    """The port's line has JAX's keys but ``composite_pallas_ms``."""
    jrec, prec, _, _ = guided
    check_keys("guided1080p", prec, jrec)
    assert "composite_pallas_ms" in jrec
    assert prec["max_guided_samples"] == jrec["max_guided_samples"] == 16


def test_guided_mlp_samples(guided):
    jrec, prec, ns, _ = guided
    assert prec["mlp_samples"] == jrec["mlp_samples"] > 0
    assert ns.n_samples_seg == prec["mlp_samples"]


def test_guided_order(guided):
    """The ``(steps, ns)`` order of the first invalidation's hints."""
    _, _, ns, seen = guided
    (jperm, jinv), = seen["order"]
    np.testing.assert_array_equal(ns.order[0].numpy(), jperm)
    np.testing.assert_array_equal(ns.order[1].numpy(), jinv)


def test_guided_segmented_collect(guided):
    """The CDF segments and the segmented collect's per-ray counts (pixel
    order) equal JAX's last segmented invalidation's."""
    _, _, ns, seen = guided
    segmented = [(s, n) for s, n in seen["collect"] if s is not None]
    assert len(segmented) == 4                 # one warm, three timed
    jsegs, jns = segmented[-1]
    assert tuple(ns.segments) == tuple(jsegs)
    np.testing.assert_array_equal(ns.cache_s["num_samples"].numpy(), jns)
    assert int(jns.sum()) == ns.n_samples_seg


def test_guided_composite(guided):
    """Kernel D's plain version against JAX's XLA compositor on the same
    ordered cache (JAX's first composite, ``use_pallas=False``)."""
    _, _, ns, seen = guided
    want = seen["composite"][0]
    got = ns.img.numpy()
    assert got.shape == want.shape == (96, 160, 4)
    assert float(got[..., :3].max()) > 0.05
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


@pytest.fixture(scope="module", params=[1, 4], ids=["f1", "f4"])
def motion_guided(request):
    argv = ["2", "3", "16", str(request.param)]
    with render_spy(JViewer) as jf:
        jrec = run_jax("motion_guided1080p", argv, MOTION_ENV)
    with render_spy(P.Viewer) as pf:
        prec, ns = run_port("motion_guided1080p", argv, MOTION_ENV)
    return request.param, jrec, prec, ns, jf[JViewer], pf[P.Viewer]


def test_motion_guided_line(motion_guided):
    fov, jrec, prec, _, _, _ = motion_guided
    check_keys("motion_guided1080p", prec, jrec)
    for k in ("poses", "deg_per_pose", "max_guided_samples", "foveation"):
        assert prec[k] == jrec[k]
    assert prec["foveation"] == fov
    assert 1 <= prec["warmup_poses"] <= 12


def test_motion_guided_frames(motion_guided):
    """Each pose of the port's run (the first invalidation, its warm-up
    poses and the timed ones) against JAX's frame of the same pose: both
    runs orbit by the same step from the same start, and JAX's longer
    warm-up only renders more poses after them."""
    _, jrec, prec, ns, jframes, pframes = motion_guided
    n = 1 + prec["warmup_poses"] + prec["poses"]
    assert len(pframes) == n
    assert len(jframes) == 1 + jrec["warmup_poses"] + jrec["poses"] >= n
    for i, (got, want) in enumerate(zip(pframes, jframes)):
        assert got.shape == want.shape == (90, 160, 4)
        assert float(got[..., :3].max()) > 0.05, i
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL,
                                   err_msg=f"pose {i}")
    # the checksum is the timed poses' sum
    timed = pframes[-prec["poses"]:]
    assert ns.checksum == pytest.approx(sum(float(f.sum()) for f in timed),
                                        rel=1e-5)
