"""The port's multi-device frames (``mega_nerf_viewer_tpu_torch/parallel``)
against the JAX package's sharded functions, at a world size of 1; the
host-side pieces (the chunk deal, the refine step's up-front check, the
collectives' backend rule) in-process.

The multi-device cases run in gloo worker processes
(``tests/torch_parallel_worker.py``, one per rank, all started by one
fixture per world size; ``test_torch_parallel_w2.py`` and ``_w4.py`` run
worlds 2 and 4), and JAX's sharded functions run here on a virtual CPU mesh
of the same size.  Every rank's results must be bit-equal to every other
rank's.  Tolerances are JAX's own (``tests/test_parallel.py``): the exact
and fast frames within 1e-6 of JAX's sharded frame and of the port's
single-device frame, with votes, visit marks, overflow counts and orders
equal; the segmented frames within 1e-6 of the port's single-device frame
and 1e-5 of JAX's (its segmented budget); guided and motion frames within
1e-5, with the motion CDF and the dealt quarter orders equal; sorted
output bit-exact through its index map.
"""

import os
import signal
import socket
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import mega_nerf_viewer_tpu.n3tree as J
from mega_nerf_viewer_tpu import parallel as JP
from mega_nerf_viewer_tpu.camera import Camera
from mega_nerf_viewer_tpu.models import MegaNeRFModel as JModel
from mega_nerf_viewer_tpu.options import RenderOptions
from mega_nerf_viewer_tpu.ops import accel as JA
from mega_nerf_viewer_tpu.ops import pallas_march as JM
from mega_nerf_viewer_tpu.ops.rays import rodrigues, screen2worlddir

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_parallel_worker.py")
SPAWN_TIMEOUT = 240
CENTER = (-1.5, 0.1, 1.4)
TOL = 1e-6
GUIDED_TOL = 1e-5


def _camera(w, h, f, center=CENTER):
    cam = Camera(w, h, f)
    cam.center = np.asarray(center, np.float32)
    cam._update()
    return cam


def _rays(cam, opt):
    dirs, cen = screen2worlddir(cam.width, cam.height, cam.fx, cam.fy,
                                cam.cx, cam.cy, jnp.asarray(cam.transform))
    return dirs, rodrigues(jnp.asarray(opt.rot_dirs, jnp.float32), dirs), cen


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _inputs(outdir):
    """What the workers read: the TP inputs, a skip model's weights, JAX's
    refinement draws and the CLI's tree."""
    rng = np.random.RandomState(1234)
    inp = dict(tp_x=rng.randn(64, 3).astype(np.float32),
               tp_ids=rng.randint(0, 4, 64).astype(np.int32))
    dims = [(3, 16), (16, 16), (19, 16), (16, 5)]
    for l, (a, b) in enumerate(dims):
        inp[f"skip_w{l}"] = (rng.randn(4, a, b) * 0.3).astype(np.float32)
        inp[f"skip_b{l}"] = (rng.randn(4, b) * 0.1).astype(np.float32)
    inp["rnd"] = np.asarray(jax.random.uniform(
        jax.random.PRNGKey(0), (16, 8, 8, 3), jnp.float32))
    np.savez(os.path.join(outdir, "inputs.npz"), **inp)
    J.sphere_tree(basis_dim=1, depth=2).save_npz(
        os.path.join(outdir, "cli_tree.npz"))
    return inp


def spawn(world, outdir):
    """Start ``world`` worker ranks (torchrun's environment when world >
    1); returns the processes."""
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env.update(OMP_NUM_THREADS="1", PYTHONUNBUFFERED="1")
    if world > 1:
        env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()),
                   WORLD_SIZE=str(world))
    procs = []
    for rank in range(world):
        e = dict(env)
        if world > 1:
            e.update(RANK=str(rank), LOCAL_RANK=str(rank))
        procs.append(subprocess.Popen(
            [sys.executable, WORKER, outdir, str(world), str(rank)],
            cwd=REPO, env=e, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, start_new_session=True))
    return procs


def collect(procs, outdir):
    """Wait for every rank (one deadline for all; on expiry or a failed
    rank every rank is killed); returns each rank's results."""
    import time
    deadline = time.monotonic() + SPAWN_TIMEOUT
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))
            outs.append(out.decode(errors="replace"))
            if p.returncode != 0:
                raise AssertionError(f"rank {len(outs) - 1} failed:\n"
                                     + outs[-1][-4000:])
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()
    return [dict(np.load(os.path.join(outdir, f"rank{r}.npz")))
            for r in range(len(procs))]


def jax_cases(n):
    """JAX's sharded functions on a virtual mesh of ``n`` devices, on the
    cases the workers ran."""
    mesh = JP.make_mesh((n,), (JP.RAY_AXIS,), jax.devices()[:n])
    out = {}
    tree = J.sphere_tree(basis_dim=1, depth=3)
    opt = RenderOptions()
    res = JP.render_rays_sharded(tree, *_rays(_camera(16, 16, 20.0), opt),
                                 opt, mesh, track_visit=True)
    out.update(exact_out=res.out, exact_split_vote=res.split_vote,
               exact_visited=res.visited)
    out["pad"] = JP.render_frame_sharded(J.sphere_tree(basis_dim=1, depth=2),
                                         _camera(9, 7, 10.0), opt, mesh)
    # fast, and fast with the skip table
    tree = J.sphere_tree(basis_dim=4, depth=3)
    out["fast"], out["fast_ov"] = JP.render_frame_fast_sharded(
        tree, JA.build_leaf_map(tree), _camera(16, 16, 20.0),
        RenderOptions(background_brightness=0.3), mesh)
    tree = J.sphere_tree(basis_dim=1, depth=3)
    tab = JM.build_skip_table(tree, opt.sigma_thresh)
    out["skip"], out["skip_ov"] = JP.render_frame_fast_sharded(
        tree, JA.build_leaf_map(tree), _camera(16, 16, 18.0), opt, mesh,
        max_dense=16, skip_table=tab)
    # segmented: stride deal, starved, sorted output, chunk-exact
    tree = J.sphere_tree(basis_dim=4, depth=4)
    lm = JA.build_leaf_map(tree)
    cam = _camera(32, 32, 24.0, (-1.6, 0.3, 1.5))
    _, _, steps, nrec = JA.render_frame_fast(
        tree, lm, cam, opt, max_dense=16, chunk_size=64, block=8,
        return_nrec=True)
    order = JA.order_from_hints(steps, nrec)
    out["seg_perm"] = order[0]
    segs = ((0.5, 2), (0.25, 4), (0.25, 16))
    out["seg"], out["seg_ov"] = JP.render_frame_fast_segmented_sharded(
        tree, lm, cam, opt, order=order, segments=segs, mesh=mesh,
        chunk_size=64)
    _, out["seg_starved_ov"] = JP.render_frame_fast_segmented_sharded(
        tree, lm, cam, opt, order=order,
        segments=((0.5, 0), (0.25, 0), (0.25, 1)), mesh=mesh, chunk_size=64)
    out["seg_rows"], out["seg_sorted_ov"], out["seg_index"] = \
        JP.render_frame_fast_segmented_sharded(
            tree, lm, cam, opt, order=order, segments=segs, mesh=mesh,
            chunk_size=64, sorted_output=True)
    perm = np.asarray(order[0])
    counts = JA.seg_counts_from_hints(np.asarray(nrec)[perm], 32, quantum=n)
    costs = np.asarray(steps)[perm].reshape(-1, 32).sum(1).astype(np.float64)
    out["exact_counts"] = np.asarray(counts, np.int64)
    out["exact_costs"] = costs
    out["chunk_exact"], out["chunk_exact_ov"] = \
        JP.render_frame_fast_segmented_sharded(
            tree, lm, cam, opt, order=order, segments=None, mesh=mesh,
            chunk_size=32, seg_counts=counts, chunk_costs=costs)
    # guided
    tree = J.sphere_tree(basis_dim=1, depth=3)
    lm = JA.build_leaf_map(tree)
    model = JModel.synthetic(data_dim=4, n_clusters=4, grid_dim=(2, 2),
                             min_position=(-1, -1, -1),
                             max_position=(1, 1, 1), need_viewdir=True)
    gopt = RenderOptions(max_guided_samples=16, need_viewdir=True,
                         use_guided_sampling=True)
    img, ov = JP.guided_frame_sharded(tree, lm, model, _camera(16, 16, 18.0),
                                      gopt, mesh, budget=1 << 12)
    out["guided"], out["guided_ov"] = img, np.int32(ov)
    out["guided_starved_ov"] = np.int32(JP.guided_frame_sharded(
        tree, lm, model, _camera(16, 16, 18.0), gopt, mesh, budget=1)[1])
    # motion
    tree = J.sphere_tree(basis_dim=4, depth=4)
    lm = JA.build_leaf_map(tree)
    cam = _camera(64, 48, 70.0)
    _, _, steps, nrec, skips = JA.render_frame_fast(
        tree, lm, cam, opt, max_dense=16, chunk_size=0, return_nrec=True,
        return_skips=True)
    ph = JA.pack_hints(steps, nrec, skips)
    perm, inv = JA.order_from_packed_device(ph)
    qperm = JA.quarter_order_from_packed(ph, width=64)
    segs = JA.segments_from_hint_cdf(
        np.asarray(JA.hint_class_cdf(jnp.asarray(nrec))), 64 * 48, margin=2,
        top_headroom=True)
    out["motion_segs"] = np.asarray(segs, np.float64)
    pix_str, qpix_str = JP.motion_episode_layout(
        (perm, inv), qperm, mesh=mesh, chunk_size=64, hint_chunk=32)
    out["motion_pix_str"], out["motion_qpix_str0"] = pix_str, qpix_str
    for i, pose in enumerate([(-1.45, 0.12, 1.35), (-1.42, 0.14, 1.38)]):
        cam.center = np.array(pose, np.float32)
        cam._update()
        img, ov, qpix_str, cdf = JP.render_frame_motion_sharded(
            tree, lm, cam, opt, qpix_str, pix_str, segs, mesh=mesh,
            chunk_size=64, hint_chunk=32)
        out[f"motion{i}"], out[f"motion{i}_ov"] = img, ov
        out[f"motion{i}_qpix"], out[f"motion{i}_cdf"] = qpix_str, cdf
    return {k: np.asarray(v) for k, v in out.items()}


def run_world(world, outdir):
    """Spawn the ranks, run JAX's side meanwhile, and return (ranks,
    jax results)."""
    outdir = str(outdir)
    inputs = _inputs(outdir)
    procs = spawn(world, outdir)
    try:
        jx = jax_cases(world)
    finally:
        ranks = collect(procs, outdir)       # kills every rank on failure
    return dict(world=world, ranks=ranks, jax=jx, inputs=inputs,
                outdir=outdir)


# ----------------------------------------------------------------------
# The checks every world runs
# ----------------------------------------------------------------------
def check_ranks_equal(run):
    """Every rank's results bit-equal to rank 0's."""
    r0 = run["ranks"][0]
    for r, other in enumerate(run["ranks"][1:], 1):
        assert set(other) == set(r0)
        for k in r0:
            np.testing.assert_array_equal(other[k], r0[k],
                                          err_msg=f"rank {r}: {k}")


def check_exact(run):
    p, j = run["ranks"][0], run["jax"]
    np.testing.assert_allclose(p["exact_out"], j["exact_out"], atol=TOL)
    np.testing.assert_allclose(p["exact_out"], p["exact_out_single"],
                               atol=TOL)
    for k in ("split_vote", "visited"):
        np.testing.assert_array_equal(p[f"exact_{k}"], j[f"exact_{k}"])
        np.testing.assert_array_equal(p[f"exact_{k}"],
                                      p[f"exact_{k}_single"])
    assert p["exact_visited"].sum() > 1


def check_pad(run):
    p, j = run["ranks"][0], run["jax"]
    assert p["pad"].shape == (7, 9, 4)
    np.testing.assert_allclose(p["pad"], j["pad"], atol=TOL)
    np.testing.assert_allclose(p["pad"], p["pad_single"], atol=TOL)


def check_fast(run):
    p, j = run["ranks"][0], run["jax"]
    for k in ("fast", "skip"):
        assert int(p[f"{k}_ov"]) == int(j[f"{k}_ov"]) == 0
        np.testing.assert_allclose(p[k], j[k], atol=TOL)
        np.testing.assert_allclose(p[k], p[f"{k}_single"], atol=TOL)
    assert p["fast"][..., 3].max() > 0.5


def check_segmented(run):
    p, j = run["ranks"][0], run["jax"]
    np.testing.assert_array_equal(p["seg_perm"], j["seg_perm"])
    for k in ("seg", "chunk_exact"):
        assert not p[f"{k}_ov"].any()
        np.testing.assert_array_equal(p[f"{k}_ov"], j[f"{k}_ov"])
        # JAX's segmented budget (test_parallel.py:289): the basis-4 SH
        # shading differs by ulps between XLA:CPU and PyTorch
        np.testing.assert_allclose(p[k], j[k], atol=GUIDED_TOL)
        np.testing.assert_allclose(p[k], p["seg_single"], atol=TOL)
    assert p["seg_starved_ov"].any()
    np.testing.assert_array_equal(p["seg_starved_ov"], j["seg_starved_ov"])
    # sorted output: rows and index map recover the frame bit-exactly
    np.testing.assert_array_equal(p["seg_index"], j["seg_index"])
    np.testing.assert_array_equal(
        p["seg_rows"][p["seg_index"]].reshape(32, 32, 4), p["seg"])
    np.testing.assert_array_equal(p["exact_counts"], j["exact_counts"])
    np.testing.assert_array_equal(p["exact_costs"], j["exact_costs"])


def check_guided(run):
    p, j = run["ranks"][0], run["jax"]
    assert int(p["guided_ov"]) == int(j["guided_ov"]) == 0
    assert int(p["guided_starved_ov"]) == int(j["guided_starved_ov"]) == 1
    np.testing.assert_allclose(p["guided"], j["guided"], atol=GUIDED_TOL)
    np.testing.assert_allclose(p["guided"], p["guided_single"],
                               atol=GUIDED_TOL)
    assert p["guided"][..., :3].max() > 0


def check_motion(run):
    p, j = run["ranks"][0], run["jax"]
    np.testing.assert_array_equal(p["motion_segs"], j["motion_segs"])
    np.testing.assert_array_equal(p["motion_pix_str"], j["motion_pix_str"])
    np.testing.assert_array_equal(p["motion_qpix_str0"],
                                  j["motion_qpix_str0"])
    for i in (0, 1):
        assert not p[f"motion{i}_ov"].any()
        np.testing.assert_array_equal(p[f"motion{i}_ov"], j[f"motion{i}_ov"])
        np.testing.assert_array_equal(p[f"motion{i}_cdf"],
                                      j[f"motion{i}_cdf"])
        np.testing.assert_array_equal(p[f"motion{i}_cdf"],
                                      p[f"motion{i}_single_cdf"])
        np.testing.assert_array_equal(p[f"motion{i}_qpix"],
                                      j[f"motion{i}_qpix"])
        np.testing.assert_allclose(p[f"motion{i}"], j[f"motion{i}"],
                                   atol=GUIDED_TOL)
        np.testing.assert_allclose(p[f"motion{i}"], p[f"motion{i}_fresh"],
                                   atol=GUIDED_TOL)
    # sorted output: rows scattered to their pixel ids, pads dropped
    R = 64 * 48
    pid = p["motion_pix_sorted"]
    img = np.zeros((R, 4), np.float32)
    img[pid[pid < R]] = p["motion_rows"][pid < R]
    np.testing.assert_array_equal(img.reshape(48, 64, 4),
                                  p["motion_sorted_img"])


def check_default_mesh(run):
    np.testing.assert_array_equal(run["ranks"][0]["default_mesh"],
                                  [run["world"], 1])


CASES = dict(ranks_equal=check_ranks_equal, exact=check_exact,
             pad=check_pad, fast=check_fast, segmented=check_segmented,
             guided=check_guided, motion=check_motion,
             default_mesh=check_default_mesh)


def check_cli(run):
    """The sharded CLI's PNG against the JAX CLI's ``--sharded`` PNG on
    the same tree: rgba8 equal or within one level."""
    from mega_nerf_viewer_tpu.cli import main
    from mega_nerf_viewer_tpu.utils import read_png
    ref = os.path.join(run["outdir"], "jax_cli.png")
    assert main([os.path.join(run["outdir"], "cli_tree.npz"), "-w", "16",
                 "--height", "16", "--fx", "16", "--center=-1.5,0.1,1.4",
                 "--sharded", "-o", ref]) == 0
    a = read_png(ref).astype(np.int32)
    b = read_png(os.path.join(run["outdir"], "cli.png")).astype(np.int32)
    assert b.shape == a.shape == (16, 16, 4)
    assert np.abs(a - b).max() <= 1
    assert b[..., 3].max() > 0


# ----------------------------------------------------------------------
# World 1
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def world1(tmp_path_factory):
    return run_world(1, tmp_path_factory.mktemp("world1"))


@pytest.mark.parametrize("case", sorted(CASES))
def test_sharded_world1(world1, case):
    CASES[case](world1)


def test_cli_sharded_world1(world1):
    """``cli --sharded`` run plainly: a world of one in-process."""
    check_cli(world1)


# ----------------------------------------------------------------------
# In-process: the deal, the step's check, the collectives' rule
# ----------------------------------------------------------------------
@pytest.mark.parametrize("n_shards,seed", [(2, 0), (4, 1), (8, 2)])
def test_deal_chunks_balanced_matches_jax(n_shards, seed):
    from mega_nerf_viewer_tpu.parallel.render import \
        deal_chunks_balanced as jdeal
    from mega_nerf_viewer_tpu_torch.parallel import deal_chunks_balanced
    rng = np.random.RandomState(seed)
    strata = tuple((n_shards * int(k), int(b)) for k, b in
                   zip(rng.randint(1, 6, 4), (0, 2, 8, 32)))
    costs = rng.exponential(10.0, sum(n for n, _ in strata))
    costs[::5] = costs[1::5][:len(costs[::5])]      # ties
    got, got_counts = deal_chunks_balanced(costs, strata, n_shards)
    want, want_counts = jdeal(costs, strata, n_shards)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32 and got_counts == want_counts
    assert sorted(got) == list(range(len(costs)))


class _Axes:
    """A stand-in mesh with a 3-wide ray axis: the step's check reads only
    the axis size (no world of three is started)."""
    shape = {"rays": 3, "model": 1}


def test_frame_refine_step_checks_the_fill_batch():
    from mega_nerf_viewer_tpu_torch import RenderOptions as POpt
    from mega_nerf_viewer_tpu_torch import parallel as PP
    kw = dict(use_splitting=True, split_batch_size=1, samples_per_corner=1)
    with pytest.raises(ValueError) as want:
        JP.make_frame_refine_step(
            JP.make_mesh((3,), (JP.RAY_AXIS,), jax.devices()[:3]),
            RenderOptions(**kw))
    with pytest.raises(ValueError) as got:
        PP.make_frame_refine_step(_Axes(), POpt(**kw))
    assert str(got.value) == str(want.value)
    PP.make_frame_refine_step(_Axes(), POpt(**dict(kw, split_batch_size=3)))


def test_backend_for_device():
    """NCCL for ranks on the card, gloo for ranks on the CPU."""
    from mega_nerf_viewer_tpu_torch.parallel import mesh
    assert mesh.backend_for("cuda:0") == "nccl"
    assert mesh.backend_for("cuda") == "nccl"
    assert mesh.backend_for("cpu") == "gloo"


def test_tp_layer_kinds_match_jax():
    from mega_nerf_viewer_tpu.parallel.model import tp_layer_kind as jkind
    from mega_nerf_viewer_tpu_torch.parallel.model import tp_layer_kind
    for n in range(1, 7):
        for skips in ((), (2,)):
            assert [tp_layer_kind(l, n, skips) for l in range(n)] == \
                [jkind(l, n, skips) for l in range(n)]
