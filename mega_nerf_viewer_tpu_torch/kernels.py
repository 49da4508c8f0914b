"""Build, bind and launch the port's CUDA kernels; count their launches.

The sources under ``csrc/`` have a plain C interface.  At first use they
are compiled with ``nvcc`` for ``sm_90a`` (one process per source, run in
parallel, then one link) into ``build/kernels/`` of the checkout, keyed by
a hash of the sources and flags, and loaded with ``ctypes``.  Every kernel
is built with ``-fmad=false``: the JAX reference rounds each f32 op
separately except where the kernels call ``__fmaf_rn`` explicitly, and
the prepass's ``t`` must be bit-equal to the march's and the collect
march's.  The nine kernels: ``skip_prepass`` (B), ``march`` (A, with
votes and depth mode), ``collect`` (C, the guided collect march),
``compact_composite`` (D, the compact guided compositor, with depth
mode), ``exact_march`` (E, the exact renderer's march with votes and
visit marks), ``exact_collect`` (F, the exact guided collect),
``padded_composite`` (G, the padded guided compositor),
``gather_chunk_sums`` (H, the row-gather probe) and ``mlp_gemm`` (I, one
fused per-cluster product of the Mega-NeRF model).

Each launch function checks its tensors, allocates the outputs, launches
on PyTorch's current stream, raises on a non-zero ``cudaGetLastError()``
and adds one to its entry of :data:`LAUNCHES` (kernel D's depth mode
counts under ``compact_composite_depth``).  There is no fallback: a
tensor that is not on a CUDA device is refused.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch


_PKG = Path(__file__).resolve().parent
_CSRC = _PKG / "csrc"
_BUILD = _PKG.parent / "build" / "kernels"
SOURCES = ("skip_prepass.cu", "march.cu", "collect.cu",
           "compact_composite.cu", "exact_march.cu", "exact_collect.cu",
           "padded_composite.cu", "gather_probe.cu", "mlp_gemm.cu")
HEADERS = ("common.cuh", "march_step.cuh", "descend_step.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xcompiler", "-fPIC")

# launches per kernel since the last reset_launch_counts()
LAUNCHES = {"skip_prepass": 0, "march": 0, "march_gated": 0, "collect": 0,
            "compact_composite": 0, "compact_composite_depth": 0,
            "exact_march": 0, "exact_collect": 0, "padded_composite": 0,
            "gather_chunk_sums": 0, "mlp_gemm": 0}

_lock = threading.Lock()
_lib = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_SIGNATURES = {
    # table, cen, d, invdir, tmin, tmax, live, step_size, R, t_out,
    # skips_out, stream
    "skip_prepass_launch": (_P, _P, _P, _P, _P, _P, _P, _F, _I, _P, _P, _P),
    # child, n_child, data, n_nodes, data_dim, rows, n_cells, level,
    # deep_levels, cen, d, invdir, delta_scale, tmin, tmax, miss, basis,
    # basis_dim, use_sh, step_size, sigma_thresh, stop_thresh, max_dense,
    # R, out, nsteps, nrec, overflow, counts, need_votes, max_depth,
    # max_sample_count, render_depth, split_vote, sample_vote, gate, n_gate,
    # stream
    "march_launch": (_P, _L, _P, _L, _I, _P, _L, _I, _I, _P, _P, _P, _P,
                     _P, _P, _P, _P, _I, _I, _F, _F, _F, _I, _I, _P, _P,
                     _P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _I, _P),
    # child, n_child, data, n_nodes, data_dim, rows, n_cells, level,
    # deep_levels, cen, d, invdir, delta_scale, tmin, tmax, miss, S,
    # step_size, sigma_thresh, stop_thresh, R, t_buf, ns, steps, overflow,
    # stream
    "collect_launch": (_P, _L, _P, _L, _I, _P, _L, _I, _I, _P, _P, _P, _P,
                       _P, _P, _P, _I, _F, _F, _F, _I, _P, _P, _P, _P, _P),
    # res, out_dim, z, offs, ns, vdirs, basis_dim, use_sh, bmin, bmax,
    # depth, R, out, stream
    "compact_composite_launch": (_P, _I, _P, _P, _P, _P, _I, _I, _I, _I,
                                 _I, _I, _P, _P),
    # the exact tree (child, n_child, data, n_nodes, D, counts, N,
    # max_levels, visited, n_visited), cen, d, invdir, delta_scale, tmin,
    # tmax, miss, basis, B, use_sh, render_depth, step_size, sigma_thresh,
    # stop_thresh, max_depth, max_sample_count, max_iters, R, out,
    # split_vote, sample_vote, steps, t_final, stream
    "exact_march_launch": (_P, _L, _P, _L, _I, _P, _I, _I, _P, _L,
                           _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                           _F, _F, _F, _I, _I, _I, _I, _P, _P, _P, _P, _P,
                           _P),
    # [restart,] registers (out), local memory bytes (out)
    "exact_march_attributes": (_I, _P, _P),
    "exact_collect_attributes": (_P, _P),
    # the exact tree, cen, d, t_final, steps, max_steps, R, stream
    "exact_visit_tail_launch": (_P, _L, _P, _L, _I, _P, _I, _I, _P, _L,
                                _P, _P, _P, _P, _P, _I, _P),
    # the exact tree, cen, d, invdir, delta_scale, tmin, tmax, miss, dirs,
    # vdirs, cen_world, scale, grid_dim, min_pos, pos_range, S, W,
    # need_viewdir, has_app, app, step_size, sigma_thresh, stop_thresh,
    # max_depth, max_sample_count, R, samples, cluster_ids, ns, split_vote,
    # sample_vote, steps, t_final, stream
    "exact_collect_launch": (_P, _L, _P, _L, _I, _P, _I, _I, _P, _L,
                             _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                             _P, _P, _P, _I, _I, _I, _I, _F, _F, _F, _F,
                             _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P),
    # res, S, out_dim, z, ns, basis, B, mode, R, out, stream
    "padded_composite_launch": (_P, _I, _I, _P, _P, _P, _I, _I, _I, _P,
                                _P),
    # table, M, W, idx, n_chunks, out, stream
    "gather_chunk_sums_launch": (_P, _L, _I, _P, _I, _P, _P),
    # a1, a1_g, lda1, k1, a2, a2_g, lda2, ids, ids_g, ids_r, n_app, k,
    # cids, n_clusters, groups, n, w, b, n_out, relu, out, out_g, ldo, col0,
    # stream
    "mlp_gemm_launch": (_P, _L, _I, _I, _P, _L, _I, _P, _L, _L, _I, _I, _P,
                        _I, _I, _I, _P, _P, _I, _I, _P, _L, _I, _I, _P),
}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME)")
    return found


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update((_CSRC / name).read_bytes())
    return _BUILD / f"libmnv_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources into the shared library unless it exists."""
    out = library_path()
    if out.exists():
        return out
    _BUILD.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{os.getpid()}"
    objs = [_BUILD / f"{Path(s).stem}.{tag}.o" for s in SOURCES]
    procs = [subprocess.Popen(
        [nvcc, *NVCC_FLAGS, "-c", str(_CSRC / s), "-o", str(o)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for s, o in zip(SOURCES, objs)]
    logs = [p.communicate()[0].decode(errors="replace") for p in procs]
    for s, p, log in zip(SOURCES, procs, logs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed on {s}:\n{log}")
    tmp = out.with_suffix(f".{tag}.tmp")
    link = subprocess.run(
        [nvcc, "-shared", *map(str, objs), "-o", str(tmp)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    if link.returncode != 0:
        raise RuntimeError("nvcc link failed:\n"
                           + link.stdout.decode(errors="replace"))
    os.replace(tmp, out)
    for o in objs:
        o.unlink()
    return out


def _library():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def _check(name, t, dtype, shape, device):
    if t.device != device or t.dtype != dtype or tuple(t.shape) != shape \
            or not t.is_contiguous():
        raise ValueError(
            f"{name}: got {tuple(t.shape)} {t.dtype} on {t.device} "
            f"(contiguous={t.is_contiguous()}); expected {shape} {dtype} "
            f"on {device}, contiguous")


def _cuda_device(t: torch.Tensor) -> torch.device:
    if t.device.type != "cuda":
        raise ValueError(f"kernel input on {t.device}; the kernels take "
                         f"CUDA tensors only")
    return t.device


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def _stream(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def skip_prepass(table, cen, d, invdir, tmin, tmax, live, step_size):
    """Launch the entry-skip prepass kernel (csrc/skip_prepass.cu).
    Returns (t_start [R] f32, skips [R] i32)."""
    dev = _cuda_device(d)
    R = d.shape[0]
    f32 = torch.float32
    for name, t, dtype, shape in (
            ("table", table, torch.int32, (80, 128)),
            ("cen", cen, f32, (3,)), ("d", d, f32, (R, 3)),
            ("invdir", invdir, f32, (R, 3)), ("tmin", tmin, f32, (R,)),
            ("tmax", tmax, f32, (R,)), ("live", live, torch.bool, (R,))):
        _check(name, t, dtype, shape, dev)
    t_out = torch.empty((R,), dtype=f32, device=dev)
    skips = torch.empty((R,), dtype=torch.int32, device=dev)
    if R == 0:
        return t_out, skips
    lib = _library()
    with torch.cuda.device(dev):
        err = lib.skip_prepass_launch(
            table.data_ptr(), cen.data_ptr(), d.data_ptr(),
            invdir.data_ptr(), tmin.data_ptr(), tmax.data_ptr(),
            live.data_ptr(), float(step_size), R, t_out.data_ptr(),
            skips.data_ptr(), _stream(dev))
    _raise_on(err, "skip_prepass")
    LAUNCHES["skip_prepass"] += 1
    return t_out, skips


def _march_tree_args(tree, leaf_map, dev) -> tuple:
    """Check the tree and leaf map for the march kernels; return their
    launch arguments (child, n_child, data, n_nodes, data_dim, rows,
    n_cells, level, deep_levels)."""
    n_cells = leaf_map.grid ** 3
    for name, t, dtype, shape in (
            ("child", tree.child, torch.int32, tuple(tree.child.shape)),
            ("data", tree.data, torch.float16, tuple(tree.data.shape)),
            ("rows", leaf_map.rows, torch.int32, (n_cells, 2))):
        _check(name, t, dtype, shape, dev)
    if tree.N != 2:
        raise ValueError("the march kernels take N == 2 trees")
    return (tree.child.data_ptr(), tree.child.numel(), tree.data.data_ptr(),
            tree.data.shape[0] * tree.N3, tree.data_dim,
            leaf_map.rows.data_ptr(), n_cells, leaf_map.level,
            leaf_map.deep_levels)


def _check_rays(dev, R, cen, d, invdir, delta_scale, tmin, tmax, miss):
    f32 = torch.float32
    for name, t, dtype, shape in (
            ("cen", cen, f32, (3,)), ("d", d, f32, (R, 3)),
            ("invdir", invdir, f32, (R, 3)),
            ("delta_scale", delta_scale, f32, (R,)),
            ("tmin", tmin, f32, (R,)), ("tmax", tmax, f32, (R,)),
            ("miss", miss, torch.bool, (R,))):
        _check(name, t, dtype, shape, dev)


def march(tree, leaf_map, cen, d, invdir, delta_scale, tmin, tmax, miss,
          basis, step_size, sigma_thresh, stop_thresh, max_dense, use_sh,
          votes=None, render_depth=False, gate=None, into=None):
    """Launch the fused march kernel (csrc/march.cu).  ``votes`` =
    (max_depth, max_sample_count) keeps the split and sample votes.
    Returns (out [R, 4] f32, overflow count [] i32, nsteps [R] i32, nrec
    [R] i32[, split_vote, sample_vote [R, 3] f32 with ``votes``]).

    ``gate`` (i32 [k] on the card) makes it the gated launch: the kernel
    marches only if a count behind the gate is not 0, and writes into
    ``into`` = (out, nsteps, nrec[, split_vote, sample_vote]), which it
    leaves untouched otherwise; the overflow count is then 0.  Counted
    under ``march_gated``."""
    dev = _cuda_device(d)
    R = d.shape[0]
    f32, i32 = torch.float32, torch.int32
    B = basis.shape[1]
    D = tree.data_dim
    tree_args = _march_tree_args(tree, leaf_map, dev)
    _check_rays(dev, R, cen, d, invdir, delta_scale, tmin, tmax, miss)
    _check("basis", basis, f32, (R, B), dev)
    if use_sh and 3 * B + 1 > D:
        raise ValueError(f"basis dim {B} does not fit data_dim {D}")
    if (gate is None) != (into is None):
        raise ValueError("a gated launch takes both gate and into")
    n_out = 3 if votes is None else 5
    if into is None:
        into = (torch.empty((R, 4), dtype=f32, device=dev),
                torch.empty((R,), dtype=i32, device=dev),
                torch.empty((R,), dtype=i32, device=dev))
        if votes is not None:
            into += (torch.empty((R, 3), dtype=f32, device=dev),
                     torch.empty((R, 3), dtype=f32, device=dev))
    else:
        if len(into) != n_out:
            raise ValueError(f"into: {len(into)} buffers, expected {n_out}")
        _check("gate", gate, i32, (gate.numel(),), dev)
        for name, t, dtype, shape in zip(
                ("out", "nsteps", "nrec", "split_vote", "sample_vote"),
                into, (f32, i32, i32, f32, f32),
                ((R, 4), (R,), (R,), (R, 3), (R, 3))):
            _check(name, t, dtype, shape, dev)
    out, nsteps, nrec = into[:3]
    sv, pv = into[3:] if votes is not None else (None, None)
    overflow = torch.zeros((), dtype=i32, device=dev)
    max_depth = max_sc = 0
    if votes is not None:
        _check("sample_counts", tree.sample_counts, torch.int16,
               tuple(tree.sample_counts.shape), dev)
        max_depth, max_sc = (int(k) for k in votes)
    res = (out, overflow, nsteps, nrec) + tuple(into[3:])
    if R == 0:
        return res
    lib = _library()
    with torch.cuda.device(dev):
        err = lib.march_launch(
            *tree_args, cen.data_ptr(), d.data_ptr(), invdir.data_ptr(),
            delta_scale.data_ptr(), tmin.data_ptr(), tmax.data_ptr(),
            miss.data_ptr(), basis.data_ptr(), B, int(use_sh),
            float(step_size), float(sigma_thresh), float(stop_thresh),
            int(max_dense), R, out.data_ptr(), nsteps.data_ptr(),
            nrec.data_ptr(), overflow.data_ptr(),
            tree.sample_counts.data_ptr(), int(votes is not None), max_depth,
            max_sc, int(bool(render_depth)),
            None if sv is None else sv.data_ptr(),
            None if pv is None else pv.data_ptr(),
            None if gate is None else gate.data_ptr(),
            0 if gate is None else gate.numel(), _stream(dev))
    _raise_on(err, "march")
    LAUNCHES["march" if gate is None else "march_gated"] += 1
    return res


def collect(tree, leaf_map, cen, d, invdir, delta_scale, tmin, tmax, miss,
            S, step_size, sigma_thresh, stop_thresh):
    """Launch the guided collect march (csrc/collect.cu).  Returns
    (t_buf [R, S] f32 with -1 past ns, ns [R] i32, steps [R] i32, overflow
    count [] i32)."""
    dev = _cuda_device(d)
    R = d.shape[0]
    i32 = torch.int32
    tree_args = _march_tree_args(tree, leaf_map, dev)
    _check_rays(dev, R, cen, d, invdir, delta_scale, tmin, tmax, miss)
    S = int(S)
    if S < 0:
        raise ValueError(f"record budget S={S} < 0")
    # the kernel writes the recorded slots only
    t_buf = torch.full((R, S), -1.0, dtype=torch.float32, device=dev)
    ns = torch.empty((R,), dtype=i32, device=dev)
    steps = torch.empty((R,), dtype=i32, device=dev)
    overflow = torch.zeros((), dtype=i32, device=dev)
    if R == 0:
        return t_buf, ns, steps, overflow
    lib = _library()
    with torch.cuda.device(dev):
        err = lib.collect_launch(
            *tree_args, cen.data_ptr(), d.data_ptr(), invdir.data_ptr(),
            delta_scale.data_ptr(), tmin.data_ptr(), tmax.data_ptr(),
            miss.data_ptr(), S, float(step_size), float(sigma_thresh),
            float(stop_thresh), R, t_buf.data_ptr(), ns.data_ptr(),
            steps.data_ptr(), overflow.data_ptr(), _stream(dev))
    _raise_on(err, "collect")
    LAUNCHES["collect"] += 1
    return t_buf, ns, steps, overflow


def compact_composite(res_c, z_c, offs, ns, vdirs_c, basis_dim, use_sh,
                      basis_min, basis_max, depth=False):
    """Launch the compact compositor (csrc/compact_composite.cu).  Ray r
    composites the samples [offs[r] - ns[r], offs[r]).  ``vdirs_c`` may be
    None when ``use_sh`` is false: the kernel then reads no view
    directions.  ``depth`` composites depth (``use_sh`` must be false).
    Returns rgba [R, 4] f32 with alpha 1."""
    dev = _cuda_device(res_c)
    M, out_dim = res_c.shape
    R = ns.shape[0]
    f32, i32 = torch.float32, torch.int32
    if use_sh and vdirs_c is None:
        raise ValueError("an SH composite needs vdirs_c")
    if use_sh and depth:
        raise ValueError("depth mode shades nothing: use_sh must be false")
    inputs = [("res_c", res_c, f32, (M, out_dim)), ("z_c", z_c, f32, (M,)),
              ("offs", offs, i32, (R,)), ("ns", ns, i32, (R,))]
    if vdirs_c is not None:
        inputs.append(("vdirs_c", vdirs_c, f32, (M, 3)))
    for name, t, dtype, shape in inputs:
        _check(name, t, dtype, shape, dev)
    if use_sh and (basis_dim not in (1, 4, 9, 16, 25)
                   or 3 * basis_dim > out_dim):
        raise ValueError(f"basis dim {basis_dim} with out_dim {out_dim}")
    if not use_sh and not depth and out_dim < 3:
        raise ValueError(f"out_dim {out_dim} < 3")
    out = torch.empty((R, 4), dtype=f32, device=dev)
    if R == 0:
        return out
    lib = _library()
    with torch.cuda.device(dev):
        err = lib.compact_composite_launch(
            res_c.data_ptr(), out_dim, z_c.data_ptr(), offs.data_ptr(),
            ns.data_ptr(), None if vdirs_c is None else vdirs_c.data_ptr(),
            int(basis_dim), int(use_sh),
            max(0, int(basis_min)), int(basis_max), int(bool(depth)), R,
            out.data_ptr(), _stream(dev))
    _raise_on(err, "compact_composite")
    LAUNCHES["compact_composite_depth" if depth else "compact_composite"] += 1
    return out


def _exact_tree_args(tree, dev, max_levels: int) -> tuple:
    """Check the tree for the exact kernels; return the leading launch
    arguments of csrc/descend_step.cuh's ExactTree (child, n_child, data,
    n_nodes, data_dim, counts, N, max_levels)."""
    for name, t, dtype in (("child", tree.child, torch.int32),
                           ("data", tree.data, torch.float16),
                           ("sample_counts", tree.sample_counts,
                            torch.int16)):
        _check(name, t, dtype, tuple(t.shape), dev)
    return (tree.child.data_ptr(), tree.child.numel(), tree.data.data_ptr(),
            tree.data.shape[0] * tree.N3, tree.data_dim,
            tree.sample_counts.data_ptr(), tree.N, int(max_levels))


def _visits(tree, dev, track_visit: bool) -> torch.Tensor:
    """The visit tracker of an exact march: zeros, the root marked when
    visits are tracked (``render.py:178-180``)."""
    visited = torch.zeros((tree.max_capacity,), dtype=torch.int32,
                          device=dev)
    if track_visit:
        visited[0] = 1
    return visited


def _visit_tail(lib, tree_args, visited, cen, d, t_final, steps, R, dev):
    """Mark, for every ray that took fewer steps than the slowest, the
    chunks above its final position (csrc/exact_march.cu)."""
    max_steps = steps.max().reshape(1)
    err = lib.exact_visit_tail_launch(
        *tree_args, visited.data_ptr(), visited.numel(), cen.data_ptr(),
        d.data_ptr(), t_final.data_ptr(), steps.data_ptr(),
        max_steps.data_ptr(), R, _stream(dev))
    _raise_on(err, "exact_visit_tail")


def exact_march(tree, m, opt, track_visit, max_levels, max_iters):
    """Launch the exact march (csrc/exact_march.cu) from the tree-space
    setup ``m`` (``accel.MarchInputs``) and, when visits are tracked, its
    visit tail.  Returns (out [R, 4] f32, split_vote, sample_vote [R, 3]
    f32, visited [max_capacity] i32, steps [R] i32)."""
    dev = _cuda_device(m.d)
    R = m.d.shape[0]
    f32, i32 = torch.float32, torch.int32
    B = m.basis.shape[1]
    _check_rays(dev, R, m.cen, m.d, m.invdir, m.delta_scale, m.tmin, m.tmax,
                m.miss)
    _check("basis", m.basis, f32, (R, B), dev)
    if m.use_sh and 3 * B + 1 > tree.data_dim:
        raise ValueError(f"basis dim {B} does not fit data_dim "
                         f"{tree.data_dim}")
    tree_args = _exact_tree_args(tree, dev, max_levels)
    visited = _visits(tree, dev, track_visit)
    out = torch.empty((R, 4), dtype=f32, device=dev)
    sv = torch.empty((R, 3), dtype=f32, device=dev)
    pv = torch.empty((R, 3), dtype=f32, device=dev)
    steps = torch.empty((R,), dtype=i32, device=dev)
    t_final = torch.empty((R,), dtype=f32, device=dev)
    if R == 0:
        return out, sv, pv, visited, steps
    lib = _library()
    with torch.cuda.device(dev):
        err = lib.exact_march_launch(
            *tree_args, visited.data_ptr() if track_visit else None,
            visited.numel(), m.cen.data_ptr(), m.d.data_ptr(),
            m.invdir.data_ptr(), m.delta_scale.data_ptr(), m.tmin.data_ptr(),
            m.tmax.data_ptr(), m.miss.data_ptr(), m.basis.data_ptr(), B,
            int(m.use_sh), int(bool(opt.render_depth)), float(m.step_size),
            float(m.sigma_thresh), float(m.stop_thresh), int(opt.max_depth),
            int(opt.max_sample_count), int(max_iters), R, out.data_ptr(),
            sv.data_ptr(), pv.data_ptr(), steps.data_ptr(),
            t_final.data_ptr(), _stream(dev))
        _raise_on(err, "exact_march")
        if track_visit:
            _visit_tail(lib, tree_args, visited, m.cen, m.d, t_final, steps,
                        R, dev)
    LAUNCHES["exact_march"] += 1
    return out, sv, pv, visited, steps


def exact_attributes() -> dict:
    """Registers and local memory bytes per thread of the exact kernels as
    built: ``{"exact_march": (regs, bytes), "exact_march root": ...,
    "exact_collect": ...}`` ("exact_march" with the restarted descent of
    N = 2^b, "exact_march root" with the descent from the root)."""
    lib = _library()
    out = {}
    for key, fn, args in (
            ("exact_march", lib.exact_march_attributes, (1,)),
            ("exact_march root", lib.exact_march_attributes, (0,)),
            ("exact_collect", lib.exact_collect_attributes, ())):
        regs, local = ctypes.c_int(0), ctypes.c_int(0)
        _raise_on(fn(*args, ctypes.byref(regs), ctypes.byref(local)),
                  f"{key} attributes")
        out[key] = (regs.value, local.value)
    return out


def exact_collect(tree, m, dirs, vdirs, cen_world, grid, opt, track_visit,
                  max_levels):
    """Launch the exact guided collect (csrc/exact_collect.cu) from the
    tree-space setup ``m`` and, when visits are tracked, the visit tail.
    ``grid`` = (grid_dim i32 [2], min_position f32 [3], pos_range f32 [3])
    on the card.  Returns (samples [R, S, 1 + dim] f32 with -1 past ns,
    cluster_ids [R, S] i32 with 0 past ns, ns [R] i32, split_vote,
    sample_vote [R, 3] f32, visited [max_capacity] i32, steps [R] i32)."""
    dev = _cuda_device(m.d)
    R = m.d.shape[0]
    f32, i32 = torch.float32, torch.int32
    S = int(opt.max_guided_samples)
    W = 1 + int(opt.sample_dim)
    need_viewdir = bool(opt.need_viewdir)
    has_app = opt.appearance_embedding != -1
    _check_rays(dev, R, m.cen, m.d, m.invdir, m.delta_scale, m.tmin, m.tmax,
                m.miss)
    grid_dim, min_pos, pos_range = grid
    inputs = [("dirs", dirs, f32, (R, 3)),
              ("cen_world", cen_world, f32, (3,)),
              ("scale", tree.scale, f32, (3,)),
              ("grid_dim", grid_dim, i32, (2,)),
              ("min_position", min_pos, f32, (3,)),
              ("pos_range", pos_range, f32, (3,))]
    if need_viewdir:
        inputs.append(("vdirs", vdirs, f32, (R, 3)))
    for name, t, dtype, shape in inputs:
        _check(name, t, dtype, shape, dev)
    tree_args = _exact_tree_args(tree, dev, max_levels)
    visited = _visits(tree, dev, track_visit)
    # the fills are one coalesced pass each; the kernel writes the records
    samples = torch.full((R, S, W), -1.0, dtype=f32, device=dev)
    cids = torch.zeros((R, S), dtype=i32, device=dev)
    ns = torch.empty((R,), dtype=i32, device=dev)
    sv = torch.empty((R, 3), dtype=f32, device=dev)
    pv = torch.empty((R, 3), dtype=f32, device=dev)
    steps = torch.empty((R,), dtype=i32, device=dev)
    t_final = torch.empty((R,), dtype=f32, device=dev)
    if R == 0:
        return samples, cids, ns, sv, pv, visited, steps
    lib = _library()
    with torch.cuda.device(dev):
        err = lib.exact_collect_launch(
            *tree_args, visited.data_ptr() if track_visit else None,
            visited.numel(), m.cen.data_ptr(), m.d.data_ptr(),
            m.invdir.data_ptr(), m.delta_scale.data_ptr(), m.tmin.data_ptr(),
            m.tmax.data_ptr(), m.miss.data_ptr(), dirs.data_ptr(),
            vdirs.data_ptr() if need_viewdir else None,
            cen_world.data_ptr(), tree.scale.data_ptr(), grid_dim.data_ptr(),
            min_pos.data_ptr(), pos_range.data_ptr(), S, W,
            int(need_viewdir), int(has_app),
            float(opt.appearance_embedding), float(m.step_size),
            float(m.sigma_thresh), float(m.stop_thresh), int(opt.max_depth),
            int(opt.max_sample_count), R, samples.data_ptr(),
            cids.data_ptr(), ns.data_ptr(), sv.data_ptr(), pv.data_ptr(),
            steps.data_ptr(), t_final.data_ptr(), _stream(dev))
        _raise_on(err, "exact_collect")
        if track_visit:
            _visit_tail(lib, tree_args, visited, m.cen, m.d, t_final, steps,
                        R, dev)
    LAUNCHES["exact_collect"] += 1
    return samples, cids, ns, sv, pv, visited, steps


def padded_composite(results, z_vals, ns, basis, mode: int):
    """Launch the padded compositor (csrc/padded_composite.cu).  ``mode``
    0 shades by SH from ``basis`` [R, B], 1 is depth mode, 2 takes the raw
    rgb; ``basis`` is None unless ``mode`` is 0.  Returns rgba [R, 4] f32
    with alpha 1."""
    dev = _cuda_device(results)
    R, S, out_dim = results.shape
    f32 = torch.float32
    inputs = [("results", results, f32, (R, S, out_dim)),
              ("z_vals", z_vals, f32, (R, S)),
              ("ns", ns, torch.int32, (R,))]
    B = 0
    if mode == 0:
        if basis is None:
            raise ValueError("an SH composite needs the basis")
        B = basis.shape[1]
        inputs.append(("basis", basis, f32, (R, B)))
        if 3 * B > out_dim:
            raise ValueError(f"basis dim {B} with out_dim {out_dim}")
    elif mode not in (1, 2):
        raise ValueError(f"mode {mode}")
    elif mode == 2 and out_dim < 3:
        raise ValueError(f"out_dim {out_dim} < 3")
    for name, t, dtype, shape in inputs:
        _check(name, t, dtype, shape, dev)
    out = torch.empty((R, 4), dtype=f32, device=dev)
    if R == 0:
        return out
    lib = _library()
    with torch.cuda.device(dev):
        err = lib.padded_composite_launch(
            results.data_ptr(), S, out_dim, z_vals.data_ptr(), ns.data_ptr(),
            None if basis is None else basis.data_ptr(), B, int(mode), R,
            out.data_ptr(), _stream(dev))
    _raise_on(err, "padded_composite")
    LAUNCHES["padded_composite"] += 1
    return out


def gather_chunk_sums(table, idx):
    """Launch the row-gather probe (csrc/gather_probe.cu): ``out[c]`` is
    the sum, wrapping mod 2^32, of ``table[idx[k], :]`` over the 2048
    indices k of chunk c.  ``table`` i32 [M, W], ``idx`` i32 [N] with N a
    multiple of 2048; an index outside [0, M) is clamped into it.  Returns
    i32 [N / 2048]."""
    dev = _cuda_device(table)
    M, W = table.shape
    N = idx.shape[0]
    _check("table", table, torch.int32, (M, W), dev)
    _check("idx", idx, torch.int32, (N,), dev)
    chunk = 2048
    if N % chunk:
        raise ValueError(f"N={N} must be a multiple of the kernel's chunk "
                         f"2048")
    if M == 0 or W == 0 or W > (1 << 18):
        # the kernel counts a chunk's 2048 * W elements in an int
        raise ValueError(f"table shape {tuple(table.shape)}: W must be in "
                         f"[1, 2^18]")
    n_chunks = N // chunk
    out = torch.empty((n_chunks,), dtype=torch.int32, device=dev)
    if n_chunks == 0:
        return out
    lib = _library()
    with torch.cuda.device(dev):
        err = lib.gather_chunk_sums_launch(
            table.data_ptr(), M, W, idx.data_ptr(), n_chunks, out.data_ptr(),
            _stream(dev))
    _raise_on(err, "gather_chunk_sums")
    LAUNCHES["gather_chunk_sums"] += 1
    return out


def check_mlp_gemm(a, w, b, cids, a2=None, table=None, ids=None,
                   out=None, col=0) -> tuple:
    """Check the arguments of :func:`mlp_gemm` (on any device, all on
    ``a``'s); return (groups, rows a group, k1, k, n_out).  ``a`` f32
    [1 or G, n, k1], ``w`` f32 [C, k, n_out], ``b`` f32 [C, n_out],
    ``cids`` i64 [G]; a second source of ``k - k1`` columns: ``a2`` f32
    [1 or G, n, k2], or the table f32 [C, A, k2] with ``ids`` f32 [1 or G,
    n] (any strides); ``out`` f32 [G, n, ldo] with ``col + n_out <= ldo``.
    All contiguous but ``ids``."""
    dev = a.device
    f32 = torch.float32
    if cids.dim() != 1 or a.dim() != 3:
        raise ValueError(f"cids {tuple(cids.shape)} must be [G], a "
                         f"{tuple(a.shape)} [1 or G, n, k1]")
    G = cids.shape[0]
    _check("cids", cids, torch.int64, (G,), dev)
    n, k1 = a.shape[1], a.shape[2]
    _check("a", a, f32, (1 if a.shape[0] == 1 else G, n, k1), dev)
    if a2 is not None and table is not None:
        raise ValueError("one second source: a2 or the table, not both")
    if (table is None) != (ids is None):
        raise ValueError("a table source takes both table and ids")
    k2 = 0
    if a2 is not None:
        k2 = a2.shape[-1]
        _check("a2", a2, f32, (1 if a2.shape[0] == 1 else G, n, k2), dev)
    if w.dim() != 3:
        raise ValueError(f"w {tuple(w.shape)} must be [C, k, n_out]")
    C, n_out = w.shape[0], w.shape[2]
    if table is not None:
        k2 = table.shape[-1]
        _check("table", table, f32, (C, table.shape[1], k2), dev)
        if table.shape[1] == 0:
            raise ValueError("an empty appearance table")
        if ids.dtype != f32 or ids.device != dev or tuple(ids.shape) not in (
                (1, n), (G, n)):
            raise ValueError(f"ids: got {tuple(ids.shape)} {ids.dtype} on "
                             f"{ids.device}; expected (1 or {G}, {n}) "
                             f"{f32} on {dev}")
    _check("w", w, f32, (C, k1 + k2, n_out), dev)
    _check("b", b, f32, (C, n_out), dev)
    if out is not None:
        ldo = out.shape[-1]
        _check("out", out, f32, (G, n, ldo), dev)
        if col < 0 or col + n_out > ldo:
            raise ValueError(f"out: columns {col}..{col + n_out} of {ldo}")
    return G, n, k1, k1 + k2, n_out


def mlp_gemm(a, w, b, cids, relu, a2=None, table=None, ids=None, out=None,
             col=0):
    """Launch the fused per-cluster product (csrc/mlp_gemm.cu): for each
    group g of rows, ``act(cat[a, second] W[c] + b[c])`` with ``c =
    cids[g]``, ``act`` ReLU or none, the second source ``a2``'s rows or
    the table's rows ``table[c, clamp(int(ids))]``; a source with a leading
    1 is shared by every group.  Writes columns ``col ..`` of ``out`` and
    returns it (a new f32 [G, n, n_out] when ``out`` is None).  See
    :func:`check_mlp_gemm`."""
    G, n, k1, k, n_out = check_mlp_gemm(a, w, b, cids, a2, table, ids, out,
                                        col)
    dev = _cuda_device(a)
    if out is None:
        out = torch.empty((G, n, n_out), dtype=torch.float32, device=dev)
    ldo = out.shape[2]
    src = a2 if a2 is not None else table
    lda2 = 0 if src is None else src.shape[-1]
    n_app = 0 if table is None else table.shape[1]
    # the kernel's row offsets are int32, its grid 128 rows a block
    if max(n, n_app) * max(k1, lda2, ldo) >= 1 << 31 \
            or -(-n // 128) > 65535 or G > 65535:
        raise ValueError(f"{G} groups of {n} rows: past the kernel's int32 "
                         f"offsets or grid")
    if G == 0 or n == 0 or n_out == 0:
        return out
    shared = (a.shape[0] == 1, a2 is not None and a2.shape[0] == 1,
              ids is not None and ids.shape[0] == 1)
    lib = _library()
    with torch.cuda.device(dev):
        err = lib.mlp_gemm_launch(
            a.data_ptr(), 0 if shared[0] else n * k1, k1, k1,
            None if src is None else src.data_ptr(),
            0 if a2 is None or shared[1] else n * lda2, lda2,
            None if ids is None else ids.data_ptr(),
            0 if ids is None or shared[2] else ids.stride(0),
            0 if ids is None else ids.stride(1),
            n_app, k, cids.data_ptr(),
            w.shape[0], G, n, w.data_ptr(), b.data_ptr(), n_out,
            int(bool(relu)), out.data_ptr(), n * ldo, ldo, int(col),
            _stream(dev))
    _raise_on(err, "mlp_gemm")
    LAUNCHES["mlp_gemm"] += 1
    return out


__all__ = ["LAUNCHES", "SOURCES", "build", "check_mlp_gemm", "collect",
           "compact_composite", "exact_attributes", "exact_collect",
           "exact_march", "gather_chunk_sums", "library_path", "march",
           "mlp_gemm", "padded_composite", "reset_launch_counts",
           "skip_prepass"]
