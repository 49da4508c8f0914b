"""Build, bind and launch the port's CUDA kernels; count their launches.

The sources under ``csrc/`` have a plain C interface.  At first use they
are compiled with ``nvcc`` for ``sm_90a`` (one process per source, run in
parallel, then one link) into ``build/kernels/`` of the checkout, keyed by
a hash of the sources and flags, and loaded with ``ctypes``.  Every kernel
is built with ``-fmad=false``: the JAX reference rounds each f32 op
separately except where the kernels call ``__fmaf_rn`` explicitly, and
the prepass's ``t`` must be bit-equal to the march's and the collect
march's.  The four kernels: ``skip_prepass`` (B), ``march`` (A),
``collect`` (C, the guided collect march) and ``compact_composite`` (D,
the guided compositor).

Each launch function checks its tensors, allocates the outputs, launches
on PyTorch's current stream, raises on a non-zero ``cudaGetLastError()``
and adds one to its entry of :data:`LAUNCHES`.  There is no fallback: a
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
           "compact_composite.cu")
HEADERS = ("common.cuh", "march_step.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xcompiler", "-fPIC")

# launches per kernel since the last reset_launch_counts()
LAUNCHES = {"skip_prepass": 0, "march": 0, "collect": 0,
            "compact_composite": 0}

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
    # R, out, nsteps, nrec, overflow, stream
    "march_launch": (_P, _L, _P, _L, _I, _P, _L, _I, _I, _P, _P, _P, _P,
                     _P, _P, _P, _P, _I, _I, _F, _F, _F, _I, _I, _P, _P,
                     _P, _P, _P),
    # child, n_child, data, n_nodes, data_dim, rows, n_cells, level,
    # deep_levels, cen, d, invdir, delta_scale, tmin, tmax, miss, S,
    # step_size, sigma_thresh, stop_thresh, R, t_buf, ns, steps, overflow,
    # stream
    "collect_launch": (_P, _L, _P, _L, _I, _P, _L, _I, _I, _P, _P, _P, _P,
                       _P, _P, _P, _I, _F, _F, _F, _I, _P, _P, _P, _P, _P),
    # res, out_dim, z, offs, ns, vdirs, basis_dim, use_sh, bmin, bmax, R,
    # out, stream
    "compact_composite_launch": (_P, _I, _P, _P, _P, _P, _I, _I, _I, _I,
                                 _I, _P, _P),
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
          basis, step_size, sigma_thresh, stop_thresh, max_dense, use_sh):
    """Launch the fused march kernel (csrc/march.cu).  Returns
    (out [R, 4] f32, overflow count [] i32, nsteps [R] i32, nrec [R] i32)."""
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
    out = torch.empty((R, 4), dtype=f32, device=dev)
    nsteps = torch.empty((R,), dtype=i32, device=dev)
    nrec = torch.empty((R,), dtype=i32, device=dev)
    overflow = torch.zeros((), dtype=i32, device=dev)
    if R == 0:
        return out, overflow, nsteps, nrec
    lib = _library()
    with torch.cuda.device(dev):
        err = lib.march_launch(
            *tree_args, cen.data_ptr(), d.data_ptr(), invdir.data_ptr(),
            delta_scale.data_ptr(), tmin.data_ptr(), tmax.data_ptr(),
            miss.data_ptr(), basis.data_ptr(), B, int(use_sh),
            float(step_size), float(sigma_thresh), float(stop_thresh),
            int(max_dense), R, out.data_ptr(), nsteps.data_ptr(),
            nrec.data_ptr(), overflow.data_ptr(), _stream(dev))
    _raise_on(err, "march")
    LAUNCHES["march"] += 1
    return out, overflow, nsteps, nrec


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
                      basis_min, basis_max):
    """Launch the compact compositor (csrc/compact_composite.cu).  Ray r
    composites the samples [offs[r] - ns[r], offs[r]).  ``vdirs_c`` may be
    None when ``use_sh`` is false: the kernel then reads no view
    directions.  Returns rgba [R, 4] f32 with alpha 1."""
    dev = _cuda_device(res_c)
    M, out_dim = res_c.shape
    R = ns.shape[0]
    f32, i32 = torch.float32, torch.int32
    if use_sh and vdirs_c is None:
        raise ValueError("an SH composite needs vdirs_c")
    inputs = [("res_c", res_c, f32, (M, out_dim)), ("z_c", z_c, f32, (M,)),
              ("offs", offs, i32, (R,)), ("ns", ns, i32, (R,))]
    if vdirs_c is not None:
        inputs.append(("vdirs_c", vdirs_c, f32, (M, 3)))
    for name, t, dtype, shape in inputs:
        _check(name, t, dtype, shape, dev)
    if use_sh and (basis_dim not in (1, 4, 9, 16, 25)
                   or 3 * basis_dim > out_dim):
        raise ValueError(f"basis dim {basis_dim} with out_dim {out_dim}")
    if not use_sh and out_dim < 3:
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
            max(0, int(basis_min)), int(basis_max), R, out.data_ptr(),
            _stream(dev))
    _raise_on(err, "compact_composite")
    LAUNCHES["compact_composite"] += 1
    return out


__all__ = ["LAUNCHES", "SOURCES", "build", "collect", "compact_composite",
           "library_path", "march", "reset_launch_counts", "skip_prepass"]
