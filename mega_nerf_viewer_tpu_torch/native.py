"""ctypes bindings for the native data-path runtime (counterpart of
``mega_nerf_viewer_tpu/native.py``).

``native/nerfview_native.cpp`` is compiled with ``g++`` at first use into
``build/native/`` of the checkout, keyed by a hash of the source, the
flags, the compiler's version and the machine, and loaded with ``ctypes``;
the library committed beside the source is never loaded (it was built for
another host's CPU).  ``NERFVIEW_NATIVE_LIB`` names a library that wins
over the build.  It exposes:
  * :func:`load_npz` — mmap'd, multi-threaded npz reading (the
    reference's cnpy equivalent, re-designed; see
    native/nerfview_native.cpp).
  * :func:`vq_decode` — parallel vector-quantized color decode
    (reference ``n3tree.cpp:109-175`` semantics, both bug-compat and
    corrected index layouts).
  * :func:`argsort_counts` — a stable counting-sort argsort.

This is host I/O, not the card.  :func:`available` is False when the
library cannot be built or loaded (:func:`build_error` says why), and
callers fall back to the numpy implementations.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional

import numpy as np

_ROOT = Path(__file__).resolve().parent.parent
SOURCE = _ROOT / "native" / "nerfview_native.cpp"
_BUILD = _ROOT / "build" / "native"
# native/Makefile's flags without -march=native: a build under build/ may
# be carried to another machine, whose CPU may lack the build host's
# instructions
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-shared")
LINK_FLAGS = ("-lz", "-lpthread")

_LIB = None
_TRIED = False
_ERROR = ""
_lock = threading.Lock()

_DESCR_TO_DTYPE = {
    "<f2": np.float16, "<f4": np.float32, "<f8": np.float64,
    "<i1": np.int8, "<i2": np.int16, "<i4": np.int32, "<i8": np.int64,
    "<u1": np.uint8, "<u2": np.uint16, "<u4": np.uint32, "<u8": np.uint64,
    "|u1": np.uint8, "|i1": np.int8, "|b1": np.bool_,
}


def _cxx() -> str:
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if not cxx:
        raise RuntimeError("no C++ compiler (g++) found")
    return cxx


def library_path() -> Path:
    """Where the build of the current source, flags and compiler goes."""
    cxx = _cxx()
    version = subprocess.run([cxx, "--version"], capture_output=True,
                             text=True, timeout=60).stdout
    h = hashlib.sha256(" ".join((cxx,) + CXX_FLAGS + LINK_FLAGS).encode())
    h.update(version.encode())
    h.update(platform.machine().encode())
    h.update(SOURCE.read_bytes())
    return _BUILD / f"libnerfview_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the source into the shared library unless it exists."""
    out = library_path()
    if out.exists():
        return out
    _BUILD.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    r = subprocess.run([_cxx(), *CXX_FLAGS, "-o", str(tmp), str(SOURCE),
                        *LINK_FLAGS], capture_output=True, text=True,
                       timeout=600)
    if r.returncode != 0:
        raise RuntimeError(f"g++ failed on {SOURCE.name}:\n{r.stdout}"
                           f"{r.stderr}")
    os.replace(tmp, out)
    return out


def _bind(lib):
    lib.nv_open.restype = ctypes.c_void_p
    lib.nv_open.argtypes = [ctypes.c_char_p]
    lib.nv_error.restype = ctypes.c_char_p
    lib.nv_error.argtypes = [ctypes.c_void_p]
    lib.nv_num_entries.restype = ctypes.c_int
    lib.nv_num_entries.argtypes = [ctypes.c_void_p]
    lib.nv_entry_name.restype = ctypes.c_char_p
    lib.nv_entry_name.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.nv_entry_info.restype = ctypes.c_int
    lib.nv_entry_info.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int64)]
    lib.nv_read_many_cap.restype = ctypes.c_int
    lib.nv_read_many_cap.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int]
    lib.nv_close.argtypes = [ctypes.c_void_p]
    lib.nv_argsort_counts.restype = ctypes.c_int
    lib.nv_argsort_counts.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
        ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32)]
    lib.nv_vq_decode.argtypes = [
        ctypes.POINTER(ctypes.c_uint16),
        ctypes.POINTER(ctypes.c_uint16),
        ctypes.POINTER(ctypes.c_uint16),
        ctypes.POINTER(ctypes.c_uint16),
        ctypes.POINTER(ctypes.c_uint16),
        ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int]
    return lib


def _lib():
    """The loaded library: ``NERFVIEW_NATIVE_LIB`` if it names one that
    loads (an override must win over the build), else the build."""
    global _LIB, _TRIED, _ERROR
    with _lock:
        if _TRIED:
            return _LIB
        _TRIED = True
        override = os.environ.get("NERFVIEW_NATIVE_LIB", "")
        errors = []
        if override and os.path.exists(override):
            try:
                _LIB = _bind(ctypes.CDLL(override))
                return _LIB
            except OSError as e:
                errors.append(f"{override}: {e}")
        try:
            _LIB = _bind(ctypes.CDLL(str(build())))
        except (OSError, RuntimeError, subprocess.SubprocessError) as e:
            errors.append(str(e))
        _ERROR = "; ".join(errors) if _LIB is None else ""
        return _LIB


def build_error() -> str:
    """Why the library is not available ("" when it is, or untried)."""
    return _ERROR


def available() -> bool:
    return _lib() is not None


def load_npz(path: str) -> Dict[str, np.ndarray]:
    """Read every array of an npz with the native loader (parallel
    inflate across entries).  Raises RuntimeError on parse errors."""
    lib = _lib()
    if lib is None:
        raise RuntimeError(f"native library not available: {_ERROR}")
    h = lib.nv_open(path.encode())
    try:
        err = lib.nv_error(h).decode()
        if err:
            raise RuntimeError(f"nv_open: {err}")
        n = lib.nv_num_entries(h)
        arrays, ptrs, idxs = [], [], []
        for i in range(n):
            name = lib.nv_entry_name(h, i).decode()
            descr = ctypes.create_string_buffer(16)
            shape = (ctypes.c_int64 * 32)()
            ndim = lib.nv_entry_info(h, i, descr, shape)
            if ndim < 0:
                raise RuntimeError(
                    f"entry {name}: {lib.nv_error(h).decode()}")
            d = descr.value.decode()
            shp = tuple(shape[k] for k in range(ndim))
            if name.endswith(".npy"):
                name = name[:-4]
            if d.startswith("<U") or d.startswith(">U"):
                # unicode strings (data_format): read raw UTF-32 bytes
                count = int(d[2:]) if len(d) > 2 else 0
                nbytes = int(np.prod(shp or (1,))) * count * 4
                buf = np.empty(nbytes, np.uint8)
                arrays.append(("U", name, buf, shp, count))
            else:
                dt = _DESCR_TO_DTYPE.get(d)
                if dt is None:
                    raise RuntimeError(f"unsupported descr {d} in {name}")
                buf = np.empty(shp, dt)
                arrays.append(("A", name, buf, shp, 0))
            ptrs.append(buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
            idxs.append(i)
        idx_arr = (ctypes.c_int * n)(*idxs)
        ptr_arr = (ctypes.POINTER(ctypes.c_uint8) * n)(*ptrs)
        # pass each destination's capacity so a corrupt archive whose zip
        # size exceeds the npy descr*shape geometry fails instead of
        # overflowing the heap
        cap_arr = (ctypes.c_int64 * n)(
            *(buf.nbytes for _, _, buf, _, _ in arrays))
        rc = lib.nv_read_many_cap(h, idx_arr, ptr_arr, cap_arr, n)
        if rc:
            raise RuntimeError(f"read failed: {lib.nv_error(h).decode()}")
        out = {}
        for kind, name, buf, shp, count in arrays:
            if kind == "U":
                # decode UTF-32LE like the reference's every-4th-byte strip
                s = buf.tobytes().decode("utf-32-le").rstrip("\x00")
                out[name] = np.str_(s)
            else:
                out[name] = buf
        return out
    finally:
        lib.nv_close(h)


def vq_decode(quant_map: np.ndarray, quant_colors: np.ndarray,
              retained: Optional[np.ndarray], sigma: np.ndarray,
              data_dim: int, bug_compat: bool = True) -> np.ndarray:
    """Parallel native VQ decode -> f16 [capacity, N3, data_dim]."""
    lib = _lib()
    if lib is None:
        raise RuntimeError(f"native library not available: {_ERROR}")
    n_basis_q, capacity, n3 = quant_map.shape
    n_retain = retained.shape[0] if retained is not None else 0
    # the C loop indexes rows at c*n_basis(+basis) and the codebook at
    # a fixed 65536 stride — validate both BEFORE handing it raw
    # pointers (the numpy fallback raises IndexError for the same
    # inconsistent archives; the native path must not heap-overflow)
    n_basis = n_basis_q + n_retain
    if data_dim < 3 * n_basis + 1:
        raise ValueError(
            f"VQ arrays imply n_basis={n_basis} but data_dim={data_dim} "
            f"< {3 * n_basis + 1}")
    if quant_colors.shape[1:] != (65536, 3):
        raise ValueError(
            f"quant_colors must be [n_basis, 65536, 3] "
            f"(got {quant_colors.shape})")
    data = np.zeros((capacity, n3, data_dim), np.float16)

    def u16(a):
        a = np.ascontiguousarray(a)
        return a.view(np.uint16).ctypes.data_as(
            ctypes.POINTER(ctypes.c_uint16))

    qm = np.ascontiguousarray(quant_map.astype(np.uint16))
    qc = np.ascontiguousarray(quant_colors)
    sg = np.ascontiguousarray(sigma.astype(np.float16))
    rt = np.ascontiguousarray(retained) if retained is not None else None
    lib.nv_vq_decode(
        data.view(np.uint16).ctypes.data_as(
            ctypes.POINTER(ctypes.c_uint16)),
        qm.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        qc.view(np.uint16).ctypes.data_as(
            ctypes.POINTER(ctypes.c_uint16)),
        rt.view(np.uint16).ctypes.data_as(
            ctypes.POINTER(ctypes.c_uint16)) if rt is not None else None,
        sg.view(np.uint16).ctypes.data_as(
            ctypes.POINTER(ctypes.c_uint16)),
        capacity, n3, data_dim, n_basis_q, n_retain, int(bug_compat))
    return data


def argsort_counts(keys: np.ndarray, max_key: int = 1 << 20):
    """Stable counting-sort argsort of small non-negative int keys.
    Returns (perm, inv) int32 arrays; raises RuntimeError when the
    native library is unavailable or keys are out of range."""
    lib = _lib()
    if lib is None:
        raise RuntimeError(f"native library not available: {_ERROR}")
    keys = np.ascontiguousarray(keys, np.int32)
    n = keys.shape[0]
    perm = np.empty(n, np.int32)
    inv = np.empty(n, np.int32)
    rc = lib.nv_argsort_counts(
        keys.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), n,
        np.int32(max_key),
        perm.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        inv.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    if rc != 0:
        raise RuntimeError("keys out of range for counting sort")
    return perm, inv
