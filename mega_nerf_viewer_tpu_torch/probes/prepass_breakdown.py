"""Where kernel B's time goes: the entry-skip prepass in four designs.

The variants below are measurement copies, built into their own library
under ``build/probes/`` apart from the port's kernels; the package runs
only ``csrc/skip_prepass.cu``.  Each takes the same inputs as
``kernels.skip_prepass`` and runs the same step math (``csrc/common.cuh``):

* ``block_copy``: the first design (one thread per ray, 256-thread
  blocks, each block copying the whole 40 KB table into shared memory
  before its rays);
* ``copy_only``: the same blocks, returning right after the copy;
* ``persistent``: as many 512-thread blocks as are resident at once, each
  copying the table once and walking rays with a grid stride;

and ``package``, the kernel the port launches (``kernels.skip_prepass``:
the first design's blocks with no copy, the table read in place through
the read-only cache), launched here through its C entry point as the
variants are, without the wrapper's checks.

Run on the card from the root of a checkout::

    python -m mega_nerf_viewer_tpu_torch.probes.prepass_breakdown

It builds the 1080p rays of ``chip_smoke.py`` phase 2 (the depth-8 shell,
its skip table, the hint frame's block order), checks that every variant
but ``copy_only`` gives ``t`` bit-equal and skips equal to the plain
version, and prints one JSON line per variant: the median over rounds of
the mean device milliseconds per launch (CUDA events over back-to-back
launches; the variants take turns within each round), the byte bound and
the share of it.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import subprocess
import sys

import torch

from .. import kernels

VARIANTS = ("block_copy", "copy_only", "persistent")
# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
# f32 operations of one prepass step (chip_smoke.py PREPASS_OPS_PER_STEP)
OPS_PER_STEP = 48

_SOURCE = r"""
#include "common.cuh"

namespace probe {
using namespace mnv;
constexpr int kWords = 80 * 128, kB5 = 8 * 128, kB6 = 16 * 128;

__device__ __forceinline__ void walk(const int* tab, float cx, float cy,
    float cz, const float* __restrict__ d, const float* __restrict__ inv,
    const float* __restrict__ tmin, const float* __restrict__ tmax,
    const bool* __restrict__ live, float step, int r,
    float* __restrict__ t_out, int* __restrict__ s_out) {
  const float dx = d[3 * r], dy = d[3 * r + 1], dz = d[3 * r + 2];
  const float ix = inv[3 * r], iy = inv[3 * r + 1], iz = inv[3 * r + 2];
  const float tm = tmax[r];
  float t = tmin[r];
  int cnt = 0;
  bool active = live[r] && t < tm;
  while (active) {
    const float px = clip_pos(cx, t, dx), py = clip_pos(cy, t, dy),
                pz = clip_pos(cz, t, dz);
    const int i4 = cell_index(px, py, pz, 16);
    const int nib = (tab[i4 >> 3] >> ((i4 & 7) * 4)) & 15;
    const bool s4 = (nib & 8) != 0;
    const int i5 = cell_index(px, py, pz, 32);
    const bool b5 = ((tab[kB5 + (i5 >> 5)] >> (i5 & 31)) & 1) != 0;
    bool b6 = false;
    if (!s4 && !b5) {
      const int i6 = cell_index(px, py, pz, 64);
      b6 = ((tab[kB6 + (i6 >> 5)] >> (i6 & 31)) & 1) != 0;
    }
    if (!(s4 || b5 || b6)) break;
    const int depth = s4 ? (nib & 7) : (b5 ? 5 : 6);
    t = t + (leaf_exit(px, py, pz, pow2f(depth), ix, iy, iz) + step);
    ++cnt;
    active = t < tm;
  }
  t_out[r] = t;
  s_out[r] = cnt;
}

#define ARGS const int* __restrict__ table, const float* __restrict__ cen, \
    const float* __restrict__ d, const float* __restrict__ inv, \
    const float* __restrict__ tmin, const float* __restrict__ tmax, \
    const bool* __restrict__ live, float step, int R, \
    float* __restrict__ t_out, int* __restrict__ s_out

__global__ void __launch_bounds__(256) block_copy(ARGS) {
  __shared__ int tab[kWords];
  for (int i = threadIdx.x; i < kWords; i += blockDim.x) tab[i] = table[i];
  __syncthreads();
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r < R) walk(tab, cen[0], cen[1], cen[2], d, inv, tmin, tmax,
                  live, step, r, t_out, s_out);
}

__global__ void __launch_bounds__(256) copy_only(ARGS) {
  __shared__ int tab[kWords];
  for (int i = threadIdx.x; i < kWords; i += blockDim.x) tab[i] = table[i];
  __syncthreads();
  if (R < 0) t_out[threadIdx.x] = (float)tab[threadIdx.x];  // keeps the copy
}

__global__ void __launch_bounds__(512) persistent(ARGS) {
  __shared__ int tab[kWords];
  for (int i = threadIdx.x; i < kWords; i += blockDim.x) tab[i] = table[i];
  __syncthreads();
  for (int r = blockIdx.x * blockDim.x + threadIdx.x; r < R;
       r += gridDim.x * blockDim.x)
    walk(tab, cen[0], cen[1], cen[2], d, inv, tmin, tmax, live, step,
         r, t_out, s_out);
}

template <typename K>
int run(K kernel, int threads, bool persist, const void* table,
        const void* cen, const void* d, const void* inv, const void* tmin,
        const void* tmax, const void* live, float step, int R, void* t_out,
        void* s_out) {
  int grid = (R + threads - 1) / threads;
  if (persist) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                  0);
    grid = grid < sms * per_sm ? grid : sms * per_sm;
  }
  kernel<<<grid, threads>>>((const int*)table, (const float*)cen,
      (const float*)d, (const float*)inv, (const float*)tmin,
      (const float*)tmax, (const bool*)live, step, R, (float*)t_out,
      (int*)s_out);
  return (int)cudaGetLastError();
}
}  // namespace probe

#define LAUNCH(name, threads, persist)                                     \
  extern "C" int name##_launch(const void* table, const void* cen,         \
      const void* d, const void* inv, const void* tmin, const void* tmax,  \
      const void* live, float step, int R, void* t_out, void* s_out) {     \
    return probe::run(probe::name, threads, persist, table, cen, d, inv,   \
                      tmin, tmax, live, step, R, t_out, s_out);            \
  }
LAUNCH(block_copy, 256, false)
LAUNCH(copy_only, 256, false)
LAUNCH(persistent, 512, true)
"""


def _library():
    """Build the variants (cached by a hash of the source, the shared
    header and the port's nvcc flags) and bind them."""
    h = hashlib.sha256(_SOURCE.encode())
    h.update(" ".join(kernels.NVCC_FLAGS).encode())
    h.update((kernels._CSRC / "common.cuh").read_bytes())
    out_dir = kernels._BUILD.parent / "probes"
    out = out_dir / f"libprepass_variants_{h.hexdigest()[:16]}.so"
    if not out.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        src = out.with_suffix(".cu")
        src.write_text(_SOURCE)
        r = subprocess.run(
            [kernels._nvcc(), *kernels.NVCC_FLAGS, "-Xptxas", "-v",
             f"-I{kernels._CSRC}", "-shared", str(src), "-o", str(out)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"nvcc failed on the prepass variants:\n"
                               f"{r.stdout}")
        print(r.stdout.strip(), file=sys.stderr)
    lib = ctypes.CDLL(str(out))
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for v in VARIANTS:
        fn = getattr(lib, f"{v}_launch")
        fn.argtypes = (P, P, P, P, P, P, P, F, I, P, P)
        fn.restype = I
    return lib


def phase2_rays(dev):
    """The rays of ``chip_smoke.py`` phase 2: the 1080p hint frame of the
    depth-8 shell in block order, padded to whole chunks.  Returns
    (table, march inputs, live)."""
    import numpy as np
    import mega_nerf_viewer_tpu_torch as P
    from ..ops import accel
    from ..ops.rays import screen2worlddir_indices
    tree = P.shell_tree(depth=8, basis_dim=9, sigma_inside=400.0,
                        device=dev)
    opt = P.RenderOptions()
    table = P.build_skip_table(tree, opt.sigma_thresh)
    tune = P.device_tuning(dev)
    cam = P.Camera(1920, 1080, 1111.0)
    cam.center = np.asarray((-1.4, 0.1, 1.3), np.float32)
    cam._update()
    perm, _ = accel.block_permutation(1920, 1080, tune.block, device=dev)
    R = 1920 * 1080
    n_pad = -(-R // tune.chunk_size) * tune.chunk_size
    pix = torch.cat([perm, perm[-1:].expand(n_pad - R)])
    dirs, cen = screen2worlddir_indices(
        pix, 1920, cam.fx, cam.fy, cam.cx, cam.cy,
        torch.as_tensor(cam.transform, device=dev))
    m = accel.march_inputs(tree, dirs, dirs, cen, opt)
    return table, m, ~m.miss


def main(argv=None) -> int:
    from ..device import resolve_device
    from ..ops import skip_prepass as sp
    argv = sys.argv[1:] if argv is None else argv
    rounds = int(argv[0]) if argv else 5
    dev = resolve_device(None)
    table, m, live = phase2_rays(dev)
    R = m.d.shape[0]
    args = (table, m.cen, m.d, m.invdir, m.tmin, m.tmax, live)
    t_p, s_p = sp.entry_skip_prepass_reference(*args, m.step_size)
    lib = _library()
    t_out = torch.empty((R,), dtype=torch.float32, device=dev)
    s_out = torch.empty((R,), dtype=torch.int32, device=dev)
    ptrs = [a.data_ptr() for a in args]

    def variant(name):
        fn = getattr(lib, f"{name}_launch")

        def call():
            err = fn(*ptrs, float(m.step_size), R, t_out.data_ptr(),
                     s_out.data_ptr())
            if err:
                raise RuntimeError(f"{name}: CUDA error {err}")
        return call

    klib = kernels._library()

    def package():
        err = klib.skip_prepass_launch(
            *ptrs, float(m.step_size), R, t_out.data_ptr(),
            s_out.data_ptr(), kernels._stream(dev))
        if err:
            raise RuntimeError(f"package: CUDA error {err}")

    calls = {v: variant(v) for v in VARIANTS}
    calls["package"] = package
    for name, call in calls.items():
        if name == "copy_only":
            continue
        t_out.fill_(-1.0)
        s_out.fill_(-1)
        call()
        tk, sk = t_out, s_out
        torch.cuda.synchronize()
        if not (torch.equal(tk.view(torch.int32), t_p.view(torch.int32))
                and torch.equal(sk, s_p)):
            raise AssertionError(f"prepass variant {name} differs from the "
                                 f"plain version")
    skips = int(s_p.sum())
    n_bytes = sum(a.numel() * a.element_size() for a in args) + 8 * R
    bound = max(n_bytes / PEAK_BYTES_PER_S,
                OPS_PER_STEP * skips / PEAK_F32_OPS_PER_S) * 1e3

    def mean_ms(fn, n=50):
        fn()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / n

    times = {k: [] for k in calls}
    for _ in range(rounds):
        for name, call in calls.items():
            times[name].append(mean_ms(call))
    name_smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    for name, ts in times.items():
        ms = sorted(ts)[rounds // 2]
        print(json.dumps({
            "metric": "prepass_variant_ms", "variant": name, "ms": ms,
            "rounds": ts, "bound_ms": bound, "share": bound / ms,
            "rays": R, "skips": skips, "card": name_smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
