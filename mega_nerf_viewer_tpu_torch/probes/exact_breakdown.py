"""Where kernel E's time goes: the exact march from the root and
restarted, the descent alone, and the march with the leaf given.

Measured on ``chip_smoke.py`` phase 10's 1080p rays (the depth-8 basis-9
shell, one ray per pixel) and, for kernel F, on phase 11's (the basis-1
refinement shell at S = 32):

* ``e_root``, ``e_root_marks``: kernel E built with ``-DMNV_ROOT_DESCENT``
  (every step descends from the root and divides the exit, 256-thread
  blocks: the design before the restart), without and with visit marks;
* ``e_package``, ``e_package_marks``: kernel E as the port builds it (the
  descent restarted from the deepest ancestor the step shares with the
  ray's last path, ``csrc/descend_step.cuh``);
* ``walk_root``, ``walk_package``: the descent alone, one thread per ray
  walking E's own trajectory (E's step count per ray; the descent, the DDA
  exit and the advance, no sigma, votes or shading), from the root and
  restarted;
* ``a_votes``: kernel A from ``tmin`` with votes, the same rays and steps
  with the leaf found by one leaf-map read (the leaf-given yardstick);
* ``f_package``: kernel F with its fills (the descent from the root).

The E variants run through the port's wrapper (``kernels.exact_march``)
with the probe's library in place of the package's where they are not the
package's; the root build is checked equal (rgba, votes, visit marks,
steps) to the package kernel, and each walk's final ``t`` bit-equal to E's.
Registers come from ``ptxas -v``.

Run on the card from the root of a checkout::

    python -m mega_nerf_viewer_tpu_torch.probes.exact_breakdown

It prints one JSON line per variant: the median over rounds of the
profiler's device milliseconds per call of the variant's own kernel
(``ms``) and of every kernel of the call (``ms_all``: the visit marks'
tail and fills included), with E's bound and share where they apply, the
registers and the card's name and power limit.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import json
import re
import subprocess
import sys

import numpy as np
import torch

from .. import kernels

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
# chip_smoke.py EXACT_OPS_PER_STEP and EXACT_BYTES_PER_STEP
OPS_PER_STEP = 50
BYTES_PER_STEP = 8
# chip_smoke.py: the 1080p view, the refinement shell's capacity, S
WIDTH, HEIGHT, FOCAL = 1920, 1080, 1111.0
CENTER = (-1.4, 0.1, 1.3)
REFINE_CAPACITY = 60033 + 3 * 4096
GUIDED_S = 32
MAX_LEVELS = 20

# kernel E with the descent from the root
_ROOT_FLAGS = ("-DMNV_ROOT_DESCENT",)
_EXACT_SOURCES = ("exact_march.cu", "exact_collect.cu")
_EXACT_ENTRIES = ("exact_march_launch", "exact_visit_tail_launch")

_WALK_SOURCE = r"""
#include "descend_step.cuh"

namespace probe {
using namespace mnv;

// E's step loop with nothing but the descent, the exit and the advance:
// steps[r] steps from tmin[r], the final t to t_out.
template <bool kRestart>
__global__ void __launch_bounds__(kBlock)
descent_walk(ExactTree tr, const float* __restrict__ cen,
             const float* __restrict__ d, const float* __restrict__ invdir,
             const float* __restrict__ tmin, const int* __restrict__ steps,
             float step_size, int R, float* __restrict__ t_out) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const float cx = cen[0], cy = cen[1], cz = cen[2];
  const float dx = d[3 * r], dy = d[3 * r + 1], dz = d[3 * r + 2];
  const float ix = invdir[3 * r], iy = invdir[3 * r + 1],
              iz = invdir[3 * r + 2];
  float t = tmin[r];
  const int n = steps[r];
  DescendPath path;
  path.L = 0;
  for (int i = 0; i < n; ++i) {
    const DescendStep st = descend_step<kRestart>(
        tr, path, cx, cy, cz, dx, dy, dz, ix, iy, iz, t, step_size);
    t = t + st.delta_t;
  }
  t_out[r] = t;
}
}  // namespace probe

extern "C" int descent_walk_launch(
    int restart, const void* child, long long n_child, const void* data,
    long long n_nodes, int D, const void* counts, int N, int max_levels,
    const void* cen, const void* d, const void* invdir, const void* tmin,
    const void* steps, float step_size, int R, void* t_out, void* stream) {
  const int grid = (R + mnv::kBlock - 1) / mnv::kBlock;
  auto kernel = restart ? probe::descent_walk<true>
                        : probe::descent_walk<false>;
  kernel<<<grid, mnv::kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      mnv::exact_tree(child, n_child, data, n_nodes, D, counts, N,
                      max_levels, nullptr, 0),
      static_cast<const float*>(cen), static_cast<const float*>(d),
      static_cast<const float*>(invdir), static_cast<const float*>(tmin),
      static_cast<const int*>(steps), step_size, R,
      static_cast<float*>(t_out));
  return static_cast<int>(cudaGetLastError());
}
"""


def _hash(*parts) -> str:
    h = hashlib.sha256(" ".join(kernels.NVCC_FLAGS).encode())
    for p in parts:
        h.update(p if isinstance(p, bytes) else p.encode())
    for name in kernels.SOURCES + kernels.HEADERS:
        h.update((kernels._CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _build():
    """Build the root build of the exact kernels and the walks, and compile
    ``march.cu`` and ``exact_march.cu`` for their ``ptxas -v`` lines, all
    nvcc processes at once, then the package.  Returns ({"root" or "walk":
    CDLL}, {"root", "walk", "march" or "package": ptxas entries})."""
    out_dir = kernels._BUILD.parent / "probes"
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = _hash(_WALK_SOURCE, repr(_ROOT_FLAGS))
    walk_src = out_dir / f"exact_walk_{tag}.cu"
    walk_src.write_text(_WALK_SOURCE)
    base = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-Xptxas", "-v",
            f"-I{kernels._CSRC}"]
    jobs = {
        "root": base + list(_ROOT_FLAGS) + ["-shared"] + [
            str(kernels._CSRC / s) for s in _EXACT_SOURCES] + [
            "-o", str(out_dir / f"libexact_root_{tag}.so")],
        "walk": base + ["-shared", str(walk_src), "-o",
                        str(out_dir / f"libexact_walk_{tag}.so")],
        "march": base + ["-c", str(kernels._CSRC / "march.cu"), "-o",
                         str(out_dir / f"march_{tag}.o")],
        "package": base + ["-c", str(kernels._CSRC / "exact_march.cu"),
                           "-o", str(out_dir / f"exact_march_{tag}.o")]}
    procs = {k: subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)
             for k, cmd in jobs.items()}
    kernels.build()
    logs = {}
    for k, p in procs.items():
        logs[k] = p.communicate()[0]
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed on the probe's {k}:\n{logs[k]}")
        print(logs[k].strip(), file=sys.stderr)
    libs = {k: ctypes.CDLL(jobs[k][-1]) for k in ("root", "walk")}
    P, I, L, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
        ctypes.c_float
    fn = libs["walk"].descent_walk_launch
    fn.argtypes = (I, P, L, P, L, I, P, I, I, P, P, P, P, P, F, I, P, P)
    fn.restype = I
    for entry in _EXACT_ENTRIES:
        f = getattr(libs["root"], entry)
        f.argtypes = kernels._SIGNATURES[entry]
        f.restype = I
    return libs, {k: _ptxas_entries(log) for k, log in logs.items()}


def _ptxas_entries(log: str) -> dict:
    """{mangled kernel name: (registers, stack frame bytes, spill store
    bytes)} from ``ptxas -v`` output."""
    entries, cur, stack, spill = {}, None, 0, 0
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur, stack, spill = m.group(1), 0, 0
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores",
                      line)
        if m:
            stack, spill = int(m.group(1)), int(m.group(2))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and cur is not None:
            entries[cur] = (int(m.group(1)), stack, spill)
            cur = None
    return entries


def _regs(entries: dict, job: str, key: str):
    """The ptxas entry of build ``job`` whose mangled name holds ``key``,
    or None."""
    hits = [v for k, v in entries[job].items() if key in k]
    return hits[0] if hits else None


@contextlib.contextmanager
def _using(lib):
    """Run the port's wrappers on ``lib`` in place of the package's."""
    saved = kernels._library()
    kernels._lib = lib
    try:
        yield
    finally:
        kernels._lib = saved


def _device_ms(fn, n, match):
    """Profiler device ms per call of ``fn`` over ``n`` calls: (the kernels
    whose name holds ``match``, every kernel).  A session with no device
    time is run again, up to three times."""
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.autograd.DeviceType.CUDA
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        ev = [e for e in prof.key_averages()
              if e.device_type == cuda and e.self_device_time_total > 0]
        if ev:
            own = [e for e in ev if match in e.key]
            if not own:
                raise RuntimeError(f"no kernel named {match} ran")
            return (sum(e.self_device_time_total for e in own) / 1e3 / n,
                    sum(e.self_device_time_total for e in ev) / 1e3 / n)
    raise RuntimeError("the profiler recorded no device time")


def _scenes(dev):
    """Phase 10's tree, options and march inputs; phase 11's tree, options,
    collect inputs, rays and model grid."""
    import mega_nerf_viewer_tpu_torch as P
    from ..ops import accel, guided
    from ..ops.rays import rodrigues, screen2worlddir
    cam = P.Camera(WIDTH, HEIGHT, FOCAL)
    cam.center = np.asarray(CENTER, np.float32)
    cam._update()
    dirs, cen = screen2worlddir(WIDTH, HEIGHT, cam.fx, cam.fy, cam.cx,
                                cam.cy, torch.as_tensor(cam.transform,
                                                        device=dev))
    tree = P.shell_tree(depth=8, basis_dim=9, sigma_inside=400.0,
                        device=dev)
    opt = P.RenderOptions()
    m = accel.march_inputs(tree, dirs, rodrigues(opt.rot_dirs, dirs), cen,
                           opt)
    rtree = P.shell_tree(depth=8, basis_dim=1, sigma_inside=400.0,
                         max_capacity=REFINE_CAPACITY, device=dev)
    ropt = P.RenderOptions(use_splitting=True, split_batch_size=4096,
                           max_depth=16, samples_per_corner=8,
                           max_sample_count=256, max_guided_samples=GUIDED_S,
                           need_viewdir=True)
    grid = (torch.tensor([2, 4], dtype=torch.int32, device=dev),
            torch.full((3,), -1.5, device=dev),
            torch.full((3,), 3.0, device=dev))
    vdirs = rodrigues(ropt.rot_dirs, dirs)
    col = (rtree, guided.collect_inputs(rtree, dirs, cen, ropt), dirs, vdirs,
           cen, grid, ropt)
    return (tree, opt, m), col


def _exact_t_final(tree, m, opt):
    """Kernel E's final t per ray and its steps: the package's entry point
    launched directly (the wrapper does not return t)."""
    dev = m.d.device
    R = m.d.shape[0]
    f32 = torch.float32
    out = torch.empty((R, 4), dtype=f32, device=dev)
    sv = torch.empty((R, 3), dtype=f32, device=dev)
    pv = torch.empty((R, 3), dtype=f32, device=dev)
    steps = torch.empty((R,), dtype=torch.int32, device=dev)
    t_final = torch.empty((R,), dtype=f32, device=dev)
    err = kernels._library().exact_march_launch(
        *kernels._exact_tree_args(tree, dev, MAX_LEVELS), None,
        tree.max_capacity, m.cen.data_ptr(), m.d.data_ptr(),
        m.invdir.data_ptr(), m.delta_scale.data_ptr(), m.tmin.data_ptr(),
        m.tmax.data_ptr(), m.miss.data_ptr(), m.basis.data_ptr(),
        m.basis.shape[1], int(m.use_sh), int(bool(opt.render_depth)),
        float(m.step_size), float(m.sigma_thresh), float(m.stop_thresh),
        int(opt.max_depth), int(opt.max_sample_count), 0, R, out.data_ptr(),
        sv.data_ptr(), pv.data_ptr(), steps.data_ptr(), t_final.data_ptr(),
        kernels._stream(dev))
    kernels._raise_on(err, "exact_march")
    return t_final, steps


def main(argv=None) -> int:
    from ..device import resolve_device
    from ..ops.accel import build_leaf_map
    argv = sys.argv[1:] if argv is None else argv
    rounds = int(argv[0]) if argv else 5
    dev = resolve_device(None)
    libs, entries = _build()
    (tree, opt, m), col = _scenes(dev)
    dev = m.d.device   # with its index, as the kernels' checks want it
    R = m.d.shape[0]
    votes = (opt.max_depth, opt.max_sample_count)
    lm = build_leaf_map(tree)

    def e_call(track):
        return lambda: kernels.exact_march(tree, m, opt, track, MAX_LEVELS,
                                           0)

    def f_call():
        return kernels.exact_collect(*col, False, MAX_LEVELS)

    # A from tmin with votes, at a budget that holds every dense sample
    md = 8
    while True:
        a_args = (tree, lm, m.cen, m.d, m.invdir, m.delta_scale, m.tmin,
                  m.tmax, m.miss, m.basis, m.step_size, m.sigma_thresh,
                  m.stop_thresh, md, m.use_sh)
        ka = kernels.march(*a_args, votes=votes)
        if not int(ka[1]):
            break
        md *= 2

    # the root build equal to the package kernel
    want = {t: e_call(t)() for t in (False, True)}
    with _using(libs["root"]):
        for t in (False, True):
            for a, b in zip(e_call(t)(), want[t]):
                if not torch.equal(a, b):
                    raise AssertionError("kernel E from the root differs "
                                         "from the package kernel")
    t_final, steps = _exact_t_final(tree, m, opt)
    if not torch.equal(steps, want[False][4]):
        raise AssertionError("kernel E's steps differ between launches")
    if not torch.equal(ka[2], steps):
        raise AssertionError("kernel A's steps differ from E's")
    t_walk = torch.empty_like(t_final)
    walk_ptrs = (*kernels._exact_tree_args(tree, dev, MAX_LEVELS),
                 m.cen.data_ptr(), m.d.data_ptr(), m.invdir.data_ptr(),
                 m.tmin.data_ptr(), steps.data_ptr(), float(m.step_size), R,
                 t_walk.data_ptr())

    def walk(restart):
        def call():
            err = libs["walk"].descent_walk_launch(
                int(restart), *walk_ptrs, kernels._stream(dev))
            kernels._raise_on(err, "descent_walk")
        return call

    for restart in (False, True):
        t_walk.fill_(-1.0)
        walk(restart)()
        if not torch.equal(t_walk.view(torch.int32),
                           t_final.view(torch.int32)):
            raise AssertionError(f"the walk (restart {restart}) leaves E's "
                                 f"trajectory")

    pkg = kernels._library()
    # name: (library, call, kernel name, (build, mangled name) of its
    # ptxas entry); the root build's exact collect is the package's code
    e_root = ("root", "exact_march_kernelILb0E")
    e_pkg = ("package", "exact_march_kernelILb1E")
    variants = {
        "e_root": (libs["root"], e_call(False), "exact_march_kernel",
                   e_root),
        "e_root_marks": (libs["root"], e_call(True), "exact_march_kernel",
                         e_root),
        "e_package": (pkg, e_call(False), "exact_march_kernel", e_pkg),
        "e_package_marks": (pkg, e_call(True), "exact_march_kernel", e_pkg),
        "walk_root": (pkg, walk(False), "descent_walk",
                      ("walk", "descent_walkILb0E")),
        "walk_package": (pkg, walk(True), "descent_walk",
                         ("walk", "descent_walkILb1E")),
        "a_votes": (pkg, lambda: kernels.march(*a_args, votes=votes),
                    "mnv::march_kernel", ("march", "3mnv12march_kernel")),
        "f_package": (pkg, f_call, "exact_collect_kernel",
                      ("root", "exact_collect_kernel")),
    }
    times = {k: [] for k in variants}
    for _ in range(rounds):
        for name, (lib, call, match, _) in variants.items():
            with _using(lib):
                times[name].append(_device_ms(call, 10, match))

    steps_total = int(steps.sum())
    shaded = int(ka[3].sum())
    B = m.basis.shape[1]
    n_bytes = (sum(t.numel() * t.element_size() for t in (
        m.d, m.invdir, m.delta_scale, m.tmin, m.tmax, m.miss, m.basis,
        *want[False][:3], steps)) + BYTES_PER_STEP * steps_total
        + 2 * tree.data_dim * shaded)
    n_ops = OPS_PER_STEP * steps_total + (6 * B + 15) * shaded
    bound = max(n_bytes / PEAK_BYTES_PER_S, n_ops / PEAK_F32_OPS_PER_S) * 1e3
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    for name, ts in times.items():
        own = sorted(t[0] for t in ts)[rounds // 2]
        every = sorted(t[1] for t in ts)[rounds // 2]
        regs = _regs(entries, *variants[name][3])
        line = {"metric": "exact_variant_ms", "variant": name, "ms": own,
                "ms_all": every, "rounds": [t[0] for t in ts],
                "regs": None if regs is None else regs[0],
                "stack_bytes": None if regs is None else regs[1],
                "spill_bytes": None if regs is None else regs[2],
                "rays": R, "steps": steps_total, "shaded": shaded,
                "card": card}
        if name.startswith("e_"):
            line.update(bound_ms=bound, share=bound / own)
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
