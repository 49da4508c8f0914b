// Exact march: one thread per ray, the octree descent at every step,
// restarted from the deepest ancestor shared with the ray's previous path.
//
// Replaces: mega_nerf_viewer_tpu/ops/render.py, render_rays — the XLA
// while_loop of the exact renderer (render.py:119-280), not a Pallas
// kernel; the shape of the reference's render_voxels_kernel
// (rt_core.cuh:162-332).  In eager PyTorch that loop launches some 60
// tensor ops per step plus ~10 per descent level, for every step of the
// slowest ray.
//
// Per step (render.py:199-258): the descent (descend_step.cuh, marking the
// chunks it walks when visits are tracked), the DDA step, sigma from the
// leaf's f16 row, the split and sample votes (common.cuh vote_step, one i16
// sample-count read), sigma-gated compositing with SH shading (or weight *
// t in depth mode, or the raw rgb of a tree that is not SH), early stop at
// T < stop_thresh, t += delta while t < tmax, at most max_iters steps.
// Then the postprocess (render.py:265-278).
//
// Visit marks: JAX descends every ray in every iteration of its loop, so a
// ray that has finished (or missed the box) still marks the chunks above
// its final position while any other ray marches.  The second kernel,
// exact_visit_tail, does that once for every ray that took fewer steps
// than the slowest (the caller passes that count on the device).
//
// What bounds it on an H100: memory traffic that depends on the data: per
// step one i32 child read per level walked, one f16 data row and one i16
// count; per ray ~100 B of inputs and outputs.  The f32 math per step is
// small against the card's rate, and the child table of the 1080p scenes
// (a few MB) stays in L2.  What holds it, measured on an NVIDIA H100 80GB
// HBM3 at 700 W, is latency at its occupancy (16 registers more, 3 blocks
// of 256 an SM in place of 4, cost 12-16%) and the step's instructions: the
// descent alone is half of its time (probes/exact_breakdown.py, PERF.md).
// Design: for N = 2^b each thread keeps the chunk of every level of its
// last path in a local array (descend_restart), and a step re-walks only
// the levels below the deepest ancestor its new position shares with that
// path, 1.86 on average on the 1080p shell where the root descent walks
// 3.95, and scales the exit by an exact power of two in place of a
// division; any other N descends from the root (descend), as the
// visit-tail kernel does.  Blocks of 128 threads capped at 56 registers
// (28 bytes spill) run 36 warps an SM; 256-thread blocks at 63 registers
// ran 32, 4% slower.  No shared memory.  Built with -fmad=false.
#include "descend_step.cuh"

namespace mnv {

#ifdef MNV_ROOT_DESCENT
// the design before the restart: 256 threads a block, no register cap (an
// explicit minimum of one block changes the compiler's allocation)
constexpr int kExactBlock = kBlock;
#define MNV_EXACT_BOUNDS __launch_bounds__(kBlock)
#else
// 128 threads a block, 9 of them an SM: at most 56 registers, 36 warps an
// SM where 256-thread blocks at 63 registers fit 32
constexpr int kExactBlock = 128;
#define MNV_EXACT_BOUNDS __launch_bounds__(kExactBlock, 9)
#endif

template <bool kRestart>
__global__ void MNV_EXACT_BOUNDS
exact_march_kernel(ExactTree tr, const float* __restrict__ cen,
                   const float* __restrict__ d,
                   const float* __restrict__ invdir,
                   const float* __restrict__ delta_scale,
                   const float* __restrict__ tmin,
                   const float* __restrict__ tmax,
                   const bool* __restrict__ miss,
                   const float* __restrict__ basis, int B, int use_sh,
                   int render_depth, float step_size, float sigma_thresh,
                   float stop_thresh, int max_depth, int max_sample_count,
                   int max_iters, int R, float* __restrict__ out,
                   float* __restrict__ sv_out, float* __restrict__ pv_out,
                   int* __restrict__ steps_out, float* __restrict__ t_out) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const float cx = cen[0], cy = cen[1], cz = cen[2];
  const float dx = d[3 * r], dy = d[3 * r + 1], dz = d[3 * r + 2];
  const float ix = invdir[3 * r], iy = invdir[3 * r + 1],
              iz = invdir[3 * r + 2];
  const float ds = delta_scale[r];
  const float tm = tmax[r];
  const bool ray_miss = miss[r];
  const float* __restrict__ rb = basis + (long long)r * B;
  const int D = tr.D;

  float t = tmin[r];
  float T = 1.0f;
  float acc0 = 0.0f, acc1 = 0.0f, acc2 = 0.0f;
  int steps = 0;
  bool stopped = false;
  bool active = !ray_miss && t < tm;
  Votes v = votes_init(max_depth, max_sample_count);
  DescendPath path;
  path.L = 0;
  while (active && (max_iters == 0 || steps < max_iters)) {
    ++steps;
    const DescendStep st = descend_step<kRestart>(
        tr, path, cx, cy, cz, dx, dy, dz, ix, iy, iz, t, step_size);
    const __half* leaf = tr.data + st.node * D;
    const float sigma = __half2float(leaf[D - 1]);
    const bool dense = sigma > sigma_thresh;
    const float att = expf(-st.delta_t * ds * sigma);
    const float weight = T * (1.0f - att);
    vote_step(v, dense, weight, st.depth, st.chunk, st.cidx,
              tr.counts[st.node], max_depth, max_sample_count);
    if (dense) {
      if (render_depth) {
        acc0 = acc0 + weight * t;
      } else {
        float c0, c1, c2;
        if (use_sh) {
          float l0 = 0.0f, l1 = 0.0f, l2 = 0.0f;
          for (int b = 0; b < B; ++b) {
            const float w = rb[b];
            l0 = l0 + w * __half2float(leaf[b]);
            l1 = l1 + w * __half2float(leaf[B + b]);
            l2 = l2 + w * __half2float(leaf[2 * B + b]);
          }
          c0 = 1.0f / (1.0f + expf(-l0));
          c1 = 1.0f / (1.0f + expf(-l1));
          c2 = 1.0f / (1.0f + expf(-l2));
        } else {
          c0 = __half2float(leaf[0]);
          c1 = __half2float(leaf[1]);
          c2 = __half2float(leaf[2]);
        }
        acc0 = acc0 + weight * c0;
        acc1 = acc1 + weight * c1;
        acc2 = acc2 + weight * c2;
      }
      T = T * att;
      if (T < stop_thresh) {
        stopped = true;
        active = false;
      }
    }
    t = t + st.delta_t;
    active = active && t < tm;
  }

  float alpha;
  if (render_depth) {
    const float d0 = fminf(acc0 * 0.3f, 1.0f);
    acc0 = acc1 = acc2 = ray_miss ? 0.0f : d0;
    alpha = 1.0f;
  } else {
    alpha = stopped ? 1.0f : (ray_miss ? 0.0f : 1.0f - T);
  }
  if (stopped) {
    const float s = 1.0f / (1.0f - T);
    acc0 = acc0 * s;
    acc1 = acc1 * s;
    acc2 = acc2 * s;
  }
  reinterpret_cast<float4*>(out)[r] = make_float4(acc0, acc1, acc2, alpha);
  votes_store(v, r, sv_out, pv_out);
  steps_out[r] = steps;
  t_out[r] = t;
}

// The marks of finished rays while the slowest still marched: a ray that
// took fewer steps than *max_steps descends once more at its final t.
__global__ void __launch_bounds__(kBlock)
exact_visit_tail_kernel(ExactTree tr, const float* __restrict__ cen,
                        const float* __restrict__ d,
                        const float* __restrict__ t_final,
                        const int* __restrict__ steps,
                        const int* __restrict__ max_steps, int R) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R || steps[r] >= *max_steps) return;
  const float t = t_final[r];
  float fx = clip_pos(cen[0], t, d[3 * r]);
  float fy = clip_pos(cen[1], t, d[3 * r + 1]);
  float fz = clip_pos(cen[2], t, d[3 * r + 2]);
  int chunk, cidx, depth;
  descend(tr, fx, fy, fz, chunk, cidx, depth);
}

}  // namespace mnv

extern "C" int exact_march_launch(
    const void* child, long long n_child, const void* data, long long n_nodes,
    int D, const void* counts, int N, int max_levels, void* visited,
    long long n_visited, const void* cen, const void* d, const void* invdir,
    const void* delta_scale, const void* tmin, const void* tmax,
    const void* miss, const void* basis, int B, int use_sh, int render_depth,
    float step_size, float sigma_thresh, float stop_thresh, int max_depth,
    int max_sample_count, int max_iters, int R, void* out, void* sv,
    void* pv, void* steps, void* t_final, void* stream) {
  const int grid = (R + mnv::kExactBlock - 1) / mnv::kExactBlock;
  const mnv::ExactTree tr = mnv::exact_tree(child, n_child, data, n_nodes, D,
                                            counts, N, max_levels, visited,
                                            n_visited);
  auto kernel = tr.b > 0 ? mnv::exact_march_kernel<true>
                         : mnv::exact_march_kernel<false>;
  kernel<<<grid, mnv::kExactBlock, 0,
           static_cast<cudaStream_t>(stream)>>>(
      tr, static_cast<const float*>(cen), static_cast<const float*>(d),
      static_cast<const float*>(invdir),
      static_cast<const float*>(delta_scale),
      static_cast<const float*>(tmin), static_cast<const float*>(tmax),
      static_cast<const bool*>(miss), static_cast<const float*>(basis), B,
      use_sh, render_depth, step_size, sigma_thresh, stop_thresh, max_depth,
      max_sample_count, max_iters, R, static_cast<float*>(out),
      static_cast<float*>(sv), static_cast<float*>(pv),
      static_cast<int*>(steps), static_cast<float*>(t_final));
  return static_cast<int>(cudaGetLastError());
}

// Registers and local memory bytes per thread of the exact march as built,
// with the restart (restart != 0) or the root descent.
extern "C" int exact_march_attributes(int restart, int* regs,
                                      int* local_bytes) {
  cudaFuncAttributes a;
  const cudaError_t e = cudaFuncGetAttributes(
      &a, restart ? mnv::exact_march_kernel<true>
                  : mnv::exact_march_kernel<false>);
  *regs = a.numRegs;
  *local_bytes = static_cast<int>(a.localSizeBytes);
  return static_cast<int>(e);
}

// Shared by the exact march and the exact collect (exact_collect.cu).
extern "C" int exact_visit_tail_launch(
    const void* child, long long n_child, const void* data, long long n_nodes,
    int D, const void* counts, int N, int max_levels, void* visited,
    long long n_visited, const void* cen, const void* d,
    const void* t_final, const void* steps, const void* max_steps, int R,
    void* stream) {
  const int grid = (R + mnv::kBlock - 1) / mnv::kBlock;
  mnv::exact_visit_tail_kernel<<<grid, mnv::kBlock, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      mnv::exact_tree(child, n_child, data, n_nodes, D, counts, N,
                      max_levels, visited, n_visited),
      static_cast<const float*>(cen), static_cast<const float*>(d),
      static_cast<const float*>(t_final), static_cast<const int*>(steps),
      static_cast<const int*>(max_steps), R);
  return static_cast<int>(cudaGetLastError());
}
