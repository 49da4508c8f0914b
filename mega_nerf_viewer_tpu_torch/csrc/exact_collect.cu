// Exact guided collect: one thread per ray records its dense samples.
//
// Replaces: mega_nerf_viewer_tpu/ops/guided.py, collect_samples — the XLA
// while_loop of the exact guided collection (guided.py:60-192), not a
// Pallas kernel; the reference's get_samples_trace_ray
// (rt_core.cuh:418-576).  It is the twin of the exact march
// (exact_march.cu): the same step (descend_step.cuh), the same
// votes and visit marks (the caller runs exact_visit_tail after it), the
// same sigma gate and early stop; instead of shading, each dense sample
// while ns < S writes its padded row [z, world xyz, (view dir),
// (appearance)] and its cluster id.
//
// The record (guided.py:155-176): z = |t * d / scale| (the fused sum of
// squares of ops/rays.py:sq_norm), the world position dir * z + cen as one
// fused multiply-add, the cluster id from the clipped world (y, z) on the
// model's grid (models/meganerf.py:cluster_ids_from_yz).  The caller fills
// samples with -1 and cluster_ids with 0 in one coalesced pass each; the
// kernel writes only the recorded slots (a per-thread fill, 32 rows per
// warp store, made the collect march of the fast path 10x its bound).
//
// What bounds it on an H100: memory traffic that depends on the data: per
// step the descent's child reads, one f16 sigma and one i16 count; per
// recorded sample one row of 4 * (1 + dim) B and one id.  The descent starts
// at the root at every step: the exact march's restarted descent
// (descend_restart) made this kernel 4% slower on the 1080p refinement rays
// (an NVIDIA H100 80GB HBM3 at 700 W, PERF.md), so it is not taken here.
// The restart finds the root descent's leaf bit for bit, so the two
// kernels' trajectories stay equal (a card test holds them equal).  Built
// with -fmad=false.
#include "descend_step.cuh"

namespace mnv {

__global__ void __launch_bounds__(kBlock)
exact_collect_kernel(ExactTree tr, const float* __restrict__ cen,
                     const float* __restrict__ d,
                     const float* __restrict__ invdir,
                     const float* __restrict__ delta_scale,
                     const float* __restrict__ tmin,
                     const float* __restrict__ tmax,
                     const bool* __restrict__ miss,
                     const float* __restrict__ dirs,
                     const float* __restrict__ vdirs,
                     const float* __restrict__ cen_world,
                     const float* __restrict__ scale,
                     const int* __restrict__ grid_dim,
                     const float* __restrict__ min_pos,
                     const float* __restrict__ pos_range, int S, int W,
                     int need_viewdir, int has_app, float app,
                     float step_size, float sigma_thresh, float stop_thresh,
                     int max_depth, int max_sample_count, int R,
                     float* __restrict__ samples, int* __restrict__ cids,
                     int* __restrict__ ns_out, float* __restrict__ sv_out,
                     float* __restrict__ pv_out, int* __restrict__ steps_out,
                     float* __restrict__ t_out) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const float cx = cen[0], cy = cen[1], cz = cen[2];
  const float dx = d[3 * r], dy = d[3 * r + 1], dz = d[3 * r + 2];
  const float ix = invdir[3 * r], iy = invdir[3 * r + 1],
              iz = invdir[3 * r + 2];
  const float ds = delta_scale[r];
  const float tm = tmax[r];
  const int D = tr.D;
  const int gd0 = grid_dim[0], gd1 = grid_dim[1];
  const float gd0f = (float)gd0, gd1f = (float)gd1;
  float* __restrict__ rows = samples + (long long)r * S * W;

  float t = tmin[r];
  float T = 1.0f;
  int steps = 0, ns = 0;
  bool active = !miss[r] && t < tm;
  Votes v = votes_init(max_depth, max_sample_count);
  DescendPath path;  // unused by the descent from the root
  while (active) {
    ++steps;
    const DescendStep st = descend_step<false>(
        tr, path, cx, cy, cz, dx, dy, dz, ix, iy, iz, t, step_size);
    const float sigma = __half2float(tr.data[st.node * D + (D - 1)]);
    const bool dense = sigma > sigma_thresh;
    const float att = expf(-st.delta_t * ds * sigma);
    const float weight = T * (1.0f - att);
    vote_step(v, dense, weight, st.depth, st.chunk, st.cidx,
              tr.counts[st.node], max_depth, max_sample_count);
    if (dense && ns < S) {
      const float zx = (t * dx) / scale[0];
      const float zy = (t * dy) / scale[1];
      const float zz = (t * dz) / scale[2];
      const float z = sqrtf(__fmaf_rn(zz, zz, __fmaf_rn(zy, zy, zx * zx)));
      const float px = __fmaf_rn(dirs[3 * r], z, cen_world[0]);
      const float py = __fmaf_rn(dirs[3 * r + 1], z, cen_world[1]);
      const float pz = __fmaf_rn(dirs[3 * r + 2], z, cen_world[2]);
      float* __restrict__ row = rows + (long long)ns * W;
      row[0] = z;
      row[1] = px;
      row[2] = py;
      row[3] = pz;
      int c = 4;
      if (need_viewdir) {
        row[4] = vdirs[3 * r];
        row[5] = vdirs[3 * r + 1];
        row[6] = vdirs[3 * r + 2];
        c = 7;
      }
      if (has_app) row[c] = app;
      const float g1 = fminf(fmaxf((py - min_pos[1]) / pos_range[1] * gd0f,
                                   0.0f), gd0f - 1.0f);
      const float g2 = fminf(fmaxf((pz - min_pos[2]) / pos_range[2] * gd1f,
                                   0.0f), gd1f - 1.0f);
      cids[(long long)r * S + ns] = (int)g1 * gd1 + (int)g2;
      ++ns;
    }
    if (dense) {
      T = T * att;
      if (T < stop_thresh) active = false;
    }
    t = t + st.delta_t;
    active = active && t < tm;
  }
  ns_out[r] = ns;
  votes_store(v, r, sv_out, pv_out);
  steps_out[r] = steps;
  t_out[r] = t;
}

}  // namespace mnv

extern "C" int exact_collect_launch(
    const void* child, long long n_child, const void* data, long long n_nodes,
    int D, const void* counts, int N, int max_levels, void* visited,
    long long n_visited, const void* cen, const void* d, const void* invdir,
    const void* delta_scale, const void* tmin, const void* tmax,
    const void* miss, const void* dirs, const void* vdirs,
    const void* cen_world, const void* scale, const void* grid_dim,
    const void* min_pos, const void* pos_range, int S, int W,
    int need_viewdir, int has_app, float app, float step_size,
    float sigma_thresh, float stop_thresh, int max_depth,
    int max_sample_count, int R, void* samples, void* cids, void* ns,
    void* sv, void* pv, void* steps, void* t_final, void* stream) {
  const int grid = (R + mnv::kBlock - 1) / mnv::kBlock;
  mnv::exact_collect_kernel<<<grid, mnv::kBlock, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      mnv::exact_tree(child, n_child, data, n_nodes, D, counts, N,
                      max_levels, visited, n_visited),
      static_cast<const float*>(cen), static_cast<const float*>(d),
      static_cast<const float*>(invdir),
      static_cast<const float*>(delta_scale),
      static_cast<const float*>(tmin), static_cast<const float*>(tmax),
      static_cast<const bool*>(miss), static_cast<const float*>(dirs),
      static_cast<const float*>(vdirs), static_cast<const float*>(cen_world),
      static_cast<const float*>(scale), static_cast<const int*>(grid_dim),
      static_cast<const float*>(min_pos),
      static_cast<const float*>(pos_range), S, W, need_viewdir, has_app, app,
      step_size, sigma_thresh, stop_thresh, max_depth, max_sample_count, R,
      static_cast<float*>(samples), static_cast<int*>(cids),
      static_cast<int*>(ns), static_cast<float*>(sv),
      static_cast<float*>(pv), static_cast<int*>(steps),
      static_cast<float*>(t_final));
  return static_cast<int>(cudaGetLastError());
}

// Registers and local memory bytes per thread of the exact collect as
// built.
extern "C" int exact_collect_attributes(int* regs, int* local_bytes) {
  cudaFuncAttributes a;
  const cudaError_t e =
      cudaFuncGetAttributes(&a, mnv::exact_collect_kernel);
  *regs = a.numRegs;
  *local_bytes = static_cast<int>(a.localSizeBytes);
  return static_cast<int>(e);
}
