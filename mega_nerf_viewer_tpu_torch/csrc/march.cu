// Fused leaf-map march: one thread per ray, lookup to shaded pixel.
//
// Replaces: mega_nerf_viewer_tpu/ops/accel.py, render_rays_fast — the XLA
// while_loop of the fast path (accel.py:438-613), not a Pallas kernel.  In
// eager PyTorch that loop would launch some 40 tensor ops per march step
// for every step of the slowest ray; here it is the shape of the
// reference's own render_voxels_kernel (rt_core.cuh:162-332).
//
// Per step (accel.py:468-545): the leaf-map row of the cell (plus the
// deep_levels resumed descent through child), the DDA step to the leaf
// exit, the sigma > sigma_thresh gate, exp(-delta * ds * sigma), the
// transmittance update, early stop at T < stop_thresh, t += delta and
// t < tmax.  Outputs: nsteps, nrec (every dense sample, uncapped), the
// count of rays with a dense sample at nd >= max_dense, and rgba before
// the background.
//
// Shading happens inline, for exactly the samples the JAX record buffer
// keeps (nd < max_dense): the f16 data row -> f32, a dot with the ray's
// masked SH basis, a sigmoid, accumulated as weight * rgb.  So pixels equal
// the deferred-shading reference even on frames that overflow, and
// max_dense = 0 gives rgb 0 with the reference's alpha.
//
// What bounds it on an H100: memory traffic that depends on the data.
// Per step one 8 B leaf-map row, read at a data-dependent place of a map
// that is larger than L2 at level 8 (134 MB); per shaded sample one data
// row (56 B for SH9); per ray ~100 B of inputs and outputs.  The f32 math
// per step is small against the card's rate.
//
// Vote frames (need_votes, accel.py:487-513) read one more i16 sample
// count per step and keep the exact march's split and sample votes
// (common.cuh vote_step), so a refinement session votes on the fast path.
// Depth mode (accel.py:524-592) adds weight * t instead of a shaded colour
// for the recorded samples and writes min(0.3 * sum, 1) in grey with
// alpha 1; with max_dense = 0 it writes (0, 0, 0, 1).
//
// The gated launch (the device overflow policy's fallback march,
// accel.py:735-770): with a non-null gate, the kernel reads the n_gate
// segment overflow counts behind it first, and when all are 0 every thread
// returns before it loads anything or writes any output, so the caller's
// buffers keep the segmented frame.  When one is not 0 the launch re-marches
// the whole sorted frame into those buffers.  JAX takes this branch with
// lax.cond; here the decision stays on the device and no count crosses to
// the host.  An ungated launch passes a null gate and pays one test of a
// kernel parameter.
//
// Design, simple first: no shared memory, no async copies; rays that are
// neighbours in the frame order are neighbours in a warp, so their row
// reads fall on nearby cells.  The step itself is march_step
// (march_step.cuh), which the guided collect march shares.  Built with
// -fmad=false (see common.cuh).
#include "march_step.cuh"

namespace mnv {

__global__ void __launch_bounds__(kBlock)
march_kernel(LeafMapTree tr, const float* __restrict__ cen,
             const float* __restrict__ d, const float* __restrict__ invdir,
             const float* __restrict__ delta_scale,
             const float* __restrict__ tmin, const float* __restrict__ tmax,
             const bool* __restrict__ miss, const float* __restrict__ basis,
             int B, int use_sh, float step_size, float sigma_thresh,
             float stop_thresh, int max_dense, int R,
             float* __restrict__ out, int* __restrict__ nsteps_out,
             int* __restrict__ nrec_out, int* __restrict__ overflow,
             const short* __restrict__ counts, int need_votes, int max_depth,
             int max_sample_count, int render_depth,
             float* __restrict__ sv_out, float* __restrict__ pv_out,
             const int* __restrict__ gate, int n_gate) {
  if (gate != nullptr) {
    int any = 0;
    for (int i = 0; i < n_gate; ++i) any |= gate[i];
    if (any == 0) return;
  }
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

  float t = tmin[r];
  float T = 1.0f;
  float acc0 = 0.0f, acc1 = 0.0f, acc2 = 0.0f;
  int nd = 0, ns = 0;
  bool stopped = false, over = false;
  bool active = !ray_miss && t < tm;
  Votes v = votes_init(max_depth, max_sample_count);
  while (active) {
    ++ns;
    const MarchStep st =
        march_step(tr, cx, cy, cz, dx, dy, dz, ix, iy, iz, t, step_size);
    const float sigma = st.sigma;
    const float delta_t = st.delta_t;
    const bool dense = sigma > sigma_thresh;
    float att = 1.0f, weight = 0.0f;
    if (dense) {
      att = expf(-delta_t * ds * sigma);
      weight = T * (1.0f - att);
    }
    if (need_votes) {
      const int sc = counts[clampll(st.node, tr.n_nodes)];
      vote_step(v, dense, weight, st.depth, st.node >> 3, st.node & 7, sc,
                max_depth, max_sample_count);
    }
    if (dense) {
      if (nd < max_dense && render_depth) {
        acc0 = acc0 + weight * t;
      } else if (nd < max_dense) {
        const __half* leaf = tr.data + clampll(st.node, tr.n_nodes) * tr.D;
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
      } else {
        over = true;
      }
      ++nd;
      T = T * att;
      if (T < stop_thresh) {
        stopped = true;
        active = false;
      }
    }
    t = t + delta_t;
    active = active && t < tm;
  }

  float alpha = stopped ? 1.0f : (ray_miss ? 0.0f : 1.0f - T);
  if (render_depth) {
    alpha = 1.0f;
    const float d0 = fminf(acc0 * 0.3f, 1.0f);
    acc0 = acc1 = acc2 = (max_dense == 0 || ray_miss) ? 0.0f : d0;
  }
  if (stopped && max_dense > 0) {
    const float s = 1.0f / (1.0f - T);
    acc0 = acc0 * s;
    acc1 = acc1 * s;
    acc2 = acc2 * s;
  }
  float4 o = make_float4(acc0, acc1, acc2, alpha);
  reinterpret_cast<float4*>(out)[r] = o;
  nsteps_out[r] = ns;
  nrec_out[r] = nd;
  if (over) atomicAdd(overflow, 1);
  if (need_votes) votes_store(v, r, sv_out, pv_out);
}

}  // namespace mnv

extern "C" int march_launch(
    const void* child, long long n_child, const void* data, long long n_nodes,
    int D, const void* rows, long long n_cells, int level, int deep_levels,
    const void* cen, const void* d, const void* invdir,
    const void* delta_scale, const void* tmin, const void* tmax,
    const void* miss, const void* basis, int B, int use_sh, float step_size,
    float sigma_thresh, float stop_thresh, int max_dense, int R, void* out,
    void* nsteps, void* nrec, void* overflow, const void* counts,
    int need_votes, int max_depth, int max_sample_count, int render_depth,
    void* sv, void* pv, const void* gate, int n_gate, void* stream) {
  const int grid = (R + mnv::kBlock - 1) / mnv::kBlock;
  const mnv::LeafMapTree tr{
      static_cast<const int*>(child), n_child,
      static_cast<const __half*>(data), n_nodes, D,
      static_cast<const int2*>(rows), n_cells, level, deep_levels};
  mnv::march_kernel<<<grid, mnv::kBlock, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      tr, static_cast<const float*>(cen), static_cast<const float*>(d),
      static_cast<const float*>(invdir),
      static_cast<const float*>(delta_scale),
      static_cast<const float*>(tmin), static_cast<const float*>(tmax),
      static_cast<const bool*>(miss), static_cast<const float*>(basis), B,
      use_sh, step_size, sigma_thresh, stop_thresh, max_dense, R,
      static_cast<float*>(out), static_cast<int*>(nsteps),
      static_cast<int*>(nrec), static_cast<int*>(overflow),
      static_cast<const short*>(counts), need_votes, max_depth,
      max_sample_count, render_depth, static_cast<float*>(sv),
      static_cast<float*>(pv), static_cast<const int*>(gate), n_gate);
  return static_cast<int>(cudaGetLastError());
}
