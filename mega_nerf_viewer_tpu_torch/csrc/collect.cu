// Guided collect march: one thread per ray records the t of each dense
// sample.
//
// Replaces: mega_nerf_viewer_tpu/ops/guided.py, collect_t_fast — the XLA
// while_loop of the guided collection (guided.py:395-445), not a Pallas
// kernel.  It is the twin of the render march (march.cu): the same leaf
// lookup and step (march_step.cuh), the same sigma gate and early stop,
// but instead of shading a dense sample it writes the sample's tree-space
// t to the ray's row of t_buf; the MLP inputs are rebuilt from t later
// (guided._compact_reconstruct).
//
// Per step (guided.py:410-441): steps += 1; the step; dense = sigma >
// sigma_thresh; a dense sample is recorded while ns < S and otherwise
// marks the ray as overflowing; T *= exp(-delta * ds * sigma); stop at
// T < stop_thresh; t += delta while t < tmax.  Outputs: the recorded
// slots of t_buf [R, S] (the caller passes it filled with -1), ns, steps,
// and the count of overflowing rays.  S = 0 marches with no record buffer.
//
// What bounds it on an H100: memory traffic that depends on the data.  Per
// step one 8 B leaf-map row at a data-dependent place; per ray ~45 B of
// inputs and 4 * S + 8 B of outputs (at 1080p and S = 32 the t_buf alone
// is 265 MB).  The f32 math per step is small against the card's rate.
//
// Design, simple first: as march.cu.  A thread writes only the slots it
// records.  Writing the -1 fill here as well (S stores per thread, a
// warp's 32 stores of one slot on 32 rows) made the kernel 10x its byte
// bound at 1080p; the caller's fill is one coalesced pass.  Built with
// -fmad=false.
#include "march_step.cuh"

namespace mnv {

__global__ void __launch_bounds__(kBlock)
collect_kernel(LeafMapTree tr, const float* __restrict__ cen,
               const float* __restrict__ d, const float* __restrict__ invdir,
               const float* __restrict__ delta_scale,
               const float* __restrict__ tmin,
               const float* __restrict__ tmax, const bool* __restrict__ miss,
               int S, float step_size, float sigma_thresh, float stop_thresh,
               int R, float* __restrict__ t_buf, int* __restrict__ ns_out,
               int* __restrict__ steps_out, int* __restrict__ overflow) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;

  const float cx = cen[0], cy = cen[1], cz = cen[2];
  const float dx = d[3 * r], dy = d[3 * r + 1], dz = d[3 * r + 2];
  const float ix = invdir[3 * r], iy = invdir[3 * r + 1],
              iz = invdir[3 * r + 2];
  const float ds = delta_scale[r];
  const float tm = tmax[r];
  float* __restrict__ row = t_buf + (long long)r * S;

  float t = tmin[r];
  float T = 1.0f;
  int ns = 0, steps = 0;
  bool over = false;
  bool active = !miss[r] && t < tm;
  while (active) {
    ++steps;
    const MarchStep st =
        march_step(tr, cx, cy, cz, dx, dy, dz, ix, iy, iz, t, step_size);
    if (st.sigma > sigma_thresh) {
      const float att = expf(-st.delta_t * ds * st.sigma);
      if (ns < S) {
        row[ns] = t;
        ++ns;
      } else {
        over = true;
      }
      T = T * att;
      if (T < stop_thresh) active = false;
    }
    t = t + st.delta_t;
    active = active && t < tm;
  }
  ns_out[r] = ns;
  steps_out[r] = steps;
  if (over) atomicAdd(overflow, 1);
}

}  // namespace mnv

extern "C" int collect_launch(
    const void* child, long long n_child, const void* data, long long n_nodes,
    int D, const void* rows, long long n_cells, int level, int deep_levels,
    const void* cen, const void* d, const void* invdir,
    const void* delta_scale, const void* tmin, const void* tmax,
    const void* miss, int S, float step_size, float sigma_thresh,
    float stop_thresh, int R, void* t_buf, void* ns, void* steps,
    void* overflow, void* stream) {
  const int grid = (R + mnv::kBlock - 1) / mnv::kBlock;
  const mnv::LeafMapTree tr{
      static_cast<const int*>(child), n_child,
      static_cast<const __half*>(data), n_nodes, D,
      static_cast<const int2*>(rows), n_cells, level, deep_levels};
  mnv::collect_kernel<<<grid, mnv::kBlock, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      tr, static_cast<const float*>(cen), static_cast<const float*>(d),
      static_cast<const float*>(invdir),
      static_cast<const float*>(delta_scale),
      static_cast<const float*>(tmin), static_cast<const float*>(tmax),
      static_cast<const bool*>(miss), S, step_size, sigma_thresh,
      stop_thresh, R, static_cast<float*>(t_buf), static_cast<int*>(ns),
      static_cast<int*>(steps), static_cast<int*>(overflow));
  return static_cast<int>(cudaGetLastError());
}
