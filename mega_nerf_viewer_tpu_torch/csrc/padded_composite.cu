// Guided padded compositor: one thread per ray walks its valid slots.
//
// Replaces: mega_nerf_viewer_tpu/ops/pallas_composite.py,
// composite_results_pallas (kernel _make_kernel :65-102, prefix product
// _prefix_prod :44-62), and the XLA compositor guided.composite_results
// (guided.py:196-240) that composite_frame runs on the padded cache; the
// reference's composite_nerf_results (rt_core.cuh:334-416).  Ray r owns
// slots [0, ns[r]) of res [R, S, out_dim] and z [R, S].  In order: delta =
// z[i+1] - z[i] (0 on the last valid slot), wc = exp(-sigma * delta) with
// sigma = res[.., min(3, out_dim - 1)], weight = T on the last valid slot
// and T * (1 - wc) before it, then by mode: SH logits from the ray's
// masked basis [R, B] (computed outside, as the Pallas wrapper does),
// sigmoid, weight * rgb summed; depth, the sum of weight * T (the
// reference's quirk) as min(0.3 * sum, 1) in grey; or the raw res[.., :3]
// of a tree that is not SH.  T is the exclusive product kept as a running
// value: an opaque sample gives wc = 0 and T = 0 after it, never NaN.
// Output rgba with alpha 1; a ray with no samples is (0, 0, 0, 1).
//
// The TPU kernel holds (8, S) tiles and turns the serial product into a
// log2(S)-step prefix product of lane rolls.  A thread per ray keeps the
// product serial and reads only the valid slots.
//
// What bounds it on an H100: bytes.  Per valid slot it reads out_dim + 1
// f32 and does ~6 * B + 24 f32 ops.  Known weakness, kept for now: a
// warp's 32 rays lie S * out_dim * 4 bytes apart (640 B at S = 32 and
// out_dim 5), so each slot's loads touch 32 separate sectors.  Built with
// -fmad=false.
#include "common.cuh"

namespace mnv {

constexpr int kModeSH = 0, kModeDepth = 1, kModeRGB = 2;

__global__ void __launch_bounds__(kBlock)
padded_composite_kernel(const float* __restrict__ res, int S, int out_dim,
                        const float* __restrict__ z,
                        const int* __restrict__ ns,
                        const float* __restrict__ basis, int B, int mode,
                        int R, float* __restrict__ out) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const int sidx = out_dim - 1 < 3 ? out_dim - 1 : 3;
  const int n = ns[r];
  const float* __restrict__ rr = res + (long long)r * S * out_dim;
  const float* __restrict__ zr = z + (long long)r * S;
  const float* __restrict__ rb = basis + (long long)r * B;

  float T = 1.0f;
  float acc0 = 0.0f, acc1 = 0.0f, acc2 = 0.0f;
  for (int i = 0; i < n; ++i) {
    const float* __restrict__ row = rr + (long long)i * out_dim;
    const bool last = i == n - 1;
    const float delta = last ? 0.0f : zr[i + 1] - zr[i];
    const float wc = expf(-row[sidx] * delta);
    const float weight = last ? T : T * (1.0f - wc);
    if (mode == kModeDepth) {
      acc0 = acc0 + weight * T;
    } else {
      float c0, c1, c2;
      if (mode == kModeSH) {
        float l0 = 0.0f, l1 = 0.0f, l2 = 0.0f;
        for (int b = 0; b < B; ++b) {
          l0 = l0 + rb[b] * row[b];
          l1 = l1 + rb[b] * row[B + b];
          l2 = l2 + rb[b] * row[2 * B + b];
        }
        c0 = 1.0f / (1.0f + expf(-l0));
        c1 = 1.0f / (1.0f + expf(-l1));
        c2 = 1.0f / (1.0f + expf(-l2));
      } else {
        c0 = row[0];
        c1 = row[1];
        c2 = row[2];
      }
      acc0 = acc0 + weight * c0;
      acc1 = acc1 + weight * c1;
      acc2 = acc2 + weight * c2;
    }
    T = T * wc;
  }
  if (mode == kModeDepth) acc0 = acc1 = acc2 = fminf(acc0 * 0.3f, 1.0f);
  reinterpret_cast<float4*>(out)[r] = make_float4(acc0, acc1, acc2, 1.0f);
}

}  // namespace mnv

extern "C" int padded_composite_launch(const void* res, int S, int out_dim,
                                       const void* z, const void* ns,
                                       const void* basis, int B, int mode,
                                       int R, void* out, void* stream) {
  const int grid = (R + mnv::kBlock - 1) / mnv::kBlock;
  mnv::padded_composite_kernel<<<grid, mnv::kBlock, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(res), S, out_dim,
      static_cast<const float*>(z), static_cast<const int*>(ns),
      static_cast<const float*>(basis), B, mode, R,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
