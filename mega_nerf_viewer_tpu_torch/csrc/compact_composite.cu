// Guided compact compositor: one thread per ray walks its run of samples.
//
// Replaces: mega_nerf_viewer_tpu/ops/pallas_composite.py,
// composite_results_compact_pallas (kernel _make_compact_kernel :150-263,
// SH helper _sh_terms :116-147), the reference's composite_nerf_results
// (rt_core.cuh:334-416) over the compact sample layout.  Ray r owns the
// samples [offs[r] - ns[r], offs[r]) of res [M, out_dim], z [M] and
// vdirs [M, 3].  In order along the run: delta = z[i+1] - z[i] (0 on the
// last sample), wc = exp(-sigma * delta) with sigma = res[i, min(3,
// out_dim - 1)], weight = T on the last sample and T * (1 - wc) before it,
// SH logits from the sample's view direction with the basis_minmax mask
// (or the raw res[:, :3] for a cache that is not SH), sigmoid, weight *
// rgb summed; then T *= wc.  T is the exclusive product kept as a running
// value, never P / wc: an opaque sample gives wc = 0, and the division
// would give NaN.  Output [R, 4] rgba with alpha 1; a ray with no samples
// is (0, 0, 0, 1).
//
// Depth mode (render_depth) is a branch of the same walk, as the XLA
// route has it (mega_nerf_viewer_tpu/ops/guided.py:706-707, :724-726;
// rt_core.cuh:372): it sums weight * T (T before this sample) and writes
// min(0.3 * sum, 1) to all three channels.  It reads no view directions.
//
// The TPU kernel is a segmented scan over (16, 128) tiles with lane
// shifts and a carry row from block to block, then a gather at each
// ray's last sample.  A thread per ray replaces all of it: no segment
// flags, no carries, no gather, and the padding past the last run is
// never read.
//
// What bounds it on an H100: bytes.  Per sample it reads out_dim + 4 f32
// (res row, z, view direction) and does ~6 * basis_dim + 30 f32 ops, far
// below the card's 20 ops per byte.  Design, simple first: a warp covers
// 32 neighbouring runs, which lie next to each other in the compact
// layout, so its reads stay in a few cache lines per step; res stays
// [M, out_dim] as the MLP writes it.  Built with -fmad=false.
#include "common.cuh"

namespace mnv {

constexpr int kMaxBasis = 25;

// The first B real SH basis values at unit (x, y, z), with the constants
// and the operation order of ops/sh.py:eval_sh_basis (rt_core.cuh:13-68).
__device__ __forceinline__ void sh_basis(int B, float x, float y, float z,
                                         float* t) {
  t[0] = 0.28209479177387814f;
  if (B >= 4) {
    t[1] = -0.4886025119029199f * y;
    t[2] = 0.4886025119029199f * z;
    t[3] = -0.4886025119029199f * x;
  }
  if (B >= 9) {
    const float xx = x * x, yy = y * y, zz = z * z;
    const float xy = x * y, yz = y * z, xz = x * z;
    t[4] = 1.0925484305920792f * xy;
    t[5] = -1.0925484305920792f * yz;
    t[6] = 0.31539156525252005f * (2.0f * zz - xx - yy);
    t[7] = -1.0925484305920792f * xz;
    t[8] = 0.5462742152960396f * (xx - yy);
    if (B >= 16) {
      t[9] = -0.5900435899266435f * y * (3.0f * xx - yy);
      t[10] = 2.890611442640554f * xy * z;
      t[11] = -0.4570457994644658f * y * (4.0f * zz - xx - yy);
      t[12] = 0.3731763325901154f * z * (2.0f * zz - 3.0f * xx - 3.0f * yy);
      t[13] = -0.4570457994644658f * x * (4.0f * zz - xx - yy);
      t[14] = 1.445305721320277f * z * (xx - yy);
      t[15] = -0.5900435899266435f * x * (xx - 3.0f * yy);
    }
    if (B >= 25) {
      t[16] = 2.5033429417967046f * xy * (xx - yy);
      t[17] = -1.7701307697799304f * yz * (3.0f * xx - yy);
      t[18] = 0.9461746957575601f * xy * (7.0f * zz - 1.0f);
      t[19] = -0.6690465435572892f * yz * (7.0f * zz - 3.0f);
      t[20] = 0.10578554691520431f * (zz * (35.0f * zz - 30.0f) + 3.0f);
      t[21] = -0.6690465435572892f * xz * (7.0f * zz - 3.0f);
      t[22] = 0.47308734787878004f * (xx - yy) * (7.0f * zz - 1.0f);
      t[23] = -1.7701307697799304f * xz * (xx - 3.0f * yy);
      t[24] = 0.6258357354491761f *
              (xx * (xx - 3.0f * yy) - yy * (3.0f * xx - yy));
    }
  }
}

__global__ void __launch_bounds__(kBlock)
compact_composite_kernel(const float* __restrict__ res, int out_dim,
                         const float* __restrict__ z,
                         const int* __restrict__ offs,
                         const int* __restrict__ ns,
                         const float* __restrict__ vdirs, int B, int use_sh,
                         int bmin, int bmax, int depth, int R,
                         float* __restrict__ out) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const int sidx = out_dim - 1 < 3 ? out_dim - 1 : 3;
  const long long end = offs[r];
  const long long start = end - ns[r];

  float T = 1.0f;
  float acc0 = 0.0f, acc1 = 0.0f, acc2 = 0.0f;
  float basis[kMaxBasis];
  for (long long i = start; i < end; ++i) {
    const float* __restrict__ row = res + i * out_dim;
    const bool last = i == end - 1;
    const float delta = last ? 0.0f : z[i + 1] - z[i];
    const float wc = expf(-row[sidx] * delta);
    const float weight = last ? T : T * (1.0f - wc);
    if (depth) {
      acc0 = acc0 + weight * T;
      T = T * wc;
      continue;
    }
    float c0, c1, c2;
    if (use_sh) {
      sh_basis(B, vdirs[3 * i], vdirs[3 * i + 1], vdirs[3 * i + 2], basis);
      float l0 = 0.0f, l1 = 0.0f, l2 = 0.0f;
      for (int b = bmin; b <= bmax && b < B; ++b) {
        l0 = l0 + basis[b] * row[b];
        l1 = l1 + basis[b] * row[B + b];
        l2 = l2 + basis[b] * row[2 * B + b];
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
    T = T * wc;
  }
  if (depth) {
    const float v = fminf(acc0 * 0.3f, 1.0f);
    acc0 = acc1 = acc2 = v;
  }
  reinterpret_cast<float4*>(out)[r] = make_float4(acc0, acc1, acc2, 1.0f);
}

}  // namespace mnv

extern "C" int compact_composite_launch(
    const void* res, int out_dim, const void* z, const void* offs,
    const void* ns, const void* vdirs, int B, int use_sh, int bmin, int bmax,
    int depth, int R, void* out, void* stream) {
  const int grid = (R + mnv::kBlock - 1) / mnv::kBlock;
  mnv::compact_composite_kernel<<<grid, mnv::kBlock, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(res), out_dim, static_cast<const float*>(z),
      static_cast<const int*>(offs), static_cast<const int*>(ns),
      static_cast<const float*>(vdirs), B, use_sh, bmin, bmax, depth, R,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
