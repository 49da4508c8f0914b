// Guided padded compositor: a tile of W lanes per ray scans its valid slots.
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
// of a tree that is not SH.  T is the exclusive product of wc over the
// valid slots before: an opaque sample gives wc = 0 and T = 0 after it,
// never NaN.  Output rgba with alpha 1; a ray with no samples is
// (0, 0, 0, 1).
//
// What bounds it on an H100: bytes.  Per valid slot it must read out_dim + 1
// f32 and does ~6 * B + 24 f32 ops; the padding past ns[r] is never read.
// What holds it above that: DRAM sectors that a ray's few valid bytes fill
// only in part (at S = 32, out_dim 5, a ray's ~6.8 valid rows are ~136 B of
// a 640 B stride), and a chunk's waits on its ray's count, rows and depths.
//
// Design: a tile of W = 8 lanes owns one ray and walks its valid slots in
// chunks of W, lane j taking slot c*W + j.  W fits a real cache's ~6.8
// valid slots per ray, where wider tiles idle most of their lanes; 16 or
// 32 lanes win only on caches whose rays fill most of S (PERF.md).
// The tile first copies the chunk's m * out_dim contiguous floats (its m
// valid slots) into shared memory, consecutive lanes on consecutive words,
// then each lane reads its row there; z is read one slot per lane.  So
// every valid byte is read from device memory once, in coalesced
// transactions, where one thread per ray had each warp's loads touch 32
// sectors S * out_dim * 4 bytes apart.  The transmittance is the TPU
// kernel's parallel form: an inclusive product scan of the chunk's wc
// (Hillis-Steele, log2 W __shfl_up_sync steps, 1 past the last valid
// slot), shifted to exclusive and scaled by a carry that holds T from one
// chunk to the next.  Each lane sums its slots' weight * colour; a
// butterfly of __shfl_xor_sync sums the tile, and lane 0 writes the float4.
// Copies that overlap those waits (cp.async of rows, depths and basis; one
// batch of eight loads per lane) measured slower on the 1080p cache: they
// take 48-64 registers, so fewer warps are resident, and more instructions
// per word (PERF.md).  Built with -fmad=false.
#include "common.cuh"

namespace mnv {

constexpr int kModeSH = 0, kModeDepth = 1;
constexpr int kCompositeThreads = 128;
constexpr int kLanes = 8;                    // W, the lanes per ray

__global__ void __launch_bounds__(kCompositeThreads)
padded_composite_kernel(const float* __restrict__ res, int S, int out_dim,
                        const float* __restrict__ z,
                        const int* __restrict__ ns,
                        const float* __restrict__ basis, int B, int mode,
                        int R, float* __restrict__ out) {
  extern __shared__ float stage[];          // W * out_dim floats per tile
  const int r = (blockIdx.x * kCompositeThreads + threadIdx.x) / kLanes;
  if (r >= R) return;                       // whole tiles leave together
  const int lane = threadIdx.x & (kLanes - 1);
  const unsigned mask = ((1u << kLanes) - 1)
                        << (threadIdx.x & 31 & ~(kLanes - 1));
  float* __restrict__ buf =
      stage + (threadIdx.x / kLanes) * kLanes * out_dim;
  const int sidx = out_dim - 1 < 3 ? out_dim - 1 : 3;
  const int n = ns[r];
  const float* __restrict__ rr = res + (long long)r * S * out_dim;
  const float* __restrict__ zr = z + (long long)r * S;
  const float* __restrict__ rb = basis + (long long)r * B;

  float carry = 1.0f;
  float acc0 = 0.0f, acc1 = 0.0f, acc2 = 0.0f;
  for (int c = 0; c < n; c += kLanes) {
    const int m = n - c < kLanes ? n - c : kLanes;  // valid slots here
    const float* __restrict__ src = rr + (long long)c * out_dim;
    for (int k = lane; k < m * out_dim; k += kLanes) buf[k] = src[k];
    __syncwarp(mask);
    const int i = c + lane;
    const bool valid = lane < m;
    const bool last = i == n - 1;
    const float* row = buf + lane * out_dim;
    const float zi = valid ? zr[i] : 0.0f;
    float znext = __shfl_down_sync(mask, zi, 1, kLanes);
    if (lane == kLanes - 1 && i + 1 < n) znext = zr[i + 1];
    const float delta = last ? 0.0f : znext - zi;
    const float wc = valid ? expf(-row[sidx] * delta) : 1.0f;
    float incl = valid && !last ? wc : 1.0f;
    for (int off = 1; off < kLanes; off <<= 1) {
      const float up = __shfl_up_sync(mask, incl, off, kLanes);
      if (lane >= off) incl = incl * up;
    }
    float excl = __shfl_up_sync(mask, incl, 1, kLanes);
    if (lane == 0) excl = 1.0f;
    const float T = carry * excl;
    if (valid) {
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
    }
    carry = carry * __shfl_sync(mask, incl, kLanes - 1, kLanes);
    __syncwarp(mask);                       // the rows are read: restage
  }
  for (int off = kLanes / 2; off > 0; off >>= 1) {
    acc0 = acc0 + __shfl_xor_sync(mask, acc0, off, kLanes);
    acc1 = acc1 + __shfl_xor_sync(mask, acc1, off, kLanes);
    acc2 = acc2 + __shfl_xor_sync(mask, acc2, off, kLanes);
  }
  if (lane == 0) {
    if (mode == kModeDepth) acc0 = acc1 = acc2 = fminf(acc0 * 0.3f, 1.0f);
    reinterpret_cast<float4*>(out)[r] = make_float4(acc0, acc1, acc2, 1.0f);
  }
}

}  // namespace mnv

extern "C" int padded_composite_launch(const void* res, int S, int out_dim,
                                       const void* z, const void* ns,
                                       const void* basis, int B, int mode,
                                       int R, void* out, void* stream) {
  using namespace mnv;
  const size_t smem = sizeof(float) * kCompositeThreads * out_dim;
  if (smem > 48 * 1024) {
    // past the card's shared memory per block this fails, and so the launch
    const cudaError_t err = cudaFuncSetAttribute(
        padded_composite_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long threads = (long long)R * kLanes;
  const int grid =
      (int)((threads + kCompositeThreads - 1) / kCompositeThreads);
  padded_composite_kernel<<<grid, kCompositeThreads, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(res), S, out_dim, static_cast<const float*>(z),
      static_cast<const int*>(ns), static_cast<const float*>(basis), B, mode,
      R, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
