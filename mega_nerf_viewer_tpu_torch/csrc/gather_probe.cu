// Row-gather probe: per-chunk sums of table rows gathered at random indices.
//
// Replaces: benchmarks/dma_gather_probe.py, build_dma_gather (its Pallas
// kernel :62-100, which issues one async DMA per row with K_INFLIGHT = 8
// descriptors in flight) and the work of its XLA baseline build_xla_gather
// (:117-129).  Inputs table i32 [M, W] and idx i32 [N], N a multiple of
// kChunk = 2048; out[c] = sum over k in chunk c and w < W of
// table[idx[k], w], wrapping mod 2^32 as XLA's int32 sum does.  An index
// outside [0, M) is clamped into it (the plain version does the same).
//
// On the card the TPU's DMA pipeline has no counterpart to carry over: a
// warp's loads are the gather.  One block per chunk copies the chunk's
// 2048 indices into shared memory (8 KB, coalesced), then its threads
// stride over the chunk's (row, column) pairs in row-major order, so a
// warp reads whole rows: at W = 8 a row is one 32-byte sector and a warp
// reads four of them, at W = 128 a warp reads 128 contiguous bytes of one
// row.  Sums are uint32 (wrapping), reduced by warp shuffles and then
// across the block's warps in shared memory; thread 0 stores the chunk's
// sum.
//
// What bounds it on an H100: bytes, N * (4 + max(32, 4W)) (each row costs
// at least one 32-byte sector) against one add per element.  Built with
// the other kernels' flags.
#include "common.cuh"

namespace mnv {

constexpr int kChunk = 2048;
constexpr int kGatherBlock = 256;

__global__ void __launch_bounds__(kGatherBlock)
gather_chunk_sums_kernel(const int* __restrict__ table, long long M, int W,
                         const int* __restrict__ idx,
                         int* __restrict__ out) {
  __shared__ int rows[kChunk];
  __shared__ unsigned int partial[kGatherBlock / 32];
  const int c = blockIdx.x;
  const int* __restrict__ cidx = idx + static_cast<long long>(c) * kChunk;
  for (int k = threadIdx.x; k < kChunk; k += kGatherBlock) {
    long long i = cidx[k];
    i = i < 0 ? 0 : (i >= M ? M - 1 : i);
    rows[k] = static_cast<int>(i);
  }
  __syncthreads();

  unsigned int acc = 0u;
  const int n = kChunk * W;  // the wrapper caps W so that this fits
#pragma unroll 4
  for (int e = threadIdx.x; e < n; e += kGatherBlock) {
    const int k = e / W;
    const int w = e - k * W;
    acc += static_cast<unsigned int>(
        __ldg(table + static_cast<long long>(rows[k]) * W + w));
  }
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_down_sync(0xffffffffu, acc, off);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) partial[warp] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned int s = 0u;
    for (int i = 0; i < kGatherBlock / 32; ++i) s += partial[i];
    out[c] = static_cast<int>(s);
  }
}

}  // namespace mnv

extern "C" int gather_chunk_sums_launch(const void* table, long long M,
                                        int W, const void* idx, int n_chunks,
                                        void* out, void* stream) {
  mnv::gather_chunk_sums_kernel<<<n_chunks, mnv::kGatherBlock, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(table), M, W, static_cast<const int*>(idx),
      static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}
