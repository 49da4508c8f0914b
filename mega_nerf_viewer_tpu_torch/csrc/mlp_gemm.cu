// Fused per-cluster product of Mega-NeRF's submodules:
// out[g, r, col0 + j] = act(sum_k A[g, r, k] W[c, k, j] + b[c, j]),
// c = cids[g], in full f32 on the CUDA cores.
//
// Replaces no TPU kernel: the JAX package leaves the model's products to
// XLA (mega_nerf_viewer_tpu/models/meganerf.py), and the port's first
// version ran each layer as cuBLAS's batched product with a broadcast bias
// (torch.baddbmm over weights gathered per group), then a ReLU pass, with
// a concatenation before the skip layer, the colour branch and the output.
// Those passes moved about as many bytes as the products took time.  This
// kernel does one layer in one pass: the rows come as G groups of n rows,
// each group one cluster's (a cluster-pure chunk of the chunked route, or
// the whole batch once per cluster on the all-clusters route), a block's
// 128 rows never leave their group, so the block reads its cluster id once
// and its weights and bias in place in the stacked [C, K, N] and [C, N]
// buffers.  The K loop reads the first k1 columns of A from one tensor and
// the rest from a second one (the skip layer's [encoding, hidden]), or
// from the cluster's appearance table at each row's clamped id (the colour
// branch's [features, appearance]).  The bias and the ReLU are applied in
// registers, and the output goes to a column window of a wider row (the
// rgb and sigma heads write columns 0-11 and 12 of the model's output).
//
// What bounds it on an H100: operations.  A 256-wide layer does 2 x 256
// operations a row for each 4-byte output column and 1 KB of input, 64
// operations a byte, three times the f32 ridge (67 TFLOP/s over 3.35 TB/s);
// f32 at the reference's precision has no tensor-core path.  Design: the
// register-tiled product.  A block computes a 128 x 128 tile with 256
// threads, each an 8 x 8 register tile as two row groups of 4, 64 rows
// apart, and two column groups of 4, 64 columns apart (heads of at most 16
// columns: a 128 x 16 tile, 128 threads of 16 x 1, row groups 32 apart),
// so that each k step reads its A and B fragments as float4s from shared
// memory, a warp's threads touching one 64-byte and one 128-byte span with
// no bank conflicts.  K is staged 16 at a time through a ring of three
// shared buffers filled by cp.async, two slices in flight while one is
// multiplied, one barrier a slice: A transposed ([k][m], rows padded by 4)
// by 4-byte copies, which also gather the appearance rows and split the
// two sources at any k1, and B by 16-byte copies where its rows allow.
// Rows past n, K's tail and columns past N are zero-filled.  Each output
// is one sequential sum of explicit __fmaf_rn over k (the build's
// -fmad=false leaves explicit FMAs alone), then + bias, stored as float4s
// where the output's row allows.
#include <cuda_runtime.h>

#include <atomic>

namespace mnv {

constexpr int kGemmBM = 128;
constexpr int kGemmBK = 16;
constexpr int kGemmStages = 3;
constexpr int kGemmPad = 4;

struct MlpGemmArgs {
  const float* a1;    // [Ga, n, lda1]: A's first k1 columns
  long long a1_g;     // a1's group stride (0: shared by every group)
  int lda1, k1;
  const float* a2;    // [Gb, n, lda2], or the [C, n_app, lda2] table
  long long a2_g;     // a2's group stride (not read with a table)
  int lda2;
  const float* ids;   // f32 appearance ids, or null (a2 is then not a table)
  long long ids_g, ids_r;  // their group and row strides
  int n_app;
  int k;              // k1 + the second source's columns
  const long long* cids;
  int n_clusters;
  int n;              // rows a group
  const float* w;     // [C, k, n_out]
  const float* b;     // [C, n_out]
  int n_out;
  int relu;
  float* out;         // [G, n, ldo], columns col0 .. col0 + n_out
  long long out_g;
  int ldo, col0;
  int vec_w, vec_out;  // w's rows, out's rows and bias in float4s
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 16 : 0));
}

// BN columns a block of NT threads, each TM rows (groups of 4) by TN
// columns (groups of 4, or 1)
template <int BN, int TM, int TN, int NT>
__global__ void __launch_bounds__(NT, 2)
mlp_gemm_kernel(const MlpGemmArgs p) {
  constexpr int BM = kGemmBM, BK = kGemmBK, S = kGemmStages;
  constexpr int TX = BN / TN;                 // threads along the columns
  static_assert((BM / TM) * TX == NT, "the threads cover the tile");
  constexpr int WX = TN == 1 ? 16 : 8;        // a warp's lanes along them
  constexpr int WY = 32 / WX;
  constexpr int RG = BM / (TM / 4);           // row group spacing
  constexpr int CG = TN >= 4 ? BN / (TN / 4) : 1;
  constexpr int LA = BM * BK / NT;            // A copies a thread a slice
  constexpr int MS = NT / BK;                 // their row step
  constexpr int ASZ = BK * (BM + kGemmPad), BSZ = BK * BN;
  extern __shared__ __align__(16) float smem[];
  float* As = smem;                           // [S][BK][BM + pad]
  float* Bs = smem + S * ASZ;                 // [S][BK][BN]
  __shared__ int off2[BM];

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int ty = (warp / (TX / WX)) * WY + lane / WX;
  const int tx = (warp % (TX / WX)) * WX + lane % WX;

  const int g = blockIdx.z;
  long long c = p.cids[g];
  c = c < 0 ? 0 : (c >= p.n_clusters ? p.n_clusters - 1 : c);
  const int row0 = blockIdx.y * BM;
  const int col_base = blockIdx.x * BN;
  const int rows = p.n - row0;                // rows of this tile: min(., BM)
  const float* a1 =
      p.a1 + g * p.a1_g + static_cast<long long>(row0) * p.lda1;
  const float* a2 = p.ids ? p.a2 + c * p.n_app * p.lda2 : p.a2 + g * p.a2_g;
  const float* w = p.w + c * p.k * p.n_out;
  const float* bias = p.b + c * p.n_out;

  // each row's offset into the second source
  for (int m = tid; m < BM; m += NT) {
    const int r = row0 + m;
    int o = 0;
    if (r < p.n) {
      if (p.ids) {
        long long v = static_cast<long long>(
            p.ids[g * p.ids_g + static_cast<long long>(r) * p.ids_r]);
        v = v < 0 ? 0 : (v >= p.n_app ? p.n_app - 1 : v);
        o = static_cast<int>(v) * p.lda2;
      } else {
        o = r * p.lda2;
      }
    }
    off2[m] = o;
  }
  __syncthreads();

  // copy K slice t into buffer t % S; a zero-filled copy reads nothing,
  // and is given a valid address all the same
  const int ka = tid % BK, ma = tid / BK;
  auto issue = [&](int t) {
    const int k0 = t * BK;
    float* as = As + (t % S) * ASZ + ka * (BM + kGemmPad) + ma;
    float* bs = Bs + (t % S) * BSZ;
    const int kg = k0 + ka;
    if (kg < p.k1) {
      const float* src = a1 + static_cast<long long>(ma) * p.lda1 + kg;
#pragma unroll
      for (int i = 0; i < LA; ++i) {
        const bool ok = ma + MS * i < rows;
        cp_async4(as + MS * i,
                  ok ? src + static_cast<long long>(MS * i) * p.lda1 : p.w,
                  ok);
      }
    } else {
      const bool in = kg < p.k;
      const float* src = a2 + (kg - p.k1);
#pragma unroll
      for (int i = 0; i < LA; ++i) {
        const bool ok = in && ma + MS * i < rows;
        cp_async4(as + MS * i, ok ? src + off2[ma + MS * i] : p.w, ok);
      }
    }
    if (TN >= 4 && p.vec_w) {
#pragma unroll
      for (int i = 0; i < BSZ / 4 / NT; ++i) {
        const int e = tid + i * NT;
        const int kb = e / (BN / 4), c4 = (e % (BN / 4)) * 4;
        const bool ok = k0 + kb < p.k && col_base + c4 < p.n_out;
        cp_async16(bs + kb * BN + c4,
                   ok ? w + static_cast<long long>(k0 + kb) * p.n_out +
                            col_base + c4
                      : p.w,
                   ok);
      }
    } else {
      for (int e = tid; e < BSZ; e += NT) {
        const int kb = e / BN, cc = e % BN;
        const bool ok = k0 + kb < p.k && col_base + cc < p.n_out;
        cp_async4(bs + e,
                  ok ? w + static_cast<long long>(k0 + kb) * p.n_out +
                           col_base + cc
                     : p.w,
                  ok);
      }
    }
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  const int nk = (p.k + BK - 1) / BK;
#pragma unroll
  for (int t = 0; t < S - 1; ++t) {
    if (t < nk) issue(t);
    asm volatile("cp.async.commit_group;\n" ::);
  }
  for (int t = 0; t < nk; ++t) {
    // slice t has landed, and every thread is done with slice t - 1,
    // whose buffer the copies of slice t + S - 1 now fill
    asm volatile("cp.async.wait_group %0;\n" ::"n"(S - 2));
    __syncthreads();
    if (t + S - 1 < nk) issue(t + S - 1);
    asm volatile("cp.async.commit_group;\n" ::);
    const float* as = As + (t % S) * ASZ + ty * 4;
    const float* bs = Bs + (t % S) * BSZ + (TN >= 4 ? tx * 4 : tx);
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int q = 0; q < TM / 4; ++q) {
        const float4 v = *reinterpret_cast<const float4*>(
            as + kk * (BM + kGemmPad) + q * RG);
        a[4 * q] = v.x; a[4 * q + 1] = v.y; a[4 * q + 2] = v.z;
        a[4 * q + 3] = v.w;
      }
      if constexpr (TN >= 4) {
#pragma unroll
        for (int q = 0; q < TN / 4; ++q) {
          const float4 v =
              *reinterpret_cast<const float4*>(bs + kk * BN + q * CG);
          b[4 * q] = v.x; b[4 * q + 1] = v.y; b[4 * q + 2] = v.z;
          b[4 * q + 3] = v.w;
        }
      } else {
        b[0] = bs[kk * BN];
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j)
          acc[i][j] = __fmaf_rn(a[i], b[j], acc[i][j]);
    }
  }

  float* out = p.out + g * p.out_g + p.col0;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = (i / 4) * RG + ty * 4 + (i & 3);
    if (m >= rows) continue;
    float* o = out + static_cast<long long>(row0 + m) * p.ldo;
    if (TN >= 4 && p.vec_out) {
#pragma unroll
      for (int q = 0; q < TN / 4; ++q) {
        const int col = col_base + q * CG + tx * 4;
        if (col < p.n_out) {
          const float4 bb = __ldg(reinterpret_cast<const float4*>(bias + col));
          float v[4] = {acc[i][4 * q] + bb.x, acc[i][4 * q + 1] + bb.y,
                        acc[i][4 * q + 2] + bb.z, acc[i][4 * q + 3] + bb.w};
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (p.relu && v[j] < 0.0f) v[j] = 0.0f;
          *reinterpret_cast<float4*>(o + col) =
              make_float4(v[0], v[1], v[2], v[3]);
        }
      }
      continue;
    }
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col =
          col_base + (TN >= 4 ? (j / 4) * CG + tx * 4 + (j & 3) : tx);
      if (col < p.n_out) {
        const float v = acc[i][j] + __ldg(bias + col);
        o[col] = p.relu && v < 0.0f ? 0.0f : v;
      }
    }
  }
}

template <int BN, int TM, int TN, int NT>
int launch(const MlpGemmArgs& p, int groups, cudaStream_t stream) {
  constexpr int smem =
      kGemmStages * kGemmBK * (kGemmBM + kGemmPad + BN) * sizeof(float);
  // above 48 KB the kernel has to be allowed its shared memory: once a
  // device (a bit each of the first 64, set after the call succeeds)
  static std::atomic<unsigned long long> allowed{0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (!(allowed.load(std::memory_order_acquire) & bit)) {
    e = cudaFuncSetAttribute(mlp_gemm_kernel<BN, TM, TN, NT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    allowed.fetch_or(bit, std::memory_order_release);
  }
  const dim3 grid((p.n_out + BN - 1) / BN, (p.n + kGemmBM - 1) / kGemmBM,
                  groups);
  mlp_gemm_kernel<BN, TM, TN, NT><<<grid, NT, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace mnv

extern "C" int mlp_gemm_launch(
    const void* a1, long long a1_g, int lda1, int k1, const void* a2,
    long long a2_g, int lda2, const void* ids, long long ids_g,
    long long ids_r, int n_app, int k, const void* cids, int n_clusters,
    int groups, int n, const void* w, const void* b, int n_out, int relu,
    void* out, long long out_g, int ldo, int col0, void* stream) {
  mnv::MlpGemmArgs p;
  p.a1 = static_cast<const float*>(a1);
  p.a1_g = a1_g;
  p.lda1 = lda1;
  p.k1 = k1;
  p.a2 = static_cast<const float*>(a2);
  p.a2_g = a2_g;
  p.lda2 = lda2;
  p.ids = static_cast<const float*>(ids);
  p.ids_g = ids_g;
  p.ids_r = ids_r;
  p.n_app = n_app;
  p.k = k;
  p.cids = static_cast<const long long*>(cids);
  p.n_clusters = n_clusters;
  p.n = n;
  p.w = static_cast<const float*>(w);
  p.b = static_cast<const float*>(b);
  p.n_out = n_out;
  p.relu = relu;
  p.out = static_cast<float*>(out);
  p.out_g = out_g;
  p.ldo = ldo;
  p.col0 = col0;
  const auto aligned = [](const void* q) {
    return reinterpret_cast<unsigned long long>(q) % 16 == 0;
  };
  p.vec_w = n_out % 4 == 0 && aligned(w);
  p.vec_out = p.vec_w && aligned(b) && ldo % 4 == 0 && col0 % 4 == 0 &&
              aligned(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return n_out > 16 ? mnv::launch<128, 8, 8, 256>(p, groups, s)
                    : mnv::launch<16, 16, 1, 128>(p, groups, s);
}
