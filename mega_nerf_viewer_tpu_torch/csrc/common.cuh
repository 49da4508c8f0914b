// Step math shared by the entry-skip prepass, the fused march, the guided
// collect march (the last two through march_step.cuh), the exact march and
// the exact collect (through descend_step.cuh), and the vote rule of the
// fused march, the exact march and the exact collect.
//
// They must advance a ray's t bit for bit alike, and alike to the plain
// PyTorch versions (ops/skip_prepass.py, ops/accel.py, ops/guided.py) and
// the JAX reference.  They are built with -fmad=false, so every f32 op below
// rounds on its own, except the position cen + t * d, which the JAX
// reference computes as one fused multiply-add and which is therefore an
// explicit __fmaf_rn here (ops/fp.py:fma_f32 is its plain counterpart).
#pragma once

#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace mnv {

// threads per block of both kernels (utils/tuning.py MARCH_BLOCK)
constexpr int kBlock = 256;
// clip bound of tree-space positions, f32(1 - 1e-6)
constexpr float kEpsHi = (float)(1.0 - 1e-6);

__device__ __forceinline__ float clip_pos(float cen, float t, float d) {
  return fminf(fmaxf(__fmaf_rn(t, d, cen), 0.0f), kEpsHi);
}

// 2^depth, exact (ops/fp.py:pow2_f32)
__device__ __forceinline__ float pow2f(int depth) {
  return __int_as_float((depth + 127) << 23);
}

// exit distance along one axis of the unit cell (rt_core.cuh:89-100)
__device__ __forceinline__ float axis_t(float frac, float inv) {
  float t1 = -frac * inv;
  float t2 = t1 + inv;
  return fmaxf(t1, t2);
}

// distance to the exit of the leaf cube of side 2^-depth holding (px,py,pz)
__device__ __forceinline__ float leaf_exit(float px, float py, float pz,
                                           float cube, float ix, float iy,
                                           float iz) {
  float ux = px * cube, uy = py * cube, uz = pz * cube;
  float fx = ux - floorf(ux), fy = uy - floorf(uy), fz = uz - floorf(uz);
  float m = fminf(fminf(axis_t(fx, ix), axis_t(fy, iy)), axis_t(fz, iz));
  return fminf(1e4f, m) / cube;
}

__device__ __forceinline__ int cell_index(float px, float py, float pz,
                                          int grid) {
  float g = (float)grid;
  int cx = (int)floorf(px * g), cy = (int)floorf(py * g),
      cz = (int)floorf(pz * g);
  return (cx * grid + cy) * grid + cz;
}

// The split and sample votes of one ray (render.py:217-236, reference
// rt_core.cuh:237-252): [priority, chunk, child] of the dense sample of
// largest weight, strictly larger than the best so far, and while the ray
// has none, of every sample it passes (max_w == -1).  The split vote's
// priority is the leaf depth, the sample vote's the leaf's sample count.
struct Votes {
  float s0, s1, s2, p0, p1, p2;
  float max_w, max_sw;
};

__device__ __forceinline__ Votes votes_init(int max_depth,
                                            int max_sample_count) {
  return Votes{(float)(max_depth + 1), -1.0f, -1.0f,
               (float)(max_sample_count + 1), -1.0f, -1.0f, -1.0f, -1.0f};
}

// One step of an active ray; ``weight`` is read only when ``dense``.
__device__ __forceinline__ void vote_step(Votes& v, bool dense, float weight,
                                          int depth, int chunk, int cidx,
                                          int sc, int max_depth,
                                          int max_sample_count) {
  const bool can_split = depth < max_depth;
  const bool can_sample = sc < max_sample_count;
  const bool vs = can_split && (dense ? weight > v.max_w : v.max_w == -1.0f);
  const bool vp =
      can_sample && (dense ? weight > v.max_sw : v.max_sw == -1.0f);
  if (vs) {
    v.s0 = (float)depth;
    v.s1 = (float)chunk;
    v.s2 = (float)cidx;
  }
  if (vp) {
    v.p0 = (float)sc;
    v.p1 = (float)chunk;
    v.p2 = (float)cidx;
  }
  if (dense && can_split && weight > v.max_w) v.max_w = weight;
  if (dense && can_sample && weight > v.max_sw) v.max_sw = weight;
}

__device__ __forceinline__ void votes_store(const Votes& v, int r,
                                            float* __restrict__ sv,
                                            float* __restrict__ pv) {
  sv[3 * r] = v.s0;
  sv[3 * r + 1] = v.s1;
  sv[3 * r + 2] = v.s2;
  pv[3 * r] = v.p0;
  pv[3 * r + 1] = v.p1;
  pv[3 * r + 2] = v.p2;
}

}  // namespace mnv
