// Step math shared by the entry-skip prepass, the fused march and the
// guided collect march (the last two through march_step.cuh).
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

}  // namespace mnv
