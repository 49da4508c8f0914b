// One step of the leaf-map march, shared by the fused render march
// (march.cu) and the guided collect march (collect.cu).
//
// The JAX package keeps the render and collect t trajectories bit-identical
// by running the same leaf resolution and step math in both loops
// (guided.py:415-418).  Here both kernels call march_step, so the
// trajectories are the same by construction.  Built with -fmad=false (see
// common.cuh): the only fused multiply-add is the position's __fmaf_rn.
#pragma once

#include "common.cuh"

namespace mnv {

// The tree and its leaf map as the march reads them.
struct LeafMapTree {
  const int* child;      // [n_child] i32 child offsets (N == 2)
  long long n_child;
  const __half* data;    // [n_nodes, D] f16, sigma in the last column
  long long n_nodes;
  int D;
  const int2* rows;      // [n_cells] (node, meta) leaf-map rows
  long long n_cells;
  int level;             // the map's level L (grid 2^L)
  int deep_levels;       // descent levels below L
};

// What one step found: the leaf's node, its depth and sigma, and the step
// length.
struct MarchStep {
  int node;
  int depth;
  float sigma;
  float delta_t;
};

__device__ __forceinline__ float half_bits_to_float(int bits) {
  return __half2float(__ushort_as_half(static_cast<unsigned short>(bits)));
}

__device__ __forceinline__ long long clampll(long long i, long long n) {
  return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

// The step at ray parameter t (accel.py:468-485, guided.py:413-425): the
// leaf-map row of the cell holding cen + t * d (plus the deep_levels
// descent through child, accel.leaf_lookup), then the DDA distance to the
// leaf's exit plus step_size.
__device__ __forceinline__ MarchStep march_step(
    const LeafMapTree& tr, float cx, float cy, float cz, float dx, float dy,
    float dz, float ix, float iy, float iz, float t, float step_size) {
  const int G = 1 << tr.level;
  const float Gf = (float)G;
  const float px = clip_pos(cx, t, dx);
  const float py = clip_pos(cy, t, dy);
  const float pz = clip_pos(cz, t, dz);

  const long long lin = ((long long)((int)floorf(px * Gf)) * G +
                         (int)floorf(py * Gf)) * G + (int)floorf(pz * Gf);
  const int2 row = tr.rows[clampll(lin, tr.n_cells)];
  int node = row.x;
  int depth = row.y & 31;
  float sigma = half_bits_to_float((row.y >> 16) & 0xFFFF);
  if (tr.deep_levels > 0 && (row.y & 32)) {
    float ux = px * Gf, uy = py * Gf, uz = pz * Gf;
    float fx = ux - floorf(ux), fy = uy - floorf(uy), fz = uz - floorf(uz);
    int chunk = node, cidx = 0;
    for (int k = 0; k <= tr.deep_levels; ++k) {
      const float u2x = fx * 2.0f, u2y = fy * 2.0f, u2z = fz * 2.0f;
      const float gx = floorf(u2x), gy = floorf(u2y), gz = floorf(u2z);
      const int idx2 = (int)(gx * 4.0f + gy * 2.0f + gz);
      const int skip =
          tr.child[clampll((long long)chunk * 8 + idx2, tr.n_child)];
      fx = u2x - gx;
      fy = u2y - gy;
      fz = u2z - gz;
      cidx = idx2;
      if (skip == 0) break;
      chunk += skip;
      ++depth;
    }
    node = chunk * 8 + cidx;
    sigma = __half2float(tr.data[clampll(node, tr.n_nodes) * tr.D +
                                 (tr.D - 1)]);
  }

  const float cube = pow2f(depth);
  MarchStep s;
  s.node = node;
  s.depth = depth;
  s.sigma = sigma;
  s.delta_t = leaf_exit(px, py, pz, cube, ix, iy, iz) + step_size;
  return s;
}

}  // namespace mnv
