// One step of the exact march, shared by the exact march (exact_march.cu)
// and the exact collect (exact_collect.cu): the octree descent from the
// root at the ray's position and the DDA distance to the leaf's exit.
//
// The JAX package runs the same _descend in render_rays and
// collect_samples (render.py:49-92, guided.py:120-125); here both kernels
// call descend_step, so their trajectories are the same by construction.
// Built with -fmad=false (see common.cuh): the only fused multiply-add is
// the position's __fmaf_rn.
#pragma once

#include "common.cuh"

namespace mnv {

// The tree as the exact march reads it (any N), and the visit tracker.
struct ExactTree {
  const int* child;       // [n_child] i32 child offsets, 0 = leaf
  long long n_child;
  const __half* data;     // [n_nodes, D] f16, sigma in the last column
  long long n_nodes;
  int D;
  const short* counts;    // [n_nodes] i16 sample counts
  int N;                  // branching per axis
  int max_levels;         // levels one descent walks at most
  int* visited;           // [n_visited] i32 visit marks, or null
  long long n_visited;
};

// What one step found: the leaf (chunk, cidx, depth), the node, and the
// step length.
struct DescendStep {
  int chunk, cidx, depth;
  long long node;         // chunk * N^3 + cidx, clamped into the data
  float delta_t;
};

__device__ __forceinline__ long long clamp_index(long long i, long long n) {
  return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

// N^e for e >= 0, rounded once to f32 (ops/fp.py:ipow_f32): exact bits for
// N == 2, a double product otherwise (exact below 2^53).
__device__ __forceinline__ float ipowf(int N, int e) {
  if (N == 2) return pow2f(e);
  double c = 1.0;
  for (int i = 0; i < e; ++i) c *= (double)N;
  return (float)c;
}

// The descent from the root at the clipped position (px, py, pz)
// (render.py:_descend, reference rt_core.cuh:117-159): per level the base-N
// digits of the position select the child slot; a 0 offset is a leaf.
// While the descent is not done the current chunk is marked in
// tr.visited (all writers store 1, so a plain store is enough; it is made
// only where the mark is still 0, since every ray passes the root and a
// store per level to the few hot lines serializes in L2).  Returns the
// in-leaf position in (fx, fy, fz).
__device__ __forceinline__ void descend(const ExactTree& tr, float& fx,
                                        float& fy, float& fz, int& chunk,
                                        int& cidx, int& depth) {
  const int N = tr.N;
  const int N3 = N * N * N;
  const float Nf = (float)N, NNf = (float)(N * N);
  chunk = 0;
  cidx = 0;
  depth = 1;
  for (int l = 0; l < tr.max_levels; ++l) {
    if (tr.visited != nullptr && chunk >= 0 && chunk < tr.n_visited &&
        tr.visited[chunk] == 0)
      tr.visited[chunk] = 1;
    const float ux = fx * Nf, uy = fy * Nf, uz = fz * Nf;
    const float gx = floorf(ux), gy = floorf(uy), gz = floorf(uz);
    const int idx = (int)(gx * NNf + gy * Nf + gz);
    const int skip =
        tr.child[clamp_index((long long)chunk * N3 + idx, tr.n_child)];
    fx = ux - gx;
    fy = uy - gy;
    fz = uz - gz;
    cidx = idx;
    if (skip == 0) return;
    chunk += skip;
    ++depth;
  }
}

// The step at ray parameter t (render.py:202-208): descend at the clipped
// cen + t * d, then the unit-cell exit of the in-leaf position scaled by
// N^-depth, plus step_size.
__device__ __forceinline__ DescendStep descend_step(
    const ExactTree& tr, float cx, float cy, float cz, float dx, float dy,
    float dz, float ix, float iy, float iz, float t, float step_size) {
  float fx = clip_pos(cx, t, dx), fy = clip_pos(cy, t, dy),
        fz = clip_pos(cz, t, dz);
  DescendStep s;
  descend(tr, fx, fy, fz, s.chunk, s.cidx, s.depth);
  s.node = clamp_index((long long)s.chunk * (tr.N * tr.N * tr.N) + s.cidx,
                       tr.n_nodes);
  const float m =
      fminf(fminf(axis_t(fx, ix), axis_t(fy, iy)), axis_t(fz, iz));
  s.delta_t = fminf(1e4f, m) / ipowf(tr.N, s.depth) + step_size;
  return s;
}

inline ExactTree exact_tree(
    const void* child, long long n_child, const void* data,
    long long n_nodes, int D, const void* counts, int N, int max_levels,
    void* visited, long long n_visited) {
  return ExactTree{static_cast<const int*>(child), n_child,
                   static_cast<const __half*>(data), n_nodes, D,
                   static_cast<const short*>(counts), N, max_levels,
                   static_cast<int*>(visited), n_visited};
}

}  // namespace mnv
