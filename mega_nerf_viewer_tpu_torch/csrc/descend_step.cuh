// One step of the exact march, shared by the exact march (exact_march.cu)
// and the exact collect (exact_collect.cu): the octree descent at the
// ray's position and the DDA distance to the leaf's exit.
//
// The JAX package runs the same _descend in render_rays and
// collect_samples (render.py:49-92, guided.py:120-125); here both kernels
// call descend_step, the exact march with the restarted descent below and
// the exact collect with the descent from the root, which find the same
// leaf and in-leaf position bit for bit, so their trajectories are equal.
// Built with -fmad=false (see common.cuh): the only fused multiply-add is
// the position's __fmaf_rn.
//
// The descent from the root is a chain of dependent child reads, one per
// level.  For N = 2^b a step of the exact march restarts it at the deepest
// ancestor that the new position shares with the ray's previous path
// (descend_restart): the next leaf is almost always a close neighbour of
// the one just left, so a step re-walks one or two levels where the root
// descent walks them all (1.86 against 3.95 on the 1080p shell, PERF.md).
// The result is the root descent's bit for bit: multiplying by a power of
// two, floor and u - floor(u) are exact in f32, so the in-cell position at
// level l is exactly frac(p * N^l) and the level-l cell floor(p * N^l),
// whichever level the walk starts from.
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
  int b;                  // log2(N) when N = 2^b >= 2, else 0 (no restart)
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

// Levels of a path that a thread keeps (ops/render.py DEFAULT_MAX_LEVELS);
// a step after a deeper path descends from the root.
constexpr int kPathCap = 20;

// The state of the restart: the path of the ray's last descent, its chunk
// per level in a local array of the thread (a slice of shared memory
// measured slower, PERF.md).
struct DescendPath {
  int chunk[kPathCap];  // the chunk at each level walked; chunk[0] = 0
  int L;                // levels the last descent walked; 0: none to reuse
  float px, py, pz;     // the clipped position it descended at
};

// One level of the descent (render.py:_descend's body, reference
// rt_core.cuh:117-159): mark the chunk while the descent is not done (all
// writers store 1, so a plain store is enough; it is made only where the
// mark is still 0, since every ray passes the root and a store per level
// to the few hot lines serializes in L2), take the base-N digits of the
// in-cell position (fx, fy, fz) as the child slot, keep the position in
// that slot.  Returns the slot's offset: 0 is a leaf.
__device__ __forceinline__ int descend_level(const ExactTree& tr, int chunk,
                                             float& fx, float& fy, float& fz,
                                             int& cidx) {
  const int N = tr.N;
  const float Nf = (float)N, NNf = (float)(N * N);
  if (tr.visited != nullptr && chunk >= 0 && chunk < tr.n_visited &&
      tr.visited[chunk] == 0)
    tr.visited[chunk] = 1;
  const float ux = fx * Nf, uy = fy * Nf, uz = fz * Nf;
  const float gx = floorf(ux), gy = floorf(uy), gz = floorf(uz);
  const int idx = (int)(gx * NNf + gy * Nf + gz);
  fx = ux - gx;
  fy = uy - gy;
  fz = uz - gz;
  cidx = idx;
  return tr.child[clamp_index((long long)chunk * (N * N * N) + idx,
                              tr.n_child)];
}

// The descent from the root at the clipped position (fx, fy, fz): at most
// max_levels levels, each with descend_level; a 0 offset is a leaf.
// Returns the in-leaf position in (fx, fy, fz).
__device__ __forceinline__ void descend(const ExactTree& tr, float& fx,
                                        float& fy, float& fz, int& chunk,
                                        int& cidx, int& depth) {
  chunk = 0;
  cidx = 0;
  depth = 1;
  for (int l = 0; l < tr.max_levels; ++l) {
    const int skip = descend_level(tr, chunk, fx, fy, fz, cidx);
    if (skip == 0) return;
    chunk += skip;
    ++depth;
  }
}

// The descent at the clipped position (fx, fy, fz) restarted from the ray's
// last path (N = 2^b).  With key(p) = floor(p * N^L) per axis (L levels on
// the path), the level-l cells of p and q agree while the keys agree above
// their last b * (L - l) bits, so the deepest shared level is
// k = min(L - 1, L - ceil(bitlen(OR of key_p ^ key_q) / b)); the walk
// starts at path.chunk[k] with the position frac(q * N^k), exactly what the
// root descent holds there.  The ancestors above k were marked visited when
// the path first walked them, so only the levels walked are marked.  A ray's
// first step (L = 0) starts at the root; a path longer than kPathCap or
// whose key needs more than 31 bits is not kept (the next step starts at
// the root).  A descent cut at max_levels walks max_levels levels, as the
// root descent does, and keeps them as its path.
__device__ __forceinline__ void descend_restart(const ExactTree& tr,
                                                DescendPath& path, float& fx,
                                                float& fy, float& fz,
                                                int& chunk, int& cidx,
                                                int& depth) {
  const int b = tr.b;
  const float px = fx, py = fy, pz = fz;
  int k = 0;
  chunk = 0;
  if (path.L > 0) {
    const float s = pow2f(b * path.L);
    const unsigned x =
        ((unsigned)floorf(px * s) ^ (unsigned)floorf(path.px * s)) |
        ((unsigned)floorf(py * s) ^ (unsigned)floorf(path.py * s)) |
        ((unsigned)floorf(pz * s) ^ (unsigned)floorf(path.pz * s));
    const int bits = 32 - __clz(x);
    k = path.L - (b == 1 ? bits : (bits + b - 1) / b);
    if (k > path.L - 1) k = path.L - 1;
    const float sk = pow2f(b * k);
    const float ux = px * sk, uy = py * sk, uz = pz * sk;
    fx = ux - floorf(ux);
    fy = uy - floorf(uy);
    fz = uz - floorf(uz);
    chunk = path.chunk[k];
  }
  cidx = 0;
  depth = k + 1;
  int L = tr.max_levels;
  for (int l = k; l < tr.max_levels; ++l) {
    if (l < kPathCap) path.chunk[l] = chunk;
    const int skip = descend_level(tr, chunk, fx, fy, fz, cidx);
    if (skip == 0) {
      L = l + 1;
      break;
    }
    chunk += skip;
    ++depth;
  }
  path.L = (L <= kPathCap && b * L <= 31) ? L : 0;
  path.px = px;
  path.py = py;
  path.pz = pz;
}

// The step at ray parameter t (render.py:202-208): descend at the clipped
// cen + t * d, then the unit-cell exit of the in-leaf position scaled by
// N^-depth, plus step_size.  With kRestart (N = 2^b) the descent restarts
// from ``path`` and the exit is multiplied by the exact power 2^-(b*depth),
// which is the division's correctly rounded value without its
// instructions; otherwise the descent starts at the root and the exit is
// divided by ipowf(N, depth).
template <bool kRestart>
__device__ __forceinline__ DescendStep descend_step(
    const ExactTree& tr, DescendPath& path, float cx, float cy, float cz,
    float dx, float dy, float dz, float ix, float iy, float iz, float t,
    float step_size) {
  float fx = clip_pos(cx, t, dx), fy = clip_pos(cy, t, dy),
        fz = clip_pos(cz, t, dz);
  DescendStep s;
  if (kRestart)
    descend_restart(tr, path, fx, fy, fz, s.chunk, s.cidx, s.depth);
  else
    descend(tr, fx, fy, fz, s.chunk, s.cidx, s.depth);
  s.node = clamp_index((long long)s.chunk * (tr.N * tr.N * tr.N) + s.cidx,
                       tr.n_nodes);
  const float m =
      fminf(fminf(axis_t(fx, ix), axis_t(fy, iy)), axis_t(fz, iz));
  const int e = tr.b * s.depth;
  s.delta_t = (kRestart && e <= 126 ? fminf(1e4f, m) * pow2f(-e)
                                    : fminf(1e4f, m) / ipowf(tr.N, s.depth))
              + step_size;
  return s;
}

// log2(N) when N = 2^b >= 2, else 0: the restart needs the descent's
// arithmetic exact, which only a power of two gives.  MNV_ROOT_DESCENT
// builds the exact march as it was before the restart (the root descent for
// every N, 256-thread blocks), which probes/exact_breakdown.py times.
inline int restart_bits(int N) {
#ifdef MNV_ROOT_DESCENT
  return 0;
#endif
  int b = 0;
  while (b < 31 && (1 << b) < N) ++b;
  return (N >= 2 && (1 << b) == N) ? b : 0;
}

inline ExactTree exact_tree(
    const void* child, long long n_child, const void* data,
    long long n_nodes, int D, const void* counts, int N, int max_levels,
    void* visited, long long n_visited) {
  return ExactTree{static_cast<const int*>(child), n_child,
                   static_cast<const __half*>(data), n_nodes, D,
                   static_cast<const short*>(counts), N, restart_bits(N),
                   max_levels, static_cast<int*>(visited), n_visited};
}

}  // namespace mnv
