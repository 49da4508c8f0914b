// Entry-skip prepass: advance each ray's start t through entry empty space.
//
// Replaces: mega_nerf_viewer_tpu/ops/pallas_march.py, the Pallas kernel
// _prepass_kernel (entry_skip_prepass).  Same result: the t at which the
// march reaches its first cell that is not an empty leaf of depth <= 6
// (bit-equal to the march's own t there), and the number of steps taken.
//
// What bounds it on an H100: by the usual count, the rays' own bytes.  Each
// ray reads d and invdir (24 B), tmin, tmax (8 B) and live (1 B) and writes
// t and the count (8 B); the table is 40 KB.  At 1080p that is ~85 MB,
// ~25 us at 3.35 TB/s, against ~13.7M steps of a few dozen f32 ops, ~10 us
// at the f32 FMA rate.  What holds it above that: the instructions of each
// step, whose float-to-int conversions and roundings (cell indices, the
// exit distance's floors) issue at a quarter of the FMA rate, and the lanes
// of a warp that idle once their ray has stopped while the slowest ray of
// the 32 still walks.
//
// Design, from the time breakdown of probes/prepass_breakdown.py: one
// thread per ray in 256-thread blocks, no shared memory.  The first design
// copied the 40 KB table into shared memory in every block (8,104 copies,
// 332 MB through L2 at 1080p), which took most of its time; a persistent
// grid that copies it once per resident block measured slower than no
// copy at all, as did the other persistent forms PERF.md lists (TMA bulk
// copies, a ray counter, lanes that refill from a pool).  So the table is
// read in place through the read-only data cache (__ldg): it comes from
// device memory into L2 once and into an SM's L1 while it stays resident
// there, and the block scheduler balances the rays' uneven step counts.  The step is the
// march's, unchanged (clip_pos, cell_index, leaf_exit, pow2f from
// common.cuh; -fmad=false and one __fmaf_rn in cen + t * d), so t stays
// bit-equal to the march it skips for.  The three planes (layout in
// ops/skip_prepass.py) are read by index, in place of the TPU kernel's
// broadcast + lane-gather + select chain, and level 6 only on the steps
// where levels 4 and 5 did not skip.
#include "common.cuh"

namespace mnv {

constexpr int kBase5 = 8 * 128;
constexpr int kBase6 = 16 * 128;

__global__ void __launch_bounds__(kBlock)
skip_prepass_kernel(const int* __restrict__ table,
                    const float* __restrict__ cen,
                    const float* __restrict__ d,
                    const float* __restrict__ invdir,
                    const float* __restrict__ tmin,
                    const float* __restrict__ tmax,
                    const bool* __restrict__ live, float step_size, int R,
                    float* __restrict__ t_out, int* __restrict__ skips_out) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const float cx = cen[0], cy = cen[1], cz = cen[2];
  const float dx = d[3 * r], dy = d[3 * r + 1], dz = d[3 * r + 2];
  const float ix = invdir[3 * r], iy = invdir[3 * r + 1],
              iz = invdir[3 * r + 2];
  const float tm = tmax[r];
  float t = tmin[r];
  int cnt = 0;
  bool active = live[r] && t < tm;
  while (active) {
    const float px = clip_pos(cx, t, dx);
    const float py = clip_pos(cy, t, dy);
    const float pz = clip_pos(cz, t, dz);
    const int idx4 = cell_index(px, py, pz, 16);
    const int nib = (__ldg(table + (idx4 >> 3)) >> ((idx4 & 7) * 4)) & 15;
    const bool skip4 = (nib & 8) != 0;
    const int idx5 = cell_index(px, py, pz, 32);
    const bool bit5 =
        ((__ldg(table + kBase5 + (idx5 >> 5)) >> (idx5 & 31)) & 1) != 0;
    bool bit6 = false;
    if (!skip4 && !bit5) {
      const int idx6 = cell_index(px, py, pz, 64);
      bit6 = ((__ldg(table + kBase6 + (idx6 >> 5)) >> (idx6 & 31)) & 1) != 0;
    }
    if (!(skip4 || bit5 || bit6)) break;
    const int depth = skip4 ? (nib & 7) : (bit5 ? 5 : 6);
    const float delta =
        leaf_exit(px, py, pz, pow2f(depth), ix, iy, iz) + step_size;
    t = t + delta;
    ++cnt;
    active = t < tm;
  }
  t_out[r] = t;
  skips_out[r] = cnt;
}

}  // namespace mnv

extern "C" int skip_prepass_launch(const void* table, const void* cen,
                                   const void* d, const void* invdir,
                                   const void* tmin, const void* tmax,
                                   const void* live, float step_size, int R,
                                   void* t_out, void* skips_out,
                                   void* stream) {
  const int grid = (R + mnv::kBlock - 1) / mnv::kBlock;
  mnv::skip_prepass_kernel<<<grid, mnv::kBlock, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(table), static_cast<const float*>(cen),
      static_cast<const float*>(d), static_cast<const float*>(invdir),
      static_cast<const float*>(tmin), static_cast<const float*>(tmax),
      static_cast<const bool*>(live), step_size, R,
      static_cast<float*>(t_out), static_cast<int*>(skips_out));
  return static_cast<int>(cudaGetLastError());
}
