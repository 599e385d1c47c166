// The warp-wide chunk walk shared by the flash kernel (flash_intersect.cu)
// and the margin kernel (flash_margins.cu): one ray per group of TW_G
// lanes, the group's lanes spread over a chunk's triangles.
//
// A launch of the differentiable path carries few rays (4,096 per bounce
// of the pose step): one thread per ray fills 32 blocks of the card's 132
// SMs, and each thread walks its chunks and their 128 triangles serially,
// one dependent L2 read after another. Here a ray's TW_G lanes
//
// 1. share out the chunk slab tests (lane k tests chunks k, k + TW_G, ...)
//    and ballot the reached ones into a mask per window of TW_G chunks,
//    keeping each reached chunk's entry distance `near` in its lane;
// 2. visit the reached chunks in packed order; in each, lane l tests
//    triangles l, l + TW_G, ... (TW_ROWS of them), so a warp's loads of a
//    plane row are coalesced;
// 3. combine their per-lane bests by a shuffle reduction on (value, packed
//    position).
//
// Why the reduction gives the sequential scan's result. The sequential scan
// (the plain PyTorch versions, flash_intersect_plain and
// flash_margin_select_plain) takes a candidate when its value strictly
// beats the running best, so it returns the first candidate, in packed
// order, of the best value. Each lane scans its own
// triangles in increasing packed position (chunks in packed order, rows in
// order) with the same strict compare, so it holds the first of its own
// best. A float compare is exact, and the reduction orders (value, position)
// lexicographically, a total order on the lanes' bests: it returns the best
// value and, among the lanes holding it, the least position, which is the
// first in packed order. Every test of the scan is applied unchanged, in the
// same arithmetic (the sources build with -fmad=false), so the candidates
// and their values are bit for bit the scan's.
//
// A ray has a whole warp, TW_G = 32 lanes, and a lane reads all its TW_ROWS
// = 4 rows of a chunk in each of the two stages, with its registers
// uncapped: as measured (PERF.md, section 6), 16 or 8 lanes a ray, fewer
// rows a stage and a register cap were each slower in the pose step.

#pragma once

#include <climits>
#include <cooperative_groups.h>

#include "tri_winner.cuh"

namespace zr {

namespace cg = cooperative_groups;

constexpr int TW_G = 32;  // lanes per ray
constexpr int TW_ROWS = TW_LANE / TW_G;  // triangles per lane in a chunk
constexpr int TW_NONE = INT_MAX;  // packed position of "no candidate"

using TwGroup = cg::thread_block_tile<TW_G>;

// The slab test of tw_reach, returning the entry and exit distances.
__device__ __forceinline__ void tw_slab(const float* lo, const float* hi, const TwRay& r,
                                        float& near, float& far) {
  const float ax = (lo[0] - r.ox) * r.ix, bx = (hi[0] - r.ox) * r.ix;
  const float ay = (lo[1] - r.oy) * r.iy, by = (hi[1] - r.oy) * r.iy;
  const float az = (lo[2] - r.oz) * r.iz, bz = (hi[2] - r.oz) * r.iz;
  near = fmaxf(fmaxf(fminf(ax, bx), fminf(ay, by)), fminf(az, bz));
  far = fminf(fminf(fmaxf(ax, bx), fmaxf(ay, by)), fmaxf(az, bz));
}

// Visit, in packed order, every chunk whose box the ray reaches within
// (t_min, cap()]: visit(c) for each. DILATE widens each box (C, 8) on every
// side by half its extent plus 1e-3, with the arithmetic of
// ops/flash_intersect.py dilated_bounds. cap() is read for the ballot of a
// window of TW_G chunks and again before each visit: where it shrinks
// between the two (the flash winner's running t_best), the second read
// culls as tw_reach would at that point of the sequential walk, since a
// chunk reached at the lower cap was reached at the higher one. slabs
// counts this lane's slab tests.
template <bool DILATE, class Cap, class Visit>
__device__ __forceinline__ void tw_group_walk(const TwGroup& g, const float* __restrict__ bounds,
                                              int n_chunks, const TwRay& r, float t_min,
                                              Cap cap, Visit visit,
                                              unsigned long long& slabs) {
  const int lane = g.thread_rank();
  for (int c0 = 0; c0 < n_chunks; c0 += TW_G) {
    float near = 0.0f;
    bool reach = false;
    if (c0 + lane < n_chunks) {
      const float* box = bounds + (size_t)(c0 + lane) * 8;
      float lo[3], hi[3];
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        lo[a] = __ldg(box + a);
        hi[a] = __ldg(box + 3 + a);
        if (DILATE) {
          const float pad = 0.5f * (hi[a] - lo[a]) + 1e-3f;
          lo[a] = lo[a] - pad;
          hi[a] = hi[a] + pad;
        }
      }
      float far;
      tw_slab(lo, hi, r, near, far);
      reach = near <= far && far > t_min && near <= cap();
      ++slabs;
    }
    for (unsigned mask = g.ballot(reach); mask; mask &= mask - 1) {
      const int k = __ffs(mask) - 1;
      if (g.shfl(near, k) <= cap()) visit(c0 + k);
    }
  }
}

// The TW_ROWS rows of a lane in one chunk (triangles base, base + TW_G,
// ...), tested in two stages whose plane reads are each issued for every
// row before any is used: a chain of dependent reads per test, as one
// thread per ray had, left the walk waiting on memory.
//
// Stage 1: det and t of every row (normal and a.fn; arithmetic of
// tri_winner.cuh: det = -(d.fn), t = (o.fn - a.fn) / det). inv is 1 / det;
// rows with det < 1e-6 are dropped by the caller, their t unused.
__device__ __forceinline__ void tw_rows_t(const float* __restrict__ base, size_t stride,
                                          const TwRay& r, float (&det)[TW_ROWS],
                                          float (&inv)[TW_ROWS], float (&t)[TW_ROWS]) {
  float f[TW_ROWS][4];
#pragma unroll
  for (int row = 0; row < TW_ROWS; ++row) {
    const float* q = base + row * TW_G;
    f[row][0] = __ldg(q + P_FNX * stride);
    f[row][1] = __ldg(q + P_FNY * stride);
    f[row][2] = __ldg(q + P_FNZ * stride);
    f[row][3] = __ldg(q + P_ADF * stride);
  }
#pragma unroll
  for (int row = 0; row < TW_ROWS; ++row) {
    det[row] = -(r.dx * f[row][0] + r.dy * f[row][1] + r.dz * f[row][2]);
    inv[row] = 1.0f / det[row];
    t[row] = (r.ox * f[row][0] + r.oy * f[row][1] + r.oz * f[row][2] - f[row][3]) * inv[row];
  }
}

// Stage 2: u and v of the rows where use[row] (from o x d, e2, e2 x a, e1
// and e1 x a, in tri_winner.cuh's order).
__device__ __forceinline__ void tw_rows_uv(const float* __restrict__ base, size_t stride,
                                           const TwRay& r, const bool (&use)[TW_ROWS],
                                           const float (&inv)[TW_ROWS], float (&u)[TW_ROWS],
                                           float (&v)[TW_ROWS]) {
  float e[TW_ROWS][12];
#pragma unroll
  for (int row = 0; row < TW_ROWS; ++row) {
    if (!use[row]) continue;
    const float* q = base + row * TW_G;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      e[row][k] = __ldg(q + (P_E2X + k) * stride);
      e[row][3 + k] = __ldg(q + (P_QAX + k) * stride);
      e[row][6 + k] = __ldg(q + (P_E1X + k) * stride);
      e[row][9 + k] = __ldg(q + (P_RAX + k) * stride);
    }
  }
#pragma unroll
  for (int row = 0; row < TW_ROWS; ++row) {
    if (!use[row]) continue;
    u[row] = (r.px * e[row][0] + r.py * e[row][1] + r.pz * e[row][2] -
              (r.dx * e[row][3] + r.dy * e[row][4] + r.dz * e[row][5])) *
             inv[row];
    v[row] = -(r.px * e[row][6] + r.py * e[row][7] + r.pz * e[row][8] -
               (r.dx * e[row][9] + r.dy * e[row][10] + r.dz * e[row][11])) *
             inv[row];
  }
}

// Lexicographic best over the group: the least (v, pos), or with LARGEST
// the largest v and then the least pos. Every lane ends with the result.
template <bool LARGEST>
__device__ __forceinline__ void tw_group_best(const TwGroup& g, float& v, int& pos) {
#pragma unroll
  for (int off = TW_G / 2; off > 0; off >>= 1) {
    const float ov = g.shfl_xor(v, off);
    const int op = g.shfl_xor(pos, off);
    if ((LARGEST ? ov > v : ov < v) || (ov == v && op < pos)) {
      v = ov;
      pos = op;
    }
  }
}

}  // namespace zr
