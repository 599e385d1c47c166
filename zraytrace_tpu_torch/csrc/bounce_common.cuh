// Device functions of the bounce kernel's per-segment body, shared by the
// bounce kernel (bounce_kernel.cu) and the bounce-body probe
// (probe_body.cu), so that the probe times the code the kernel runs:
// the vector type, PCG4D and its unit floats, and the fused sphere
// winner over per-sphere rows made from a table of (cx, cy, cz, radius,
// material) rows.
//
// Numerics follow the plain PyTorch versions operation by operation:
// explicit left-to-right component sums, built with -fmad=false so no
// multiply-add is contracted.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "exact_math.cuh"

namespace zr {

constexpr float SPH_BIG = 3.4e38f;

// sphere table columns (zraytrace_tpu/ops/common.py prepare_tables)
enum { S_CX, S_CY, S_CZ, S_R, S_MAT, S_COLS };

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ float dot3(V3 a, V3 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}

// PCG4D (Jarzynski & Olano 2020), bit-identical to zraytrace_tpu/rng.py
// pcg4d: four uint32 counters -> four uint32 hashes.
__device__ __forceinline__ uint4 pcg4d(uint32_t x, uint32_t y, uint32_t z, uint32_t w) {
  x = x * 1664525u + 1013904223u;
  y = y * 1664525u + 1013904223u;
  z = z * 1664525u + 1013904223u;
  w = w * 1664525u + 1013904223u;
  x += y * w;
  y += z * x;
  z += x * y;
  w += y * z;
  x ^= x >> 16;
  y ^= y >> 16;
  z ^= z >> 16;
  w ^= w >> 16;
  x += y * w;
  y += z * x;
  z += x * y;
  w += y * z;
  return make_uint4(x, y, z, w);
}

// Four U[0,1) floats of (pixel, sample, bounce, seed^stream): the top 24
// bits of each hash (zraytrace_tpu/rng.py _to_unit_float).
__device__ __forceinline__ float4 uniform4(uint32_t seed_c, uint32_t pixel,
                                           uint32_t sample, uint32_t bounce) {
  const uint4 h = pcg4d(pixel, sample, bounce, seed_c);
  const float k = 1.0f / 16777216.0f;
  return make_float4((float)(h.x >> 8) * k, (float)(h.y >> 8) * k,
                     (float)(h.z >> 8) * k, (float)(h.w >> 8) * k);
}

// The winner's row of one sphere: (cx, cy, cz, c.c - r*r) from its row of
// the (S, S_COLS) table. The last term depends on the sphere alone, so a
// kernel makes it once per block, in the plain version's operations and
// order ((cx*cx + cy*cy) + cz*cz) - r*r, and each test reads one float4.
__device__ __forceinline__ float4 sphere_row(const float* s) {
  const float cx = s[S_CX], cy = s[S_CY], cz = s[S_CZ], r = s[S_R];
  return make_float4(cx, cy, cz, (cx * cx + cy * cy + cz * cz) - r * r);
}

// The fused sphere winner: the closest root in (t_min, BIG) over n_sph
// sphere_row rows. Returns the winning row, -1 on a miss; t_best receives
// its t (SPH_BIG on a miss). The strict < keeps the first sphere on ties.
// With COUNT, n_disc counts the tests whose discriminant is positive.
// With FAST, each root's square root is exact_math.cuh's sqrt_fast, which
// clears ok where it may differ from sqrtf (the caller recomputes); the
// overload without ok, the bounce kernel's, takes sqrtf.
template <bool COUNT, bool FAST>
__device__ __forceinline__ int sphere_winner(const float4* rows, int n_sph, V3 o, V3 d,
                                             float t_min, float& t_best,
                                             unsigned long long& n_disc, bool& ok) {
  const float o_dot_d = dot3(o, d);
  const float o_sq = dot3(o, o);
  t_best = SPH_BIG;
  int win = -1;
  for (int si = 0; si < n_sph; ++si) {
    const float4 row = rows[si];
    const V3 c{row.x, row.y, row.z};
    const float half_b = o_dot_d - dot3(d, c);
    const float cc = o_sq - 2.0f * dot3(o, c) + row.w;
    const float disc = half_b * half_b - cc;
    if (COUNT && disc > 0.0f) ++n_disc;
    float root;
    if constexpr (FAST) {
      bool in = true;
      const float sq = sqrt_fast(disc, in);
      ok &= in | !(disc > 0.0f);
      root = disc > 0.0f ? sq : 0.0f;
    } else {
      root = disc > 0.0f ? sqrtf(disc) : 0.0f;
    }
    const float t1 = -half_b - root;
    const float t2 = -half_b + root;
    const bool ok1 = (t1 > t_min) && (t1 < SPH_BIG);
    const bool ok2 = (t2 > t_min) && (t2 < SPH_BIG);
    const float t = ok1 ? t1 : t2;
    if (disc >= 0.0f && (ok1 || ok2) && t < t_best) {
      t_best = t;
      win = si;
    }
  }
  return win;
}

template <bool COUNT>
__device__ __forceinline__ int sphere_winner(const float4* rows, int n_sph, V3 o, V3 d,
                                             float t_min, float& t_best,
                                             unsigned long long& n_disc) {
  bool ok = true;
  return sphere_winner<COUNT, false>(rows, n_sph, o, d, t_min, t_best, n_disc, ok);
}

}  // namespace zr
