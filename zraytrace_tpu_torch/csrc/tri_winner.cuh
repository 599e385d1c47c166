// The flash winner's per-ray pieces: the plane layout, the ray set-up, the
// chunk slab test and the work counters, shared by the warp-wide chunk
// walk of the flash and margin kernels (tri_winner_warp.cuh,
// flash_intersect.cu, flash_margins.cu) and the bounce kernel's BVH walk
// (tri_bvh.cuh).
//
// Replaces the per-ray arithmetic of the TPU kernel _kernel_rl
// (zraytrace_tpu/ops/flash_intersect.py:589). Triangles are packed by
// zraytrace_tpu_torch/ops/flash_intersect.py pack_tri_planes as 18
// component planes (18, C, 128) f32 in BVH-leaf order, one AABB per
// 128-triangle chunk in bounds (C, 8).
//
// The contract every winner keeps is that of the sequential scan in packed
// order (flash_intersect_plain): a chunk is skipped unless the ray's own
// slab test reaches its box within (t_min, t_best], t_best being the
// running winner seeded with t_init; a reached chunk's 128 triangles are
// tested in the JAX arithmetic order (det = -(d.fn); u and v from o x d,
// e2, e2 x a, e1, e1 x a; t = (o.fn - a.fn) / det), one-sided (det >=
// 1e-6), then t > t_min, u >= 0, v >= 0, u + v <= 1 and a strict t <
// t_best, so a seed keeps exact ties. Ties between distinct triangles at
// bit-equal t go to the first in packed order; _kernel_rl picks the lowest
// sublane instead (flash_intersect.py:593-598). Exact ties of distinct
// triangles do not occur in the reference scenes.

#pragma once

#include <cuda_runtime.h>

namespace zr {

constexpr int TW_LANE = 128;
constexpr float TW_BIG = 3.4e38f;
constexpr float TW_DET_EPS = 1e-6f;

// plane rows (ops/flash_intersect.py N_COMP)
enum {
  P_E1X, P_E1Y, P_E1Z, P_E2X, P_E2Y, P_E2Z, P_FNX, P_FNY, P_FNZ,
  P_QAX, P_QAY, P_QAZ, P_RAX, P_RAY, P_RAZ, P_ADF, P_VALID, P_ORIG, P_COMPS
};

struct TwRay {
  float ox, oy, oz, dx, dy, dz;
  float ix, iy, iz;  // 1 / d, with |d| < 1e-30 clamped to +1e-30
  float px, py, pz;  // o x d
};

__device__ __forceinline__ float tw_inv(float d) {
  return 1.0f / (fabsf(d) < 1e-30f ? 1e-30f : d);
}

__device__ __forceinline__ TwRay tw_ray(float ox, float oy, float oz, float dx, float dy,
                                        float dz) {
  TwRay r;
  r.ox = ox; r.oy = oy; r.oz = oz;
  r.dx = dx; r.dy = dy; r.dz = dz;
  r.ix = tw_inv(dx); r.iy = tw_inv(dy); r.iz = tw_inv(dz);
  r.px = oy * dz - oz * dy;
  r.py = oz * dx - ox * dz;
  r.pz = ox * dy - oy * dx;
  return r;
}

// Slab test of box [lo, hi] within (t_min, t_cap] (_ray_chunk_reach).
__device__ __forceinline__ bool tw_reach(const float* lo, const float* hi, const TwRay& r,
                                         float t_min, float t_cap) {
  const float ax = (lo[0] - r.ox) * r.ix, bx = (hi[0] - r.ox) * r.ix;
  const float ay = (lo[1] - r.oy) * r.iy, by = (hi[1] - r.oy) * r.iy;
  const float az = (lo[2] - r.oz) * r.iz, bz = (hi[2] - r.oz) * r.iz;
  const float near = fmaxf(fmaxf(fminf(ax, bx), fminf(ay, by)), fminf(az, bz));
  const float far = fminf(fminf(fmaxf(ax, bx), fmaxf(ay, by)), fmaxf(az, bz));
  return near <= far && far > t_min && near <= t_cap;
}

struct TwHit {
  float t;  // t_init where no triangle won
  int id;   // packed id (chunk*128 + lane) or original id; 0 on a miss
  float u, v;
};

// Work counters, in this order in the int64 work array the wrappers pass
// (ops/flash_intersect.py WORK_FIELDS).
enum { W_SLAB, W_VISITS, W_DET, W_T, W_U, W_TRI_N };

// Sum v over the warp and add it to *dst once. Every lane of the warp
// must call it.
__device__ __forceinline__ void tw_add(unsigned long long* dst, unsigned long long v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  if ((threadIdx.x & 31) == 0 && v) atomicAdd(dst, v);
}

}  // namespace zr
