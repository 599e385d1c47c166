// The flash closest-triangle winner for one ray: the device function shared
// by the flash kernel (flash_intersect.cu) and the bounce kernel's mesh
// mode (bounce_kernel.cu).
//
// Replaces the per-ray arithmetic of the TPU kernel _kernel_rl
// (zraytrace_tpu/ops/flash_intersect.py:589). Triangles are packed by
// zraytrace_tpu_torch/ops/flash_intersect.py pack_tri_planes as 18
// component planes (18, C, 128) f32 in BVH-leaf order, one AABB per
// 128-triangle chunk in bounds (C, 8).
//
// One thread walks the chunks in packed order. A chunk is skipped unless
// the ray's own slab test reaches its box within (t_min, t_best], t_best
// being the running winner seeded with t_init: a per-ray cull in place of
// the TPU kernel's per-block work lists. A reached chunk's 128 triangles
// are tested in the JAX arithmetic order (det = -(d.fn); u and v from
// o x d, e2, e2 x a, e1, e1 x a; t = (o.fn - a.fn) / det), one-sided
// (det >= 1e-6), then t > t_min, u >= 0, v >= 0, u + v <= 1 and a strict
// t < t_best, so a seed keeps exact ties. Ties between distinct triangles
// at bit-equal t go to the first in packed order; _kernel_rl picks the
// lowest sublane instead (flash_intersect.py:593-598). Exact ties of
// distinct triangles do not occur in the reference scenes.
//
// The early exits (det, then t, then u) skip work only: every test of the
// plain version is still applied, so the winner is the same. The counting
// instantiation (COUNT) also tallies the work each stage did, from which a
// bound on the kernels' time is priced: chunk slab tests, chunk visits and
// the triangle tests that pass det, t and u.

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

struct TwCount {
  unsigned long long n[W_TRI_N];
};

// Sum v over the warp and add it to *dst once. Every lane of the warp
// must call it.
__device__ __forceinline__ void tw_add(unsigned long long* dst, unsigned long long v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  if ((threadIdx.x & 31) == 0 && v) atomicAdd(dst, v);
}

// Closest triangle strictly below t_init. packed_id: report the packed id
// (const-material attrs mode) instead of the original one. With COUNT,
// cnt receives the work done.
template <bool COUNT>
__device__ __forceinline__ TwHit tri_winner(const float* __restrict__ planes,
                                            const float* __restrict__ bounds, int n_chunks,
                                            const TwRay& r, float t_min, float t_init,
                                            bool packed_id, TwCount& cnt) {
  TwHit best{t_init, 0, 0.0f, 0.0f};
  const size_t stride = (size_t)n_chunks * TW_LANE;  // one plane
  for (int c = 0; c < n_chunks; ++c) {
    const float* box = bounds + (size_t)c * 8;
    if (COUNT) ++cnt.n[W_SLAB];
    if (!tw_reach(box, box + 3, r, t_min, best.t)) continue;
    if (COUNT) ++cnt.n[W_VISITS];
    const float* base = planes + (size_t)c * TW_LANE;
    for (int j = 0; j < TW_LANE; ++j) {
      const float* q = base + j;
      const float fnx = __ldg(q + P_FNX * stride);
      const float fny = __ldg(q + P_FNY * stride);
      const float fnz = __ldg(q + P_FNZ * stride);
      const float det = -(r.dx * fnx + r.dy * fny + r.dz * fnz);
      if (!(det >= TW_DET_EPS)) continue;
      if (COUNT) ++cnt.n[W_DET];
      const float inv_det = 1.0f / det;  // |det| > 1e-12 here
      const float t = (r.ox * fnx + r.oy * fny + r.oz * fnz - __ldg(q + P_ADF * stride)) * inv_det;
      if (!(t > t_min && t < best.t)) continue;
      if (COUNT) ++cnt.n[W_T];
      const float u = (r.px * __ldg(q + P_E2X * stride) + r.py * __ldg(q + P_E2Y * stride) +
                       r.pz * __ldg(q + P_E2Z * stride) -
                       (r.dx * __ldg(q + P_QAX * stride) + r.dy * __ldg(q + P_QAY * stride) +
                        r.dz * __ldg(q + P_QAZ * stride))) *
                      inv_det;
      if (!(u >= 0.0f)) continue;
      if (COUNT) ++cnt.n[W_U];
      const float v = -(r.px * __ldg(q + P_E1X * stride) + r.py * __ldg(q + P_E1Y * stride) +
                        r.pz * __ldg(q + P_E1Z * stride) -
                        (r.dx * __ldg(q + P_RAX * stride) + r.dy * __ldg(q + P_RAY * stride) +
                         r.dz * __ldg(q + P_RAZ * stride))) *
                      inv_det;
      if (v >= 0.0f && u + v <= 1.0f) {
        best.t = t;
        best.id = packed_id ? c * TW_LANE + j : (int)__ldg(q + P_ORIG * stride);
        best.u = u;
        best.v = v;
      }
    }
  }
  return best;
}

}  // namespace zr
