// Flash silhouette-margin selection, written for Hopper (sm_90a).
//
// Replaces the TPU kernel _kernel_rl_margins (zraytrace_tpu/ops/
// flash_intersect.py:870, called at :1029 through flash_margin_select :982).
// Contract: zraytrace_tpu_torch/ops/flash_intersect.py flash_margin_select.
// Per ray, over the original-id planes of pack_tri_planes (no attrs table):
//   near: the triangle of largest barycentric margin m = min(u, v, 1-u-v)
//         among front crossings (det >= 1e-6) with m < 0 and
//         t_min < t < t_cap (strict: the argmax);
//   occ:  the interior crossing (m >= 0) of least t with
//         t > t_cap * (1 + 1e-5) (the argmin);
//   win:  the interior crossing of least t with t > t_min and
//         t_cap * (1 - 1e-5) <= t <= t_cap * (1 + 1e-5),
// each as an original id (P_ORIG), or -1 where no triangle qualified.
// edge_grad.silhouette_margin recomputes the margins differentiably on the
// selected triangles; the ids carry no gradient.
//
// Design. One thread per ray walks the chunks in packed (BVH-leaf) order.
// A chunk is visited when the ray's own slab test (tw_reach) reaches its
// DILATED box within (t_min, cap], cap = 2 * t_cap (t_cap itself when
// t_cap >= 1e30, a miss ray): the wrapper widens each box by half its
// extent plus 1e-3 on every side, because a near-missing ray can pass
// outside the plain box while its margin is still small. There is no
// running-winner shrink, since near-miss and occlusion candidates lie on
// both sides of t_cap. A visited chunk's triangles are tested in the
// arithmetic order of _kernel_rl_margins:920-928 (the order of
// tri_winner.cuh); a test ends after det, or after t <= t_min, where no
// mask can pass. Three running bests use strict comparisons.
//
// Two differences from the TPU kernel:
// - Ties: the first triangle in packed order wins. _kernel_rl_margins
//   picks the lowest sublane over its per-slot bests (pick_arg, :960-969).
// - Culling: each ray culls against its own dilated reach; the TPU kernel
//   visits the union of its 128-ray block's work lists. So a candidate the
//   TPU found in a chunk this ray does not reach can be missed here. It
//   lies outside the dilated band, so its margin is saturated (below -0.5,
//   or an occlusion margin above 0.5) and its gradient about zero; the
//   JAX package's own flash-vs-brute test allows the same.
//
// For a miss ray t_cap is 3.4e38: texcl = 3.40003e38 and tlow = 3.39997e38
// stay finite, and no crossing's t (|t| is at most |o.fn - a.fn| / 1e-6)
// comes near them, so a miss ray selects no occlusion or winner candidate.
//
// What bounds it on this card: FP32 work (6 operations per triangle test,
// 8 more past det, 27 more past t, 12 per slab test) and divergence, as in
// the flash winner; the dilated boxes reach more chunks than the winner's.
// The planes stay in L2. Built with -fmad=false: the plain PyTorch version
// (flash_margin_select_plain) rounds every product and sum separately, and
// the two agree bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tri_winner.cuh"

namespace {

constexpr int BLOCK = 128;

// Work counters, in the order of ops/flash_intersect.py MARGIN_WORK_FIELDS.
enum { M_SLAB, M_VISITS, M_DET, M_T, M_N };

// COUNT: add the work done to work[M_N], for a bound.
template <bool COUNT>
__global__ void __launch_bounds__(BLOCK)
margins_kernel(const float* __restrict__ planes, const float* __restrict__ dil_bounds,
               int n_chunks, const float* __restrict__ o, const float* __restrict__ d,
               const float* __restrict__ t_cap, float t_min, int n,
               int* __restrict__ out_near, int* __restrict__ out_occ,
               int* __restrict__ out_win, unsigned long long* __restrict__ work) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  unsigned long long cnt[M_N] = {0, 0, 0, 0};
  if (i < n) {
    const zr::TwRay r = zr::tw_ray(o[3 * i], o[3 * i + 1], o[3 * i + 2], d[3 * i],
                                   d[3 * i + 1], d[3 * i + 2]);
    const float tc = t_cap[i];
    const float cap = tc >= 1e30f ? tc : 2.0f * tc;
    const float texcl = tc * 1.00001f;
    const float tlow = tc * 0.99999f;
    float mb = -zr::TW_BIG, tob = zr::TW_BIG, twb = zr::TW_BIG;
    int nib = -1, oib = -1, wib = -1;
    const size_t stride = (size_t)n_chunks * zr::TW_LANE;  // one plane
    for (int c = 0; c < n_chunks; ++c) {
      const float* box = dil_bounds + (size_t)c * 8;
      if (COUNT) ++cnt[M_SLAB];
      if (!zr::tw_reach(box, box + 3, r, t_min, cap)) continue;
      if (COUNT) ++cnt[M_VISITS];
      const float* base = planes + (size_t)c * zr::TW_LANE;
      for (int j = 0; j < zr::TW_LANE; ++j) {
        const float* q = base + j;
        const float fnx = __ldg(q + zr::P_FNX * stride);
        const float fny = __ldg(q + zr::P_FNY * stride);
        const float fnz = __ldg(q + zr::P_FNZ * stride);
        const float det = -(r.dx * fnx + r.dy * fny + r.dz * fnz);
        if (!(det >= zr::TW_DET_EPS)) continue;
        if (COUNT) ++cnt[M_DET];
        const float inv_det = 1.0f / det;  // |det| > 1e-12 here
        const float t =
            (r.ox * fnx + r.oy * fny + r.oz * fnz - __ldg(q + zr::P_ADF * stride)) * inv_det;
        // every mask needs t > t_min (occlusion through t > texcl > t_min,
        // as a hit's t_cap exceeds t_min)
        if (!(t > t_min)) continue;
        if (COUNT) ++cnt[M_T];
        const float u =
            (r.px * __ldg(q + zr::P_E2X * stride) + r.py * __ldg(q + zr::P_E2Y * stride) +
             r.pz * __ldg(q + zr::P_E2Z * stride) -
             (r.dx * __ldg(q + zr::P_QAX * stride) + r.dy * __ldg(q + zr::P_QAY * stride) +
              r.dz * __ldg(q + zr::P_QAZ * stride))) *
            inv_det;
        const float v =
            -(r.px * __ldg(q + zr::P_E1X * stride) + r.py * __ldg(q + zr::P_E1Y * stride) +
              r.pz * __ldg(q + zr::P_E1Z * stride) -
              (r.dx * __ldg(q + zr::P_RAX * stride) + r.dy * __ldg(q + zr::P_RAY * stride) +
               r.dz * __ldg(q + zr::P_RAZ * stride))) *
            inv_det;
        const float m = fminf(fminf(u, v), 1.0f - u - v);
        if (m < 0.0f) {
          if (t < tc && m > mb) {
            mb = m;
            nib = (int)__ldg(q + zr::P_ORIG * stride);
          }
        } else if (m >= 0.0f) {
          if (t > texcl) {
            if (t < tob) {
              tob = t;
              oib = (int)__ldg(q + zr::P_ORIG * stride);
            }
          } else if (t >= tlow && t < twb) {
            twb = t;
            wib = (int)__ldg(q + zr::P_ORIG * stride);
          }
        }
      }
    }
    out_near[i] = nib;
    out_occ[i] = oib;
    out_win[i] = wib;
  }
  if (COUNT) {
#pragma unroll
    for (int k = 0; k < M_N; ++k) zr::tw_add(&work[k], cnt[k]);
  }
}

}  // namespace

// dil_bounds: (n_chunks, 8) dilated chunk boxes [lo3, hi3, 0, 0].
// work: null, or int64 [4] that receives the work done (slower).
extern "C" int zr_margins_launch(const float* planes, const float* dil_bounds, int n_chunks,
                                 const float* o, const float* d, const float* t_cap,
                                 float t_min, int n, int* out_near, int* out_occ, int* out_win,
                                 unsigned long long* work, void* stream) {
  if (n_chunks < 1) return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  const int grid = (n + BLOCK - 1) / BLOCK;
  if (work) {
    margins_kernel<true><<<grid, BLOCK, 0, (cudaStream_t)stream>>>(
        planes, dil_bounds, n_chunks, o, d, t_cap, t_min, n, out_near, out_occ, out_win, work);
  } else {
    margins_kernel<false><<<grid, BLOCK, 0, (cudaStream_t)stream>>>(
        planes, dil_bounds, n_chunks, o, d, t_cap, t_min, n, out_near, out_occ, out_win, work);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* zr_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
