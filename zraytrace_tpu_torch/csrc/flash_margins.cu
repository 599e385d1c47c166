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
// Design: one ray per group of TW_G lanes (tri_winner_warp.cuh). A chunk is
// visited when the ray's own slab test reaches its DILATED box within
// (t_min, cap], cap = 2 * t_cap (t_cap itself when t_cap >= 1e30, a miss
// ray): each box is widened by half its extent plus 1e-3 on every side, in
// the kernel, with the arithmetic of dilated_bounds, because a near-missing
// ray can pass outside the plain box while its margin is still small. The
// lanes share out the slab tests and ballot the reached chunks. There is no
// running-winner shrink, since near-miss and occlusion candidates lie on
// both sides of t_cap, so the ballot is final. In a visited chunk lane l
// tests triangles l, l + TW_G, ... in the arithmetic order of
// _kernel_rl_margins:920-928 (the order of tri_winner.cuh), in two stages
// whose plane reads are issued for all its rows at once: det and t, then u
// and v of the rows past det and t > t_min, where a mask can pass. Each
// lane keeps three bests with the sequential scan's strict comparisons and
// their packed positions; one shuffle reduction per best at the end gives
// the scan's first-in-packed-order result: each lane holds the first of
// its own bests, float compares are exact, and the best (value, least
// packed position) over the lanes is the scan's (tri_winner_warp.cuh).
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
// A pose-step launch has 4,096 rays: one thread per ray filled 32 blocks
// and walked up to 50 dilated chunks of 128 dependent L2 reads each. What
// bounds it, as measured (PERF.md section 6): at the pose step's 4,096
// rays, the launch and the latency of each ray's serial walk (its plane
// reads run at about 2.4 TB/s, under the 5.2 TB/s its camera rays reach,
// so neither L2 nor FP32 work bounds it). The staged reads hold 128
// registers a thread: a chain of reads per test needs 56 and is faster on
// 32,768 camera rays and on surface rays of 14 visits, but 1.6x slower in
// the pose step. Built with -fmad=false: the plain PyTorch version
// (flash_margin_select_plain) rounds every product and sum separately,
// and the two agree bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tri_winner_warp.cuh"

namespace {

constexpr int BLOCK = 128;

// Work counters, in the order of ops/flash_intersect.py MARGIN_WORK_FIELDS.
enum { M_SLAB, M_VISITS, M_DET, M_T, M_N };

// COUNT: add the work done to work[M_N], for a bound.
template <bool COUNT>
__global__ void __launch_bounds__(BLOCK)
margins_kernel(const float* __restrict__ planes, const float* __restrict__ bounds,
               int n_chunks, const float* __restrict__ o, const float* __restrict__ d,
               const float* __restrict__ t_cap, float t_min, int n,
               int* __restrict__ out_near, int* __restrict__ out_occ,
               int* __restrict__ out_win, unsigned long long* __restrict__ work) {
  namespace cg = cooperative_groups;
  const zr::TwGroup g = cg::tiled_partition<zr::TW_G>(cg::this_thread_block());
  const int i = (int)(((long long)blockIdx.x * blockDim.x + threadIdx.x) / zr::TW_G);
  const int lane = g.thread_rank();
  unsigned long long cnt[M_N] = {0, 0, 0, 0};
  if (i < n) {
    const zr::TwRay r = zr::tw_ray(o[3 * i], o[3 * i + 1], o[3 * i + 2], d[3 * i],
                                   d[3 * i + 1], d[3 * i + 2]);
    const float tc = t_cap[i];
    const float cap = tc >= 1e30f ? tc : 2.0f * tc;
    const float texcl = tc * 1.00001f;
    const float tlow = tc * 0.99999f;
    // this lane's bests and their packed positions: near, occ, win
    float mb = -zr::TW_BIG, tob = zr::TW_BIG, twb = zr::TW_BIG;
    int nj = zr::TW_NONE, oj = zr::TW_NONE, wj = zr::TW_NONE;
    const size_t stride = (size_t)n_chunks * zr::TW_LANE;  // one plane

    auto visit = [&](int c) {
      if (COUNT && lane == 0) ++cnt[M_VISITS];
      const float* base = planes + (size_t)c * zr::TW_LANE + lane;
      constexpr int S = zr::TW_ROWS;
      float det[S], inv[S], t[S], u[S], v[S];
      bool use[S];
      zr::tw_rows_t(base, stride, r, det, inv, t);
      // every mask needs t > t_min (occlusion through t > texcl > t_min,
      // as a hit's t_cap exceeds t_min)
#pragma unroll
      for (int k = 0; k < S; ++k) {
        use[k] = det[k] >= zr::TW_DET_EPS && t[k] > t_min;
        if (COUNT) {
          cnt[M_DET] += det[k] >= zr::TW_DET_EPS;
          cnt[M_T] += use[k];
        }
      }
      zr::tw_rows_uv(base, stride, r, use, inv, u, v);
#pragma unroll
      for (int k = 0; k < S; ++k) {
        if (!use[k]) continue;
        const int pos = c * zr::TW_LANE + k * zr::TW_G + lane;
        const float m = fminf(fminf(u[k], v[k]), 1.0f - u[k] - v[k]);
        if (m < 0.0f) {
          if (t[k] < tc && m > mb) {
            mb = m;
            nj = pos;
          }
        } else if (m >= 0.0f) {
          if (t[k] > texcl) {
            if (t[k] < tob) {
              tob = t[k];
              oj = pos;
            }
          } else if (t[k] >= tlow && t[k] < twb) {
            twb = t[k];
            wj = pos;
          }
        }
      }
    };

    zr::tw_group_walk<true>(g, bounds, n_chunks, r, t_min, [&] { return cap; }, visit,
                            cnt[M_SLAB]);
    zr::tw_group_best<true>(g, mb, nj);
    zr::tw_group_best<false>(g, tob, oj);
    zr::tw_group_best<false>(g, twb, wj);
    if (lane == 0) {
      const float* orig = planes + zr::P_ORIG * stride;
      out_near[i] = nj == zr::TW_NONE ? -1 : (int)__ldg(orig + nj);
      out_occ[i] = oj == zr::TW_NONE ? -1 : (int)__ldg(orig + oj);
      out_win[i] = wj == zr::TW_NONE ? -1 : (int)__ldg(orig + wj);
    }
  }
  if (COUNT) {
#pragma unroll
    for (int k = 0; k < M_N; ++k) zr::tw_add(&work[k], cnt[k]);
  }
}

}  // namespace

// bounds: (n_chunks, 8) chunk boxes [lo3, hi3, 0, 0], dilated in the kernel.
// work: null, or int64 [4] that receives the work done (slower).
extern "C" int zr_margins_launch(const float* planes, const float* bounds, int n_chunks,
                                 const float* o, const float* d, const float* t_cap,
                                 float t_min, int n, int* out_near, int* out_occ, int* out_win,
                                 unsigned long long* work, void* stream) {
  if (n_chunks < 1) return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  const long long threads = (long long)n * zr::TW_G;
  const int grid = (int)((threads + BLOCK - 1) / BLOCK);
  if (work) {
    margins_kernel<true><<<grid, BLOCK, 0, (cudaStream_t)stream>>>(
        planes, bounds, n_chunks, o, d, t_cap, t_min, n, out_near, out_occ, out_win, work);
  } else {
    margins_kernel<false><<<grid, BLOCK, 0, (cudaStream_t)stream>>>(
        planes, bounds, n_chunks, o, d, t_cap, t_min, n, out_near, out_occ, out_win, work);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* zr_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
