// Flash closest-triangle winner, written for Hopper (sm_90a).
//
// Replaces the TPU kernel _kernel_rl (zraytrace_tpu/ops/flash_intersect.py:589,
// called at :839 through _flash_rl from flash_intersect_triangles :1055) and,
// with the same contract, the older rays-on-sublanes _kernel / _winner_scan
// (:401). Contract: zraytrace_tpu_torch/ops/flash_intersect.py
// flash_intersect_triangles; per ray t, id, hit and uv, the running winner
// seeded with t_init. The result is that of the sequential scan in packed
// order (flash_intersect_plain), bit for bit.
//
// Ties: the first triangle in packed order wins, as in the TPU kernel's
// packed-id mode. Its original-id mode keeps a best per triangle lane over
// the chunks and takes the lowest lane ("sublane-first", _kernel_rl's
// docstring), so of two exact copies in different chunks it can return
// the later one (tests/test_torch_flash.py holds both rules).
//
// Design: one ray per group of TW_G lanes (tri_winner_warp.cuh). The lanes
// share out the chunk slab tests within (t_min, t_best] and ballot the
// reached chunks; each reached chunk is re-checked against the running
// winner when its turn comes (near <= t_best, tw_reach's condition at that
// point of the sequential walk, so the same chunks are visited). In a
// visited chunk lane l tests triangles l, l + TW_G, ... in the arithmetic
// order of tri_winner.cuh, in two stages whose plane reads are issued for all
// its rows at once (det and t; then u and v of the rows with t strictly
// below the chunk's entry winner), and keeps its first least t strictly
// below its own running best; then a shuffle reduction on (t, packed
// position) gives the chunk's first least t, which becomes the running
// winner before the next chunk is culled. u and v come from the winning
// lane by shuffle. This equals the sequential first-wins scan: each lane
// scans its own triangles in packed order and keeps the first of its
// least t, float compares are exact, and the least (t, packed position)
// over the lanes is the scan's first least t (tri_winner_warp.cuh).
//
// A pose-step launch has 4,096 rays: one thread per ray filled 32 blocks of
// the card's 132 SMs and walked about 2,000 dependent L2 reads per thread;
// TW_G lanes per ray give TW_G times the threads, each with a TW_G-th of
// the walk, coalesced plane loads, and two rounds of reads per chunk.
// What bounds it, as measured (PERF.md section 6): at the pose step's
// 4,096 rays, the launch (0.006 ms when no chunk is reached) and the
// latency of each ray's serial walk; its plane reads run at about 1 TB/s,
// far under the 5 TB/s the margin kernel reaches, so neither L2 nor FP32
// work bounds it. The staged reads hold 128 registers a thread (16 warps
// an SM): a chain of reads per test needs 56 and is faster at 753,816
// rays, but 2x slower at the pose step's 4,096. The planes are read
// through the read-only cache; the teapot's (6,320 triangles, 455 KB)
// stay in the 50 MB L2.
//
// Counting build (COUNT): slab tests, visits and det counts equal the
// sequential scan's. A lane tests t against the chunk's entry winner, not
// the winner that shrinks mid-chunk, so it passes t and u a little more often:
// "t" and "u" are the counts of the sequential order (an exclusive prefix
// minimum of the hits in packed order gives each triangle the running
// winner the scan would hold), "t_warp" and "u_warp" what this design
// tested (ops/flash_intersect.py FLASH_WORK_FIELDS).
//
// Built with -fmad=false: the plain PyTorch version rounds every product
// and sum separately, and the two agree bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tri_winner_warp.cuh"

namespace {

constexpr int BLOCK = 128;

// work columns after tri_winner's W_TRI_N (FLASH_WORK_FIELDS)
enum { W_T_WARP = zr::W_TRI_N, W_U_WARP, W_FLASH_N };

// COUNT: add the work done to work[W_FLASH_N], for a bound.
template <bool COUNT>
__global__ void __launch_bounds__(BLOCK)
flash_kernel(const float* __restrict__ planes, const float* __restrict__ bounds,
             int n_chunks, bool packed_id, const float* __restrict__ o,
             const float* __restrict__ d, const float* __restrict__ t_init, float t_min,
             int n, float* __restrict__ out_t, int* __restrict__ out_idx,
             uint8_t* __restrict__ out_hit, float* __restrict__ out_uv,
             unsigned long long* __restrict__ work) {
  namespace cg = cooperative_groups;
  const zr::TwGroup g = cg::tiled_partition<zr::TW_G>(cg::this_thread_block());
  const int i = (int)(((long long)blockIdx.x * blockDim.x + threadIdx.x) / zr::TW_G);
  const int lane = g.thread_rank();
  unsigned long long cnt[W_FLASH_N] = {};
  if (i < n) {
    const zr::TwRay r = zr::tw_ray(o[3 * i], o[3 * i + 1], o[3 * i + 2], d[3 * i],
                                   d[3 * i + 1], d[3 * i + 2]);
    const float ti = t_init ? fminf(t_init[i], zr::TW_BIG) : zr::TW_BIG;
    zr::TwHit best{ti, 0, 0.0f, 0.0f};  // the same in every lane of the group
    const size_t stride = (size_t)n_chunks * zr::TW_LANE;  // one plane

    auto visit = [&](int c) {
      if (COUNT && lane == 0) ++cnt[zr::W_VISITS];
      const float* base = planes + (size_t)c * zr::TW_LANE + lane;
      float bt = best.t, bu = 0.0f, bv = 0.0f;
      int bj = zr::TW_NONE;
      constexpr int S = zr::TW_ROWS;
      float det[S], inv[S], t[S], u[S], v[S], t_hit[S];
      bool use[S];
      zr::tw_rows_t(base, stride, r, det, inv, t);
#pragma unroll
      for (int k = 0; k < S; ++k) {
        use[k] = det[k] >= zr::TW_DET_EPS && t[k] > t_min && t[k] < best.t;
        if (COUNT) {
          cnt[zr::W_DET] += det[k] >= zr::TW_DET_EPS;
          cnt[W_T_WARP] += use[k];
        }
      }
      zr::tw_rows_uv(base, stride, r, use, inv, u, v);
#pragma unroll
      for (int k = 0; k < S; ++k) {
        t_hit[k] = zr::TW_BIG;  // COUNT only
        if (!use[k]) continue;
        if (COUNT) cnt[W_U_WARP] += u[k] >= 0.0f;
        if (t[k] < bt && u[k] >= 0.0f && v[k] >= 0.0f && u[k] + v[k] <= 1.0f) {
          bt = t[k];
          bj = k * zr::TW_G + lane;
          bu = u[k];
          bv = v[k];
          t_hit[k] = t[k];
        }
      }
      if (COUNT) {
        // the sequential scan's t and u counts: triangle j faces the least
        // of the entry winner and the hits before it in packed order (a
        // lane skipped u for a t at or above the entry winner, which the
        // scan's running winner cannot exceed)
        float carry = best.t;  // the scan's running winner
#pragma unroll
        for (int k = 0; k < S; ++k) {
          float incl = t_hit[k];
#pragma unroll
          for (int off = 1; off < zr::TW_G; off <<= 1) {
            const float up = g.shfl_up(incl, off);
            if (lane >= off) incl = fminf(incl, up);
          }
          const float before = g.shfl_up(incl, 1);
          const float run = lane == 0 ? carry : fminf(carry, before);
          if (det[k] >= zr::TW_DET_EPS && t[k] > t_min && t[k] < run) {
            ++cnt[zr::W_T];
            if (u[k] >= 0.0f) ++cnt[zr::W_U];
          }
          carry = fminf(carry, g.shfl(incl, zr::TW_G - 1));
        }
      }
      if (!g.any(bj != zr::TW_NONE)) return;
      zr::tw_group_best<false>(g, bt, bj);
      const int from = bj % zr::TW_G;
      best.t = bt;
      best.id = packed_id ? c * zr::TW_LANE + bj
                          : (int)__ldg(planes + zr::P_ORIG * stride + (size_t)c * zr::TW_LANE + bj);
      best.u = g.shfl(bu, from);
      best.v = g.shfl(bv, from);
    };

    zr::tw_group_walk<false>(g, bounds, n_chunks, r, t_min, [&] { return best.t; }, visit,
                             cnt[zr::W_SLAB]);
    if (lane == 0) {
      out_t[i] = best.t;
      out_idx[i] = best.id;
      out_hit[i] = best.t < ti;
      out_uv[2 * i] = packed_id ? 0.0f : best.u;
      out_uv[2 * i + 1] = packed_id ? 0.0f : best.v;
    }
  }
  if (COUNT) {
#pragma unroll
    for (int k = 0; k < W_FLASH_N; ++k) zr::tw_add(&work[k], cnt[k]);
  }
}

}  // namespace

// work: null, or int64 [W_FLASH_N] that receives the work done (slower).
extern "C" int zr_flash_launch(const float* planes, const float* bounds, int n_chunks,
                               int packed_id, const float* o, const float* d,
                               const float* t_init, float t_min, int n, float* out_t,
                               int* out_idx, uint8_t* out_hit, float* out_uv,
                               unsigned long long* work, void* stream) {
  if (n_chunks < 1) return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  const long long threads = (long long)n * zr::TW_G;
  const int grid = (int)((threads + BLOCK - 1) / BLOCK);
  if (work) {
    flash_kernel<true><<<grid, BLOCK, 0, (cudaStream_t)stream>>>(
        planes, bounds, n_chunks, packed_id != 0, o, d, t_init, t_min, n, out_t, out_idx,
        out_hit, out_uv, work);
  } else {
    flash_kernel<false><<<grid, BLOCK, 0, (cudaStream_t)stream>>>(
        planes, bounds, n_chunks, packed_id != 0, o, d, t_init, t_min, n, out_t, out_idx,
        out_hit, out_uv, work);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* zr_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
