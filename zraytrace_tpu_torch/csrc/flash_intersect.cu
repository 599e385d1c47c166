// Flash closest-triangle winner, written for Hopper (sm_90a).
//
// Replaces the TPU kernel _kernel_rl (zraytrace_tpu/ops/flash_intersect.py:589,
// called at :839 through _flash_rl from flash_intersect_triangles :1055) and,
// with the same contract, the older rays-on-sublanes _kernel / _winner_scan
// (:401). Contract: zraytrace_tpu_torch/ops/flash_intersect.py
// flash_intersect_triangles; per ray t, id, hit and uv, the running winner
// seeded with t_init.
//
// Design. One thread per ray runs tri_winner (tri_winner.cuh): a per-ray
// slab test of each 128-triangle chunk box within (t_min, t_best], then the
// chunk's triangles, in packed (BVH-leaf) order. The TPU kernel's
// rays-on-lanes layout, SMEM work lists, reach sort, group bounds, coarse
// phase and near exit were how a TPU block skips work it cannot branch
// around; a GPU thread simply skips the chunks its ray does not reach.
//
// What bounds it on this card: FP32 work, 6 to 40 operations per triangle
// test (the early exits) and 12 per chunk slab test, and divergence: rays
// of one warp reach different chunks, and a warp runs until its slowest
// ray is done. The
// planes are read through the read-only cache; the teapot's (6320
// triangles, 455 KB) stay in the 50 MB L2. Tile-coherent rays, BVH
// traversal and shared-memory staging of chunks are the levers left for
// later.
//
// Built with -fmad=false: the plain PyTorch version rounds every product
// and sum separately, and the two agree bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tri_winner.cuh"

namespace {

constexpr int BLOCK = 128;

// COUNT: add the work done to work[W_TRI_N] (tri_winner.cuh), for a bound.
template <bool COUNT>
__global__ void __launch_bounds__(BLOCK)
flash_kernel(const float* __restrict__ planes, const float* __restrict__ bounds,
             int n_chunks, bool packed_id, const float* __restrict__ o,
             const float* __restrict__ d, const float* __restrict__ t_init, float t_min,
             int n, float* __restrict__ out_t, int* __restrict__ out_idx,
             uint8_t* __restrict__ out_hit, float* __restrict__ out_uv,
             unsigned long long* __restrict__ work) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  zr::TwCount cnt{};
  if (i < n) {
    const zr::TwRay r = zr::tw_ray(o[3 * i], o[3 * i + 1], o[3 * i + 2], d[3 * i],
                                   d[3 * i + 1], d[3 * i + 2]);
    const float ti = t_init ? fminf(t_init[i], zr::TW_BIG) : zr::TW_BIG;
    const zr::TwHit h =
        zr::tri_winner<COUNT>(planes, bounds, n_chunks, r, t_min, ti, packed_id, cnt);
    out_t[i] = h.t;
    out_idx[i] = h.id;
    out_hit[i] = h.t < ti;
    out_uv[2 * i] = packed_id ? 0.0f : h.u;
    out_uv[2 * i + 1] = packed_id ? 0.0f : h.v;
  }
  if (COUNT) {
#pragma unroll
    for (int k = 0; k < zr::W_TRI_N; ++k) zr::tw_add(&work[k], cnt.n[k]);
  }
}

}  // namespace

// work: null, or int64 [W_TRI_N] that receives the work done (slower).
extern "C" int zr_flash_launch(const float* planes, const float* bounds, int n_chunks,
                               int packed_id, const float* o, const float* d,
                               const float* t_init, float t_min, int n, float* out_t,
                               int* out_idx, uint8_t* out_hit, float* out_uv,
                               unsigned long long* work, void* stream) {
  if (n_chunks < 1) return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  const int grid = (n + BLOCK - 1) / BLOCK;
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
