// Block-cull micro-benchmark for Hopper (sm_90a): does one chunk-skip
// decision per block of rays pay against the port's per-ray cull?
//
// Replaces the TPU probe tools/flash2_probe.py probe_cullwhen (its kernel
// :269-339 and pallas_call :341): rays in blocks of RB = 512; per block
// the min and max of o and d over its rays, then for each 128-triangle
// chunk the tool's conservative slab "reach" of the chunk box from that
// range of origins and directions (an axis where the directions span 0
// constrains nothing), and where it reaches, the flash body on every ray
// of the block with t < t_best and valid > 0.5. Output: each ray's
// closest t (3.4e38 on a miss; the tool's column 0) and the chunks each
// block visited.
//
// Design. One CUDA block per 512 rays, one thread per ray. A warp-shuffle
// and shared-memory reduction gives the block's ranges; every thread then
// computes the same reach of each chunk from them, so the skip is uniform
// across the block (no divergence: the TPU's pl.when on a scalar), and the
// visited chunk's planes are read by all threads at the same address (one
// broadcast load per row and triangle). The test is zr::chunk_test
// (flash_chunk.cuh), the same as the chunk-body probe's. The port's
// kernels (csrc/tri_winner.cuh) cull per ray instead: each lane walks the
// chunks its own ray reaches, and lanes of a warp diverge.
//
// What bounds it: FP32 operations of the visited ray-triangle pairs, 40 a
// pair (flash3_probe.py's count), so the bound depends on how many chunks
// the blocks' ranges reach: rays from random points in random directions
// span every direction in a block and reach every chunk, while rays aimed
// away from the mesh reach none.

#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_chunk.cuh"

namespace {

constexpr int RB = 512;  // rays per block (the tool's RB)
constexpr int LANE = 128;
constexpr int N_WARPS = RB / 32;
constexpr float BIG = zr::FLASH_BIG;

// o and d ranges: min of o xyz, d xyz, then max of the same
enum { N_RANGE = 12 };

__device__ __forceinline__ float fmin_(float a, float b) { return a < b ? a : b; }
__device__ __forceinline__ float fmax_(float a, float b) { return a > b ? a : b; }

__global__ void __launch_bounds__(RB)
cull_kernel(const float* __restrict__ planes, const float* __restrict__ bounds, int nchunk,
            const float* __restrict__ o, const float* __restrict__ d, float* __restrict__ out,
            int* __restrict__ visits) {
  __shared__ float part[N_WARPS][N_RANGE];
  __shared__ float range[N_RANGE];
  const int i = blockIdx.x * RB + threadIdx.x;
  const zr::Ray r = zr::make_ray(o, d, i);
  float v[N_RANGE] = {r.ox, r.oy, r.oz, r.dx, r.dy, r.dz, r.ox, r.oy, r.oz, r.dx, r.dy, r.dz};
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int k = 0; k < N_RANGE; ++k) {
      const float other = __shfl_xor_sync(0xffffffffu, v[k], off);
      v[k] = k < 6 ? fmin_(v[k], other) : fmax_(v[k], other);
    }
  }
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 == 0)
    for (int k = 0; k < N_RANGE; ++k) part[warp][k] = v[k];
  __syncthreads();
  if (threadIdx.x < N_RANGE) {
    const int k = threadIdx.x;
    float x = part[0][k];
    for (int w = 1; w < N_WARPS; ++w) x = k < 6 ? fmin_(x, part[w][k]) : fmax_(x, part[w][k]);
    range[k] = x;
  }
  __syncthreads();
  float omin[3], omax[3], dmin[3], dmax[3];
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    omin[ax] = range[ax];
    dmin[ax] = range[3 + ax];
    omax[ax] = range[6 + ax];
    dmax[ax] = range[9 + ax];
  }
  const size_t plane = (size_t)nchunk * LANE;
  float t_best = BIG;
  int n_visits = 0;
#pragma unroll 1
  for (int ci = 0; ci < nchunk; ++ci) {
    // the tool's reach(ci), the same value in every thread of the block
    float near = 0.0f, far = BIG;
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) {
      const float lo = __ldg(bounds + ci * 8 + ax), hi = __ldg(bounds + ci * 8 + 3 + ax);
      const float dl = dmin[ax], dh = dmax[ax];
      const bool spans = dl <= 0.0f && dh >= 0.0f;
      const float il = 1.0f / (spans ? 1.0f : dl);
      const float ih = 1.0f / (spans ? 1.0f : dh);
      const float cs[8] = {(lo - omax[ax]) * il, (lo - omax[ax]) * ih, (lo - omin[ax]) * il,
                           (lo - omin[ax]) * ih, (hi - omax[ax]) * il, (hi - omax[ax]) * ih,
                           (hi - omin[ax]) * il, (hi - omin[ax]) * ih};
      float lo_t = cs[0], hi_t = cs[0];
#pragma unroll
      for (int c = 1; c < 8; ++c) {
        lo_t = fmin_(lo_t, cs[c]);
        hi_t = fmax_(hi_t, cs[c]);
      }
      near = spans ? near : fmax_(near, lo_t);
      far = spans ? far : fmin_(far, hi_t);
    }
    if (!(near <= far)) continue;  // block-uniform skip
    ++n_visits;
    const float* q = planes + (size_t)ci * LANE;
    for (int j = 0; j < LANE; ++j) {
      const float t = zr::chunk_test(r, [&](int k) { return __ldg(q + k * plane + j); }, t_best);
      t_best = t < t_best ? t : t_best;
    }
  }
  out[i] = t_best;
  if (threadIdx.x == 0) visits[blockIdx.x] = n_visits;
}

}  // namespace

// planes (n_comp >= 17, nchunk, 128) f32 (rows 0-16 read), bounds
// (nchunk, 8) f32 [lo3, hi3, -, -], o and d (n_rays, 3) f32 with n_rays a
// multiple of 512; out (n_rays,) f32, visits (n_rays / 512,) int32.
extern "C" int zr_probe_flash_cull_launch(const float* planes, const float* bounds, int nchunk,
                                          const float* o, const float* d, float* out,
                                          int* visits, int n_rays, void* stream) {
  if (nchunk < 0 || n_rays < 0 || n_rays % RB != 0) return (int)cudaErrorInvalidValue;
  if (n_rays == 0) return 0;
  cull_kernel<<<n_rays / RB, RB, 0, (cudaStream_t)stream>>>(planes, bounds, nchunk, o, d, out,
                                                            visits);
  return (int)cudaGetLastError();
}

extern "C" const char* zr_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
