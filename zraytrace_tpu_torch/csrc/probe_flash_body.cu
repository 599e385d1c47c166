// Flash chunk-body micro-benchmark for Hopper (sm_90a): where does the
// triangle test of the flash winner spend its time, and which layout of
// rays and triangles over threads pays?
//
// Replaces the TPU probe tools/flash3_probe.py:54-117 (build, and the
// pallas_call of run :109-117): the closest t per ray over NCHUNK = 50
// chunks x 128 triangles given as 17 plane rows (_chunk_math :33-51:
// edges, face normal, the two edge x apex cross products, apex . normal,
// a valid flag), REPS = 8 times, for R = 512 rays; the output is the sum
// over REPS of each ray's closest t (3.4e38 where nothing is hit).
//
// The four TPU modes were layouts of Mosaic's (8, 128) vector tiles. On
// this card each stands for the question it asks here, and a fifth is
// this card's own answer:
//   base   one thread per ray, every triangle's planes read from global
//          memory (L1/L2) per test, the ray terms (o x d) recomputed each
//          rep: the layout of a per-ray sequential chunk scan;
//   hoist  base with the ray terms computed once per thread before the
//          reps (the TPU's pre-broadcast). nvcc hoists them out of base's
//          loop by itself, so the two should compile alike: compare their
//          -Xptxas -v lines and times;
//   both   the block stages each chunk's 17 x 128 planes in shared memory
//          (8.5 KB) before its threads test them, so every plane is read
//          from device memory once per block and chunk, and the tests read
//          shared-memory broadcasts;
//   r8     eight rays per warp: four lanes per ray split a chunk's 128
//          triangles (32 each), then a two-step warp-shuffle min; four
//          times the threads per ray (the "more threads per ray" lever);
//   tile   four rays per warp, held by every lane in registers; the 32
//          lanes split each chunk's 128 triangles (lane l tests l, l + 32,
//          l + 64, l + 96), so every plane value a lane reads serves four
//          tests. The block's warps share each chunk, staged in shared
//          memory with cp.async three chunks deep (the next two land while
//          this one is tested; one barrier per chunk); lanes read
//          consecutive banks. Each rep's partial minimums meet in a
//          five-step warp-shuffle min before they are added to the sum.
//          Blocks of up to 8 warps, fewer where the rays are few, so that
//          the blocks spread over the SMs (at 512 rays: 128 one-warp
//          blocks).
//
// Every mode tests every triangle with the tool's branch-free arithmetic
// (zr::chunk_test in flash_chunk.cuh; for tile zr::chunk_hits, the same
// operations for four rays at once; no per-ray cull, no early exit), so
// the modes differ only in layout and all return the same sums, bit for
// bit: each t is computed in the same order, with -fmad=false, and a
// minimum is exact whatever the order.
//
// What bounds it: FP32 operations (40 per ray-triangle pair, one of them
// a division) against 8.7 KB of planes per chunk: an H100 needs ~0.001 ms
// to read R = 32,768 rays' inputs and ~1 ms for their 1.68e9 pairs x 8
// reps of arithmetic at 67 TFLOP/s, ~2 ms at one instruction per multiply
// or add (-fmad=false). Beside those 40, a pair costs its 7 comparisons, a
// select and the reciprocal's refinement: tile issues about 60
// instructions a pair (LDS included), ~3 ms at the card's issue rate. Its
// reciprocal is zr::rcp_rn_fast, one branch per triangle for four rays:
// 1.0f / det compiled to a general division (-1.0f / s, with FCHK and a
// call per pair), and those per-pair branches kept the four tests from
// interleaving. Warps on offer per SM (132 SMs): at 32,768 rays base,
// hoist and both launch 256 blocks of 4 warps (~8 warps an SM, of 64), r8
// 512 blocks of 8 (~31), tile 1,024 of 8 (~62, of which 80 registers a
// thread leave 24 resident); at the tool's 512 rays base, hoist and both
// fill 4 SMs with 4 warps, r8 8 SMs with 8, tile 128 SMs with one. On an
// H100 80GB HBM3 at 700 W, tile at 32,768 rays takes ~3.85 ms, about 78%
// of the issue rate.
//
// Each rep starts its running minimum from a value that depends on the
// previous reps' sum (BIG while the sum is not negative, which it never
// is), so the compiler cannot run the reps' identical work once.

#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_chunk.cuh"

namespace {

using zr::chunk_test;
using zr::make_ray;
using zr::Ray;

constexpr int LANE = 128;
constexpr int N_ROWS = 17;
constexpr int BLOCK = 128;  // base, hoist, both
constexpr int BLOCK_R8 = 256;
constexpr int LANES_PER_RAY = 4;
constexpr float BIG = zr::FLASH_BIG;

constexpr int TILE_RT = 4;     // rays per warp, held by every lane
constexpr int TILE_WARPS = 8;  // most warps per block
constexpr int TILE_BUF = 3;    // chunks staged at once

enum Mode { BASE, HOIST, BOTH, R8, TILE, N_MODES };

template <int MODE>
__global__ void __launch_bounds__(BLOCK)
flash_body_kernel(const float* __restrict__ planes, int nchunk, const float* __restrict__ o,
                  const float* __restrict__ d, float* __restrict__ out, int n_rays, int reps) {
  __shared__ float tile[MODE == BOTH ? N_ROWS * LANE : 1];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int ray = i < n_rays ? i : n_rays - 1;  // both: idle threads still stage
  const size_t plane = (size_t)nchunk * LANE;
  Ray r;
  if (MODE != BASE) r = make_ray(o, d, ray);
  float acc = 0.0f;
#pragma unroll 1
  for (int rep = 0; rep < reps; ++rep) {
    if (MODE == BASE) r = make_ray(o, d, ray);
    float t_best = acc < 0.0f ? 0.0f : BIG;
#pragma unroll 1
    for (int c = 0; c < nchunk; ++c) {
      if (MODE == BOTH) {
        __syncthreads();
        for (int k = 0; k < N_ROWS; ++k)
          tile[k * LANE + threadIdx.x] = planes[k * plane + (size_t)c * LANE + threadIdx.x];
        __syncthreads();
        for (int j = 0; j < LANE; ++j) {
          const float t = chunk_test(r, [&](int k) { return tile[k * LANE + j]; }, t_best);
          t_best = t < t_best ? t : t_best;
        }
      } else {
        const float* q = planes + (size_t)c * LANE;
        for (int j = 0; j < LANE; ++j) {
          const float t =
              chunk_test(r, [&](int k) { return __ldg(q + k * plane + j); }, t_best);
          t_best = t < t_best ? t : t_best;
        }
      }
    }
    acc = acc + t_best;
  }
  if (i < n_rays) out[i] = acc;
}

// r8: LANES_PER_RAY lanes per ray, each testing every fourth triangle
__global__ void __launch_bounds__(BLOCK_R8)
flash_body_r8(const float* __restrict__ planes, int nchunk, const float* __restrict__ o,
              const float* __restrict__ d, float* __restrict__ out, int n_rays, int reps) {
  const int i = (blockIdx.x * blockDim.x + threadIdx.x) / LANES_PER_RAY;
  const int sub = threadIdx.x % LANES_PER_RAY;
  const Ray r = make_ray(o, d, i < n_rays ? i : n_rays - 1);  // idle lanes join the shuffles
  const size_t plane = (size_t)nchunk * LANE;
  float acc = 0.0f;
#pragma unroll 1
  for (int rep = 0; rep < reps; ++rep) {
    float t_best = acc < 0.0f ? 0.0f : BIG;
#pragma unroll 1
    for (int c = 0; c < nchunk; ++c) {
      const float* q = planes + (size_t)c * LANE;
      for (int j = sub; j < LANE; j += LANES_PER_RAY) {
        const float t = chunk_test(r, [&](int k) { return __ldg(q + k * plane + j); }, t_best);
        t_best = t < t_best ? t : t_best;
      }
    }
#pragma unroll
    for (int off = 1; off < LANES_PER_RAY; off <<= 1) {
      const float other = __shfl_xor_sync(0xffffffffu, t_best, off);
      t_best = other < t_best ? other : t_best;
    }
    acc = acc + t_best;
  }
  if (i < n_rays && sub == 0) out[i] = acc;
}

// tile: TILE_RT rays per warp in every lane's registers, the lanes over
// each chunk's triangles, the chunks staged in shared memory
__global__ void __launch_bounds__(32 * TILE_WARPS)
flash_body_tile(const float* __restrict__ planes, int nchunk, const float* __restrict__ o,
                const float* __restrict__ d, float* __restrict__ out, int n_rays, int reps) {
  __shared__ __align__(16) float tile[TILE_BUF][zr::N_PLANE_ROWS * LANE];
  const int lane = threadIdx.x % 32;
  const int ray0 = (blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32) * TILE_RT;
  const size_t plane = (size_t)nchunk * LANE;
  Ray r[TILE_RT];
  float acc[TILE_RT];
#pragma unroll
  for (int i = 0; i < TILE_RT; ++i) {  // rays past the end repeat the last one, unwritten
    r[i] = make_ray(o, d, ray0 + i < n_rays ? ray0 + i : n_rays - 1);
    acc[i] = 0.0f;
  }
  // stage s holds chunk s % nchunk of rep s / nchunk
  const int stages = reps * nchunk;
#pragma unroll
  for (int s = 0; s < TILE_BUF - 1; ++s) {
    if (s < stages) zr::stage_chunk<LANE>(tile[s], planes, plane, s % nchunk);
    zr::cp_async_commit();
  }
  int s = 0;
#pragma unroll 1
  for (int rep = 0; rep < reps; ++rep) {
    float tb[TILE_RT];
#pragma unroll
    for (int i = 0; i < TILE_RT; ++i) tb[i] = acc[i] < 0.0f ? 0.0f : BIG;
#pragma unroll 1
    for (int c = 0; c < nchunk; ++c, ++s) {
      zr::cp_async_wait<TILE_BUF - 2>();  // this thread's copies of stage s have landed
      __syncthreads();  // everyone's have, and stage s - 1's buffer is free
      const int next = s + TILE_BUF - 1;
      if (next < stages)
        zr::stage_chunk<LANE>(tile[next % TILE_BUF], planes, plane, next % nchunk);
      zr::cp_async_commit();
      zr::test_staged<TILE_RT, 32, LANE>(tile[s % TILE_BUF], lane, r, tb);
    }
#pragma unroll
    for (int i = 0; i < TILE_RT; ++i)
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float other = __shfl_xor_sync(0xffffffffu, tb[i], off);
        tb[i] = other < tb[i] ? other : tb[i];
      }
#pragma unroll
    for (int i = 0; i < TILE_RT; ++i) acc[i] = acc[i] + tb[i];
  }
#pragma unroll
  for (int i = 0; i < TILE_RT; ++i)
    if (lane == i && ray0 + i < n_rays) out[ray0 + i] = acc[i];
}

// zr::rcp_rn_fast against __frcp_rn on the floats with bits lo .. lo +
// count - 1: tally[0] += how many take the fast path, tally[1] += how many
// of those differ from __frcp_rn in any bit
__global__ void __launch_bounds__(256)
rcp_check_kernel(unsigned lo, unsigned count, unsigned long long* __restrict__ tally) {
  unsigned long long fast = 0, bad = 0;
  const unsigned long long stride = (unsigned long long)gridDim.x * blockDim.x;
  for (unsigned long long i = blockIdx.x * blockDim.x + threadIdx.x; i < count; i += stride) {
    const float x = __uint_as_float(lo + (unsigned)i);
    bool ok;
    const float r = zr::rcp_rn_fast(x, ok);
    if (ok) {
      ++fast;
      bad += __float_as_uint(r) != __float_as_uint(__frcp_rn(x));
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    fast += __shfl_xor_sync(0xffffffffu, fast, off);
    bad += __shfl_xor_sync(0xffffffffu, bad, off);
  }
  if (threadIdx.x % 32 == 0) {
    atomicAdd(tally, fast);
    atomicAdd(tally + 1, bad);
  }
}

}  // namespace

// tally (2,) uint64, added to: see rcp_check_kernel
extern "C" int zr_probe_rcp_check(unsigned lo, unsigned count, unsigned long long* tally,
                                  void* stream) {
  if (count == 0) return 0;
  rcp_check_kernel<<<132 * 8, 256, 0, (cudaStream_t)stream>>>(lo, count, tally);
  return (int)cudaGetLastError();
}

// mode: index into zraytrace_tpu_torch/probes/flash3_probe.py MODES;
// planes (17, nchunk, 128) f32 (16-byte aligned for tile), o and d
// (n_rays, 3) f32, out (n_rays,).
extern "C" int zr_probe_flash_body_launch(int mode, const float* planes, int nchunk,
                                          const float* o, const float* d, float* out,
                                          int n_rays, int reps, void* stream) {
  if (mode < 0 || mode >= N_MODES || nchunk < 0 || n_rays < 0 || reps < 0 ||
      (long long)n_rays * LANES_PER_RAY >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  if (n_rays == 0) return 0;
  if (mode == TILE && ((uintptr_t)planes & 15) != 0) return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = (cudaStream_t)stream;
  const int grid = (n_rays + BLOCK - 1) / BLOCK;
  switch (mode) {
    case BASE:
      flash_body_kernel<BASE><<<grid, BLOCK, 0, s>>>(planes, nchunk, o, d, out, n_rays, reps);
      break;
    case HOIST:
      flash_body_kernel<HOIST><<<grid, BLOCK, 0, s>>>(planes, nchunk, o, d, out, n_rays, reps);
      break;
    case BOTH:
      flash_body_kernel<BOTH><<<grid, BLOCK, 0, s>>>(planes, nchunk, o, d, out, n_rays, reps);
      break;
    case TILE: {
      // up to TILE_WARPS warps a block, fewer where that leaves SMs idle
      int dev = 0, sms = 0;
      cudaError_t err = cudaGetDevice(&dev);
      if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      if (err != cudaSuccess) return (int)err;
      const int warps = (n_rays + TILE_RT - 1) / TILE_RT;
      int per_block = warps / sms;
      per_block = per_block < 1 ? 1 : (per_block > TILE_WARPS ? TILE_WARPS : per_block);
      flash_body_tile<<<(warps + per_block - 1) / per_block, 32 * per_block, 0, s>>>(
          planes, nchunk, o, d, out, n_rays, reps);
      break;
    }
    default: {
      const int rays_per_block = BLOCK_R8 / LANES_PER_RAY;
      flash_body_r8<<<(n_rays + rays_per_block - 1) / rays_per_block, BLOCK_R8, 0, s>>>(
          planes, nchunk, o, d, out, n_rays, reps);
    }
  }
  return (int)cudaGetLastError();
}

extern "C" const char* zr_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
