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
// this card each stands for the question it asks here:
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
//          times the threads per ray (the "more threads per ray" lever).
//
// Every mode tests every triangle with the tool's branch-free arithmetic
// (zr::chunk_test in flash_chunk.cuh; no per-ray cull, no early exit), so the modes differ only in layout and
// all return the same sums, bit for bit: each t is computed in the same
// order, with -fmad=false, and a minimum is exact whatever the order.
//
// What bounds it: FP32 operations (40 per ray-triangle pair, one of them
// a division) against 8.7 KB of planes per chunk: an H100 needs ~0.001 ms
// to read R = 32,768 rays' inputs and ~1 ms for their 1.68e9 pairs x 8
// reps of arithmetic. At the tool's 512 rays a launch fills 4 of the 132
// SMs (base, hoist, both: 128-thread blocks) or 8 (r8), so it measures
// one SM's pipeline latency; at 32,768 rays it fills the card.
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

enum Mode { BASE, HOIST, BOTH, R8, N_MODES };

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

}  // namespace

// mode: index into zraytrace_tpu_torch/probes/flash3_probe.py MODES;
// planes (17, nchunk, 128) f32, o and d (n_rays, 3) f32, out (n_rays,).
extern "C" int zr_probe_flash_body_launch(int mode, const float* planes, int nchunk,
                                          const float* o, const float* d, float* out,
                                          int n_rays, int reps, void* stream) {
  if (mode < 0 || mode >= N_MODES || nchunk < 0 || n_rays < 0 || reps < 0 ||
      (long long)n_rays * LANES_PER_RAY >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  if (n_rays == 0) return 0;
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
