// Kernel-capability micro-benchmark for Hopper (sm_90a): the five things
// the bounce kernel needs inside a kernel, each on (64, 128) = 8,192 lanes.
//
// Replaces the TPU probe tools/pallas_probe.py (its pallas_calls :56, :75,
// :95, :113, :134), which asked whether Mosaic could lower them at all:
//   while     out = sum of x over a loop whose trip count (10) is a kernel
//             argument read at run time, not a template constant (:42-64);
//   gather1d  out[i] = tbl[idx[i]] from a 4,096-f32 table (:67-83);
//   gather2d  the same from a (32, 128) table indexed [idx >> 7][idx & 127]
//             (:86-105);
//   philox    (64, 128) uint32 random bits made on chip (:108-122). The card
//             has no hardware generator: its counterpart is a counter-based
//             generator held in registers, Philox4x32-10 (Salmon et al.,
//             SC'11; the family of CUDA's device generator) with key =
//             (seed, 0) and counter = (lane, 0, 0, 0), the lane index read
//             from an input; a lane keeps the first word;
//   pcg4d     uniform4(42, px, 3, 1, STREAM_SCATTER).x for px = lane, through
//             bounce_common.cuh's PCG4D, the bounce kernel's own (:125-143).
//
// Design. One thread per lane, 256 threads a block. Both gathers stage the
// whole 16 KB table in shared memory per block (the TPU's VMEM table),
// then read it at the lane's index: a shared-memory gather is one load
// whatever the index pattern, at the cost of bank conflicts. Everything
// else lives in registers.
//
// What bounds it: at 8,192 lanes a launch fills 32 blocks of 132 SMs, so
// its time is the launch and one pass of latency (tens of loads, a few
// hundred integer operations a lane), not bandwidth or peak rate: the
// bytes (48-80 KB) take ~0.02 us at 3.35 TB/s.
//
// Numerics: every result is an integer or a separately rounded f32 sum
// (-fmad=false), so the plain version equals it bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bounce_common.cuh"

namespace {

constexpr int BLOCK = 256;
constexpr int TABLE = 4096;  // f32 entries of the gather tables
constexpr int TABLE_W = 128;  // width of the 2-D table
constexpr uint32_t STREAM_SCATTER = 0x85EBCA6Bu;  // zraytrace_tpu_torch/rng.py
constexpr uint32_t PCG_SAMPLE = 3, PCG_BOUNCE = 1;

// Philox4x32-10 constants (Salmon, Moraes, Dror, Shaw, SC'11)
constexpr uint32_t PHILOX_M0 = 0xD2511F53u, PHILOX_M1 = 0xCD9E8D57u;
constexpr uint32_t PHILOX_W0 = 0x9E3779B9u, PHILOX_W1 = 0xBB67AE85u;

enum Mode { WHILE, GATHER1D, GATHER2D, PHILOX, PCG4D, N_MODES };

__global__ void __launch_bounds__(BLOCK)
while_kernel(const float* __restrict__ x, float* __restrict__ out, int n, int trips) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  const float v = x[e];
  float acc = 0.0f;
  int i = 0;
  while (i < trips) {
    acc = acc + v;
    ++i;
  }
  out[e] = acc;
}

__global__ void __launch_bounds__(BLOCK)
gather1d_kernel(const float* __restrict__ tbl, const int* __restrict__ idx,
                float* __restrict__ out, int n) {
  __shared__ float s[TABLE];
  for (int k = threadIdx.x; k < TABLE; k += BLOCK) s[k] = tbl[k];
  __syncthreads();
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e < n) out[e] = s[idx[e] & (TABLE - 1)];
}

__global__ void __launch_bounds__(BLOCK)
gather2d_kernel(const float* __restrict__ tbl, const int* __restrict__ idx,
                float* __restrict__ out, int n) {
  __shared__ float s[TABLE / TABLE_W][TABLE_W];
  for (int k = threadIdx.x; k < TABLE; k += BLOCK) s[k / TABLE_W][k % TABLE_W] = tbl[k];
  __syncthreads();
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e < n) {
    const int id = idx[e] & (TABLE - 1);
    out[e] = s[id >> 7][id & (TABLE_W - 1)];
  }
}

// one Philox4x32 round on counter c with key (k0, k1)
__device__ __forceinline__ uint4 philox_round(uint4 c, uint32_t k0, uint32_t k1) {
  const uint32_t hi0 = __umulhi(PHILOX_M0, c.x), lo0 = PHILOX_M0 * c.x;
  const uint32_t hi1 = __umulhi(PHILOX_M1, c.z), lo1 = PHILOX_M1 * c.z;
  return make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
}

__global__ void __launch_bounds__(BLOCK)
philox_kernel(const uint32_t* __restrict__ ctr, uint32_t* __restrict__ out, int n,
              uint32_t seed) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  uint4 c = make_uint4(ctr[e], 0u, 0u, 0u);
  uint32_t k0 = seed, k1 = 0u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k0 += PHILOX_W0;
      k1 += PHILOX_W1;
    }
    c = philox_round(c, k0, k1);
  }
  out[e] = c.x;
}

__global__ void __launch_bounds__(BLOCK)
pcg4d_kernel(const uint32_t* __restrict__ px, float* __restrict__ out, int n, uint32_t seed) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  out[e] = zr::uniform4(seed ^ STREAM_SCATTER, px[e], PCG_SAMPLE, PCG_BOUNCE).x;
}

}  // namespace

// mode: index into zraytrace_tpu_torch/probes/pallas_probe.py MODES.
// WHILE: a = x f32, out f32, param = trip count; GATHER1D / GATHER2D:
// a = the 4,096-f32 table, b = int32 ids (masked to [0, 4096), which
// changes no id the tool draws), out f32; PHILOX: a = the counters
// uint32 (the lane index), out uint32, param = seed; PCG4D: a = px uint32,
// out f32, param = seed.
// Every array holds n lanes.
extern "C" int zr_probe_pallas_launch(int mode, const void* a, const int* b, void* out, int n,
                                      int param, void* stream) {
  if (mode < 0 || mode >= N_MODES || n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int grid = (n + BLOCK - 1) / BLOCK;
  switch (mode) {
    case WHILE:
      while_kernel<<<grid, BLOCK, 0, s>>>((const float*)a, (float*)out, n, param);
      break;
    case GATHER1D:
      gather1d_kernel<<<grid, BLOCK, 0, s>>>((const float*)a, b, (float*)out, n);
      break;
    case GATHER2D:
      gather2d_kernel<<<grid, BLOCK, 0, s>>>((const float*)a, b, (float*)out, n);
      break;
    case PHILOX:
      philox_kernel<<<grid, BLOCK, 0, s>>>((const uint32_t*)a, (uint32_t*)out, n,
                                           (uint32_t)param);
      break;
    default:
      pcg4d_kernel<<<grid, BLOCK, 0, s>>>((const uint32_t*)a, (float*)out, n, (uint32_t)param);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* zr_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
