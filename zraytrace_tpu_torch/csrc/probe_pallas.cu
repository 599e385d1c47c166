// Kernel-capability micro-benchmark for Hopper (sm_90a): the five things
// the bounce kernel needs inside a kernel, each on the tool's (64, 128) =
// 8,192 lanes and on 2^20 lanes, about the bounce kernel's own.
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
// Design (redesigned for Hopper at the bounce kernel's 2^20 lanes, where
// the parent's one thread per lane in 4,096 blocks sat at the launch floor
// of that grid, 3.2 us, and its gathers staged the 16 KB table in every
// block: 64 MB of L2 reads for 8 MB of work). Where the lanes give every
// SM at least a block of quads, four lanes a thread: each thread's lanes
// moved as one 16-byte load and store, the four lanes' work interleaved
// (four independent chains in flight), a grid of at most 8 blocks an SM
// walking the lanes, the last n mod 4 lanes one at a time; the gathers
// stage the table once per resident block (two blocks of 512 threads an
// SM) and gather from shared memory (the table through L1 with __ldg
// instead: 0.0040 against 0.0033 ms on an H100 80GB HBM3 at 700 W).
// Below that (the tool's 8,192 lanes) one lane a thread in blocks of 256,
// as many as the lanes need, the gathers reading the table through L1: a
// launch there is its floor, and four lanes a thread, or a staged table,
// only lengthened it. The while
// loop's trip count stays a kernel argument; the four-lane loop is kept
// (unroll 1) so that every trip is a trip.
//
// What bounds it: at 2^20 lanes the bytes (8 MB: the lanes' input and
// output, and the 16 KB table) take 2.5 us at 3.35 TB/s, above the
// operations (Philox 87 and PCG4D 28 int32 operations a lane, priced at
// the FP32 rate: 1.4 and 0.4 us); graph timing reuses the inputs, so they
// come from L2. At the tool's 8,192 lanes a launch is its floor.
//
// Numerics: every result is an integer or a separately rounded f32 sum
// (-fmad=false), so the plain version equals it bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bounce_common.cuh"

namespace {

constexpr int BLOCK = 256;
constexpr int PER_SM = 2048 / BLOCK;  // resident blocks an SM
constexpr int GATHER_BLOCK = 512;
constexpr int GATHER_PER_SM = 2;
constexpr int TABLE = 4096;  // f32 entries of the gather tables
constexpr uint32_t STREAM_SCATTER = 0x85EBCA6Bu;  // zraytrace_tpu_torch/rng.py
constexpr uint32_t PCG_SAMPLE = 3, PCG_BOUNCE = 1;

// Philox4x32-10 constants (Salmon, Moraes, Dror, Shaw, SC'11)
constexpr uint32_t PHILOX_M0 = 0xD2511F53u, PHILOX_M1 = 0xCD9E8D57u;
constexpr uint32_t PHILOX_W0 = 0x9E3779B9u, PHILOX_W1 = 0xBB67AE85u;

enum Mode { WHILE, GATHER1D, GATHER2D, PHILOX, PCG4D, N_MODES };

// Apply f to every lane, Q (4 or 1) a thread: a thread's lanes t*Q ..
// t*Q + Q - 1, grid-stride; with Q = 4 the n mod 4 left go one at a time
// to the first thread. f(e0, k) handles lanes e0 .. e0 + k - 1 (k = Q or 1).
template <int Q, typename F>
__device__ __forceinline__ void for_lanes(int n, F f) {
  const int groups = n / Q;
  const int first = blockIdx.x * blockDim.x + threadIdx.x;
  for (int t = first; t < groups; t += gridDim.x * blockDim.x) f(Q * t, Q);
  if (Q > 1 && first == 0)
    for (int e = Q * groups; e < n; ++e) f(e, 1);
}

template <int Q>
__global__ void __launch_bounds__(BLOCK)
while_kernel(const float* __restrict__ x, float* __restrict__ out, int n, int trips) {
  for_lanes<Q>(n, [&](int e, int k) {
    if (k == 4) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(x + e));
      float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      int i = 0;
#pragma unroll 1
      while (i < trips) {
        acc.x = acc.x + v.x;
        acc.y = acc.y + v.y;
        acc.z = acc.z + v.z;
        acc.w = acc.w + v.w;
        ++i;
      }
      *reinterpret_cast<float4*>(out + e) = acc;
    } else {
      const float v = x[e];
      float acc = 0.0f;
      int i = 0;
      while (i < trips) {
        acc = acc + v;
        ++i;
      }
      out[e] = acc;
    }
  });
}

// the 1-D and 2-D gathers: the 2-D table [id >> 7][id & 127] is the 1-D
// one at id (row-major, 128 wide), so both read tbl[id & 4095]; STAGE
// copies the table to shared memory first (once per resident block),
// otherwise each lane reads it with __ldg through L1
template <int Q, bool STAGE>
__global__ void __launch_bounds__(GATHER_BLOCK)
gather_kernel(const float* __restrict__ tbl, const int* __restrict__ idx,
              float* __restrict__ out, int n) {
  __shared__ float4 s4[STAGE ? TABLE / 4 : 1];
  if (STAGE) {
    for (int k = threadIdx.x; k < TABLE / 4; k += blockDim.x)
      s4[k] = __ldg(reinterpret_cast<const float4*>(tbl) + k);
    __syncthreads();
  }
  const float* s = reinterpret_cast<const float*>(s4);
  auto at = [&](int id) { return STAGE ? s[id & (TABLE - 1)] : __ldg(tbl + (id & (TABLE - 1))); };
  for_lanes<Q>(n, [&](int e, int k) {
    if (k == 4) {
      const int4 id = __ldg(reinterpret_cast<const int4*>(idx + e));
      *reinterpret_cast<float4*>(out + e) = make_float4(at(id.x), at(id.y), at(id.z), at(id.w));
    } else {
      out[e] = at(idx[e]);
    }
  });
}

// one Philox4x32 round on counter c with key (k0, k1)
__device__ __forceinline__ uint4 philox_round(uint4 c, uint32_t k0, uint32_t k1) {
  const uint32_t hi0 = __umulhi(PHILOX_M0, c.x), lo0 = PHILOX_M0 * c.x;
  const uint32_t hi1 = __umulhi(PHILOX_M1, c.z), lo1 = PHILOX_M1 * c.z;
  return make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
}

// the first word of Philox4x32-10 with key (seed, 0) and counter (ctr, 0, 0, 0)
__device__ __forceinline__ uint32_t philox_x(uint32_t ctr, uint32_t seed) {
  uint4 c = make_uint4(ctr, 0u, 0u, 0u);
  uint32_t k0 = seed, k1 = 0u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k0 += PHILOX_W0;
      k1 += PHILOX_W1;
    }
    c = philox_round(c, k0, k1);
  }
  return c.x;
}

template <int Q>
__global__ void __launch_bounds__(BLOCK)
philox_kernel(const uint32_t* __restrict__ ctr, uint32_t* __restrict__ out, int n,
              uint32_t seed) {
  for_lanes<Q>(n, [&](int e, int k) {
    if (k == 4) {
      const uint4 c = __ldg(reinterpret_cast<const uint4*>(ctr + e));
      *reinterpret_cast<uint4*>(out + e) = make_uint4(philox_x(c.x, seed), philox_x(c.y, seed),
                                                      philox_x(c.z, seed), philox_x(c.w, seed));
    } else {
      out[e] = philox_x(ctr[e], seed);
    }
  });
}

__device__ __forceinline__ float pcg4d_x(uint32_t px, uint32_t seed) {
  return zr::uniform4(seed ^ STREAM_SCATTER, px, PCG_SAMPLE, PCG_BOUNCE).x;
}

template <int Q>
__global__ void __launch_bounds__(BLOCK)
pcg4d_kernel(const uint32_t* __restrict__ px, float* __restrict__ out, int n, uint32_t seed) {
  for_lanes<Q>(n, [&](int e, int k) {
    if (k == 4) {
      const uint4 p = __ldg(reinterpret_cast<const uint4*>(px + e));
      *reinterpret_cast<float4*>(out + e) = make_float4(pcg4d_x(p.x, seed), pcg4d_x(p.y, seed),
                                                        pcg4d_x(p.z, seed), pcg4d_x(p.w, seed));
    } else {
      out[e] = pcg4d_x(px[e], seed);
    }
  });
}

// The launch floor: a kernel that does nothing, launched with a probe
// launch's grid and block.
__global__ void floor_kernel() {}


struct Config {
  int grid, block, lanes;  // lanes a thread: 4, or 1 for a launch too small to fill the card
};

// Four lanes a thread (the gathers staging the table) once the launch has
// at least a block of quads for every SM; below that one lane a thread, as
// many blocks as that gives, the gathers reading the table through L1.
cudaError_t config(int mode, int n, Config* c) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const bool gather = mode == GATHER1D || mode == GATHER2D;
  c->lanes = n / 4 >= sms * BLOCK ? 4 : 1;
  if (c->lanes == 1) {
    *c = {max(1, (n + BLOCK - 1) / BLOCK), BLOCK, 1};
  } else {
    c->block = gather ? GATHER_BLOCK : BLOCK;
    c->grid = min((n / 4 + c->block - 1) / c->block, sms * (gather ? GATHER_PER_SM : PER_SM));
  }
  return cudaSuccess;
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

}  // namespace

// mode: index into zraytrace_tpu_torch/probes/pallas_probe.py MODES.
// WHILE: a = x f32, out f32, param = trip count; GATHER1D / GATHER2D:
// a = the 4,096-f32 table, b = int32 ids (masked to [0, 4096), which
// changes no id the tool draws), out f32; PHILOX: a = the counters
// uint32 (the lane index), out uint32, param = seed; PCG4D: a = px uint32,
// out f32, param = seed.
// Every array holds n lanes; a, b and out must be 16-byte aligned
// (cudaErrorMisalignedAddress otherwise; nothing runs).
extern "C" int zr_probe_pallas_launch(int mode, const void* a, const int* b, void* out, int n,
                                      int param, void* stream) {
  if (mode < 0 || mode >= N_MODES || n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  if (!aligned16(a) || !aligned16(b) || !aligned16(out)) return (int)cudaErrorMisalignedAddress;
  Config c;
  const cudaError_t err = config(mode, n, &c);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  const int g = c.grid, t = c.block;
  const bool quad = c.lanes == 4;
  switch (mode) {
    case WHILE:
      if (quad) while_kernel<4><<<g, t, 0, s>>>((const float*)a, (float*)out, n, param);
      else while_kernel<1><<<g, t, 0, s>>>((const float*)a, (float*)out, n, param);
      break;
    case GATHER1D:
    case GATHER2D:
      if (quad) gather_kernel<4, true><<<g, t, 0, s>>>((const float*)a, b, (float*)out, n);
      else gather_kernel<1, false><<<g, t, 0, s>>>((const float*)a, b, (float*)out, n);
      break;
    case PHILOX:
      if (quad)
        philox_kernel<4><<<g, t, 0, s>>>((const uint32_t*)a, (uint32_t*)out, n, (uint32_t)param);
      else
        philox_kernel<1><<<g, t, 0, s>>>((const uint32_t*)a, (uint32_t*)out, n, (uint32_t)param);
      break;
    default:
      if (quad)
        pcg4d_kernel<4><<<g, t, 0, s>>>((const uint32_t*)a, (float*)out, n, (uint32_t)param);
      else
        pcg4d_kernel<1><<<g, t, 0, s>>>((const uint32_t*)a, (float*)out, n, (uint32_t)param);
  }
  return (int)cudaGetLastError();
}

// The launch floor of zr_probe_pallas_launch(mode, ..., n, ...):
// floor_kernel with the same grid and block.
extern "C" int zr_probe_pallas_floor(int mode, int n, void* stream) {
  if (mode < 0 || mode >= N_MODES || n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  Config c;
  const cudaError_t err = config(mode, n, &c);
  if (err != cudaSuccess) return (int)err;
  floor_kernel<<<c.grid, c.block, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

extern "C" const char* zr_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
