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
// Design (redesigned for Hopper). A thread-block cluster of SHARES = 8
// CTAs of 128 threads takes one block of 512 rays; every thread of every
// CTA holds RT = 4 of its rays (t, t + 128, t + 256, t + 384) in
// registers, so each CTA holds the whole block. A warp-shuffle and
// shared-memory reduction gives the block's o and d ranges, the CTA's
// threads then compute the tool's reach of one chunk each, and one thread
// lists the reached chunks in order (4,096 chunks at a time, the list's
// shared memory; a larger mesh takes several such windows). Every CTA of the cluster computes the
// same list and walks all of it, but CTA k takes only its slice of each
// chunk, triangles 16k .. 16k + 15, so the eight CTAs split every visited
// chunk evenly whatever the number of visits (a split by whole chunks
// would leave 7 of 50 to some CTAs and 6 to others). The slices are
// staged in shared memory with cp.async three deep (the next two visited
// chunks' slices land while this one is tested) and tested with
// zr::test_staged: each triangle's 17 plane values, one shared-memory
// broadcast each, serve a thread's four rays. The CTAs' partial minimums
// meet through distributed shared memory: each CTA writes its 512 minima
// to its own shared memory, the cluster synchronises, and CTA k takes the
// minimum over the 8 CTAs of rays 64k .. 64k + 63 and writes them. Visits
// (the reached chunks, counted once per block) come from CTA 0. So the
// skip stays one decision per 512 rays (the TPU's pl.when on a scalar),
// each reached chunk is read from L2 once per block, and a block's work
// spreads over 32 warps on up to 8 SMs instead of 16 warps on one. The
// test is zr::chunk_hits (flash_chunk.cuh), the chunk-body probe's tile
// layout's. The port's kernels (csrc/tri_winner.cuh) cull per ray instead:
// each lane walks the chunks its own ray reaches, and lanes of a warp
// diverge.
//
// What bounds it: FP32 operations of the visited ray-triangle pairs, 40 a
// pair (flash3_probe.py's count; about 60 instructions with the
// comparisons and the reciprocal's refinement, at one instruction per
// multiply or add), so the bound depends on how many chunks the blocks'
// ranges reach: rays from random points in random directions span every
// direction in a block and reach every chunk, rays aimed away from the
// mesh reach none, and camera rays in 512-pixel blocks reach some. On an
// H100 80GB HBM3 at 700 W the 65,536 random rays (6,400 visits) take
// ~0.96 ms (0.25 ms bound; 0.50 at one instruction per operation), the
// camera rays (1,143 visits, one block reaching all 50 chunks) ~0.26 ms;
// the per-ray cull flash kernel takes ~0.19 and ~0.085 ms on the same rays.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_chunk.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int RB = 512;  // rays per block (the tool's RB)
constexpr int LANE = 128;
constexpr int RT = 4;                   // rays per thread
constexpr int THREADS = RB / RT;        // threads per CTA
constexpr int N_WARPS = THREADS / 32;
constexpr int SHARES = 8;               // CTAs per cluster, the shares of a block's chunks
constexpr int PER_SHARE = RB / SHARES;  // rays each CTA writes
constexpr int SLICE = LANE / SHARES;     // triangles of each chunk each CTA tests
constexpr int N_BUF = 3;                // chunks staged at once
constexpr int MAX_CHUNKS = 4096;        // chunks listed at once (8 KB of shared memory)
constexpr float BIG = zr::FLASH_BIG;

// o and d ranges: min of o xyz, d xyz, then max of the same
enum { N_RANGE = 12 };

__device__ __forceinline__ float fmin_(float a, float b) { return a < b ? a : b; }
__device__ __forceinline__ float fmax_(float a, float b) { return a > b ? a : b; }

// the tool's reach of chunk ci from the block's ranges (probe_cullwhen
// :285-306): does any ray of the range meet the chunk's box?
__device__ __forceinline__ bool reach(const float* __restrict__ bounds, int ci,
                                      const float (&omin)[3], const float (&omax)[3],
                                      const float (&dmin)[3], const float (&dmax)[3]) {
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
  return near <= far;
}

// WINDOWS: more than MAX_CHUNKS chunks, listed a window at a time (the
// loop over windows, compiled in, costs the one-window case ~4.5%)
template <bool WINDOWS>
__global__ void __cluster_dims__(SHARES, 1, 1) __launch_bounds__(THREADS)
cull_kernel(const float* __restrict__ planes, const float* __restrict__ bounds, int nchunk,
            const float* __restrict__ o, const float* __restrict__ d, float* __restrict__ out,
            int* __restrict__ visits) {
  __shared__ __align__(16) float tile[N_BUF][zr::N_PLANE_ROWS * SLICE];
  __shared__ float t_part[RB];
  __shared__ float part[N_WARPS][N_RANGE];
  __shared__ float range[N_RANGE];
  __shared__ unsigned short list[MAX_CHUNKS];  // reach flags, then the reached chunks
  __shared__ int n_reached;
  cg::cluster_group cluster = cg::this_cluster();
  const int share = (int)cluster.block_rank();
  const int block = blockIdx.x / SHARES;
  const int tid = threadIdx.x;
  zr::Ray r[RT];
#pragma unroll
  for (int i = 0; i < RT; ++i) r[i] = zr::make_ray(o, d, block * RB + tid + i * THREADS);
  float v[N_RANGE] = {r[0].ox, r[0].oy, r[0].oz, r[0].dx, r[0].dy, r[0].dz,
                      r[0].ox, r[0].oy, r[0].oz, r[0].dx, r[0].dy, r[0].dz};
#pragma unroll
  for (int i = 1; i < RT; ++i) {
    const float x[6] = {r[i].ox, r[i].oy, r[i].oz, r[i].dx, r[i].dy, r[i].dz};
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      v[k] = fmin_(v[k], x[k]);
      v[6 + k] = fmax_(v[6 + k], x[k]);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int k = 0; k < N_RANGE; ++k) {
      const float other = __shfl_xor_sync(0xffffffffu, v[k], off);
      v[k] = k < 6 ? fmin_(v[k], other) : fmax_(v[k], other);
    }
  }
  const int warp = tid / 32;
  if (tid % 32 == 0)
    for (int k = 0; k < N_RANGE; ++k) part[warp][k] = v[k];
  __syncthreads();
  if (tid < N_RANGE) {
    float x = part[0][tid];
    for (int w = 1; w < N_WARPS; ++w)
      x = tid < 6 ? fmin_(x, part[w][tid]) : fmax_(x, part[w][tid]);
    range[tid] = x;
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
  const int j0 = share * SLICE;
  const size_t plane = (size_t)nchunk * LANE;
  float tb[RT];
#pragma unroll
  for (int i = 0; i < RT; ++i) tb[i] = BIG;
  int visited = 0;
  // the chunks in windows of MAX_CHUNKS: reach flags, the list of the
  // reached ones, then their slices staged and tested
#pragma unroll 1
  for (int c0 = 0; c0 < (WINDOWS ? nchunk : 1); c0 += MAX_CHUNKS) {
    const int nc = !WINDOWS ? nchunk : nchunk - c0 < MAX_CHUNKS ? nchunk - c0 : MAX_CHUNKS;
    __syncthreads();  // the last window's list and staged slices are read
    for (int ci = tid; ci < nc; ci += THREADS)
      list[ci] = reach(bounds, c0 + ci, omin, omax, dmin, dmax);
    __syncthreads();
    if (tid == 0) {  // in place: entry n is written after flag n was read
      int n = 0;
      for (int ci = 0; ci < nc; ++ci)
        if (list[ci]) list[n++] = ci;
      n_reached = n;
    }
    __syncthreads();
    const int reached = n_reached;
#pragma unroll
    for (int s = 0; s < N_BUF - 1; ++s) {
      if (s < reached) zr::stage_chunk<SLICE>(tile[s], planes, plane, c0 + list[s], j0);
      zr::cp_async_commit();
    }
#pragma unroll 1
    for (int s = 0; s < reached; ++s) {
      zr::cp_async_wait<N_BUF - 2>();  // this thread's copies of chunk s have landed
      __syncthreads();  // everyone's have, and chunk s - 1's buffer is free
      const int next = s + N_BUF - 1;
      if (next < reached)
        zr::stage_chunk<SLICE>(tile[next % N_BUF], planes, plane, c0 + list[next], j0);
      zr::cp_async_commit();
      zr::test_staged<RT, 1, SLICE>(tile[s % N_BUF], 0, r, tb);
    }
    visited += reached;
  }
#pragma unroll
  for (int i = 0; i < RT; ++i) t_part[tid + i * THREADS] = tb[i];
  cluster.sync();  // every CTA's minima are written
  for (int q = tid; q < PER_SHARE; q += THREADS) {
    const int ray = share * PER_SHARE + q;
    float best = BIG;
#pragma unroll
    for (int k = 0; k < SHARES; ++k) {
      const float x = cluster.map_shared_rank(t_part, k)[ray];
      best = x < best ? x : best;
    }
    out[block * RB + ray] = best;
  }
  if (share == 0 && tid == 0) visits[block] = visited;
  cluster.sync();  // no CTA leaves while another reads its minima
}

}  // namespace

// planes (n_comp >= 17, nchunk, 128) f32, 16-byte aligned (rows 0-16
// read), bounds (nchunk, 8) f32 [lo3, hi3, -, -], o and d (n_rays, 3) f32
// with n_rays a multiple of 512; out (n_rays,) f32, visits (n_rays / 512,)
// int32.
extern "C" int zr_probe_flash_cull_launch(const float* planes, const float* bounds, int nchunk,
                                          const float* o, const float* d, float* out,
                                          int* visits, int n_rays, void* stream) {
  if (nchunk < 0 || n_rays < 0 || n_rays % RB != 0)
    return (int)cudaErrorInvalidValue;
  if (((uintptr_t)planes & 15) != 0) return (int)cudaErrorMisalignedAddress;
  if (n_rays == 0) return 0;
  if (nchunk > MAX_CHUNKS)
    cull_kernel<true><<<n_rays / RB * SHARES, THREADS, 0, (cudaStream_t)stream>>>(
        planes, bounds, nchunk, o, d, out, visits);
  else
    cull_kernel<false><<<n_rays / RB * SHARES, THREADS, 0, (cudaStream_t)stream>>>(
        planes, bounds, nchunk, o, d, out, visits);
  return (int)cudaGetLastError();
}

extern "C" const char* zr_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
