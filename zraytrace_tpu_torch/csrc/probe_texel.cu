// In-kernel texel-fetch micro-benchmark for Hopper (sm_90a): what does a
// gather from a table in device memory cost inside a kernel, against
// PyTorch's library gather?
//
// Replaces the TPU probe tools/inkernel_texel_probe.py:82-91 (_pallas, a
// whole-array VMEM pallas_call) and the probes built on it (:103-203):
//   dg1         take_along_axis of an (R, W) f32 table by (R, NI) int32
//               ids, K = 32 rounds with the ids rotated by the round;
//   reshape_rt  the (64,128) -> (1, 8192) -> (64,128) relayout round trip
//               around (acc + x) * 1.0000001;
//   e2e_atlas   (64, 128) flat texel ids gathered from a (1, 2^19) packed
//               u32 atlas (r << 16 | g << 8 | b) and unpacked to 3 f32
//               channels, summed over K rounds.
//
// Design of dg1 and reshape_rt. One thread per output element; each round
// reads its element's table entry with __ldg through L1/L2. Nothing is
// staged in shared memory: the atlas is 2^19 x 4 B = 2 MB (and the widest
// dg1 table 16 MB), far above the 227 KB a block can hold, while the whole
// of either sits in the 50 MB L2. The relayout of reshape_rt moves no data
// on this card: a thread's element has the same address in both shapes,
// so only the arithmetic is ported, and the line prices the chain alone.
//
// Design of e2e_atlas (redesigned for Hopper). A warp takes 32 ids at a
// time and its lanes run over the rounds: for each of the 32 ids the lanes
// load rounds r0 .. r0 + 31, 32 consecutive texels, so a warp load touches
// one or two lines (a thread per id touches 32, one L1 wavefront each),
// and all 32 loads are in flight before the first is used. A padded 32 x
// 33 transpose in shared memory then hands lane j its id's 32 texels,
// which it adds in round order (round 0 first, as the plain version does),
// 32 rounds per pass for any round count. The channel value c / 255 comes
// from a 256-entry table the wrapper makes with the plain version's own
// correctly rounded division, so it is bit-equal by construction and takes
// the place of three divisions per texel; the block keeps it once per bank
// (sc[c * 32 + lane]), so a warp's 32 lookups never conflict. Blocks of
// two warps walk the ids' warps with a grid stride, at most as many blocks
// as the card holds at once, so the table is staged once per block, and
// the tool's 8,192 ids still spread over 128 SMs.
//
// What bounds e2e_atlas: at 8,192 ids the launch and one L2 round trip per
// pass (0.0043 ms on an H100 80GB HBM3 at 700 W, 15x the bytes' bound,
// which lies below a launch's latency); at 1M ids the L2 reads (4 bytes
// per texel, 32 per id) and the shared-memory pipe (the transpose and the
// three lookups per texel; 0.053 ms, 9x the bytes' bound).
//
// How the TPU variants map to this card. On the TPU the question was
// whether Mosaic lowers a lane gather whose index range exceeds 128, and
// whether its cost grows with W; here any index range is one load, so
// wide_dg1_W and blk_dg1_W ask how the cost grows as the table leaves
// L1 (256 KB per SM) for L2; row1_dg1 is the whole atlas as one row;
// e2e_atlas is the bounce kernel's own texel read (csrc/bounce_kernel.cu
// reads a textured hit's texel with __ldg); the TPU's XLA row gather
// (xla_ref) becomes the library row, PyTorch's atlas[idx].
//
// Numerics: the adds run in the tool's order (round 0 first) and the
// channel is a correctly rounded division by 255 (e2e_atlas: read from the
// wrapper's table of those quotients), as in the plain version.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 256;

enum Mode { DG1, RESHAPE_RT, E2E_ATLAS, N_MODES };

// out[r, j] = sum_i tbl[r, (idx[r, j] + i) & (W - 1)]
__global__ void __launch_bounds__(BLOCK)
dg1_kernel(const float* __restrict__ tbl, const int* __restrict__ idx,
           float* __restrict__ out, int rows, int w, int cols, int rounds) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= rows * cols) return;
  const float* row = tbl + (size_t)(e / cols) * w;
  const int id = idx[e];
  float acc = 0.0f;
  for (int i = 0; i < rounds; ++i) acc = acc + __ldg(row + ((id + i) & (w - 1)));
  out[e] = acc;
}

__global__ void __launch_bounds__(BLOCK)
reshape_kernel(const float* __restrict__ x, float* __restrict__ out, int n, int rounds) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  const float v = x[e];
  float acc = 0.0f;
  for (int i = 0; i < rounds; ++i) acc = (acc + v) * 1.0000001f;
  out[e] = acc;
}

constexpr unsigned FULL = 0xffffffffu;
constexpr int E2E_WARPS = 2;  // warps per block
constexpr int E2E_BLOCK = 32 * E2E_WARPS;
constexpr int N_CHAN = 256;

// out (3, n): the unpacked channels of atlas[(idx + i) & (F - 1)] summed
// over rounds i in order; chan[c] = c / 255 (256 floats)
__global__ void __launch_bounds__(E2E_BLOCK)
e2e_kernel(const int* __restrict__ atlas, int f, const int* __restrict__ idx,
           const float* __restrict__ chan, float* __restrict__ out, int n, int rounds) {
  __shared__ float4 sc4[N_CHAN * 32 / 4];    // the table once per bank: entry c at c * 32 + lane
  __shared__ int sg[E2E_WARPS][32][33];       // texels [id][round], padded: both passes conflict-free
  for (int e = threadIdx.x; e < N_CHAN * 8; e += E2E_BLOCK) {
    const float v = __ldg(chan + e / 8);
    sc4[e] = make_float4(v, v, v, v);
  }
  __syncthreads();
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
  const float* sc = reinterpret_cast<const float*>(sc4) + lane;
  int(*tile)[33] = sg[w];
  // warp-uniform: every lane of a warp walks the same groups of 32 ids
  for (int e0 = (blockIdx.x * E2E_WARPS + w) * 32; e0 < n; e0 += gridDim.x * E2E_BLOCK) {
    const int e = e0 + lane;
    const int my = e < n ? __ldg(idx + e) : 0;  // a missing id loads texels it never stores
    float ar = 0.0f, ag = 0.0f, ab = 0.0f;
    for (int r0 = 0; r0 < rounds; r0 += 32) {
      const int i = r0 + lane;  // this lane's round; lanes past the last load and are not summed
      int got[32];
#pragma unroll
      for (int j = 0; j < 32; ++j) got[j] = __ldg(atlas + ((__shfl_sync(FULL, my, j) + i) & (f - 1)));
#pragma unroll
      for (int j = 0; j < 32; ++j) tile[j][lane] = got[j];
      __syncwarp();
      const int* mine = tile[lane];
      auto add = [&](int g) {
        ar = ar + sc[32 * ((g >> 16) & 255)];
        ag = ag + sc[32 * ((g >> 8) & 255)];
        ab = ab + sc[32 * (g & 255)];
      };
      if (rounds - r0 >= 32) {
#pragma unroll
        for (int q = 0; q < 32; ++q) add(mine[q]);
      } else {
        for (int q = 0; q < rounds - r0; ++q) add(mine[q]);
      }
      __syncwarp();
    }
    if (e < n) {
      out[e] = ar;
      out[(size_t)n + e] = ag;
      out[2 * (size_t)n + e] = ab;
    }
  }
}

}  // namespace

// mode DG1: table (rows, width) f32, idx and out (rows, cols);
// RESHAPE_RT: table is x (rows, cols) f32, idx unused;
// E2E_ATLAS: table is the (width,) int32 atlas, idx (rows, cols), chan the
// 256 f32 channel values c / 255, out (3, rows, cols). width must be a
// power of two for DG1 and E2E_ATLAS; chan is read by E2E_ATLAS alone.
extern "C" int zr_probe_texel_launch(int mode, const void* table, const int* idx,
                                     const float* chan, float* out, int rows, int width, int cols,
                                     int rounds, void* stream) {
  const long long n = (long long)rows * cols;
  if (mode < 0 || mode >= N_MODES || rows < 0 || cols < 0 || rounds < 0 || n >= (1LL << 31) ||
      (mode != RESHAPE_RT && (width <= 0 || (width & (width - 1)) != 0)) ||
      (mode == E2E_ATLAS && chan == nullptr))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const int grid = (int)((n + BLOCK - 1) / BLOCK);
  cudaStream_t s = (cudaStream_t)stream;
  if (mode == DG1) {
    dg1_kernel<<<grid, BLOCK, 0, s>>>((const float*)table, idx, out, rows, width, cols, rounds);
  } else if (mode == RESHAPE_RT) {
    reshape_kernel<<<grid, BLOCK, 0, s>>>((const float*)table, out, (int)n, rounds);
  } else {
    // as many blocks as the card holds at once, or one per two warps of ids
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, e2e_kernel, E2E_BLOCK, 0);
    if (err != cudaSuccess) return (int)err;
    const long long need = (n + E2E_BLOCK - 1) / E2E_BLOCK;
    const int blocks = (int)(need < (long long)sms * per_sm ? need : (long long)sms * per_sm);
    e2e_kernel<<<blocks > 0 ? blocks : 1, E2E_BLOCK, 0, s>>>((const int*)table, width, idx, chan,
                                                             out, (int)n, rounds);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* zr_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
