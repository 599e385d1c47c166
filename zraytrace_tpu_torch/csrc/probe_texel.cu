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
// Design. One thread per output element; each round reads its element's
// table entry with __ldg through L1/L2. Nothing is staged in shared
// memory: the atlas is 2^19 x 4 B = 2 MB (and the widest dg1 table 16 MB),
// far above the 227 KB a block can hold, while the whole of either sits in
// the 50 MB L2. The relayout of reshape_rt moves no data on this card: a
// thread's element has the same address in both shapes, so only the
// arithmetic is ported, and the line prices the chain alone.
//
// What bounds it: bytes and latency, not operations. Each round is one
// dependent global (L2) read and a handful of integer and FP32 operations
// per element; with the tool's shapes (4,096-8,192 threads) a launch fills
// 16-32 blocks of 132 SMs, so the L2 latency of each round, not its
// bandwidth, sets the time.
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
// channel is a correctly rounded division by 255, as in the plain version.

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

// out (3, n): the unpacked channels of atlas[(idx + i) & (F - 1)] summed
__global__ void __launch_bounds__(BLOCK)
e2e_kernel(const int* __restrict__ atlas, int f, const int* __restrict__ idx,
           float* __restrict__ out, int n, int rounds) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  const int id = idx[e];
  float ar = 0.0f, ag = 0.0f, ab = 0.0f;
  for (int i = 0; i < rounds; ++i) {
    const int got = __ldg(atlas + ((id + i) & (f - 1)));
    ar = ar + (float)((got >> 16) & 255) / 255.0f;
    ag = ag + (float)((got >> 8) & 255) / 255.0f;
    ab = ab + (float)(got & 255) / 255.0f;
  }
  out[e] = ar;
  out[n + e] = ag;
  out[2 * (size_t)n + e] = ab;
}

}  // namespace

// mode DG1: table (rows, width) f32, idx and out (rows, cols);
// RESHAPE_RT: table is x (rows, cols) f32, idx unused;
// E2E_ATLAS: table is the (width,) int32 atlas, idx (rows, cols), out
// (3, rows, cols). width must be a power of two for DG1 and E2E_ATLAS.
extern "C" int zr_probe_texel_launch(int mode, const void* table, const int* idx, float* out,
                                     int rows, int width, int cols, int rounds, void* stream) {
  const long long n = (long long)rows * cols;
  if (mode < 0 || mode >= N_MODES || rows < 0 || cols < 0 || rounds < 0 || n >= (1LL << 31) ||
      (mode != RESHAPE_RT && (width <= 0 || (width & (width - 1)) != 0)))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const int grid = (int)((n + BLOCK - 1) / BLOCK);
  cudaStream_t s = (cudaStream_t)stream;
  if (mode == DG1) {
    dg1_kernel<<<grid, BLOCK, 0, s>>>((const float*)table, idx, out, rows, width, cols, rounds);
  } else if (mode == RESHAPE_RT) {
    reshape_kernel<<<grid, BLOCK, 0, s>>>((const float*)table, out, (int)n, rounds);
  } else {
    e2e_kernel<<<grid, BLOCK, 0, s>>>((const int*)table, width, idx, out, (int)n, rounds);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* zr_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
