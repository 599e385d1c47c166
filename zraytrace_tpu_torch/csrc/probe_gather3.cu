// In-kernel gather micro-benchmark for Hopper (sm_90a): what do the
// gathers and rotations a texture fetch is built from cost inside a kernel,
// and how much on-chip scratch can a block hold?
//
// Replaces the TPU probe tools/gather_probe3.py (its pallas_calls :63 in
// _time_kernel, :166 in probe_tex128 and :229 in probe_vmem), on (R, 128)
// arrays, K = 32 rounds per launch:
//   dg0   out[r, l] = sum_{i<K} tbl[(idx[r, l] + i) & (R - 1), l]
//         (take_along_axis on axis 0, R in {1024, 4096}; probe_dg :82-108);
//   dg1   out[r, l] = sum_{i<K} tbl[r, (idx[r, l] + i) & 127] (axis 1);
//   roll  out = sum_{i<K} roll(x, s, axis=1) with s = 1 or s = i, in
//         jnp.roll's direction: out[r, l] += x[r, (l - s) & 127]
//         (probe_roll :111-130);
//   tex   out[i, l] = tbl[q[i, l], c[i, l]] on an int32 (1024, 128) table
//         (probe_tex128 :133-189). The tool's 128-round rotate-gather was
//         TPU machinery for a 2-D gather Mosaic could not lower; here the
//         kernel reads the element directly;
//   scratch  the on-chip scratch capacity (probe_vmem :218-243): a block
//         with S bytes of dynamic shared memory writes row 0 and row n - 1
//         of its (n, 128) f32 scratch and returns their sum. The TPU's VMEM
//         megabytes have no counterpart; a block's shared memory does, up
//         to the card's opt-in limit (232,448 B on an H100), above which
//         cudaFuncSetAttribute refuses the request.
//
// Design. One thread per element; dg0, dg1 and tex read the table with
// __ldg through L1/L2 (the largest table, 2 MB, sits in L2). roll stages
// its row in shared memory (one 128-thread block per row) and each round
// reads the rotated element from there: a shared-memory rotate, since a
// row spans four warps and a warp shuffle rotates within 32 lanes only.
//
// What bounds it: at 1,024 x 128 lanes (512 blocks of 256 threads, or
// 1,024 of 128) a launch fills the card once; each round is one dependent
// L1/L2 (or shared) read and an add, so the latency of 32 dependent
// reads, not bandwidth, sets the time. The bytes that must move (the
// table, the ids and the output: 1.5-6 MB) take 0.5-2 us at 3.35 TB/s.
//
// Numerics: the adds run in the tool's order (round 0 first), separately
// rounded, as the plain version does, so both agree bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int L = 128;
constexpr int BLOCK = 256;
constexpr int SMEM_DEFAULT = 48 * 1024;  // dynamic shared memory without opting in

enum Mode { DG0, DG1, ROLL, ROLL_DYN, TEX, N_MODES };

template <int AXIS>
__global__ void __launch_bounds__(BLOCK)
dg_kernel(const float* __restrict__ tbl, const int* __restrict__ idx, float* __restrict__ out,
          int rows, int rounds) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= rows * L) return;
  const int r = e / L, l = e % L;
  const int id = idx[e];
  float acc = 0.0f;
  for (int i = 0; i < rounds; ++i) {
    const float g = AXIS == 0 ? __ldg(tbl + (size_t)((id + i) & (rows - 1)) * L + l)
                              : __ldg(tbl + (size_t)r * L + ((id + i) & (L - 1)));
    acc = acc + g;
  }
  out[e] = acc;
}

template <bool DYNAMIC>
__global__ void __launch_bounds__(L)
roll_kernel(const float* __restrict__ x, float* __restrict__ out, int rounds) {
  __shared__ float row[L];
  const int l = threadIdx.x;
  const size_t base = (size_t)blockIdx.x * L;
  row[l] = x[base + l];
  __syncthreads();
  float acc = 0.0f;
  for (int i = 0; i < rounds; ++i) acc = acc + row[(l - (DYNAMIC ? i : 1)) & (L - 1)];
  out[base + l] = acc;
}

__global__ void __launch_bounds__(BLOCK)
tex_kernel(const int* __restrict__ tbl, const int* __restrict__ q, const int* __restrict__ c,
           int* __restrict__ out, int rows) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= rows * L) return;
  out[e] = __ldg(tbl + (size_t)(q[e] & (rows - 1)) * L + (c[e] & (L - 1)));
}

// one block of L threads; n_rows rows of L floats of dynamic shared memory
__global__ void __launch_bounds__(L)
scratch_kernel(const float* __restrict__ x, float* __restrict__ out, int n_rows) {
  extern __shared__ float scratch[];
  volatile float* s = scratch;  // keep the stores and loads in shared memory
  const int l = threadIdx.x;
  s[l] = x[l];
  s[(size_t)(n_rows - 1) * L + l] = x[l] * 2.0f;
  __syncthreads();
  const int m = (l + 1) & (L - 1);  // read a neighbour's column
  out[m] = s[(size_t)(n_rows - 1) * L + m] + s[m];
}

}  // namespace

// mode: index into zraytrace_tpu_torch/probes/gather_probe3.py MODES; rows
// a power of two. DG0 / DG1: tbl (rows, 128) f32, idx int32, out f32;
// ROLL / ROLL_DYN: tbl is x (rows, 128) f32, idx unused; TEX: tbl (rows,
// 128) int32, idx = q, idx2 = c, out int32.
extern "C" int zr_probe_gather3_launch(int mode, const void* tbl, const int* idx,
                                       const int* idx2, void* out, int rows, int rounds,
                                       void* stream) {
  if (mode < 0 || mode >= N_MODES || rows < 0 || (rows & (rows - 1)) != 0 || rounds < 0 ||
      (long long)rows * L >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int grid = (rows * L + BLOCK - 1) / BLOCK;
  switch (mode) {
    case DG0:
      dg_kernel<0><<<grid, BLOCK, 0, s>>>((const float*)tbl, idx, (float*)out, rows, rounds);
      break;
    case DG1:
      dg_kernel<1><<<grid, BLOCK, 0, s>>>((const float*)tbl, idx, (float*)out, rows, rounds);
      break;
    case ROLL:
      roll_kernel<false><<<rows, L, 0, s>>>((const float*)tbl, (float*)out, rounds);
      break;
    case ROLL_DYN:
      roll_kernel<true><<<rows, L, 0, s>>>((const float*)tbl, (float*)out, rounds);
      break;
    default:
      tex_kernel<<<grid, BLOCK, 0, s>>>((const int*)tbl, idx, idx2, (int*)out, rows);
  }
  return (int)cudaGetLastError();
}

// The scratch probe: x and out (128,) f32, nbytes of dynamic shared memory
// (a multiple of 512, at least two rows). Above 48 KB it opts in with
// cudaFuncSetAttribute first; a refused request launches nothing and its
// error is returned (and cleared, so it cannot surface at a later launch).
extern "C" int zr_probe_scratch_launch(const float* x, float* out, int nbytes, void* stream) {
  if (nbytes < 2 * L * 4 || nbytes % (L * 4) != 0) return (int)cudaErrorInvalidValue;
  if (nbytes > SMEM_DEFAULT) {
    const cudaError_t err = cudaFuncSetAttribute(
        scratch_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, nbytes);
    if (err != cudaSuccess) {
      cudaGetLastError();
      return (int)err;
    }
  }
  scratch_kernel<<<1, L, nbytes, (cudaStream_t)stream>>>(x, out, nbytes / (L * 4));
  const cudaError_t err = cudaGetLastError();
  return (int)err;
}

// The current device's opt-in limit of shared memory per block, in bytes;
// a negative CUDA error code on failure.
extern "C" int zr_probe_smem_optin(void) {
  int dev = 0, bytes = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return err == cudaSuccess ? bytes : -(int)err;
}

extern "C" const char* zr_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
