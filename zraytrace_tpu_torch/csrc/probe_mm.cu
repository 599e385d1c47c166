// Matrix-form triangle-test micro-benchmark for Hopper (sm_90a): does a
// product-shaped triangle test pay on this card?
//
// Replaces the TPU probe tools/flash2_probe.py's product kernels: its
// flash2 design computes all four Moller numerators of G = 1600 triangles
// for R = 512 rays as ONE (R, K) @ (K, 4G) product (lhs: the ray terms
// o, d, o x d, 1 padded to K = 16; rhs: the triangles' planes):
//   mm        (pallas_call :53) sum over REPS = 16 of (lhs @ rhs)[:, :128],
//             every one of the 6,400 columns computed each rep, as the
//             Mosaic kernel does;
//   mm128     (:176) the same with K = 128;
//   mm_elem   (:104) the whole intersect block per rep: det, un, vn, tn as
//             the product's four column blocks, inv = 1/det where
//             |det| > 1e-12, the hit test det >= 1e-6, t > 1e-3, u >= 0,
//             v >= 0, u + v <= 1, each ray's least t over G with the lowest
//             triangle on ties, and a strict < running winner across reps
//             with id lane + rep; output (R, 2) [t_best, i_best].
//
// Design. One block of 256 threads per four rows (128 blocks for 512
// rows); the block's lhs rows sit in shared memory (read as broadcasts),
// each thread walks columns t, t + 256, ... reading rhs with coalesced
// __ldg loads (400 KB, L2-resident) and keeps four rows' sums in
// registers. Each product is summed over k in a fixed order, every
// multiply and add rounded separately (-fmad=false, FP32 CUDA cores; TF32
// and the tensor cores are a redesign's question), so the plain version
// equals it bit for bit. So that no compiler drops a column, mm also
// returns per row the XOR over reps and columns of each product's bits,
// rotated left by the rep (a checksum whose value does not depend on the
// order the threads meet the columns in). The reps are identical work:
// each reads rhs at an offset masked by a kernel argument that is always
// 0, so the compiler cannot run them once.
//
// What bounds it: FP32 operations. mm does 2 x 512 x 16 x 6,400 x 16 =
// 1.68 GFLOP (0.025 ms at 67 TFLOP/s, 0.05 ms as separate multiplies and
// adds, which issue one per lane and clock each); mm128 8x that. The
// bytes (lhs, rhs, outputs: ~0.7 MB) take 0.2 us at 3.35 TB/s.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 256;
constexpr int ROWS = 4;  // lhs rows per block
constexpr int OUT_COLS = 128;
constexpr int N_WARPS = BLOCK / 32;
constexpr float BIG = 3.4e38f;

// the product of rows r0 .. r0 + ROWS - 1 of the block's lhs rows with
// column col of rhs (K rows, stride cols), summed over k in order
template <int K>
__device__ __forceinline__ void dot_rows(float (*sl)[K], const float* rb, int cols,
                                         int col, float (&p)[ROWS]) {
#pragma unroll 16
  for (int k = 0; k < K; ++k) {
    const float rk = __ldg(rb + (size_t)k * cols + col);
#pragma unroll
    for (int r = 0; r < ROWS; ++r) p[r] = k == 0 ? sl[r][0] * rk : p[r] + sl[r][k] * rk;
  }
}

template <int K>
__device__ __forceinline__ void load_rows(const float* lhs, int n_rows, int r0,
                                          float (*sl)[K]) {
  for (int e = threadIdx.x; e < ROWS * K; e += BLOCK) {
    const int r = r0 + e / K;
    sl[e / K][e % K] = r < n_rows ? lhs[(size_t)r * K + e % K] : 0.0f;
  }
  __syncthreads();
}

template <int K>
__global__ void __launch_bounds__(BLOCK)
mm_kernel(const float* __restrict__ lhs, const float* __restrict__ rhs, float* __restrict__ out,
          uint32_t* __restrict__ checksum, int n_rows, int cols, int reps, int zero) {
  __shared__ float sl[ROWS][K];
  __shared__ uint32_t sx[ROWS][N_WARPS];
  const int r0 = blockIdx.x * ROWS;
  load_rows<K>(lhs, n_rows, r0, sl);
  float acc[ROWS];
  uint32_t chk[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    acc[r] = 0.0f;
    chk[r] = 0u;
  }
#pragma unroll 1
  for (int rep = 0; rep < reps; ++rep) {
    const float* rb = rhs + (rep & zero);
#pragma unroll 1
    for (int col = threadIdx.x; col < cols; col += BLOCK) {
      float p[ROWS];
      dot_rows<K>(sl, rb, cols, col, p);
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const uint32_t b = __float_as_uint(p[r]);
        chk[r] ^= __funnelshift_l(b, b, rep & 31);
        if (col < OUT_COLS) acc[r] = acc[r] + p[r];
      }
    }
  }
  const int c = threadIdx.x;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    if (c < OUT_COLS && c < cols && r0 + r < n_rows) out[(size_t)(r0 + r) * OUT_COLS + c] = acc[r];
    uint32_t x = chk[r];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) x ^= __shfl_xor_sync(0xffffffffu, x, off);
    if (c % 32 == 0) sx[r][c / 32] = x;
  }
  __syncthreads();
  if (c < ROWS && r0 + c < n_rows) {
    uint32_t x = 0u;
    for (int w = 0; w < N_WARPS; ++w) x ^= sx[c][w];
    checksum[r0 + c] = x;
  }
}

// (t, j) pairs: the lesser t, the lower j on ties
__device__ __forceinline__ void take_min(float& t, int& j, float ot, int oj) {
  if (ot < t || (ot == t && oj < j)) {
    t = ot;
    j = oj;
  }
}

__global__ void __launch_bounds__(BLOCK)
mm_elem_kernel(const float* __restrict__ lhs, const float* __restrict__ rhs,
               float* __restrict__ out, int n_rows, int g, int reps, int zero) {
  constexpr int K = 16;
  __shared__ float sl[ROWS][K];
  __shared__ float st[ROWS][N_WARPS];
  __shared__ int sj[ROWS][N_WARPS];
  const int r0 = blockIdx.x * ROWS;
  const int cols = 4 * g;
  load_rows<K>(lhs, n_rows, r0, sl);
  float t_best = BIG;  // thread r < ROWS keeps row r0 + r's winner
  int i_best = 0;
#pragma unroll 1
  for (int rep = 0; rep < reps; ++rep) {
    const float* rb = rhs + (rep & zero);
    float bt[ROWS];
    int bj[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      bt[r] = BIG;
      bj[r] = threadIdx.x < g ? threadIdx.x : g;  // the first column this thread meets
    }
#pragma unroll 1
    for (int j = threadIdx.x; j < g; j += BLOCK) {
      float det[ROWS], un[ROWS], vn[ROWS], tn[ROWS];
      dot_rows<K>(sl, rb, cols, j, det);
      dot_rows<K>(sl, rb, cols, g + j, un);
      dot_rows<K>(sl, rb, cols, 2 * g + j, vn);
      dot_rows<K>(sl, rb, cols, 3 * g + j, tn);
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const bool safe = fabsf(det[r]) > (float)1e-12;
        const float inv = 1.0f / (safe ? det[r] : 1.0f);
        const float u = un[r] * inv, v = vn[r] * inv, t = tn[r] * inv;
        const bool hit = det[r] >= (float)1e-6 && t > (float)1e-3 && u >= 0.0f && v >= 0.0f &&
                         u + v <= 1.0f;
        const float th = hit ? t : BIG;
        if (th < bt[r]) {
          bt[r] = th;
          bj[r] = j;
        }
      }
    }
    const int c = threadIdx.x;
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      float t = bt[r];
      int j = bj[r];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        take_min(t, j, __shfl_xor_sync(0xffffffffu, t, off), __shfl_xor_sync(0xffffffffu, j, off));
      if (c % 32 == 0) {
        st[r][c / 32] = t;
        sj[r][c / 32] = j;
      }
    }
    __syncthreads();
    if (c < ROWS) {
      float tc = st[c][0];
      int lane = sj[c][0];
      for (int w = 1; w < N_WARPS; ++w) take_min(tc, lane, st[c][w], sj[c][w]);
      if (tc < t_best) {
        t_best = tc;
        i_best = lane + rep;
      }
    }
    __syncthreads();
  }
  if (threadIdx.x < ROWS && r0 + threadIdx.x < n_rows) {
    out[(size_t)(r0 + threadIdx.x) * 2] = t_best;
    out[(size_t)(r0 + threadIdx.x) * 2 + 1] = (float)i_best;
  }
}

}  // namespace

// lhs (n_rows, k) and rhs (k, cols) f32, k 16 or 128; out (n_rows, 128)
// f32 (cols >= 128), checksum (n_rows,) uint32. zero must be 0.
extern "C" int zr_probe_mm_launch(const float* lhs, const float* rhs, float* out,
                                  uint32_t* checksum, int n_rows, int k, int cols, int reps,
                                  int zero, void* stream) {
  if (n_rows < 0 || cols < OUT_COLS || reps < 0 || (k != 16 && k != 128) || zero != 0)
    return (int)cudaErrorInvalidValue;
  if (n_rows == 0) return 0;
  const int grid = (n_rows + ROWS - 1) / ROWS;
  cudaStream_t s = (cudaStream_t)stream;
  if (k == 16)
    mm_kernel<16><<<grid, BLOCK, 0, s>>>(lhs, rhs, out, checksum, n_rows, cols, reps, zero);
  else
    mm_kernel<128><<<grid, BLOCK, 0, s>>>(lhs, rhs, out, checksum, n_rows, cols, reps, zero);
  return (int)cudaGetLastError();
}

// lhs (n_rows, 16) and rhs (16, 4 g) f32; out (n_rows, 2) f32
// [t_best, i_best]. zero must be 0.
extern "C" int zr_probe_mm_elem_launch(const float* lhs, const float* rhs, float* out,
                                       int n_rows, int g, int reps, int zero, void* stream) {
  if (n_rows < 0 || g <= 0 || reps < 0 || zero != 0) return (int)cudaErrorInvalidValue;
  if (n_rows == 0) return 0;
  mm_elem_kernel<<<(n_rows + ROWS - 1) / ROWS, BLOCK, 0, (cudaStream_t)stream>>>(
      lhs, rhs, out, n_rows, g, reps, zero);
  return (int)cudaGetLastError();
}

extern "C" const char* zr_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
