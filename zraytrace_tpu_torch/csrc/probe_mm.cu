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
// Design (redesigned for Hopper: a register-tiled SIMT product with its
// epilogue fused). A block owns a tile of 32 lhs rows by 64 columns (mm)
// or by 16 triangles' four column blocks (mm_elem); each thread keeps 8
// rows x 4 columns (mm) or 4 rows x 4 triangles x 4 numerators (mm_elem)
// in registers, so each value read from shared memory feeds 8 or 16
// multiply-adds. The block's lhs rows sit transposed in shared memory for
// the whole launch; its rhs tile is staged with cp.async, double-buffered
// (K = 128 in slices of 16 rows), the next slice in flight while the
// current one is used. Every rep re-stages its tile from rhs + (rep &
// zero), where zero is a kernel argument that is always 0, so the
// compiler cannot run the reps once. The grid (16 x 100 blocks of 64
// threads for mm, 16 x 100 of 32 for mm_elem) gives each SM twelve or
// thirteen blocks at once, so the SMs that hold one more block than the
// others add little (32 x 128 tiles, six or seven a SM, were 1-6% slower).
//   mm's epilogue: the blocks that own columns < 128 add the product into
// out in rep order (out is theirs alone); the checksum, per row the XOR
// over reps and columns of each product's bits rotated left by the rep, is
// each thread's XOR, then the XOR over the lanes of its row group, then one
// atomicXor per row and block into checksum[row], which the launch zeroes
// first (XOR is order-free, so the result is deterministic).
//   mm_elem's winner: each hit becomes a 64-bit key (float bits of t) << 32
// | rep << 16 | triangle. A hit's t is above 1e-3, so its bits order as
// unsigned integers, and the least key is the least t, then the earliest
// rep, then the lowest triangle: the tool's strict < across reps with the
// lowest triangle on ties. Keys at or above 3.4e38 never win (the tool
// keeps its 3.4e38 start). Each thread takes its rows' least t per rep
// over its four triangles (strict <, in order), keeps its rows' least
// keys over reps, the lanes of a row group take their minimum, and one
// 64-bit atomicMin per row and block meets the other blocks' in keys[row]
// (set to all ones by the launch); a second small kernel decodes the keys
// into [t_best, lane + rep], a row without a key into [3.4e38, 0].
// Numerics: every product is summed over k in order, each multiply and add
// rounded separately (-fmad=false, FP32 CUDA cores), and 1/det is a
// correctly rounded division, so the plain version equals it bit for bit.
//
// What bounds it: FP32 operations. mm does 2 x 512 x 16 x 6,400 x 16 =
// 1.68 GFLOP: 0.025 ms at 67 TFLOP/s, the yardstick of probes/bounds.py,
// but about 0.05 ms as separate multiplies and adds, which issue one per
// lane and clock each (33.5 T instructions/s); mm128 8x that. The bytes
// (lhs, rhs, outputs: ~0.7 MB) take 0.2 us at 3.35 TB/s. Beside the FP32
// pipe each k costs three shared loads per 64 operations (mm) or five per
// 128 (mm_elem), and mm_elem adds per pair a correctly rounded division
// and the test (about a fifth more instructions). On an H100 80GB HBM3 at
// 700 W mm reaches 52% of the unfused rate (0.096 ms), mm128 58%, mm_elem
// 40% (0.132 ms).
// The tensor cores (TF32, or 3xTF32) are a later lever: neither is bit-
// equal to this f32 sum.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int OUT_COLS = 128;
constexpr float BIG = 3.4e38f;
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned long long NO_KEY = ~0ULL;

constexpr int BM = 32;  // lhs rows per block (both kernels)
constexpr int PAD = 4;  // the transposed lhs rows' padding (16-byte aligned rows)
constexpr int KS = 16;  // rhs rows per staged slice

// mm: 32 x 64 tiles, 8 x 4 per thread
constexpr int MM_BN = 64, MM_TM = 8, MM_TN = 4;
constexpr int MM_CG = MM_BN / MM_TN;  // column groups: lanes that share a row group
constexpr int MM_THREADS = (BM / MM_TM) * MM_CG;
static_assert(32 % MM_CG == 0 && OUT_COLS % MM_BN == 0, "row groups within a warp");

// mm_elem: 32 rows x 16 triangles, 4 x 4 per thread
constexpr int EL_K = 16, EL_BT = 16, EL_TM = 4, EL_TT = 4;
constexpr int EL_TG = EL_BT / EL_TT;  // triangle groups: lanes that share a row group
constexpr int EL_THREADS = (BM / EL_TM) * EL_TG;

__device__ __forceinline__ void cp_async16(void* smem, const float* src, bool valid) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* smem, const float* src, bool valid) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most one committed group (the newest) is still in flight
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// rows r0 .. r0 + BM - 1 of lhs (n_rows, K), transposed, zero past n_rows
template <int K, int THREADS>
__device__ __forceinline__ void stage_lhs(const float* __restrict__ lhs, int n_rows, int r0,
                                          float (*sa)[BM + PAD]) {
  for (int e = threadIdx.x; e < BM * K; e += THREADS) {
    const int r = e / K, k = e % K;
    sa[k][r] = r0 + r < n_rows ? __ldg(lhs + (size_t)(r0 + r) * K + k) : 0.0f;
  }
}

// rows k0 .. k0 + KS - 1 of rb (stride cols), the columns col[0 .. n) of
// NB blocks that start b_stride apart, at c0 within each block; columns
// at or past lim within their block are zero. 16-byte copies where every
// row and block start is 16-byte aligned, else 4-byte ones.
template <int NB, int N, int THREADS>
__device__ __forceinline__ void stage_cols(const float* rb, int cols, int k0, int b_stride,
                                           int c0, int lim, bool vec, float (*sb)[NB][N]) {
  if (vec) {
    for (int e = threadIdx.x; e < KS * NB * N / 4; e += THREADS) {
      const int c = e % (N / 4) * 4, q = e / (N / 4) % NB, kk = e / (N / 4 * NB);
      const bool ok = c0 + c < lim;
      cp_async16(&sb[kk][q][c], ok ? rb + (size_t)(k0 + kk) * cols + q * b_stride + c0 + c : rb,
                 ok);
    }
  } else {
    for (int e = threadIdx.x; e < KS * NB * N; e += THREADS) {
      const int c = e % N, q = e / N % NB, kk = e / (N * NB);
      const bool ok = c0 + c < lim;
      cp_async4(&sb[kk][q][c], ok ? rb + (size_t)(k0 + kk) * cols + q * b_stride + c0 + c : rb,
                ok);
    }
  }
}

__device__ __forceinline__ bool aligned16(const float* p) {
  return ((uintptr_t)p & 15) == 0;
}

template <int K>
__global__ void __launch_bounds__(MM_THREADS)
mm_kernel(const float* __restrict__ lhs, const float* __restrict__ rhs, float* __restrict__ out,
          uint32_t* __restrict__ checksum, int n_rows, int cols, int reps, int zero) {
  constexpr int NS = K / KS;  // slices per rep
  __shared__ __align__(16) float sa[K][BM + PAD];
  __shared__ __align__(16) float sb[2][KS][1][MM_BN];
  const int r0 = blockIdx.x * BM, c0 = blockIdx.y * MM_BN;
  const int rg = threadIdx.x / MM_CG, cg = threadIdx.x % MM_CG;
  const bool vec = cols % 4 == 0;
  const bool whole = c0 + MM_BN <= cols;  // every column of the tile is one of rhs's
  stage_lhs<K, MM_THREADS>(lhs, n_rows, r0, sa);
  const int stages = reps * NS;
  if (stages > 0) {
    const float* rb = rhs + (0 & zero);
    stage_cols<1, MM_BN, MM_THREADS>(rb, cols, 0, 0, c0, cols, vec && aligned16(rb), sb[0]);
  }
  cp_async_commit();
  float p[MM_TM][MM_TN];
  uint32_t chk[MM_TM];
#pragma unroll
  for (int i = 0; i < MM_TM; ++i) chk[i] = 0u;
#pragma unroll 1
  for (int st = 0; st < stages; ++st) {
    const int rep = st / NS, s = st % NS;
    if (st + 1 < stages) {
      const float* rb = rhs + (((st + 1) / NS) & zero);
      stage_cols<1, MM_BN, MM_THREADS>(rb, cols, (st + 1) % NS * KS, 0, c0, cols,
                                       vec && aligned16(rb), sb[(st + 1) & 1]);
    }
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
    const float(*b)[1][MM_BN] = sb[st & 1];
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&sa[s * KS + kk][rg * MM_TM]);
      const float4 a1 = *reinterpret_cast<const float4*>(&sa[s * KS + kk][rg * MM_TM + 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&b[kk][0][cg * MM_TN]);
      const float a[MM_TM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bb[MM_TN] = {bv.x, bv.y, bv.z, bv.w};
      const bool first = kk == 0 && s == 0;
#pragma unroll
      for (int i = 0; i < MM_TM; ++i)
#pragma unroll
        for (int j = 0; j < MM_TN; ++j) p[i][j] = first ? a[i] * bb[j] : p[i][j] + a[i] * bb[j];
    }
    if (s == NS - 1) {  // the rep's product is whole
      const int rot = rep & 31;
#pragma unroll
      for (int i = 0; i < MM_TM; ++i) {
        // the XOR of this thread's columns, rotated once (rotation
        // distributes over XOR); rows past n_rows are dropped at the end
        uint32_t x = 0u;
#pragma unroll
        for (int j = 0; j < MM_TN; ++j)
          if (whole || c0 + cg * MM_TN + j < cols) x ^= __float_as_uint(p[i][j]);
        chk[i] ^= __funnelshift_l(x, x, rot);
        const int row = r0 + rg * MM_TM + i;
        if (c0 < OUT_COLS && row < n_rows) {  // the block owns these columns of out
          float* o = out + (size_t)row * OUT_COLS + c0 + cg * MM_TN;
#pragma unroll
          for (int j = 0; j < MM_TN; ++j) o[j] = (rep == 0 ? 0.0f : o[j]) + p[i][j];
        }
      }
    }
    __syncthreads();  // every thread is done with this buffer before it is staged again
  }
#pragma unroll
  for (int i = 0; i < MM_TM; ++i) {
    const int row = r0 + rg * MM_TM + i;
    if (reps == 0 && c0 < OUT_COLS && row < n_rows) {
#pragma unroll
      for (int j = 0; j < MM_TN; ++j) out[(size_t)row * OUT_COLS + c0 + cg * MM_TN + j] = 0.0f;
    }
    uint32_t x = chk[i];
#pragma unroll
    for (int off = MM_CG / 2; off > 0; off >>= 1) x ^= __shfl_xor_sync(FULL, x, off);
    if (cg == 0 && row < n_rows && x != 0u) atomicXor(checksum + row, x);
  }
}

__global__ void __launch_bounds__(EL_THREADS)
mm_elem_kernel(const float* __restrict__ lhs, const float* __restrict__ rhs,
               unsigned long long* __restrict__ keys, int n_rows, int g, int reps, int zero) {
  __shared__ __align__(16) float sa[EL_K][BM + PAD];
  __shared__ __align__(16) float sb[2][EL_K][4][EL_BT];
  const int r0 = blockIdx.x * BM, j0 = blockIdx.y * EL_BT;
  const int rg = threadIdx.x / EL_TG, tg = threadIdx.x % EL_TG;
  const int cols = 4 * g;
  const bool vec = g % 4 == 0;
  stage_lhs<EL_K, EL_THREADS>(lhs, n_rows, r0, sa);
  if (reps > 0) {
    const float* rb = rhs + (0 & zero);
    stage_cols<4, EL_BT, EL_THREADS>(rb, cols, 0, g, j0, g, vec && aligned16(rb), sb[0]);
  }
  cp_async_commit();
  unsigned long long best[EL_TM];
#pragma unroll
  for (int i = 0; i < EL_TM; ++i) best[i] = NO_KEY;
#pragma unroll 1
  for (int rep = 0; rep < reps; ++rep) {
    if (rep + 1 < reps) {
      const float* rb = rhs + ((rep + 1) & zero);
      stage_cols<4, EL_BT, EL_THREADS>(rb, cols, 0, g, j0, g, vec && aligned16(rb),
                                       sb[(rep + 1) & 1]);
    }
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
    const float(*b)[4][EL_BT] = sb[rep & 1];
    float num[4][EL_TM][EL_TT];  // det, un, vn, tn
#pragma unroll
    for (int k = 0; k < EL_K; ++k) {
      const float4 av = *reinterpret_cast<const float4*>(&sa[k][rg * EL_TM]);
      const float a[EL_TM] = {av.x, av.y, av.z, av.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 bv = *reinterpret_cast<const float4*>(&b[k][q][tg * EL_TT]);
        const float bb[EL_TT] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int i = 0; i < EL_TM; ++i)
#pragma unroll
          for (int j = 0; j < EL_TT; ++j)
            num[q][i][j] = k == 0 ? a[i] * bb[j] : num[q][i][j] + a[i] * bb[j];
      }
    }
#pragma unroll
    for (int i = 0; i < EL_TM; ++i) {
      float bt = BIG;  // the row's least t among this thread's triangles, the first on ties
      int bj = 0;
#pragma unroll
      for (int j = 0; j < EL_TT; ++j) {
        const int tri = j0 + tg * EL_TT + j;
        const float det = num[0][i][j];
        const bool safe = fabsf(det) > (float)1e-12;
        const float inv = 1.0f / (safe ? det : 1.0f);
        const float u = num[1][i][j] * inv, v = num[2][i][j] * inv, t = num[3][i][j] * inv;
        const bool hit = det >= (float)1e-6 && t > (float)1e-3 && u >= 0.0f && v >= 0.0f &&
                         u + v <= 1.0f;
        if (hit && t < bt && tri < g) {
          bt = t;
          bj = tri;
        }
      }
      const unsigned long long key =
          (unsigned long long)__float_as_uint(bt) << 32 | (unsigned)rep << 16 | (unsigned)bj;
      if (bt < BIG && key < best[i]) best[i] = key;
    }
    __syncthreads();  // every thread is done with this buffer before it is staged again
  }
#pragma unroll
  for (int i = 0; i < EL_TM; ++i) {
    unsigned long long k = best[i];
#pragma unroll
    for (int off = EL_TG / 2; off > 0; off >>= 1) {
      const unsigned long long o = __shfl_xor_sync(FULL, k, off);
      k = o < k ? o : k;
    }
    const int row = r0 + rg * EL_TM + i;
    if (tg == 0 && row < n_rows && k != NO_KEY) atomicMin(keys + row, k);
  }
}

__global__ void __launch_bounds__(256)
mm_elem_decode(const unsigned long long* __restrict__ keys, float* __restrict__ out, int n_rows) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_rows) return;
  const unsigned long long k = keys[r];
  const bool none = k == NO_KEY;
  out[2 * (size_t)r] = none ? BIG : __uint_as_float((unsigned)(k >> 32));
  out[2 * (size_t)r + 1] = none ? 0.0f : (float)((int)(k >> 16 & 0xffff) + (int)(k & 0xffff));
}

}  // namespace

// lhs (n_rows, k) and rhs (k, cols) f32, k 16 or 128; out (n_rows, 128)
// f32 (cols >= 128), checksum (n_rows,) uint32, zeroed here first. zero
// must be 0.
extern "C" int zr_probe_mm_launch(const float* lhs, const float* rhs, float* out,
                                  uint32_t* checksum, int n_rows, int k, int cols, int reps,
                                  int zero, void* stream) {
  if (n_rows < 0 || cols < OUT_COLS || reps < 0 || (k != 16 && k != 128) || zero != 0 ||
      (cols + MM_BN - 1) / MM_BN > 65535 || (long long)reps * (k / KS) >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  if (n_rows == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(checksum, 0, sizeof(uint32_t) * (size_t)n_rows, s);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n_rows + BM - 1) / BM, (cols + MM_BN - 1) / MM_BN);
  if (k == 16)
    mm_kernel<16><<<grid, MM_THREADS, 0, s>>>(lhs, rhs, out, checksum, n_rows, cols, reps, zero);
  else
    mm_kernel<128><<<grid, MM_THREADS, 0, s>>>(lhs, rhs, out, checksum, n_rows, cols, reps, zero);
  return (int)cudaGetLastError();
}

// lhs (n_rows, 16) and rhs (16, 4 g) f32; keys (n_rows,) 64-bit scratch;
// out (n_rows, 2) f32 [t_best, i_best]. g and reps at most 65,536 (the
// key's fields). zero must be 0.
extern "C" int zr_probe_mm_elem_launch(const float* lhs, const float* rhs,
                                       unsigned long long* keys, float* out, int n_rows, int g,
                                       int reps, int zero, void* stream) {
  if (n_rows < 0 || g <= 0 || g > 65536 || reps < 0 || reps > 65536 || zero != 0 ||
      (long long)4 * g >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  if (n_rows == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(keys, 0xff, sizeof(unsigned long long) * (size_t)n_rows, s);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n_rows + BM - 1) / BM, (g + EL_BT - 1) / EL_BT);
  mm_elem_kernel<<<grid, EL_THREADS, 0, s>>>(lhs, rhs, keys, n_rows, g, reps, zero);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  mm_elem_decode<<<(n_rows + 255) / 256, 256, 0, s>>>(keys, out, n_rows);
  return (int)cudaGetLastError();
}

extern "C" const char* zr_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
