// Integer-hash micro-benchmark for Hopper (sm_90a): what do PCG4D's
// 32-bit multiplies cost, against multiply-free and float alternatives?
//
// Replaces the TPU probe tools/rng_probe.py:196-216 (build: a pallas_call
// over (1024, 128) int32 lanes in (8, 128) blocks, B = 8 iterations of
// c = c + fn(c, i) per launch), with its ten variants (:188-193).
//
// Design. One thread per lane; the B iterations run in registers, and
// `chain` repeats them in the same launch, which equals `chain` launches
// chained one after another (lanes are independent and i restarts at 0),
// so a timing of K = 24 chained launches carries no host launch gaps.
//
// What bounds it: integer (and, for f32mul, FP32) instructions, not
// bytes: 8 bytes a lane against 80-500 operations. The multiplies run
// as IMAD on the FMA pipe and the adds, shifts and logic as IADD3, SHF
// and LOP3 on the integer pipe, so a hash can dispatch up to 128 lanes of
// instructions per SM per clock, as FP32 work does, and not only the
// integer pipe's 64.
//
// How the TPU variants map to this card. On the TPU the question was how
// Mosaic lowers a 32-bit multiply (uint32 against int32, a 16-bit split,
// a multiply-free Threefry). Here uint32 and int32 multiplies are the same
// IMAD instruction, so u32mul/i32mul and pcg4d/pcg4d_i32 ask whether the
// signed form costs anything (it should not); pcg4d_16b prices the
// 16-bit split at four IMADs where one does; threefry13 prices add, xor
// and the rotate (SHF) against IMAD; f32mul the FP32 pipe. pcg4d is the
// device function the bounce kernel runs (bounce_common.cuh).
//
// Numerics: two's-complement wrap on every add, multiply and left shift
// (computed through unsigned, so no signed overflow is left to the
// compiler); >> on int32 is arithmetic, as in JAX, so the tool's masks
// (& 0xFFFF, & 0x7FFFF) stay. f32mul's float -> int32 conversion is
// __float2int_rz, which saturates; the plain version's cast of an
// out-of-range float is undefined, so the two are compared on one launch,
// where nothing overflows.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bounce_common.cuh"

namespace {

constexpr int BLOCK = 256;

enum Variant {
  U32MUL, U32MULVAR, I32MUL, I32MULVAR, F32MUL, SHIFTS, PCG4D, PCG4D_I32, PCG4D_16B,
  THREEFRY13, N_VARIANTS
};

__device__ __forceinline__ int add(int a, int b) { return (int)((uint32_t)a + (uint32_t)b); }
__device__ __forceinline__ int mul(int a, int b) { return (int)((uint32_t)a * (uint32_t)b); }
__device__ __forceinline__ int shl(int a, int s) { return (int)((uint32_t)a << s); }

constexpr int PCG_M = 1664525;
constexpr int PCG_A = 1013904223;

__device__ __forceinline__ int rsh16(int v) { return (v >> 16) & 0xFFFF; }

// rng_probe.py _pcg4d_i32: PCG4D in int32, logical shifts by masking
__device__ __forceinline__ int pcg4d_i32(int px, int sa, int dp, int sd) {
  int x = add(mul(px, PCG_M), PCG_A);
  int y = add(mul(sa, PCG_M), PCG_A);
  int z = add(mul(dp, PCG_M), PCG_A);
  int w = add(mul(sd, PCG_M), PCG_A);
  x = add(x, mul(y, w));
  y = add(y, mul(z, x));
  z = add(z, mul(x, y));
  w = add(w, mul(y, z));
  x ^= rsh16(x);
  y ^= rsh16(y);
  z ^= rsh16(z);
  w ^= rsh16(w);
  x = add(x, mul(y, w));
  y = add(y, mul(z, x));
  z = add(z, mul(x, y));
  w = add(w, mul(y, z));
  return (x >> 8) & 0xFFFFFF;
}

// rng_probe.py _mul_i32: the low 32 bits of a product from 16-bit halves
__device__ __forceinline__ int mul16(int a, int b) {
  const int a_lo = a & 0xFFFF, a_hi = (a >> 16) & 0xFFFF;
  const int b_lo = b & 0xFFFF, b_hi = (b >> 16) & 0xFFFF;
  const int lo = mul(a_lo, b_lo);
  const int mid = shl(add(mul(a_lo, b_hi), mul(a_hi, b_lo)), 16);
  return add(lo, mid);
}

__device__ __forceinline__ int pcg4d_16b(int px, int sa, int dp, int sd) {
  int x = add(mul16(px, PCG_M), PCG_A);
  int y = add(mul16(sa, PCG_M), PCG_A);
  int z = add(mul16(dp, PCG_M), PCG_A);
  int w = add(mul16(sd, PCG_M), PCG_A);
  x = add(x, mul16(y, w));
  y = add(y, mul16(z, x));
  z = add(z, mul16(x, y));
  w = add(w, mul16(y, z));
  x ^= rsh16(x);
  y ^= rsh16(y);
  z ^= rsh16(z);
  w ^= rsh16(w);
  x = add(x, mul16(y, w));
  y = add(y, mul16(z, x));
  z = add(z, mul16(x, y));
  w = add(w, mul16(y, z));
  return (x >> 8) & 0xFFFFFF;
}

// the tool's rotl, its mask included
__device__ __forceinline__ int rotl(int v, int r) {
  return shl(v, r) | ((v >> (32 - r)) & ((1 << (32 - r)) - 1));
}

__device__ __forceinline__ int threefry13(int k0, int k1, int c0, int c1) {
  const int rot[8] = {13, 15, 26, 6, 17, 29, 16, 24};
  const int ks2 = k0 ^ k1 ^ 0x1BD11BDA;
  const int keys[3] = {k0, k1, ks2};
  int x0 = add(c0, k0);
  int x1 = add(c1, k1);
#pragma unroll
  for (int r = 0; r < 13; ++r) {
    x0 = add(x0, x1);
    x1 = rotl(x1, rot[r % 8]) ^ x0;
    if (r % 4 == 3) {
      const int j = r / 4 + 1;
      x0 = add(x0, keys[j % 3]);
      x1 = add(add(x1, keys[(j + 1) % 3]), j);
    }
  }
  return x0;
}

template <int V>
__device__ __forceinline__ int variant(int x, int i) {
  if (V == U32MUL) {
    uint32_t u = (uint32_t)x;
#pragma unroll
    for (int k = 0; k < 10; ++k) u = u * 1664525u;
    return (int)u;
  } else if (V == U32MULVAR) {
    uint32_t u = (uint32_t)x;
    uint32_t v = u ^ 0x9E3779B9u;
#pragma unroll
    for (int k = 0; k < 5; ++k) {
      u = u * v;
      v = v + u;
    }
    return (int)u;
  } else if (V == I32MUL) {
    int u = x;
#pragma unroll
    for (int k = 0; k < 10; ++k) u = mul(u, 1664525);
    return u;
  } else if (V == I32MULVAR) {
    int u = x;
    int v = x ^ 0x1E377909;
#pragma unroll
    for (int k = 0; k < 5; ++k) {
      u = mul(u, v);
      v = add(v, u);
    }
    return u;
  } else if (V == F32MUL) {
    float u = (float)x;
#pragma unroll
    for (int k = 0; k < 10; ++k) u = u * 1.0001f;
    return __float2int_rz(u);
  } else if (V == SHIFTS) {
    int u = x;
#pragma unroll
    for (int k = 0; k < 10; ++k) {
      u = u ^ ((u >> 13) & 0x7FFFF);
      u = add(u, shl(u, 7));
    }
    return u;
  } else if (V == PCG4D) {  // the bounce kernel's uint32 PCG4D
    const uint32_t xi = (uint32_t)add(x, i);
    const uint4 a = zr::pcg4d((uint32_t)x, (uint32_t)add(x, 1), xi, 42u);
    const uint4 b = zr::pcg4d((uint32_t)add(x, 2), (uint32_t)add(x, 3), xi, 7u);
    return add((int)(a.x >> 8), (int)(b.x >> 8));
  } else if (V == PCG4D_I32) {
    const int xi = add(x, i);
    return add(pcg4d_i32(x, add(x, 1), xi, 42), pcg4d_i32(add(x, 2), add(x, 3), xi, 7));
  } else if (V == PCG4D_16B) {
    const int xi = add(x, i);
    return add(pcg4d_16b(x, add(x, 1), xi, 42), pcg4d_16b(add(x, 2), add(x, 3), xi, 42));
  } else {  // THREEFRY13
    const int xi = add(x, i);
    return add(threefry13(x, xi, 42, add(x, 1)), threefry13(add(x, 2), xi, 42, add(x, 3)));
  }
}

template <int V>
__global__ void __launch_bounds__(BLOCK)
rng_kernel(const int* __restrict__ x, int* __restrict__ out, int n, int iters, int chain) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  int c = x[lane];
  for (int k = 0; k < chain; ++k) {
#pragma unroll 1
    for (int i = 0; i < iters; ++i) c = add(c, variant<V>(c, i));
  }
  out[lane] = c;
}

template <int V>
void launch_v(const int* x, int* out, int n, int iters, int chain, cudaStream_t stream) {
  rng_kernel<V><<<(n + BLOCK - 1) / BLOCK, BLOCK, 0, stream>>>(x, out, n, iters, chain);
}

}  // namespace

// variant: index into the order above (zraytrace_tpu_torch/probes/
// rng_probe.py VARIANTS); iters: B; chain: launches folded into this one.
extern "C" int zr_probe_rng_launch(int variant, const int* x, int* out, int n, int iters,
                                   int chain, void* stream) {
  if (variant < 0 || variant >= N_VARIANTS || n < 0 || iters < 0 || chain < 0)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (variant) {
    case U32MUL: launch_v<U32MUL>(x, out, n, iters, chain, s); break;
    case U32MULVAR: launch_v<U32MULVAR>(x, out, n, iters, chain, s); break;
    case I32MUL: launch_v<I32MUL>(x, out, n, iters, chain, s); break;
    case I32MULVAR: launch_v<I32MULVAR>(x, out, n, iters, chain, s); break;
    case F32MUL: launch_v<F32MUL>(x, out, n, iters, chain, s); break;
    case SHIFTS: launch_v<SHIFTS>(x, out, n, iters, chain, s); break;
    case PCG4D: launch_v<PCG4D>(x, out, n, iters, chain, s); break;
    case PCG4D_I32: launch_v<PCG4D_I32>(x, out, n, iters, chain, s); break;
    case PCG4D_16B: launch_v<PCG4D_16B>(x, out, n, iters, chain, s); break;
    default: launch_v<THREEFRY13>(x, out, n, iters, chain, s); break;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* zr_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
