// Bounce-body micro-benchmark for Hopper (sm_90a): which slice of the
// path-tracing segment body costs the most per lane?
//
// Replaces the TPU probe tools/body_probe.py:337-372 (build: a
// pallas_call over 15 (1024, 128) lane planes and a base-pixel plane in
// (8, 128) blocks, scene tables in SMEM, B = 8 body iterations per launch)
// with its seven bodies (:247-334; body_full :40-244) and one more:
//   pass_      no work: the loads and stores of the 15 planes;
//   spheres    the fused sphere winner over scene 1's 7 spheres;
//   rng        two PCG4D draws (scatter and camera streams);
//   trig       the polynomial acos/atan2 of the sphere uv, a sin and a cos;
//   intdiv     pixel % width and pixel // width (floor semantics);
//   mats       eleven material-table reads;
//   full       the whole segment body: winner, normal and uv, the texel
//              index, Lambertian/mirror/dielectric directions with Schlick,
//              sky radiance, throughput, sample and slot book-keeping and
//              the next camera ray;
//   trig_libdevice  trig with CUDA's acosf/atan2f, the form the port's
//              bounce kernel runs (csrc/bounce_kernel.cu).
//
// Design. One thread per lane; the planes are read once and written once
// per launch and the B iterations run in registers, so pass_ prices the
// loads and stores of a launch. The sphere, material and camera tables
// sit in shared memory. K = 24 launches are timed as one CUDA graph.
// PCG4D and the sphere winner are the bounce kernel's device functions
// (bounce_common.cuh), so those lines time what the kernel runs.
//
// What bounds it: FP32, SFU (sqrt, sin, cos, division) and INT32
// instructions, not bytes: a lane moves 128 bytes per launch against
// ~370 FP32 and ~80 integer operations per iteration in `full`. The
// random-normal state sends neighbouring lanes down different material
// branches, which the tool's straight-line TPU body never paid for.
//
// How the TPU variants map to this card. On the TPU each body was one
// straight-line vector program in which every branch is computed and
// selected, and the question was which slice Mosaic lowers badly (PCG4D's
// 32-bit multiplies, the polynomial trig, the where-chain material select,
// integer division). Here the same slices are scalar per-thread code:
// the material select becomes an indexed shared-memory read, integer
// division a multiply-high sequence, and the branches of `full` are real
// branches. The tool kept the texel index live with `texflat & 0`, which
// nvcc would fold away; here the mask is a kernel argument that is 0.
//
// Numerics follow the plain PyTorch version (zraytrace_tpu_torch/probes/
// body_probe.py) operation by operation, built with -fmad=false: IEEE
// division and square root, 1/sqrt where the tool multiplies by rsqrt,
// CUDA's sinf/cosf (the functions torch's CUDA sin/cos call), constants
// rounded from the double as numpy rounds them, and clamps that pass NaN
// through as torch.clamp does.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bounce_common.cuh"

namespace {

using zr::V3;

constexpr int BLOCK = 256;
constexpr int MAX_SPHERES = 32;
constexpr int MAX_MATS = 32;
constexpr int M_COLS = 11;
constexpr int N_F32 = 12;
constexpr float BIG = (float)3.4e38;
constexpr float T_MIN = (float)1e-3;
constexpr float PI_F = (float)3.141592653589793;
constexpr float HALF_PI_F = (float)(3.141592653589793 / 2);
constexpr float TWO_PI_F = (float)(2.0 * 3.141592653589793);
constexpr float INV_TWO_PI_F = (float)(1.0 / (2.0 * 3.141592653589793));
constexpr float INV_PI_F = (float)(1.0 / 3.141592653589793);
constexpr float CLIP_LO = (float)(-1.0 + 1e-7);
constexpr float CLIP_HI = (float)(1.0 - 1e-7);
constexpr uint32_t STREAM_CAMERA = 0x9E3779B9u;
constexpr uint32_t STREAM_SCATTER = 0x85EBCA6Bu;

enum Variant { PASS, SPHERES, RNG, TRIG, INTDIV, MATS, FULL, TRIG_LIBDEVICE, N_VARIANTS };

// the tool's integer parameters (zraytrace_tpu/ops/common.py P_*)
struct Params {
  int width, height, sample_end, max_depth, seed, n_pixels, stride, sample_start, atlas_w,
      n_slots;
};

struct Lane {
  float ox, oy, oz, dx, dy, dz, tr, tg, tb, ar, ag, ab;
  int dep, samp, slot;
};

__device__ __forceinline__ int add(int a, int b) { return (int)((uint32_t)a + (uint32_t)b); }
__device__ __forceinline__ int mul(int a, int b) { return (int)((uint32_t)a * (uint32_t)b); }

__device__ __forceinline__ int floordiv(int a, int b) {
  const int q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

__device__ __forceinline__ int floormod(int a, int b) {
  const int r = a % b;
  return (r != 0 && ((r < 0) != (b < 0))) ? r + b : r;
}

// torch.clamp: NaN passes through
__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}
__device__ __forceinline__ float max0(float x) { return x < 0.0f ? 0.0f : x; }
__device__ __forceinline__ float min1(float x) { return x > 1.0f ? 1.0f : x; }

// zraytrace_tpu/ops/common.py:76-107, the polynomial inverse trig
__device__ __forceinline__ float atan_core(float z) {
  const float z2 = z * z;
  float p = (float)8.05374449538e-2;
  p = p * z2 - (float)1.38776856032e-1;
  p = p * z2 + (float)1.99777106478e-1;
  p = p * z2 - (float)3.33329491539e-1;
  return p * z2 * z + z;
}

__device__ __forceinline__ float atan2_poly(float y, float x) {
  const float ax = fabsf(x), ay = fabsf(y);
  const bool big = ay > ax;
  const float num = big ? ax : ay;
  float den = big ? ay : ax;
  den = den > 0.0f ? den : 1.0f;
  float a = atan_core(num / den);
  a = big ? HALF_PI_F - a : a;
  a = x < 0.0f ? PI_F - a : a;
  return y < 0.0f ? -a : a;
}

__device__ __forceinline__ float acos_poly(float x) {
  return atan2_poly(sqrtf(max0((1.0f - x) * (1.0f + x))), x);
}

// x * (1 / sqrt(|x|^2)), the tool's x * rsqrt(|x|^2) correctly rounded
__device__ __forceinline__ V3 normalize_inv(V3 v) {
  const float inv = 1.0f / sqrtf(v.x * v.x + v.y * v.y + v.z * v.z);
  return V3{v.x * inv, v.y * inv, v.z * inv};
}

__device__ __forceinline__ float wrap01(float x) {
  x = x > 1.0f ? x - 1.0f : x;
  return x < 0.0f ? x + 1.0f : x;
}

__device__ __forceinline__ void body_full(Lane& c, const float* sph, const float4* rows,
                                          int n_sph, const float* mats, const float* cam,
                                          int base, const Params& p, int mask) {
  const uint32_t seed_sc = (uint32_t)p.seed ^ STREAM_SCATTER;
  const uint32_t seed_cam = (uint32_t)p.seed ^ STREAM_CAMERA;
  const int pixel = add(base, mul(c.slot, p.stride));
  const bool alive = (c.slot < p.n_slots) && (pixel < p.n_pixels);
  const bool exhausted = alive && (c.dep >= p.max_depth);
  const bool processing = alive && !exhausted;

  float t_best;
  unsigned long long n_disc = 0;
  const int win = zr::sphere_winner<false>(rows, n_sph, V3{c.ox, c.oy, c.oz},
                                           V3{c.dx, c.dy, c.dz}, T_MIN, t_best, n_disc);
  float cxs = 0.0f, cys = 0.0f, czs = 0.0f, rs = 1.0f;
  int ms = 0;
  if (win >= 0) {
    cxs = sph[win * zr::S_COLS + zr::S_CX];
    cys = sph[win * zr::S_COLS + zr::S_CY];
    czs = sph[win * zr::S_COLS + zr::S_CZ];
    rs = sph[win * zr::S_COLS + zr::S_R];
    ms = (int)sph[win * zr::S_COLS + zr::S_MAT];
  }
  const bool hit = t_best < BIG;
  const float t_attr = hit ? t_best : 1.0f;
  const float px_ = c.ox + t_attr * c.dx;
  const float py_ = c.oy + t_attr * c.dy;
  const float pz_ = c.oz + t_attr * c.dz;
  const float safe_r = fabsf(rs) > (float)1e-8 ? rs : (float)1e-8;
  float nx = (px_ - cxs) / safe_r;
  float ny = (py_ - cys) / safe_r;
  float nz = (pz_ - czs) / safe_r;
  const bool front = c.dx * nx + c.dy * ny + c.dz * nz <= 0.0f;
  const float fsign = front ? 1.0f : -1.0f;
  nx = nx * fsign;
  ny = ny * fsign;
  nz = nz * fsign;
  const float ony = clampf(ny * fsign, CLIP_LO, CLIP_HI);
  const float theta = acos_poly(-ony);
  float onx = nx * fsign;
  const float onz = nz * fsign;
  const bool pole = (fabsf(onx) + fabsf(onz)) < (float)1e-12;
  onx = pole ? (float)1e-12 : onx;
  const float phi = atan2_poly(-onz, -onx) + PI_F;
  const float uu_ = phi * INV_TWO_PI_F;
  const float vv_ = theta * INV_PI_F;

  const float4 r = zr::uniform4(seed_sc, (uint32_t)pixel, (uint32_t)c.samp, (uint32_t)c.dep);
  const float* m = mats + ms * M_COLS;  // the tool's where-chain: an indexed read
  const float mtype = m[0], ior = m[1], textype = m[2];
  const float tbase = m[6], uoff = m[7], voff = m[8], th = m[9], tw = m[10];

  const float uu = wrap01(1.0f - uu_ + uoff);
  const float vv = wrap01(vv_ + voff);
  const int ix = min(max((int)(uu * tw), 0), (int)tw - 1);
  const int iy = min(max((int)(vv * th), 0), (int)th - 1);
  const int texflat = add(add((int)tbase, mul(iy, p.atlas_w)), ix);

  const float zr_ = r.x * 2.0f - 1.0f;
  const float phi_l = TWO_PI_F * r.y;
  const float rad = sqrtf(max0(1.0f - zr_ * zr_));
  const float rux = rad * cosf(phi_l);
  const float ruy = rad * sinf(phi_l);
  float lx = nx + rux, ly = ny + ruy, lz = nz + zr_;
  if ((lx * lx + ly * ly + lz * lz) < (float)1e-12) {
    lx = nx;
    ly = ny;
    lz = nz;
  }
  const float ddn = c.dx * nx + c.dy * ny + c.dz * nz;
  const float mx = c.dx - 2.0f * ddn * nx;
  const float my = c.dy - 2.0f * ddn * ny;
  const float mz = c.dz - 2.0f * ddn * nz;
  const bool met_absorb = mx * nx + my * ny + mz * nz <= 0.0f;
  const float ratio = front ? 1.0f / ior : ior;
  const float cos_t = min1(-ddn);
  const float sin_t = sqrtf(max0(1.0f - cos_t * cos_t));
  const bool cannot = ratio * sin_t > 1.0f;
  const float r0s = (1.0f - ratio) / (1.0f + ratio);
  const float x = 1.0f - cos_t;
  const float schl = r0s + (1.0f - r0s) * (x * ((x * x) * (x * x)));
  const bool reflect_now = cannot || (schl > r.z);
  const float rpx = ratio * (c.dx + cos_t * nx);
  const float rpy = ratio * (c.dy + cos_t * ny);
  const float rpz = ratio * (c.dz + cos_t * nz);
  const float kk = fabsf(1.0f - (rpx * rpx + rpy * rpy + rpz * rpz));
  const float kroot = kk > 0.0f ? sqrtf(kk) : 0.0f;
  const float gx = reflect_now ? mx : rpx - kroot * nx;
  const float gy = reflect_now ? my : rpy - kroot * ny;
  const float gz = reflect_now ? mz : rpz - kroot * nz;

  const bool is_lam = mtype < 0.5f;
  const bool is_met = (mtype >= 0.5f) && (mtype < 1.5f);
  const V3 s = normalize_inv(is_lam   ? V3{lx, ly, lz}
                             : is_met ? V3{mx, my, mz}
                                      : V3{gx, gy, gz});

  const bool absorbed = is_met && met_absorb;
  const bool miss = processing && !hit;
  const bool sc = processing && hit && !absorbed;
  const bool path_done = miss || (processing && hit && absorbed) || exhausted;

  const float tsky = 0.5f * (c.dy + 1.0f);
  const float skyr = (1.0f - tsky) + tsky * 0.5f;
  const float skyg = (1.0f - tsky) + tsky * (float)0.7;
  const float skyb = (1.0f - tsky) + tsky * 1.0f;
  const float mf = miss ? 1.0f : 0.0f;
  c.ar = c.ar + mf * c.tr * skyr;
  c.ag = c.ag + mf * c.tg * skyg;
  c.ab = c.ab + mf * c.tb * skyb;

  const bool use_img = textype > 0.5f;
  const bool lam_met = is_lam || is_met;
  const float alr = lam_met ? (use_img ? 1.0f : m[3]) : 1.0f;
  const float alg = lam_met ? (use_img ? 1.0f : m[4]) : 1.0f;
  const float alb = lam_met ? (use_img ? 1.0f : m[5]) : 1.0f;
  if (sc) {
    c.tr = c.tr * alr;
    c.tg = c.tg * alg;
    c.tb = c.tb * alb;
    c.ox = px_;
    c.oy = py_;
    c.oz = pz_;
    c.dx = s.x;
    c.dy = s.y;
    c.dz = s.z;
  }
  const int dep = add(sc ? add(c.dep, 1) : c.dep, texflat & mask);

  int samp2 = add(c.samp, path_done ? 1 : 0);
  const bool finished = path_done && (samp2 >= p.sample_end);
  if (finished) {
    c.ar = 0.0f;
    c.ag = 0.0f;
    c.ab = 0.0f;
  }
  const int slot2 = add(c.slot, finished ? 1 : 0);
  samp2 = finished ? p.sample_start : samp2;

  const int pixel2 = add(base, mul(slot2, p.stride));
  const float4 j = zr::uniform4(seed_cam, (uint32_t)pixel2, (uint32_t)samp2, 0u);
  const float pxf = (float)floormod(pixel2, p.width);
  const float pyf = (float)floordiv(pixel2, p.width);
  const float cu = (pxf + j.x - 0.5f) / (float)p.width;
  const float cv = (pyf + j.y - 0.5f) / (float)p.height;
  const V3 nd = normalize_inv(V3{cam[3] + cu * cam[6] + cv * cam[9] - cam[0],
                                 cam[4] + cu * cam[7] + cv * cam[10] - cam[1],
                                 cam[5] + cu * cam[8] + cv * cam[11] - cam[2]});
  if (path_done) {
    c.ox = cam[0];
    c.oy = cam[1];
    c.oz = cam[2];
    c.dx = nd.x;
    c.dy = nd.y;
    c.dz = nd.z;
    c.tr = 1.0f;
    c.tg = 1.0f;
    c.tb = 1.0f;
  }
  c.dep = path_done ? 0 : dep;
  c.samp = samp2;
  c.slot = slot2;
}

template <int V>
__device__ __forceinline__ void body(Lane& c, const float* sph, const float4* rows, int n_sph,
                                     const float* mats, int n_mats, const float* cam, int base,
                                     const Params& p, int mask) {
  if (V == PASS) {
    return;
  } else if (V == SPHERES) {
    float t_best;
    unsigned long long n_disc = 0;
    const int win = zr::sphere_winner<false>(rows, n_sph, V3{c.ox, c.oy, c.oz},
                                             V3{c.dx, c.dy, c.dz}, T_MIN, t_best, n_disc);
    const int ms = win >= 0 ? (int)sph[win * zr::S_COLS + zr::S_MAT] : 0;
    c.tr = t_best < BIG ? c.tr : t_best;
    c.tb = c.tb + (float)ms;
  } else if (V == RNG) {
    const int pixel = add(base, mul(c.slot, p.stride));
    const float4 r = zr::uniform4((uint32_t)p.seed ^ STREAM_SCATTER, (uint32_t)pixel,
                                  (uint32_t)c.samp, (uint32_t)c.dep);
    const float4 j = zr::uniform4((uint32_t)p.seed ^ STREAM_CAMERA, (uint32_t)pixel,
                                  (uint32_t)c.samp, (uint32_t)c.dep);
    c.ox = c.ox + r.x;
    c.oy = c.oy + r.y;
    c.oz = c.oz + r.z;
    c.dx = c.dx + j.x;
    c.dy = c.dy + j.y;
  } else if (V == TRIG || V == TRIG_LIBDEVICE) {
    const float ony = clampf(c.dy, CLIP_LO, CLIP_HI);
    const float theta = V == TRIG ? acos_poly(-ony) : acosf(-ony);
    const float phi = (V == TRIG ? atan2_poly(-c.dz, -c.dx) : atan2f(-c.dz, -c.dx)) + PI_F;
    c.ox = c.ox + sinf(theta * 2.0f);
    c.oy = c.oy + cosf(phi);
    c.oz = c.oz + theta;
  } else if (V == INTDIV) {
    const int pixel = add(base, c.slot);
    c.ox = c.ox + (float)floormod(pixel, p.width);
    c.oy = c.oy + (float)floordiv(pixel, p.width);
  } else if (V == MATS) {
    const int ms = floormod(c.dep, n_mats);
    float acc = 0.0f;
#pragma unroll
    for (int col = 0; col < M_COLS; ++col) acc = acc + mats[ms * M_COLS + col];
    c.ox = c.ox + acc;
  } else {
    body_full(c, sph, rows, n_sph, mats, cam, base, p, mask);
  }
}

template <int V>
__global__ void __launch_bounds__(BLOCK)
body_kernel(const float* __restrict__ sph_g, int n_sph, const float* __restrict__ mats_g,
            int n_mats, const float* __restrict__ cam_g, const int* __restrict__ base_g,
            const float* __restrict__ in_f, const int* __restrict__ in_i,
            float* __restrict__ out_f, int* __restrict__ out_i, int n, Params p, int iters,
            int mask) {
  __shared__ float sph[MAX_SPHERES * zr::S_COLS];
  __shared__ float4 rows[MAX_SPHERES];  // the winner's rows, as the bounce kernel makes them
  __shared__ float mats[MAX_MATS * M_COLS];
  __shared__ float cam[12];
  for (int i = threadIdx.x; i < n_sph * zr::S_COLS; i += blockDim.x) sph[i] = sph_g[i];
  for (int i = threadIdx.x; i < n_sph; i += blockDim.x)
    rows[i] = zr::sphere_row(sph_g + i * zr::S_COLS);
  for (int i = threadIdx.x; i < n_mats * M_COLS; i += blockDim.x) mats[i] = mats_g[i];
  if (threadIdx.x < 12) cam[threadIdx.x] = cam_g[threadIdx.x];
  __syncthreads();

  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  float f[N_F32];
#pragma unroll
  for (int k = 0; k < N_F32; ++k) f[k] = in_f[(size_t)k * n + lane];
  Lane c{f[0], f[1], f[2], f[3], f[4], f[5], f[6], f[7], f[8], f[9], f[10], f[11],
         in_i[lane], in_i[(size_t)n + lane], in_i[2 * (size_t)n + lane]};
  const int base = base_g[lane];
#pragma unroll 1
  for (int i = 0; i < iters; ++i)
    body<V>(c, sph, rows, n_sph, mats, n_mats, cam, base, p, mask);
  const float o[N_F32] = {c.ox, c.oy, c.oz, c.dx, c.dy, c.dz, c.tr, c.tg, c.tb, c.ar, c.ag, c.ab};
#pragma unroll
  for (int k = 0; k < N_F32; ++k) out_f[(size_t)k * n + lane] = o[k];
  out_i[lane] = c.dep;
  out_i[(size_t)n + lane] = c.samp;
  out_i[2 * (size_t)n + lane] = c.slot;
}

template <int V>
void launch_v(int grid, cudaStream_t s, const float* sph, int n_sph, const float* mats,
              int n_mats, const float* cam, const int* base, const float* in_f,
              const int* in_i, float* out_f, int* out_i, int n, const Params& p, int iters) {
  body_kernel<V><<<grid, BLOCK, 0, s>>>(sph, n_sph, mats, n_mats, cam, base, in_f, in_i, out_f,
                                        out_i, n, p, iters, /*mask=*/0);
}

}  // namespace

// variant: index into zraytrace_tpu_torch/probes/body_probe.py VARIANTS;
// in_f/out_f: 12 f32 planes of n lanes, in_i/out_i: 3 int32 planes
// (depth, sample, slot); params: the tool's 10 integers (host memory).
extern "C" int zr_probe_body_launch(int variant, const float* sph, int n_sph, const float* mats,
                                    int n_mats, const float* cam, const int* base,
                                    const float* in_f, const int* in_i, float* out_f,
                                    int* out_i, int n, const int* params, int iters,
                                    void* stream) {
  if (variant < 0 || variant >= N_VARIANTS || n_sph < 1 || n_sph > MAX_SPHERES || n_mats < 1 ||
      n_mats > MAX_MATS || n < 0 || iters < 0 || params[0] <= 0 || params[1] <= 0)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const Params p{params[0], params[1], params[2], params[3], params[4],
                 params[5], params[6], params[7], params[8], params[9]};
  const int grid = (n + BLOCK - 1) / BLOCK;
  cudaStream_t s = (cudaStream_t)stream;
  switch (variant) {
#define ZR_CASE(V)                                                                          \
  case V:                                                                                   \
    launch_v<V>(grid, s, sph, n_sph, mats, n_mats, cam, base, in_f, in_i, out_f, out_i, n, p, \
                iters);                                                                     \
    break;
    ZR_CASE(PASS)
    ZR_CASE(SPHERES)
    ZR_CASE(RNG)
    ZR_CASE(TRIG)
    ZR_CASE(INTDIV)
    ZR_CASE(MATS)
    ZR_CASE(FULL)
    ZR_CASE(TRIG_LIBDEVICE)
#undef ZR_CASE
  }
  return (int)cudaGetLastError();
}

extern "C" const char* zr_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
