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
// Design. One thread per lane, 256 a block; the planes are read once and
// written once per launch and the B iterations run in registers, so pass_
// prices the loads and stores of a launch. The sphere, material and
// camera tables sit in shared memory. K = 24 launches are timed as one
// CUDA graph. PCG4D and the sphere winner are the bounce kernel's device
// functions (bounce_common.cuh), so those lines time what the kernel runs.
//
// What bounds it: issue, not bytes (a lane moves 128 bytes per launch) and
// not latency: `full`'s time grows with the lanes (0.027, 0.046 and 0.086
// ms at half, once and twice the tool's, NVIDIA H100 80GB HBM3), so each
// instruction counts. Written plainly, `full`'s loop issued ~1,030
// instructions an iteration for ~405 operations: each IEEE division
// (eleven) a reciprocal, five fused multiply-adds, an FCHK and a branch
// around a called slow path inside a convergence barrier; each square
// root (six, and the winner's seven) and reciprocal the same around an
// exponent test; sinf and cosf of one angle two reductions through the
// conversion pipe with their Payne-Hanek branches; pixel // width and %
// width an integer division rebuilt in every iteration. This design
// (~920 an iteration, 64 registers, every lane resident):
// - takes those operations from exact_math.cuh, the same instructions
//   with a range test in place of each branch, the winner's square roots
//   too (sphere_winner<..., FAST>); the tests of a whole iteration meet in
//   one flag (`&=`, so that it stays a predicate) and one branch, taken
//   where a lane's flag is false, to a called copy of the body built from
//   the library functions (body_lib) that recomputes the iteration from
//   its inputs; a flag the lane's material leaves unread (the dielectric's
//   Schlick division, 0 / 2 on every Lambertian and metal hit) does not
//   count;
// - shares one refined reciprocal between the normal's three divisions
//   by the radius, and makes those of the camera's width and height once
//   per thread;
// - takes sinf and cosf of the Lambertian angle from one reduction;
// - divides by the width (and, for mats, by the material count) with a
//   multiply-high by a reciprocal the host computes once per launch, one
//   quotient for both the floor division and the modulo.
// trig's and intdiv's and mats' operands do not change between
// iterations, so nvcc computes them once per launch: those lines price a
// launch, not the slice. trig keeps the library's division and square
// root in its acos and atan2 and takes sin and cos from exact_math.cuh's
// pure fast path, so that nvcc can still do so (the estimates' inline
// assembly would keep them in the loop). spheres keeps the bounce
// kernel's winner, sqrtf and all.
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
// through as torch.clamp does. exact_math.cuh's functions equal the
// library's bit for bit wherever their flag holds (math_check below).

#include <cuda_runtime.h>
#include <stdint.h>

#include "bounce_common.cuh"
#include "exact_math.cuh"

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

// floor(a / d) for d >= 1 as a multiply-high: q = (u * mul) >> shift for u
// in [0, 2^31), with shift = 31 + ceil(log2 d) and mul = ceil(2^shift / d)
// (mul * d - 2^shift < d <= 2^(shift - 31), so q is exact: Granlund and
// Montgomery, "Division by invariant integers using multiplication", 1994)
struct IntDivisor {
  uint32_t mul;
  int shift, d;
};

IntDivisor int_divisor(int d) {
  int l = 0;
  while ((1ull << l) < (unsigned long long)d) ++l;
  const unsigned long long p = 1ull << (31 + l);
  return IntDivisor{(uint32_t)((p + (unsigned)d - 1) / (unsigned)d), 31 + l, d};
}

// (floor(a / d), a - d * floor(a / d)), the remainder's sign that of d, for
// any int32 a: a negative a divides as -a - 1 (below 2^31), whose quotient
// q gives floor(a / d) = -q - 1
__device__ __forceinline__ int2 floor_divmod(int a, const IntDivisor& v) {
  const uint32_t neg = (uint32_t)(a >> 31);
  const uint32_t u = (uint32_t)a ^ neg;
  const uint32_t q = (uint32_t)(((unsigned long long)u * v.mul) >> v.shift) ^ neg;
  return make_int2((int)q, (int)((uint32_t)a - q * (uint32_t)v.d));
}

// the tool's integer parameters (zraytrace_tpu/ops/common.py P_*) and the
// width's and the material count's divisors
struct Params {
  int width, height, sample_end, max_depth, seed, n_pixels, stride, sample_start, atlas_w,
      n_slots;
  IntDivisor width_div, mats_div;
};

// the tables in shared memory, and the camera's two divisors
struct Tables {
  const float* sph;
  const float4* rows;
  int n_sph;
  const float* mats;
  const float* cam;
  zr::Divisor wdiv, hdiv;
};

struct Lane {
  float ox, oy, oz, dx, dy, dz, tr, tg, tb, ar, ag, ab;
  int dep, samp, slot;
};

__device__ __forceinline__ int add(int a, int b) { return (int)((uint32_t)a + (uint32_t)b); }
__device__ __forceinline__ int mul(int a, int b) { return (int)((uint32_t)a * (uint32_t)b); }

// torch.clamp: NaN passes through
__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}
__device__ __forceinline__ float max0(float x) { return x < 0.0f ? 0.0f : x; }
__device__ __forceinline__ float min1(float x) { return x > 1.0f ? 1.0f : x; }

// The body's divisions, square roots, reciprocals and trig: the library
// functions, or (FAST) exact_math.cuh's, which clear ok where they may
// differ from the library.
template <bool FAST>
__device__ __forceinline__ zr::Divisor divisor(float b, bool& ok) {
  if constexpr (FAST) {
    ok &= zr::div_operand(b);
    return zr::divisor(b);
  } else {
    return zr::Divisor{b, 0.0f};
  }
}

template <bool FAST>
__device__ __forceinline__ float div_by(float a, const zr::Divisor& d, bool& ok) {
  if constexpr (FAST) return zr::div_by(a, d, ok);
  else return a / d.b;
}

template <bool FAST>
__device__ __forceinline__ float fdiv(float a, float b, bool& ok) {
  if constexpr (FAST) return zr::div_fast(a, b, ok);
  else return a / b;
}

template <bool FAST, bool ZERO = false>
__device__ __forceinline__ float fsqrt(float x, bool& ok) {
  if constexpr (FAST) return zr::sqrt_fast<ZERO>(x, ok);
  else return sqrtf(x);
}

template <bool FAST>
__device__ __forceinline__ float frcp(float x, bool& ok) {
  if constexpr (FAST) {
    bool in;
    const float r = zr::rcp_rn_fast(x, in);
    ok &= in;
    return r;
  } else {
    return 1.0f / x;
  }
}

template <bool FAST>
__device__ __forceinline__ void fsincos(float x, float& s, float& c, bool& ok) {
  if constexpr (FAST) {
    zr::sincos_fast(x, s, c, ok);
  } else {
    s = sinf(x);
    c = cosf(x);
  }
}

// zraytrace_tpu/ops/common.py:76-107, the polynomial inverse trig
__device__ __forceinline__ float atan_core(float z) {
  const float z2 = z * z;
  float p = (float)8.05374449538e-2;
  p = p * z2 - (float)1.38776856032e-1;
  p = p * z2 + (float)1.99777106478e-1;
  p = p * z2 - (float)3.33329491539e-1;
  return p * z2 * z + z;
}

template <bool FAST>
__device__ __forceinline__ float atan2_poly(float y, float x, bool& ok) {
  const float ax = fabsf(x), ay = fabsf(y);
  const bool big = ay > ax;
  const float num = big ? ax : ay;
  float den = big ? ay : ax;
  den = den > 0.0f ? den : 1.0f;
  float a = atan_core(fdiv<FAST>(num, den, ok));
  a = big ? HALF_PI_F - a : a;
  a = x < 0.0f ? PI_F - a : a;
  return y < 0.0f ? -a : a;
}

template <bool FAST>
__device__ __forceinline__ float acos_poly(float x, bool& ok) {
  return atan2_poly<FAST>(fsqrt<FAST>(max0((1.0f - x) * (1.0f + x)), ok), x, ok);
}

// x * (1 / sqrt(|x|^2)), the tool's x * rsqrt(|x|^2) correctly rounded
template <bool FAST>
__device__ __forceinline__ V3 normalize_inv(V3 v, bool& ok) {
  const float inv = frcp<FAST>(fsqrt<FAST>(v.x * v.x + v.y * v.y + v.z * v.z, ok), ok);
  return V3{v.x * inv, v.y * inv, v.z * inv};
}

// sinf and cosf, not inlined: trig's slow path, kept out of its loop
__device__ __noinline__ float sin_lib(float x) { return sinf(x); }
__device__ __noinline__ float cos_lib(float x) { return cosf(x); }

__device__ __forceinline__ float wrap01(float x) {
  x = x > 1.0f ? x - 1.0f : x;
  return x < 0.0f ? x + 1.0f : x;
}

template <bool FAST>
__device__ __forceinline__ void body_full(Lane& c, const Tables& tb, int base, const Params& p,
                                          int mask, bool& ok) {
  const float* sph = tb.sph;
  const float* cam = tb.cam;
  const uint32_t seed_sc = (uint32_t)p.seed ^ STREAM_SCATTER;
  const uint32_t seed_cam = (uint32_t)p.seed ^ STREAM_CAMERA;
  const int pixel = add(base, mul(c.slot, p.stride));
  const bool alive = (c.slot < p.n_slots) && (pixel < p.n_pixels);
  const bool exhausted = alive && (c.dep >= p.max_depth);
  const bool processing = alive && !exhausted;

  float t_best;
  unsigned long long n_disc = 0;
  const int win = zr::sphere_winner<false, FAST>(tb.rows, tb.n_sph, V3{c.ox, c.oy, c.oz},
                                                 V3{c.dx, c.dy, c.dz}, T_MIN, t_best, n_disc, ok);
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
  const zr::Divisor rdiv = divisor<FAST>(safe_r, ok);
  float nx = div_by<FAST>(px_ - cxs, rdiv, ok);
  float ny = div_by<FAST>(py_ - cys, rdiv, ok);
  float nz = div_by<FAST>(pz_ - czs, rdiv, ok);
  const bool front = c.dx * nx + c.dy * ny + c.dz * nz <= 0.0f;
  const float fsign = front ? 1.0f : -1.0f;
  nx = nx * fsign;
  ny = ny * fsign;
  nz = nz * fsign;
  const float ony = clampf(ny * fsign, CLIP_LO, CLIP_HI);
  const float theta = acos_poly<FAST>(-ony, ok);
  float onx = nx * fsign;
  const float onz = nz * fsign;
  const bool pole = (fabsf(onx) + fabsf(onz)) < (float)1e-12;
  onx = pole ? (float)1e-12 : onx;
  const float phi = atan2_poly<FAST>(-onz, -onx, ok) + PI_F;
  const float uu_ = phi * INV_TWO_PI_F;
  const float vv_ = theta * INV_PI_F;

  const float4 r = zr::uniform4(seed_sc, (uint32_t)pixel, (uint32_t)c.samp, (uint32_t)c.dep);
  const float* m = tb.mats + ms * M_COLS;  // the tool's where-chain: an indexed read
  const float mtype = m[0], ior = m[1], textype = m[2];
  const float tbase = m[6], uoff = m[7], voff = m[8], th = m[9], tw = m[10];
  const bool is_lam = mtype < 0.5f;
  const bool is_met = (mtype >= 0.5f) && (mtype < 1.5f);

  const float uu = wrap01(1.0f - uu_ + uoff);
  const float vv = wrap01(vv_ + voff);
  const int ix = min(max((int)(uu * tw), 0), (int)tw - 1);
  const int iy = min(max((int)(vv * th), 0), (int)th - 1);
  const int texflat = add(add((int)tbase, mul(iy, p.atlas_w)), ix);

  // each material's direction; its flag counts only where the lane's
  // material reads the direction
  bool ok_lam = true, ok_diel = true;
  const float zr_ = r.x * 2.0f - 1.0f;
  const float phi_l = TWO_PI_F * r.y;
  const float rad = fsqrt<FAST, true>(max0(1.0f - zr_ * zr_), ok_lam);
  float sin_l, cos_l;
  fsincos<FAST>(phi_l, sin_l, cos_l, ok_lam);
  const float rux = rad * cos_l;
  const float ruy = rad * sin_l;
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
  const float ratio = front ? frcp<FAST>(ior, ok_diel) : ior;
  const float cos_t = min1(-ddn);
  const float sin_t = fsqrt<FAST, true>(max0(1.0f - cos_t * cos_t), ok_diel);
  const bool cannot = ratio * sin_t > 1.0f;
  const float r0s = fdiv<FAST>(1.0f - ratio, 1.0f + ratio, ok_diel);
  const float x = 1.0f - cos_t;
  const float schl = r0s + (1.0f - r0s) * (x * ((x * x) * (x * x)));
  const bool reflect_now = cannot || (schl > r.z);
  const float rpx = ratio * (c.dx + cos_t * nx);
  const float rpy = ratio * (c.dy + cos_t * ny);
  const float rpz = ratio * (c.dz + cos_t * nz);
  const float kk = fabsf(1.0f - (rpx * rpx + rpy * rpy + rpz * rpz));
  const float kroot = kk > 0.0f ? fsqrt<FAST>(kk, ok_diel) : 0.0f;
  const float gx = reflect_now ? mx : rpx - kroot * nx;
  const float gy = reflect_now ? my : rpy - kroot * ny;
  const float gz = reflect_now ? mz : rpz - kroot * nz;
  ok &= is_lam ? ok_lam : (is_met | ok_diel);

  const V3 s = normalize_inv<FAST>(is_lam   ? V3{lx, ly, lz}
                                   : is_met ? V3{mx, my, mz}
                                            : V3{gx, gy, gz},
                                   ok);

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
  const int2 qr = floor_divmod(pixel2, p.width_div);
  const float pxf = (float)qr.y;
  const float pyf = (float)qr.x;
  const float cu = div_by<FAST>(pxf + j.x - 0.5f, tb.wdiv, ok);
  const float cv = div_by<FAST>(pyf + j.y - 0.5f, tb.hdiv, ok);
  const V3 nd = normalize_inv<FAST>(V3{cam[3] + cu * cam[6] + cv * cam[9] - cam[0],
                                       cam[4] + cu * cam[7] + cv * cam[10] - cam[1],
                                       cam[5] + cu * cam[8] + cv * cam[11] - cam[2]},
                                    ok);
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

template <int V, bool FAST>
__device__ __forceinline__ void body(Lane& c, const Tables& tb, int base, const Params& p,
                                     int mask, bool& ok) {
  if constexpr (V == PASS) {
    return;
  } else if constexpr (V == SPHERES) {
    float t_best;
    unsigned long long n_disc = 0;
    const int win = zr::sphere_winner<false>(tb.rows, tb.n_sph, V3{c.ox, c.oy, c.oz},
                                             V3{c.dx, c.dy, c.dz}, T_MIN, t_best, n_disc);
    const int ms = win >= 0 ? (int)tb.sph[win * zr::S_COLS + zr::S_MAT] : 0;
    c.tr = t_best < BIG ? c.tr : t_best;
    c.tb = c.tb + (float)ms;
  } else if constexpr (V == RNG) {
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
  } else if constexpr (V == TRIG) {
    // acos and atan2 with the library's division and square root, sin and
    // cos from one pure fast path: trig's inputs do not change between
    // iterations, and nvcc computes what it can prove pure once per launch
    // (exact_math.cuh's estimates are inline assembly, which it keeps in
    // the loop)
    const float ony = clampf(c.dy, CLIP_LO, CLIP_HI);
    bool in = true;
    const float theta = acos_poly<false>(-ony, in);
    const float phi = atan2_poly<false>(-c.dz, -c.dx, in) + PI_F;
    float s = zr::sin_fast(theta * 2.0f, in), co = zr::cos_fast(phi, in);
    if (!in) {
      s = sin_lib(theta * 2.0f);
      co = cos_lib(phi);
    }
    c.ox = c.ox + s;
    c.oy = c.oy + co;
    c.oz = c.oz + theta;
  } else if constexpr (V == TRIG_LIBDEVICE) {
    const float ony = clampf(c.dy, CLIP_LO, CLIP_HI);
    const float theta = acosf(-ony);
    const float phi = atan2f(-c.dz, -c.dx) + PI_F;
    c.ox = c.ox + sinf(theta * 2.0f);
    c.oy = c.oy + cosf(phi);
    c.oz = c.oz + theta;
  } else if constexpr (V == INTDIV) {
    const int2 qr = floor_divmod(add(base, c.slot), p.width_div);
    c.ox = c.ox + (float)qr.y;
    c.oy = c.oy + (float)qr.x;
  } else if constexpr (V == MATS) {
    const int ms = floor_divmod(c.dep, p.mats_div).y;
    float acc = 0.0f;
#pragma unroll
    for (int col = 0; col < M_COLS; ++col) acc = acc + tb.mats[ms * M_COLS + col];
    c.ox = c.ox + acc;
  } else {
    body_full<FAST>(c, tb, base, p, mask, ok);
  }
}


// One iteration from the library functions alone: the slow path of an
// iteration whose fast body cleared its flag. Not inlined, so that the
// loop holds one call in place of a second body.
template <int V>
__device__ __noinline__ Lane body_lib(Lane c, Tables tb, int base, Params p, int mask) {
  bool ok = true;
  body<V, false>(c, tb, base, p, mask, ok);
  return c;
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
  bool ok_tables = true;  // the camera's divisors in the fast path's range
  const Tables tb{sph, rows, n_sph, mats, cam, divisor<true>((float)p.width, ok_tables),
                  divisor<true>((float)p.height, ok_tables)};
  float f[N_F32];
#pragma unroll
  for (int k = 0; k < N_F32; ++k) f[k] = in_f[(size_t)k * n + lane];
  Lane c{f[0], f[1], f[2], f[3], f[4], f[5], f[6], f[7], f[8], f[9], f[10], f[11],
         in_i[lane], in_i[(size_t)n + lane], in_i[2 * (size_t)n + lane]};
  const int base = base_g[lane];
#pragma unroll 1
  for (int i = 0; i < iters; ++i) {
    bool ok = ok_tables;
    if constexpr (V == FULL) {
      Lane next = c;
      body<V, true>(next, tb, base, p, mask, ok);
      c = ok ? next : body_lib<V>(c, tb, base, p, mask);
    } else {
      body<V, true>(c, tb, base, p, mask, ok);
    }
  }
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

// exact_math.cuh against the library, for math_check: FN_SIN and
// FN_SINCOS on the floats with bits lo .. lo + count - 1 (sin_fast and
// cos_fast with them, against sinf and cosf), FN_SQRT the same for
// sqrt_fast<true> against sqrtf; FN_DIV on `count` pairs from index lo
// (div_fast against the IEEE division): random bits with the exponent
// fields drawn from [56, 198], about the fast range [67, 187] with both
// its edges, or, for FN_DIV_NEAR, b random in that range and a = b * q
// rounded, q with a 12-bit mantissa, so that many quotients lie at or
// next to a float and the final correction decides them; FN_DIV_EDGES on
// the pairs of EDGES x EDGES floats (index lo + i). tally[0] += the
// values or pairs on the fast path, tally[1] += those that differ from
// the library in any bit.
enum MathFn { FN_SIN, FN_SINCOS, FN_SQRT, FN_DIV, FN_DIV_NEAR, FN_DIV_EDGES, N_FN };

__device__ __forceinline__ uint32_t mix32(uint32_t x) {  // a 32-bit finaliser (murmur3)
  x ^= x >> 16;
  x *= 0x85ebca6bu;
  x ^= x >> 13;
  x *= 0xc2b2ae35u;
  return x ^ (x >> 16);
}

__device__ __forceinline__ float with_exponent(uint32_t bits, uint32_t e) {
  return __uint_as_float((bits & 0x807fffffu) | (e << 23));
}

// the edge floats of the division's range: exponent fields at and beside
// the range's ends, and at the ends of all floats, with the extreme
// mantissas and their neighbours, of both signs (17 x 8 x 2)
__device__ __forceinline__ float edge_float(uint32_t i) {
  const uint32_t exps[17] = {0, 1, 2, 65, 66, 67, 68, 100, 126, 127, 128, 150, 186, 187, 188,
                             254, 255};
  const uint32_t mants[8] = {0, 1, 2, 0x3fffff, 0x400000, 0x400001, 0x7ffffe, 0x7fffff};
  return __uint_as_float(((i & 1u) << 31) | (exps[(i >> 1) % 17] << 23) | mants[(i >> 1) / 17]);
}
constexpr uint32_t N_EDGES = 17 * 8 * 2;

__global__ void __launch_bounds__(256)
math_check_kernel(int fn, unsigned lo, unsigned long long count,
                  unsigned long long* __restrict__ tally) {
  unsigned long long fast = 0, bad = 0;
  const unsigned long long stride = (unsigned long long)gridDim.x * blockDim.x;
  for (unsigned long long i = blockIdx.x * blockDim.x + threadIdx.x; i < count; i += stride) {
    const uint32_t k = lo + (uint32_t)i;
    bool ok = true;
    bool differs = false;
    if (fn == FN_SIN || fn == FN_SINCOS || fn == FN_SQRT) {
      const float x = __uint_as_float(k);
      if (fn == FN_SQRT) {
        const float r = zr::sqrt_fast<true>(x, ok);
        differs = __float_as_uint(r) != __float_as_uint(sqrtf(x));
      } else if (fn == FN_SIN) {
        const float s = zr::sin_fast(x, ok), c = zr::cos_fast(x, ok);
        differs = __float_as_uint(s) != __float_as_uint(sinf(x)) ||
                  __float_as_uint(c) != __float_as_uint(cosf(x));
      } else {
        float s, c;
        zr::sincos_fast(x, s, c, ok);
        differs = __float_as_uint(s) != __float_as_uint(sinf(x)) ||
                  __float_as_uint(c) != __float_as_uint(cosf(x));
      }
    } else {
      float a, b;
      if (fn == FN_DIV_EDGES) {
        a = edge_float(k / N_EDGES);
        b = edge_float(k % N_EDGES);
      } else {
        const uint32_t ha = mix32(k * 2u + 1u), hb = mix32(k * 2u + 0x9e3779b9u);
        b = with_exponent(hb, 56u + (mix32(hb) >> 8) % 143u);
        if (fn == FN_DIV) {
          a = with_exponent(ha, 56u + (mix32(ha) >> 8) % 143u);
        } else {  // b times a q of 12 mantissa bits, about 2^-40 .. 2^40
          const float q = with_exponent(ha & 0x807ff000u, 87u + (mix32(ha) >> 8) % 81u);
          a = b * q;
        }
      }
      const float q = zr::div_fast(a, b, ok);
      differs = __float_as_uint(q) != __float_as_uint(__fdiv_rn(a, b));
    }
    if (ok) {
      ++fast;
      bad += differs;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    fast += __shfl_xor_sync(0xffffffffu, fast, off);
    bad += __shfl_xor_sync(0xffffffffu, bad, off);
  }
  if (threadIdx.x % 32 == 0) {
    atomicAdd(tally, fast);
    atomicAdd(tally + 1, bad);
  }
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
  const Params p{params[0], params[1], params[2], params[3], params[4], params[5], params[6],
                 params[7], params[8], params[9], int_divisor(params[0]), int_divisor(n_mats)};
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

// fn: MathFn; tally (2,) uint64, added to: see math_check_kernel
extern "C" int zr_probe_math_check(int fn, unsigned lo, unsigned long long count,
                                   unsigned long long* tally, void* stream) {
  if (fn < 0 || fn >= N_FN) return (int)cudaErrorInvalidValue;
  if (count == 0) return 0;
  math_check_kernel<<<132 * 8, 256, 0, (cudaStream_t)stream>>>(fn, lo, count, tally);
  return (int)cudaGetLastError();
}

extern "C" const char* zr_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
