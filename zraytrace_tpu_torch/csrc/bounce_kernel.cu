// Bounce kernel for sphere and mesh scenes, written for Hopper (sm_90a).
//
// Replaces the TPU bounce megakernel zraytrace_tpu/ops/bounce_kernel3.py:222
// (make_bounce_kernel3, driven by wavefront_trace_pallas3) in sphere mode
// and in mesh mode (has_mesh, :231-248, with the flash glue :1338-1370),
// and so also the round-2 zraytrace_tpu/legacy/bounce_kernel2.py:71. The
// contract is that of the plain wavefront (zraytrace_tpu_torch/render.py
// wavefront_trace, itself the port of zraytrace_tpu/render.py:255):
// per-pixel slot sums (n_slots, N, 3) f32 and the six event counters.
//
// Design. One thread per lane: lane i traces pixels base[i] + k*stride,
// k < n_slots, each pixel's samples one after another (or one block of
// them: sample blocks, below), each path to its end. The TPU kernel's
// deferred texel slots, records, texel cache, per-launch gather,
// roll-fold, balanced lane map and launch loop existed
// only because Mosaic can neither gather inside a kernel nor skip a
// branch; here a textured hit reads its one nearest texel straight from
// global memory (the 12.6 MB atlas stays in the 50 MB L2).
//
// The loop is the plain wavefront's: one loop of segments per thread,
// whose state is (slot, sample, depth, ray, throughput, pixel sum). A
// lane whose path escapes, is absorbed or runs out of depth adds its
// radiance, commits the pixel's sum on its last sample and starts its
// next sample's camera ray in the next iteration, as the wavefront
// regenerates a lane in place. A sample loop around a depth loop would
// hold every lane of a warp at the end of each sample until the warp's
// longest path ended: paths of scene 1 take 1 to 31 steps, so under SIMT
// half the lanes' issue slots would idle at 4 spp. The warp runs while
// any of its lanes is alive (__any_sync), so each lane still sums its
// pixel's samples in sample order with the same arithmetic, and the warp
// reductions at the end see every lane. The loop state costs registers
// (72 a thread), so blocks are 128 threads: an SM then holds 7 blocks,
// 28 warps, where 256-thread blocks would fit 3, 24 warps.
//
// What bounds it: per-ray FP32 and SFU work (7 sphere tests, PCG4D,
// sqrt/acos/atan2/sin/cos) and warp divergence from unequal path lengths
// and material branches, not bytes: a ray reads ~1 texel. There is no
// matrix work, so no wgmma or TMA. The scene tables (spheres (S,5),
// materials (M,11), camera (12)) sit in shared memory, with the sphere
// winner's rows: one float4 (cx, cy, cz, c.c - r*r) per sphere, made once
// per block, so a sphere test is one broadcast shared load and 16
// operations (23 with c.c - r*r made in every test).
// PCG4D and the sphere winner are the device functions of
// bounce_common.cuh, which the bounce-body probe (probe_body.cu) times.
//
// Mesh mode (the template parameter MESH, so the sphere-only kernel is
// compiled as before). The TPU kernel blocks a segment that can reach the
// mesh, resolves all blocked lanes with one flash call per launch and
// replays them, because Mosaic cannot intersect triangles usefully inside
// the megakernel. Here each segment runs the sphere winner; if the ray
// reaches the mesh root box within (t_min, t_sphere], the triangle winner
// runs in place, seeded with t_sphere: a stackless walk of the mesh's BVH
// (tri_bvh.cuh, leaves of 4), with the flash winner's contract and
// arithmetic; the merge is a strict <, so spheres keep exact ties, and a
// triangle hit is shaded with its attrs row (unit face normal, material
// id). The walk is a chain of dependent node loads per ray, and walks
// differ in length between the lanes of a warp, as do rays that reach the
// mesh and rays that do not: these bound mesh scenes. The node and
// triangle tables stay in global memory (the teapot's 121 KB and 405 KB
// sit in L2). The root box is the union of the chunk boxes, so it
// contains every triangle.
//
// Sample blocks (the template parameter BLOCKED, so the kernel render()
// runs is compiled as before). A rank of parallel/mesh.py's data axis
// owns a 1/n_data share of render()'s lanes; one thread per lane would
// launch too few warps to fill the card, and its longest lanes, tracing
// every sample of a glass pixel, would set the launch's end. So its
// samples are cut into n_blocks contiguous blocks of block_spp (the last
// shorter) and its lanes are given once a block, warp by warp: warp w
// traces its 32 lanes over block w % n_blocks, so a rank launches
// render()'s lane count and consecutive warps trace the same 32 pixels
// over the blocks in turn. (All of one block's lanes before the next
// block's took 23.4 ms against 17.6 ms a rank at the showcase's size on
// one H100: resident warps then spread over four times the image.) The
// wrapper adds a pixel's block sums in block order. A lane over one block
// is the plain wavefront's lane over that block's samples, so a launch
// equals the plain traces of the blocks' ranges bit for bit; the image
// differs from one running sum over all samples only by the order of the
// adds.
//
// Numerics follow the plain PyTorch version operation by operation:
// explicit left-to-right component sums, division where the reference
// divides (1.0f/sqrtf, no rsqrtf), the IEEE library functions (no fast
// math), built with -fmad=false so no multiply-add is contracted.
//
// Work counters (the template parameter COUNT, for a bound on the kernel's
// time; the instantiations without it are the ones render() runs): the
// sphere tests whose discriminant is positive, the segments that reach the
// mesh root box, the triangle hits shaded, the BVH walk's own counts, and
// the loop's SIMT counts: lane steps (iterations in which a lane was
// alive: rays + recursion-depth hits), warp iterations, the material
// branches (sky, texel fetch, Lambertian, metal, dielectric) each warp
// iteration ran, summed over iterations, and in mesh mode the node slab
// tests of the longest walk in each warp iteration, summed: the trips of
// the walk loop, against which the node tests give the walk's SIMT share.
//
// Counters: rays, reflections, background hits, recursion-depth hits and
// samples are summed per thread, reduced per warp and added with one
// 64-bit atomicAdd per warp. The sixth, wavefront iterations, is the
// largest number of loop steps one lane took (warp max, then atomicMax):
// the number of lockstep iterations the plain wavefront needs for the same
// lanes, so the two engines report the same value.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bounce_common.cuh"
#include "tri_bvh.cuh"

namespace {

constexpr int MAX_SPHERES = 32;
constexpr int MAX_MATS = 32;
constexpr int BLOCK = 128;  // occupancy: see the design note
constexpr float T_MIN = 1e-3f;
constexpr float PI_F = 3.14159265358979323846f;
constexpr float TWO_PI_F = 6.28318530717958647692f;
constexpr uint32_t STREAM_CAMERA = 0x9E3779B9u;
constexpr uint32_t STREAM_SCATTER = 0x85EBCA6Bu;

constexpr int LAMBERTIAN = 0;
constexpr int METAL = 1;
constexpr int TEX_IMAGE = 1;

// material table columns (zraytrace_tpu/ops/common.py prepare_tables)
enum {
  M_TYPE, M_IOR, M_TEXTYPE, M_R, M_G, M_B, M_BASE, M_UOFF, M_VOFF, M_TH, M_TW,
  M_COLS
};
enum { C_RAYS, C_REFLECTIONS, C_BACKGROUND, C_RECURSION, C_SAMPLES, C_ITERS };

using zr::dot3;
using zr::uniform4;
using zr::V3;
using zr::S_COLS;
using zr::S_CX;
using zr::S_CY;
using zr::S_CZ;
using zr::S_R;
using zr::S_MAT;

__device__ __forceinline__ V3 normalize(V3 v) {
  float len = sqrtf(dot3(v, v));
  return V3{v.x / len, v.y / len, v.z / len};
}

__device__ __forceinline__ float wrap01(float x) {
  x = x > 1.0f ? x - 1.0f : x;
  return x < 0.0f ? x + 1.0f : x;
}

__device__ __forceinline__ V3 reflect(V3 v, V3 n) {
  float k = 2.0f * dot3(v, n);
  return V3{v.x - k * n.x, v.y - k * n.y, v.z - k * n.z};
}

__device__ __forceinline__ unsigned long long warp_sum(unsigned long long v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ unsigned long long warp_max(unsigned long long v) {
  for (int off = 16; off > 0; off >>= 1) {
    unsigned long long o = __shfl_down_sync(0xffffffffu, v, off);
    v = o > v ? o : v;
  }
  return v;
}

// work array columns after the walk's (ops/bounce_kernel.py WORK_FIELDS)
enum {
  W_DISC = zr::B_N, W_ROOT, W_TRI_HITS, W_LANE_STEPS, W_WARP_ITERS, W_WARP_BRANCHES, W_WARP_NODES,
  W_N
};
// the branches a warp iteration may run, counted into W_WARP_BRANCHES
enum { BR_SKY, BR_TEXEL, BR_LAMBERTIAN, BR_METAL, BR_DIELECTRIC };

// The mesh (mesh mode only): the BVH walk's node table (M, 8) and triangle
// rows (T, 16) (tri_bvh.cuh), attrs by packed id (C*128, 4) and the root
// box [lo3, hi3].
struct Mesh {
  const float4* nodes;
  const float4* rows;
  const float* attrs;
  const float* box;
  int n_nodes;
};

template <bool MESH, bool COUNT, bool BLOCKED>
__global__ void __launch_bounds__(BLOCK)
bounce_kernel(const float* __restrict__ sph_g, int n_sph,
              const float* __restrict__ mats_g, int n_mats,
              const float* __restrict__ cam_g,
              const float* __restrict__ atlas, int atlas_w, Mesh mesh,
              const int* __restrict__ base, int n_lanes, int width, int height,
              int sample_start, int spp, int max_depth, uint32_t seed,
              int pixel_stride, int n_pixels, int n_slots,
              float* __restrict__ slot_sums,
              unsigned long long* __restrict__ counters,
              unsigned long long* __restrict__ work, int n_blocks, int block_spp) {
  __shared__ float sph[MAX_SPHERES * S_COLS];
  __shared__ float4 sph_rows[MAX_SPHERES];  // the winner's (bounce_common.cuh sphere_row)
  __shared__ float mats[MAX_MATS * M_COLS];
  __shared__ float cam[12];
  __shared__ float box[6];
  for (int i = threadIdx.x; i < n_sph * S_COLS; i += blockDim.x) sph[i] = sph_g[i];
  for (int i = threadIdx.x; i < n_sph; i += blockDim.x)
    sph_rows[i] = zr::sphere_row(sph_g + i * S_COLS);
  for (int i = threadIdx.x; i < n_mats * M_COLS; i += blockDim.x) mats[i] = mats_g[i];
  if (threadIdx.x < 12) cam[threadIdx.x] = cam_g[threadIdx.x];
  if (MESH && threadIdx.x < 6) box[threadIdx.x] = mesh.box[threadIdx.x];
  __syncthreads();

  const V3 origin{cam[0], cam[1], cam[2]};
  const V3 lower_left{cam[3], cam[4], cam[5]};
  const V3 horizontal{cam[6], cam[7], cam[8]};
  const V3 vertical{cam[9], cam[10], cam[11]};
  const float fw = (float)width, fh = (float)height;
  const uint32_t seed_cam = seed ^ STREAM_CAMERA;
  const uint32_t seed_sc = seed ^ STREAM_SCATTER;

  uint32_t n_rays = 0, n_refl = 0, n_bg = 0, n_rec = 0, n_samp = 0;
  uint32_t steps = 0;
  zr::TbCount cnt{};
  unsigned long long n_disc = 0, n_root = 0, n_tri_hits = 0;
  // the warp's, kept by every lane
  unsigned long long n_iters = 0, n_branches = 0, n_warp_nodes = 0;
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (BLOCKED) {  // this thread's block of samples: warps dealt to the blocks in turn
    const int b = (lane / 32) % n_blocks;
    sample_start += b * block_spp;
    spp = min(block_spp, spp - b * block_spp);
  }
  const int sample_end = sample_start + spp;

  // The loop state: slot k of the lane (pixel b0 + k*stride), sample s,
  // depth, the ray, its throughput and the pixel's running sum. `fresh`:
  // the path has no ray yet, so this iteration starts with its camera ray.
  int b0 = 0, k = 0, pixel = 0, s = sample_start, depth = 0;
  float px = 0.0f, py = 0.0f;
  V3 o{0.0f, 0.0f, 0.0f}, d{0.0f, 0.0f, 0.0f};
  float tx = 1.0f, ty = 1.0f, tz = 1.0f;
  float ax = 0.0f, ay = 0.0f, az = 0.0f;
  bool fresh = true;
  bool alive = lane < n_lanes;
  if (alive) {
    b0 = base[lane];
    pixel = b0;
    alive = pixel < n_pixels;  // the wavefront's lane_alive
    px = (float)(pixel % width);
    py = (float)(pixel / width);
  }

  // One iteration is one step of the plain wavefront's loop for this lane:
  // a depth check or a traced segment, and where the path ends, its
  // radiance, the pixel's commit on its last sample and the move to the
  // next sample. The warp runs while any of its lanes is alive.
  while (__any_sync(0xffffffffu, alive)) {
    unsigned branches = 0;  // COUNT: the material branches this lane ran
    const unsigned long long nodes_before = cnt.n[zr::B_NODES];
    if (alive) {
      if (fresh) {  // camera ray (camera.pixel_uv + get_rays)
        const float4 j = uniform4(seed_cam, (uint32_t)pixel, (uint32_t)s, 0u);
        const float u = (px + j.x - 0.5f) / fw;
        const float v = (py + j.y - 0.5f) / fh;
        o = origin;
        d = normalize(V3{lower_left.x + u * horizontal.x + v * vertical.x - origin.x,
                         lower_left.y + u * horizontal.y + v * vertical.y - origin.y,
                         lower_left.z + u * horizontal.z + v * vertical.z - origin.z});
        tx = ty = tz = 1.0f;
        depth = 0;
        fresh = false;
      }
      ++steps;
      bool done = true;
      if (depth >= max_depth) {  // checked before tracing
        ++n_rec;
      } else {
        ++n_rays;

        // fused sphere winner (bounce_common.cuh); strict < keeps the
        // first sphere on ties
        float t_best;
        const int win = zr::sphere_winner<COUNT>(sph_rows, n_sph, o, d, T_MIN, t_best,
                                                 n_disc);

        // mesh mode: the BVH walk's winner below the sphere winner's t
        bool tri = false;
        V3 tri_n{0.0f, 0.0f, 0.0f};
        int tri_mid = 0;
        if (MESH) {
          const zr::TwRay ray = zr::tw_ray(o.x, o.y, o.z, d.x, d.y, d.z);
          if (zr::tw_reach(box, box + 3, ray, T_MIN, t_best)) {
            if (COUNT) ++n_root;
            const zr::TbHit th = zr::tri_bvh_winner<COUNT>(mesh.nodes, mesh.n_nodes, mesh.rows,
                                                           ray, T_MIN, t_best, cnt);
            if (th.t < t_best) {
              if (COUNT) ++n_tri_hits;
              t_best = th.t;
              tri = true;
              const float* at = mesh.attrs + 4 * (size_t)th.id;
              tri_n = V3{__ldg(at), __ldg(at + 1), __ldg(at + 2)};
              tri_mid = (int)__ldg(at + 3);
            }
          }
        }

        if (win < 0 && !tri) {  // escaped: the sky is the only light
          ++n_bg;
          if (COUNT) branches |= 1u << BR_SKY;
          const float t = 0.5f * (d.y + 1.0f);
          const float w1 = 1.0f - t;
          ax = ax + tx * (w1 * 1.0f + t * 0.5f);
          ay = ay + ty * (w1 * 1.0f + t * 0.7f);
          az = az + tz * (w1 * 1.0f + t * 1.0f);
        } else {
          // hit attributes: the attrs row of a triangle, else
          // geometry/sphere.py sphere_attributes
          const V3 p{o.x + t_best * d.x, o.y + t_best * d.y, o.z + t_best * d.z};
          V3 out = tri_n;
          int mid = tri_mid;
          if (!tri) {
            const V3 c{sph[win * S_COLS + S_CX], sph[win * S_COLS + S_CY],
                       sph[win * S_COLS + S_CZ]};
            float r = sph[win * S_COLS + S_R];
            mid = (int)sph[win * S_COLS + S_MAT];
            r = fabsf(r) > 1e-8f ? r : (r < 0.0f ? -1e-8f : 1e-8f);
            out = V3{(p.x - c.x) / r, (p.y - c.y) / r, (p.z - c.z) / r};
          }
          const bool front = dot3(d, out) <= 0.0f;
          const V3 n = front ? out : V3{-out.x, -out.y, -out.z};

          const float* m = &mats[mid * M_COLS];
          const int mtype = (int)m[M_TYPE];
          const float4 rnd = uniform4(seed_sc, (uint32_t)pixel, (uint32_t)s, (uint32_t)depth);
          const V3 met = reflect(d, n);
          V3 nd;
          float ar = 1.0f, ag = 1.0f, ab = 1.0f;
          if (mtype == LAMBERTIAN || mtype == METAL) {
            if (m[M_TEXTYPE] == (float)TEX_IMAGE) {
              // spherical uv, then the nearest texel (textures.py)
              if (COUNT) branches |= 1u << BR_TEXEL;
              const float ny = fminf(fmaxf(out.y, -1.0f + 1e-7f), 1.0f - 1e-7f);
              const float theta = acosf(-ny);
              float nx = out.x;
              const float nz = out.z;
              if (fabsf(nx) + fabsf(nz) < 1e-12f) nx = 1e-12f;
              const float phi = atan2f(-nz, -nx) + PI_F;
              const float uu = wrap01(1.0f - phi / TWO_PI_F + m[M_UOFF]);
              const float vv = wrap01(theta / PI_F + m[M_VOFF]);
              const int tw = (int)m[M_TW], th = (int)m[M_TH];
              const int ix = min(max((int)(uu * m[M_TW]), 0), tw - 1);
              const int iy = min(max((int)(vv * m[M_TH]), 0), th - 1);
              const long long flat = (long long)m[M_BASE] + (long long)iy * atlas_w + ix;
              ar = __ldg(&atlas[flat * 3 + 0]);
              ag = __ldg(&atlas[flat * 3 + 1]);
              ab = __ldg(&atlas[flat * 3 + 2]);
            } else {
              ar = m[M_R];
              ag = m[M_G];
              ab = m[M_B];
            }
          }
          bool absorbed = false;
          if (mtype == LAMBERTIAN) {
            if (COUNT) branches |= 1u << BR_LAMBERTIAN;
            const float z = rnd.x * 2.0f - 1.0f;
            const float ph = TWO_PI_F * rnd.y;
            const float rr = sqrtf(fmaxf(0.0f, 1.0f - z * z));
            nd = V3{n.x + rr * cosf(ph), n.y + rr * sinf(ph), n.z + z};
            if (dot3(nd, nd) < 1e-12f) nd = n;
          } else if (mtype == METAL) {
            if (COUNT) branches |= 1u << BR_METAL;
            nd = met;
            absorbed = dot3(met, n) <= 0.0f;
          } else {  // dielectric
            if (COUNT) branches |= 1u << BR_DIELECTRIC;
            const float ior = m[M_IOR];
            const float ratio = front ? 1.0f / ior : ior;
            const V3 nd_in{-d.x, -d.y, -d.z};
            const float cos_t = fminf(dot3(nd_in, n), 1.0f);
            const float sin_t = sqrtf(fmaxf(0.0f, 1.0f - cos_t * cos_t));
            const bool cannot_refract = ratio * sin_t > 1.0f;
            const float r0 = (1.0f - ratio) / (1.0f + ratio);
            const float x = 1.0f - cos_t;
            const float x2 = x * x;
            const float refl = r0 + (1.0f - r0) * (x * (x2 * x2));
            if (cannot_refract || refl > rnd.z) {
              nd = met;
            } else {
              const V3 perp{ratio * (d.x + cos_t * n.x), ratio * (d.y + cos_t * n.y),
                            ratio * (d.z + cos_t * n.z)};
              const float kk = fabsf(1.0f - dot3(perp, perp));
              const float root = kk > 0.0f ? sqrtf(kk) : 0.0f;
              const float nr = -root;
              nd = V3{perp.x + nr * n.x, perp.y + nr * n.y, perp.z + nr * n.z};
            }
          }
          if (!absorbed) {
            // normalize_safe: multiply by 1/sqrt, zero for degenerate input
            const float n2 = dot3(nd, nd);
            const float inv = n2 > 1e-20f ? 1.0f / sqrtf(n2) : 0.0f;
            d = V3{nd.x * inv, nd.y * inv, nd.z * inv};
            o = p;
            tx = tx * ar;
            ty = ty * ag;
            tz = tz * ab;
            ++n_refl;
            ++depth;
            done = false;
          }
        }
      }
      if (done) {  // the path ended: the lane moves to its next sample
        ++n_samp;
        fresh = true;
        if (++s == sample_end) {  // the pixel's last sample: commit it to its slot
          float* dst = slot_sums + ((size_t)k * n_lanes + lane) * 3;
          dst[0] = ax;
          dst[1] = ay;
          dst[2] = az;
          ax = ay = az = 0.0f;
          s = sample_start;
          if (++k < n_slots) {
            pixel = b0 + k * pixel_stride;
            alive = pixel < n_pixels;
            px = (float)(pixel % width);
            py = (float)(pixel / width);
          } else {
            alive = false;
          }
        }
      }
    }
    if (COUNT) {
      ++n_iters;
      n_branches += __popc(__reduce_or_sync(0xffffffffu, branches));
      if (MESH)  // the walk loop's trips: its longest walk in the warp
        n_warp_nodes += __reduce_max_sync(0xffffffffu,
                                          (unsigned)(cnt.n[zr::B_NODES] - nodes_before));
    }
  }

  const unsigned long long sums[5] = {n_rays, n_refl, n_bg, n_rec, n_samp};
  const bool leader = (threadIdx.x & 31) == 0;
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    const unsigned long long t = warp_sum(sums[i]);
    if (leader && t) atomicAdd(&counters[i], t);
  }
  const unsigned long long most = warp_max(steps);
  if (leader && most) atomicMax(&counters[C_ITERS], most);
  if (COUNT) {
#pragma unroll
    for (int i = 0; i < zr::B_N; ++i) zr::tw_add(&work[i], cnt.n[i]);
    zr::tw_add(&work[W_DISC], n_disc);
    zr::tw_add(&work[W_ROOT], n_root);
    zr::tw_add(&work[W_TRI_HITS], n_tri_hits);
    zr::tw_add(&work[W_LANE_STEPS], steps);
    if (leader && n_iters) {
      atomicAdd(&work[W_WARP_ITERS], n_iters);
      atomicAdd(&work[W_WARP_BRANCHES], n_branches);
      atomicAdd(&work[W_WARP_NODES], n_warp_nodes);
    }
  }
}

template <bool MESH>
void launch(int grid, cudaStream_t stream, const float* sph, int n_sph, const float* mats,
            int n_mats, const float* cam, const float* atlas, int atlas_w, const Mesh& mesh,
            const int* base, int n_lanes, int width, int height, int sample_start, int spp,
            int max_depth, unsigned int seed, int pixel_stride, int n_pixels, int n_slots,
            float* slot_sums, unsigned long long* counters, unsigned long long* work,
            int n_blocks, int block_spp) {
  const auto kernel = work ? bounce_kernel<MESH, true, false>
                      : n_blocks > 1 ? bounce_kernel<MESH, false, true>
                                     : bounce_kernel<MESH, false, false>;
  kernel<<<grid, BLOCK, 0, stream>>>(
      sph, n_sph, mats, n_mats, cam, atlas, atlas_w, mesh, base, n_lanes, width, height,
      sample_start, spp, max_depth, seed, pixel_stride, n_pixels, n_slots, slot_sums, counters,
      work, n_blocks, block_spp);
}

}  // namespace

// n_nodes == 0: sphere mode (nodes, rows, attrs and box unused);
// n_nodes > 0: mesh mode, where n_sph may be 0; nodes and rows 16-byte
// aligned. work: null, or int64 [W_N] that receives the work done (the
// slower counting kernel; one block only). n_blocks > 1: sample blocks,
// lane i tracing samples [sample_start + b * block_spp, min(that +
// block_spp, sample_start + spp)) of block b = (i / 32) % n_blocks; the
// blocks cover the samples and none is empty.
extern "C" int zr_bounce_launch_blocks(const float* sph, int n_sph, const float* mats,
                                       int n_mats, const float* cam, const float* atlas,
                                       int atlas_w, const float* nodes, const float* rows,
                                       const float* attrs, const float* box, int n_nodes,
                                       unsigned long long* work, const int* base, int n_lanes,
                                       int width, int height, int sample_start, int spp,
                                       int max_depth, unsigned int seed, int pixel_stride,
                                       int n_pixels, int n_slots, int n_blocks, int block_spp,
                                       float* slot_sums, unsigned long long* counters,
                                       void* stream) {
  const bool mesh_mode = n_nodes > 0;
  if (n_sph < (mesh_mode ? 0 : 1) || n_sph > MAX_SPHERES || n_mats < 1 ||
      n_mats > MAX_MATS || n_nodes < 0 ||
      (mesh_mode && (((uintptr_t)nodes | (uintptr_t)rows) & 15)))
    return (int)cudaErrorInvalidValue;
  if (n_blocks != 1 && (n_blocks < 1 || work || block_spp < 1 ||
                        (long long)(n_blocks - 1) * block_spp >= spp ||
                        (long long)n_blocks * block_spp < spp))
    return (int)cudaErrorInvalidValue;
  if (n_lanes <= 0) return 0;
  const int grid = (n_lanes + BLOCK - 1) / BLOCK;
  const Mesh mesh{reinterpret_cast<const float4*>(nodes), reinterpret_cast<const float4*>(rows),
                  attrs, box, n_nodes};
  (mesh_mode ? launch<true> : launch<false>)(
      grid, (cudaStream_t)stream, sph, n_sph, mats, n_mats, cam, atlas, atlas_w, mesh, base,
      n_lanes, width, height, sample_start, spp, max_depth, seed, pixel_stride, n_pixels,
      n_slots, slot_sums, counters, work, n_blocks, block_spp);
  return (int)cudaGetLastError();
}

// One block: render()'s launch, the interface builds of other checkouts share.
extern "C" int zr_bounce_launch(const float* sph, int n_sph, const float* mats,
                                int n_mats, const float* cam, const float* atlas,
                                int atlas_w, const float* nodes, const float* rows,
                                const float* attrs, const float* box, int n_nodes,
                                unsigned long long* work, const int* base, int n_lanes, int width,
                                int height, int sample_start, int spp, int max_depth,
                                unsigned int seed, int pixel_stride, int n_pixels,
                                int n_slots, float* slot_sums,
                                unsigned long long* counters, void* stream) {
  return zr_bounce_launch_blocks(sph, n_sph, mats, n_mats, cam, atlas, atlas_w, nodes, rows,
                                 attrs, box, n_nodes, work, base, n_lanes, width, height,
                                 sample_start, spp, max_depth, seed, pixel_stride, n_pixels,
                                 n_slots, 1, spp, slot_sums, counters, stream);
}

extern "C" const char* zr_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
