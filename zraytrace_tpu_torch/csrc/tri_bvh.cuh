// The bounce kernel's mesh winner: one thread walks the BVH of its ray,
// stackless, over skip links, with leaves of at most 4 triangles.
//
// Replaces, in the bounce kernel's mesh mode (bounce_kernel.cu), the
// per-ray scan of every 128-triangle chunk in packed order: 128 is the
// TPU's lane width, not part of the contract. It is the port of the JAX
// traversal bvh_closest_triangle (zraytrace_tpu/geometry/bvh.py:272), which
// lost to the flash scan on the TPU because Mosaic can neither gather nor
// branch per lane; a Hopper thread can do both.
//
// Contract: the flash winner's (tri_winner.cuh): the first triangle in
// packed order of least t strictly below t_init. The tables
// (ops/mesh_bvh.py) keep it by construction:
// - the builder emits leaves in preorder, their triangles contiguous and
//   ascending in prim_order, the order the flash planes are packed in, so
//   the left-first walk tests triangles in increasing packed position,
//   each in the scan's arithmetic, early exits and strict <;
// - a node is entered when the ray's slab test (tw_reach) reaches its box
//   within (t_min, t_best], else the walk jumps to its skip link. Boxes
//   are dilated outward (ops/mesh_bvh.py node_table), so the cull does not
//   drop a hit that passes the triangle test.
//
// Tables: nodes (M, 8) f32 = two float4 per node: lo.xyz hi.x | hi.yz,
// then, as int32 bits, a leaf's (start, count) or an internal node's
// (skip, 0) (a leaf's skip is the next node). rows (T, 16) f32 = four
// float4 per triangle: fn a.fn | e2 qa.x | qa.yz e1.xy | e1.z ra, the flash
// planes' values (qa = e2 x a, ra = e1 x a). det and t read the first; u
// the second and third; v the third and fourth.
//
// What bounds it: per thread a chain of dependent loads (node after node,
// from L2: the goat-class scene's 3 MB of nodes and 10 MB of rows stay in
// the 50 MB L2) and the divergence of the warp's walks, which differ in
// length; there is no stack and no per-thread array, so the registers stay
// those of the ray and the running best.
//
// The counting instantiation (COUNT) tallies node slab tests, leaves
// entered, triangle tests, and the tests passing det, t and u.

#pragma once

#include <cuda_runtime.h>

#include "tri_winner.cuh"

namespace zr {

// Work counters, in this order in the bounce kernel's int64 work array
// (ops/mesh_bvh.py WORK_FIELDS).
enum { B_NODES, B_LEAVES, B_TRIS, B_DET, B_T, B_U, B_N };

struct TbCount {
  unsigned long long n[B_N];
};

struct TbHit {
  float t;  // t_init where no triangle won
  int id;   // packed id (position in packed order); 0 on a miss
};

template <bool COUNT>
__device__ __forceinline__ TbHit tri_bvh_winner(const float4* __restrict__ nodes, int n_nodes,
                                                const float4* __restrict__ rows, const TwRay& r,
                                                float t_min, float t_init, TbCount& cnt) {
  TbHit best{t_init, 0};
  int node = 0;
  while (node < n_nodes) {
    const float4 a = __ldg(nodes + 2 * node);
    const float4 b = __ldg(nodes + 2 * node + 1);
    if (COUNT) ++cnt.n[B_NODES];
    const float lo[3] = {a.x, a.y, a.z}, hi[3] = {a.w, b.x, b.y};
    const bool reach = tw_reach(lo, hi, r, t_min, best.t);
    const int ref = __float_as_int(b.z), count = __float_as_int(b.w);
    if (count == 0) {  // internal: descend, or skip the subtree
      node = reach ? node + 1 : ref;
      continue;
    }
    ++node;
    if (!reach) continue;
    if (COUNT) ++cnt.n[B_LEAVES];
    for (int i = ref; i < ref + count; ++i) {
      const float4* q = rows + 4 * (size_t)i;
      const float4 q0 = __ldg(q);
      if (COUNT) ++cnt.n[B_TRIS];
      const float det = -(r.dx * q0.x + r.dy * q0.y + r.dz * q0.z);
      if (!(det >= TW_DET_EPS)) continue;
      if (COUNT) ++cnt.n[B_DET];
      const float inv_det = 1.0f / det;  // |det| > 1e-12 here
      const float t = (r.ox * q0.x + r.oy * q0.y + r.oz * q0.z - q0.w) * inv_det;
      if (!(t > t_min && t < best.t)) continue;
      if (COUNT) ++cnt.n[B_T];
      const float4 q1 = __ldg(q + 1);
      const float4 q2 = __ldg(q + 2);
      const float u = (r.px * q1.x + r.py * q1.y + r.pz * q1.z -
                       (r.dx * q1.w + r.dy * q2.x + r.dz * q2.y)) *
                      inv_det;
      if (!(u >= 0.0f)) continue;
      if (COUNT) ++cnt.n[B_U];
      const float4 q3 = __ldg(q + 3);
      const float v = -(r.px * q2.z + r.py * q2.w + r.pz * q3.x -
                        (r.dx * q3.y + r.dy * q3.z + r.dz * q3.w)) *
                      inv_det;
      if (v >= 0.0f && u + v <= 1.0f) {
        best.t = t;
        best.id = i;
      }
    }
  }
  return best;
}

}  // namespace zr
