// Native binned-SAH BVH builder.
//
// Host-side runtime component: scene preprocessing (the analogue of the
// reference's BVH build step, bvh.zig:129-179, upgraded from its
// 3-axis x 3-candidate-split heuristic to full binned SAH). Emits a
// flattened preorder skip-link layout (geometry/bvh.py TriBVH).
//
// The same source as zraytrace_tpu/native/bvh_builder.cpp, so both
// packages compute the same prim_order (the order the flash planes are
// packed in). Exposed via a C ABI for ctypes; built with g++ at first
// use by ops/build.py (build_host).

#include <algorithm>
#include <cfloat>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int kBins = 16;

struct Vec3 {
  float x, y, z;
};

inline Vec3 vmin(const Vec3 &a, const Vec3 &b) {
  return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
inline Vec3 vmax(const Vec3 &a, const Vec3 &b) {
  return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}
inline float axis(const Vec3 &v, int a) { return a == 0 ? v.x : (a == 1 ? v.y : v.z); }

inline float surface_area(const Vec3 &lo, const Vec3 &hi) {
  const float dx = std::max(hi.x - lo.x, 0.0f);
  const float dy = std::max(hi.y - lo.y, 0.0f);
  const float dz = std::max(hi.z - lo.z, 0.0f);
  return 2.0f * (dx * dy + dy * dz + dz * dx);
}

struct Builder {
  const Vec3 *lo;
  const Vec3 *hi;
  std::vector<Vec3> centroid;
  int leaf_size;

  std::vector<Vec3> node_min, node_max;
  std::vector<int32_t> prim_start, prim_count, skip;
  std::vector<int64_t> order;
  int64_t cursor = 0;

  // Build the subtree over order[first, first+n) in preorder.
  void emit(int64_t first, int64_t n) {
    const int node = static_cast<int>(node_min.size());
    Vec3 bmin = {FLT_MAX, FLT_MAX, FLT_MAX};
    Vec3 bmax = {-FLT_MAX, -FLT_MAX, -FLT_MAX};
    Vec3 cmin = bmin, cmax = bmax;
    for (int64_t i = first; i < first + n; ++i) {
      bmin = vmin(bmin, lo[order[i]]);
      bmax = vmax(bmax, hi[order[i]]);
      cmin = vmin(cmin, centroid[order[i]]);
      cmax = vmax(cmax, centroid[order[i]]);
    }
    node_min.push_back(bmin);
    node_max.push_back(bmax);
    prim_start.push_back(0);
    prim_count.push_back(0);
    skip.push_back(-1);

    if (n <= leaf_size) {
      prim_start[node] = static_cast<int32_t>(first);
      prim_count[node] = static_cast<int32_t>(n);
      return;
    }

    // Binned SAH across all 3 axes.
    int best_axis = -1, best_cut = -1;
    float best_cost = FLT_MAX;
    float best_cmin = 0.0f, best_inv_extent = 0.0f;
    for (int ax = 0; ax < 3; ++ax) {
      const float extent = axis(cmax, ax) - axis(cmin, ax);
      if (extent <= 1e-12f) continue;
      const float inv = kBins / extent;
      int32_t counts[kBins] = {0};
      Vec3 bins_lo[kBins], bins_hi[kBins];
      for (int b = 0; b < kBins; ++b) {
        bins_lo[b] = {FLT_MAX, FLT_MAX, FLT_MAX};
        bins_hi[b] = {-FLT_MAX, -FLT_MAX, -FLT_MAX};
      }
      for (int64_t i = first; i < first + n; ++i) {
        int b = static_cast<int>((axis(centroid[order[i]], ax) - axis(cmin, ax)) * inv);
        b = std::min(b, kBins - 1);
        counts[b]++;
        bins_lo[b] = vmin(bins_lo[b], lo[order[i]]);
        bins_hi[b] = vmax(bins_hi[b], hi[order[i]]);
      }
      // prefix/suffix sweeps
      Vec3 lmin[kBins], lmax[kBins], rmin[kBins], rmax[kBins];
      int64_t lcount[kBins];
      Vec3 acc_lo = {FLT_MAX, FLT_MAX, FLT_MAX};
      Vec3 acc_hi = {-FLT_MAX, -FLT_MAX, -FLT_MAX};
      int64_t acc_n = 0;
      for (int b = 0; b < kBins; ++b) {
        acc_lo = vmin(acc_lo, bins_lo[b]);
        acc_hi = vmax(acc_hi, bins_hi[b]);
        acc_n += counts[b];
        lmin[b] = acc_lo;
        lmax[b] = acc_hi;
        lcount[b] = acc_n;
      }
      acc_lo = {FLT_MAX, FLT_MAX, FLT_MAX};
      acc_hi = {-FLT_MAX, -FLT_MAX, -FLT_MAX};
      for (int b = kBins - 1; b >= 0; --b) {
        acc_lo = vmin(acc_lo, bins_lo[b]);
        acc_hi = vmax(acc_hi, bins_hi[b]);
        rmin[b] = acc_lo;
        rmax[b] = acc_hi;
      }
      for (int cut = 0; cut < kBins - 1; ++cut) {
        const int64_t nl = lcount[cut];
        const int64_t nr = n - nl;
        if (nl == 0 || nr == 0) continue;
        const float cost = nl * surface_area(lmin[cut], lmax[cut]) +
                           nr * surface_area(rmin[cut + 1], rmax[cut + 1]);
        if (cost < best_cost) {
          best_cost = cost;
          best_axis = ax;
          best_cut = cut;
          best_cmin = axis(cmin, ax);
          best_inv_extent = inv;
        }
      }
    }

    int64_t mid;
    if (best_axis < 0) {
      // Degenerate centroids: median split on the widest axis.
      int ax = 0;
      float wmax = -1.0f;
      for (int a2 = 0; a2 < 3; ++a2) {
        const float w = axis(cmax, a2) - axis(cmin, a2);
        if (w > wmax) { wmax = w; ax = a2; }
      }
      mid = first + n / 2;
      std::nth_element(order.begin() + first, order.begin() + mid,
                       order.begin() + first + n,
                       [&](int64_t a2, int64_t b2) {
                         return axis(centroid[a2], ax) < axis(centroid[b2], ax);
                       });
    } else {
      auto it = std::partition(
          order.begin() + first, order.begin() + first + n, [&](int64_t p) {
            int b = static_cast<int>((axis(centroid[p], best_axis) - best_cmin) *
                                     best_inv_extent);
            b = std::min(b, kBins - 1);
            return b <= best_cut;
          });
      mid = it - order.begin();
      if (mid == first || mid == first + n) mid = first + n / 2;  // safety
    }

    emit(first, mid - first);
    emit(mid, first + n - mid);
    skip[node] = static_cast<int32_t>(node_min.size());
  }
};

}  // namespace

extern "C" {

// Returns the node count, or -1 if max_nodes was too small.
// lo/hi: (n,3) primitive bounds. Outputs sized by the caller:
// node_* capacity max_nodes; prim_order capacity n.
int64_t zrt_build_bvh(const float *lo, const float *hi, int64_t n,
                      int32_t leaf_size, float *out_node_min,
                      float *out_node_max, int32_t *out_prim_start,
                      int32_t *out_prim_count, int32_t *out_skip,
                      int32_t *out_prim_order, int64_t max_nodes) {
  Builder b;
  b.lo = reinterpret_cast<const Vec3 *>(lo);
  b.hi = reinterpret_cast<const Vec3 *>(hi);
  b.leaf_size = leaf_size;
  b.centroid.resize(n);
  for (int64_t i = 0; i < n; ++i) {
    b.centroid[i] = {0.5f * (b.lo[i].x + b.hi[i].x),
                     0.5f * (b.lo[i].y + b.hi[i].y),
                     0.5f * (b.lo[i].z + b.hi[i].z)};
  }
  b.order.resize(n);
  for (int64_t i = 0; i < n; ++i) b.order[i] = i;
  b.node_min.reserve(2 * n / leaf_size + 4);

  b.emit(0, n);

  const int64_t m = static_cast<int64_t>(b.node_min.size());
  if (m > max_nodes) return -1;
  std::memcpy(out_node_min, b.node_min.data(), m * sizeof(Vec3));
  std::memcpy(out_node_max, b.node_max.data(), m * sizeof(Vec3));
  std::memcpy(out_prim_start, b.prim_start.data(), m * sizeof(int32_t));
  std::memcpy(out_prim_count, b.prim_count.data(), m * sizeof(int32_t));
  for (int64_t i = 0; i < m; ++i) {
    // leaves escape to the next preorder node; internal nodes to their
    // subtree end; the final node escapes to m (done sentinel).
    int32_t s = b.skip[i];
    if (b.prim_count[i] > 0) s = static_cast<int32_t>(std::min<int64_t>(i + 1, m));
    else if (s < 0) s = static_cast<int32_t>(m);
    out_skip[i] = s;
  }
  for (int64_t i = 0; i < n; ++i)
    out_prim_order[i] = static_cast<int32_t>(b.order[i]);
  return m;
}
}
