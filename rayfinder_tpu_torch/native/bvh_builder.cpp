// Native binned-SAH BVH builder.
//
// Same algorithm and float32 numerics as the Python builder
// (rayfinder_tpu/bvh/build.py), which itself reimplements the reference's
// recursive SAH build (reference: src/common/bvh.cpp:81-291):
//   - 12-bucket SAH along the max-extent centroid axis, costs 0.5/1.0
//   - equal-count fallback below 3 primitives (stable sort by centroid)
//   - leaf on degenerate AABBs / single primitive / SAH says stop;
//     forced split above 255 primitives
//   - pre-order flattened nodes, first child at idx+1, explicit second
//     child offset, and the triangle reorder map
//
// The recursion is an explicit LIFO work stack (same pre-order layout).
// Compile with -ffp-contract=off so float expressions round exactly like
// the numpy builder (no FMA contraction); topology equality is asserted in
// tests/test_native_bvh.py.
//
// C ABI: rf_build_bvh() writes SoA node planes into caller-allocated
// buffers of capacity 2*num_tris and returns the node count (or -1 if the
// capacity would overflow, which cannot happen for a binary tree whose
// leaves hold >= 1 triangle).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

namespace {

constexpr int kNumBuckets = 12;
constexpr float kTraversalCost = 0.5f;
constexpr int kMaxTrianglesInNode = 255;

struct Vec3 {
  float x, y, z;
};

inline Vec3 vmin(const Vec3& a, const Vec3& b) {
  return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
inline Vec3 vmax(const Vec3& a, const Vec3& b) {
  return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}
inline float surface_area(const Vec3& lo, const Vec3& hi) {
  const float dx = hi.x - lo.x;
  const float dy = hi.y - lo.y;
  const float dz = hi.z - lo.z;
  return 2.0f * (dx * dy + dx * dz + dy * dz);
}
inline float axis_of(const Vec3& v, int axis) {
  return axis == 0 ? v.x : (axis == 1 ? v.y : v.z);
}

// aabb.hpp:33-48 tie-breaking: x wins only when strictly largest.
inline int max_dimension(const Vec3& lo, const Vec3& hi) {
  const float dx = hi.x - lo.x;
  const float dy = hi.y - lo.y;
  const float dz = hi.z - lo.z;
  if (dx > dy && dx > dz) return 0;
  if (dy > dz) return 1;
  return 2;
}

struct Task {
  int64_t begin;  // range into the prim index array
  int64_t end;
  int64_t ordered_offset;
  int64_t parent;  // second-child parent node to patch, or -1
};

}  // namespace

extern "C" int64_t rf_build_bvh(
    const float* triangles,  // (num_tris, 3, 3) row-major
    int64_t num_tris,
    // outputs, capacity >= 2 * num_tris nodes:
    float* aabb_min,            // (cap, 3)
    float* aabb_max,            // (cap, 3)
    uint32_t* tri_offset,       // (cap,)
    uint32_t* second_child,     // (cap,)
    uint32_t* tri_count,        // (cap,)
    uint32_t* split_axis,       // (cap,)
    int64_t* triangle_indices)  // (num_tris,)
{
  if (num_tris <= 0) return -1;
  const int64_t capacity = 2 * num_tris;

  std::vector<Vec3> prim_lo(num_tris), prim_hi(num_tris), prim_c(num_tris);
  for (int64_t i = 0; i < num_tris; ++i) {
    const float* t = triangles + i * 9;
    Vec3 lo{t[0], t[1], t[2]}, hi = lo;
    for (int v = 1; v < 3; ++v) {
      const Vec3 p{t[v * 3], t[v * 3 + 1], t[v * 3 + 2]};
      lo = vmin(lo, p);
      hi = vmax(hi, p);
    }
    prim_lo[i] = lo;
    prim_hi[i] = hi;
    prim_c[i] = {0.5f * (lo.x + hi.x), 0.5f * (lo.y + hi.y), 0.5f * (lo.z + hi.z)};
  }

  std::vector<int64_t> prims(num_tris);
  for (int64_t i = 0; i < num_tris; ++i) prims[i] = i;

  int64_t node_count = 0;
  std::vector<Task> stack;
  stack.push_back({0, num_tris, 0, -1});

  while (!stack.empty()) {
    const Task task = stack.back();
    stack.pop_back();
    if (node_count >= capacity) return -1;
    const int64_t node = node_count++;
    if (task.parent >= 0) second_child[task.parent] = static_cast<uint32_t>(node);

    const int64_t count = task.end - task.begin;
    Vec3 node_lo = prim_lo[prims[task.begin]];
    Vec3 node_hi = prim_hi[prims[task.begin]];
    Vec3 c_lo = prim_c[prims[task.begin]];
    Vec3 c_hi = c_lo;
    for (int64_t i = task.begin + 1; i < task.end; ++i) {
      node_lo = vmin(node_lo, prim_lo[prims[i]]);
      node_hi = vmax(node_hi, prim_hi[prims[i]]);
      c_lo = vmin(c_lo, prim_c[prims[i]]);
      c_hi = vmax(c_hi, prim_c[prims[i]]);
    }
    const int axis = max_dimension(c_lo, c_hi);
    const float c_min = axis_of(c_lo, axis);
    const float c_max = axis_of(c_hi, axis);

    aabb_min[node * 3] = node_lo.x;
    aabb_min[node * 3 + 1] = node_lo.y;
    aabb_min[node * 3 + 2] = node_lo.z;
    aabb_max[node * 3] = node_hi.x;
    aabb_max[node * 3 + 1] = node_hi.y;
    aabb_max[node * 3 + 2] = node_hi.z;

    const auto make_leaf = [&]() {
      tri_offset[node] = static_cast<uint32_t>(task.ordered_offset);
      second_child[node] = 0;
      tri_count[node] = static_cast<uint32_t>(count);
      split_axis[node] = 0xFFFFFFFFu;
      for (int64_t i = 0; i < count; ++i) {
        triangle_indices[prims[task.begin + i]] = task.ordered_offset + i;
      }
    };

    if (surface_area(node_lo, node_hi) == 0.0f || c_min == c_max || count == 1) {
      make_leaf();
      continue;
    }

    int64_t split_idx;
    if (count < 3) {
      // Equal-count split; stable sort matches the numpy builder's tie order.
      std::stable_sort(
          prims.begin() + task.begin, prims.begin() + task.end,
          [&](int64_t a, int64_t b) { return axis_of(prim_c[a], axis) < axis_of(prim_c[b], axis); });
      split_idx = count / 2;
    } else {
      // Binned SAH, float32 bucket arithmetic exactly as bvh.cpp:150-157.
      int64_t counts[kNumBuckets] = {0};
      Vec3 blo[kNumBuckets], bhi[kNumBuckets];
      for (int b = 0; b < kNumBuckets; ++b) {
        blo[b] = {INFINITY, INFINITY, INFINITY};
        bhi[b] = {-INFINITY, -INFINITY, -INFINITY};
      }
      const auto bucket_of = [&](int64_t prim) -> int {
        const float rel =
            (static_cast<float>(kNumBuckets) * (axis_of(prim_c[prim], axis) - c_min)) /
            (c_max - c_min);
        const int b = static_cast<int>(rel);
        return b < kNumBuckets - 1 ? b : kNumBuckets - 1;
      };
      for (int64_t i = task.begin; i < task.end; ++i) {
        const int b = bucket_of(prims[i]);
        counts[b]++;
        blo[b] = vmin(blo[b], prim_lo[prims[i]]);
        bhi[b] = vmax(bhi[b], prim_hi[prims[i]]);
      }

      float costs[kNumBuckets - 1];
      {
        int64_t below = 0;
        Vec3 lo{INFINITY, INFINITY, INFINITY}, hi{-INFINITY, -INFINITY, -INFINITY};
        for (int i = 0; i < kNumBuckets - 1; ++i) {
          below += counts[i];
          lo = vmin(lo, blo[i]);
          hi = vmax(hi, bhi[i]);
          costs[i] = static_cast<float>(below) * surface_area(lo, hi);
        }
        int64_t above = 0;
        lo = {INFINITY, INFINITY, INFINITY};
        hi = {-INFINITY, -INFINITY, -INFINITY};
        for (int i = kNumBuckets - 1; i > 0; --i) {
          above += counts[i];
          lo = vmin(lo, blo[i]);
          hi = vmax(hi, bhi[i]);
          costs[i - 1] = costs[i - 1] + static_cast<float>(above) * surface_area(lo, hi);
        }
      }

      int split_bucket = 0;
      float min_cost = costs[0];
      for (int i = 1; i < kNumBuckets - 1; ++i) {
        if (costs[i] < min_cost) {
          min_cost = costs[i];
          split_bucket = i;
        }
      }

      const float leaf_cost = static_cast<float>(count);
      const float total_cost = kTraversalCost + min_cost / surface_area(node_lo, node_hi);
      if (count > kMaxTrianglesInNode || total_cost < leaf_cost) {
        // Stable partition keeps relative order like the numpy boolean masks.
        auto mid = std::stable_partition(
            prims.begin() + task.begin, prims.begin() + task.end,
            [&](int64_t p) { return bucket_of(p) <= split_bucket; });
        split_idx = mid - (prims.begin() + task.begin);
      } else {
        make_leaf();
        continue;
      }
    }

    split_axis[node] = static_cast<uint32_t>(axis);
    tri_offset[node] = 0;
    tri_count[node] = 0;
    // Push right first: the left child is processed next and lands at node+1.
    stack.push_back({task.begin + split_idx, task.end,
                     task.ordered_offset + split_idx, node});
    stack.push_back({task.begin, task.begin + split_idx, task.ordered_offset, -2});
  }

  return node_count;
}
