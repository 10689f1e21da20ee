// The BVH walk of the path kernels K3 (regen.cu), K4 (regen_shaded.cu) and
// K5 (regen_segs.cu) over the packed walk tables: two-child 64-byte node
// records and 16-byte triangle rows, read with 16-byte loads. Same results
// as the plane walk of traverse.cuh, and as its plain torch version
// (render/traverse.py intersect_packed, which holds the same rule).
//
// Tables (built at upload, render/scene.py _walk_tables):
//   bvh_nodes2 (M, 16) int32, one record per interior node, in node order:
//     words 0-5   left child (node + 1): box min xyz, max xyz (float bits)
//     words 6-11  right child (second_child): box min xyz, max xyz
//     word 12/13  left/right reference: record index if interior, else the
//                 leaf's tri_offset
//     word 14     left tri_count (0: interior)
//     word 15     right tri_count | split_axis << 30
//   tri_pos4 (T, 12) f32: v0, v1, v2, each padded to 16 bytes.
// The root's own box is read from the SoA planes (row 0).
//
// What bounds the plane walk is a chain of dependent loads per node visit:
// six scalar box loads, then tri_count, then tri_offset or split_axis and
// second_child, up to ten loads in two or three round trips, and one visit
// per child. Here a step loads the whole record in one round trip of four
// 16-byte loads, tests both children's boxes from it, and learns each
// child's leaf range with it, so the chain per level is about half as long.
// On the H100 that made launches of 4,096-26,624 lanes 1.4-1.6x faster but
// full-width (262,144-lane) ones only 1.03x (K3) and 1.19x (K5) (PERF.md):
// there the load chain is not what bounds the walk. A 12-byte stack entry
// beat an 8-byte one that read a popped leaf's range back from its parent
// record.
//
// The rule that keeps it bit-exact with the plane walk:
//   * at a record, run the slab arithmetic of traverse.cuh (ray_aabb) on
//     both children; near and far by split_axis and the sign of inv, as
//     there (not by entry distance);
//   * always push the far child, with its entry distance tmin, or +inf
//     where the bound-free part of its test failed (fail_xy, fail_z,
//     tmax <= 0); descend into the near child if its whole test passes
//     against the current best t, else pop;
//   * a popped entry is taken iff its stored tmin < the best t: the only
//     term of the test that depends on the bound, so the decision the plane
//     walk makes when it tests the popped node again;
//   * overflow as there: a push at depth 32 is dropped but the pointer
//     still moves, and a pop reads slot min(sp, 31).
// Every triangle test then runs in the same order against the same bound.
// A closest-hit walk makes as many slab tests as the plane walk visits
// nodes (one for the root and two per record: each record is one push, and
// each push one pop); an any-hit walk that stops early may have tested far
// boxes that the plane walk never popped.

#pragma once

#include <math_constants.h>

#include "traverse.cuh"

namespace rf {

struct PackedView {
  const int4* nodes;    // (M, 16) int32 as four int4 per record
  const float4* tris;   // (T, 12) f32 as three float4 per triangle
  const float* root_min;  // SoA plane rows of the root (node 0)
  const float* root_max;
  const int* root_offset;
  const int* root_count;
  int num_tris;
};

// Entry distance of a child's box: tmin where the bound-free terms of the
// slab test pass, else +inf, so that the full test against a bound is
// `key < bound`. The arithmetic of traverse.cuh's ray_aabb, operation for
// operation, split at its bound term (render/intersect.py ray_aabb_entry).
// A copy: on the H100, ray_aabb written over a shared helper made the plane
// walk's kernels up to 8% slower (PERF.md); the card tests hold both walks
// to their plain versions, which share their terms (_slab_terms).
__device__ __forceinline__ float slab_key(Vec3 lo, Vec3 hi, Vec3 o, Vec3 inv) {
  const float nx = inv.x < 0.0f ? hi.x : lo.x, fx = inv.x < 0.0f ? lo.x : hi.x;
  const float ny = inv.y < 0.0f ? hi.y : lo.y, fy = inv.y < 0.0f ? lo.y : hi.y;
  const float nz = inv.z < 0.0f ? hi.z : lo.z, fz = inv.z < 0.0f ? lo.z : hi.z;
  const float t0x = (nx - o.x) * inv.x, t1x = (fx - o.x) * inv.x;
  const float t0y = (ny - o.y) * inv.y, t1y = (fy - o.y) * inv.y;
  const float t0z = (nz - o.z) * inv.z, t1z = (fz - o.z) * inv.z;

  const float tmin_xy = max_nan(t0x, t0y);
  const float tmax_xy = min_nan(t1x, t1y);
  const bool fail_xy = (t0x > t1y) || (t0y > t1x);
  const bool fail_z = (tmin_xy > t1z) || (t0z > tmax_xy);
  const float tmin = max_nan(tmin_xy, t0z);
  const float tmax = min_nan(tmax_xy, t1z);
  return (!fail_xy && !fail_z && tmax > 0.0f) ? tmin : CUDART_INF_F;
}

struct StackEntry {
  int ref;    // record index, or a leaf's first triangle
  int count;  // the leaf's tri_count, 0 for a record
  float key;  // entry distance (slab_key)
};

// One thread's walk over the packed tables. Returns the leaf-order index of
// the accepted triangle (-1 if none); *t_best_out holds its t (t_max if
// none). kAnyHit stops at the first accepted triangle.
template <bool kAnyHit>
__device__ int walk_packed(const PackedView& s, Vec3 o, Vec3 d, float t_max, float* t_best_out) {
  const Vec3 inv{1.0f / d.x, 1.0f / d.y, 1.0f / d.z};
  float t_best = t_max;
  int hit_tri = -1;
  StackEntry stack[kStackDepth];
  int sp = 0;
  // The root: its box from the SoA planes, then its record (0) or its leaf.
  bool take = slab_key(load3(s.root_min, 0), load3(s.root_max, 0), o, inv) < t_best;
  int count = take ? __ldg(s.root_count) : 0;
  int ref = count > 0 ? __ldg(s.root_offset) : 0;
  while (true) {
    if (take) {
      if (count > 0) {
        for (int k = 0; k < count; ++k) {
          const int tri = min(ref + k, s.num_tris - 1);
          const float4* p4 = s.tris + 3ll * tri;
          const float4 a = __ldg(p4), b = __ldg(p4 + 1), c = __ldg(p4 + 2);
          const float p[9] = {a.x, a.y, a.z, b.x, b.y, b.z, c.x, c.y, c.z};
          float t, u, v;
          if (moller_trumbore(p, o, d, t_best, &t, &u, &v)) {
            t_best = t;
            hit_tri = tri;
            if (kAnyHit) {
              *t_best_out = t_best;
              return hit_tri;
            }
          }
        }
      } else {
        const int4* r = s.nodes + 4ll * ref;
        const int4 a = __ldg(r), b = __ldg(r + 1), c = __ldg(r + 2), m = __ldg(r + 3);
        const float key_l = slab_key(
            Vec3{__int_as_float(a.x), __int_as_float(a.y), __int_as_float(a.z)},
            Vec3{__int_as_float(a.w), __int_as_float(b.x), __int_as_float(b.y)}, o, inv);
        const float key_r = slab_key(
            Vec3{__int_as_float(b.z), __int_as_float(b.w), __int_as_float(c.x)},
            Vec3{__int_as_float(c.y), __int_as_float(c.z), __int_as_float(c.w)}, o, inv);
        const int count_r = m.w & 0x3FFFFFFF;
        const int axis = static_cast<int>(static_cast<unsigned>(m.w) >> 30);
        const bool axis_neg = component(inv, axis) < 0.0f;
        if (sp < kStackDepth) {
          stack[sp] = axis_neg ? StackEntry{m.x, m.z, key_l} : StackEntry{m.y, count_r, key_r};
        }
        ++sp;
        ref = axis_neg ? m.y : m.x;
        count = axis_neg ? count_r : m.z;
        take = (axis_neg ? key_r : key_l) < t_best;
        continue;
      }
    }
    if (sp == 0) break;
    --sp;
    const StackEntry e = stack[min(sp, kStackDepth - 1)];
    ref = e.ref;
    count = e.count;
    take = e.key < t_best;
  }
  *t_best_out = t_best;
  return hit_tri;
}

__device__ __forceinline__ int closest_hit(const PackedView& s, Vec3 o, Vec3 d, float t_max,
                                           float* t_out) {
  return walk_packed<false>(s, o, d, t_max, t_out);
}

__device__ __forceinline__ bool any_hit(const PackedView& s, Vec3 o, Vec3 d, float t_max) {
  float t;
  return walk_packed<true>(s, o, d, t_max, &t) >= 0;
}

// The view of K3's and K5's C entry points: the root's rows of the SoA
// planes (box, tri_offset, tri_count) and the packed tables.
inline PackedView make_packed(const float* aabb_min, const float* aabb_max,
                              const int* tri_offset, const int* tri_count, const int* nodes2,
                              const float* tri_pos4, int num_tris) {
  return PackedView{reinterpret_cast<const int4*>(nodes2),
                    reinterpret_cast<const float4*>(tri_pos4),
                    aabb_min, aabb_max, tri_offset, tri_count, num_tris};
}

}  // namespace rf
