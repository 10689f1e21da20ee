// The BVH walk of every kernel that walks: the ray queries K1, K2 and the
// counted walk K6 (walk.cu), the path kernels K3 (regen.cu), K4
// (regen_shaded.cu) and K5 (regen_segs.cu), and the sky-round probe K8
// (skyround.cu), over the packed walk tables: two-child 64-byte node records
// and 16-byte triangle rows, read with 16-byte loads. Same results as the
// plane walk over the SoA planes (render/traverse.py _walk, the plain
// specification), and as its own plain torch version (render/traverse.py
// intersect_packed, which holds the same rule).
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
// At full width a launch's time follows the steps a warp takes times the
// instructions of a record step (PERF.md; all on an NVIDIA H100 80GB HBM3,
// 700.00 W: on 262,144 rays the plane walk, this walk in one loop of
// record, leaf or pop steps, a while-while loop and a persistent grid
// refilled from a counter were within 6% of each other, 0.131-0.146 ms).
// A warp runs a step's record code if any lane is at a record;
// in a one-step loop half of a ray's steps are pops (21 of 43), spent idle
// beside other lanes' records, and a warp of random rays ran 73 steps for
// lanes of 37, with leaf tests for one or two lanes in a quarter of them.
// So walk_packed makes a warp's steps few and full:
//   * seek: a lane pops until it holds an entry to take (a few instructions
//     per pop), so every trip of the record loop reads a record: 22 steps
//     per ray instead of 43;
//   * while-while: the record loop runs until the lane holds a leaf to test
//     or is done, and the leaf tests follow it, so the lanes of a warp meet
//     at the leaf tests instead of running them for one lane at a time;
//   * the slab key's four NaN-propagating min/max are one instruction each
//     (min.NaN.f32 / max.NaN.f32), not two compares and a select.
// Nothing is speculated: a ray's own steps keep their order, only when its
// warp runs them changes. On that card the three together made K1 1.26x, K2
// 1.19x, K3 1.19x, K4 1.18x (its work-item kernel at 262,144 lanes) to 1.55x
// (its tile kernel at 26,624) and K5 1.29x faster than the one-step loop.
//
// Where the stack lives is the kernel's choice (kShared). 32 entries of 12
// bytes in local memory are 384 bytes a thread, and local memory is cached
// in L1: 900-1,300 resident threads hold 340-480 KB of stack per SM against
// 256 KB of L1, and since the seek pops often, the stacks' lines evict the
// records' (under the one-step loop, which pops one entry per step, the
// stack in shared memory was 15% slower). With its first kShared entries in
// shared memory (entry k of thread t at [k * kBlock + t]; the deeper ones,
// rarely reached, stay local; the overflow rule is unchanged) the ray
// queries of incoherent rays were 1.35x faster on that card and K4's
// work-item kernel 1.12x, while launches that do not fill the card (K4's
// tile kernel) or whose lanes are coherent lost up to 25% and 12%: so K1 and
// K2 take 16 entries, K4's work items 12, and K3, K5 and K4's tile kernel
// keep the local stack (PERF.md).
//
// The rule that keeps it bit-exact with the plane walk:
//   * at a record, run the plane walk's slab arithmetic (ray_aabb) on
//     both children; near and far by split_axis and the sign of inv, as
//     there (not by entry distance);
//   * always push the far child, with its entry distance tmin, or +inf
//     where the bound-free part of its test failed (fail_xy, fail_z,
//     tmax <= 0); descend into the near child if its whole test passes
//     against the current best t, else pop;
//   * a popped entry is taken iff its stored tmin < the best t: the only
//     term of the test that depends on the bound, so the decision the plane
//     walk makes when it tests the popped node again;
//   * overflow as there: a push at depth 32 (kStack) is dropped but the
//     pointer still moves, and a pop reads slot min(sp, 31).
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
// `key < bound`. The arithmetic of the plane walk's slab test (ray_aabb),
// operation for operation, split at its bound term (render/intersect.py
// ray_aabb_entry; the plain versions share their terms, _slab_terms). The
// NaN-propagating min/max are PTX's (max_nan1, min_nan1): of two zeros of
// different sign they may return the other one than traverse.cuh's max_nan,
// which no comparison downstream tells apart (a key is only compared with a
// bound).
__device__ __forceinline__ float max_nan1(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float min_nan1(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float slab_key(Vec3 lo, Vec3 hi, Vec3 o, Vec3 inv) {
  const float nx = inv.x < 0.0f ? hi.x : lo.x, fx = inv.x < 0.0f ? lo.x : hi.x;
  const float ny = inv.y < 0.0f ? hi.y : lo.y, fy = inv.y < 0.0f ? lo.y : hi.y;
  const float nz = inv.z < 0.0f ? hi.z : lo.z, fz = inv.z < 0.0f ? lo.z : hi.z;
  const float t0x = (nx - o.x) * inv.x, t1x = (fx - o.x) * inv.x;
  const float t0y = (ny - o.y) * inv.y, t1y = (fy - o.y) * inv.y;
  const float t0z = (nz - o.z) * inv.z, t1z = (fz - o.z) * inv.z;

  const float tmin_xy = max_nan1(t0x, t0y);
  const float tmax_xy = min_nan1(t1x, t1y);
  const bool fail_xy = (t0x > t1y) || (t0y > t1x);
  const bool fail_z = (tmin_xy > t1z) || (t0z > tmax_xy);
  const float tmin = max_nan1(tmin_xy, t0z);
  const float tmax = min_nan1(tmax_xy, t1z);
  return (!fail_xy && !fail_z && tmax > 0.0f) ? tmin : CUDART_INF_F;
}

struct StackEntry {
  int ref;    // record index, or a leaf's first triangle
  int count;  // the leaf's tri_count, 0 for a record
  float key;  // entry distance (slab_key)
};

// The first kShared entries of the stacks of a block of kBlock threads, one
// array per kShared for the closest and the any-hit walks of a kernel
// (a thread runs one walk at a time).
template <int kShared>
__device__ __forceinline__ StackEntry* shared_stack() {
  __shared__ StackEntry entries[kShared * kBlock];
  return entries + threadIdx.x;
}

// One thread's walk over the packed tables. Returns the leaf-order index of
// the accepted triangle (-1 if none); *t_best_out holds its t (t_max if
// none). kAnyHit stops at the first accepted triangle. kCount is a level of
// counting: 0 none (the path kernels, K2); 1 the records read, into
// *records_out (K1: a closest walk makes one slab test for the root and two
// per record, the nodes the plane walk visits); 2 also the leaves entered
// (a leaf entry taken: the plane walk's slab test passing on a leaf) and the
// triangles tested (each Moller-Trumbore call), into *leaves_out and
// *tests_out (K6, and K4 with its leaves unread). Counters above the level
// are compiled out, so a level adds only its own. kShared: how many of the
// stack's first entries live in shared memory (0: none; the block is kBlock
// threads). kStack: the stack's entries, kStackDepth or, for a deeper tree,
// kDeepStack; the 32-entry walk is the code it was before the choice.
template <bool kAnyHit, int kCount = 0, int kShared = 0, int kStack = kStackDepth>
__device__ int walk_packed(const PackedView& s, Vec3 o, Vec3 d, float t_max, float* t_best_out,
                           int* records_out = nullptr, int* leaves_out = nullptr,
                           int* tests_out = nullptr) {
  static_assert(kShared >= 0 && kShared <= kStack, "the stack has kStack entries");
  constexpr int kLocal = kStack - kShared;
  const Vec3 inv{1.0f / d.x, 1.0f / d.y, 1.0f / d.z};
  float t_best = t_max;
  int hit_tri = -1;
  int records = 0;
  int leaves = 0;
  int tests = 0;
  StackEntry stack[kLocal > 0 ? kLocal : 1];  // entries kShared .. kStack - 1
  StackEntry* shared = nullptr;               // entries 0 .. kShared - 1, kBlock apart
  if constexpr (kShared > 0) shared = shared_stack<kShared>();
  int sp = 0;
  // The root: its box from the SoA planes, then its record (0) or its leaf.
  bool take = slab_key(load3(s.root_min, 0), load3(s.root_max, 0), o, inv) < t_best;
  int count = take ? __ldg(s.root_count) : 0;
  int ref = count > 0 ? __ldg(s.root_offset) : 0;
  bool alive = true;
  while (alive) {
    // Records, until the ray holds a leaf to test or is done.
    while (true) {
      // Seek: pop until an entry to take.
      while (!take && sp > 0) {
        --sp;
        const int slot = min(sp, kStack - 1);
        StackEntry e;
        if constexpr (kShared == 0) {
          e = stack[slot];
        } else if constexpr (kLocal == 0) {
          e = shared[slot * kBlock];
        } else {
          e = slot < kShared ? shared[slot * kBlock] : stack[slot - kShared];
        }
        ref = e.ref;
        count = e.count;
        take = e.key < t_best;
      }
      if (!take) {
        alive = false;
        break;
      }
      if (count > 0) break;
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
      if (sp < kStack) {
        const StackEntry far = axis_neg ? StackEntry{m.x, m.z, key_l}
                                        : StackEntry{m.y, count_r, key_r};
        if constexpr (kShared == 0) {
          stack[sp] = far;
        } else if constexpr (kLocal == 0) {
          shared[sp * kBlock] = far;
        } else if (sp < kShared) {
          shared[sp * kBlock] = far;
        } else {
          stack[sp - kShared] = far;
        }
      }
      ++sp;
      if (kCount >= 1) ++records;
      ref = axis_neg ? m.y : m.x;
      count = axis_neg ? count_r : m.z;
      take = (axis_neg ? key_r : key_l) < t_best;
    }
    if (alive) {
      if (kCount >= 2) ++leaves;
      for (int k = 0; k < count; ++k) {
        const int tri = min(ref + k, s.num_tris - 1);
        const float4* p4 = s.tris + 3ll * tri;
        const float4 a = __ldg(p4), b = __ldg(p4 + 1), c = __ldg(p4 + 2);
        const float p[9] = {a.x, a.y, a.z, b.x, b.y, b.z, c.x, c.y, c.z};
        float t, u, v;
        if (kCount >= 2) ++tests;
        if (moller_trumbore(p, o, d, t_best, &t, &u, &v)) {
          t_best = t;
          hit_tri = tri;
          if (kAnyHit) {
            alive = false;
            break;
          }
        }
      }
      take = false;
    }
  }
  *t_best_out = t_best;
  if (kCount >= 1) *records_out = records;
  if (kCount >= 2) {
    *leaves_out = leaves;
    *tests_out = tests;
  }
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

// A PackedView whose walks keep the first kShared stack entries in shared
// memory: a kernel passes it where it would pass the PackedView.
template <int kShared>
struct SharedStackView {
  PackedView view;
};

template <int kShared>
__device__ __forceinline__ int closest_hit(const SharedStackView<kShared>& s, Vec3 o, Vec3 d,
                                           float t_max, float* t_out) {
  return walk_packed<false, 0, kShared>(s.view, o, d, t_max, t_out);
}

template <int kShared>
__device__ __forceinline__ bool any_hit(const SharedStackView<kShared>& s, Vec3 o, Vec3 d,
                                        float t_max) {
  float t;
  return walk_packed<true, 0, kShared>(s.view, o, d, t_max, &t) >= 0;
}

// The walk of a PackedView, or of a SharedStackView with its shared
// entries, with a stack of kStack entries.
template <bool kAnyHit, int kCount, int kStack>
__device__ __forceinline__ int walk_view(const PackedView& s, Vec3 o, Vec3 d, float t_max,
                                         float* t_out, int* records, int* leaves, int* tests) {
  return walk_packed<kAnyHit, kCount, 0, kStack>(s, o, d, t_max, t_out, records, leaves, tests);
}

template <bool kAnyHit, int kCount, int kStack, int kShared>
__device__ __forceinline__ int walk_view(const SharedStackView<kShared>& s, Vec3 o, Vec3 d,
                                         float t_max, float* t_out, int* records, int* leaves,
                                         int* tests) {
  return walk_packed<kAnyHit, kCount, kShared, kStack>(s.view, o, d, t_max, t_out, records,
                                                       leaves, tests);
}

// A view (PackedView or SharedStackView) whose walks also count the records
// they read and the triangles they test, at counting level 2 (its count of
// leaves is left unread, so the compiler drops it), into the thread's
// running sums *records and *tests: K4's walk counters. The walks are those
// of the view, step for step, with a stack of kStack entries; the tests add
// one increment per triangle test and nothing to a record step.
template <class View, int kStack = kStackDepth>
struct CountedView {
  View view;
  unsigned* records;
  unsigned* tests;
};

template <class View, int kStack>
__device__ __forceinline__ int closest_hit(const CountedView<View, kStack>& s, Vec3 o, Vec3 d,
                                           float t_max, float* t_out) {
  int records, leaves, tests;
  const int tri =
      walk_view<false, 2, kStack>(s.view, o, d, t_max, t_out, &records, &leaves, &tests);
  *s.records += static_cast<unsigned>(records);
  *s.tests += static_cast<unsigned>(tests);
  return tri;
}

template <class View, int kStack>
__device__ __forceinline__ bool any_hit(const CountedView<View, kStack>& s, Vec3 o, Vec3 d,
                                        float t_max) {
  float t;
  int records, leaves, tests;
  const bool hit =
      walk_view<true, 2, kStack>(s.view, o, d, t_max, &t, &records, &leaves, &tests) >= 0;
  *s.records += static_cast<unsigned>(records);
  *s.tests += static_cast<unsigned>(tests);
  return hit;
}

// The view of the C entry points of K1-K5: the root's rows of the SoA
// planes (box, tri_offset, tri_count) and the packed tables.
inline PackedView make_packed(const float* aabb_min, const float* aabb_max,
                              const int* tri_offset, const int* tri_count, const int* nodes2,
                              const float* tri_pos4, int num_tris) {
  return PackedView{reinterpret_cast<const int4*>(nodes2),
                    reinterpret_cast<const float4*>(tri_pos4),
                    aabb_min, aabb_max, tri_offset, tri_count, num_tris};
}

}  // namespace rf
