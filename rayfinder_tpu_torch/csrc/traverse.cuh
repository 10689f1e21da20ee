// Per-thread BVH traversal for NVIDIA Hopper (sm_90a): closest hit and
// any hit, as device functions: the plane walk of the counted walk
// (counted.cu) and the sky-round probe (skyround.cu), and the vector, slab
// and triangle arithmetic that every kernel shares.
//
// Replaces the TPU's block-uniform cluster sweeps
// (rayfinder_tpu/ops/pallas_walk.py: _closest_tile_sweep,
// _closest_tile_sweep_grouped, _any_tile_sweep, _any_tile_sweep_grouped).
// A GPU thread has its own control flow, so each ray walks the flattened
// BVH with a 32-entry stack, near child first -- the reference's own
// traversal (src/pt/reference_path_tracer.wgsl:370-429) and exactly the
// algorithm of the plain torch version (rayfinder_tpu_torch/render/
// traverse.py): the same visit order, the same ray_aabb comparisons against
// the best t so far, and the same behaviour when the stack is full (a push
// at depth 32 is dropped, the pointer still moves).
//
// Numerics: every product and sum is rounded on its own, in the order the
// torch version evaluates it. The build passes --fmad=false, so nvcc does
// not contract a*b+c into an FMA (which would change the rounding of
// Moller-Trumbore's det/u/v/t and of the slab test), and no fast-math flag,
// so 1/x and sqrt are IEEE-rounded. t, tri and occlusion are then bit-exact
// against the torch version.
//
// What bounds it on the card: divergent, latency-bound loads of BVH nodes
// and triangles (each step of a thread depends on the previous load; warps
// diverge on traversal order and depth), not arithmetic. The ray queries K1
// and K2 and the path kernels K3, K4 and K5 walk the same tree through
// two-child records and 16-byte loads instead (traverse2.cuh), with the same
// results; K6 and K8 read the planes here. Tensor cores (wgmma) do not apply.

#pragma once

#include <cuda_runtime.h>

namespace rf {

constexpr int kStackDepth = 32;
constexpr float kEpsilon = 1e-5f;

struct SceneView {
  const float* aabb_min;    // (N, 3)
  const float* aabb_max;    // (N, 3)
  const int* tri_offset;    // (N,)
  const int* second_child;  // (N,)
  const int* tri_count;     // (N,) 0 on interior nodes
  const int* split_axis;    // (N,)
  const float* tri_pos;     // (T, 3, 3) leaf order
  int num_tris;
};

struct Vec3 {
  float x, y, z;
};

__device__ __forceinline__ Vec3 load3(const float* p, long long i) {
  return Vec3{p[3 * i], p[3 * i + 1], p[3 * i + 2]};
}

__device__ __forceinline__ void store3(float* p, long long i, Vec3 v) {
  p[3 * i] = v.x;
  p[3 * i + 1] = v.y;
  p[3 * i + 2] = v.z;
}

__device__ __forceinline__ Vec3 sub(Vec3 a, Vec3 b) {
  return Vec3{a.x - b.x, a.y - b.y, a.z - b.z};
}

// ((x + y) + z), left to right.
__device__ __forceinline__ float dot(Vec3 a, Vec3 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}

// jnp.cross order.
__device__ __forceinline__ Vec3 cross(Vec3 a, Vec3 b) {
  return Vec3{a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}

// torch.maximum / torch.minimum: NaN in either operand gives NaN.
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a > b || a != a) ? a : b;
}

__device__ __forceinline__ float min_nan(float a, float b) {
  return (a < b || a != a) ? a : b;
}

__device__ __forceinline__ float component(Vec3 v, int axis) {
  return axis == 0 ? v.x : (axis == 1 ? v.y : v.z);
}

// Slab test (ray_intersection.cpp:101-136, render/intersect.py ray_aabb).
__device__ __forceinline__ bool ray_aabb(const SceneView& s, int node, Vec3 o,
                                         Vec3 inv, float t_max) {
  const Vec3 lo = load3(s.aabb_min, node);
  const Vec3 hi = load3(s.aabb_max, node);
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
  return !fail_xy && !fail_z && (tmin < t_max) && (tmax > 0.0f);
}

// Moller-Trumbore (wgsl:477-521, render/intersect.py ray_triangle) on the
// vertices (9 floats: v0, v1, v2). Returns whether the ray hits below t_max;
// *t_out, *u_out, *v_out are valid where it does.
__device__ __forceinline__ bool moller_trumbore(const float* p, Vec3 o, Vec3 d, float t_max,
                                                float* t_out, float* u_out, float* v_out) {
  const Vec3 v0{p[0], p[1], p[2]};
  const Vec3 v1{p[3], p[4], p[5]};
  const Vec3 v2{p[6], p[7], p[8]};
  const Vec3 e1 = sub(v1, v0);
  const Vec3 e2 = sub(v2, v0);
  const Vec3 h = cross(d, e2);
  const float det = dot(e1, h);
  const float inv_det = 1.0f / det;
  const Vec3 sv = sub(o, v0);
  const float u = inv_det * dot(sv, h);
  const Vec3 q = cross(sv, e1);
  const float v = inv_det * dot(d, q);
  const float t = inv_det * dot(e2, q);
  *t_out = t;
  *u_out = u;
  *v_out = v;
  return fabsf(det) >= kEpsilon && u >= 0.0f && u <= 1.0f && v >= 0.0f &&
         u + v <= 1.0f && t > kEpsilon && t < t_max;
}

__device__ __forceinline__ bool ray_triangle(const SceneView& s, int tri, Vec3 o,
                                             Vec3 d, float t_max, float* t_out) {
  float u, v;
  return moller_trumbore(s.tri_pos + 9ll * tri, o, d, t_max, t_out, &u, &v);
}

// One thread's near-first stack walk. Returns the leaf-order index of the
// accepted triangle (-1 if none); *t_best holds its t (t_max if none).
// kAnyHit stops at the first accepted triangle (shadow rays). kCount also
// counts the leaves entered and the triangles tested (K6, counted.cu); with
// kCount false those counters are compiled out, so K1-K5 keep their code.
template <bool kAnyHit, bool kCount = false>
__device__ int walk(const SceneView& s, Vec3 o, Vec3 d, float t_max, float* t_best_out,
                    int* visits_out, int* leaves_out = nullptr, int* tests_out = nullptr) {
  const Vec3 inv{1.0f / d.x, 1.0f / d.y, 1.0f / d.z};
  float t_best = t_max;
  int hit_tri = -1;
  int visits = 0;
  int leaves = 0;
  int tests = 0;
  int stack[kStackDepth];
  int sp = 0;
  int node = 0;
  while (true) {
    ++visits;
    bool pop = true;
    if (ray_aabb(s, node, o, inv, t_best)) {
      const int count = s.tri_count[node];
      if (count > 0) {
        if (kCount) ++leaves;
        const int first = s.tri_offset[node];
        for (int k = 0; k < count; ++k) {
          const int tri = min(first + k, s.num_tris - 1);
          float t;
          if (kCount) ++tests;
          if (ray_triangle(s, tri, o, d, t_best, &t)) {
            t_best = t;
            hit_tri = tri;
            if (kAnyHit) {
              *t_best_out = t_best;
              if (visits_out) *visits_out = visits;
              if (kCount) {
                *leaves_out = leaves;
                *tests_out = tests;
              }
              return hit_tri;
            }
          }
        }
      } else {
        // Push the far child, descend into the near one (wgsl:408-418).
        const bool axis_neg = component(inv, s.split_axis[node]) < 0.0f;
        const int second = s.second_child[node];
        const int near_child = axis_neg ? second : node + 1;
        const int far_child = axis_neg ? node + 1 : second;
        if (sp < kStackDepth) stack[sp] = far_child;
        ++sp;
        node = near_child;
        pop = false;
      }
    }
    if (pop) {
      if (sp == 0) break;
      --sp;
      node = stack[min(sp, kStackDepth - 1)];
    }
  }
  *t_best_out = t_best;
  if (visits_out) *visits_out = visits;
  if (kCount) {
    *leaves_out = leaves;
    *tests_out = tests;
  }
  return hit_tri;
}

__device__ __forceinline__ int closest_hit(const SceneView& s, Vec3 o, Vec3 d, float t_max,
                                           float* t_out, int* visits_out) {
  return walk<false>(s, o, d, t_max, t_out, visits_out);
}

// closest_hit that also counts the work: nodes visited, leaves entered,
// triangles tested.
__device__ __forceinline__ int closest_hit_counted(const SceneView& s, Vec3 o, Vec3 d,
                                                   float t_max, float* t_out, int* visits_out,
                                                   int* leaves_out, int* tests_out) {
  return walk<false, true>(s, o, d, t_max, t_out, visits_out, leaves_out, tests_out);
}

__device__ __forceinline__ bool any_hit(const SceneView& s, Vec3 o, Vec3 d, float t_max) {
  float t;
  return walk<true>(s, o, d, t_max, &t, nullptr) >= 0;
}

inline SceneView make_scene(const float* aabb_min, const float* aabb_max,
                            const int* tri_offset, const int* second_child,
                            const int* tri_count, const int* split_axis,
                            const float* tri_pos, int num_tris) {
  return SceneView{aabb_min, aabb_max, tri_offset, second_child, tri_count,
                   split_axis, tri_pos, num_tris};
}

constexpr int kBlock = 128;

inline int grid_for(int n) { return (n + kBlock - 1) / kBlock; }

}  // namespace rf
