// The arithmetic that every kernel's BVH walk and K7 share, for NVIDIA
// Hopper (sm_90a): vectors, the NaN-propagating min/max of torch, the
// Moller-Trumbore triangle test, the stack depth and the launch block.
//
// Replaces the arithmetic of the TPU's block-uniform cluster sweeps
// (rayfinder_tpu/ops/pallas_walk.py: _closest_tile_sweep,
// _closest_tile_sweep_grouped, _any_tile_sweep, _any_tile_sweep_grouped).
// A GPU thread has its own control flow, so each ray walks the flattened
// BVH with a 32-entry stack, near child first -- the reference's own
// traversal (src/pt/reference_path_tracer.wgsl:370-429) and exactly the
// algorithm of the plain torch walk (rayfinder_tpu_torch/render/
// traverse.py _walk): the same visit order, the same slab comparisons
// against the best t so far, and the same behaviour when the stack is full
// (a push at depth 32 is dropped, the pointer still moves). A scene whose
// tree is deeper than that stack holds (render/scene.py: depth 34 to 65)
// is walked by K1, K2 and K4 with a 64-entry stack instead (kDeepStack),
// chosen by their wrappers from the scene, and by no other kernel. Every kernel
// walks it over the packed tables (traverse2.cuh walk_packed); the walk
// over the SoA planes that the kernels ran before lives on only in torch
// (render/traverse.py _walk).
//
// Numerics: every product and sum is rounded on its own, in the order the
// torch version evaluates it. The build passes --fmad=false, so nvcc does
// not contract a*b+c into an FMA (which would change the rounding of
// Moller-Trumbore's det/u/v/t and of the slab test), and no fast-math flag,
// so 1/x and sqrt are IEEE-rounded. t, tri and occlusion are then bit-exact
// against the torch version.

#pragma once

#include <cuda_runtime.h>

namespace rf {

constexpr int kStackDepth = 32;
constexpr int kDeepStack = 64;
constexpr float kEpsilon = 1e-5f;

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

constexpr int kBlock = 128;

inline int grid_for(int n) { return (n + kBlock - 1) / kBlock; }

}  // namespace rf
