// Counted closest-hit walk (K6): K1's walk that also reports, per ray, the
// traversal work it did: nodes visited, leaves entered, triangles tested.
//
// Replaces counted_closest (prof/diag_iters.py: the grouped closest sweep
// with super-visit and inner-iteration counters per 128-lane tile). A
// per-thread stack walk has no tiles or supers, so the work is counted per
// ray: the counters the bench's traversal-efficiency figures need (issued
// triangle tests per warp against the per-ray need of K7, slab_entry.cu) and
// the operation counts behind each walk kernel's bound.
//
// It is walk<false, true> of traverse.cuh: the same visit order and
// comparisons as K1 (walk.cu), so t, tri and the node count equal K1's bit
// for bit, and K1 and K3-K5 keep their own code (walk<..., false> compiles
// the counters out). One thread per ray, 128-thread blocks, lane i in
// thread i (rf::grid_for), so a warp is 32 consecutive rays.
//
// What bounds it: as K1, divergent, latency-bound node and triangle loads;
// the counters add three registers and three stores per ray.
//
// Plain C interface, loaded with ctypes (rayfinder_tpu_torch/ops/counted.py).
// Launches on the caller's stream; returns cudaGetLastError().

#include "traverse.cuh"

namespace {

__global__ void counted_kernel(rf::SceneView s, const float* __restrict__ origin,
                               const float* __restrict__ direction,
                               const float* __restrict__ t_max, int n,
                               float* __restrict__ t_out, int* __restrict__ tri_out,
                               int* __restrict__ counts_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float t;
  int visits, leaves, tests;
  const int tri = rf::closest_hit_counted(s, rf::load3(origin, i), rf::load3(direction, i),
                                          t_max[i], &t, &visits, &leaves, &tests);
  t_out[i] = t;
  tri_out[i] = tri;
  counts_out[3 * i] = visits;
  counts_out[3 * i + 1] = leaves;
  counts_out[3 * i + 2] = tests;
}

}  // namespace

extern "C" int rf_intersect_closest_counted(
    const float* aabb_min, const float* aabb_max, const int* tri_offset,
    const int* second_child, const int* tri_count, const int* split_axis,
    const float* tri_pos, int num_tris, const float* origin, const float* direction,
    const float* t_max, int n, float* t_out, int* tri_out, int* counts_out, void* stream) {
  const rf::SceneView s = rf::make_scene(aabb_min, aabb_max, tri_offset, second_child,
                                         tri_count, split_axis, tri_pos, num_tris);
  counted_kernel<<<rf::grid_for(n), rf::kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      s, origin, direction, t_max, n, t_out, tri_out, counts_out);
  return static_cast<int>(cudaGetLastError());
}
