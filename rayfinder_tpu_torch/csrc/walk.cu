// Closest-hit (K1), counted closest-hit (K6) and any-hit (K2) kernels: one
// thread per ray over (B,) rays, each walking the packed walk tables of
// traverse2.cuh (two-child 64-byte node records, 16-byte triangle rows,
// 16-byte loads).
//
// K1 and K2 replace the TPU kernels pallas_intersect_closest and
// pallas_intersect_any (rayfinder_tpu/ops/pallas_walk.py, via _common_call;
// bodies _make_closest_kernel and _make_any_kernel). Their cluster sweeps
// run inline in the path kernels; these standalone launches answer ray
// queries: the exact golden checks of the traversal, the probes, and any
// caller that only traces rays. K6 replaces counted_closest
// (prof/diag_iters.py: the grouped closest sweep with super-visit and
// inner-iteration counters per 128-lane tile); a per-thread walk has no
// tiles or supers, so it counts per ray the work behind the bench's
// traversal-efficiency figures and every walk kernel's bound.
//
// The walk is traverse2.cuh's walk_packed, shared with the path kernels: t,
// tri and occlusion equal the plane walk's bit for bit (render/traverse.py
// _walk, the plain specification). K1 is walk_packed at counting level 1 and
// also returns the plane walk's node count: a closest walk makes one slab
// test per node the plane walk visits, one for the root and two per record.
// K6 is the same kernel at level 2, which also counts the leaves entered and
// the triangles tested; K1's code is that of level 1 alone.
//
// What bounds it on the card (traverse2.cuh, PERF.md): 262,144 rays load
// 0.4 GB of records and triangles ray by ray through L1 and L2 (bypassing L1
// doubles the time), and the launch's time follows the number of steps a
// warp takes times the instructions of a record step; walk_packed's seek
// and while-while loops and its one-instruction min/max are shaped for
// that, and the first 16 entries of each ray's stack live in shared memory
// so that the stacks do not evict the records from L1. On an NVIDIA H100
// 80GB HBM3 (700.00 W) that reads 0.091 (K1) and 0.084 ms (K2) against 0.141
// and 0.125 ms for the plane walk; 8, 12, 24 and all 32 entries in shared
// memory were 2-7% slower on K1 (8 and 12 2% faster on K2), blocks of 64
// the same and of 256 1-6% faster (the shared stack is laid out for the
// library's one block size), a persistent grid that refills idle lanes
// from a counter 1-6% slower (PERF.md). K6 on
// the plane walk read 0.085 ms on 262,144 coherent primaries.
//
// K1 and K2 come with a stack of 32 entries and, for a tree deeper than
// those hold, of 64 (traverse.cuh kDeepStack): their entry points take the
// scene's stack (render/scene.py walk_stack) and launch that walk. K6 walks
// 32 entries.
//
// Plain C interface, loaded with ctypes (rayfinder_tpu_torch/ops/walk.py,
// rayfinder_tpu_torch/ops/counted.py). Launches on the caller's stream;
// returns cudaGetLastError().

#include "traverse2.cuh"

namespace {

// Stack entries of a ray kept in shared memory (traverse2.cuh).
constexpr int kSharedEntries = 16;

// kCount 1 (K1): counts_out (B,) the nodes the plane walk visits, the root
// and both children of a record. kCount 2 (K6): counts_out (B, 3) those
// nodes, the leaves entered and the triangles tested.
template <int kCount, int kStack>
__global__ void __launch_bounds__(rf::kBlock) closest_kernel(
    rf::PackedView s, const float* __restrict__ origin, const float* __restrict__ direction,
    const float* __restrict__ t_max, int n, float* __restrict__ t_out,
    int* __restrict__ tri_out, int* __restrict__ counts_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float t;
  int records, leaves, tests;
  const int tri = rf::walk_packed<false, kCount, kSharedEntries, kStack>(
      s, rf::load3(origin, i), rf::load3(direction, i), t_max[i], &t, &records, &leaves,
      &tests);
  t_out[i] = t;
  tri_out[i] = tri;
  if (kCount == 1) {
    counts_out[i] = 1 + 2 * records;
  } else {
    counts_out[3 * i] = 1 + 2 * records;
    counts_out[3 * i + 1] = leaves;
    counts_out[3 * i + 2] = tests;
  }
}

template <int kStack>
__global__ void __launch_bounds__(rf::kBlock) any_kernel(
    rf::PackedView s, const float* __restrict__ origin, const float* __restrict__ direction,
    const float* __restrict__ t_max, int n, bool* __restrict__ occ_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float t;
  occ_out[i] = rf::walk_packed<true, 0, kSharedEntries, kStack>(
                   s, rf::load3(origin, i), rf::load3(direction, i), t_max[i], &t) >= 0;
}

}  // namespace

extern "C" int rf_intersect_closest(const float* aabb_min, const float* aabb_max,
                                    const int* tri_offset, const int* tri_count,
                                    const int* nodes2, const float* tri_pos4, int num_tris,
                                    int stack, const float* origin, const float* direction,
                                    const float* t_max, int n, float* t_out, int* tri_out,
                                    int* visits_out, void* stream) {
  const rf::PackedView s =
      rf::make_packed(aabb_min, aabb_max, tri_offset, tri_count, nodes2, tri_pos4, num_tris);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (stack == rf::kDeepStack) {
    closest_kernel<1, rf::kDeepStack><<<rf::grid_for(n), rf::kBlock, 0, st>>>(
        s, origin, direction, t_max, n, t_out, tri_out, visits_out);
  } else {
    closest_kernel<1, rf::kStackDepth><<<rf::grid_for(n), rf::kBlock, 0, st>>>(
        s, origin, direction, t_max, n, t_out, tri_out, visits_out);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rf_intersect_closest_counted(const float* aabb_min, const float* aabb_max,
                                            const int* tri_offset, const int* tri_count,
                                            const int* nodes2, const float* tri_pos4,
                                            int num_tris, const float* origin,
                                            const float* direction, const float* t_max, int n,
                                            float* t_out, int* tri_out, int* counts_out,
                                            void* stream) {
  const rf::PackedView s =
      rf::make_packed(aabb_min, aabb_max, tri_offset, tri_count, nodes2, tri_pos4, num_tris);
  closest_kernel<2, rf::kStackDepth>
      <<<rf::grid_for(n), rf::kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
          s, origin, direction, t_max, n, t_out, tri_out, counts_out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rf_intersect_any(const float* aabb_min, const float* aabb_max,
                                const int* tri_offset, const int* tri_count, const int* nodes2,
                                const float* tri_pos4, int num_tris, int stack,
                                const float* origin, const float* direction, const float* t_max,
                                int n, bool* occ_out, void* stream) {
  const rf::PackedView s =
      rf::make_packed(aabb_min, aabb_max, tri_offset, tri_count, nodes2, tri_pos4, num_tris);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (stack == rf::kDeepStack) {
    any_kernel<rf::kDeepStack><<<rf::grid_for(n), rf::kBlock, 0, st>>>(s, origin, direction,
                                                                       t_max, n, occ_out);
  } else {
    any_kernel<rf::kStackDepth><<<rf::grid_for(n), rf::kBlock, 0, st>>>(s, origin, direction,
                                                                        t_max, n, occ_out);
  }
  return static_cast<int>(cudaGetLastError());
}
