// Slab-entry reductions (K7): for N rays against M boxes, the per-ray sums
// and minima of the dense slab-entry table, without writing the table.
//
// Replaces the probe of the TPU's prebuilt entry table (prof/
// probe_prebuilt.py run: _slab_entry_rows of rayfinder_tpu/ops/
// pallas_walk.py over S groups of G boxes x a 128-ray tile, per-group
// minima, front-to-back selection). The entry of box m for ray n is
// max(tmin, 0) where the slab test (ray_intersection.cpp:101-136, with
// tmin < bound) accepts, +inf where it fails; NaN comparisons for
// axis-parallel rays as in _slab_entry_rows. Per ray it returns:
//   need[n]             = sum of weight[m] over boxes with entry < bound[n]
//                         (the leaves a front-to-back walk must enter before
//                         its hit, weighted by their triangle counts);
//   group_min[g, n]     = min of the entries of boxes [g*G, (g+1)*G), if
//                         asked for (the TPU probe's per-super `agg`);
//   first_group[n]      = the first group whose minimum is the smallest
//                         one below bound[n], -1 if none (the
//                         front-to-back selection, _next_row, per ray).
//
// What bounds it: operations (about 33 per ray-box pair, no data reuse
// problem: every box is read by every ray). The design is an n-body tile:
// each thread holds one ray in registers; the 128-thread block stages
// chunks of boxes through shared memory (structure of arrays, so the
// broadcast reads are conflict-free) and every thread tests the whole
// chunk. The table itself (M x N floats) never leaves registers.
//
// Numerics: subtractions and products rounded one by one (--fmad=false),
// the same selects and NaN-propagating min/max as the plain torch version
// (ops/slab.py slab_entry_rows), so the reductions agree exactly.
//
// Plain C interface, loaded with ctypes (rayfinder_tpu_torch/ops/slab.py).
// Launches on the caller's stream; returns cudaGetLastError().

#include "traverse.cuh"

namespace {

constexpr int kChunk = 256;  // boxes staged in shared memory per step

__device__ __forceinline__ float inf() { return __int_as_float(0x7f800000); }

__device__ __forceinline__ float slab_entry(float lox, float loy, float loz, float hix,
                                            float hiy, float hiz, rf::Vec3 o, rf::Vec3 inv,
                                            float bound) {
  const float nx = inv.x < 0.0f ? hix : lox, fx = inv.x < 0.0f ? lox : hix;
  const float ny = inv.y < 0.0f ? hiy : loy, fy = inv.y < 0.0f ? loy : hiy;
  const float nz = inv.z < 0.0f ? hiz : loz, fz = inv.z < 0.0f ? loz : hiz;
  const float t0x = (nx - o.x) * inv.x, t1x = (fx - o.x) * inv.x;
  const float t0y = (ny - o.y) * inv.y, t1y = (fy - o.y) * inv.y;
  const float t0z = (nz - o.z) * inv.z, t1z = (fz - o.z) * inv.z;
  const float tmin_xy = rf::max_nan(t0x, t0y);
  const float tmax_xy = rf::min_nan(t1x, t1y);
  const bool fail_xy = (t0x > t1y) || (t0y > t1x);
  const bool fail_z = (tmin_xy > t1z) || (t0z > tmax_xy);
  const float tmin = rf::max_nan(tmin_xy, t0z);
  const float tmax = rf::min_nan(tmax_xy, t1z);
  const bool hit = !fail_xy && !fail_z && (tmin < bound) && (tmax > 0.0f);
  return hit ? rf::max_nan(tmin, 0.0f) : inf();
}

__global__ void slab_entry_kernel(const float* __restrict__ box_min,
                                  const float* __restrict__ box_max,
                                  const int* __restrict__ weight, int m, int group,
                                  const float* __restrict__ origin,
                                  const float* __restrict__ inv_dir,
                                  const float* __restrict__ bound_in, int n,
                                  int* __restrict__ need_out, float* __restrict__ group_min_out,
                                  int* __restrict__ first_out) {
  __shared__ float s_box[6][kChunk];
  __shared__ int s_weight[kChunk];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool valid = i < n;  // threads past n still stage boxes
  const rf::Vec3 o = valid ? rf::load3(origin, i) : rf::Vec3{0.0f, 0.0f, 0.0f};
  const rf::Vec3 inv = valid ? rf::load3(inv_dir, i) : rf::Vec3{1.0f, 1.0f, 1.0f};
  const float bound = valid ? bound_in[i] : 0.0f;
  int need = 0;
  float gmin = inf();
  float best = inf();
  int first = -1;
  int g = 0;
  int left = group;  // boxes left in the current group
  for (int base = 0; base < m; base += kChunk) {
    const int count = min(kChunk, m - base);
    __syncthreads();
    for (int k = threadIdx.x; k < count; k += blockDim.x) {
      const long long b = base + k;
      s_box[0][k] = box_min[3 * b];
      s_box[1][k] = box_min[3 * b + 1];
      s_box[2][k] = box_min[3 * b + 2];
      s_box[3][k] = box_max[3 * b];
      s_box[4][k] = box_max[3 * b + 1];
      s_box[5][k] = box_max[3 * b + 2];
      s_weight[k] = weight[b];
    }
    __syncthreads();
    for (int k = 0; k < count; ++k) {
      const float e = slab_entry(s_box[0][k], s_box[1][k], s_box[2][k], s_box[3][k],
                                 s_box[4][k], s_box[5][k], o, inv, bound);
      if (e < bound) need += s_weight[k];
      gmin = fminf(gmin, e);  // entries are never NaN
      if (--left == 0 || base + k + 1 == m) {
        if (group_min_out != nullptr && valid) group_min_out[(long long)g * n + i] = gmin;
        if (gmin < bound && gmin < best) {
          best = gmin;
          first = g;
        }
        gmin = inf();
        left = group;
        ++g;
      }
    }
  }
  if (valid) {
    need_out[i] = need;
    first_out[i] = first;
  }
}

}  // namespace

extern "C" int rf_slab_entry_reduce(const float* box_min, const float* box_max,
                                    const int* weight, int m, int group, const float* origin,
                                    const float* inv_dir, const float* bound, int n,
                                    int* need_out, float* group_min_out, int* first_out,
                                    void* stream) {
  slab_entry_kernel<<<rf::grid_for(n), rf::kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      box_min, box_max, weight, m, group, origin, inv_dir, bound, n, need_out, group_min_out,
      first_out);
  return static_cast<int>(cudaGetLastError());
}
