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
// What bounds it: operations. Every ray meets every box, the table (M x N
// floats) never leaves registers, and the inputs are read once; the time is
// the instructions executed per ray-box pair, and of those the ones that the
// H100 runs at half rate: compares, minima, maxima, selects and logic (64
// lanes a clock per SM against 128 for add and multiply). A pair costs 12
// adds and multiplies and 19 such half-rate instructions (6 near/far
// selects, 5 NaN-propagating min/max, 6 compares, a predicate and, and the
// running minimum), about 38 clocks of a sub-partition; the kernel measures
// about 42 (PERF.md). The design is an n-body tile around that inner loop:
//   * a box is two 16-byte words in shared memory (min xyz + max x; max yz +
//     weight), read with two 16-byte broadcast loads;
//   * each thread holds kRays rays in registers, so one pair of loads feeds
//     kRays slab tests, and the tests of different rays are independent
//     instructions to overlap; a block covers kRays * 128 rays, ray r of
//     thread t being block * kRays * 128 + r * 128 + t (coalesced), the
//     ragged edge masked;
//   * groups outside, boxes inside: the inner loop runs to the end of the
//     group or of the staged chunk, whichever comes first, and holds only the
//     slab test, the need sum and the running minimum; the group's store and
//     the front-to-back selection happen once per group, also where a group
//     straddles two chunks;
//   * chunks of kChunk boxes are staged with cp.async into one of two
//     buffers while the tests run on the other: one barrier per chunk;
//   * a NaN-propagating minimum or maximum is one instruction
//     (min.NaN.f32 / max.NaN.f32), not two compares and a select; the
//     near/far choice on the ray's sign is one logic instruction on a mask
//     (kRays rays have more signs than a thread has predicates);
//   * the need sum and the minimum are predicated on the test, and the
//     entry-below-bound compare of `need` is replaced by its equivalent,
//     a positive bound, applied once per ray after the loop.
// Four rays a thread and eight boxes unrolled measured fastest (2, 3, 5, 6
// and 8 rays, and 1 to 4 boxes, were 3-30% slower). Replacing the four
// pairwise compares by tmin > tmax was 8% faster but differs from the plain
// version on a box with min > max, so it is not used.
//
// Numerics: subtractions and products rounded one by one (--fmad=false),
// the same selects and NaN-propagating min/max as the plain torch version
// (ops/slab.py slab_entry_rows), so the reductions agree exactly. The slab
// arithmetic is this file's own copy (traverse2.cuh keeps its code). Of two
// zeros of different sign, max.NaN returns +0 where the plain version may
// return -0: the two compare equal, and no comparison downstream tells them
// apart.
//
// Plain C interface, loaded with ctypes (rayfinder_tpu_torch/ops/slab.py).
// Launches on the caller's stream; returns cudaGetLastError().

#include <math_constants.h>

#include "traverse.cuh"

namespace {

constexpr int kChunk = 256;  // boxes staged in shared memory per step
constexpr int kRays = 4;     // rays per thread
constexpr int kTile = kRays * rf::kBlock;  // rays per block

__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ void copy_async4(float* shared_dst, const void* global_src) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(shared_dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(dst), "l"(global_src)
               : "memory");
}

// Start the copy of boxes [base, base + count) into `buffer`, box k as eight
// floats: min xyz, max xyz, the weight's bits, one unused.
__device__ __forceinline__ void stage(float* buffer, const float* __restrict__ box_min,
                                      const float* __restrict__ box_max,
                                      const int* __restrict__ weight, int base, int count) {
  const float* lo = box_min + 3ll * base;
  const float* hi = box_max + 3ll * base;
  for (int j = threadIdx.x; j < 3 * count; j += blockDim.x) {
    const int k = j / 3, c = j - 3 * k;
    copy_async4(buffer + 8 * k + c, lo + j);
    copy_async4(buffer + 8 * k + 3 + c, hi + j);
  }
  for (int k = threadIdx.x; k < count; k += blockDim.x) {
    copy_async4(buffer + 8 * k + 6, weight + base + k);
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// A ray in registers. sx, sy, sz are all ones where the inverse direction's
// component is negative, else 0: kRays rays have more signs than a thread has
// predicate registers, so the near/far choice is a bitwise select on a mask.
struct Ray {
  float ox, oy, oz, ix, iy, iz, bound;
  int sx, sy, sz;
};

// mask ? a : b, bit for bit, as one three-input logic instruction (written
// in PTX so that the compiler does not turn it back into a compare of the
// sign and a select on its predicate).
__device__ __forceinline__ float select(int mask, float a, float b) {
  int r;
  asm("lop3.b32 %0, %1, %2, %3, 0xE4;"
      : "=r"(r)
      : "r"(__float_as_int(a)), "r"(__float_as_int(b)), "r"(mask));
  return __int_as_float(r);
}

// The slab test of ops/slab.py slab_entry, operation for operation, on the
// box (a: min xyz, max x; b: max yz). Returns whether the ray enters the box
// before its bound; *tmin_out is then its entry distance before the clamp
// at 0 (never NaN where the test accepts).
__device__ __forceinline__ bool slab_test(float4 a, float4 b, const Ray& r, float* tmin_out) {
  const float nx = select(r.sx, a.w, a.x), fx = select(r.sx, a.x, a.w);
  const float ny = select(r.sy, b.x, a.y), fy = select(r.sy, a.y, b.x);
  const float nz = select(r.sz, b.y, a.z), fz = select(r.sz, a.z, b.y);
  const float t0x = (nx - r.ox) * r.ix, t1x = (fx - r.ox) * r.ix;
  const float t0y = (ny - r.oy) * r.iy, t1y = (fy - r.oy) * r.iy;
  const float t0z = (nz - r.oz) * r.iz, t1z = (fz - r.oz) * r.iz;
  const float tmin_xy = max_nan(t0x, t0y);
  const float tmax_xy = min_nan(t1x, t1y);
  const bool fail_xy = (t0x > t1y) || (t0y > t1x);
  const bool fail_z = (tmin_xy > t1z) || (t0z > tmax_xy);
  const float tmin = max_nan(tmin_xy, t0z);
  const float tmax = min_nan(tmax_xy, t1z);
  *tmin_out = tmin;
  return !fail_xy && !fail_z && (tmin < r.bound) && (tmax > 0.0f);
}

__global__ void __launch_bounds__(rf::kBlock) slab_entry_kernel(
    const float* __restrict__ box_min, const float* __restrict__ box_max,
    const int* __restrict__ weight, int m, int group, const float* __restrict__ origin,
    const float* __restrict__ inv_dir, const float* __restrict__ bound_in, int n,
    int* __restrict__ need_out, float* __restrict__ group_min_out, int* __restrict__ first_out) {
  __shared__ float4 s_box[2][2 * kChunk];
  // Rays past n are tested like the others and never stored.
  Ray ray[kRays];
  int need[kRays], first[kRays];
  float gmin[kRays], best[kRays];
#pragma unroll
  for (int r = 0; r < kRays; ++r) {
    const long long i = static_cast<long long>(blockIdx.x) * kTile + r * rf::kBlock + threadIdx.x;
    const bool valid = i < n;
    const rf::Vec3 o = valid ? rf::load3(origin, i) : rf::Vec3{0.0f, 0.0f, 0.0f};
    const rf::Vec3 inv = valid ? rf::load3(inv_dir, i) : rf::Vec3{1.0f, 1.0f, 1.0f};
    ray[r] = Ray{o.x,   o.y,   o.z, inv.x, inv.y, inv.z, valid ? bound_in[i] : 0.0f,
                 inv.x < 0.0f ? -1 : 0, inv.y < 0.0f ? -1 : 0, inv.z < 0.0f ? -1 : 0};
    need[r] = 0;
    first[r] = -1;
    gmin[r] = CUDART_INF_F;
    best[r] = CUDART_INF_F;
  }

  int g = 0;         // the current group
  int left = group;  // boxes left in it
  const int chunks = (m + kChunk - 1) / kChunk;
  if (chunks > 0) {
    stage(reinterpret_cast<float*>(s_box[0]), box_min, box_max, weight, 0, min(kChunk, m));
  }
  for (int c = 0; c < chunks; ++c) {
    const int base = c * kChunk;
    const int count = min(kChunk, m - base);
    // This thread's copies of chunk c have landed; after the barrier so have
    // everyone's, and everyone is done with the other buffer (chunk c - 1).
    asm volatile("cp.async.wait_all;" ::: "memory");
    __syncthreads();
    if (c + 1 < chunks) {
      stage(reinterpret_cast<float*>(s_box[(c + 1) & 1]), box_min, box_max, weight,
            base + kChunk, min(kChunk, m - base - kChunk));
    }
    const float4* box = s_box[c & 1];
    int k = 0;
    while (k < count) {
      const int stop = k + min(count - k, left);
      left -= stop - k;
#pragma unroll 8
      for (; k < stop; ++k) {
        const float4 a = box[2 * k], b = box[2 * k + 1];
        const int w = __float_as_int(b.z);
#pragma unroll
        for (int r = 0; r < kRays; ++r) {
          // The entry is max(tmin, 0) where the test accepts, else +inf,
          // which changes neither sum nor minimum. An accepted entry lies
          // below the bound iff the bound is positive (tmin < bound holds):
          // that factor of `need` is applied once, after the loop.
          float tmin;
          if (slab_test(a, b, ray[r], &tmin)) {
            need[r] += w;
            gmin[r] = fminf(gmin[r], max_nan(tmin, 0.0f));
          }
        }
      }
      if (left == 0 || base + k == m) {
        // The group is complete: its minimum, and the front-to-back choice.
#pragma unroll
        for (int r = 0; r < kRays; ++r) {
          const long long i =
              static_cast<long long>(blockIdx.x) * kTile + r * rf::kBlock + threadIdx.x;
          if (group_min_out != nullptr && i < n) {
            group_min_out[static_cast<long long>(g) * n + i] = gmin[r];
          }
          if (gmin[r] < ray[r].bound && gmin[r] < best[r]) {
            best[r] = gmin[r];
            first[r] = g;
          }
          gmin[r] = CUDART_INF_F;
        }
        left = group;
        ++g;
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRays; ++r) {
    const long long i = static_cast<long long>(blockIdx.x) * kTile + r * rf::kBlock + threadIdx.x;
    if (i < n) {
      need_out[i] = ray[r].bound > 0.0f ? need[r] : 0;
      first_out[i] = first[r];
    }
  }
}

}  // namespace

extern "C" int rf_slab_entry_reduce(const float* box_min, const float* box_max,
                                    const int* weight, int m, int group, const float* origin,
                                    const float* inv_dir, const float* bound, int n,
                                    int* need_out, float* group_min_out, int* first_out,
                                    void* stream) {
  const int grid = (n + kTile - 1) / kTile;
  slab_entry_kernel<<<grid, rf::kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      box_min, box_max, weight, m, group, origin, inv_dir, bound, n, need_out, group_min_out,
      first_out);
  return static_cast<int>(cudaGetLastError());
}
