// Sky-round probe (K8): one regen round of the path kernel K3, split into
// its parts, looped `rounds` times per lane so that each part can be timed.
//
// Replaces the probe kernel of prof/prof_skyround.py (make_kernel, run):
// the TPU probe's rounds over a tile of pure-sky lanes, with modes
//   full      sweep (closest hit) + sky + primary regeneration;
//   nosweep   sky + regeneration;
//   sweeponly the sweep alone, on the lane's first ray every round;
//   noop      the loop alone (a0 += direction.x);
//   fullwhile the production-shaped loop: sweep; on a miss add the sky and
//             regenerate; a finished lane's sweep cannot hit; the loop runs
//             while any lane of the group regenerated this round.
// Each lane accumulates a0: the sweep's t on a hit and the sky's r + g + b,
// in the order of the TPU probe; acc[i] is a0 after the last round.
//
// What it times are K3's own device functions: closest_hit (traverse.cuh)
// and noise_of, primary and sky_radiance (path.cuh). One thread per lane,
// 128-thread blocks, lane i in thread i. fullwhile's group is the block: its
// vote is __syncthreads_or, once per round, so threads past n stay in the
// loop and vote 0 (a return before a barrier is undefined). The TPU probe's
// group is its 1024-lane tile.
//
// What bounds it: the sweep's latency-bound node and triangle loads where a
// lane's ray meets geometry; the sky's transcendental functions (acosf,
// expf, powf) otherwise. No memory traffic besides the lane inputs and acc.
//
// Plain C interface, loaded with ctypes (rayfinder_tpu_torch/ops/skyround.py).
// Launches on the caller's stream; returns cudaGetLastError().

#include "path.cuh"

namespace {

enum Mode { kFull = 0, kNoSweep = 1, kSweepOnly = 2, kNoop = 3, kFullWhile = 4 };

__device__ __forceinline__ void start(const rf::RegenParams& p, const rf::Pixel& px,
                                      int sample, rf::Vec3* o, rf::Vec3* d) {
  float nx, ny;
  rf::noise_of(p, sample, px, &nx, &ny);
  rf::primary(p, px, nx, ny, o, d);
}

template <int kMode>
__global__ void skyround_kernel(rf::SceneView s, rf::RegenParams p, int n, int rounds,
                                const float* __restrict__ u_in,
                                const float* __restrict__ v_in,
                                const float* __restrict__ noise_base,
                                float* __restrict__ acc_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool valid = i < n;
  if (kMode != kFullWhile && !valid) return;
  const rf::Pixel px = valid ? rf::Pixel{u_in[i], v_in[i], noise_base[2 * i],
                                         noise_base[2 * i + 1]}
                             : rf::Pixel{0.5f, 0.5f, 0.0f, 0.0f};
  int sample = 0;
  rf::Vec3 o, d;
  start(p, px, sample, &o, &d);
  float a0 = 0.0f;
  if (kMode == kFullWhile) {
    int vote = 1;
    while (vote) {
      const bool live = valid && sample < rounds;
      float t = p.t_max;
      int tri = -1;
      if (live) tri = rf::closest_hit(s, o, d, p.t_max, &t, nullptr);
      a0 = a0 + (tri >= 0 ? t : 0.0f);
      const rf::Vec3 sky = rf::sky_radiance(p, d);
      const bool miss = live && tri < 0;
      a0 = a0 + (miss ? (sky.x + sky.y) + sky.z : 0.0f);
      sample += miss ? 1 : 0;
      const bool regen = miss && sample < rounds;
      if (regen) start(p, px, sample, &o, &d);
      vote = __syncthreads_or(regen);
    }
  } else {
    for (int r = 0; r < rounds; ++r) {
      if (kMode == kFull || kMode == kSweepOnly) {
        float t;
        const int tri = rf::closest_hit(s, o, d, p.t_max, &t, nullptr);
        a0 = a0 + (tri >= 0 ? t : 0.0f);
      }
      if (kMode == kFull || kMode == kNoSweep) {
        const rf::Vec3 sky = rf::sky_radiance(p, d);
        a0 = a0 + sky.x + sky.y + sky.z;
        ++sample;
        start(p, px, sample, &o, &d);
      } else {
        ++sample;
      }
      if (kMode == kNoop) a0 = a0 + d.x;
    }
  }
  if (valid) acc_out[i] = a0;
}

template <int kMode>
void launch(const rf::SceneView& s, const rf::RegenParams& p, int n, int rounds,
            const float* u, const float* v, const float* nb, float* acc, cudaStream_t stream) {
  skyround_kernel<kMode><<<rf::grid_for(n), rf::kBlock, 0, stream>>>(s, p, n, rounds, u, v,
                                                                      nb, acc);
}

}  // namespace

extern "C" int rf_sky_round(const float* aabb_min, const float* aabb_max,
                            const int* tri_offset, const int* second_child,
                            const int* tri_count, const int* split_axis, const float* tri_pos,
                            int num_tris, const rf::RegenParams* params, int n, int rounds,
                            int mode, const float* u, const float* v_tex,
                            const float* noise_base, float* acc_out, void* stream) {
  const rf::SceneView s = rf::make_scene(aabb_min, aabb_max, tri_offset, second_child,
                                         tri_count, split_axis, tri_pos, num_tris);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kFull: launch<kFull>(s, *params, n, rounds, u, v_tex, noise_base, acc_out, st); break;
    case kNoSweep:
      launch<kNoSweep>(s, *params, n, rounds, u, v_tex, noise_base, acc_out, st);
      break;
    case kSweepOnly:
      launch<kSweepOnly>(s, *params, n, rounds, u, v_tex, noise_base, acc_out, st);
      break;
    case kNoop: launch<kNoop>(s, *params, n, rounds, u, v_tex, noise_base, acc_out, st); break;
    case kFullWhile:
      launch<kFullWhile>(s, *params, n, rounds, u, v_tex, noise_base, acc_out, st);
      break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
