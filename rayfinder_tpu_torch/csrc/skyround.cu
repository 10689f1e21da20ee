// Sky-round probe (K8): one regen round of the path kernels, split into its
// parts, `rounds` rounds per lane so that each part can be timed.
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
// What it times are the path kernels' own device functions: the packed
// walk (traverse2.cuh walk_packed over bvh_nodes2 / tri_pos4, its stack in
// local memory as in K3 and K5), and noise_of, primary and sky_radiance
// (path.cuh).
//
// What held it back (PERF.md, NVIDIA H100 80GB HBM3): one thread per lane
// ran the lane's rounds one after another over the plane walk's chain of
// scalar loads. 65,536 lanes made 512 blocks of 128: 16 warps on an SM that
// holds 64, for a walk bound by load latency, and the card's fill ended with
// the lanes that took longest.
//
// The design. In full, nosweep and sweeponly a lane's rounds depend on each
// other only through the order in which a0 is summed, so a warp takes a
// lane: thread k computes rounds k, k + 32, ... (its ray, walk and sky),
// and the warp adds each group of 32 rounds' terms in round order by
// shuffles. n lanes make n warps (56 registers a thread: up to 36 of an
// SM's 64 warp slots), each a short piece of work, so the card stays full
// to the end; the rounds of one pixel walk nearly the same ray, so a warp's
// threads stay together. Every round's walk, sky and primary is still
// computed, and the adds keep their order (a0 + t, then ((a0 + r) + g) + b),
// so acc is bit for bit that of one thread looping over the rounds. On an
// NVIDIA H100 80GB HBM3 (700.00 W), "full" on 65,536 lanes x 64 rounds read
// 0.763 ms (Duck probe camera) and 0.428 ms (bench camera) against 1.702 and
// 0.947 ms for one thread per lane over the plane walk and 1.18-1.22 and
// 0.710 ms for one thread per lane over this walk; warps taking 32
// (lane, round) items at a time from a counter, with a scratch and a fold
// kernel, read 0.777 / 0.433 ms; 8 or 16 stack entries in shared memory
// made every form 10-25% slower (PERF.md).
//
// fullwhile keeps one thread per lane and 128-lane blocks: its group is the
// block, its vote __syncthreads_or once per round, so threads past n stay in
// the loop and vote 0 (a return before a barrier is undefined); the TPU
// probe's group is its 1024-lane tile. noop is the loop alone, one thread
// per lane.
//
// Plain C interface, loaded with ctypes (rayfinder_tpu_torch/ops/skyround.py).
// Launches on the caller's stream; returns cudaGetLastError().

#include "path.cuh"

namespace {

enum Mode { kFull = 0, kNoSweep = 1, kSweepOnly = 2, kNoop = 3, kFullWhile = 4 };

constexpr unsigned kFullWarp = 0xffffffffu;
constexpr int kWarp = 32;

__device__ __forceinline__ rf::Pixel pixel(const float* u, const float* v, const float* nb,
                                           int i) {
  return rf::Pixel{u[i], v[i], nb[2 * i], nb[2 * i + 1]};
}

__device__ __forceinline__ void start(const rf::RegenParams& p, const rf::Pixel& px,
                                      int sample, rf::Vec3* o, rf::Vec3* d) {
  float nx, ny;
  rf::noise_of(p, sample, px, &nx, &ny);
  rf::primary(p, px, nx, ny, o, d);
}

// full, nosweep, sweeponly: warp i / 32 takes lane i / 32.
template <int kMode>
__global__ void __launch_bounds__(rf::kBlock) rounds_kernel(rf::PackedView s, rf::RegenParams p,
                                                            int n, int rounds,
                                                            const float* __restrict__ u_in,
                                                            const float* __restrict__ v_in,
                                                            const float* __restrict__ noise_base,
                                                            float* __restrict__ acc_out) {
  const int i = (blockIdx.x * blockDim.x + threadIdx.x) / kWarp;
  const int k = threadIdx.x % kWarp;
  if (i >= n) return;  // the whole warp
  const rf::Pixel px = pixel(u_in, v_in, noise_base, i);
  rf::Vec3 o0{0.0f, 0.0f, 0.0f}, d0{0.0f, 0.0f, 0.0f};
  if (kMode == kSweepOnly) start(p, px, 0, &o0, &d0);
  float a0 = 0.0f;
  for (int base = 0; base < rounds; base += kWarp) {
    float hit_t = 0.0f;
    rf::Vec3 sky{0.0f, 0.0f, 0.0f};
    if (base + k < rounds) {
      rf::Vec3 o = o0, d = d0;
      if (kMode != kSweepOnly) start(p, px, base + k, &o, &d);
      if (kMode != kNoSweep) {
        float t;
        hit_t = rf::closest_hit(s, o, d, p.t_max, &t) >= 0 ? t : 0.0f;
      }
      if (kMode != kSweepOnly) sky = rf::sky_radiance(p, d);
    }
    const int m = min(kWarp, rounds - base);
    for (int j = 0; j < m; ++j) {
      if (kMode != kNoSweep) a0 = a0 + __shfl_sync(kFullWarp, hit_t, j);
      if (kMode != kSweepOnly) {
        a0 = a0 + __shfl_sync(kFullWarp, sky.x, j);
        a0 = a0 + __shfl_sync(kFullWarp, sky.y, j);
        a0 = a0 + __shfl_sync(kFullWarp, sky.z, j);
      }
    }
  }
  if (k == 0) acc_out[i] = a0;
}

__global__ void __launch_bounds__(rf::kBlock) noop_kernel(rf::RegenParams p, int n, int rounds,
                                                          const float* __restrict__ u_in,
                                                          const float* __restrict__ v_in,
                                                          const float* __restrict__ noise_base,
                                                          float* __restrict__ acc_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  rf::Vec3 o, d;
  start(p, pixel(u_in, v_in, noise_base, i), 0, &o, &d);
  float a0 = 0.0f;
  for (int r = 0; r < rounds; ++r) a0 = a0 + d.x;
  acc_out[i] = a0;
}

__global__ void __launch_bounds__(rf::kBlock) fullwhile_kernel(
    rf::PackedView s, rf::RegenParams p, int n, int rounds, const float* __restrict__ u_in,
    const float* __restrict__ v_in, const float* __restrict__ noise_base,
    float* __restrict__ acc_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool valid = i < n;
  const rf::Pixel px = valid ? pixel(u_in, v_in, noise_base, i)
                             : rf::Pixel{0.5f, 0.5f, 0.0f, 0.0f};
  int sample = 0;
  rf::Vec3 o, d;
  start(p, px, sample, &o, &d);
  float a0 = 0.0f;
  int vote = 1;
  while (vote) {
    const bool live = valid && sample < rounds;
    float t = p.t_max;
    int tri = -1;
    if (live) tri = rf::closest_hit(s, o, d, p.t_max, &t);
    a0 = a0 + (tri >= 0 ? t : 0.0f);
    const rf::Vec3 sky = rf::sky_radiance(p, d);
    const bool miss = live && tri < 0;
    a0 = a0 + (miss ? (sky.x + sky.y) + sky.z : 0.0f);
    sample += miss ? 1 : 0;
    const bool regen = miss && sample < rounds;
    if (regen) start(p, px, sample, &o, &d);
    vote = __syncthreads_or(regen);
  }
  if (valid) acc_out[i] = a0;
}

template <int kMode>
void launch_rounds(const rf::PackedView& s, const rf::RegenParams& p, int n, int rounds,
                   const float* u, const float* v, const float* nb, float* acc,
                   cudaStream_t stream) {
  constexpr int kLanesPerBlock = rf::kBlock / kWarp;
  rounds_kernel<kMode><<<(n + kLanesPerBlock - 1) / kLanesPerBlock, rf::kBlock, 0, stream>>>(
      s, p, n, rounds, u, v, nb, acc);
}

}  // namespace

extern "C" int rf_sky_round(const float* aabb_min, const float* aabb_max,
                            const int* tri_offset, const int* tri_count, const int* nodes2,
                            const float* tri_pos4, int num_tris, const rf::RegenParams* params,
                            int n, int rounds, int mode, const float* u, const float* v_tex,
                            const float* noise_base, float* acc_out, void* stream) {
  const rf::PackedView s =
      rf::make_packed(aabb_min, aabb_max, tri_offset, tri_count, nodes2, tri_pos4, num_tris);
  const rf::RegenParams& p = *params;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kFull: launch_rounds<kFull>(s, p, n, rounds, u, v_tex, noise_base, acc_out, st); break;
    case kNoSweep:
      launch_rounds<kNoSweep>(s, p, n, rounds, u, v_tex, noise_base, acc_out, st);
      break;
    case kSweepOnly:
      launch_rounds<kSweepOnly>(s, p, n, rounds, u, v_tex, noise_base, acc_out, st);
      break;
    case kNoop:
      noop_kernel<<<rf::grid_for(n), rf::kBlock, 0, st>>>(p, n, rounds, u, v_tex, noise_base,
                                                           acc_out);
      break;
    case kFullWhile:
      fullwhile_kernel<<<rf::grid_for(n), rf::kBlock, 0, st>>>(s, p, n, rounds, u, v_tex,
                                                                noise_base, acc_out);
      break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
