// Persistent path kernel with in-kernel shading (K4): the whole path loop --
// NEE resolve, terminate, trace, sky, shade, scatter, regenerate -- on the
// card, until the live lanes of each 128-lane tile fall to a floor.
//
// Replaces pallas_trace_regen_shaded (rayfinder_tpu/ops/pallas_regen.py;
// body _make_shaded_path_kernel, shade _shade_rows). One round, per lane,
// in the order of the TPU kernel:
//   1. resolve the pending NEE light sample (path.cuh add_nee);
//   2. flag == 2: flush, finish the sample, regenerate;
//   3. trace ONE closest segment; on a miss add the sky, flush, finish the
//      sample and regenerate;
//   4. shade every lane (shade.cuh), hit-masked: a hit prepares its NEE
//      sample and its scatter ray for the next round.
// Both walks of a round read the packed tables (traverse2.cuh): two-child
// 64-byte records and 16-byte triangle rows; the shade reads the attribute
// rows and texels from global memory.
//
// Two kernels share those rounds:
//
// * live_floor > 0, trace_regen_shaded_tile_kernel: one 128-thread block per
//   128-lane tile (the TPU kernel's ray tile), a lane bound to its thread.
//   The rounds repeat while more than live_floor lanes of the tile have
//   samples left; the count is one __syncthreads_count per round, and every
//   thread of the block (those past n included, which vote 0) reaches it.
//   The floor per tile is part of the result: the caller compacts the
//   survivors into the next, narrower batch.
//
// * live_floor == 0, trace_regen_shaded_items_kernel + ..._fold_kernel: no
//   lane is tied to its tile, and a sample's path depends on its pixel and
//   its sample index alone. On the H100 the tile kernel ran the 262,144-lane,
//   16-sample slice with 91% of the lane-rounds of its blocks in use, but
//   with the card full for only the first half of its time: lanes that meet
//   geometry take up to 65 rounds, their tiles end anywhere between 40% and
//   100% of the launch, and one lane alone is half the launch long
//   (PERF.md). So the tail, not the dead lanes, was the loss, and the work
//   item is one (lane, sample), at most num_bounces + 1 rounds long:
//     - a persistent grid (SMs x resident blocks) of warps that never meet
//       at a barrier;
//     - a warp takes its next 32 items from a global counter with one
//       atomicAdd, when all its lanes are done: item j is sample
//       j % num_frames of lane j / num_frames, so the warp starts the
//       samples of one or two pixels together and its lanes stay at the same
//       bounce of neighbouring paths. (Refilling each idle lane at once, or
//       at 8, 16, 24 or 28 idle lanes, kept more lanes busy but mixed fresh
//       primaries with late bounces and was 1-12% slower; taking 32 pixels
//       of one sample was 4% slower.) The item of the lane's input sample
//       continues the input state; a later one starts from a fresh primary;
//       an earlier one is skipped. A warp leaves when the counter has run
//       out;
//     - an item writes its sample's radiance to a (n, num_frames, 3)
//       scratch (row j of item j); the item of the lane's last sample writes the lane's final
//       state, as the tile kernel's last round leaves it;
//     - the fold kernel, one thread per lane, adds the samples' radiance to
//       the lane's in sample order, ((lrad + r_s) + r_s+1) + ..., the order
//       in which the tile kernel flushes them, so lrad is equal bit for bit;
//       a lane with no sample left on entry passes through, with the shade's
//       reset if any lane of its tile was live (the tile then ran a round).
//   Which warp took which items varies from launch to launch; no output
//   does. Seven resident blocks per SM (72 registers, no spills) measured
//   5% faster than the compiler's own 77 registers; eight (64 registers)
//   spill.
//
// Both kernels count the rays they trace, as the split route's loop does:
// one closest segment per closest walk, one NEE shadow ray per surface hit,
// counted at the hit (not where add_nee resolves it, so that a sample whose
// NEE crosses a call boundary is counted once); and the interior records
// that their walks read and the triangles they test, closest and shadow
// (traverse2.cuh CountedView, walk_packed's counting level 2), which tell a
// walk that reads more records from one whose records cost more, and a walk
// whose leaves hold more triangles that it tests from one that reads more
// records. A thread keeps four counters; at its end each warp adds its sums
// to a (4,) int64 tensor with one atomicAdd per counter. Integer sums: any
// order gives the same totals.
//
// What bounds both: the two BVH walks per round, which diverge (lanes of a
// warp are at different nodes of different paths).
//
// Both come with walks of a 32-entry stack and, for a tree deeper than those
// hold, of 64 (traverse.cuh kDeepStack): the entry point takes the scene's
// stack (render/scene.py walk_stack) and launches those kernels.

#include "shade.cuh"

namespace {

static_assert(rf::kBlock == 128, "K4's live floor is counted per 128-lane tile");

constexpr unsigned kFullWarp = 0xffffffffu;

// The lane arrays of the C entry point, in its order.
struct LaneIn {
  const float *u, *v_tex, *noise_base;
  const int *sample, *bounce, *flag;
  const float *origin, *direction, *thr, *srad, *lrad, *shadow_o, *shadow_d, *contrib;
};

struct LaneOut {
  int *sample, *bounce, *flag;
  float *origin, *direction, *thr, *srad, *lrad, *shadow_o, *shadow_d, *contrib;
};

// A lane's path state between two rounds (lrad apart).
struct PathState {
  int bounce, flag;
  rf::Vec3 o, d, thr, srad, shadow_o, shadow_d, contrib;
};

__device__ __forceinline__ rf::Pixel load_pixel(const LaneIn& in, int i) {
  return rf::Pixel{in.u[i], in.v_tex[i], in.noise_base[2 * i], in.noise_base[2 * i + 1]};
}

__device__ __forceinline__ PathState load_state(const LaneIn& in, int i) {
  return PathState{in.bounce[i],
                   in.flag[i],
                   rf::load3(in.origin, i),
                   rf::load3(in.direction, i),
                   rf::load3(in.thr, i),
                   rf::load3(in.srad, i),
                   rf::load3(in.shadow_o, i),
                   rf::load3(in.shadow_d, i),
                   rf::load3(in.contrib, i)};
}

// Every output of lane i but lrad.
__device__ __forceinline__ void store_state(const LaneOut& out, int i, int sample,
                                            const PathState& st) {
  out.sample[i] = sample;
  out.bounce[i] = st.bounce;
  out.flag[i] = st.flag;
  rf::store3(out.origin, i, st.o);
  rf::store3(out.direction, i, st.d);
  rf::store3(out.thr, i, st.thr);
  rf::store3(out.srad, i, st.srad);
  rf::store3(out.shadow_o, i, st.shadow_o);
  rf::store3(out.shadow_d, i, st.shadow_d);
  rf::store3(out.contrib, i, st.contrib);
}

// The shade of a lane that is not at a hit: flag 0, the NEE sample reset,
// shadow_d the light direction of `sample`.
__device__ __forceinline__ void shade_no_hit(const rf::ShadeView& sh, const rf::RegenParams& p,
                                             const rf::Pixel& px, int sample, PathState* st) {
  rf::shade(sh, p, px, false, -1, sample, &st->o, &st->d, &st->thr, &st->bounce, &st->flag,
            &st->shadow_o, &st->shadow_d, &st->contrib);
}

// Add a warp's counts to ray_counts = [closest, shadow, records, tests].
// Every thread of the warp calls it. A thread's records and tests stay below
// 2^32 (a few hundred a ray); the warp's sums are taken in 64 bits.
__device__ __forceinline__ unsigned long long warp_sum64(unsigned x) {
  unsigned long long sum = x;
  for (int lane = 16; lane > 0; lane >>= 1) sum += __shfl_down_sync(kFullWarp, sum, lane);
  return sum;
}

__device__ __forceinline__ void add_ray_counts(unsigned closest, unsigned shadow,
                                               unsigned records, unsigned tests,
                                               unsigned long long* ray_counts) {
  closest = __reduce_add_sync(kFullWarp, closest);
  shadow = __reduce_add_sync(kFullWarp, shadow);
  const unsigned long long rec = warp_sum64(records);
  const unsigned long long tri = warp_sum64(tests);
  if ((threadIdx.x & 31) == 0) {
    atomicAdd(ray_counts, static_cast<unsigned long long>(closest));
    atomicAdd(ray_counts + 1, static_cast<unsigned long long>(shadow));
    atomicAdd(ray_counts + 2, rec);
    atomicAdd(ray_counts + 3, tri);
  }
}

template <int kStack>
__global__ void __launch_bounds__(rf::kBlock) trace_regen_shaded_tile_kernel(
    rf::PackedView view, rf::ShadeView sh, rf::RegenParams p, int n, LaneIn in, LaneOut out,
    unsigned long long* __restrict__ ray_counts) {
  unsigned records = 0, tests = 0;  // records read, triangles tested by this thread's walks
  const rf::CountedView<rf::PackedView, kStack> s{view, &records, &tests};
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool lane = i < n;
  const int nf = p.num_frames;
  // A thread past n holds a dead lane: it never traces and reads nothing.
  int sample = nf;
  PathState st{1,
               0,
               {0.0f, 0.0f, 0.0f},
               {1.0f, 0.0f, 0.0f},
               {0.0f, 0.0f, 0.0f},
               {0.0f, 0.0f, 0.0f},
               {rf::kPark, rf::kPark, rf::kPark},
               {1.0f, 0.0f, 0.0f},
               {0.0f, 0.0f, 0.0f}};
  rf::Vec3 lrad{0.0f, 0.0f, 0.0f};
  rf::Pixel px{0.5f, 0.5f, 0.0f, 0.0f};
  unsigned closest = 0, shadow = 0;  // rays traced by this thread
  if (lane) {
    sample = min(in.sample[i], nf);
    st = load_state(in, i);
    lrad = rf::load3(in.lrad, i);
    px = load_pixel(in, i);
  }

  while (__syncthreads_count(sample < nf) > p.live_floor) {
    // 1. Pending NEE light sample of the previous segment.
    const bool live = sample < nf;
    if (live && st.flag > 0) {
      st.srad = rf::add_nee(s, p.t_max, st.srad, st.contrib, st.shadow_o, st.shadow_d);
    }

    // 2. Terminate after NEE: flush, finish the sample, regenerate.
    if (live && st.flag == 2) {
      rf::flush(&lrad, &st.srad);
      ++sample;
      rf::regenerate(p, px, sample, &st.o, &st.d, &st.thr, &st.bounce);
    }

    // 3. One closest segment; a miss folds the sky and starts the next sample.
    int tri = -1;
    if (sample < nf) {
      float t;
      tri = rf::closest_hit(s, st.o, st.d, p.t_max, &t);
      ++closest;
      if (tri < 0) {
        rf::fold_sky(rf::sky_radiance(p, st.d), st.thr, &st.srad, &lrad);
        ++sample;
        rf::regenerate(p, px, sample, &st.o, &st.d, &st.thr, &st.bounce);
      } else {
        ++shadow;
      }
    }

    // 4. Shade (hit lanes prepare NEE + scatter; the rest reset the NEE).
    rf::shade(sh, p, px, tri >= 0, tri, sample, &st.o, &st.d, &st.thr, &st.bounce, &st.flag,
              &st.shadow_o, &st.shadow_d, &st.contrib);
  }

  if (lane) {
    store_state(out, i, sample, st);
    rf::store3(out.lrad, i, lrad);
  }
  add_ray_counts(closest, shadow, records, tests, ray_counts);
}

// Resident blocks per SM that the items kernel is compiled for.
constexpr int kItemBlocksPerSm = 7;
// Stack entries of an item's walks kept in shared memory (traverse2.cuh):
// on an NVIDIA H100 80GB HBM3 (700.00 W) 12 measured 1.12x faster than the
// local stack at the 262,144-lane, 16-sample shape (8 and 16 the same, 24
// 1.06x, all 32 no gain), while the tile kernel lost 12-25% with any.
constexpr int kItemSharedEntries = 12;

template <int kStack>
__global__ void __launch_bounds__(rf::kBlock, kItemBlocksPerSm) trace_regen_shaded_items_kernel(
    rf::PackedView view, rf::ShadeView sh, rf::RegenParams p, int n, LaneIn in, LaneOut out,
    float* __restrict__ rad, unsigned long long* __restrict__ counter,
    unsigned long long* __restrict__ ray_counts) {
  unsigned records = 0, tests = 0;  // records read, triangles tested by this thread's walks
  const rf::CountedView<rf::SharedStackView<kItemSharedEntries>, kStack> s{
      {view}, &records, &tests};
  const int warp_lane = threadIdx.x & 31;
  const int nf = p.num_frames;
  const unsigned long long total = static_cast<unsigned long long>(n) * nf;
  bool active = false;  // this thread holds an item
  int i = 0, sample = 0;
  PathState st{};
  rf::Pixel px{};
  unsigned closest = 0, shadow = 0;  // rays traced by this thread's items

  while (true) {
    // The warp takes its next 32 items together.
    unsigned long long base = 0;
    if (warp_lane == 0) base = atomicAdd(counter, 32ull);
    base = __shfl_sync(kFullWarp, base, 0);
    if (base >= total) break;
    const unsigned long long j = base + warp_lane;
    if (j < total) {
      const int item_lane = static_cast<int>(j / static_cast<unsigned>(nf));
      const int item_sample = static_cast<int>(j - static_cast<unsigned long long>(item_lane) * nf);
      const int first = min(in.sample[item_lane], nf);
      if (item_sample >= first) {  // else: a sample done before this call
        i = item_lane;
        sample = item_sample;
        px = load_pixel(in, i);
        if (sample == first) {
          st = load_state(in, i);  // the lane's sample in flight
        } else {
          st.flag = 0;
          st.srad = rf::Vec3{0.0f, 0.0f, 0.0f};
          st.contrib = rf::Vec3{0.0f, 0.0f, 0.0f};
          rf::regenerate(p, px, sample, &st.o, &st.d, &st.thr, &st.bounce);
        }
        active = true;
      }
    }

    // Rounds until every item of the warp has ended.
    while (__any_sync(kFullWarp, active)) {
      if (active) {
        // 1. Pending NEE light sample of the previous segment.
        if (st.flag > 0) {
          st.srad = rf::add_nee(s, p.t_max, st.srad, st.contrib, st.shadow_o, st.shadow_d);
        }
        // 2. Terminate after NEE, or 3. one closest segment: a miss adds the
        // sky and ends the sample, a hit is shaded (4).
        bool done = st.flag == 2;
        if (!done) {
          float t;
          const int tri = rf::closest_hit(s, st.o, st.d, p.t_max, &t);
          ++closest;
          if (tri < 0) {
            st.srad = rf::add(st.srad, rf::mul(st.thr, rf::sky_radiance(p, st.d)));
            done = true;
          } else {
            ++shadow;
            rf::shade(sh, p, px, true, tri, sample, &st.o, &st.d, &st.thr, &st.bounce,
                      &st.flag, &st.shadow_o, &st.shadow_d, &st.contrib);
          }
        }
        if (done) {
          rf::store3(rad, static_cast<long long>(i) * nf + sample, st.srad);
          if (sample == nf - 1) {
            // The lane's last sample: its final state, as the last round of
            // the tile kernel leaves it (flushed, then shaded as not a hit).
            st.srad = rf::Vec3{0.0f, 0.0f, 0.0f};
            shade_no_hit(sh, p, px, nf, &st);
            store_state(out, i, nf, st);
          }
          active = false;
        }
      }
      __syncwarp();
    }
  }
  // The counter ran out for the whole warp at once: its threads leave together.
  add_ray_counts(closest, shadow, records, tests, ray_counts);
}

__global__ void __launch_bounds__(rf::kBlock) trace_regen_shaded_fold_kernel(
    rf::ShadeView sh, rf::RegenParams p, int n, LaneIn in, LaneOut out,
    const float* __restrict__ rad) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int nf = p.num_frames;
  // Whether any lane of this 128-lane tile had samples left on entry.
  bool tile_live = false;
  for (int w = 0; w < rf::kBlock / 32; ++w) {
    const int k = blockIdx.x * blockDim.x + 32 * w + (threadIdx.x & 31);
    tile_live |= __any_sync(kFullWarp, k < n && in.sample[k] < nf);
  }
  if (i >= n) return;
  const int first = min(in.sample[i], nf);
  rf::Vec3 lrad = rf::load3(in.lrad, i);
  for (int sample = first; sample < nf; ++sample) {
    lrad = rf::add(lrad, rf::load3(rad, static_cast<long long>(i) * nf + sample));
  }
  rf::store3(out.lrad, i, lrad);
  if (first >= nf) {
    PathState st = load_state(in, i);
    if (tile_live) shade_no_hit(sh, p, load_pixel(in, i), nf, &st);
    store_state(out, i, nf, st);
  }
}

// The launches of one call, with walks of kStack entries.
template <int kStack>
int launch(const rf::PackedView& s, const rf::ShadeView& sh, const rf::RegenParams& params,
           int n, const LaneIn& in, const LaneOut& out, float* sample_rad,
           unsigned long long* item_counter, unsigned long long* ray_counts,
           cudaStream_t stream) {
  if (params.live_floor > 0) {
    trace_regen_shaded_tile_kernel<kStack><<<rf::grid_for(n), rf::kBlock, 0, stream>>>(
        s, sh, params, n, in, out, ray_counts);
    return static_cast<int>(cudaGetLastError());
  }
  // Floor 0: a persistent grid that fills the card, no wider than the items.
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, trace_regen_shaded_items_kernel<kStack>, rf::kBlock, 0);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long items = static_cast<long long>(n) * params.num_frames;
  const long long wanted = (items + rf::kBlock - 1) / rf::kBlock;
  const long long resident = static_cast<long long>(sms) * per_sm;
  const int grid = static_cast<int>(wanted < resident ? (wanted > 0 ? wanted : 1) : resident);
  trace_regen_shaded_items_kernel<kStack><<<grid, rf::kBlock, 0, stream>>>(
      s, sh, params, n, in, out, sample_rad, item_counter, ray_counts);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  trace_regen_shaded_fold_kernel<<<rf::grid_for(n), rf::kBlock, 0, stream>>>(sh, params, n, in,
                                                                            out, sample_rad);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int rf_trace_regen_shaded(
    const float* aabb_min, const float* aabb_max, const int* tri_offset, const int* tri_count,
    const int* nodes2, const float* tri_pos4, int num_tris, int stack, const float* attrs,
    const int* tex_desc, const int* texels, const rf::RegenParams* params, int n, const float* u,
    const float* v_tex, const float* noise_base, const int* sample, const int* bounce,
    const int* flag, const float* origin, const float* direction, const float* thr,
    const float* srad, const float* lrad, const float* shadow_o, const float* shadow_d,
    const float* contrib, int* sample_out, int* bounce_out, int* flag_out, float* origin_out,
    float* direction_out, float* thr_out, float* srad_out, float* lrad_out,
    float* shadow_o_out, float* shadow_d_out, float* contrib_out, float* sample_rad,
    unsigned long long* item_counter, unsigned long long* ray_counts, void* stream_ptr) {
  const rf::PackedView s = rf::make_packed(aabb_min, aabb_max, tri_offset, tri_count, nodes2,
                                           tri_pos4, num_tris);
  const rf::ShadeView sh{attrs, tex_desc, texels};
  const LaneIn in{u,      v_tex,     noise_base, sample, bounce,   flag,     origin,
                  direction, thr,    srad,       lrad,   shadow_o, shadow_d, contrib};
  const LaneOut out{sample_out, bounce_out, flag_out, origin_out,   direction_out, thr_out,
                    srad_out,   lrad_out,   shadow_o_out, shadow_d_out, contrib_out};
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (stack == rf::kDeepStack) {
    return launch<rf::kDeepStack>(s, sh, *params, n, in, out, sample_rad, item_counter,
                                  ray_counts, stream);
  }
  return launch<rf::kStackDepth>(s, sh, *params, n, in, out, sample_rad, item_counter,
                                 ray_counts, stream);
}
