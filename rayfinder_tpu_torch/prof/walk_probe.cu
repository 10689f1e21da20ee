// Probe kernels of the ray queries K1 and K2 (prof/walk_probe.py): forms of
// the packed walk chosen by macros at build time, to be timed in turns with
// the shipped kernels, and an instrumented closest walk that counts its
// steps. Every form keeps each ray's own order of records, pushes, pops and
// triangle tests, so t, tri, the node count and occlusion must equal the
// shipped kernels' bit for bit; the probe checks that before it times.
//
//   RF_LOOP       0: one loop that takes one step (record, leaf or pop) per
//                    trip; 1: while-while (records and pops until the lane
//                    holds a leaf, then the leaf tests); 2: one loop with
//                    the seek (pop until an entry to take, then record or
//                    leaf); 3: seek and while-while (walk_packed's form)
//   RF_PTX_MINMAX 1: min.NaN / max.NaN in PTX (traverse2.cuh's slab_key);
//                 0: two compares and a select each (traverse.cuh's)
//   RF_LOP3       1: the near/far selects as lop3 on sign masks
//   RF_STACK16    1: 16-byte stack entries
//   RF_SMEM       the first RF_SMEM entries of the stack in shared memory (0:
//                    none, 32: all of it), the rest in local memory
//   RF_LDHINT     0: __ldg; 1: ld.global.cg (L2 only); 2: ld.global.ca
//   RF_PERSIST    1: a grid that fills the card, whose warps take rays from
//                    a counter; RF_REFILL_AT: idle lanes are refilled when
//                    fewer than this many lanes of the warp are alive
//   RF_BLOCK      threads per block; RF_MIN_BLOCKS: launch bound (0: none)
//   RF_PLANE      1: the plane walk of traverse.cuh instead (one thread per
//                    ray, as K6 and K8 walk)
//
// rf_probe_steps is the instrumented closest walk: one step per
// warp-synchronous trip, counting per lane its record, leaf and pop steps,
// per warp its trips and how many held leaf lanes, record lanes, both, and
// pop lanes, and per block its start and end on %globaltimer.
//
// Built by the probe with the library's flags and -I csrc; not part of the
// kernel library.

#include "traverse2.cuh"

#ifndef RF_LOOP
#define RF_LOOP 3
#endif
#ifndef RF_PTX_MINMAX
#define RF_PTX_MINMAX 1
#endif
#ifndef RF_LOP3
#define RF_LOP3 0
#endif
#ifndef RF_STACK16
#define RF_STACK16 0
#endif
#ifndef RF_SMEM
#define RF_SMEM 0
#endif
#ifndef RF_LDHINT
#define RF_LDHINT 0
#endif
#ifndef RF_PERSIST
#define RF_PERSIST 0
#endif
#ifndef RF_REFILL_AT
#define RF_REFILL_AT 1
#endif
#ifndef RF_BLOCK
#define RF_BLOCK 128
#endif
#ifndef RF_MIN_BLOCKS
#define RF_MIN_BLOCKS 0
#endif
#ifndef RF_PLANE
#define RF_PLANE 0
#endif

namespace {

constexpr unsigned kFullWarp = 0xffffffffu;

#if RF_MIN_BLOCKS
#define RF_BOUNDS __launch_bounds__(RF_BLOCK, RF_MIN_BLOCKS)
#else
#define RF_BOUNDS __launch_bounds__(RF_BLOCK)
#endif

#if RF_LDHINT == 1
#define RF_LD(p) __ldcg(p)
#elif RF_LDHINT == 2
#define RF_LD(p) __ldca(p)
#else
#define RF_LD(p) __ldg(p)
#endif

#if RF_STACK16
struct __align__(16) Entry {
  int ref, count;
  float key;
  int pad;
};
#else
typedef rf::StackEntry Entry;
#endif

// RF_STACK(k): entry k of this thread's stack, an lvalue.
#if RF_SMEM >= 32
#define RF_STACK_DECL __shared__ Entry stack_shared[rf::kStackDepth * RF_BLOCK];
#define RF_STACK(k) stack_shared[(k) * RF_BLOCK + threadIdx.x]
#elif RF_SMEM
#define RF_STACK_DECL                                   \
  __shared__ Entry stack_shared[RF_SMEM * RF_BLOCK];    \
  Entry stack_local[rf::kStackDepth - RF_SMEM];
#define RF_STACK(k) \
  (*((k) < RF_SMEM ? &stack_shared[(k) * RF_BLOCK + threadIdx.x] : &stack_local[(k) - RF_SMEM]))
#else
#define RF_STACK_DECL Entry stack_local[rf::kStackDepth];
#define RF_STACK(k) stack_local[k]
#endif

// mask ? a : b as one logic instruction.
__device__ __forceinline__ float select(int mask, float a, float b) {
  int r;
  asm("lop3.b32 %0, %1, %2, %3, 0xE4;"
      : "=r"(r)
      : "r"(__float_as_int(a)), "r"(__float_as_int(b)), "r"(mask));
  return __int_as_float(r);
}

// One ray's walk state.
struct Walk {
  rf::Vec3 o, d, inv;
  float t_best;
  int hit_tri, records, sp, ref, count;
  int sx, sy, sz;  // all ones where the inverse direction is negative
  bool take;
};

// rf::slab_key, with the min/max and the selects the macros choose.
__device__ __forceinline__ float key_of(rf::Vec3 lo, rf::Vec3 hi, const Walk& w) {
  const rf::Vec3 o = w.o, inv = w.inv;
#if RF_LOP3
  const float nx = select(w.sx, hi.x, lo.x), fx = select(w.sx, lo.x, hi.x);
  const float ny = select(w.sy, hi.y, lo.y), fy = select(w.sy, lo.y, hi.y);
  const float nz = select(w.sz, hi.z, lo.z), fz = select(w.sz, lo.z, hi.z);
#else
  const float nx = inv.x < 0.0f ? hi.x : lo.x, fx = inv.x < 0.0f ? lo.x : hi.x;
  const float ny = inv.y < 0.0f ? hi.y : lo.y, fy = inv.y < 0.0f ? lo.y : hi.y;
  const float nz = inv.z < 0.0f ? hi.z : lo.z, fz = inv.z < 0.0f ? lo.z : hi.z;
#endif
  const float t0x = (nx - o.x) * inv.x, t1x = (fx - o.x) * inv.x;
  const float t0y = (ny - o.y) * inv.y, t1y = (fy - o.y) * inv.y;
  const float t0z = (nz - o.z) * inv.z, t1z = (fz - o.z) * inv.z;
#if RF_PTX_MINMAX
#define RF_MAX rf::max_nan1
#define RF_MIN rf::min_nan1
#else
#define RF_MAX rf::max_nan
#define RF_MIN rf::min_nan
#endif
  const float tmin_xy = RF_MAX(t0x, t0y);
  const float tmax_xy = RF_MIN(t1x, t1y);
  const bool fail_xy = (t0x > t1y) || (t0y > t1x);
  const bool fail_z = (tmin_xy > t1z) || (t0z > tmax_xy);
  const float tmin = RF_MAX(tmin_xy, t0z);
  const float tmax = RF_MIN(tmax_xy, t1z);
  return (!fail_xy && !fail_z && tmax > 0.0f) ? tmin : CUDART_INF_F;
}

__device__ __forceinline__ void start(const rf::PackedView& s, rf::Vec3 o, rf::Vec3 d,
                                      float t_max, Walk* w) {
  w->o = o;
  w->d = d;
  w->inv = rf::Vec3{1.0f / d.x, 1.0f / d.y, 1.0f / d.z};
  w->t_best = t_max;
  w->hit_tri = -1;
  w->records = 0;
  w->sp = 0;
  w->sx = w->inv.x < 0.0f ? -1 : 0;
  w->sy = w->inv.y < 0.0f ? -1 : 0;
  w->sz = w->inv.z < 0.0f ? -1 : 0;
  w->take = key_of(rf::load3(s.root_min, 0), rf::load3(s.root_max, 0), *w) < t_max;
  w->count = w->take ? __ldg(s.root_count) : 0;
  w->ref = w->count > 0 ? __ldg(s.root_offset) : 0;
}

// The three steps of walk_packed, on a Walk `w` with the stack RF_STACK.
#define RF_RECORD_STEP(w)                                                                   \
  {                                                                                         \
    const int4* r = s.nodes + 4ll * w.ref;                                                  \
    const int4 a = RF_LD(r), b = RF_LD(r + 1), c = RF_LD(r + 2), m = RF_LD(r + 3);          \
    const float key_l = key_of(                                                             \
        rf::Vec3{__int_as_float(a.x), __int_as_float(a.y), __int_as_float(a.z)},            \
        rf::Vec3{__int_as_float(a.w), __int_as_float(b.x), __int_as_float(b.y)}, w);        \
    const float key_r = key_of(                                                             \
        rf::Vec3{__int_as_float(b.z), __int_as_float(b.w), __int_as_float(c.x)},            \
        rf::Vec3{__int_as_float(c.y), __int_as_float(c.z), __int_as_float(c.w)}, w);        \
    const int count_r = m.w & 0x3FFFFFFF;                                                   \
    const int axis = static_cast<int>(static_cast<unsigned>(m.w) >> 30);                    \
    const bool axis_neg = rf::component(w.inv, axis) < 0.0f;                                \
    if (w.sp < rf::kStackDepth) {                                                           \
      RF_STACK(w.sp) = axis_neg ? Entry{m.x, m.z, key_l} : Entry{m.y, count_r, key_r};      \
    }                                                                                       \
    ++w.sp;                                                                                 \
    ++w.records;                                                                            \
    w.ref = axis_neg ? m.y : m.x;                                                           \
    w.count = axis_neg ? count_r : m.z;                                                     \
    w.take = (axis_neg ? key_r : key_l) < w.t_best;                                         \
  }

#define RF_POP(w)                                                \
  {                                                              \
    --w.sp;                                                      \
    const Entry e = RF_STACK(min(w.sp, rf::kStackDepth - 1));    \
    w.ref = e.ref;                                               \
    w.count = e.count;                                           \
    w.take = e.key < w.t_best;                                   \
  }

// Tests the leaf's triangles; `done` becomes true where an any-hit walk ends.
#define RF_LEAF(w, any_hit, done)                                        \
  {                                                                      \
    for (int k = 0; k < w.count; ++k) {                                  \
      const int tri = min(w.ref + k, s.num_tris - 1);                    \
      const float4* p4 = s.tris + 3ll * tri;                             \
      const float4 a = __ldg(p4), b = __ldg(p4 + 1), c = __ldg(p4 + 2);  \
      const float p[9] = {a.x, a.y, a.z, b.x, b.y, b.z, c.x, c.y, c.z};  \
      float t, u, v;                                                     \
      if (rf::moller_trumbore(p, w.o, w.d, w.t_best, &t, &u, &v)) {      \
        w.t_best = t;                                                    \
        w.hit_tri = tri;                                                 \
        if (any_hit) {                                                   \
          done = true;                                                   \
          break;                                                         \
        }                                                                \
      }                                                                  \
    }                                                                    \
    w.take = false;                                                      \
  }

// The walk of `w` to its end (RF_LOOP 0 or 2), or to the end of one round of
// the while-while forms (RF_LOOP 1 or 3): records until the lane holds a
// leaf, then the leaf. `alive` becomes false when the walk is over.
#if RF_LOOP == 0
#define RF_ADVANCE(w, any_hit, alive)              \
  while (alive) {                                  \
    if (w.take) {                                  \
      if (w.count > 0) {                           \
        bool done = false;                         \
        RF_LEAF(w, any_hit, done)                  \
        if (done) alive = false;                   \
      } else {                                     \
        RF_RECORD_STEP(w)                          \
      }                                            \
    } else if (w.sp == 0) {                        \
      alive = false;                               \
    } else {                                       \
      RF_POP(w)                                    \
    }                                              \
  }
#elif RF_LOOP == 2
#define RF_ADVANCE(w, any_hit, alive)              \
  while (alive) {                                  \
    while (!w.take && w.sp > 0) {                  \
      RF_POP(w)                                    \
    }                                              \
    if (!w.take) {                                 \
      alive = false;                               \
    } else if (w.count > 0) {                      \
      bool done = false;                           \
      RF_LEAF(w, any_hit, done)                    \
      if (done) alive = false;                     \
    } else {                                       \
      RF_RECORD_STEP(w)                            \
    }                                              \
  }
#elif RF_LOOP == 1
#define RF_ADVANCE(w, any_hit, alive)                  \
  {                                                    \
    while (alive && !(w.take && w.count > 0)) {        \
      if (w.take) {                                    \
        RF_RECORD_STEP(w)                              \
      } else if (w.sp == 0) {                          \
        alive = false;                                 \
      } else {                                         \
        RF_POP(w)                                      \
      }                                                \
    }                                                  \
    if (alive) {                                       \
      bool done = false;                               \
      RF_LEAF(w, any_hit, done)                        \
      if (done) alive = false;                         \
    }                                                  \
  }
#else
#define RF_ADVANCE(w, any_hit, alive)                  \
  {                                                    \
    while (true) {                                     \
      while (!w.take && w.sp > 0) {                    \
        RF_POP(w)                                      \
      }                                                \
      if (!w.take) {                                   \
        alive = false;                                 \
        break;                                         \
      }                                                \
      if (w.count > 0) break;                          \
      RF_RECORD_STEP(w)                                \
    }                                                  \
    if (alive) {                                       \
      bool done = false;                               \
      RF_LEAF(w, any_hit, done)                        \
      if (done) alive = false;                         \
    }                                                  \
  }
#endif

template <bool kAnyHit>
__device__ __forceinline__ void store(const Walk& w, int i, float* t_out, int* tri_out,
                                      int* visits_out, bool* occ_out) {
  if (kAnyHit) {
    occ_out[i] = w.hit_tri >= 0;
  } else {
    t_out[i] = w.t_best;
    tri_out[i] = w.hit_tri;
    visits_out[i] = 1 + 2 * w.records;
  }
}

template <bool kAnyHit>
__global__ void RF_BOUNDS walk_kernel(rf::PackedView s, const float* __restrict__ origin,
                                      const float* __restrict__ direction,
                                      const float* __restrict__ t_max, int n,
                                      float* __restrict__ t_out, int* __restrict__ tri_out,
                                      int* __restrict__ visits_out, bool* __restrict__ occ_out,
                                      unsigned* __restrict__ counter) {
  RF_STACK_DECL
  Walk w;
#if !RF_PERSIST
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  start(s, rf::load3(origin, i), rf::load3(direction, i), t_max[i], &w);
  bool alive = true;
  while (alive) {
    RF_ADVANCE(w, kAnyHit, alive)
  }
  store<kAnyHit>(w, i, t_out, tri_out, visits_out, occ_out);
#else
  // Warps take rays from the counter: all 32 at once when every lane is
  // done (RF_REFILL_AT 1), or the idle lanes' share as soon as fewer than
  // RF_REFILL_AT lanes are alive. One round of the while-while per trip.
  const int warp_lane = threadIdx.x & 31;
  int i = 0;
  bool alive = false;
  bool more = true;  // the counter has rays left
  while (true) {
    const unsigned alive_mask = __ballot_sync(kFullWarp, alive);
    if (more && __popc(alive_mask) < RF_REFILL_AT) {
      const unsigned idle = ~alive_mask;
      const int rank = __popc(idle & ((1u << warp_lane) - 1u));
      unsigned base = 0;
      if (warp_lane == 0) base = atomicAdd(counter, static_cast<unsigned>(__popc(idle)));
      base = __shfl_sync(kFullWarp, base, 0);
      if (base + __popc(idle) >= static_cast<unsigned>(n)) more = false;
      const unsigned j = base + rank;
      if (!alive && j < static_cast<unsigned>(n)) {
        i = static_cast<int>(j);
        start(s, rf::load3(origin, i), rf::load3(direction, i), t_max[i], &w);
        alive = true;
      }
    }
    if (!__any_sync(kFullWarp, alive)) break;
    if (alive) {
      RF_ADVANCE(w, kAnyHit, alive)
      if (!alive) store<kAnyHit>(w, i, t_out, tri_out, visits_out, occ_out);
    }
  }
#endif
}

// The plane walk of traverse.cuh, one thread per ray.
template <bool kAnyHit>
__global__ void RF_BOUNDS plane_kernel(rf::SceneView s, const float* __restrict__ origin,
                                       const float* __restrict__ direction,
                                       const float* __restrict__ t_max, int n,
                                       float* __restrict__ t_out, int* __restrict__ tri_out,
                                       int* __restrict__ visits_out,
                                       bool* __restrict__ occ_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const rf::Vec3 o = rf::load3(origin, i), d = rf::load3(direction, i);
  if (kAnyHit) {
    occ_out[i] = rf::any_hit(s, o, d, t_max[i]);
  } else {
    float t;
    int visits;
    tri_out[i] = rf::closest_hit(s, o, d, t_max[i], &t, &visits);
    t_out[i] = t;
    visits_out[i] = visits;
  }
}

__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// The instrumented walk keeps its stack in local memory whatever RF_SMEM says.
#undef RF_STACK
#define RF_STACK(k) steps_stack[k]

__global__ void __launch_bounds__(128) steps_kernel(
    rf::PackedView s, const float* __restrict__ origin, const float* __restrict__ direction,
    const float* __restrict__ t_max, int n, float* __restrict__ t_out, int* __restrict__ tri_out,
    int* __restrict__ lane_steps,  // (n, 3): records, leaves, pops
    int* __restrict__ warp_steps,  // (warps, 6): trips, with leaf lanes, with record lanes,
                                   // with both, alive lane-trips, with pop lanes
    unsigned long long* __restrict__ block_t, int* __restrict__ block_sm) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (threadIdx.x == 0) {
    block_t[2 * blockIdx.x] = globaltimer();
    unsigned sm;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
    block_sm[blockIdx.x] = static_cast<int>(sm);
  }
  bool alive = i < n;
  Entry steps_stack[rf::kStackDepth];
  Walk w;
  w.take = false;
  w.count = w.sp = w.records = 0;
  if (alive) start(s, rf::load3(origin, i), rf::load3(direction, i), t_max[i], &w);
  int n_leaf = 0, n_pop = 0;
  int w_trips = 0, w_leaf = 0, w_rec = 0, w_both = 0, w_alive = 0, w_pop = 0;
  while (true) {
    const unsigned m_alive = __ballot_sync(kFullWarp, alive);
    if (m_alive == 0) break;
    const unsigned m_leaf = __ballot_sync(kFullWarp, alive && w.take && w.count > 0);
    const unsigned m_rec = __ballot_sync(kFullWarp, alive && w.take && w.count <= 0);
    const unsigned m_pop = __ballot_sync(kFullWarp, alive && !w.take);
    ++w_trips;
    w_leaf += m_leaf != 0;
    w_rec += m_rec != 0;
    w_both += (m_leaf != 0) && (m_rec != 0);
    w_pop += m_pop != 0;
    w_alive += __popc(m_alive);
    if (alive) {
      if (w.take) {
        if (w.count > 0) {
          ++n_leaf;
          bool done = false;
          RF_LEAF(w, false, done)
        } else {
          RF_RECORD_STEP(w)
        }
      } else if (w.sp == 0) {
        alive = false;
      } else {
        ++n_pop;
        RF_POP(w)
      }
    }
  }
  if (i < n) {
    t_out[i] = w.t_best;
    tri_out[i] = w.hit_tri;
    lane_steps[3 * i] = w.records;
    lane_steps[3 * i + 1] = n_leaf;
    lane_steps[3 * i + 2] = n_pop;
  }
  if ((threadIdx.x & 31) == 0) {
    int* out = warp_steps + 6ll * (i / 32);
    out[0] = w_trips;
    out[1] = w_leaf;
    out[2] = w_rec;
    out[3] = w_both;
    out[4] = w_alive;
    out[5] = w_pop;
  }
  __syncthreads();
  if (threadIdx.x == 0) block_t[2 * blockIdx.x + 1] = globaltimer();
}

template <bool kAnyHit>
int launch(const rf::PackedView& s, const float* origin, const float* direction,
           const float* t_max, int n, float* t_out, int* tri_out, int* visits_out, bool* occ_out,
           unsigned* counter, void* stream_ptr) {
  int grid = (n + RF_BLOCK - 1) / RF_BLOCK;
#if RF_PERSIST
  int device = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, walk_kernel<kAnyHit>, RF_BLOCK, 0);
  grid = min(grid, sms * per_sm);
#endif
  walk_kernel<kAnyHit><<<grid, RF_BLOCK, 0, static_cast<cudaStream_t>(stream_ptr)>>>(
      s, origin, direction, t_max, n, t_out, tri_out, visits_out, occ_out, counter);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The packed forms: the scene arguments of the library's rf_intersect_closest
// and rf_intersect_any, then a zeroed counter (used by RF_PERSIST).
extern "C" int rf_probe_closest(const float* aabb_min, const float* aabb_max,
                                const int* tri_offset, const int* tri_count, const int* nodes2,
                                const float* tri_pos4, int num_tris, const float* origin,
                                const float* direction, const float* t_max, int n, float* t_out,
                                int* tri_out, int* visits_out, unsigned* counter, void* stream) {
  const rf::PackedView s =
      rf::make_packed(aabb_min, aabb_max, tri_offset, tri_count, nodes2, tri_pos4, num_tris);
  return launch<false>(s, origin, direction, t_max, n, t_out, tri_out, visits_out, nullptr,
                       counter, stream);
}

extern "C" int rf_probe_any(const float* aabb_min, const float* aabb_max, const int* tri_offset,
                            const int* tri_count, const int* nodes2, const float* tri_pos4,
                            int num_tris, const float* origin, const float* direction,
                            const float* t_max, int n, bool* occ_out, unsigned* counter,
                            void* stream) {
  const rf::PackedView s =
      rf::make_packed(aabb_min, aabb_max, tri_offset, tri_count, nodes2, tri_pos4, num_tris);
  return launch<true>(s, origin, direction, t_max, n, nullptr, nullptr, nullptr, occ_out, counter,
                      stream);
}

// The plane walk: the six SoA planes, the triangle positions and count.
extern "C" int rf_probe_plane(const float* aabb_min, const float* aabb_max, const int* tri_offset,
                              const int* second_child, const int* tri_count,
                              const int* split_axis, const float* tri_pos, int num_tris,
                              const float* origin, const float* direction, const float* t_max,
                              int n, float* t_out, int* tri_out, int* visits_out, bool* occ_out,
                              int any_hit, void* stream) {
  const rf::SceneView s = rf::make_scene(aabb_min, aabb_max, tri_offset, second_child, tri_count,
                                         split_axis, tri_pos, num_tris);
  const int grid = (n + RF_BLOCK - 1) / RF_BLOCK;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (any_hit) {
    plane_kernel<true><<<grid, RF_BLOCK, 0, st>>>(s, origin, direction, t_max, n, t_out, tri_out,
                                                  visits_out, occ_out);
  } else {
    plane_kernel<false><<<grid, RF_BLOCK, 0, st>>>(s, origin, direction, t_max, n, t_out, tri_out,
                                                   visits_out, occ_out);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rf_probe_steps(const float* aabb_min, const float* aabb_max, const int* tri_offset,
                              const int* tri_count, const int* nodes2, const float* tri_pos4,
                              int num_tris, const float* origin, const float* direction,
                              const float* t_max, int n, float* t_out, int* tri_out,
                              int* lane_steps, int* warp_steps, unsigned long long* block_t,
                              int* block_sm, void* stream) {
  const rf::PackedView s =
      rf::make_packed(aabb_min, aabb_max, tri_offset, tri_count, nodes2, tri_pos4, num_tris);
  steps_kernel<<<(n + 127) / 128, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      s, origin, direction, t_max, n, t_out, tri_out, lane_steps, warp_steps, block_t, block_sm);
  return static_cast<int>(cudaGetLastError());
}
