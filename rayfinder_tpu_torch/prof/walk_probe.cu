// Probe kernels of the ray queries K1 and K2 and of the sky-round probe K8
// (prof/walk_probe.py): forms of the packed walk chosen by macros at build
// time, to be timed in turns with the shipped kernels, the plane walk that
// the port's kernels used before the packed tables, and instrumented walks
// that count their steps. Every form keeps each ray's own order of records,
// pushes, pops and triangle tests, so t, tri, the node count, occlusion and
// K8's sums must equal the shipped kernels' bit for bit; the probe checks
// that before it times.
//
//   RF_LOOP       0: one loop that takes one step (record, leaf or pop) per
//                    trip; 1: while-while (records and pops until the lane
//                    holds a leaf, then the leaf tests); 2: one loop with
//                    the seek (pop until an entry to take, then record or
//                    leaf); 3: seek and while-while (walk_packed's form)
//   RF_PTX_MINMAX 1: min.NaN / max.NaN in PTX (traverse2.cuh's slab_key);
//                 0: two compares and a select each (the plane walk's)
//   RF_LOP3       1: the near/far selects as lop3 on sign masks
//   RF_STACK16    1: 16-byte stack entries
//   RF_SMEM       the first RF_SMEM entries of the stack in shared memory (0:
//                    none, 32: all of it), the rest in local memory; also
//                    the packed K8 forms' (walk_packed's kShared)
//   RF_LDHINT     0: __ldg; 1: ld.global.cg (L2 only); 2: ld.global.ca
//   RF_PERSIST    1: a grid that fills the card, whose warps take rays from
//                    a counter; RF_REFILL_AT: idle lanes are refilled when
//                    fewer than this many lanes of the warp are alive
//   RF_BLOCK      threads per block; RF_MIN_BLOCKS: launch bound (0: none)
//   RF_PLANE      1: the plane walk below instead (one thread per ray)
//   RF_SKY        K8's "full" mode (rf_probe_sky): 0: one thread per lane,
//                    its rounds one after another, over the plane walk (the
//                    kernel before the packed walk); 1: the same over the
//                    packed walk; 2: one warp per lane, whose threads take
//                    its rounds and fold their sums in round order by
//                    shuffles (skyround.cu's form); 3: a grid that fills
//                    the card, whose warps take 32 (lane, round) items at a
//                    time from a counter and write each round's terms to a
//                    scratch, then a kernel that folds them in round order
//
// The plane walk (namespace plane) reads the BVH's SoA planes: per node
// visit six scalar box loads, then tri_count, then tri_offset or split_axis
// and second_child, one visit per child and one pop per far child. It was
// the walk of every kernel of the port until the packed tables (traverse2.cuh)
// replaced it; it stays here as the baseline form of the probes.
//
// rf_probe_steps is the instrumented closest walk: one step per
// warp-synchronous trip, counting per lane its record, leaf and pop steps,
// per warp its trips and how many held leaf lanes, record lanes, both, and
// pop lanes, and per block its start and end on %globaltimer.
// rf_probe_sky_steps is K8's "full" mode as it ran over the plane walk (RF_SKY
// 0), writing the nodes each (lane, round) visited and each block's SM, start
// and end on %globaltimer.
//
// Built by the probe with the library's flags and -I csrc; not part of the
// kernel library.

#include "path.cuh"

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
#ifndef RF_SKY
#define RF_SKY 2
#endif

// The plane walk: one thread's near-first walk over the SoA planes with a
// 32-entry stack, the reference's own traversal
// (src/pt/reference_path_tracer.wgsl:370-429) and the rule of the plain
// torch walk (render/traverse.py _walk): the same visit order, the same slab
// comparisons against the best t so far, and the same behaviour when the
// stack is full (a push at depth 32 is dropped, the pointer still moves).
namespace plane {

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

// Slab test (ray_intersection.cpp:101-136, render/intersect.py ray_aabb).
__device__ __forceinline__ bool ray_aabb(const SceneView& s, int node, rf::Vec3 o, rf::Vec3 inv,
                                         float t_max) {
  const rf::Vec3 lo = rf::load3(s.aabb_min, node);
  const rf::Vec3 hi = rf::load3(s.aabb_max, node);
  const float nx = inv.x < 0.0f ? hi.x : lo.x, fx = inv.x < 0.0f ? lo.x : hi.x;
  const float ny = inv.y < 0.0f ? hi.y : lo.y, fy = inv.y < 0.0f ? lo.y : hi.y;
  const float nz = inv.z < 0.0f ? hi.z : lo.z, fz = inv.z < 0.0f ? lo.z : hi.z;
  const float t0x = (nx - o.x) * inv.x, t1x = (fx - o.x) * inv.x;
  const float t0y = (ny - o.y) * inv.y, t1y = (fy - o.y) * inv.y;
  const float t0z = (nz - o.z) * inv.z, t1z = (fz - o.z) * inv.z;

  const float tmin_xy = rf::max_nan(t0x, t0y);
  const float tmax_xy = rf::min_nan(t1x, t1y);
  const bool fail_xy = (t0x > t1y) || (t0y > t1x);
  const bool fail_z = (tmin_xy > t1z) || (t0z > tmax_xy);
  const float tmin = rf::max_nan(tmin_xy, t0z);
  const float tmax = rf::min_nan(tmax_xy, t1z);
  return !fail_xy && !fail_z && (tmin < t_max) && (tmax > 0.0f);
}

// Returns the leaf-order index of the accepted triangle (-1 if none); *t_best
// holds its t (t_max if none), *visits_out the nodes visited. kAnyHit stops at
// the first accepted triangle.
template <bool kAnyHit>
__device__ int walk(const SceneView& s, rf::Vec3 o, rf::Vec3 d, float t_max, float* t_best_out,
                    int* visits_out) {
  const rf::Vec3 inv{1.0f / d.x, 1.0f / d.y, 1.0f / d.z};
  float t_best = t_max;
  int hit_tri = -1;
  int visits = 0;
  int stack[rf::kStackDepth];
  int sp = 0;
  int node = 0;
  while (true) {
    ++visits;
    bool pop = true;
    if (ray_aabb(s, node, o, inv, t_best)) {
      const int count = s.tri_count[node];
      if (count > 0) {
        const int first = s.tri_offset[node];
        for (int k = 0; k < count; ++k) {
          const int tri = min(first + k, s.num_tris - 1);
          float t, u, v;
          if (rf::moller_trumbore(s.tri_pos + 9ll * tri, o, d, t_best, &t, &u, &v)) {
            t_best = t;
            hit_tri = tri;
            if (kAnyHit) {
              *t_best_out = t_best;
              *visits_out = visits;
              return hit_tri;
            }
          }
        }
      } else {
        // Push the far child, descend into the near one (wgsl:408-418).
        const bool axis_neg = rf::component(inv, s.split_axis[node]) < 0.0f;
        const int second = s.second_child[node];
        const int near_child = axis_neg ? second : node + 1;
        const int far_child = axis_neg ? node + 1 : second;
        if (sp < rf::kStackDepth) stack[sp] = far_child;
        ++sp;
        node = near_child;
        pop = false;
      }
    }
    if (pop) {
      if (sp == 0) break;
      --sp;
      node = stack[min(sp, rf::kStackDepth - 1)];
    }
  }
  *t_best_out = t_best;
  *visits_out = visits;
  return hit_tri;
}

__device__ __forceinline__ int closest_hit(const SceneView& s, rf::Vec3 o, rf::Vec3 d,
                                           float t_max, float* t_out, int* visits_out) {
  return walk<false>(s, o, d, t_max, t_out, visits_out);
}

__device__ __forceinline__ bool any_hit(const SceneView& s, rf::Vec3 o, rf::Vec3 d,
                                        float t_max) {
  float t;
  int visits;
  return walk<true>(s, o, d, t_max, &t, &visits) >= 0;
}

}  // namespace plane

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

// The plane walk, one thread per ray.
template <bool kAnyHit>
__global__ void RF_BOUNDS plane_kernel(plane::SceneView s, const float* __restrict__ origin,
                                       const float* __restrict__ direction,
                                       const float* __restrict__ t_max, int n,
                                       float* __restrict__ t_out, int* __restrict__ tri_out,
                                       int* __restrict__ visits_out,
                                       bool* __restrict__ occ_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const rf::Vec3 o = rf::load3(origin, i), d = rf::load3(direction, i);
  if (kAnyHit) {
    occ_out[i] = plane::any_hit(s, o, d, t_max[i]);
  } else {
    float t;
    int visits;
    tri_out[i] = plane::closest_hit(s, o, d, t_max[i], &t, &visits);
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
  const plane::SceneView s{aabb_min, aabb_max, tri_offset, second_child, tri_count,
                           split_axis, tri_pos, num_tris};
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

// ---- K8, the sky-round probe, in its "full" mode ----------------------------
// Each form computes, for every lane i and round r, the closest hit of the
// lane's primary ray of sample r and the sky of that ray, and adds
// a0 + t (0 on a miss), then ((a0 + r) + g) + b, in round order: acc equals
// skyround.cu's bit for bit.

namespace {

__device__ __forceinline__ rf::Pixel sky_pixel(const float* u, const float* v, const float* nb,
                                               int i) {
  return rf::Pixel{u[i], v[i], nb[2 * i], nb[2 * i + 1]};
}

__device__ __forceinline__ void sky_start(const rf::RegenParams& p, const rf::Pixel& px,
                                          int sample, rf::Vec3* o, rf::Vec3* d) {
  float nx, ny;
  rf::noise_of(p, sample, px, &nx, &ny);
  rf::primary(p, px, nx, ny, o, d);
}

// Round r of a lane over the packed walk: (t or 0, sky r, g, b).
__device__ __forceinline__ float4 sky_terms(const rf::PackedView& s, const rf::RegenParams& p,
                                            const rf::Pixel& px, int r) {
  rf::Vec3 o, d;
  sky_start(p, px, r, &o, &d);
  float t;
  const int tri = rf::walk_packed<false, 0, RF_SMEM>(s, o, d, p.t_max, &t);
  const rf::Vec3 sky = rf::sky_radiance(p, d);
  return make_float4(tri >= 0 ? t : 0.0f, sky.x, sky.y, sky.z);
}

__device__ __forceinline__ float sky_fold(float a0, float4 t) {
  a0 = a0 + t.x;
  return a0 + t.y + t.z + t.w;
}

// RF_SKY 0 (kSteps false): the kernel as it ran over the plane walk, one
// thread per lane. kSteps: also the nodes of every (lane, round) and each
// block's SM, start and end.
template <bool kSteps>
__global__ void __launch_bounds__(128) sky_plane_kernel(
    plane::SceneView s, rf::RegenParams p, int n, int rounds, const float* __restrict__ u,
    const float* __restrict__ v, const float* __restrict__ nb, float* __restrict__ acc,
    int* __restrict__ visits_out, unsigned long long* __restrict__ block_t,
    int* __restrict__ block_sm) {
  if (kSteps && threadIdx.x == 0) {
    block_t[2 * blockIdx.x] = globaltimer();
    unsigned sm;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
    block_sm[blockIdx.x] = static_cast<int>(sm);
  }
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) {
    const rf::Pixel px = sky_pixel(u, v, nb, i);
    int sample = 0;
    rf::Vec3 o, d;
    sky_start(p, px, sample, &o, &d);
    float a0 = 0.0f;
    for (int r = 0; r < rounds; ++r) {
      float t;
      int visits;
      const int tri = plane::closest_hit(s, o, d, p.t_max, &t, &visits);
      if (kSteps) visits_out[static_cast<long long>(i) * rounds + r] = visits;
      a0 = a0 + (tri >= 0 ? t : 0.0f);
      const rf::Vec3 sky = rf::sky_radiance(p, d);
      a0 = a0 + sky.x + sky.y + sky.z;
      ++sample;
      sky_start(p, px, sample, &o, &d);
    }
    acc[i] = a0;
  }
  if (kSteps) {
    __syncthreads();
    if (threadIdx.x == 0) block_t[2 * blockIdx.x + 1] = globaltimer();
  }
}

// RF_SKY 1: the same over the packed walk.
__global__ void __launch_bounds__(128) sky_lane_kernel(rf::PackedView s, rf::RegenParams p, int n,
                                                       int rounds, const float* __restrict__ u,
                                                       const float* __restrict__ v,
                                                       const float* __restrict__ nb,
                                                       float* __restrict__ acc) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const rf::Pixel px = sky_pixel(u, v, nb, i);
  float a0 = 0.0f;
  for (int r = 0; r < rounds; ++r) a0 = sky_fold(a0, sky_terms(s, p, px, r));
  acc[i] = a0;
}

// RF_SKY 2: one warp per lane; thread k takes rounds k, k + 32, ...; each
// group of 32 rounds is folded in round order by shuffles.
__global__ void __launch_bounds__(128) sky_warp_kernel(rf::PackedView s, rf::RegenParams p, int n,
                                                       int rounds, const float* __restrict__ u,
                                                       const float* __restrict__ v,
                                                       const float* __restrict__ nb,
                                                       float* __restrict__ acc) {
  const int i = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int k = threadIdx.x & 31;
  if (i >= n) return;
  const rf::Pixel px = sky_pixel(u, v, nb, i);
  float a0 = 0.0f;
  for (int base = 0; base < rounds; base += 32) {
    float4 mine = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (base + k < rounds) mine = sky_terms(s, p, px, base + k);
    const int m = min(32, rounds - base);
    for (int j = 0; j < m; ++j) {
      const float4 t = make_float4(__shfl_sync(kFullWarp, mine.x, j),
                                   __shfl_sync(kFullWarp, mine.y, j),
                                   __shfl_sync(kFullWarp, mine.z, j),
                                   __shfl_sync(kFullWarp, mine.w, j));
      a0 = sky_fold(a0, t);
    }
  }
  if (k == 0) acc[i] = a0;
}

// RF_SKY 3: warps take 32 (lane, round) items at a time from the counter,
// lane-major (item j is round j % rounds of lane j / rounds), and write each
// round's terms to the scratch; sky_fold_kernel adds them in round order.
__global__ void __launch_bounds__(128) sky_items_kernel(
    rf::PackedView s, rf::RegenParams p, int n, int rounds, const float* __restrict__ u,
    const float* __restrict__ v, const float* __restrict__ nb, float4* __restrict__ scratch,
    unsigned* __restrict__ counter) {
  const unsigned total = static_cast<unsigned>(n) * static_cast<unsigned>(rounds);
  const int k = threadIdx.x & 31;
  while (true) {
    unsigned base = 0;
    if (k == 0) base = atomicAdd(counter, 32u);
    base = __shfl_sync(kFullWarp, base, 0);
    if (base >= total) break;
    const unsigned j = base + k;
    if (j < total) {
      const int i = static_cast<int>(j / rounds);
      scratch[j] = sky_terms(s, p, sky_pixel(u, v, nb, i), static_cast<int>(j % rounds));
    }
  }
}

__global__ void __launch_bounds__(128) sky_fold_kernel(int n, int rounds,
                                                       const float4* __restrict__ scratch,
                                                       float* __restrict__ acc) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float a0 = 0.0f;
  const float4* row = scratch + static_cast<long long>(i) * rounds;
  for (int r = 0; r < rounds; ++r) a0 = sky_fold(a0, row[r]);
  acc[i] = a0;
}

}  // namespace

// K8's "full" mode in the form RF_SKY: the six SoA planes, the triangle
// positions, the packed tables, the triangle count, then the probe's
// parameters and lanes, acc, and for RF_SKY 3 a scratch of n x rounds x 16
// bytes and a zeroed counter.
extern "C" int rf_probe_sky(const float* aabb_min, const float* aabb_max, const int* tri_offset,
                            const int* second_child, const int* tri_count, const int* split_axis,
                            const float* tri_pos, const int* nodes2, const float* tri_pos4,
                            int num_tris, const rf::RegenParams* params, int n, int rounds,
                            const float* u, const float* v, const float* nb, float* acc,
                            float* scratch, unsigned* counter, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const rf::PackedView s =
      rf::make_packed(aabb_min, aabb_max, tri_offset, tri_count, nodes2, tri_pos4, num_tris);
#if RF_SKY == 0
  const plane::SceneView ps{aabb_min, aabb_max, tri_offset, second_child, tri_count,
                            split_axis, tri_pos, num_tris};
  sky_plane_kernel<false><<<(n + 127) / 128, 128, 0, st>>>(ps, *params, n, rounds, u, v, nb, acc,
                                                           nullptr, nullptr, nullptr);
#elif RF_SKY == 1
  sky_lane_kernel<<<(n + 127) / 128, 128, 0, st>>>(s, *params, n, rounds, u, v, nb, acc);
#elif RF_SKY == 2
  sky_warp_kernel<<<(n + 3) / 4, 128, 0, st>>>(s, *params, n, rounds, u, v, nb, acc);
#else
  int device = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, sky_items_kernel, 128, 0);
  float4* items = reinterpret_cast<float4*>(scratch);
  sky_items_kernel<<<sms * per_sm, 128, 0, st>>>(s, *params, n, rounds, u, v, nb, items, counter);
  sky_fold_kernel<<<(n + 127) / 128, 128, 0, st>>>(n, rounds, items, acc);
#endif
  (void)second_child;
  (void)split_axis;
  (void)tri_pos;
  (void)scratch;
  (void)counter;
  (void)s;
  return static_cast<int>(cudaGetLastError());
}

// RF_SKY 0 instrumented: visits (n, rounds) int32, block_t (blocks, 2) and
// block_sm (blocks,) for blocks of 128 lanes.
extern "C" int rf_probe_sky_steps(const float* aabb_min, const float* aabb_max,
                                  const int* tri_offset, const int* second_child,
                                  const int* tri_count, const int* split_axis,
                                  const float* tri_pos, int num_tris,
                                  const rf::RegenParams* params, int n, int rounds,
                                  const float* u, const float* v, const float* nb, float* acc,
                                  int* visits, unsigned long long* block_t, int* block_sm,
                                  void* stream) {
  const plane::SceneView ps{aabb_min, aabb_max, tri_offset, second_child, tri_count,
                            split_axis, tri_pos, num_tris};
  sky_plane_kernel<true><<<(n + 127) / 128, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      ps, *params, n, rounds, u, v, nb, acc, visits, block_t, block_sm);
  return static_cast<int>(cudaGetLastError());
}
