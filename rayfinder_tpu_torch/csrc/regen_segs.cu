// Multi-segment persistent path kernel (K5): each lane pipelines K paths of
// its pixel in K slots and returns K hit segments per call, so the loop
// around it runs about K times fewer iterations than around K3.
//
// Replaces pallas_trace_regen_segs (rayfinder_tpu/ops/pallas_regen.py; body
// _make_path_kernel_segs). Per lane, in the order of the TPU kernel:
//   prologue, per slot j = 0..K-1: resolve the slot's pending NEE sample,
//     and where its flag is 2 flush its radiance, take the pixel's next
//     sample from the allocator `salloc` and regenerate the slot;
//   loop: trace the first slot that still has a sample and is not parked;
//     a hit parks the slot (t, tri kept for the shade); a miss folds the sky
//     into the lane radiance, takes the next sample from `salloc` and
//     regenerates the slot in place; until no slot is in flight.
// Each sample's arithmetic is that of K3 (path.cuh); only the order in which
// samples add into the lane radiance differs.
//
// The TPU kernel looped per 128-lane tile, but no lane's result depends on
// its tile, so here each thread runs its own loop with no barrier. Slots
// are selected with unrolled compares (the TPU kernel's `sel`): indexing
// the slot arrays with a runtime value would put them in local memory.
// What bounds it: the BVH walks, over the packed tables (traverse2.cuh);
// the K slots' registers lower occupancy as K grows.

#include "path.cuh"

namespace {

template <int K>
__global__ void trace_regen_segs_kernel(
    rf::PackedView s, rf::RegenParams p, int n, const float* __restrict__ u_in,
    const float* __restrict__ v_in, const float* __restrict__ noise_base,
    const int* __restrict__ salloc_in, const float* __restrict__ lrad_in,
    const int* __restrict__ cnt_in, const float* __restrict__ ray_in,
    const float* __restrict__ thr_in, const float* __restrict__ nee_in,
    int* __restrict__ salloc_out, float* __restrict__ lrad_out, int* __restrict__ cnt_out,
    float* __restrict__ ray_out, float* __restrict__ thr_out, float* __restrict__ t_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int nf = p.num_frames;
  const long long ci = 3ll * K * i, ri = 6ll * K * i, ni = 9ll * K * i;
  const rf::Pixel px{u_in[i], v_in[i], noise_base[2 * i], noise_base[2 * i + 1]};
  int salloc = min(salloc_in[i], nf);
  rf::Vec3 lrad = rf::load3(lrad_in, i);

  int ssample[K], bounce[K], tri[K];
  bool parked[K];
  float t_fin[K];
  rf::Vec3 o[K], d[K], thr[K], srad[K];

  // Prologue, slot by slot: pending NEE, terminate, take a sample, regenerate.
#pragma unroll
  for (int j = 0; j < K; ++j) {
    ssample[j] = cnt_in[ci + 3 * j];
    bounce[j] = cnt_in[ci + 3 * j + 1];
    const int flag = cnt_in[ci + 3 * j + 2];
    o[j] = rf::load3(ray_in + ri + 6 * j, 0);
    d[j] = rf::load3(ray_in + ri + 6 * j + 3, 0);
    thr[j] = rf::load3(thr_in + ri + 6 * j, 0);
    srad[j] = rf::load3(thr_in + ri + 6 * j + 3, 0);
    const bool live = ssample[j] < nf;
    if (live && flag > 0) {
      const float* nee = nee_in + ni + 9 * j;
      srad[j] = rf::add_nee(s, p.t_max, srad[j], rf::load3(nee + 6, 0), rf::load3(nee, 0),
                            rf::load3(nee + 3, 0));
    }
    if (live && flag == 2) {
      rf::flush(&lrad, &srad[j]);
      ssample[j] = salloc++;
      rf::regenerate(p, px, ssample[j], &o[j], &d[j], &thr[j], &bounce[j]);
    }
    t_fin[j] = p.t_max;
    tri[j] = -1;
    parked[j] = false;
  }

  // Trace the first in-flight slot until every slot is parked or done.
  while (true) {
    int act = K;
#pragma unroll
    for (int j = K - 1; j >= 0; --j) {
      if (ssample[j] < nf && !parked[j]) act = j;
    }
    if (act == K) break;
    rf::Vec3 ao = o[0], ad = d[0];
#pragma unroll
    for (int j = 1; j < K; ++j) {
      if (act == j) {
        ao = o[j];
        ad = d[j];
      }
    }
    float t;
    const int hit = rf::closest_hit(s, ao, ad, p.t_max, &t);
    if (hit >= 0) {
#pragma unroll
      for (int j = 0; j < K; ++j) {
        if (act == j) {
          t_fin[j] = t;
          tri[j] = hit;
          parked[j] = true;
        }
      }
    } else {
      const rf::Vec3 sky = rf::sky_radiance(p, ad);
      const int new_s = salloc++;
      rf::Vec3 ro = ao, rd = ad, rthr{1.0f, 1.0f, 1.0f};
      int rbounce = 1;
      rf::regenerate(p, px, new_s, &ro, &rd, &rthr, &rbounce);
#pragma unroll
      for (int j = 0; j < K; ++j) {
        if (act == j) {
          rf::fold_sky(sky, thr[j], &srad[j], &lrad);
          ssample[j] = new_s;
          if (new_s < nf) {
            o[j] = ro;
            d[j] = rd;
            thr[j] = rthr;
            bounce[j] = rbounce;
          }
        }
      }
    }
  }

  salloc_out[i] = salloc;
  rf::store3(lrad_out, i, lrad);
#pragma unroll
  for (int j = 0; j < K; ++j) {
    cnt_out[ci + 3 * j] = ssample[j];
    cnt_out[ci + 3 * j + 1] = bounce[j];
    cnt_out[ci + 3 * j + 2] = tri[j];
    rf::store3(ray_out + ri + 6 * j, 0, o[j]);
    rf::store3(ray_out + ri + 6 * j + 3, 0, d[j]);
    rf::store3(thr_out + ri + 6 * j, 0, thr[j]);
    rf::store3(thr_out + ri + 6 * j + 3, 0, srad[j]);
    t_out[static_cast<long long>(K) * i + j] = t_fin[j];
  }
}

}  // namespace

extern "C" int rf_trace_regen_segs(
    const float* aabb_min, const float* aabb_max, const int* tri_offset, const int* tri_count,
    const int* nodes2, const float* tri_pos4, int num_tris, const rf::RegenParams* params,
    int n, int segs,
    const float* u, const float* v_tex, const float* noise_base, const int* salloc,
    const float* lrad, const int* cnt, const float* ray, const float* thr, const float* nee,
    int* salloc_out, float* lrad_out, int* cnt_out, float* ray_out, float* thr_out,
    float* t_out, void* stream) {
  const rf::PackedView s = rf::make_packed(aabb_min, aabb_max, tri_offset, tri_count, nodes2,
                                           tri_pos4, num_tris);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define RF_SEGS_LAUNCH(K)                                                                     \
  trace_regen_segs_kernel<K><<<rf::grid_for(n), rf::kBlock, 0, st>>>(                         \
      s, *params, n, u, v_tex, noise_base, salloc, lrad, cnt, ray, thr, nee, salloc_out,      \
      lrad_out, cnt_out, ray_out, thr_out, t_out)
  switch (segs) {
    case 2: RF_SEGS_LAUNCH(2); break;
    case 3: RF_SEGS_LAUNCH(3); break;
    case 4: RF_SEGS_LAUNCH(4); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef RF_SEGS_LAUNCH
  return static_cast<int>(cudaGetLastError());
}
