// Persistent path kernel (K3): one thread per lane advances the lane to its
// next surface hit, consuming every miss segment on the card.
//
// Replaces pallas_trace_regen (rayfinder_tpu/ops/pallas_regen.py; body
// _make_path_kernel, helpers _sky_rows, _primary_rows, _noise_rows). Per
// lane, in the order of the TPU kernel:
//   1. resolve the pending NEE light sample of the previous segment: the
//      shadow ray is traced (any hit, traverse2.cuh) when flag is 1 or 2 and
//      the contribution is non-zero (otherwise the bound is -inf and it
//      cannot hit, _make_path_kernel :279-284); srad += contrib * visible;
//   2. flag == 2 (depth limit or degenerate scatter): flush srad into lrad,
//      finish the sample, regenerate the pixel's next primary (:394-419);
//   3. loop: trace the ray (closest hit); on a hit stop the lane and return
//      (t, tri) for shading; on a miss add throughput x sky radiance, flush,
//      finish the sample and regenerate its next thin-lens primary from the
//      blue-noise base + R2 offset, until the samples run out (:323-356).
// The sky is _sky_rows with acosf in place of the TPU's acos polynomial.
// Arithmetic follows the plain torch version (rayfinder_tpu_torch/ops/
// regen.py trace_regen_reference) operation by operation; the per-lane
// pieces it shares with K4 and K5 are in path.cuh.
//
// What bounds it: the BVH walks; lanes of one warp also run different
// numbers of miss rounds. The walks read the packed tables (traverse2.cuh):
// two-child 64-byte records and 16-byte triangle rows, each read in one
// round trip of 16-byte loads. That shortened the narrow launches' chain of
// dependent loads, but left the full-width launches' time as it was
// (PERF.md), so what bounds those is not the load chain. Keeping a lane's
// whole miss chain in registers is what this kernel saves over a launch per
// segment. Later changes: warp-coherent traversal, lane sorting, persistent
// work queues.

#include "path.cuh"

namespace {

__global__ void trace_regen_kernel(
    rf::PackedView s, rf::RegenParams p, int n, const float* __restrict__ u_in,
    const float* __restrict__ v_in, const float* __restrict__ noise_base,
    const int* __restrict__ sample_in, const int* __restrict__ bounce_in,
    const int* __restrict__ flag_in, const float* __restrict__ origin_in,
    const float* __restrict__ direction_in, const float* __restrict__ thr_in,
    const float* __restrict__ srad_in, const float* __restrict__ lrad_in,
    const float* __restrict__ shadow_o, const float* __restrict__ shadow_d,
    const float* __restrict__ contrib_in, int* __restrict__ sample_out,
    int* __restrict__ bounce_out, float* __restrict__ origin_out,
    float* __restrict__ direction_out, float* __restrict__ thr_out,
    float* __restrict__ srad_out, float* __restrict__ lrad_out, float* __restrict__ t_out,
    int* __restrict__ tri_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int nf = p.num_frames;
  int sample = sample_in[i];
  int bounce = bounce_in[i];
  const int flag = flag_in[i];
  rf::Vec3 o = rf::load3(origin_in, i);
  rf::Vec3 d = rf::load3(direction_in, i);
  rf::Vec3 thr = rf::load3(thr_in, i);
  rf::Vec3 srad = rf::load3(srad_in, i);
  rf::Vec3 lrad = rf::load3(lrad_in, i);
  const rf::Pixel px{u_in[i], v_in[i], noise_base[2 * i], noise_base[2 * i + 1]};

  // 1. Pending NEE light sample of the previous segment.
  const bool live = sample < nf;
  if (live && (flag == 1 || flag == 2)) {
    srad = rf::add_nee(s, p.t_max, srad, rf::load3(contrib_in, i), rf::load3(shadow_o, i),
                       rf::load3(shadow_d, i));
  }

  // 2. Terminate after NEE: flush, finish the sample, regenerate.
  if (live && flag == 2) {
    rf::flush(&lrad, &srad);
    ++sample;
    rf::regenerate(p, px, sample, &o, &d, &thr, &bounce);
  }

  // 3. Trace to the next hit, consuming misses.
  float t_fin = p.t_max;
  int tri_fin = -1;
  while (sample < nf) {
    float t;
    const int tri = rf::closest_hit(s, o, d, p.t_max, &t);
    if (tri >= 0) {
      t_fin = t;
      tri_fin = tri;
      break;
    }
    rf::fold_sky(rf::sky_radiance(p, d), thr, &srad, &lrad);
    ++sample;
    rf::regenerate(p, px, sample, &o, &d, &thr, &bounce);
  }

  sample_out[i] = sample;
  bounce_out[i] = bounce;
  rf::store3(origin_out, i, o);
  rf::store3(direction_out, i, d);
  rf::store3(thr_out, i, thr);
  rf::store3(srad_out, i, srad);
  rf::store3(lrad_out, i, lrad);
  t_out[i] = t_fin;
  tri_out[i] = tri_fin;
}

}  // namespace

extern "C" int rf_trace_regen(
    const float* aabb_min, const float* aabb_max, const int* tri_offset, const int* tri_count,
    const int* nodes2, const float* tri_pos4, int num_tris, const rf::RegenParams* params, int n,
    const float* u, const float* v_tex, const float* noise_base, const int* sample,
    const int* bounce, const int* flag, const float* origin, const float* direction,
    const float* thr, const float* srad, const float* lrad, const float* shadow_o,
    const float* shadow_d, const float* contrib, int* sample_out, int* bounce_out,
    float* origin_out, float* direction_out, float* thr_out, float* srad_out,
    float* lrad_out, float* t_out, int* tri_out, void* stream) {
  const rf::PackedView s = rf::make_packed(aabb_min, aabb_max, tri_offset, tri_count, nodes2,
                                           tri_pos4, num_tris);
  trace_regen_kernel<<<rf::grid_for(n), rf::kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      s, *params, n, u, v_tex, noise_base, sample, bounce, flag, origin, direction, thr,
      srad, lrad, shadow_o, shadow_d, contrib, sample_out, bounce_out, origin_out,
      direction_out, thr_out, srad_out, lrad_out, t_out, tri_out);
  return static_cast<int>(cudaGetLastError());
}
