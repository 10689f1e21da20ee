// Persistent path kernel with in-kernel shading (K4): each 128-lane block
// runs the whole path loop -- NEE resolve, terminate, trace, sky, shade,
// scatter, regenerate -- until its live-lane count falls to a floor.
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
// The rounds repeat while more than live_floor lanes of the block have
// samples left. The block is the TPU kernel's 128-lane ray tile, so the
// floor is counted per tile exactly as there; the count is one
// __syncthreads_count per round, and every thread of the block (those past
// n included, which hold no lane and vote 0) reaches it.
//
// What bounds it: the two BVH walks per round (traverse.cuh) and the
// block-wide barrier, which holds a block's finished lanes until its slowest
// lane ends its round. The global-memory gathers of the triangle row and the
// texel replace the TPU kernel's VMEM tables and one-hot matmuls. A
// warp-level exit and per-warp work refill are later speed work.

#include "shade.cuh"

namespace {

static_assert(rf::kBlock == 128, "K4's live floor is counted per 128-lane tile");

__global__ void __launch_bounds__(rf::kBlock) trace_regen_shaded_kernel(
    rf::SceneView s, rf::ShadeView sh, rf::RegenParams p, int n, const float* __restrict__ u_in,
    const float* __restrict__ v_in, const float* __restrict__ noise_base,
    const int* __restrict__ sample_in, const int* __restrict__ bounce_in,
    const int* __restrict__ flag_in, const float* __restrict__ origin_in,
    const float* __restrict__ direction_in, const float* __restrict__ thr_in,
    const float* __restrict__ srad_in, const float* __restrict__ lrad_in,
    const float* __restrict__ shadow_o_in, const float* __restrict__ shadow_d_in,
    const float* __restrict__ contrib_in, int* __restrict__ sample_out,
    int* __restrict__ bounce_out, int* __restrict__ flag_out, float* __restrict__ origin_out,
    float* __restrict__ direction_out, float* __restrict__ thr_out,
    float* __restrict__ srad_out, float* __restrict__ lrad_out,
    float* __restrict__ shadow_o_out, float* __restrict__ shadow_d_out,
    float* __restrict__ contrib_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool lane = i < n;
  const int nf = p.num_frames;
  // A thread past n holds a dead lane: it never traces and reads nothing.
  int sample = nf, bounce = 1, flag = 0;
  rf::Vec3 o{0.0f, 0.0f, 0.0f}, d{1.0f, 0.0f, 0.0f}, thr{0.0f, 0.0f, 0.0f};
  rf::Vec3 srad{0.0f, 0.0f, 0.0f}, lrad{0.0f, 0.0f, 0.0f};
  rf::Vec3 shadow_o{rf::kPark, rf::kPark, rf::kPark}, shadow_d{1.0f, 0.0f, 0.0f};
  rf::Vec3 contrib{0.0f, 0.0f, 0.0f};
  rf::Pixel px{0.5f, 0.5f, 0.0f, 0.0f};
  if (lane) {
    sample = min(sample_in[i], nf);
    bounce = bounce_in[i];
    flag = flag_in[i];
    o = rf::load3(origin_in, i);
    d = rf::load3(direction_in, i);
    thr = rf::load3(thr_in, i);
    srad = rf::load3(srad_in, i);
    lrad = rf::load3(lrad_in, i);
    shadow_o = rf::load3(shadow_o_in, i);
    shadow_d = rf::load3(shadow_d_in, i);
    contrib = rf::load3(contrib_in, i);
    px = rf::Pixel{u_in[i], v_in[i], noise_base[2 * i], noise_base[2 * i + 1]};
  }

  while (__syncthreads_count(sample < nf) > p.live_floor) {
    // 1. Pending NEE light sample of the previous segment.
    const bool live = sample < nf;
    if (live && flag > 0) srad = rf::add_nee(s, p.t_max, srad, contrib, shadow_o, shadow_d);

    // 2. Terminate after NEE: flush, finish the sample, regenerate.
    if (live && flag == 2) {
      rf::flush(&lrad, &srad);
      ++sample;
      rf::regenerate(p, px, sample, &o, &d, &thr, &bounce);
    }

    // 3. One closest segment; a miss folds the sky and starts the next sample.
    int tri = -1;
    if (sample < nf) {
      float t;
      tri = rf::closest_hit(s, o, d, p.t_max, &t, nullptr);
      if (tri < 0) {
        rf::fold_sky(rf::sky_radiance(p, d), thr, &srad, &lrad);
        ++sample;
        rf::regenerate(p, px, sample, &o, &d, &thr, &bounce);
      }
    }

    // 4. Shade (hit lanes prepare NEE + scatter; the rest reset the NEE).
    rf::shade(sh, p, px, tri >= 0, tri, sample, &o, &d, &thr, &bounce, &flag, &shadow_o,
              &shadow_d, &contrib);
  }

  if (lane) {
    sample_out[i] = sample;
    bounce_out[i] = bounce;
    flag_out[i] = flag;
    rf::store3(origin_out, i, o);
    rf::store3(direction_out, i, d);
    rf::store3(thr_out, i, thr);
    rf::store3(srad_out, i, srad);
    rf::store3(lrad_out, i, lrad);
    rf::store3(shadow_o_out, i, shadow_o);
    rf::store3(shadow_d_out, i, shadow_d);
    rf::store3(contrib_out, i, contrib);
  }
}

}  // namespace

extern "C" int rf_trace_regen_shaded(
    const float* aabb_min, const float* aabb_max, const int* tri_offset,
    const int* second_child, const int* tri_count, const int* split_axis,
    const float* tri_pos, int num_tris, const float* attrs, const int* tex_desc,
    const int* texels, const rf::RegenParams* params, int n, const float* u,
    const float* v_tex, const float* noise_base, const int* sample, const int* bounce,
    const int* flag, const float* origin, const float* direction, const float* thr,
    const float* srad, const float* lrad, const float* shadow_o, const float* shadow_d,
    const float* contrib, int* sample_out, int* bounce_out, int* flag_out, float* origin_out,
    float* direction_out, float* thr_out, float* srad_out, float* lrad_out,
    float* shadow_o_out, float* shadow_d_out, float* contrib_out, void* stream) {
  const rf::SceneView s = rf::make_scene(aabb_min, aabb_max, tri_offset, second_child,
                                         tri_count, split_axis, tri_pos, num_tris);
  const rf::ShadeView sh{attrs, tex_desc, texels};
  trace_regen_shaded_kernel<<<rf::grid_for(n), rf::kBlock, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      s, sh, *params, n, u, v_tex, noise_base, sample, bounce, flag, origin, direction, thr,
      srad, lrad, shadow_o, shadow_d, contrib, sample_out, bounce_out, flag_out, origin_out,
      direction_out, thr_out, srad_out, lrad_out, shadow_o_out, shadow_d_out, contrib_out);
  return static_cast<int>(cudaGetLastError());
}
