// Per-lane pieces of the path kernels (K3 regen.cu, K4 regen_shaded.cu, K5
// regen_segs.cu) and of the sky-round probe (K8 skyround.cu): the
// camera/sky/loop parameters, the animated blue noise,
// the thin-lens primary ray, the Perez sky, the pending-NEE resolve, and the
// flush of a finished sample. Each is one thread's work on its own lane.
//
// From the TPU kernels' helpers (rayfinder_tpu/ops/pallas_regen.py:
// _noise_rows, _primary_rows, _sky_rows and the NEE/terminate/miss blocks of
// _make_path_kernel). The sky uses acosf in place of the TPU's acos
// polynomial. Arithmetic follows the plain torch versions operation by
// operation (render/rng.py noise_of, render/camera.py primary_ray,
// sky/model.py sky_radiance_dir, ops/regen.py).

#pragma once

#include "traverse.cuh"
#include "traverse2.cuh"

namespace rf {

// Camera, sky and loop scalars; layout mirrored by ctypes in ops/regen.py.
struct RegenParams {
  float cam_origin[3];
  float lower_left[3];
  float horizontal[3];
  float vertical[3];
  float right[3];
  float up[3];
  float lens_radius;
  float t_max;
  float sun[3];
  float sky_radiance[3];
  float perez[27];  // 3 channels x 9 params
  float inv_w;
  float inv_h;
  int frame_base;
  int spp;
  int num_frames;
  // The shade (K4 only).
  float solar[3];           // solar radiance
  float one_minus_cos_max;  // float32(1) - float32(cos theta_max of the sun)
  float solar_inv_pdf;
  float frac_1_pi;
  int num_bounces;
  int live_floor;  // K4: a 128-lane tile stops at this many live lanes
};

// A lane's pixel: centre (u, v_tex) and blue-noise tile value.
struct Pixel {
  float u, v_tex, nb0, nb1;
};

constexpr float kTwoPi = 6.28318548202514648f;  // float32(2 pi)
constexpr float kA1 = 0.754877686500549316f;    // float32 R2 constants
constexpr float kA2 = 0.569840312004089355f;
constexpr float kPark = 1e30f;

__device__ __forceinline__ float clamp_nan(float x, float lo, float hi) {
  return min_nan(max_nan(x, lo), hi);
}

__device__ __forceinline__ Vec3 add(Vec3 a, Vec3 b) {
  return Vec3{a.x + b.x, a.y + b.y, a.z + b.z};
}

__device__ __forceinline__ Vec3 mul(Vec3 a, Vec3 b) {
  return Vec3{a.x * b.x, a.y * b.y, a.z * b.z};
}

// Animated blue noise of a sample (render/rng.py noise_of).
__device__ __forceinline__ void noise_of(const RegenParams& p, int sample, const Pixel& px,
                                         float* nx, float* ny) {
  const float n = static_cast<float>((p.frame_base + sample) % p.spp);
  float rx = kA1 * n;
  rx = rx - floorf(rx);
  float ry = kA2 * n;
  ry = ry - floorf(ry);
  const float x = px.nb0 + rx;
  const float y = px.nb1 + ry;
  *nx = x - floorf(x);
  *ny = y - floorf(y);
}

// Thin-lens primary ray (render/camera.py primary_ray).
__device__ __forceinline__ void primary(const RegenParams& p, const Pixel& px, float nx,
                                        float ny, Vec3* o, Vec3* d) {
  const float ray_u = px.u + nx * p.inv_w;
  const float ray_v = (1.0f - px.v_tex) + ny * p.inv_h;
  const float r = sqrtf(nx);
  const float theta = kTwoPi * ny;
  const float lp0 = p.lens_radius * (r * cosf(theta));
  const float lp1 = p.lens_radius * (r * sinf(theta));
  const Vec3 org{p.cam_origin[0] + (lp0 * p.right[0] + lp1 * p.up[0]),
                 p.cam_origin[1] + (lp0 * p.right[1] + lp1 * p.up[1]),
                 p.cam_origin[2] + (lp0 * p.right[2] + lp1 * p.up[2])};
  const Vec3 dd{p.lower_left[0] + ray_u * p.horizontal[0] + ray_v * p.vertical[0] - org.x,
                p.lower_left[1] + ray_u * p.horizontal[1] + ray_v * p.vertical[1] - org.y,
                p.lower_left[2] + ray_u * p.horizontal[2] + ray_v * p.vertical[2] - org.z};
  const float norm = sqrtf(dd.x * dd.x + dd.y * dd.y + dd.z * dd.z);
  *o = org;
  *d = Vec3{dd.x / norm, dd.y / norm, dd.z / norm};
}

// Start sample `sample` of the pixel if the lane has samples left: a fresh
// primary, unit throughput, bounce 1.
__device__ __forceinline__ void regenerate(const RegenParams& p, const Pixel& px, int sample,
                                           Vec3* o, Vec3* d, Vec3* thr, int* bounce) {
  if (sample < p.num_frames) {
    float nx, ny;
    noise_of(p, sample, px, &nx, &ny);
    primary(p, px, nx, ny, o, d);
    *thr = Vec3{1.0f, 1.0f, 1.0f};
    *bounce = 1;
  }
}

// Perez sky radiance without the solar disk (sky/model.py sky_radiance_dir).
__device__ __forceinline__ Vec3 sky_radiance(const RegenParams& p, Vec3 d) {
  const float cos_g = clamp_nan(d.x * p.sun[0] + d.y * p.sun[1] + d.z * p.sun[2], -1.0f, 1.0f);
  const float cos_t = fabsf(clamp_nan(d.y, -1.0f, 1.0f));
  const float gamma = acosf(cos_g);
  const float cg2 = cos_g * cos_g;
  const float zenith = sqrtf(cos_t);
  float out[3];
  for (int ch = 0; ch < 3; ++ch) {
    const float* c = p.perez + 9 * ch;
    const float exp_m = expf(c[4] * gamma);
    const float mie = (1.0f + cg2) / powf(1.0f + c[8] * c[8] - 2.0f * c[8] * cos_g, 1.5f);
    const float lhs = 1.0f + c[0] * expf(c[1] / (cos_t + 0.01f));
    const float rhs = c[2] + c[3] * exp_m + c[5] * cg2 + c[6] * mie + c[7] * zenith;
    out[ch] = p.sky_radiance[ch] * lhs * rhs;
  }
  return Vec3{out[0], out[1], out[2]};
}

// Pending NEE light sample of the previous segment: the shadow ray is traced
// only where the contribution is non-zero (the TPU kernels give the others
// a -inf bound, which cannot hit); returns srad + contrib * visible. View is
// the packed walk's PackedView (K3, K5) or SharedStackView (K4's work
// items).
template <class View>
__device__ __forceinline__ Vec3 add_nee(const View& s, float t_max, Vec3 srad, Vec3 c,
                                        Vec3 shadow_o, Vec3 shadow_d) {
  float vis = 1.0f;
  if (c.x != 0.0f || c.y != 0.0f || c.z != 0.0f) {
    if (any_hit(s, shadow_o, shadow_d, t_max)) vis = 0.0f;
  }
  return Vec3{srad.x + c.x * vis, srad.y + c.y * vis, srad.z + c.z * vis};
}

// Flush a finished sample's radiance into the lane's.
__device__ __forceinline__ void flush(Vec3* lrad, Vec3* srad) {
  *lrad = add(*lrad, *srad);
  *srad = Vec3{0.0f, 0.0f, 0.0f};
}

// A miss: add throughput x sky radiance to the sample, then flush it.
__device__ __forceinline__ void fold_sky(Vec3 sky, Vec3 thr, Vec3* srad, Vec3* lrad) {
  *srad = add(*srad, mul(thr, sky));
  flush(lrad, srad);
}

}  // namespace rf
