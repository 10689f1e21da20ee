// The deferred renderer's passes around the walks K1 and K2: the G-buffer,
// the 2-bounce lighting and the TAA resolve of render/deferred.py, one
// thread per pixel (the resolve one per channel).
//
// Replaces no TPU kernel: the JAX package leaves these passes to XLA, which
// fuses them; the port ran them as ~600 torch operators a frame at 1080p,
// each (B, 3) intermediate through device memory. Here a frame is six small
// kernels between the four walk launches, which stay K1 and K2 on the same
// rays in the same order (ops/deferred.py):
//   gbuffer:  deferred_rays_kernel -> K1 -> deferred_gbuffer_kernel
//   lighting: deferred_light_rays_kernel -> K2 (sun) -> K1 (bounce)
//             -> deferred_bounce_kernel -> K2 (bounce's sun)
//             -> deferred_sample_kernel
//   resolve:  deferred_resolve_kernel
// Rays that a pass drops are traced as torch traces them (G-buffer misses
// from the origin, missed bounces shaded on triangle 0), so the walks see
// the same rays.
//
// What bounds them: bytes. A 1080p frame moves about 0.7 GB through these
// kernels (the planes each kernel reads and writes, plus one 100-byte
// attribute row and one texel per surface, mostly from L2), about 0.2 ms at
// 3.35 TB/s; their arithmetic is a few hundred operations a pixel. So each
// kernel keeps its intermediates in registers and writes only what the
// next launch reads. On an NVIDIA H100 80GB HBM3 (700 W) the six take
// 0.28 ms a 1080p frame, where the torch passes took 10 ms (PERF.md).
//
// Numerics: the output equals the torch passes' on the card bit for bit.
// Every operation is the torch operator's, in float32, rounded on its own
// and in the order torch evaluates it (--fmad=false, no fast-math);
// sinf, cosf, acosf, expf, powf and sqrtf are torch's own functions; a
// division of a tensor by a Python float is a product with its float32
// reciprocal, as torch does it on the card; clamps propagate NaN; the
// visibility multiplies (0 * inf stays NaN). The sky is the
// sky_radiance_dist form with the solar disk (acosf, then cosf of each
// angle), not path.cuh's sky_radiance. The lighting pass offsets the
// G-buffer point with its own constants (1024, 1/16384), the bounce surface
// with the path tracer's (shade.cuh offset_component).
//
// Plain C interface, loaded with ctypes (rayfinder_tpu_torch/ops/
// deferred.py). Launches on the caller's stream; returns
// cudaGetLastError().

#include "shade.cuh"

namespace rf {

// The frame's scalars, passed by value; layout mirrored by ctypes in
// ops/deferred.py.
struct DeferredParams {
  float cam_origin[3];
  float lower_left[3];
  float horizontal[3];
  float vertical[3];
  float jitter[2];  // the frame's R2 jitter minus one half
  float inv_w;      // float32 1 / width
  float inv_h;
  float sun[3];
  float solar[3];  // solar radiance
  float sky_radiance[3];
  float perez[27];  // 3 channels x 9 params
  float one_minus_cos_max;  // float32(1) - float32(cos theta_max of the sun)
  float solar_inv_pdf;
  float frac_1_pi;
  float inv_solar_radius;  // float32 1 / SOLAR_RADIUS_RADIANS
  float exposure;
  int width;
  int noise_frame;  // frame_count mod 2^20 (animatedBlueNoise's period)
  int blend;        // resolve: 0 on frame 0 (the sample is the history)
};

}  // namespace rf

namespace {

using rf::DeferredParams;
using rf::Vec3;

constexpr int kTile = 128;  // the blue-noise tile's side (render/rng.py)
constexpr float kInv255 = 1.0f / 255.0f;

// torch.clamp on a float: NaN passes through.
__device__ __forceinline__ float clamp_nan(float x, float lo, float hi) {
  return x != x ? x : fminf(fmaxf(x, lo), hi);
}

// render/intersect.py offset_ray with the lighting pass's constants
// (deferred_renderer_lighting_pass.wgsl:500-502), one component.
__device__ __forceinline__ float offset_deferred(float p, float n) {
  const int offset = __float2int_rz(1024.0f * n);
  const unsigned bits = static_cast<unsigned>(__float_as_int(p)) +
                        (p < 0.0f ? 0u - static_cast<unsigned>(offset)
                                  : static_cast<unsigned>(offset));
  const float po = __int_as_float(static_cast<int>(bits));
  return fabsf(p) < 1.0f / 32.0f ? p + (1.0f / 16384.0f) * n : po;
}

// Sky radiance WITH the solar disk toward the unit direction d
// (render/deferred.py _sky, sky/model.py sky_radiance).
__device__ Vec3 sky_with_sun(const DeferredParams& p, Vec3 d) {
  const float theta = acosf(clamp_nan(d.y, -1.0f, 1.0f));
  const float gamma =
      acosf(clamp_nan(d.x * p.sun[0] + d.y * p.sun[1] + d.z * p.sun[2], -1.0f, 1.0f));
  const float cos_t = fabsf(cosf(theta));
  const float cos_g = cosf(gamma);
  const float cg2 = cos_g * cos_g;
  const float zenith = sqrtf(cos_t);
  const bool in_disk = gamma * p.inv_solar_radius <= 1.0f;
  float out[3];
  for (int ch = 0; ch < 3; ++ch) {
    const float* c = p.perez + 9 * ch;
    const float exp_m = expf(c[4] * gamma);
    const float mie = (1.0f + cg2) / powf(1.0f + c[8] * c[8] - 2.0f * c[8] * cos_g, 1.5f);
    const float lhs = 1.0f + c[0] * expf(c[1] / (cos_t + 0.01f));
    const float rhs = c[2] + c[3] * exp_m + c[5] * cg2 + c[6] * mie + c[7] * zenith;
    out[ch] = p.sky_radiance[ch] * lhs * rhs + (in_disk ? p.solar[ch] : 0.0f);
  }
  return Vec3{out[0], out[1], out[2]};
}

// A surface met by the ray (o, d) on triangle `tri` (render/shade.py
// _surface_interaction): the interpolated normal (not renormalised), the
// UV and the texture index; *po, when given, the hit point offset along
// the geometric normal.
struct Surface {
  Vec3 n;
  float uvx, uvy;
  int tex;
};

__device__ __forceinline__ Surface surface(const float* a, Vec3 o, Vec3 d, Vec3* po) {
  float t_unused, b1, b2;
  rf::moller_trumbore(a, o, d, 0.0f, &t_unused, &b1, &b2);
  if (po != nullptr) {
    const Vec3 v0{a[0], a[1], a[2]};
    const Vec3 e1 = rf::sub(Vec3{a[3], a[4], a[5]}, v0);
    const Vec3 e2 = rf::sub(Vec3{a[6], a[7], a[8]}, v0);
    const Vec3 pt{v0.x + b1 * e1.x + b2 * e2.x, v0.y + b1 * e1.y + b2 * e2.y,
                  v0.z + b1 * e1.z + b2 * e2.z};
    const Vec3 gn = rf::cross(e1, e2);
    const float norm = sqrtf(rf::dot(gn, gn));
    *po = Vec3{rf::offset_component(pt.x, gn.x / norm), rf::offset_component(pt.y, gn.y / norm),
               rf::offset_component(pt.z, gn.z / norm)};
  }
  const float b0 = 1.0f - b1 - b2;
  return Surface{
      Vec3{b0 * a[9] + b1 * a[12] + b2 * a[15], b0 * a[10] + b1 * a[13] + b2 * a[16],
           b0 * a[11] + b1 * a[14] + b2 * a[17]},
      b0 * a[18] + b1 * a[20] + b2 * a[22], b0 * a[19] + b1 * a[21] + b2 * a[23],
      __float_as_int(a[24])};
}

// solar * (albedo * FRAC_1_PI) * cos_term: the light sample before its
// visibility and 1/pdf (render/deferred.py lighting_pass light_sample).
__device__ __forceinline__ Vec3 unshadowed(const DeferredParams& p, Vec3 alb, float cos_term) {
  return Vec3{(p.solar[0] * (alb.x * p.frac_1_pi)) * cos_term,
              (p.solar[1] * (alb.y * p.frac_1_pi)) * cos_term,
              (p.solar[2] * (alb.z * p.frac_1_pi)) * cos_term};
}

// The jittered pinhole primary of each pixel, row-major (render/deferred.py
// gbuffer_pass, render/camera.py generate_camera_ray).
__global__ void __launch_bounds__(rf::kBlock) deferred_rays_kernel(
    DeferredParams p, int n, float* __restrict__ origin, float* __restrict__ direction) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int y = i / p.width;
  const int x = i - y * p.width;
  const float u = (static_cast<float>(x) + 0.5f + p.jitter[0]) * p.inv_w;
  const float v = 1.0f - (static_cast<float>(y) + 0.5f + p.jitter[1]) * p.inv_h;
  const Vec3 d{p.lower_left[0] + u * p.horizontal[0] + v * p.vertical[0] - p.cam_origin[0],
               p.lower_left[1] + u * p.horizontal[1] + v * p.vertical[1] - p.cam_origin[1],
               p.lower_left[2] + u * p.horizontal[2] + v * p.vertical[2] - p.cam_origin[2]};
  const float norm = sqrtf(d.x * d.x + d.y * d.y + d.z * d.z);
  rf::store3(origin, i, Vec3{p.cam_origin[0], p.cam_origin[1], p.cam_origin[2]});
  rf::store3(direction, i, Vec3{d.x / norm, d.y / norm, d.z / norm});
}

// The G-buffer planes from K1's primaries: the 8-bit albedo (round half to
// even), the interpolated normal, the exact hit point, the depth; zero on a
// miss.
__global__ void __launch_bounds__(rf::kBlock) deferred_gbuffer_kernel(
    rf::ShadeView sh, DeferredParams p, int n, const float* __restrict__ direction,
    const float* __restrict__ t, const int* __restrict__ tri, bool* __restrict__ hit,
    float* __restrict__ position, float* __restrict__ normal, float* __restrict__ albedo,
    float* __restrict__ depth) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int k = tri[i];
  hit[i] = k >= 0;
  if (k < 0) {
    const Vec3 zero{0.0f, 0.0f, 0.0f};
    rf::store3(position, i, zero);
    rf::store3(normal, i, zero);
    rf::store3(albedo, i, zero);
    depth[i] = 0.0f;
    return;
  }
  const Vec3 o{p.cam_origin[0], p.cam_origin[1], p.cam_origin[2]};
  const Vec3 d = rf::load3(direction, i);
  const Surface s = surface(sh.attrs + 25ll * k, o, d, nullptr);
  const Vec3 a = rf::albedo_of(sh, s.tex, s.uvx, s.uvy);
  const float ti = t[i];
  rf::store3(position, i, Vec3{o.x + ti * d.x, o.y + ti * d.y, o.z + ti * d.z});
  rf::store3(normal, i, s.n);
  rf::store3(albedo, i, Vec3{rintf(a.x * 255.0f) * kInv255, rintf(a.y * 255.0f) * kInv255,
                             rintf(a.z * 255.0f) * kInv255});
  depth[i] = ti;
}

// Each pixel's lighting rays from its G-buffer point: the point offset with
// the deferred constants, the direction into the solar cone and the cosine
// bounce direction, both from the pixel's animated blue noise
// (render/rng.py animated_blue_noise, render/sampling.py).
__global__ void __launch_bounds__(rf::kBlock) deferred_light_rays_kernel(
    DeferredParams p, int n, const float* __restrict__ tile, const float* __restrict__ position,
    const float* __restrict__ normal, float* __restrict__ origin, float* __restrict__ light,
    float* __restrict__ bounce) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int y = i / p.width;
  const int x = i - y * p.width;
  const float* base = tile + 2 * ((y % kTile) * kTile + x % kTile);
  const float frame = static_cast<float>(p.noise_frame);
  float rx = rf::kA1 * frame;
  rx = rx - floorf(rx);
  float ry = rf::kA2 * frame;
  ry = ry - floorf(ry);
  float nx = base[0] + rx;
  nx = nx - floorf(nx);
  float ny = base[1] + ry;
  ny = ny - floorf(ny);

  const Vec3 nrm = rf::load3(normal, i);
  const Vec3 pos = rf::load3(position, i);
  rf::store3(origin, i, Vec3{offset_deferred(pos.x, nrm.x), offset_deferred(pos.y, nrm.y),
                             offset_deferred(pos.z, nrm.z)});

  const float phi = rf::kTwoPi * ny;
  const float cos_phi = cosf(phi);
  const float sin_phi = sinf(phi);
  const Vec3 sun{p.sun[0], p.sun[1], p.sun[2]};
  const float ct = 1.0f - nx * p.one_minus_cos_max;
  const float st = sqrtf(1.0f - ct * ct);
  Vec3 su, sv;
  rf::onb(sun, &su, &sv);
  rf::store3(light, i, rf::onb_transform(cos_phi * st, sin_phi * st, ct, su, sv, sun));

  const float st2 = sqrtf(1.0f - nx);
  Vec3 bu, bv;
  rf::onb(nrm, &bu, &bv);
  rf::store3(bounce, i, rf::onb_transform(cos_phi * st2, sin_phi * st2, sqrtf(nx), bu, bv, nrm));
}

// The bounce surface from K1's bounce hits: its offset point (the origin of
// the bounce's sun ray; a missed bounce shaded on triangle 0, as torch does)
// and, for a pixel on a surface, its light sample before visibility on a
// hit or the sky toward the bounce on a miss.
__global__ void __launch_bounds__(rf::kBlock) deferred_bounce_kernel(
    rf::ShadeView sh, DeferredParams p, int n, const bool* __restrict__ hit,
    const float* __restrict__ origin, const float* __restrict__ wi,
    const float* __restrict__ light, const int* __restrict__ tri,
    float* __restrict__ b_origin, float* __restrict__ b_light) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int k = tri[i];
  const Vec3 d = rf::load3(wi, i);
  Vec3 po;
  const Surface s = surface(sh.attrs + 25ll * max(k, 0), rf::load3(origin, i), d, &po);
  rf::store3(b_origin, i, po);
  if (!hit[i]) return;  // the pixel shows the sky
  if (k >= 0) {
    const Vec3 a = rf::albedo_of(sh, s.tex, s.uvx, s.uvy);
    rf::store3(b_light, i, unshadowed(p, a, rf::dot(s.n, rf::load3(light, i))));
  } else {
    rf::store3(b_light, i, sky_with_sun(p, d));
  }
}

// The pixel's lighting sample: the sky with the sun where the G-buffer
// missed, else the light sample plus albedo x (the bounce's light sample or
// its sky).
__global__ void __launch_bounds__(rf::kBlock) deferred_sample_kernel(
    DeferredParams p, int n, const bool* __restrict__ hit, const float* __restrict__ view_dir,
    const float* __restrict__ normal, const float* __restrict__ albedo,
    const float* __restrict__ light, const bool* __restrict__ occluded,
    const int* __restrict__ tri, const bool* __restrict__ b_occluded,
    const float* __restrict__ b_light, float* __restrict__ sample) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  if (!hit[i]) {
    rf::store3(sample, i, sky_with_sun(p, rf::load3(view_dir, i)));
    return;
  }
  const Vec3 alb = rf::load3(albedo, i);
  const float vis = occluded[i] ? 0.0f : 1.0f;
  const Vec3 u = unshadowed(p, alb, rf::dot(rf::load3(normal, i), rf::load3(light, i)));
  const Vec3 rad{(u.x * vis) * p.solar_inv_pdf, (u.y * vis) * p.solar_inv_pdf,
                 (u.z * vis) * p.solar_inv_pdf};
  const Vec3 b = rf::load3(b_light, i);
  Vec3 ind;
  if (tri[i] >= 0) {
    const float b_vis = b_occluded[i] ? 0.0f : 1.0f;
    ind = Vec3{alb.x * ((b.x * b_vis) * p.solar_inv_pdf), alb.y * ((b.y * b_vis) * p.solar_inv_pdf),
               alb.z * ((b.z * b_vis) * p.solar_inv_pdf)};
  } else {
    ind = rf::mul(alb, b);
  }
  rf::store3(sample, i, rf::add(rad, ind));
}

// TAA blend (a copy on frame 0: the sample is the history), exposure, ACES,
// gamma 2.2 and the 8-bit display (render/deferred.py resolve_pass,
// render/tonemap.py), one thread per channel.
__global__ void __launch_bounds__(rf::kBlock) deferred_resolve_kernel(
    DeferredParams p, long long m, const float* __restrict__ sample,
    const float* __restrict__ accum, float* __restrict__ blended,
    unsigned char* __restrict__ display) {
  const long long j = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (j >= m) return;
  float b = sample[j];
  if (p.blend) {
    b = b * 0.1f + accum[j] * 0.9f;
    blended[j] = b;
  }
  const float x = b * p.exposure;
  const float aces = clamp_nan((x * (x * 2.51f + 0.03f)) / (x * (x * 2.43f + 0.59f) + 0.14f),
                               0.0f, 1.0f);
  const float g = powf(aces, static_cast<float>(1.0 / 2.2));
  // torch's float -> uint8 goes through int64.
  display[j] = static_cast<unsigned char>(
      static_cast<long long>(clamp_nan(rintf(g * 255.0f), 0.0f, 255.0f)));
}

int grid(long long m) { return static_cast<int>((m + rf::kBlock - 1) / rf::kBlock); }

rf::ShadeView shade_view(const float* attrs, const int* tex_desc, const int* texels) {
  return rf::ShadeView{attrs, tex_desc, texels};
}

}  // namespace

extern "C" int rf_deferred_rays(const DeferredParams* params, int n, float* origin,
                                float* direction, void* stream) {
  deferred_rays_kernel<<<grid(n), rf::kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      *params, n, origin, direction);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rf_deferred_gbuffer(const float* attrs, const int* tex_desc, const int* texels,
                                   const DeferredParams* params, int n, const float* direction,
                                   const float* t, const int* tri, bool* hit, float* position,
                                   float* normal, float* albedo, float* depth, void* stream) {
  deferred_gbuffer_kernel<<<grid(n), rf::kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      shade_view(attrs, tex_desc, texels), *params, n, direction, t, tri, hit, position, normal,
      albedo, depth);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rf_deferred_light_rays(const DeferredParams* params, int n, const float* tile,
                                      const float* position, const float* normal,
                                      float* origin, float* light, float* bounce, void* stream) {
  deferred_light_rays_kernel<<<grid(n), rf::kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      *params, n, tile, position, normal, origin, light, bounce);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rf_deferred_bounce(const float* attrs, const int* tex_desc, const int* texels,
                                  const DeferredParams* params, int n, const bool* hit,
                                  const float* origin, const float* wi, const float* light,
                                  const int* tri, float* b_origin, float* b_light,
                                  void* stream) {
  deferred_bounce_kernel<<<grid(n), rf::kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      shade_view(attrs, tex_desc, texels), *params, n, hit, origin, wi, light, tri, b_origin,
      b_light);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rf_deferred_sample(const DeferredParams* params, int n, const bool* hit,
                                  const float* view_dir, const float* normal,
                                  const float* albedo, const float* light,
                                  const bool* occluded, const int* tri,
                                  const bool* b_occluded, const float* b_light, float* sample,
                                  void* stream) {
  deferred_sample_kernel<<<grid(n), rf::kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      *params, n, hit, view_dir, normal, albedo, light, occluded, tri, b_occluded, b_light,
      sample);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rf_deferred_resolve(const DeferredParams* params, int n, const float* sample,
                                   const float* accum, float* blended, unsigned char* display,
                                   void* stream) {
  const long long m = 3ll * n;
  deferred_resolve_kernel<<<grid(m), rf::kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      *params, m, sample, accum, blended, display);
  return static_cast<int>(cudaGetLastError());
}
