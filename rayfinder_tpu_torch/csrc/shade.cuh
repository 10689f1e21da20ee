// In-kernel shade of one lane stopped at a surface hit: surface interaction,
// texture albedo, the NEE light sample toward the solar disk and the cosine
// scatter. Device counterpart of render/shade.py _nee_and_continuation,
// following the TPU kernel's _shade_rows (rayfinder_tpu/ops/pallas_regen.py):
//   - (u, v) re-derived by Moller-Trumbore on the hit triangle;
//   - the offset hit point built on the float's bits (_offset_rows);
//   - normal and UV interpolated, not renormalised (wgsl:396);
//   - nearest texel of the fract-wrapped UV from tex_desc/texels, sRGB to
//     linear by powf(x / 255, 2.2) (render/texture_eval.py);
//   - light direction in the solar cone and cosine scatter direction, both
//     through pixar_onb (_onb_rows).
// Every product is rounded on its own, left to right as the torch shade
// writes it, e.g. contrib = (((thr * solar) * brdf) * cos) * inv_pdf. No
// fast-math intrinsics.
//
// The TPU kernel gathered attributes and texels through bf16 splits and
// one-hot matmuls out of VMEM tables; here each thread reads its triangle's
// 25-float row and its texel from global memory (L2 holds the hot rows).

#pragma once

#include "path.cuh"

namespace rf {

// The scene's shading tables (render/scene.py DeviceScene).
struct ShadeView {
  const float* attrs;    // (T, 25): 9 positions, 9 normals, 6 uvs, texture index bits
  const int* tex_desc;   // (K, 3): width, height, offset
  const int* texels;     // (P,): packed BGRA words
};

// pixar_onb (render/sampling.py): the u and v rows of the basis about n.
__device__ __forceinline__ void onb(Vec3 n, Vec3* bu, Vec3* bv) {
  const float s = n.z >= 0.0f ? 1.0f : -1.0f;
  const float a = -1.0f / (s + n.z);
  const float b = n.x * n.y * a;
  *bu = Vec3{1.0f + s * n.x * n.x * a, s * b, -s * n.x};
  *bv = Vec3{b, s + n.y * n.y * a, -n.y};
}

// lx * bu + ly * bv + lz * n (render/sampling.py _onb_transform).
__device__ __forceinline__ Vec3 onb_transform(float lx, float ly, float lz, Vec3 bu, Vec3 bv,
                                              Vec3 n) {
  return Vec3{lx * bu.x + ly * bv.x + lz * n.x, lx * bu.y + ly * bv.y + lz * n.y,
              lx * bu.z + ly * bv.z + lz * n.z};
}

// render/intersect.py offset_ray, one component: an integer offset added
// into the float's bits, a fixed epsilon near the origin.
__device__ __forceinline__ float offset_component(float p, float n) {
  const int offset = static_cast<int>(256.0f * n);
  const unsigned bits = static_cast<unsigned>(__float_as_int(p)) +
                        static_cast<unsigned>(p < 0.0f ? -offset : offset);
  const float po = __int_as_float(static_cast<int>(bits));
  return fabsf(p) < 1.0f / 32.0f ? p + (1.0f / 65536.0f) * n : po;
}

__device__ __forceinline__ bool finite3(Vec3 v) {
  return isfinite(v.x) && isfinite(v.y) && isfinite(v.z);
}

// Linear albedo of the texel under uv (render/texture_eval.py).
__device__ __forceinline__ Vec3 albedo_of(const ShadeView& sh, int tex, float uvx, float uvy) {
  const int w = sh.tex_desc[3 * tex];
  const int h = sh.tex_desc[3 * tex + 1];
  const int off = sh.tex_desc[3 * tex + 2];
  const float uf = uvx - floorf(uvx);
  const float vf = uvy - floorf(uvy);
  // float -> int truncates and saturates, NaN -> 0 (intersect.py to_int32).
  const int j = min(max(static_cast<int>(uf * static_cast<float>(w)), 0), w - 1);
  const int i = min(max(static_cast<int>(vf * static_cast<float>(h)), 0), h - 1);
  const int bgra = sh.texels[off + i * w + j];
  // torch on the GPU divides by a scalar as a product with its reciprocal.
  constexpr float kInv255 = 1.0f / 255.0f;
  return Vec3{powf(static_cast<float>((bgra >> 16) & 0xFF) * kInv255, 2.2f),
              powf(static_cast<float>((bgra >> 8) & 0xFF) * kInv255, 2.2f),
              powf(static_cast<float>(bgra & 0xFF) * kInv255, 2.2f)};
}

// Shade one lane. `hit` lanes stopped at triangle `tri` with ray (o, d);
// the noise is that of `sample`. Every lane gets shadow_d = the light
// direction; a lane that is not a hit gets flag 0, shadow_o parked and a
// zero contribution, and keeps its ray, throughput and bounce. A hit gets
// flag 1 (NEE pending + scatter: o, d, thr, bounce move on) or 2 (NEE
// pending + terminate: depth limit or a non-finite point or direction).
__device__ __forceinline__ void shade(const ShadeView& sh, const RegenParams& p,
                                      const Pixel& px, bool hit, int tri, int sample,
                                      Vec3* o, Vec3* d, Vec3* thr, int* bounce, int* flag,
                                      Vec3* shadow_o, Vec3* shadow_d, Vec3* contrib) {
  float nx, ny;
  noise_of(p, sample, px, &nx, &ny);
  const Vec3 sun{p.sun[0], p.sun[1], p.sun[2]};
  const float phi = kTwoPi * ny;
  const float cos_phi = cosf(phi);
  const float sin_phi = sinf(phi);

  // Light direction in the solar cone (sampling.py direction_in_cone).
  const float ct = 1.0f - nx * p.one_minus_cos_max;
  const float st = sqrtf(1.0f - ct * ct);
  Vec3 su, sv;
  onb(sun, &su, &sv);
  const Vec3 light = onb_transform(cos_phi * st, sin_phi * st, ct, su, sv, sun);
  *shadow_d = light;
  if (!hit) {
    *flag = 0;
    *shadow_o = Vec3{kPark, kPark, kPark};
    *contrib = Vec3{0.0f, 0.0f, 0.0f};
    return;
  }

  // Surface interaction (shade.py _surface_interaction).
  const float* a = sh.attrs + 25ll * tri;
  float t_unused, b1, b2;
  moller_trumbore(a, *o, *d, 0.0f, &t_unused, &b1, &b2);
  const Vec3 v0{a[0], a[1], a[2]};
  const Vec3 e1 = sub(Vec3{a[3], a[4], a[5]}, v0);
  const Vec3 e2 = sub(Vec3{a[6], a[7], a[8]}, v0);
  const Vec3 pt{v0.x + b1 * e1.x + b2 * e2.x, v0.y + b1 * e1.y + b2 * e2.y,
                v0.z + b1 * e1.z + b2 * e2.z};
  const Vec3 gn = cross(e1, e2);
  const float norm = sqrtf(dot(gn, gn));
  const Vec3 po{offset_component(pt.x, gn.x / norm), offset_component(pt.y, gn.y / norm),
                offset_component(pt.z, gn.z / norm)};
  const float b0 = 1.0f - b1 - b2;
  const Vec3 n{b0 * a[9] + b1 * a[12] + b2 * a[15], b0 * a[10] + b1 * a[13] + b2 * a[16],
               b0 * a[11] + b1 * a[14] + b2 * a[17]};
  const float uvx = b0 * a[18] + b1 * a[20] + b2 * a[22];
  const float uvy = b0 * a[19] + b1 * a[21] + b2 * a[23];
  // The texture index is stored as int32 bits in the float row.
  const Vec3 albedo = albedo_of(sh, __float_as_int(a[24]), uvx, uvy);

  // NEE: shadow ray from the offset point, unoccluded contribution.
  const float cos_term = dot(n, light);
  const bool p_ok = finite3(po);
  *shadow_o = p_ok ? po : Vec3{kPark, kPark, kPark};
  const Vec3 t3 = *thr;
  *contrib = Vec3{
      (((t3.x * p.solar[0]) * (albedo.x * p.frac_1_pi)) * cos_term) * p.solar_inv_pdf,
      (((t3.y * p.solar[1]) * (albedo.y * p.frac_1_pi)) * cos_term) * p.solar_inv_pdf,
      (((t3.z * p.solar[2]) * (albedo.z * p.frac_1_pi)) * cos_term) * p.solar_inv_pdf};

  // Scatter: cosine-weighted hemisphere about the shading normal.
  const float st2 = sqrtf(1.0f - nx);
  Vec3 bu, bv;
  onb(n, &bu, &bv);
  const Vec3 wi = onb_transform(cos_phi * st2, sin_phi * st2, sqrtf(nx), bu, bv, n);
  const bool scatter = *bounce < p.num_bounces && finite3(wi) && p_ok;
  *flag = scatter ? 1 : 2;
  if (scatter) {
    *o = po;
    *d = wi;
    *thr = mul(t3, albedo);
    *bounce += 1;
  }
}

}  // namespace rf
