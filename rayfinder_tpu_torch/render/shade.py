"""Shade step of the fused loop: surface interaction, texture albedo, the
NEE light sample toward the solar disk and the cosine scatter, for lanes
stopped at a surface hit.

Counterpart of `rayfinder_tpu.render.pathtracer` `_surface_interaction` and
`_nee_and_continuation` (the XLA shade of the split loop). The plain
versions of the path kernels (ops/regen_shaded.py, ops/regen_segs.py) and the
regen loop (render/pathtracer.py) both use it; the in-kernel shade of
csrc/shade.cuh follows it operation by operation.
"""

from __future__ import annotations

import numpy as np
import torch

from .intersect import cross, dot, offset_ray, ray_triangle
from .sampling import sample_cosine_hemisphere, sample_solar_disk_direction
from .scene import DeviceScene
from .texture_eval import eval_texture

# wgsl:79-83
TERRESTRIAL_SOLAR_RADIUS = np.float32(0.255 * np.pi / 180.0)
SOLAR_COS_THETA_MAX = np.float32(np.cos(TERRESTRIAL_SOLAR_RADIUS))
SOLAR_INV_PDF = np.float32(2.0 * np.pi * (1.0 - SOLAR_COS_THETA_MAX))
FRAC_1_PI = np.float32(1.0 / np.pi)

# Lanes whose path has ended are parked far outside the scene.
PARK = 1e30


def _surface_interaction(scene: DeviceScene, origin, direction, tri_idx):
    """The reference's intersection data for known hit triangles: offset hit
    point (geometric normal), interpolated shading normal, UV and texture
    index (wgsl:383-401, 477-521). One (B, 25) row gather per lane."""
    attrs = scene.tri_attrs[tri_idx.long()]
    v0, v1, v2 = attrs[:, 0:3], attrs[:, 3:6], attrs[:, 6:9]
    _, _, u, v = ray_triangle(origin, direction, v0, v1, v2, float("inf"))

    e1 = v1 - v0
    e2 = v2 - v0
    b1 = u[:, None]
    b2 = v[:, None]
    p = v0 + b1 * e1 + b2 * e2
    geo_n = cross(e1, e2)
    geo_n = geo_n / torch.sqrt(dot(geo_n, geo_n))[:, None]
    p_offset = offset_ray(p, geo_n)

    b0 = 1.0 - b1 - b2
    # Interpolated shading normal; NOT renormalized, matching wgsl:396.
    n = b0 * attrs[:, 9:12] + b1 * attrs[:, 12:15] + b2 * attrs[:, 15:18]
    uv = b0 * attrs[:, 18:20] + b1 * attrs[:, 20:22] + b2 * attrs[:, 22:24]
    tex = attrs[:, 24].contiguous().view(torch.int32)
    return p_offset, n, uv, tex


def _nee_and_continuation(
    scene, noise, origin, direction, tri, thr, bounce, live,
    sun_dir, solar_radiance, num_bounces,
):
    """Shade step of the fused loop: for lanes stopped at a surface hit,
    prepare the NEE light sample (shadow ray + unoccluded contribution) and
    the scatter continuation; the next kernel call applies them.

    Returns (flag, origin, direction, thr, bounce, shadow_o, shadow_d,
    contrib); flag 1 = NEE pending + scatter continuation, 2 = NEE pending
    + terminate, 0 = no hit."""
    hit = live & (tri >= 0)
    p, n, uv, tex = _surface_interaction(scene, origin, direction, tri.clamp(min=0))
    albedo = eval_texture(scene, tex, uv)
    light_dir = sample_solar_disk_direction(noise, SOLAR_COS_THETA_MAX, sun_dir)
    brdf = albedo * float(FRAC_1_PI)
    # No clamp on the cosine -- parity with wgsl:201.
    cos_term = dot(n, light_dir)[:, None]
    p_ok = torch.isfinite(p).all(dim=1)
    shadow_o = torch.where((hit & p_ok)[:, None], p, PARK)
    contrib = thr * solar_radiance * brdf * cos_term * float(SOLAR_INV_PDF)
    contrib = torch.where(hit[:, None], contrib, 0.0)

    wi = sample_cosine_hemisphere(noise, n)
    ray_ok = torch.isfinite(wi).all(dim=1) & p_ok
    scatter = hit & (bounce < num_bounces) & ray_ok
    flag = torch.where(hit, torch.where(scatter, 1, 2), 0).to(torch.int32)
    s3 = scatter[:, None]
    origin = torch.where(s3, p, origin)
    direction = torch.where(s3, wi, direction)
    thr = torch.where(s3, thr * albedo, thr)
    bounce = torch.where(scatter, bounce + 1, bounce)
    return flag, origin, direction, thr, bounce, shadow_o, light_dir, contrib
