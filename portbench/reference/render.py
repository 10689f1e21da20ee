"""The renderers' arithmetic, pixel sample by pixel sample, in plain torch.

Written from the reference renderer's shaders (reference_path_tracer.wgsl,
deferred_renderer_*.wgsl) in the operation order the program documents, so
that where both find the same surfaces the two agree to the last bit or
nearly; over the reference's own BVH (bvh.py). Every function takes the
pixels (ys, xs) and the frame index of each sample, one entry per pixel
sample, so that a caller evaluates any sample of the window's frames.

`dtype` is the precision of the arithmetic: float32, or a lower one for the
control (the same code in bfloat16). Integer bit operations (the ray offset,
texel unpacking) are done in float32 and int32 whatever the dtype.
"""

from __future__ import annotations

import math
import pathlib
from typing import NamedTuple

import numpy as np
import torch

from . import bvh as bvh_mod
from .sky import SkyState, radiance_path, radiance_with_sun

T_MAX = 1e4
PARK = 1e30
TWO_PI = float(np.float32(2.0 * np.pi))
SOLAR_RADIUS = np.float32(0.255 * np.pi / 180.0)
SOLAR_COS_THETA_MAX = np.float32(np.cos(SOLAR_RADIUS))
SOLAR_INV_PDF = float(np.float32(2.0 * np.pi * (1.0 - SOLAR_COS_THETA_MAX)))
FRAC_1_PI = float(np.float32(1.0 / np.pi))
R2_A1 = float(np.float32(0.7548776662466927))
R2_A2 = float(np.float32(0.5698402909980532))
# The deferred renderer's own constants.
DEFERRED_PERIOD = 1 << 20
DEFERRED_INT_SCALE = 1024.0
DEFERRED_FLOAT_SCALE = 1.0 / 16384.0
JITTER_A1 = np.float32(1.0 / 1.32471795)
JITTER_A2 = np.float32(1.0 / (1.32471795**2))

_NOISE = pathlib.Path(__file__).resolve().parent / "data" / "blue_noise.npz"


def blue_noise_tile() -> np.ndarray:
    """(128, 128, 2) float32 in [0, 1]: the published 8-bit tile over 255."""
    with np.load(_NOISE) as data:
        return (data["tile"].astype(np.float32) / np.float32(255.0)).astype(np.float32)


class Scene(NamedTuple):
    bvh: bvh_mod.Bvh
    attrs: torch.Tensor  # (T, 24): positions, normals, uvs, by original index
    tex: torch.Tensor  # (T,) int64 texture of each triangle
    desc: torch.Tensor  # (K, 3) int64 width, height, offset
    texels: torch.Tensor  # (N,) int64 BGRA words
    tile: torch.Tensor  # (128, 128, 2) blue noise


def make_scene(scene, device, dtype=torch.float32, build_tree=bvh_mod.build) -> Scene:
    """The reference scene from the benchmark's triangles and textures
    (scenes/*.py Scene): its own BVH (`build_tree` builds it: the median-split
    tree, or sah.tree where a tool counts the work on a SAH tree), the
    shading rows, the texel atlas."""
    pos = torch.from_numpy(np.ascontiguousarray(scene.positions, np.float32)).to(device)
    t = pos.shape[0]
    attrs = torch.cat([
        pos.reshape(t, 9),
        torch.from_numpy(np.ascontiguousarray(scene.normals, np.float32)).to(device).reshape(t, 9),
        torch.from_numpy(np.ascontiguousarray(scene.tex_coords, np.float32)).to(device).reshape(t, 6),
    ], dim=1)
    widths = [int(x.width) for x in scene.textures]
    heights = [int(x.height) for x in scene.textures]
    sizes = [w * h for w, h in zip(widths, heights)]
    offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64)
    desc = torch.tensor(np.stack([widths, heights, offsets], 1), dtype=torch.long, device=device)
    texels = torch.from_numpy(np.concatenate(
        [np.asarray(x.pixels, np.uint32) for x in scene.textures]).astype(np.int64)).to(device)
    tree = build_tree(pos)
    if dtype != torch.float32:
        tree = bvh_mod.cast(tree, dtype)
    return Scene(tree, attrs.to(dtype),
                 torch.from_numpy(np.asarray(scene.texture_indices).astype(np.int64)).to(device),
                 desc, texels, torch.from_numpy(blue_noise_tile()).to(device))


class Camera(NamedTuple):
    origin: np.ndarray
    lower_left: np.ndarray
    horizontal: np.ndarray
    vertical: np.ndarray
    up: np.ndarray
    right: np.ndarray
    lens_radius: float


def camera(eye, look_at, aperture, focus_distance, vfov_degrees, aspect) -> Camera:
    """camera.cpp:7-42, in float32."""
    origin = np.asarray(eye, np.float32)
    look_at = np.asarray(look_at, np.float32)
    half_height = np.float32(focus_distance * math.tan(0.5 * math.radians(vfov_degrees)))
    half_width = np.float32(aspect) * half_height
    forward = look_at - origin
    forward = forward / np.linalg.norm(forward)
    right = np.cross(forward, np.array([0.0, 1.0, 0.0], np.float32))
    right = (right / np.linalg.norm(right)).astype(np.float32)
    up = np.cross(right, forward).astype(np.float32)
    lower_left = origin - half_width * right - half_height * up + np.float32(focus_distance) * forward
    return Camera(origin, lower_left.astype(np.float32),
                  (2.0 * half_width * right).astype(np.float32),
                  (2.0 * half_height * up).astype(np.float32), up, right,
                  float(np.float32(0.5 * aperture)))


def camera_rows(cams: list[Camera], index, device) -> Camera:
    """One camera per pixel sample: the fields of cams[index[i]] as (R, 3)
    tensors (lens radius (R, 1)), for the functions below."""
    def field(k):
        table = torch.from_numpy(np.stack([np.asarray(c[k], np.float32).reshape(-1)
                                           for c in cams])).to(device)
        return table[index]
    return Camera(*(field(k) for k in range(7)))


def _vec(a, ref):
    if isinstance(a, torch.Tensor):
        return a.to(ref.dtype)
    return torch.as_tensor(np.asarray(a, np.float32), device=ref.device).to(ref.dtype)


def _dot(a, b):
    p0, p1, p2 = (a * b).unbind(-1)
    return p0 + p1 + p2


def _to_int32(x):
    x = torch.where(torch.isnan(x), 0.0, x)
    i = x.clamp(-2147483648.0, 2147483520.0).to(torch.int32)
    return torch.where(x >= 2147483648.0, 2147483647, i)


def offset_ray(p, n, int_scale=256.0, float_scale=1.0 / 65536.0):
    """Integer-mantissa offset along n (ray_intersection.cpp:17-35), in
    float32 bits."""
    dt = p.dtype
    p, n = p.float(), n.float()
    offset = _to_int32(int_scale * n)
    bits = p.view(torch.int32) + torch.where(p < 0, -offset, offset)
    out = torch.where(torch.abs(p) < 1.0 / 32.0, p + float_scale * n, bits.view(torch.float32))
    return out.to(dt)


def _noise(tile, ys, xs, frames, period):
    """animatedBlueNoise: the tile's value plus the R2 offset of frame mod
    period, wrapped to [0, 1)."""
    base = tile[(ys % tile.shape[0]).long(), (xs % tile.shape[1]).long()]
    n = torch.remainder(frames, period).to(torch.float32)
    r2 = torch.stack([R2_A1 * n, R2_A2 * n], dim=-1)
    r2 = r2 - torch.floor(r2)
    out = base + r2
    return out - torch.floor(out)


def _onb(n):
    one = torch.ones_like(n[..., 2])
    s = torch.where(n[..., 2] >= 0.0, one, -one)
    a = -1.0 / (s + n[..., 2])
    b = n[..., 0] * n[..., 1] * a
    u = torch.stack([1.0 + s * n[..., 0] * n[..., 0] * a, s * b, -s * n[..., 0]], dim=-1)
    v = torch.stack([b, s + n[..., 1] * n[..., 1] * a, -n[..., 1]], dim=-1)
    return u, v, n


def _to_world(basis, local):
    u, v, n = basis
    return local[..., 0:1] * u + local[..., 1:2] * v + local[..., 2:3] * n


def _solar_dir(noise, sun):
    cos_theta = 1.0 - noise[:, 0] * float(np.float32(1.0) - SOLAR_COS_THETA_MAX)
    sin_theta = torch.sqrt(1.0 - cos_theta * cos_theta)
    phi = TWO_PI * noise[:, 1]
    local = torch.stack([torch.cos(phi) * sin_theta, torch.sin(phi) * sin_theta, cos_theta], -1)
    return _to_world(tuple(b.expand_as(local) for b in _onb(sun)), local)


def _cosine_dir(noise, n):
    phi = TWO_PI * noise[:, 1]
    sin_theta = torch.sqrt(1.0 - noise[:, 0])
    local = torch.stack([torch.cos(phi) * sin_theta, torch.sin(phi) * sin_theta,
                         torch.sqrt(noise[:, 0])], -1)
    return _to_world(_onb(n), local)


def _surface(scene: Scene, origin, direction, tri):
    """Offset hit point, interpolated normal, uv, texture (wgsl:383-401)."""
    a = scene.attrs[tri]
    v0, v1, v2 = a[:, 0:3], a[:, 3:6], a[:, 6:9]
    _, _, u, v = bvh_mod.ray_triangle(origin, direction, v0, v1, v2, float("inf"))
    e1 = v1 - v0
    e2 = v2 - v0
    b1, b2 = u[:, None], v[:, None]
    p = v0 + b1 * e1 + b2 * e2
    geo = bvh_mod._cross(e1, e2)
    geo = geo / torch.sqrt(_dot(geo, geo))[:, None]
    b0 = 1.0 - b1 - b2
    n = b0 * a[:, 9:12] + b1 * a[:, 12:15] + b2 * a[:, 15:18]
    uv = b0 * a[:, 18:20] + b1 * a[:, 20:22] + b2 * a[:, 22:24]
    return offset_ray(p, geo), n, uv, scene.tex[tri]


def _albedo(scene: Scene, tex, uv):
    """Nearest texel, fract-wrapped, BGRA unpacked, sRGB^2.2 (wgsl:546-565)."""
    d = scene.desc[tex]
    w, h, off = d[:, 0], d[:, 1], d[:, 2]
    uvf = uv.float()
    u = uvf[:, 0] - torch.floor(uvf[:, 0])
    v = uvf[:, 1] - torch.floor(uvf[:, 1])
    j = torch.minimum(torch.clamp(_to_int32(u * w.float()).long(), min=0), w - 1)
    i = torch.minimum(torch.clamp(_to_int32(v * h.float()).long(), min=0), h - 1)
    word = scene.texels[off + i * w + j]
    rgb = torch.stack([(word >> 16) & 0xFF, (word >> 8) & 0xFF, word & 0xFF], dim=-1)
    return torch.pow((rgb.float() / 255.0).to(uv.dtype), 2.2)


def _closest(scene, o, d, counter):
    hit, t, tri, slabs, tests = bvh_mod.walk(scene.bvh, o, d, T_MAX, False, counts=True)
    counter["closest"] += o.shape[0]
    counter["closest_hits"] += int(hit.sum())
    counter["closest_slabs"] += slabs
    counter["closest_tests"] += tests
    return hit, t.to(o.dtype), tri


def _occluded(scene, o, d, counter):
    hit, _, _, slabs, tests = bvh_mod.walk(scene.bvh, o, d, T_MAX, True, counts=True)
    counter["shadow"] += o.shape[0]
    counter["shadow_slabs"] += slabs
    counter["shadow_tests"] += tests
    return hit


def new_counter() -> dict:
    """The reference's own walk work: rays and their slab and triangle tests."""
    return dict.fromkeys(("closest", "closest_hits", "closest_slabs", "closest_tests", "shadow",
                          "shadow_slabs", "shadow_tests"), 0)


def pt_samples(scene: Scene, sky: SkyState, cam: Camera, ys, xs, frames, *, width, height,
               spp, bounces, counter=None):
    """The radiance (R, 3) of R pixel samples of the progressive path
    tracer: pixel (ys, xs), sample of frame index `frames` (R,) int64,
    image width x height, noise period spp (fsMain and rayColor,
    wgsl:34-64, 180-234, with the sun by next-event estimation)."""
    counter = new_counter() if counter is None else counter
    dt = scene.attrs.dtype
    dev = ys.device
    noise = _noise(scene.tile, ys, xs, frames, spp).to(dt)
    u = ((xs.float() + 0.5) / float(width)).to(dt)
    v_tex = ((ys.float() + 0.5) / float(height)).to(dt)
    inv_w = float(np.float32(1.0) / np.float32(width))
    inv_h = float(np.float32(1.0) / np.float32(height))
    ray_u = u + noise[:, 0] * inv_w
    ray_v = (1.0 - v_tex) + noise[:, 1] * inv_h
    r = torch.sqrt(noise[:, 0])
    theta = TWO_PI * noise[:, 1]
    ref = noise
    lens = _vec(cam.lens_radius, ref) * torch.stack([r * torch.cos(theta), r * torch.sin(theta)], -1)
    origin = _vec(cam.origin, ref) + (lens[:, 0:1] * _vec(cam.right, ref)
                                      + lens[:, 1:2] * _vec(cam.up, ref))
    d = (_vec(cam.lower_left, ref) + ray_u[:, None] * _vec(cam.horizontal, ref)
         + ray_v[:, None] * _vec(cam.vertical, ref) - origin)
    direction = d / torch.sqrt(d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2])[:, None]

    n_rays = ys.shape[0]
    srad = torch.zeros(n_rays, 3, dtype=dt, device=dev)
    thr = torch.ones(n_rays, 3, dtype=dt, device=dev)
    sun = _vec(sky.sun_direction, ref)
    solar = _vec(sky.solar_radiances, ref)
    light = _solar_dir(noise, sun)
    live = torch.arange(n_rays, device=dev)
    for bounce in range(1, bounces + 1):
        o, dd = origin[live], direction[live]
        hit, _, tri = _closest(scene, o, dd, counter)
        miss = live[~hit]
        srad[miss] = srad[miss] + thr[miss] * radiance_path(sky, direction[miss])
        live, o, dd, tri = live[hit], o[hit], dd[hit], tri[hit]
        p, n, uv, tex = _surface(scene, o, dd, tri)
        albedo = _albedo(scene, tex, uv)
        ld = light[live]
        cos_term = _dot(n, ld)[:, None]
        contrib = thr[live] * solar * (albedo * FRAC_1_PI) * cos_term * SOLAR_INV_PDF
        p_ok = torch.isfinite(p).all(dim=1)
        traced = (contrib != 0.0).any(dim=1)
        occluded = torch.zeros_like(traced)
        occluded[traced] = _occluded(scene, torch.where(p_ok[:, None], p, PARK)[traced],
                                     ld[traced], counter)
        visible = torch.where(occluded, 0.0, 1.0).to(dt)[:, None]
        srad[live] = srad[live] + contrib * visible
        wi = _cosine_dir(noise[live], n)
        go = torch.isfinite(wi).all(dim=1) & p_ok
        if bounce == bounces:
            break
        thr[live] = torch.where(go[:, None], thr[live] * albedo, thr[live])
        origin[live], direction[live] = p, wi
        live = live[go]
    return srad


def deferred_samples(scene: Scene, sky: SkyState, cam: Camera, ys, xs, frames, *, width, height,
                     counter=None):
    """The lighting pass's radiance (R, 3) of R pixel samples of the
    deferred renderer at frame indices `frames`: the G-buffer of a jittered
    primary ray, an NEE sample toward the sun and one cosine bounce with its
    own NEE sample, the sky with the solar disk at a miss
    (deferred_renderer_{gbuffer,lighting}_pass.wgsl)."""
    counter = new_counter() if counter is None else counter
    dt = scene.attrs.dtype
    n_rays = ys.shape[0]
    fr = frames.cpu().numpy()
    n = (fr % DEFERRED_PERIOD).astype(np.float32)
    half, one = np.float32(0.5), np.float32(1.0)
    jx = (np.remainder(half + JITTER_A1 * n, one) - half).astype(np.float32)
    jy = (np.remainder(half + JITTER_A2 * n, one) - half).astype(np.float32)
    jx = torch.from_numpy(jx).to(ys.device)
    jy = torch.from_numpy(jy).to(ys.device)
    rw = float(np.float32(1.0) / np.float32(width))
    rh = float(np.float32(1.0) / np.float32(height))
    u = ((xs.float() + 0.5 + jx) * rw).to(dt)
    v = (1.0 - (ys.float() + 0.5 + jy) * rh).to(dt)
    ref = u
    origin = _vec(cam.origin, ref).expand(n_rays, 3).contiguous()
    d = (_vec(cam.lower_left, ref) + u[:, None] * _vec(cam.horizontal, ref)
         + v[:, None] * _vec(cam.vertical, ref) - _vec(cam.origin, ref))
    direction = d / torch.sqrt(d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2])[:, None]

    hit, t, tri = _closest(scene, origin, direction, counter)
    _, normal, uv, tex = _surface(scene, origin, direction, tri.clamp(min=0))
    albedo = torch.round(_albedo(scene, tex, uv) * 255.0) * float(np.float32(1.0) / np.float32(255))
    position = origin + t[:, None] * direction
    h3 = hit[:, None]
    position = torch.where(h3, position, 0.0)
    normal = torch.where(h3, normal, 0.0)
    albedo = torch.where(h3, albedo, 0.0)

    noise = _noise(scene.tile, ys, xs, frames, DEFERRED_PERIOD).to(dt)
    sun = _vec(sky.sun_direction, ref)
    solar = _vec(sky.solar_radiances, ref)
    sky_rgb = radiance_with_sun(sky, direction)
    position = offset_ray(position, normal, DEFERRED_INT_SCALE, DEFERRED_FLOAT_SCALE)
    light = _solar_dir(noise, sun)

    def light_sample(pos, nrm, alb):
        cos_term = _dot(nrm, light)[:, None]
        vis = torch.where(_occluded(scene, pos, light, counter), 0.0, 1.0).to(dt)[:, None]
        return solar * (alb * FRAC_1_PI) * cos_term * vis * SOLAR_INV_PDF

    radiance = light_sample(position, normal, albedo)
    wi = _cosine_dir(noise, normal)
    b_hit, _, b_tri = _closest(scene, position, wi, counter)
    b_pos, b_nrm, b_uv, b_tex = _surface(scene, position, wi, b_tri.clamp(min=0))
    b_alb = _albedo(scene, b_tex, b_uv)
    b_sky = radiance_with_sun(sky, wi)
    indirect = torch.where(b_hit[:, None], albedo * light_sample(b_pos, b_nrm, b_alb),
                           albedo * b_sky)
    return torch.where(h3, radiance + indirect, sky_rgb)


def tonemap_u8(linear, exposure: float):
    """ACES filmic fit, gamma 2.2, x 255 rounded half to even, clamped: the
    display byte (wgsl:59-63, 277-285)."""
    x = float(exposure) * linear
    a, b, c, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
    rgb = torch.clamp((x * (a * x + b)) / (x * (c * x + d) + e), 0.0, 1.0)
    return torch.clamp(torch.round(torch.pow(rgb, 1.0 / 2.2) * 255.0), 0.0, 255.0).to(torch.uint8)
