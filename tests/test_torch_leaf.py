"""The PyTorch port's leaf modules against the JAX package's, on the same
numpy inputs.

Exact (atol 0) where both sides run the same IEEE operations in the same
order: the slab test, the ray offset, the pixel order, the noise, the
texel lookup and the host-side numpy builds. Moller-Trumbore is held exactly
to a numpy transcription of the JAX formula: XLA's CPU compiler evaluates
`jnp.cross` with a fused multiply-add (a1*b2 - a2*b1 as fma(a1, b2, -a2*b1)),
even eagerly, which the port and its CUDA kernels (built with --fmad=false)
never do; against JAX itself the hit decisions agree on all but a few
borderline rays. Functions that call sin/cos/exp/pow/acos are held at rtol
1e-6: torch's and XLA's CPU implementations of those differ by an ulp or so.
"""

import pathlib
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rayfinder_tpu.render import camera as jcamera
from rayfinder_tpu.render import intersect as jintersect
from rayfinder_tpu.render import rng as jrng
from rayfinder_tpu.render import sampling as jsampling
from rayfinder_tpu.render import tiling as jtiling
from rayfinder_tpu.render import tonemap as jtonemap
from rayfinder_tpu.render.scene import build_device_scene as jax_build
from rayfinder_tpu.render.texture_eval import eval_texture as jax_eval_texture
from rayfinder_tpu.scene.procedural import courtyard_scene
from rayfinder_tpu.sky import model as jsky
from rayfinder_tpu_torch.render import camera, intersect, rng, sampling, tiling, tonemap
from rayfinder_tpu_torch.render.scene import build_device_scene
from rayfinder_tpu_torch.render.texture_eval import eval_texture, texel_bytes
from rayfinder_tpu_torch.sky import model as sky

SEED = 20261016


def _t(a):
    return torch.from_numpy(np.array(a))


def _unit(rng_, n):
    d = rng_.normal(size=(n, 3)).astype(np.float32)
    return d / np.linalg.norm(d, axis=1, keepdims=True)


def _exact(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def _ray_triangle_numpy(o, d, v0, v1, v2, t_max):
    """rayfinder_tpu.render.intersect.ray_triangle in numpy float32, every
    product and sum rounded on its own, left to right."""
    def cross(a, b):
        return np.stack([a[:, 1] * b[:, 2] - a[:, 2] * b[:, 1],
                         a[:, 2] * b[:, 0] - a[:, 0] * b[:, 2],
                         a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]], axis=1)

    def dot(a, b):
        p = a * b
        return (p[:, 0] + p[:, 1]) + p[:, 2]

    e1, e2 = v1 - v0, v2 - v0
    h = cross(d, e2)
    det = dot(e1, h)
    inv_det = np.float32(1.0) / det
    s = o - v0
    u = inv_det * dot(s, h)
    q = cross(s, e1)
    v = inv_det * dot(d, q)
    t = inv_det * dot(e2, q)
    eps = np.float32(1e-5)
    hit = (np.abs(det) >= eps) & (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1) & (t > eps) & (t < t_max)
    return hit, t, u, v


def test_ray_triangle_exact():
    r = np.random.default_rng(SEED)
    n = 20000
    o = r.uniform(-2, 2, (n, 3)).astype(np.float32)
    v = r.uniform(-1, 1, (3, n, 3)).astype(np.float32)
    # Aim at points around each triangle, some outside its edges.
    b = r.uniform(-0.3, 1.0, (n, 2))
    target = v[0] + b[:, :1] * (v[1] - v[0]) + b[:, 1:] * (v[2] - v[0])
    d = target - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    t_max = r.uniform(0.5, 5.0, n).astype(np.float32)
    got = intersect.ray_triangle(_t(o), _t(d), _t(v[0]), _t(v[1]), _t(v[2]), _t(t_max))
    assert 0.2 < float(got[0].float().mean()) < 0.8
    with np.errstate(divide="ignore", invalid="ignore"):
        want = _ray_triangle_numpy(o, d, v[0], v[1], v[2], t_max)
    for g, w in zip(got, want):
        _exact(g.numpy(), w)
    # Against JAX (FMA-contracted cross products): the same hits but for
    # rays within rounding of an edge or of t_max.
    jax_hit, jax_t, _, _ = jintersect.ray_triangle(
        *(jnp.asarray(a) for a in (o, d, v[0], v[1], v[2], t_max)))
    jax_hit, jax_t = np.asarray(jax_hit), np.asarray(jax_t)
    hit = got[0].numpy()
    assert (hit != jax_hit).sum() <= n // 2000
    both = hit & jax_hit
    np.testing.assert_allclose(got[1].numpy()[both], jax_t[both], rtol=1e-3)


def test_ray_aabb_exact():
    r = np.random.default_rng(SEED + 1)
    n = 20000
    o = r.uniform(-3, 3, (n, 3)).astype(np.float32)
    d = _unit(r, n)
    d[::97, 0] = 0.0  # axis-parallel rays: infinite inverse components
    with np.errstate(divide="ignore"):
        inv = (np.float32(1.0) / d).astype(np.float32)
    lo = r.uniform(-1, 0, (n, 3)).astype(np.float32)
    hi = lo + r.uniform(0, 2, (n, 3)).astype(np.float32)
    t_max = r.uniform(0.5, 8.0, n).astype(np.float32)
    got = intersect.ray_aabb(_t(o), _t(inv), _t(inv < 0), _t(lo), _t(hi), _t(t_max))
    want = jintersect.ray_aabb(
        jnp.asarray(o), jnp.asarray(inv), jnp.asarray(inv < 0), jnp.asarray(lo),
        jnp.asarray(hi), jnp.asarray(t_max))
    assert 0.02 < float(got.float().mean()) < 0.98
    _exact(got.numpy(), want)


def test_offset_ray_bits_exact():
    r = np.random.default_rng(SEED + 2)
    p = r.uniform(-40, 40, (5000, 3)).astype(np.float32)
    p[::7] *= np.float32(1e-3)  # near the origin: the epsilon branch
    n = _unit(r, 5000)
    got = intersect.offset_ray(_t(p), _t(n)).numpy()
    want = np.asarray(jintersect.offset_ray(jnp.asarray(p), jnp.asarray(n)))
    _exact(got.view(np.int32), want.view(np.int32))


def test_to_int32_saturates_like_xla():
    x = np.asarray([np.nan, np.inf, -np.inf, 3e9, -3e9, 2.9, -2.9, 0.0], np.float32)
    got = intersect.to_int32(_t(x)).numpy()
    want = np.asarray(jnp.asarray(x).astype(jnp.int32))
    _exact(got, want)


@pytest.mark.parametrize("size", [(128, 96), (512, 512), (37, 21)])
def test_block_order_and_unswizzle_exact(size):
    w, h = size
    for g, want in zip(tiling.block_order(w, h), jtiling.block_order(w, h)):
        _exact(g, want)
    x = np.random.default_rng(SEED).normal(size=(w * h, 3)).astype(np.float32)
    _exact(tiling.unswizzle(_t(x), w, h).numpy(), jtiling.unswizzle(jnp.asarray(x), w, h))


def test_noise_exact():
    tile = rng.blue_noise_tile()
    np.testing.assert_array_equal(tile, jrng.blue_noise_tile())
    ys, xs, _ = tiling.block_order(64, 48)
    base = _t(tile[ys % 128, xs % 128])
    for frame_base, sample, spp in ((0, 0, 8), (16, 3, 256), (250, 9, 256), (7, 5, 4)):
        got = rng.noise_of(base, frame_base, torch.full((ys.size,), sample, dtype=torch.int32), spp)
        want = jrng.animated_blue_noise(
            jnp.asarray(ys), jnp.asarray(xs), frame_base + sample, spp,
            tile=jnp.asarray(tile))
        _exact(got.numpy(), want)


def test_eval_texture_exact():
    flat, textures = courtyard_scene(4, textured=True)
    port = build_device_scene(flat, textures=textures, device="cpu")
    want_scene = jax_build(flat, textures=textures)
    r = np.random.default_rng(SEED + 3)
    n = 20000
    tex = r.integers(0, len(textures), n).astype(np.int32)
    uv = r.uniform(-3, 3, (n, 2)).astype(np.float32)
    uv[::50] = np.floor(uv[::50])  # integer UVs: the wrap's edge
    # The texel lookup, exactly: JAX's index arithmetic in numpy on the JAX
    # scene's own atlas.
    desc = np.asarray(want_scene.tex_desc)[tex]
    fu = uv[:, 0] - np.floor(uv[:, 0])
    fv = uv[:, 1] - np.floor(uv[:, 1])
    j = np.clip((fu * desc[:, 0].astype(np.float32)).astype(np.int32), 0, desc[:, 0] - 1)
    i = np.clip((fv * desc[:, 1].astype(np.float32)).astype(np.int32), 0, desc[:, 1] - 1)
    bgra = np.asarray(want_scene.texels)[desc[:, 2] + i * desc[:, 0] + j]
    want_bytes = np.stack([(bgra >> 16) & 0xFF, (bgra >> 8) & 0xFF, bgra & 0xFF], axis=1)
    _exact(texel_bytes(port, _t(tex), _t(uv)).numpy(), want_bytes.astype(np.int32))
    # The albedo: pow(x, 2.2) of the same bytes, within an ulp.
    got = eval_texture(port, _t(tex), _t(uv)).numpy()
    want = np.asarray(jax_eval_texture(want_scene, jnp.asarray(tex), jnp.asarray(uv)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_create_camera_exact():
    args = ([-16.0, 5.0, 0.0], [12.0, 2.0, 0.0], 0.4, 2.5, 70.0, 4 / 3)
    for g, w in zip(camera.create_camera(*args), jcamera.create_camera(*args)):
        assert np.asarray(g).dtype == np.asarray(w).dtype
        _exact(g, w)


@pytest.mark.parametrize("ui", [(2.5, (0.3, 0.3, 0.3), 35.0, 25.0), (1.0, (1.0, 0.5, 0.0), 80.0, -40.0)])
def test_sky_state_from_ui_exact(ui):
    got, want = sky.sky_state_from_ui(*ui), jsky.sky_state_from_ui(*ui)
    for g, w in zip(got, want):
        _exact(g, w)
    carried = sky.sky_from_jax(*want)
    for g, w in zip(carried, want):
        _exact(g, w)


def test_sky_state_rejects_out_of_range():
    with pytest.raises(ValueError, match="turbidity"):
        sky.sky_state_from_ui(99.0, (1, 1, 1), 30.0, 0.0)


def test_camera_rays_close():
    cam_args = ([2.0, 1.5, 2.0], [0.1, 0.8, 0.0], 0.3, 2.5, 70.0, 4 / 3)
    r = np.random.default_rng(SEED + 4)
    n = 5000
    noise = r.uniform(size=(n, 2)).astype(np.float32)
    u, v = r.uniform(size=(2, n)).astype(np.float32)
    go, gd = camera.generate_camera_ray_lens(camera.create_camera(*cam_args), _t(noise), _t(u), _t(v))
    wo, wd = jcamera.generate_camera_ray_lens(
        jcamera.create_camera(*cam_args), jnp.asarray(noise), jnp.asarray(u), jnp.asarray(v))
    np.testing.assert_allclose(go.numpy(), np.asarray(wo), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(gd.numpy(), np.asarray(wd), rtol=1e-6, atol=1e-6)


def test_sampling_close():
    r = np.random.default_rng(SEED + 5)
    n = 5000
    noise = r.uniform(size=(n, 2)).astype(np.float32)
    normals = _unit(r, n)
    sun = jsky.sun_direction_from_zenith_azimuth(np.radians(35.0), np.radians(25.0))
    ctm = np.float32(np.cos(np.float32(0.255 * np.pi / 180.0)))
    for g, w in zip(sampling.pixar_onb(_t(normals)), jsampling.pixar_onb(jnp.asarray(normals))):
        _exact(g.numpy(), w)
    got = sampling.sample_solar_disk_direction(_t(noise), ctm, _t(sun))
    want = jsampling.sample_solar_disk_direction(jnp.asarray(noise), ctm, jnp.asarray(sun))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    got = sampling.sample_cosine_hemisphere(_t(noise), _t(normals))
    want = jsampling.sample_cosine_hemisphere(jnp.asarray(noise), jnp.asarray(normals))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_sky_radiance_close():
    state = sky.sky_state_from_ui(2.5, (0.3, 0.3, 0.3), 35.0, 25.0)
    r = np.random.default_rng(SEED + 6)
    theta = r.uniform(0, np.pi, 4000).astype(np.float32)
    gamma = r.uniform(0, np.pi, 4000).astype(np.float32)
    got = sky.sky_radiance_dist(state, _t(theta), _t(gamma)).numpy()
    want = np.asarray(jsky.sky_radiance_dist(jsky.sky_state_from_ui(2.5, (0.3, 0.3, 0.3), 35.0, 25.0),
                                             jnp.asarray(theta), jnp.asarray(gamma)))
    # Each side lies within ~1e-6 of the float64 value (about 8 float32
    # roundings in a row), so they may differ by twice that. Two terms also
    # scale the ulp by which torch's and XLA's cos differ: near the sun the
    # Mie denominator 1 + g^2 - 2 g cos(gamma) cancels (g ~ 0.7, ~15x), near
    # the horizon exp(p1 / (cos(theta) + 0.01)) (up to ~100x).
    away = (np.abs(np.cos(theta)) >= 0.1) & (gamma >= 0.3)
    np.testing.assert_allclose(got[away], want[away], rtol=2e-6, atol=0)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    # The path kernel's form (cos taken straight from the direction) against
    # the angle form: the same radiance up to the cos(acos(x)) rounding.
    d = _unit(r, 4000)
    by_dir = sky.sky_radiance_dir(state, _t(d)).numpy()
    th = np.arccos(np.clip(d[:, 1], -1, 1))
    ga = np.arccos(np.clip(d @ state.sun_direction, -1, 1))
    by_angle = sky.sky_radiance_dist(state, _t(th.astype(np.float32)), _t(ga.astype(np.float32))).numpy()
    np.testing.assert_allclose(by_dir, by_angle, rtol=1e-4)


def test_tonemap_close():
    x = np.random.default_rng(SEED + 7).exponential(2.0, (5000, 3)).astype(np.float32)
    got = tonemap.tonemap(_t(x), 0.25).numpy()
    want = np.asarray(jtonemap.tonemap(jnp.asarray(x), 0.25))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_kernel_float_constants_are_float32_values():
    """path.cuh (the path kernels' shared per-lane code) spells the float32
    constants of the noise and the lens as decimal literals; each must be
    the float32 the torch side uses."""
    src = (pathlib.Path(rng.__file__).resolve().parents[1] / "csrc" / "path.cuh").read_text()
    lits = dict(re.findall(r"constexpr float (k\w+) = ([0-9.]+)f;", src))
    assert np.float32(lits["kA1"]) == rng.A1
    assert np.float32(lits["kA2"]) == rng.A2
    assert np.float32(lits["kTwoPi"]) == np.float32(sampling.TWO_PI)
