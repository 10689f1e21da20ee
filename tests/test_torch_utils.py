"""The port's leaf pieces of the scan integrator and the tools against the
JAX package: sky_radiance with the solar disk, the sky-dome tool, the math
helpers, PNG I/O, the scene's cluster count, the scan form's noise, the
sigmoid exposure and the pinhole camera.

Budgets: sky radiance rtol 1e-5 near the sun (torch's and XLA's exp and pow
differ by an ulp, which the Perez term amplifies there), the disk itself
exact; images RMSE < 5e-3 (tests/test_goldens.py); everything else exact
or to an ulp.
"""

import enum
import pathlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rayfinder_tpu.render.camera import create_camera as jax_camera
from rayfinder_tpu.render.camera import generate_camera_ray as jax_pinhole
from rayfinder_tpu.render.rng import animated_blue_noise as jax_noise
from rayfinder_tpu.render.scene import build_device_scene as jax_build
from rayfinder_tpu.render.tonemap import expose_sigmoid as jax_expose
from rayfinder_tpu.scene.procedural import courtyard_scene
from rayfinder_tpu.sky import model as jsky
from rayfinder_tpu.tools.sky_demo import render_sky_dome as jax_sky_dome
from rayfinder_tpu.utils import image as jimage
from rayfinder_tpu.utils import math as jmath
from rayfinder_tpu_torch.render import pathtracer as pt
from rayfinder_tpu_torch.render.camera import create_camera, generate_camera_ray
from rayfinder_tpu_torch.render.rng import animated_blue_noise, blue_noise_tile, noise_of
from rayfinder_tpu_torch.render.scene import build_device_scene
from rayfinder_tpu_torch.render.tonemap import expose_sigmoid
from rayfinder_tpu_torch.sky import model as sky
from rayfinder_tpu_torch.tools.sky_demo import main as sky_demo_main
from rayfinder_tpu_torch.tools.sky_demo import render_sky_dome
from rayfinder_tpu_torch.utils import math as pmath
from rayfinder_tpu_torch.utils.image import read_png, rmse, write_png

GOLDENS = pathlib.Path(__file__).resolve().parent / "goldens"


def test_sky_radiance_across_the_solar_disk():
    """A dense (theta, gamma) grid across the disk's edge, gamma = R itself
    included: the disk decision equals JAX's on every point, the radiance
    within rtol 1e-5."""
    state = sky.sky_state_from_ui(1.0, (1.0, 1.0, 1.0), 30.0, 0.0)
    jstate = jsky.sky_state_from_ui(1.0, (1.0, 1.0, 1.0), 30.0, 0.0)
    r = float(sky.SOLAR_RADIUS_RADIANS)
    assert sky.SOLAR_RADIUS_RADIANS == jsky.SOLAR_RADIUS_RADIANS
    gamma = np.concatenate([np.linspace(0.0, 3.0 * r, 301, dtype=np.float32),
                            [np.float32(r), np.nextafter(np.float32(r), np.float32(1.0))]])
    theta = np.linspace(0.0, 0.5 * np.pi, 41, dtype=np.float32)
    tt, gg = (a.reshape(-1) for a in np.meshgrid(theta, gamma))
    got = sky.sky_radiance(state, torch.from_numpy(tt), torch.from_numpy(gg)).numpy()
    want = np.asarray(jsky.sky_radiance(jstate, jnp.asarray(tt), jnp.asarray(gg)))
    got_disk = got - sky.sky_radiance_dist(state, torch.from_numpy(tt), torch.from_numpy(gg)).numpy()
    want_disk = want - np.asarray(jsky.sky_radiance_dist(jstate, jnp.asarray(tt), jnp.asarray(gg)))
    in_disk = gg <= np.float32(r)
    np.testing.assert_array_equal(got_disk[:, 0] > 1.0, in_disk)
    np.testing.assert_array_equal(want_disk[:, 0] > 1.0, in_disk)
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_sky_dome_matches_golden(tmp_path):
    dome = render_sky_dome(size=64, device="cpu")
    golden = read_png(GOLDENS / "sky_dome_64.png").astype(np.float32) / 255.0
    assert dome.shape == golden.shape == (64, 64, 3)
    assert rmse(dome, golden) < 5e-3
    np.testing.assert_allclose(dome, jax_sky_dome(size=64), rtol=1e-5, atol=1e-6)
    out = tmp_path / "dome.png"
    assert sky_demo_main(["-o", str(out), "--size", "16", "--device", "cpu"]) == 0
    assert read_png(out).shape == (16, 16, 3)


@pytest.mark.parametrize("channels", [3, 4])
def test_png_round_trip_and_pillow_reads_it(tmp_path, channels):
    """write_png goes through the zlib coder (no Pillow); read_png gives the
    pixels back, and so does the JAX package's Pillow reader."""
    img = np.random.default_rng(5).integers(0, 256, (7, 9, channels), dtype=np.uint8)
    path = tmp_path / "img.png"
    write_png(path, img)
    np.testing.assert_array_equal(read_png(path), img)
    np.testing.assert_array_equal(jimage.read_png(path), img)
    floats = img.astype(np.float32) / 255.0
    write_png(path, floats)
    np.testing.assert_array_equal(read_png(path), jimage.read_png(path))
    # A PNG only Pillow decodes (the goldens) reads as the JAX reader does.
    np.testing.assert_array_equal(read_png(GOLDENS / "sky_dome_64.png"),
                                  jimage.read_png(GOLDENS / "sky_dome_64.png"))
    assert rmse(floats, floats) == 0.0
    with pytest.raises(ValueError, match="shapes differ"):
        rmse(floats, floats[:1])


def test_math_helpers_match_jax():
    x = np.asarray([-2.75, -1.25, -0.5, 0.0, 0.25, 1.0, 3.5], np.float32)
    for fn in ("fract", "gpu_fract"):
        want = np.asarray(getattr(jmath, fn)(x))
        np.testing.assert_array_equal(getattr(pmath, fn)(x), want)
        np.testing.assert_array_equal(getattr(pmath, fn)(torch.from_numpy(x)).numpy(), want)
        np.testing.assert_array_equal(np.asarray(getattr(jmath, fn)(jnp.asarray(x))), want)
    n = np.arange(20)
    np.testing.assert_array_equal(pmath.r2_sequence(n, 7), jmath.r2_sequence(n, 7))
    np.testing.assert_array_equal(pmath.degrees_to_radians([0.0, 30.0, 185.5]),
                                  jmath.degrees_to_radians([0.0, 30.0, 185.5]))
    a, ja = pmath.Angle.degrees(37.5), jmath.Angle.degrees(37.5)
    assert a.as_radians() == ja.as_radians() and a.as_degrees() == ja.as_degrees()
    assert (a + pmath.Angle.radians(0.5)).as_radians() == (ja + jmath.Angle.radians(0.5)).as_radians()
    assert pmath.Angle.radians(0.1) < a and repr(a) == repr(ja)
    assert a == pmath.Angle.degrees(37.5) and hash(a) == hash(ja)
    with pytest.raises(TypeError):
        pmath.Angle(1.0)
    e, je = pmath.Extent2(1920, 1080), jmath.Extent2(1920, 1080)
    assert e.aspect_ratio() == je.aspect_ratio() and e.area() == je.area()
    assert repr(e.astype(np.float32)) == repr(je.astype(np.float32))
    assert e == pmath.Extent2(1920, 1080) and hash(e) == hash(je)

    class Flag(enum.Enum):
        A = 1
        B = 2
        C = 4

    f, jf = pmath.BitFlags(Flag.A, Flag.C), jmath.BitFlags(Flag.A, Flag.C)
    assert repr(f) == repr(jf) and f.has(Flag.C) and not f.has(Flag.B)
    assert pmath.BitFlags.all(Flag) == pmath.BitFlags(Flag.A, Flag.B, Flag.C)
    assert repr(pmath.BitFlags.none()) == repr(jmath.BitFlags.none())


@pytest.mark.parametrize("subdiv", [4, 8])
def test_cluster_count_decides_as_jax(subdiv):
    """The scene's cluster count is the JAX scene's (unpadded at or below
    512 clusters), so the sort decision (> SORT_THRESHOLD) is JAX's; the
    count survives DeviceScene.to()."""
    flat, textures = courtyard_scene(subdiv)
    port = build_device_scene(flat, textures=textures, device="cpu")
    want = jax_build(flat, textures=textures).cluster_tris.shape[0]
    assert want <= 512 and port.num_clusters == want
    assert (port.num_clusters > pt.SORT_THRESHOLD) == (subdiv == 8)
    assert port.to("cpu").num_clusters == want
    assert pt.SORT_THRESHOLD == 256 and pt._SORT_BITS == 5


def test_animated_blue_noise_is_noise_of():
    tile = torch.from_numpy(blue_noise_tile())
    ys, xs = torch.meshgrid(torch.arange(0, 300, 7), torch.arange(5, 400, 11), indexing="ij")
    for frame, spp in ((0, 1), (3, 8), (17, 8), (1000, 256)):
        got = animated_blue_noise(ys, xs, frame, spp, tile=tile)
        base = tile[ys % 128, xs % 128]
        assert torch.equal(got, noise_of(base, frame, torch.zeros_like(ys), spp))
        assert torch.equal(got, noise_of(base, 0, torch.full_like(ys, frame), spp))
        want = np.asarray(jax_noise(jnp.asarray(ys.numpy()), jnp.asarray(xs.numpy()), frame, spp))
        np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(animated_blue_noise(ys, xs, 3, 8), animated_blue_noise(ys, xs, 3, 8, tile))


def test_expose_sigmoid_and_pinhole_camera():
    x = torch.linspace(-50.0, 400.0, 257)
    np.testing.assert_allclose(expose_sigmoid(x, 0.1).numpy(),
                               np.asarray(jax_expose(jnp.asarray(x.numpy()), 0.1)),
                               rtol=1e-6, atol=1e-7)
    eye = ([2.0, 1.5, 2.0], [0.1, 0.8, 0.0], 0.0, 1.0, 70.0, 4 / 3)
    u = torch.rand(6, 5, generator=torch.Generator().manual_seed(0))
    v = torch.rand(6, 5, generator=torch.Generator().manual_seed(1))
    o, d = generate_camera_ray(create_camera(*eye), u, v)
    jo, jd = jax_pinhole(jax_camera(*eye), jnp.asarray(u.numpy()), jnp.asarray(v.numpy()))
    assert o.shape == d.shape == (6, 5, 3) and o.is_contiguous()
    np.testing.assert_array_equal(o.numpy(), np.asarray(jo))
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-6, atol=1e-7)
