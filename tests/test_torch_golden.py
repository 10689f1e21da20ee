"""The port's plain path against the images the JAX package baked
(tests/goldens/bake_torch_smoke.py): the untextured and the textured
courtyard_scene(8) at 128x96, 8 spp, 4 bounces, exposure 0.25.
chip_smoke.py holds the CUDA kernels to the same goldens on the card, with
the textured scene built without Pillow by the port's own
scene.procedural."""

import pathlib
import sys

import numpy as np
import pytest
import torch

from rayfinder_tpu.scene.procedural import courtyard_scene as jax_courtyard_scene
from rayfinder_tpu_torch.scene.procedural import courtyard_scene
from rayfinder_tpu_torch.render.camera import create_camera
from rayfinder_tpu_torch.render.pathtracer import (
    SamplingParams, accumulate_samples_regen, render_image,
)
from rayfinder_tpu_torch.render.rng import blue_noise_tile
from rayfinder_tpu_torch.render.scene import build_device_scene
from rayfinder_tpu_torch.render.tiling import unswizzle
from rayfinder_tpu_torch.render.tonemap import tonemap
from rayfinder_tpu_torch.sky.model import sky_state_from_ui

GOLDENS = pathlib.Path(__file__).resolve().parent / "goldens"
sys.path.insert(0, str(GOLDENS))
import bake_torch_smoke as cfg  # noqa: E402


def _rmse(a, b):
    return float(np.sqrt(np.mean((np.asarray(a, np.float64) - b) ** 2)))


def test_plain_path_reproduces_jax_golden():
    golden = np.load(GOLDENS / "courtyard_untextured_128x96_8spp.npz")
    flat, textures = courtyard_scene(cfg.SUBDIV, textured=False)
    scene = build_device_scene(flat, textures=textures, device="cpu")
    w, h, spp = cfg.WIDTH, cfg.HEIGHT, cfg.SPP
    accum, rays = accumulate_samples_regen(
        scene, sky_state_from_ui(*cfg.SKY), create_camera(*cfg.CAMERA, w / h),
        torch.from_numpy(blue_noise_tile()), 0, torch.zeros(w * h, 3),
        width=w, height=h, num_bounces=cfg.BOUNCES, spp=spp, num_frames=spp,
        count_rays=True,
    )
    img = tonemap(unswizzle(accum, w, h) / float(spp), cfg.EXPOSURE).reshape(h, w, 3).numpy()
    assert img.shape == golden["image"].shape
    assert np.isfinite(img).all() and img.max() > 0.1
    assert _rmse(img, golden["image"]) < 5e-3
    np.testing.assert_array_equal(rays.numpy(), golden["rays"])


def test_render_image_is_the_accumulated_estimate():
    """render_image = accumulate in dispatches, unswizzle, mean, tonemap."""
    flat, textures = courtyard_scene(4, textured=False)
    scene = build_device_scene(flat, textures=textures, device="cpu")
    w, h, spp = 32, 24, 4
    cam, sky = create_camera(*cfg.CAMERA, w / h), sky_state_from_ui(*cfg.SKY)
    img = render_image(scene, sky, cam, width=w, height=h,
                       sampling=SamplingParams(spp, 3), exposure=0.5, samples_per_dispatch=3)
    accum = accumulate_samples_regen(
        scene, sky, cam, torch.from_numpy(blue_noise_tile()), 0, torch.zeros(w * h, 3),
        width=w, height=h, num_bounces=3, spp=spp, num_frames=spp)
    want = tonemap(unswizzle(accum, w, h) / float(spp), 0.5).reshape(h, w, 3).numpy()
    assert img.dtype == np.float32 and img.shape == (h, w, 3)
    np.testing.assert_allclose(img, want, rtol=1e-5, atol=1e-6)


def test_plain_path_reproduces_textured_jax_golden():
    golden = np.load(cfg.golden_path(textured=True))
    flat, textures = courtyard_scene(cfg.SUBDIV, textured=True)
    scene = build_device_scene(flat, textures=textures, device="cpu")
    w, h, spp = cfg.WIDTH, cfg.HEIGHT, cfg.SPP
    accum, rays = accumulate_samples_regen(
        scene, sky_state_from_ui(*cfg.SKY), create_camera(*cfg.CAMERA, w / h),
        torch.from_numpy(blue_noise_tile()), 0, torch.zeros(w * h, 3),
        width=w, height=h, num_bounces=cfg.BOUNCES, spp=spp, num_frames=spp,
        count_rays=True,
    )
    img = tonemap(unswizzle(accum, w, h) / float(spp), cfg.EXPOSURE).reshape(h, w, 3).numpy()
    assert np.isfinite(img).all() and img.max() > 0.1
    assert _rmse(img, golden["image"]) < 5e-3
    np.testing.assert_array_equal(rays.numpy(), golden["rays"])


@pytest.mark.parametrize("subdiv", [2, 8])
def test_textured_courtyard_without_pillow_is_bit_exact(subdiv):
    """The port's courtyard_scene(subdiv, textured=True), built without
    Pillow for the GPU machine, equals the JAX package's (textures
    round-tripped through PNG with Pillow) bit for bit."""
    got, got_tex = courtyard_scene(subdiv, textured=True)
    want, want_tex = jax_courtyard_scene(subdiv, textured=True)
    for field in ("positions", "normals", "tex_coords", "texture_indices"):
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype and np.array_equal(a, b), field
    assert len(got_tex) == len(want_tex) == 14
    for a, b in zip(got_tex, want_tex):
        assert (a.width, a.height) == (b.width, b.height)
        assert a.pixels.dtype == b.pixels.dtype and np.array_equal(a.pixels, b.pixels)
