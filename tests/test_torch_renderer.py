"""The port's progressive Renderer (render/renderer.py): the cases of
tests/test_renderer.py, which take the absent Duck fixture, restated on
courtyard_scene(4) on the CPU, and checkpoints shared with the JAX package's
Renderer (same npz keys, same sha256 parameter digest).
"""

import dataclasses

import numpy as np
import pytest
import torch

from rayfinder_tpu.render import renderer as jrr
from rayfinder_tpu.render.camera import create_camera as jax_camera
from rayfinder_tpu.render.scene import build_device_scene as jax_build
from rayfinder_tpu.scene.procedural import courtyard_scene
from rayfinder_tpu_torch.render import pathtracer as pt
from rayfinder_tpu_torch.render.camera import create_camera
from rayfinder_tpu_torch.render.renderer import Renderer, RenderParameters, Sky
from rayfinder_tpu_torch.render.rng import blue_noise_tile
from rayfinder_tpu_torch.render.scene import build_device_scene

EYE = ([-16.0, 5.0, 0.0], [12.0, 2.0, 0.0], 0.0, 1.0, 70.0, 16 / 12)
SKY = Sky(2.5, (0.3, 0.3, 0.3), 35.0, 25.0)


@pytest.fixture(scope="module")
def scene():
    flat, textures = courtyard_scene(4)
    return build_device_scene(flat, textures=textures, device="cpu")


@pytest.fixture(scope="module")
def params():
    return RenderParameters(width=16, height=12, camera=create_camera(*EYE),
                            sampling=pt.SamplingParams(4, 2), sky=SKY, exposure=0.25)


@pytest.mark.parametrize("engine", ["kernel", "reference"])
def test_progressive_accumulation(scene, params, engine):
    r = Renderer(scene, params, engine=engine)
    assert r.render_progress_percentage() == 0.0
    r.render()
    assert r.accumulated_sample_count == 1
    assert r.render_progress_percentage() == 25.0
    r.render(num_frames=3)
    assert r.render_progress_percentage() == 100.0
    # Past the target: the frame counter advances, the accumulation does not.
    accum = r._accum.clone()
    r.render()
    assert r.accumulated_sample_count == 4
    assert r.frame_count == 5
    assert torch.equal(r._accum, accum)
    img = r.image()
    assert img.shape == (12, 16, 3) and img.dtype == np.float32
    assert np.isfinite(img).all() and img.max() <= 1.0 and img.max() > 0.0
    assert r.average_render_pass_duration_ms() > 0.0
    # The accumulation is the dispatches' own, in one call.
    want = pt.accumulate_samples_regen(
        scene, SKY.state(), params.camera, torch.from_numpy(blue_noise_tile()), 0,
        torch.zeros(16 * 12, 3), width=16, height=12, num_bounces=2, spp=4, num_frames=4,
        engine=engine)
    np.testing.assert_allclose(r._accum.numpy(), want.numpy(), rtol=1e-6, atol=1e-7)
    for _ in range(40):
        r.render()
    assert len(r._durations) == 30


def test_param_change_resets_accumulation(scene, params):
    r = Renderer(scene, params)
    r.render()
    assert r.accumulated_sample_count == 1
    # Same params: no reset (reference_path_tracer.cpp:557-563).
    r.set_render_parameters(dataclasses.replace(params))
    assert r.accumulated_sample_count == 1
    # Changed exposure: reset, but the frame counter keeps running.
    r.set_render_parameters(dataclasses.replace(params, exposure=0.5))
    assert r.accumulated_sample_count == 0
    assert r.frame_count == 1
    assert not r._accum.any()
    # A changed sky rebuilds the sky state.
    r.set_render_parameters(dataclasses.replace(params, sky=Sky(sun_zenith_degrees=50.0)))
    assert r._sky_state.sun_direction[1] == pytest.approx(np.cos(np.radians(50.0)), rel=1e-6)


def test_checkpoint_roundtrip(scene, params, tmp_path):
    r = Renderer(scene, params)
    r.render(num_frames=2)
    ckpt = tmp_path / "render.ckpt.npz"
    r.save_checkpoint(ckpt)
    with np.load(ckpt) as data:
        assert sorted(data.files) == ["accum", "accumulated_sample_count", "frame_count",
                                      "params_key"]
    r2 = Renderer(scene, params)
    r2.load_checkpoint(ckpt)
    assert r2.accumulated_sample_count == 2
    assert r2.frame_count == 2
    assert torch.equal(r2._accum, r._accum)
    np.testing.assert_array_equal(r2.image(), r.image())
    # Mismatched params must refuse to resume.
    r3 = Renderer(scene, dataclasses.replace(params, exposure=0.5))
    with pytest.raises(ValueError, match="different render parameters"):
        r3.load_checkpoint(ckpt)


def test_checkpoint_of_the_jax_renderer_loads(scene, params, tmp_path):
    """The digest of equal parameters is the JAX package's (the port's
    Camera, SamplingParams and Sky repr as JAX's do), so a checkpoint the
    JAX Renderer wrote resumes here, and the image is JAX's."""
    flat, textures = courtyard_scene(4)
    jparams = jrr.RenderParameters(
        width=16, height=12, camera=jax_camera(*EYE), sampling=jrr.SamplingParams(4, 2),
        sky=jrr.Sky(2.5, (0.3, 0.3, 0.3), 35.0, 25.0), exposure=0.25)
    assert repr(jparams._key()) == repr(params._key())
    assert jparams._digest() == params._digest()
    jr = jrr.Renderer(jax_build(flat, textures=textures), jparams, engine="reference")
    jr.render(num_frames=3)
    ckpt = tmp_path / "jax.ckpt.npz"
    jr.save_checkpoint(ckpt)
    r = Renderer(scene, params)
    r.load_checkpoint(ckpt)
    assert (r.accumulated_sample_count, r.frame_count) == (3, 3)
    np.testing.assert_allclose(r.image(), jr.image(), rtol=1e-6, atol=1e-6)
    # ... and it renders on from there.
    r.render()
    assert r.accumulated_sample_count == 4 and r.frame_count == 4


def test_image_u8_matches_image(scene, params):
    """The 8-bit frame equals the f32 image quantized on the host."""
    r = Renderer(scene, dataclasses.replace(params, sampling=pt.SamplingParams(2, 2)))
    r.render(2)
    f32 = r.image()
    u8 = r.image_u8()
    assert u8.dtype == np.uint8 and u8.shape == f32.shape
    np.testing.assert_array_equal(u8, np.clip(np.round(f32 * 255.0), 0, 255).astype(np.uint8))


def test_total_rays(scene, params, monkeypatch):
    """Counted on the regeneration loop (the dispatch's exact counts);
    None once the scan form is picked (big scenes on unfused engines)."""
    r = Renderer(scene, params, engine="kernel_split", count_rays=True)
    assert r.total_rays == 0
    r.render(3)
    _, rays = pt.accumulate_samples_regen(
        scene, SKY.state(), params.camera, torch.from_numpy(blue_noise_tile()), 0,
        torch.zeros(16 * 12, 3), width=16, height=12, num_bounces=2, spp=4, num_frames=3,
        engine="kernel", count_rays=True)
    assert r.total_rays == int(rays.sum()) > 0
    monkeypatch.setattr(pt, "SORT_THRESHOLD", 0)
    scan = Renderer(scene, params, engine="kernel_split", count_rays=True)
    scan.render(2)
    assert scan.total_rays is None and scan.accumulated_sample_count == 2
    assert Renderer(scene, params).total_rays is None
