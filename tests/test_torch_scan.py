"""The port's scan integrator (trace_radiance, accumulate_sample(s), the
windows of render_image_tiled) and its unfused regeneration loop
(accumulate_samples_regen with engine "reference" / "kernel_split") against
the JAX package on the CPU, with the JAX engine "reference" (the per-ray
stack walk).

Budgets, as in tests/test_pallas_regen.py: radiance rtol 2e-4 / atol 1e-5
(XLA's CPU jit contracts products into FMAs, the port rounds each one;
torch's and XLA's acos/exp/pow differ by an ulp); ray counts exact; images
RMSE < 5e-3 (tests/test_goldens.py). Inputs: courtyard_scene(4) (72
clusters: no bounce sort unless SORT_THRESHOLD is lowered), rays and noise
made by the port from the blue-noise tile and handed to both packages as
numpy arrays.
"""

import pathlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rayfinder_tpu.render import pathtracer as jpt
from rayfinder_tpu.render.camera import create_camera as jax_camera
from rayfinder_tpu.render.rng import blue_noise_tile as jax_tile
from rayfinder_tpu.render.scene import build_device_scene as jax_build
from rayfinder_tpu.scene.procedural import courtyard_scene
from rayfinder_tpu.sky.model import sky_state_from_ui as jax_sky
from rayfinder_tpu_torch.render import pathtracer as pt
from rayfinder_tpu_torch.render.camera import create_camera, generate_camera_ray_lens
from rayfinder_tpu_torch.render.rng import animated_blue_noise, blue_noise_tile
from rayfinder_tpu_torch.render.scene import build_device_scene
from rayfinder_tpu_torch.render.tiling import block_order
from rayfinder_tpu_torch.sky.model import sky_state_from_ui
from rayfinder_tpu_torch.utils.image import read_png, rmse

GOLDENS = pathlib.Path(__file__).resolve().parent / "goldens"
SKY = (2.5, (0.3, 0.3, 0.3), 35.0, 25.0)
EYE = ([-16.0, 5.0, 0.0], [12.0, 2.0, 0.0], 0.0, 1.0, 70.0)
W, H = 24, 16


@pytest.fixture(scope="module")
def courtyard():
    flat, textures = courtyard_scene(4)
    return build_device_scene(flat, textures=textures, device="cpu"), jax_build(flat, textures=textures)


def _tile():
    return torch.from_numpy(blue_noise_tile())


def _primaries(w, h, frame=1, spp=4):
    """Block-ordered primary rays and noise of one frame, made by the port."""
    ys, xs, _ = block_order(w, h)
    ys, xs = torch.from_numpy(ys), torch.from_numpy(xs)
    noise = animated_blue_noise(ys, xs, frame, spp, tile=_tile())
    u = (xs.float() + 0.5) / w + noise[:, 0] / w
    v = (1.0 - (ys.float() + 0.5) / h) + noise[:, 1] / h
    o, d = generate_camera_ray_lens(create_camera(*EYE, w / h), noise, u, v)
    return o, d, noise


def _jax_trace(jscene, o, d, noise, bounces, **kw):
    return np.asarray(jpt.trace_radiance(
        jscene, jax_sky(*SKY), jnp.asarray(o.numpy()), jnp.asarray(d.numpy()),
        jnp.asarray(noise.numpy()), bounces, engine="reference", **kw))


@pytest.mark.parametrize("engine", ["reference", "plain", "kernel"])
def test_trace_radiance_matches_jax(courtyard, engine):
    """Each engine of the port (the plane walk, the packed walk, K1/K2's
    wrappers on CPU tensors: their plain versions) against JAX's reference
    engine, 3 bounces."""
    port, jscene = courtyard
    o, d, noise = _primaries(W, H)
    want = _jax_trace(jscene, o, d, noise, 3)
    got = pt.trace_radiance(port, sky_state_from_ui(*SKY), o, d, noise, 3, engine=engine)
    assert got.shape == (W * H, 3) and float(got.sum()) > 0.0
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=1e-5)


def test_trace_radiance_sorted_matches_jax(courtyard, monkeypatch):
    """SORT_THRESHOLD 0 in both packages: the per-bounce coherence sort runs
    (4 bounces; a batch shape no other test compiles, so JAX traces anew)."""
    port, jscene = courtyard
    monkeypatch.setattr(jpt, "SORT_THRESHOLD", 0)
    monkeypatch.setattr(pt, "SORT_THRESHOLD", 0)
    o, d, noise = _primaries(20, 12)
    want = _jax_trace(jscene, o, d, noise, 4)
    got = pt.trace_radiance(port, sky_state_from_ui(*SKY), o, d, noise, 4, engine="reference")
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=1e-5)


@pytest.mark.parametrize("decorrelate", [False, True])
def test_lane_order_changes_no_pixel(courtyard, monkeypatch, decorrelate):
    """The sorted scan form equals the unsorted one bit for bit, with and
    without decorrelated noise (each lane keeps its pixel's noise)."""
    port, _ = courtyard
    o, d, noise = _primaries(W, H)
    sky = sky_state_from_ui(*SKY)
    plain = pt.trace_radiance(port, sky, o, d, noise, 4, engine="plain", decorrelate=decorrelate)
    monkeypatch.setattr(pt, "SORT_THRESHOLD", 0)
    keys = []
    key = pt._coherence_key
    monkeypatch.setattr(pt, "_coherence_key", lambda *a: keys.append(1) or key(*a))
    got = pt.trace_radiance(port, sky, o, d, noise, 4, engine="plain", decorrelate=decorrelate)
    assert len(keys) == 3  # one sort per bounce after the first
    assert torch.equal(got, plain)


def test_trace_radiance_decorrelated_matches_jax(courtyard):
    port, jscene = courtyard
    o, d, noise = _primaries(W, H)
    want = _jax_trace(jscene, o, d, noise, 3, decorrelate=True)
    got = pt.trace_radiance(port, sky_state_from_ui(*SKY), o, d, noise, 3, engine="reference",
                            decorrelate=True)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=1e-5)
    plain = pt.trace_radiance(port, sky_state_from_ui(*SKY), o, d, noise, 3, engine="reference")
    assert not torch.equal(got, plain)


def test_accumulate_samples_is_n_single_samples(courtyard):
    """accumulate_samples(k) in one call == k accumulate_sample calls, bit
    for bit, and within budget of JAX's accumulate_samples."""
    port, jscene = courtyard
    sky, cam = sky_state_from_ui(*SKY), create_camera(*EYE, W / H)
    kw = dict(width=W, height=H, num_bounces=2, spp=8)
    a = torch.zeros(W * H, 3)
    for k in range(3):
        a = pt.accumulate_sample(port, sky, cam, _tile(), 2 + k, a, engine="reference", **kw)
    b = pt.accumulate_samples(port, sky, cam, _tile(), 2, torch.zeros(W * H, 3), num_frames=3,
                              engine="reference", **kw)
    assert torch.equal(a, b)
    want = jpt.accumulate_samples(
        jscene, jax_sky(*SKY), jax_camera(*EYE, W / H), jnp.asarray(jax_tile()), jnp.int32(2),
        jnp.zeros((W * H, 3), jnp.float32), num_frames=3, engine="reference", **kw)
    np.testing.assert_allclose(b.numpy(), np.asarray(want), rtol=2e-4, atol=1e-5)


def test_tiled_render_matches_untiled(courtyard):
    """render_image_tiled reproduces render_image: each window's pixels keep
    their noise, and the clamped edge window (x 16..48) re-renders its
    overlap identically. render_image takes the unfused loop here (72
    clusters), so this also holds the loop to the scan form."""
    port, _ = courtyard
    w, h = 48, 32
    kw = dict(width=w, height=h, sampling=pt.SamplingParams(2, 2), exposure=0.25,
              engine="reference")
    args = (port, sky_state_from_ui(*SKY), create_camera(*EYE, w / h))
    assert pt.pick_accumulator(port, "reference") is pt.accumulate_samples_regen
    whole = pt.render_image(*args, **kw)
    tiled = pt.render_image_tiled(*args, tile_w=32, tile_h=32, **kw)
    assert tiled.shape == (h, w, 3) and tiled.dtype == np.float32
    np.testing.assert_allclose(tiled, whole, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("engine,floor", [("reference", None), ("reference", 16),
                                          ("kernel_split", 16)])
def test_unfused_loop_matches_jax(courtyard, engine, floor):
    """The unfused loop against JAX accumulate_samples_regen(engine=
    "reference"): counts exact, radiance rtol 2e-4 / atol 1e-5; floor 16
    runs the compacted phases."""
    port, jscene = courtyard
    kw = dict(width=W, height=H, num_bounces=3, spp=4, num_frames=4, count_rays=True)
    if floor is not None:
        kw["compact_floor"] = floor
        assert len(pt._phase_sizes(W * H, floor)) > 2
    want, want_rays = jpt.accumulate_samples_regen(
        jscene, jax_sky(*SKY), jax_camera(*EYE, W / H), jnp.asarray(jax_tile()), jnp.int32(0),
        jnp.zeros((W * H, 3), jnp.float32), engine="reference", **kw)
    start = torch.zeros(W * H, 3)
    got, rays = pt.accumulate_samples_regen(
        port, sky_state_from_ui(*SKY), create_camera(*EYE, W / H), _tile(), 0, start,
        engine=engine, **kw)
    assert rays.dtype == torch.int64
    np.testing.assert_array_equal(rays.numpy(), np.asarray(want_rays))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=1e-5)
    assert not start.any()  # accum is not modified in place


def test_unfused_loop_counts_the_default_routes_rays(courtyard):
    """The unfused loop traces the segments the fused loop traces: equal
    ray counts, and radiance within budget of the default route's."""
    port, _ = courtyard
    args = (port, sky_state_from_ui(*SKY), create_camera(*EYE, W / H), _tile(), 1,
            torch.zeros(W * H, 3))
    kw = dict(width=W, height=H, num_bounces=4, spp=4, num_frames=3, count_rays=True)
    fused, fused_rays = pt.accumulate_samples_regen(*args, engine="plain", **kw)
    unfused, rays = pt.accumulate_samples_regen(*args, engine="kernel_split", **kw)
    assert torch.equal(rays, fused_rays)
    np.testing.assert_allclose(unfused.numpy(), fused.numpy(), rtol=2e-4, atol=1e-5)


def test_engines_and_routes(courtyard, monkeypatch):
    port, _ = courtyard
    assert pt.get_engine("wavefront") == (pt._closest_wavefront, pt._any_wavefront)
    with pytest.raises(ValueError, match="unknown traversal engine"):
        pt.get_engine("pallas")
    assert pt.get_engine("kernel") == pt.get_engine("kernel_split")
    with pytest.raises(ValueError, match="no route keyword"):
        pt.accumulate_samples_regen(
            port, sky_state_from_ui(*SKY), create_camera(*EYE, 1.0), _tile(), 0,
            torch.zeros(64, 3), width=8, height=8, num_bounces=1, spp=1, num_frames=1,
            engine="reference", inkernel=False)
    with pytest.raises(ValueError, match="has no routes"):
        pt.render_image(port, sky_state_from_ui(*SKY), create_camera(*EYE, 1.0), width=8,
                        height=8, sampling=pt.SamplingParams(1, 1), engine="kernel_split",
                        segs=2)
    # The fused engines keep the regeneration loop on any scene; the unfused
    # ones take the scan form above SORT_THRESHOLD clusters.
    for threshold, unfused in ((256, pt.accumulate_samples_regen), (0, pt.accumulate_samples)):
        monkeypatch.setattr(pt, "SORT_THRESHOLD", threshold)
        for engine in ("kernel", "plain"):
            assert pt.pick_accumulator(port, engine) is pt.accumulate_samples_regen
        for engine in ("kernel_split", "reference", "wavefront"):
            assert pt.pick_accumulator(port, engine) is unfused


def test_textured_courtyard_matches_jax_golden():
    """The JAX golden test's render (tests/test_goldens.py), through the
    port: courtyard_scene(4, textured=True), 64x48, 2 spp, 3 bounces, the
    reference engine, RMSE < 5e-3."""
    from rayfinder_tpu_torch.scene.procedural import courtyard_scene as port_courtyard

    flat, textures = port_courtyard(4, textured=True)
    scene = build_device_scene(flat, textures=textures, device="cpu")
    img = pt.render_image(
        scene, sky_state_from_ui(*SKY), create_camera(*EYE, 64 / 48), width=64, height=48,
        sampling=pt.SamplingParams(2, 3), exposure=1.0, engine="reference")
    golden = read_png(GOLDENS / "courtyard_textured_64x48_2spp.png").astype(np.float32) / 255.0
    assert rmse(img, golden) < 5e-3
