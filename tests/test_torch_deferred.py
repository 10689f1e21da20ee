"""The port's deferred renderer (render/deferred.py) against the JAX package
on the CPU: each pass, three DeferredRenderer frames, the debug triptych,
the sun check of tests/test_renderer.py, and the JAX-baked golden of
tests/goldens/courtyard_deferred_128x96_f3.npz.

JAX runs with engine="reference" (the per-ray stack walk), the port with
"plain" (the packed walk, the plain version of K1/K2) and "reference" (the
plane walk). Scenes: courtyard_scene(4), untextured and textured, at 32x24
with the camera and sky of tests/test_torch_scan.py.

Budgets: hit and albedo exact; position, normal, depth and view_dir rtol
1e-6 / atol 1e-6; lighting rtol 2e-4 / atol 1e-5 (tests/test_pallas_regen.py);
u8 display at most 1 apart on at most 0.1% of pixels; images RMSE < 5e-3.
Pixels outside a budget are named below with their cause.
"""

import pathlib
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rayfinder_tpu.render import deferred as jd
from rayfinder_tpu.render.camera import create_camera as jax_camera
from rayfinder_tpu.render.scene import build_device_scene as jax_build
from rayfinder_tpu.scene.procedural import courtyard_scene
from rayfinder_tpu.sky.model import sky_state_from_ui as jax_sky
from rayfinder_tpu_torch.render import deferred as pd
from rayfinder_tpu_torch.render.camera import create_camera
from rayfinder_tpu_torch.render.scene import build_device_scene
from rayfinder_tpu_torch.sky.model import sky_state_from_ui
from rayfinder_tpu_torch.utils.image import rmse

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent / "goldens"))
import bake_torch_smoke as cfg  # noqa: E402

SKY = cfg.SKY
EXPOSURE = cfg.EXPOSURE
EYE = ([-16.0, 5.0, 0.0], [12.0, 2.0, 0.0], 0.0, 1.0, 70.0)
W, H = 32, 24

# A hit position may lie outside rtol/atol 1e-6 where the two packages'
# camera rays differ: each rounds generate_camera_ray its own way (XLA's CPU
# jit contracts its products into FMAs; torch's CPU sqrt is not rounded to
# nearest on every build and CPU), so their view directions differ by a few
# ulps (inside 1e-6), and the distance to a far hit multiplies that (row 18,
# pixels 576-607, looks down the far floor). Which pixels those are depends
# on the host, so test_gbuffer_matches_jax names them from the view
# directions themselves and holds each to depth x the rays' difference.
# Pixels whose primary hit lies on the textured courtyard's +x wall, where
# the interpolated UV u is 8.0 exactly: float32 rounding gives 8 -+ 5e-7,
# which wraps to texel column 191 or 0 of a brick texture, and XLA's FMAs
# round the other way than the port (ROADMAP.md section 3). Their albedo,
# and so their lighting and display, differ; every other pixel agrees.
TEXEL_WRAP = {0: [238, 239, 336], 1: [244, 303, 367, 369], 2: [239, 303]}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: these small tensors run faster on one, and the
    tier-1 run shares the machine's cores among its workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", params=[False, True], ids=["untextured", "textured"])
def scenes(request):
    flat, textures = courtyard_scene(4, textured=request.param)
    return (build_device_scene(flat, textures=textures, device="cpu"),
            jax_build(flat, textures=textures), request.param)


def _jax_gbuffer(jscene, frame):
    return jd.gbuffer_pass(jscene, jax_camera(*EYE, W / H), jnp.int32(frame), width=W,
                           height=H, engine="reference")


def _port_gbuffer(port, frame, engine):
    return pd.gbuffer_pass(port, create_camera(*EYE, W / H), frame, width=W, height=H,
                           engine=engine)


def _jax_lighting(jscene, gbuf, frame):
    return np.asarray(jd.lighting_pass(jscene, jax_sky(*SKY), gbuf, jnp.int32(frame), width=W,
                                       height=H, engine="reference"))


def _outside(got, want, rtol, atol):
    """Rows of (N, ...) arrays outside the tolerance."""
    close = np.isclose(got, want, rtol=rtol, atol=atol).reshape(got.shape[0], -1).all(axis=1)
    return set(np.nonzero(~close)[0].tolist())


@pytest.mark.parametrize("engine", ["plain", "reference"])
@pytest.mark.parametrize("frame", [0, 1])
def test_gbuffer_matches_jax(scenes, frame, engine):
    port, jscene, textured = scenes
    want = {k: np.asarray(v) for k, v in _jax_gbuffer(jscene, frame).items()}
    got = {k: v.numpy() for k, v in _port_gbuffer(port, frame, engine).items()}
    assert set(got) == set(want)
    np.testing.assert_array_equal(got["hit"], want["hit"])
    assert 0 < want["hit"].sum() < W * H
    for key in ("normal", "depth", "view_dir"):
        assert not _outside(got[key], want[key], 1e-6, 1e-6), key
    named = sorted(np.nonzero((got["view_dir"] != want["view_dir"]).any(axis=1))[0].tolist())
    assert _outside(got["position"], want["position"], 1e-6, 1e-6) <= set(named)
    # The named positions: the rays' difference times the hit distance.
    ray_diff = np.abs(got["view_dir"] - want["view_dir"]).max(axis=1)
    depth_diff = np.abs(got["depth"] - want["depth"])
    slack = ((want["depth"] * ray_diff + depth_diff)[:, None]
             + 1e-6 * (1 + np.abs(want["position"])))
    assert (np.abs(got["position"] - want["position"]) <= slack)[named].all()
    wrap = TEXEL_WRAP[frame] if textured else []
    differ = set(np.nonzero((got["albedo"] != want["albedo"]).any(axis=1))[0].tolist())
    assert differ <= set(wrap)
    # The albedo is quantized to 8 bits.
    np.testing.assert_array_equal(np.round(got["albedo"] * 255) % 1, 0.0)


@pytest.mark.parametrize("frame", [0, 1])
def test_lighting_matches_jax(scenes, frame):
    """The lighting pass on JAX's G-buffer (the pass alone), and the two
    passes end to end, within the regen budget."""
    port, jscene, textured = scenes
    jg = _jax_gbuffer(jscene, frame)
    want = _jax_lighting(jscene, jg, frame)
    sky = sky_state_from_ui(*SKY)
    on_jax_gbuffer = pd.lighting_pass(
        port, sky, {k: torch.from_numpy(np.array(v)) for k, v in jg.items()}, frame, width=W,
        height=H, engine="plain")
    np.testing.assert_allclose(on_jax_gbuffer.numpy(), want, rtol=2e-4, atol=1e-5)
    got = pd.lighting_pass(port, sky, _port_gbuffer(port, frame, "plain"), frame, width=W,
                           height=H, engine="plain").numpy()
    assert _outside(got, want, 2e-4, 1e-5) <= set(TEXEL_WRAP[frame] if textured else [])
    assert np.isfinite(got).all()


def test_resolve_display_matches_jax(scenes):
    """Frame 0 copies, later frames blend 0.1 / 0.9; the u8 display differs
    by at most 1 on at most 0.1% of the pixels (none but the named)."""
    port, jscene, textured = scenes
    rng = np.random.default_rng(9)
    sample = rng.uniform(-0.5, 30.0, (W * H, 3)).astype(np.float32)
    accum = rng.uniform(0.0, 30.0, (W * H, 3)).astype(np.float32)
    for frame in (0, 1, 2):
        ja, j8 = jd.resolve_pass(jnp.asarray(sample), jnp.asarray(accum), jnp.int32(frame),
                                 jnp.float32(EXPOSURE))
        pa, p8 = pd.resolve_pass(torch.from_numpy(sample), torch.from_numpy(accum), frame,
                                 EXPOSURE)
        np.testing.assert_allclose(pa.numpy(), np.asarray(ja), rtol=1e-6, atol=1e-6)
        if frame == 0:
            assert torch.equal(pa, torch.from_numpy(sample))
        diff = np.abs(p8.numpy().astype(int) - np.asarray(j8).astype(int))
        assert p8.dtype == torch.uint8 and diff.max() <= 1
        assert diff.any(axis=1).sum() <= 0.001 * W * H
    # The whole frame, end to end.
    for frame in (0, 1):
        want = _jax_lighting(jscene, _jax_gbuffer(jscene, frame), frame)
        got = pd.frame_pass(port, sky_state_from_ui(*SKY), create_camera(*EYE, W / H),
                            torch.zeros(W * H, 3), frame, EXPOSURE, width=W, height=H,
                            engine="plain")[1].numpy()
        j8 = np.asarray(jd.resolve_pass(jnp.asarray(want), jnp.zeros((W * H, 3), jnp.float32),
                                        jnp.int32(frame), jnp.float32(EXPOSURE))[1])
        diff = np.abs(got.astype(int) - j8.astype(int))
        keep = np.setdiff1d(np.arange(W * H), TEXEL_WRAP[frame] if textured else [])
        assert diff[keep].max() <= 1 and diff[keep].any(axis=1).sum() <= 0.001 * W * H


@pytest.mark.parametrize("engine", ["plain", "reference"])
def test_deferred_renderer_frames_match_jax(scenes, engine):
    """Three frames: display RMSE < 5e-3 against JAX's, the TAA blend, the
    perf_stats keys, and the resets of invalidate and resize."""
    port, jscene, textured = scenes
    jr = jd.DeferredRenderer(jscene, W, H, engine="reference")
    pr = pd.DeferredRenderer(port, W, H, engine=engine)
    cam, jcam = create_camera(*EYE, W / H), jax_camera(*EYE, W / H)
    # The TAA carries a texel-wrap pixel into the later frames.
    named = sorted({p for f in range(3) for p in TEXEL_WRAP[f]}) if textured else []
    keep = np.setdiff1d(np.arange(W * H), named)
    images = []
    for _ in range(3):
        want = jr.render(jcam, jax_sky(*SKY), EXPOSURE)
        got = pr.render(cam, sky_state_from_ui(*SKY), EXPOSURE)
        assert got.shape == (H, W, 3) and got.dtype == np.float32
        assert rmse(got.reshape(-1, 3)[keep], want.reshape(-1, 3)[keep]) < 5e-3
        images.append(got)
    assert pr.frame_count == 3
    assert not np.array_equal(images[0], images[1])  # TAA: a blend, not a copy
    # Outside a profiling.recording() block only the frame is timed (the
    # passes' times come from their spans, tests/test_torch_tracing.py).
    stats = pr.perf_stats()
    assert set(stats) == {"frame"} and "frame" in jr.perf_stats()
    assert stats["frame"] > 0.0
    pr.invalidate_temporal_accumulation()
    assert pr.frame_count == 0 and not bool(pr.accum.any())
    pr.render(cam, sky_state_from_ui(*SKY), EXPOSURE)
    pr.resize(16, 12)
    assert pr.frame_count == 0 and pr.accum.shape == (16 * 12, 3)
    assert pr.render(create_camera(*EYE, 16 / 12), sky_state_from_ui(*SKY)).shape == (12, 16, 3)


def test_render_debug_matches_jax(scenes):
    """The triptych at frame count 1, composed on the host by the same
    numpy code: within rtol 1e-5 / atol 1e-3 of JAX's but for the named
    pixels. The encoded normal is (0.5 n + 0.5) ** (1 / 2.2): NaN where an
    interpolated normal component is below -1, as in JAX, and 0, NaN or
    up to 6.5e-4 where it is -1 within an ulp (taken here as 0)."""
    port, jscene, textured = scenes
    jr = jd.DeferredRenderer(jscene, W, H, engine="reference")
    pr = pd.DeferredRenderer(port, W, H, engine="plain")
    jr.frame_count = pr.frame_count = 1
    with np.errstate(invalid="ignore"):
        want = jr.render_debug(jax_camera(*EYE, W / H))
        got = pr.render_debug(create_camera(*EYE, W / H))
    assert got.shape == (H, W, 3) and got.dtype == want.dtype
    got, want = np.nan_to_num(got).reshape(-1, 3), np.nan_to_num(want).reshape(-1, 3)
    assert _outside(got, want, 1e-5, 1e-3) <= set(TEXEL_WRAP[1] if textured else [])
    assert rmse(got, want) < 5e-3


def test_miss_pixels_see_the_solar_disk(scenes):
    """The miss branch adds the solar disk (lighting_pass.wgsl:203-236),
    unlike the path tracer's: a 9x9 camera above the courtyard's root box
    staring at the sun (odd size: the centre pixel's ray is the sun's
    direction) reads above 1e4 at the centre, as JAX does."""
    port, jscene, _ = scenes
    sky = sky_state_from_ui(1.0, (1.0, 1.0, 1.0), 30.0, 0.0)
    sun_dir = np.asarray(sky.sun_direction, np.float64)
    top = float(port.bvh_aabb_max[0, 1])
    origin = np.asarray([0.0, top + 50.0, 0.0])
    cam = create_camera(origin, origin + sun_dir, 0.0, 1.0, 10.0, 1.0)
    jcam = jax_camera(origin, origin + sun_dir, 0.0, 1.0, 10.0, 1.0)
    gbuf = pd.gbuffer_pass(port, cam, 0, width=9, height=9, engine="plain")
    assert not bool(gbuf["hit"].any())
    sample = pd.lighting_pass(port, sky, gbuf, 0, width=9, height=9, engine="plain").numpy()
    assert sample[40].max() > 1e4 and np.isfinite(sample).all()
    jg = jd.gbuffer_pass(jscene, jcam, jnp.int32(0), width=9, height=9, engine="reference")
    want = np.asarray(jd.lighting_pass(jscene, jax_sky(1.0, (1.0, 1.0, 1.0), 30.0, 0.0), jg,
                                       jnp.int32(0), width=9, height=9, engine="reference"))
    np.testing.assert_allclose(sample, want, rtol=2e-4, atol=1e-5)


def test_engines_and_devices():
    flat, textures = courtyard_scene(2)
    scene = build_device_scene(flat, textures=textures, device="cpu")
    with pytest.raises(ValueError, match="unknown traversal engine"):
        pd.DeferredRenderer(scene, 8, 6, engine="pallas")
    r = pd.DeferredRenderer(scene, 8, 6)
    assert r.engine == "kernel" and r.accum.device == scene.device
    # K1/K2's wrappers on CPU tensors run their plain versions.
    img = r.render(create_camera(*EYE, 8 / 6), sky_state_from_ui(*SKY), EXPOSURE)
    r2 = pd.DeferredRenderer(scene, 8, 6, engine="plain")
    np.testing.assert_array_equal(img, r2.render(create_camera(*EYE, 8 / 6),
                                                 sky_state_from_ui(*SKY), EXPOSURE))


def test_float_table_is_numpys_division_bit_for_bit():
    """The device-side conversion of every display byte equals numpy's
    u8.astype(float32) / float32(255), compared as bits."""
    want = np.arange(256, dtype=np.uint8).astype(np.float32) / np.float32(255.0)
    got = pd.to_float(torch.arange(256, dtype=torch.uint8), pd.float_table("cpu")).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_render_returns_numpys_float_frame_bit_for_bit(scenes):
    """Two frames (a copy into the history, then a blend): render's image is
    numpy's float32 conversion of the display bytes that a twin renderer's
    frame_pass gives for the same frame, bit for bit, as a new C-contiguous
    array each frame."""
    port, _, _ = scenes
    cam, sky = create_camera(*EYE, W / H), sky_state_from_ui(*SKY)
    r = pd.DeferredRenderer(port, W, H, engine="plain")
    twin = pd.DeferredRenderer(port, W, H, engine="plain")
    before = None
    for frame in (0, 1):
        got = r.render(cam, sky, EXPOSURE)
        twin.accum, img8 = pd.frame_pass(port, twin._device_sky(sky), cam, twin.accum, frame,
                                         EXPOSURE, width=W, height=H, engine="plain",
                                         tile=twin._tile)
        want = img8.numpy().reshape(H, W, 3).astype(np.float32) / np.float32(255.0)
        assert got.dtype == np.float32 and got.flags.c_contiguous and got.shape == (H, W, 3)
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
        assert before is None or not np.shares_memory(before, got)
        before = got


@pytest.mark.parametrize("textured", [False, True])
def test_deferred_frames_match_the_jax_golden(textured):
    """courtyard_scene(8) at 128x96, three frames (the golden's
    configuration, chip_smoke.py phase 10): the display and the triptych
    within RMSE 5e-3, and the untextured accumulator within the lighting
    budget."""
    kind = "textured" if textured else "untextured"
    golden = np.load(cfg.DEFERRED_GOLDEN)
    flat, textures = courtyard_scene(cfg.SUBDIV, textured=textured)
    scene = build_device_scene(flat, textures=textures, device="cpu")
    w, h = cfg.WIDTH, cfg.HEIGHT
    cam = create_camera(*cfg.CAMERA, w / h)
    r = pd.DeferredRenderer(scene, w, h, engine="plain")
    for _ in range(cfg.DEFERRED_FRAMES):
        img = r.render(cam, sky_state_from_ui(*SKY), EXPOSURE)
    assert rmse(img, golden[f"{kind}_display"] / 255.0) < 5e-3
    if not textured:  # (textured: the +x wall's texel wrap, carried by the TAA)
        assert not _outside(r.accum.numpy(), golden[f"{kind}_accum"], 2e-4, 1e-5)
    with np.errstate(invalid="ignore"):
        debug = r.render_debug(cam)
    assert rmse(np.nan_to_num(debug), np.nan_to_num(golden[f"{kind}_debug"])) < 5e-3
