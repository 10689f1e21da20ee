"""The fused loop's default route (render/pathtracer.py): with no route
keyword, accumulate_samples_regen and render_image run each dispatch inside
the in-kernel-shaded path kernel K4 (ops/regen_shaded.py; here its plain
version), in one call or in runs of samples under the scratch cap, and
count their rays exactly.

Budgets: against the JAX `reference` engine rtol 2e-4 / atol 1e-5 (XLA on
the CPU contracts products into FMAs; the port rounds each one), ray counts
equal; a capped dispatch against the uncapped one, and two calls of N/2
samples against one of N, bit for bit (torch.equal).
"""

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
from rayfinder_tpu_torch.ops import regen_shaded
from rayfinder_tpu_torch.ops.regen_shaded import trace_regen_shaded_reference
from rayfinder_tpu_torch.render import pathtracer as pt
from rayfinder_tpu_torch.render.camera import create_camera
from rayfinder_tpu_torch.render.intersect import T_MAX
from rayfinder_tpu_torch.render.rng import blue_noise_tile
from rayfinder_tpu_torch.render.scene import build_device_scene
from rayfinder_tpu_torch.render.tiling import block_order
from rayfinder_tpu_torch.sky.model import sky_state_from_ui

W, H, SPP, BOUNCES = 32, 24, 4, 3
CAM = ([-16.0, 5.0, 0.0], [12.0, 2.0, 0.0], 0.0, 1.0, 70.0, W / H)
SKY = (2.5, (0.3, 0.3, 0.3), 35.0, 25.0)
STATE = ("sample", "bounce", "flag", "origin", "direction", "thr", "srad", "lrad",
         "shadow_o", "shadow_d", "contrib")


@pytest.fixture(scope="module")
def courtyard():
    flat, textures = courtyard_scene(4)
    return build_device_scene(flat, textures=textures, device="cpu"), jax_build(flat, textures=textures)


@pytest.fixture(scope="module")
def jax_reference(courtyard):
    """The JAX regen loop with the per-ray stack walk: radiance and counts."""
    _, jscene = courtyard
    out, rays = jpt.accumulate_samples_regen(
        jscene, jax_sky(*SKY), jax_camera(*CAM), jnp.asarray(jax_tile()), jnp.int32(0),
        jnp.zeros((W * H, 3), jnp.float32), width=W, height=H, num_bounces=BOUNCES, spp=SPP,
        num_frames=SPP, engine="reference", count_rays=True)
    return np.asarray(out), np.asarray(rays)


def _port_regen(scene, frame_base=0, accum=None, num_frames=SPP, **kw):
    accum = torch.zeros(W * H, 3) if accum is None else accum
    return pt.accumulate_samples_regen(
        scene, sky_state_from_ui(*SKY), create_camera(*CAM), torch.from_numpy(blue_noise_tile()),
        frame_base, accum, width=W, height=H, num_bounces=BOUNCES, spp=SPP,
        num_frames=num_frames, **kw)


@pytest.fixture
def shaded_calls(monkeypatch):
    """The (num_frames, frame_base, live_floor) of each plain K4 call, and the
    number of plain K3 calls, made through the "kernel" engine on the CPU."""
    engine = pt._ENGINES["kernel"]
    calls = dict(shaded=[], split=0)

    def shaded(*args):
        calls["shaded"].append((args[9], args[7], args[11]))
        return engine.shaded(*args)

    def split(*args):
        calls["split"] += 1
        return engine.split(*args)

    monkeypatch.setitem(pt._ENGINES, "kernel", engine._replace(shaded=shaded, split=split))
    return calls


@pytest.mark.parametrize("floor", ["batch", "default", 16])
def test_inkernel_counts_equal_split_and_jax(courtyard, jax_reference, floor):
    """count_rays with inkernel=True: one K4 call (a floor of the batch, and
    the route's default floor), and the hybrid at a small floor (phase 0's
    split counts plus K4's), against the split route's counts and the JAX
    `reference` engine's, exactly."""
    port, _ = courtyard
    kw = {} if floor == "default" else {"compact_floor": W * H if floor == "batch" else floor}
    if floor == 16:
        assert len(pt._phase_sizes(W * H, 16)) > 2
    got, rays = _port_regen(port, inkernel=True, count_rays=True, **kw)
    split, split_rays = _port_regen(port, inkernel=False, count_rays=True)
    assert rays.dtype == torch.int64 and rays.shape == (2,)
    np.testing.assert_array_equal(rays.numpy(), split_rays.numpy())
    np.testing.assert_array_equal(rays.numpy(), jax_reference[1])
    np.testing.assert_allclose(got.numpy(), split.numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("entry", ["accumulate_samples_regen", "render_image"])
def test_default_route_matches_jax_reference(courtyard, jax_reference, entry, shaded_calls):
    """With no route keyword both entry points run each dispatch in one K4
    call and no K3 call, and hold against the JAX `reference` engine."""
    port, jscene = courtyard
    if entry == "accumulate_samples_regen":
        got, rays = _port_regen(port, count_rays=True)
        np.testing.assert_allclose(got.numpy(), jax_reference[0], rtol=2e-4, atol=1e-5)
        np.testing.assert_array_equal(rays.numpy(), jax_reference[1])
        assert shaded_calls == dict(shaded=[(SPP, 0, 0)], split=0)
        return
    sampling = dict(width=W, height=H, exposure=0.5, samples_per_dispatch=3)
    got = pt.render_image(port, sky_state_from_ui(*SKY), create_camera(*CAM),
                          sampling=pt.SamplingParams(SPP, BOUNCES), **sampling)
    want = jpt.render_image(jscene, jax_sky(*SKY), jax_camera(*CAM), engine="reference",
                            sampling=jpt.SamplingParams(SPP, BOUNCES), **sampling)
    np.testing.assert_allclose(got, np.asarray(want), rtol=2e-4, atol=1e-5)
    assert shaded_calls == dict(shaded=[(3, 0, 0), (1, 3, 0)], split=0)


def test_route_keywords_reach_the_other_routes(courtyard, shaded_calls):
    """inkernel=False is the split route (no K4 call); inkernel=True with a
    small compact_floor is the hybrid (K3 calls, then K4 calls with a floor
    and a last one at floor 0)."""
    port, _ = courtyard
    _port_regen(port, inkernel=False)
    assert shaded_calls["shaded"] == [] and shaded_calls["split"] > 0
    shaded_calls["split"] = 0
    _port_regen(port, inkernel=True, compact_floor=16)
    floors = [floor for _, _, floor in shaded_calls["shaded"]]
    assert shaded_calls["split"] > 0 and len(floors) > 1
    assert all(f > 0 for f in floors[:-1]) and floors[-1] == 0


@pytest.mark.parametrize("samples_per_call", [1, 3])
def test_capped_dispatch_equals_uncapped(courtyard, monkeypatch, shaded_calls, samples_per_call):
    """A dispatch whose K4 scratch would pass the cap runs in runs of
    samples (frame_base moved, lrad carried): radiance and ray counts equal
    the uncapped dispatch's bit for bit, from a non-zero accumulation."""
    port, _ = courtyard
    start = torch.from_numpy(np.random.default_rng(0).uniform(0, 2, (W * H, 3)).astype(np.float32))
    want, want_rays = _port_regen(port, accum=start, frame_base=1, num_frames=SPP - 1,
                                  count_rays=True)
    assert shaded_calls["shaded"] == [(SPP - 1, 1, 0)]
    shaded_calls["shaded"].clear()
    monkeypatch.setattr(regen_shaded, "SCRATCH_CAP_BYTES", 12 * W * H * samples_per_call)
    assert regen_shaded.samples_per_call(W * H) == samples_per_call
    got, rays = _port_regen(port, accum=start, frame_base=1, num_frames=SPP - 1, count_rays=True)
    runs = {1: [(1, 1, 0), (1, 2, 0), (1, 3, 0)], 3: [(3, 1, 0)]}[samples_per_call]
    assert shaded_calls["shaded"] == runs
    assert torch.equal(got, want) and torch.equal(rays, want_rays)


@pytest.mark.parametrize("tiles_per_call", [1, 3])
def test_hybrid_last_call_split_by_lanes(courtyard, monkeypatch, shaded_calls, tiles_per_call):
    """The hybrid's last K4 call (floor 0, every lane of the last phase in
    flight) whose scratch would pass the cap runs as chunks of whole tiles:
    radiance and ray counts equal the uncapped dispatch's bit for bit, and
    the counts equal the split route's."""
    port, _ = courtyard
    floor = 512  # phases [768, 512]: the last K4 call takes 4 tiles
    assert pt._phase_sizes(W * H, floor) == [W * H, floor]
    want, want_rays = _port_regen(port, inkernel=True, compact_floor=floor, count_rays=True)
    assert [f for _, _, f in shaded_calls["shaded"]] == [0]
    shaded_calls["shaded"].clear()
    monkeypatch.setattr(regen_shaded, "SCRATCH_CAP_BYTES", 12 * SPP * 128 * tiles_per_call)
    assert regen_shaded.lanes_per_call(SPP) == 128 * tiles_per_call
    got, rays = _port_regen(port, inkernel=True, compact_floor=floor, count_rays=True)
    assert shaded_calls["shaded"] == [(SPP, 0, 0)] * -(-floor // (128 * tiles_per_call))
    assert torch.equal(got, want) and torch.equal(rays, want_rays)
    _, split_rays = _port_regen(port, inkernel=False, count_rays=True)
    assert torch.equal(rays, split_rays)


def test_lanes_per_call_takes_whole_tiles():
    """A floor-0 call over lanes in flight takes whole 128-lane tiles inside
    the cap, and at least one: the 512x512 hybrid's last call of 256 samples
    in chunks of 682 tiles; one tile holds up to 174,762 samples."""
    assert regen_shaded.lanes_per_call(256) == 87_296 == 128 * (268_435_456 // (12 * 256 * 128))
    assert regen_shaded.lanes_per_call(16) == 1_398_016
    assert regen_shaded.lanes_per_call(174_762) == 128
    assert 12 * 128 * 174_762 <= regen_shaded.SCRATCH_CAP_BYTES < 12 * 128 * 174_763
    assert regen_shaded.lanes_per_call(10**6) == 128


def test_scratch_cap_is_stated_in_bytes():
    """The cap is a module constant in bytes; a (lane, sample) item takes 12
    of them, and a call always takes at least one sample."""
    assert regen_shaded.SCRATCH_CAP_BYTES == 268_435_456
    assert regen_shaded.samples_per_call(512 * 512) == 268_435_456 // (12 * 512 * 512) == 85
    assert regen_shaded.samples_per_call(1920 * 1080) == 10
    assert regen_shaded.samples_per_call(10**9) == 1


def test_two_calls_of_half_the_samples_equal_one(courtyard):
    """What the runs rely on, on the plain K4 itself: a call of N samples
    equals a call of the first N/2 followed by a call of N/2 whose
    frame_base is moved by N/2, from a fresh initial state and with the
    first call's lrad: lrad, every other output (the sample index counted
    from the run's start) and the ray counts."""
    port, _ = courtyard
    cam, sky = create_camera(*CAM), sky_state_from_ui(*SKY)
    ys, xs, _ = block_order(W, H)
    tile = torch.from_numpy(blue_noise_tile())
    lanes = dict(u=torch.from_numpy(((xs + 0.5) / W).astype(np.float32)),
                 v_tex=torch.from_numpy(((ys + 0.5) / H).astype(np.float32)),
                 noise_base=tile[torch.from_numpy(ys % 128).long(), torch.from_numpy(xs % 128).long()])
    n, half = W * H, SPP // 2
    inv_dims = (float(np.float32(1) / np.float32(W)), float(np.float32(1) / np.float32(H)))
    lrad0 = torch.from_numpy(np.random.default_rng(1).uniform(0, 2, (n, 3)).astype(np.float32))

    def call(frame_base, num_frames, lrad):
        d = pt._Dispatch(scene=port, sky=sky, camera=cam, kernels=pt._ENGINES["plain"],
                         inv_dims=inv_dims, frame_base=frame_base, spp=SPP, nf=num_frames,
                         num_bounces=BOUNCES)
        st = pt._initial_state(d, lanes, n, lrad.device)
        st["lrad"] = lrad
        out = trace_regen_shaded_reference(*d.pixel_args(lanes), BOUNCES, 0, T_MAX,
                                           *(st[k] for k in STATE))
        return dict(zip(STATE, out)), out[-1]

    one, one_rays = call(1, SPP, lrad0)
    first, first_rays = call(1, half, lrad0)
    second, second_rays = call(1 + half, SPP - half, first["lrad"])
    assert not torch.equal(first["lrad"], one["lrad"])
    assert torch.equal(second["sample"] + half, one["sample"])
    for k in STATE[1:]:
        assert torch.equal(second[k], one[k]), k
    assert torch.equal(first_rays + second_rays, one_rays)
