"""The port's path kernel (ops/regen.py, plain version of csrc/regen.cu) and
the split route of its fused regeneration loop (render/pathtracer.py,
inkernel=False: K3 + a torch shade step) against the JAX package.

Budgets, as in tests/test_pallas_regen.py: rtol 2e-4 / atol 1e-5. The sky is
evaluated with acos (the TPU kernel uses a polynomial, |err| <= 2e-8 rad),
which the Perez term exp(p4 * gamma) amplifies near the sun; compacted
phases add finished lanes to their pixels at phase end, a few-ulp
regrouping; torch's and XLA's sin/cos/exp/pow differ by an ulp. Integers
(sample, bounce, hit triangle, ray counts) must match exactly.
"""

import pathlib
import sys

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
from rayfinder_tpu_torch.ops.regen import trace_regen, trace_regen_reference
from rayfinder_tpu_torch.render.camera import create_camera, primary_ray
from rayfinder_tpu_torch.render.intersect import T_MAX
from rayfinder_tpu_torch.render.pathtracer import _phase_sizes, accumulate_samples_regen
from rayfinder_tpu_torch.render.rng import blue_noise_tile, noise_of
from rayfinder_tpu_torch.render.scene import build_device_scene, scene_from_jax
from rayfinder_tpu_torch.render.tiling import block_order
from rayfinder_tpu_torch.sky.model import sky_state_from_ui

ROOT = pathlib.Path(__file__).resolve().parent.parent

# The test_pallas_regen.py courtyard configuration.
W, H, SPP = 32, 24, 2
CAM = ([-16.0, 5.0, 0.0], [12.0, 2.0, 0.0], 0.0, 1.0, 70.0, W / H)
SKY = (2.5, (0.3, 0.3, 0.3), 35.0, 25.0)


def _procedural():
    sys.path.insert(0, str(ROOT))
    from __graft_entry__ import _procedural_scene

    return _procedural_scene(num_triangles=256)


def _lanes(w, h):
    ys, xs, _ = block_order(w, h)
    u = ((xs.astype(np.float32) + 0.5) / np.float32(w)).astype(np.float32)
    v = ((ys.astype(np.float32) + 0.5) / np.float32(h)).astype(np.float32)
    nb = blue_noise_tile()[ys % 128, xs % 128]
    return u, v, nb


def test_trace_regen_matches_pallas_kernel():
    """Three calls of the plain path kernel against pallas_trace_regen in
    interpret mode, from the same lane state: fresh primaries, then twice
    the state after JAX's own shade step (NEE pending with a scatter
    continuation, then with depth-limited paths that terminate)."""
    from rayfinder_tpu.ops.pallas_regen import pallas_trace_regen

    jscene = _procedural()
    port = scene_from_jax({k: np.asarray(v) for k, v in vars(jscene).items()}, device="cpu")
    w, h, nf, spp, nb = 40, 32, 3, 3, 2
    jcam = jax_camera([0.0, 0.0, 12.0], [0.0, 0.0, 0.0], 0.0, 1.0, 70.0, w / h)
    cam = create_camera([0.0, 0.0, 12.0], [0.0, 0.0, 0.0], 0.0, 1.0, 70.0, w / h)
    jsky, sky = jax_sky(1.5, (0.8, 0.8, 0.8), 35.0, 10.0), sky_state_from_ui(1.5, (0.8, 0.8, 0.8), 35.0, 10.0)
    u, v, nbase = _lanes(w, h)
    n = u.size
    inv_dims = (float(np.float32(1) / np.float32(w)), float(np.float32(1) / np.float32(h)))
    sample = np.zeros(n, np.int32)
    o0, d0 = primary_ray(cam, torch.from_numpy(u), torch.from_numpy(v),
                         noise_of(torch.from_numpy(nbase), 0, torch.from_numpy(sample), spp), inv_dims)
    z3 = np.zeros((n, 3), np.float32)
    state = dict(sample=sample, bounce=np.ones(n, np.int32), flag=np.zeros(n, np.int32),
                 origin=o0.numpy(), direction=d0.numpy(), thr=np.ones((n, 3), np.float32),
                 srad=z3, lrad=z3, shadow_o=np.full((n, 3), 1e30, np.float32),
                 shadow_d=np.tile(np.float32([1, 0, 0]), (n, 1)), contrib=z3)
    keys = ("sample", "bounce", "flag", "origin", "direction", "thr", "srad", "lrad",
            "shadow_o", "shadow_d", "contrib")
    names = ("sample", "bounce", "origin", "direction", "thr", "srad", "lrad", "t", "tri")
    flags_seen = set()
    for call in range(3):
        want = pallas_trace_regen(
            jscene, jcam, jsky, jnp.asarray(u), jnp.asarray(v), jnp.asarray(nbase),
            jnp.float32(1.0) / jnp.asarray([w, h], jnp.float32), jnp.int32(0),
            jnp.int32(spp), jnp.int32(nf), jnp.float32(1e4),
            *(jnp.asarray(state[k]) for k in keys))
        got = trace_regen_reference(
            port, cam, sky, torch.from_numpy(u), torch.from_numpy(v), torch.from_numpy(nbase),
            inv_dims, 0, spp, nf, T_MAX, *(torch.from_numpy(np.array(state[k])) for k in keys))
        want = [np.asarray(x) for x in want]
        got = [x.numpy() for x in got]
        # Lanes where the TPU sweep and the stack walk pick different
        # triangles (hits within rounding of an edge) are named here.
        differ = np.nonzero((got[0] != want[0]) | (got[1] != want[1]) | (got[8] != want[8]))[0]
        assert len(differ) == 0, f"call {call}: lanes {differ.tolist()} differ"
        for name, g, w_ in zip(names, got, want):
            if g.dtype.kind == "f":
                np.testing.assert_allclose(g, w_, rtol=2e-4, atol=1e-5, err_msg=f"call {call}: {name}")
        # JAX's shade step prepares the next call's state.
        sample1, bounce1, o1, d1, thr1, srad1, lrad1, _, tri1 = (jnp.asarray(x) for x in want)
        flag, o2, d2, thr2, bounce2, sh_o, sh_d, contrib = jpt._nee_and_continuation(
            jscene, jpt_noise(nbase, sample1, spp), o1, d1, tri1, thr1, bounce1,
            sample1 < nf, jnp.asarray(jsky.sun_direction), jnp.asarray(jsky.solar_radiances),
            jnp.asarray([1e30, 1e30, 1e30], jnp.float32), nb)
        if call < 2:
            flags_seen |= set(np.unique(np.asarray(flag)).tolist())
        state = dict(sample=want[0], bounce=bounce2, flag=flag, origin=o2, direction=d2,
                     thr=thr2, srad=want[5], lrad=want[6], shadow_o=sh_o, shadow_d=sh_d,
                     contrib=contrib)
        state = {k: np.asarray(x) for k, x in state.items()}
    assert {1, 2} <= flags_seen


def jpt_noise(nbase, sample, spp):
    """JAX-side per-lane noise (pathtracer._noise_of with frame_base 0)."""
    from rayfinder_tpu.render.rng import _A1, _A2

    n = (sample % jnp.int32(spp)).astype(jnp.float32)
    r2 = jnp.stack([_A1 * n, _A2 * n], axis=-1)
    r2 = r2 - jnp.floor(r2)
    out = jnp.asarray(nbase) + r2
    return out - jnp.floor(out)


def test_trace_regen_wrapper_runs_plain_version_on_cpu():
    flat, textures = courtyard_scene(2)
    scene = build_device_scene(flat, textures=textures, device="cpu")
    cam = create_camera(*CAM)
    sky = sky_state_from_ui(*SKY)
    u, v, nbase = (torch.from_numpy(a) for a in _lanes(16, 8))
    n = u.shape[0]
    sample = torch.zeros(n, dtype=torch.int32)
    o, d = primary_ray(cam, u, v, noise_of(nbase, 0, sample, 4), (1 / 16, 1 / 8))
    z3 = torch.zeros(n, 3)
    args = (scene, cam, sky, u, v, nbase, (1 / 16, 1 / 8), 0, 4, 2, T_MAX, sample,
            torch.ones_like(sample), torch.zeros_like(sample), o, d, torch.ones(n, 3), z3, z3,
            torch.full((n, 3), 1e30), torch.tensor([1.0, 0, 0]).expand(n, 3), z3)
    before = trace_regen.launches
    for a, b in zip(trace_regen(*args), trace_regen_reference(*args)):
        assert torch.equal(a, b)
    assert trace_regen.launches == before
    # The inputs are not modified.
    assert not bool(args[11].any()) and not bool(args[17].any())


@pytest.fixture(scope="module")
def courtyard():
    flat, textures = courtyard_scene(8)
    return build_device_scene(flat, textures=textures, device="cpu"), jax_build(flat, textures=textures)


def _jax_regen(jscene, num_bounces, **kw):
    out, rays = jpt.accumulate_samples_regen(
        jscene, jax_sky(*SKY), jax_camera(*CAM), jnp.asarray(jax_tile()), jnp.int32(0),
        jnp.zeros((W * H, 3), jnp.float32), width=W, height=H, num_bounces=num_bounces,
        spp=SPP, num_frames=SPP, engine="reference", count_rays=True, **kw)
    return np.asarray(out), np.asarray(rays)


def _port_regen(scene, num_bounces, frame_base=0, accum=None, num_frames=SPP, **kw):
    """The split route, by its keyword."""
    accum = torch.zeros(W * H, 3) if accum is None else accum
    out, rays = accumulate_samples_regen(
        scene, sky_state_from_ui(*SKY), create_camera(*CAM), torch.from_numpy(blue_noise_tile()),
        frame_base, accum, width=W, height=H, num_bounces=num_bounces, spp=SPP,
        num_frames=num_frames, count_rays=True, inkernel=False, **kw)
    return out, rays


@pytest.mark.parametrize("case", ["three_bounces", "single_bounce", "compact_floor_16"])
def test_slice_matches_jax_reference(courtyard, case):
    """accumulate_samples_regen through the port's fused loop against the
    JAX regen loop with the per-ray stack walk (engine="reference")."""
    port, jscene = courtyard
    nb = 1 if case == "single_bounce" else 3
    kw = {"compact_floor": 16} if case == "compact_floor_16" else {}
    if kw:
        assert len(_phase_sizes(W * H, 16)) > 2  # the compacted phases run
    want, want_rays = _jax_regen(jscene, nb)
    got, rays = _port_regen(port, nb, **kw)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=1e-5)
    np.testing.assert_array_equal(rays.numpy(), want_rays)


def test_slice_half_dispatches_match_one(courtyard):
    """Two dispatches of spp/2 samples == one dispatch of spp."""
    port, _ = courtyard
    one, one_rays = _port_regen(port, 2)
    half, rays_a = _port_regen(port, 2, num_frames=SPP // 2)
    two, rays_b = _port_regen(port, 2, frame_base=SPP // 2, accum=half, num_frames=SPP // 2)
    np.testing.assert_allclose(two.numpy(), one.numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal((rays_a + rays_b).numpy(), one_rays.numpy())


def test_unknown_engine_raises(courtyard):
    port, _ = courtyard
    with pytest.raises(ValueError, match="unknown engine"):
        _port_regen(port, 1, engine="pallas")


def test_phase_sizes_match_jax():
    for batch, floor in ((262144, 4096), (480000, 4096), (768, 16), (12288, 4096), (768, 4096)):
        assert _phase_sizes(batch, floor) == jpt._phase_sizes(batch, floor)
