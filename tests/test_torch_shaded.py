"""The port's in-kernel-shaded path kernel K4 (ops/regen_shaded.py, plain
version of csrc/regen_shaded.cu) and its route through the fused loop
(accumulate_samples_regen(inkernel=True): one K4 call, or the hybrid below a
compact_floor) against the JAX package. tests/test_torch_default_route.py
holds the same route as the loop's default.

Budgets: against JAX, rtol 2e-4 / atol 1e-5 as in tests/test_torch_regen.py
(XLA on the CPU contracts products into FMAs; the port rounds each one), and
the JAX in-kernel hybrid's own budget rtol 1e-4 / atol 2e-3
(tests/test_pallas_regen.py::test_inkernel_shade_matches_split). Integers
(sample, bounce, flag) must match exactly. The scene is the textured
courtyard_scene(2): 1,504 triangles, 14 textures.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rayfinder_tpu.render import pathtracer as jpt
from rayfinder_tpu.render.camera import create_camera as jax_camera
from rayfinder_tpu.render.rng import blue_noise_tile as jax_tile
from rayfinder_tpu.render.scene import build_device_scene as jax_build
from rayfinder_tpu.scene.procedural import courtyard_scene
from rayfinder_tpu.sky.model import sky_state_from_ui as jax_sky
from rayfinder_tpu_torch.ops.regen import primaries, trace_regen_reference
from rayfinder_tpu_torch.ops.regen_shaded import trace_regen_shaded, trace_regen_shaded_reference
from rayfinder_tpu_torch.render.camera import create_camera, primary_ray
from rayfinder_tpu_torch.render.intersect import T_MAX
from rayfinder_tpu_torch.render.pathtracer import (
    _nee_and_continuation, _phase_sizes, accumulate_samples_regen,
)
from rayfinder_tpu_torch.render.rng import blue_noise_tile, noise_of
from rayfinder_tpu_torch.render.scene import scene_from_jax
from rayfinder_tpu_torch.render.tiling import block_order
from rayfinder_tpu_torch.sky.model import sky_state_from_ui

CAM = ([-16.0, 5.0, 0.0], [12.0, 2.0, 0.0], 0.2, 12.0, 70.0)
SKY = (2.5, (0.3, 0.3, 0.3), 35.0, 25.0)
STATE = ("sample", "bounce", "flag", "origin", "direction", "thr", "srad", "lrad",
         "shadow_o", "shadow_d", "contrib")


@pytest.fixture(scope="module")
def scenes():
    flat, textures = courtyard_scene(2, textured=True)
    jscene = jax_build(flat, textures=textures)
    return scene_from_jax({k: np.asarray(v) for k, v in vars(jscene).items()}, device="cpu"), jscene


def _lanes(w, h):
    ys, xs, _ = block_order(w, h)
    u = ((xs.astype(np.float32) + 0.5) / np.float32(w)).astype(np.float32)
    v = ((ys.astype(np.float32) + 0.5) / np.float32(h)).astype(np.float32)
    nb = blue_noise_tile()[ys % 128, xs % 128]
    return u, v, nb


def _after_split_steps(port, w, h, nf, spp, nb, steps=2):
    """Lane state after `steps` split steps (K3 + shade) of a w x h image,
    as numpy arrays: NEE pending, scatter continuations, terminations."""
    cam = create_camera(*CAM, w / h)
    sky = sky_state_from_ui(*SKY)
    u, v, nbase = (torch.from_numpy(a) for a in _lanes(w, h))
    inv_dims = (float(np.float32(1) / np.float32(w)), float(np.float32(1) / np.float32(h)))
    n = u.shape[0]
    sample = torch.zeros(n, dtype=torch.int32)
    o0, d0 = primary_ray(cam, u, v, noise_of(nbase, 0, sample, spp), inv_dims)
    z3 = torch.zeros(n, 3)
    state = dict(sample=sample, bounce=torch.ones_like(sample), flag=torch.zeros_like(sample),
                 origin=o0, direction=d0, thr=torch.ones(n, 3), srad=z3, lrad=z3,
                 shadow_o=torch.full((n, 3), 1e30),
                 shadow_d=torch.tensor([1.0, 0.0, 0.0]).expand(n, 3).contiguous(), contrib=z3)
    for _ in range(steps):
        (sample, bounce, org, dirn, thr, srad, lrad, _t, tri) = trace_regen_reference(
            port, cam, sky, u, v, nbase, inv_dims, 0, spp, nf, T_MAX,
            *(state[k] for k in STATE))
        flag, org, dirn, thr, bounce, sho, shd, con = _nee_and_continuation(
            port, noise_of(nbase, 0, sample, spp), org, dirn, tri, thr, bounce, sample < nf,
            torch.as_tensor(sky.sun_direction), torch.as_tensor(sky.solar_radiances), nb)
        state = dict(sample=sample, bounce=bounce, flag=flag, origin=org, direction=dirn,
                     thr=thr, srad=srad, lrad=lrad, shadow_o=sho, shadow_d=shd, contrib=con)
    return (u.numpy(), v.numpy(), nbase.numpy(), inv_dims,
            {k: x.numpy() for k, x in state.items()})


@pytest.mark.parametrize("live_floor", [0, 40])
def test_single_call_matches_pallas_kernel(scenes, live_floor):
    """One call of the plain K4 against pallas_trace_regen_shaded in
    interpret mode on 256 lanes (two 128-lane tiles), from the state after
    two split steps; a floor > 0 stops each tile at that many live lanes."""
    from rayfinder_tpu.ops.pallas_regen import pallas_trace_regen_shaded

    port, jscene = scenes
    w, h, nf, spp, nb = 16, 16, 3, 3, 2
    u, v, nbase, inv_dims, state = _after_split_steps(port, w, h, nf, spp, nb)
    flags = np.bincount(state["flag"], minlength=3)
    assert flags[1] > 0 and flags[2] > 0
    want = pallas_trace_regen_shaded(
        jscene, jax_camera(*CAM, w / h), jax_sky(*SKY), jnp.asarray(u), jnp.asarray(v),
        jnp.asarray(nbase), jnp.float32(1.0) / jnp.asarray([w, h], jnp.float32),
        jnp.int32(0), jnp.int32(spp), jnp.int32(nf), jnp.int32(nb), jnp.int32(live_floor),
        jnp.float32(T_MAX), *(jnp.asarray(state[k]) for k in STATE))
    got = trace_regen_shaded_reference(
        port, create_camera(*CAM, w / h), sky_state_from_ui(*SKY), torch.from_numpy(u),
        torch.from_numpy(v), torch.from_numpy(nbase), inv_dims, 0, spp, nf, nb, live_floor,
        T_MAX, *(torch.from_numpy(state[k]) for k in STATE))
    want = [np.asarray(x) for x in want]
    got = [x.numpy() for x in got]
    live = (got[0] < nf).reshape(2, 128).sum(axis=1)
    if live_floor:
        assert (live <= live_floor).all() and (live > 0).any()
    else:
        assert (live == 0).all()
    # Lanes where XLA's FMAs and the port's rounding pick different
    # triangles (hits within rounding of an edge) would be named here.
    differ = np.nonzero((got[0] != want[0]) | (got[1] != want[1]) | (got[2] != want[2]))[0]
    assert len(differ) == 0, f"lanes {differ.tolist()} differ"
    # Lane 120's third hit lies on the +x wall, whose UV u is 8.0 exactly:
    # interpolated in float32 it is 8 - 5e-7 here, which wraps to texel
    # column 191 of 192, and column 0 under XLA's FMAs. The neighbouring
    # texel changes its albedo by ~1% (thr, and lrad or contrib after it).
    texel_wrap = [120]
    keep = np.setdiff1d(np.arange(u.size), texel_wrap)
    for name, g, w_ in zip(STATE, got, want):
        if g.dtype.kind == "f":
            np.testing.assert_allclose(g[keep], w_[keep], rtol=2e-4, atol=1e-5, err_msg=name)
            np.testing.assert_allclose(g[texel_wrap], w_[texel_wrap], rtol=3e-2, err_msg=name)


def test_wrapper_runs_plain_version_on_cpu(scenes):
    port, _ = scenes
    w, h, nf, spp, nb = 16, 8, 2, 2, 2
    u, v, nbase, inv_dims, state = _after_split_steps(port, w, h, nf, spp, nb)
    args = (port, create_camera(*CAM, w / h), sky_state_from_ui(*SKY), torch.from_numpy(u),
            torch.from_numpy(v), torch.from_numpy(nbase), inv_dims, 0, spp, nf, nb, 0, T_MAX,
            *(torch.from_numpy(state[k]) for k in STATE))
    before = trace_regen_shaded.launches
    for a, b in zip(trace_regen_shaded(*args), trace_regen_shaded_reference(*args)):
        assert torch.equal(a, b)
    assert trace_regen_shaded.launches == before
    # The inputs are not modified.
    for k, x in zip(STATE, args[13:]):
        assert np.array_equal(x.numpy(), state[k]), k


@pytest.mark.parametrize("start", ["initial", "in_flight"])
def test_samples_are_independent_items(scenes, start):
    """What K4's work-item loop at floor 0 relies on: a sample's path depends
    on its pixel and its sample index alone. The plain version run once per
    sample (the lanes' state at sample s, num_frames = s + 1, zero lrad; the
    lane's input sample continues the input state, a later one starts from a
    fresh primary, an earlier one is done), its radiance folded in sample
    order, equals the plain whole-lane run bit for bit on lrad and, from the
    last sample, on the final state. Once from the initial state, once from
    the in-flight state that a call with a floor of 100 returns."""
    port, _ = scenes
    w, h, nf, spp, nb = 16, 16, 4, 4, 3
    cam, sky = create_camera(*CAM, w / h), sky_state_from_ui(*SKY)
    u, v, nbase, inv_dims, state = _after_split_steps(
        port, w, h, nf, spp, nb, steps=0 if start == "initial" else 2)
    u, v, nbase = (torch.from_numpy(a) for a in (u, v, nbase))
    state = {k: torch.from_numpy(x) for k, x in state.items()}

    def run(num_frames, floor, st):
        out = trace_regen_shaded_reference(port, cam, sky, u, v, nbase, inv_dims, 0, spp,
                                           num_frames, nb, floor, T_MAX, *(st[k] for k in STATE))
        return dict(zip(STATE, out))

    if start == "in_flight":
        state = run(nf, 100, state)
        live = state["sample"] < nf
        assert 0 < int(live.sum()) <= 200 and not bool(live.all())
        assert len(torch.unique(state["sample"])) > 2 and bool((state["flag"][live] > 0).any())
    whole = run(nf, 0, state)
    assert not bool((whole["sample"] < nf).any())

    n = u.shape[0]
    first = state["sample"].clamp(max=nf)
    lrad = state["lrad"].clone()
    for s in range(int(first.min()), nf):
        sample = torch.full_like(first, s)
        o, d = primaries(cam, u, v, nbase, inv_dims, 0, spp, torch.arange(n), sample)
        fresh = dict(sample=sample, bounce=torch.ones_like(first), flag=torch.zeros_like(first),
                     origin=o, direction=d, thr=torch.ones(n, 3), srad=torch.zeros(n, 3),
                     lrad=torch.zeros(n, 3), shadow_o=torch.full((n, 3), 1e30),
                     shadow_d=torch.zeros(n, 3), contrib=torch.zeros(n, 3))
        item = {}
        for k in STATE:
            keep = (first >= s).view(-1, *[1] * (fresh[k].dim() - 1))
            item[k] = torch.where(keep, state[k], fresh[k])
        # A lane whose input sample comes later has no item of sample s: it
        # is dead in this run and its input state passes through.
        item["sample"] = torch.where(first > s, s + 1, sample).to(torch.int32)
        item["lrad"] = torch.zeros(n, 3)
        out = run(s + 1, 0, item)
        lrad = torch.where((first <= s)[:, None], lrad + out["lrad"], lrad)
    assert torch.equal(lrad, whole["lrad"])
    # The item of a lane's last sample leaves the lane's final state. Lanes
    # with no sample left on entry pass through in both (same tiles live).
    for k in STATE:
        if k != "lrad":
            assert torch.equal(out[k], whole[k]), k


W, H, SPP = 32, 24, 2

# Pixels whose paths hit the +x wall, where the interpolated UV u is 8.0
# exactly: float32 rounding gives 8 -+ 5e-7, which wraps to texel column 191
# or 0 of a brick texture (brick or mortar), and XLA's FMAs round the other
# way than the port. Every route of the port (the split one included) and
# both JAX engines agree on every other pixel; the ray counts are equal.
TEXEL_WRAP = {(32, 24): [285, 318, 338, 400, 401], (16, 12): [72, 102]}


def _assert_close_except(got, want, named, rtol, atol):
    bad = np.nonzero(~np.isclose(got, want, rtol=rtol, atol=atol).all(axis=1))[0]
    assert set(bad.tolist()) <= set(named), f"pixels {bad.tolist()} differ"
    keep = np.setdiff1d(np.arange(got.shape[0]), named)
    np.testing.assert_allclose(got[keep], want[keep], rtol=rtol, atol=atol)


def _port_regen(port, **kw):
    return accumulate_samples_regen(
        port, sky_state_from_ui(*SKY), create_camera(*CAM, W / H),
        torch.from_numpy(blue_noise_tile()), 0, torch.zeros(W * H, 3), width=W, height=H,
        num_bounces=3, spp=SPP, num_frames=SPP, engine="plain", **kw)


@pytest.mark.parametrize("compact_floor", [None, 16])
def test_route_matches_jax_reference(scenes, compact_floor):
    """accumulate_samples_regen(inkernel=True) against the JAX regen loop
    with the per-ray stack walk (engine="reference"): a single K4 call, and
    the phased hybrid (split phase 0, then K4 calls down the ladder)."""
    port, jscene = scenes
    if compact_floor:
        assert len(_phase_sizes(W * H, compact_floor)) > 2
    want = jpt.accumulate_samples_regen(
        jscene, jax_sky(*SKY), jax_camera(*CAM, W / H), jnp.asarray(jax_tile()), jnp.int32(0),
        jnp.zeros((W * H, 3), jnp.float32), width=W, height=H, num_bounces=3, spp=SPP,
        num_frames=SPP, engine="reference")
    got = _port_regen(port, inkernel=True, compact_floor=compact_floor)
    _assert_close_except(got.numpy(), np.asarray(want), TEXEL_WRAP[W, H], rtol=2e-4, atol=1e-5)


def test_route_matches_jax_inkernel_hybrid(scenes, monkeypatch):
    """The port's in-kernel route against the JAX one (RAYFINDER_INKERNEL=1,
    Pallas in interpret mode) at 16x12, 2 spp, compact_floor 16."""
    port, jscene = scenes
    w, h = 16, 12
    monkeypatch.setenv("RAYFINDER_INKERNEL", "1")
    assert jpt._inkernel_enabled(jscene)
    jax.clear_caches()
    try:
        want = np.asarray(jpt.accumulate_samples_regen(
            jscene, jax_sky(*SKY), jax_camera(*CAM, w / h), jnp.asarray(jax_tile()),
            jnp.int32(0), jnp.zeros((w * h, 3), jnp.float32), width=w, height=h,
            num_bounces=3, spp=2, num_frames=2, engine="pallas", compact_floor=16))
    finally:
        monkeypatch.delenv("RAYFINDER_INKERNEL")
        jax.clear_caches()
    got = accumulate_samples_regen(
        port, sky_state_from_ui(*SKY), create_camera(*CAM, w / h),
        torch.from_numpy(blue_noise_tile()), 0, torch.zeros(w * h, 3), width=w, height=h,
        num_bounces=3, spp=2, num_frames=2, engine="plain", inkernel=True, compact_floor=16)
    _assert_close_except(got.numpy(), want, TEXEL_WRAP[w, h], rtol=1e-4, atol=2e-3)


@pytest.mark.parametrize("compact_floor", [None, 16])
def test_route_matches_split_route(scenes, compact_floor):
    """In-kernel and split routes, both plain: the same per-sample
    arithmetic; only the phase-end flushes regroup the sums."""
    port, _ = scenes
    split, split_rays = _port_regen(port, inkernel=False, count_rays=True,
                                    compact_floor=compact_floor)
    inker, rays = _port_regen(port, inkernel=True, count_rays=True, compact_floor=compact_floor)
    np.testing.assert_allclose(inker.numpy(), split.numpy(), rtol=1e-5, atol=1e-6)
    assert torch.equal(rays, split_rays)  # K4 counts its own rays


@pytest.mark.parametrize("kw, match", [
    (dict(segs=5), "1 .off. or one of"),
    (dict(inkernel=True, segs=2), "different routes"),
])
def test_bad_route_combinations_raise(scenes, kw, match):
    port, _ = scenes
    with pytest.raises(ValueError, match=match):
        _port_regen(port, **kw)
