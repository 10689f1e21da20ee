"""The port's multi-segment path kernel K5 (ops/regen_segs.py, plain version
of csrc/regen_segs.cu) and its route through the fused loop
(accumulate_samples_regen(segs=K)) against the JAX package.

Budgets, as in tests/test_torch_regen.py: rtol 2e-4 / atol 1e-5 against
JAX (XLA on the CPU contracts products into FMAs; the port rounds each one);
integers (samples, bounces, hit triangles, the allocator, ray counts) must
match exactly. The scene is the textured courtyard_scene(2).
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
from rayfinder_tpu_torch.ops.regen_segs import trace_regen_segs, trace_regen_segs_reference
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
SLOTS = ("salloc", "lrad", "slot_cnt", "slot_ray", "slot_thr", "slot_nee")
OUTS = ("salloc", "lrad", "ocnt", "oray", "othr", "t")


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


def _slots_after(port, w, h, nf, spp, nb, segs, iterations):
    """Slot state of a w x h image after `iterations` iterations of the
    segs loop (K5 + the shade of the K slots), as numpy arrays."""
    cam = create_camera(*CAM, w / h)
    sky = sky_state_from_ui(*SKY)
    u, v, nbase = (torch.from_numpy(a) for a in _lanes(w, h))
    inv_dims = (float(np.float32(1) / np.float32(w)), float(np.float32(1) / np.float32(h)))
    n = u.shape[0]
    sample = torch.arange(segs, dtype=torch.int32).repeat(n)
    rep = n * segs
    o0, d0 = primary_ray(cam, u.repeat_interleave(segs), v.repeat_interleave(segs),
                         noise_of(nbase.repeat_interleave(segs, 0), 0, sample, spp), inv_dims)
    state = dict(
        salloc=torch.full((n,), segs, dtype=torch.int32),
        lrad=torch.zeros(n, 3),
        slot_cnt=torch.stack([sample, torch.ones_like(sample), torch.zeros_like(sample)], 1),
        slot_ray=torch.cat([o0, d0], 1),
        slot_thr=torch.cat([torch.ones(rep, 3), torch.zeros(rep, 3)], 1),
        slot_nee=torch.cat([torch.full((rep, 3), 1e30),
                            torch.tensor([1.0, 0.0, 0.0]).expand(rep, 3),
                            torch.zeros(rep, 3)], 1),
    )
    for k, c in (("slot_cnt", 3), ("slot_ray", 6), ("slot_thr", 6), ("slot_nee", 9)):
        state[k] = state[k].reshape(n, c * segs)
    for _ in range(iterations):
        salloc, lrad, ocnt, oray, othr, _t = trace_regen_segs_reference(
            port, cam, sky, u, v, nbase, inv_dims, 0, spp, nf, T_MAX,
            *(state[k] for k in SLOTS))
        cnt, ray, thr = ocnt.view(-1, 3), oray.view(-1, 6), othr.view(-1, 6)
        flag, org, dirn, thr3, bounce, sho, shd, con = _nee_and_continuation(
            port, noise_of(nbase.repeat_interleave(segs, 0), 0, cnt[:, 0], spp), ray[:, 0:3],
            ray[:, 3:6], cnt[:, 2], thr[:, 0:3], cnt[:, 1], cnt[:, 0] < nf,
            torch.as_tensor(sky.sun_direction), torch.as_tensor(sky.solar_radiances), nb)
        state = dict(
            salloc=salloc, lrad=lrad,
            slot_cnt=torch.stack([cnt[:, 0], bounce, flag], 1).reshape(n, 3 * segs),
            slot_ray=torch.cat([org, dirn], 1).reshape(n, 6 * segs),
            slot_thr=torch.cat([thr3, thr[:, 3:6]], 1).reshape(n, 6 * segs),
            slot_nee=torch.cat([sho, shd, con], 1).reshape(n, 9 * segs),
        )
    return (u.numpy(), v.numpy(), nbase.numpy(), inv_dims,
            {k: x.numpy() for k, x in state.items()})


@pytest.mark.parametrize("iterations", [0, 2])
def test_single_call_matches_pallas_kernel(scenes, iterations):
    """One call of the plain K5 (K = 2) against pallas_trace_regen_segs in
    interpret mode on 256 lanes: from fresh slots (samples 0 and 1), and
    after two iterations (NEE pending, terminations that take a sample from
    the allocator)."""
    from rayfinder_tpu.ops.pallas_regen import pallas_trace_regen_segs

    port, jscene = scenes
    w, h, nf, spp, nb, segs = 16, 16, 4, 4, 2, 2
    u, v, nbase, inv_dims, state = _slots_after(port, w, h, nf, spp, nb, segs, iterations)
    if iterations:
        flags = np.bincount(state["slot_cnt"][:, 2::3].reshape(-1), minlength=3)
        assert flags[1] > 0 and flags[2] > 0
    want = pallas_trace_regen_segs(
        jscene, jax_camera(*CAM, w / h), jax_sky(*SKY), jnp.asarray(u), jnp.asarray(v),
        jnp.asarray(nbase), jnp.float32(1.0) / jnp.asarray([w, h], jnp.float32),
        jnp.int32(0), jnp.int32(spp), jnp.int32(nf), jnp.float32(T_MAX),
        *(jnp.asarray(state[k]) for k in SLOTS), segs=segs)
    got = trace_regen_segs_reference(
        port, create_camera(*CAM, w / h), sky_state_from_ui(*SKY), torch.from_numpy(u),
        torch.from_numpy(v), torch.from_numpy(nbase), inv_dims, 0, spp, nf, T_MAX,
        *(torch.from_numpy(state[k]) for k in SLOTS))
    want = [np.asarray(x) for x in want]
    got = [x.numpy() for x in got]
    # Every slot with samples left stopped at a hit.
    ssample, tri = got[2][:, 0::3], got[2][:, 2::3]
    assert ((ssample >= nf) | (tri >= 0)).all() and (tri >= 0).any()
    # Slot 0 of lane 166 (after two iterations) reaches the floor under a
    # crate, whose bottom face is coplanar with the floor: triangles 264 and
    # 174 both hit at the same t, and the TPU sweep's cluster order and the
    # stack walk's near-first order keep different ones. Nothing else of
    # the lane differs.
    ties = {(2, 166, 0)}
    lane, slot = np.nonzero(tri != want[2][:, 2::3])
    assert {(iterations, a, b) for a, b in zip(lane.tolist(), slot.tolist())} <= ties
    got[2][lane, 3 * slot + 2] = want[2][lane, 3 * slot + 2]
    for name, g, w_ in zip(OUTS, got, want):
        assert g.shape == w_.shape, name
        if g.dtype.kind == "f":
            np.testing.assert_allclose(g, w_, rtol=2e-4, atol=1e-5, err_msg=name)
        else:
            np.testing.assert_array_equal(g, w_, err_msg=name)


def test_wrapper_runs_plain_version_on_cpu(scenes):
    port, _ = scenes
    w, h, nf, spp, nb, segs = 16, 8, 3, 3, 2, 3
    u, v, nbase, inv_dims, state = _slots_after(port, w, h, nf, spp, nb, segs, 1)
    args = (port, create_camera(*CAM, w / h), sky_state_from_ui(*SKY), torch.from_numpy(u),
            torch.from_numpy(v), torch.from_numpy(nbase), inv_dims, 0, spp, nf, T_MAX,
            *(torch.from_numpy(state[k]) for k in SLOTS))
    before = trace_regen_segs.launches
    for a, b in zip(trace_regen_segs(*args), trace_regen_segs_reference(*args)):
        assert torch.equal(a, b)
    assert trace_regen_segs.launches == before
    for k, x in zip(SLOTS, args[11:]):
        assert np.array_equal(x.numpy(), state[k]), k
    with pytest.raises(ValueError, match="3 x segs"):
        trace_regen_segs(*args[:13], args[13][:, :8], *args[14:])


W, H, SPP = 32, 24, 2

# Pixels whose paths hit the +x wall, where the interpolated UV u is 8.0
# exactly: float32 rounding gives 8 -+ 5e-7, which wraps to texel column 191
# or 0 of a brick texture, and XLA's FMAs round the other way than the port
# (tests/test_torch_shaded.py). The ray counts are equal.
TEXEL_WRAP = [285, 318, 338, 400, 401]


def _port_regen(port, **kw):
    return accumulate_samples_regen(
        port, sky_state_from_ui(*SKY), create_camera(*CAM, W / H),
        torch.from_numpy(blue_noise_tile()), 0, torch.zeros(W * H, 3), width=W, height=H,
        num_bounces=3, spp=SPP, num_frames=SPP, engine="plain", count_rays=True, **kw)


@pytest.fixture(scope="module")
def jax_reference(scenes):
    _, jscene = scenes
    out, rays = jpt.accumulate_samples_regen(
        jscene, jax_sky(*SKY), jax_camera(*CAM, W / H), jnp.asarray(jax_tile()), jnp.int32(0),
        jnp.zeros((W * H, 3), jnp.float32), width=W, height=H, num_bounces=3, spp=SPP,
        num_frames=SPP, engine="reference", count_rays=True)
    return np.asarray(out), np.asarray(rays)


@pytest.mark.parametrize("segs, compact_floor", [(2, None), (3, 16), (4, None)])
def test_route_matches_jax_reference(scenes, jax_reference, segs, compact_floor):
    """accumulate_samples_regen(segs=K) against the JAX regen loop with the
    per-ray stack walk (engine="reference"), with equal ray counts."""
    port, _ = scenes
    if compact_floor:
        assert len(_phase_sizes(W * H, compact_floor)) > 2
    want, want_rays = jax_reference
    got, rays = _port_regen(port, segs=segs, compact_floor=compact_floor)
    got = got.numpy()
    bad = np.nonzero(~np.isclose(got, want, rtol=2e-4, atol=1e-5).all(axis=1))[0]
    assert set(bad.tolist()) <= set(TEXEL_WRAP), f"pixels {bad.tolist()} differ"
    keep = np.setdiff1d(np.arange(W * H), TEXEL_WRAP)
    np.testing.assert_allclose(got[keep], want[keep], rtol=2e-4, atol=1e-5)
    np.testing.assert_array_equal(rays.numpy(), want_rays)


@pytest.mark.parametrize("segs", [2, 3])
def test_route_matches_split_route(scenes, segs):
    """Segs and split routes, both plain: each sample's arithmetic is the
    same; only the order in which samples add into a lane's radiance
    differs. Ray counts are equal."""
    port, _ = scenes
    split, split_rays = _port_regen(port)
    got, rays = _port_regen(port, segs=segs)
    np.testing.assert_allclose(got.numpy(), split.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(rays.numpy(), split_rays.numpy())


@pytest.mark.parametrize("segs", [0, 5, -1])
def test_segs_outside_range_raises(scenes, segs):
    port, _ = scenes
    with pytest.raises(ValueError, match="segs="):
        _port_regen(port, segs=segs)
