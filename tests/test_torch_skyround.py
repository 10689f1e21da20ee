"""The sky-round probe (K8, ops/skyround.py) on the CPU, where its wrapper
runs the plain version.

Each mode's acc is held to a jnp loop written here after the TPU probe
(prof/prof_skyround.py make_kernel) over the JAX kernels' own per-lane
helpers (_noise_rows, _primary_rows, _sky_rows of
rayfinder_tpu/ops/pallas_regen.py, fed _pack_fscal) and, for the sweep, the
JAX `reference` engine's closest hit. The tolerance is rtol 1e-5: the JAX
sky takes acos from a polynomial and the port from acosf, within 2e-6 per
term and 1e-5 near the sun and the horizon.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rayfinder_tpu.ops import pallas_regen as pr
from rayfinder_tpu.render.camera import create_camera as jax_camera
from rayfinder_tpu.render.scene import build_device_scene as jax_build
from rayfinder_tpu.render.traverse import intersect_closest as jax_closest
from rayfinder_tpu.scene.procedural import courtyard_scene
from rayfinder_tpu.sky.model import sky_state_from_ui as jax_sky
from rayfinder_tpu_torch.ops.skyround import GROUP, MODES, sky_round, sky_round_reference
from rayfinder_tpu_torch.render.camera import create_camera
from rayfinder_tpu_torch.render.scene import build_device_scene
from rayfinder_tpu_torch.sky.model import sky_state_from_ui

CAMERA = ([-16.0, 5.0, 0.0], [12.0, 2.0, 0.0], 0.0, 1.0, 70.0, 800 / 600)
SKY = (1.0, (1.0, 1.0, 1.0), 30.0, 0.0)
INV_DIMS = (float(np.float32(1.0) / np.float32(800.0)),
            float(np.float32(1.0) / np.float32(600.0)))
T_MAX = 1e30
ROUNDS = 4


@pytest.fixture(scope="module")
def scenes():
    flat, textures = courtyard_scene(2)
    return (build_device_scene(flat, textures=textures, device="cpu"),
            jax_build(flat, textures=textures))


def _lanes():
    """Three tiles of the probe's lanes (u across the tile, noise base
    (0.25, 0.75)) at v = 0.05, 0.3 and 0.6: sky and geometry both."""
    u = np.tile(np.linspace(0.05, 0.95, 256, dtype=np.float32), 3)
    v = np.repeat(np.asarray([0.05, 0.3, 0.6], np.float32), 256)
    nb = np.broadcast_to(np.asarray([0.25, 0.75], np.float32), (u.size, 2)).copy()
    return u, v, nb


def _jax_probe(jscene, u, v, nb, mode, rounds):
    """The TPU probe's loop in jnp, one group of GROUP lanes per vote."""
    f = pr._pack_fscal(jax_camera(*CAMERA), jax_sky(*SKY), T_MAX,
                       jnp.asarray(INV_DIMS, jnp.float32))
    iscal = jnp.asarray([0, 256, 1 << 20], jnp.int32)
    u, v, nb0, nb1 = jnp.asarray(u), jnp.asarray(v), jnp.asarray(nb[:, 0]), jnp.asarray(nb[:, 1])
    n = u.shape[0]

    def start(sample):
        nx, ny = pr._noise_rows(sample, nb0, nb1, iscal)
        ox, oy, oz, dx, dy, dz = pr._primary_rows(u, v, nx, ny, f)
        return jnp.stack([ox, oy, oz], 1), jnp.stack([dx, dy, dz], 1)

    def sweep(o, d):
        hit, t, _, _ = jax_closest(jscene, o, d, jnp.float32(T_MAX))
        return hit, t

    def sky(d):
        r, g, b = pr._sky_rows(d[:, 0], d[:, 1], d[:, 2], f)
        return r, g, b

    sample = jnp.zeros(n, jnp.int32)
    o, d = start(sample)
    a0 = jnp.zeros(n, jnp.float32)
    if mode != "fullwhile":
        for _ in range(rounds):
            if mode in ("full", "sweeponly"):
                hit, t = sweep(o, d)
                a0 = a0 + jnp.where(hit, t, jnp.float32(0.0))
            if mode in ("full", "nosweep"):
                r, g, b = sky(d)
                a0 = a0 + r + g + b
                sample = sample + 1
                o, d = start(sample)
            else:
                sample = sample + 1
            if mode == "noop":
                a0 = a0 + d[:, 0]
        return np.asarray(a0)
    group = np.arange(n) // GROUP
    running = np.ones(group[-1] + 1, bool)
    while running.any():
        live = jnp.asarray(running[group]) & (sample < rounds)
        hit, t = sweep(o, d)
        hit = hit & live
        a0 = a0 + jnp.where(hit, t, jnp.float32(0.0))
        r, g, b = sky(d)
        miss = live & ~hit
        a0 = a0 + jnp.where(miss, r + g + b, jnp.float32(0.0))
        sample = sample + jnp.where(miss, 1, 0)
        regen = miss & (sample < rounds)
        no, nd = start(sample)
        o, d = jnp.where(regen[:, None], no, o), jnp.where(regen[:, None], nd, d)
        running = np.zeros_like(running)
        running[group[np.asarray(regen)]] = True
    return np.asarray(a0)


def _port_args(scene):
    u, v, nb = (torch.from_numpy(a) for a in _lanes())
    return (scene, create_camera(*CAMERA), sky_state_from_ui(*SKY), u, v, nb, INV_DIMS)


@pytest.mark.parametrize("mode", MODES)
def test_plain_probe_matches_jax_loop(scenes, mode):
    port, jscene = scenes
    before = sky_round.launches
    got = sky_round(*_port_args(port), ROUNDS, mode).numpy()
    assert sky_round.launches == before
    want = _jax_probe(jscene, *_lanes(), mode, ROUNDS)
    assert got.shape == want.shape == (768,) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)


@pytest.mark.parametrize("mode", MODES)
def test_plain_probe_over_the_packed_walk_is_equal(scenes, mode, monkeypatch):
    """The kernel's sweep walks the packed tables (csrc/traverse2.cuh); its
    plain form (render/traverse.py intersect_packed) in place of the plane
    walk gives the plain probe's acc bit for bit, in every mode."""
    from rayfinder_tpu_torch.ops import skyround
    from rayfinder_tpu_torch.render.traverse import intersect_packed

    port, _ = scenes
    args = _port_args(port)
    want = sky_round_reference(*args, ROUNDS, mode)
    walked = []

    def packed(scene, o, d, t_max):
        walked.append(o.shape[0])
        return intersect_packed(scene, o, d, t_max)

    monkeypatch.setattr(skyround, "intersect_closest", packed)
    got = sky_round_reference(*args, ROUNDS, mode)
    assert torch.equal(got, want)
    assert bool(walked) == (mode not in ("nosweep", "noop"))


def test_lanes_hit_and_miss(scenes):
    """The lanes meet both sky and geometry, so each mode's parts are
    exercised: sweeponly adds t on some lanes and nothing on others."""
    port, _ = scenes
    swept = sky_round_reference(*_port_args(port), 1, "sweeponly")
    assert 0 < int((swept > 0).sum()) < swept.shape[0]


def test_fullwhile_stops_when_no_lane_of_a_group_regenerates(scenes):
    """A group stops once none of its lanes started a primary in a round;
    by then each of its lanes has hit geometry or used all its rounds."""
    port, _ = scenes
    args = _port_args(port)
    full = sky_round_reference(*args, ROUNDS, "fullwhile")
    more = sky_round_reference(*args, ROUNDS + 2, "fullwhile")
    assert bool((more >= full).all()) and bool((more > full).any())


def test_unknown_mode_raises(scenes):
    port, _ = scenes
    with pytest.raises(ValueError, match="mode"):
        sky_round(*_port_args(port), 1, "half")
