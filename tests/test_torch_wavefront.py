"""The port's wavefront engine (render/wavefront.py) and the scene's cluster
tables against the JAX package's (rayfinder_tpu.render.wavefront, an XLA
engine there, torch code here).

Both cull the same cluster boxes, order them by entry distance with ties in
cluster order, and walk whole cluster blocks with the same Moller-Trumbore
test, so t and tri agree at atol 0, occlusion and the escalation counts
exactly. XLA's CPU compiler contracts some products of the test into fused
multiply-adds, which can move a hit within that rounding of a triangle edge:
such rays would be named here (none on these inputs).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rayfinder_tpu.render.camera import create_camera as jax_camera
from rayfinder_tpu.render.pathtracer import accumulate_samples_regen as jax_regen
from rayfinder_tpu.render.rng import blue_noise_tile as jax_tile
from rayfinder_tpu.render.scene import build_device_scene as jax_build
from rayfinder_tpu.render.wavefront import intersect_any_wavefront as jax_any
from rayfinder_tpu.render.wavefront import intersect_closest_wavefront as jax_closest
from rayfinder_tpu.scene.procedural import courtyard_scene
from rayfinder_tpu.sky.model import sky_state_from_ui as jax_sky
from rayfinder_tpu_torch.render import pathtracer as pt
from rayfinder_tpu_torch.render import wavefront as wf
from rayfinder_tpu_torch.render.camera import create_camera, primary_ray
from rayfinder_tpu_torch.render.intersect import T_MAX
from rayfinder_tpu_torch.render.rng import blue_noise_tile
from rayfinder_tpu_torch.render.scene import build_device_scene
from rayfinder_tpu_torch.sky.model import sky_state_from_ui

CLUSTER_FIELDS = ("cluster_tris", "cluster_min", "cluster_max", "cluster_tri_map",
                  "cluster_start")


@pytest.fixture(scope="module", params=[4, 8])
def scenes(request):
    flat, textures = courtyard_scene(request.param)
    return (build_device_scene(flat, textures=textures, device="cpu"),
            jax_build(flat, textures=textures))


@pytest.fixture(scope="module")
def scenes8():
    flat, textures = courtyard_scene(8)
    return (build_device_scene(flat, textures=textures, device="cpu"),
            jax_build(flat, textures=textures))


def _rays(n_camera=2048, n_random=2048, seed=23):
    """Camera rays of the bench view plus random rays inside the courtyard
    (made with numpy from a seed)."""
    rng = np.random.default_rng(seed)
    cam = create_camera([-16.0, 5.0, 0.0], [12.0, 2.0, 0.0], 0.0, 1.0, 70.0, 4 / 3)
    u, v = rng.uniform(size=(2, n_camera)).astype(np.float32)
    noise = rng.uniform(size=(n_camera, 2)).astype(np.float32)
    co, cd = primary_ray(cam, torch.from_numpy(u), torch.from_numpy(v),
                         torch.from_numpy(noise), (1.0 / 64, 1.0 / 48))
    ro = np.stack([rng.uniform(-19, 19, n_random), rng.uniform(0.5, 11, n_random),
                   rng.uniform(-9, 9, n_random)], axis=1).astype(np.float32)
    rd = rng.normal(size=(n_random, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    return (np.concatenate([co.numpy(), ro]).astype(np.float32),
            np.concatenate([cd.numpy(), rd]).astype(np.float32))


def _port(fn, scene, o, d, **kw):
    return [x.numpy() for x in fn(scene, torch.from_numpy(o), torch.from_numpy(d), T_MAX, **kw)]


def _jax(fn, scene, o, d, **kw):
    return [np.asarray(x) for x in fn(scene, jnp.asarray(o), jnp.asarray(d),
                                      jnp.float32(T_MAX), **kw)]


def test_cluster_tables_match_jax(scenes):
    port, jscene = scenes
    for name in CLUSTER_FIELDS:
        got, want = getattr(port, name).numpy(), np.asarray(getattr(jscene, name))
        assert got.dtype == want.dtype and got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    assert port.num_clusters == jscene.cluster_tris.shape[0]


def test_closest_matches_jax(scenes):
    port, jscene = scenes
    o, d = _rays()
    hit, t, tri, esc = _port(wf.intersect_closest_wavefront, port, o, d)
    jhit, jt, jtri, jesc = _jax(jax_closest, jscene, o, d)
    assert 0.5 < hit.mean() < 1.0
    differ = np.nonzero((hit != jhit) | (t != jt) | (tri != jtri))[0]
    assert differ.tolist() == [], "rays that differ from the JAX wavefront"
    assert esc.dtype == np.int32 and int(esc) == int(jesc)


def test_any_matches_jax(scenes):
    port, jscene = scenes
    o, d = _rays()
    occ, esc = _port(wf.intersect_any_wavefront, port, o, d)
    jocc, jesc = _jax(jax_any, jscene, o, d)
    assert 0.3 < occ.mean() < 1.0
    np.testing.assert_array_equal(occ, jocc)
    assert esc.dtype == np.int32 and int(esc) == int(jesc)


@pytest.mark.parametrize("query", ["closest", "any"])
def test_small_top_k_escalates_as_jax(scenes8, query):
    """A top_k far below the clusters a ray in the enclosed courtyard
    overlaps (as tests/test_wavefront.py:123): many rays are walked again at
    full capacity, as many as in JAX, and the results still equal the
    full-capacity walk's."""
    port, jscene = scenes8
    rng = np.random.default_rng(5)
    n = 512
    o = rng.uniform([-18, 0.5, -9], [18, 10.0, 9], size=(n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    port_fn, jax_fn = ((wf.intersect_closest_wavefront, jax_closest) if query == "closest"
                       else (wf.intersect_any_wavefront, jax_any))
    got = _port(port_fn, port, o, d, top_k=4)
    want = _jax(jax_fn, jscene, o, d, top_k=4)
    full = _port(port_fn, port, o, d, top_k=port.num_clusters)
    assert int(got[-1]) > 0 and int(got[-1]) == int(want[-1])
    assert int(full[-1]) == 0
    for g, w_, f in zip(got[:-1], want[:-1], full[:-1]):
        np.testing.assert_array_equal(g, w_)
        np.testing.assert_array_equal(g, f)


def test_ties_keep_cluster_order():
    """Tied entry distances (0 for every box around the origin) keep the
    cluster order, as jax.lax.top_k's tied scores do, -0.0 and 0.0 alike."""
    flat, textures = courtyard_scene(4)
    scene = build_device_scene(flat, textures=textures, device="cpu")
    o = torch.tensor([[0.0, 5.0, 0.0], [-0.0, 5.0, -0.0]])
    d = torch.tensor([[0.3, -1.0, 0.2], [-0.3, -1.0, -0.2]])
    d = d / d.norm(dim=1, keepdim=True)
    entry, cids, _ = wf._order_clusters(scene, o, d, torch.full((2,), T_MAX), 8)
    for row_e, row_c in zip(entry, cids):
        for a, b in zip(range(7), range(1, 8)):
            assert row_e[a] < row_e[b] or (row_e[a] == row_e[b] and row_c[a] < row_c[b])


def test_ray_chunk_keeps_the_cull_grid_bounded():
    assert wf._ray_chunk(2951) == 8192 and 8192 * 2951 <= wf._MAX_CULL_ENTRIES
    assert wf._ray_chunk(72) == wf.RAY_CHUNK
    assert wf._ray_chunk(72, 4096) == 4096 and wf._ray_chunk(72, 100) == 1024


def test_get_engine_wavefront():
    closest, any_hit = pt.get_engine("wavefront")
    flat, textures = courtyard_scene(4)
    scene = build_device_scene(flat, textures=textures, device="cpu")
    o, d = (torch.from_numpy(x) for x in _rays(64, 64))
    hit, t, tri, extra = closest(scene, o, d, T_MAX)
    assert extra is None and hit.dtype == torch.bool and tri.dtype == torch.int32
    assert torch.equal(any_hit(scene, o, d, T_MAX),
                       wf.intersect_any_wavefront(scene, o, d, T_MAX)[0])
    with pytest.raises(ValueError, match="unknown traversal engine"):
        pt.get_engine("pallas")


def test_unfused_loop_on_wavefront_matches_jax():
    """accumulate_samples_regen(engine="wavefront"): the unfused loop over
    the wavefront engine, as JAX's accumulate_lanes_regen runs it, within
    the regen budget (rtol 2e-4, atol 1e-5) and with exact ray counts."""
    flat, textures = courtyard_scene(4)
    port = build_device_scene(flat, textures=textures, device="cpu")
    jscene = jax_build(flat, textures=textures)
    w, h, spp = 32, 24, 2
    cam = ([-16.0, 5.0, 0.0], [12.0, 2.0, 0.0], 0.0, 1.0, 70.0, w / h)
    sky = (2.5, (0.3, 0.3, 0.3), 35.0, 25.0)
    kw = dict(width=w, height=h, num_bounces=3, spp=spp, num_frames=spp, count_rays=True,
              engine="wavefront")
    want, want_rays = jax_regen(jscene, jax_sky(*sky), jax_camera(*cam), jnp.asarray(jax_tile()),
                                jnp.int32(0), jnp.zeros((w * h, 3), jnp.float32), **kw)
    got, rays = pt.accumulate_samples_regen(
        port, sky_state_from_ui(*sky), create_camera(*cam), torch.from_numpy(blue_noise_tile()),
        0, torch.zeros(w * h, 3), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=1e-5)
    np.testing.assert_array_equal(rays.numpy(), np.asarray(want_rays))
    ref, ref_rays = pt.accumulate_samples_regen(
        port, sky_state_from_ui(*sky), create_camera(*cam), torch.from_numpy(blue_noise_tile()),
        0, torch.zeros(w * h, 3), **{**kw, "engine": "reference"})
    assert torch.equal(rays, ref_rays)
    with pytest.raises(ValueError, match="unfused loop"):
        pt.accumulate_samples_regen(
            port, sky_state_from_ui(*sky), create_camera(*cam),
            torch.from_numpy(blue_noise_tile()), 0, torch.zeros(w * h, 3),
            **{**kw, "count_rays": False}, inkernel=False)


def test_pick_accumulator_on_wavefront():
    """As in JAX: the regeneration loop on small scenes, the scan form above
    SORT_THRESHOLD clusters."""
    small, big = (build_device_scene(flat, textures=textures, device="cpu")
                  for flat, textures in (courtyard_scene(4), courtyard_scene(8)))
    assert pt.pick_accumulator(small, "wavefront") is pt.accumulate_samples_regen
    assert pt.pick_accumulator(big, "wavefront") is pt.accumulate_samples
