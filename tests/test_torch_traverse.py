"""The port's BVH walk (render/traverse.py, the plain version of the CUDA
walk kernels) against the JAX `reference` engine and the committed goldens.

The two walks run the same algorithm. They agree exactly (t, tri,
nodes_visited, occlusion) except where XLA's CPU compiler, under jit,
evaluates a Moller-Trumbore dot product with fused multiply-adds: a ray whose
hit lies within that rounding of a triangle edge can then pick another
triangle. Each such ray is named, and each side's answer is shown to be its
own arithmetic's brute-force answer over every triangle.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rayfinder_tpu.render.intersect import brute_force_closest_hit as jax_brute_force
from rayfinder_tpu.render.scene import build_device_scene as jax_build
from rayfinder_tpu.render.traverse import intersect_any as jax_any
from rayfinder_tpu.render.traverse import intersect_closest as jax_closest
from rayfinder_tpu.scene.procedural import courtyard_scene
from rayfinder_tpu_torch.render.camera import create_camera, primary_ray
from rayfinder_tpu_torch.render.intersect import T_MAX, brute_force_closest_hit
from rayfinder_tpu_torch.render.scene import build_device_scene
from rayfinder_tpu_torch.render.traverse import intersect_any, intersect_closest
from rayfinder_tpu_torch.ops.walk import (
    intersect_any_kernel, intersect_closest_kernel,
)

GOLDENS = __import__("pathlib").Path(__file__).parent / "goldens"


@pytest.fixture(scope="module")
def scenes():
    flat, textures = courtyard_scene(8)
    return build_device_scene(flat, textures=textures, device="cpu"), jax_build(flat, textures=textures)


def _rays(n_camera=2048, n_random=2048, seed=11):
    """Camera rays of the bench view plus random rays inside the courtyard."""
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


def _brute_force_torch(scene, o, d):
    """Closest accepted triangle over every triangle, with the port's test
    (the port's brute_force_closest_hit)."""
    _, t, tri = brute_force_closest_hit(o[None], d[None], scene.tri_positions, T_MAX)
    return int(tri[0]), float(t[0])


def test_walk_matches_jax_reference(scenes):
    port, jscene = scenes
    o, d = _rays()
    hit, t, tri, visits = (x.numpy() for x in intersect_closest(
        port, torch.from_numpy(o), torch.from_numpy(d), T_MAX))
    occ = intersect_any(port, torch.from_numpy(o), torch.from_numpy(d), T_MAX).numpy()
    jhit, jt, jtri, jvisits = (np.asarray(x) for x in jax_closest(
        jscene, jnp.asarray(o), jnp.asarray(d), jnp.float32(1e4)))
    jocc = np.asarray(jax_any(jscene, jnp.asarray(o), jnp.asarray(d), jnp.float32(1e4)))
    assert 0.5 < hit.mean() < 1.0

    differ = np.nonzero((tri != jtri) | (t != jt) | (visits != jvisits) | (occ != jocc))[0]
    assert len(differ) <= 2, f"rays {differ.tolist()} differ from the JAX walk"
    brute_jax = jax.jit(jax_brute_force)
    for i in differ:
        assert tri[i] >= 0 and jtri[i] >= 0 and occ[i] == jocc[i], i
        assert _brute_force_torch(port, torch.from_numpy(o[i]), torch.from_numpy(d[i])) == (
            int(tri[i]), float(t[i])), i
        _, bt, btri = brute_jax(jnp.asarray(o[i:i + 1]), jnp.asarray(d[i:i + 1]),
                                jscene.tri_positions, jnp.float32(1e4))
        assert (int(btri[0]), float(bt[0])) == (int(jtri[i]), float(jt[i])), i
    same = np.setdiff1d(np.arange(len(o)), differ)
    np.testing.assert_array_equal(t[same], jt[same])
    np.testing.assert_array_equal(visits[same], jvisits[same])


@pytest.mark.parametrize("name, need", [("grouped_courtyard8", 256), ("flat_courtyard8", 255)])
def test_walk_matches_goldens(scenes, name, need):
    """The goldens were pinned from the TPU's cluster sweeps. The stack walk
    agrees with all of grouped_courtyard8; on flat_courtyard8 its slab test
    prunes ray 6's closest triangle (t 1.9844084) and it lands on one 1 ulp
    further away (1.9844085)."""
    port, _ = scenes
    g = np.load(GOLDENS / f"{name}.npz")
    o, d = torch.from_numpy(g["origins"]), torch.from_numpy(g["directions"])
    _, t, tri, _ = (x.numpy() for x in intersect_closest(port, o, d, T_MAX))
    occ = intersect_any(port, o, d, T_MAX).numpy()
    agree = (t == g["t"]) & (tri == g["tri"]) & (occ == g["occ"].astype(bool))
    assert agree.sum() == need
    for i in np.nonzero(~agree)[0]:
        assert i == 6 and name == "flat_courtyard8"
        assert abs(t[i] - g["t"][i]) <= np.spacing(g["t"][i])
        assert occ[i] == bool(g["occ"][i])


def test_walk_kernels_take_the_plain_walk_on_cpu(scenes):
    """On CPU tensors the K1/K2 wrappers run the plain walk and launch
    nothing."""
    port, _ = scenes
    o, d = (torch.from_numpy(a) for a in _rays(64, 64))
    before = (intersect_closest_kernel.launches, intersect_any_kernel.launches)
    for got, want in zip(intersect_closest_kernel(port, o, d, T_MAX),
                         intersect_closest(port, o, d, T_MAX)):
        assert torch.equal(got, want)
    assert torch.equal(intersect_any_kernel(port, o, d, T_MAX), intersect_any(port, o, d, T_MAX))
    assert (intersect_closest_kernel.launches, intersect_any_kernel.launches) == before


def test_walk_per_ray_bounds_and_empty_batch(scenes):
    port, _ = scenes
    o, d = (torch.from_numpy(a) for a in _rays(256, 256))
    scalar = intersect_closest(port, o, d, T_MAX)
    per_ray = intersect_closest(port, o, d, torch.full((o.shape[0],), T_MAX))
    for a, b in zip(scalar, per_ray):
        assert torch.equal(a, b)
    # Under the same per-ray bound, a ray is occluded exactly when it has a
    # closest hit, and every hit lies below its bound.
    bound = torch.from_numpy(np.random.default_rng(3).uniform(1.0, 12.0, o.shape[0]).astype(np.float32))
    _, t, tri, _ = intersect_closest(port, o, d, bound)
    occ = intersect_any(port, o, d, bound)
    assert torch.equal(occ, tri >= 0)
    assert 0 < int(occ.sum()) < o.shape[0]
    assert bool((t[tri >= 0] < bound[tri >= 0]).all())
    empty = torch.zeros(0, 3)
    hit, t, tri, visits = intersect_closest(port, empty, empty, T_MAX)
    assert hit.shape == t.shape == tri.shape == visits.shape == (0,)
