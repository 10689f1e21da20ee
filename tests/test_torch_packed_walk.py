"""The packed walk tables of the ray queries K1 and K2 and the path kernels
K3, K4 and K5 (`bvh_nodes2`, `tri_pos4`, render/scene.py) and the plain
version of their walk (render/traverse.py intersect_packed, the rule of
csrc/traverse2.cuh; ops/walk.py's plain versions are this walk).

The tables must decode bit for bit to the SoA planes they are built from,
whichever entry point built the scene, and the packed walk must give the
plane walk's t (atol 0), tri and occlusion on every ray, with as many slab
tests per closest-hit ray as the plane walk visits nodes: on the courtyard,
on the committed golden rays, on a scene whose root is a leaf and on one
whose BVH is deeper than the 32-entry stack.
"""

import dataclasses
import pathlib

import numpy as np
import pytest
import torch

from rayfinder_tpu.render.scene import build_device_scene as jax_build
from rayfinder_tpu_torch.render.camera import create_camera, primary_ray
from rayfinder_tpu_torch.render.intersect import T_MAX, ray_aabb, ray_aabb_entry
from rayfinder_tpu_torch.render.scene import build_device_scene, scene_from_jax
from rayfinder_tpu_torch.render.traverse import (
    STACK_DEPTH, intersect_any, intersect_closest, intersect_packed,
)
from rayfinder_tpu_torch.scene import FlattenedScene
from rayfinder_tpu_torch.scene.procedural import courtyard_scene
from torch_deep_scene import bvh_depth, deep_rays, deep_scene, walked_with_32

GOLDENS = pathlib.Path(__file__).resolve().parent / "goldens"


def _random_flat(n=300, seed=7) -> FlattenedScene:
    """n random small triangles in a 10-unit cube."""
    rng = np.random.default_rng(seed)
    centre = rng.uniform(-5, 5, (n, 1, 3))
    pos = (centre + rng.normal(scale=0.4, size=(n, 3, 3))).astype(np.float32)
    return FlattenedScene(positions=pos, normals=np.zeros_like(pos),
                          tex_coords=np.zeros((n, 3, 2), np.float32),
                          texture_indices=np.zeros(n, np.uint32))


def _scene(name: str):
    """(flat, textures, bvh) of a named test scene."""
    if name.startswith("courtyard"):
        return (*courtyard_scene(int(name[len("courtyard"):])), None)
    if name == "random":
        return _random_flat(), None, None
    if name == "one_triangle":
        flat, _ = deep_scene(2)
        return FlattenedScene(*(a[:1] for a in (flat.positions, flat.normals, flat.tex_coords,
                                                flat.texture_indices))), None, None
    flat, bvh = deep_scene()
    return flat, None, bvh


def _built(name: str):
    flat, textures, bvh = _scene(name)
    scene = build_device_scene(flat, bvh=bvh, textures=textures, device="cpu")
    # The chain overflows a 32-entry stack on purpose: the rule for a full
    # stack is what the deep cases hold the walks to.
    return walked_with_32(scene) if name == "deep" else scene


@pytest.mark.parametrize("name", ["courtyard4", "courtyard8", "random"])
def test_records_decode_to_the_planes(name):
    s = _built(name)
    count = s.bvh_tri_count.numpy()
    second = s.bvh_second_child.numpy()
    nodes = np.nonzero(count <= 0)[0]
    record_of = np.full(count.shape[0], -1)
    record_of[nodes] = np.arange(nodes.shape[0])
    rec = s.bvh_nodes2.numpy()
    assert rec.dtype == np.int32 and rec.shape == (nodes.shape[0], 16)
    assert rec.shape[0] == (s.num_nodes - 1) // 2
    lo = s.bvh_aabb_min.numpy().view(np.int32)
    hi = s.bvh_aabb_max.numpy().view(np.int32)
    for words, child in ((slice(0, 6), nodes + 1), (slice(6, 12), second[nodes])):
        np.testing.assert_array_equal(rec[:, words], np.concatenate([lo[child], hi[child]], 1))
    right_count = rec[:, 15] & 0x3FFFFFFF
    for ref, cnt, child in ((rec[:, 12], rec[:, 14], nodes + 1),
                            (rec[:, 13], right_count, second[nodes])):
        leaf = count[child] > 0
        np.testing.assert_array_equal(cnt, np.where(leaf, count[child], 0))
        np.testing.assert_array_equal(ref[leaf], s.bvh_tri_offset.numpy()[child[leaf]])
        np.testing.assert_array_equal(ref[~leaf], record_of[child[~leaf]])
    np.testing.assert_array_equal(rec[:, 15].view(np.uint32) >> 30,
                                  s.bvh_split_axis.numpy()[nodes])

    pos4 = s.tri_pos4.numpy().reshape(-1, 3, 4)
    assert s.tri_pos4.dtype == torch.float32 and s.tri_pos4.shape == (s.num_triangles, 12)
    np.testing.assert_array_equal(pos4[:, :, :3].view(np.int32),
                                  s.tri_positions.numpy().view(np.int32))
    np.testing.assert_array_equal(pos4[:, :, 3].view(np.int32), 0)


@pytest.mark.parametrize("name", ["courtyard4", "random"])
def test_scene_from_jax_builds_the_same_tables(name):
    """From the JAX package's DeviceScene fields alone, scene_from_jax
    builds the tables that build_device_scene does."""
    flat, textures, _ = _scene(name)
    jscene = jax_build(flat, textures=textures)
    arrays = {f.name: np.asarray(getattr(jscene, f.name)) for f in dataclasses.fields(jscene)}
    assert "bvh_nodes2" not in arrays and "tri_pos4" not in arrays
    port = scene_from_jax(arrays, device="cpu")
    built = build_device_scene(flat, textures=textures, device="cpu")
    for table in ("bvh_nodes2", "tri_pos4"):
        assert torch.equal(getattr(port, table), getattr(built, table)), table


def _courtyard_rays(n_camera=2048, n_random=2048, seed=17):
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


def _rays(case: str):
    """(scene name, origins, directions) of a walk case."""
    if case == "courtyard8":
        return "courtyard8", *_courtyard_rays()
    if case in ("grouped_courtyard8", "flat_courtyard8"):
        g = np.load(GOLDENS / f"{case}.npz")
        return "courtyard8", g["origins"], g["directions"]
    if case == "random":
        rng = np.random.default_rng(5)
        d = rng.normal(size=(2048, 3)).astype(np.float32)
        return "random", rng.uniform(-6, 6, (2048, 3)).astype(np.float32), (
            d / np.linalg.norm(d, axis=1, keepdims=True))
    return case, *deep_rays(2048, seed=9)


@pytest.mark.parametrize("case", ["courtyard8", "grouped_courtyard8", "flat_courtyard8",
                                  "random", "one_triangle", "deep"])
def test_packed_walk_equals_plane_walk(case):
    name, o, d = _rays(case)
    s = _built(name)
    o, d = torch.from_numpy(o), torch.from_numpy(d)
    hit, t, tri, visits = intersect_closest(s, o, d, T_MAX)
    p_hit, p_t, p_tri, p_tests = intersect_packed(s, o, d, T_MAX)
    assert torch.equal(p_t, t) and torch.equal(p_tri, tri) and torch.equal(p_hit, hit)
    assert torch.equal(p_tests, visits)  # one slab test per node the plane walk visits
    assert 0 < int(hit.sum()) <= hit.shape[0]
    # Shadow rays: to T_MAX and to per-ray bounds below it.
    bound = torch.from_numpy(np.random.default_rng(1).uniform(0.5, 12.0, o.shape[0])
                             .astype(np.float32))
    for t_max in (T_MAX, bound):
        occ = intersect_any(s, o, d, t_max)
        p_occ, _, _, any_tests = intersect_packed(s, o, d, t_max, any_hit=True)
        assert torch.equal(p_occ, occ)
        assert bool((any_tests <= p_tests).all())
    if case == "flat_courtyard8":  # ROADMAP §3: both walks land one ulp further
        assert int(tri[6]) == int(p_tri[6]) == 9748
    if case == "one_triangle":
        assert s.num_nodes == 1 and s.bvh_nodes2.shape == (0, 16)
    if case == "deep":
        assert bvh_depth(s.bvh_tri_count, s.bvh_second_child) > STACK_DEPTH
        assert int(visits.max()) > 2 * STACK_DEPTH + 1  # some rays overflowed the stack


@pytest.mark.parametrize("case", ["grouped_courtyard8", "flat_courtyard8", "deep",
                                  "one_triangle"])
def test_ray_query_plain_versions_equal_plane_walk(case):
    """The plain versions beside the ray-query kernels K1 and K2
    (ops/walk.py, the packed walk) give the plane walk's t, tri,
    nodes_visited and occlusion on every ray, and the wrappers run them on
    CPU tensors without a launch."""
    from rayfinder_tpu_torch.ops import walk

    name, o, d = _rays(case)
    s = _built(name)
    o, d = torch.from_numpy(o), torch.from_numpy(d)
    bound = torch.from_numpy(np.random.default_rng(2).uniform(0.5, 12.0, o.shape[0])
                             .astype(np.float32))
    before = walk.intersect_closest_kernel.launches, walk.intersect_any_kernel.launches
    for t_max in (T_MAX, bound):
        want = intersect_closest(s, o, d, t_max)
        want_occ = intersect_any(s, o, d, t_max)
        for closest, any_hit in ((walk.intersect_closest_reference, walk.intersect_any_reference),
                                 (walk.intersect_closest_kernel, walk.intersect_any_kernel)):
            for got, w in zip(closest(s, o, d, t_max), want):  # hit, t, tri, nodes_visited
                assert got.dtype == w.dtype and torch.equal(got, w)
            occ = any_hit(s, o, d, t_max)
            assert occ.dtype == torch.bool and torch.equal(occ, want_occ)
    assert (walk.intersect_closest_kernel.launches, walk.intersect_any_kernel.launches) == before
    if case == "flat_courtyard8":  # both walks land one ulp beyond the golden's triangle
        assert int(walk.intersect_closest_reference(s, o, d, T_MAX)[2][6]) == 9748
    if case == "deep":
        assert int(want[3].max()) > 2 * STACK_DEPTH + 1  # some rays overflowed the stack


def test_packed_walk_empty_batch():
    s = _built("courtyard4")
    empty = torch.zeros(0, 3)
    for out in intersect_packed(s, empty, empty, T_MAX):
        assert out.shape == (0,)


def test_slab_entry_is_the_bound_free_test():
    """ray_aabb(..., t_max) is ray_aabb_entry(...) < t_max for every bound,
    with flat boxes, axis-parallel rays (NaN and inf slab terms) and boxes
    behind the ray."""
    rng = np.random.default_rng(4)
    n = 4096
    lo = rng.uniform(-4, 4, (n, 3)).astype(np.float32)
    hi = lo + rng.uniform(0, 2, (n, 3)).astype(np.float32)
    hi[::5, 1] = lo[::5, 1]
    o = rng.uniform(-6, 6, (n, 3)).astype(np.float32)
    o[::7, 0] = lo[::7, 0]
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[rng.random((n, 3)) < 0.2] = 0.0
    with np.errstate(divide="ignore"):
        inv = torch.from_numpy(np.float32(1.0) / d)
    lo, hi, o = (torch.from_numpy(a) for a in (lo, hi, o))
    entry = ray_aabb_entry(o, inv, inv < 0, lo, hi)
    assert bool(torch.isinf(entry).any()) and bool(torch.isfinite(entry).any())
    for t_max in (T_MAX, 0.5, float("inf"), torch.from_numpy(rng.uniform(0, 8, n)
                                                                .astype(np.float32))):
        assert torch.equal(ray_aabb(o, inv, inv < 0, lo, hi, t_max), entry < t_max)
