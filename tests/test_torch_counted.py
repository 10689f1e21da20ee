"""The counted walk (K6, ops/counted.py) on the CPU, where its wrapper runs
the plain version: the torch lockstep walk with its work counters.

t and tri are held to the JAX `reference` engine, the counters to a small
recursive walk in numpy written here, and the node count to the uncounted
walk's. `count_work`, which sums the work of every plain walk for the
kernels' bounds, is held to the per-ray counts.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rayfinder_tpu.render.scene import build_device_scene as jax_build
from rayfinder_tpu.render.traverse import intersect_closest as jax_closest
from rayfinder_tpu.scene.procedural import courtyard_scene
from rayfinder_tpu_torch.ops.counted import (
    SLAB_TEST_OPS, TRIANGLE_TEST_OPS, intersect_closest_counted, walk_operations,
)
from rayfinder_tpu_torch.render import traverse
from rayfinder_tpu_torch.render.camera import create_camera, primary_ray
from rayfinder_tpu_torch.render.intersect import T_MAX
from rayfinder_tpu_torch.render.scene import build_device_scene

F32 = np.float32
EPS = F32(1e-5)


@pytest.fixture(scope="module")
def scenes():
    flat, textures = courtyard_scene(2)
    return (build_device_scene(flat, textures=textures, device="cpu"),
            jax_build(flat, textures=textures))


def _rays(n, seed=5):
    """n/2 camera rays of the bench view and n/2 random rays inside the
    courtyard, unit directions, as numpy f32."""
    rng = np.random.default_rng(seed)
    half = n // 2
    cam = create_camera([-16.0, 5.0, 0.0], [12.0, 2.0, 0.0], 0.0, 1.0, 70.0, 1.0)
    u, v = rng.uniform(size=(2, half)).astype(np.float32)
    noise = rng.uniform(size=(half, 2)).astype(np.float32)
    co, cd = primary_ray(cam, torch.from_numpy(u), torch.from_numpy(v),
                         torch.from_numpy(noise), (1.0 / 64, 1.0 / 64))
    ro = np.stack([rng.uniform(-19, 19, half), rng.uniform(0.5, 11, half),
                   rng.uniform(-9, 9, half)], axis=1).astype(np.float32)
    rd = rng.normal(size=(half, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    return (np.concatenate([co.numpy(), ro]).astype(np.float32),
            np.concatenate([cd.numpy(), rd]).astype(np.float32))


def test_counted_walk_matches_jax_reference(scenes):
    port, jscene = scenes
    o, d = _rays(4096)
    before = intersect_closest_counted.launches
    hit, t, tri, counts = (x.numpy() for x in intersect_closest_counted(
        port, torch.from_numpy(o), torch.from_numpy(d), T_MAX))
    assert intersect_closest_counted.launches == before
    assert counts.shape == (4096, 3) and counts.dtype == np.int32
    _, jt, jtri, jvisits = (np.asarray(x) for x in jax_closest(
        jscene, jnp.asarray(o), jnp.asarray(d), jnp.float32(T_MAX)))
    assert 0.5 < hit.mean() < 1.0
    np.testing.assert_array_equal(tri, jtri)
    np.testing.assert_array_equal(t, jt)
    np.testing.assert_array_equal(counts[:, 0], jvisits)


def _cross(a, b):
    return np.asarray([a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
                       a[0] * b[1] - a[1] * b[0]], F32)


def _dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _triangle(o, d, v, bound):
    """Moller-Trumbore in float32, operation by operation."""
    e1, e2 = v[1] - v[0], v[2] - v[0]
    h = _cross(d, e2)
    det = _dot(e1, h)
    inv_det = F32(1.0) / det
    s = o - v[0]
    u = inv_det * _dot(s, h)
    q = _cross(s, e1)
    w = inv_det * _dot(d, q)
    t = inv_det * _dot(e2, q)
    ok = (abs(det) >= EPS and u >= 0 and u <= 1 and w >= 0 and u + w <= 1 and t > EPS
          and t < bound)
    return ok, t


def _slab(lo, hi, o, inv, bound):
    neg = inv < 0
    t0 = (np.where(neg, hi, lo) - o) * inv
    t1 = (np.where(neg, lo, hi) - o) * inv
    tmin_xy, tmax_xy = np.maximum(t0[0], t0[1]), np.minimum(t1[0], t1[1])
    fail = (t0[0] > t1[1]) or (t0[1] > t1[0]) or (tmin_xy > t1[2]) or (t0[2] > tmax_xy)
    return (not fail and np.maximum(tmin_xy, t0[2]) < bound
            and np.minimum(tmax_xy, t1[2]) > 0)


def _recursive_walk(bvh, pos, o, d, t_max):
    """Near child first, then far, each visit tested against the best t so
    far: [t, tri, nodes, leaves, tests]."""
    inv = F32(1.0) / d
    state = [F32(t_max), -1, 0, 0, 0]

    def visit(node):
        state[2] += 1
        if not _slab(bvh["lo"][node], bvh["hi"][node], o, inv, state[0]):
            return
        count = bvh["count"][node]
        if count > 0:
            state[3] += 1
            for k in range(count):
                tri = bvh["offset"][node] + k
                state[4] += 1
                ok, t = _triangle(o, d, pos[tri], state[0])
                if ok:
                    state[0], state[1] = t, tri
            return
        second = bvh["second"][node]
        near, far = (second, node + 1) if inv[bvh["axis"][node]] < 0 else (node + 1, second)
        visit(near)
        visit(far)

    visit(0)
    return state


def test_counts_match_a_recursive_numpy_walk(scenes):
    port, _ = scenes
    bvh = {k: getattr(port, f"bvh_{name}").numpy() for k, name in (
        ("lo", "aabb_min"), ("hi", "aabb_max"), ("count", "tri_count"),
        ("offset", "tri_offset"), ("second", "second_child"), ("axis", "split_axis"))}
    pos = port.tri_positions.numpy()
    o, d = _rays(256, seed=9)
    _, t, tri, counts = (x.numpy() for x in intersect_closest_counted(
        port, torch.from_numpy(o), torch.from_numpy(d), T_MAX))
    assert counts[:, 2].sum() > counts[:, 1].sum() > 0
    for i in range(len(o)):
        want = _recursive_walk(bvh, pos, o[i], d[i], T_MAX)
        assert [t[i], tri[i], *counts[i]] == want, i


def test_node_counts_equal_the_uncounted_walk(scenes):
    port, _ = scenes
    o, d = (torch.from_numpy(a) for a in _rays(1024, seed=2))
    hit, t, tri, visits = traverse.intersect_closest(port, o, d, T_MAX)
    chit, ct, ctri, counts = intersect_closest_counted(port, o, d, T_MAX)
    for a, b in ((hit, chit), (t, ct), (tri, ctri), (visits, counts[:, 0])):
        assert torch.equal(a, b)
    # Every leaf entered tests each of its triangles: between 1 and 2 a leaf.
    assert bool((counts[:, 1] <= counts[:, 2]).all() and (counts[:, 2] <= 2 * counts[:, 1]).all())


def test_count_work_sums_every_plain_walk(scenes):
    port, _ = scenes
    o, d = (torch.from_numpy(a) for a in _rays(512, seed=4))
    closest = intersect_closest_counted(port, o, d, T_MAX)[3].sum(0).tolist()
    occluded, _, _, any_counts = traverse._walk(port, o, d, T_MAX, any_hit=True, count=True)
    with traverse.count_work() as work:
        visits = traverse.intersect_closest(port, o, d, T_MAX)[3]
        occ = traverse.intersect_any(port, o, d, T_MAX)
    assert visits.shape == (512,) and torch.equal(occ, occluded)
    assert work["closest"] == [512, *closest]
    assert work["any"] == [512, *any_counts.sum(0).tolist()]
    assert traverse._work is None
    # Any-hit walks stop at the first hit: no more work than closest-hit.
    assert work["any"][3] <= work["closest"][3]


@pytest.mark.parametrize("case", ["courtyard", "deep"])
def test_packed_walk_counts_equal_the_counted_walk(scenes, case):
    """intersect_packed(count=True), the plain form of the kernels' counting
    rule (walk_packed at level 2: a slab test per node, a leaf entry taken,
    a Moller-Trumbore call), gives intersect_closest_counted's t, tri and
    three counts on every ray: on this file's rays and on the 40-level chain
    that overflows the 32-entry stack, to T_MAX and to per-ray bounds."""
    from torch_deep_scene import deep_rays, deep_scene, walked_with_32

    if case == "courtyard":
        scene, (o, d) = scenes[0], _rays(2048)
    else:
        flat, bvh = deep_scene()
        scene = walked_with_32(build_device_scene(flat, bvh=bvh, device="cpu"))
        o, d = deep_rays(2048, seed=9)
    o, d = torch.from_numpy(o), torch.from_numpy(d)
    bound = torch.from_numpy(np.random.default_rng(3).uniform(0.5, 12.0, o.shape[0])
                             .astype(np.float32))
    for t_max in (T_MAX, bound):
        got = traverse.intersect_packed(scene, o, d, t_max, count=True)
        want = traverse.intersect_closest_counted(scene, o, d, t_max)
        assert got[3].shape == (o.shape[0], 3) and got[3].dtype == torch.int32
        assert int(got[3][:, 2].sum()) > 0
        for a, b in zip(got, want):
            assert torch.equal(a, b)


def test_walk_operations_count_slab_and_triangle_tests():
    assert walk_operations(3, 2) == 3 * SLAB_TEST_OPS + 2 * TRIANGLE_TEST_OPS
    assert (SLAB_TEST_OPS, TRIANGLE_TEST_OPS) == (25, 60)
