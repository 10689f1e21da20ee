"""Scenes whose BVH is a chain deeper than the walks' 32-entry stack, for
the tests of the port's walks (imported by tests/test_torch_*.py; no jax).

`deep_scene`: triangle k lies in the plane x = k. Interior node 2k holds
triangles k..T-1; its first child (node 2k + 1) is the leaf of triangle k,
its second child the rest of the chain. A ray heading -x takes the second
child as its near one at every level (split axis x, negative direction), so
it pushes one far leaf per level and overflows a 32-entry stack. The tree
is built by hand; it loads with the 64-entry walk, and `walked_with_32`
hands its walks the 32-entry stack, which they then overflow.

`native_deep_positions`: triangles that the port's own builder (the native
binned-SAH builder, bvh/native.py) makes into a chain: each triangle is the
previous one scaled by a factor above the square root of the triangles it
encloses, so that the surface-area cost splits the largest off alone at
every level.
"""

import dataclasses

import numpy as np

from rayfinder_tpu_torch.bvh.build import LEAF_SPLIT_AXIS, Bvh
from rayfinder_tpu_torch.render.scene import WALK_STACK
from rayfinder_tpu_torch.scene import FlattenedScene

DEEP_TRIANGLES = 40
# Triangles of native_deep_positions, and the depth the native builder gives them.
NATIVE_DEEP_TRIANGLES = 44


def bvh_depth(tri_count, second_child) -> int:
    """Levels of the flattened BVH, the root being level 1."""
    deepest, stack = 0, [(0, 1)]
    while stack:
        node, level = stack.pop()
        deepest = max(deepest, level)
        if tri_count[node] <= 0:
            stack += [(node + 1, level + 1), (int(second_child[node]), level + 1)]
    return deepest


def walked_with_32(scene):
    """The DeviceScene `scene` walked with the 32-entry stack whatever its
    tree's depth: a deeper tree's walks then drop the pushes past it, by the
    rule that the kernels and their plain versions share."""
    return dataclasses.replace(scene, walk_stack=WALK_STACK)


def deep_scene(n: int = DEEP_TRIANGLES) -> tuple[FlattenedScene, Bvh]:
    """The chain scene of n triangles and its hand-built BVH."""
    x = np.arange(n, dtype=np.float32)
    pos = np.zeros((n, 3, 3), np.float32)
    pos[:, :, 0] = x[:, None]
    pos[:, 1, 1] = 1.0
    pos[:, 2, 2] = 1.0
    flat = FlattenedScene(
        positions=pos, normals=np.tile(np.float32([-1.0, 0.0, 0.0]), (n, 3, 1)),
        tex_coords=np.zeros((n, 3, 2), np.float32),
        texture_indices=np.zeros(n, np.uint32))
    m = 2 * n - 1
    lo, hi = np.zeros((m, 3), np.float32), np.ones((m, 3), np.float32)
    offset, second = np.zeros(m, np.uint32), np.zeros(m, np.uint32)
    count, axis = np.zeros(m, np.uint32), np.zeros(m, np.uint32)
    for k in range(n):
        leaf = 2 * k + 1 if k < n - 1 else 2 * k
        lo[leaf, 0] = hi[leaf, 0] = k
        offset[leaf], count[leaf], axis[leaf] = k, 1, LEAF_SPLIT_AXIS
        if k < n - 1:
            lo[2 * k, 0], hi[2 * k, 0] = k, n - 1
            second[2 * k] = 2 * k + 2
    bvh = Bvh(aabb_min=lo, aabb_max=hi, triangles_offset=offset, second_child_offset=second,
              triangle_count=count, split_axis=axis,
              triangle_indices=np.arange(n, dtype=np.int64))
    return flat, bvh


def deep_rays(n: int, seed: int):
    """Rays through the chain, half of them heading -x."""
    rng = np.random.default_rng(seed)
    o = np.stack([rng.uniform(-2, DEEP_TRIANGLES + 2, n), rng.uniform(-0.5, 1.5, n),
                  rng.uniform(-0.5, 1.5, n)], axis=1).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[: n // 2, 0] = -np.abs(d[: n // 2, 0]) - 4.0
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def native_deep_positions(n: int = NATIVE_DEEP_TRIANGLES) -> np.ndarray:
    """(n, 3, 3) float32 triangles, each the last scaled from the origin by
    1.2 sqrt(k + 1), k the triangles it encloses: the native builder's tree
    over them is a chain of depth n (sizes from about 1e-15 to 1e15)."""
    grow = 1.2 * np.sqrt(np.arange(1, n) + 1.0)
    size = np.concatenate([[1.0], np.cumprod(grow)])
    size /= np.sqrt(size[0] * size[-1])
    tri = np.array([[0.0, 0.0, 0.0], [1.0, 0.1, 0.0], [1.0, 0.0, 0.1]])
    return (tri[None] * size[:, None, None]).astype(np.float32)
