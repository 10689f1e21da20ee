"""The triangle -> cluster rule of the JAX package's scenes.

The port walks the BVH per thread and keeps no clusters, but the traversal
diagnostics (prof/diag_iters.py) order bounce rays by the parent hit's
cluster, as the JAX sorted loop does, and the scene upload counts the
clusters (render/scene.py `num_clusters`), on which the scan integrator
decides whether to sort bounce rays. The JAX scene cuts its leaf-ordered
triangles into BVH-treelet ranges of at most 128 triangles
(`rayfinder_tpu.render.scene.build_device_scene`:
`build_clusters(positions, ranges=treelet_ranges(bvh, DEFAULT_LEAF_SIZE,
positions))`). This module is the port's copy of that numpy rule,
`rayfinder_tpu.bvh.clusters.treelet_ranges`, without the TPU packing.
"""

from __future__ import annotations

import numpy as np

# The JAX package's cluster size (rayfinder_tpu.bvh.clusters.DEFAULT_LEAF_SIZE).
DEFAULT_LEAF_SIZE = 128


def treelet_ranges(
    bvh, leaf_size: int, positions: np.ndarray | None = None,
    sa_alpha: float = 1.0,
) -> np.ndarray:
    """Cut the BVH into maximal subtrees of <= leaf_size triangles, then
    merge consecutive cuts that still fit — but only when the merge does not
    BLOAT the cluster AABB.

    Because the builder flattens depth-first and reorders triangles into leaf
    order (bvh.cpp:263-291), every subtree covers a CONTIGUOUS leaf-order
    range — so treelet clusters are ranges [start, end) whose AABBs respect
    the tree's own spatial splits, much tighter than blind fixed chunks at
    branch boundaries. Returns (C, 2) int64 [start, end) ranges.

    positions: (N, 3, 3) leaf-ordered triangle vertices. When given, a merge
    is accepted only if the union's AABB surface area <= sa_alpha * (sum of
    the parts' areas) — consecutive cuts at major branch boundaries can be
    spatially DISJOINT, and unconditionally merging them (the round-1
    behavior) unions far-apart geometry into one fat AABB. Measured on
    courtyard(14) bounce rays (offline study, 2026-08-18): unconditional
    merge C=777/fill 95/total SA 7776/per-lane needed clusters 3.58/sorted
    tile max 9.16; SA-bounded (alpha=1) C=868/fill 85/SA 3935/need 0.83/tile
    max 3.66 — a 2.5x iteration-count cut for +12% clusters. positions=None
    falls back to NO merging (measured equivalent to alpha<=0.8).
    """
    tc = np.asarray(bvh.triangle_count, np.int64)
    off = np.asarray(bvh.triangles_offset, np.int64)
    sc = np.asarray(bvh.second_child_offset, np.int64)
    num_tris = int(tc[tc > 0].sum())

    cuts = []
    stack = [0]
    while stack:
        i = stack.pop()
        if tc[i] > 0:
            cuts.append((int(off[i]), int(off[i] + tc[i])))
            continue
        # Subtree triangle range = [min leaf offset, max leaf end) — compute
        # lazily: a subtree of an in-order leaf layout spans from its
        # leftmost leaf's offset to its rightmost leaf's end. Walk down the
        # left spine for start and right spine for end.
        lo = i
        while tc[lo] == 0:
            lo = lo + 1
        hi = i
        while tc[hi] == 0:
            hi = int(sc[hi])
        start, end = int(off[lo]), int(off[hi] + tc[hi])
        if end - start <= leaf_size:
            cuts.append((start, end))
        else:
            stack.append(int(sc[i]))
            stack.append(i + 1)
    cuts.sort()
    assert cuts[0][0] == 0 and cuts[-1][1] == num_tris

    if positions is None:
        return np.asarray(cuts, np.int64)

    # Ranges are <= leaf_size triangles, so the merge scan's area
    # evaluations stay O(total triangles).
    verts = np.asarray(positions, np.float32).reshape(-1, 3)

    def _sa(s: int, e: int) -> float:
        blk = verts[3 * s:3 * e]
        ext = blk.max(axis=0) - blk.min(axis=0)
        return float(ext[0] * ext[1] + ext[1] * ext[2] + ext[0] * ext[2])

    merged = []
    cs, ce = cuts[0]
    for s, e in cuts[1:]:
        if e - cs <= leaf_size and _sa(cs, e) <= sa_alpha * (
            _sa(cs, ce) + _sa(s, e)
        ):
            ce = e
        else:
            merged.append((cs, ce))
            cs, ce = s, e
    merged.append((cs, ce))
    return np.asarray(merged, np.int64)


def triangle_clusters(bvh, positions: np.ndarray, leaf_size: int = DEFAULT_LEAF_SIZE) -> np.ndarray:
    """(T,) int64: the cluster of each leaf-order triangle under the JAX
    scene's rule (treelet ranges with the surface-area merge)."""
    ranges = treelet_ranges(bvh, leaf_size, positions)
    return np.repeat(np.arange(ranges.shape[0], dtype=np.int64), ranges[:, 1] - ranges[:, 0])
