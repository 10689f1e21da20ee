"""Binned-SAH BVH builder, vectorized with numpy.

Reimplements the reference's recursive binary SAH builder
(src/common/bvh.cpp:81-291) with identical tree topology and node layout:

* 12-bucket surface-area-heuristic split along the max-extent centroid axis,
  traversal cost 0.5, intersection cost 1.0 (bvh.cpp:140-233);
* equal-count fallback for fewer than 3 primitives (bvh.cpp:126-137);
* leaf termination on degenerate AABBs, single primitives, or when the SAH
  leaf cost beats the split cost (bvh.cpp:107-121, 203-232), with a forced
  split above 255 primitives;
* depth-first flattened node array: first child implicit at idx+1, explicit
  `second_child_offset` (bvh.hpp:14-21);
* a triangle reorder map, `triangle_indices[src] == new index`
  (bvh.cpp:57-79, bvh.hpp:35-46).

The recursion is replaced by an explicit LIFO work stack that allocates nodes
in the same pre-order, and per-node work (bucketing, SAH scan, partition) is
vectorized over the node's primitives. Arithmetic is float32 to match the
reference's GPU-facing numerics.

The port's own copy of `rayfinder_tpu.bvh.build`, same names and numerics.
"""

from __future__ import annotations

import dataclasses

import numpy as np

LEAF_SPLIT_AXIS = np.uint32(0xFFFFFFFF)

_NUM_BUCKETS = 12
_TRAVERSAL_COST = np.float32(0.5)
_MAX_TRIANGLES_IN_NODE = 255


@dataclasses.dataclass
class Bvh:
    """Flattened depth-first BVH in SoA layout (one entry per node)."""

    aabb_min: np.ndarray  # (N, 3) float32
    aabb_max: np.ndarray  # (N, 3) float32
    triangles_offset: np.ndarray  # (N,) uint32, valid when leaf
    second_child_offset: np.ndarray  # (N,) uint32, valid when interior
    triangle_count: np.ndarray  # (N,) uint32, 0 for interior nodes
    split_axis: np.ndarray  # (N,) uint32, LEAF_SPLIT_AXIS for leaves
    triangle_indices: np.ndarray  # (T,) int64: new index of source triangle i

    @property
    def num_nodes(self) -> int:
        return self.aabb_min.shape[0]

    def max_leaf_size(self) -> int:
        return int(self.triangle_count.max())


def _surface_area(lo: np.ndarray, hi: np.ndarray) -> np.float32:
    d = hi - lo
    return np.float32(2.0) * (d[0] * d[1] + d[0] * d[2] + d[1] * d[2])


def _max_dimension(lo: np.ndarray, hi: np.ndarray) -> int:
    """Tie-breaking of aabb.hpp:33-48: x wins only if strictly largest."""
    d = hi - lo
    if d[0] > d[1] and d[0] > d[2]:
        return 0
    if d[1] > d[2]:
        return 1
    return 2


def build_bvh(triangles: np.ndarray) -> Bvh:
    """Build a BVH over (T, 3, 3) float32 triangle vertex positions."""
    triangles = np.ascontiguousarray(triangles, dtype=np.float32)
    num_tris = triangles.shape[0]
    assert num_tris > 0

    # Primitive AABBs and their centroids (bvh.cpp:263-279: the centroid is
    # the center of the triangle's AABB, not the vertex centroid).
    prim_lo = triangles.min(axis=1)
    prim_hi = triangles.max(axis=1)
    prim_centroid = (np.float32(0.5) * (prim_lo + prim_hi)).astype(np.float32)

    nodes_lo: list[np.ndarray] = []
    nodes_hi: list[np.ndarray] = []
    nodes_tri_offset: list[int] = []
    nodes_second_child: list[int] = []
    nodes_tri_count: list[int] = []
    nodes_split_axis: list[int] = []
    triangle_indices = np.empty(num_tris, dtype=np.int64)

    def alloc_node() -> int:
        idx = len(nodes_lo)
        nodes_lo.append(None)  # type: ignore[arg-type]
        nodes_hi.append(None)  # type: ignore[arg-type]
        nodes_tri_offset.append(0)
        nodes_second_child.append(0)
        nodes_tri_count.append(0)
        nodes_split_axis.append(0)
        return idx

    def set_leaf(idx: int, lo, hi, prims: np.ndarray, ordered_offset: int) -> None:
        nodes_lo[idx] = lo
        nodes_hi[idx] = hi
        nodes_tri_offset[idx] = ordered_offset
        nodes_second_child[idx] = 0
        nodes_tri_count[idx] = prims.size
        nodes_split_axis[idx] = int(LEAF_SPLIT_AXIS)
        # triangle_indices[source] = new location (bvh.cpp:64-71).
        triangle_indices[prims] = ordered_offset + np.arange(prims.size, dtype=np.int64)

    # Work stack of (primitive index array, ordered offset, parent node index).
    # parent >= 0 marks a right child whose parent's second_child_offset must
    # be patched to this node's index, mirroring the recursion in
    # bvh.cpp:236-257. Pushing right before left reproduces pre-order layout.
    stack: list[tuple[np.ndarray, int, int]] = [
        (np.arange(num_tris, dtype=np.int64), 0, -1)
    ]
    while stack:
        prims, ordered_offset, parent = stack.pop()
        node_idx = alloc_node()
        if parent >= 0:
            nodes_second_child[parent] = node_idx

        lo_arr = prim_lo[prims]
        hi_arr = prim_hi[prims]
        c_arr = prim_centroid[prims]
        node_lo = lo_arr.min(axis=0)
        node_hi = hi_arr.max(axis=0)
        c_lo = c_arr.min(axis=0)
        c_hi = c_arr.max(axis=0)
        axis = _max_dimension(c_lo, c_hi)

        count = prims.size
        if (
            _surface_area(node_lo, node_hi) == np.float32(0.0)
            or c_lo[axis] == c_hi[axis]
            or count == 1
        ):
            set_leaf(node_idx, node_lo, node_hi, prims, ordered_offset)
            continue

        centroids = c_arr[:, axis]
        if count < 3:
            # Equal-count split via partial sort (bvh.cpp:126-137).
            split_idx = count // 2
            order = np.argsort(centroids, kind="stable")
            left = prims[order[:split_idx]]
            right = prims[order[split_idx:]]
        else:
            # Binned SAH (bvh.cpp:140-233). Bucket arithmetic in float32 with
            # truncation, exactly as the C++ expression
            # size_t(numBuckets * (c - cmin) / (cmax - cmin)).
            rel = (np.float32(_NUM_BUCKETS) * (centroids - c_lo[axis])) / (
                c_hi[axis] - c_lo[axis]
            )
            bucket = np.minimum(rel.astype(np.int64), _NUM_BUCKETS - 1)

            counts = np.bincount(bucket, minlength=_NUM_BUCKETS)
            bucket_lo = np.full((_NUM_BUCKETS, 3), np.inf, dtype=np.float32)
            bucket_hi = np.full((_NUM_BUCKETS, 3), -np.inf, dtype=np.float32)
            np.minimum.at(bucket_lo, bucket, lo_arr)
            np.maximum.at(bucket_hi, bucket, hi_arr)

            # Forward scan: cost of putting buckets[0..i] below the split.
            below_lo = np.minimum.accumulate(bucket_lo[:-1], axis=0)
            below_hi = np.maximum.accumulate(bucket_hi[:-1], axis=0)
            below_count = np.cumsum(counts[:-1])
            d_b = below_hi - below_lo
            sa_below = np.float32(2.0) * (
                d_b[:, 0] * d_b[:, 1] + d_b[:, 0] * d_b[:, 2] + d_b[:, 1] * d_b[:, 2]
            )
            # Backward scan: buckets[i+1..11] above the split.
            above_lo = np.minimum.accumulate(bucket_lo[:0:-1], axis=0)[::-1]
            above_hi = np.maximum.accumulate(bucket_hi[:0:-1], axis=0)[::-1]
            above_count = np.cumsum(counts[:0:-1])[::-1]
            d_a = above_hi - above_lo
            sa_above = np.float32(2.0) * (
                d_a[:, 0] * d_a[:, 1] + d_a[:, 0] * d_a[:, 2] + d_a[:, 1] * d_a[:, 2]
            )

            costs = (
                below_count.astype(np.float32) * sa_below
                + above_count.astype(np.float32) * sa_above
            )
            split_bucket = int(np.argmin(costs))  # first minimum, like bvh.cpp:183-193
            min_cost = np.float32(costs[split_bucket])

            leaf_cost = np.float32(count)
            total_cost = _TRAVERSAL_COST + min_cost / _surface_area(node_lo, node_hi)

            if count > _MAX_TRIANGLES_IN_NODE or total_cost < leaf_cost:
                go_left = bucket <= split_bucket
                left = prims[go_left]
                right = prims[~go_left]
                split_idx = left.size
                assert 0 < split_idx < count
            else:
                set_leaf(node_idx, node_lo, node_hi, prims, ordered_offset)
                continue

        nodes_lo[node_idx] = node_lo
        nodes_hi[node_idx] = node_hi
        nodes_split_axis[node_idx] = axis
        # Right pushed first so the left child is processed next and lands at
        # node_idx + 1 (pre-order), like the recursion in bvh.cpp:238-249.
        stack.append((right, ordered_offset + split_idx, node_idx))
        stack.append((left, ordered_offset, -2))

    return Bvh(
        aabb_min=np.stack(nodes_lo).astype(np.float32),
        aabb_max=np.stack(nodes_hi).astype(np.float32),
        triangles_offset=np.asarray(nodes_tri_offset, dtype=np.uint32),
        second_child_offset=np.asarray(nodes_second_child, dtype=np.uint32),
        triangle_count=np.asarray(nodes_tri_count, dtype=np.uint32),
        split_axis=np.asarray(nodes_split_axis, dtype=np.uint32),
        triangle_indices=triangle_indices,
    )


def reorder_attributes(attributes: np.ndarray, triangle_indices: np.ndarray) -> np.ndarray:
    """Scatter attributes into BVH leaf order: out[map[i]] = attributes[i]
    (bvh.hpp:35-46)."""
    out = np.empty_like(attributes)
    out[triangle_indices] = attributes
    return out
