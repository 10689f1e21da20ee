"""A binned-SAH tree over the benchmark's triangles, for counting the work a
walk needs on a tree of the program's quality.

The builder is a frozen copy of the program's (rayfinder's bvh.cpp:81-291,
as the program builds it on the host): 12 buckets along the longest axis of
the node's centroid bounds, traversal cost 0.5 against a leaf's triangle
count, an equal-count split below 3 triangles, a forced split above 255,
leaves on degenerate bounds. Arithmetic in float32. `tree` hands it to the
reference's walks (bvh.py) in their layout; the reference renders over its
own median-split tree (bvh.build) and uses this one only to count tests
(tools/work.py), which metrics/k4_roofline.py freezes.
"""

from __future__ import annotations

import numpy as np
import torch

from .bvh import Bvh

BUCKETS = 12
TRAVERSAL_COST = np.float32(0.5)
MAX_LEAF = 255


def _area(lo, hi) -> np.float32:
    d = hi - lo
    return np.float32(2.0) * (d[..., 0] * d[..., 1] + d[..., 0] * d[..., 2] + d[..., 1] * d[..., 2])


def _longest(lo, hi) -> int:
    """The longest axis; x only where strictly longest."""
    d = hi - lo
    if d[0] > d[1] and d[0] > d[2]:
        return 0
    return 1 if d[1] > d[2] else 2


def _split(prims, c_arr, lo_arr, hi_arr, node_lo, node_hi, c_lo, c_hi, axis):
    """(left, right) primitives of a node, or None where it stays a leaf."""
    count = prims.size
    centroids = c_arr[:, axis]
    if count < 3:
        order = np.argsort(centroids, kind="stable")
        return prims[order[:count // 2]], prims[order[count // 2:]]
    rel = (np.float32(BUCKETS) * (centroids - c_lo[axis])) / (c_hi[axis] - c_lo[axis])
    bucket = np.minimum(rel.astype(np.int64), BUCKETS - 1)
    counts = np.bincount(bucket, minlength=BUCKETS)
    b_lo = np.full((BUCKETS, 3), np.inf, dtype=np.float32)
    b_hi = np.full((BUCKETS, 3), -np.inf, dtype=np.float32)
    np.minimum.at(b_lo, bucket, lo_arr)
    np.maximum.at(b_hi, bucket, hi_arr)
    below = _area(np.minimum.accumulate(b_lo[:-1], axis=0),
                  np.maximum.accumulate(b_hi[:-1], axis=0))
    above = _area(np.minimum.accumulate(b_lo[:0:-1], axis=0)[::-1],
                  np.maximum.accumulate(b_hi[:0:-1], axis=0)[::-1])
    costs = (np.cumsum(counts[:-1]).astype(np.float32) * below
             + np.cumsum(counts[:0:-1])[::-1].astype(np.float32) * above)
    split = int(np.argmin(costs))
    total = TRAVERSAL_COST + np.float32(costs[split]) / _area(node_lo, node_hi)
    if count > MAX_LEAF or total < np.float32(count):
        go_left = bucket <= split
        return prims[go_left], prims[~go_left]
    return None


def build(positions: np.ndarray):
    """The tree over (T, 3, 3) float32 triangles, depth first: (lo, hi,
    right child, first, count) per node (the left child is the next node;
    count 0 at an interior node) and `order`, the triangles in leaf order."""
    tris = np.ascontiguousarray(positions, dtype=np.float32)
    p_lo, p_hi = tris.min(axis=1), tris.max(axis=1)
    p_c = (np.float32(0.5) * (p_lo + p_hi)).astype(np.float32)
    lo, hi, right, first, count = [], [], [], [], []
    order = np.empty(tris.shape[0], dtype=np.int64)
    # (primitives, first leaf slot, parent whose right child this is or -1)
    stack = [(np.arange(tris.shape[0], dtype=np.int64), 0, -1)]
    while stack:
        prims, offset, parent = stack.pop()
        node = len(lo)
        if parent >= 0:
            right[parent] = node
        lo_arr, hi_arr, c_arr = p_lo[prims], p_hi[prims], p_c[prims]
        n_lo, n_hi = lo_arr.min(axis=0), hi_arr.max(axis=0)
        c_lo, c_hi = c_arr.min(axis=0), c_arr.max(axis=0)
        axis = _longest(c_lo, c_hi)
        lo.append(n_lo)
        hi.append(n_hi)
        right.append(-1)
        parts = None
        if not (_area(n_lo, n_hi) == 0.0 or c_lo[axis] == c_hi[axis] or prims.size == 1):
            parts = _split(prims, c_arr, lo_arr, hi_arr, n_lo, n_hi, c_lo, c_hi, axis)
        if parts is None:
            first.append(offset)
            count.append(prims.size)
            order[offset:offset + prims.size] = prims
            continue
        first.append(0)
        count.append(0)
        left_p, right_p = parts
        stack.append((right_p, offset + left_p.size, node))
        stack.append((left_p, offset, -1))
    return (np.stack(lo), np.stack(hi), np.asarray(right, np.int64),
            np.asarray(first, np.int64), np.asarray(count, np.int64), order)


def tree(positions: torch.Tensor) -> Bvh:
    """The SAH tree over (T, 3, 3) triangles, in the layout of bvh.Bvh, on
    their device."""
    dev = positions.device
    lo, hi, right, first, count, order = build(positions.detach().cpu().numpy())
    leaf = count > 0
    n = np.arange(count.size, dtype=np.int64)
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    order_t = t(order)
    return Bvh(t(lo), t(hi), t(np.where(leaf, -1, n + 1)), t(np.where(leaf, -1, right)),
               t(first), t(count), positions[order_t], order_t)
