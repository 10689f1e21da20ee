"""Counted closest-hit walk (K6): CUDA kernel and its plain version.

Counterpart of `counted_closest` (prof/diag_iters.py), the TPU's grouped
closest sweep with per-tile super-visit and inner-iteration counters. On
this card the walk is per thread, so the work is counted per ray: nodes
visited, leaves entered, triangles tested. The kernel (csrc/walk.cu) is
K1's kernel over the packed walk tables (`bvh_nodes2`, `tri_pos4`) at the
walk's counting level 2 (traverse2.cuh walk_packed), so t, tri and the node
count equal K1's bit for bit; a scene without the tables raises. The plain
version is the torch plane walk of render/traverse.py with its two extra
counters, the specification every walk is held to.

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches its kernel or raises.
"""

from __future__ import annotations

import torch

from ..render.scene import DeviceScene
from ..render.traverse import (
    intersect_closest_counted as intersect_closest_counted_reference,
)
from . import _build

__all__ = ["intersect_closest_counted", "intersect_closest_counted_reference",
           "walk_operations"]

# Operations of one slab test and of one Moller-Trumbore test, counted from
# csrc/traverse2.cuh slab_key (with the bound's compare) and csrc/traverse.cuh
# moller_trumbore: each add, subtract, multiply, divide, min, max, abs and
# comparison is one; selects are not.
SLAB_TEST_OPS = 25
TRIANGLE_TEST_OPS = 60


def walk_operations(nodes: int, tests: int) -> int:
    """Operations of walks that visited `nodes` nodes and tested `tests`
    triangles in all: the work a walk kernel's bound is computed from."""
    return int(nodes) * SLAB_TEST_OPS + int(tests) * TRIANGLE_TEST_OPS


def intersect_closest_counted(scene: DeviceScene, origin, direction, t_max):
    """Closest hit of each ray (B, 3) below t_max (float or (B,)), with the
    walk's work.

    Returns (hit, t, tri, counts): hit, t, tri (B,) as K1's; counts (B, 3)
    int32 = nodes visited, leaves entered, triangles tested."""
    if origin.device.type == "cpu":
        return intersect_closest_counted_reference(scene, origin, direction, t_max)
    dev = origin.device
    n = origin.shape[0]
    _build.check(origin, "origin", torch.float32, (n, 3), dev)
    _build.check(direction, "direction", torch.float32, (n, 3), dev)
    t_max = torch.as_tensor(t_max, dtype=torch.float32, device=dev).expand(n).contiguous()
    t = torch.empty(n, dtype=torch.float32, device=dev)
    tri = torch.empty(n, dtype=torch.int32, device=dev)
    counts = torch.empty(n, 3, dtype=torch.int32, device=dev)
    if n:
        lib = _build.library()
        with torch.cuda.device(dev):
            err = lib.rf_intersect_closest_counted(
                *_build.packed_args(scene, dev), origin.data_ptr(), direction.data_ptr(),
                t_max.data_ptr(), n, t.data_ptr(), tri.data_ptr(), counts.data_ptr(),
                _build.stream_of(dev),
            )
        _build.raise_on_error(err, "rf_intersect_closest_counted")
        intersect_closest_counted.launches += 1
    return tri >= 0, t, tri, counts


# Kernel launch count (a run resets and reads it to show which kernels it
# went through).
intersect_closest_counted.launches = 0
