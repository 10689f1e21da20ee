"""Closest-hit (K1) and any-hit (K2) ray queries: CUDA kernels and their
plain versions.

Counterpart of `rayfinder_tpu.ops.pallas_walk` (pallas_intersect_closest,
pallas_intersect_any). The kernels (csrc/walk.cu) run one thread per ray
over the scene's packed walk tables (`bvh_nodes2`, `tri_pos4`) with the walk
of csrc/traverse2.cuh, which the path kernels share; a scene without the
tables raises. The plain versions are the torch walk of the same tables by
the same rule (render/traverse.py intersect_packed), which the kernels match
bit for bit; both give the t, tri, occlusion and, for a closest walk, the
nodes_visited of the plane walk (render/traverse.py intersect_closest,
intersect_any).

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches its kernel or raises. `closest_into` and `any_into` launch K1 and
K2 into outputs that the caller allocates (the deferred passes' kernels,
ops/deferred.py); they count in the same launch counts.
"""

from __future__ import annotations

import torch

from ..render.scene import DeviceScene
from ..render.traverse import intersect_packed
from . import _build

__all__ = [
    "intersect_closest_kernel",
    "intersect_any_kernel",
    "intersect_closest_reference",
    "intersect_any_reference",
    "closest_into",
    "any_into",
]


def intersect_closest_reference(scene: DeviceScene, origin, direction, t_max):
    """Plain torch version of `intersect_closest_kernel`, on any device:
    (hit, t, tri, nodes_visited), the last being the walk's slab tests,
    which are the nodes the plane walk visits."""
    return intersect_packed(scene, origin, direction, t_max)


def intersect_any_reference(scene: DeviceScene, origin, direction, t_max):
    """Plain torch version of `intersect_any_kernel`, on any device:
    occluded (B,) bool."""
    return intersect_packed(scene, origin, direction, t_max, any_hit=True)[0]


def _ray_args(origin, t_max):
    """The rays' device and count, and t_max as a (B,) float32 tensor there."""
    dev = origin.device
    n = origin.shape[0]
    t_max = torch.as_tensor(t_max, dtype=torch.float32, device=dev)
    t_max = t_max.expand(n).contiguous()
    return dev, n, t_max


def intersect_closest_kernel(scene: DeviceScene, origin, direction, t_max):
    """Closest hit of each ray (B, 3) below t_max (float or (B,)).

    Returns (hit, t, tri, nodes_visited), each (B,): tri is the leaf-order
    triangle index (-1 on a miss, where t is t_max)."""
    if origin.device.type == "cpu":
        return intersect_closest_reference(scene, origin, direction, t_max)
    dev, n, t_max = _ray_args(origin, t_max)
    t = torch.empty(n, dtype=torch.float32, device=dev)
    tri = torch.empty(n, dtype=torch.int32, device=dev)
    visits = torch.empty(n, dtype=torch.int32, device=dev)
    closest_into(scene, origin, direction, t_max, t, tri, visits)
    return tri >= 0, t, tri, visits


def intersect_any_kernel(scene: DeviceScene, origin, direction, t_max):
    """Whether anything lies on each ray (B, 3) below t_max (float or
    (B,)): occluded (B,) bool, for shadow rays."""
    if origin.device.type == "cpu":
        return intersect_any_reference(scene, origin, direction, t_max)
    dev, n, t_max = _ray_args(origin, t_max)
    occ = torch.empty(n, dtype=torch.bool, device=dev)
    any_into(scene, origin, direction, t_max, occ)
    return occ


def closest_into(scene: DeviceScene, origin, direction, t_max, t, tri, visits) -> None:
    """Launch K1 on CUDA rays (B, 3) below the bounds t_max (B,), writing
    intersect_closest_kernel's t, tri and nodes_visited into the (B,)
    tensors given; counted in intersect_closest_kernel.launches."""
    dev = origin.device
    n = origin.shape[0]
    for tensor, name, dtype, shape in (
        (origin, "origin", torch.float32, (n, 3)), (direction, "direction", torch.float32, (n, 3)),
        (t_max, "t_max", torch.float32, (n,)), (t, "t", torch.float32, (n,)),
        (tri, "tri", torch.int32, (n,)), (visits, "visits", torch.int32, (n,)),
    ):
        _build.check(tensor, name, dtype, shape, dev)
    if n:
        lib = _build.library()
        with torch.cuda.device(dev):
            err = lib.rf_intersect_closest(
                *_build.packed_args(scene, dev, sized=True), origin.data_ptr(),
                direction.data_ptr(), t_max.data_ptr(), n, t.data_ptr(),
                tri.data_ptr(), visits.data_ptr(), _build.stream_of(dev),
            )
        _build.raise_on_error(err, "rf_intersect_closest")
        intersect_closest_kernel.launches += 1


def any_into(scene: DeviceScene, origin, direction, t_max, occ) -> None:
    """Launch K2 on CUDA rays (B, 3) below the bounds t_max (B,), writing
    the occlusion into the (B,) bool tensor `occ`; counted in
    intersect_any_kernel.launches."""
    dev = origin.device
    n = origin.shape[0]
    for tensor, name, dtype, shape in (
        (origin, "origin", torch.float32, (n, 3)), (direction, "direction", torch.float32, (n, 3)),
        (t_max, "t_max", torch.float32, (n,)), (occ, "occ", torch.bool, (n,)),
    ):
        _build.check(tensor, name, dtype, shape, dev)
    if n:
        lib = _build.library()
        with torch.cuda.device(dev):
            err = lib.rf_intersect_any(
                *_build.packed_args(scene, dev, sized=True), origin.data_ptr(),
                direction.data_ptr(), t_max.data_ptr(), n, occ.data_ptr(),
                _build.stream_of(dev),
            )
        _build.raise_on_error(err, "rf_intersect_any")
        intersect_any_kernel.launches += 1


# Kernel launch counts (a run resets and reads them to show which kernels
# it went through).
intersect_closest_kernel.launches = 0
intersect_any_kernel.launches = 0
