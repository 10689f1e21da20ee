"""Thin-lens camera (reference: src/common/camera.{hpp,cpp}).

Counterpart of `rayfinder_tpu.render.camera`: the basis is precomputed on the
host in numpy float32; rays are generated in torch. (u, v) are in [0, 1] with
(0, 0) the lower-left corner.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .sampling import point_in_unit_disk


class Camera(NamedTuple):
    origin: np.ndarray  # (3,) f32
    lower_left_corner: np.ndarray
    horizontal: np.ndarray
    vertical: np.ndarray
    up: np.ndarray
    right: np.ndarray
    lens_radius: np.ndarray  # () f32


def create_camera(
    origin,
    look_at,
    aperture: float,
    focus_distance: float,
    vfov_degrees: float,
    aspect_ratio: float,
) -> Camera:
    """camera.cpp:7-42, in float32."""
    origin = np.asarray(origin, dtype=np.float32)
    look_at = np.asarray(look_at, dtype=np.float32)

    theta = math.radians(vfov_degrees)
    half_height = np.float32(focus_distance * math.tan(0.5 * theta))
    half_width = np.float32(aspect_ratio) * half_height

    world_up = np.array([0.0, 1.0, 0.0], dtype=np.float32)
    forward = look_at - origin
    forward = forward / np.linalg.norm(forward)
    right = np.cross(forward, world_up)
    right = (right / np.linalg.norm(right)).astype(np.float32)
    up = np.cross(right, forward).astype(np.float32)

    lower_left = origin - half_width * right - half_height * up + np.float32(focus_distance) * forward

    return Camera(
        origin=origin,
        lower_left_corner=lower_left.astype(np.float32),
        horizontal=(2.0 * half_width * right).astype(np.float32),
        vertical=(2.0 * half_height * up).astype(np.float32),
        up=up,
        right=right,
        lens_radius=np.float32(0.5 * aperture),
    )


def generate_camera_ray(camera: Camera, u, v):
    """Pinhole primary ray for (u, v) batches (camera.cpp:44-51). u, v:
    (...,) f32 tensors. Returns (origin, direction), each (..., 3)."""
    dev = u.device

    def vec(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    d = vec(camera.lower_left_corner) + u[..., None] * vec(camera.horizontal) \
        + v[..., None] * vec(camera.vertical) - vec(camera.origin)
    norm = torch.sqrt(d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2])
    return vec(camera.origin).expand_as(d).contiguous(), d / norm[..., None]


def generate_camera_ray_lens(camera: Camera, noise, u, v):
    """Thin-lens primary ray with a blue-noise lens sample
    (reference_path_tracer.wgsl:236-245). noise: (B, 2) in [0, 1); u, v:
    (B,). Returns (origin, direction), each (B, 3)."""
    dev = noise.device

    def vec(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    lens_point = float(camera.lens_radius) * point_in_unit_disk(noise)
    lens_offset = lens_point[:, 0:1] * vec(camera.right) + lens_point[:, 1:2] * vec(camera.up)
    origin = vec(camera.origin) + lens_offset
    d = vec(camera.lower_left_corner) + u[:, None] * vec(camera.horizontal) \
        + v[:, None] * vec(camera.vertical) - origin
    norm = torch.sqrt(d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2])
    return origin, d / norm[:, None]


def primary_ray(camera: Camera, u, v_tex, noise, inv_dims: tuple[float, float]):
    """The primary ray of a pixel sample: pixel centre (u, v_tex) (B,)
    jittered by the sample's noise (B, 2) over the image size
    (inv_dims = 1/width, 1/height as float32 values), v flipped
    (ray v = 1 - texCoord.y, wgsl:52-54), thin-lens origin. Returns
    (origin, direction), each (B, 3)."""
    ray_u = u + noise[:, 0] * inv_dims[0]
    ray_v = (1.0 - v_tex) + noise[:, 1] * inv_dims[1]
    return generate_camera_ray_lens(camera, noise, ray_u, ray_v)
