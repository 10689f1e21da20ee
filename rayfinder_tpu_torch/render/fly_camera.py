"""Fly camera controller (reference: src/pt/fly_camera_controller.{hpp,cpp}).

Counterpart of `rayfinder_tpu.render.fly_camera`. Windowing is replaced by
an explicit input snapshot (`FlyInput`), so the same WASD+QE / mouse-look
state machine drives headless frame loops and tests:

* yaw/pitch orientation with the reference's spherical parameterization
  (fly_camera_controller.cpp:137-148) and ±89° pitch clamp;
* drag-to-look computed like the reference: current and previous mouse rays
  converted to camera-local spherical deltas (fly_camera_controller.cpp:84-122);
* translation along the camera basis at `speed` units/second;
* `camera()` builds the thin-lens Camera via create_camera
  (fly_camera_controller.cpp:12-22) and `view_reverse_z_projection()` the
  reverse-Z view-projection of the deferred G-buffer
  (fly_camera_controller.cpp:24-51);
* defaults tuned for Sponza (fly_camera_controller.hpp:47-56).

The controller is numpy on the host; `pick_focus_distance` casts its one ray
through the closest-hit kernel K1 on the scene's device.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..ops.walk import intersect_closest_kernel
from .camera import Camera, create_camera, generate_camera_ray


@dataclasses.dataclass
class FlyInput:
    """One frame of input state (the GLFW polling analog)."""

    left: bool = False  # A
    right: bool = False  # D
    forward: bool = False  # W
    backward: bool = False  # S
    up: bool = False  # E
    down: bool = False  # Q
    mouse_look: bool = False  # LMB held
    mouse_x: float = 0.0  # pixels, top-left origin
    mouse_y: float = 0.0


class FlyCameraController:
    def __init__(self, window_size=(640, 480)):
        # Defaults from fly_camera_controller.hpp:47-56.
        self.position = np.asarray([1.22, 1.25, -1.25], np.float32)
        self.yaw = math.radians(129.64)
        self.pitch = math.radians(-13.73)
        self.vfov_degrees = 80.0
        self.aperture = 0.0
        self.focus_distance = 10.0
        self.speed = 1.0
        self.window_size = tuple(window_size)
        self._last_mouse = None

    # -- orientation -------------------------------------------------------

    def orientation(self):
        """(forward, right, up) basis (fly_camera_controller.cpp:137-148)."""
        forward = np.asarray(
            [
                math.cos(self.yaw) * math.cos(self.pitch),
                math.sin(self.pitch),
                math.sin(self.yaw) * math.cos(self.pitch),
            ],
            np.float32,
        )
        forward /= np.linalg.norm(forward)
        world_up = np.asarray([0.0, 1.0, 0.0], np.float32)
        right = np.cross(forward, world_up)
        right /= np.linalg.norm(right)
        up = np.cross(right, forward)
        return forward, right, up

    def look_at(self, p) -> None:
        """fly_camera_controller.cpp:53-61."""
        d = np.asarray(p, np.float32) - self.position
        length = float(np.linalg.norm(d))
        self.yaw = math.atan2(d[2], d[0])
        self.pitch = math.asin(d[1] / length)

    # -- frame update ------------------------------------------------------

    def update(self, inputs: FlyInput, dt: float) -> None:
        """fly_camera_controller.cpp:63-135."""
        mouse = (inputs.mouse_x, inputs.mouse_y)

        if inputs.mouse_look and self._last_mouse is not None:
            forward, right, up = self.orientation()
            c3 = np.cross(right, forward)
            c3 /= np.linalg.norm(c3)
            from_local = np.stack([right, forward, c3], axis=1)  # columns
            to_local = np.linalg.inv(from_local)

            cur = to_local @ self._camera_ray_dir(mouse)
            prev = to_local @ self._camera_ray_dir(self._last_mouse)

            def spherical(v):
                x, y, z = float(v[0]), float(v[1]), float(v[2])
                p = math.acos(max(-1.0, min(1.0, z)))
                a = math.copysign(1.0, y) * math.acos(x / math.sqrt(x * x + y * y))
                return p, a

            p1, a1 = spherical(cur)
            p2, a2 = spherical(prev)
            self.yaw += a1 - a2
            self.pitch = max(
                math.radians(-89.0), min(math.radians(89.0), self.pitch + (p1 - p2))
            )

        forward, right, up = self.orientation()
        tx = (int(inputs.right) - int(inputs.left)) * self.speed * dt
        ty = (int(inputs.up) - int(inputs.down)) * self.speed * dt
        tz = (int(inputs.forward) - int(inputs.backward)) * self.speed * dt
        self.position = (self.position + right * tx + up * ty + forward * tz).astype(
            np.float32
        )
        self._last_mouse = mouse

    def _camera_ray_dir(self, mouse) -> np.ndarray:
        """fly_camera_controller.cpp:150-171."""
        w, h = self.window_size
        aspect = w / h
        half_height = self.focus_distance * math.tan(0.5 * math.radians(self.vfov_degrees))
        half_width = aspect * half_height
        u = mouse[0] / w
        v = mouse[1] / h
        x = 2.0 * u - 1.0
        y = 1.0 - 2.0 * v
        forward, right, up = self.orientation()
        point = (
            self.position
            + self.focus_distance * forward
            + x * half_width * right
            + y * half_height * up
        )
        d = point - self.position
        return d / np.linalg.norm(d)

    # -- outputs -----------------------------------------------------------

    def camera(self) -> Camera:
        """fly_camera_controller.cpp:12-22."""
        forward, _, _ = self.orientation()
        w, h = self.window_size
        return create_camera(
            self.position,
            self.position + self.focus_distance * forward,
            self.aperture,
            self.focus_distance,
            self.vfov_degrees,
            w / h,
        )

    def view_reverse_z_projection(self) -> np.ndarray:
        """Reverse-Z view-projection (fly_camera_controller.cpp:24-51):
        z-remap(1-z) @ perspective(near=0.2, far=1000) @ lookAt."""
        forward, _, _ = self.orientation()
        origin = self.position.astype(np.float64)
        look_at = origin + self.focus_distance * forward
        fwd = look_at - origin
        fwd /= np.linalg.norm(fwd)
        world_up = np.asarray([0.0, 1.0, 0.0])
        right = np.cross(fwd, world_up)
        right /= np.linalg.norm(right)
        up = np.cross(right, fwd)

        view = np.eye(4)
        view[0, :3] = right
        view[1, :3] = up
        view[2, :3] = -fwd
        view[:3, 3] = -view[:3, :3] @ origin

        near, far = 0.2, 1000.0
        f = 1.0 / math.tan(0.5 * math.radians(self.vfov_degrees))
        w, h = self.window_size
        aspect = w / h
        project = np.zeros((4, 4))
        project[0, 0] = f / aspect
        project[1, 1] = f
        project[2, 2] = (far + near) / (near - far)
        project[2, 3] = 2.0 * far * near / (near - far)
        project[3, 2] = -1.0

        reverse_z = np.eye(4)
        reverse_z[2, 2] = -1.0
        reverse_z[2, 3] = 1.0

        return (reverse_z @ project @ view).astype(np.float32)


def pick_focus_distance(scene, controller: FlyCameraController, x: float, y: float):
    """Right-click focus-distance pick (src/pt/main.cpp:198-227): window
    pixel -> camera ray -> closest BVH hit (one ray through K1 on the
    scene's device, t_max 1000) -> focus = dot(hit_p - position, forward),
    written back to the controller. Returns the new focus distance, or None
    on a miss or out-of-window coordinates (the reference skips both)."""
    w, h = controller.window_size
    if not (0.0 <= x < w and 0.0 <= y < h):
        return None
    dev = scene.device
    u = torch.tensor([np.float32(x) / np.float32(w)], device=dev)
    v = torch.tensor([np.float32(1.0) - np.float32(y) / np.float32(h)], device=dev)
    o, d = generate_camera_ray(controller.camera(), u, v)
    hit, t, _, _ = intersect_closest_kernel(scene, o, d, o.new_full((1,), 1000.0))
    if not bool(hit[0]):
        return None
    o, d = o.cpu().numpy(), d.cpu().numpy()
    p = o[0] + float(t[0]) * d[0]
    forward, _, _ = controller.orientation()
    focus = float(np.dot(p - controller.position, forward))
    controller.focus_distance = focus
    return focus
