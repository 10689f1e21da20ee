"""The port's fly camera (render/fly_camera.py) against the JAX package's:
each case of tests/test_fly_camera.py drives both controllers with the same
FlyInput sequence, and their state, camera() and reverse-Z matrix must be
equal; the focus pick (one ray through K1's wrapper, which runs its plain
version on CPU tensors) against JAX's on courtyard_scene(4).
"""

import math

import numpy as np
import pytest
import torch

from rayfinder_tpu.render import fly_camera as jfc
from rayfinder_tpu.render.scene import build_device_scene as jax_build
from rayfinder_tpu.scene.procedural import courtyard_scene
from rayfinder_tpu_torch.render import fly_camera as pfc
from rayfinder_tpu_torch.render.scene import build_device_scene


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: these small tensors run faster on one, and the
    tier-1 run shares the machine's cores among its workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _defaults(c):
    pass


def _wasd(c):
    c.yaw, c.pitch = 0.0, 0.0
    c.update(pfc.FlyInput(forward=True), dt=2.0)
    c.update(pfc.FlyInput(up=True, right=True), dt=1.0)
    c.update(pfc.FlyInput(left=True, down=True, backward=True), dt=0.25)


def _look_at(c):
    c.position = np.asarray([0.0, 0.0, 0.0], np.float32)
    c.look_at([1.0, 1.0, 0.0])


def _mouse_drag(c):
    c.yaw, c.pitch = 0.0, 0.0
    c.update(pfc.FlyInput(mouse_look=True, mouse_x=320, mouse_y=240), dt=0.016)
    c.update(pfc.FlyInput(mouse_look=True, mouse_x=360, mouse_y=240), dt=0.016)
    c.update(pfc.FlyInput(mouse_look=True, mouse_x=350, mouse_y=200, forward=True), dt=0.016)


def _pitch_clamp(c):
    c.yaw, c.pitch = 0.0, 0.0
    c.update(pfc.FlyInput(mouse_look=True, mouse_x=320, mouse_y=240), dt=0.016)
    for _ in range(100):
        c.update(pfc.FlyInput(mouse_look=True, mouse_x=320, mouse_y=0), dt=0.016)
        c.update(pfc.FlyInput(mouse_look=False, mouse_x=320, mouse_y=240), dt=0.016)
        c.update(pfc.FlyInput(mouse_look=True, mouse_x=320, mouse_y=240), dt=0.016)


def _focus_and_fov(c):
    c.focus_distance = 3.5
    c.vfov_degrees = 55.0
    c.aperture = 0.1
    c.update(pfc.FlyInput(mouse_look=True, mouse_x=100, mouse_y=100), dt=0.0)
    c.update(pfc.FlyInput(mouse_look=True, mouse_x=90, mouse_y=130, right=True), dt=0.5)


CASES = {
    "defaults_match_reference": _defaults,
    "wasd_translation": _wasd,
    "look_at_sets_yaw_pitch": _look_at,
    "mouse_look_drag_changes_yaw": _mouse_drag,
    "pitch_clamped": _pitch_clamp,
    "focus_and_fov": _focus_and_fov,
}


class _Recorder:
    """Replays the same script on the JAX controller, with the JAX
    FlyInput."""

    def __init__(self, controller):
        self._c = controller

    def update(self, inputs, dt):
        self._c.update(jfc.FlyInput(**vars(inputs)), dt)

    def __getattr__(self, name):
        return getattr(self._c, name)

    def __setattr__(self, name, value):
        if name == "_c":
            object.__setattr__(self, name, value)
        else:
            setattr(self._c, name, value)


@pytest.mark.parametrize("case", list(CASES))
def test_controller_matches_jax(case):
    port, jax_c = pfc.FlyCameraController((640, 480)), jfc.FlyCameraController((640, 480))
    CASES[case](port)
    CASES[case](_Recorder(jax_c))
    np.testing.assert_array_equal(port.position, jax_c.position)
    assert port.position.dtype == np.float32
    assert (port.yaw, port.pitch, port.focus_distance, port.vfov_degrees, port.aperture) == (
        jax_c.yaw, jax_c.pitch, jax_c.focus_distance, jax_c.vfov_degrees, jax_c.aperture)
    for a, b in zip(port.orientation(), jax_c.orientation()):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(port.camera(), jax_c.camera()):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(port.view_reverse_z_projection(),
                                  jax_c.view_reverse_z_projection())
    assert abs(port.pitch) <= math.radians(89.0) + 1e-6
    if case == "pitch_clamped":
        assert abs(port.pitch) == pytest.approx(math.radians(89.0))


@pytest.fixture(scope="module")
def scenes():
    flat, textures = courtyard_scene(4)
    return (build_device_scene(flat, textures=textures, device="cpu"),
            jax_build(flat, textures=textures))


def _controller(module, look_at, size=(64, 48)):
    c = module.FlyCameraController(size)
    c.position = np.asarray([-16.0, 5.0, 0.0], np.float32)
    c.look_at(look_at)
    c.vfov_degrees = 70.0
    return c


@pytest.mark.parametrize("x,y,look_at,hits", [
    (32.0, 24.0, [12.0, 2.0, 0.0], True),
    (10.0, 40.0, [12.0, 2.0, 0.0], True),
    (32.0, 24.0, [-10.0, 60.0, 0.0], False),
    (-1.0, 10.0, [12.0, 2.0, 0.0], False),
    (64.0, 10.0, [12.0, 2.0, 0.0], False),
])
def test_pick_focus_distance_matches_jax(scenes, x, y, look_at, hits):
    """A hit on the courtyard sets the same focus as JAX's pick; a ray into
    the sky and out-of-window coordinates leave it."""
    port_scene, jax_scene = scenes
    port, jax_c = _controller(pfc, look_at), _controller(jfc, look_at)
    before = port.focus_distance
    got = pfc.pick_focus_distance(port_scene, port, x, y)
    want = jfc.pick_focus_distance(jax_scene, jax_c, x, y)
    assert (got is not None) == (want is not None) == hits
    if hits:
        assert got == port.focus_distance != before
        assert got == want
    else:
        assert port.focus_distance == before
