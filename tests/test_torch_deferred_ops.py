"""The deferred passes' kernel wrappers (rayfinder_tpu_torch/ops/deferred.py)
on the CPU: the parameter block the kernels take by value, the wrappers'
plain versions, and the routing of render/deferred.py to them. The kernels
themselves run in tests/test_torch_cuda.py."""

import ctypes

import numpy as np
import pytest
import torch

from rayfinder_tpu_torch.ops import deferred as od
from rayfinder_tpu_torch.render import deferred as pd
from rayfinder_tpu_torch.render.camera import create_camera
from rayfinder_tpu_torch.render.scene import build_device_scene
from rayfinder_tpu_torch.render.shade import FRAC_1_PI, SOLAR_COS_THETA_MAX, SOLAR_INV_PDF
from rayfinder_tpu_torch.scene.procedural import courtyard_scene
from rayfinder_tpu_torch.sky.model import SOLAR_RADIUS_RADIANS, sky_on_device, sky_state_from_ui
from rayfinder_tpu_torch.utils import profiling

W, H = 16, 12
EXPOSURE = 0.25
SKY = (2.5, (0.3, 0.3, 0.3), 35.0, 25.0)


@pytest.fixture(scope="module")
def scene():
    flat, textures = courtyard_scene(2, textured=True)
    return build_device_scene(flat, textures=textures, device="cpu")


def _camera(w=W, h=H):
    return create_camera([-16, 5, 0], [12, 2, 0], 0.0, 1.0, 70.0, w / h)


def _bits(x) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.uint32)


@pytest.mark.parametrize("frame", [0, 5, (1 << 20) + 3])
@pytest.mark.parametrize("device_sky", [False, True])
def test_parameter_block_holds_the_frames_float32_values(frame, device_sky):
    """deferred_params, field by field as float32 bits: the four vectors that
    generate_camera_ray adds, the frame's _jitter, _recip(width) and
    _recip(height), the sky's state (host arrays or tensors alike), the sun's
    sampling constants, 1/SOLAR_RADIUS_RADIANS as torch's division by it
    multiplies, the exposure, the width, the noise's frame mod 2^20 and
    whether the resolve blends."""
    w, h = 1920, 1080
    cam = _camera(w, h)
    sky = sky_state_from_ui(*SKY)
    p = od.deferred_params(frame, width=w, height=h, camera=cam,
                           sky=sky_on_device(sky, "cpu") if device_sky else sky, exposure=0.3)
    for field, want in (("cam_origin", cam.origin), ("lower_left", cam.lower_left_corner),
                        ("horizontal", cam.horizontal), ("vertical", cam.vertical),
                        ("jitter", pd._jitter(frame)), ("sun", sky.sun_direction),
                        ("solar", sky.solar_radiances), ("sky_radiance", sky.sky_radiances),
                        ("perez", sky.params.reshape(-1))):
        np.testing.assert_array_equal(_bits(list(getattr(p, field))), _bits(want), field)
    for field, want in (("inv_w", pd._recip(w)), ("inv_h", pd._recip(h)),
                        ("one_minus_cos_max", np.float32(1.0) - SOLAR_COS_THETA_MAX),
                        ("solar_inv_pdf", SOLAR_INV_PDF), ("frac_1_pi", FRAC_1_PI),
                        ("inv_solar_radius", np.float32(1.0) / SOLAR_RADIUS_RADIANS),
                        ("exposure", 0.3)):
        assert _bits(getattr(p, field)) == _bits(want), field
    assert (p.width, p.noise_frame, p.blend) == (w, frame % (1 << 20), int(frame != 0))
    # The C struct's layout: 57 floats then 3 ints, in declaration order.
    assert ctypes.sizeof(od.DeferredParams) == 60 * 4
    assert od.DeferredParams.width.offset == 57 * 4
    assert od.DeferredParams.blend.offset == 59 * 4


def test_parameter_block_leaves_out_what_it_is_not_given():
    p = od.deferred_params(3, exposure=2.0)
    assert list(p.cam_origin) == [0.0] * 3 and list(p.perez) == [0.0] * 27
    assert (p.inv_w, p.inv_h, p.width, p.exposure, p.blend) == (1.0, 1.0, 1, 2.0, 1)


@pytest.mark.parametrize("frame", [0, 1])
def test_wrappers_on_cpu_tensors_run_the_torch_passes(scene, frame):
    """Given CPU tensors, each wrapper returns its torch pass's results bit
    for bit and launches nothing."""
    launches = [fn.launches for fn in (od.gbuffer_kernel, od.lighting_kernel,
                                       od.resolve_kernel)]
    cam, sky = _camera(), sky_state_from_ui(*SKY)
    got = od.gbuffer_kernel(scene, cam, frame, width=W, height=H)
    want = pd.gbuffer_pass(scene, cam, frame, width=W, height=H)
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    sample = od.lighting_kernel(scene, sky, got, frame, width=W, height=H)
    want_sample = pd.lighting_pass(scene, sky, want, frame, width=W, height=H)
    assert torch.equal(sample, want_sample)
    accum = torch.full_like(sample, 0.5)
    for a, b in zip(od.resolve_kernel(sample, accum, frame, EXPOSURE),
                    pd.resolve_pass(want_sample, accum, frame, EXPOSURE)):
        assert torch.equal(a, b)
    assert [fn.launches for fn in (od.gbuffer_kernel, od.lighting_kernel,
                                   od.resolve_kernel)] == launches


def test_kernel_frames_stay_zero_on_a_cpu_scene(scene):
    """rf.deferred.kernel_frames counts 0 for every frame of the default
    engine on a CPU scene, whose passes are the torch ones."""
    r = pd.DeferredRenderer(scene, W, H)
    assert r.engine == "kernel"
    with profiling.recording() as rec:
        for _ in range(3):
            r.render(_camera(), sky_state_from_ui(*SKY), EXPOSURE)
    counts = [(c.name, c.n, c.frame) for c in rec.records() if isinstance(c, profiling.Count)
              and c.name == profiling.KERNEL_FRAMES]
    assert counts == [(profiling.KERNEL_FRAMES, 0, f) for f in range(3)]


def test_kernel_route_takes_every_pass_through_the_wrappers(scene, monkeypatch):
    """With the kernel route taken (forced here on the CPU, where the
    wrappers run their plain versions), a frame goes through the three
    wrappers once each and the renderer hands the frame the host sky; the
    frames equal the torch route's bit for bit and kernel_frames counts 1 a
    frame."""
    calls = []

    def spy(fn):
        def wrapped(*args, **kw):
            calls.append(fn.__name__)
            return fn(*args, **kw)
        return wrapped

    for name in ("gbuffer_kernel", "lighting_kernel", "resolve_kernel"):
        monkeypatch.setattr(od, name, spy(getattr(od, name)))
    sky = sky_state_from_ui(*SKY)
    plain = pd.DeferredRenderer(scene, W, H, engine="plain")
    want = [plain.render(_camera(), sky, EXPOSURE) for _ in range(2)]
    monkeypatch.setattr(pd, "_on_kernels", lambda scene, engine: engine == "kernel")
    r = pd.DeferredRenderer(scene, W, H)
    monkeypatch.setattr(r, "_device_sky", lambda s: pytest.fail("the sky went to the device"))
    with profiling.recording() as rec:
        got = [r.render(_camera(), sky, EXPOSURE) for _ in range(2)]
    assert calls == ["gbuffer_kernel", "lighting_kernel", "resolve_kernel"] * 2
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))
    assert torch.equal(r.accum, plain.accum)
    assert [c.n for c in rec.records() if isinstance(c, profiling.Count)
            and c.name == profiling.KERNEL_FRAMES] == [1, 1]
