"""The deferred renderer's passes as CUDA kernels around K1/K2, and their
plain versions.

The G-buffer, lighting and resolve passes of render/deferred.py, on the
card in csrc/deferred.cu: per frame six small kernels between the four ray
queries, which stay the launches of K1 and K2 (ops/walk.py) on the same rays
in the same order. The frame's scalars (camera, jitter, sun, sky, exposure)
go to the kernels by value in one parameter block (`deferred_params`), so a
frame copies nothing to the card; the pixel coordinates come from the
thread index. The passes' results are new tensors each call, as the torch
passes' are; the rays and the walks' outputs between the launches are
scratch of the call, and the walks' bound is one T_MAX plane per size and
device, built once and cached for the process (`_t_max_plane`). The results equal the torch passes'
bit for bit (csrc/deferred.cu).

The plain versions are the torch passes of render/deferred.py on K1/K2's
plain walk. A wrapper given CPU tensors runs the plain version; given CUDA
tensors it launches its kernels or raises.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..render import deferred as passes
from ..render.camera import Camera
from ..render.intersect import T_MAX
from ..render.rng import blue_noise_tile
from ..render.scene import DeviceScene
from ..render.shade import FRAC_1_PI, SOLAR_COS_THETA_MAX, SOLAR_INV_PDF
from ..sky.model import SOLAR_RADIUS_RADIANS, SkyState
from . import _build
from .walk import any_into, closest_into

__all__ = [
    "gbuffer_kernel",
    "lighting_kernel",
    "resolve_kernel",
    "gbuffer_reference",
    "lighting_reference",
    "resolve_reference",
    "deferred_params",
]

_F3 = ctypes.c_float * 3


class DeferredParams(ctypes.Structure):
    """Mirror of DeferredParams in csrc/deferred.cu."""

    _fields_ = [
        ("cam_origin", _F3),
        ("lower_left", _F3),
        ("horizontal", _F3),
        ("vertical", _F3),
        ("jitter", ctypes.c_float * 2),
        ("inv_w", ctypes.c_float),
        ("inv_h", ctypes.c_float),
        ("sun", _F3),
        ("solar", _F3),
        ("sky_radiance", _F3),
        ("perez", ctypes.c_float * 27),
        ("one_minus_cos_max", ctypes.c_float),
        ("solar_inv_pdf", ctypes.c_float),
        ("frac_1_pi", ctypes.c_float),
        ("inv_solar_radius", ctypes.c_float),
        ("exposure", ctypes.c_float),
        ("width", ctypes.c_int),
        ("noise_frame", ctypes.c_int),
        ("blend", ctypes.c_int),
    ]


def _host(a, n: int) -> list[float]:
    """A float32 field (numpy, or a tensor on any device) as n Python floats."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, np.float32).reshape(n).tolist()


def deferred_params(frame_count: int, *, width: int = 1, height: int = 1, camera: Camera = None,
                    sky: SkyState = None, exposure: float = 1.0) -> DeferredParams:
    """The frame's parameter block: the camera's vectors and the frame's
    jitter (render/deferred.py _jitter), 1/width and 1/height as float32
    (_recip), the sky's state, the sun's sampling constants, the exposure,
    the noise's frame (frame_count mod 2^20) and whether the resolve blends
    (frame_count > 0). A camera or sky left out leaves its fields 0."""
    p = DeferredParams()
    if camera is not None:
        for name in ("origin", "lower_left_corner", "horizontal", "vertical"):
            setattr(p, "cam_origin" if name == "origin" else name.replace("_corner", ""),
                    _F3(*_host(getattr(camera, name), 3)))
    p.jitter[:] = passes._jitter(int(frame_count))
    p.inv_w, p.inv_h = passes._recip(width), passes._recip(height)
    if sky is not None:
        p.sun[:] = _host(sky.sun_direction, 3)
        p.solar[:] = _host(sky.solar_radiances, 3)
        p.sky_radiance[:] = _host(sky.sky_radiances, 3)
        p.perez[:] = _host(sky.params, 27)
    p.one_minus_cos_max = float(np.float32(1.0) - SOLAR_COS_THETA_MAX)
    p.solar_inv_pdf = float(SOLAR_INV_PDF)
    p.frac_1_pi = float(FRAC_1_PI)
    p.inv_solar_radius = float(np.float32(1.0) / SOLAR_RADIUS_RADIANS)
    p.exposure = float(exposure)
    p.width = int(width)
    p.noise_frame = int(frame_count) % passes._NOISE_PERIOD
    p.blend = int(int(frame_count) != 0)
    return p


@functools.lru_cache(maxsize=2)
def _t_max_plane(device: torch.device, n: int) -> torch.Tensor:
    """The walks' bound, T_MAX for each of n rays, on `device`: built once
    per size and device, read by every frame's four walks. The cache lives
    as long as the process and holds the last two planes (4 n bytes each:
    8.3 MB at 1080p), whatever renderers and scenes are gone."""
    return torch.full((n,), T_MAX, dtype=torch.float32, device=device)


def _empty(n: int, dev, *width, dtype=torch.float32):
    return torch.empty(n, *width, dtype=dtype, device=dev)


def _launch(fn: str, *args) -> None:
    err = getattr(_build.library(), fn)(*args)
    _build.raise_on_error(err, fn)


def gbuffer_reference(scene: DeviceScene, camera: Camera, frame_count: int, *, width: int,
                      height: int) -> dict:
    """Plain torch version of `gbuffer_kernel`, on any device: the torch
    G-buffer pass on K1's plain walk."""
    return passes.gbuffer_pass(scene, camera, frame_count, width=width, height=height,
                               engine="plain")


def gbuffer_kernel(scene: DeviceScene, camera: Camera, frame_count: int, *, width: int,
                   height: int) -> dict:
    """The G-buffer of render/deferred.py gbuffer_pass: the jittered
    primaries (deferred_rays_kernel), K1, the planes
    (deferred_gbuffer_kernel). Returns its dict of flat (H*W, ...) planes."""
    if scene.device.type == "cpu":
        return gbuffer_reference(scene, camera, frame_count, width=width, height=height)
    dev, n = scene.device, width * height
    params = deferred_params(frame_count, width=width, height=height, camera=camera)
    origin, direction = _empty(n, dev, 3), _empty(n, dev, 3)
    t = _empty(n, dev)
    tri, visits = (_empty(n, dev, dtype=torch.int32) for _ in range(2))
    out = dict(hit=_empty(n, dev, dtype=torch.bool), position=_empty(n, dev, 3),
               normal=_empty(n, dev, 3), albedo=_empty(n, dev, 3), depth=_empty(n, dev),
               view_dir=direction)
    if n:
        stream = _build.stream_of(dev)
        with torch.cuda.device(dev):
            _launch("rf_deferred_rays", ctypes.addressof(params), n, origin.data_ptr(),
                    direction.data_ptr(), stream)
            closest_into(scene, origin, direction, _t_max_plane(dev, n), t, tri, visits)
            _launch("rf_deferred_gbuffer", *_build.shade_args(scene, dev),
                    ctypes.addressof(params), n, direction.data_ptr(), t.data_ptr(),
                    tri.data_ptr(), *(out[k].data_ptr() for k in (
                        "hit", "position", "normal", "albedo", "depth")), stream)
        gbuffer_kernel.launches += 2
    return out


def lighting_reference(scene: DeviceScene, sky: SkyState, gbuffer: dict, frame_count: int, *,
                       width: int, height: int, tile=None):
    """Plain torch version of `lighting_kernel`, on any device: the torch
    lighting pass on K1/K2's plain walks."""
    return passes.lighting_pass(scene, sky, gbuffer, frame_count, width=width, height=height,
                                engine="plain", tile=tile)


def lighting_kernel(scene: DeviceScene, sky: SkyState, gbuffer: dict, frame_count: int, *,
                    width: int, height: int, tile=None):
    """The lighting of render/deferred.py lighting_pass: the lighting rays
    (deferred_light_rays_kernel), K2 toward the sun, K1 for the bounce, the
    bounce surface (deferred_bounce_kernel), K2 from it toward the sun, the
    sample (deferred_sample_kernel). tile: the (128, 128, 2) blue-noise tile
    on the scene's device (loaded when None). Returns the (H*W, 3)
    samples."""
    if scene.device.type == "cpu":
        return lighting_reference(scene, sky, gbuffer, frame_count, width=width, height=height,
                                  tile=tile)
    dev, n = scene.device, width * height
    if tile is None:
        tile = torch.from_numpy(blue_noise_tile()).to(dev)
    _build.check(tile, "tile", torch.float32, (128, 128, 2), dev)
    _build.check(gbuffer["hit"], "gbuffer['hit']", torch.bool, (n,), dev)
    for name in ("position", "normal", "albedo", "view_dir"):
        _build.check(gbuffer[name], f"gbuffer[{name!r}]", torch.float32, (n, 3), dev)
    hit, position, normal, albedo, view_dir = (
        gbuffer[k] for k in ("hit", "position", "normal", "albedo", "view_dir"))
    params = deferred_params(frame_count, width=width, height=height, sky=sky)
    origin, light, wi, b_origin, b_light, sample = (_empty(n, dev, 3) for _ in range(6))
    occluded, b_occluded = (_empty(n, dev, dtype=torch.bool) for _ in range(2))
    t = _empty(n, dev)
    tri, visits = (_empty(n, dev, dtype=torch.int32) for _ in range(2))
    if n:
        p, stream, t_max = ctypes.addressof(params), _build.stream_of(dev), _t_max_plane(dev, n)
        shade = _build.shade_args(scene, dev)
        with torch.cuda.device(dev):
            _launch("rf_deferred_light_rays", p, n, tile.data_ptr(), position.data_ptr(),
                    normal.data_ptr(), origin.data_ptr(), light.data_ptr(), wi.data_ptr(),
                    stream)
            any_into(scene, origin, light, t_max, occluded)
            closest_into(scene, origin, wi, t_max, t, tri, visits)
            _launch("rf_deferred_bounce", *shade, p, n, hit.data_ptr(), origin.data_ptr(),
                    wi.data_ptr(), light.data_ptr(), tri.data_ptr(), b_origin.data_ptr(),
                    b_light.data_ptr(), stream)
            any_into(scene, b_origin, light, t_max, b_occluded)
            _launch("rf_deferred_sample", p, n, hit.data_ptr(), view_dir.data_ptr(),
                    normal.data_ptr(), albedo.data_ptr(), light.data_ptr(),
                    occluded.data_ptr(), tri.data_ptr(), b_occluded.data_ptr(),
                    b_light.data_ptr(), sample.data_ptr(), stream)
        lighting_kernel.launches += 3
    return sample


def resolve_reference(sample, accum, frame_count: int, exposure: float):
    """Plain torch version of `resolve_kernel`, on any device: the torch
    resolve pass."""
    return passes.resolve_pass(sample, accum, frame_count, exposure)


def resolve_kernel(sample, accum, frame_count: int, exposure: float):
    """The resolve of render/deferred.py resolve_pass
    (deferred_resolve_kernel): the history blend (frame 0: the sample itself
    is the history), the tonemap and the u8 display. Returns (new_accum,
    display u8 (H*W, 3))."""
    if sample.device.type == "cpu":
        return resolve_reference(sample, accum, frame_count, exposure)
    dev, n = sample.device, sample.shape[0]
    _build.check(sample, "sample", torch.float32, (n, 3), dev)
    params = deferred_params(frame_count, exposure=exposure)
    if params.blend:
        _build.check(accum, "accum", torch.float32, (n, 3), dev)
        blended = _empty(n, dev, 3)
    else:
        blended = sample
    display = _empty(n, dev, 3, dtype=torch.uint8)
    if n:
        with torch.cuda.device(dev):
            _launch("rf_deferred_resolve", ctypes.addressof(params), n, sample.data_ptr(),
                    accum.data_ptr() if params.blend else None,
                    blended.data_ptr() if params.blend else None, display.data_ptr(),
                    _build.stream_of(dev))
        resolve_kernel.launches += 1
    return blended, display


# Kernel launch counts (a run resets and reads them to show which kernels it
# went through): deferred_rays_kernel and deferred_gbuffer_kernel;
# deferred_light_rays_kernel, deferred_bounce_kernel and
# deferred_sample_kernel; deferred_resolve_kernel. K1 and K2 count in
# ops/walk.py.
gbuffer_kernel.launches = 0
lighting_kernel.launches = 0
resolve_kernel.launches = 0
