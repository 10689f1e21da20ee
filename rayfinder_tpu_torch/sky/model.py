"""Simplified RGB Hosek-Wilkie sky model.

Counterpart of `rayfinder_tpu.sky.model` (reference
src/hw-skymodel/hw_skymodel.c). The 33-float state is built on the host in
numpy exactly as the JAX package builds it (its module cannot be imported
without loading jax, so the build is carried over here), and the radiance is
evaluated per direction in torch. sky_on_device is the one place a state's
fields are copied to a device.
"""

from __future__ import annotations

import functools
import pathlib
from typing import NamedTuple

import numpy as np
import torch

from ..utils import profiling

SOLAR_RADIUS_RADIANS = np.float32(0.004450589)  # 0.255 degrees (hw_skymodel.c:16)

# The fit tables: the port's copy of the JAX package's asset.
_ASSETS = pathlib.Path(__file__).resolve().parents[1] / "assets"


class SkyParams(NamedTuple):
    """hw_skymodel.h:8-16. elevation in radians in [0, pi/2], turbidity in
    [1, 10], per-channel ground albedo in [0, 1]."""

    elevation: float
    turbidity: float = 1.0
    albedo: tuple[float, float, float] = (1.0, 1.0, 1.0)


class SkyState(NamedTuple):
    """Packed state (hw_skymodel.h:18-23 + sun direction), numpy float32."""

    params: np.ndarray  # (3, 9): RGB x Perez params
    sky_radiances: np.ndarray  # (3,)
    solar_radiances: np.ndarray  # (3,)
    sun_direction: np.ndarray  # (3,)


@functools.cache
def _tables() -> dict[str, np.ndarray]:
    with np.load(_ASSETS / "sky_tables.npz") as data:
        return {k: data[k] for k in data.files}


def _quintic_weights(t: float) -> np.ndarray:
    """Bernstein weights of the quintic Bezier (hw_skymodel.c:18-62)."""
    t = np.float32(t)
    it = np.float32(1.0) - t
    return np.asarray(
        [it**5, 5 * it**4 * t, 10 * it**3 * t**2, 10 * it**2 * t**3, 5 * it * t**4, t**5],
        dtype=np.float32,
    )


def _turbidity_blend(turbidity: float) -> tuple[int, int, np.float32]:
    t_int = int(turbidity)
    t_rem = np.float32(np.fmod(np.float32(turbidity), np.float32(1.0)))
    t_min = t_int - 1
    t_max = min(t_int, 9)
    return t_min, t_max, t_rem


def sun_direction_from_zenith_azimuth(zenith_radians: float, azimuth_radians: float) -> np.ndarray:
    """World-space unit sun direction (aligned_sky_state.hpp:54-57):
    y up, azimuth 0 along +x, positive azimuth toward -z."""
    d = np.asarray(
        [
            np.sin(zenith_radians) * np.cos(azimuth_radians),
            np.cos(zenith_radians),
            -np.sin(zenith_radians) * np.sin(azimuth_radians),
        ],
        dtype=np.float32,
    )
    return d / np.linalg.norm(d)


def sky_state_new(params: SkyParams, sun_direction=None) -> SkyState:
    """Host-side state construction (hw_skymodel.c:141-180). Raises
    ValueError when parameters are out of range."""
    elevation = float(params.elevation)
    turbidity = float(params.turbidity)
    albedo = np.asarray(params.albedo, dtype=np.float32)

    if not 0.0 <= elevation <= np.pi:
        raise ValueError("elevation out of range [0, pi]")
    if not 1.0 <= turbidity <= 10.0:
        raise ValueError("turbidity out of range [1, 10]")
    if np.any(albedo < 0.0) or np.any(albedo > 1.0):
        raise ValueError("albedo out of range [0, 1]")

    t = np.float32((elevation / (0.5 * np.pi)) ** (1.0 / 3.0))
    w = _quintic_weights(t)  # (6,)
    t_min, t_max, t_rem = _turbidity_blend(turbidity)
    tables = _tables()

    out_params = np.zeros((3, 9), dtype=np.float32)
    out_sky = np.zeros((3,), dtype=np.float32)
    out_solar = np.zeros((3,), dtype=np.float32)
    for ch_idx, ch in enumerate("rgb"):
        a = albedo[ch_idx]
        # Bilinear blend weights over (albedo, turbidity) corners
        # (hw_skymodel.c:82-85).
        s = np.asarray(
            [(1 - a) * (1 - t_rem), (1 - a) * t_rem, a * (1 - t_rem), a * t_rem],
            dtype=np.float32,
        )
        p = tables[f"params_{ch}"]  # (2, 10, 6, 9)
        corners = np.stack([p[0, t_min], p[0, t_max], p[1, t_min], p[1, t_max]])
        out_params[ch_idx] = np.einsum("c,k,ckp->p", s, w, corners, dtype=np.float32)

        r = tables[f"radiances_{ch}"]  # (2, 10, 6)
        r_corners = np.stack([r[0, t_min], r[0, t_max], r[1, t_min], r[1, t_max]])
        out_sky[ch_idx] = np.einsum("c,k,ck->", s, w, r_corners, dtype=np.float32)

        solar = tables[f"solar_radiances_{ch}"]  # (10,)
        out_solar[ch_idx] = solar[t_min] * (1 - t_rem) + solar[t_max] * t_rem

    if sun_direction is None:
        # elevation measured from the horizon: zenith = pi/2 - elevation.
        sun_direction = sun_direction_from_zenith_azimuth(0.5 * np.pi - elevation, 0.0)
    return SkyState(
        params=out_params,
        sky_radiances=out_sky,
        solar_radiances=out_solar,
        sun_direction=np.asarray(sun_direction, dtype=np.float32),
    )


def sky_state_from_ui(turbidity, albedo, sun_zenith_degrees, sun_azimuth_degrees) -> SkyState:
    """Build a SkyState from the UI-style parameters (aligned_sky_state.hpp:15-23)."""
    zen = np.float32(np.radians(sun_zenith_degrees))
    azi = np.float32(np.radians(sun_azimuth_degrees))
    return sky_state_new(
        SkyParams(elevation=float(0.5 * np.pi - zen), turbidity=float(turbidity), albedo=tuple(albedo)),
        sun_direction=sun_direction_from_zenith_azimuth(zen, azi),
    )


def sky_from_jax(params, sky_radiances, solar_radiances, sun_direction) -> SkyState:
    """Carry a JAX SkyState over from its numpy fields
    (`sky_from_jax(*jax_sky)`)."""
    return SkyState(*(np.asarray(a, np.float32) for a in (
        params, sky_radiances, solar_radiances, sun_direction)))


def sky_on_device(sky: SkyState, device) -> SkyState:
    """The state with its fields as float32 tensors on `device`: fields
    already there are kept, the others copied, their bytes counted in
    rf.h2d_bytes."""
    device = torch.device(device)
    fields, copied = [], 0
    for f in sky:
        if not (isinstance(f, torch.Tensor) and f.device == device):
            t = f if isinstance(f, torch.Tensor) else torch.from_numpy(np.asarray(f, np.float32))
            on = t.to(device)
            copied += 0 if on is f else on.nbytes
            f = on
        fields.append(f)
    if copied:
        profiling.count(profiling.H2D_BYTES, copied)
    return SkyState(*fields)


def _perez(state: SkyState, cos_theta, cos_gamma, gamma):
    """Perez-style radiance per channel from (..., 1) angle terms; the
    evaluation order of sky_radiance_dist (hw_skymodel.c:182-223,
    wgsl:247-275), state on gamma's device. Returns (..., 3)."""
    p = state.params  # (3, 9)
    r = state.sky_radiances
    cos_gamma2 = cos_gamma * cos_gamma
    exp_m = torch.exp(p[:, 4] * gamma)
    mie_m = (1.0 + cos_gamma2) / torch.pow(
        1.0 + p[:, 8] * p[:, 8] - 2.0 * p[:, 8] * cos_gamma, 1.5
    )
    zenith = torch.sqrt(cos_theta)
    radiance_lhs = 1.0 + p[:, 0] * torch.exp(p[:, 1] / (cos_theta + 0.01))
    radiance_rhs = (
        p[:, 2] + p[:, 3] * exp_m + p[:, 5] * cos_gamma2 + p[:, 6] * mie_m
        + p[:, 7] * zenith
    )
    return r * radiance_lhs * radiance_rhs


def sky_radiance_dist(state: SkyState, theta, gamma):
    """Sky dome radiance WITHOUT the solar disk for direction angles
    theta/gamma (...,) f32 (the path tracer adds the sun through next-event
    estimation only). Returns (..., 3)."""
    state = sky_on_device(state, gamma.device)
    theta = theta[..., None]
    gamma = gamma[..., None]
    return _perez(state, torch.abs(torch.cos(theta)), torch.cos(gamma), gamma)


def sky_radiance(state: SkyState, theta, gamma):
    """Full radiance including the constant solar disk (hw_skymodel.c:182-223):
    the CPU demo's semantics. theta/gamma: (...,) f32 tensors. Returns
    (..., 3)."""
    state = sky_on_device(state, gamma.device)
    base = sky_radiance_dist(state, theta, gamma)
    solar = state.solar_radiances
    in_disk = (gamma / float(SOLAR_RADIUS_RADIANS) <= 1.0)[..., None]
    return base + torch.where(in_disk, solar, 0.0)


def sky_radiance_dir(state: SkyState, direction):
    """Sky radiance for unit directions (B, 3), in the form the path kernel
    evaluates it: cos(theta) is the direction's y component and cos(gamma)
    the dot product with the sun, instead of cos(acos(.)) of each."""
    state = sky_on_device(state, direction.device)
    sun = state.sun_direction
    cos_g = (
        direction[:, 0] * sun[0] + direction[:, 1] * sun[1] + direction[:, 2] * sun[2]
    ).clamp(-1.0, 1.0)[:, None]
    cos_t = torch.abs(direction[:, 1].clamp(-1.0, 1.0))[:, None]
    return _perez(state, cos_t, cos_g, torch.acos(cos_g))
