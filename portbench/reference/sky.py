"""Simplified RGB Hosek-Wilkie sky: the state from the fit tables, and the
radiance toward a direction, in the two forms the renderers evaluate.

Built from the published fit tables (data/sky_tables.npz, the reference's
hw_skymodel.c datasets), as hw_skymodel.c builds its state, in float32.
"""

from __future__ import annotations

import pathlib
from typing import NamedTuple

import numpy as np
import torch

SOLAR_RADIUS_RADIANS = np.float32(0.004450589)  # 0.255 degrees
_TABLES = pathlib.Path(__file__).resolve().parent / "data" / "sky_tables.npz"


class SkyState(NamedTuple):
    params: np.ndarray  # (3, 9) Perez parameters per channel
    sky_radiances: np.ndarray  # (3,)
    solar_radiances: np.ndarray  # (3,)
    sun_direction: np.ndarray  # (3,)


def sun_direction(zenith: float, azimuth: float) -> np.ndarray:
    """y up, azimuth 0 along +x, positive azimuth toward -z."""
    d = np.asarray([np.sin(zenith) * np.cos(azimuth), np.cos(zenith),
                    -np.sin(zenith) * np.sin(azimuth)], dtype=np.float32)
    return d / np.linalg.norm(d)


def sky_state(turbidity: float, albedo, zenith_degrees: float, azimuth_degrees: float) -> SkyState:
    """hw_skymodel.c:141-180 from the UI's parameters."""
    zen = np.float32(np.radians(zenith_degrees))
    azi = np.float32(np.radians(azimuth_degrees))
    elevation = float(0.5 * np.pi - zen)
    albedo = np.asarray(albedo, np.float32)
    t = np.float32((elevation / (0.5 * np.pi)) ** (1.0 / 3.0))
    it = np.float32(1.0) - t
    w = np.asarray([it**5, 5 * it**4 * t, 10 * it**3 * t**2, 10 * it**2 * t**3,
                    5 * it * t**4, t**5], dtype=np.float32)
    t_int = int(turbidity)
    t_rem = np.float32(np.fmod(np.float32(turbidity), np.float32(1.0)))
    t_min, t_max = t_int - 1, min(t_int, 9)
    params = np.zeros((3, 9), np.float32)
    sky = np.zeros(3, np.float32)
    solar = np.zeros(3, np.float32)
    with np.load(_TABLES) as tables:
        for c, ch in enumerate("rgb"):
            a = albedo[c]
            s = np.asarray([(1 - a) * (1 - t_rem), (1 - a) * t_rem, a * (1 - t_rem), a * t_rem],
                           dtype=np.float32)
            p = tables[f"params_{ch}"]
            corners = np.stack([p[0, t_min], p[0, t_max], p[1, t_min], p[1, t_max]])
            params[c] = np.einsum("c,k,ckp->p", s, w, corners, dtype=np.float32)
            r = tables[f"radiances_{ch}"]
            r_corners = np.stack([r[0, t_min], r[0, t_max], r[1, t_min], r[1, t_max]])
            sky[c] = np.einsum("c,k,ck->", s, w, r_corners, dtype=np.float32)
            sol = tables[f"solar_radiances_{ch}"]
            solar[c] = sol[t_min] * (1 - t_rem) + sol[t_max] * t_rem
    return SkyState(params, sky, solar, sun_direction(zen, azi))


def _perez(state: SkyState, cos_theta, cos_gamma, gamma):
    """hw_skymodel.c:182-223 from (B, 1) angle terms. Returns (B, 3)."""
    dt = gamma.dtype
    p = torch.as_tensor(state.params, device=gamma.device).to(dt)
    r = torch.as_tensor(state.sky_radiances, device=gamma.device).to(dt)
    cos_gamma2 = cos_gamma * cos_gamma
    exp_m = torch.exp(p[:, 4] * gamma)
    mie_m = (1.0 + cos_gamma2) / torch.pow(
        1.0 + p[:, 8] * p[:, 8] - 2.0 * p[:, 8] * cos_gamma, 1.5)
    zenith = torch.sqrt(cos_theta)
    lhs = 1.0 + p[:, 0] * torch.exp(p[:, 1] / (cos_theta + 0.01))
    rhs = (p[:, 2] + p[:, 3] * exp_m + p[:, 5] * cos_gamma2 + p[:, 6] * mie_m
           + p[:, 7] * zenith)
    return r * lhs * rhs


def radiance_path(state: SkyState, direction):
    """The path tracer's sky (no solar disk: the sun arrives by next-event
    estimation), in its kernel's form: cos(theta) is the direction's y and
    cos(gamma) its dot product with the sun."""
    sun = torch.as_tensor(state.sun_direction, device=direction.device).to(direction.dtype)
    cos_g = (direction[:, 0] * sun[0] + direction[:, 1] * sun[1]
             + direction[:, 2] * sun[2]).clamp(-1.0, 1.0)[:, None]
    cos_t = torch.abs(direction[:, 1].clamp(-1.0, 1.0))[:, None]
    return _perez(state, cos_t, cos_g, torch.acos(cos_g))


def radiance_with_sun(state: SkyState, direction):
    """The deferred renderer's sky: the angles by acos, and the solar disk."""
    sun = torch.as_tensor(state.sun_direction, device=direction.device).to(direction.dtype)
    theta = torch.acos(direction[:, 1].clamp(-1.0, 1.0))[:, None]
    gamma = torch.acos((direction[:, 0] * sun[0] + direction[:, 1] * sun[1]
                        + direction[:, 2] * sun[2]).clamp(-1.0, 1.0))[:, None]
    base = _perez(state, torch.abs(torch.cos(theta)), torch.cos(gamma), gamma)
    solar = torch.as_tensor(state.solar_radiances, device=direction.device).to(direction.dtype)
    in_disk = gamma / float(SOLAR_RADIUS_RADIANS) <= 1.0
    return base + torch.where(in_disk, solar, 0.0)
