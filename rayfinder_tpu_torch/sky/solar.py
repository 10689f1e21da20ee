"""Spectral solar-disk radiance from the upstream Hosek-Wilkie model.

Counterpart of `rayfinder_tpu.sky.solar` (numpy, float64), reading the
port's copy of `solar_spectral.npz`. Port of
`arhosekskymodel_solar_disk_radiance` and its piecewise-polynomial internals
(reference: src/hosekwilkie-skylightmodel-source-1.4a/
ArHosekSkyModel.c:345-441): direct solar radiance per wavelength band with
5th-order limb darkening, bilinearly interpolated over turbidity and
wavelength. Used offline by the sun integrator (tools/sun_integrator.py) to
derive the per-turbidity RGB solar radiance constants in the runtime sky
tables — not by the renderer itself.

All math in float64, matching the C code.
"""

from __future__ import annotations

import functools
import pathlib

import numpy as np

_ASSETS = pathlib.Path(__file__).resolve().parent.parent / "assets"

_PIECES = 45
_ORDER = 4
# ArHosekSkyModel.c:133: (0.51 degrees) / 2
TERRESTRIAL_SOLAR_RADIUS = np.deg2rad(0.51) / 2.0

WAVELENGTHS = np.arange(320.0, 721.0, 40.0)


@functools.cache
def _tables():
    with np.load(_ASSETS / "solar_spectral.npz") as data:
        return data["solar"].copy(), data["limb"].copy()


def _sr_internal(solar: np.ndarray, turbidity: int, wl: int, solar_disk_radius: float) -> float:
    """ArHosekSkyModel.c:348-371: piecewise cubic in elevation across 45
    pieces with cubically-warped breakpoints."""
    pos = int((1.0 - solar_disk_radius) ** (1.0 / 3.0) * _PIECES)
    if pos > 44:
        pos = 44
    break_x = (pos / _PIECES) ** 3.0 * (np.pi * 0.5)

    base = _ORDER * _PIECES * turbidity + _ORDER * (pos + 1) - 1
    elevation = 0.5 * np.pi * (1.0 - solar_disk_radius)
    x = elevation - break_x
    res = 0.0
    x_exp = 1.0
    row = solar[wl]
    for i in range(_ORDER):
        res += x_exp * row[base - i]
        x_exp *= x
    return res


def solar_disk_radiance(
    turbidity: float,
    gamma: float,
    solar_disk_radius: float,
    wavelength: float,
    solar_radius: float = TERRESTRIAL_SOLAR_RADIUS,
) -> float:
    """ArHosekSkyModel.c:373-441. gamma: angle from the sun center;
    solar_disk_radius: the caller's radial disk parameterization in [0, 1]."""
    assert 320.0 <= wavelength <= 720.0 and 1.0 <= turbidity <= 10.0
    solar, limb = _tables()

    turb_low = int(turbidity) - 1
    turb_frac = turbidity - (turb_low + 1)
    if turb_low == 9:
        turb_low = 8
        turb_frac = 1.0

    wl_low = int((wavelength - 320.0) / 40.0)
    wl_frac = np.fmod(wavelength, 40.0) / 40.0
    if wl_low == 10:
        wl_low = 9
        wl_frac = 1.0

    direct = (1.0 - turb_frac) * (
        (1.0 - wl_frac) * _sr_internal(solar, turb_low, wl_low, solar_disk_radius)
        + wl_frac * _sr_internal(solar, turb_low, wl_low + 1, solar_disk_radius)
    ) + turb_frac * (
        (1.0 - wl_frac) * _sr_internal(solar, turb_low + 1, wl_low, solar_disk_radius)
        + wl_frac * _sr_internal(solar, turb_low + 1, wl_low + 1, solar_disk_radius)
    )

    ld = (1.0 - wl_frac) * limb[wl_low] + wl_frac * limb[wl_low + 1]

    sol_rad_sin = np.sin(solar_radius)
    ar2 = 1.0 / (sol_rad_sin * sol_rad_sin)
    singamma = np.sin(gamma)
    sc2 = max(0.0, 1.0 - ar2 * singamma * singamma)
    sample_cosine = np.sqrt(sc2)

    darkening = sum(ld[i] * sample_cosine**i for i in range(6))
    return direct * darkening


# CIE 1931 color matching functions: multi-lobe gaussian fits
# (hw-sunmodel-integrator/main.cpp:33-57, Wyman et al. JCGT 2013).
def cie1931_x(wave):
    wave = np.asarray(wave, np.float64)
    t1 = (wave - 442.0) * np.where(wave < 442.0, 0.0624, 0.0374)
    t2 = (wave - 599.8) * np.where(wave < 599.8, 0.0264, 0.0323)
    t3 = (wave - 501.1) * np.where(wave < 501.1, 0.0490, 0.0382)
    return (
        0.362 * np.exp(-0.5 * t1 * t1)
        + 1.056 * np.exp(-0.5 * t2 * t2)
        - 0.065 * np.exp(-0.5 * t3 * t3)
    )


def cie1931_y(wave):
    wave = np.asarray(wave, np.float64)
    t1 = (wave - 568.8) * np.where(wave < 568.8, 0.0213, 0.0247)
    t2 = (wave - 530.9) * np.where(wave < 530.9, 0.0613, 0.0322)
    return 0.821 * np.exp(-0.5 * t1 * t1) + 0.286 * np.exp(-0.5 * t2 * t2)


def cie1931_z(wave):
    wave = np.asarray(wave, np.float64)
    t1 = (wave - 437.0) * np.where(wave < 437.0, 0.0845, 0.0278)
    t2 = (wave - 459.0) * np.where(wave < 459.0, 0.0385, 0.0725)
    return 1.217 * np.exp(-0.5 * t1 * t1) + 0.681 * np.exp(-0.5 * t2 * t2)


# Bruce Lindbloom's sRGB D65 matrix (hw-sunmodel-integrator/main.cpp:63-69).
XYZ_TO_SRGB = np.asarray(
    [
        [3.2404542, -1.5371385, -0.4985314],
        [-0.9692660, 1.8760108, 0.0415560],
        [0.0556434, -0.2040259, 1.0572252],
    ],
    np.float64,
)


class SpectralSkyState:
    """arhosekskymodelstate_alloc_init analog (ArHosekSkyModel.c:312-341):
    cooked per-wavelength-band Perez configurations + radiance scales.

    The cooking is the same quintic Bézier over solar elevation with bilinear
    albedo/turbidity blending as the runtime RGB fit
    (ArHosekSkyModel_CookConfiguration, mirrored by hw_skymodel.c:64-125) —
    evaluated in float64 over the upstream spectral datasets.
    """

    def __init__(self, solar_elevation: float, turbidity: float, albedo: float):
        with np.load(_ASSETS / "solar_spectral.npz") as data:
            sky = data["sky"]  # (11, 2, 10, 6, 9)
            sky_rad = data["sky_rad"]  # (11, 2, 10, 6)

        self.turbidity = float(turbidity)
        self.solar_radius = TERRESTRIAL_SOLAR_RADIUS

        t = (solar_elevation / (np.pi / 2.0)) ** (1.0 / 3.0)
        it = 1.0 - t
        w = np.asarray(
            [it**5, 5 * it**4 * t, 10 * it**3 * t**2, 10 * it**2 * t**3, 5 * it * t**4, t**5],
            np.float64,
        )
        int_turb = int(turbidity)
        rem = turbidity - int_turb
        lo = int_turb - 1
        hi = min(int_turb, 9)
        s = np.asarray(
            [(1 - albedo) * (1 - rem), albedo * (1 - rem), (1 - albedo) * rem, albedo * rem],
            np.float64,
        )
        corners = np.stack(
            [sky[:, 0, lo], sky[:, 1, lo], sky[:, 0, hi], sky[:, 1, hi]], axis=1
        )  # (11, 4, 6, 9)
        self.configs = np.einsum("c,k,wckp->wp", s, w, corners)  # (11, 9)
        rad_corners = np.stack(
            [sky_rad[:, 0, lo], sky_rad[:, 1, lo], sky_rad[:, 0, hi], sky_rad[:, 1, hi]],
            axis=1,
        )  # (11, 4, 6)
        self.radiances = np.einsum("c,k,wck->w", s, w, rad_corners)  # (11,)

    def skydome_radiance(self, theta: float, gamma: float, wavelength: float) -> float:
        """arhosekskymodel_skydome_radiance (ArHosekSkyModel.c:443-473)."""
        low_wl = int((wavelength - 320.0) / 40.0)
        if low_wl < 0 or low_wl >= 11:
            return 0.0
        interp = np.fmod((wavelength - 320.0) / 40.0, 1.0)

        def eval_band(band):
            c = self.configs[band]
            exp_m = np.exp(c[4] * gamma)
            ray_m = np.cos(gamma) ** 2
            mie_m = (1.0 + np.cos(gamma) ** 2) / (
                1.0 + c[8] * c[8] - 2.0 * c[8] * np.cos(gamma)
            ) ** 1.5
            zenith = np.sqrt(np.cos(theta))
            return (
                (1.0 + c[0] * np.exp(c[1] / (np.cos(theta) + 0.01)))
                * (c[2] + c[3] * exp_m + c[5] * ray_m + c[6] * mie_m + c[7] * zenith)
            ) * self.radiances[band]

        val_low = eval_band(low_wl)
        if interp < 1e-6:
            return float(val_low)
        result = (1.0 - interp) * val_low
        if low_wl + 1 < 11:
            result += interp * eval_band(low_wl + 1)
        return float(result)

    def solar_radiance(self, theta: float, gamma: float, wavelength: float) -> float:
        """Sky dome + direct solar disk (ArHosekSkyModel.c:473-489):
        the disk parameterization is gamma / solar_radius."""
        direct = 0.0
        if gamma < self.solar_radius:
            direct = solar_disk_radiance(
                self.turbidity,
                gamma,
                gamma / self.solar_radius,
                wavelength,
                self.solar_radius,
            )
        return self.skydome_radiance(theta, gamma, wavelength) + direct


def spectral_to_srgb(wavelengths: np.ndarray, radiances: np.ndarray) -> np.ndarray:
    """Trapezoid-rule XYZ integration over the sample grid + sRGB conversion
    (hw-sunmodel-integrator/main.cpp:155-186)."""
    n = len(wavelengths)
    delta = (wavelengths[-1] - wavelengths[0]) / n
    xyz = []
    for cmf in (cie1931_x, cie1931_y, cie1931_z):
        weights = cmf(wavelengths)
        total = 0.5 * (weights[0] * radiances[0] + weights[-1] * radiances[-1])
        total += float(np.sum(weights[1:-1] * radiances[1:-1]))
        xyz.append(total * delta)
    return XYZ_TO_SRGB @ np.asarray(xyz, np.float64)
