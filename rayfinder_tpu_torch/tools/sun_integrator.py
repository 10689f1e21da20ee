"""CLI: regenerate the per-turbidity solar radiance constants.

    python -m rayfinder_tpu_torch.tools.sun_integrator [--size 64] [--write-disks]

Counterpart of `rayfinder_tpu.tools.sun_integrator` (numpy, float64).
Parity with the reference's hw-sunmodel-integrator
(src/hw-sunmodel-integrator/main.cpp:71-250): renders the 64x64 solar disk
through the upstream spectral model's `solar_disk_radiance` (with limb
darkening) for turbidities 1..10, integrates CIE 1931 XYZ over 11 wavelengths
(trapezoid rule, 320-720nm), converts to sRGB (Bruce Lindbloom matrix), and
prints the mean disk radiance as the C arrays pasted into the runtime
radiances tables. Optionally writes the per-turbidity sundisk PNGs.

The computed means must reproduce the baked `solar_radiances_{r,g,b}` tables
(asserted in tests/test_sun_integrator.py for the JAX package, and for the
port against it in tests/test_torch_tools.py) — the tables were generated
by this exact pipeline.
"""

from __future__ import annotations

import argparse
import pathlib
import sys

import numpy as np


def integrate_sun_disks(size: int = 64):
    """Returns (means (10, 3) float64, disks list of (size, size, 3) sRGB
    radiance images) for turbidities 1..10."""
    from ..sky.solar import WAVELENGTHS, solar_disk_radiance, spectral_to_srgb

    sun_zenith = np.deg2rad(30.0)
    sun_direction = np.asarray(
        [np.sin(sun_zenith), np.cos(sun_zenith), 0.0], np.float64
    )

    # Hemisphere pixel grid (main.cpp:103-125).
    js, is_ = np.meshgrid(np.arange(size), np.arange(size), indexing="xy")
    u = js / size
    v = is_ / size
    x = 2.0 * u - 1.0
    y = 1.0 - 2.0 * v
    r2 = x * x + y * y
    inside = r2 < 1.0
    z = np.sqrt(np.maximum(1.0 - r2, 0.0))
    dirs = np.stack([x, z, -y], axis=-1)
    norm = np.linalg.norm(dirs, axis=-1, keepdims=True)
    dirs = dirs / np.where(norm > 0, norm, 1.0)

    theta = np.arccos(np.clip(dirs[..., 1], -1.0, 1.0))
    gamma = np.arccos(np.clip(dirs @ sun_direction, -1.0, 1.0))
    solar_disk_radius = theta / (np.pi / 2.0)  # main.cpp:146

    means = []
    disks = []
    for turbidity in range(1, 11):
        rgb = np.zeros((size, size, 3), np.float64)
        samples = []
        for i in range(size):
            for j in range(size):
                if not inside[i, j]:
                    continue
                radiances = np.asarray(
                    [
                        solar_disk_radiance(
                            float(turbidity),
                            float(gamma[i, j]),
                            float(solar_disk_radius[i, j]),
                            float(wl),
                        )
                        for wl in WAVELENGTHS
                    ]
                )
                srgb = spectral_to_srgb(WAVELENGTHS, radiances)
                rgb[i, j] = srgb
                samples.append(srgb)
        means.append(np.mean(samples, axis=0))
        disks.append(rgb)
    return np.asarray(means), disks


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--size", type=int, default=64)
    parser.add_argument("--write-disks", action="store_true", help="write sundisk PNGs")
    parser.add_argument("--outdir", type=pathlib.Path, default=pathlib.Path("."))
    args = parser.parse_args(argv)

    means, disks = integrate_sun_disks(args.size)

    if args.write_disks:
        from ..utils.image import write_png

        exposure = 0.000002
        for turbidity, disk in enumerate(disks, start=1):
            color = 2.0 / (1.0 + np.exp(-exposure * disk)) - 1.0
            img = np.clip(color, 0.0, 1.0) ** (1.0 / 2.2)
            out = args.outdir / f"sundisk-turbidity-{turbidity}.png"
            write_png(out, img)
            print(f"wrote {out}", file=sys.stderr)

    for ch, name in enumerate("rgb"):
        print(f"const float solar_radiances_{name}[] = {{")
        for mean in means:
            print(f"    {mean[ch]:f}f,")
        print("};")
    return 0


if __name__ == "__main__":
    sys.exit(main())
