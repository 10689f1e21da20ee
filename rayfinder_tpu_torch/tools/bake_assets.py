"""Bake the reference's numeric data tables into compact .npz assets.

Two data assets are required for parity with the reference renderer:

* The simplified Hosek-Wilkie RGB sky-model fit tables
  (reference: src/hw-skymodel/params_{r,g,b}.h, radiances_{r,g,b}.h).
  Each params table is 1080 floats: [albedo(2)][turbidity(10)][bezier-knot(6)][param(9)].
  Each radiances table is 120 floats: [albedo(2)][turbidity(10)][bezier-knot(6)],
  plus 10 per-turbidity solar-disk radiance constants.

* The 128x128 2-channel (RG) 8-bit blue-noise tile
  (reference: src/pt/blue_noise.{h,c}, generated from a free
  momentsingraphics LDR_RG01 texture by tools/blue_noise/src/main.rs).

This script parses the numeric literals out of the reference headers once and
stores them as .npz next to the package so that the runtime has no dependency
on the reference tree. Counterpart of `rayfinder_tpu.tools.bake_assets`,
with the same parsers; it writes into the port's assets directory
(rayfinder_tpu_torch/assets/) unless --output-dir names another. Run
manually, with a checkout of the reference renderer (not part of this
repository):

    python -m rayfinder_tpu_torch.tools.bake_assets --reference path/to/rayfinder
"""

from __future__ import annotations

import argparse
import pathlib
import re

import numpy as np

_FLOAT_RE = re.compile(r"[-+]?(?:\d+\.?\d*|\.\d+)(?:[eE][-+]?\d+)?f?")
_INT_RE = re.compile(r"\b\d+\b")


def _floats_from_c_array(path: pathlib.Path, name: str, dtype=np.float32) -> np.ndarray:
    """Extract the float literals of `const float <name>[] = {...};`."""
    text = path.read_text()
    start = text.index(name)
    open_brace = text.index("{", start)
    close_brace = text.index("};", open_brace)
    body = re.sub(r"//[^\n]*", "", text[open_brace:close_brace])
    vals = [float(tok.rstrip("f")) for tok in _FLOAT_RE.findall(body)]
    return np.asarray(vals, dtype=dtype)


def _ints_from_c_array(path: pathlib.Path, name: str) -> np.ndarray:
    text = path.read_text()
    start = text.index(name)
    open_brace = text.index("{", start)
    close_brace = text.index("};", open_brace)
    body = text[open_brace + 1 : close_brace]
    vals = [int(tok) for tok in _INT_RE.findall(body)]
    return np.asarray(vals, dtype=np.uint8)


def bake_sky_tables(reference: pathlib.Path, out: pathlib.Path) -> None:
    sky_dir = reference / "src" / "hw-skymodel"
    arrays = {}
    for ch in "rgb":
        params = _floats_from_c_array(sky_dir / f"params_{ch}.h", f"params_{ch}")
        assert params.size == 2 * 10 * 6 * 9, params.size
        # [albedo, turbidity, knot, param]
        arrays[f"params_{ch}"] = params.reshape(2, 10, 6, 9)

        rad_path = sky_dir / f"radiances_{ch}.h"
        radiances = _floats_from_c_array(rad_path, f"radiances_{ch}")
        assert radiances.size == 2 * 10 * 6, radiances.size
        arrays[f"radiances_{ch}"] = radiances.reshape(2, 10, 6)

        solar = _floats_from_c_array(rad_path, f"solar_radiances_{ch}")
        assert solar.size == 10, solar.size
        arrays[f"solar_radiances_{ch}"] = solar

    np.savez_compressed(out, **arrays)
    print(f"wrote {out} ({out.stat().st_size} bytes)")


def bake_blue_noise(reference: pathlib.Path, out: pathlib.Path) -> None:
    src = reference / "src" / "pt" / "blue_noise.c"
    vals = _ints_from_c_array(src, "blueNoiseValues")
    assert vals.size == 128 * 128 * 2, vals.size
    # Pixels indexed from the top-left, consecutive R,G pairs
    # (reference: src/pt/blue_noise.h:9-13).
    tile = vals.reshape(128, 128, 2)
    np.savez_compressed(out, tile=tile)
    print(f"wrote {out} ({out.stat().st_size} bytes)")


def bake_solar_spectral(reference: pathlib.Path, out: pathlib.Path) -> None:
    """Spectral solar-disk datasets from the upstream Hosek-Wilkie model
    (ArHosekSkyModelData_Spectral.h): per wavelength band (320..720nm, 11
    bands) a piecewise-polynomial table of order(4) x pieces(45) x
    turbidity(10) doubles, plus 6 limb-darkening coefficients per band.
    Only these (not the full sky-dome spectral datasets) are needed by the
    sun integrator (hw-sunmodel-integrator/main.cpp:146-153)."""
    src = reference / "src" / "hosekwilkie-skylightmodel-source-1.4a"
    path = src / "ArHosekSkyModelData_Spectral.h"
    wavelengths = list(range(320, 721, 40))

    solar = np.stack(
        [
            _floats_from_c_array(path, f"solarDataset{wl}[]", np.float64)
            for wl in wavelengths
        ]
    )
    assert solar.shape == (11, 10 * 45 * 4), solar.shape

    # Full spectral sky-dome datasets (same [albedo][turbidity][knot][param]
    # layout as the RGB fit tables; ArHosekSkyModel.c CookConfiguration).
    sky = np.stack(
        [
            _floats_from_c_array(path, f"dataset{wl}[]", np.float64).reshape(2, 10, 6, 9)
            for wl in wavelengths
        ]
    )
    sky_rad = np.stack(
        [
            _floats_from_c_array(path, f"datasetRad{wl}[]", np.float64).reshape(2, 10, 6)
            for wl in wavelengths
        ]
    )
    limb = np.stack(
        [
            _floats_from_c_array(path, f"limbDarkeningDataset{wl}[]", np.float64)
            for wl in wavelengths
        ]
    )
    assert limb.shape == (11, 6), limb.shape
    np.savez_compressed(
        out,
        solar=solar.astype(np.float64),
        limb=limb.astype(np.float64),
        sky=sky,
        sky_rad=sky_rad,
    )
    print(f"wrote {out} ({out.stat().st_size} bytes)")


ASSETS = pathlib.Path(__file__).resolve().parent.parent / "assets"


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--reference", type=pathlib.Path, required=True,
                        help="a checkout of the reference renderer")
    parser.add_argument("--output-dir", type=pathlib.Path, default=ASSETS)
    args = parser.parse_args(argv)

    assets = args.output_dir
    assets.mkdir(parents=True, exist_ok=True)
    bake_sky_tables(args.reference, assets / "sky_tables.npz")
    bake_blue_noise(args.reference, assets / "blue_noise.npz")
    bake_solar_spectral(args.reference, assets / "solar_spectral.npz")


if __name__ == "__main__":
    main()
