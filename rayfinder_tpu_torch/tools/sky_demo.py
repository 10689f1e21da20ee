"""CLI: render the upper-hemisphere fisheye sky dome.

    python -m rayfinder_tpu_torch.tools.sky_demo -o sky.png [--device cpu]

Counterpart of `rayfinder_tpu.tools.sky_demo`, with parity with
hw-skymodel-demo (src/hw-skymodel-demo/main.cpp:24-103): 720x720
orthographic hemisphere projection, sun at zenith 30 degrees, turbidity 1,
sigmoid exposure 2/(1+exp(-0.1x)) - 1, solar disk included. The radiance is
evaluated on the card unless another device is named.
"""

from __future__ import annotations

import argparse
import pathlib
import sys

import numpy as np


def render_sky_dome(
    size: int = 720,
    sun_zenith_degrees: float = 30.0,
    sun_azimuth_degrees: float = 0.0,
    turbidity: float = 1.0,
    exposure: float = 0.1,
    device="cuda",
) -> np.ndarray:
    """The (size, size, 3) float image in [0, 1]; black outside the dome."""
    import torch

    from ..render.tonemap import expose_sigmoid
    from ..sky.model import sky_radiance, sky_state_from_ui

    state = sky_state_from_ui(turbidity, (1.0, 1.0, 1.0), sun_zenith_degrees, sun_azimuth_degrees)

    # Pixel grid: x right, y up, (left, top) written first (main.cpp:47-61).
    js, is_ = np.meshgrid(np.arange(size), np.arange(size), indexing="xy")
    u = js.astype(np.float32) / np.float32(size)
    v = is_.astype(np.float32) / np.float32(size)
    x = 2.0 * u - 1.0
    y = 1.0 - 2.0 * v
    r2 = x * x + y * y
    inside = r2 < 1.0

    z = np.sqrt(np.maximum(1.0 - r2, 0.0)).astype(np.float32)
    # Direction: v = normalize(x, z, -y) (main.cpp:68-70); already unit length.
    direction = np.stack([x, z, -y], axis=-1).astype(np.float32)

    theta = np.arccos(np.clip(direction[..., 1], -1.0, 1.0))
    gamma = np.arccos(np.clip(direction @ state.sun_direction, -1.0, 1.0))

    radiance = sky_radiance(state, torch.from_numpy(theta.reshape(-1)).to(device),
                            torch.from_numpy(gamma.reshape(-1)).to(device))
    color = expose_sigmoid(radiance, exposure).cpu().numpy().reshape(size, size, 3)
    color = np.where(inside[..., None], color, 0.0)
    return np.clip(color, 0.0, 1.0)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("-o", "--output", type=pathlib.Path, default=pathlib.Path("hw-skymodel-demo.png"))
    parser.add_argument("--size", type=int, default=720)
    parser.add_argument("--sun-zenith", type=float, default=30.0)
    parser.add_argument("--sun-azimuth", type=float, default=0.0)
    parser.add_argument("--turbidity", type=float, default=1.0)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    from ..utils.image import write_png

    img = render_sky_dome(args.size, args.sun_zenith, args.sun_azimuth, args.turbidity,
                          device=args.device)
    write_png(args.output, img)
    print(f"wrote {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
