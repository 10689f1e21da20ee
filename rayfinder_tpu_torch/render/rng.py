"""Sampling noise: tiled blue-noise texture animated by an R2 offset.

Counterpart of `rayfinder_tpu.render.rng` (the reference's
`animatedBlueNoise`, reference_path_tracer.wgsl:602-616): the per-pixel 2D
noise is the 128x128 blue-noise tile value plus the frame's R2 offset,
wrapped to [0, 1). One value serves every sampling decision a pixel makes in
a frame.
"""

from __future__ import annotations

import functools
import pathlib

import numpy as np
import torch

_ASSETS = pathlib.Path(__file__).resolve().parents[1] / "assets"

# wgsl:609-610
A1 = np.float32(0.7548776662466927)
A2 = np.float32(0.5698402909980532)


@functools.cache
def blue_noise_tile() -> np.ndarray:
    """(128, 128, 2) float32 tile in [0, 1]."""
    with np.load(_ASSETS / "blue_noise.npz") as data:
        tile = data["tile"]
    return (tile.astype(np.float32) / np.float32(255.0)).astype(np.float32)


def noise_of(noise_base, frame_base: int, sample, spp: int):
    """Per-lane noise of sample index `sample` (B,) i32 for lanes whose tile
    value is `noise_base` (B, 2): tile base + the R2 offset of frame
    (frame_base + sample) mod spp, wrapped (pathtracer.py:531-536)."""
    n = torch.remainder(frame_base + sample, spp).to(torch.float32)
    r2 = torch.stack([float(A1) * n, float(A2) * n], dim=-1)
    r2 = r2 - torch.floor(r2)
    out = noise_base + r2
    return out - torch.floor(out)
