"""Sampling noise: tiled blue-noise texture animated by an R2 offset.

Counterpart of `rayfinder_tpu.render.rng` (the reference's
`animatedBlueNoise`, reference_path_tracer.wgsl:602-616): the per-pixel 2D
noise is the 128x128 blue-noise tile value plus the frame's R2 offset,
wrapped to [0, 1). One value serves every sampling decision a pixel makes in
a frame.
`noise_of` is the regeneration loop's per-lane form, `animated_blue_noise`
the scan form's per-pixel one; both are the same arithmetic.
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


def animated_blue_noise(coords_y, coords_x, frame_idx: int, total_sample_count: int, tile=None):
    """Per-pixel animated 2D noise of frame `frame_idx` (wgsl:602-616).

    coords_y/coords_x: integer pixel coordinates (top-left origin), any
    shape; tile: the (128, 128, 2) f32 tile on their device (loaded when
    None). Returns (..., 2) float32 in [0, 1): noise_of with the pixel's tile
    value and sample 0 of frame_base frame_idx."""
    if tile is None:
        tile = torch.from_numpy(blue_noise_tile()).to(coords_y.device)
    h, w = tile.shape[0], tile.shape[1]
    base = tile[(coords_y % h).long(), (coords_x % w).long()]
    return noise_of(base, frame_idx, torch.zeros_like(coords_y), total_sample_count)
