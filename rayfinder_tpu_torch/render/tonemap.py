"""Tonemapping: ACES filmic fit + gamma 2.2 (reference_path_tracer.wgsl:59-63,
277-285), and the sky demo's sigmoid exposure. Counterpart of
`rayfinder_tpu.render.tonemap`."""

from __future__ import annotations

import torch


def aces_filmic(x):
    """Narkowicz's ACES filmic curve fit, saturated to [0, 1] (wgsl:277-285)."""
    a, b, c, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
    return torch.clamp((x * (a * x + b)) / (x * (c * x + d) + e), 0.0, 1.0)


def tonemap(linear_rgb, exposure: float):
    """Exposure-scaled ACES + gamma 2.2 encode -> [0, 1] (fsMain, wgsl:59-63)."""
    rgb = aces_filmic(float(exposure) * linear_rgb)
    return torch.pow(rgb, 1.0 / 2.2)


def expose_sigmoid(x, exposure: float):
    """The hw-skymodel-demo's exposure curve 2/(1+exp(-e*x)) - 1
    (src/hw-skymodel-demo/main.cpp expose())."""
    return 2.0 / (1.0 + torch.exp(-float(exposure) * x)) - 1.0
