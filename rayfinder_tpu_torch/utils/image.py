"""PNG I/O and image comparison for the tools and golden tests.

Counterpart of `rayfinder_tpu.utils.image`. PNGs are written with the
port's zlib coder (scene/texture.py `encode_png`: 8-bit RGB or RGBA, filter
0 on every row), so the machine with the GPU, which has no Pillow, can write
and read them; reading any other PNG needs Pillow and raises without it.
"""

from __future__ import annotations

import pathlib

import numpy as np

from ..scene.texture import _decode_plain_png, _decode_with_pillow, encode_png


def write_png(path, image: np.ndarray) -> None:
    """Write an (H, W, 3|4) uint8 or float [0, 1] image to PNG."""
    image = np.asarray(image)
    if image.dtype != np.uint8:
        image = (np.clip(image, 0.0, 1.0) * 255.0).astype(np.uint8)
    pathlib.Path(path).write_bytes(encode_png(image))


def read_png(path) -> np.ndarray:
    """(H, W, C) uint8 pixels of a PNG file, C as stored."""
    data = pathlib.Path(path).read_bytes()
    image = _decode_plain_png(data)
    return image if image is not None else _decode_with_pillow(data, convert=None)


def rmse(a: np.ndarray, b: np.ndarray) -> float:
    """Root-mean-square error over all channels, inputs in [0, 1]."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    if a.shape != b.shape:
        raise ValueError(f"shapes differ: {a.shape} and {b.shape}")
    return float(np.sqrt(np.mean((a - b) ** 2)))
