"""CPU-side texture representation.

Textures are stored as packed BGRA uint32 pixels — the same in-memory layout
the reference uploads to the GPU (src/common/texture.{hpp,cpp}), so that the
`.pt` scene format round-trips bit-exactly and the renderer's texel unpack
(b | g<<8 | r<<16 | a<<24) matches the reference's WGSL `textureLookup`
(src/pt/reference_path_tracer.wgsl:552-565).

Counterpart of `rayfinder_tpu.scene.texture`. The machine with the GPU has
no Pillow, so PNGs are encoded (`encode_png`: 8-bit RGB or RGBA, filter 0
on every row) and decoded (`decode_png`: 8-bit grey, grey + alpha, RGB or
RGBA, no interlace, any row filter) with zlib alone; any other image (JPEG,
palette, 16-bit, interlaced) needs Pillow.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import io
import struct
import zlib

import numpy as np

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


# PNG colour types of encode_png by channel count: RGB, RGBA.
_COLOR_TYPE = {3: 2, 4: 6}


def encode_png(rgba: np.ndarray) -> bytes:
    """(h, w, 4) uint8 RGBA or (h, w, 3) RGB -> PNG bytes: 8-bit RGBA or
    RGB, filter 0 on every row."""
    h, w, c = rgba.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), rgba.reshape(h, c * w)], axis=1)
    return (_PNG_SIGNATURE
            + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPE[c], 0, 0, 0))
            + _png_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _png_chunk(b"IEND", b""))


def _unfilter(rows: np.ndarray, bpp: int) -> np.ndarray:
    """Undo the PNG row filters (0 none, 1 sub, 2 up, 3 average, 4 Paeth)
    of (h, 1 + stride) filtered rows with `bpp` bytes per pixel; returns
    the (h, stride) uint8 scanlines. Sub is a running sum per channel and
    up a sum with the row above; average and Paeth go pixel by pixel."""
    h, stride = rows.shape[0], rows.shape[1] - 1
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        kind, line = int(rows[y, 0]), rows[y, 1:].astype(np.int32)
        if kind == 1:
            line = line.reshape(-1, bpp).cumsum(axis=0).reshape(-1)
        elif kind == 2:
            line = line + prev
        elif kind in (3, 4):
            for x in range(0, stride, bpp):
                a = line[x - bpp:x] if x else np.zeros(bpp, np.int32)
                b = prev[x:x + bpp]
                if kind == 3:
                    pred = (a + b) // 2
                else:
                    c = prev[x - bpp:x] if x else np.zeros(bpp, np.int32)
                    p = a + b - c
                    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
                    pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
                line[x:x + bpp] = (line[x:x + bpp] + pred) & 0xFF
        elif kind != 0:
            raise ValueError(f"PNG row filter {kind} is not one of 0-4")
        prev = line & 0xFF
        out[y] = prev
    return out


# PNG colour types by channel count: grey, grey + alpha, RGB, RGBA.
_CHANNELS = {0: 1, 4: 2, 2: 3, 6: 4}


def decode_png(data: bytes) -> np.ndarray | None:
    """(h, w, c) uint8 pixels of an 8-bit, non-interlaced PNG as stored (c =
    1 grey, 2 grey + alpha, 3 RGB, 4 RGBA), any row filter; None for any
    other image (16-bit, palette, interlaced, not a PNG)."""
    if not data.startswith(_PNG_SIGNATURE):
        return None
    pos, idat, header = len(_PNG_SIGNATURE), [], None
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + length
    if header is None or header[3] not in _CHANNELS or header[2] != 8 or header[4:] != (0, 0, 0):
        return None
    w, h, c = header[0], header[1], _CHANNELS[header[3]]
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if rows.size != h * (c * w + 1):
        return None
    return _unfilter(rows.reshape(h, c * w + 1), c).reshape(h, w, c)


def _decode_rgba(data: bytes) -> np.ndarray | None:
    """(h, w, 4) RGBA of a PNG that decode_png reads, grey spread over R, G
    and B and alpha 255 where the image has none (Pillow's
    `convert("RGBA")`); None for any other image."""
    img = decode_png(data)
    if img is None:
        return None
    h, w, c = img.shape
    if c == 4:
        return img
    alpha = img[:, :, c - 1:] if c in (2, 4) else np.full((h, w, 1), 255, np.uint8)
    rgb = img[:, :, :3] if c == 3 else np.repeat(img[:, :, :1], 3, axis=2)
    return np.concatenate([rgb, alpha], axis=2)


def _decode_with_pillow(data: bytes, convert: str | None = "RGBA") -> np.ndarray:
    """The image's pixels through Pillow, converted to mode `convert` (as
    stored when None). Raises when Pillow is not installed."""
    if importlib.util.find_spec("PIL") is None:
        raise RuntimeError(
            "decoding this image needs Pillow, which is not installed (only "
            "8-bit RGB or RGBA PNGs with filter 0 on every row decode without it)")
    from PIL import Image

    image = Image.open(io.BytesIO(data))
    return np.asarray(image if convert is None else image.convert(convert), dtype=np.uint8)


@dataclasses.dataclass(frozen=True)
class Texture:
    """An RGBA image packed as row-major BGRA uint32 pixels.

    pixels: (height * width,) uint32, top-left pixel first.
    """

    pixels: np.ndarray
    width: int
    height: int

    def __post_init__(self):
        assert self.pixels.dtype == np.uint32
        assert self.pixels.size == self.width * self.height

    @staticmethod
    def from_memory(data: bytes) -> "Texture":
        """Decode PNG/JPEG bytes into a BGRA texture.

        Matches Texture::fromMemory (src/common/texture.cpp:12-54): output is
        always 4-channel with alpha forced to 255 (stb fills alpha for 3-channel
        sources; the reference then overwrites alpha with 255 for all sources).
        """
        rgba = _decode_rgba(data)
        if rgba is None:
            rgba = _decode_with_pillow(data)
        rgba = rgba.astype(np.uint32)  # (h, w, 4)
        h, w = rgba.shape[:2]
        r, g, b = rgba[..., 0], rgba[..., 1], rgba[..., 2]
        bgra = b | (g << np.uint32(8)) | (r << np.uint32(16)) | np.uint32(255 << 24)
        return Texture(bgra.reshape(-1).astype(np.uint32), width=w, height=h)

    @staticmethod
    def from_pixel(r: float, g: float, b: float, a: float) -> "Texture":
        """1x1 solid-color texture (src/common/texture.cpp:56-65)."""
        r8, g8, b8, a8 = (np.uint32(int(c * 255.0)) for c in (r, g, b, a))
        px = b8 | (g8 << np.uint32(8)) | (r8 << np.uint32(16)) | (a8 << np.uint32(24))
        return Texture(np.asarray([px], dtype=np.uint32), width=1, height=1)

    def to_rgba(self) -> np.ndarray:
        """Unpack to (height, width, 4) uint8 RGBA."""
        px = self.pixels.reshape(self.height, self.width)
        b = px & np.uint32(0xFF)
        g = (px >> np.uint32(8)) & np.uint32(0xFF)
        r = (px >> np.uint32(16)) & np.uint32(0xFF)
        a = (px >> np.uint32(24)) & np.uint32(0xFF)
        return np.stack([r, g, b, a], axis=-1).astype(np.uint8)
