"""CPU-side texture representation.

Textures are stored as packed BGRA uint32 pixels — the same in-memory layout
the reference uploads to the GPU (src/common/texture.{hpp,cpp}), so that the
`.pt` scene format round-trips bit-exactly and the renderer's texel unpack
(b | g<<8 | r<<16 | a<<24) matches the reference's WGSL `textureLookup`
(src/pt/reference_path_tracer.wgsl:552-565).

Counterpart of `rayfinder_tpu.scene.texture`. The machine with the GPU has
no Pillow, so PNGs of the plain form this package writes (8-bit RGB or
RGBA, no interlace, filter 0 on every row: `encode_png`) are encoded and
decoded with zlib alone; any other image needs Pillow.
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


# PNG colour types by channel count: RGB, RGBA.
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


def _decode_plain_png(data: bytes) -> np.ndarray | None:
    """(h, w, 4) uint8 RGBA or (h, w, 3) RGB of a PNG in `encode_png`'s
    form; None for any other image."""
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
    channels = {t: c for c, t in _COLOR_TYPE.items()}
    if header is None or header[3] not in channels or header[2:] != (8, header[3], 0, 0, 0):
        return None
    w, h, c = header[0], header[1], channels[header[3]]
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if rows.size != h * (c * w + 1):
        return None
    rows = rows.reshape(h, c * w + 1)
    if rows[:, 0].any():
        return None
    return rows[:, 1:].reshape(h, w, c)


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
        rgba = _decode_plain_png(data)
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
