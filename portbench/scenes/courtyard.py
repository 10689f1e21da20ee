"""The courtyard scene, frozen for the benchmark.

A copy of the port's procedural courtyard (a floor, four walls, two rows of
columns and twelve crates; 14 image textures of 64-512 px when textured),
kept here so that the benchmark's input does not move when the program's
copy does. `make(subdiv=..., textured=...)` returns the flat triangle soup
and the textures as plain numpy arrays: the harness hands them to the
program's asset path, and the reference renders from them directly.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class Texture(NamedTuple):
    """BGRA texels as uint32 words (b | g << 8 | r << 16 | a << 24), row-major."""

    pixels: np.ndarray
    width: int
    height: int

    @staticmethod
    def from_pixel(r, g, b, a) -> "Texture":
        c = [int(x * 255.0) for x in (r, g, b, a)]
        word = c[2] | (c[1] << 8) | (c[0] << 16) | (c[3] << 24)
        return Texture(np.asarray([word], np.uint32), 1, 1)


class Scene(NamedTuple):
    """Per-triangle vertex attributes: positions, normals (T, 3, 3) f32,
    tex_coords (T, 3, 2) f32, texture_indices (T,) u32; and the textures."""

    positions: np.ndarray
    normals: np.ndarray
    tex_coords: np.ndarray
    texture_indices: np.ndarray
    textures: list


def make(subdiv: int = 8, textured: bool = False) -> Scene:
    """The courtyard at `subdiv` (26: 254,176 triangles)."""
    return courtyard_scene(subdiv, textured)


def _subdivided_quad(corner, edge_u, edge_v, subdiv: int) -> np.ndarray:
    """(2*subdiv^2, 3, 3) triangles tiling the parallelogram
    corner + s*edge_u + t*edge_v, CCW so cross(e1, e2) faces +normal."""
    s = np.linspace(0.0, 1.0, subdiv + 1, dtype=np.float32)
    grid = (
        np.asarray(corner, np.float32)
        + s[:, None, None] * np.asarray(edge_u, np.float32)
        + s[None, :, None] * np.asarray(edge_v, np.float32)
    )  # (subdiv+1, subdiv+1, 3)
    p00 = grid[:-1, :-1].reshape(-1, 3)
    p10 = grid[1:, :-1].reshape(-1, 3)
    p01 = grid[:-1, 1:].reshape(-1, 3)
    p11 = grid[1:, 1:].reshape(-1, 3)
    t1 = np.stack([p00, p10, p11], axis=1)
    t2 = np.stack([p00, p11, p01], axis=1)
    return np.concatenate([t1, t2], axis=0)


def _box(center, half, subdiv: int) -> np.ndarray:
    cx, cy, cz = center
    hx, hy, hz = half
    quads = [
        # +y (top), -y (bottom)
        ([cx - hx, cy + hy, cz - hz], [2 * hx, 0, 0], [0, 0, 2 * hz]),
        ([cx - hx, cy - hy, cz - hz], [0, 0, 2 * hz], [2 * hx, 0, 0]),
        # +x, -x
        ([cx + hx, cy - hy, cz - hz], [0, 2 * hy, 0], [0, 0, 2 * hz]),
        ([cx - hx, cy - hy, cz - hz], [0, 0, 2 * hz], [0, 2 * hy, 0]),
        # +z, -z
        ([cx - hx, cy - hy, cz + hz], [2 * hx, 0, 0], [0, 2 * hy, 0]),
        ([cx - hx, cy - hy, cz - hz], [0, 2 * hy, 0], [2 * hx, 0, 0]),
    ]
    return np.concatenate(
        [_subdivided_quad(c, u, v, subdiv) for c, u, v in quads], axis=0
    )


def courtyard_scene(subdiv: int = 8, textured: bool = False):
    """Build the Scene. Triangle count scales ~ subdiv^2:
    subdiv=8 → ~25K tris, subdiv=26 → ~262K tris (Sponza-sized).

    textured=True gives the scene Sponza-class MATERIAL variety: 14 distinct
    image textures of mixed sizes (64..512 px), with per-wall / per-column /
    per-crate texture assignment so the packed atlas (render/scene.py) sees
    many offsets live in one render. The JAX package round-trips each
    texture through PNG bytes with Pillow; PNG is lossless, so packing the
    8-bit pixels straight to BGRA gives the same textures without Pillow.
    textured=False keeps the legacy 4 solid 1x1 base colors (cheap engine
    tests)."""
    chunks: list[np.ndarray] = []
    materials: list[int] = []

    def add(tris: np.ndarray, material: int) -> None:
        chunks.append(tris.astype(np.float32))
        materials.extend([material] * tris.shape[0])

    # Material slots: untextured keeps the legacy 4 (floor/walls/columns/
    # crates); textured fans each group over distinct texture indices.
    def wall_mat(i):
        return 1 + (i % 4) if textured else 1

    def col_mat(i):
        return 5 + (i % 4) if textured else 2

    def crate_mat(i):
        return 9 + (i % 5) if textured else 3

    # Floor 40x20, walls height 12 (interior-facing normals).
    add(_subdivided_quad([-20, 0, -10], [0, 0, 20], [40, 0, 0], 2 * subdiv), 0)
    add(_subdivided_quad([-20, 0, -10], [40, 0, 0], [0, 12, 0], subdiv), wall_mat(0))  # -z
    add(_subdivided_quad([-20, 0, 10], [0, 12, 0], [40, 0, 0], subdiv), wall_mat(1))  # +z
    add(_subdivided_quad([-20, 0, -10], [0, 12, 0], [0, 0, 20], subdiv), wall_mat(2))  # -x
    add(_subdivided_quad([20, 0, -10], [0, 0, 20], [0, 12, 0], subdiv), wall_mat(3))  # +x

    # Two rows of columns.
    rng = np.random.default_rng(42)
    for ci, x in enumerate(np.linspace(-16, 16, 9)):
        for zi, z in enumerate((-5.0, 5.0)):
            add(_box([x, 4.0, z], [0.6, 4.0, 0.6], subdiv), col_mat(2 * ci + zi))
    # Scattered crates.
    for ki in range(12):
        cx = rng.uniform(-17, 17)
        cz = rng.uniform(-8, 8)
        h = rng.uniform(0.5, 1.5)
        add(_box([cx, h, cz], [h, h, h], subdiv), crate_mat(ki))

    positions = np.concatenate(chunks, axis=0)
    num_tris = positions.shape[0]

    e1 = positions[:, 1] - positions[:, 0]
    e2 = positions[:, 2] - positions[:, 0]
    n = np.cross(e1, e2)
    n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-12)
    normals = np.repeat(n[:, None, :], 3, axis=1).astype(np.float32)

    # Planar UVs from the two dominant axes of each triangle's bbox.
    uvs = positions[:, :, :2].copy()
    uvs -= uvs.min(axis=(0, 1))
    uvs /= max(uvs.max(), 1.0)
    if textured:
        # ~1 texture repeat per 5 world units (fract-wrapped at lookup,
        # like the reference's UV handling) so the checker/brick patterns
        # read at courtyard scale.
        uvs *= 8.0

    if textured:
        textures = courtyard_textures()
    else:
        textures = [
            Texture.from_pixel(0.65, 0.6, 0.55, 1.0),  # floor
            Texture.from_pixel(0.75, 0.72, 0.68, 1.0),  # walls
            Texture.from_pixel(0.8, 0.78, 0.7, 1.0),  # columns
            Texture.from_pixel(0.55, 0.35, 0.2, 1.0),  # crates
        ]
    return Scene(positions, normals, uvs.astype(np.float32),
                 np.asarray(materials, dtype=np.uint32), textures)


def courtyard_textures() -> list[Texture]:
    """The textured courtyard's 14 distinct mixed-size image textures (see
    courtyard_scene docstring).
    Index layout: 0 floor; 1-4 walls; 5-8 columns; 9-13 crates."""
    return [
        # 0: floor — large stone checker
        _rgb_texture(_checker_rgb(512, (0.72, 0.66, 0.58), (0.5, 0.46, 0.42), 16)),
        # 1-4: walls — brick variants, mixed sizes/tints
        _rgb_texture(_brick_rgb(512, (0.78, 0.74, 0.7), (0.6, 0.57, 0.54))),
        _rgb_texture(_brick_rgb(256, (0.84, 0.82, 0.74), (0.7, 0.68, 0.6))),
        _rgb_texture(_brick_rgb(320, (0.75, 0.68, 0.62), (0.55, 0.5, 0.46))),
        _rgb_texture(_brick_rgb(192, (0.8, 0.72, 0.66), (0.62, 0.55, 0.5))),
        # 5-8: columns — marble-ish banded stone
        _rgb_texture(_marble_rgb(128, (0.85, 0.83, 0.78), (0.66, 0.64, 0.6), 0)),
        _rgb_texture(_marble_rgb(96, (0.82, 0.8, 0.78), (0.6, 0.58, 0.56), 1)),
        _rgb_texture(_marble_rgb(160, (0.88, 0.84, 0.76), (0.68, 0.64, 0.56), 2)),
        _rgb_texture(_marble_rgb(64, (0.8, 0.78, 0.72), (0.58, 0.56, 0.5), 3)),
        # 9-13: crates — wood-grain variants
        _rgb_texture(_wood_rgb(128, (0.6, 0.4, 0.22), (0.42, 0.26, 0.13), 0)),
        _rgb_texture(_wood_rgb(96, (0.55, 0.36, 0.2), (0.38, 0.24, 0.12), 1)),
        _rgb_texture(_wood_rgb(256, (0.64, 0.44, 0.26), (0.46, 0.3, 0.16), 2)),
        _rgb_texture(_wood_rgb(64, (0.5, 0.33, 0.18), (0.34, 0.21, 0.1), 3)),
        _rgb_texture(_checker_rgb(112, (0.6, 0.38, 0.2), (0.44, 0.27, 0.14), 8)),
    ]


def _rgb_texture(rgb: np.ndarray) -> Texture:
    """(h, w, 3) float RGB -> 8-bit -> BGRA texture with alpha 255: what
    decoding the 8-bit image as a PNG gives (Texture.from_memory)."""
    u8 = np.clip(rgb * 255.0 + 0.5, 0, 255).astype(np.uint8).astype(np.uint32)
    bgra = u8[..., 2] | (u8[..., 1] << 8) | (u8[..., 0] << 16) | np.uint32(255 << 24)
    return Texture(bgra.reshape(-1).astype(np.uint32), rgb.shape[1], rgb.shape[0])


def _value_noise(size: int, cells: int, seed: int) -> np.ndarray:
    """Cheap tileable value noise in [0,1]: a random coarse grid bilinearly
    upsampled (wrap-around so fract-wrapped UVs don't seam)."""
    rng = np.random.default_rng(seed)
    coarse = rng.uniform(size=(cells, cells))
    y = np.linspace(0, cells, size, endpoint=False)
    x = np.linspace(0, cells, size, endpoint=False)
    yi, xi = np.floor(y).astype(int), np.floor(x).astype(int)
    yf, xf = (y - yi)[:, None], (x - xi)[None, :]
    c00 = coarse[np.ix_(yi % cells, xi % cells)]
    c10 = coarse[np.ix_((yi + 1) % cells, xi % cells)]
    c01 = coarse[np.ix_(yi % cells, (xi + 1) % cells)]
    c11 = coarse[np.ix_((yi + 1) % cells, (xi + 1) % cells)]
    return (
        c00 * (1 - yf) * (1 - xf)
        + c10 * yf * (1 - xf)
        + c01 * (1 - yf) * xf
        + c11 * yf * xf
    )


def _checker_rgb(size: int, a, b, cells: int) -> np.ndarray:
    yy, xx = np.meshgrid(np.arange(size), np.arange(size), indexing="ij")
    mask = ((yy * cells // size) + (xx * cells // size)) % 2
    rgb = np.where(mask[..., None] == 0, np.asarray(a), np.asarray(b))
    noise = 0.9 + 0.2 * _value_noise(size, 8, seed=size)
    return rgb * noise[..., None]


def _brick_rgb(size: int, brick, mortar) -> np.ndarray:
    yy, xx = np.meshgrid(np.arange(size), np.arange(size), indexing="ij")
    rows = yy * 8 // size
    xoff = (xx + (rows % 2) * (size // 8)) % size
    in_mortar = ((yy * 8 % size) < size // 16) | ((xoff * 4 % size) < size // 16)
    rgb = np.where(in_mortar[..., None], np.asarray(mortar), np.asarray(brick))
    noise = 0.88 + 0.24 * _value_noise(size, 16, seed=size + 1)
    return rgb * noise[..., None]


def _marble_rgb(size: int, light, dark, seed: int) -> np.ndarray:
    yy = np.arange(size)[:, None] / size
    warp = _value_noise(size, 4, seed=100 + seed)
    band = 0.5 + 0.5 * np.sin(2 * np.pi * (6 * yy + 1.5 * warp))
    rgb = np.asarray(light) * band[..., None] + np.asarray(dark) * (1 - band)[..., None]
    return rgb


def _wood_rgb(size: int, light, dark, seed: int) -> np.ndarray:
    xx = np.arange(size)[None, :] / size
    warp = _value_noise(size, 6, seed=200 + seed)
    grain = 0.5 + 0.5 * np.sin(2 * np.pi * (10 * xx + 2.0 * warp))
    rgb = np.asarray(light) * grain[..., None] + np.asarray(dark) * (1 - grain)[..., None]
    return rgb
