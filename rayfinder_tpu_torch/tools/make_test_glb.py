"""Deterministic multi-mesh, multi-texture GLB generator for loader tests.

The reference checkout ships only Duck.glb (one mesh, one texture, trivial
hierarchy), so the Sponza-class code paths of the loader — node-hierarchy
TRS chains with inverse-transpose normal matrices
(reference: src/common/gltf_model.cpp:29-72), texture dedup across many
materials incl. FNV-1a factor hashing (gltf_model.cpp:143-263), and
texture-sorted mesh output (gltf_model.cpp:462-464) — had never been fed
input that exercises them. This tool emits a GLB that does:

* 10 meshes under a >= 3-deep TRS node hierarchy, several with NON-UNIFORM
  scales (the inverse-transpose normal-matrix path matters);
* one node using a raw column-major `matrix` instead of TRS;
* 6 embedded PNG image textures of mixed sizes, one of them referenced by
  TWO different materials (image dedup), plus 3 factor-only materials of
  which two share the same factor (FNV-1a dedup);
* one mesh referenced by TWO nodes — per the reference's transforms-by-mesh
  indexing (gltf_model.cpp:56-64) the LAST traversed node's transform wins
  and the mesh is emitted once;
* uint16 and uint32 index accessors.

Usage: python -m rayfinder_tpu_torch.tools.make_test_glb [out.glb]
(default: rayfinder_tpu_torch/assets/test_scene.glb)

Counterpart of `rayfinder_tpu.tools.make_test_glb`: the same document, the
same geometry and the same pixels from the same seeds. The machine with the
GPU has no Pillow, so the six PNGs are encoded by the port's zlib writer
(scene/texture.py `encode_png`); their bytes differ from the JAX tool's, and
every loader decodes the same pixels from them.
"""

from __future__ import annotations

import json
import pathlib
import struct
import sys

import numpy as np

from ..scene.texture import encode_png

_GLB_MAGIC = 0x46546C67
_CHUNK_JSON = 0x4E4F534A
_CHUNK_BIN = 0x004E4942


def _png_bytes(size: tuple[int, int], seed: int) -> bytes:
    """A small deterministic RGBA PNG with a per-seed pattern."""
    w, h = size
    yy, xx = np.mgrid[0:h, 0:w]
    r = ((xx * (seed + 3) * 29 + yy * 7) % 256).astype(np.uint8)
    g = ((yy * (seed + 5) * 13 + xx * 11) % 256).astype(np.uint8)
    b = ((xx * yy + seed * 37) % 256).astype(np.uint8)
    a = np.full((h, w), 255, np.uint8)
    return encode_png(np.stack([r, g, b, a], axis=-1))


def _box() -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Unit box: 24 vertices (per-face normals/uvs), 36 indices."""
    faces = [
        ((0, 0, 1), [(-1, -1, 1), (1, -1, 1), (1, 1, 1), (-1, 1, 1)]),
        ((0, 0, -1), [(1, -1, -1), (-1, -1, -1), (-1, 1, -1), (1, 1, -1)]),
        ((1, 0, 0), [(1, -1, 1), (1, -1, -1), (1, 1, -1), (1, 1, 1)]),
        ((-1, 0, 0), [(-1, -1, -1), (-1, -1, 1), (-1, 1, 1), (-1, 1, -1)]),
        ((0, 1, 0), [(-1, 1, 1), (1, 1, 1), (1, 1, -1), (-1, 1, -1)]),
        ((0, -1, 0), [(-1, -1, -1), (1, -1, -1), (1, -1, 1), (-1, -1, 1)]),
    ]
    pos, nrm, uv, idx = [], [], [], []
    for fi, (n, corners) in enumerate(faces):
        base = len(pos)
        for ci, c in enumerate(corners):
            pos.append([0.5 * c[0], 0.5 * c[1], 0.5 * c[2]])
            nrm.append(list(n))
            uv.append([float(ci in (1, 2)), float(ci in (2, 3))])
        idx.extend([base, base + 1, base + 2, base, base + 2, base + 3])
    return (
        np.asarray(pos, np.float32), np.asarray(nrm, np.float32),
        np.asarray(uv, np.float32), np.asarray(idx, np.uint32),
    )


def _quad() -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    pos = np.asarray(
        [[-1, 0, -1], [1, 0, -1], [1, 0, 1], [-1, 0, 1]], np.float32
    )
    nrm = np.tile(np.asarray([[0, 1, 0]], np.float32), (4, 1))
    uv = np.asarray([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    idx = np.asarray([0, 1, 2, 0, 2, 3], np.uint32)
    return pos, nrm, uv, idx


def _yrot(deg: float) -> list[float]:
    h = np.deg2rad(deg) / 2.0
    return [0.0, float(np.sin(h)), 0.0, float(np.cos(h))]


def _xrot(deg: float) -> list[float]:
    h = np.deg2rad(deg) / 2.0
    return [float(np.sin(h)), 0.0, 0.0, float(np.cos(h))]


def build_test_glb(path) -> None:
    bin_parts: list[bytes] = []
    buffer_views: list[dict] = []
    accessors: list[dict] = []

    def add_view(data: bytes, align: int = 4) -> int:
        offset = sum(len(p) for p in bin_parts)
        pad = (-offset) % align
        if pad:
            bin_parts.append(b"\x00" * pad)
            offset += pad
        bin_parts.append(data)
        buffer_views.append(
            {"buffer": 0, "byteOffset": offset, "byteLength": len(data)}
        )
        return len(buffer_views) - 1

    def add_accessor(arr: np.ndarray, comp_type: int, type_: str) -> int:
        view = add_view(arr.tobytes())
        acc = {
            "bufferView": view,
            "componentType": comp_type,
            "count": int(arr.shape[0]),
            "type": type_,
        }
        if type_ == "VEC3":
            acc["min"] = [float(v) for v in arr.min(axis=0)]
            acc["max"] = [float(v) for v in arr.max(axis=0)]
        accessors.append(acc)
        return len(accessors) - 1

    def add_mesh(geom, material: int, wide_indices: bool) -> dict:
        pos, nrm, uv, idx = geom
        p = add_accessor(pos, 5126, "VEC3")
        n = add_accessor(nrm, 5126, "VEC3")
        t = add_accessor(uv, 5126, "VEC2")
        if wide_indices:
            i = add_accessor(idx.astype(np.uint32)[:, None], 5125, "SCALAR")
        else:
            i = add_accessor(idx.astype(np.uint16)[:, None], 5123, "SCALAR")
        return {
            "primitives": [{
                "attributes": {"POSITION": p, "NORMAL": n, "TEXCOORD_0": t},
                "indices": i,
                "material": material,
                "mode": 4,
            }]
        }

    # --- images: 6 PNGs of mixed sizes (atlas-path realism).
    sizes = [(16, 16), (32, 16), (8, 8), (16, 32), (24, 16), (8, 16)]
    images = []
    for seed, size in enumerate(sizes):
        images.append({"bufferView": add_view(_png_bytes(size, seed)),
                       "mimeType": "image/png"})
    textures = [{"source": i} for i in range(len(images))]

    # --- materials: 6 image-backed (m5 and m6 share image 3 -> image
    # dedup), red factor twice (FNV-1a dedup), blue factor once.
    materials = [
        {"pbrMetallicRoughness": {"baseColorTexture": {"index": i}}}
        for i in range(6)
    ]
    materials.append(  # m6: image 3 again, different material object
        {"pbrMetallicRoughness": {"baseColorTexture": {"index": 3}}}
    )
    red = [0.8, 0.1, 0.1, 1.0]
    materials.append({"pbrMetallicRoughness": {"baseColorFactor": red}})   # m7
    materials.append({"pbrMetallicRoughness": {"baseColorFactor": red}})   # m8
    materials.append({"pbrMetallicRoughness":
                      {"baseColorFactor": [0.1, 0.2, 0.9, 1.0]}})          # m9

    # --- meshes: boxes/quads over the 10 materials; mixed index widths.
    box, quad = _box(), _quad()
    meshes = [
        add_mesh(box, 0, False),   # mesh0 — SHARED by two nodes
        add_mesh(box, 1, True),
        add_mesh(quad, 7, False),  # red factor
        add_mesh(box, 2, False),
        add_mesh(box, 3, True),
        add_mesh(quad, 6, False),  # image 3 via the duplicate material
        add_mesh(box, 4, False),
        add_mesh(box, 5, False),
        add_mesh(quad, 8, True),   # red factor again (dedup)
        add_mesh(quad, 9, False),  # blue factor
    ]

    # --- >= 3-deep hierarchy with non-uniform scales and one matrix node.
    # Node 12 re-references mesh0 LAST in traversal order: its transform
    # wins (reference transforms-by-mesh indexing).
    b_matrix = np.array(
        [[0.5, 0.0, 0.0, -3.0],
         [0.0, 2.0, 0.0, 0.5],
         [0.0, 0.0, 1.5, 0.0],
         [0.0, 0.0, 0.0, 1.0]], np.float32
    )
    nodes = [
        # 0: root (non-uniform scale)
        {"scale": [1.0, 2.0, 1.0], "children": [1, 5, 9, 12]},
        # 1: a
        {"translation": [2.0, 0.0, 0.0], "rotation": _yrot(30.0),
         "children": [2, 3, 4]},
        {"scale": [2.0, 1.0, 0.5], "mesh": 0},                    # 2: a1
        {"translation": [0.0, 1.0, 0.0], "children": [13]},       # 3: a2
        {"translation": [0.0, -1.5, 0.5], "mesh": 2},             # 4: a3
        # 5: b — raw column-major matrix
        {"matrix": [float(v) for v in b_matrix.T.reshape(-1)],
         "children": [6, 7, 8]},
        {"translation": [0.0, 0.0, 2.0], "mesh": 3},              # 6: b1
        {"scale": [1.0, 0.5, 2.0], "mesh": 4},                    # 7: b2
        {"translation": [1.0, 1.0, 0.0], "mesh": 5},              # 8: b3
        # 9: c
        {"translation": [0.0, 0.0, -3.0], "children": [10, 11, 14, 15]},
        {"rotation": _xrot(-20.0), "mesh": 6},                    # 10: c1
        {"translation": [1.5, 0.0, 0.0], "mesh": 7},              # 11: c2
        # 12: d — re-references mesh0; traversed after node 2, so wins.
        {"translation": [0.0, 3.0, 0.0], "scale": [0.5, 1.0, 3.0],
         "mesh": 0},
        {"rotation": _xrot(45.0), "mesh": 1},                     # 13: a2x
        {"translation": [-1.5, 0.2, 0.0], "mesh": 8},             # 14: c3
        {"translation": [0.0, 0.2, 1.5], "mesh": 9},              # 15: c4
    ]

    doc = {
        "asset": {"version": "2.0", "generator": "rayfinder-tpu make_test_glb"},
        "scene": 0,
        "scenes": [{"nodes": [0]}],
        "nodes": nodes,
        "meshes": meshes,
        "materials": materials,
        "textures": textures,
        "images": images,
        "accessors": accessors,
        "bufferViews": buffer_views,
        "buffers": [{"byteLength": sum(len(p) for p in bin_parts)}],
    }

    bin_chunk = b"".join(bin_parts)
    bin_chunk += b"\x00" * ((-len(bin_chunk)) % 4)
    doc["buffers"][0]["byteLength"] = len(bin_chunk)
    json_chunk = json.dumps(doc, separators=(",", ":"), sort_keys=True).encode()
    json_chunk += b" " * ((-len(json_chunk)) % 4)

    total = 12 + 8 + len(json_chunk) + 8 + len(bin_chunk)
    with open(path, "wb") as f:
        f.write(struct.pack("<III", _GLB_MAGIC, 2, total))
        f.write(struct.pack("<II", len(json_chunk), _CHUNK_JSON))
        f.write(json_chunk)
        f.write(struct.pack("<II", len(bin_chunk), _CHUNK_BIN))
        f.write(bin_chunk)


DEFAULT_OUTPUT = pathlib.Path(__file__).resolve().parent.parent / "assets" / "test_scene.glb"


def main(argv: list[str] | None = None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    out = argv[0] if argv else DEFAULT_OUTPUT
    build_test_glb(out)
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
