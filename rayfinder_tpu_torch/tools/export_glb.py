"""Export a FlattenedScene (+ textures) as a standard GLB.

Purpose: drive BENCHMARK-SCALE assets through the production asset path —
the procedural courtyard (scene/procedural.py) exports to GLB, loads back
through scene/gltf.py -> io/ptformat.py (the reference's
gltf -> .pt -> render flow, src/pt-format-tool/main.cpp:15-35 ->
src/pt/main.cpp:126-135), and renders from the .pt file
(showcase/render_courtyard.py pt modes, tests/test_export_glb.py).

Layout: one mesh per texture index (triangle soup: 3 vertices per
triangle, uint32 indices), one material per texture with the BGRA pixels
re-encoded as an embedded PNG. Meshes are emitted in texture-index order,
which is also the loader's output order (gltf_model.cpp:462-464 sorts by
texture), so triangle order round-trips deterministically.

The port's own copy of `rayfinder_tpu.tools.export_glb`, same names and numerics,
except that the PNGs are written with zlib alone (scene/texture.encode_png),
so export needs no Pillow; the JAX loader reads them as any PNG.
"""

from __future__ import annotations

import json
import struct

import numpy as np

from ..scene.texture import encode_png

_GLB_MAGIC = 0x46546C67
_CHUNK_JSON = 0x4E4F534A
_CHUNK_BIN = 0x004E4942


def _texture_png(texture) -> bytes:
    """The texture as an 8-bit RGBA PNG, written with zlib alone (no Pillow)."""
    bgra = texture.pixels.reshape(texture.height, texture.width)
    b = (bgra & 0xFF).astype(np.uint8)
    g = ((bgra >> 8) & 0xFF).astype(np.uint8)
    r = ((bgra >> 16) & 0xFF).astype(np.uint8)
    a = ((bgra >> 24) & 0xFF).astype(np.uint8)
    return encode_png(np.stack([r, g, b, a], axis=-1))


def export_flattened_glb(flat, textures, path) -> None:
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
        buffer_views.append({"buffer": 0, "byteOffset": offset, "byteLength": len(data)})
        return len(buffer_views) - 1

    def add_accessor(arr: np.ndarray, comp_type: int, type_str: str,
                     with_bounds: bool = False) -> int:
        view = add_view(np.ascontiguousarray(arr).tobytes())
        acc = {
            "bufferView": view,
            "componentType": comp_type,
            "count": int(arr.shape[0]),
            "type": type_str,
        }
        if with_bounds:
            acc["min"] = [float(v) for v in arr.min(axis=0)]
            acc["max"] = [float(v) for v in arr.max(axis=0)]
        accessors.append(acc)
        return len(accessors) - 1

    tex_ids = np.asarray(flat.texture_indices)
    order = np.argsort(tex_ids, kind="stable")
    meshes, nodes, materials, images, gltf_textures = [], [], [], [], []

    for ti in range(len(textures)):
        sel = order[tex_ids[order] == ti]
        if sel.size == 0:
            continue
        pos = np.asarray(flat.positions, np.float32)[sel].reshape(-1, 3)
        nrm = np.asarray(flat.normals, np.float32)[sel].reshape(-1, 3)
        uv = np.asarray(flat.tex_coords, np.float32)[sel].reshape(-1, 2)
        idx = np.arange(pos.shape[0], dtype=np.uint32)

        img_id = len(images)
        images.append({"bufferView": add_view(_texture_png(textures[ti])),
                       "mimeType": "image/png"})
        gltf_textures.append({"source": img_id})
        mat_id = len(materials)
        materials.append({
            "pbrMetallicRoughness": {
                "baseColorTexture": {"index": img_id},
                "metallicFactor": 0.0,
            },
            "name": f"tex{ti}",
        })
        prim = {
            "attributes": {
                "POSITION": add_accessor(pos, 5126, "VEC3", with_bounds=True),
                "NORMAL": add_accessor(nrm, 5126, "VEC3"),
                "TEXCOORD_0": add_accessor(uv, 5126, "VEC2"),
            },
            "indices": add_accessor(idx[:, None], 5125, "SCALAR"),
            "material": mat_id,
        }
        nodes.append({"mesh": len(meshes), "name": f"mesh{ti}"})
        meshes.append({"primitives": [prim]})

    blob = b"".join(bin_parts)
    blob += b"\x00" * ((-len(blob)) % 4)
    doc = {
        "asset": {"version": "2.0", "generator": "rayfinder-tpu export_glb"},
        "scene": 0,
        "scenes": [{"nodes": list(range(len(nodes)))}],
        "nodes": nodes,
        "meshes": meshes,
        "materials": materials,
        "textures": gltf_textures,
        "images": images,
        "samplers": [{}],
        "buffers": [{"byteLength": len(blob)}],
        "bufferViews": buffer_views,
        "accessors": accessors,
    }
    js = json.dumps(doc, separators=(",", ":")).encode()
    js += b" " * ((-len(js)) % 4)
    out = struct.pack("<III", _GLB_MAGIC, 2, 12 + 8 + len(js) + 8 + len(blob))
    out += struct.pack("<II", len(js), _CHUNK_JSON) + js
    out += struct.pack("<II", len(blob), _CHUNK_BIN) + blob
    with open(path, "wb") as f:
        f.write(out)


def main() -> None:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("out", help="output .glb path")
    ap.add_argument("--scale", type=int, default=26,
                    help="courtyard subdivision (26 = 254K tris)")
    ap.add_argument("--untextured", action="store_true")
    args = ap.parse_args()

    from ..scene.procedural import courtyard_scene

    flat, textures = courtyard_scene(args.scale, textured=not args.untextured)
    export_flattened_glb(flat, textures, args.out)
    print(f"wrote {args.out}: {flat.num_triangles} tris, "
          f"{len(textures)} textures")


if __name__ == "__main__":
    main()
