"""Minimal glTF 2.0 / GLB loader (stdlib json + struct + numpy).

Reproduces the loading semantics of the reference's cgltf-based loader
(src/common/gltf_model.cpp:266-465):

* single-scene files only;
* node hierarchy flattened with TRS-or-matrix local transforms, accumulating
  world transforms and inverse-transpose normal matrices
  (gltf_model.cpp:29-72);
* triangles-only primitives with required POSITION/NORMAL/TEXCOORD_0 float
  accessors and integer indices (gltf_model.cpp:320-440);
* base-color textures deduplicated by glTF image index; solid base-color
  factors become 1x1 textures deduplicated by an FNV-1a hash of the factor
  (gltf_model.cpp:143-263);
* resulting meshes sorted by base-color texture index (gltf_model.cpp:462-464).

One GltfMesh is emitted per primitive, in world space.

The port's own copy of `rayfinder_tpu.scene.gltf`, same names and numerics.
"""

from __future__ import annotations

import base64
import dataclasses
import json
import pathlib
import struct

import numpy as np

from .texture import Texture

_GLB_MAGIC = 0x46546C67  # 'glTF'
_CHUNK_JSON = 0x4E4F534A
_CHUNK_BIN = 0x004E4942

_COMPONENT_DTYPES = {
    5120: np.int8,
    5121: np.uint8,
    5122: np.int16,
    5123: np.uint16,
    5125: np.uint32,
    5126: np.float32,
}
_TYPE_COMPONENTS = {
    "SCALAR": 1,
    "VEC2": 2,
    "VEC3": 3,
    "VEC4": 4,
    "MAT4": 16,
}


@dataclasses.dataclass
class GltfMesh:
    positions: np.ndarray  # (V, 3) float32, world space
    normals: np.ndarray  # (V, 3) float32, world space, normalized
    tex_coords: np.ndarray  # (V, 2) float32
    indices: np.ndarray  # (I,) uint32, I % 3 == 0
    base_color_texture_index: int


@dataclasses.dataclass
class GltfScene:
    meshes: list[GltfMesh]
    base_color_textures: list[Texture]


def _fnv1a(data: bytes) -> int:
    """32-bit FNV-1a (gltf_model.cpp:123-135)."""
    h = 2166136261
    for byte in data:
        h ^= byte
        h = (h * 16777619) & 0xFFFFFFFF
    return h


def _quat_to_matrix(q) -> np.ndarray:
    """Rotation matrix from glTF quaternion [x, y, z, w] (column-convention)."""
    x, y, z, w = (float(c) for c in q)
    n = np.sqrt(x * x + y * y + z * z + w * w)
    if n > 0:
        x, y, z, w = x / n, y / n, z / n, w / n
    m = np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ],
        dtype=np.float32,
    )
    out = np.eye(4, dtype=np.float32)
    out[:3, :3] = m
    return out


def _local_transform(node: dict) -> np.ndarray:
    if "matrix" in node:
        # glTF matrices are column-major.
        return np.asarray(node["matrix"], dtype=np.float32).reshape(4, 4).T
    t = np.eye(4, dtype=np.float32)
    t[:3, 3] = np.asarray(node.get("translation", [0, 0, 0]), dtype=np.float32)
    r = _quat_to_matrix(node.get("rotation", [0, 0, 0, 1]))
    s = np.eye(4, dtype=np.float32)
    s[[0, 1, 2], [0, 1, 2]] = np.asarray(node.get("scale", [1, 1, 1]), dtype=np.float32)
    return t @ r @ s


class _GltfFile:
    def __init__(self, doc: dict, buffers: list[bytes], base_dir: pathlib.Path):
        self.doc = doc
        self.buffers = buffers
        self.base_dir = base_dir

    def buffer_view_bytes(self, view_idx: int) -> bytes:
        view = self.doc["bufferViews"][view_idx]
        buf = self.buffers[view["buffer"]]
        offset = view.get("byteOffset", 0)
        return buf[offset : offset + view["byteLength"]]

    def read_accessor(self, accessor_idx: int) -> np.ndarray:
        """Return (count, components) array in the accessor's component dtype."""
        acc = self.doc["accessors"][accessor_idx]
        assert "sparse" not in acc, "sparse accessors not supported"
        dtype = np.dtype(_COMPONENT_DTYPES[acc["componentType"]])
        ncomp = _TYPE_COMPONENTS[acc["type"]]
        count = acc["count"]
        view = self.doc["bufferViews"][acc["bufferView"]]
        buf = self.buffers[view["buffer"]]
        start = view.get("byteOffset", 0) + acc.get("byteOffset", 0)
        stride = view.get("byteStride") or dtype.itemsize * ncomp
        if stride == dtype.itemsize * ncomp:
            raw = np.frombuffer(buf, dtype=dtype, count=count * ncomp, offset=start)
            return raw.reshape(count, ncomp)
        # Interleaved: gather with a strided view.
        nbytes = stride * (count - 1) + dtype.itemsize * ncomp
        raw = np.frombuffer(buf, dtype=np.uint8, count=nbytes, offset=start)
        strided = np.lib.stride_tricks.as_strided(
            raw, shape=(count, dtype.itemsize * ncomp), strides=(stride, 1)
        )
        return strided.reshape(-1).view(dtype).reshape(count, ncomp)

    def image_bytes(self, image_idx: int) -> bytes:
        image = self.doc["images"][image_idx]
        if "bufferView" in image:
            return self.buffer_view_bytes(image["bufferView"])
        uri = image["uri"]
        if uri.startswith("data:"):
            return base64.b64decode(uri.split(",", 1)[1])
        path = self.base_dir / uri
        if not path.exists():
            raise FileNotFoundError(f"The image {path} does not exist.")
        return path.read_bytes()


def _parse_container(path: pathlib.Path) -> _GltfFile:
    data = path.read_bytes()
    base_dir = path.parent
    if len(data) >= 12 and struct.unpack("<I", data[:4])[0] == _GLB_MAGIC:
        magic, version, length = struct.unpack("<III", data[:12])
        assert version == 2, f"unsupported GLB version {version}"
        offset = 12
        doc = None
        bin_chunk = b""
        while offset + 8 <= length:
            chunk_len, chunk_type = struct.unpack("<II", data[offset : offset + 8])
            chunk = data[offset + 8 : offset + 8 + chunk_len]
            if chunk_type == _CHUNK_JSON:
                doc = json.loads(chunk)
            elif chunk_type == _CHUNK_BIN:
                bin_chunk = chunk
            offset += 8 + chunk_len
        assert doc is not None, "GLB file has no JSON chunk"
    else:
        doc = json.loads(data)
        bin_chunk = b""

    buffers = []
    for buf in doc.get("buffers", []):
        uri = buf.get("uri")
        if uri is None:
            buffers.append(bin_chunk)
        elif uri.startswith("data:"):
            buffers.append(base64.b64decode(uri.split(",", 1)[1]))
        else:
            buffers.append((base_dir / uri).read_bytes())
    return _GltfFile(doc, buffers, base_dir)


class _BaseColorTextureBuilder:
    """Deduplicating base-color texture builder (gltf_model.cpp:143-263)."""

    def __init__(self, gltf: _GltfFile):
        self.gltf = gltf
        self.textures: list[Texture] = []
        self._image_lookup: dict[int, int] = {}
        self._factor_lookup: dict[int, int] = {}

    def add_base_color(self, material: dict) -> int:
        pbr = material.get("pbrMetallicRoughness", {})
        tex_info = pbr.get("baseColorTexture")
        if tex_info is not None:
            assert tex_info.get("texCoord", 0) == 0
            gltf_tex = self.gltf.doc["textures"][tex_info["index"]]
            image_idx = gltf_tex["source"]
            if image_idx not in self._image_lookup:
                self._image_lookup[image_idx] = len(self.textures)
                self.textures.append(Texture.from_memory(self.gltf.image_bytes(image_idx)))
            return self._image_lookup[image_idx]
        factor = pbr.get("baseColorFactor", [1.0, 1.0, 1.0, 1.0])
        key = _fnv1a(np.asarray(factor, dtype=np.float32).tobytes())
        if key not in self._factor_lookup:
            self._factor_lookup[key] = len(self.textures)
            self.textures.append(Texture.from_pixel(*(float(c) for c in factor)))
        return self._factor_lookup[key]


def load_gltf(path) -> GltfScene:
    """Load a .glb/.gltf file into a world-space GltfScene."""
    path = pathlib.Path(path)
    if not path.exists():
        raise FileNotFoundError(f"The gltf file {path} does not exist.")
    gltf = _parse_container(path)
    doc = gltf.doc

    scenes = doc.get("scenes", [])
    assert len(scenes) == 1, "only single-scene glTF files are supported"
    scene = scenes[doc.get("scene", 0)]

    # Flatten node hierarchy: record (world, normal) matrices per mesh index
    # (gltf_model.cpp:29-72 indexes transforms by mesh, not node).
    num_meshes = len(doc.get("meshes", []))
    identity = np.eye(4, dtype=np.float32)
    transforms = [(identity, identity)] * num_meshes

    def traverse(node_idx: int, parent: np.ndarray) -> None:
        node = doc["nodes"][node_idx]
        world = parent @ _local_transform(node)
        if "mesh" in node:
            normal_matrix = np.linalg.inv(world).T.astype(np.float32)
            transforms[node["mesh"]] = (world, normal_matrix)
        for child in node.get("children", []):
            traverse(child, world)

    for root in scene.get("nodes", []):
        traverse(root, identity)

    builder = _BaseColorTextureBuilder(gltf)
    meshes: list[GltfMesh] = []
    for mesh_idx, mesh in enumerate(doc.get("meshes", [])):
        world, normal_matrix = transforms[mesh_idx]
        for prim in mesh["primitives"]:
            assert prim.get("mode", 4) == 4, "triangles-only primitives supported"
            material = doc["materials"][prim["material"]]
            texture_idx = builder.add_base_color(material)

            indices = gltf.read_accessor(prim["indices"]).reshape(-1).astype(np.uint32)
            assert indices.size % 3 == 0

            attrs = prim["attributes"]
            local_pos = gltf.read_accessor(attrs["POSITION"]).astype(np.float32)
            local_nrm = gltf.read_accessor(attrs["NORMAL"]).astype(np.float32)
            uv = gltf.read_accessor(attrs["TEXCOORD_0"]).astype(np.float32)
            assert local_pos.shape == local_nrm.shape
            assert local_pos.shape[0] == uv.shape[0]

            positions = local_pos @ world[:3, :3].T + world[:3, 3]
            normals = local_nrm @ normal_matrix[:3, :3].T
            norm = np.linalg.norm(normals, axis=-1, keepdims=True)
            normals = normals / np.where(norm > 0, norm, 1.0)

            meshes.append(
                GltfMesh(
                    positions=positions.astype(np.float32),
                    normals=normals.astype(np.float32),
                    tex_coords=uv,
                    indices=indices,
                    base_color_texture_index=texture_idx,
                )
            )

    # Sort meshes by texture index so the rasterizer can bind textures in runs
    # (gltf_model.cpp:462-464); Python's sort is stable like std::sort is not,
    # but tie order is irrelevant downstream.
    meshes.sort(key=lambda m: m.base_color_texture_index)
    return GltfScene(meshes=meshes, base_color_textures=builder.textures)
