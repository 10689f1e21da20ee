"""`.pt` scene format: byte-compatible reader/writer for PTFORMAT3.

The layout matches the reference's serializer exactly
(src/pt-format/pt_format.cpp:153-321) so `.pt` files produced by the
reference's `pt-format-tool` load here and vice versa:

* magic bytes "PTFORMAT3";
* length-prefixed (u64 little-endian) flat arrays of GPU-padded structs:
  48-byte BVH nodes (bvh.hpp:14-21), 36-byte raw `Positions`, 48-byte padded
  `PositionAttribute` and 80-byte `VertexAttributes`
  (pt-format/vertex_attributes.hpp:7-35);
* per-mesh rasterizer arrays (vec4 positions/normals, vec2 uvs, u32 indices)
  with span-into-buffer encoding as (offset, count) u64 pairs;
* deduplicated BGRA textures as {u32 width, u32 height} + length-prefixed
  u32 pixels.

Everything is little-endian; arrays are numpy structured views so reading is
a single buffer reinterpretation, not a Python loop.

The port's own copy of `rayfinder_tpu.io.ptformat`, same names and numerics.
It has no `to_device_scene`: `render.scene.load_device_scene` reads a `.pt`
file into the port's DeviceScene.
"""

from __future__ import annotations

import dataclasses
import io
import pathlib
import re
import struct

import numpy as np

from ..bvh import Bvh, reorder_attributes
from ..scene import FlattenedScene, GltfScene, Texture

MAGIC = b"PTFORMAT3"

# 48-byte GPU-aligned BVH node (bvh.hpp:14-21).
_NODE_DTYPE = np.dtype(
    [
        ("aabb_min", np.float32, 3),
        ("pad0", np.float32),
        ("aabb_max", np.float32, 3),
        ("pad1", np.float32),
        ("triangles_offset", np.uint32),
        ("second_child_offset", np.uint32),
        ("triangle_count", np.uint32),
        ("split_axis", np.uint32),
    ]
)


@dataclasses.dataclass
class PtScene:
    """In-memory PTFORMAT3 contents in SoA numpy form."""

    # BVH + leaf-ordered triangle data
    bvh: Bvh
    bvh_positions: np.ndarray  # (T, 3, 3) f32 raw Positions
    tri_positions: np.ndarray  # (T, 3, 3) f32 (unpadded view of PositionAttribute)
    tri_normals: np.ndarray  # (T, 3, 3) f32
    tri_uvs: np.ndarray  # (T, 3, 2) f32
    tri_texture: np.ndarray  # (T,) u32

    # Per-mesh rasterizer arrays
    vertex_positions: np.ndarray  # (V, 4) f32
    vertex_normals: np.ndarray  # (V, 4) f32
    vertex_tex_coords: np.ndarray  # (V, 2) f32
    vertex_indices: np.ndarray  # (I,) u32
    mesh_vertex_slices: np.ndarray  # (M, 2) u64 (offset, count) into vertices
    mesh_index_slices: np.ndarray  # (M, 2) u64 (offset, count) into indices
    mesh_texture_indices: np.ndarray  # (M,) u32

    textures: list[Texture]

    @staticmethod
    def from_gltf(path) -> "PtScene":
        """glTF → PtScene, replicating PtFormat's constructor
        (pt_format.cpp:20-151): flatten, build BVH, reorder attributes into
        leaf order, pack per-mesh arrays."""
        from ..scene import load_gltf

        scene = load_gltf(path)
        return PtScene.from_scene(scene)

    @staticmethod
    def from_scene(scene: GltfScene) -> "PtScene":
        from ..bvh.native import build_bvh_fast

        flat = FlattenedScene.from_scene(scene)
        bvh = build_bvh_fast(flat.positions)

        positions = reorder_attributes(flat.positions, bvh.triangle_indices)
        normals = reorder_attributes(flat.normals, bvh.triangle_indices)
        uvs = reorder_attributes(flat.tex_coords, bvh.triangle_indices)
        tex_idx = reorder_attributes(flat.texture_indices, bvh.triangle_indices)

        vert_pos, vert_nrm, vert_uv, vert_idx = [], [], [], []
        vert_slices, idx_slices, mesh_tex = [], [], []
        v_off = i_off = 0
        for mesh in scene.meshes:
            n_verts = mesh.positions.shape[0]
            n_idx = mesh.indices.shape[0]
            vert_pos.append(
                np.concatenate(
                    [mesh.positions, np.ones((n_verts, 1), np.float32)], axis=1
                )
            )
            vert_nrm.append(
                np.concatenate(
                    [mesh.normals, np.zeros((n_verts, 1), np.float32)], axis=1
                )
            )
            vert_uv.append(mesh.tex_coords)
            vert_idx.append(mesh.indices)
            vert_slices.append((v_off, n_verts))
            idx_slices.append((i_off, n_idx))
            mesh_tex.append(mesh.base_color_texture_index)
            v_off += n_verts
            i_off += n_idx

        return PtScene(
            bvh=bvh,
            bvh_positions=positions,
            tri_positions=positions.copy(),
            tri_normals=normals,
            tri_uvs=uvs,
            tri_texture=tex_idx,
            vertex_positions=np.concatenate(vert_pos, axis=0),
            vertex_normals=np.concatenate(vert_nrm, axis=0),
            vertex_tex_coords=np.concatenate(vert_uv, axis=0),
            vertex_indices=np.concatenate(vert_idx, axis=0),
            mesh_vertex_slices=np.asarray(vert_slices, dtype=np.uint64),
            mesh_index_slices=np.asarray(idx_slices, dtype=np.uint64),
            mesh_texture_indices=np.asarray(mesh_tex, dtype=np.uint32),
            textures=list(scene.base_color_textures),
        )


def _write_array(out: io.BufferedIOBase, arr: np.ndarray) -> None:
    out.write(struct.pack("<Q", arr.shape[0]))
    out.write(np.ascontiguousarray(arr).tobytes())


def _pad_vec3_triplet(a: np.ndarray) -> np.ndarray:
    """(T, 3, 3) → (T, 3, 4) with zero pad floats (vertex_attributes.hpp:7-15)."""
    t = a.shape[0]
    out = np.zeros((t, 3, 4), dtype=np.float32)
    out[:, :, :3] = a
    return out


def write_pt(scene: PtScene, path) -> None:
    """Serialize (pt_format.cpp:240-269)."""
    buf = io.BytesIO()
    buf.write(MAGIC)

    bvh = scene.bvh
    nodes = np.zeros(bvh.num_nodes, dtype=_NODE_DTYPE)
    nodes["aabb_min"] = bvh.aabb_min
    nodes["aabb_max"] = bvh.aabb_max
    nodes["triangles_offset"] = bvh.triangles_offset
    nodes["second_child_offset"] = bvh.second_child_offset
    nodes["triangle_count"] = bvh.triangle_count
    nodes["split_axis"] = bvh.split_axis
    _write_array(buf, nodes)

    _write_array(buf, scene.bvh_positions.reshape(-1, 9).astype(np.float32))
    _write_array(buf, _pad_vec3_triplet(scene.tri_positions).reshape(-1, 12))

    # VertexAttributes: padded normals (48B) + uvs (24B) + texIdx + pad (8B).
    t = scene.tri_normals.shape[0]
    vattr = np.zeros((t, 20), dtype=np.float32)
    vattr[:, 0:12] = _pad_vec3_triplet(scene.tri_normals).reshape(-1, 12)
    vattr[:, 12:18] = scene.tri_uvs.reshape(-1, 6)
    vattr[:, 18] = scene.tri_texture.view(np.float32)
    _write_array(buf, vattr)

    _write_array(buf, scene.vertex_positions.astype(np.float32))
    _write_array(buf, scene.vertex_normals.astype(np.float32))
    _write_array(buf, scene.vertex_tex_coords.astype(np.float32))
    _write_array(buf, scene.vertex_indices.astype(np.uint32))

    for slices in (
        scene.mesh_vertex_slices,  # positions
        scene.mesh_vertex_slices,  # normals share vertex offsets
        scene.mesh_vertex_slices,  # texcoords too
        scene.mesh_index_slices,
    ):
        buf.write(struct.pack("<Q", slices.shape[0]))
        buf.write(np.ascontiguousarray(slices, dtype=np.uint64).tobytes())

    _write_array(buf, scene.mesh_texture_indices.astype(np.uint32))

    buf.write(struct.pack("<Q", len(scene.textures)))
    for tex in scene.textures:
        buf.write(struct.pack("<II", tex.width, tex.height))
        _write_array(buf, tex.pixels.astype(np.uint32))

    pathlib.Path(path).write_bytes(buf.getvalue())


class _Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def take(self, n: int) -> bytes:
        chunk = self.data[self.pos : self.pos + n]
        assert len(chunk) == n, "unexpected end of .pt file"
        self.pos += n
        return chunk

    def u64(self) -> int:
        return struct.unpack("<Q", self.take(8))[0]

    def array(self, dtype, itemsize: int) -> np.ndarray:
        count = self.u64()
        raw = self.take(count * itemsize)
        return np.frombuffer(raw, dtype=dtype)


def read_pt(path) -> PtScene:
    """Deserialize (pt_format.cpp:271-321), with the reference's distinct
    version-mismatch vs invalid-format errors."""
    data = pathlib.Path(path).read_bytes()
    r = _Reader(data)
    magic = r.take(len(MAGIC))
    if magic != MAGIC:
        if re.search(rb"PTFORMAT\d", magic):
            raise ValueError(
                "Mismatching PtFormat file version. Invalid version in magic "
                f"bytes: expected '{MAGIC.decode()}', got '{magic.decode(errors='replace')}'."
            )
        raise ValueError("Invalid file format: expected PtFormat file.")

    nodes = r.array(_NODE_DTYPE, _NODE_DTYPE.itemsize)

    bvh_positions = r.array(np.float32, 36).reshape(-1, 3, 3)
    tri_positions_padded = r.array(np.float32, 48).reshape(-1, 3, 4)
    vattr = r.array(np.float32, 80).reshape(-1, 20)

    vertex_positions = r.array(np.float32, 16).reshape(-1, 4)
    vertex_normals = r.array(np.float32, 16).reshape(-1, 4)
    vertex_tex_coords = r.array(np.float32, 8).reshape(-1, 2)
    vertex_indices = r.array(np.uint32, 4)

    slices = [r.array(np.uint64, 16).reshape(-1, 2).copy() for _ in range(4)]
    mesh_texture_indices = r.array(np.uint32, 4).copy()

    num_textures = r.u64()
    textures = []
    for _ in range(num_textures):
        width, height = struct.unpack("<II", r.take(8))
        pixels = r.array(np.uint32, 4).copy()
        textures.append(Texture(pixels=pixels, width=width, height=height))

    num_tris = bvh_positions.shape[0]
    bvh = Bvh(
        aabb_min=nodes["aabb_min"].copy(),
        aabb_max=nodes["aabb_max"].copy(),
        triangles_offset=nodes["triangles_offset"].copy(),
        second_child_offset=nodes["second_child_offset"].copy(),
        triangle_count=nodes["triangle_count"].copy(),
        split_axis=nodes["split_axis"].copy(),
        triangle_indices=np.arange(num_tris, dtype=np.int64),
    )

    return PtScene(
        bvh=bvh,
        bvh_positions=bvh_positions.copy(),
        tri_positions=tri_positions_padded[:, :, :3].copy(),
        tri_normals=vattr[:, 0:12].reshape(-1, 3, 4)[:, :, :3].copy(),
        tri_uvs=vattr[:, 12:18].reshape(-1, 3, 2).copy(),
        tri_texture=vattr[:, 18].copy().view(np.uint32),
        vertex_positions=vertex_positions.copy(),
        vertex_normals=vertex_normals.copy(),
        vertex_tex_coords=vertex_tex_coords.copy(),
        vertex_indices=vertex_indices.copy(),
        mesh_vertex_slices=slices[0],
        mesh_index_slices=slices[3],
        mesh_texture_indices=mesh_texture_indices,
        textures=textures,
    )
