"""Device-resident scene: SoA torch tensors consumed by the render kernels.

Counterpart of `rayfinder_tpu.render.scene` (the reference's scene bind
group, src/pt/reference_path_tracer.cpp:131-270): BVH node planes, triangle
attributes in BVH leaf order, a texture-descriptor table and one packed texel
atlas, and the cluster tables (below). The CUDA kernels walk the BVH itself,
one thread per ray.

Texels are stored as the int32 view of the packed BGRA uint32 words, because
torch's uint32 supports few operations; shifts and masks on the int32 view
(`(w >> 16) & 0xFF`) give the same bytes. The atlas may hold up to 2**31 - 1
texels (MAX_TEXELS), the range of the int32 index that every fetch computes:
the reference's 256 MiB is its WebGPU storage-buffer binding limit, and on
the card the atlas is a plain allocation that no such limit binds.

Beside the SoA node planes, the upload builds the packed walk tables that
every CUDA kernel that walks the BVH reads (K1-K6, K8; csrc/traverse2.cuh)
from them:

* `bvh_nodes2`, (M, 16) int32: one aligned 64-byte record per interior node,
  in node order (record r is the r-th interior node; the root, when it is
  interior, is record 0). Words 0-5 are the left child's (node + 1) box,
  min xyz then max xyz, and words 6-11 the right child's (`second_child`),
  as the bit patterns of the SoA floats. Word 12 is the left child's
  reference and word 13 the right's: the child's record index if it is
  interior, its `tri_offset` if it is a leaf. Word 14 is the left child's
  `tri_count` (0 if interior), word 15 the right child's `tri_count` with
  the node's `split_axis` in bits 30-31.
* `tri_pos4`, (T, 12) float32: v0, v1 and v2 of each triangle in leaf
  order, each padded with a zero to 16 bytes.

A leaf is a node with `tri_count > 0`, as the walks read it. The root's own
box stays in the SoA planes, which the plain torch walk reads.

The scene also carries the JAX scene's cluster tables (bvh/clusters.py):
its leaf-order triangles cut into BVH-treelet ranges of at most 128
(`treelet_ranges` with the surface-area merge), each a padded block of
triangles with its box (`cluster_tris`, `cluster_min`, `cluster_max`,
`cluster_tri_map`, `cluster_start`), built from the SoA planes and the
triangle positions at upload. The wavefront engine (render/wavefront.py)
walks them, and the sorted fused loop keys its lanes by their hit's cluster.
`num_clusters` is their count: the scan integrator sorts bounce rays on
scenes with more clusters than `render/pathtracer.py SORT_THRESHOLD`, as the
JAX one does on `cluster_tris.shape[0]`. The JAX scene pads its cluster list
only where an opt-in TPU layout asks for it, so by default the tables are
equal field by field.

The entry points put the scene on the card unless the caller names another
device. They take the port's `FlattenedScene` and `Texture` and the JAX
package's alike (dataclasses with the same fields).
"""

from __future__ import annotations

import dataclasses
import pathlib
import types

import numpy as np
import torch

from ..bvh import Bvh, reorder_attributes
from ..bvh.clusters import DEFAULT_LEAF_SIZE, build_clusters, treelet_ranges
from ..scene import FlattenedScene, Texture
from ..utils import profiling

# Packed-texel-atlas budget: the texels that an int32 index reaches. The
# JAX package and the reference keep 256 MiB, the reference's WebGPU
# storage-buffer binding limit for its texture buffer; on the card the atlas
# is a plain device allocation with no binding limit, and what bounds it is
# the texel index: the descriptors' offsets are int32 (`tex_desc`) and the
# fetches compute `offset + i * width + j` in int32 (csrc/shade.cuh
# albedo_of, render/texture_eval.py texel_bytes), exact for an atlas of up
# to 2**31 - 1 texels (8 GiB).
MAX_TEXELS = 2**31 - 1
MAX_TEXEL_BYTES = 4 * MAX_TEXELS
# The walks' stack (csrc/traverse.cuh kStackDepth, render/traverse.py
# STACK_DEPTH): a walk holds one entry per interior node above the node it
# is at, so a tree of depth d (nodes on its longest root-to-leaf path) needs
# d - 1 entries. A push beyond the stack is dropped, and the walk would then
# miss what lies under the dropped node. A tree deeper than WALK_STACK holds
# is walked with DEEP_WALK_STACK entries (`DeviceScene.walk_stack`: the
# plain walks, and K1, K2 and K4, which come with a walk of each size; the
# other kernels raise for such a scene); a tree deeper than that does not
# load.
WALK_STACK = 32
DEEP_WALK_STACK = 64


@dataclasses.dataclass(frozen=True)
class DeviceScene:
    """SoA device tensors. Triangles are in BVH leaf order."""

    # BVH (reference node contract, bvh.hpp:14-21, split into SoA planes)
    bvh_aabb_min: torch.Tensor  # (N, 3) f32
    bvh_aabb_max: torch.Tensor  # (N, 3) f32
    bvh_tri_offset: torch.Tensor  # (N,) i32
    bvh_second_child: torch.Tensor  # (N,) i32
    bvh_tri_count: torch.Tensor  # (N,) i32
    bvh_split_axis: torch.Tensor  # (N,) i32 (0 on leaves)

    # Triangle attributes (reference_path_tracer.wgsl:133-149)
    tri_positions: torch.Tensor  # (T, 3, 3) f32
    tri_normals: torch.Tensor  # (T, 3, 3) f32
    tri_uvs: torch.Tensor  # (T, 3, 2) f32
    tri_texture: torch.Tensor  # (T,) i32

    # Texture atlas (reference_path_tracer.cpp:209-270)
    tex_width: torch.Tensor  # (K,) i32
    tex_height: torch.Tensor  # (K,) i32
    tex_offset: torch.Tensor  # (K,) i32
    tex_desc: torch.Tensor  # (K, 3) i32 rows [width, height, offset]
    texels: torch.Tensor  # (P,) i32 view of packed BGRA uint32 words

    # One 25-float shading row per triangle: 9 positions, 9 normals, 6 uvs,
    # the texture index as bitcast f32.
    tri_attrs: torch.Tensor  # (T, 25) f32

    # Packed walk tables of the kernels' walk, built from the planes above at
    # upload (module docstring).
    bvh_nodes2: torch.Tensor  # (M, 16) i32, one record per interior node
    tri_pos4: torch.Tensor  # (T, 12) f32

    # BVH-treelet clusters of the JAX package's scene (module docstring).
    cluster_tris: torch.Tensor  # (C, L, 3, 3) f32 padded blocks
    cluster_min: torch.Tensor  # (C, 3) f32
    cluster_max: torch.Tensor  # (C, 3) f32
    cluster_tri_map: torch.Tensor  # (C * L,) i32 padded slot -> real triangle
    cluster_start: torch.Tensor  # (C,) i32 first leaf-order triangle of each cluster

    # The entries of the walks' stack that the tree needs: WALK_STACK or
    # DEEP_WALK_STACK, chosen at load from its depth.
    walk_stack: int = WALK_STACK

    @property
    def num_triangles(self) -> int:
        return self.tri_positions.shape[0]

    @property
    def num_nodes(self) -> int:
        return self.bvh_aabb_min.shape[0]

    @property
    def num_clusters(self) -> int:
        return self.cluster_tris.shape[0]

    @property
    def device(self) -> torch.device:
        return self.tri_positions.device

    def to(self, device) -> "DeviceScene":
        """The scene on `device`."""
        return dataclasses.replace(self, **{name: getattr(self, name).to(device)
                                            for name in tensor_fields()})


def tensor_fields() -> list[str]:
    """The names of DeviceScene's tensor fields."""
    return [f.name for f in dataclasses.fields(DeviceScene) if f.name != "walk_stack"]


def _scene_arrays(
    flat: FlattenedScene, bvh: Bvh, textures: list[Texture] | None
) -> dict[str, np.ndarray]:
    """The numpy arrays of a DeviceScene, built exactly as the JAX package
    builds its own (rayfinder_tpu/render/scene.py:89-135)."""
    positions = reorder_attributes(flat.positions, bvh.triangle_indices)
    normals = reorder_attributes(flat.normals, bvh.triangle_indices)
    uvs = reorder_attributes(flat.tex_coords, bvh.triangle_indices)
    tex_idx = reorder_attributes(flat.texture_indices, bvh.triangle_indices)

    if textures:
        widths = np.asarray([t.width for t in textures], dtype=np.int32)
        heights = np.asarray([t.height for t in textures], dtype=np.int32)
        sizes = widths.astype(np.int64) * heights
        total_bytes = int(sizes.sum()) * 4
        if total_bytes > MAX_TEXEL_BYTES:
            raise ValueError(
                f"Texture atlas of {total_bytes} bytes ({total_bytes // 4} texels) exceeds "
                f"the {MAX_TEXEL_BYTES} byte limit: the int32 texel index reaches "
                f"{MAX_TEXELS} texels"
            )
        offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int32)
        texels = np.concatenate([t.pixels for t in textures]).astype(np.uint32)
    else:
        widths = np.asarray([1], dtype=np.int32)
        heights = np.asarray([1], dtype=np.int32)
        offsets = np.asarray([0], dtype=np.int32)
        # Default white texel: BGRA 0xFFFFFFFF.
        texels = np.asarray([0xFFFFFFFF], dtype=np.uint32)

    num_tris = positions.shape[0]
    tri_attrs = np.empty((num_tris, 25), dtype=np.float32)
    tri_attrs[:, 0:9] = positions.reshape(num_tris, 9)
    tri_attrs[:, 9:18] = normals.reshape(num_tris, 9)
    tri_attrs[:, 18:24] = uvs.reshape(num_tris, 6)
    tri_attrs[:, 24] = tex_idx.astype(np.uint32).view(np.float32)

    return dict(
        bvh_aabb_min=bvh.aabb_min,
        bvh_aabb_max=bvh.aabb_max,
        bvh_tri_offset=bvh.triangles_offset.astype(np.int32),
        bvh_second_child=bvh.second_child_offset.astype(np.int32),
        bvh_tri_count=bvh.triangle_count.astype(np.int32),
        bvh_split_axis=np.where(
            bvh.triangle_count > 0, 0, bvh.split_axis
        ).astype(np.int32),
        tri_positions=positions,
        tri_normals=normals,
        tri_uvs=uvs,
        tri_texture=tex_idx.astype(np.int32),
        tex_width=widths,
        tex_height=heights,
        tex_offset=offsets,
        tex_desc=np.stack([widths, heights, offsets], axis=1),
        texels=texels,
        tri_attrs=tri_attrs,
    )


def _walk_tables(arrays: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    """`bvh_nodes2` and `tri_pos4` (module docstring) from the SoA planes and
    the triangle positions. Floats go over as their bits
    (`ndarray.view(np.int32)`), never through arithmetic."""
    box_min = np.ascontiguousarray(arrays["bvh_aabb_min"], np.float32).view(np.int32)
    box_max = np.ascontiguousarray(arrays["bvh_aabb_max"], np.float32).view(np.int32)
    count = np.asarray(arrays["bvh_tri_count"]).astype(np.int64)
    offset = np.asarray(arrays["bvh_tri_offset"]).astype(np.int64)
    second = np.asarray(arrays["bvh_second_child"]).astype(np.int64)
    axis = np.asarray(arrays["bvh_split_axis"]).astype(np.int64)
    interior = count <= 0
    nodes = np.nonzero(interior)[0]
    if count.max() >= 1 << 30 or not np.isin(axis[nodes], (0, 1, 2)).all():
        raise ValueError("bvh_nodes2 holds leaf sizes below 2**30 and split axes 0-2")
    record = np.cumsum(interior) - 1
    leaf_count = np.where(interior, 0, count)
    ref = np.where(interior, record, offset)
    left, right = nodes + 1, second[nodes]
    nodes2 = np.empty((nodes.shape[0], 16), np.int32)
    nodes2[:, 0:3], nodes2[:, 3:6] = box_min[left], box_max[left]
    nodes2[:, 6:9], nodes2[:, 9:12] = box_min[right], box_max[right]
    nodes2[:, 12], nodes2[:, 13] = ref[left], ref[right]
    nodes2[:, 14] = leaf_count[left]
    nodes2[:, 15] = (leaf_count[right] | axis[nodes] << 30).astype(np.uint32).view(np.int32)
    positions = np.asarray(arrays["tri_positions"], np.float32)
    tri_pos4 = np.zeros((positions.shape[0], 3, 4), np.float32)
    tri_pos4[:, :, :3] = positions
    return dict(bvh_nodes2=nodes2, tri_pos4=tri_pos4.reshape(-1, 12))


def _cluster_tables(arrays: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    """The JAX scene's cluster tables (module docstring): its treelet ranges
    of at most DEFAULT_LEAF_SIZE leaf-order triangles, from the SoA planes,
    as padded blocks."""
    bvh = types.SimpleNamespace(triangle_count=arrays["bvh_tri_count"],
                                triangles_offset=arrays["bvh_tri_offset"],
                                second_child_offset=arrays["bvh_second_child"])
    positions = np.asarray(arrays["tri_positions"], np.float32)
    clusters = build_clusters(positions,
                              ranges=treelet_ranges(bvh, DEFAULT_LEAF_SIZE, positions))
    return dict(cluster_tris=clusters.tris, cluster_min=clusters.aabb_min,
                cluster_max=clusters.aabb_max, cluster_tri_map=clusters.tri_map,
                cluster_start=clusters.start)


def tree_depth(tri_count, second_child) -> int:
    """The nodes on the longest root-to-leaf path of a tree in the node
    planes' pre-order (node i's first child is i + 1, its second
    `second_child[i]`; a node with tri_count > 0 is a leaf), level by level."""
    count = np.asarray(tri_count)
    second = np.asarray(second_child).astype(np.int64)
    depth = 0
    level = np.zeros(1, np.int64)
    while level.size:
        depth += 1
        inner = level[count[level] <= 0]
        level = np.concatenate([inner + 1, second[inner]])
    return depth


def _walk_stack(arrays: dict[str, np.ndarray]) -> int:
    """The stack entries that the tree's walks need (WALK_STACK or
    DEEP_WALK_STACK), from its depth, which is counted as
    rf.scene.tree_depth; raises for a tree deeper than the larger stack
    holds."""
    depth = tree_depth(arrays["bvh_tri_count"], arrays["bvh_second_child"])
    profiling.count(profiling.TREE_DEPTH, depth)
    if depth - 1 <= WALK_STACK:
        return WALK_STACK
    if depth - 1 > DEEP_WALK_STACK:
        raise ValueError(
            f"BVH of depth {depth} needs {depth - 1} stack entries; the walks hold at most "
            f"{DEEP_WALK_STACK} (trees of depth up to {DEEP_WALK_STACK + 1})"
        )
    return DEEP_WALK_STACK


def _upload(arrays: dict[str, np.ndarray], device) -> DeviceScene:
    """The walks' stack chosen from the tree's depth and the walk and cluster
    tables built (span rf.scene.tables), then every field copied to `device`
    (rf.scene.upload)."""
    with profiling.span("rf.scene.tables"):
        walk_stack = _walk_stack(arrays)
        arrays = {**arrays, **_walk_tables(arrays), **_cluster_tables(arrays)}
    fields = {}
    with profiling.span("rf.scene.upload"):
        for name in tensor_fields():
            a = np.asarray(arrays[name])
            if name == "texels":
                a = a.astype(np.uint32).view(np.int32)
            fields[name] = torch.from_numpy(np.array(a, order="C")).to(device)
    return DeviceScene(**fields, walk_stack=walk_stack)


def build_device_scene(
    flat: FlattenedScene,
    bvh: Bvh | None = None,
    textures: list[Texture] | None = None,
    device="cuda",
) -> DeviceScene:
    """Build the BVH (if not given) with the native builder, reorder the
    attributes into leaf order, pack textures into one atlas, and upload
    everything to `device`. A tree deeper than WALK_STACK entries hold is
    walked with DEEP_WALK_STACK, and one deeper than that raises ValueError."""
    if bvh is None:
        from ..bvh.native import build_bvh_fast

        bvh = build_bvh_fast(flat.positions)
    return _upload(_scene_arrays(flat, bvh, textures), device)


def scene_from_jax(arrays: dict[str, np.ndarray], device="cuda") -> DeviceScene:
    """Carry a JAX `DeviceScene` over: `arrays` maps its field names to
    numpy arrays (`np.asarray` of each field). Its cluster fields are
    ignored: the packed walk tables and the cluster tables are built from
    the SoA planes and the triangle positions, as for any other scene."""
    return _upload(arrays, device)


def load_device_scene(path, device="cuda") -> DeviceScene:
    """Load a .glb/.gltf or .pt file straight into a DeviceScene. Its
    phases are spans: rf.scene.read (the file read, and for a glTF its
    flattening and BVH build), rf.scene.tables and rf.scene.upload
    (_upload)."""
    path = pathlib.Path(path)
    if path.suffix == ".pt":
        from ..io.ptformat import read_pt

        with profiling.span("rf.scene.read"):
            pt = read_pt(path)
        flat = FlattenedScene(
            positions=pt.tri_positions,
            normals=pt.tri_normals,
            tex_coords=pt.tri_uvs,
            texture_indices=pt.tri_texture,
        )
        # Attributes are already in leaf order: identity reorder map.
        bvh = dataclasses.replace(
            pt.bvh,
            triangle_indices=np.arange(pt.tri_positions.shape[0], dtype=np.int64),
        )
        return build_device_scene(flat, bvh=bvh, textures=pt.textures, device=device)
    from ..bvh.native import build_bvh_fast
    from ..scene import load_gltf

    with profiling.span("rf.scene.read"):
        scene = load_gltf(path)
        flat = FlattenedScene.from_scene(scene)
        bvh = build_bvh_fast(flat.positions)
    return build_device_scene(
        flat, bvh=bvh, textures=scene.base_color_textures, device=device
    )
