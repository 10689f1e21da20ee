"""Index-unrolled per-triangle SoA scene representation.

Equivalent of the reference's FlattenedModel (src/common/flattened_model.cpp:8-46):
every indexed mesh is unrolled into per-triangle vertex attribute arrays, the
input to the BVH builder and the wavefront renderer. Arrays are SoA numpy,
already in the layout the TPU kernels consume.

The port's own copy of `rayfinder_tpu.scene.flatten`, same names and numerics.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .gltf import GltfScene


@dataclasses.dataclass
class FlattenedScene:
    positions: np.ndarray  # (T, 3, 3) float32: triangle, vertex, xyz
    normals: np.ndarray  # (T, 3, 3) float32
    tex_coords: np.ndarray  # (T, 3, 2) float32
    texture_indices: np.ndarray  # (T,) uint32

    @property
    def num_triangles(self) -> int:
        return self.positions.shape[0]

    @staticmethod
    def from_scene(scene: GltfScene) -> "FlattenedScene":
        positions, normals, tex_coords, texture_indices = [], [], [], []
        for mesh in scene.meshes:
            idx = mesh.indices.reshape(-1, 3)
            positions.append(mesh.positions[idx])
            normals.append(mesh.normals[idx])
            tex_coords.append(mesh.tex_coords[idx])
            texture_indices.append(
                np.full(idx.shape[0], mesh.base_color_texture_index, dtype=np.uint32)
            )
        return FlattenedScene(
            positions=np.concatenate(positions, axis=0),
            normals=np.concatenate(normals, axis=0),
            tex_coords=np.concatenate(tex_coords, axis=0),
            texture_indices=np.concatenate(texture_indices, axis=0),
        )
