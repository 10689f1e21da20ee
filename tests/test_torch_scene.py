"""The PyTorch port's DeviceScene against the JAX package's, field by field.

Both are built from the same numpy helpers, so every shared field must be
equal bit for bit (texels compared as their uint32 words). The port's packed
walk tables have no JAX counterpart: tests/test_torch_packed_walk.py decodes
them against the shared planes.
"""

import dataclasses

import numpy as np
import pytest
import torch

from rayfinder_tpu.render.scene import build_device_scene as jax_build
from rayfinder_tpu.render.scene import load_device_scene as jax_load
from rayfinder_tpu.scene.procedural import courtyard_scene
from rayfinder_tpu_torch.render.scene import (
    DeviceScene, build_device_scene, load_device_scene, scene_from_jax, tensor_fields,
)

FIELDS = tensor_fields()
SHARED = [name for name in FIELDS if name not in ("bvh_nodes2", "tri_pos4")]


def _assert_same(port: DeviceScene, jax_scene) -> None:
    for name in SHARED:
        got = getattr(port, name).numpy()
        want = np.asarray(getattr(jax_scene, name))
        if name == "texels":
            assert got.dtype == np.int32
            got = got.view(np.uint32)
        assert got.dtype == want.dtype, name
        assert got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)


def _pt_file(tmp_path, flat, textures):
    from rayfinder_tpu.io import PtScene, write_pt
    from rayfinder_tpu.tools.export_glb import export_flattened_glb

    glb = tmp_path / "courtyard.glb"
    export_flattened_glb(flat, textures, glb)
    pt = tmp_path / "courtyard.pt"
    write_pt(PtScene.from_gltf(glb), pt)
    return pt


@pytest.mark.parametrize("source", ["courtyard4", "courtyard4_textured", "pt_roundtrip"])
def test_scene_matches_jax(source, tmp_path):
    flat, textures = courtyard_scene(4, textured=source == "courtyard4_textured")
    if source == "pt_roundtrip":
        pt = _pt_file(tmp_path, flat, textures)
        port, want = load_device_scene(pt, device="cpu"), jax_load(pt)
    else:
        port, want = build_device_scene(flat, textures=textures, device="cpu"), jax_build(flat, textures=textures)
    assert port.num_triangles == want.num_triangles
    assert port.num_nodes == want.num_nodes
    assert port.num_clusters == want.cluster_tris.shape[0]
    _assert_same(port, want)


def test_scene_from_jax_carries_every_field():
    flat, textures = courtyard_scene(4, textured=True)
    want = jax_build(flat, textures=textures)
    arrays = {f.name: np.asarray(getattr(want, f.name)) for f in dataclasses.fields(want)}
    port = scene_from_jax(arrays, device="cpu")
    _assert_same(port, want)
    built = build_device_scene(flat, textures=textures, device="cpu")
    for name in FIELDS:
        assert torch.equal(getattr(port, name), getattr(built, name)), name
    assert port.num_clusters == built.num_clusters == want.cluster_tris.shape[0]


def test_scene_to_device_keeps_values():
    flat, textures = courtyard_scene(2)
    scene = build_device_scene(flat, textures=textures, device="cpu")
    moved = scene.to("cpu")
    assert moved.device == torch.device("cpu")
    for name in FIELDS:
        assert torch.equal(getattr(moved, name), getattr(scene, name)), name
    assert moved.num_clusters == scene.num_clusters > 0


def test_oversized_texture_atlas_raises(monkeypatch):
    import rayfinder_tpu_torch.render.scene as port_scene

    flat, textures = courtyard_scene(2, textured=False)
    monkeypatch.setattr(port_scene, "MAX_TEXEL_BYTES", 8)
    with pytest.raises(ValueError, match="exceeds"):
        build_device_scene(flat, textures=textures, device="cpu")
