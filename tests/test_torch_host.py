"""The port's own host code against the JAX package's: scenes, BVH builds,
the .pt format, glTF export and loading, and the data files.

The port keeps copies of these modules so that it imports nothing of
rayfinder_tpu; each copy must give the same arrays and bytes.
"""

import dataclasses
import pathlib

import numpy as np
import pytest

from rayfinder_tpu.bvh import build_bvh as jax_build_bvh
from rayfinder_tpu.bvh.native import build_bvh_fast as jax_build_bvh_fast
from rayfinder_tpu.io import PtScene as JaxPtScene
from rayfinder_tpu.io import read_pt as jax_read_pt
from rayfinder_tpu.io import write_pt as jax_write_pt
from rayfinder_tpu.scene import load_gltf as jax_load_gltf
from rayfinder_tpu.scene.procedural import courtyard_scene as jax_courtyard_scene
from rayfinder_tpu.tools.export_glb import export_flattened_glb as jax_export
from rayfinder_tpu_torch.bvh import build_bvh
from rayfinder_tpu_torch.bvh.native import build_bvh_fast
from rayfinder_tpu_torch.io import PtScene, read_pt, write_pt
from rayfinder_tpu_torch.scene import load_gltf
from rayfinder_tpu_torch.scene.procedural import courtyard_scene
from rayfinder_tpu_torch.scene.texture import Texture, encode_png
from rayfinder_tpu_torch.tools.export_glb import export_flattened_glb

ROOT = pathlib.Path(__file__).resolve().parent.parent
FLAT_FIELDS = ("positions", "normals", "tex_coords", "texture_indices")


def _equal(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, what
    np.testing.assert_array_equal(a, b, err_msg=what)


def _same_bvh(got, want):
    for f in dataclasses.fields(want):
        _equal(getattr(got, f.name), getattr(want, f.name), f.name)


def _same_textures(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert (a.width, a.height) == (b.width, b.height)
        _equal(a.pixels, b.pixels, "pixels")


@pytest.mark.parametrize("subdiv,textured", [(2, False), (4, False), (2, True), (4, True)])
def test_courtyard_scene_equals_jax(subdiv, textured):
    got, got_tex = courtyard_scene(subdiv, textured=textured)
    want, want_tex = jax_courtyard_scene(subdiv, textured=textured)
    for field in FLAT_FIELDS:
        _equal(getattr(got, field), getattr(want, field), field)
    _same_textures(got_tex, want_tex)


@pytest.mark.parametrize("builder", ["native", "python"])
def test_bvh_build_equals_jax(builder):
    flat, _ = courtyard_scene(4)
    if builder == "native":
        _same_bvh(build_bvh_fast(flat.positions), jax_build_bvh_fast(flat.positions))
    else:
        _same_bvh(build_bvh(flat.positions[:600]), jax_build_bvh(flat.positions[:600]))


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_pt_file_reads_back_byte_equal_in_the_other_package(writer, tmp_path):
    """A .pt written by one package, read by the other and written again,
    gives the same bytes."""
    flat, textures = courtyard_scene(2, textured=True)
    glb = tmp_path / "scene.glb"
    export_flattened_glb(flat, textures, glb)
    first, second = tmp_path / "first.pt", tmp_path / "second.pt"
    if writer == "port":
        write_pt(PtScene.from_gltf(glb), first)
        jax_write_pt(jax_read_pt(first), second)
    else:
        jax_write_pt(JaxPtScene.from_gltf(glb), first)
        write_pt(read_pt(first), second)
    assert first.read_bytes() == second.read_bytes()
    got, want = read_pt(first), jax_read_pt(first)
    _same_bvh(got.bvh, want.bvh)
    for field in ("tri_positions", "tri_normals", "tri_uvs", "tri_texture"):
        _equal(getattr(got, field), getattr(want, field), field)
    _same_textures(got.textures, want.textures)


@pytest.mark.parametrize("exporter", ["port", "jax"])
def test_load_gltf_of_an_exported_glb_equals_jax(exporter, tmp_path):
    """The port's exporter writes its PNGs with zlib alone; both loaders
    read either package's GLB to the same meshes and textures."""
    flat, textures = courtyard_scene(2, textured=True)
    glb = tmp_path / "scene.glb"
    (export_flattened_glb if exporter == "port" else jax_export)(flat, textures, glb)
    got, want = load_gltf(glb), jax_load_gltf(glb)
    assert len(got.meshes) == len(want.meshes)
    for a, b in zip(got.meshes, want.meshes):
        for field in ("positions", "normals", "tex_coords", "indices"):
            _equal(getattr(a, field), getattr(b, field), field)
        assert a.base_color_texture_index == b.base_color_texture_index
    _same_textures(got.base_color_textures, want.base_color_textures)
    _same_textures(got.base_color_textures, textures)


def test_plain_png_decodes_without_pillow():
    rgba = np.random.default_rng(3).integers(0, 256, (5, 7, 4), dtype=np.uint8)
    tex = Texture.from_memory(encode_png(rgba))
    u = rgba.astype(np.uint32)
    # BGRA words with alpha forced to 255, as Texture::fromMemory does.
    want = u[..., 2] | (u[..., 1] << 8) | (u[..., 0] << 16) | np.uint32(255 << 24)
    assert (tex.width, tex.height) == (7, 5)
    _equal(tex.pixels, want.reshape(-1), "pixels")


@pytest.mark.parametrize("name", ["blue_noise.npz", "sky_tables.npz", "solar_spectral.npz"])
def test_copied_assets_equal_the_jax_package_files(name):
    got = np.load(ROOT / "rayfinder_tpu_torch" / "assets" / name)
    want = np.load(ROOT / "rayfinder_tpu" / "assets" / name)
    assert sorted(got.files) == sorted(want.files)
    for key in want.files:
        _equal(got[key], want[key], f"{name}:{key}")
