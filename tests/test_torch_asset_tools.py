"""The port's asset tools (tools/blue_noise_tool.py, make_test_glb.py,
bake_assets.py) and its PNG decoder against the JAX package's tools, on
synthetic inputs made here (no file from outside the repository).

The JAX tools read and write PNGs with Pillow; the port's use its own zlib
coder (scene/texture.py), so the GPU machine, which has no Pillow, runs them.
Their outputs are held equal array for array.
"""

import io
import struct
import zlib

import numpy as np
import pytest

from PIL import Image

from rayfinder_tpu.scene import FlattenedScene as JaxFlattened
from rayfinder_tpu.scene import load_gltf as jax_load_gltf
from rayfinder_tpu.tools import bake_assets as jax_bake
from rayfinder_tpu.tools.blue_noise_tool import bake_png as jax_bake_png
from rayfinder_tpu.tools.make_test_glb import build_test_glb as jax_build_glb
from rayfinder_tpu_torch.scene import FlattenedScene, load_gltf
from rayfinder_tpu_torch.scene.texture import Texture, decode_png
from rayfinder_tpu_torch.tools import bake_assets, blue_noise_tool, make_test_glb
from rayfinder_tpu_torch.utils.image import read_png


def _png_with_filters(img: np.ndarray) -> bytes:
    """An 8-bit PNG of img ((h, w) grey or (h, w, c)) whose rows cycle
    through the five filter types (encoded here, as the PNG standard
    defines them)."""
    img = img if img.ndim == 3 else img[:, :, None]
    h, w, c = img.shape
    color = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    raw = img.reshape(h, w * c).astype(np.int32)
    rows = []
    for y in range(h):
        line, prev = raw[y], raw[y - 1] if y else np.zeros(w * c, np.int32)
        left = np.concatenate([np.zeros(c, np.int32), line[:-c]])
        upleft = np.concatenate([np.zeros(c, np.int32), prev[:-c]])
        kind = y % 5
        if kind == 0:
            pred = np.zeros_like(line)
        elif kind == 1:
            pred = left
        elif kind == 2:
            pred = prev
        elif kind == 3:
            pred = (left + prev) // 2
        else:
            p = left + prev - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
        rows.append(bytes([kind]) + ((line - pred) & 0xFF).astype(np.uint8).tobytes())

    def chunk(kind, data):
        return struct.pack(">I", len(data)) + kind + data + struct.pack(
            ">I", zlib.crc32(kind + data) & 0xFFFFFFFF)

    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(rows))) + chunk(b"IEND", b""))


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_decode_png_undoes_every_filter(channels):
    rng = np.random.default_rng(channels)
    img = rng.integers(0, 256, (23, 17, channels), dtype=np.uint8)
    if channels == 1:
        img = img[:, :, 0]
    data = _png_with_filters(img)
    want = np.asarray(Image.open(io.BytesIO(data)))
    got = decode_png(data)
    np.testing.assert_array_equal(got if channels > 1 else got[:, :, 0], want)
    rgba = np.asarray(Image.open(io.BytesIO(data)).convert("RGBA")).astype(np.uint32)
    bgra = rgba[..., 2] | (rgba[..., 1] << 8) | (rgba[..., 0] << 16) | np.uint32(255 << 24)
    np.testing.assert_array_equal(Texture.from_memory(data).pixels, bgra.reshape(-1))


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA"])
def test_decode_png_reads_pillows_pngs(mode):
    rng = np.random.default_rng(7)
    channels = len(mode)
    img = rng.integers(0, 256, (31, 45, channels), dtype=np.uint8)
    buf = io.BytesIO()
    Image.fromarray(img[:, :, 0] if channels == 1 else img, mode).save(buf, format="PNG")
    got = decode_png(buf.getvalue())
    np.testing.assert_array_equal(got if channels > 1 else got[:, :, 0],
                                  np.asarray(Image.open(buf)))


def test_decode_png_declines_other_images():
    buf = io.BytesIO()
    Image.fromarray(np.zeros((4, 4), np.uint8), "L").convert("P").save(buf, format="PNG")
    assert decode_png(buf.getvalue()) is None  # palette
    assert decode_png(b"not a png") is None


@pytest.mark.parametrize("writer", ["pillow", "port"])
def test_blue_noise_tool_matches_jax(tmp_path, writer):
    """An RG(BA) blue-noise PNG baked by both tools gives the same tile."""
    rng = np.random.default_rng(11)
    rgba = rng.integers(0, 256, (128, 128, 4), dtype=np.uint8)
    png = tmp_path / "noise.png"
    if writer == "pillow":
        Image.fromarray(rgba, "RGBA").save(png)
    else:
        from rayfinder_tpu_torch.utils.image import write_png

        write_png(png, rgba)
    jax_bake_png(png, tmp_path / "jax.npz")
    assert blue_noise_tool.main([str(png), "-o", str(tmp_path / "port.npz")]) == 0
    with np.load(tmp_path / "jax.npz") as want, np.load(tmp_path / "port.npz") as got:
        assert got["tile"].dtype == np.uint8
        np.testing.assert_array_equal(got["tile"], want["tile"])
        np.testing.assert_array_equal(got["tile"], rgba[:, :, :2])


def test_blue_noise_tool_refuses_a_grey_png(tmp_path):
    png = tmp_path / "grey.png"
    Image.fromarray(np.zeros((8, 8), np.uint8), "L").save(png)
    with pytest.raises(ValueError, match="RG"):
        blue_noise_tool.bake_png(png, tmp_path / "out.npz")


def test_tool_defaults_point_into_the_ports_assets():
    import pathlib

    assets = pathlib.Path(blue_noise_tool.__file__).resolve().parent.parent / "assets"
    assert make_test_glb.DEFAULT_OUTPUT.parent == assets == bake_assets.ASSETS
    assert assets.parent.name == "rayfinder_tpu_torch"


@pytest.fixture(scope="module")
def test_glbs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("glb")
    jax_path, port_path = tmp / "jax.glb", tmp / "port.glb"
    jax_build_glb(jax_path)
    make_test_glb.main([str(port_path)])
    return jax_path, port_path


def _scene_arrays(scene, flat):
    return ({k: getattr(flat, k) for k in ("positions", "normals", "tex_coords", "texture_indices")},
            [(t.width, t.height, t.pixels) for t in scene.base_color_textures])


@pytest.mark.parametrize("loader", ["jax", "port"])
def test_make_test_glb_loads_as_jax(test_glbs, loader):
    """Each package's loader reads the port's GLB as the JAX tool's: equal
    FlattenedScene fields and texture pixels."""
    load, flatten = ((jax_load_gltf, JaxFlattened.from_scene) if loader == "jax"
                     else (load_gltf, FlattenedScene.from_scene))
    scenes = [load(path) for path in test_glbs]
    (want_fields, want_tex), (got_fields, got_tex) = (
        _scene_arrays(s, flatten(s)) for s in scenes)
    for name, want in want_fields.items():
        assert got_fields[name].dtype == want.dtype, name
        np.testing.assert_array_equal(got_fields[name], want, err_msg=name)
    assert len(got_tex) == len(want_tex) == 8  # 6 images + 2 distinct factors
    for (gw, gh, gp), (ww, wh, wp) in zip(got_tex, want_tex):
        assert (gw, gh) == (ww, wh)
        np.testing.assert_array_equal(gp, wp)


def test_make_test_glb_pngs_decode_without_pillow(test_glbs):
    """The port's GLB embeds PNGs its own decoder reads: same pixels as the
    JAX tool's Pillow PNGs."""
    import json

    for seed, size in enumerate([(16, 16), (32, 16), (8, 8), (16, 32), (24, 16), (8, 16)]):
        data = make_test_glb._png_bytes(size, seed)
        img = decode_png(data)
        assert img.shape == (size[1], size[0], 4)
        np.testing.assert_array_equal(img, np.asarray(Image.open(io.BytesIO(data))))
    raw = test_glbs[1].read_bytes()
    doc = json.loads(raw[20:20 + struct.unpack("<I", raw[12:16])[0]])
    assert doc["asset"]["generator"] == "rayfinder-tpu make_test_glb"


def _c_array(kind: str, name: str, values) -> str:
    body = ",\n    ".join(", ".join(v for v in values[i:i + 8]) for i in range(0, len(values), 8))
    return f"// generated\nconst {kind} {name} = {{\n    {body}\n}};\n"


@pytest.fixture(scope="module")
def reference_tree(tmp_path_factory):
    """Small headers of the reference's layout, with the table sizes the
    parsers check, written here from a seed."""
    root = tmp_path_factory.mktemp("reference")
    rng = np.random.default_rng(13)

    def floats(n, suffix="f"):
        return [f"{x:.9g}{suffix}" if i % 3 else f"{x:.6e}" for i, x in
                enumerate(rng.normal(size=n) * 10.0 ** rng.integers(-3, 4, n))]

    sky = root / "src" / "hw-skymodel"
    sky.mkdir(parents=True)
    for ch in "rgb":
        (sky / f"params_{ch}.h").write_text(_c_array("float", f"params_{ch}[]", floats(1080)))
        (sky / f"radiances_{ch}.h").write_text(
            _c_array("float", f"radiances_{ch}[]", floats(120))
            + _c_array("float", f"solar_radiances_{ch}[]", floats(10)))
    pt = root / "src" / "pt"
    pt.mkdir(parents=True)
    ints = [str(v) for v in rng.integers(0, 256, 128 * 128 * 2)]
    (pt / "blue_noise.c").write_text(_c_array("unsigned char", "blueNoiseValues[]", ints))
    spectral = root / "src" / "hosekwilkie-skylightmodel-source-1.4a"
    spectral.mkdir(parents=True)
    text = ""
    for wl in range(320, 721, 40):
        text += _c_array("double", f"dataset{wl}[]", floats(1080, ""))
        text += _c_array("double", f"datasetRad{wl}[]", floats(120, ""))
        text += _c_array("double", f"solarDataset{wl}[]", floats(1800, ""))
        text += _c_array("double", f"limbDarkeningDataset{wl}[]", floats(6, ""))
    (spectral / "ArHosekSkyModelData_Spectral.h").write_text(text)
    return root


@pytest.mark.parametrize("bake", ["bake_sky_tables", "bake_blue_noise", "bake_solar_spectral"])
def test_bake_assets_match_jax(reference_tree, tmp_path, bake):
    getattr(jax_bake, bake)(reference_tree, tmp_path / "jax.npz")
    getattr(bake_assets, bake)(reference_tree, tmp_path / "port.npz")
    with np.load(tmp_path / "jax.npz") as want, np.load(tmp_path / "port.npz") as got:
        assert sorted(got.files) == sorted(want.files)
        for name in want.files:
            assert got[name].dtype == want[name].dtype, name
            np.testing.assert_array_equal(got[name], want[name], err_msg=name)


def test_bake_assets_cli_writes_every_asset(reference_tree, tmp_path):
    out = tmp_path / "assets"
    bake_assets.main(["--reference", str(reference_tree), "--output-dir", str(out)])
    assert sorted(p.name for p in out.iterdir()) == [
        "blue_noise.npz", "sky_tables.npz", "solar_spectral.npz"]
    with pytest.raises(SystemExit):
        bake_assets.main([])  # the reference checkout is not optional


def test_read_png_gives_grey_as_pillow(tmp_path):
    png = tmp_path / "grey.png"
    img = np.arange(48, dtype=np.uint8).reshape(6, 8)
    Image.fromarray(img, "L").save(png)
    np.testing.assert_array_equal(read_png(png), img)
