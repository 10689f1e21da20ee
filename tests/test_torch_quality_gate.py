"""The port's quality-gate pieces against the JAX package's, on the CPU.

- `tools/make_quality_goldens.py quality_image` (the full-scale gate's
  render) against the JAX tool's with the per-ray stack walk
  (engine="reference"), at the regen budget of tests/test_pallas_regen.py
  (rtol 2e-4, atol 1e-5), on the textured courtyard_scene(4);
- `render/intersect.py brute_force_closest_hit` (the traversal tests' oracle)
  against the JAX package's, exactly, in one shot and in chunks;
- `prof/scenes.py courtyard_pt_scene(textured=True)`, the bench's scene: its
  texels and texture descriptors after GLB (PNG encode) -> .pt -> scene
  against the procedural build's;
- the gate's split of the image: the faces on a texel edge (the +x wall),
  the pixels whose middle ray hits them against the JAX package's stack
  walk, and `quality_gate` on images made to pass or miss each part.

The gate itself runs at 512x512 on the card (tests/test_torch_cuda.py,
chip_smoke.py phase 12).
"""

import dataclasses
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rayfinder_tpu.render.camera import create_camera as jax_camera
from rayfinder_tpu.render.camera import generate_camera_ray_lens as jax_camera_ray
from rayfinder_tpu.render.intersect import brute_force_closest_hit as jax_brute_force
from rayfinder_tpu.render.scene import build_device_scene as jax_build
from rayfinder_tpu.render.tiling import block_order
from rayfinder_tpu.scene.procedural import courtyard_scene
from rayfinder_tpu.sky.model import sky_state_from_ui as jax_sky
from rayfinder_tpu_torch.prof import scenes
from rayfinder_tpu_torch.render import intersect
from rayfinder_tpu_torch.render.camera import create_camera, primary_ray
from rayfinder_tpu_torch.render.scene import build_device_scene
from rayfinder_tpu_torch.sky.model import sky_state_from_ui
from rayfinder_tpu_torch.tools import make_quality_goldens

ROOT = pathlib.Path(__file__).resolve().parent.parent
W, H, FRAMES = 48, 32, 2

# The textured courtyard's +x wall has the UV u 8.0 exactly at every
# vertex: interpolated, float32 rounding gives 8 -+ 5e-7, which wraps to
# texel column 191 or 0 of a brick texture, and the two packages round it
# apart where their arithmetic differs (XLA's FMAs, torch's CPU sqrt on some
# builds; tests/test_torch_shaded.py), which depends on the host. With the
# wall's u moved to 7.999 in both scenes (the "wall_u_7.999" case) every
# pixel falls within the budget. As built, a pixel may fall outside it only
# where the two packages read the wrap apart: each package's image is set
# against its own images with the wall's u moved to either side of 8
# (WALL_SIDES), and a pixel is excepted where the sides it matches differ
# between the packages, or where in either it matches neither side (its
# samples wrap both ways): 13 of the 1,536 pixels on one host, at most
# MAX_WRAP_SHARE of them on any.
WALL_U = np.float32(8.0)
WALL_SIDES = (7.999, 8.001)
MAX_WRAP_SHARE = 0.02


@pytest.fixture
def jax_tool(monkeypatch, tmp_path):
    """The JAX package's tools/make_quality_goldens.py, loaded by path; its
    compilation-cache default points into tmp_path."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    spec = importlib.util.spec_from_file_location(
        "jax_make_quality_goldens", ROOT / "tools" / "make_quality_goldens.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _quality_images(jax_tool, flat, textures):
    """The port's and the JAX tool's quality images of a scene, (H*W, 3)."""
    sky, cam = scenes.BENCH_SKY, (*scenes.BENCH_CAMERA, W / H)
    want = jax_tool.quality_image(jax_build(flat, textures=textures), jax_sky(*sky),
                                  jax_camera(*cam), width=W, height=H, num_frames=FRAMES,
                                  engine="reference")
    got = make_quality_goldens.quality_image(
        build_device_scene(flat, textures=textures, device="cpu"), sky_state_from_ui(*sky),
        create_camera(*cam), width=W, height=H, num_frames=FRAMES, engine="plain")
    assert got.shape == want.shape == (H, W, 3) and got.dtype == np.float32
    return got.reshape(-1, 3), np.asarray(want).reshape(-1, 3)


def _outside_budget(a, b):
    return ~np.isclose(a, b, rtol=2e-4, atol=1e-5).all(axis=1)


def _wall_moved(flat, u):
    uv = flat.tex_coords.copy()
    on_wall = uv[..., 0] == WALL_U
    assert on_wall.any()
    uv[on_wall, 0] = np.float32(u)
    return dataclasses.replace(flat, tex_coords=uv)


@pytest.mark.parametrize("wall_u", [None, 7.999], ids=["as_built", "wall_u_7.999"])
def test_quality_image_matches_jax_reference(jax_tool, wall_u):
    flat, textures = courtyard_scene(4, textured=True)
    if wall_u is None:
        got, want = _quality_images(jax_tool, flat, textures)
        # (pixels, side) within the budget of the package's image with the
        # wall's u moved to that side.
        sides = [_quality_images(jax_tool, _wall_moved(flat, u), textures) for u in WALL_SIDES]
        port = np.stack([~_outside_budget(got, g) for g, _ in sides], axis=1)
        jax = np.stack([~_outside_budget(want, w) for _, w in sides], axis=1)
        apart = (port != jax).any(axis=1) | ~port.any(axis=1) | ~jax.any(axis=1)
        exceptions = np.nonzero(apart)[0]
    else:
        got, want = _quality_images(jax_tool, _wall_moved(flat, wall_u), textures)
        exceptions = np.zeros(0, np.int64)
    bad = np.nonzero(_outside_budget(got, want))[0]
    assert set(bad.tolist()) <= set(exceptions.tolist()), f"pixels {bad.tolist()} differ"
    assert exceptions.size <= MAX_WRAP_SHARE * W * H, f"{exceptions.size} pixels wrap apart"
    keep = np.setdiff1d(np.arange(W * H), exceptions)
    np.testing.assert_allclose(got[keep], want[keep], rtol=2e-4, atol=1e-5)


def _rays(n_camera=1024, n_random=1024, seed=17):
    """Camera rays of the bench view plus random rays inside the courtyard."""
    rng = np.random.default_rng(seed)
    cam = create_camera(*scenes.BENCH_CAMERA, 4 / 3)
    u, v = rng.uniform(size=(2, n_camera)).astype(np.float32)
    noise = rng.uniform(size=(n_camera, 2)).astype(np.float32)
    co, cd = primary_ray(cam, torch.from_numpy(u), torch.from_numpy(v),
                         torch.from_numpy(noise), (1.0 / 64, 1.0 / 48))
    ro = np.stack([rng.uniform(-19, 19, n_random), rng.uniform(0.5, 11, n_random),
                   rng.uniform(-9, 9, n_random)], axis=1).astype(np.float32)
    rd = rng.normal(size=(n_random, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    return (torch.cat([co, torch.from_numpy(ro)]).contiguous(),
            torch.cat([cd, torch.from_numpy(rd)]).contiguous())


def test_brute_force_matches_jax_exactly(monkeypatch):
    flat, textures = courtyard_scene(2)
    scene = build_device_scene(flat, textures=textures, device="cpu")
    o, d = _rays()
    tris = scene.tri_positions
    hit, t, tri = intersect.brute_force_closest_hit(o, d, tris, intersect.T_MAX)
    assert hit.dtype == torch.bool and t.dtype == torch.float32 and tri.dtype == torch.int32
    assert 0.5 < float(hit.float().mean()) < 1.0
    jhit, jt, jtri = (np.asarray(x) for x in jax_brute_force(
        jnp.asarray(o.numpy()), jnp.asarray(d.numpy()), jnp.asarray(tris.numpy()),
        jnp.float32(intersect.T_MAX)))
    np.testing.assert_array_equal(hit.numpy(), jhit)
    np.testing.assert_array_equal(t.numpy(), jt)  # atol 0, t_max where nothing is hit
    np.testing.assert_array_equal(tri.numpy(), jtri)  # -1 where nothing is hit
    # In chunks of 7 rays (and a ragged last one) the result is the same.
    monkeypatch.setattr(intersect, "BRUTE_FORCE_PAIRS", 7 * tris.shape[0] + 3)
    for a, b in zip(intersect.brute_force_closest_hit(o, d, tris, intersect.T_MAX),
                    (hit, t, tri)):
        assert torch.equal(a, b)
    empty = intersect.brute_force_closest_hit(o[:0], d[:0], tris, intersect.T_MAX)
    assert [x.shape for x in empty] == [(0,)] * 3


def test_brute_force_takes_the_first_of_equal_hits():
    """Two copies of one triangle: equal t, the lower index wins."""
    tri = torch.tensor([[[0.0, 0.0, 5.0], [1.0, 0.0, 5.0], [0.0, 1.0, 5.0]]])
    tris = torch.cat([tri + 1.0, tri, tri])
    o = torch.tensor([[0.2, 0.2, 0.0], [3.0, 3.0, 0.0]])
    d = torch.tensor([[0.0, 0.0, 1.0], [0.0, 0.0, 1.0]])
    hit, t, idx = intersect.brute_force_closest_hit(o, d, tris, 1e4)
    assert hit.tolist() == [True, False]
    assert t.tolist() == [5.0, 1e4] and idx.tolist() == [1, -1]


def test_textured_pt_scene_keeps_the_procedural_texels(monkeypatch, tmp_path):
    monkeypatch.setattr(scenes, "CACHE_DIR", tmp_path)
    pt_scene, info = scenes.courtyard_pt_scene(2, device="cpu", textured=True)
    assert pathlib.Path(info["path"]) == tmp_path / "courtyard_s2_tex1.pt"
    assert info["bytes"] == (tmp_path / "courtyard_s2_tex1.pt").stat().st_size
    flat, textures = courtyard_scene(2, textured=True)
    built = build_device_scene(flat, textures=textures, device="cpu")
    assert len(textures) == built.tex_desc.shape[0] == 14
    assert torch.equal(pt_scene.tex_desc, built.tex_desc)
    assert torch.equal(pt_scene.texels, built.texels)
    assert pt_scene.num_triangles == built.num_triangles
    untextured, _ = scenes.courtyard_pt_scene(2, device="cpu")
    assert untextured.tex_desc.shape[0] < built.tex_desc.shape[0]
    assert sorted(p.name for p in tmp_path.glob("*.pt")) == ["courtyard_s2_tex0.pt",
                                                             "courtyard_s2_tex1.pt"]


def _wall_u_moved(flat, u):
    uv = flat.tex_coords.copy()
    uv[uv[..., 0] == WALL_U, 0] = np.float32(u)
    return dataclasses.replace(flat, tex_coords=uv)


def test_texel_wrap_triangles_are_the_wall_on_a_texel_edge():
    flat, textures = courtyard_scene(4, textured=True)
    scene = build_device_scene(flat, textures=textures, device="cpu")
    wrap = make_quality_goldens.texel_wrap_triangles(scene)
    on_wall = (scene.tri_uvs[..., 0] == float(WALL_U)).all(dim=1)
    assert int(on_wall.sum()) == 2 * 4 * 4  # the +x wall's subdivided quad
    assert (scene.tri_positions[on_wall][..., 0] == 20.0).all()
    assert torch.equal(wrap, on_wall)
    # Off the edge (u = 7.999: column 191 on every hit) no face is.
    moved = build_device_scene(_wall_u_moved(flat, 7.999), textures=textures, device="cpu")
    assert not make_quality_goldens.texel_wrap_triangles(moved).any()
    # Untextured, the same wall has u = 1.0 over a one-texel texture: one texel either way.
    flat, textures = courtyard_scene(4)
    scene = build_device_scene(flat, textures=textures, device="cpu")
    assert (scene.tri_uvs[..., 0] == 1.0).all(dim=1).any()
    assert not make_quality_goldens.texel_wrap_triangles(scene).any()


def test_texel_wrap_pixels_match_jax_brute_force():
    """The pixels whose middle ray first hits the wall, by the port's brute
    force, are those JAX's brute force finds on JAX's camera rays. (JAX's
    stack walk finds no hit on 7 of them here: their rays cross a seam of
    the wall, and the walk prunes the leaf box that holds brute force's
    hit.)"""
    flat, textures = courtyard_scene(4, textured=True)
    cam = (*scenes.BENCH_CAMERA, W / H)
    scene = build_device_scene(flat, textures=textures, device="cpu")
    got = make_quality_goldens.texel_wrap_pixels(scene, create_camera(*cam), W, H)
    jscene = jax_build(flat, textures=textures)
    ys, xs, _ = block_order(W, H)
    u = (xs.astype(np.float32) + 0.5) / np.float32(W)
    v_tex = (ys.astype(np.float32) + 0.5) / np.float32(H)
    noise = np.full((W * H, 2), 0.5, np.float32)
    o, d = jax_camera_ray(jax_camera(*cam), jnp.asarray(noise),
                          jnp.asarray(u + noise[:, 0] / np.float32(W)),
                          jnp.asarray(np.float32(1.0) - v_tex + noise[:, 1] / np.float32(H)))
    tris = jnp.asarray(np.asarray(jscene.tri_attrs)[:, :9].reshape(-1, 3, 3))
    _, _, tri = jax_brute_force(o, d, tris, jnp.float32(intersect.T_MAX))
    tri = np.asarray(tri)
    uv = np.asarray(jscene.tri_attrs)[:, 18:24].reshape(-1, 3, 2)
    on_wall = (uv[:, :, 0] == WALL_U).all(axis=1)
    want = ((tri >= 0) & on_wall[np.maximum(tri, 0)]).reshape(H, W)
    assert got.dtype == np.bool_ and got.shape == (H, W)
    assert 0 < got.sum() < W * H // 2
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case, ok, failed", [
    ("equal", True, ""),
    ("off_wrap_over_budget", False, "off the texel-edge"),
    ("wrap_zero_mean_noise", True, ""),
    ("wrap_mean_shift", False, "mean difference"),
    ("wrap_rmse_over_ieee", False, "RMSE on the texel-edge"),
])
def test_quality_gate_holds_each_part(tmp_path, case, ok, failed):
    rng = np.random.default_rng(5)
    golden = rng.uniform(0.2, 0.8, size=(32, 48, 3)).astype(np.float16)
    path = tmp_path / "golden.npz"
    np.savez_compressed(path, image=golden)
    wrap = np.zeros((32, 48), bool)
    wrap[8:24, 30:46] = True  # 256 pixels
    img = golden.astype(np.float32)
    sign = rng.choice([-1.0, 1.0], size=(256, 3)).astype(np.float32)
    sign -= sign.mean(axis=0)  # zero mean on each channel
    if case == "off_wrap_over_budget":
        img[~wrap] += 2e-3
    elif case == "wrap_zero_mean_noise":
        img[wrap] += 5e-3 * sign
    elif case == "wrap_mean_shift":
        img[wrap] += 5e-3 * sign + 3e-3
    elif case == "wrap_rmse_over_ieee":
        img[wrap] += 2e-2 * sign
    line = make_quality_goldens.quality_gate(img, path, wrap)
    assert line["wrap_pixels"] == 256
    assert line["quality_ok"] is ok
    failures = make_quality_goldens.gate_failures(line)
    assert (not failures) if ok else (len(failures) == 1 and failed in failures[0])
    # Every pixel's RMSE is reported whatever the gate says.
    assert line["quality_rmse"] == pytest.approx(float(np.sqrt(np.mean(
        (img - golden.astype(np.float32)) ** 2))), rel=1e-6)
    with pytest.raises(ValueError, match="golden"):
        make_quality_goldens.quality_gate(img[:16], path, wrap[:16])
