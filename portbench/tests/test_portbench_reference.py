"""The frozen reference against the program's plain engine on the CPU, at a
tiny size: courtyard(2), 32x24, 2 bounces. Where both find the same
surfaces they agree to the byte."""

import numpy as np
import pytest
import torch

from portbench.reference import bvh, render, sah, sky
from portbench.scenes import courtyard

W, H = 32, 24
SKY = (2.5, (0.3, 0.3, 0.3), 35.0, 25.0)
POSES = [([-8.0, 3.0, 1.0], [6.0, 1.5, -1.0]), ([-7.0, 3.2, 1.0], [6.0, 1.4, -1.0]),
         ([-6.0, 3.4, 1.2], [6.0, 1.3, -1.0])]


@pytest.fixture(scope="module")
def scenes():
    from rayfinder_tpu_torch.render.scene import build_device_scene
    from rayfinder_tpu_torch.scene.flatten import FlattenedScene
    from rayfinder_tpu_torch.scene.texture import Texture

    sc = courtyard.make(2, True)
    flat = FlattenedScene(sc.positions, sc.normals, sc.tex_coords, sc.texture_indices)
    tex = [Texture(t.pixels, width=t.width, height=t.height) for t in sc.textures]
    return sc, build_device_scene(flat, textures=tex, device="cpu"), render.make_scene(sc, "cpu")


def _pixels():
    ys, xs = torch.meshgrid(torch.arange(H), torch.arange(W), indexing="ij")
    return ys.reshape(-1), xs.reshape(-1)


def test_frozen_courtyard_is_the_programs():
    from rayfinder_tpu_torch.scene.procedural import courtyard_scene

    flat, textures = courtyard_scene(4, textured=True)
    sc = courtyard.make(4, True)
    for a, b in ((flat.positions, sc.positions), (flat.normals, sc.normals),
                 (flat.tex_coords, sc.tex_coords), (flat.texture_indices, sc.texture_indices)):
        assert np.array_equal(a, b)
    assert all(np.array_equal(a.pixels, b.pixels) for a, b in zip(textures, sc.textures))


def test_sky_state_is_the_programs():
    from rayfinder_tpu_torch.sky.model import sky_state_from_ui

    for a, b in zip(sky.sky_state(*SKY), sky_state_from_ui(*SKY)):
        assert np.array_equal(a, b)


def test_walk_matches_brute_force(scenes):
    from rayfinder_tpu_torch.render.intersect import brute_force_closest_hit

    sc, _, ref = scenes
    g = torch.Generator().manual_seed(1)
    o = torch.rand(2000, 3, generator=g) * torch.tensor([36.0, 10.0, 18.0]) \
        - torch.tensor([18.0, -0.5, 9.0])
    d = torch.randn(2000, 3, generator=g)
    d = d / d.norm(dim=1, keepdim=True)
    d[:50, 0] = -0.0  # signed zeros take the negative side
    hit, t, tri = bvh.walk(ref.bvh, o, d, 1e4, False)
    bh, bt, btri = brute_force_closest_hit(o, d, torch.from_numpy(sc.positions), 1e4)
    assert torch.equal(hit, bh)
    assert (t == bt).float().mean() > 0.995
    assert torch.equal(bvh.walk(ref.bvh, o, d, 1e4, True)[0], bh)


def test_path_tracer_matches_the_programs_plain_engine(scenes):
    from rayfinder_tpu_torch.render.camera import create_camera
    from rayfinder_tpu_torch.render.pathtracer import SamplingParams
    from rayfinder_tpu_torch.render.renderer import Renderer, RenderParameters, Sky

    sc, scene, ref = scenes
    eye, look = POSES[0]
    r = Renderer(scene, RenderParameters(W, H, create_camera(eye, look, 0.0, 1.0, 70.0, W / H),
                                         SamplingParams(16, 2), Sky(*SKY), 0.25),
                 engine="plain", count_rays=True)
    r.frame_count = 5
    r.render(4)
    program = r.image_u8()
    ys, xs = _pixels()
    cam = render.camera(eye, look, 0.0, 1.0, 70.0, W / H)
    counter = render.new_counter()
    acc = torch.zeros(H * W, 3)
    for f in range(5, 9):
        acc = acc + render.pt_samples(ref, sky.sky_state(*SKY), cam, ys, xs,
                                      torch.full_like(ys, f), width=W, height=H, spp=16,
                                      bounces=2, counter=counter)
    reference = render.tonemap_u8(acc / 4.0, 0.25).reshape(H, W, 3).numpy()
    assert np.array_equal(program, reference)
    assert counter["closest"] + counter["shadow"] == r.total_rays


def test_deferred_matches_the_programs_plain_engine(scenes):
    from rayfinder_tpu_torch.render.camera import create_camera
    from rayfinder_tpu_torch.render.deferred import DeferredRenderer
    from rayfinder_tpu_torch.sky.model import sky_state_from_ui

    sc, scene, ref = scenes
    dr = DeferredRenderer(scene, W, H, engine="plain")
    ys, xs = _pixels()
    acc = None
    for k, (eye, look) in enumerate(POSES):
        out = dr.render(create_camera(eye, look, 0.0, 1.0, 70.0, W / H), sky_state_from_ui(*SKY),
                        0.25)
        s = render.deferred_samples(ref, sky.sky_state(*SKY),
                                    render.camera(eye, look, 0.0, 1.0, 70.0, W / H), ys, xs,
                                    torch.full_like(ys, k), width=W, height=H)
        acc = s if k == 0 else 0.1 * s + 0.9 * acc
        reference = render.tonemap_u8(acc, 0.25).reshape(H, W, 3).numpy()
        assert np.array_equal(np.rint(out * 255).astype(np.uint8), reference)


def test_frozen_sah_builder_is_the_programs():
    """reference/sah.py builds the program's tree (bvh/build.py), node for
    node, and the reference's walk over it finds what it finds over its own
    median-split tree, with fewer tests."""
    from rayfinder_tpu_torch.bvh.build import build_bvh

    sc = courtyard.make(4, True)
    lo, hi, right, first, count, order = sah.build(sc.positions)
    prog = build_bvh(sc.positions)
    leaf = count > 0
    assert np.array_equal(lo, prog.aabb_min) and np.array_equal(hi, prog.aabb_max)
    assert np.array_equal(count, prog.triangle_count.astype(np.int64))
    assert np.array_equal(first[leaf], prog.triangles_offset[leaf].astype(np.int64))
    assert np.array_equal(right[~leaf], prog.second_child_offset[~leaf].astype(np.int64))
    new_index = np.empty_like(order)
    new_index[order] = np.arange(order.size)
    assert np.array_equal(new_index, prog.triangle_indices)

    pos = torch.from_numpy(sc.positions)
    g = torch.Generator().manual_seed(2)
    o = torch.tensor([-8.0, 3.0, 1.0]).expand(3000, 3).clone()
    d = torch.randn(3000, 3, generator=g)
    d = d / d.norm(dim=1, keepdim=True)
    a = bvh.walk(sah.tree(pos), o, d, 1e4, False, counts=True)
    m = bvh.walk(bvh.build(pos), o, d, 1e4, False, counts=True)
    assert torch.equal(a[0], m[0]) and torch.equal(a[2], m[2])
    assert a[3] < m[3] and a[4] < m[4]


def test_work_tool_counts_both_trees(tmp_path, monkeypatch):
    from portbench.tests.tiny import tiny_cell
    from portbench.tools import work

    cell = tiny_cell("pt_converge_1080p", tmp_path, monkeypatch)
    totals = work.count(cell, [5], pixels=64, samples=2, device=torch.device("cpu"), log=None)
    sah_, med = work.summary(totals["sah"]), work.summary(totals["median"])
    assert sah_["rays"] == med["rays"] > 64 * 2
    assert sah_["closest_miss_share"] == med["closest_miss_share"]
    assert sah_["ops_per_ray"] < med["ops_per_ray"]
    assert bvh.TAIL_STEPS == 64  # restored
