"""The benchmark's vegetation-heavy garden (portbench/scenes/garden.py), the
K4 triangle-test counter (rf.walk_tests, its plain version) and its reader
(portbench/metrics/walk_tests_per_ray.py), the texel atlas past WebGPU's 256
MiB and the walks' stack sized from the tree's depth (render/scene.py), on
the CPU. The garden at its full size is only counted here (garden.census);
its geometry is made at small sizes of the same generator."""

import json
import math
import pathlib
import sys
import types

import numpy as np
import pytest
import torch

from portbench import cells, check, trace
from portbench.reference import render as ref_render
from portbench.reference import sky as ref_sky
from portbench.scenes import garden
from rayfinder_tpu_torch.ops import regen, regen_shaded
from rayfinder_tpu_torch.render import pathtracer as pt
from rayfinder_tpu_torch.render import scene as port_scene
from rayfinder_tpu_torch.render.camera import create_camera
from rayfinder_tpu_torch.render.intersect import T_MAX, brute_force_closest_hit
from rayfinder_tpu_torch.render.pathtracer import SamplingParams
from rayfinder_tpu_torch.render.renderer import Renderer, RenderParameters, Sky
from rayfinder_tpu_torch.render.rng import blue_noise_tile
from rayfinder_tpu_torch.render.scene import (
    DEEP_WALK_STACK, MAX_TEXEL_BYTES, MAX_TEXELS, WALK_STACK, build_device_scene,
)
from rayfinder_tpu_torch.render.traverse import (
    STACK_DEPTH, intersect_closest, intersect_closest_counted, intersect_packed,
)
from rayfinder_tpu_torch.scene import FlattenedScene, Texture
from rayfinder_tpu_torch.sky.model import sky_state_from_ui
from rayfinder_tpu_torch.utils import profiling
from rayfinder_tpu_torch.utils.profiling import TREE_DEPTH, WALK_TESTS, Count

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
from torch_deep_scene import (  # noqa: E402
    bvh_depth, deep_rays, deep_scene, native_deep_positions, walked_with_32,
)

ROOT = pathlib.Path(__file__).resolve().parents[1]
CONFIG = json.loads((ROOT / "portbench/configs/garden10m_tex_pt_1080p.json").read_text())
MIX = json.loads((ROOT / "portbench/mixes/converge_garden.json").read_text())
# A garden of the configuration's layout with a hundredth of its leaf cards
# (each card ten times as wide, so that its canopies cover as much) and
# small maps.
SMALL = dict(seed=5, detail=0.3, foliage=0.01, textures=128, texture_size=16)
W, H = 16, 12
SKY = (2.5, (0.3, 0.3, 0.3), 35.0, 25.0)


def _device_scene(sc):
    flat = FlattenedScene(sc.positions, sc.normals, sc.tex_coords, sc.texture_indices)
    tex = [Texture(t.pixels, width=t.width, height=t.height) for t in sc.textures]
    return build_device_scene(flat, textures=tex, device="cpu")


@pytest.fixture(scope="module")
def small():
    sc = garden.make(**SMALL)
    return sc, _device_scene(sc)


def _leaf(scene, tri, hit):
    """Which hits lie on a leaf card (a map of the leaf group)."""
    first, count = garden._groups(SMALL["textures"])["leaf"]
    tex = scene.tri_texture[tri.clamp(min=0).long()]
    return hit & (tex >= first) & (tex < first + count)


def test_garden_is_deterministic_and_made_as_counted(small):
    sc, _ = small
    again = garden.make(**SMALL)
    for a, b in ((sc.positions, again.positions), (sc.normals, again.normals),
                 (sc.tex_coords, again.tex_coords), (sc.texture_indices, again.texture_indices)):
        assert np.array_equal(a, b)
    assert all(np.array_equal(a.pixels, b.pixels) for a, b in zip(sc.textures, again.textures))
    census = garden.census(**SMALL)
    assert sc.positions.shape == (census["triangles"], 3, 3)
    leaf = _leaf(types.SimpleNamespace(tri_texture=torch.from_numpy(
        sc.texture_indices.astype(np.int32))), torch.arange(census["triangles"]),
        torch.ones(census["triangles"], dtype=torch.bool))
    assert int(leaf.sum()) == census["leaf_triangles"]
    assert len(sc.textures) == 128 and {(t.width, t.height) for t in sc.textures} == {(16, 16)}
    used = np.bincount(sc.texture_indices.astype(np.int64), minlength=128)
    assert np.array_equal(used > 0, np.asarray(census["map_users"]) > 0)
    assert np.isfinite(sc.positions).all() and np.isfinite(sc.normals).all()
    other = garden.make(**dict(SMALL, seed=6))
    assert not np.array_equal(other.positions[-1000:], sc.positions[-1000:])


def test_full_garden_is_the_configured_deployment():
    """The configuration's arguments: about 10M triangles (no cut: reduced
    is empty), most of them leaf cards, 128 maps of 2048 x 2048 RGBA8 (2
    GiB: past WebGPU's 256 MiB, inside the card's int32 texel index), each
    used by several objects."""
    args = CONFIG["scene"]["args"]
    assert CONFIG["scene"]["generator"] == "garden" and CONFIG["reduced"] == []
    census = garden.census(**args)
    assert 9_500_000 <= census["triangles"] <= 10_500_000
    assert census["foliage_share"] > 0.9
    assert census["by_kind"]["tree"] >= 8 and census["by_kind"]["potted_plant"] >= 40
    assert len(census["map_users"]) == 128 and min(census["map_users"]) >= 3
    assert census["texture_size"] == 2048
    assert 256 * 2**20 < census["texel_bytes"] == 2 * 2**30 <= MAX_TEXEL_BYTES
    assert str(census["triangles"]) in CONFIG["deployment"].replace(",", "")
    assert str(census["leaf_triangles"]) in CONFIG["deployment"].replace(",", "")
    assert "San Miguel" in CONFIG["source"] and "reference_path_tracer.hpp" in CONFIG["source"]
    assert (CONFIG["width"], CONFIG["height"], CONFIG["engine"]) == (1920, 1080, "kernel")


def test_full_garden_objects_are_made_as_counted():
    """At full detail and foliage, one object of each kind makes the
    triangles that the count gives, its leaf cards among them."""
    args = CONFIG["scene"]["args"]
    objs = garden.plan(args["seed"], args["width"], args["depth"], args["foliage"])
    groups = garden._groups(args["textures"])
    first = {}
    for o in objs:
        first.setdefault(o.kind, o)
    assert set(first) == set(garden.BUILDERS)
    sample = list(first.values())
    counted = garden._build(sample, True, groups, args["detail"], args["seed"])
    made = garden._build(sample, False, groups, args["detail"], args["seed"])
    leaf_first, leaf_count = groups["leaf"]
    for o, (n, leaves, _), (p, uv, mat) in zip(sample, counted, made):
        assert p.shape == (n, 3, 3) and uv.shape == (n, 3, 2) and mat.shape == (n,), o.kind
        on_leaf = (mat >= leaf_first) & (mat < leaf_first + leaf_count)
        assert int(on_leaf.sum()) == leaves, o.kind
        assert (leaves > 0) == (o.kind in garden.FOLIAGE), o.kind


def test_garden_camera_faces_foliage(small):
    """The cell's view (mixes/converge_garden.json): most of the primary
    rays that hit meet a leaf card, and so do most of the sun's shadow rays
    from those hits."""
    _, scene = small
    eye, look = MIX["views"][0]
    assert math.isclose(eye[1], 1.7)
    cam = create_camera(eye, look, 0.0, 1.0, 70.0, 16 / 9)
    g = torch.Generator().manual_seed(3)
    u, v = torch.rand(3000, generator=g), torch.rand(3000, generator=g)
    d = (torch.tensor(cam.lower_left_corner) + u[:, None] * torch.tensor(cam.horizontal)
         + v[:, None] * torch.tensor(cam.vertical) - torch.tensor(cam.origin))
    d = (d / d.norm(dim=1, keepdim=True)).float()
    o = torch.tensor(eye, dtype=torch.float32).expand(3000, 3).contiguous()
    hit, t, tri, _ = intersect_closest(scene, o, d, T_MAX)
    assert float(_leaf(scene, tri, hit).sum()) > 0.5 * float(hit.sum()) > 0
    sky = sky_state_from_ui(*SKY)
    sun = torch.tensor(np.asarray(sky.sun_direction, np.float32)).expand(int(hit.sum()), 3)
    p = (o[hit] + t[hit, None] * d[hit] + 1e-3 * sun).contiguous()
    hit2, _, tri2, _ = intersect_closest(scene, p, sun.contiguous(), T_MAX)
    assert float(_leaf(scene, tri2, hit2).float().mean()) > 0.5


def test_garden_plain_engine_matches_the_reference(small):
    """The program's plain engine against the benchmark's reference on the
    small garden, at the cell's view, 16x12, 4 bounces: within the check's
    rule (check.judge with the cell's limits), and the reference traces the
    rays the program counts."""
    sc, scene = small
    eye, look = MIX["views"][0]
    r = Renderer(scene, RenderParameters(W, H, create_camera(eye, look, 0.0, 1.0, 70.0, W / H),
                                         SamplingParams(16, 4), Sky(*SKY), 0.25),
                 engine="plain", count_rays=True)
    r.frame_count = 7
    r.render(2)
    program = r.image_u8()
    ref = ref_render.make_scene(sc, "cpu")
    ys, xs = torch.meshgrid(torch.arange(H), torch.arange(W), indexing="ij")
    ys, xs = ys.reshape(-1), xs.reshape(-1)
    cam = ref_render.camera(eye, look, 0.0, 1.0, 70.0, W / H)
    counter = ref_render.new_counter()
    acc = torch.zeros(H * W, 3)
    for f in range(7, 9):
        acc = acc + ref_render.pt_samples(ref, ref_sky.sky_state(*SKY), cam, ys, xs,
                                          torch.full_like(ys, f), width=W, height=H, spp=16,
                                          bounces=4, counter=counter)
    reference = ref_render.tonemap_u8(acc / 2.0, 0.25).reshape(H, W, 3).numpy()
    limits = cells.find("pt_converge_1080p_garden").limits
    correct, compared = check.judge(check.numbers(program[None], reference[None]), limits)
    assert correct, compared
    assert counter["closest"] + counter["shadow"] == r.total_rays


def test_plain_k4_counts_the_tests_of_its_walks(small, monkeypatch):
    """The plain K4's rf.walk_tests count equals the triangles that the
    packed walk's plain version (intersect_packed at counting level 2)
    tests over the very rays the plain K4 walked, closest and shadow; and
    counting changes none of its outputs."""
    _, scene = small
    w, h, spp = 16, 8, 2
    eye, look = MIX["views"][0]
    cam = create_camera(eye, look, 0.0, 1.0, 70.0, w / h)
    ys, xs = pt._pixels(w, h, "cpu")
    tile = torch.from_numpy(blue_noise_tile())
    lanes = dict(u=(xs.to(torch.float32) + 0.5) / float(w),
                 v_tex=(ys.to(torch.float32) + 0.5) / float(h),
                 noise_base=tile[(ys % 128).long(), (xs % 128).long()])
    d = pt._Dispatch(scene=scene, sky=sky_state_from_ui(*SKY), camera=cam,
                     kernels=pt._ENGINES["plain"], inv_dims=(1.0 / w, 1.0 / h), frame_base=3,
                     spp=spp, nf=spp, num_bounces=4)
    st = pt._initial_state(d, lanes, w * h, "cpu")
    lrad, _ = d.split_step(st, lanes, torch.zeros(w * h, 3))
    args = (*d.pixel_args(lanes), d.num_bounces, 0, T_MAX, st["sample"], st["bounce"],
            st["flag"], st["origin"], st["direction"], st["thr"], st["srad"], lrad,
            st["shadow_o"], st["shadow_d"], st["contrib"])
    plain = regen_shaded.trace_regen_shaded_reference(*args)
    walked = []
    closest = regen_shaded.intersect_closest_counted
    packed = regen.intersect_packed

    def closest_seen(sc, o, dd, t_max):
        walked.append((o, dd, False))
        return closest(sc, o, dd, t_max)

    def packed_seen(sc, o, dd, t_max, any_hit=False, count=False):
        walked.append((o, dd, any_hit))
        return packed(sc, o, dd, t_max, any_hit=any_hit, count=count)

    monkeypatch.setattr(regen_shaded, "intersect_closest_counted", closest_seen)
    monkeypatch.setattr(regen, "intersect_packed", packed_seen)
    records, tests = torch.zeros(1, dtype=torch.int64), torch.zeros(1, dtype=torch.int64)
    counted = regen_shaded.trace_regen_shaded(*args, records=records, tests=tests)
    for a, b in zip(plain, counted):
        assert torch.equal(a, b)
    want_records = want_tests = 0
    for o, dd, any_hit in walked:
        work = intersect_packed(scene, o, dd, T_MAX, any_hit=any_hit, count=True)[3]
        want_records += int(((work[:, 0].to(torch.int64) - 1) // 2).sum())
        want_tests += int(work[:, 2].sum())
    assert {a for _, _, a in walked} == {False, True}
    assert int(records) == want_records > 0
    assert int(tests) == want_tests > 0


def test_renderer_records_the_test_counter(small):
    """Renderer(count_rays=True) adds each render's K4 tests to
    total_walk_tests and to the counter rf.walk_tests, read back with the
    rays; a renderer that does not count gives the same image."""
    _, scene = small
    eye, look = MIX["views"][0]
    params = RenderParameters(W, H, create_camera(eye, look, 0.0, 1.0, 70.0, W / H),
                              SamplingParams(8, 2), Sky(*SKY), 0.25)
    r = Renderer(scene, params, engine="plain", count_rays=True)
    with profiling.recording() as rec:
        r.render(2)
        r.render(2)
    counts = [c.n for c in rec.records() if isinstance(c, Count) and c.name == WALK_TESTS]
    assert len(counts) == 2 and all(n > 0 for n in counts)
    assert r.total_walk_tests == sum(counts)
    quiet = Renderer(scene, params, engine="plain")
    quiet.render(2)
    quiet.render(2)
    assert quiet.total_walk_tests is None
    assert np.array_equal(quiet.image_u8(), r.image_u8())


# Two batches in a window of (0, 10) on the trace's clock.
K4_TRACE = trace.Trace([("trace_regen_shaded_items_kernel", 0.5, 4.0)], [], (0.0, 10.0))
FRAMES = [{"t0": 10.0, "t1": 11.0}, {"t0": 11.0, "t1": 12.0}]
RECORDS = [Count(WALK_TESTS, 9.9, 7, 0), Count(WALK_TESTS, 10.2, 3_000_000_000, 1),
           Count("rf.walk_records", 10.3, 5, 1), Count(WALK_TESTS, 11.5, 1_000_000_000, 2),
           Count(WALK_TESTS, 12.1, 9, 3)]


def test_walk_tests_per_ray_reader(monkeypatch):
    """4e9 tests in the window over 1e8 rays; None from a program without
    the counter (the parent of the counter) or without a recorder."""
    read = cells.load_module("metrics", "walk_tests_per_ray").read
    monkeypatch.setattr(profiling, "PROFILED", types.SimpleNamespace(records=lambda: RECORDS))
    run = types.SimpleNamespace(trace=K4_TRACE, frames=FRAMES, rays=100_000_000)
    assert read(run) == pytest.approx(40.0)
    monkeypatch.setattr(profiling, "PROFILED", types.SimpleNamespace(
        records=lambda: [r for r in RECORDS if r.name != WALK_TESTS]))
    assert read(run) is None
    monkeypatch.delattr(profiling, "PROFILED")
    assert read(run) is None


def _two_triangles():
    pos = np.asarray([[[0, 0, 0], [1, 0, 0], [0, 1, 0]], [[0, 0, 1], [1, 0, 1], [0, 1, 1]]],
                     np.float32)
    return FlattenedScene(positions=pos, normals=np.zeros_like(pos),
                          tex_coords=np.full((2, 3, 2), 0.5, np.float32),
                          texture_indices=np.asarray([0, 1], np.uint32))


def test_atlas_past_256_mib_loads_and_equals_its_parts():
    """The texel budget is the card's int32 texel index, not WebGPU's 256
    MiB: an atlas of 256 MiB and a map more loads, each map at its offset;
    one of 2**31 texels raises, naming the bound."""
    big = Texture((np.arange(8192 * 8192, dtype=np.uint32) * np.uint32(2654435761)),
                  width=8192, height=8192)
    small = Texture(np.asarray([1, 2, 3, 4, 5, 6], np.uint32), width=3, height=2)
    scene = build_device_scene(_two_triangles(), textures=[big, small], device="cpu")
    texels = scene.texels.numpy().view(np.uint32)
    assert texels.nbytes == 256 * 2**20 + 24 > 256 * 2**20
    assert scene.tex_desc.tolist() == [[8192, 8192, 0], [3, 2, 8192 * 8192]]
    assert np.array_equal(texels[:8192 * 8192], big.pixels)
    assert np.array_equal(texels[8192 * 8192:], small.pixels)
    assert MAX_TEXELS == 2**31 - 1 and MAX_TEXEL_BYTES == 4 * MAX_TEXELS
    # The atlas's size is checked before any texel is read: a map that only
    # names its size will do.
    huge = types.SimpleNamespace(pixels=np.zeros(1, np.uint32), width=65536, height=32768)
    with pytest.raises(ValueError, match=f"{MAX_TEXELS} texels"):
        build_device_scene(_two_triangles(), textures=[huge, small], device="cpu")


def test_tree_depth_of_the_node_planes():
    """render/scene.py tree_depth, level by level, against the recursive
    count of tests/torch_deep_scene.py on a chain, a SAH tree and a leaf."""
    from rayfinder_tpu_torch.bvh.native import build_bvh_fast

    _, chain = deep_scene()
    rng = np.random.default_rng(4)
    pos = (rng.uniform(-5, 5, (500, 1, 3)) + rng.normal(scale=0.3, size=(500, 3, 3)))
    sah = build_bvh_fast(pos.astype(np.float32))
    for bvh in (chain, sah):
        want = bvh_depth(bvh.triangle_count, bvh.second_child_offset)
        assert port_scene.tree_depth(bvh.triangle_count, bvh.second_child_offset) == want > 1
    assert port_scene.tree_depth(np.asarray([3]), np.asarray([0])) == 1


def test_deep_tree_loads_with_the_deeper_walk():
    """Triangles that the port's own builder makes into a tree of depth 44
    (past the 32-entry stack's 33) load with the 64-entry walk, inside the
    tables' span, counted as rf.scene.tree_depth; a courtyard keeps the 32
    entries."""
    flat = FlattenedScene(positions=native_deep_positions(),
                          normals=np.zeros_like(native_deep_positions()),
                          tex_coords=np.zeros((44, 3, 2), np.float32),
                          texture_indices=np.zeros(44, np.uint32))
    with profiling.recording() as rec:
        scene = build_device_scene(flat, device="cpu")
    records = rec.records()
    depth = [(c.name, c.n) for c in records if isinstance(c, Count)]
    assert depth == [(TREE_DEPTH, 44)]
    tables = next(r for r in records if isinstance(r, profiling.Span)
                  and r.name == "rf.scene.tables")
    count = next(c for c in records if isinstance(c, Count))
    assert tables.t0 <= count.t <= tables.t1
    assert scene.walk_stack == DEEP_WALK_STACK == 64
    assert bvh_depth(scene.bvh_tri_count.numpy(), scene.bvh_second_child.numpy()) == 44
    from rayfinder_tpu_torch.scene.procedural import courtyard_scene

    flat, textures = courtyard_scene(2)
    assert build_device_scene(flat, textures=textures, device="cpu").walk_stack == WALK_STACK


def test_deeper_walk_equals_brute_force_where_the_32_entry_walk_does_not():
    """On the 40-level chain of tests/torch_deep_scene.py the plain walks
    with the scene's 64 entries find the closest hits that brute force
    finds, on rays that overflow a 32-entry stack; with 32 entries
    (walked_with_32) they miss some; both walks agree with each other as
    before."""
    flat, bvh = deep_scene()
    deep = build_device_scene(flat, bvh=bvh, device="cpu")
    shallow = walked_with_32(deep)
    assert (deep.walk_stack, shallow.walk_stack) == (64, STACK_DEPTH)
    o, d = (torch.from_numpy(a) for a in deep_rays(2048, seed=9))
    _, t, tri = brute_force_closest_hit(o, d, deep.tri_positions, T_MAX)
    for scene, exact in ((deep, True), (shallow, False)):
        plane = intersect_closest_counted(scene, o, d, T_MAX)
        packed = intersect_packed(scene, o, d, T_MAX, count=True)
        for a, b in zip(plane, packed):
            assert torch.equal(a, b)
        assert (torch.equal(plane[2], tri) and torch.equal(plane[1], t)) == exact
        assert (int(plane[3][:, 0].max()) > 2 * STACK_DEPTH + 1) or exact


def test_tree_past_the_deeper_walk_raises():
    """A chain of depth 70 needs 69 entries, past the 64-entry walk: it
    does not load, and the error names its depth."""
    flat, bvh = deep_scene(70)
    with pytest.raises(ValueError, match="depth 70"):
        build_device_scene(flat, bvh=bvh, device="cpu")


def test_garden_cell_is_listed():
    """The cell reports what the path-tracer cells report, walk_tests_per_ray
    among them, on one chip, and the metric reads in the four path-tracer
    cells."""
    bench = cells.benchmark()
    cell = cells.find("pt_converge_1080p_garden", bench)
    entry = next(w for w in bench["workloads"] if w["name"] == cell.name)
    assert entry["chips"] == 1 and entry["config"] == "garden10m_tex_pt_1080p"
    assert [m["name"] for m in cell.end_to_end] == ["msamples_per_s", "setup_s"]
    names = {m["name"] for m in cell.per_layer}
    assert {"walk_records_per_ray", "k4_ns_per_record", "k4_roofline", "rays_per_sample",
            "device_idle.converge", "pt_idle_prep_ms", "pt_idle_image_ms",
            "h2d_mb_per_batch", "scene_load_s", "walk_tests_per_ray"} == names
    tests = next(m for m in bench["per_layer"] if m["name"] == "walk_tests_per_ray")
    assert tests["workloads"] == ["pt_converge_1080p", "pt_converge_1080p_b8",
                                  "pt_converge_1080p_street", "pt_converge_1080p_garden"]
    assert (tests["unit"], tests["better"], tests["source"], tests["layer"], tests["moves"]) == (
        "tests", "lower", "program_counter", "traversal", "msamples_per_s")
    assert cell.mix["check_pixels"] == 128 and cell.mix["bounces"] == 4
    assert (cell.mix["spp"], cell.mix["batch"]) == (1024, 8)
    assert cell.mix["jitter"]["eye"] == [0.02, 0.02, 0.02]
