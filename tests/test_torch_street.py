"""The benchmark's production-size street (portbench/scenes/street.py), the
K4 walk counter (rf.walk_records, its plain version), the scene load's spans
(render/scene.py load_device_scene) and the readers of the counter
(portbench/metrics/walk_records_per_ray.py, k4_ns_per_record.py), on the
CPU. The street at its full size is only counted here (street.census); its
geometry is made at small sizes of the same generator."""

import json
import math
import pathlib
import types

import numpy as np
import pytest
import torch

from portbench import cells, trace
from portbench.reference import render as ref_render
from portbench.reference import sky as ref_sky
from portbench.scenes import street
from rayfinder_tpu_torch.ops import regen, regen_shaded
from rayfinder_tpu_torch.render import pathtracer as pt
from rayfinder_tpu_torch.render.camera import create_camera
from rayfinder_tpu_torch.render.intersect import T_MAX
from rayfinder_tpu_torch.render.pathtracer import SamplingParams, accumulate_samples_regen
from rayfinder_tpu_torch.render.renderer import Renderer, RenderParameters, Sky
from rayfinder_tpu_torch.render.rng import blue_noise_tile
from rayfinder_tpu_torch.render.scene import MAX_TEXEL_BYTES, build_device_scene
from rayfinder_tpu_torch.render.traverse import intersect_packed
from rayfinder_tpu_torch.scene import FlattenedScene, Texture
from rayfinder_tpu_torch.scene.procedural import courtyard_scene
from rayfinder_tpu_torch.sky.model import sky_state_from_ui
from rayfinder_tpu_torch.utils import profiling
from rayfinder_tpu_torch.utils.profiling import WALK_RECORDS, Count

ROOT = pathlib.Path(__file__).resolve().parents[1]
CONFIG = json.loads((ROOT / "portbench/configs/street2m8_tex_pt_1080p.json").read_text())
SMALL = dict(seed=5, length=10.0, detail=0.3, textures=56, texture_size=16)
W, H = 32, 24
SKY = (2.5, (0.3, 0.3, 0.3), 35.0, 25.0)


def _device_scene(sc):
    flat = FlattenedScene(sc.positions, sc.normals, sc.tex_coords, sc.texture_indices)
    tex = [Texture(t.pixels, width=t.width, height=t.height) for t in sc.textures]
    return build_device_scene(flat, textures=tex, device="cpu")


@pytest.fixture(scope="module")
def small():
    sc = street.make(**SMALL)
    return sc, _device_scene(sc)


def _view(length):
    """The cell's view (mixes/converge_street.json) scaled to a street of `length`."""
    return [-length / 2 + 2.0, 1.7, 0.0], [length / 2, 2.6, 0.0]


def test_street_is_deterministic_and_made_as_counted(small):
    sc, _ = small
    again = street.make(**SMALL)
    for a, b in ((sc.positions, again.positions), (sc.normals, again.normals),
                 (sc.tex_coords, again.tex_coords), (sc.texture_indices, again.texture_indices)):
        assert np.array_equal(a, b)
    assert all(np.array_equal(a.pixels, b.pixels) for a, b in zip(sc.textures, again.textures))
    census = street.census(**SMALL)
    assert sc.positions.shape == (census["triangles"], 3, 3)
    assert len(sc.textures) == 56 and {(t.width, t.height) for t in sc.textures} == {(16, 16)}
    used = np.bincount(sc.texture_indices.astype(np.int64), minlength=56)
    assert np.array_equal(used > 0, np.asarray(census["map_users"]) > 0)
    assert np.isfinite(sc.positions).all() and np.isfinite(sc.normals).all()
    other = street.make(**dict(SMALL, seed=6))
    assert not np.array_equal(other.positions[-1000:], sc.positions[-1000:])


def test_full_street_is_the_configured_deployment():
    """The configuration's arguments: 2.70M-2.90M triangles, at least 2,000
    props of 200-5,000 triangles each, 56 maps of 1024 x 1024 RGBA8 (224 MiB,
    inside the atlas budget), each used by several objects."""
    args = CONFIG["scene"]["args"]
    assert CONFIG["scene"]["generator"] == "street" and CONFIG["reduced"] == []
    census = street.census(**args)
    assert 2_700_000 <= census["triangles"] <= 2_900_000
    assert census["props"] >= 2_000
    assert 200 <= min(census["prop_triangles"]) and max(census["prop_triangles"]) <= 5_000
    assert len(census["map_users"]) == 56 and min(census["map_users"]) >= 3
    assert census["texture_size"] == 1024
    assert census["texel_bytes"] == 224 * 2**20 <= MAX_TEXEL_BYTES
    assert str(census["triangles"]) in CONFIG["deployment"].replace(",", "")


def test_full_street_objects_are_made_as_counted():
    """At full detail, one object of each kind makes the triangles that the
    count gives, and their areas span more than four orders of magnitude."""
    args = CONFIG["scene"]["args"]
    objs = street.plan(args["seed"], args["length"])
    groups = street._groups(args["textures"])
    first = {}
    for o in objs:
        first.setdefault(o.kind, o)
    assert set(first) == set(street.BUILDERS)
    sample = list(first.values())
    counted = street._build(sample, True, groups, args["detail"], args["seed"])
    made = street._build(sample, False, groups, args["detail"], args["seed"])
    areas = []
    for (n, _), (p, uv, mat) in zip(counted, made):
        assert p.shape == (n, 3, 3) and uv.shape == (n, 3, 2) and mat.shape == (n,)
        areas.append(0.5 * np.linalg.norm(np.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0]), axis=1))
    areas = np.concatenate(areas)
    assert areas.min() > 0 and areas.max() / areas.min() > 1e4


def test_street_faces_the_camera(small):
    """Every surface faces out of its solid: the camera's rays meet the
    front of what they hit."""
    from rayfinder_tpu_torch.render.traverse import intersect_closest

    sc, scene = small
    eye, look = _view(SMALL["length"])
    g = torch.Generator().manual_seed(3)
    d = torch.tensor(look) - torch.tensor(eye) + torch.randn(4000, 3, generator=g) * 4.0
    d = d / d.norm(dim=1, keepdim=True)
    o = torch.tensor(eye).expand(4000, 3).contiguous()
    hit, _, tri, _ = intersect_closest(scene, o, d, T_MAX)
    p = scene.tri_positions[tri[hit].long()]
    n = torch.linalg.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0])
    facing = ((n * d[hit]).sum(1) < 0).float().mean()
    assert int(hit.sum()) > 1000 and float(facing) > 0.999


def test_street_plain_engine_matches_the_reference(small):
    """The program's plain engine against the benchmark's reference at a
    small size of the same generator, 32x24, 4 bounces: where both find the
    same surfaces they agree to the byte (portbench/tests'
    test_path_tracer_matches_the_programs_plain_engine)."""
    sc, scene = small
    eye, look = _view(SMALL["length"])
    r = Renderer(scene, RenderParameters(W, H, create_camera(eye, look, 0.0, 1.0, 70.0, W / H),
                                         SamplingParams(16, 4), Sky(*SKY), 0.25),
                 engine="plain", count_rays=True)
    r.frame_count = 7
    r.render(4)
    program = r.image_u8()
    ref = ref_render.make_scene(sc, "cpu")
    ys, xs = torch.meshgrid(torch.arange(H), torch.arange(W), indexing="ij")
    ys, xs = ys.reshape(-1), xs.reshape(-1)
    cam = ref_render.camera(eye, look, 0.0, 1.0, 70.0, W / H)
    counter = ref_render.new_counter()
    acc = torch.zeros(H * W, 3)
    for f in range(7, 11):
        acc = acc + ref_render.pt_samples(ref, ref_sky.sky_state(*SKY), cam, ys, xs,
                                          torch.full_like(ys, f), width=W, height=H, spp=16,
                                          bounces=4, counter=counter)
    reference = ref_render.tonemap_u8(acc / 4.0, 0.25).reshape(H, W, 3).numpy()
    assert np.array_equal(program, reference)
    assert counter["closest"] + counter["shadow"] == r.total_rays


def _k4_state(scene, w=32, h=16, spp=4):
    """A dispatch's lanes and their state after one split step (NEE samples
    pending), the courtyard's bench view."""
    cam = create_camera([-16.0, 5.0, 0.0], [12.0, 2.0, 0.0], 0.0, 1.0, 70.0, w / h)
    sky = sky_state_from_ui(*SKY)
    ys, xs = pt._pixels(w, h, "cpu")
    u = (xs.to(torch.float32) + 0.5) / float(w)
    v_tex = (ys.to(torch.float32) + 0.5) / float(h)
    tile = torch.from_numpy(blue_noise_tile())
    lanes = dict(u=u, v_tex=v_tex, noise_base=tile[(ys % 128).long(), (xs % 128).long()])
    d = pt._Dispatch(scene=scene, sky=sky, camera=cam, kernels=pt._ENGINES["plain"],
                     inv_dims=(1.0 / w, 1.0 / h), frame_base=3, spp=spp, nf=spp,
                     num_bounces=4)
    n = w * h
    st = pt._initial_state(d, lanes, n, "cpu")
    lrad, _ = d.split_step(st, lanes, torch.zeros(n, 3))
    return d, lanes, st, lrad


@pytest.mark.parametrize("floor", [0, 40])
def test_plain_k4_counts_the_records_of_its_walks(floor, monkeypatch):
    """The plain K4's rf.walk_records count equals the records that the
    packed walk's plain version (intersect_packed: one slab test for the
    root, two per record) reads over the very rays the plain K4 walked,
    closest and shadow; and counting changes none of its outputs."""
    flat, textures = courtyard_scene(4, textured=True)
    scene = build_device_scene(flat, textures=textures, device="cpu")
    d, lanes, st, lrad = _k4_state(scene)
    walked = []
    closest = regen_shaded.intersect_closest
    packed = regen.intersect_packed

    def closest_seen(sc, o, dd, t_max):
        walked.append((o, dd, False))
        return closest(sc, o, dd, t_max)

    def packed_seen(sc, o, dd, t_max, any_hit=False, count=False):
        walked.append((o, dd, any_hit))
        return packed(sc, o, dd, t_max, any_hit=any_hit, count=count)

    args = (*d.pixel_args(lanes), d.num_bounces, floor, T_MAX, st["sample"], st["bounce"],
            st["flag"], st["origin"], st["direction"], st["thr"], st["srad"], lrad,
            st["shadow_o"], st["shadow_d"], st["contrib"])
    plain = regen_shaded.trace_regen_shaded_reference(*args)
    monkeypatch.setattr(regen_shaded, "intersect_closest", closest_seen)
    monkeypatch.setattr(regen, "intersect_packed", packed_seen)
    records = torch.zeros(1, dtype=torch.int64)
    counted = regen_shaded.trace_regen_shaded(*args, records=records)
    for a, b in zip(plain, counted):
        assert torch.equal(a, b)
    want = 0
    for o, dd, any_hit in walked:
        tests = intersect_packed(scene, o, dd, T_MAX, any_hit=any_hit)[3].to(torch.int64)
        assert bool((tests % 2 == 1).all())
        want += int(((tests - 1) // 2).sum())
    assert {a for _, _, a in walked} == {False, True}
    assert int(records) == want > 0


def test_renderer_records_the_walk_counter():
    """Renderer(count_rays=True) adds each render's K4 records to
    total_walk_records and to the counter rf.walk_records; the scan form
    counts none; the route does not change the images."""
    flat, textures = courtyard_scene(2, textured=True)
    scene = build_device_scene(flat, textures=textures, device="cpu")
    cam = create_camera([-16, 5, 0], [12, 2, 0], 0.0, 1.0, 70.0, W / H)
    params = RenderParameters(W, H, cam, SamplingParams(8, 2), Sky(*SKY), 0.25)
    r = Renderer(scene, params, engine="plain", count_rays=True)
    with profiling.recording() as rec:
        r.render(2)
        r.render(2)
    counts = [c.n for c in rec.records() if isinstance(c, Count) and c.name == WALK_RECORDS]
    assert len(counts) == 2 and all(n > 0 for n in counts)
    assert r.total_walk_records == sum(counts)
    assert 1.0 < r.total_walk_records / r.total_rays < 100.0
    quiet = Renderer(scene, params, engine="plain")
    quiet.render(2)
    quiet.render(2)
    assert quiet.total_walk_records is None
    assert np.array_equal(quiet.image_u8(), r.image_u8())


def test_split_route_reads_no_k4_records():
    flat, textures = courtyard_scene(2, textured=True)
    scene = build_device_scene(flat, textures=textures, device="cpu")
    cam = create_camera([-16, 5, 0], [12, 2, 0], 0.0, 1.0, 70.0, W / H)
    sky = sky_state_from_ui(*SKY)
    tile = torch.from_numpy(blue_noise_tile())
    out = {}
    for route in (dict(), dict(inkernel=False)):
        rec = torch.zeros(1, dtype=torch.int64)
        accum, rays = accumulate_samples_regen(
            scene, sky, cam, tile, 0, torch.zeros(W * H, 3), width=W, height=H, num_bounces=2,
            spp=4, num_frames=4, engine="plain", count_rays=True, walk_records=rec, **route)
        out[bool(route)] = (accum, rays, int(rec))
    assert out[False][2] > 0 and out[True][2] == 0
    assert torch.equal(out[False][1], out[True][1])
    torch.testing.assert_close(out[False][0], out[True][0], rtol=1e-5, atol=1e-5)


def test_scene_load_spans(tmp_path):
    """load_device_scene names its phases: the .pt read, the walk and
    cluster tables, the upload; a glTF's read takes its BVH build. Inside
    the tables' span it counts the tree's depth (rf.scene.tree_depth)."""
    from rayfinder_tpu_torch.io import PtScene, write_pt
    from rayfinder_tpu_torch.render.scene import load_device_scene
    from rayfinder_tpu_torch.tools.export_glb import export_flattened_glb

    sc = street.make(**dict(SMALL, length=4.0, detail=0.2, textures=12, texture_size=8))
    flat = FlattenedScene(sc.positions, sc.normals, sc.tex_coords, sc.texture_indices)
    tex = [Texture(t.pixels, width=t.width, height=t.height) for t in sc.textures]
    glb = tmp_path / "street.glb"
    export_flattened_glb(flat, tex, glb)
    write_pt(PtScene.from_gltf(glb), tmp_path / "street.pt")
    for path in (tmp_path / "street.pt", glb):
        with profiling.recording() as rec:
            scene = load_device_scene(path, device="cpu")
        records = rec.records()
        spans = [(s.name, s.parent) for s in records if isinstance(s, profiling.Span)]
        assert spans == [("rf.scene.read", None), ("rf.scene.tables", None),
                         ("rf.scene.upload", None)]
        depth = [(c.name, records.index(c)) for c in records if isinstance(c, Count)]
        assert depth == [(profiling.TREE_DEPTH, 2)]
        assert scene.num_triangles == sc.positions.shape[0]
    assert profiling.span("rf.scene.read") is profiling._OFF


# Two batches in a window of (0, 10) on the trace's clock: K4's items and
# fold kernels 6.0 s in it, a copy beside them.
K4_TRACE = trace.Trace(
    [("trace_regen_shaded_items_kernel", 0.5, 4.0), ("trace_regen_shaded_fold_kernel", 4.0, 4.5),
     ("copy", 4.5, 5.0), ("trace_regen_shaded_items_kernel", 6.0, 8.0), ("copy", 8.0, 9.0)],
    [], (0.0, 10.0))
FRAMES = [{"t0": 10.0, "t1": 11.0}, {"t0": 11.0, "t1": 12.0}]
RECORDS = [Count(WALK_RECORDS, 9.9, 7, 0), Count(WALK_RECORDS, 10.2, 2_000_000_000, 1),
           Count("rf.h2d_bytes", 10.3, 5, 1), Count(WALK_RECORDS, 11.5, 1_000_000_000, 2),
           Count(WALK_RECORDS, 12.1, 9, 3)]


@pytest.mark.parametrize("metric, want", [
    # 3e9 records in the window over 1e8 rays.
    ("walk_records_per_ray", 30.0),
    # 6.0 s of K4 over 3e9 records.
    ("k4_ns_per_record", 2.0),
])
def test_walk_counter_readers(monkeypatch, metric, want):
    """Each reader on a made-up trace and recorder, and None from a program
    without the counter (the parent of the counter) or without a recorder."""
    read = cells.load_module("metrics", metric).read
    monkeypatch.setattr(profiling, "PROFILED", types.SimpleNamespace(records=lambda: RECORDS))
    run = types.SimpleNamespace(trace=K4_TRACE, frames=FRAMES, rays=100_000_000)
    assert read(run) == pytest.approx(want)
    monkeypatch.setattr(profiling, "PROFILED", types.SimpleNamespace(
        records=lambda: [r for r in RECORDS if r.name != WALK_RECORDS]))
    assert read(run) is None
    monkeypatch.delattr(profiling, "PROFILED")
    assert read(run) is None


def test_street_cell_is_listed():
    """The cell reports what its configuration's path tracer reports, and
    the two new metrics read in the three path-tracer cells (and
    walk_tests_per_ray, which came later, in every path-tracer cell)."""
    bench = cells.benchmark()
    cell = cells.find("pt_converge_1080p_street", bench)
    assert [m["name"] for m in cell.end_to_end] == ["msamples_per_s", "setup_s"]
    names = {m["name"] for m in cell.per_layer}
    assert {"walk_records_per_ray", "k4_ns_per_record", "k4_roofline", "rays_per_sample",
            "device_idle.converge", "pt_idle_prep_ms", "pt_idle_image_ms",
            "h2d_mb_per_batch", "scene_load_s", "walk_tests_per_ray"} == names
    for name in ("pt_converge_1080p", "pt_converge_1080p_b8"):
        assert {"walk_records_per_ray", "k4_ns_per_record"} <= {
            m["name"] for m in cells.find(name, bench).per_layer}
    assert cell.mix["check_pixels"] == 128 and cell.mix["bounces"] == 4
    assert math.isclose(cell.mix["views"][0][0][1], 1.7)
