"""The CUDA kernels against their plain versions, on the card.

These need an NVIDIA GPU (sm_90a) and nvcc; without a CUDA device they skip.
On the GPU machine:

    python -m pytest tests/test_torch_cuda.py -m cuda -q --noconftest

(--noconftest: tests/conftest.py imports jax, which that machine lacks.)
"""

import dataclasses
import pathlib

import numpy as np
import pytest
import torch

from rayfinder_tpu_torch.scene.procedural import courtyard_scene

GOLDENS = pathlib.Path(__file__).resolve().parent / "goldens"

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def scene8(dev):
    from rayfinder_tpu_torch.render.scene import build_device_scene

    flat, textures = courtyard_scene(8)
    return build_device_scene(flat, textures=textures, device=dev)


@pytest.mark.parametrize("name", ["grouped_courtyard8", "flat_courtyard8"])
def test_walk_kernels_match_plain_walk_exactly(dev, scene8, name):
    from rayfinder_tpu_torch.ops import walk
    from rayfinder_tpu_torch.render.intersect import T_MAX

    g = np.load(GOLDENS / f"{name}.npz")
    o = torch.from_numpy(g["origins"]).to(dev)
    d = torch.from_numpy(g["directions"]).to(dev)
    before = walk.intersect_closest_kernel.launches
    got = walk.intersect_closest_kernel(scene8, o, d, T_MAX)
    assert walk.intersect_closest_kernel.launches == before + 1
    want = walk.intersect_closest_reference(scene8, o, d, T_MAX)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert torch.equal(walk.intersect_any_kernel(scene8, o, d, T_MAX),
                       walk.intersect_any_reference(scene8, o, d, T_MAX))


@pytest.mark.parametrize("scene_name", ["courtyard8", "deep", "one_triangle"])
def test_walk_kernels_equal_the_plane_walk(dev, scene8, scene_name):
    """K1 and K2 walk the packed tables; t, tri, nodes visited and occlusion
    must be the plane walk's bit for bit: against the plain plane walk (t,
    tri, nodes, occlusion), the counted walk K6 (t, tri, nodes), and their
    own plain version, to T_MAX and to per-ray bounds; on the courtyard, on
    a BVH deeper than the 32-entry stack and on a scene whose root is a
    leaf."""
    from torch_deep_scene import deep_rays, deep_scene, walked_with_32

    from rayfinder_tpu_torch.ops import counted, walk
    from rayfinder_tpu_torch.render import traverse
    from rayfinder_tpu_torch.render.intersect import T_MAX
    from rayfinder_tpu_torch.render.scene import build_device_scene
    from rayfinder_tpu_torch.scene import FlattenedScene

    if scene_name == "courtyard8":
        scene, (o, d) = scene8, _probe_rays(dev)
    else:
        flat, bvh = deep_scene()
        if scene_name == "one_triangle":
            flat, bvh = FlattenedScene(*(a[:1] for a in (
                flat.positions, flat.normals, flat.tex_coords, flat.texture_indices))), None
        scene = walked_with_32(build_device_scene(flat, bvh=bvh, device=dev))
        o, d = (torch.from_numpy(a).to(dev) for a in deep_rays(4096, seed=9))
    bound = torch.from_numpy(np.random.default_rng(2).uniform(0.5, 12.0, o.shape[0])
                             .astype(np.float32)).to(dev)
    for t_max in (T_MAX, bound):
        before = walk.intersect_closest_kernel.launches, walk.intersect_any_kernel.launches
        hit, t, tri, visits = walk.intersect_closest_kernel(scene, o, d, t_max)
        occ = walk.intersect_any_kernel(scene, o, d, t_max)
        assert (walk.intersect_closest_kernel.launches,
                walk.intersect_any_kernel.launches) == (before[0] + 1, before[1] + 1)
        assert bool(hit.any())
        _, t6, tri6, counts6 = counted.intersect_closest_counted(scene, o, d, t_max)
        assert torch.equal(t, t6) and torch.equal(tri, tri6)
        assert torch.equal(visits, counts6[:, 0])
        for a, b in zip((hit, t, tri, visits), traverse.intersect_closest(scene, o, d, t_max)):
            assert torch.equal(a, b)
        assert torch.equal(occ, traverse.intersect_any(scene, o, d, t_max))
        for a, b in zip((hit, t, tri, visits),
                        walk.intersect_closest_reference(scene, o, d, t_max)):
            assert torch.equal(a, b)
        assert torch.equal(occ, walk.intersect_any_reference(scene, o, d, t_max))


def test_walk_kernels_need_the_packed_tables(dev, scene8):
    """K1 and K2 read only the packed walk tables: a scene without them
    raises, and nothing falls back to the plane walk."""
    import dataclasses

    from rayfinder_tpu_torch.ops import walk

    o, d = _probe_rays(dev, 64)
    for broken, error in ((dict(bvh_nodes2=scene8.bvh_nodes2[:0]), ValueError),
                          (dict(tri_pos4=None), TypeError)):
        scene = dataclasses.replace(scene8, **broken)
        before = walk.intersect_closest_kernel.launches, walk.intersect_any_kernel.launches
        with pytest.raises(error, match="scene.bvh_nodes2|scene.tri_pos4"):
            walk.intersect_closest_kernel(scene, o, d, 1e4)
        with pytest.raises(error, match="scene.bvh_nodes2|scene.tri_pos4"):
            walk.intersect_any_kernel(scene, o, d, 1e4)
        assert (walk.intersect_closest_kernel.launches,
                walk.intersect_any_kernel.launches) == before


def test_walk_kernel_rejects_bad_input(dev, scene8):
    from rayfinder_tpu_torch.ops import walk

    o = torch.zeros(8, 3, device=dev, dtype=torch.float64)
    with pytest.raises(TypeError, match="dtype"):
        walk.intersect_closest_kernel(scene8, o, o, 1e4)
    with pytest.raises(ValueError, match="on cpu"):
        walk.intersect_any_kernel(scene8.to("cpu"), torch.zeros(8, 3, device=dev),
                                  torch.ones(8, 3, device=dev), 1e4)


def test_render_kernel_matches_plain_and_golden(dev, scene8):
    from rayfinder_tpu_torch.ops.regen import trace_regen
    from rayfinder_tpu_torch.render.camera import create_camera
    from rayfinder_tpu_torch.render.pathtracer import accumulate_samples_regen
    from rayfinder_tpu_torch.render.rng import blue_noise_tile
    from rayfinder_tpu_torch.render.tiling import unswizzle
    from rayfinder_tpu_torch.render.tonemap import tonemap
    from rayfinder_tpu_torch.sky.model import sky_state_from_ui

    w, h, spp = 128, 96, 8
    cam = create_camera([-16.0, 5.0, 0.0], [12.0, 2.0, 0.0], 0.0, 1.0, 70.0, w / h)
    sky = sky_state_from_ui(2.5, (0.3, 0.3, 0.3), 35.0, 25.0)
    tile = torch.from_numpy(blue_noise_tile()).to(dev)
    images, counts = {}, {}
    for engine in ("kernel", "plain"):
        before = trace_regen.launches
        accum, rays = accumulate_samples_regen(
            scene8, sky, cam, tile, 0, torch.zeros(w * h, 3, device=dev), width=w,
            height=h, num_bounces=4, spp=spp, num_frames=spp, engine=engine, count_rays=True,
            inkernel=False)
        assert (trace_regen.launches > before) == (engine == "kernel")
        images[engine] = tonemap(unswizzle(accum, w, h) / float(spp), 0.25).reshape(h, w, 3).cpu().numpy()
        counts[engine] = rays.cpu().numpy()
    golden = np.load(GOLDENS / "courtyard_untextured_128x96_8spp.npz")
    assert np.sqrt(np.mean((images["kernel"] - images["plain"]) ** 2)) < 1e-3
    assert np.sqrt(np.mean((images["kernel"] - golden["image"]) ** 2)) < 5e-3
    np.testing.assert_allclose(counts["kernel"], counts["plain"], rtol=1e-3)


@pytest.fixture(scope="module")
def textured4(dev):
    from rayfinder_tpu_torch.render.scene import build_device_scene

    flat, textures = courtyard_scene(4, textured=True)
    return build_device_scene(flat, textures=textures, device=dev)


@pytest.mark.parametrize("route", [dict(inkernel=True), dict(inkernel=True, compact_floor=16),
                                   dict(segs=2), dict(segs=4)])
def test_route_kernels_match_plain(dev, textured4, route):
    """K4 (inkernel: one call, and the hybrid) and K5 (segs) through their
    routes on the textured courtyard: kernel against plain on the card, and
    against the split route, radiance and ray counts (K4 counts its
    own)."""
    from rayfinder_tpu_torch.ops.regen_segs import trace_regen_segs
    from rayfinder_tpu_torch.ops.regen_shaded import trace_regen_shaded
    from rayfinder_tpu_torch.render.camera import create_camera
    from rayfinder_tpu_torch.render.pathtracer import accumulate_samples_regen
    from rayfinder_tpu_torch.render.rng import blue_noise_tile
    from rayfinder_tpu_torch.sky.model import sky_state_from_ui

    w, h, spp = 64, 48, 4
    cam = create_camera([-16.0, 5.0, 0.0], [12.0, 2.0, 0.0], 0.2, 12.0, 70.0, w / h)
    sky = sky_state_from_ui(2.5, (0.3, 0.3, 0.3), 35.0, 25.0)
    tile = torch.from_numpy(blue_noise_tile()).to(dev)

    def run(engine, **kw):
        return accumulate_samples_regen(
            textured4, sky, cam, tile, 0, torch.zeros(w * h, 3, device=dev), width=w,
            height=h, num_bounces=4, spp=spp, num_frames=spp, engine=engine, count_rays=True,
            **kw)

    launches = trace_regen_shaded.launches + trace_regen_segs.launches
    kernel, k_rays = run("kernel", **route)
    assert trace_regen_shaded.launches + trace_regen_segs.launches > launches
    plain, p_rays = run("plain", **route)
    split, s_rays = run("plain", inkernel=False)
    torch.testing.assert_close(kernel, plain, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(kernel, split, rtol=1e-5, atol=1e-5)
    assert torch.equal(k_rays, p_rays) and torch.equal(k_rays, s_rays)


@pytest.mark.parametrize("route", [dict(), dict(inkernel=True, compact_floor=16)])
def test_k4_walk_records_equal_plain(dev, textured4, route):
    """K4 counts the interior records its walks read (closest and shadow),
    the work items at floor 0 (the default route) and the tile kernel above
    it (the hybrid's compacted phases): the same count as its plain version
    on the textured courtyard, beside equal ray counts."""
    from rayfinder_tpu_torch.render.camera import create_camera
    from rayfinder_tpu_torch.render.pathtracer import accumulate_samples_regen
    from rayfinder_tpu_torch.render.rng import blue_noise_tile
    from rayfinder_tpu_torch.sky.model import sky_state_from_ui

    w, h, spp = 64, 48, 4
    cam = create_camera([-16.0, 5.0, 0.0], [12.0, 2.0, 0.0], 0.0, 1.0, 70.0, w / h)
    sky = sky_state_from_ui(2.5, (0.3, 0.3, 0.3), 35.0, 25.0)
    tile = torch.from_numpy(blue_noise_tile()).to(dev)
    counted = {}
    for engine in ("kernel", "plain"):
        records = torch.zeros(1, dtype=torch.int64, device=dev)
        _, rays = accumulate_samples_regen(
            textured4, sky, cam, tile, 0, torch.zeros(w * h, 3, device=dev), width=w,
            height=h, num_bounces=4, spp=spp, num_frames=spp, engine=engine, count_rays=True,
            walk_records=records, **route)
        counted[engine] = (rays.tolist(), int(records))
    assert counted["kernel"] == counted["plain"] and counted["kernel"][1] > 0


def _regen(scene, dev, w, h, spp, engine="kernel", start=None, frame_base=0, **kw):
    """One dispatch of the bench view through accumulate_samples_regen, with
    exact ray counts."""
    from rayfinder_tpu_torch.render.camera import create_camera
    from rayfinder_tpu_torch.render.pathtracer import accumulate_samples_regen
    from rayfinder_tpu_torch.render.rng import blue_noise_tile
    from rayfinder_tpu_torch.sky.model import sky_state_from_ui

    cam = create_camera([-16.0, 5.0, 0.0], [12.0, 2.0, 0.0], 0.0, 1.0, 70.0, w / h)
    sky = sky_state_from_ui(2.5, (0.3, 0.3, 0.3), 35.0, 25.0)
    tile = torch.from_numpy(blue_noise_tile()).to(dev)
    start = torch.zeros(w * h, 3, device=dev) if start is None else start
    return accumulate_samples_regen(
        scene, sky, cam, tile, frame_base, start, width=w, height=h, num_bounces=4,
        spp=spp + frame_base, num_frames=spp, engine=engine, count_rays=True, **kw)


def test_default_route_is_one_shaded_call_with_the_split_counts(dev, scene8):
    """With no route keyword a dispatch is one K4 call and no K3 or K5
    call; K4's ray counters give the split route's counts, as does the
    hybrid (phase 0's split counts plus K4's)."""
    from rayfinder_tpu_torch.ops.regen import trace_regen
    from rayfinder_tpu_torch.ops.regen_segs import trace_regen_segs
    from rayfinder_tpu_torch.ops.regen_shaded import trace_regen_shaded

    w, h, spp = 128, 96, 8
    before = trace_regen.launches, trace_regen_shaded.launches, trace_regen_segs.launches
    accum, rays = _regen(scene8, dev, w, h, spp)
    assert (trace_regen.launches, trace_regen_shaded.launches,
            trace_regen_segs.launches) == (before[0], before[1] + 1, before[2])
    split, split_rays = _regen(scene8, dev, w, h, spp, inkernel=False)
    assert trace_regen.launches > before[0]
    assert rays.dtype == torch.int64 and torch.equal(rays, split_rays)
    torch.testing.assert_close(accum, split, rtol=1e-5, atol=1e-5)
    for floor in (1024, 128):
        hybrid, hybrid_rays = _regen(scene8, dev, w, h, spp, inkernel=True, compact_floor=floor)
        assert torch.equal(hybrid_rays, split_rays)
        torch.testing.assert_close(hybrid, split, rtol=1e-5, atol=1e-5)
    golden = np.load(GOLDENS / "courtyard_untextured_128x96_8spp.npz")
    assert rays.tolist() == golden["rays"].tolist()


def test_capped_dispatch_equals_uncapped(dev, scene8, monkeypatch):
    """A dispatch whose K4 scratch would pass the cap runs in runs of
    samples and equals the uncapped dispatch bit for bit; a single call over
    the cap raises and launches nothing."""
    from rayfinder_tpu_torch.ops import regen_shaded
    from rayfinder_tpu_torch.render import pathtracer as pt

    w, h, spp = 64, 48, 8
    start = torch.rand(w * h, 3, device=dev)
    want, want_rays = _regen(scene8, dev, w, h, spp, start=start, frame_base=2)
    monkeypatch.setattr(regen_shaded, "SCRATCH_CAP_BYTES", 12 * w * h * 3)
    before = regen_shaded.trace_regen_shaded.launches
    got, rays = _regen(scene8, dev, w, h, spp, start=start, frame_base=2)
    assert regen_shaded.trace_regen_shaded.launches == before + 3  # 3 + 3 + 2 samples
    assert torch.equal(got, want) and torch.equal(rays, want_rays)

    disp, lanes = _path_state(scene8, dev, w, h, spp)
    st = pt._initial_state(disp, lanes, w * h, dev)
    before = regen_shaded.trace_regen_shaded.launches
    with pytest.raises(ValueError, match="over the cap"):
        regen_shaded.trace_regen_shaded(*_shaded_args(disp, lanes, st, start, 0))
    assert regen_shaded.trace_regen_shaded.launches == before
    # Above floor 0 there is no scratch, and no cap.
    regen_shaded.trace_regen_shaded(*_shaded_args(disp, lanes, st, start, 8))


def _probe_rays(dev, n=4096, seed=21):
    """Camera rays of the bench view and random rays inside the courtyard."""
    from rayfinder_tpu_torch.render.camera import create_camera, primary_ray

    rng = np.random.default_rng(seed)
    half = n // 2
    cam = create_camera([-16.0, 5.0, 0.0], [12.0, 2.0, 0.0], 0.0, 1.0, 70.0, 1.0)
    u, v = (torch.from_numpy(a).to(dev) for a in rng.uniform(size=(2, half)).astype(np.float32))
    noise = torch.from_numpy(rng.uniform(size=(half, 2)).astype(np.float32)).to(dev)
    co, cd = primary_ray(cam, u, v, noise, (1.0 / 64, 1.0 / 64))
    ro = np.stack([rng.uniform(-19, 19, half), rng.uniform(0.5, 11, half),
                   rng.uniform(-9, 9, half)], axis=1).astype(np.float32)
    rd = rng.normal(size=(half, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    return (torch.cat([co, torch.from_numpy(ro).to(dev)]).contiguous(),
            torch.cat([cd, torch.from_numpy(rd).to(dev)]).contiguous())


def test_counted_kernel_matches_plain_and_k1(dev, scene8):
    """K6 against its plain version (t, tri, all counts) and against K1 (t,
    tri, nodes visited), exactly."""
    from rayfinder_tpu_torch.ops import counted, walk
    from rayfinder_tpu_torch.render.intersect import T_MAX

    o, d = _probe_rays(dev)
    before = counted.intersect_closest_counted.launches
    got = counted.intersect_closest_counted(scene8, o, d, T_MAX)
    assert counted.intersect_closest_counted.launches == before + 1
    want = counted.intersect_closest_counted_reference(scene8, o, d, T_MAX)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    k1 = walk.intersect_closest_kernel(scene8, o, d, T_MAX)
    for a, b in zip(got[:3], k1[:3]):
        assert torch.equal(a, b)
    assert torch.equal(got[3][:, 0], k1[3])


@pytest.mark.parametrize("scene_name", ["deep", "one_triangle"])
def test_counted_kernel_walks_a_deep_and_a_one_leaf_scene(dev, scene_name):
    """K6 is K1's kernel at counting level 2: t, tri and all three counts
    equal the plain plane walk's (intersect_closest_counted), and t, tri and
    nodes equal K1's, to T_MAX and to per-ray bounds, on a BVH deeper than
    the 32-entry stack and on a scene whose root is a leaf."""
    from torch_deep_scene import deep_rays, deep_scene, walked_with_32

    from rayfinder_tpu_torch.ops import counted, walk
    from rayfinder_tpu_torch.render.intersect import T_MAX
    from rayfinder_tpu_torch.render.scene import build_device_scene
    from rayfinder_tpu_torch.scene import FlattenedScene

    flat, bvh = deep_scene()
    if scene_name == "one_triangle":
        flat, bvh = FlattenedScene(*(a[:1] for a in (
            flat.positions, flat.normals, flat.tex_coords, flat.texture_indices))), None
    scene = walked_with_32(build_device_scene(flat, bvh=bvh, device=dev))
    o, d = (torch.from_numpy(a).to(dev) for a in deep_rays(4096, seed=9))
    bound = torch.from_numpy(np.random.default_rng(2).uniform(0.5, 12.0, o.shape[0])
                             .astype(np.float32)).to(dev)
    for t_max in (T_MAX, bound):
        got = counted.intersect_closest_counted(scene, o, d, t_max)
        assert bool(got[0].any())
        for a, b in zip(got, counted.intersect_closest_counted_reference(scene, o, d, t_max)):
            assert torch.equal(a, b)
        k1 = walk.intersect_closest_kernel(scene, o, d, t_max)
        for a, b in zip(got[:3], k1[:3]):
            assert torch.equal(a, b)
        assert torch.equal(got[3][:, 0], k1[3])


def test_counted_and_sky_round_kernels_need_the_packed_tables(dev, scene8):
    """K6 and K8 read only the packed walk tables: a scene without them
    raises, and nothing falls back to the plane walk."""
    import dataclasses

    from rayfinder_tpu_torch.ops import counted
    from rayfinder_tpu_torch.ops.skyround import sky_round

    o, d = _probe_rays(dev, 64)
    args = _sky_args(scene8, dev)[1:]
    for broken, error in ((dict(bvh_nodes2=scene8.bvh_nodes2[:0]), ValueError),
                          (dict(tri_pos4=None), TypeError)):
        scene = dataclasses.replace(scene8, **broken)
        before = counted.intersect_closest_counted.launches, sky_round.launches
        with pytest.raises(error, match="scene.bvh_nodes2|scene.tri_pos4"):
            counted.intersect_closest_counted(scene, o, d, 1e4)
        for mode in ("full", "fullwhile"):
            with pytest.raises(error, match="scene.bvh_nodes2|scene.tri_pos4"):
                sky_round(scene, *args, 4, mode)
        assert (counted.intersect_closest_counted.launches, sky_round.launches) == before


@pytest.mark.parametrize("group,with_group_min", [(128, True), (7, True), (128, False),
                                                  (100, True)])
def test_slab_kernel_matches_plain(dev, group, with_group_min):
    """K7's need, group minima and selection against its plain version,
    exactly, with flat boxes and axis-parallel rays (NaN slab terms)."""
    from rayfinder_tpu_torch.ops.slab import slab_entry_reduce, slab_entry_reduce_reference

    rng = np.random.default_rng(group)
    m, n = 1001, 3000
    lo = rng.uniform(-4, 4, (m, 3)).astype(np.float32)
    hi = lo + rng.uniform(0.0, 2.0, (m, 3)).astype(np.float32)
    hi[::7, 1] = lo[::7, 1]
    o = rng.uniform(-6, 6, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[rng.random((n, 3)) < 1 / 3] = 0.0
    d[np.all(d == 0, axis=1), 2] = 1.0
    o[::5, 0] = lo[rng.integers(0, m, o[::5].shape[0]), 0]
    with np.errstate(divide="ignore"):
        inv = (np.float32(1.0) / d).astype(np.float32)
    bound = rng.uniform(0.5, 12.0, n).astype(np.float32)
    weight = rng.integers(1, 3, m).astype(np.int32)
    args = [torch.from_numpy(a).to(dev) for a in (lo, hi, weight, o, inv, bound)]
    before = slab_entry_reduce.launches
    got = slab_entry_reduce(*args, group, with_group_min)
    assert slab_entry_reduce.launches == before + 1
    want = slab_entry_reduce_reference(*args, group, with_group_min)
    for a, b in zip(got, want):
        assert (a is None and b is None) or torch.equal(a, b)
    assert bool((got[2] >= 0).any()) and bool((got[2] == -1).any())


@pytest.mark.parametrize("n", [1, 127, 130])
def test_slab_kernel_ragged_ray_tile(dev, n):
    """K7 holds several rays per thread: ray counts that leave its last
    register tile and its last block ragged, with a group (7) and a box
    count (300) that divide neither each other nor the staged chunk."""
    from rayfinder_tpu_torch.ops.slab import slab_entry_reduce, slab_entry_reduce_reference

    rng = np.random.default_rng(n)
    m = 300
    lo = rng.uniform(-4, 4, (m, 3)).astype(np.float32)
    hi = lo + rng.uniform(0.0, 2.0, (m, 3)).astype(np.float32)
    o = rng.uniform(-6, 6, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[rng.random((n, 3)) < 1 / 4] = 0.0
    d[np.all(d == 0, axis=1), 2] = 1.0
    with np.errstate(divide="ignore"):
        inv = (np.float32(1.0) / d).astype(np.float32)
    bound = rng.uniform(0.5, 12.0, n).astype(np.float32)
    weight = rng.integers(1, 3, m).astype(np.int32)
    args = [torch.from_numpy(a).to(dev) for a in (lo, hi, weight, o, inv, bound)]
    before = slab_entry_reduce.launches
    got = slab_entry_reduce(*args, 7, True)
    assert slab_entry_reduce.launches == before + 1
    for a, b in zip(got, slab_entry_reduce_reference(*args, 7, True)):
        assert torch.equal(a, b)


def _sky_args(scene, dev, lanes=256):
    """K8's arguments before rounds and mode: 3 x `lanes` lanes across the
    bench view at three heights, meeting sky and geometry."""
    from rayfinder_tpu_torch.render.camera import create_camera
    from rayfinder_tpu_torch.sky.model import sky_state_from_ui

    u = torch.from_numpy(np.tile(np.linspace(0.05, 0.95, lanes, dtype=np.float32), 3)).to(dev)
    v = torch.from_numpy(np.repeat(np.asarray([0.05, 0.3, 0.6], np.float32), lanes)).to(dev)
    nb = torch.tensor([0.25, 0.75], device=dev).expand(3 * lanes, 2).contiguous()
    return (scene, create_camera([-16.0, 5.0, 0.0], [12.0, 2.0, 0.0], 0.0, 1.0, 70.0, 4 / 3),
            sky_state_from_ui(1.0, (1.0, 1.0, 1.0), 30.0, 0.0), u, v, nb,
            (float(np.float32(1) / np.float32(800)), float(np.float32(1) / np.float32(600))))


@pytest.mark.parametrize("mode", ["full", "nosweep", "sweeponly", "noop", "fullwhile"])
def test_sky_round_kernel_matches_plain(dev, scene8, mode):
    """K8 against its plain version on lanes that meet sky and geometry;
    the same device functions and the same order of operations, so equal
    to float32 rounding (rtol 1e-5 states the budget, 0 is expected)."""
    from rayfinder_tpu_torch.ops.skyround import sky_round, sky_round_reference

    args = _sky_args(scene8, dev)
    before = sky_round.launches
    got = sky_round(*args, 4, mode)
    assert sky_round.launches == before + 1
    want = sky_round_reference(*args, 4, mode)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=0)


@pytest.mark.parametrize("mode", ["full", "nosweep", "sweeponly", "noop", "fullwhile"])
def test_sky_round_kernel_twice_is_equal(dev, scene8, mode):
    """In full, nosweep and sweeponly a warp takes a lane and its threads
    the lane's rounds, so no output may depend on which warp ran when: two
    launches equal each other bit for bit, at rounds that fill one, two and
    a part of a third group of 32, and equal the plain version at rtol 1e-5."""
    from rayfinder_tpu_torch.ops.skyround import sky_round, sky_round_reference

    args = _sky_args(scene8, dev, lanes=64)
    for rounds in (1, 32, 70):
        got = sky_round(*args, rounds, mode)
        assert torch.equal(got, sky_round(*args, rounds, mode))
        torch.testing.assert_close(got, sky_round_reference(*args, rounds, mode), rtol=1e-5,
                                   atol=0)


def test_hybrid_last_call_over_the_cap_equals_uncapped(dev, scene8, monkeypatch):
    """The hybrid at 512x512, one 256-sample dispatch, compact_floor 131,072:
    its last K4 call (floor 0 over 131,072 lanes in flight, a scratch of
    402,653,184 bytes) runs in chunks of whole tiles under the cap, equals
    the same dispatch with the cap lifted bit for bit, and counts the split
    route's rays."""
    from rayfinder_tpu_torch.ops import regen_shaded

    w, h, spp, floor = 512, 512, 256, 131_072
    cap = regen_shaded.SCRATCH_CAP_BYTES
    assert 12 * floor * spp > cap
    before = regen_shaded.trace_regen_shaded.launches
    got, rays = _regen(scene8, dev, w, h, spp, inkernel=True, compact_floor=floor)
    assert regen_shaded.trace_regen_shaded.launches == before + 2
    monkeypatch.setattr(regen_shaded, "SCRATCH_CAP_BYTES", 12 * floor * spp)
    want, want_rays = _regen(scene8, dev, w, h, spp, inkernel=True, compact_floor=floor)
    assert torch.equal(got, want) and torch.equal(rays, want_rays)
    _, split_rays = _regen(scene8, dev, w, h, spp, inkernel=False)
    assert torch.equal(rays, split_rays)


def _path_state(scene, dev, w=64, h=48, spp=8):
    """A dispatch over the w x h image of the bench view, its lane inputs,
    and the state after one split step of the plain route (NEE samples
    pending, scatter rays and fresh primaries mixed)."""
    from rayfinder_tpu_torch.render import pathtracer as pt
    from rayfinder_tpu_torch.render.camera import create_camera
    from rayfinder_tpu_torch.render.rng import blue_noise_tile
    from rayfinder_tpu_torch.render.tiling import block_order
    from rayfinder_tpu_torch.sky.model import sky_state_from_ui

    sky = sky_state_from_ui(2.5, (0.3, 0.3, 0.3), 35.0, 25.0)
    ys, xs, _ = block_order(w, h)
    ys, xs = torch.from_numpy(ys).to(dev), torch.from_numpy(xs).to(dev)
    tile = torch.from_numpy(blue_noise_tile()).to(dev)
    lanes = dict(u=(xs.float() + 0.5) / w, v_tex=(ys.float() + 0.5) / h,
                 noise_base=tile[(ys % 128).long(), (xs % 128).long()].contiguous())
    disp = pt._Dispatch(
        scene=scene, sky=sky,
        camera=create_camera([-16.0, 5.0, 0.0], [12.0, 2.0, 0.0], 0.0, 1.0, 70.0, w / h),
        kernels=pt._ENGINES["plain"],
        inv_dims=(float(np.float32(1) / np.float32(w)), float(np.float32(1) / np.float32(h))),
        frame_base=0, spp=spp, nf=spp, num_bounces=4)
    return disp, lanes


def test_split_kernel_equals_plain_on_every_output(dev, scene8):
    """K3 over the packed walk tables against its plain version (the walk of
    the SoA planes), bit for bit."""
    from rayfinder_tpu_torch.ops.regen import trace_regen, trace_regen_reference
    from rayfinder_tpu_torch.render import pathtracer as pt
    from rayfinder_tpu_torch.render.intersect import T_MAX

    disp, lanes = _path_state(scene8, dev)
    st = pt._initial_state(disp, lanes, lanes["u"].shape[0], dev)
    lrad, _ = disp.split_step(st, lanes, torch.zeros(lanes["u"].shape[0], 3, device=dev))
    assert bool((st["flag"] > 0).any())
    args = (*disp.pixel_args(lanes), T_MAX, st["sample"], st["bounce"], st["flag"],
            st["origin"], st["direction"], st["thr"], st["srad"], lrad, st["shadow_o"],
            st["shadow_d"], st["contrib"])
    before = trace_regen.launches
    got = trace_regen(*args)
    assert trace_regen.launches == before + 1
    for a, b in zip(got, trace_regen_reference(*args)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("segs", [2, 3, 4])
def test_segs_kernel_equals_plain_on_every_output(dev, scene8, segs):
    """K5 over the packed walk tables against its plain version, bit for
    bit."""
    from rayfinder_tpu_torch.ops.regen_segs import trace_regen_segs, trace_regen_segs_reference
    from rayfinder_tpu_torch.render import pathtracer as pt
    from rayfinder_tpu_torch.render.intersect import T_MAX

    disp, lanes = _path_state(scene8, dev)
    n = lanes["u"].shape[0]
    st = pt._initial_slots(disp, lanes, n, segs, dev)
    lrad, flags = disp.segs_step(st, lanes, torch.zeros(n, 3, device=dev))
    assert bool((flags > 0).any())
    args = (*disp.pixel_args(lanes), T_MAX, st["salloc"], lrad, st["cnt"], st["ray"],
            st["thr"], st["nee"])
    before = trace_regen_segs.launches
    got = trace_regen_segs(*args)
    assert trace_regen_segs.launches == before + 1
    for a, b in zip(got, trace_regen_segs_reference(*args)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("segs", [1, 2, 3, 4])
def test_path_kernels_walk_a_deep_and_a_one_leaf_scene(dev, segs):
    """K3 (segs 1) and K5 (segs 2-4) on a BVH deeper than the 32-entry
    stack (the stack overflows) and on a one-triangle scene (the root is a
    leaf), against their plain versions, every slot's closest-hit and
    shadow ray through the chain."""
    from torch_deep_scene import bvh_depth, deep_rays, deep_scene, walked_with_32

    from rayfinder_tpu_torch.ops.regen import trace_regen, trace_regen_reference
    from rayfinder_tpu_torch.ops.regen_segs import trace_regen_segs, trace_regen_segs_reference
    from rayfinder_tpu_torch.render import pathtracer as pt
    from rayfinder_tpu_torch.render.intersect import T_MAX
    from rayfinder_tpu_torch.render.scene import build_device_scene
    from rayfinder_tpu_torch.scene import FlattenedScene

    flat, bvh = deep_scene()
    deep = walked_with_32(build_device_scene(flat, bvh=bvh, device=dev))
    assert bvh_depth(bvh.triangle_count, bvh.second_child_offset) > 32
    one = FlattenedScene(positions=flat.positions[:1], normals=flat.normals[:1],
                         tex_coords=flat.tex_coords[:1], texture_indices=flat.texture_indices[:1])
    for scene in (deep, build_device_scene(one, device=dev)):
        disp, lanes = _path_state(scene, dev)
        n = lanes["u"].shape[0]
        # Closest-hit and shadow rays through the chain, half of them -x.
        o, d = (torch.from_numpy(a).to(dev) for a in deep_rays(n * segs, seed=3))
        ones = torch.ones(n * segs, 3, device=dev)
        if segs == 1:
            st = pt._initial_state(disp, lanes, n, dev)
            args = (*disp.pixel_args(lanes), T_MAX, st["sample"], st["bounce"],
                    torch.ones_like(st["flag"]), o, d, ones, st["srad"],
                    torch.zeros(n, 3, device=dev), o, d, ones)
            kernel, reference = trace_regen, trace_regen_reference
        else:
            st = pt._initial_slots(disp, lanes, n, segs, dev)
            st["cnt"][:, 2::3] = 1  # every slot's NEE sample pending
            args = (*disp.pixel_args(lanes), T_MAX, st["salloc"], torch.zeros(n, 3, device=dev),
                    st["cnt"], torch.cat([o, d], 1).reshape(n, 6 * segs), st["thr"],
                    torch.cat([o, d, ones], 1).reshape(n, 9 * segs))
            kernel, reference = trace_regen_segs, trace_regen_segs_reference
        got = kernel(*args)
        tri = got[-1] if segs == 1 else got[2][:, 2::3]
        assert bool((tri >= 0).any())
        for a, b in zip(got, reference(*args)):
            assert torch.equal(a, b)


K4_STATE = ("sample", "bounce", "flag", "origin", "direction", "thr", "srad", "lrad",
            "shadow_o", "shadow_d", "contrib")


def _assert_held(got, want):
    """K4 against its plain version: at least 99.9% of lanes with equal
    integer state (sample, bounce, flag), and on those lanes every float
    within rtol 1e-4 / atol 1e-4 (the shade's sin, cos and pow differ in the
    last place between the kernel and torch)."""
    same = (got[0] == want[0]) & (got[1] == want[1]) & (got[2] == want[2])
    assert float(same.float().mean()) >= 0.999
    for name, a, b in zip(K4_STATE[3:], got[3:], want[3:]):
        torch.testing.assert_close(a[same], b[same], rtol=1e-4, atol=1e-4, msg=name)


def _shaded_args(disp, lanes, st, lrad, floor):
    from rayfinder_tpu_torch.render.intersect import T_MAX

    return (*disp.pixel_args(lanes), disp.num_bounces, floor, T_MAX, st["sample"], st["bounce"],
            st["flag"], st["origin"], st["direction"], st["thr"], st["srad"], lrad,
            st["shadow_o"], st["shadow_d"], st["contrib"])


@pytest.mark.parametrize("floor", [0, 40])
def test_shaded_kernel_matches_plain(dev, scene8, floor):
    """K4 over the packed walk tables against its plain version, from the
    state after one split step (NEE samples pending): the work-item loop at
    floor 0, the tile rule at a floor of 40 lanes per tile. Then again from
    the in-flight state the floor-40 call returns, down to floor 0."""
    from rayfinder_tpu_torch.ops.regen_shaded import (
        trace_regen_shaded, trace_regen_shaded_reference,
    )
    from rayfinder_tpu_torch.render import pathtracer as pt

    disp, lanes = _path_state(scene8, dev)
    n = lanes["u"].shape[0]
    st = pt._initial_state(disp, lanes, n, dev)
    lrad, _ = disp.split_step(st, lanes, torch.zeros(n, 3, device=dev))
    assert bool((st["flag"] > 0).any())
    args = _shaded_args(disp, lanes, st, lrad, floor)
    before = trace_regen_shaded.launches
    got = trace_regen_shaded(*args)
    assert trace_regen_shaded.launches == before + 1
    want = trace_regen_shaded_reference(*args)
    _assert_held(got, want)
    live = (got[0] < disp.nf).view(-1, 128).sum(1)
    if floor:
        assert bool((live <= floor).all()) and bool((live > 0).any())
        assert torch.equal(got[0], want[0])  # the survivors per tile
        rest = dict(zip(K4_STATE, want))
        args0 = _shaded_args(disp, lanes, rest, rest["lrad"], 0)
        _assert_held(trace_regen_shaded(*args0), trace_regen_shaded_reference(*args0))
    else:
        assert not bool(live.any())


def test_shaded_kernel_twice_is_equal(dev, scene8):
    """At floor 0 the lanes take their work items in an order that varies
    from launch to launch; no output may."""
    from rayfinder_tpu_torch.ops.regen_shaded import trace_regen_shaded
    from rayfinder_tpu_torch.render import pathtracer as pt

    disp, lanes = _path_state(scene8, dev, 128, 96)
    n = lanes["u"].shape[0]
    st = pt._initial_state(disp, lanes, n, dev)
    args = _shaded_args(disp, lanes, st, torch.zeros(n, 3, device=dev), 0)
    first = trace_regen_shaded(*args)
    for _ in range(3):
        for a, b in zip(first, trace_regen_shaded(*args)):
            assert torch.equal(a, b)


@pytest.mark.parametrize("floor", [0, 40])
def test_shaded_kernel_walks_a_deep_and_a_one_leaf_scene(dev, floor):
    """K4 on a BVH deeper than the 32-entry stack and on a one-triangle
    scene (the root is a leaf), against its plain version: every lane's
    pending shadow ray and first closest-hit ray go through the chain."""
    from torch_deep_scene import bvh_depth, deep_rays, deep_scene, walked_with_32

    from rayfinder_tpu_torch.ops.regen_shaded import (
        trace_regen_shaded, trace_regen_shaded_reference,
    )
    from rayfinder_tpu_torch.render import pathtracer as pt
    from rayfinder_tpu_torch.render.scene import build_device_scene
    from rayfinder_tpu_torch.scene import FlattenedScene

    flat, bvh = deep_scene()
    deep = walked_with_32(build_device_scene(flat, bvh=bvh, device=dev))
    assert bvh_depth(bvh.triangle_count, bvh.second_child_offset) > 32
    one = FlattenedScene(positions=flat.positions[:1], normals=flat.normals[:1],
                         tex_coords=flat.tex_coords[:1], texture_indices=flat.texture_indices[:1])
    for scene in (deep, build_device_scene(one, device=dev)):
        disp, lanes = _path_state(scene, dev)
        n = lanes["u"].shape[0]
        o, d = (torch.from_numpy(a).to(dev) for a in deep_rays(n, seed=3))
        st = pt._initial_state(disp, lanes, n, dev)
        st.update(flag=torch.ones_like(st["flag"]), origin=o, direction=d, shadow_o=o,
                  shadow_d=d, contrib=torch.ones(n, 3, device=dev))
        args = _shaded_args(disp, lanes, st, torch.zeros(n, 3, device=dev), floor)
        got = trace_regen_shaded(*args)
        assert bool((got[7] != 0).any())
        _assert_held(got, trace_regen_shaded_reference(*args))


def test_path_kernels_need_the_packed_tables(dev, scene8):
    """K3, K4 and K5 read only the packed walk tables: a scene without them
    raises, and nothing falls back to the plane walk."""
    import dataclasses

    from rayfinder_tpu_torch.ops.regen import trace_regen
    from rayfinder_tpu_torch.ops.regen_segs import trace_regen_segs
    from rayfinder_tpu_torch.ops.regen_shaded import trace_regen_shaded
    from rayfinder_tpu_torch.render import pathtracer as pt
    from rayfinder_tpu_torch.render.intersect import T_MAX

    disp, lanes = _path_state(scene8, dev, 16, 16)
    n = lanes["u"].shape[0]
    st = pt._initial_state(disp, lanes, n, dev)
    slots = pt._initial_slots(disp, lanes, n, 2, dev)
    z3 = torch.zeros(n, 3, device=dev)
    for broken, error in ((dict(bvh_nodes2=scene8.bvh_nodes2[:0]), ValueError),
                          (dict(tri_pos4=None), TypeError)):
        scene = dataclasses.replace(scene8, **broken)
        pix = (scene, *disp.pixel_args(lanes)[1:], T_MAX)
        before = trace_regen.launches, trace_regen_segs.launches, trace_regen_shaded.launches
        with pytest.raises(error, match="scene.bvh_nodes2|scene.tri_pos4"):
            trace_regen(*pix, st["sample"], st["bounce"], st["flag"], st["origin"],
                        st["direction"], st["thr"], st["srad"], z3, st["shadow_o"],
                        st["shadow_d"], st["contrib"])
        with pytest.raises(error, match="scene.bvh_nodes2|scene.tri_pos4"):
            trace_regen_segs(*pix, slots["salloc"], z3, slots["cnt"], slots["ray"],
                             slots["thr"], slots["nee"])
        for floor in (0, 40):
            with pytest.raises(error, match="scene.bvh_nodes2|scene.tri_pos4"):
                trace_regen_shaded(*pix[:-1], disp.num_bounces, floor, T_MAX, st["sample"],
                                   st["bounce"], st["flag"], st["origin"], st["direction"],
                                   st["thr"], st["srad"], z3, st["shadow_o"], st["shadow_d"],
                                   st["contrib"])
        assert (trace_regen.launches, trace_regen_segs.launches,
                trace_regen_shaded.launches) == before


def test_walk_kernels_equal_plain_on_the_scan_forms_rays(dev, scene8, monkeypatch):
    """K1/K2 at the scan form's inputs: every closest-hit and shadow query
    of one trace_radiance over 128x96 pixels (the bounce sort on, lanes
    parked at 1e30 from bounce 2 on) held to the plain versions exactly."""
    from rayfinder_tpu_torch.ops import walk
    from rayfinder_tpu_torch.render import pathtracer as pt
    from rayfinder_tpu_torch.render.camera import create_camera
    from rayfinder_tpu_torch.render.rng import blue_noise_tile
    from rayfinder_tpu_torch.sky.model import sky_state_from_ui

    calls = []

    def record(kind, fn):
        def wrapped(scene, o, d, t_max):
            calls.append((kind, o.clone(), d.clone(), t_max.clone()))
            return fn(scene, o, d, t_max)
        return wrapped

    closest, any_hit = pt._WALKS["kernel"]
    monkeypatch.setitem(pt._WALKS, "kernel", (record("closest", closest), record("any", any_hit)))
    assert scene8.num_clusters > pt.SORT_THRESHOLD
    w, h = 128, 96
    pt.accumulate_sample(
        scene8, sky_state_from_ui(2.5, (0.3, 0.3, 0.3), 35.0, 25.0),
        create_camera([-16.0, 5.0, 0.0], [12.0, 2.0, 0.0], 0.0, 1.0, 70.0, w / h),
        torch.from_numpy(blue_noise_tile()).to(dev), 3, torch.zeros(w * h, 3, device=dev),
        width=w, height=h, num_bounces=4, spp=8)
    assert [c[0] for c in calls] == ["closest", "any"] * 4
    parked = 0
    for kind, o, d, t_max in calls:
        parked += int((o == 1e30).all(1).sum())
        if kind == "closest":
            for a, b in zip(walk.intersect_closest_kernel(scene8, o, d, t_max),
                            walk.intersect_closest_reference(scene8, o, d, t_max)):
                assert torch.equal(a, b)
        else:
            assert torch.equal(walk.intersect_any_kernel(scene8, o, d, t_max),
                               walk.intersect_any_reference(scene8, o, d, t_max))
    assert parked > 0


def test_sorted_decorrelated_scan_form_on_k1_k2_equals_plain(dev, scene8):
    """trace_radiance(decorrelate=True) on courtyard_scene(8), above
    SORT_THRESHOLD (lanes sorted before bounces 2-4, each bounce's noise
    made from the base noise in pixel order and sorted with the lanes, as
    the JAX package does): K1/K2 against their plain versions on the same
    4,096 rays, bit for bit, one K1 and one K2 launch per bounce."""
    from rayfinder_tpu_torch.ops import walk
    from rayfinder_tpu_torch.render import pathtracer as pt
    from rayfinder_tpu_torch.sky.model import sky_state_from_ui

    assert scene8.num_clusters > pt.SORT_THRESHOLD
    o, d = _probe_rays(dev)
    noise = torch.from_numpy(np.random.default_rng(5).random((o.shape[0], 2),
                                                             dtype=np.float32)).to(dev)
    sky = sky_state_from_ui(2.5, (0.3, 0.3, 0.3), 35.0, 25.0)
    before = (walk.intersect_closest_kernel.launches, walk.intersect_any_kernel.launches)
    got = pt.trace_radiance(scene8, sky, o, d, noise, 4, engine="kernel", decorrelate=True)
    assert (walk.intersect_closest_kernel.launches - before[0],
            walk.intersect_any_kernel.launches - before[1]) == (4, 4)
    want = pt.trace_radiance(scene8, sky, o, d, noise, 4, engine="plain", decorrelate=True)
    assert bool(torch.isfinite(got).all()) and float(got.sum()) > 0.0
    assert torch.equal(got, want)


@pytest.mark.parametrize("textured", [False, True])
def test_unfused_loop_and_tiled_scan_form_match_the_default_route(dev, textured):
    """128x96, 8 spp, 4 bounces: the unfused loop over K1/K2 counts the
    default route's rays exactly and equals itself over the plane walk bit
    for bit; render_image_tiled (scan form, 64x48 windows) over K1/K2 equals
    its plain version (one window) bit for bit; every image is within RMSE
    1e-3 of the default route's and 5e-3 of the golden."""
    from rayfinder_tpu_torch.ops import walk
    from rayfinder_tpu_torch.render import pathtracer as pt
    from rayfinder_tpu_torch.render.camera import create_camera
    from rayfinder_tpu_torch.render.rng import blue_noise_tile
    from rayfinder_tpu_torch.render.scene import build_device_scene
    from rayfinder_tpu_torch.render.tiling import unswizzle
    from rayfinder_tpu_torch.render.tonemap import tonemap
    from rayfinder_tpu_torch.sky.model import sky_state_from_ui

    flat, textures = courtyard_scene(8, textured=textured)
    scene = build_device_scene(flat, textures=textures, device=dev)
    w, h, spp = 128, 96, 8
    cam = create_camera([-16.0, 5.0, 0.0], [12.0, 2.0, 0.0], 0.0, 1.0, 70.0, w / h)
    sky = sky_state_from_ui(2.5, (0.3, 0.3, 0.3), 35.0, 25.0)
    tile = torch.from_numpy(blue_noise_tile()).to(dev)
    accums, counts = {}, {}
    for engine in ("kernel", "kernel_split", "reference"):
        before = walk.intersect_closest_kernel.launches
        accums[engine], counts[engine] = pt.accumulate_samples_regen(
            scene, sky, cam, tile, 0, torch.zeros(w * h, 3, device=dev), width=w, height=h,
            num_bounces=4, spp=spp, num_frames=spp, engine=engine, count_rays=True)
        assert (walk.intersect_closest_kernel.launches > before) == (engine == "kernel_split")
    assert torch.equal(counts["kernel_split"], counts["kernel"])
    assert torch.equal(counts["reference"], counts["kernel"])
    assert torch.equal(accums["kernel_split"], accums["reference"])
    images = {k: tonemap(unswizzle(a, w, h) / float(spp), 0.25).reshape(h, w, 3).cpu().numpy()
              for k, a in accums.items()}
    # The plain version in one window: the windows change no pixel.
    for engine, tile_w, tile_h in (("kernel", 64, 48), ("plain", w, h)):
        before = walk.intersect_any_kernel.launches
        images[f"tiled {engine}"] = pt.render_image_tiled(
            scene, sky, cam, width=w, height=h, sampling=pt.SamplingParams(spp, 4),
            exposure=0.25, engine=engine, tile_w=tile_w, tile_h=tile_h)
        assert walk.intersect_any_kernel.launches - before == (128 if engine == "kernel" else 0)
    np.testing.assert_array_equal(images["tiled kernel"], images["tiled plain"])
    golden = np.load(GOLDENS / f"courtyard_{'' if textured else 'un'}textured_128x96_8spp.npz")
    for name, img in images.items():
        assert np.sqrt(np.mean((img - images["kernel"]) ** 2)) < 1e-3, name
        assert np.sqrt(np.mean((img - golden["image"]) ** 2)) < 5e-3, name


@pytest.mark.parametrize("textured", [False, True])
def test_deferred_frames_on_the_kernels_equal_plain(dev, textured):
    """Three DeferredRenderer frames at 128x96 on K1/K2 ("kernel", two K1 and
    two K2 launches per frame) and on their plain versions: the TAA
    accumulator bit for bit, the displays equal, within RMSE 5e-3 of the
    JAX-baked golden; the debug triptych equal too."""
    import sys

    from rayfinder_tpu_torch.ops import walk
    from rayfinder_tpu_torch.render.camera import create_camera
    from rayfinder_tpu_torch.render.deferred import DeferredRenderer
    from rayfinder_tpu_torch.render.scene import build_device_scene
    from rayfinder_tpu_torch.sky.model import sky_state_from_ui

    sys.path.insert(0, str(GOLDENS))
    import bake_torch_smoke as cfg

    kind = "textured" if textured else "untextured"
    flat, textures = courtyard_scene(cfg.SUBDIV, textured=textured)
    scene = build_device_scene(flat, textures=textures, device=dev)
    w, h = cfg.WIDTH, cfg.HEIGHT
    cam = create_camera(*cfg.CAMERA, w / h)
    renderers = {e: DeferredRenderer(scene, w, h, engine=e) for e in ("kernel", "plain")}
    images = {}
    for engine, r in renderers.items():
        before = (walk.intersect_closest_kernel.launches, walk.intersect_any_kernel.launches)
        for _ in range(cfg.DEFERRED_FRAMES):
            images[engine] = r.render(cam, sky_state_from_ui(*cfg.SKY), cfg.EXPOSURE)
        after = (walk.intersect_closest_kernel.launches, walk.intersect_any_kernel.launches)
        per_frame = 2 * cfg.DEFERRED_FRAMES if engine == "kernel" else 0
        assert (after[0] - before[0], after[1] - before[1]) == (per_frame, per_frame)
    assert renderers["kernel"].accum.device.type == "cuda"
    assert torch.equal(renderers["kernel"].accum, renderers["plain"].accum)
    np.testing.assert_array_equal(images["kernel"], images["plain"])
    golden = np.load(cfg.DEFERRED_GOLDEN)
    assert np.sqrt(np.mean((images["kernel"] - golden[f"{kind}_display"] / 255.0) ** 2)) < 5e-3
    with np.errstate(invalid="ignore"):
        np.testing.assert_array_equal(renderers["kernel"].render_debug(cam),
                                      renderers["plain"].render_debug(cam))


def test_focus_pick_goes_through_k1(dev, scene8):
    """The viewer's focus pick on the card: one K1 launch, the plain walk's
    focus."""
    from rayfinder_tpu_torch.ops import walk
    from rayfinder_tpu_torch.render.fly_camera import FlyCameraController, pick_focus_distance

    def controller():
        c = FlyCameraController((64, 48))
        c.position = np.asarray([-16.0, 5.0, 0.0], np.float32)
        c.look_at([12.0, 2.0, 0.0])
        return c

    c = controller()
    before = walk.intersect_closest_kernel.launches
    focus = pick_focus_distance(scene8, c, 32.0, 24.0)
    assert walk.intersect_closest_kernel.launches == before + 1
    cpu = controller()
    assert focus is not None and focus == pick_focus_distance(scene8.to("cpu"), cpu, 32.0, 24.0)


@pytest.mark.parametrize("floor", [None, 1024])
def test_sorted_loop_equals_unsorted_on_k3(dev, scene8, floor):
    """The split route sorted every iteration (courtyard_scene(8) has 297
    clusters) against unsorted, from a zero accumulator, on K3: equal bit for
    bit with equal ray counts, K3 launched as often."""
    from rayfinder_tpu_torch.ops.regen import trace_regen

    kw = {} if floor is None else {"compact_floor": floor}
    before = trace_regen.launches
    unsorted, u_rays = _regen(scene8, dev, 128, 96, 8, inkernel=False, sort=False, **kw)
    mid = trace_regen.launches
    got, rays = _regen(scene8, dev, 128, 96, 8, inkernel=False, sort=True, **kw)
    assert mid > before and trace_regen.launches - mid == mid - before
    assert torch.equal(got, unsorted) and torch.equal(rays, u_rays)


def test_one_by_one_nccl_mesh_equals_unsharded(dev, scene8):
    """render_image_sharded_regen on a 1x1 nccl mesh (one process, the
    default route per shard) equals render_image bit for bit."""
    import socket

    import torch.distributed as dist

    from rayfinder_tpu_torch.ops.regen_shaded import trace_regen_shaded
    from rayfinder_tpu_torch.parallel.sharding import make_render_mesh, render_image_sharded_regen
    from rayfinder_tpu_torch.render.camera import create_camera
    from rayfinder_tpu_torch.render.pathtracer import SamplingParams, render_image
    from rayfinder_tpu_torch.sky.model import sky_state_from_ui

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", rank=0, world_size=1)
    w, h = 128, 96
    cam = create_camera([-16.0, 5.0, 0.0], [12.0, 2.0, 0.0], 0.0, 1.0, 70.0, w / h)
    sky = sky_state_from_ui(2.5, (0.3, 0.3, 0.3), 35.0, 25.0)
    mesh = make_render_mesh(device=dev)
    before = trace_regen_shaded.launches
    sharded = render_image_sharded_regen(scene8, sky, cam, mesh=mesh, width=w, height=h, spp=8,
                                         num_bounces=4, exposure=0.25)
    dist.destroy_process_group()
    assert trace_regen_shaded.launches == before + 1
    single = render_image(scene8, sky, cam, width=w, height=h, sampling=SamplingParams(8, 4),
                          exposure=0.25, samples_per_dispatch=8)
    np.testing.assert_array_equal(sharded, single)


@pytest.mark.parametrize("name", ["grouped_courtyard8", "flat_courtyard8"])
def test_wavefront_engine_matches_k1_k2_on_the_goldens(dev, scene8, name):
    """The wavefront engine on the card against K1/K2 on the goldens' rays:
    equal t, tri and occlusion but for flat_courtyard8 ray 6, where the
    stack walk's slab test prunes the nearer triangle by an ulp (the golden
    and the wavefront find it), and no ray escalates."""
    from rayfinder_tpu_torch.ops import walk
    from rayfinder_tpu_torch.render.intersect import T_MAX
    from rayfinder_tpu_torch.render.wavefront import (
        intersect_any_wavefront, intersect_closest_wavefront,
    )

    g = np.load(GOLDENS / f"{name}.npz")
    o = torch.from_numpy(g["origins"]).to(dev)
    d = torch.from_numpy(g["directions"]).to(dev)
    _, kt, ktri, _ = walk.intersect_closest_kernel(scene8, o, d, T_MAX)
    _, t, tri, esc = intersect_closest_wavefront(scene8, o, d, T_MAX)
    occ, esc_any = intersect_any_wavefront(scene8, o, d, T_MAX)
    assert int(esc) == 0 and int(esc_any) == 0
    differ = torch.nonzero((t != kt) | (tri != ktri))[:, 0].tolist()
    assert differ == ([6] if name == "flat_courtyard8" else [])
    np.testing.assert_array_equal(t.cpu().numpy(), g["t"])
    np.testing.assert_array_equal(tri.cpu().numpy(), g["tri"])
    assert torch.equal(occ, walk.intersect_any_kernel(scene8, o, d, T_MAX))


def test_full_scale_quality_gate_on_the_default_route(dev):
    """The courtyard case of tests/test_quality_gate.py test_full_scale_rmse
    on the card: the procedural courtyard_scene(26, textured=True) at
    512x512, two 16-sample dispatches on the default route (one K4 call
    each), tonemapped, against the JAX wavefront engine's golden by
    tools/make_quality_goldens.py quality_gate: RMSE < 1e-3 off the pixels
    whose middle ray hits the +x wall (a face on a texel edge); on them the
    mean difference within its standard errors and the RMSE within JAX's
    own on the CPU."""
    from rayfinder_tpu_torch.ops.regen_shaded import trace_regen_shaded
    from rayfinder_tpu_torch.tools.make_quality_goldens import (
        QUALITY_RMSE_BUDGET, courtyard_config, gate_failures, golden_path, quality_gate,
        quality_image, texel_wrap_pixels,
    )

    scene, sky, camera, kw = courtyard_config(dev)
    before = trace_regen_shaded.launches
    img = quality_image(scene, sky, camera, engine="kernel", **kw)
    assert trace_regen_shaded.launches == before + 2
    wrap = texel_wrap_pixels(scene, camera, kw["width"], kw["height"])
    assert 0 < wrap.sum() < wrap.size // 10
    gate = quality_gate(img, golden_path("courtyard", kw["width"], kw["height"],
                                         2 * kw["num_frames"]), wrap)
    assert gate["quality_rmse_off_wrap"] < QUALITY_RMSE_BUDGET
    assert gate["quality_ok"], f"courtyard drifted: {gate_failures(gate)}"


@pytest.mark.parametrize("u", [7.999, 8.001])
def test_full_scale_quality_gate_misses_one_texel_column_on_the_wall(dev, u):
    """The gate's negative control: with the +x wall's u moved off the
    texel edge, every hit on it reads one texel column (191 below 8, 0
    above), and the image misses the gate."""
    from rayfinder_tpu_torch.tools.make_quality_goldens import (
        courtyard_config, golden_path, quality_gate, quality_image, texel_wrap_pixels,
        texel_wrap_triangles,
    )

    scene, sky, camera, kw = courtyard_config(dev)
    wrap = texel_wrap_pixels(scene, camera, kw["width"], kw["height"])
    faces = texel_wrap_triangles(scene)
    uvs, attrs = scene.tri_uvs.clone(), scene.tri_attrs.clone()
    uvs[faces, :, 0] = u
    attrs[faces, 18:24:2] = u
    moved = dataclasses.replace(scene, tri_uvs=uvs, tri_attrs=attrs)
    img = quality_image(moved, sky, camera, engine="kernel", **kw)
    gate = quality_gate(img, golden_path("courtyard", kw["width"], kw["height"],
                                         2 * kw["num_frames"]), wrap)
    assert not gate["quality_ok"], gate


def test_walk_kernels_match_brute_force_on_flat_courtyard8(dev, scene8):
    """K1 and K2 against the port's brute_force_closest_hit on the card: hit
    and occlusion equal on every ray, t and tri on every ray but ray 6, where
    the slab test prunes the nearer leaf box by an ulp and K1 lands on a
    triangle at most 2 ulp further away. Brute force equals the golden."""
    from rayfinder_tpu_torch.ops import walk
    from rayfinder_tpu_torch.render.intersect import T_MAX, brute_force_closest_hit

    g = np.load(GOLDENS / "flat_courtyard8.npz")
    o = torch.from_numpy(g["origins"]).to(dev)
    d = torch.from_numpy(g["directions"]).to(dev)
    hit, t, tri, _ = walk.intersect_closest_kernel(scene8, o, d, T_MAX)
    occ = walk.intersect_any_kernel(scene8, o, d, T_MAX)
    bhit, bt, btri = brute_force_closest_hit(o, d, scene8.tri_positions, T_MAX)
    np.testing.assert_array_equal(bt.cpu().numpy(), g["t"])
    np.testing.assert_array_equal(btri.cpu().numpy(), g["tri"])
    assert torch.equal(hit, bhit) and torch.equal(occ, bhit)
    differ = torch.nonzero((t != bt) | (tri != btri))[:, 0].tolist()
    assert differ == [6]
    inf = torch.tensor(float("inf"), device=dev)
    assert bt[6] < t[6] <= torch.nextafter(torch.nextafter(bt[6], inf), inf)


def _bench_view(w, h):
    from rayfinder_tpu_torch.render.camera import create_camera
    from rayfinder_tpu_torch.render.renderer import Sky

    return (create_camera([-16, 5, 0], [12, 2, 0], 0.0, 1.0, 70.0, w / h),
            Sky(2.5, (0.3, 0.3, 0.3), 35.0, 25.0))


def test_h2d_counter_equals_the_traced_copies(dev, scene8, tmp_path):
    """rf.h2d_bytes over the first 1920x1080 render(8) + image_u8() is within
    1% of the bytes of the host-to-device copies in a torch.profiler chrome
    trace of the same calls (the counter leaves out the camera's vectors),
    and holds the pixel tables' one upload; a second batch counts only the
    parked shadow direction's 12 bytes (K4 takes the sky by value), copies
    nothing over 1 KiB to the card, and its image_u8() is the accumulation
    unswizzled through a fresh numpy int64 index."""
    import json

    from rayfinder_tpu_torch.render import tiling
    from rayfinder_tpu_torch.render.pathtracer import SamplingParams
    from rayfinder_tpu_torch.render.renderer import Renderer, RenderParameters, _display_u8
    from rayfinder_tpu_torch.utils import profiling

    camera, sky = _bench_view(1920, 1080)
    warm = Renderer(scene8, RenderParameters(64, 32, camera, SamplingParams(64, 4), sky, 0.25))
    warm.render(8)
    warm.image_u8()
    tiling._block_order_on.cache_clear()
    r = Renderer(scene8, RenderParameters(1920, 1080, camera, SamplingParams(64, 4), sky, 0.25))
    profiling.PROFILED.take()

    def traced_batch(name):
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            r.render(8)
            img = r.image_u8()
        records = profiling.PROFILED.take()
        path = tmp_path / f"{name}.json"
        prof.export_chrome_trace(str(path))
        copies = [int(e["args"]["bytes"]) for e in json.loads(path.read_text())["traceEvents"]
                  if e.get("cat") == "gpu_memcpy" and "HtoD" in e.get("name", "")]
        counted = {n: sum(c.n for c in records if isinstance(c, profiling.Count) and c.name == n)
                   for n in (profiling.H2D_BYTES, profiling.PIXEL_TABLES)}
        return img, copies, counted

    _, copies, counted = traced_batch("first")
    copied = sum(copies)
    print(f"first batch: rf.h2d_bytes {counted}, HtoD copies {len(copies)} of {copied} bytes")
    assert counted[profiling.PIXEL_TABLES] == 1
    assert counted[profiling.H2D_BYTES] > 33_000_000
    assert abs(counted[profiling.H2D_BYTES] - copied) <= 0.01 * copied
    img, copies, counted = traced_batch("second")
    print(f"second batch: rf.h2d_bytes {counted}, HtoD copies {copies}")
    assert counted[profiling.PIXEL_TABLES] == 0 and counted[profiling.H2D_BYTES] == 12
    assert max(copies, default=0) <= 1024
    idx = torch.from_numpy(tiling.block_order(1920, 1080)[2].astype(np.int64)).to(dev)
    flat = torch.empty_like(r._accum)
    flat[idx] = r._accum
    want = _display_u8(flat / float(r.accumulated_sample_count), 0.25)
    np.testing.assert_array_equal(img, want.reshape(1080, 1920, 3).cpu().numpy())


def test_deferred_pass_spans_lie_inside_the_frame(dev, scene8):
    """Over one 1920x1080 deferred frame each pass's device interval (its CUDA
    event pair) is above 0, and the three together are no longer than the
    frame's rf.deferred.frame host interval."""
    from rayfinder_tpu_torch.render.deferred import PASSES, DeferredRenderer
    from rayfinder_tpu_torch.utils import profiling

    camera, sky = _bench_view(1920, 1080)
    dr = DeferredRenderer(scene8, 1920, 1080)
    dr.render(camera, sky.state(), 0.25)
    with profiling.recording() as rec:
        dr.render(camera, sky.state(), 0.25)
        stats = dr.perf_stats()
    (frame,) = rec.spans("rf.deferred.frame")
    passes = {p: rec.spans(f"rf.deferred.{p}")[0].device_ms for p in PASSES}
    print(f"frame {1e3 * (frame.t1 - frame.t0):.3f} ms host, passes {passes} ms device")
    assert all(ms is not None and ms > 0.0 for ms in passes.values())
    assert sum(passes.values()) <= 1e3 * (frame.t1 - frame.t0)
    assert {p: stats[p] for p in PASSES} == pytest.approx(passes)


def test_deferred_frame_is_converted_on_the_card_into_pinned_memory(dev, scene8):
    """Over 1920x1080 deferred frames on the default engine: every display
    byte converts on the card to numpy's u8 / float32(255) bit for bit;
    render's image is numpy's conversion of a twin renderer's frame_pass
    bytes, in page-locked memory, and keeps its values after the next
    render; rf.d2h_bytes counts the image's 24,883,200 bytes a frame; once
    warm, no frame allocates pinned memory; the copy is a DtoH to pinned
    memory in torch.profiler's events."""
    from rayfinder_tpu_torch.render import deferred as pd
    from rayfinder_tpu_torch.utils import profiling

    codes = pd.to_float(torch.arange(256, dtype=torch.uint8, device=dev), pd.float_table(dev))
    want = np.arange(256, dtype=np.uint8).astype(np.float32) / np.float32(255.0)
    np.testing.assert_array_equal(codes.cpu().numpy().view(np.uint32), want.view(np.uint32))

    w, h = 1920, 1080
    camera, sky = _bench_view(w, h)
    sky = sky.state()
    r, twin = pd.DeferredRenderer(scene8, w, h), pd.DeferredRenderer(scene8, w, h)
    held, allocs = None, []
    for frame in range(6):
        with profiling.recording() as rec:
            got = r.render(camera, sky, 0.25)
        d2h = [c.n for c in rec.records()
               if isinstance(c, profiling.Count) and c.name == profiling.D2H_BYTES]
        twin.accum, img8 = pd.frame_pass(scene8, twin._device_sky(sky), camera, twin.accum,
                                         frame, 0.25, width=w, height=h, tile=twin._tile)
        want = img8.cpu().numpy().reshape(h, w, 3).astype(np.float32) / np.float32(255.0)
        assert got.shape == (h, w, 3) and got.flags.c_contiguous
        assert torch.from_numpy(got).is_pinned()
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
        assert d2h == [w * h * 3 * 4] == [24_883_200]
        if held is not None:  # the frame before, after this render
            assert not np.shares_memory(held[0], got)
            np.testing.assert_array_equal(held[0].view(np.uint32), held[1].view(np.uint32))
        held = (got, want)
        allocs.append(torch.cuda.host_memory_stats()["num_host_alloc"])
    print(f"pinned blocks allocated after each frame: {allocs}")
    assert allocs[2] == allocs[-1]

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        r.render(camera, sky, 0.25)
    copies = {e.name for e in prof.events() if e.name.startswith("Memcpy DtoH")}
    profiling.PROFILED.take()
    assert copies == {"Memcpy DtoH (Device -> Pinned)"}, copies


def _planes_equal(got: dict, want: dict, label: str) -> None:
    """Each plane bit for bit (floats compared as their bits), naming the
    first plane that differs and how many of its rows do."""
    for k, a in want.items():
        b = got[k]
        assert b.dtype == a.dtype and b.shape == a.shape, (label, k)
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        bad = (a != b).reshape(a.shape[0], -1).any(dim=1)
        assert not bool(bad.any()), f"{label} {k}: {int(bad.sum())} rows differ, first " \
                                    f"{torch.nonzero(bad)[:4, 0].tolist()}"


@pytest.mark.parametrize("textured", [False, True])
def test_deferred_pass_kernels_equal_their_plain_versions(dev, textured):
    """At 1920x1080 on courtyard_scene(8): the G-buffer kernels' planes, the
    lighting kernels' samples (from the same G-buffer) and the resolve
    kernel's history and display (frame 0's copy and a blend, on samples
    holding NaN, infinities and negatives too) equal the torch passes' bit
    for bit, with the launches each wrapper counts."""
    from rayfinder_tpu_torch.ops import deferred as od
    from rayfinder_tpu_torch.render.scene import build_device_scene
    from rayfinder_tpu_torch.render.rng import blue_noise_tile

    flat, textures = courtyard_scene(8, textured=textured)
    scene = build_device_scene(flat, textures=textures, device=dev)
    w, h = 1920, 1080
    camera, sky = _bench_view(w, h)
    sky = sky.state()
    tile = torch.from_numpy(blue_noise_tile()).to(dev)
    for frame in (0, 7):
        launches = (od.gbuffer_kernel.launches, od.lighting_kernel.launches)
        gbuf = od.gbuffer_kernel(scene, camera, frame, width=w, height=h)
        _planes_equal(gbuf, od.gbuffer_reference(scene, camera, frame, width=w, height=h),
                      f"gbuffer, frame {frame}")
        assert bool(gbuf["hit"].any()) and not bool(gbuf["hit"].all())
        sample = od.lighting_kernel(scene, sky, gbuf, frame, width=w, height=h, tile=tile)
        want = od.lighting_reference(scene, sky, gbuf, frame, width=w, height=h, tile=tile)
        _planes_equal({"sample": sample}, {"sample": want}, f"lighting, frame {frame}")
        assert (od.gbuffer_kernel.launches - launches[0],
                od.lighting_kernel.launches - launches[1]) == (2, 3)
    odd = torch.tensor([[float("nan"), float("inf"), -1.0], [-float("inf"), 0.0, -0.0],
                        [1e30, 1e-30, 3.0]], device=dev)
    sample = torch.cat([sample, odd])
    accum = torch.cat([want, odd.flip(0)])
    for frame in (0, 1, 5):
        before = od.resolve_kernel.launches
        got = od.resolve_kernel(sample, accum, frame, 0.25)
        ref = od.resolve_reference(sample, accum, frame, 0.25)
        assert od.resolve_kernel.launches == before + 1
        assert (got[0] is sample) == (frame == 0)
        _planes_equal({"accum": got[0], "display": got[1]},
                      {"accum": ref[0], "display": ref[1]}, f"resolve, frame {frame}")


@pytest.mark.parametrize("textured", [False, True])
def test_deferred_frames_on_the_pass_kernels_equal_plain_at_1080p(dev, textured):
    """DeferredRenderer at 1920x1080 on courtyard_scene(8), four frames (frame
    0's copy and three blends, the camera moved on the third) on the engine
    "kernel" (the passes' kernels around K1/K2) and on "plain" (the torch
    passes on the plain walks): the history, every returned frame and the
    debug triptych bit for bit; per frame two K1 and two K2 launches, two
    G-buffer, three lighting and one resolve kernel, and
    rf.deferred.kernel_frames counts every frame (0 on "plain")."""
    from rayfinder_tpu_torch.ops import deferred as od
    from rayfinder_tpu_torch.ops import walk
    from rayfinder_tpu_torch.render.camera import create_camera
    from rayfinder_tpu_torch.render.deferred import DeferredRenderer
    from rayfinder_tpu_torch.render.scene import build_device_scene
    from rayfinder_tpu_torch.utils import profiling

    flat, textures = courtyard_scene(8, textured=textured)
    scene = build_device_scene(flat, textures=textures, device=dev)
    w, h = 1920, 1080
    camera, sky = _bench_view(w, h)
    sky = sky.state()
    moved = create_camera([-15.5, 5.2, 0.4], [12, 2.5, -0.5], 0.0, 1.0, 70.0, w / h)
    cams = [camera, camera, moved, moved]
    counters = (walk.intersect_closest_kernel, walk.intersect_any_kernel, od.gbuffer_kernel,
                od.lighting_kernel, od.resolve_kernel)
    frames, accum, debug = {}, {}, {}
    for engine in ("kernel", "plain"):
        r = DeferredRenderer(scene, w, h, engine=engine)
        before = [fn.launches for fn in counters]
        with profiling.recording() as rec:
            frames[engine] = [r.render(cam, sky, 0.25).copy() for cam in cams]
        counted = [c.n for c in rec.records()
                   if isinstance(c, profiling.Count) and c.name == profiling.KERNEL_FRAMES]
        per_frame = [(fn.launches - b) / len(cams) for fn, b in zip(counters, before)]
        if engine == "kernel":
            assert per_frame == [2, 2, 2, 3, 1] and counted == [1] * 4
        else:
            assert per_frame == [0] * 5 and counted == [0] * 4
        accum[engine] = r.accum
        with np.errstate(invalid="ignore"):
            debug[engine] = r.render_debug(moved)
    assert torch.equal(accum["kernel"].view(torch.int32), accum["plain"].view(torch.int32))
    for got, want in zip(frames["kernel"], frames["plain"]):
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    assert not np.array_equal(frames["kernel"][1], frames["kernel"][2])
    np.testing.assert_array_equal(debug["kernel"], debug["plain"])


def test_warm_deferred_frame_is_at_most_16_device_operations(dev, scene8, tmp_path):
    """Under torch.profiler one warm 1920x1080 deferred frame on the default
    engine issues at most 16 device operations (kernels, copies, fills: the
    chrome trace's events as portbench/trace.py counts them) and copies
    nothing from the host to the card."""
    import json

    from rayfinder_tpu_torch.render.deferred import DeferredRenderer
    from rayfinder_tpu_torch.utils import profiling

    w, h = 1920, 1080
    camera, sky = _bench_view(w, h)
    sky = sky.state()
    r = DeferredRenderer(scene8, w, h)
    for _ in range(3):
        r.render(camera, sky, 0.25)
    torch.cuda.synchronize(dev)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        r.render(camera, sky, 0.25)
    profiling.PROFILED.take()
    path = tmp_path / "frame.json"
    prof.export_chrome_trace(str(path))
    device_ops = [e["name"] for e in json.loads(path.read_text())["traceEvents"]
                  if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    print(f"{len(device_ops)} device operations: {device_ops}")
    assert 0 < len(device_ops) <= 16
    assert not [n for n in device_ops if "HtoD" in n]


@pytest.mark.parametrize("route", [dict(), dict(inkernel=True, compact_floor=16)])
def test_k4_walk_counters_equal_plain(dev, textured4, route):
    """K4's four counters, the [closest, shadow] rays and its walks'
    [records, tests], the work items at floor 0 (the default route) and the
    tile kernel above it (the hybrid's compacted phases): equal to its plain
    version's on the textured courtyard, and the tests at least one a ray
    that meets a leaf."""
    counted = {}
    for engine in ("kernel", "plain"):
        walk = [torch.zeros(1, dtype=torch.int64, device=dev) for _ in range(2)]
        _, rays = _regen(textured4, dev, 64, 48, 4, engine=engine, walk_records=walk[0],
                         walk_tests=walk[1], **route)
        counted[engine] = rays.tolist() + [int(w) for w in walk]
    assert counted["kernel"] == counted["plain"]
    closest, shadow, records, tests = counted["kernel"]
    assert records > 0 and tests > 0


def test_deep_tree_takes_the_64_entry_walks(dev):
    """The 40-level chain of tests/torch_deep_scene.py loads with the
    64-entry walk (walk_stack 64): K1 and K2 equal their plain versions and
    brute force on rays that overflow the 32-entry stack, where the 32-entry
    walks (walked_with_32) do not; K4's dispatch on it equals its plain
    version's (counters and accumulation); K3, which walks 32 entries,
    raises."""
    import sys

    from rayfinder_tpu_torch.ops import walk
    from rayfinder_tpu_torch.render import intersect
    from rayfinder_tpu_torch.render.camera import create_camera
    from rayfinder_tpu_torch.render.intersect import T_MAX
    from rayfinder_tpu_torch.render.pathtracer import accumulate_samples_regen
    from rayfinder_tpu_torch.render.rng import blue_noise_tile
    from rayfinder_tpu_torch.render.scene import build_device_scene
    from rayfinder_tpu_torch.sky.model import sky_state_from_ui

    sys.path.insert(0, str(GOLDENS.parent))
    from torch_deep_scene import deep_rays, deep_scene, walked_with_32

    flat, bvh = deep_scene()
    deep = build_device_scene(flat, bvh=bvh, device=dev)
    shallow = walked_with_32(deep)
    assert (deep.walk_stack, shallow.walk_stack) == (64, 32)
    o, d = (torch.from_numpy(a).to(dev) for a in deep_rays(4096, seed=9))
    hit, t, tri = intersect.brute_force_closest_hit(o, d, deep.tri_positions, T_MAX)
    for scene, exact in ((deep, True), (shallow, False)):
        got = walk.intersect_closest_kernel(scene, o, d, T_MAX)
        want = walk.intersect_closest_reference(scene, o, d, T_MAX)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        occ = walk.intersect_any_kernel(scene, o, d, T_MAX)
        assert torch.equal(occ, walk.intersect_any_reference(scene, o, d, T_MAX))
        assert (torch.equal(got[2], tri) and torch.equal(got[1], t)) == exact
        if exact:
            assert torch.equal(occ, hit)
    cam = create_camera([20.5, 0.3, 0.3], [0.0, 0.35, 0.35], 0.0, 1.0, 70.0, 4 / 3)
    sky = sky_state_from_ui(2.5, (0.3, 0.3, 0.3), 35.0, 25.0)
    tile = torch.from_numpy(blue_noise_tile()).to(dev)

    def dispatch(engine, **kw):
        walk_counts = [torch.zeros(1, dtype=torch.int64, device=dev) for _ in range(2)]
        accum, rays = accumulate_samples_regen(
            deep, sky, cam, tile, 0, torch.zeros(32 * 24, 3, device=dev), width=32, height=24,
            num_bounces=4, spp=4, num_frames=4, engine=engine, count_rays=True,
            walk_records=walk_counts[0], walk_tests=walk_counts[1], **kw)
        return accum, rays.tolist() + [int(w) for w in walk_counts]

    k_accum, k_counts = dispatch("kernel")
    p_accum, p_counts = dispatch("plain")
    assert k_counts == p_counts and k_counts[0] > 0
    torch.testing.assert_close(k_accum, p_accum, rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="64 stack entries"):
        dispatch("kernel", inkernel=False)


def test_atlas_past_256_mib_on_k4_and_the_deferred_kernels(dev):
    """A texel atlas of 256 MiB and more (a 8192 x 8192 map packed before
    the textured courtyard's 14, so that every map it samples lies past
    2**26 texels): K4's default route and the deferred renderer's kernels
    equal their plain versions on it."""
    from rayfinder_tpu_torch.render.camera import create_camera
    from rayfinder_tpu_torch.render.deferred import DeferredRenderer
    from rayfinder_tpu_torch.render.scene import build_device_scene
    from rayfinder_tpu_torch.scene import Texture
    from rayfinder_tpu_torch.sky.model import sky_state_from_ui

    flat, textures = courtyard_scene(8, textured=True)
    big = Texture(np.full(8192 * 8192, 0xFF40C080, np.uint32), width=8192, height=8192)
    flat = dataclasses.replace(flat, texture_indices=flat.texture_indices + 1)
    scene = build_device_scene(flat, textures=[big, *textures], device=dev)
    assert scene.texels.numel() * 4 > 256 * 2**20 and int(scene.tex_offset[1]) == 8192**2
    w, h = 128, 96
    k_accum, k_rays = _regen(scene, dev, w, h, 8)
    p_accum, p_rays = _regen(scene, dev, w, h, 8, engine="plain")
    assert torch.equal(k_rays, p_rays)
    torch.testing.assert_close(k_accum, p_accum, rtol=1e-5, atol=1e-6)
    cam = create_camera([-16.0, 5.0, 0.0], [12.0, 2.0, 0.0], 0.0, 1.0, 70.0, w / h)
    sky = sky_state_from_ui(2.5, (0.3, 0.3, 0.3), 35.0, 25.0)
    frames = {}
    for engine in ("kernel", "plain"):
        r = DeferredRenderer(scene, w, h, engine=engine)
        frames[engine] = [r.render(cam, sky, 0.25).copy() for _ in range(2)]
    for got, want in zip(frames["kernel"], frames["plain"]):
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
