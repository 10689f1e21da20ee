"""The CUDA kernels against their plain versions, on the card.

These need an NVIDIA GPU (sm_90a) and nvcc; without a CUDA device they skip.
On the GPU machine:

    python -m pytest tests/test_torch_cuda.py -m cuda -q --noconftest

(--noconftest: tests/conftest.py imports jax, which that machine lacks.)
"""

import pathlib

import numpy as np
import pytest
import torch

from rayfinder_tpu.scene.procedural import courtyard_scene

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
            height=h, num_bounces=4, spp=spp, num_frames=spp, engine=engine, count_rays=True)
        assert (trace_regen.launches > before) == (engine == "kernel")
        images[engine] = tonemap(unswizzle(accum, w, h) / float(spp), 0.25).reshape(h, w, 3).cpu().numpy()
        counts[engine] = rays.cpu().numpy()
    golden = np.load(GOLDENS / "courtyard_untextured_128x96_8spp.npz")
    assert np.sqrt(np.mean((images["kernel"] - images["plain"]) ** 2)) < 1e-3
    assert np.sqrt(np.mean((images["kernel"] - golden["image"]) ** 2)) < 5e-3
    np.testing.assert_allclose(counts["kernel"], counts["plain"], rtol=1e-3)


@pytest.fixture(scope="module")
def textured4(dev):
    import sys

    from rayfinder_tpu_torch.render.scene import build_device_scene

    sys.path.insert(0, str(GOLDENS.parent.parent))
    from chip_smoke import textured_courtyard

    flat, textures = textured_courtyard(4)
    return build_device_scene(flat, textures=textures, device=dev)


@pytest.mark.parametrize("route", [dict(inkernel=True), dict(inkernel=True, compact_floor=16),
                                   dict(segs=2, count_rays=True), dict(segs=4, count_rays=True)])
def test_route_kernels_match_plain(dev, textured4, route):
    """K4 (inkernel) and K5 (segs) through their routes on the textured
    courtyard: kernel against plain on the card, and against the split
    route."""
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
        out = accumulate_samples_regen(
            textured4, sky, cam, tile, 0, torch.zeros(w * h, 3, device=dev), width=w,
            height=h, num_bounces=4, spp=spp, num_frames=spp, engine=engine, **kw)
        return out if isinstance(out, tuple) else (out, None)

    launches = trace_regen_shaded.launches + trace_regen_segs.launches
    kernel, k_rays = run("kernel", **route)
    assert trace_regen_shaded.launches + trace_regen_segs.launches > launches
    plain, p_rays = run("plain", **route)
    split, s_rays = run("plain", count_rays=True)
    torch.testing.assert_close(kernel, plain, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(kernel, split, rtol=1e-5, atol=1e-5)
    if k_rays is not None:
        assert torch.equal(k_rays, p_rays) and torch.equal(k_rays, s_rays)
