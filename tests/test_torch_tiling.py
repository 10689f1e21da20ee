"""The block-order pixel tables kept on the device (rayfinder_tpu_torch/
render/tiling.py block_order_on), on the CPU at small sizes on the plain
engine: one build per image size and device, also over sharded steps, no
caller writing into them, unswizzle the same permutation as a scatter
through a numpy index, and the lanes made from them (pixel_lanes) those of
the numpy derivation."""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from rayfinder_tpu_torch.parallel import sharding
from rayfinder_tpu_torch.render import pathtracer as pt
from rayfinder_tpu_torch.render import tiling
from rayfinder_tpu_torch.render.camera import create_camera
from rayfinder_tpu_torch.render.pathtracer import SamplingParams
from rayfinder_tpu_torch.render.renderer import Renderer, RenderParameters, Sky
from rayfinder_tpu_torch.render.rng import blue_noise_tile
from rayfinder_tpu_torch.render.scene import build_device_scene
from rayfinder_tpu_torch.scene.procedural import courtyard_scene
from rayfinder_tpu_torch.utils import profiling
from rayfinder_tpu_torch.utils.profiling import H2D_BYTES, PIXEL_TABLES, Count

W, H = 32, 24
SKY = Sky(2.5, (0.3, 0.3, 0.3), 35.0, 25.0)


@pytest.fixture(scope="module")
def scene():
    flat, textures = courtyard_scene(2, textured=True)
    return build_device_scene(flat, textures=textures, device="cpu")


def _params(w, h):
    camera = create_camera([-16, 5, 0], [12, 2, 0], 0.0, 1.0, 70.0, w / h)
    return RenderParameters(w, h, camera, SamplingParams(8, 2), SKY, 0.25)


def _batches(r, n):
    for _ in range(n):
        r.render(2)
        r.image_u8()


def _counted(rec, name):
    return sum(c.n for c in rec.records() if isinstance(c, Count) and c.name == name)


def test_pixel_tables_build_once_per_size(scene):
    """rf.pixel_tables counts 1 over three render(2) + image_u8() batches,
    with the tables' bytes in rf.h2d_bytes once, and 1 more after a size
    change; "cpu" and torch.device("cpu") name one entry. Each batch copies
    besides only the parked direction and the sky that K4's plain version
    reads (the kernel takes it by value)."""
    tiling._block_order_on.cache_clear()
    r = Renderer(scene, _params(W, H), engine="plain")
    with profiling.recording() as rec:
        _batches(r, 3)
    assert _counted(rec, PIXEL_TABLES) == 1
    per_batch = _counted(rec, H2D_BYTES) - W * H * (4 + 4 + 8)
    sky_bytes = sum(np.asarray(f, np.float32).nbytes for f in SKY.state())
    assert per_batch == 3 * (3 * 4 + sky_bytes)  # parked direction, K4's plain version's sky
    r.set_render_parameters(_params(48, 32))
    with profiling.recording() as rec:
        _batches(r, 1)
    assert _counted(rec, PIXEL_TABLES) == 1
    assert tiling.block_order_on(W, H, "cpu") is tiling.block_order_on(W, H, torch.device("cpu"))


def test_cached_tables_are_unchanged_by_renders(scene):
    """After three batches and a window of a larger image at an offset (the
    tiled render's form) the cached ys, xs and index still equal
    block_order's: no caller wrote into them."""
    tiling._block_order_on.cache_clear()
    _batches(Renderer(scene, _params(W, H), engine="plain"), 3)
    big = _params(2 * W, 2 * H)
    tile = torch.from_numpy(blue_noise_tile())
    pt.accumulate_samples_window(
        scene, SKY.state(), big.camera, tile, 0, torch.zeros(W * H, 3), 5, 3, win_w=W,
        win_h=H, width=2 * W, height=2 * H, num_bounces=2, spp=8, num_frames=1, engine="plain")
    got = tiling.block_order_on(W, H, "cpu")
    ys, xs, pixel_idx = tiling.block_order(W, H)
    for g, want, dtype in zip(got, (ys, xs, pixel_idx), (torch.int32, torch.int32, torch.int64)):
        assert g.dtype == dtype
        np.testing.assert_array_equal(g.numpy(), want)


@pytest.mark.parametrize("size", [(64, 48), (37, 21)])
def test_unswizzle_is_the_numpy_index_scatter(size):
    """unswizzle through the cached index equals a scatter through a fresh
    numpy int64 index, bit for bit, also where the image is not a multiple
    of the 32x16 block."""
    w, h = size
    x = np.random.default_rng(7).normal(size=(w * h, 3)).astype(np.float32)
    want = np.empty_like(x)
    want[tiling.block_order(w, h)[2].astype(np.int64)] = x
    got = tiling.unswizzle(torch.from_numpy(x), w, h).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("size, rows", [((32, 24), None), ((37, 23), 852)])
def test_pixel_lanes_are_the_numpy_derivation(size, rows):
    """pixel_lanes equals the derivation from numpy block_order: the order
    padded with np.pad at pixel (0, 0), the centres in float32, the tile's
    value per pixel and 1 / width, 1 / height in float32; at 32x24 and at
    37x23 padded to 852 rows, a multiple of 4."""
    w, h = size
    tile = torch.from_numpy(blue_noise_tile())
    ys_np, xs_np, _ = tiling.block_order(w, h)
    pad = 0 if rows is None else rows - w * h
    ys = torch.from_numpy(np.pad(ys_np, (0, pad)))
    xs = torch.from_numpy(np.pad(xs_np, (0, pad)))
    u, v_tex, noise_base, inv_dims = tiling.pixel_lanes(w, h, tile, rows=rows)
    assert torch.equal(u, (xs.to(torch.float32) + 0.5) / float(w))
    assert torch.equal(v_tex, (ys.to(torch.float32) + 0.5) / float(h))
    assert torch.equal(noise_base, tile[(ys % 128).long(), (xs % 128).long()])
    assert inv_dims == (float(np.float32(1.0) / np.float32(w)),
                        float(np.float32(1.0) / np.float32(h)))


def test_sharded_steps_build_pixel_tables_once(scene, tmp_path):
    """Two regen steps on a 1x1 mesh (a one-rank gloo group) count
    rf.pixel_tables once: the second copies no pixel data, only the parked
    direction and the sky of K4's plain version. Each step adds to the
    accumulator what one dispatch of the single-device loop gives from zero,
    bit for bit."""
    tiling._block_order_on.cache_clear()
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'pg'}", rank=0,
                            world_size=1)
    try:
        mesh = sharding.make_render_mesh(device="cpu")
        p = _params(W, H)
        sky, tile = SKY.state(), torch.from_numpy(blue_noise_tile())
        kw = dict(width=W, height=H, num_bounces=2, spp=8, num_frames=2)
        recs = []
        accum = torch.zeros(W * H, 3)
        for frame_base in (0, 2):
            with profiling.recording() as rec:
                accum = sharding.render_step_sharded_regen(
                    scene, sky, p.camera, tile, frame_base, accum, mesh=mesh, **kw)
            recs.append(rec)
    finally:
        dist.destroy_process_group()
    assert [_counted(rec, PIXEL_TABLES) for rec in recs] == [1, 0]
    sky_bytes = sum(np.asarray(f, np.float32).nbytes for f in sky)
    assert _counted(recs[1], H2D_BYTES) == 3 * 4 + sky_bytes
    want = torch.zeros(W * H, 3)
    for frame_base in (0, 2):
        want = want + pt.accumulate_samples_regen(scene, sky, p.camera, tile, frame_base,
                                                  torch.zeros(W * H, 3), **kw)
    assert torch.equal(accum, want)
