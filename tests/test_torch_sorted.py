"""The sorted fused loop (render/pathtracer.py _accumulate_regen_fused_sorted:
the split route with its lanes reordered by the "dir" key every iteration)
against the unsorted split route, the JAX package's key and its regen loop.

courtyard_scene(8) has 297 clusters, more than SORT_THRESHOLD, on which
JAX's fused loop sorts by default; the port's split route sorts when given
sort=True (an H100 A/B kept it off by default). Each pixel has one
lane per phase and a lane's arithmetic does not depend on its position, so
from a zero accumulator sorted equals unsorted bit for bit with the same ray
counts. Against JAX `engine="reference"`: the regen budget of
tests/test_pallas_regen.py (rtol 2e-4, atol 1e-5), counts exact.
"""

import ast
import importlib.util
import inspect
import pathlib
import textwrap

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rayfinder_tpu.render import pathtracer as jpt
from rayfinder_tpu.render.camera import create_camera as jax_camera
from rayfinder_tpu.render.rng import blue_noise_tile as jax_tile
from rayfinder_tpu.render.scene import build_device_scene as jax_build
from rayfinder_tpu.scene.procedural import courtyard_scene
from rayfinder_tpu.sky.model import sky_state_from_ui as jax_sky
from rayfinder_tpu_torch.prof import diag_iters
from rayfinder_tpu_torch.render import pathtracer as pt
from rayfinder_tpu_torch.render.camera import create_camera
from rayfinder_tpu_torch.render.pathtracer import SamplingParams, accumulate_samples_regen
from rayfinder_tpu_torch.render.rng import blue_noise_tile
from rayfinder_tpu_torch.render.scene import build_device_scene
from rayfinder_tpu_torch.sky.model import sky_state_from_ui

ROOT = pathlib.Path(__file__).resolve().parent.parent
W, H, SPP = 32, 24, 2
CAM = ([-16.0, 5.0, 0.0], [12.0, 2.0, 0.0], 0.0, 1.0, 70.0, W / H)
SKY = (2.5, (0.3, 0.3, 0.3), 35.0, 25.0)


@pytest.fixture(scope="module")
def courtyard():
    flat, textures = courtyard_scene(8)
    return build_device_scene(flat, textures=textures, device="cpu"), jax_build(flat, textures=textures)


def _split(scene, num_bounces=3, frame_base=0, accum=None, num_frames=SPP, **kw):
    accum = torch.zeros(W * H, 3) if accum is None else accum
    return accumulate_samples_regen(
        scene, sky_state_from_ui(*SKY), create_camera(*CAM), torch.from_numpy(blue_noise_tile()),
        frame_base, accum, width=W, height=H, num_bounces=num_bounces, spp=SPP,
        num_frames=num_frames, count_rays=True, inkernel=False, **kw)


@pytest.mark.parametrize("floor", [None, 16])
def test_sorted_equals_unsorted_from_zero(courtyard, floor):
    port, _ = courtyard
    kw = {} if floor is None else {"compact_floor": floor}
    if floor is not None:
        assert len(pt._phase_sizes(W * H, floor)) > 2  # compacted phases run
    unsorted, rays_u = _split(port, sort=False, **kw)
    got, rays = _split(port, sort=True, **kw)
    assert torch.equal(got, unsorted)
    assert torch.equal(rays, rays_u)


@pytest.mark.parametrize("case", ["three_bounces", "single_bounce", "compact_floor_16"])
def test_sorted_matches_jax_reference(courtyard, case):
    port, jscene = courtyard
    nb = 1 if case == "single_bounce" else 3
    kw = {"compact_floor": 16} if case == "compact_floor_16" else {}
    want, want_rays = jpt.accumulate_samples_regen(
        jscene, jax_sky(*SKY), jax_camera(*CAM), jnp.asarray(jax_tile()), jnp.int32(0),
        jnp.zeros((W * H, 3), jnp.float32), width=W, height=H, num_bounces=nb, spp=SPP,
        num_frames=SPP, engine="reference", count_rays=True, **kw)
    got, rays = _split(port, nb, sort=True, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=1e-5)
    np.testing.assert_array_equal(rays.numpy(), np.asarray(want_rays))


def test_sorted_half_dispatches_match_one(courtyard):
    """Two dispatches of spp/2 samples == one of spp: the second starts from
    a nonzero accumulator, so its first phase groups its sums otherwise."""
    port, _ = courtyard
    one, one_rays = _split(port, 2, sort=True)
    half, rays_a = _split(port, 2, num_frames=SPP // 2, sort=True)
    two, rays_b = _split(port, 2, frame_base=SPP // 2, accum=half, num_frames=SPP // 2,
                         sort=True)
    np.testing.assert_allclose(two.numpy(), one.numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal((rays_a + rays_b).numpy(), one_rays.numpy())


def test_split_route_sorts_only_when_asked(courtyard, monkeypatch):
    """sort=False, the default, keeps the lanes in place, on a scene above
    SORT_THRESHOLD clusters too; sort=True sorts on any scene."""
    port, _ = courtyard
    flat4, textures4 = courtyard_scene(4)
    small = build_device_scene(flat4, textures=textures4, device="cpu")
    assert port.num_clusters > pt.SORT_THRESHOLD >= small.num_clusters
    calls = []
    sorted_loop = pt._accumulate_regen_fused_sorted
    monkeypatch.setattr(pt, "_accumulate_regen_fused_sorted",
                        lambda *a: calls.append(1) or sorted_loop(*a))
    _split(port, 1)
    _split(port, 1, sort=False)
    assert calls == []
    _split(small, 1, sort=True)
    assert calls == [1]


def test_sort_is_the_split_routes_keyword(courtyard):
    port, _ = courtyard
    args = (port, sky_state_from_ui(*SKY), create_camera(*CAM),
            torch.from_numpy(blue_noise_tile()), 0, torch.zeros(W * H, 3))
    kw = dict(width=W, height=H, num_bounces=1, spp=SPP, num_frames=1)
    for route in ({}, {"inkernel": True}, {"segs": 2}, {"engine": "kernel_split"},
                  {"engine": "wavefront"}, {"inkernel": False, "segs": 2}):
        with pytest.raises(ValueError):
            accumulate_samples_regen(*args, **kw, **route, sort=True)
        # sort=False is the default, which every route takes.
        accumulate_samples_regen(*args, **kw, **route, sort=False)
    with pytest.raises(ValueError, match="no routes"):
        pt.render_image(port, *args[1:3], width=W, height=H, sampling=SamplingParams(1, 1),
                        engine="reference", sort=True)


def test_render_image_sort_changes_no_pixel(courtyard):
    """The pick_accumulator claim: render_image on the split route sorted
    and unsorted gives the same image, bit for bit."""
    port, _ = courtyard
    kw = dict(width=W, height=H, sampling=SamplingParams(SPP, 2), exposure=0.25,
              inkernel=False)
    a = pt.render_image(port, sky_state_from_ui(*SKY), create_camera(*CAM), sort=True, **kw)
    b = pt.render_image(port, sky_state_from_ui(*SKY), create_camera(*CAM), sort=False, **kw)
    assert np.array_equal(a, b)


def _jax_dir_bin_key():
    """JAX's `_dir_bin_key`, a closure inside
    rayfinder_tpu.render.pathtracer._accumulate_regen_fused_sorted, compiled
    from its own source with `t2c` bound to a value given later."""
    tree = ast.parse(textwrap.dedent(inspect.getsource(jpt._accumulate_regen_fused_sorted)))
    node = next(n for n in ast.walk(tree)
                if isinstance(n, ast.FunctionDef) and n.name == "_dir_bin_key")
    namespace = {"jnp": jnp, "dead_key": jnp.int32(2**30)}
    exec(compile(ast.Module([node], []), "<jax _dir_bin_key>", "exec"), namespace)
    return namespace


def _jax_t2c(jscene):
    """The JAX sorted loop's t2c, built by its own rule."""
    cl_map = jscene.cluster_tri_map.reshape(-1)
    num_tris = jscene.tri_positions.shape[0]
    slots = jnp.arange(cl_map.shape[0], dtype=jnp.int32)
    cids = slots // jscene.cluster_tris.shape[1]
    real_cl = jscene.cluster_min[:, 0] < jnp.float32(1e29)
    return jnp.zeros((num_tris,), jnp.int32).at[
        jnp.where(real_cl[cids], cl_map, num_tris)].set(cids, mode="drop")


def _key_inputs(num_tris, n=4096, seed=3):
    rng = np.random.default_rng(seed)
    tri = rng.integers(-1, num_tris, n).astype(np.int32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[:64] = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 64)] * rng.choice([-1, 1], (64, 1))
    d[64:72] = 0.0  # degenerate continuation directions
    d[72:80, 0] = np.nan
    pix = rng.permutation(n).astype(np.int32)
    live = rng.uniform(size=n) < 0.9
    return tri, d, pix, live


def test_dir_bin_key_matches_jax(courtyard):
    port, jscene = courtyard
    t2c = pt.triangle_clusters(port)
    jt2c = _jax_t2c(jscene)
    np.testing.assert_array_equal(t2c.numpy(), np.asarray(jt2c))
    namespace = _jax_dir_bin_key()
    namespace["t2c"] = jt2c
    tri, d, pix, live = _key_inputs(port.num_triangles)
    want = np.asarray(namespace["_dir_bin_key"](jnp.asarray(tri), jnp.asarray(d),
                                                jnp.asarray(pix), jnp.asarray(live)))
    got = pt._dir_bin_key(t2c, torch.from_numpy(tri), torch.from_numpy(d),
                          torch.from_numpy(pix), torch.from_numpy(live))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_dir_bin_key_orders_as_dir_key_order(courtyard):
    """On live lanes with a hit the key orders lanes as dir_key_order does,
    the port's prof/diag_iters.py and the JAX package's."""
    port, jscene = courtyard
    tri, d, pix, _ = _key_inputs(port.num_triangles, seed=4)
    tri = np.abs(tri)
    d = d[80:]
    tri, pix = tri[80:], pix[80:]
    key = pt._dir_bin_key(pt.triangle_clusters(port), torch.from_numpy(tri), torch.from_numpy(d),
                          torch.from_numpy(pix), torch.ones(tri.shape[0], dtype=torch.bool))
    order = torch.argsort(key, stable=True).numpy()
    np.testing.assert_array_equal(
        order, diag_iters.dir_key_order(diag_iters.scene_tri_clusters(port), d, tri))
    spec = importlib.util.spec_from_file_location("jax_diag_iters", ROOT / "prof" / "diag_iters.py")
    jax_diag = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_diag)
    np.testing.assert_array_equal(order, jax_diag.dir_key_order(jscene, d, tri))


def test_key_bands(courtyard):
    """Hit lanes before lanes that regenerate (by pixel), finished lanes
    last."""
    port, _ = courtyard
    t2c = pt.triangle_clusters(port)
    tri = torch.tensor([5, -1, -1, 7], dtype=torch.int32)
    d = torch.tensor([[0.0, 1.0, 0.0]] * 4)
    pix = torch.tensor([9, 3, 2, 1], dtype=torch.int32)
    live = torch.tensor([True, True, True, False])
    key = pt._dir_bin_key(t2c, tri, d, pix, live)
    assert key[0] < pt._REGEN_KEY
    assert key[1].item() == pt._REGEN_KEY + 3 and key[2].item() == pt._REGEN_KEY + 2
    assert key[3].item() == pt._DEAD_KEY
