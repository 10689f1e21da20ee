"""The traversal-efficiency path (prof/diag_iters.py of the port) on the CPU.

`cosine_bounce` and `dir_key_order` are held to the JAX package's
prof/diag_iters.py, imported by file path as bench.py imports it; the
dir-key permutation on the JAX scene's own cluster map. The waste
arithmetic is checked on a hand-made case, and the whole path on a small
courtyard.
"""

import importlib.util
import os
import pathlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rayfinder_tpu.render.scene import build_device_scene as jax_build
from rayfinder_tpu.scene.procedural import courtyard_scene
from rayfinder_tpu_torch.ops.slab import slab_entry_reduce
from rayfinder_tpu_torch.prof import diag_iters
from rayfinder_tpu_torch.prof.scenes import BENCH_CAMERA
from rayfinder_tpu_torch.render.camera import create_camera
from rayfinder_tpu_torch.render.intersect import T_MAX
from rayfinder_tpu_torch.render.scene import build_device_scene
from rayfinder_tpu_torch.render.traverse import intersect_closest

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def jax_diag():
    """The JAX package's prof/diag_iters.py, loaded by file path (its
    import sets an environment default, undone here)."""
    env = dict(os.environ)
    spec = importlib.util.spec_from_file_location("jax_diag_iters", ROOT / "prof" / "diag_iters.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    os.environ.clear()
    os.environ.update(env)
    return module


@pytest.fixture(scope="module")
def scenes():
    flat, textures = courtyard_scene(4)
    return (build_device_scene(flat, textures=textures, device="cpu"),
            jax_build(flat, textures=textures))


def _primary_hits(port, w=48, h=48):
    camera = create_camera(*BENCH_CAMERA, 1.0)
    o, d = diag_iters.primary_rays(camera, w, h, "cpu")
    hit, t, tri, _ = intersect_closest(port, o, d, T_MAX)
    return o.numpy(), d.numpy(), hit.numpy(), t.numpy(), tri.numpy()


def test_cosine_bounce_equals_jax(scenes, jax_diag):
    port, jscene = scenes
    o, d, hit, t, tri = _primary_hits(port)
    got = diag_iters.cosine_bounce(port, o, d, hit, t, tri, np.random.default_rng(7))
    want = jax_diag.cosine_bounce(jscene, o, d, hit, t, tri, np.random.default_rng(7))
    assert got[0].shape[0] == int(hit.sum()) > 0
    np.testing.assert_array_equal(got[0], want[0])  # numpy on both sides
    np.testing.assert_array_equal(got[2], want[2])
    # The directions (torch against jnp) agree to within one float32 step:
    # XLA's CPU compiler contracts the basis products into FMAs.
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=2.0 ** -23)


def test_dir_key_order_equals_jax_on_its_cluster_map(scenes, jax_diag):
    port, jscene = scenes
    rng = np.random.default_rng(11)
    n = 5000
    trih = rng.integers(0, port.num_triangles, n)
    dn = rng.normal(size=(n, 3)).astype(np.float32)
    dn /= np.linalg.norm(dn, axis=1, keepdims=True)
    dn[::50] = np.asarray([0.0, 1.0, 0.0], np.float32)  # ties across faces
    tri_cluster = diag_iters.scene_tri_clusters(port)
    got = diag_iters.dir_key_order(tri_cluster, dn, trih)
    want = jax_diag.dir_key_order(jscene, dn, trih)
    np.testing.assert_array_equal(got, want)
    # The port's clusters are contiguous leaf-order ranges of <= 128.
    sizes = np.bincount(tri_cluster)
    assert tri_cluster[0] == 0 and np.all(np.diff(tri_cluster) >= 0) and sizes.max() <= 128


def test_waste_on_a_hand_made_case():
    """Two warps: the first issues 32 x 5 tests for its slowest ray, the
    second none; the lanes issue 36 and need 30."""
    tests = np.zeros(64, np.int64)
    tests[:32] = 1
    tests[3] = 5
    need = np.zeros(64, np.int64)
    need[:30] = 1
    f = diag_iters.waste(tests, need)
    assert (f["issued_warp"], f["issued_lane"], f["need"]) == (160, 36, 30)
    assert f["mt_waste"] == pytest.approx(100 * (1 - 30 / 160))
    assert f["mt_waste_lane"] == pytest.approx(100 * (1 - 30 / 36))
    # A ragged last warp is padded with rays that test nothing.
    ragged = tests[:40].copy()
    ragged[35] = 2
    assert diag_iters.waste(ragged, need[:40])["issued_warp"] == 32 * 5 + 32 * 2


def test_need_counts_the_hit_leaf_and_stays_within_the_tests(scenes):
    """need is K7's count of leaves entered before the hit plus the hit's
    own leaf where its flat box is entered at t exactly; a front-to-back
    walk tests all of them, so need <= triangle tests on every ray."""
    port, _ = scenes
    boxes = diag_iters.leaf_boxes(port)
    assert bool((boxes[3][1:] > boxes[3][:-1]).all())
    camera = create_camera(*BENCH_CAMERA, 1.0)
    o, d = diag_iters.primary_rays(camera, 32, 32, "cpu")
    r = diag_iters.measure(port, boxes, o, d)
    need, tests = r["need"].numpy(), r["counts"][:, 2].numpy()
    before, _, _ = slab_entry_reduce(boxes[0], boxes[1], boxes[2], o, 1.0 / d, r["bound"],
                                     diag_iters.GROUP)
    own = boxes[2][torch.searchsorted(boxes[3], r["tri"].clamp(min=0), right=True) - 1]
    hit = r["hit"].numpy()
    np.testing.assert_array_equal(np.maximum(need - before.numpy(), 0)[~hit], 0)
    assert bool((need[hit] - before.numpy()[hit] <= own.numpy()[hit]).all())
    assert bool((need[hit] >= 1).all())
    assert r["need_over_tests"].size == 0 and bool((need <= tests).all())
    # Floor and wall leaves are flat: the table alone misses some hit leaves.
    assert int((need - before.numpy()).sum()) > 0


def test_traversal_efficiency_on_a_small_courtyard(scenes):
    port, _ = scenes
    camera = create_camera(*BENCH_CAMERA, 1.0)
    fields = diag_iters.traversal_efficiency(port, camera, 32, 32)
    for pop in ("primary", "bounce1", "bounce2"):
        assert 0.0 <= fields[f"mt_waste_lane_{pop}"] <= fields[f"mt_waste_{pop}"] < 100.0
        assert fields[f"need_over_tests_{pop}"] == []
        assert fields[f"need_per_ray_{pop}"] <= fields[f"tests_per_ray_{pop}"]
        assert fields[f"nodes_per_ray_{pop}"] > 1.0


def test_bench_primary_rays_equal_jax_pinhole_rays():
    """The bench's primary rays (pixel centres, v from the top, no lens):
    the port's thin-lens ray with zero aperture against JAX's pinhole ray."""
    from rayfinder_tpu.render.camera import create_camera as jax_camera
    from rayfinder_tpu.render.camera import generate_camera_ray

    w = h = 16
    o, d = diag_iters.primary_rays(create_camera(*BENCH_CAMERA, 1.0), w, h, "cpu")
    js, is_ = np.meshgrid(np.arange(w), np.arange(h), indexing="xy")
    u = (js.reshape(-1) + 0.5).astype(np.float32) / w
    v = 1.0 - (is_.reshape(-1) + 0.5).astype(np.float32) / h
    jo, jd = generate_camera_ray(jax_camera(*BENCH_CAMERA, 1.0), jnp.asarray(u), jnp.asarray(v))
    np.testing.assert_array_equal(o.numpy(), np.asarray(jo))
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=0, atol=2e-7)
