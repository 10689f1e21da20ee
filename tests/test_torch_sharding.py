"""The port's sharded renders (parallel/sharding.py over torch.distributed)
against the JAX package's (rayfinder_tpu.parallel.sharding over a device
mesh) and against the port's single-device render.

Gloo worlds of CPU processes (tests/torch_sharding_worker.py) at 2x2, 4x1
and 1x4 render courtyard_scene(4) at tests/test_sharding.py's size; the JAX
package renders the same on four of its eight virtual CPU devices. Budgets:
the scan form at tests/test_sharding.py's rtol 1e-5 / atol 1e-6, the
regeneration loop against JAX `engine="reference"` at the regen budget of
tests/test_pallas_regen.py (rtol 2e-4 / atol 1e-5).
"""

import inspect
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from rayfinder_tpu.parallel import sharding as jax_sharding
from rayfinder_tpu.render.camera import create_camera as jax_camera
from rayfinder_tpu.render.scene import build_device_scene as jax_build
from rayfinder_tpu.scene.procedural import courtyard_scene
from rayfinder_tpu.sky.model import sky_state_from_ui as jax_sky
from rayfinder_tpu_torch.parallel import sharding
from rayfinder_tpu_torch.render.camera import create_camera
from rayfinder_tpu_torch.render.pathtracer import SamplingParams, render_image
from rayfinder_tpu_torch.render.scene import build_device_scene
from rayfinder_tpu_torch.sky.model import sky_state_from_ui
from rayfinder_tpu_torch.tools import render as render_tool
from rayfinder_tpu_torch.utils.image import read_png
from torch_sharding_worker import (
    BOUNCES, CAM, RENDERS, SIZE, SKY, SPP, SUBGROUPS, run_mesh, run_subgroups,
)

ROOT = pathlib.Path(__file__).resolve().parent.parent
MESHES = [(2, 2), (4, 1), (1, 4)]
JAX_ENGINES = {"scan_reference": "reference", "scan_wavefront": "wavefront",
               "regen_kernel": "reference"}


@pytest.fixture(scope="module")
def port_ranks():
    """{(tiles, samples): each rank's results}, one spawned world per mesh."""
    return {mesh: run_mesh(*mesh) for mesh in MESHES}


@pytest.fixture(scope="module")
def jax_scene():
    flat, textures = courtyard_scene(4)
    return jax_build(flat, textures=textures)


@pytest.fixture(scope="module")
def single():
    """The port's single-device render (render_image, the default route)."""
    flat, textures = courtyard_scene(4)
    scene = build_device_scene(flat, textures=textures, device="cpu")
    return render_image(scene, sky_state_from_ui(*SKY), create_camera(*CAM), width=SIZE[0],
                        height=SIZE[1], sampling=SamplingParams(SPP, BOUNCES), exposure=0.25)


def _jax_render(jscene, mesh, name):
    tiles, samples = mesh
    jmesh = jax_sharding.make_render_mesh(jax.devices()[:tiles * samples],
                                          sample_parallel=samples)
    fn = (jax_sharding.render_image_sharded_regen if name.startswith("regen")
          else jax_sharding.render_image_sharded)
    return fn(jscene, jax_sky(*SKY), jax_camera(*CAM), mesh=jmesh, width=SIZE[0],
              height=SIZE[1], spp=SPP, num_bounces=BOUNCES, exposure=0.25,
              engine=JAX_ENGINES[name])


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_mesh_shapes_and_places(port_ranks, mesh):
    tiles, samples = mesh
    for r, rank in enumerate(port_ranks[mesh]):
        assert list(rank["shape"]) == [tiles, samples]
        assert list(rank["place"]) == [r // samples, r % samples]  # rank = tile x s + sample
        assert list(rank["default_shape"]) == [2, 2]  # a world of 4: 2 samples by default


@pytest.mark.parametrize("name", list(RENDERS))
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_sharded_matches_jax(port_ranks, jax_scene, mesh, name):
    if len(jax.devices()) < 4:
        pytest.fail("the JAX package needs its virtual CPU devices (tests/conftest.py)")
    ranks = port_ranks[mesh]
    for rank in ranks[1:]:
        assert np.array_equal(rank[name], ranks[0][name])  # every rank returns the image
    want = np.asarray(_jax_render(jax_scene, mesh, name))
    got = ranks[0][name]
    assert got.shape == want.shape == (SIZE[1], SIZE[0], 3)
    rtol, atol = (2e-4, 1e-5) if name.startswith("regen") else (1e-5, 1e-6)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


@pytest.mark.parametrize("name", list(RENDERS))
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_sharded_matches_single_device(port_ranks, single, mesh, name):
    np.testing.assert_allclose(port_ranks[mesh][0][name], single, rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def subgroup_ranks():
    """Each rank's results in a world of four that makes SUBGROUPS' meshes."""
    return run_subgroups()


@pytest.mark.parametrize("name", list(SUBGROUPS))
def test_mesh_over_part_of_the_world(subgroup_ranks, single, name):
    """make_render_mesh(group=...): a mesh over two of four ranks, made by
    every rank of the world. Its members render the single-device image;
    the other ranks get None."""
    members, samples = SUBGROUPS[name]
    shape = [2, 1] if samples == 1 else [1, 2]
    for r, rank in enumerate(subgroup_ranks):
        assert (name in rank["member_of"]) == (r in members)
    for i, r in enumerate(members):
        rank = subgroup_ranks[r]
        assert list(rank["member_of"]) == [name]
        assert list(rank["shape"]) == shape
        assert list(rank["place"]) == [i // shape[1], i % shape[1]]
        np.testing.assert_allclose(rank["image"], single, rtol=1e-5, atol=1e-6)


def test_nccl_is_refused_on_cpu_tensors(monkeypatch):
    with pytest.raises(ValueError, match="nccl backend serves CUDA tensors"):
        sharding.check_backend("nccl", "cpu")
    sharding.check_backend("gloo", "cpu")
    with pytest.raises(ValueError, match="mpi"):
        sharding.check_backend("mpi", "cpu")
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(ValueError, match="nccl backend serves CUDA tensors"):
        render_tool.main(["procedural:courtyard:2", "--mesh", "1x1", "--backend", "nccl",
                          "--device", "cpu"])


def test_mesh_arguments_are_checked(monkeypatch, capsys):
    monkeypatch.setenv("WORLD_SIZE", "2")
    for argv, message in ((["--mesh", "2x2"], "needs 4 processes"),
                          (["--mesh", "1x2", "--spp", "3"], "multiple of the samples axis"),
                          (["--mesh", "2by1"], "TILESxSAMPLES")):
        with pytest.raises(SystemExit):
            render_tool.main(["procedural:courtyard:2", "--device", "cpu", "--backend", "gloo",
                              *argv])
        assert message in capsys.readouterr().err


def test_rank_renders_only_on_its_device():
    """A scene or accumulator on another device than the mesh's raises
    before anything is rendered."""
    flat, textures = courtyard_scene(2)
    scene = build_device_scene(flat, textures=textures, device="cpu")
    mesh = sharding.RenderMesh(shape={"tiles": 1, "samples": 1}, tile_rank=0, sample_rank=0,
                               device=torch.device("meta"), group=None, samples_group=None)
    tile = torch.zeros(128, 128, 2, device="meta")
    for step in (sharding.render_step_sharded, sharding.render_step_sharded_regen):
        kw = dict(num_frames=1) if step is sharding.render_step_sharded_regen else {}
        with pytest.raises(ValueError, match="this rank renders on meta"):
            step(scene, sky_state_from_ui(*SKY), create_camera(*CAM), tile, 0,
                 torch.zeros(4, 3, device="meta"), mesh=mesh, width=2, height=2, num_bounces=1,
                 spp=1, **kw)


def test_every_sharded_render_defaults_to_the_kernels():
    """"kernel" is the default of the scan form's pair too, where the JAX
    package defaults to "wavefront"; the tests above name every engine."""
    for fn in (sharding.render_step_sharded, sharding.render_image_sharded,
               sharding.render_step_sharded_regen, sharding.render_image_sharded_regen):
        assert inspect.signature(fn).parameters["engine"].default == "kernel", fn.__name__
    assert inspect.signature(jax_sharding.render_image_sharded).parameters[
        "engine"].default == "wavefront"


def test_make_render_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="initialised"):
        sharding.make_render_mesh(device="cpu")


def test_render_tool_mesh_under_torch_distributed_run(tmp_path):
    """tools/render.py --mesh 2x1 --backend gloo --device cpu under
    torch.distributed.run: rank 0 writes the PNG, which equals the
    single-device tool's (tiles alone change no pixel)."""
    common = ["procedural:courtyard:2", "--width", "16", "--height", "12", "--spp", "2",
              "--bounces", "2", "--device", "cpu", "--engine", "plain"]
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    meshed = tmp_path / "mesh.png"
    done = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
         "-m", "rayfinder_tpu_torch.tools.render", *common, "-o", str(meshed), "--mesh", "2x1",
         "--backend", "gloo"],
        cwd=ROOT, capture_output=True, text=True, timeout=300, env=env)
    assert done.returncode == 0, done.stderr[-3000:]
    assert done.stdout.count("wrote ") == 1  # rank 0 alone
    plain = tmp_path / "single.png"
    assert render_tool.main([*common, "-o", str(plain)]) == 0
    assert np.array_equal(read_png(meshed), read_png(plain))
