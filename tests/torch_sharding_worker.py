"""The ranks of the sharded-render tests (tests/test_torch_sharding.py; no
jax): a gloo world of CPU processes, spawned with torch.multiprocessing,
each rendering courtyard_scene(4) through the port's sharded renders.
"""

import pathlib
import socket
import tempfile

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

SIZE = (16, 12)  # width, height: tests/test_sharding.py's image
SPP, BOUNCES = 4, 2
CAM = ([-16.0, 5.0, 0.0], [12.0, 2.0, 0.0], 0.0, 1.0, 70.0, SIZE[0] / SIZE[1])
SKY = (2.5, (0.3, 0.3, 0.3), 35.0, 25.0)
# Image names and how each rank renders them: (function, engine).
RENDERS = {"scan_reference": ("render_image_sharded", "reference"),
           "scan_wavefront": ("render_image_sharded", "wavefront"),
           "regen_kernel": ("render_image_sharded_regen", "kernel")}


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _rank(rank: int, world: int, port: int, samples: int, outdir: str) -> None:
    from rayfinder_tpu_torch.parallel import sharding
    from rayfinder_tpu_torch.render.camera import create_camera
    from rayfinder_tpu_torch.render.scene import build_device_scene
    from rayfinder_tpu_torch.scene.procedural import courtyard_scene
    from rayfinder_tpu_torch.sky.model import sky_state_from_ui

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world)
    default = sharding.make_render_mesh(device="cpu")
    mesh = sharding.make_render_mesh(sample_parallel=samples, device="cpu")
    flat, textures = courtyard_scene(4)
    scene = build_device_scene(flat, textures=textures, device="cpu")
    cam, sky = create_camera(*CAM), sky_state_from_ui(*SKY)
    out = dict(shape=[mesh.shape["tiles"], mesh.shape["samples"]],
               place=[mesh.tile_rank, mesh.sample_rank],
               default_shape=[default.shape["tiles"], default.shape["samples"]])
    for name, (fn, engine) in RENDERS.items():
        out[name] = getattr(sharding, fn)(scene, sky, cam, mesh=mesh, width=SIZE[0],
                                          height=SIZE[1], spp=SPP, num_bounces=BOUNCES,
                                          exposure=0.25, engine=engine)
    np.savez(pathlib.Path(outdir) / f"rank{rank}.npz", **out)
    dist.destroy_process_group()


# Meshes over parts of a world of four: (their ranks, sample_parallel).
SUBGROUPS = {"ranks 1, 3": ([1, 3], None), "ranks 0, 2": ([0, 2], 1)}


def _subgroup_rank(rank: int, world: int, port: int, outdir: str) -> None:
    """Every rank makes both of SUBGROUPS' meshes, in the same order, and
    renders regen_kernel on the one it belongs to."""
    from rayfinder_tpu_torch.parallel import sharding
    from rayfinder_tpu_torch.render.camera import create_camera
    from rayfinder_tpu_torch.render.scene import build_device_scene
    from rayfinder_tpu_torch.scene.procedural import courtyard_scene
    from rayfinder_tpu_torch.sky.model import sky_state_from_ui

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world)
    meshes = {name: sharding.make_render_mesh(sample_parallel=samples,
                                              group=dist.new_group(ranks), device="cpu")
              for name, (ranks, samples) in SUBGROUPS.items()}
    flat, textures = courtyard_scene(4)
    scene = build_device_scene(flat, textures=textures, device="cpu")
    fn, engine = RENDERS["regen_kernel"]
    out = {"member_of": [name for name, mesh in meshes.items() if mesh is not None]}
    for name, mesh in meshes.items():
        if mesh is not None:
            out["shape"] = [mesh.shape["tiles"], mesh.shape["samples"]]
            out["place"] = [mesh.tile_rank, mesh.sample_rank]
            out["image"] = getattr(sharding, fn)(
                scene, sky_state_from_ui(*SKY), create_camera(*CAM), mesh=mesh, width=SIZE[0],
                height=SIZE[1], spp=SPP, num_bounces=BOUNCES, exposure=0.25, engine=engine)
    np.savez(pathlib.Path(outdir) / f"rank{rank}.npz", **out)
    dist.destroy_process_group()


def run_subgroups() -> list[dict]:
    """Spawn a gloo world of four ranks making SUBGROUPS' meshes; returns
    each rank's results."""
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_subgroup_rank, args=(4, _free_port(), tmp), nprocs=4)
        return [dict(np.load(pathlib.Path(tmp) / f"rank{r}.npz")) for r in range(4)]


def run_mesh(tiles: int, samples: int) -> list[dict]:
    """Spawn tiles x samples gloo ranks; returns each rank's results."""
    world = tiles * samples
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_rank, args=(world, _free_port(), samples, tmp), nprocs=world)
        return [dict(np.load(pathlib.Path(tmp) / f"rank{r}.npz")) for r in range(world)]
