"""CLI: headless path-traced render of a glTF/.pt scene to PNG.

    python -m rayfinder_tpu_torch.tools.render procedural:courtyard:26 -o out.png
    python -m rayfinder_tpu_torch.tools.render scene.glb --device cpu --engine plain
    python -m torch.distributed.run --nproc-per-node 4 -m rayfinder_tpu_torch.tools.render \
        procedural:courtyard:26 -o out.png --mesh 2x2 [--backend gloo|nccl]

Counterpart of `rayfinder_tpu.tools.render`, the offline replacement for the
reference's interactive `pt` viewer (src/pt/main.cpp): all ImGui parameters
(spp, bounces, sun zenith/azimuth, turbidity, vfov, exposure stops, camera
pose) become flags with the same defaults (main.cpp:46-60,
fly_camera_controller.hpp:47-56). Renders through `render_image` on the
card unless --device names another device.

With --mesh TILESxSAMPLES it renders across ranks through
`parallel.sharding.render_image_sharded_regen`: run it under
`torch.distributed.run` with TILES x SAMPLES processes; --spp must be a
multiple of SAMPLES. --backend is the process group's backend: nccl (the
default) for one rank per card, gloo for the CPU (--device cpu) or for
several ranks that share a card. Each rank renders on cuda:{LOCAL_RANK %
device count} (or the CPU), and rank 0 alone writes the PNG.
"""

from __future__ import annotations

import argparse
import pathlib
import sys
import time

import numpy as np

ENGINES = ["kernel", "kernel_split", "plain", "reference", "wavefront"]


def auto_frame(scene, dtype=None):
    """(origin, look_at) from the root AABB, like bvh-visualizer
    (main.cpp:36-55): centroid - (-0.8 d, 0, 0.8 d) with d the root box's
    largest extent (maxDimension tie-breaking, aabb.hpp:33-48), the offset
    as an array of `dtype` (numpy's choice when None)."""
    lo = scene.bvh_aabb_min[0].cpu().numpy()
    hi = scene.bvh_aabb_max[0].cpu().numpy()
    diag = hi - lo
    centroid = 0.5 * (lo + hi)
    if diag[0] > diag[1] and diag[0] > diag[2]:
        max_dim = 0
    elif diag[1] > diag[2]:
        max_dim = 1
    else:
        max_dim = 2
    offset = np.asarray([-0.8 * diag[max_dim], 0.0, 0.8 * diag[max_dim]], dtype=dtype)
    return centroid - offset, centroid


def load_scene(scene_arg: str, device, textured: bool = False):
    """A .glb/.gltf or .pt file, or procedural:courtyard[:subdiv] (subdiv 8
    when not given; the CLIs refuse another procedural name), on
    `device`."""
    from ..render.scene import build_device_scene, load_device_scene
    from ..scene.procedural import courtyard_scene

    if not scene_arg.startswith("procedural:"):
        return load_device_scene(scene_arg, device=device)
    parts = scene_arg.split(":")
    subdiv = int(parts[2]) if len(parts) > 2 else 8
    flat, textures = courtyard_scene(subdiv, textured=textured)
    return build_device_scene(flat, textures=textures, device=device)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument(
        "scene", type=pathlib.Path,
        help=".glb/.gltf or .pt scene, or procedural:courtyard[:subdiv] "
        "(the built-in Sponza-scale interior; subdiv 26 = 254K tris)",
    )
    parser.add_argument("-o", "--output", type=pathlib.Path, default=pathlib.Path("render.png"))
    parser.add_argument("--width", type=int, default=640)
    parser.add_argument("--height", type=int, default=480)
    parser.add_argument("--spp", type=int, default=64, help="samples per pixel (UI default 64)")
    parser.add_argument("--bounces", type=int, default=2, help="path bounces (UI default 2)")
    parser.add_argument("--vfov", type=float, default=70.0)
    parser.add_argument("--sun-zenith", type=float, default=30.0)
    parser.add_argument("--sun-azimuth", type=float, default=0.0)
    parser.add_argument("--turbidity", type=float, default=1.0)
    parser.add_argument("--albedo", type=float, nargs=3, default=[1.0, 1.0, 1.0])
    parser.add_argument("--exposure-stops", type=int, default=2, help="exposure = 2^-stops")
    parser.add_argument("--aperture", type=float, default=0.0)
    parser.add_argument("--focus-distance", type=float, default=10.0)
    parser.add_argument("--camera-origin", type=float, nargs=3, default=None)
    parser.add_argument("--camera-look-at", type=float, nargs=3, default=None)
    parser.add_argument(
        "--engine", choices=ENGINES, default="kernel",
        help="kernel: the CUDA kernels (default); kernel_split: the unfused loop over "
        "the ray-query kernels; plain / reference: the torch walks; wavefront: the "
        "cluster engine in torch",
    )
    parser.add_argument("--device", default="cuda", help="torch device (default cuda)")
    parser.add_argument(
        "--mesh", default=None, metavar="TILESxSAMPLES",
        help="render across ranks, e.g. 2x2 = 2-way pixel-tile sharding x 2-way sample "
        "sharding (run under torch.distributed.run with TILES*SAMPLES processes; "
        "spp must be a multiple of SAMPLES)",
    )
    parser.add_argument("--backend", choices=["nccl", "gloo"], default="nccl",
                        help="process-group backend of --mesh (default nccl: one rank per card)")
    args = parser.parse_args(argv)

    from ..render.camera import create_camera
    from ..render.pathtracer import SamplingParams, render_image
    from ..sky.model import sky_state_from_ui
    from ..utils.image import write_png

    scene_arg = str(args.scene)
    if scene_arg.startswith("procedural:") and scene_arg.split(":")[1] != "courtyard":
        parser.error(f"unknown procedural scene {scene_arg.split(':')[1]!r}")
    mesh = None
    device = args.device
    if args.mesh is not None:
        mesh = _init_mesh(parser, args)
        device = mesh.device
    scene = load_scene(scene_arg, device)
    leader = mesh is None or (mesh.tile_rank, mesh.sample_rank) == (0, 0)
    if leader:
        print(f"scene: {scene.num_triangles} triangles, {scene.num_nodes} BVH nodes")

    if args.camera_origin is None or args.camera_look_at is None:
        auto_origin, auto_look_at = auto_frame(scene)
        origin = args.camera_origin or auto_origin
        look_at = args.camera_look_at or auto_look_at
    else:
        origin, look_at = args.camera_origin, args.camera_look_at

    camera = create_camera(
        origin,
        look_at,
        args.aperture,
        args.focus_distance,
        args.vfov,
        args.width / args.height,
    )
    sky = sky_state_from_ui(args.turbidity, tuple(args.albedo), args.sun_zenith, args.sun_azimuth)

    t0 = time.time()
    if mesh is None:
        img = render_image(
            scene,
            sky,
            camera,
            width=args.width,
            height=args.height,
            sampling=SamplingParams(args.spp, args.bounces),
            exposure=2.0 ** -args.exposure_stops,
            engine=args.engine,
        )
    else:
        from ..parallel.sharding import render_image_sharded_regen

        img = render_image_sharded_regen(
            scene, sky, camera, mesh=mesh, width=args.width, height=args.height,
            spp=args.spp, num_bounces=args.bounces, exposure=2.0 ** -args.exposure_stops,
            engine=args.engine,
        )
    dt = time.time() - t0
    if leader:
        rays = args.width * args.height * args.spp * (2 * args.bounces)  # closest+shadow per bounce
        print(f"rendered {args.width}x{args.height} @ {args.spp}spp in {dt:.1f}s "
              f"(~{rays / dt / 1e6:.2f} Mrays/s)" + (f" on mesh {args.mesh}" if mesh else ""))
        write_png(args.output, img)
        print(f"wrote {args.output}")
    if mesh is not None:
        import torch.distributed as dist

        dist.destroy_process_group()
    return 0


def _init_mesh(parser, args):
    """The --mesh TILESxSAMPLES mesh over a process group that this process
    joins (torch.distributed.run sets its rank and address), after checking
    the world size and spp as the JAX tool does."""
    import os

    import torch.distributed as dist

    from ..parallel.sharding import check_backend, make_render_mesh

    parts = args.mesh.lower().split("x")
    if len(parts) != 2 or not all(p.isdigit() and int(p) > 0 for p in parts):
        parser.error(f"--mesh must be TILESxSAMPLES, got {args.mesh!r}")
    tiles, samples = (int(p) for p in parts)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if tiles * samples != world:
        parser.error(f"--mesh {args.mesh} needs {tiles * samples} processes, the world has "
                     f"{world} (run under torch.distributed.run --nproc-per-node "
                     f"{tiles * samples})")
    if args.spp % samples:
        parser.error(f"--spp {args.spp} must be a multiple of the samples axis {samples}")
    device = None if args.device == "cuda" else args.device
    check_backend(args.backend, args.device)
    dist.init_process_group(args.backend, init_method="env://")
    return make_render_mesh(sample_parallel=samples, device=device)


if __name__ == "__main__":
    sys.exit(main())
