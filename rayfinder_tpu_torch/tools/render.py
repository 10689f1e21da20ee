"""CLI: headless path-traced render of a glTF/.pt scene to PNG.

    python -m rayfinder_tpu_torch.tools.render procedural:courtyard:26 -o out.png
    python -m rayfinder_tpu_torch.tools.render scene.glb --device cpu --engine plain

Counterpart of `rayfinder_tpu.tools.render`, the offline replacement for the
reference's interactive `pt` viewer (src/pt/main.cpp): all ImGui parameters
(spp, bounces, sun zenith/azimuth, turbidity, vfov, exposure stops, camera
pose) become flags with the same defaults (main.cpp:46-60,
fly_camera_controller.hpp:47-56). Renders through `render_image` on the
card unless --device names another device. The multi-device render
(--mesh) comes with the port of `parallel/sharding.py` and is not here yet.
"""

from __future__ import annotations

import argparse
import pathlib
import sys
import time

import numpy as np

ENGINES = ["kernel", "kernel_split", "plain", "reference"]


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
        "the ray-query kernels; plain / reference: the torch walks",
    )
    parser.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = parser.parse_args(argv)

    from ..render.camera import create_camera
    from ..render.pathtracer import SamplingParams, render_image
    from ..sky.model import sky_state_from_ui
    from ..utils.image import write_png

    scene_arg = str(args.scene)
    if scene_arg.startswith("procedural:") and scene_arg.split(":")[1] != "courtyard":
        parser.error(f"unknown procedural scene {scene_arg.split(':')[1]!r}")
    scene = load_scene(scene_arg, args.device)
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
    dt = time.time() - t0
    rays = args.width * args.height * args.spp * (2 * args.bounces)  # closest+shadow per bounce
    print(f"rendered {args.width}x{args.height} @ {args.spp}spp in {dt:.1f}s "
          f"(~{rays / dt / 1e6:.2f} Mrays/s)")
    write_png(args.output, img)
    print(f"wrote {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
