"""CLI: render a grayscale BVH node-visit heatmap for primary rays.

    python -m rayfinder_tpu_torch.tools.bvh_visualizer scene.glb -o heat.png
    python -m rayfinder_tpu_torch.tools.bvh_visualizer scene.pt --device cpu

Counterpart of `rayfinder_tpu.tools.bvh_visualizer`, with parity with the
reference's bvh-visualizer (src/bvh-visualizer/main.cpp:22-88): auto-frames
a camera from the root AABB, casts one primary ray per pixel, and writes
min(0.01 * nodesVisited, 1) as an 8-bit grayscale PNG. The rays go through
the closest-hit kernel K1 on the scene's device, whose node count is the
plane walk's (ops/walk.py).
"""

from __future__ import annotations

import argparse
import pathlib
import sys

import numpy as np


def visualize(gltf_path, width: int = 1280, height: int = 720, device="cuda") -> np.ndarray:
    """The (height, width, 3) uint8 heat map of the scene file."""
    from ..render.scene import load_device_scene

    return heat_map(load_device_scene(gltf_path, device=device), width, height)[0]


def heat_camera(scene, width: int, height: int):
    """The camera framed on the root AABB (main.cpp:36-55), its offset in
    float32 as the JAX package's tool computes it."""
    from ..render.camera import create_camera
    from .render import auto_frame

    origin, centroid = auto_frame(scene, np.float32)
    return create_camera(origin, centroid, 0.0, 1.0, 70.0, width / height)


def pixel_uv(width: int, height: int):
    """(u, v) float32 of each pixel's ray, row-major: the CPU tool's grid
    (u = j / W, v = 1 - (i + 1) / H)."""
    js, is_ = np.meshgrid(np.arange(width), np.arange(height), indexing="xy")
    u = js.reshape(-1).astype(np.float32) / np.float32(width)
    v = 1.0 - (is_.reshape(-1) + 1.0).astype(np.float32) / np.float32(height)
    return u, v


def heat_map(scene, width: int, height: int):
    """The heat map of a DeviceScene, and K1's node counts (H*W,) int32 on
    its device."""
    import torch

    from ..ops.walk import intersect_closest_kernel
    from ..render.camera import generate_camera_ray

    u, v = pixel_uv(width, height)
    dev = scene.device
    o, d = generate_camera_ray(heat_camera(scene, width, height), torch.from_numpy(u).to(dev),
                               torch.from_numpy(v).to(dev))

    t_max = o.new_full((o.shape[0],), float(np.finfo(np.float32).max))
    _, _, _, visited = intersect_closest_kernel(scene, o, d, t_max)
    x = np.minimum(0.01 * visited.cpu().numpy().astype(np.float32), 1.0)
    gray = (x * 255.0).astype(np.uint8).reshape(height, width)
    return np.stack([gray, gray, gray], axis=-1), visited


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("gltf", type=pathlib.Path, help=".glb/.gltf or .pt scene")
    parser.add_argument("-o", "--output", type=pathlib.Path,
                        default=pathlib.Path("bvh-visualizer.png"))
    parser.add_argument("--width", type=int, default=1280)
    parser.add_argument("--height", type=int, default=720)
    parser.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = parser.parse_args(argv)

    from ..utils.image import write_png

    img = visualize(args.gltf, args.width, args.height, device=args.device)
    write_png(args.output, img)
    print(f"wrote {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
