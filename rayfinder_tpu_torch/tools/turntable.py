"""CLI: headless interactive-loop analog -- orbit the camera and write frames.

    python -m rayfinder_tpu_torch.tools.turntable scene.glb --outdir turntable/
    python -m rayfinder_tpu_torch.tools.turntable scene.pt --device cpu --engine plain

Counterpart of `rayfinder_tpu.tools.turntable`. Replaces the reference's
windowed frame loop (src/pt/main.cpp + GLFW): orbits the camera, renders
each frame with the progressive Renderer (resetting accumulation on camera
motion, like the reference's setRenderParameters), and writes numbered
PNGs with the PassTimer's rolling frame time, fenced on the device.
"""

from __future__ import annotations

import argparse
import math
import pathlib
import sys

import numpy as np


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("scene", type=pathlib.Path)
    parser.add_argument("--outdir", type=pathlib.Path, default=pathlib.Path("turntable"))
    parser.add_argument("--frames", type=int, default=8)
    parser.add_argument("--width", type=int, default=320)
    parser.add_argument("--height", type=int, default=240)
    parser.add_argument("--spp", type=int, default=8)
    parser.add_argument("--bounces", type=int, default=2)
    parser.add_argument("--radius", type=float, default=2.5)
    parser.add_argument("--engine", default="kernel")
    parser.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = parser.parse_args(argv)

    from ..render.camera import create_camera
    from ..render.pathtracer import SamplingParams
    from ..render.renderer import Renderer, RenderParameters, Sky
    from ..render.scene import load_device_scene
    from ..utils.image import write_png
    from ..utils.profiling import PassTimer

    scene = load_device_scene(args.scene, device=args.device)
    lo = scene.bvh_aabb_min[0].cpu().numpy()
    hi = scene.bvh_aabb_max[0].cpu().numpy()
    center = 0.5 * (lo + hi)

    args.outdir.mkdir(parents=True, exist_ok=True)
    timer = PassTimer()
    renderer = None
    for frame in range(args.frames):
        angle = 2.0 * math.pi * frame / args.frames
        origin = center + args.radius * np.asarray(
            [math.cos(angle), 0.6, math.sin(angle)]
        )
        cam = create_camera(
            origin, center, 0.0, 1.0, 70.0, args.width / args.height
        )
        params = RenderParameters(
            width=args.width,
            height=args.height,
            camera=cam,
            sampling=SamplingParams(args.spp, args.bounces),
            sky=Sky(),
            exposure=0.25,
        )
        if renderer is None:
            renderer = Renderer(scene, params, engine=args.engine)
        else:
            # Camera moved: accumulation resets, frame counter keeps running
            # (reference_path_tracer.cpp:556-563).
            renderer.set_render_parameters(params)
        with timer.section("frame", fence_value=scene.tri_positions):
            renderer.render(num_frames=args.spp)
            img = renderer.image()
        out = args.outdir / f"frame_{frame:03d}.png"
        write_png(out, img)
        print(f"{out}  {timer.report()}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
