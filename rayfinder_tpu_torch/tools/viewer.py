"""Headless interactive viewer: the reference's live loop, without a window.

    python -m rayfinder_tpu_torch.tools.viewer procedural:courtyard:26 --script cmds.txt
    python -m rayfinder_tpu_torch.tools.viewer scene.glb --device cpu --engine plain

Counterpart of `rayfinder_tpu.tools.viewer`. The reference is at its core an
interactive app: `main.cpp:104-434` polls a GLFW window (`window.cpp:159-209`),
feeds WASD/mouse to the FlyCameraController, right-click picks the focus
distance via a BVH raycast (`main.cpp:198-227`), and ImGui shows per-pass ms
and render progress. This tool reproduces that loop headlessly: a
progressive render rewrites the output PNG every batch of samples with a
live console readout (progress %, rolling pass ms, exact Mrays/s from the
render loop's ray counts), while one-line commands -- from stdin
(interactive) or a script file -- drive the same FlyCameraController and
focus pick. Any camera or parameter change resets accumulation, like the
reference (`reference_path_tracer.cpp:556-563`). It renders on the card
unless --device names another device.

Commands (one per line; `#` comments and blank lines ignored):
  w/a/s/d/q/e [secs]     fly (W fwd, S back, A/D strafe, E up, Q down)
  look DX DY             mouse-look by a pixel delta (LMB-drag analog)
  pick X Y               right-click focus pick at window pixel (X, Y)
  lookat X Y Z           aim the camera at a world point
  speed V | vfov V       controller parameters (ImGui sliders)
  spp N | bounces N      sampling parameters ({8,64,512} / {2,4,8} in the UI)
  sun ZENITH AZIMUTH     sun direction degrees (ImGui sliders)
  renderer MODE          pt | deferred | debug (the ImGui renderer radio,
                         main.cpp:235-247; deferred frames TAA-accumulate,
                         debug writes the G-buffer triptych)
  frames N               render N progressive frames, then rewrite the PNG
  wait                   render to the spp target, rewriting every batch
  status                 print the readout line without rendering
  quit                   exit
"""

from __future__ import annotations

import argparse
import dataclasses
import pathlib
import sys
import time

import numpy as np

from ..render.deferred import DeferredRenderer
from ..render.fly_camera import FlyCameraController, FlyInput, pick_focus_distance
from ..render.pathtracer import SamplingParams
from ..render.renderer import Renderer, RenderParameters, Sky
from ..utils import profiling
from ..utils.image import write_png
from .render import ENGINES, load_scene

_MOVE_KEYS = {
    "w": "forward", "s": "backward", "a": "left",
    "d": "right", "e": "up", "q": "down",
}


class ViewerSession:
    """State machine behind the CLI: applies commands to the fly camera and
    renderers, writes the progressive PNG, and reports progress."""

    def __init__(
        self,
        scene,
        out_path,
        *,
        width: int = 640,
        height: int = 480,
        spp: int = 64,
        bounces: int = 2,
        sky: Sky | None = None,
        exposure: float = 0.25,
        engine: str = "kernel",
        batch: int = 8,
    ):
        self.scene = scene
        self.out_path = pathlib.Path(out_path)
        self.controller = FlyCameraController((width, height))
        self.sky = sky if sky is not None else Sky()
        self.exposure = exposure
        self.spp = spp
        self.bounces = bounces
        self.batch = batch
        self.width, self.height = width, height
        self.engine = engine
        self.renderer = Renderer(
            scene, self._params(), engine=engine, count_rays=True
        )
        self.mode = "pt"  # pt | deferred | debug (the ImGui renderer radio)
        self._deferred = None
        self._render_seconds = 0.0

    def _params(self) -> RenderParameters:
        return RenderParameters(
            width=self.width,
            height=self.height,
            camera=self.controller.camera(),
            sampling=SamplingParams(self.spp, self.bounces),
            sky=self.sky,
            exposure=self.exposure,
        )

    def _sync(self) -> None:
        """Push controller/parameter state into the renderer (a real change
        resets accumulation, reference_path_tracer.cpp:556-563). The deferred
        renderer's TAA history is viewpoint-dependent, so it resets too."""
        self.renderer.set_render_parameters(self._params())
        if self._deferred is not None:
            self._deferred.invalidate_temporal_accumulation()

    def _deferred_renderer(self) -> DeferredRenderer:
        if self._deferred is None:
            self._deferred = DeferredRenderer(
                self.scene, self.width, self.height, engine=self.engine
            )
        return self._deferred

    def status(self) -> str:
        if self.mode != "pt":
            dr = self._deferred_renderer()
            stats = " ".join(
                f"{k}={v:.1f}ms" for k, v in dr.perf_stats().items()
            )
            return (
                f"[{self.mode} frame {dr.frame_count}] {stats} "
                f"pos={np.round(self.controller.position, 3).tolist()}"
            )
        r = self.renderer
        mrays = ""
        if r.total_rays and self._render_seconds > 0:
            mrays = f" {r.total_rays / self._render_seconds / 1e6:7.2f} Mrays/s"
        return (
            f"[{r.accumulated_sample_count}/{self.spp} spp "
            f"{r.render_progress_percentage():5.1f}%] "
            f"{r.average_render_pass_duration_ms():7.1f} ms/frame{mrays} "
            f"pos={np.round(self.controller.position, 3).tolist()} "
            f"focus={self.controller.focus_distance:.3f}"
        )

    def render_frames(self, n: int) -> str:
        if self.mode != "pt":
            dr = self._deferred_renderer()
            cam = self.controller.camera()
            if self.mode == "deferred":
                img = None
                for _ in range(max(1, n)):
                    img = dr.render(cam, self.sky.state(), self.exposure)
            else:
                img = dr.render_debug(cam)
            write_png(self.out_path, img)
            return self.status()
        t0 = time.perf_counter()
        self.renderer.render(n)
        # The 8-bit frame is tonemapped and quantized on the device; its copy
        # ends the timed span, and it is what the PNG holds.
        img = self.renderer.image_u8()
        self._render_seconds += time.perf_counter() - t0
        write_png(self.out_path, img)
        return self.status()

    def handle(self, line: str) -> bool:
        """Apply one command line. Returns False when the session should
        quit. Prints one readout line per rendering command."""
        tok = line.split("#", 1)[0].split()
        if not tok:
            return True
        cmd, args = tok[0].lower(), tok[1:]
        if cmd in ("quit", "exit"):
            return False
        if cmd in _MOVE_KEYS:
            secs = float(args[0]) if args else 1.0
            self.controller.update(FlyInput(**{_MOVE_KEYS[cmd]: True}), secs)
            self._sync()
        elif cmd == "look":
            dx, dy = float(args[0]), float(args[1])
            w, h = self.controller.window_size
            cx, cy = w / 2, h / 2
            self.controller.update(
                FlyInput(mouse_look=False, mouse_x=cx, mouse_y=cy), 0.0
            )
            self.controller.update(
                FlyInput(mouse_look=True, mouse_x=cx + dx, mouse_y=cy + dy), 0.0
            )
            self._sync()
        elif cmd == "pick":
            focus = pick_focus_distance(
                self.scene, self.controller, float(args[0]), float(args[1])
            )
            print(f"pick: {'miss' if focus is None else f'focus={focus:.4f}'}")
            self._sync()
        elif cmd == "lookat":
            self.controller.look_at([float(a) for a in args[:3]])
            self._sync()
        elif cmd == "speed":
            self.controller.speed = float(args[0])
        elif cmd == "vfov":
            self.controller.vfov_degrees = float(args[0])
            self._sync()
        elif cmd == "spp":
            self.spp = int(args[0])
            self._sync()
        elif cmd == "bounces":
            self.bounces = int(args[0])
            self._sync()
        elif cmd == "sun":
            self.sky = dataclasses.replace(
                self.sky,
                sun_zenith_degrees=float(args[0]),
                sun_azimuth_degrees=float(args[1]),
            )
            self._sync()
        elif cmd == "renderer":
            mode = args[0].lower()
            if mode not in ("pt", "deferred", "debug"):
                print(f"viewer: unknown renderer {mode!r}", file=sys.stderr)
            else:
                self.mode = mode
        elif cmd == "frames":
            print(self.render_frames(int(args[0])))
        elif cmd == "wait":
            if self.mode != "pt":
                print(self.render_frames(1))
            else:
                while self.renderer.accumulated_sample_count < self.spp:
                    print(self.render_frames(self.batch))
        elif cmd == "status":
            print(self.status())
        else:
            print(f"viewer: unknown command {cmd!r}", file=sys.stderr)
        return True


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter
    )
    parser.add_argument(
        "scene",
        help=".glb/.gltf or .pt scene, or procedural:courtyard[:subdiv]",
    )
    parser.add_argument("-o", "--output", type=pathlib.Path,
                        default=pathlib.Path("viewer.png"))
    parser.add_argument("--width", type=int, default=640)
    parser.add_argument("--height", type=int, default=480)
    parser.add_argument("--spp", type=int, default=64)
    parser.add_argument("--bounces", type=int, default=2)
    parser.add_argument("--turbidity", type=float, default=1.0)
    parser.add_argument("--sun-zenith", type=float, default=30.0)
    parser.add_argument("--sun-azimuth", type=float, default=0.0)
    parser.add_argument("--exposure-stops", type=int, default=2)
    parser.add_argument("--engine", choices=ENGINES, default="kernel")
    parser.add_argument("--device", default="cuda", help="torch device (default cuda)")
    parser.add_argument("--batch", type=int, default=8,
                        help="samples per PNG rewrite in `wait`")
    parser.add_argument("--script", type=pathlib.Path, default=None,
                        help="command file (default: interactive stdin)")
    args = parser.parse_args(argv)

    scene_arg = str(args.scene)
    if scene_arg.startswith("procedural:") and scene_arg.split(":")[1] != "courtyard":
        parser.error(f"unknown procedural scene {scene_arg.split(':')[1]!r}")
    # The load's phases (render/scene.py load_device_scene's spans), on the
    # host clock.
    with profiling.recording() as load:
        scene = load_scene(scene_arg, args.device, textured=True)
    print(f"scene: {scene.num_triangles} triangles; writing {args.output}")
    records = load.records()
    phases = [f"{s.name.removeprefix('rf.scene.')}={1e3 * (s.t1 - s.t0):.0f}ms"
              for s in records if isinstance(s, profiling.Span)]
    phases += [f"tree_depth={c.n}" for c in records
               if isinstance(c, profiling.Count) and c.name == profiling.TREE_DEPTH]
    if phases:
        print("scene load: " + " ".join(phases))

    session = ViewerSession(
        scene,
        args.output,
        width=args.width,
        height=args.height,
        spp=args.spp,
        bounces=args.bounces,
        sky=Sky(args.turbidity, (1.0, 1.0, 1.0), args.sun_zenith, args.sun_azimuth),
        exposure=2.0 ** -args.exposure_stops,
        engine=args.engine,
        batch=args.batch,
    )
    lines = args.script.read_text().splitlines() if args.script else sys.stdin
    if lines is sys.stdin and sys.stdin.isatty():
        print("viewer ready -- commands: w/a/s/d/q/e, look, pick, spp, "
              "frames N, wait, quit")
    # The renderers' spans of the last 30 frames: the deferred status line's
    # pass times.
    with profiling.recording(keep_frames=30):
        for line in lines:
            if not session.handle(line):
                break
    return 0


if __name__ == "__main__":
    sys.exit(main())
