"""Benchmark: the courtyard path trace on one card, with its quality gate.

    python -m rayfinder_tpu_torch.bench
    python -m rayfinder_tpu_torch.bench --device cpu --engine plain --scale 2 \
        --width 32 --height 32 --bounces 2 --frames 2 --hd-width 32 --hd-height 16 \
        --hd-frames 2 --golden golden.npz

Counterpart of bench.py main_courtyard, the JAX package's measurement of its
primary metric, without its fallbacks: a step that fails raises, and there
is no other engine or scene to fall back to. courtyard_scene(26,
textured=True) through the production asset path (GLB -> .pt -> scene,
prof/scenes.py courtyard_pt_scene), 512x512, 4 bounces, the bench camera and
sky, the port's blue-noise tile:

1. one warm 16-sample dispatch from frame 0, then one timed from frame 16,
   both on the default route with exact ray counts, fenced by a device sync
   on both sides: value = (closest + shadow rays) / seconds / 1e6 Mrays/s;
2. time_to_1024spp_1080p_s, measured at 1920x1080 (time_to_1024spp): a warm
   32-sample dispatch, then a timed one, times 1024 / 32. bench.py's
   extrapolation from the 512x512 dispatch stands beside it on stderr;
3. the JSON line {"metric", "value", "unit", "time_to_1024spp_1080p_s", ...}
   is printed first;
4. the quality gate on the 32 accumulated samples: tonemap(accum / 32, 0.25)
   against tests/goldens/quality_courtyard_512x512_32spp.npz (baked by the
   JAX package's wavefront engine on a TPU from the procedural scene),
   tools/make_quality_goldens.py quality_gate: quality_rmse over every
   pixel (bench.py's number) beside quality_rmse_off_wrap < 1e-3 off the
   pixels whose middle ray hits a face on a texel edge, and on those
   (wrap_pixels) the mean difference within its standard errors and
   quality_rmse_wrap within JAX's own on the CPU; quality_ok is that
   gate (the tool's docstring says why the +x wall's pixels cannot be held
   to the TPU's golden one by one);
5. the traversal efficiency (prof/diag_iters.py traversal_efficiency):
   mt_waste_primary, mt_waste_bounce1, mt_waste_bounce2 and their
   mt_waste_lane_* twins;
6. the line again with those fields folded in: the last line wins.

The mt_waste fields share their names with the JAX bench's but not their
meaning: here the tests issued per warp of 32 rays by the per-thread walk
(each warp issues 32 x its slowest ray's triangle tests), against the tests
the rays need; on the TPU they were the tests issued per 128-lane sweep of
128-triangle clusters. The values are not comparable.

The exit code is non-zero when quality_ok is false (after the line is
printed, with what failed on stderr). On stderr: the timed dispatch's closest and shadow rays beside the
JAX package's on the TPU for the same textured .pt scene and window
(JAX_TPU_RAYS, a record, not a gate).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from .prof import diag_iters
from .prof.scenes import BENCH_CAMERA, BENCH_SKY, courtyard_pt_scene
from .render.camera import create_camera
from .render.pathtracer import accumulate_samples_regen
from .render.rng import blue_noise_tile
from .sky.model import sky_state_from_ui
from .tools.make_quality_goldens import (
    gate_failures, golden_path, mean_image, quality_gate, texel_wrap_pixels,
)

METRIC = "courtyard_512x512_4bounce_path_trace"
UNIT = "Mrays/s/chip"
# The JAX package's [closest, shadow] rays of the timed dispatch (samples
# 16-31) on the TPU, same textured .pt scene and window (BENCH_r05.json).
JAX_TPU_RAYS = (11_611_581, 8_839_498)
HD = dict(width=1920, height=1080, num_frames=32)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else str(dev)


def timed_dispatch(scene, sky, camera, tile, frame_base: int, accum, **kw):
    """One accumulate_samples_regen dispatch with count_rays=True, fenced by
    a device sync on both sides. Returns (accum, [closest, shadow], seconds)."""
    dev = accum.device
    _sync(dev)
    t0 = time.perf_counter()
    accum, rays = accumulate_samples_regen(scene, sky, camera, tile, frame_base, accum,
                                           count_rays=True, **kw)
    _sync(dev)
    return accum, rays.tolist(), time.perf_counter() - t0


def time_to_1024spp(scene, sky, tile, *, width=HD["width"], height=HD["height"],
                    num_bounces=4, num_frames=HD["num_frames"], engine="kernel") -> dict:
    """time_to_1024spp_1080p_s as measured: on the bench camera at
    width x height (1920x1080), one warm num_frames-sample dispatch from
    frame 0, then a timed one from frame num_frames (spp 1024, the default
    route), times 1024 / num_frames."""
    dev = tile.device
    cam = create_camera(*BENCH_CAMERA, width / height)
    kw = dict(width=width, height=height, num_bounces=num_bounces, spp=1024,
              num_frames=num_frames, engine=engine)
    warm, _, _ = timed_dispatch(scene, sky, cam, tile, 0,
                                torch.zeros(width * height, 3, device=dev), **kw)
    _, rays, secs = timed_dispatch(scene, sky, cam, tile, num_frames, warm, **kw)
    return dict(seconds=secs, seconds_per_sample=secs / num_frames,
                time_to_1024spp_s=1024 * secs / num_frames, rays=rays)


def courtyard_bench(*, scale=26, width=512, height=512, num_bounces=4, num_frames=16,
                    textured=True, device="cuda", engine="kernel",
                    golden=golden_path("courtyard", 512, 512, 32), hd_width=HD["width"],
                    hd_height=HD["height"], hd_frames=HD["num_frames"]) -> dict:
    """Run the bench (module docstring) and print its JSON line twice: after
    the timed measurement and with the gate and efficiency fields folded in.
    Returns the last line's fields."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("bench: no CUDA device (pass device='cpu' for the plain versions)")
    scene, info = courtyard_pt_scene(scale, device=dev, textured=textured)
    print(f"courtyard_scene({scale}, textured={textured}) from {info['path']}: "
          f"{scene.num_triangles} triangles, {info['bytes']} bytes, prepared in "
          f"{info['prepare_s']:.1f} s, loaded in {info['load_s']:.1f} s", file=sys.stderr)
    camera = create_camera(*BENCH_CAMERA, width / height)
    sky = sky_state_from_ui(*BENCH_SKY)
    tile = torch.from_numpy(blue_noise_tile()).to(dev)
    kw = dict(width=width, height=height, num_bounces=num_bounces, spp=256,
              num_frames=num_frames, engine=engine)

    accum, _, _ = timed_dispatch(scene, sky, camera, tile, 0,
                                 torch.zeros(width * height, 3, device=dev), **kw)
    accum, rays, secs = timed_dispatch(scene, sky, camera, tile, num_frames, accum, **kw)
    hd = time_to_1024spp(scene, sky, tile, width=hd_width, height=hd_height,
                         num_bounces=num_bounces, num_frames=hd_frames, engine=engine)
    line = {"metric": METRIC, "value": sum(rays) / secs / 1e6, "unit": UNIT,
            "time_to_1024spp_1080p_s": hd["time_to_1024spp_s"], "rays": rays,
            "device": _device_name(dev)}
    print(json.dumps(line), flush=True)
    extrapolated = secs * (1920 * 1080 * 1024) / (width * height * num_frames)
    print(f"courtyard rays={sum(rays)} (closest={rays[0]} shadow={rays[1]}; JAX on the TPU "
          f"for the same .pt scene and window: closest={JAX_TPU_RAYS[0]} "
          f"shadow={JAX_TPU_RAYS[1]}) dt={secs:.6f} s; {hd_width}x{hd_height}: "
          f"{hd['seconds']:.6f} s per {hd_frames} samples, time_to_1024spp "
          f"{hd['time_to_1024spp_s']:.3f} s (bench.py's extrapolation from "
          f"{width}x{height}: {extrapolated:.3f} s) [{line['device']}]", file=sys.stderr)

    img = mean_image(accum, 2 * num_frames, width, height)
    line.update(quality_gate(img, golden, texel_wrap_pixels(scene, camera, width, height)))
    efficiency = diag_iters.traversal_efficiency(scene, camera, width, height)
    line.update({k: v for k, v in efficiency.items() if k.startswith("mt_waste")})
    print(json.dumps(line), flush=True)
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", type=int, default=26)
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--height", type=int, default=512)
    ap.add_argument("--bounces", type=int, default=4)
    ap.add_argument("--frames", type=int, default=16, help="samples per dispatch")
    ap.add_argument("--hd-width", type=int, default=HD["width"])
    ap.add_argument("--hd-height", type=int, default=HD["height"])
    ap.add_argument("--hd-frames", type=int, default=HD["num_frames"])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--engine", default="kernel", choices=("kernel", "plain"))
    ap.add_argument("--golden", default=None,
                    help="golden npz (default: tests/goldens/quality_courtyard_"
                         "{width}x{height}_{2 frames}spp.npz)")
    args = ap.parse_args(argv)
    golden = args.golden or golden_path("courtyard", args.width, args.height, 2 * args.frames)
    line = courtyard_bench(scale=args.scale, width=args.width, height=args.height,
                           num_bounces=args.bounces, num_frames=args.frames,
                           device=args.device, engine=args.engine, golden=golden,
                           hd_width=args.hd_width, hd_height=args.hd_height,
                           hd_frames=args.hd_frames)
    if not line["quality_ok"]:
        print(f"bench: quality gate failed: {'; '.join(gate_failures(line))}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
