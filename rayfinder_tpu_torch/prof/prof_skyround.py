"""K8, one regen round split into sweep, sky and regeneration, timed per mode.

Counterpart of prof/prof_skyround.py, which timed the TPU probe kernel over
64 tiles of 1024 pure-sky lanes: u = linspace(0.05, 0.95) across a tile,
v = 0.05 (the top of the image, rays that mostly miss), blue-noise base
(0.25, 0.75), 64 rounds per lane, the Duck probe's camera and sky. Here the
scene is the untextured courtyard_scene(scale) through the production asset
path (prof/scenes.py), since Duck is not in the repository. From the Duck
camera's place the courtyard's walls fill the top of the image, so those
lanes hit geometry; the bench camera (prof/scenes.py BENCH_CAMERA) sees sky
there, the pure-sky lanes the TPU probe meant. For each camera and each mode
of ops/skyround.py it prints the kernel's time for the whole probe and per
lane-round, and the share of the lanes' first rays that hit geometry.

    python -m rayfinder_tpu_torch.prof.prof_skyround [--scale 26] [--rounds 64] [--reps 5]

Needs a CUDA device: the times are the kernel's (CUDA events).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..ops.skyround import MODES, sky_round
from ..render.camera import create_camera, primary_ray
from ..render.rng import noise_of
from ..sky.model import sky_state_from_ui
from .probe_prebuilt import time_ms

TILES, TILE = 64, 1024
ROUNDS = 64
# The Duck probe's camera, sky and image size (prof/prof_skyround.py), and
# the bench camera at the same image size.
CAMERAS = {"duck": ([2.0, 1.5, 2.0], [0.1, 0.8, 0.0], 0.0, 1.0, 70.0, 800 / 600),
           "bench": ([-16.0, 5.0, 0.0], [12.0, 2.0, 0.0], 0.0, 1.0, 70.0, 800 / 600)}
SKY = (1.0, (1.0, 1.0, 1.0), 30.0, 0.0)
INV_DIMS = (float(np.float32(1.0) / np.float32(800.0)),
            float(np.float32(1.0) / np.float32(600.0)))
T_MAX = 1e30


def probe_lanes(dev, v: float = 0.05):
    """The probe's lanes: (u, v_tex (N,), noise_base (N, 2)) f32 on dev,
    N = TILES * TILE."""
    u = np.tile(np.linspace(0.05, 0.95, TILE, dtype=np.float32), TILES)
    n = u.size
    nb = np.broadcast_to(np.asarray([0.25, 0.75], np.float32), (n, 2))
    return (torch.from_numpy(u).to(dev), torch.full((n,), v, dtype=torch.float32, device=dev),
            torch.from_numpy(np.ascontiguousarray(nb)).to(dev))


def probe_args(scene, dev, camera: str = "duck"):
    """Positional arguments of sky_round/sky_round_reference before
    `rounds` and `mode`: (scene, camera, sky, u, v_tex, noise_base,
    inv_dims), with the camera of CAMERAS[camera]."""
    return (scene, create_camera(*CAMERAS[camera]), sky_state_from_ui(*SKY),
            *probe_lanes(dev), INV_DIMS)


def sample_rays(args, sample: int):
    """The primary rays (origin, direction (N, 3)) of every lane's sample
    `sample`: the rays that "full" and "nosweep" start in round `sample`."""
    _, camera, _, u, v_tex, nb, inv_dims = args
    s = torch.full((u.shape[0],), sample, dtype=torch.int32, device=u.device)
    o, d = primary_ray(camera, u, v_tex, noise_of(nb, 0, s, 256), inv_dims)
    return o.contiguous(), d.contiguous()


def first_ray_hits(args):
    """Whether each lane's first primary ray hits the scene (the closest-hit
    kernel on the card, its plain version on the CPU)."""
    from ..ops.walk import intersect_closest_kernel

    return intersect_closest_kernel(args[0], *sample_rays(args, 0), T_MAX)[0]


def time_mode(args, mode: str, rounds: int, reps: int) -> float:
    """Mean kernel time (ms) of one probe run in `mode`, after a warm-up."""
    return time_ms(lambda: sky_round(*args, rounds, mode), reps)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--scale", type=int, default=26)
    ap.add_argument("--rounds", type=int, default=ROUNDS)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("prof_skyround: needs a CUDA device (the times are the kernel's)")
    from .scenes import courtyard_pt_scene

    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    scene, _ = courtyard_pt_scene(args.scale, device=dev)
    for camera in CAMERAS:
        probe = probe_args(scene, dev, camera)
        n = probe[3].shape[0]
        hits = float(first_ray_hits(probe).float().mean())
        print(f"courtyard_scene({args.scale}), {camera} camera, {n} lanes x {args.rounds} "
              f"rounds; first rays that hit the scene: {hits:.4f} [{name}]", flush=True)
        for mode in MODES:
            ms = time_mode(probe, mode, args.rounds, args.reps)
            print(f"  {mode:10s}: {ms:8.3f} ms total  {ms * 1e6 / (n * args.rounds):6.3f} "
                  f"ns/lane-round [{name}]", flush=True)


if __name__ == "__main__":
    main()
