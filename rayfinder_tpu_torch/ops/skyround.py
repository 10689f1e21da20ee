"""Sky-round probe (K8): CUDA kernel and its plain version.

Counterpart of the probe kernel of prof/prof_skyround.py, which splits one
regen round of the TPU path kernel into sweep, sky evaluation and primary
regeneration. The kernel (csrc/skyround.cu) runs `rounds` rounds per lane
over the path kernels' own device functions: the packed walk over the
scene's `bvh_nodes2` / `tri_pos4` (a scene without them raises), the noise,
the primary ray and the sky; `mode` picks the parts:

- "full": closest hit, then sky, then the next primary ray;
- "nosweep": sky and the next primary;
- "sweeponly": the closest hit of the lane's first ray, every round;
- "noop": the loop alone (acc += direction.x);
- "fullwhile": closest hit; on a miss add the sky and start the next
  primary; a 128-lane group (one block) runs while any of its lanes started
  one this round.

Each lane accumulates the hit's t and the sky's r + g + b; the result is
acc (N,) f32. In "full", "nosweep" and "sweeponly" a warp takes a lane and
its threads take the lane's rounds; the sums are added in round order, so
the result is that of one loop over the rounds. The plain version
`sky_round_reference` runs that loop over the port's torch functions
(render/rng.py noise_of, render/camera.py primary_ray, sky/model.py
sky_radiance_dir, render/traverse.py intersect_closest), in the same order
of operations.

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches its kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from ..render.camera import Camera, primary_ray
from ..render.rng import noise_of
from ..render.scene import DeviceScene
from ..render.traverse import intersect_closest
from ..sky.model import SkyState, sky_on_device, sky_radiance_dir
from . import _build
from .regen import _params

__all__ = ["MODES", "GROUP", "sky_round", "sky_round_reference"]

MODES = ("full", "nosweep", "sweeponly", "noop", "fullwhile")
# Lanes of one fullwhile vote: the kernel's block.
GROUP = 128
# The probe's noise stream: frame base 0, 256 samples per pixel.
_SPP = 256
# Operations of a lane-round besides the sweep, counted from csrc/path.cuh as
# ops/counted.py counts the walk's (each transcendental function one): the
# sky (sky_radiance) and the next primary ray (noise_of + primary).
SKY_OPS = 88
REGEN_OPS = 65


def _start(camera, u, v_tex, noise_base, inv_dims, sample):
    return primary_ray(camera, u, v_tex, noise_of(noise_base, 0, sample, _SPP), inv_dims)


def sky_round_reference(scene: DeviceScene, camera: Camera, sky: SkyState, u, v_tex,
                        noise_base, inv_dims: tuple[float, float], rounds: int, mode: str,
                        t_max: float = 1e30):
    """Plain version of `sky_round`: same arguments and result."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    n = u.shape[0]
    dev = u.device
    sky = sky_on_device(sky, dev)
    sample = torch.zeros(n, dtype=torch.int32, device=dev)
    o, d = _start(camera, u, v_tex, noise_base, inv_dims, sample)
    acc = torch.zeros(n, dtype=torch.float32, device=dev)
    if mode != "fullwhile":
        for _ in range(rounds):
            if mode in ("full", "sweeponly"):
                hit, t, _, _ = intersect_closest(scene, o, d, t_max)
                acc = acc + torch.where(hit, t, 0.0)
            if mode in ("full", "nosweep"):
                s = sky_radiance_dir(sky, d)
                acc = acc + s[:, 0] + s[:, 1] + s[:, 2]
                sample = sample + 1
                o, d = _start(camera, u, v_tex, noise_base, inv_dims, sample)
            else:
                sample = sample + 1
            if mode == "noop":
                acc = acc + d[:, 0]
        return acc
    # fullwhile: each group of GROUP lanes runs while one of its lanes
    # started a new primary in the last round.
    group = torch.arange(n, device=dev) // GROUP
    running = torch.ones(-(-n // GROUP), dtype=torch.bool, device=dev)
    while bool(running.any()):
        live = torch.nonzero(running[group] & (sample < rounds))[:, 0]
        hit, t, _, _ = intersect_closest(scene, o[live], d[live], t_max)
        s = sky_radiance_dir(sky, d[live])
        acc[live] = acc[live] + torch.where(hit, t, 0.0)
        acc[live] = acc[live] + torch.where(~hit, s[:, 0] + s[:, 1] + s[:, 2], 0.0)
        sample[live] = sample[live] + (~hit).to(torch.int32)
        regen = live[~hit & (sample[live] < rounds)]
        o[regen], d[regen] = _start(camera, u[regen], v_tex[regen], noise_base[regen],
                                    inv_dims, sample[regen])
        voted = torch.zeros_like(running)
        voted[group[regen]] = True
        running = voted
    return acc


def sky_round(scene: DeviceScene, camera: Camera, sky: SkyState, u, v_tex, noise_base,
              inv_dims: tuple[float, float], rounds: int, mode: str, t_max: float = 1e30):
    """`rounds` probe rounds of each lane in `mode` (one of MODES). Lane
    pixel centres u, v_tex (N,) f32 and tile noise noise_base (N, 2) f32;
    inv_dims is (1/width, 1/height) as float32 values; the noise stream is
    that of frame base 0 and 256 samples per pixel. Returns acc (N,) f32."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if u.device.type == "cpu":
        return sky_round_reference(scene, camera, sky, u, v_tex, noise_base, inv_dims, rounds,
                                   mode, t_max)
    dev = u.device
    n = u.shape[0]
    for t, name, shape in ((u, "u", (n,)), (v_tex, "v_tex", (n,)),
                           (noise_base, "noise_base", (n, 2))):
        _build.check(t, name, torch.float32, shape, dev)
    acc = torch.empty(n, dtype=torch.float32, device=dev)
    if n:
        params = _params(camera, sky, inv_dims, 0, _SPP, rounds, t_max)
        lib = _build.library()
        with torch.cuda.device(dev):
            err = lib.rf_sky_round(
                *_build.packed_args(scene, dev), ctypes.addressof(params), n, int(rounds),
                MODES.index(mode), u.data_ptr(), v_tex.data_ptr(), noise_base.data_ptr(),
                acc.data_ptr(), _build.stream_of(dev),
            )
        _build.raise_on_error(err, "rf_sky_round")
        sky_round.launches += 1
    return acc


# Kernel launch count (a run resets and reads it to show which kernels it
# went through).
sky_round.launches = 0
