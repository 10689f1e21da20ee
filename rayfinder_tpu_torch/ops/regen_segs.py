"""Multi-segment persistent path kernel (K5): CUDA kernel and its plain
version.

Counterpart of `rayfinder_tpu.ops.pallas_regen.pallas_trace_regen_segs`.
Each lane pipelines K = segs paths of its pixel in K slots and returns K hit
segments per call: a prologue resolves each slot's pending NEE sample and
restarts slots whose path ended (flag 2) with the pixel's next sample from
the lane's allocator `salloc`; then the lane traces its first in-flight
slot again and again, parking it at a hit, and on a miss adding the sky and
restarting it with the next sample, until no slot is in flight.

Per-slot columns keep the TPU kernel's public layout: slot_cnt (B, 3K)
[sample, bounce, flag], slot_ray (B, 6K) [origin, direction], slot_thr
(B, 6K) [thr, srad], slot_nee (B, 9K) [shadow_o, shadow_d, contrib]. The
kernel (csrc/regen_segs.cu) runs one thread per lane over the packed walk
tables, as K3 does (ops/regen.py). The plain version
`trace_regen_segs_reference` runs the slot machine in torch, one trace round
at a time over the lanes with a slot in flight. A wrapper given CPU tensors
runs the plain version; given CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from ..render.camera import Camera
from ..render.scene import DeviceScene
from ..render.traverse import intersect_closest
from ..sky.model import SkyState, sky_on_device, sky_radiance_dir
from . import _build
from .regen import _params, add_nee, primaries

__all__ = ["trace_regen_segs", "trace_regen_segs_reference", "SEGS"]

# The slot counts the kernel is built for.
SEGS = (2, 3, 4)


def _segs_of(slot_cnt) -> int:
    segs, rem = divmod(slot_cnt.shape[1], 3)
    if rem or segs not in SEGS:
        raise ValueError(f"slot_cnt has {slot_cnt.shape[1]} columns: 3 x segs with segs in {SEGS}")
    return segs


def trace_regen_segs(
    scene: DeviceScene, camera: Camera, sky: SkyState, u, v_tex, noise_base,
    inv_dims: tuple[float, float], frame_base: int, spp: int, num_frames: int,
    t_max: float,
    salloc, lrad, slot_cnt, slot_ray, slot_thr, slot_nee,
):
    """Advance every slot of every lane to its next HIT or exhaust the
    lane's samples.

    Per lane: pixel u, v_tex (B,), noise_base (B, 2); the sample allocator
    salloc (B,) i32 (the pixel's next unassigned sample); lane radiance lrad
    (B, 3); the K slots' state in the columns described above.

    Returns (salloc, lrad, ocnt (B, 3K) [sample, bounce, tri], oray (B, 6K),
    othr (B, 6K), t (B, K)): each slot with samples left is stopped at a hit
    (tri >= 0) with the ray that hit it, awaiting its shade."""
    segs = _segs_of(slot_cnt)
    if u.device.type == "cpu":
        return trace_regen_segs_reference(
            scene, camera, sky, u, v_tex, noise_base, inv_dims, frame_base, spp,
            num_frames, t_max, salloc, lrad, slot_cnt, slot_ray, slot_thr, slot_nee,
        )
    dev = u.device
    n = u.shape[0]
    inputs = (
        (u, "u", torch.float32, (n,)),
        (v_tex, "v_tex", torch.float32, (n,)),
        (noise_base, "noise_base", torch.float32, (n, 2)),
        (salloc, "salloc", torch.int32, (n,)),
        (lrad, "lrad", torch.float32, (n, 3)),
        (slot_cnt, "slot_cnt", torch.int32, (n, 3 * segs)),
        (slot_ray, "slot_ray", torch.float32, (n, 6 * segs)),
        (slot_thr, "slot_thr", torch.float32, (n, 6 * segs)),
        (slot_nee, "slot_nee", torch.float32, (n, 9 * segs)),
    )
    for tensor, name, dtype, shape in inputs:
        _build.check(tensor, name, dtype, shape, dev)
    outputs = (
        torch.empty(n, dtype=torch.int32, device=dev),  # salloc
        torch.empty(n, 3, dtype=torch.float32, device=dev),  # lrad
        torch.empty(n, 3 * segs, dtype=torch.int32, device=dev),  # ocnt
        torch.empty(n, 6 * segs, dtype=torch.float32, device=dev),  # oray
        torch.empty(n, 6 * segs, dtype=torch.float32, device=dev),  # othr
        torch.empty(n, segs, dtype=torch.float32, device=dev),  # t
    )
    if n:
        params = _params(camera, sky, inv_dims, frame_base, spp, num_frames, t_max)
        lib = _build.library()
        with torch.cuda.device(dev):
            err = lib.rf_trace_regen_segs(
                *_build.packed_args(scene, dev), ctypes.addressof(params), n, segs,
                *(tensor.data_ptr() for tensor, *_ in inputs),
                *(out.data_ptr() for out in outputs),
                _build.stream_of(dev),
            )
        _build.raise_on_error(err, "rf_trace_regen_segs")
        trace_regen_segs.launches += 1
    return outputs


# Kernel launch count (a run resets and reads it to show which kernels it
# went through).
trace_regen_segs.launches = 0


def trace_regen_segs_reference(
    scene: DeviceScene, camera: Camera, sky: SkyState, u, v_tex, noise_base,
    inv_dims: tuple[float, float], frame_base: int, spp: int, num_frames: int,
    t_max: float,
    salloc, lrad, slot_cnt, slot_ray, slot_thr, slot_nee,
):
    """Plain torch version of `trace_regen_segs`, on any device. Same
    arguments and results; the slot machine of csrc/regen_segs.cu."""
    segs = _segs_of(slot_cnt)
    nf = num_frames
    n = u.shape[0]
    dev = u.device
    sky = sky_on_device(sky, dev)
    salloc = salloc.clamp(max=nf)
    lrad = lrad.clone()
    cnt = slot_cnt.reshape(n, segs, 3)
    ray = slot_ray.reshape(n, segs, 6)
    nee = slot_nee.reshape(n, segs, 9)
    ssample, bounce, flag = cnt[..., 0].clone(), cnt[..., 1].clone(), cnt[..., 2]
    origin, direction = ray[..., 0:3].clone(), ray[..., 3:6].clone()
    thr = slot_thr.reshape(n, segs, 6)[..., 0:3].clone()
    srad = slot_thr.reshape(n, segs, 6)[..., 3:6].clone()

    def regenerate(lanes, slots, sample):
        """Start sample `sample` in the given (lane, slot) pairs where the
        lane has samples left."""
        keep = sample < nf
        lanes, slots, sample = lanes[keep], slots[keep], sample[keep]
        o, d = primaries(camera, u, v_tex, noise_base, inv_dims, frame_base, spp, lanes,
                         sample)
        origin[lanes, slots], direction[lanes, slots] = o, d
        thr[lanes, slots] = 1.0
        bounce[lanes, slots] = 1

    # Prologue, slot by slot: pending NEE, terminate, take a sample, regenerate.
    for j in range(segs):
        live = ssample[:, j] < nf
        srad[:, j] = add_nee(scene, live & (flag[:, j] > 0), srad[:, j], nee[:, j, 0:3],
                             nee[:, j, 3:6], nee[:, j, 6:9], t_max)
        term = live & (flag[:, j] == 2)
        lrad = torch.where(term[:, None], lrad + srad[:, j], lrad)
        srad[:, j] = torch.where(term[:, None], 0.0, srad[:, j])
        ssample[:, j] = torch.where(term, salloc, ssample[:, j])
        salloc = salloc + term.to(torch.int32)
        lanes = torch.nonzero(term)[:, 0]
        regenerate(lanes, torch.full_like(lanes, j), ssample[lanes, j])

    # Trace each lane's first in-flight slot until none is in flight.
    t_fin = torch.full((n, segs), t_max, dtype=torch.float32, device=dev)
    tri_fin = torch.full((n, segs), -1, dtype=torch.int32, device=dev)
    parked = torch.zeros(n, segs, dtype=torch.bool, device=dev)
    while True:
        inflight = (ssample < nf) & ~parked
        lanes = torch.nonzero(inflight.any(dim=1))[:, 0]
        if not lanes.numel():
            break
        act = inflight[lanes].to(torch.int32).argmax(dim=1)  # the first in flight
        d = direction[lanes, act]
        hit, t, tri, _ = intersect_closest(scene, origin[lanes, act], d, t_max)
        h, ha = lanes[hit], act[hit]
        t_fin[h, ha], tri_fin[h, ha], parked[h, ha] = t[hit], tri[hit], True
        m, ma = lanes[~hit], act[~hit]
        s = srad[m, ma] + thr[m, ma] * sky_radiance_dir(sky, d[~hit])
        lrad[m] = lrad[m] + s
        srad[m, ma] = 0.0
        new_s = salloc[m]
        ssample[m, ma] = new_s
        salloc[m] = new_s + 1
        regenerate(m, ma, new_s)

    ocnt = torch.stack([ssample, bounce, tri_fin], dim=2).view(n, 3 * segs)
    oray = torch.cat([origin, direction], dim=2).view(n, 6 * segs)
    othr = torch.cat([thr, srad], dim=2).view(n, 6 * segs)
    return salloc, lrad, ocnt, oray, othr, t_fin
