"""Persistent path kernel (K3): CUDA kernel and its plain version.

Counterpart of `rayfinder_tpu.ops.pallas_regen.pallas_trace_regen`. Each
lane first resolves the pending NEE light sample of its previous segment,
then terminates flag==2 paths (flush + regenerate), then loops
trace -> sky -> regenerate until it stops at a surface hit or runs out of
samples. Lane arrays keep the TPU kernel's public layout: (B,) and (B, 3).

The kernel (csrc/regen.cu) runs one thread per lane; its walks read the
scene's packed walk tables (`bvh_nodes2`, `tri_pos4`; csrc/traverse2.cuh),
and a scene without them raises. The plain version `trace_regen_reference`
does the same per lane in torch, over the torch BVH walk of the SoA planes
(render/traverse.py), one trace round at a time over the lanes still in
flight: both walks give the same t, tri and occlusion on every ray. A wrapper given CPU tensors runs the plain version; given CUDA
tensors it launches the kernel or raises.

The parameter block and the plain per-lane helpers (primaries, add_nee) are
shared with K4 (ops/regen_shaded.py) and K5 (ops/regen_segs.py).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..render.camera import Camera, primary_ray
from ..render.rng import noise_of
from ..render.scene import DeviceScene
from ..render.shade import FRAC_1_PI, SOLAR_COS_THETA_MAX, SOLAR_INV_PDF
from ..render.traverse import intersect_any, intersect_closest, intersect_packed
from ..sky.model import SkyState, sky_on_device, sky_radiance_dir
from . import _build

__all__ = ["trace_regen", "trace_regen_reference"]


class _RegenParams(ctypes.Structure):
    """Mirror of RegenParams in csrc/path.cuh."""

    _fields_ = [
        ("cam_origin", ctypes.c_float * 3),
        ("lower_left", ctypes.c_float * 3),
        ("horizontal", ctypes.c_float * 3),
        ("vertical", ctypes.c_float * 3),
        ("right", ctypes.c_float * 3),
        ("up", ctypes.c_float * 3),
        ("lens_radius", ctypes.c_float),
        ("t_max", ctypes.c_float),
        ("sun", ctypes.c_float * 3),
        ("sky_radiance", ctypes.c_float * 3),
        ("perez", ctypes.c_float * 27),
        ("inv_w", ctypes.c_float),
        ("inv_h", ctypes.c_float),
        ("frame_base", ctypes.c_int),
        ("spp", ctypes.c_int),
        ("num_frames", ctypes.c_int),
        ("solar", ctypes.c_float * 3),
        ("one_minus_cos_max", ctypes.c_float),
        ("solar_inv_pdf", ctypes.c_float),
        ("frac_1_pi", ctypes.c_float),
        ("num_bounces", ctypes.c_int),
        ("live_floor", ctypes.c_int),
    ]


def _floats(a, n):
    return (ctypes.c_float * n)(*np.asarray(a, np.float32).reshape(n).tolist())


def _params(camera, sky, inv_dims, frame_base, spp, num_frames, t_max,
            num_bounces=0, live_floor=0) -> _RegenParams:
    return _RegenParams(
        _floats(camera.origin, 3), _floats(camera.lower_left_corner, 3),
        _floats(camera.horizontal, 3), _floats(camera.vertical, 3),
        _floats(camera.right, 3), _floats(camera.up, 3),
        float(camera.lens_radius), float(t_max),
        _floats(sky.sun_direction, 3), _floats(sky.sky_radiances, 3),
        _floats(sky.params, 27), float(inv_dims[0]), float(inv_dims[1]),
        int(frame_base), int(spp), int(num_frames),
        _floats(sky.solar_radiances, 3),
        float(np.float32(1.0) - SOLAR_COS_THETA_MAX), float(SOLAR_INV_PDF),
        float(FRAC_1_PI), int(num_bounces), int(live_floor),
    )


def lane_inputs(n, u, v_tex, noise_base, sample, bounce, flag, origin, direction,
                thr, srad, lrad, shadow_o, shadow_d, contrib):
    """(tensor, name, dtype, shape) of the lane inputs of K3 and K4, in the
    order their C entry points take them."""
    return (
        (u, "u", torch.float32, (n,)),
        (v_tex, "v_tex", torch.float32, (n,)),
        (noise_base, "noise_base", torch.float32, (n, 2)),
        (sample, "sample", torch.int32, (n,)),
        (bounce, "bounce", torch.int32, (n,)),
        (flag, "flag", torch.int32, (n,)),
        (origin, "origin", torch.float32, (n, 3)),
        (direction, "direction", torch.float32, (n, 3)),
        (thr, "thr", torch.float32, (n, 3)),
        (srad, "srad", torch.float32, (n, 3)),
        (lrad, "lrad", torch.float32, (n, 3)),
        (shadow_o, "shadow_o", torch.float32, (n, 3)),
        (shadow_d, "shadow_d", torch.float32, (n, 3)),
        (contrib, "contrib", torch.float32, (n, 3)),
    )


def primaries(camera, u, v_tex, noise_base, inv_dims, frame_base, spp, idx, sample):
    """Fresh primary rays (origin, direction) of lanes idx for their sample
    indices `sample` (plain versions)."""
    noise = noise_of(noise_base[idx], frame_base, sample, spp)
    return primary_ray(camera, u[idx], v_tex[idx], noise, inv_dims)


def add_nee(scene, has_nee, srad, shadow_o, shadow_d, contrib, t_max, records=None,
            tests=None):
    """Resolve the pending NEE light samples (plain versions): where has_nee,
    srad + contrib * visible, the shadow ray traced only where the
    contribution is non-zero. With `records` (a (1,) int64 tensor), the
    shadow rays walk by the kernels' rule (intersect_packed, the same
    occlusion) and the interior records they read are added to it: one slab
    test for the root and two per record; with `tests` too, the triangles
    they test are added to that."""
    occluded = torch.zeros(has_nee.shape[0], dtype=torch.bool, device=has_nee.device)
    shadow = torch.nonzero(has_nee & (contrib != 0.0).any(dim=1))[:, 0]
    if records is None:
        occluded[shadow] = intersect_any(scene, shadow_o[shadow], shadow_d[shadow], t_max)
    else:
        occluded[shadow], _, _, work = intersect_packed(
            scene, shadow_o[shadow], shadow_d[shadow], t_max, any_hit=True,
            count=tests is not None)
        slabs = work if tests is None else work[:, 0]
        records += ((slabs.to(torch.int64) - 1) // 2).sum()
        if tests is not None:
            tests += work[:, 2].sum(dtype=torch.int64)
    visible = torch.where(occluded, 0.0, 1.0)[:, None]
    return torch.where(has_nee[:, None], srad + contrib * visible, srad)


def trace_regen(
    scene: DeviceScene, camera: Camera, sky: SkyState, u, v_tex, noise_base,
    inv_dims: tuple[float, float], frame_base: int, spp: int, num_frames: int,
    t_max: float,
    sample, bounce, flag, origin, direction, thr, srad, lrad,
    shadow_o, shadow_d, contrib,
):
    """Advance every lane to its next HIT or exhaust its samples.

    Per lane: pixel centre u, v_tex (B,) f32, tile noise noise_base (B, 2);
    path state sample, bounce, flag (B,) i32 and origin, direction, thr
    (throughput), srad (sample radiance), lrad (lane radiance) (B, 3) f32;
    the pending NEE sample shadow_o, shadow_d, contrib (B, 3) f32, applied
    where flag is 1 (then scatter) or 2 (then terminate). inv_dims is
    (1/width, 1/height) as float32 values.

    Returns (sample, bounce, origin, direction, thr, srad, lrad, t, tri):
    tri >= 0 marks lanes stopped at a surface hit awaiting shading, with
    the ray that hit it; every other live lane has consumed all its
    samples, their sky radiance folded into lrad."""
    if u.device.type == "cpu":
        return trace_regen_reference(
            scene, camera, sky, u, v_tex, noise_base, inv_dims, frame_base,
            spp, num_frames, t_max, sample, bounce, flag, origin, direction,
            thr, srad, lrad, shadow_o, shadow_d, contrib,
        )
    dev = u.device
    n = u.shape[0]
    inputs = lane_inputs(n, u, v_tex, noise_base, sample, bounce, flag, origin, direction,
                         thr, srad, lrad, shadow_o, shadow_d, contrib)
    for tensor, name, dtype, shape in inputs:
        _build.check(tensor, name, dtype, shape, dev)
    outputs = (
        torch.empty(n, dtype=torch.int32, device=dev),  # sample
        torch.empty(n, dtype=torch.int32, device=dev),  # bounce
        *(torch.empty(n, 3, dtype=torch.float32, device=dev) for _ in range(5)),
        torch.empty(n, dtype=torch.float32, device=dev),  # t
        torch.empty(n, dtype=torch.int32, device=dev),  # tri
    )
    if n:
        params = _params(camera, sky, inv_dims, frame_base, spp, num_frames, t_max)
        lib = _build.library()
        with torch.cuda.device(dev):
            err = lib.rf_trace_regen(
                *_build.packed_args(scene, dev), ctypes.addressof(params), n,
                *(tensor.data_ptr() for tensor, *_ in inputs),
                *(out.data_ptr() for out in outputs),
                _build.stream_of(dev),
            )
        _build.raise_on_error(err, "rf_trace_regen")
        trace_regen.launches += 1
    return outputs


# Kernel launch count (a run resets and reads it to show which kernels it
# went through).
trace_regen.launches = 0


def trace_regen_reference(
    scene: DeviceScene, camera: Camera, sky: SkyState, u, v_tex, noise_base,
    inv_dims: tuple[float, float], frame_base: int, spp: int, num_frames: int,
    t_max: float,
    sample, bounce, flag, origin, direction, thr, srad, lrad,
    shadow_o, shadow_d, contrib,
):
    """Plain torch version of `trace_regen`, on any device. Same arguments
    and results; the arithmetic of csrc/regen.cu operation by operation."""
    nf = num_frames
    sample, bounce = sample.clone(), bounce.clone()
    origin, direction = origin.clone(), direction.clone()
    thr, srad, lrad = thr.clone(), srad.clone(), lrad.clone()
    n = u.shape[0]
    dev = u.device
    sky = sky_on_device(sky, dev)

    def regenerate(idx):
        """Start the next sample of lanes idx: fresh primary, unit
        throughput, bounce 1."""
        origin[idx], direction[idx] = primaries(
            camera, u, v_tex, noise_base, inv_dims, frame_base, spp, idx, sample[idx])
        thr[idx] = 1.0
        bounce[idx] = 1

    # 1. Pending NEE light sample: trace the shadow ray where the
    # contribution is non-zero; add contrib * visibility.
    live = sample < nf
    srad = add_nee(scene, live & ((flag == 1) | (flag == 2)), srad, shadow_o, shadow_d,
                   contrib, t_max)

    # 2. Terminate after NEE: flush, finish the sample, regenerate.
    term = live & (flag == 2)
    lrad = torch.where(term[:, None], lrad + srad, lrad)
    srad = torch.where(term[:, None], 0.0, srad)
    sample = torch.where(term, sample + 1, sample)
    regenerate(torch.nonzero(term & (sample < nf))[:, 0])

    # 3. Trace rounds over the lanes in flight, consuming misses.
    t_fin = torch.full((n,), t_max, dtype=torch.float32, device=dev)
    tri_fin = torch.full((n,), -1, dtype=torch.int32, device=dev)
    flying = torch.nonzero(sample < nf)[:, 0]
    while flying.numel():
        hit, t, tri, _ = intersect_closest(scene, origin[flying], direction[flying], t_max)
        stop = flying[hit]
        t_fin[stop], tri_fin[stop] = t[hit], tri[hit]
        miss = flying[~hit]
        s = srad[miss] + thr[miss] * sky_radiance_dir(sky, direction[miss])
        lrad[miss] = lrad[miss] + s
        srad[miss] = 0.0
        sample[miss] = sample[miss] + 1
        flying = miss[sample[miss] < nf]
        regenerate(flying)
    return sample, bounce, origin, direction, thr, srad, lrad, t_fin, tri_fin
