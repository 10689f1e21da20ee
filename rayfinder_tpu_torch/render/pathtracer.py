"""Path tracer: the port of `rayfinder_tpu.render.pathtracer`. Its fused
regeneration loop (accumulate_samples_regen with engine="pallas":
_accumulate_regen_fused, its sorted form _accumulate_regen_fused_sorted and
its two other routes, _accumulate_regen_inkernel and
_accumulate_regen_fused_segs), the unfused regeneration loop over the ray
queries K1/K2 or the wavefront engine (accumulate_lanes_regen's loop for its
other engines), the
scan integrator (trace_radiance, accumulate_sample(s), the windows of
render_image_tiled), and the accumulator choice of render_image and the
Renderer (pick_accumulator).

Per sample and pixel, with one 2D blue-noise value reused for every sampling
decision that frame (exactly like the reference's WGSL megakernel `rayColor`,
src/pt/reference_path_tracer.wgsl:180-234):

  thin-lens primary ray -> for each bounce: closest hit -> albedo lookup ->
  next-event estimation toward the solar disk (shadow ray) -> cosine-weighted
  scatter; a miss adds the Hosek-Wilkie sky (without the sun, which arrives
  through NEE) and ends the sample.

Each lane owns one pixel and traces its samples back to back. The default
route runs a whole dispatch inside the kernel K4 (ops/regen_shaded.py), which
shades in place: one call, or one call per run of samples where the
kernel's scratch would pass its cap. The split route (inkernel=False)
makes, per outer iteration, one call of the persistent path kernel K3
(ops/regen.py), which resolves the pending NEE, consumes every miss segment
on the card and stops each lane at its next surface hit, and one shade step
in torch (render/shade.py) that prepares the NEE sample and the scatter ray.
As lanes finish, the busy ones are compacted into narrower batches (phases).
With sort=True the split route also reorders its lanes after every iteration
by the cluster of their hit and the direction of their next ray
(_accumulate_regen_fused_sorted).
The hybrid in-kernel route (inkernel=True with a compact_floor below the
batch) runs K4 per phase after a split first phase; the segs route (segs=K)
keeps K paths per lane in the kernel K5 (ops/regen_segs.py).

The unfused loop and the scan integrator trace each path segment with one
closest-hit query and one any-hit (shadow) query, the kernels K1 and K2
(ops/walk.py) on engine "kernel" / "kernel_split", and shade in torch. The
scan form runs each sample's bounces over every pixel at once; on scenes
with more than SORT_THRESHOLD clusters it sorts the lanes by a coherence key
before each bounce and puts the radiance back in pixel order at the end.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..ops.regen import trace_regen, trace_regen_reference
from ..ops.regen_segs import SEGS, trace_regen_segs, trace_regen_segs_reference
from ..ops.regen_shaded import (
    TILE, lanes_per_call, samples_per_call, trace_regen_shaded, trace_regen_shaded_reference,
)
from ..ops.walk import (
    intersect_any_kernel, intersect_any_reference,
    intersect_closest_kernel, intersect_closest_reference,
)
from ..sky.model import SkyState, sky_on_device, sky_radiance_dist
from ..utils import profiling
from ..utils.profiling import H2D_BYTES
from .camera import Camera, generate_camera_ray_lens, primary_ray
from .intersect import T_MAX, dot, to_int32
from .rng import animated_blue_noise, blue_noise_tile, noise_of
from .sampling import sample_cosine_hemisphere, sample_solar_disk_direction
from .scene import DeviceScene
# The shade step lives in render/shade.py (the plain kernels use it too);
# it is re-exported here, beside the loop that drives it.
from .shade import (  # noqa: F401
    FRAC_1_PI, PARK, SOLAR_COS_THETA_MAX, SOLAR_INV_PDF, _nee_and_continuation,
    _surface_interaction,
)
from .texture_eval import eval_texture
from .tiling import block_order_on, pixel_centres, pixel_lanes, unswizzle
from .tonemap import tonemap
from .traverse import intersect_any, intersect_closest
from .wavefront import intersect_any_wavefront, intersect_closest_wavefront

# Phase compaction: when the busy-lane count falls below 1/DIV of the batch,
# the busy lanes move into a batch that size, then down a ladder to FLOOR
# lanes (the JAX package's ladder; its widths were tuned on a TPU and are
# kept until a GPU measurement says otherwise).
_COMPACT_DIV = 10
_COMPACT_FLOOR = 4096
# Scenes with more BVH-treelet clusters than this (DeviceScene.num_clusters)
# sort bounce rays for coherence in the scan integrator (trace_radiance), and
# take the scan form on the unfused engines (pick_accumulator). Position bits
# per axis in the sort key. The JAX package's values, kept as module
# constants until a GPU measurement earns a knob.
SORT_THRESHOLD = 256
_SORT_BITS = 5


class _Kernels(NamedTuple):
    split: Callable  # K3
    shaded: Callable  # K4
    segs: Callable  # K5


# engine name -> the path kernels. "kernel" is the CUDA kernels (the
# counterpart of the JAX "pallas" engine; on CPU tensors their wrappers run
# the plain versions); "plain" drives the same loops through the plain torch
# versions on any device.
_ENGINES = {
    "kernel": _Kernels(trace_regen, trace_regen_shaded, trace_regen_segs),
    "plain": _Kernels(trace_regen_reference, trace_regen_shaded_reference,
                      trace_regen_segs_reference),
}


def _closest_wavefront(scene, origin, direction, t_max):
    hit, t, tri, _ = intersect_closest_wavefront(scene, origin, direction, t_max)
    return hit, t, tri, None


def _any_wavefront(scene, origin, direction, t_max):
    return intersect_any_wavefront(scene, origin, direction, t_max)[0]


# engine name -> the ray queries (closest, any_hit) of the unfused loop and
# the scan integrator (get_engine). "kernel" and "kernel_split" are K1/K2
# (the JAX "pallas" and "pallas_split"; on CPU tensors their wrappers run
# the plain versions); "plain" is their plain version, the packed walk in
# torch; "reference" the plane walk (render/traverse.py, the JAX
# "reference"), which the packed walk equals bit for bit; "wavefront" the
# cluster engine (render/wavefront.py, torch code as in JAX, where it is
# XLA's).
_WALKS = {
    "kernel": (intersect_closest_kernel, intersect_any_kernel),
    "kernel_split": (intersect_closest_kernel, intersect_any_kernel),
    "plain": (intersect_closest_reference, intersect_any_reference),
    "reference": (intersect_closest, intersect_any),
    "wavefront": (_closest_wavefront, _any_wavefront),
}
# The engines of accumulate_samples_regen that run the unfused loop.
_UNFUSED = ("kernel_split", "reference", "wavefront")


def get_engine(engine: str):
    """Resolve a traversal engine name to (closest, any_hit) callables:
    closest(scene, o, d, t_max) -> (hit, t, tri_idx, extra), extra being
    nodes_visited on the stack walks and None on "wavefront", as in JAX;
    any_hit(scene, o, d, t_max) -> occluded."""
    if engine not in _WALKS:
        raise ValueError(f"unknown traversal engine {engine!r}: the port has {sorted(_WALKS)}")
    return _WALKS[engine]


def _phase_sizes(batch: int, floor: int) -> list[int]:
    """Regen phase lane counts: [batch, batch/DIV, ...] down to `floor`,
    rounded up to a 2048-lane granularity (small floors shrink it)."""
    gran = min(2048, max(floor, 16))
    cap = max(floor, -(-batch // _COMPACT_DIV // gran) * gran)
    if cap >= batch:
        return [batch]
    sizes = [batch, cap]
    for div in (2, 6, 12):
        nxt = max(floor, -(-cap // div // gran) * gran)
        if nxt >= sizes[-1]:
            continue
        sizes.append(nxt)
        if nxt <= floor:
            break
    return sizes


class SamplingParams(NamedTuple):
    """reference_path_tracer.hpp:26-32 defaults."""

    num_samples_per_pixel: int = 128
    num_bounces: int = 4


def _segment(scene, sky, walks, origin, direction, thr, rad, noise, live):
    """One path segment of the scan integrator and the unfused loop, for
    the lanes `live`: the closest hit (K1), at a miss the sky radiance
    without the sun (it arrives through NEE), at a hit the NEE sample
    toward the solar disk with its shadow ray (K2), added to rad in that
    order, and the cosine scatter ray (wgsl:180-234). sky: on the lanes'
    device (sky_on_device).

    Returns (rad, hit_lane, p, wi, albedo, ray_ok): the hit lanes, the
    offset hit point, the scatter direction, the albedo, and whether p and
    wi are finite (degenerate shading normals give non-finite directions,
    which no kernel is handed)."""
    closest, any_hit = walks
    sun_dir, solar = sky.sun_direction, sky.solar_radiances
    t_max = origin.new_full((origin.shape[0],), T_MAX)
    hit, _, tri, _ = closest(scene, origin, direction, t_max)
    hit_lane = live & hit
    miss_lane = live & ~hit

    theta = torch.acos(direction[:, 1].clamp(-1.0, 1.0))
    gamma = torch.acos(dot(direction, sun_dir).clamp(-1.0, 1.0))
    rad = torch.where(miss_lane[:, None], rad + thr * sky_radiance_dist(sky, theta, gamma), rad)

    p, n, uv, tex = _surface_interaction(scene, origin, direction, tri.clamp(min=0))
    albedo = eval_texture(scene, tex, uv)
    light_dir = sample_solar_disk_direction(noise, SOLAR_COS_THETA_MAX, sun_dir)
    brdf = albedo * float(FRAC_1_PI)
    # No clamp on the cosine -- parity with wgsl:201.
    cos_term = dot(n, light_dir)[:, None]
    p_ok = torch.isfinite(p).all(dim=1)
    occluded = any_hit(scene, torch.where((hit_lane & p_ok)[:, None], p, PARK), light_dir, t_max)
    visibility = torch.where(occluded, 0.0, 1.0)[:, None]
    contrib = thr * solar * brdf * cos_term * visibility * float(SOLAR_INV_PDF)
    rad = torch.where(hit_lane[:, None], rad + contrib, rad)

    wi = sample_cosine_hemisphere(noise, n)
    ray_ok = torch.isfinite(wi).all(dim=1) & p_ok
    return rad, hit_lane, p, wi, albedo, ray_ok


def _coherence_key(origin, direction, live, lo, inv):
    """The bounce sort key: the direction's octant over _SORT_BITS bits per
    axis of the origin's cell (1024 per axis from lo, `inv` cells per unit),
    dead lanes last."""
    octant = ((direction[:, 0] < 0).to(torch.int32) + 2 * (direction[:, 1] < 0).to(torch.int32)
              + 4 * (direction[:, 2] < 0).to(torch.int32))
    cell = ((origin - lo) * inv).clamp(0.0, 1023.0).to(torch.int32)
    b = _SORT_BITS
    sh = 10 - b
    pos_key = (cell[:, 0] >> sh << (2 * b)) | (cell[:, 1] >> sh << b) | (cell[:, 2] >> sh)
    return torch.where(live, (octant << (3 * b)) | pos_key, 2**30)


def trace_radiance(
    scene: DeviceScene,
    sky: SkyState,
    origin,
    direction,
    noise,
    num_bounces: int,
    engine: str = "kernel",
    decorrelate: bool = False,
):
    """Radiance for a batch of primary rays (rayColor, wgsl:180-234).

    origin/direction: (B, 3) f32; noise: (B, 2), one value reused for every
    decision of the path, as the reference samples one blue-noise value per
    pixel per frame (wgsl:52). decorrelate=True rotates the noise by a
    per-bounce R2 offset instead (lower sample correlation at the cost of
    exact parity). engine: get_engine's names. Returns (B, 3) f32 radiance.

    Ended lanes are parked far outside the scene, so the queries drop them
    at the root. On scenes with more than SORT_THRESHOLD clusters (bounce
    rays scatter everywhere, so neighbouring lanes stop being coherent), the
    lanes are sorted by _coherence_key before each bounce after the first
    (one stable argsort), and the radiance goes back to pixel order at the
    end. The noise is sorted with the lanes. Without decorrelate each lane
    keeps its pixel's noise, so a lane's order changes no pixel's value.
    With it, each bounce's noise is the base noise, which stays in pixel
    order, plus that bounce's shift, made before the bounce's sort and then
    sorted with the lanes: at bounce 2 a lane reads its own pixel's base
    noise, and from bounce 3 on the base noise of the position it held
    before that bounce's sort, as the JAX package computes it."""
    walks = get_engine(engine)
    dev = origin.device
    batch = origin.shape[0]
    radiance = torch.zeros(batch, 3, device=dev)
    throughput = torch.ones(batch, 3, device=dev)
    alive = torch.ones(batch, dtype=torch.bool, device=dev)
    base_noise = noise
    sky = sky_on_device(sky, dev)
    sort_bounces = num_bounces > 1 and scene.num_clusters > SORT_THRESHOLD
    pixel_of = torch.arange(batch, device=dev)
    if sort_bounces:
        # Triangle bounds of the scene, 1023 cells across.
        lo = scene.tri_positions.amin(dim=(0, 1))
        inv = 1023.0 / torch.clamp(scene.tri_positions.amax(dim=(0, 1)) - lo, min=1e-6)

    for bounce in range(1, num_bounces + 1):
        if decorrelate and bounce > 1:
            # Rotate the pixel's noise point by the R2 sequence per bounce.
            shift = torch.tensor([np.float32(0.7548776662466927) * bounce,
                                  np.float32(0.5698402909980532) * bounce], device=dev)
            profiling.count(H2D_BYTES, shift.nbytes)
            noise = base_noise + shift
            noise = noise - torch.floor(noise)
        if bounce > 1:
            origin = torch.where(alive[:, None], origin, PARK)
        if sort_bounces and bounce > 1:
            order = torch.argsort(_coherence_key(origin, direction, alive, lo, inv), stable=True)
            origin, direction, radiance, throughput = (
                x[order] for x in (origin, direction, radiance, throughput))
            alive, noise, pixel_of = (x[order] for x in (alive, noise, pixel_of))
        radiance, hit_lane, p, wi, albedo, ray_ok = _segment(
            scene, sky, walks, origin, direction, throughput, radiance, noise, alive)
        if bounce == num_bounces:
            break
        # Scatter: implicit-PDF Lambertian (wgsl:209-211, 294-301).
        alive = hit_lane & ray_ok
        origin = torch.where(alive[:, None], p, origin)
        direction = torch.where(alive[:, None], wi, direction)
        throughput = torch.where(alive[:, None], throughput * albedo, throughput)

    if sort_bounces:
        radiance = torch.zeros_like(radiance).index_copy_(0, pixel_of, radiance)
    return radiance


def _scan_frames(scene, sky, camera, tile, frame_base: int, accum, ys, xs, *, width: int,
                 height: int, num_bounces: int, spp: int, num_frames: int, engine: str):
    """Add samples frame_base .. frame_base + num_frames - 1 of the pixels
    (ys, xs) (block order) of a width x height image to accum, one
    trace_radiance per sample (fsMain, wgsl:34-64): the fragment's texCoord
    jittered by the frame's noise over the image size, ray v = 1 - texCoord.y
    (wgsl:51-55), thin-lens primaries."""
    u, v_tex = pixel_centres(ys, xs, width, height)
    dims = torch.tensor([float(width), float(height)], device=accum.device)
    profiling.count(H2D_BYTES, dims.nbytes)
    sky = sky_on_device(sky, accum.device)
    for k in range(num_frames):
        noise = animated_blue_noise(ys, xs, frame_base + k, spp, tile=tile)
        jitter = noise / dims
        origin, direction = generate_camera_ray_lens(
            camera, noise, u + jitter[:, 0], (1.0 - v_tex) + jitter[:, 1])
        accum = accum + trace_radiance(scene, sky, origin, direction, noise, num_bounces, engine)
    return accum


def _pixels(width: int, height: int, dev, x0: int = 0, y0: int = 0):
    """(ys, xs) of a width x height window at (x0, y0), in block order: the
    cached tables of render/tiling.py, read-only, offset on the device."""
    ys, xs, _ = block_order_on(width, height, dev)
    return (ys + y0 if y0 else ys), (xs + x0 if x0 else xs)


def accumulate_sample(
    scene: DeviceScene, sky: SkyState, camera: Camera, blue_noise_tile, frame_idx: int, accum,
    *, width: int, height: int, num_bounces: int, spp: int, engine: str = "kernel",
):
    """One progressive frame: one sample per pixel added into accum ((H*W,
    3) f32, block-major pixel order, render/tiling.py). Returns the new
    buffer."""
    ys, xs = _pixels(width, height, accum.device)
    return _scan_frames(scene, sky, camera, blue_noise_tile, frame_idx, accum, ys, xs,
                        width=width, height=height, num_bounces=num_bounces, spp=spp,
                        num_frames=1, engine=engine)


def accumulate_samples(
    scene: DeviceScene, sky: SkyState, camera: Camera, blue_noise_tile, frame_base: int, accum,
    *, width: int, height: int, num_bounces: int, spp: int, num_frames: int,
    engine: str = "kernel",
):
    """The scan form: `num_frames` progressive samples, frame_base first,
    each through trace_radiance over every pixel (num_frames calls of
    accumulate_sample, in one call). Rays, shading and accum are in
    block-major pixel order."""
    ys, xs = _pixels(width, height, accum.device)
    return _scan_frames(scene, sky, camera, blue_noise_tile, frame_base, accum, ys, xs,
                        width=width, height=height, num_bounces=num_bounces, spp=spp,
                        num_frames=num_frames, engine=engine)


@dataclasses.dataclass
class _Dispatch:
    """What every kernel call and shade step of one dispatch shares."""

    scene: DeviceScene
    sky: SkyState
    camera: Camera
    kernels: _Kernels
    inv_dims: tuple[float, float]
    frame_base: int
    spp: int
    nf: int  # samples per pixel in this dispatch
    num_bounces: int
    # (1,) int64 to which each K4 call adds the records its walks read, or None.
    walk_records: torch.Tensor | None = None
    # (1,) int64 to which each K4 call adds the triangles its walks test, or None.
    walk_tests: torch.Tensor | None = None

    @functools.cached_property
    def device_sky(self) -> SkyState:
        """The sky on the scene's device, for the torch code that reads it
        (the shade step, the unfused loop). K3, K4 and K5 take the host
        state's values in their parameter block."""
        return sky_on_device(self.sky, self.scene.device)

    def pixel_args(self, lanes):
        return (self.scene, self.camera, self.sky, lanes["u"], lanes["v_tex"],
                lanes["noise_base"], self.inv_dims, self.frame_base, self.spp, self.nf)

    def primary(self, lanes, sample):
        noise = noise_of(lanes["noise_base"], self.frame_base, sample, self.spp)
        return primary_ray(self.camera, lanes["u"], lanes["v_tex"], noise, self.inv_dims)

    def shade(self, noise_base, sample, origin, direction, tri, thr, bounce):
        noise = noise_of(noise_base, self.frame_base, sample, self.spp)
        return _nee_and_continuation(
            self.scene, noise, origin, direction, tri, thr, bounce, sample < self.nf,
            self.device_sky.sun_direction, self.device_sky.solar_radiances, self.num_bounces,
        )

    def split_step(self, st, lanes, lrad):
        """One K3 call + one shade step. Returns lrad and the hit triangle of
        each lane (-1 where the lane ran out of samples)."""
        (sample, bounce, origin, direction, thr, srad, lrad, _t, tri) = self.kernels.split(
            *self.pixel_args(lanes), T_MAX,
            st["sample"], st["bounce"], st["flag"], st["origin"], st["direction"],
            st["thr"], st["srad"], lrad, st["shadow_o"], st["shadow_d"], st["contrib"],
        )
        (flag, origin, direction, thr, bounce, shadow_o, shadow_d, contrib
         ) = self.shade(lanes["noise_base"], sample, origin, direction, tri, thr, bounce)
        st.update(sample=sample, bounce=bounce, flag=flag, origin=origin,
                  direction=direction, thr=thr, srad=srad, shadow_o=shadow_o,
                  shadow_d=shadow_d, contrib=contrib)
        return lrad, tri

    def shaded_call(self, st, lanes, lrad, live_floor, rays):
        """One K4 call down to `live_floor` live lanes per 128-lane tile; the
        rays it traced are added to `rays` ([closest, shadow])."""
        counted = {k: v for k, v in (("records", self.walk_records), ("tests", self.walk_tests))
                   if v is not None}
        with profiling.span("rf.pt.k4", device=True):
            out = self.kernels.shaded(
                *self.pixel_args(lanes), self.num_bounces, live_floor, T_MAX,
                st["sample"], st["bounce"], st["flag"], st["origin"], st["direction"],
                st["thr"], st["srad"], lrad, st["shadow_o"], st["shadow_d"], st["contrib"],
                **counted,
            )
            (st["sample"], st["bounce"], st["flag"], st["origin"], st["direction"], st["thr"],
             st["srad"], lrad, st["shadow_o"], st["shadow_d"], st["contrib"], traced) = out
            rays.add_(traced)
        return lrad

    def segs_step(self, st, lanes, lrad):
        """One K5 call + the shade of its K hit segments, in ONE shade call
        over the (K * B) slot rows, lane-major: the per-row arithmetic is
        that of K calls, and the launches per iteration stay those of the
        split route. Returns lrad and the slots' fresh flags."""
        (salloc, lrad, ocnt, oray, othr, _t) = self.kernels.segs(
            *self.pixel_args(lanes), T_MAX,
            st["salloc"], lrad, st["cnt"], st["ray"], st["thr"], st["nee"],
        )
        n, segs = ocnt.shape[0], ocnt.shape[1] // 3
        cnt, ray, thr = ocnt.view(-1, 3), oray.view(-1, 6), othr.view(-1, 6)
        (flag, origin, direction, thr3, bounce, shadow_o, shadow_d, contrib
         ) = self.shade(lanes["noise_base"].repeat_interleave(segs, 0), cnt[:, 0],
                        ray[:, 0:3], ray[:, 3:6], cnt[:, 2], thr[:, 0:3], cnt[:, 1])
        st.update(
            salloc=salloc,
            cnt=torch.stack([cnt[:, 0], bounce, flag], 1).view(n, 3 * segs),
            ray=torch.cat([origin, direction], 1).view(n, 6 * segs),
            thr=torch.cat([thr3, thr[:, 3:6]], 1).view(n, 6 * segs),
            nee=torch.cat([shadow_o, shadow_d, contrib], 1).view(n, 9 * segs),
        )
        return lrad, flag


def _initial_state(d: _Dispatch, lanes, batch, dev):
    with profiling.span("rf.pt.initial_state"):
        sample = torch.zeros(batch, dtype=torch.int32, device=dev)
        o0, d0 = d.primary(lanes, sample)
        park_dir = torch.tensor([1.0, 0.0, 0.0], device=dev)
        profiling.count(H2D_BYTES, park_dir.nbytes)
        return dict(
            sample=sample,
            bounce=torch.ones(batch, dtype=torch.int32, device=dev),
            flag=torch.zeros(batch, dtype=torch.int32, device=dev),  # no NEE pending
            origin=o0,
            direction=d0,
            thr=torch.ones(batch, 3, device=dev),
            srad=torch.zeros(batch, 3, device=dev),
            shadow_o=torch.full((batch, 3), PARK, device=dev),
            shadow_d=park_dir.expand(batch, 3).contiguous(),
            contrib=torch.zeros(batch, 3, device=dev),
        )


def _compact(busy, size, pix, batch, *tables):
    """Move the busy lanes, in order, into the first rows of `size` rows of
    every tensor of `tables` (dicts, updated in place); padding rows copy
    lane 0. Returns (valid, pix): the real rows, and each row's pixel
    (`batch`, out of range, on padding rows)."""
    idx = torch.nonzero(busy)[:, 0]
    if idx.numel() > size:
        raise RuntimeError(f"{idx.numel()} busy lanes do not fit a phase of {size}")
    valid = torch.arange(size, device=busy.device) < idx.numel()
    idx = torch.cat([idx, idx.new_zeros(size - idx.numel())])
    # One gather per tensor, integers as integers.
    for table in tables:
        for k in table:
            table[k] = table[k][idx]
    pix = idx if pix is None else pix[idx]
    return valid, torch.where(valid, pix, batch)


def _flush(lrad_full, pix, lrad, batch):
    """Scatter-add compacted lanes' radiance to their pixels, dropping the
    padding rows (pix == batch)."""
    keep = pix < batch
    return lrad_full.index_add(0, pix[keep], lrad[keep])


def _with_counts(out, counts, total):
    """[H, D] -> (out, [closest, shadow]): every sample ends exactly once,
    by a miss (one more closest segment) or at a hit (D), so misses are
    total - D; closest = H + misses, shadow = H."""
    hits, depth = counts
    return out, torch.stack([hits + (total - depth), hits])


def _phased_loop(accum, lanes, floor, st, step, busy, pad):
    """Run `step` (one iteration: lrad -> lrad) down the phase ladder. Phase
    1 has lane == pixel, so lanes accumulate straight into accum. Each phase
    steps while more lanes are busy than the next phase holds, then flushes
    the lane radiance to the pixels and compacts the busy lanes of `st` and
    `lanes` (pending NEE state rides along and resolves in the next phase;
    `pad(valid)` makes the padding rows dead). The last phase steps until
    no lane is busy. Returns the new accumulation buffer."""
    batch = accum.shape[0]
    lrad = accum.clone()
    lrad_full, pix = None, None
    for size in _phase_sizes(batch, floor)[1:]:
        while int(busy().sum()) > size:
            lrad = step(lrad)
        lrad_full = lrad if pix is None else _flush(lrad_full, pix, lrad, batch)
        valid, pix = _compact(busy(), size, pix, batch, st, lanes)
        pad(valid)
        lrad = torch.zeros(size, 3, device=accum.device)
    while bool(busy().any()):
        lrad = step(lrad)
    return lrad if pix is None else _flush(lrad_full, pix, lrad, batch)


def _add_counts(counts, flag):
    """Every surface hit passes through the shade exactly once, so the fresh
    flags count hits H (flag > 0) and the samples that end at a hit rather
    than by a miss, D (flag == 2: depth limit or degenerate scatter)."""
    counts.add_(torch.stack([(flag > 0).sum(), (flag == 2).sum()]))


def _accumulate_regen_fused(d: _Dispatch, accum, lanes, floor, count_rays):
    """The split route: one K3 call and one shade step per iteration.
    Returns the new accumulation buffer and, with count_rays, the exact
    [closest, shadow] ray counts."""
    batch = accum.shape[0]
    st = _initial_state(d, lanes, batch, accum.device)
    counts = torch.zeros(2, dtype=torch.int64, device=accum.device)

    def step(lrad):
        lrad, _ = d.split_step(st, lanes, lrad)
        if count_rays:
            _add_counts(counts, st["flag"])
        return lrad

    def pad(valid):
        st["sample"] = torch.where(valid, st["sample"], d.nf)

    out = _phased_loop(accum, lanes, floor, st, step, lambda: st["sample"] < d.nf, pad)
    return _with_counts(out, counts, batch * d.nf) if count_rays else out


# Lane sort keys of the sorted fused loop: a lane with a hit keys below
# _REGEN_KEY (its hit's cluster x 96 direction bins), a lane without a hit
# that has samples left at _REGEN_KEY + its pixel, a finished lane at
# _DEAD_KEY (the JAX package's bands).
_REGEN_KEY = 2**28
_DEAD_KEY = 2**30


def triangle_clusters(scene: DeviceScene) -> torch.Tensor:
    """(T,) int32: the cluster of each leaf-order triangle, from the scene's
    cluster_tri_map (the JAX sorted loop's `t2c`). A padding slot maps to its
    own cluster's first triangle, so every write to a triangle gives it the
    same cluster."""
    tri_map = scene.cluster_tri_map.long()
    slots = torch.arange(tri_map.shape[0], dtype=torch.int32, device=tri_map.device)
    t2c = torch.zeros(scene.num_triangles, dtype=torch.int32, device=tri_map.device)
    t2c[tri_map] = slots // scene.cluster_tris.shape[1]
    return t2c


def _dir_bin_key(t2c, tri, direction, pix, live):
    """The "dir" sort key (JAX `_dir_bin_key`): the lane's hit cluster x 96
    bins of its continuation direction (cube face x a 4x4 grid on it); a
    lane without a hit sorts by its pixel after every hit lane, so fresh
    camera rays stay together, and a finished lane last. int32, as JAX's."""
    hit = tri >= 0
    hc = t2c[tri.clamp(min=0).long()]
    dx, dy, dz = direction.unbind(1)
    adx, ady, adz = dx.abs(), dy.abs(), dz.abs()
    is_x = (adx >= ady) & (adx >= adz)
    is_y = ~is_x & (ady >= adz)
    m = torch.maximum(torch.maximum(adx, ady), adz)
    m = torch.maximum(m, m.new_tensor(1e-20))
    ds = torch.where(is_x, dx, torch.where(is_y, dy, dz))
    face = torch.where(is_x, 0, torch.where(is_y, 2, 4)) + (ds > 0).to(torch.int32)
    u_ = torch.where(is_x, dy, torch.where(is_y, dz, dx))
    v_ = torch.where(is_x, dz, torch.where(is_y, dx, dy))
    ub = to_int32((u_ / m + 1.0) * 2.0).clamp(0, 3)
    vb = to_int32((v_ / m + 1.0) * 2.0).clamp(0, 3)
    key = hc * 96 + (face * 4 + ub) * 4 + vb
    key = torch.where(hit, key, _REGEN_KEY + pix)
    return torch.where(live, key, _DEAD_KEY).to(torch.int32)


# The lane state of the split route, as the sorted loop moves it: float
# columns (with their widths) and int columns.
_FLOAT_COLS = (("origin", 3), ("direction", 3), ("thr", 3), ("srad", 3), ("lrad", 3),
               ("shadow_o", 3), ("shadow_d", 3), ("contrib", 3), ("u", 1), ("v_tex", 1),
               ("noise_base", 2))
_INT_COLS = ("sample", "bounce", "flag", "pix")


def _permute(state, order):
    """Reorder the lanes of `state` (dict of the columns above) by `order`:
    one gather of the float columns packed side by side and one of the int
    columns (integers stay integers). Each column comes back contiguous, as
    the path kernel takes it."""
    floats = torch.cat([state[k].reshape(-1, w) for k, w in _FLOAT_COLS], 1)[order]
    ints = torch.stack([state[k] for k in _INT_COLS], 1)[order]
    col = 0
    for k, w in _FLOAT_COLS:
        x = floats[:, col:col + w]
        state[k] = (x if w > 1 else x[:, 0]).contiguous()
        col += w
    for i, k in enumerate(_INT_COLS):
        state[k] = ints[:, i].contiguous()


def _accumulate_regen_fused_sorted(d: _Dispatch, accum, lanes, floor, count_rays):
    """The split route with the lanes sorted every iteration (JAX
    `_accumulate_regen_fused_sorted` with its "dir" key): one K3 call and
    one shade step, then the lanes are reordered by _dir_bin_key (one
    stable argsort, _permute), so that the next K3 call walks lanes whose
    rays leave the same cluster in like directions side by side, and
    finished lanes sit at the tail.

    Lanes move from the first iteration, so every lane carries its pixel
    (`pix`) and its own radiance from zero, scatter-added into the pixels at
    the end of every phase, the first included (_flush). Each pixel has one
    lane per phase and a lane's arithmetic does not depend on its position,
    so from a zero accumulator the result equals the unsorted split route's
    bit for bit, with the same ray counts; from another accumulator the
    first phase's sums are grouped differently (ulps). Compaction follows
    the same phase ladder. Returns the new accumulation buffer and, with
    count_rays, the exact [closest, shadow] ray counts."""
    batch = accum.shape[0]
    dev = accum.device
    st = _initial_state(d, lanes, batch, dev)
    st.update(lanes)
    st["pix"] = torch.arange(batch, dtype=torch.int32, device=dev)
    st["lrad"] = torch.zeros(batch, 3, device=dev)
    t2c = triangle_clusters(d.scene)
    counts = torch.zeros(2, dtype=torch.int64, device=dev)

    def step():
        # The lanes' pixel data (u, v_tex, noise_base) ride in st.
        st["lrad"], tri = d.split_step(st, st, st["lrad"])
        if count_rays:
            _add_counts(counts, st["flag"])
        live = st["sample"] < d.nf
        key = _dir_bin_key(t2c, tri, st["direction"], st["pix"], live)
        _permute(st, torch.argsort(key, stable=True))

    out = accum
    for size in _phase_sizes(batch, floor)[1:]:
        while int((st["sample"] < d.nf).sum()) > size:
            step()
        out = _flush(out, st["pix"], st.pop("lrad"), batch)
        valid, st["pix"] = _compact(st["sample"] < d.nf, size, st.pop("pix"), batch, st)
        st["sample"] = torch.where(valid, st["sample"], d.nf)  # padding: dead
        st["lrad"] = torch.zeros(size, 3, device=dev)
    while bool((st["sample"] < d.nf).any()):
        step()
    out = _flush(out, st["pix"], st["lrad"], batch)
    return _with_counts(out, counts, batch * d.nf) if count_rays else out


def _accumulate_regen_inkernel(d: _Dispatch, accum, lanes, floor, count_rays):
    """The in-kernel route. With no compacted phase (a floor of the batch:
    the default) the whole dispatch runs inside K4 at floor 0
    (_shaded_runs). Otherwise the hybrid (JAX _accumulate_regen_inkernel):
    phase 0 is the split route (K3 + torch shade) while more lanes than the
    first compacted phase are busy; then the busy lanes compact, and one K4
    call per further phase runs each 128-lane tile down to a per-tile live
    floor, followed by a flush and a compaction; the last K4 call runs to
    floor 0, in chunks of lanes where one call's scratch would pass its cap
    (_last_call). Returns the new accumulation buffer and, with count_rays,
    the exact [closest, shadow] ray counts: K4's own, plus phase 0's.

    The per-tile floor is nxt // (tiles of the current phase), so the
    survivors always fit the next phase; the JAX loop divides by cur // 128,
    the same wherever the phase is a multiple of 128 lanes or narrower than
    one tile."""
    batch = accum.shape[0]
    sizes = _phase_sizes(batch, floor)
    rays = torch.zeros(2, dtype=torch.int64, device=accum.device)
    if len(sizes) < 2:
        out = _shaded_runs(d, lanes, accum.clone(), rays)
        return (out, rays) if count_rays else out
    st = _initial_state(d, lanes, batch, accum.device)
    lrad_full, pix, lrad = _split_phase0(d, st, lanes, accum, sizes[1],
                                         rays if count_rays else None)
    for cur, nxt in zip(sizes[1:], sizes[2:]):
        lrad = d.shaded_call(st, lanes, lrad, _tile_floor(cur, nxt), rays)
        lrad_full = _flush(lrad_full, pix, lrad, batch)
        pix, lrad = _compact_state(d, st, lanes, nxt, pix, batch)
    lrad = _last_call(d, st, lanes, lrad, rays)
    out = _flush(lrad_full, pix, lrad, batch)
    return (out, rays) if count_rays else out


def _last_call(d: _Dispatch, st, lanes, lrad, rays):
    """The hybrid's last K4 call, at floor 0 over lanes in flight: one call,
    or one call per chunk of lanes_per_call(nf) lanes where one call's
    scratch would pass its cap. At floor 0 no lane is tied to its tile's
    other lanes, and a chunk holds whole tiles, so each lane's outputs are
    those of one call; the lane state and lrad are taken chunk by chunk and
    the rays of every chunk added to `rays`. Returns lrad."""
    batch = lrad.shape[0]
    per_call = lanes_per_call(d.nf)
    if per_call >= batch:
        return d.shaded_call(st, lanes, lrad, 0, rays)
    parts = []
    for first in range(0, batch, per_call):
        rows = slice(first, first + per_call)
        part = {k: x[rows] for k, x in st.items()}
        parts.append((part, d.shaded_call(part, {k: x[rows] for k, x in lanes.items()},
                                          lrad[rows], 0, rays)))
    st.update({k: torch.cat([part[k] for part, _ in parts]) for k in st})
    return torch.cat([out for _, out in parts])


def _shaded_runs(d: _Dispatch, lanes, lrad, rays):
    """A whole dispatch inside K4 at floor 0, every lane from its first
    sample: one call, or one call per run of samples_per_call(lanes) samples
    where one call's scratch would pass its cap. K4 sizes its scratch by the
    call's num_frames and numbers a call's samples from 0, so a run is a
    call of its own length whose frame_base is moved to the run's first
    sample (the noise of a sample depends on frame_base + sample alone),
    from a fresh initial state. lrad is carried from call to call: K4 adds
    the samples' radiance to it in sample order, so the sums are those of
    one call, bit for bit. Adds the rays traced to `rays`; returns lrad."""
    batch = lrad.shape[0]
    per_call = samples_per_call(batch)
    for first in range(0, d.nf, per_call):
        run = dataclasses.replace(d, frame_base=d.frame_base + first,
                                  nf=min(per_call, d.nf - first))
        st = _initial_state(run, lanes, batch, lrad.device)
        lrad = run.shaded_call(st, lanes, lrad, 0, rays)
    return lrad


def _tile_floor(cur: int, nxt: int) -> int:
    """K4's per-tile live floor for a phase of `cur` lanes whose survivors
    move into `nxt` rows."""
    return nxt // -(-cur // TILE)


def _compact_state(d: _Dispatch, st, lanes, size, pix, batch):
    """Compact the busy lanes of the split or in-kernel state into `size`
    rows. Returns (pix, a zero lrad for the new phase)."""
    valid, pix = _compact(st["sample"] < d.nf, size, pix, batch, st, lanes)
    st["sample"] = torch.where(valid, st["sample"], d.nf)  # padding: dead
    return pix, torch.zeros(size, 3, device=valid.device)


def _split_phase0(d: _Dispatch, st, lanes, accum, size, rays=None):
    """Phase 0 of the hybrid in-kernel route: split steps (lane == pixel,
    straight into accum) until at most `size` lanes are busy; then the busy
    lanes compact into `size` rows. Returns (lrad_full, pix, lrad). The rays
    of the phase are added to `rays` ([closest, shadow]) where given: its
    hits H, each with a shadow ray (counted here, though K4 may resolve the
    last ones), and its misses: the samples finished so far (the lanes'
    sample indices) less those that ended at a hit (the D of _add_counts,
    less the flag == 2 lanes whose termination is still pending)."""
    lrad = accum.clone()
    counts = torch.zeros(2, dtype=torch.int64, device=accum.device)
    while int((st["sample"] < d.nf).sum()) > size:
        lrad, _ = d.split_step(st, lanes, lrad)
        if rays is not None:
            _add_counts(counts, st["flag"])
    if rays is not None:
        hits, depth = counts
        pending = ((st["sample"] < d.nf) & (st["flag"] == 2)).sum()
        misses = st["sample"].sum(dtype=torch.int64) - (depth - pending)
        rays.add_(torch.stack([hits + misses, hits]))
    pix, lrad_new = _compact_state(d, st, lanes, size, None, accum.shape[0])
    return lrad, pix, lrad_new


def _initial_slots(d: _Dispatch, lanes, batch, segs, dev):
    """Slot state of the segs route: slot j of every lane starts at sample
    j, the allocator at `segs`; columns as trace_regen_segs takes them."""
    rows = batch * segs
    # Lane-major rows: row b * segs + j is slot j of lane b.
    sample = torch.arange(segs, dtype=torch.int32, device=dev).repeat(batch)
    o0, d0 = d.primary({k: x.repeat_interleave(segs, 0) for k, x in lanes.items()}, sample)
    st = dict(
        salloc=torch.full((batch,), segs, dtype=torch.int32, device=dev),
        cnt=torch.stack([sample, torch.ones_like(sample), torch.zeros_like(sample)], 1),
        ray=torch.cat([o0, d0], 1),
        thr=torch.cat([torch.ones(rows, 3, device=dev), torch.zeros(rows, 3, device=dev)], 1),
        nee=torch.cat([torch.full((rows, 3), PARK, device=dev),
                       torch.tensor([1.0, 0.0, 0.0], device=dev).expand(rows, 3),
                       torch.zeros(rows, 3, device=dev)], 1),
    )
    for k, c in (("cnt", 3), ("ray", 6), ("thr", 6), ("nee", 9)):
        st[k] = st[k].reshape(batch, c * segs)
    return st


def _accumulate_regen_fused_segs(d: _Dispatch, accum, lanes, floor, count_rays, segs):
    """The segs route (JAX _accumulate_regen_fused_segs): each lane keeps
    `segs` paths of its pixel in slots, starting with samples 0..segs-1, and
    takes the pixel's later samples from its allocator. Per iteration, one
    K5 call returns a hit segment per slot and one shade step prepares the
    slots' NEE samples and scatter rays (_Dispatch.segs_step). A lane is
    busy while any slot has samples left (the minimum of the slots'
    samples); compaction follows the same phase ladder. Counts come from the
    slots' fresh flags, exactly as in the split route."""
    batch = accum.shape[0]
    st = _initial_slots(d, lanes, batch, segs, accum.device)
    counts = torch.zeros(2, dtype=torch.int64, device=accum.device)

    def step(lrad):
        lrad, flag = d.segs_step(st, lanes, lrad)
        if count_rays:
            _add_counts(counts, flag)
        return lrad

    def pad(valid):
        # Padding rows: the allocator and every slot exhausted.
        st["salloc"] = torch.where(valid, st["salloc"], d.nf)
        st["cnt"][:, 0::3] = torch.where(valid[:, None], st["cnt"][:, 0::3], d.nf)

    out = _phased_loop(accum, lanes, floor, st, step,
                       lambda: st["cnt"][:, 0::3].amin(dim=1) < d.nf, pad)
    return _with_counts(out, counts, batch * d.nf) if count_rays else out


def _accumulate_unfused(d: _Dispatch, walks, accum, lanes, floor, count_rays):
    """The unfused regeneration loop (JAX accumulate_lanes_regen with an
    engine other than "pallas"): per iteration one _segment over the lanes,
    one closest-hit and one any-hit query, then the lanes whose sample ended
    add its radiance to their pixel, in sample order, and start their
    pixel's next sample. Phase 1 has lane == pixel; when no more lanes are
    busy than the next phase holds, the busy ones compact into it (block
    order kept) and from then on a finished sample is scatter-added to its
    pixel as it ends. Each pixel's radiance starts from accum and adds one
    finished sample at a time, as in the scan form. Returns the new buffer
    and, with count_rays, the exact int64 [closest, shadow] counts: one
    closest query per busy lane and iteration, one shadow ray per hit."""
    batch = accum.shape[0]
    dev = accum.device
    sample = torch.zeros(batch, dtype=torch.int32, device=dev)
    noise = noise_of(lanes["noise_base"], d.frame_base, sample, d.spp)
    origin, direction = primary_ray(d.camera, lanes["u"], lanes["v_tex"], noise, d.inv_dims)
    st = dict(sample=sample, bounce=torch.ones(batch, dtype=torch.int32, device=dev),
              origin=origin, direction=direction, thr=torch.ones(batch, 3, device=dev),
              srad=torch.zeros(batch, 3, device=dev), noise=noise)
    counts = torch.zeros(2, dtype=torch.int64, device=dev)
    lrad, pix = accum.clone(), None

    def step():
        live = st["sample"] < d.nf
        origin = torch.where(live[:, None], st["origin"], PARK)
        srad, hit_lane, p, wi, albedo, ray_ok = _segment(
            d.scene, d.device_sky, walks, origin, st["direction"], st["thr"],
            st["srad"], st["noise"], live)
        if count_rays:
            counts.add_(torch.stack([live.sum(), hit_lane.sum()]))
        scatter = hit_lane & (st["bounce"] < d.num_bounces) & ray_ok
        term = live & ~scatter
        # Flush each finished sample into its pixel, in sample order.
        if pix is None:
            lrad.copy_(torch.where(term[:, None], lrad + srad, lrad))
        else:
            lrad.index_add_(0, pix[term], srad[term])
        sample = torch.where(term, st["sample"] + 1, st["sample"])
        regen = (term & (sample < d.nf))[:, None]
        noise_new = noise_of(lanes["noise_base"], d.frame_base, sample, d.spp)
        po, pd = primary_ray(d.camera, lanes["u"], lanes["v_tex"], noise_new, d.inv_dims)
        s3 = scatter[:, None]
        st.update(
            sample=sample,
            bounce=torch.where(scatter, st["bounce"] + 1, torch.where(regen[:, 0], 1, st["bounce"])),
            origin=torch.where(s3, p, torch.where(regen, po, origin)),
            direction=torch.where(s3, wi, torch.where(regen, pd, st["direction"])),
            thr=torch.where(s3, st["thr"] * albedo, torch.where(regen, 1.0, st["thr"])),
            srad=torch.where(term[:, None], 0.0, srad),
            noise=torch.where(regen, noise_new, st["noise"]),
        )

    for size in _phase_sizes(batch, floor)[1:]:
        while int((st["sample"] < d.nf).sum()) > size:
            step()
        valid, pix = _compact(st["sample"] < d.nf, size, pix, batch, st, lanes)
        st["sample"] = torch.where(valid, st["sample"], d.nf)  # padding: dead
    while bool((st["sample"] < d.nf).any()):
        step()
    return (lrad, counts) if count_rays else lrad


def accumulate_lanes_regen(
    scene: DeviceScene,
    sky: SkyState,
    camera: Camera,
    frame_base: int,
    accum,
    u,
    v_tex,
    noise_base,
    inv_dims: tuple[float, float],
    *,
    num_bounces: int,
    spp: int,
    num_frames: int,
    engine: str = "kernel",
    compact_floor: int | None = None,
    count_rays: bool = False,
    inkernel: bool | None = None,
    segs: int = 1,
    sort: bool = False,
    walk_records: torch.Tensor | None = None,
    walk_tests: torch.Tensor | None = None,
):
    """Regeneration accumulation over an arbitrary set of lanes, each with
    its pixel's data: centre u, v_tex (B,) f32 and blue-noise tile value
    noise_base (B, 2); accum (B, 3) holds the lanes' pixels. inv_dims: 1 /
    width, 1 / height as float32 values. The lane-level entry of
    accumulate_samples_regen (and of a render split across devices), with
    its engines, routes, walk_records, walk_tests and return values."""
    if engine not in _ENGINES and engine not in _UNFUSED:
        raise ValueError(
            f"unknown engine {engine!r}: the port has {sorted([*_ENGINES, *_UNFUSED])}"
        )
    if engine in _UNFUSED and (inkernel is not None or segs != 1 or sort):
        raise ValueError(f"engine {engine!r} is the unfused loop: it takes no route keyword")
    if segs != 1 and segs not in SEGS:
        raise ValueError(f"segs={segs}: 1 (off) or one of {SEGS}")
    if inkernel and segs != 1:
        raise ValueError("inkernel=True and segs > 1 are two different routes")
    if sort and (inkernel is not False or segs != 1):
        raise ValueError("sort is the split route's keyword (inkernel=False)")
    if inkernel is None:
        inkernel = segs == 1
    d = _Dispatch(
        scene=scene, sky=sky, camera=camera, kernels=_ENGINES.get(engine), inv_dims=inv_dims,
        frame_base=frame_base, spp=spp, nf=num_frames, num_bounces=num_bounces,
        walk_records=walk_records, walk_tests=walk_tests,
    )
    lanes = dict(u=u, v_tex=v_tex, noise_base=noise_base)
    if engine in _UNFUSED:
        floor = _COMPACT_FLOOR if compact_floor is None else compact_floor
        return _accumulate_unfused(d, get_engine(engine), accum, lanes, floor, count_rays)
    floor = compact_floor
    if floor is None:
        floor = accum.shape[0] if inkernel else _COMPACT_FLOOR
    if inkernel:
        return _accumulate_regen_inkernel(d, accum, lanes, floor, count_rays)
    if segs > 1:
        return _accumulate_regen_fused_segs(d, accum, lanes, floor, count_rays, segs)
    if sort:
        return _accumulate_regen_fused_sorted(d, accum, lanes, floor, count_rays)
    return _accumulate_regen_fused(d, accum, lanes, floor, count_rays)


def accumulate_samples_regen(
    scene: DeviceScene,
    sky: SkyState,
    camera: Camera,
    blue_noise_tile,
    frame_base: int,
    accum,
    *,
    width: int,
    height: int,
    num_bounces: int,
    spp: int,
    num_frames: int,
    engine: str = "kernel",
    compact_floor: int | None = None,
    count_rays: bool = False,
    inkernel: bool | None = None,
    segs: int = 1,
    sort: bool = False,
    walk_records: torch.Tensor | None = None,
    walk_tests: torch.Tensor | None = None,
):
    """Add samples frame_base .. frame_base + num_frames - 1 of every pixel
    into accum ((H*W, 3) f32, block-major pixel order, render/tiling.py)
    with path regeneration, and return the new buffer.

    blue_noise_tile: (128, 128, 2) f32 tensor on the scene's device. spp is
    the total sample count of the image (it sets the R2 noise period).
    count_rays=True also returns the exact int64 [closest, shadow] ray
    counts, on every route: one closest segment per traced segment plus one
    NEE shadow ray per surface hit, as the reference's megakernel traces
    them (reference_path_tracer.wgsl:180-234). walk_records, a (1,) int64
    tensor on the scene's device, gets added the interior records that the
    walks of every K4 call (kernel or plain) read, closest and shadow: all
    of the dispatch's walks on the default route, those of the K4 phases on
    the hybrid, none on the split and segs routes; walk_tests likewise the
    triangles those walks test.

    engine="kernel" drives the fused loop through the CUDA path kernels;
    engine="plain" through their plain torch versions (any device), by the
    same routes, all with the same per-sample arithmetic, the default first:
    - no route keyword (inkernel=None, segs=1): the whole dispatch inside
      the kernel K4, which shades in place: one call per dispatch, or one
      per run of samples where K4's scratch would pass its cap
      (ops/regen_shaded.py SCRATCH_CAP_BYTES). It is inkernel=True with a
      compact_floor of the batch;
    - inkernel=True with a compact_floor below a tenth of the batch (4,096
      is the other routes' default): the hybrid. After a split first phase,
      K4 runs each 128-lane tile of each compacted phase down to a live
      floor (the JAX RAYFINDER_INKERNEL=1 route);
    - inkernel=False: the split route, the path kernel K3 + a torch shade
      step per iteration. With sort=True it reorders the lanes by the "dir"
      key after every iteration (_accumulate_regen_fused_sorted); with
      False, the default, it does not. The JAX package sorts by default on
      scenes of more than SORT_THRESHOLD clusters; on the H100 the sort made
      K3 faster but the dispatch slower (PERF.md), so here it runs only when
      asked. Only this route takes sort=True; the sort changes no pixel;
    - segs=K (2 to 4): the kernel K5 keeps K paths per lane and returns K
      hit segments per call (the JAX RAYFINDER_SEGS=K route).
    compact_floor is the narrowest compaction phase: by default the batch
    on the in-kernel route (no compaction) and 4,096 lanes on the others.
    The JAX package gates the K4 and K5 routes to small scenes (VMEM
    tables, flat sweeps); the CUDA kernels read triangle attributes and
    texels from global memory and walk the BVH per thread, so they take any
    scene.

    engine="kernel_split" runs the unfused loop (_accumulate_unfused) over
    the ray queries K1/K2 (the JAX "pallas_split"), engine="reference" the
    same loop over the plane walk (the JAX "reference"), engine="wavefront"
    over the cluster engine (render/wavefront.py); they take no route
    keyword."""
    with profiling.span("rf.pt.lanes"):
        lanes = pixel_lanes(width, height, blue_noise_tile)
    return accumulate_lanes_regen(
        scene, sky, camera, frame_base, accum, *lanes,
        num_bounces=num_bounces, spp=spp, num_frames=num_frames, engine=engine,
        compact_floor=compact_floor, count_rays=count_rays, inkernel=inkernel, segs=segs,
        sort=sort, walk_records=walk_records, walk_tests=walk_tests,
    )


def pick_accumulator(scene: DeviceScene, engine: str):
    """The progressive accumulator of render_image and the Renderer.

    On "kernel" and "plain" the fused regeneration loop
    (accumulate_samples_regen) on every scene: its routes take any scene
    (the CUDA kernels walk the BVH per thread and read the shading tables
    from global memory). The sorted fused loop (the split route with
    sort=True, which the JAX package takes on big scenes) only reorders
    lanes, which changes no pixel: from a zero accumulator its image is the
    unsorted loop's bit for bit (tests/test_torch_sorted.py). On the unfused engines
    ("kernel_split", "reference", "wavefront"), as in the JAX package: the
    regeneration loop on scenes of at most SORT_THRESHOLD clusters, and the
    scan form (accumulate_samples), whose per-bounce coherence sort needs
    lane-free pixels, on bigger ones."""
    if engine in _ENGINES or scene.num_clusters <= SORT_THRESHOLD:
        return accumulate_samples_regen
    return accumulate_samples


def accumulate_samples_window(
    scene: DeviceScene,
    sky: SkyState,
    camera: Camera,
    blue_noise_tile,
    frame_base: int,
    accum,
    x0: int,
    y0: int,
    *,
    win_w: int,
    win_h: int,
    width: int,
    height: int,
    num_bounces: int,
    spp: int,
    num_frames: int,
    engine: str = "kernel",
):
    """accumulate_samples over the (win_w, win_h) window at (x0, y0) of a
    width x height image: the window's pixels take their global coordinates,
    so their noise and rays are those of the whole image's (the reference
    bounds work volume the same way, capping buffers to device limits,
    reference_path_tracer.cpp:253-263). accum: (win_h * win_w, 3), block
    order of the window."""
    ys, xs = _pixels(win_w, win_h, accum.device, x0, y0)
    return _scan_frames(scene, sky, camera, blue_noise_tile, frame_base, accum, ys, xs,
                        width=width, height=height, num_bounces=num_bounces, spp=spp,
                        num_frames=num_frames, engine=engine)


def render_image_tiled(
    scene: DeviceScene,
    sky: SkyState,
    camera: Camera,
    *,
    width: int,
    height: int,
    sampling: SamplingParams = SamplingParams(),
    exposure: float = 1.0,
    engine: str = "kernel",
    tile_w: int = 512,
    tile_h: int = 512,
    samples_per_dispatch: int = 8,
) -> np.ndarray:
    """Render a large image window by window through the scan form, so any
    resolution renders with bounded work per call. Every window has one
    shape: edge windows are moved inside the image (clamped offsets) and
    overlap their neighbours, whose pixels they render again identically.
    Returns (H, W, 3) float32 numpy in [0, 1]."""
    dev = scene.device
    tile = torch.from_numpy(blue_noise_tile()).to(dev)
    spp = sampling.num_samples_per_pixel
    win_w, win_h = min(tile_w, width), min(tile_h, height)
    out = np.empty((height, width, 3), np.float32)
    for y0 in range(0, height, tile_h):
        for x0 in range(0, width, tile_w):
            wx, wy = min(x0, width - win_w), min(y0, height - win_h)
            accum = torch.zeros(win_h * win_w, 3, device=dev)
            frame = 0
            while frame < spp:
                n = min(samples_per_dispatch, spp - frame)
                accum = accumulate_samples_window(
                    scene, sky, camera, tile, frame, accum, wx, wy, win_w=win_w, win_h=win_h,
                    width=width, height=height, num_bounces=sampling.num_bounces, spp=spp,
                    num_frames=n, engine=engine)
                frame += n
            img = tonemap(unswizzle(accum, win_w, win_h) / float(spp), exposure)
            out[wy:wy + win_h, wx:wx + win_w] = img.reshape(win_h, win_w, 3).cpu().numpy()
    return out


def render_image(
    scene: DeviceScene,
    sky: SkyState,
    camera: Camera,
    *,
    width: int,
    height: int,
    sampling: SamplingParams = SamplingParams(),
    exposure: float = 1.0,
    engine: str = "kernel",
    samples_per_dispatch: int = 32,
    inkernel: bool | None = None,
    segs: int = 1,
    sort: bool = False,
) -> np.ndarray:
    """Render a full image on the scene's device: spp progressive samples
    through pick_accumulator's choice, running-mean estimator, ACES tonemap
    + gamma (wgsl:59-63). Returns (H, W, 3) float32 numpy in [0, 1].
    inkernel, segs and sort choose the fused loop's route on "kernel" and
    "plain" (accumulate_samples_regen; by default each dispatch runs inside
    K4).

    The JAX package caps big scenes at 4 samples per dispatch, to keep a
    TPU worker from crashing on long programs; nothing here needs it."""
    dev = scene.device
    tile = torch.from_numpy(blue_noise_tile()).to(dev)
    accum = torch.zeros(height * width, 3, device=dev)
    spp = sampling.num_samples_per_pixel
    accumulate = pick_accumulator(scene, engine)
    route = {}
    if inkernel is not None or segs != 1 or sort:
        if engine not in _ENGINES:
            raise ValueError(f"engine {engine!r} has no routes: inkernel, segs and sort are "
                             f"the fused loop's ({sorted(_ENGINES)})")
        route = dict(inkernel=inkernel, segs=segs, sort=sort)
    frame = 0
    while frame < spp:
        n = min(samples_per_dispatch, spp - frame)
        accum = accumulate(
            scene, sky, camera, tile, frame, accum,
            width=width, height=height, num_bounces=sampling.num_bounces,
            spp=spp, num_frames=n, engine=engine, **route,
        )
        frame += n
    img = tonemap(unswizzle(accum, width, height) / float(spp), exposure)
    return img.reshape(height, width, 3).cpu().numpy()
