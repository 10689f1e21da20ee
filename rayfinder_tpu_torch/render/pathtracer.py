"""Path tracer with path regeneration: the port of the JAX package's fused
regeneration loop (`rayfinder_tpu.render.pathtracer`, accumulate_samples_regen
with engine="pallas": _accumulate_regen_fused and its two other routes,
_accumulate_regen_inkernel and _accumulate_regen_fused_segs).

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
The hybrid in-kernel route (inkernel=True with a compact_floor below the
batch) runs K4 per phase after a split first phase; the segs route (segs=K)
keeps K paths per lane in the kernel K5 (ops/regen_segs.py).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..ops.regen import trace_regen, trace_regen_reference
from ..ops.regen_segs import SEGS, trace_regen_segs, trace_regen_segs_reference
from ..ops.regen_shaded import (
    TILE, lanes_per_call, samples_per_call, trace_regen_shaded, trace_regen_shaded_reference,
)
from ..sky.model import SkyState
from .camera import Camera, primary_ray
from .intersect import T_MAX
from .rng import blue_noise_tile, noise_of
from .scene import DeviceScene
# The shade step lives in render/shade.py (the plain kernels use it too);
# it is re-exported here, beside the loop that drives it.
from .shade import PARK, _nee_and_continuation, _surface_interaction  # noqa: F401
from .tiling import block_order, unswizzle
from .tonemap import tonemap

# Phase compaction: when the busy-lane count falls below 1/DIV of the batch,
# the busy lanes move into a batch that size, then down a ladder to FLOOR
# lanes (the JAX package's ladder; its widths were tuned on a TPU and are
# kept until a GPU measurement says otherwise).
_COMPACT_DIV = 10
_COMPACT_FLOOR = 4096


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
    sun_dir: torch.Tensor
    solar: torch.Tensor

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
            self.sun_dir, self.solar, self.num_bounces,
        )

    def split_step(self, st, lanes, lrad):
        """One K3 call + one shade step."""
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
        return lrad

    def shaded_call(self, st, lanes, lrad, live_floor, rays):
        """One K4 call down to `live_floor` live lanes per 128-lane tile; the
        rays it traced are added to `rays` ([closest, shadow])."""
        out = self.kernels.shaded(
            *self.pixel_args(lanes), self.num_bounces, live_floor, T_MAX,
            st["sample"], st["bounce"], st["flag"], st["origin"], st["direction"],
            st["thr"], st["srad"], lrad, st["shadow_o"], st["shadow_d"], st["contrib"],
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
    sample = torch.zeros(batch, dtype=torch.int32, device=dev)
    o0, d0 = d.primary(lanes, sample)
    return dict(
        sample=sample,
        bounce=torch.ones(batch, dtype=torch.int32, device=dev),
        flag=torch.zeros(batch, dtype=torch.int32, device=dev),  # no NEE pending
        origin=o0,
        direction=d0,
        thr=torch.ones(batch, 3, device=dev),
        srad=torch.zeros(batch, 3, device=dev),
        shadow_o=torch.full((batch, 3), PARK, device=dev),
        shadow_d=torch.tensor([1.0, 0.0, 0.0], device=dev).expand(batch, 3).contiguous(),
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
        lrad = d.split_step(st, lanes, lrad)
        if count_rays:
            _add_counts(counts, st["flag"])
        return lrad

    def pad(valid):
        st["sample"] = torch.where(valid, st["sample"], d.nf)

    out = _phased_loop(accum, lanes, floor, st, step, lambda: st["sample"] < d.nf, pad)
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
        lrad = d.split_step(st, lanes, lrad)
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
):
    """Add samples frame_base .. frame_base + num_frames - 1 of every pixel
    into accum ((H*W, 3) f32, block-major pixel order, render/tiling.py)
    with path regeneration, and return the new buffer.

    blue_noise_tile: (128, 128, 2) f32 tensor on the scene's device. spp is
    the total sample count of the image (it sets the R2 noise period).
    count_rays=True also returns the exact int64 [closest, shadow] ray
    counts, on every route: one closest segment per traced segment plus one
    NEE shadow ray per surface hit, as the reference's megakernel traces
    them (reference_path_tracer.wgsl:180-234).

    Routes, all with the same per-sample arithmetic, the default first:
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
      step per iteration;
    - segs=K (2 to 4): the kernel K5 keeps K paths per lane and returns K
      hit segments per call (the JAX RAYFINDER_SEGS=K route).
    compact_floor is the narrowest compaction phase: by default the batch
    on the in-kernel route (no compaction) and 4,096 lanes on the others.
    The JAX package gates the K4 and K5 routes to small scenes (VMEM
    tables, flat sweeps); the CUDA kernels read triangle attributes and
    texels from global memory and walk the BVH per thread, so they take any
    scene.

    engine="kernel" drives the loop through the CUDA path kernels;
    engine="plain" through their plain torch versions (any device), by the
    same routes."""
    if engine not in _ENGINES:
        raise ValueError(
            f"unknown engine {engine!r}: the port has {sorted(_ENGINES)}"
        )
    if segs != 1 and segs not in SEGS:
        raise ValueError(f"segs={segs}: 1 (off) or one of {SEGS}")
    if inkernel and segs != 1:
        raise ValueError("inkernel=True and segs > 1 are two different routes")
    if inkernel is None:
        inkernel = segs == 1
    dev = accum.device
    ys_np, xs_np, _ = block_order(width, height)
    ys = torch.from_numpy(ys_np).to(dev)
    xs = torch.from_numpy(xs_np).to(dev)
    u = (xs.to(torch.float32) + 0.5) / float(width)
    v_tex = (ys.to(torch.float32) + 0.5) / float(height)
    # The tile value is a function of the pixel: gather it once per call;
    # each sample's noise is that base plus the frame's R2 offset.
    th, tw = blue_noise_tile.shape[0], blue_noise_tile.shape[1]
    noise_base = blue_noise_tile[(ys % th).long(), (xs % tw).long()]
    inv_dims = (float(np.float32(1.0) / np.float32(width)),
                float(np.float32(1.0) / np.float32(height)))
    d = _Dispatch(
        scene=scene, sky=sky, camera=camera, kernels=_ENGINES[engine], inv_dims=inv_dims,
        frame_base=frame_base, spp=spp, nf=num_frames, num_bounces=num_bounces,
        sun_dir=torch.as_tensor(sky.sun_direction, device=dev),
        solar=torch.as_tensor(sky.solar_radiances, device=dev),
    )
    lanes = dict(u=u, v_tex=v_tex, noise_base=noise_base)
    floor = compact_floor
    if floor is None:
        floor = accum.shape[0] if inkernel else _COMPACT_FLOOR
    if inkernel:
        return _accumulate_regen_inkernel(d, accum, lanes, floor, count_rays)
    if segs > 1:
        return _accumulate_regen_fused_segs(d, accum, lanes, floor, count_rays, segs)
    return _accumulate_regen_fused(d, accum, lanes, floor, count_rays)


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
) -> np.ndarray:
    """Render a full image on the scene's device: spp progressive samples,
    running-mean estimator, ACES tonemap + gamma (wgsl:59-63). Returns
    (H, W, 3) float32 numpy in [0, 1]. inkernel and segs choose the route
    (accumulate_samples_regen; by default each dispatch runs inside K4)."""
    dev = scene.device
    tile = torch.from_numpy(blue_noise_tile()).to(dev)
    accum = torch.zeros(height * width, 3, device=dev)
    spp = sampling.num_samples_per_pixel
    frame = 0
    while frame < spp:
        n = min(samples_per_dispatch, spp - frame)
        accum = accumulate_samples_regen(
            scene, sky, camera, tile, frame, accum,
            width=width, height=height, num_bounces=sampling.num_bounces,
            spp=spp, num_frames=n, engine=engine, inkernel=inkernel, segs=segs,
        )
        frame += n
    img = tonemap(unswizzle(accum, width, height) / float(spp), exposure)
    return img.reshape(height, width, 3).cpu().numpy()
