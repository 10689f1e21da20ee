"""Persistent path kernel with in-kernel shading (K4): CUDA kernel and its
plain version.

Counterpart of `rayfinder_tpu.ops.pallas_regen.pallas_trace_regen_shaded`.
Each round, per lane: resolve the pending NEE sample, terminate flag==2
paths, trace one closest segment (a miss adds the sky, flushes and
regenerates), then shade the hit in place (render/shade.py). The rounds
repeat while more than `live_floor` lanes of the lane's 128-lane tile have
samples left, so a nonzero floor lets the caller compact the survivors and
call again. Lane arrays keep the TPU kernel's public layout: (B,) and (B, 3).

The kernel (csrc/regen_shaded.cu) walks the scene's packed walk tables
(`bvh_nodes2`, `tri_pos4`; csrc/traverse2.cuh), and a scene without them
raises; it reads the triangle attributes and texels from global memory, so
it has none of the TPU kernel's scene-size or VMEM limits. Above floor 0 it
runs one 128-thread block per tile. At floor 0 no lane is tied to its tile:
the warps of a grid that fills the card take (lane, sample) work items from
a counter, each item writes its sample's radiance to a scratch, and a second
small kernel folds them into the lane's radiance in sample order, so every
output equals the tile rule's bit for bit (the wrapper allocates the
scratch, B x num_frames x 3 floats, and the zeroed counter). That scratch is
capped at SCRATCH_CAP_BYTES: a call that would need more raises, and the
loop (render/pathtracer.py) keeps its calls inside the cap: a dispatch from
every lane's first sample in runs of `samples_per_call` samples, a call over
lanes already in flight in chunks of `lanes_per_call` lanes (whole tiles).
Both kernels count the rays they trace, and the call returns the counts
with the lane state; they also count the interior records their walks read
and the triangles they test (closest and shadow: walk_packed's counting
level 2), which the call adds to `records` and `tests` where the caller
passes them. The plain version
`trace_regen_shaded_reference` runs the same rounds in torch over the lanes
of the tiles still running. A wrapper given CPU tensors runs the plain
version; given CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from ..render.camera import Camera
from ..render.rng import noise_of
from ..render.scene import DeviceScene
from ..render.shade import _nee_and_continuation
from ..render.traverse import intersect_closest, intersect_closest_counted
from ..sky.model import SkyState, sky_on_device, sky_radiance_dir
from . import _build
from .regen import _params, add_nee, lane_inputs, primaries

__all__ = ["trace_regen_shaded", "trace_regen_shaded_reference", "samples_per_call",
           "lanes_per_call", "TILE", "SCRATCH_CAP_BYTES"]

# Lanes per tile: the live floor is counted per tile (the CUDA block).
TILE = 128

# The most that one floor-0 call's radiance scratch may take: 268,435,456
# bytes (256 MiB, 0.3% of the memory of an NVIDIA H100 80GB HBM3). A
# (lane, sample) item takes 12 bytes of it.
SCRATCH_CAP_BYTES = 268_435_456
_ITEM_BYTES = 12


def samples_per_call(lanes: int) -> int:
    """Samples per pixel that one floor-0 call over `lanes` lanes may take
    with its scratch inside SCRATCH_CAP_BYTES (at least 1: a call of more
    lanes than the cap holds at one sample raises)."""
    return max(1, SCRATCH_CAP_BYTES // (_ITEM_BYTES * max(lanes, 1)))


def lanes_per_call(samples: int) -> int:
    """Lanes, in whole 128-lane tiles, that one floor-0 call of `samples`
    samples per pixel may take with its scratch inside SCRATCH_CAP_BYTES (at
    least one tile: a tile of more samples than the cap holds raises)."""
    return TILE * max(1, SCRATCH_CAP_BYTES // (_ITEM_BYTES * max(samples, 1) * TILE))


def trace_regen_shaded(
    scene: DeviceScene, camera: Camera, sky: SkyState, u, v_tex, noise_base,
    inv_dims: tuple[float, float], frame_base: int, spp: int, num_frames: int,
    num_bounces: int, live_floor: int, t_max: float,
    sample, bounce, flag, origin, direction, thr, srad, lrad,
    shadow_o, shadow_d, contrib, records=None, tests=None,
):
    """Run the path loop with in-kernel shading until each 128-lane tile
    (lanes 128k .. 128k+127) has at most `live_floor` lanes with samples left
    (0: until every sample is done).

    Arguments as `trace_regen`, plus the depth limit num_bounces and the
    per-tile floor. Returns the whole lane state (sample, bounce, flag,
    origin, direction, thr, srad, lrad, shadow_o, shadow_d, contrib): lanes
    still live carry their pending NEE sample (flag 1 or 2) to the next
    call; and, last, the rays this call traced, (2,) int64 [closest,
    shadow]: one per closest segment, one per surface hit (its NEE shadow
    ray, counted at the hit). `records` and `tests`, (1,) int64 tensors on the
    lanes' device, get the interior records that the call's walks read and
    the triangles they test added to them."""
    if u.device.type == "cpu":
        return trace_regen_shaded_reference(
            scene, camera, sky, u, v_tex, noise_base, inv_dims, frame_base, spp,
            num_frames, num_bounces, live_floor, t_max, sample, bounce, flag, origin,
            direction, thr, srad, lrad, shadow_o, shadow_d, contrib, records, tests,
        )
    dev = u.device
    n = u.shape[0]
    inputs = lane_inputs(n, u, v_tex, noise_base, sample, bounce, flag, origin, direction,
                         thr, srad, lrad, shadow_o, shadow_d, contrib)
    for tensor, name, dtype, shape in inputs:
        _build.check(tensor, name, dtype, shape, dev)
    outputs = (
        *(torch.empty(n, dtype=torch.int32, device=dev) for _ in range(3)),
        *(torch.empty(n, 3, dtype=torch.float32, device=dev) for _ in range(8)),
    )
    counts = torch.zeros(4, dtype=torch.int64, device=dev)  # closest, shadow, records, tests
    if n:
        params = _params(camera, sky, inv_dims, frame_base, spp, num_frames, t_max,
                         num_bounces=num_bounces, live_floor=live_floor)
        tables = _build.packed_args(scene, dev, sized=True) + _build.shade_args(scene, dev)
        # Floor 0: the work items' radiance scratch and their counter.
        scratch = None, None
        if live_floor <= 0:
            if _ITEM_BYTES * n * num_frames > SCRATCH_CAP_BYTES:
                raise ValueError(
                    f"a floor-0 call of {n} lanes x {num_frames} samples needs a scratch of "
                    f"{_ITEM_BYTES * n * num_frames} bytes, over the cap of "
                    f"{SCRATCH_CAP_BYTES}: at most {samples_per_call(n)} samples per call")
            scratch = (torch.empty(n, num_frames, 3, dtype=torch.float32, device=dev),
                       torch.zeros(1, dtype=torch.int64, device=dev))
        lib = _build.library()
        with torch.cuda.device(dev):
            err = lib.rf_trace_regen_shaded(
                *tables, ctypes.addressof(params), n,
                *(tensor.data_ptr() for tensor, *_ in inputs),
                *(out.data_ptr() for out in outputs),
                *(t if t is None else t.data_ptr() for t in scratch),
                counts.data_ptr(), _build.stream_of(dev),
            )
        _build.raise_on_error(err, "rf_trace_regen_shaded")
        trace_regen_shaded.launches += 1
        if records is not None:
            records.add_(counts[2:3])
        if tests is not None:
            tests.add_(counts[3:])
    return (*outputs, counts[:2])


# Kernel launch count (a run resets and reads it to show which kernels it
# went through).
trace_regen_shaded.launches = 0


def trace_regen_shaded_reference(
    scene: DeviceScene, camera: Camera, sky: SkyState, u, v_tex, noise_base,
    inv_dims: tuple[float, float], frame_base: int, spp: int, num_frames: int,
    num_bounces: int, live_floor: int, t_max: float,
    sample, bounce, flag, origin, direction, thr, srad, lrad,
    shadow_o, shadow_d, contrib, records=None, tests=None,
):
    """Plain torch version of `trace_regen_shaded`, on any device. Same
    arguments and results; the rounds of csrc/regen_shaded.cu over the
    lanes of the tiles still running. Given `records` (and `tests`), its
    walks count the records that the kernel's read (and the triangles they
    test): a closest walk's from its plane walk's visits (one node for the
    root and two per record) and tests, a shadow walk's from the packed
    walk's plain version (ops/regen.py add_nee)."""
    nf = num_frames
    n = u.shape[0]
    dev = u.device
    st = dict(sample=sample.clamp(max=nf), bounce=bounce, flag=flag, origin=origin,
              direction=direction, thr=thr, srad=srad, lrad=lrad, shadow_o=shadow_o,
              shadow_d=shadow_d, contrib=contrib)
    st = {k: x.clone() for k, x in st.items()}
    sky = sky_on_device(sky, dev)
    tile = torch.arange(n, device=dev) // TILE
    num_tiles = -(-n // TILE)
    rays = torch.zeros(2, dtype=torch.int64, device=dev)  # [closest, shadow]

    def running():
        """Lanes of the tiles with more than live_floor live lanes."""
        live = torch.zeros(num_tiles, dtype=torch.int64, device=dev)
        live.index_add_(0, tile, (st["sample"] < nf).to(torch.int64))
        return torch.nonzero((live > live_floor)[tile])[:, 0]

    idx = running()
    while idx.numel():
        s = {k: x[idx] for k, x in st.items()}
        sample = s["sample"]
        live = sample < nf

        def regenerate(rows):
            s["origin"][rows], s["direction"][rows] = primaries(
                camera, u, v_tex, noise_base, inv_dims, frame_base, spp, idx[rows],
                sample[rows])
            s["thr"][rows] = 1.0
            s["bounce"][rows] = 1

        # 1. Pending NEE light sample of the previous segment.
        srad = add_nee(scene, live & (s["flag"] > 0), s["srad"], s["shadow_o"],
                       s["shadow_d"], s["contrib"], t_max, records=records, tests=tests)
        # 2. Terminate after NEE: flush, finish the sample, regenerate.
        term = live & (s["flag"] == 2)
        lrad = torch.where(term[:, None], s["lrad"] + srad, s["lrad"])
        srad = torch.where(term[:, None], 0.0, srad)
        sample = torch.where(term, sample + 1, sample)
        regenerate(torch.nonzero(term & (sample < nf))[:, 0])

        # 3. One closest segment; a miss adds the sky, flushes, regenerates.
        flying = torch.nonzero(sample < nf)[:, 0]
        tri = torch.full_like(sample, -1)
        if tests is None:
            hit, _, tri_f, visits = intersect_closest(scene, s["origin"][flying],
                                                      s["direction"][flying], t_max)
        else:
            hit, _, tri_f, work = intersect_closest_counted(
                scene, s["origin"][flying], s["direction"][flying], t_max)
            visits = work[:, 0]
            tests += work[:, 2].sum(dtype=torch.int64)
        if records is not None:
            records += ((visits.to(torch.int64) - 1) // 2).sum()
        tri[flying] = tri_f
        rays[0] += flying.numel()
        rays[1] += hit.sum()
        miss = flying[~hit]
        srad[miss] = srad[miss] + s["thr"][miss] * sky_radiance_dir(sky, s["direction"][miss])
        lrad[miss] = lrad[miss] + srad[miss]
        srad[miss] = 0.0
        sample[miss] = sample[miss] + 1
        regenerate(miss[sample[miss] < nf])

        # 4. Shade every lane of the running tiles (hit-masked).
        noise = noise_of(noise_base[idx], frame_base, sample, spp)
        (flag, origin, direction, thr, bounce, shadow_o, shadow_d, contrib
         ) = _nee_and_continuation(
            scene, noise, s["origin"], s["direction"], tri, s["thr"], s["bounce"],
            sample < nf, sky.sun_direction, sky.solar_radiances, num_bounces,
        )
        new = dict(sample=sample, bounce=bounce, flag=flag, origin=origin,
                   direction=direction, thr=thr, srad=srad, lrad=lrad, shadow_o=shadow_o,
                   shadow_d=shadow_d, contrib=contrib)
        for k, x in new.items():
            st[k][idx] = x
        idx = running()
    return (st["sample"], st["bounce"], st["flag"], st["origin"], st["direction"],
            st["thr"], st["srad"], st["lrad"], st["shadow_o"], st["shadow_d"],
            st["contrib"], rays)
