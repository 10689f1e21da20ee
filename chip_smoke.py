"""Smoke run of the PyTorch port (rayfinder_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --kernel-times

Run from the root of a checkout, on a machine with a CUDA device and the
CUDA toolkit (nvcc). It imports only the port. It builds the port's CUDA
kernels from csrc/, then:

1. prints the card's name and power limit, the build time, and each
   kernel's registers, stack frame and spills (ptxas);
2. runs the closest-hit (K1) and any-hit (K2) kernels, which walk the
   packed tables, on the 256 rays of each *_courtyard8.npz golden and on
   262,144 camera and random rays over the 254K-triangle courtyard, and
   holds them to their plain torch versions on the same card exactly (t at
   atol 0, tri, nodes visited, occlusion); the counted walk (K6) on the
   same rays must equal K1 (t, tri, nodes) and gives its work, the plain
   plane walk must equal K2;
3. renders the untextured courtyard_scene(8) at 128x96, 8 spp, 4 bounces
   through the default route (one K4 call per dispatch) and its plain
   version, the split route (K3) and its plain version, and the hybrid
   in-kernel (K3 + K4) and segs=2 (K5) routes: the tonemapped images must
   agree at RMSE < 1e-3, each must lie within RMSE 5e-3 of
   tests/goldens/courtyard_untextured_128x96_8spp.npz (baked by the JAX
   package), the [closest, shadow] ray counts, which every route counts,
   equal among the kernel routes and within 0.1% of the plain ones;
3b. the same for the textured courtyard_scene(8) (its textures built
   without Pillow), against
   tests/goldens/courtyard_textured_128x96_8spp.npz;
4. runs the slice -- courtyard_scene(26) untextured (254,176 triangles),
   512x512, 4 bounces -- through accumulate_samples_regen with no route
   keyword: one warm-up dispatch of 16 samples, then one timed dispatch of
   16, the kernels' launch counts set to 0 just before and read just
   after: it must take one K4 call per dispatch and count 11,611,591 /
   8,839,510 rays;
5. runs the slice through every other route the same way (split, hybrid
   in-kernel, segs=2, segs=4, and the one-call route by its keywords),
   holds their accumulations to the default's and every route's ray
   counts to the split route's, and times three more dispatches of each
   route in turns; runs one capped dispatch (a sample count whose K4
   scratch would pass the cap: two K4 calls) against the same dispatch with
   the cap lifted, bit for bit, and one 256-sample dispatch of the hybrid
   whose last K4 call would pass the cap (compact_floor 131,072: two chunks
   of lanes) against the cap lifted, bit for bit, with the split route's
   ray counts; 5b does the route comparison again on the
   textured courtyard(26) at 512x512; then one instrumented dispatch of
   each route (split, segs=2, hybrid, one call) gives its path kernel's
   (K3, K5, K4, K4) device time per launch, summed by the launch's lane
   count;
6. holds each path kernel (K3, K4, K5) to its plain version at the slice's
   shapes, and counts the walks' work of each call; K4 at two shapes: the
   26,624 compacted lanes of the in-kernel route's first shaded phase with
   their per-tile floor, and all 262,144 lanes at floor 0 (the one-call
   route), there also against a second launch, bit for bit;
7. the traversal efficiency of the bench (prof/diag_iters.py): the
   courtyard(26) through the production asset path (GLB -> .pt -> scene),
   its 512x512 primary rays and two dir-key-sorted bounce populations;
   the counted walk (K6) on every ray, held to its plain version (t, tri,
   all counts exact) and to K1 (t, tri, nodes), and timed beside K1 on the
   primary rays; the slab-entry reductions
   (K7) held to their plain version on 4,096 rays of each population over
   all leaves (need, group minima and selection exact); need <= triangle
   tests on every ray; the mt_waste figures;
8. the probes: K7 at the TPU probe's shapes (prof/probe_prebuilt.py), and
   the sky-round probe (K8, prof/prof_skyround.py) in each mode and for
   each camera, held to its plain version at 4 rounds on all 65,536 lanes,
   then timed at 64 rounds; its timed shape ("full", Duck camera, 64
   rounds) also held to its plain version;
9. (run after 5b) the scan integrator, the unfused loop and the Renderer,
   over K1/K2: at 128x96, untextured and textured, the unfused loop over
   K1/K2 (engine="kernel_split") and render_image_tiled in 64x48 windows
   with K1/K2, each within RMSE 1e-3 of the default route's image and 5e-3
   of the golden, the unfused loop's ray counts equal to the default
   route's, and (untextured) the tiled scan form through the plain versions
   equal to it bit for bit; K1/K2 held to
   their plain versions exactly on the rays and shadow rays of bounce 2 of
   the scan form over the slice, parked lanes included; on the slice, the
   scan form (accumulate_samples: 64 K1 and 64 K2 per 16-sample dispatch,
   within RMSE 1e-3 of the default route) and the unfused loop (exactly
   11,611,591 / 8,839,510 rays), timed; the Renderer (three render(16):
   progress, frames, total_rays, image_u8, a checkpoint round trip, reset
   on change only); 1920x1080 at 4 spp tiled (scan form) against untiled
   (default route), RMSE < 1e-3, and the default route's seconds per
   sample and time to 1024 spp there. One more dispatch of each form on the
   slice runs under torch.profiler for the device's busy share;
10. (run after 8) the deferred renderer and the interactive layer over
   K1/K2: (a) three DeferredRenderer frames of each courtyard_scene(8) at
   128x96 on K1/K2 and on their plain versions, the accumulators bit for
   bit, displays and debug triptychs equal and within RMSE 5e-3 of
   tests/goldens/courtyard_deferred_128x96_f3.npz, and the sun check;
   (b) the slice's path: DeferredRenderer on courtyard_scene(26) at
   1920x1080 (bench camera and sky), two warm-up and eight timed frames
   (ms per frame, synchronised, u8 readback included; 2 K1 + 2 K2 launches
   per frame, counted over the timed frames), the three passes unfused
   between CUDA events, one frame under torch.profiler, the peak memory,
   one frame's four queries launched at full width, each launch's result
   held to the plain walks on its first and last 262,144 rays and timed,
   and every ray passed through against the dropped lanes parked, in
   turns; (c) a scripted ViewerSession on the slice's scene at 640x480 (pt
   frames with the Mrays/s readout, a move resetting both renderers, a
   focus pick through K1, deferred and debug frames, every PNG written);
   (d) the BVH heat map of the slice's .pt at 1280x720, K1's node counts
   equal to the plain walk's on its first and last 262,144 rays, and
   tools/render.py on procedural:courtyard:26 at 640x480, 16 spp;
11. (run after 10) the port's last modules: (a) the wavefront engine
   (render/wavefront.py, torch code) against K1/K2 on phase 2's 262,144
   rays, t/tri/occlusion equal but on rays each side's slab test prunes by
   an ulp or equal-t hits met in another order (counted, at most 0.05%),
   with its escalations and wall time; (b) the split route sorted by the
   "dir" key every iteration against unsorted on the slice: bit for bit
   from a zero accumulator, 11,611,591 / 8,839,510 rays on samples 16-31,
   then three dispatches of each in turns (wall) and three under
   torch.profiler (K3's device time); (c) render_image_sharded_regen on a
   1x1 nccl mesh at 1920x1080, 16 spp on the slice's scene, bit for bit
   render_image, and its last K4 call (2,073,600 lanes) recorded and held
   to K4's plain version on its first and last 262,144 lanes; (d) 2x1, 1x2
   and 2x2 gloo meshes as 2-4 processes sharing the card
   (torch.multiprocessing), courtyard_scene(8) at 128x96, against the 1x1
   images (RMSE < 1e-6), one K4 launch per shard, and on 2x2 the scan form
   (render_image_sharded) with "kernel" (K1/K2 per rank counted) and
   "wavefront", the two within RMSE 1e-3; (e) two nccl ranks on the card,
   refused, and
   tools/render.py --mesh 2x1 --backend gloo under torch.distributed.run.

Any failed check raises, so the script exits non-zero and prints no "ok"
line. The line before the last is a JSON object of per-kernel numbers
(time, plain time, launches on the run that drives each kernel -- for K1
and K2 phase 10's timed 1080p deferred frames, with every path's count
beside it -- bound, and two closer figures beside it: the issue limit without FMAs and, for a walk,
the bytes its rays load at the measured rate of data held in L2); the
last is {"ok": true, "device": {...}}. Every printed time names the card and
its power limit; the total seconds stand on a line before the card's.

A kernel's time is the mean over launches of one CUDA event pair around
each launch, with a busy-wait queued ahead of the start event so that the
host's time between launches is not counted (_timed_call).

--kernel-times runs phases 1, 2 (on the big courtyard only), the
instrumented dispatches of 5, 6, K6's and K1's times on phase 7's primary
rays and K7's at phase 7's shape (on the built courtyard), and 8 (K8 on the
built courtyard), and
prints their kernel numbers as one JSON line. Those phases use nothing
that the port lacked before its packed walk tables, so a copy of this
script times an older tree in turns with a newer one.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import pathlib
import re
import subprocess
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parent
GOLDENS = ROOT / "tests" / "goldens"

# The bench configuration of the JAX package (bench.py main_courtyard).
SLICE = dict(width=512, height=512, num_bounces=4, spp=256, num_frames=16)
CAMERA = ([-16.0, 5.0, 0.0], [12.0, 2.0, 0.0], 0.0, 1.0, 70.0)
SKY = (2.5, (0.3, 0.3, 0.3), 35.0, 25.0)
# The exact [closest, shadow] rays of the slice's timed dispatch (samples
# 16-31), on every route.
SLICE_RAYS = [11_611_591, 8_839_510]


# Cycles of the busy-wait queued ahead of each timed launch (about 1 ms at
# the H100's clock): longer than the host takes to queue one launch.
QUEUE_AHEAD_CYCLES = 2_000_000

# Peak rates of one H100 SXM (NVIDIA's data sheet, at 700 W): float32
# outside the tensor cores, and device memory.
F32_OPS_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12
# Two closer figures beside the bound (_bound): the issue limit and the
# bytes each ray loads. The kernels build with --fmad=false, so the card
# issues one instruction per lane and clock (half the FMA peak), and
# comparisons, min/max, abs and selects issue at half of that; a kernel's
# instructions then take max(full + half, 2 * half) issue slots. Counted from
# csrc/traverse2.cuh slab_key (with the bound's compare) and traverse.cuh
# moller_trumbore as (full-rate, half-rate) instructions: a slab test is 6
# subtracts and 6 multiplies; 9 comparisons, 4 min/max and 7 selects. A
# Moller-Trumbore test is 15 subtracts, 27 multiplies, 9 adds and a divide;
# 7 comparisons and an abs. K7's inner loop per ray-box pair (its SASS): 6
# adds, 6 multiplies and an integer add; 6 logic selects, 6 min/max, 6
# comparisons and a predicate operation.
SLOTS_PER_S = F32_OPS_PER_S / 2
SLAB_TEST_SLOTS = (12, 20)
TRIANGLE_TEST_SLOTS = (52, 8)
PAIR_SLOTS = (13, 19)
# A walk loads its nodes and triangles ray by ray through the caches, however
# small the scene: per record read (two nodes visited below the root) 64
# bytes, per triangle test three 16-byte rows. Set against the rate at which
# plain torch passes move data held in L2, which main() measures (_l2_rate):
# what the walk would take if every load went to L2. Loads that hit L1 do
# not, so a walk can be faster than this figure: it is an estimate of the
# L2's share, not a bound.
LOADED_RECORD_BYTES = 64
LOADED_TRIANGLE_BYTES = 48
L2_PASS_BYTES = (8 << 20, 16 << 20)
L2_RATE = {"bytes_per_s": None}
# The BVH's SoA planes (the plain walk's layout), and the shading tables of
# K4.
NODE_PLANES = ("bvh_aabb_min", "bvh_aabb_max", "bvh_tri_offset", "bvh_second_child",
               "bvh_tri_count", "bvh_split_axis")
SHADE_TABLES = ("tri_attrs", "tex_desc", "texels")
# K4's lane outputs, in order (its last output is the rays it traced).
K4_OUTPUTS = ("sample", "bounce", "flag", "origin", "direction", "thr", "srad", "lrad",
              "shadow_o", "shadow_d", "contrib")
# The cluster tables of the wavefront engine and the sorted loop's key.
CLUSTER_TABLES = ("cluster_tris", "cluster_min", "cluster_max", "cluster_tri_map",
                  "cluster_start")
# The packed walk of K1-K5 reads one 64-byte record per interior node, and
# the root's rows of four of the planes.
RECORD_BYTES = 64
ROOT_ROW_BYTES = 32


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def _timed_call(fn, log: list, *args, ahead: int = QUEUE_AHEAD_CYCLES):
    """fn(*args) between two CUDA events, appended to log as (start, stop).
    A busy-wait of `ahead` cycles (0: none) is queued ahead of the start
    event, so that the card reaches the start event only after the host has
    queued the launch behind it: the pair spans the launch's device time,
    with no host gap in it."""
    import torch

    if ahead:
        torch.cuda._sleep(ahead)
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn(*args)
    stop.record()
    log.append((start, stop))
    return out


def _time_ms(fn, reps: int) -> float:
    """Mean device time of fn() over reps launches, after one warm-up: one
    event pair around each launch, averaged. The launches run back to back
    behind one busy-wait long enough for the host to queue them all, so no
    host gap falls inside a pair."""
    import torch

    fn()
    torch.cuda.synchronize()
    pairs = []
    torch.cuda._sleep(QUEUE_AHEAD_CYCLES * reps)
    for _ in range(reps):
        _timed_call(fn, pairs, ahead=0)
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / reps


def _kernel_times_by_width(field: str, dispatch) -> tuple[dict, list]:
    """Run dispatch() with the "kernel" engine's `field` path kernel (split:
    K3, segs: K5) behind _timed_call. Returns {lanes: [launches, ms]}, the
    kernel's device time summed over its launches at each lane count, and
    the device time of each launch in launch order."""
    import torch

    from rayfinder_tpu_torch.render import pathtracer as pt

    engine = pt._ENGINES["kernel"]
    kernel = getattr(engine, field)
    log, widths = [], []

    def timed(*args):
        widths.append(int(args[3].shape[0]))  # u: one entry per lane
        return _timed_call(kernel, log, *args)

    pt._ENGINES["kernel"] = engine._replace(**{field: timed})
    try:
        dispatch()
    finally:
        pt._ENGINES["kernel"] = engine
    torch.cuda.synchronize()
    by_width, launch_ms = {}, [start.elapsed_time(stop) for start, stop in log]
    for n, ms in zip(widths, launch_ms):
        entry = by_width.setdefault(n, [0, 0.0])
        entry[0] += 1
        entry[1] += ms
    return dict(sorted(by_width.items(), reverse=True)), launch_ms


def _ptxas(log: str) -> dict:
    """Registers, stack frame and spills of each kernel in nvcc's -Xptxas -v
    output: {kernel<template args>: {registers, stack, spill_stores,
    spill_loads}} (bytes)."""
    kernels, entry, props = {}, None, None
    for line in log.splitlines():
        if m := re.search(r"Compiling entry function '(\w+)'", line):
            entry = m.group(1)
        elif m := re.search(r"Function properties for (\w+)", line):
            props = m.group(1)
        elif (m := re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                             r"(\d+) bytes spill loads", line)) and props == entry:
            kernels.setdefault(entry, {}).update(
                stack=int(m.group(1)), spill_stores=int(m.group(2)), spill_loads=int(m.group(3)))
        elif (m := re.search(r"Used (\d+) registers", line)) and entry:
            kernels.setdefault(entry, {})["registers"] = int(m.group(1))

    def readable(mangled: str) -> str:
        name = re.search(r"[a-z_]+_kernel", mangled).group(0)
        args = re.match(r"I((?:L[a-z]\d+E)+)E", mangled[mangled.index(name) + len(name):])
        if args is None:
            return name
        return name + "<" + ",".join(re.findall(r"L[a-z](\d+)E", args.group(1))) + ">"

    return {readable(k): v for k, v in kernels.items()}


def _rays(camera, n_camera: int, n_random: int, seed: int, dev):
    """Camera rays through a jittered 512-wide pixel grid plus random rays
    from inside the courtyard, all unit length."""
    import numpy as np
    import torch

    from rayfinder_tpu_torch.render.camera import primary_ray

    rng = np.random.default_rng(seed)
    w = 512
    h = n_camera // w
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    u = torch.from_numpy(((xs.reshape(-1) + 0.5) / w).astype(np.float32)).to(dev)
    v = torch.from_numpy(((ys.reshape(-1) + 0.5) / h).astype(np.float32)).to(dev)
    noise = torch.from_numpy(rng.uniform(size=(n_camera, 2)).astype(np.float32)).to(dev)
    co, cd = primary_ray(camera, u, v, noise, (1.0 / w, 1.0 / h))
    lo = np.asarray([-19.5, 0.2, -9.5], np.float32)
    hi = np.asarray([19.5, 11.5, 9.5], np.float32)
    ro = (lo + (hi - lo) * rng.uniform(size=(n_random, 3))).astype(np.float32)
    rd = rng.normal(size=(n_random, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    o = torch.cat([co, torch.from_numpy(ro).to(dev)]).contiguous()
    d = torch.cat([cd, torch.from_numpy(rd).to(dev)]).contiguous()
    return o, d


def _check_walks(scene, o, d, label: str) -> dict:
    """K1/K2 against their plain versions on the same card, exactly."""
    import torch

    from rayfinder_tpu_torch.ops.walk import (
        intersect_any_kernel, intersect_any_reference,
        intersect_closest_kernel, intersect_closest_reference,
    )
    from rayfinder_tpu_torch.render.intersect import T_MAX

    _, t, tri, visits = intersect_closest_kernel(scene, o, d, T_MAX)
    occ = intersect_any_kernel(scene, o, d, T_MAX)
    torch.cuda.synchronize()
    _, pt, ptri, pvisits = intersect_closest_reference(scene, o, d, T_MAX)
    pocc = intersect_any_reference(scene, o, d, T_MAX)
    n = o.shape[0]
    same = dict(
        t=int((t == pt).sum()), tri=int((tri == ptri).sum()),
        visits=int((visits == pvisits).sum()), occ=int((occ == pocc).sum()),
    )
    print(f"{label}: {n} rays, kernel == plain: {same}", flush=True)
    _require(all(v == n for v in same.values()), f"{label}: K1/K2 differ from the plain walk")
    return dict(t=t, tri=tri, visits=visits, occ=occ,
                t_err=float((t - pt).abs().max()) if n else 0.0,
                occ_err=float((occ != pocc).float().max()) if n else 0.0)


def _image(accum, w: int, h: int, spp: int):
    from rayfinder_tpu_torch.render.tiling import unswizzle
    from rayfinder_tpu_torch.render.tonemap import tonemap

    return tonemap(unswizzle(accum, w, h) / float(spp), 0.25).reshape(h, w, 3).cpu().numpy()


def _rmse(a, b) -> float:
    import numpy as np

    return float(np.sqrt(np.mean((np.asarray(a, np.float64) - b) ** 2)))


def _render_routes(scene, sky, tile, dev, label: str, golden, routes) -> dict:
    """Render the 128x96, 8 spp, 4-bounce courtyard through each route
    (name -> accumulate_samples_regen keywords); hold the images to each
    other (RMSE < 1e-3) and to the JAX golden (RMSE < 5e-3), and their ray
    counts to each other (0.1%: the kernels' sin, cos and pow differ from
    torch's in the last place, so a plain run may scatter a ray elsewhere;
    the kernel routes must count the same rays exactly)."""
    import numpy as np
    import torch

    from rayfinder_tpu_torch.render.camera import create_camera
    from rayfinder_tpu_torch.render.pathtracer import accumulate_samples_regen

    w, h, spp = 128, 96, 8
    cam = create_camera(*CAMERA, w / h)
    images, counts = {}, {}
    for name, kw in routes.items():
        t0 = time.perf_counter()
        out = accumulate_samples_regen(
            scene, sky, cam, tile, 0, torch.zeros(w * h, 3, device=dev), width=w, height=h,
            num_bounces=4, spp=spp, num_frames=spp, **kw)
        accum, rays = out if isinstance(out, tuple) else (out, None)
        images[name] = _image(accum, w, h, spp)
        if rays is not None:
            counts[name] = rays.cpu().numpy()
        print(f"{label} 128x96 8spp via {name}: {time.perf_counter() - t0:.1f} s, rays "
              f"[closest, shadow] = {counts[name].tolist() if name in counts else 'not counted'}",
              flush=True)
    first = next(iter(images))
    for name, img in images.items():
        rmse_first, rmse_golden = _rmse(img, images[first]), _rmse(img, golden["image"])
        print(f"  {name}: RMSE vs {first} {rmse_first:.3e}, vs golden {rmse_golden:.3e}",
              flush=True)
        _require(rmse_first < 1e-3, f"{label}: {name} and {first} images differ")
        _require(rmse_golden < 5e-3, f"{label}: {name} image differs from the golden")
    base = counts[first]
    for name, c in counts.items():
        dev_c = float(np.max(np.abs(c - base) / base))
        _require(dev_c <= 1e-3, f"{label}: {name} ray counts differ from {first} by > 0.1%")
        if routes[name].get("engine") == "kernel":
            _require(c.tolist() == base.tolist(),
                     f"{label}: the {name} route counts {c.tolist()}, {first} {base.tolist()}")
    print(f"  ray counts of {sorted(counts)} within 0.1%, the kernel routes' equal (golden "
          f"counts {golden['rays'].tolist()})", flush=True)
    return counts


def _hold(label: str, names, k_out, p_out, int_names, card: str) -> float:
    """A kernel's outputs against its plain version's: at least 99.9% of
    lanes with equal integer state, floats on them within rtol 1e-4 / atol
    1e-4. Returns the largest |kernel - plain| on those lanes."""
    import torch

    ints_same = None
    for name, a, b in zip(names, k_out, p_out):
        if name in int_names:
            same = (a == b) if a.dim() == 1 else (a == b).all(dim=1)
            ints_same = same if ints_same is None else ints_same & same
    agree = float(ints_same.float().mean())
    errs = {}
    for name, a, b in zip(names, k_out, p_out):
        if a.dtype.is_floating_point:
            diff = (a - b).abs()[ints_same]
            errs[name] = float(diff.max()) if diff.numel() else 0.0
            ok = torch.isclose(a[ints_same], b[ints_same], rtol=1e-4, atol=1e-4)
            _require(bool(ok.all()), f"{label}: {name} differs beyond rtol 1e-4 / atol 1e-4")
    print(f"  lanes with equal {tuple(int_names)} {agree:.6f}; max |kernel - plain| on "
          f"them {errs} [{card}]", flush=True)
    _require(agree >= 0.999, f"{label}: fewer than 99.9% of lanes agree with the plain version")
    return max(errs.values())


def _equal(label: str, names, k_out, p_out, card: str, other: str = "plain") -> float:
    """A bit-exact kernel's outputs against its plain version's (or
    `other`'s): every output equal on every lane (torch.equal). Returns the
    largest |kernel - other|, which is then 0."""
    import torch

    differ = [name for name, a, b in zip(names, k_out, p_out) if not torch.equal(a, b)]
    print(f"  {label} == {other} on every output {tuple(names)}: {not differ} [{card}]",
          flush=True)
    _require(not differ, f"{label}: {differ} differ from {other}")
    return 0.0


def _timed(fn):
    """(result, seconds) of fn(), fenced by a device sync."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _nbytes(*tensors) -> int:
    """Bytes of the tensors among `tensors` (other arguments are skipped)."""
    import torch

    return sum(t.numel() * t.element_size() for t in tensors if isinstance(t, torch.Tensor))


def _scene_bytes(scene, tables) -> int:
    return _nbytes(*(getattr(scene, name) for name in tables))


def _walk_bytes(scene) -> int:
    """The scene bytes a BVH walk must read, whatever layout a kernel reads
    them in: the triangles at 36 bytes each, and the nodes in the smaller of
    the port's two layouts (the SoA planes, or one record per interior node
    and the root's plane rows). Padding is left out."""
    records = RECORD_BYTES * ((scene.num_nodes - 1) // 2) + ROOT_ROW_BYTES
    return _nbytes(scene.tri_positions) + min(_scene_bytes(scene, NODE_PLANES), records)


def _l2_rate(dev) -> tuple[float, dict]:
    """The rate of data held in the card's L2: the fastest of plain torch
    passes over buffers of L2_PASS_BYTES, a copy (bytes read plus written)
    and a sum (bytes read). Returns (bytes per second, {pass: TB/s})."""
    import torch

    rates = {}
    for nbytes in L2_PASS_BYTES:
        src = torch.zeros(nbytes // 4, dtype=torch.int32, device=dev)
        dst = torch.empty_like(src)
        for name, fn, moved in ((f"copy of {nbytes >> 20} MiB", lambda: dst.copy_(src), 2 * nbytes),
                                (f"sum of {nbytes >> 20} MiB", lambda: src.sum(), nbytes)):
            for _ in range(3):
                fn()
            rates[name] = moved / (_time_ms(fn, 20) * 1e-3) / 1e12
    return max(rates.values()) * 1e12, rates


def _bound(ops: int, nbytes: int, issue=None, loaded: int | None = None) -> dict:
    """The least time the card could take: the larger of the operations at
    the float32 peak and the bytes (each input read once, each output
    written once) at the memory rate. Beside it two closer figures of their
    own names: issue_ms, the issue limit of `issue` = (full-rate, half-rate)
    instructions without FMAs, and, for a walk, l2_ms, the time of the
    `loaded` bytes its rays load one by one at the measured L2 rate."""
    ops_ms = ops / F32_OPS_PER_S * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    out = dict(bound_ms=max(ops_ms, bytes_ms),
               bound_by="operations" if ops_ms >= bytes_ms else "bytes",
               ops=int(ops), bytes=int(nbytes))
    if issue is not None:
        full, half = issue
        out["issue_ms"] = max(full + half, 2 * half) / SLOTS_PER_S * 1e3
    if loaded is not None:
        out["loaded_bytes"] = int(loaded)
        out["l2_ms"] = loaded / L2_RATE["bytes_per_s"] * 1e3
    return out


def _second(bound: dict) -> str:
    """The figures beside a bound, for a printed line."""
    parts = [f"issue limit without FMAs {bound['issue_ms']:.4f} ms"]
    if "l2_ms" in bound:
        parts.append(f"{bound['loaded_bytes']} bytes loaded ray by ray at the L2 rate "
                     f"{bound['l2_ms']:.4f} ms")
    return "; ".join(parts)


def _walk_issue(nodes: int, tests: int) -> tuple[int, int]:
    """(full-rate, half-rate) instructions of walks that visited `nodes`
    nodes and tested `tests` triangles in all."""
    return (nodes * SLAB_TEST_SLOTS[0] + tests * TRIANGLE_TEST_SLOTS[0],
            nodes * SLAB_TEST_SLOTS[1] + tests * TRIANGLE_TEST_SLOTS[1])


def _walk_loaded(rays: int, nodes: int, tests: int) -> int:
    """Bytes that `rays` walks load ray by ray: a record per two nodes
    visited below the root, three rows per triangle test."""
    return (nodes - rays) // 2 * LOADED_RECORD_BYTES + tests * LOADED_TRIANGLE_BYTES


def _walk_ops(work: dict) -> int:
    """Operations of the walks summed by render.traverse.count_work."""
    from rayfinder_tpu_torch.ops.counted import walk_operations

    return sum(walk_operations(w[1], w[3]) for w in work.values())


def _work_second(work: dict) -> dict:
    """The `issue` and `loaded` arguments of _bound for the walks summed by
    render.traverse.count_work."""
    issues = [_walk_issue(w[1], w[3]) for w in work.values()]
    return dict(issue=(sum(i[0] for i in issues), sum(i[1] for i in issues)),
                loaded=sum(_walk_loaded(w[0], w[1], w[3]) for w in work.values()))


def _plain_work(fn):
    """(result, seconds) of one plain call of fn, and the walks' work
    (render.traverse.count_work) of a second call."""
    from rayfinder_tpu_torch.render.traverse import count_work

    out, secs = _timed(fn)
    with count_work() as work:
        fn()
    return out, secs, work


def _kernel_entry(name, src, replaces, launches, err, ms, plain_ms, bound, path) -> dict:
    return {"name": name, "route": "cuda", "source": f"rayfinder_tpu_torch/csrc/{src}",
            "replaces": replaces, "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "issue_ms": None, "l2_ms": None, **bound, "library_ms": None,
            "path": path}


def _efficiency(dev, card: str) -> tuple[list, dict, object]:
    """Phase 7: K6 and K7 on the bench's traversal-efficiency path. Returns
    (kernel entries, efficiency fields, the .pt-loaded scene)."""
    import torch

    from rayfinder_tpu_torch.ops.counted import (
        intersect_closest_counted, intersect_closest_counted_reference,
    )
    from rayfinder_tpu_torch.ops.slab import slab_entry_reduce, slab_entry_reduce_reference
    from rayfinder_tpu_torch.ops.walk import intersect_closest_kernel
    from rayfinder_tpu_torch.prof import diag_iters
    from rayfinder_tpu_torch.prof.scenes import BENCH_CAMERA, courtyard_pt_scene
    from rayfinder_tpu_torch.render.camera import create_camera
    from rayfinder_tpu_torch.render.intersect import T_MAX

    scene, info = courtyard_pt_scene(26, device=dev)
    print(f"courtyard_scene(26) via GLB -> .pt -> scene: {scene.num_triangles} triangles, "
          f"{info['bytes']} bytes, prepared in {info['prepare_s']:.1f} s, loaded in "
          f"{info['load_s']:.1f} s", flush=True)
    camera = create_camera(*BENCH_CAMERA, 1.0)
    tri_cluster = diag_iters.scene_tri_clusters(scene)
    box_min, box_max, count, _ = boxes = diag_iters.leaf_boxes(scene)
    m = box_min.shape[0]

    # The path: K6 and K7 on the three populations, counts read just after.
    intersect_closest_counted.launches = 0
    slab_entry_reduce.launches = 0
    results, secs = _timed(lambda: dict(diag_iters.populations(scene, camera, 512, 512,
                                                                 tri_cluster)))
    launches = (intersect_closest_counted.launches, slab_entry_reduce.launches)
    print(f"efficiency path: {secs:.1f} s, K6 launches {launches[0]}, K7 launches "
          f"{launches[1]}, {m} leaves", flush=True)
    _require(min(launches) > 0, "the efficiency path did not launch K6 and K7")
    fields = diag_iters.efficiency_fields(results)
    for name, r in results.items():
        print("  " + diag_iters.report(name, r), flush=True)

    k7_err = 0.0
    for name, r in results.items():
        o, d, counts = r["o"], r["d"], r["counts"]
        n = o.shape[0]
        _, pt, ptri, pcounts = intersect_closest_counted_reference(scene, o, d, T_MAX)
        _, kt, ktri, kvisits = intersect_closest_kernel(scene, o, d, T_MAX)
        same = dict(t=int((r["t"] == pt).sum()), tri=int((r["tri"] == ptri).sum()),
                    counts=int((counts == pcounts).all(1).sum()),
                    k1_t=int((r["t"] == kt).sum()), k1_tri=int((r["tri"] == ktri).sum()),
                    k1_nodes=int((counts[:, 0] == kvisits).sum()))
        print(f"  {name}: {n} rays, K6 == plain and K1: {same}", flush=True)
        _require(all(v == n for v in same.values()), f"{name}: K6 differs from plain or K1")
        _require(r["need_over_tests"].size == 0,
                 f"{name}: need > triangle tests on rays {r['need_over_tests'][:20].tolist()}")
        s = slice(0, 4096)
        args = (box_min, box_max, count, o[s], (1.0 / d[s]).contiguous(), r["bound"][s],
                diag_iters.GROUP, True)
        got, want = slab_entry_reduce(*args), slab_entry_reduce_reference(*args)
        _require(all(torch.equal(a, b) for a, b in zip(got, want)),
                 f"{name}: K7 differs from its plain version")
        diff = (got[1] - want[1])[torch.isfinite(want[1])].abs()
        k7_err = max(k7_err, float(diff.max()) if diff.numel() else 0.0)
        print(f"  {name}: K7 == plain on {got[0].shape[0]} rays x {m} leaves (need, "
              f"{want[1].shape[0]} group minima, selection); need <= tests on every ray",
              flush=True)
    print("efficiency: " + ", ".join(
        f"{k} {v:.3f}" for k, v in fields.items() if k.startswith("mt_waste")) + f" [{card}]",
        flush=True)

    # Times and bounds at the primary population's shape.
    prim = results["primary"]
    o, d = prim["o"], prim["d"]
    entries = [_k6_entry(scene, o, d, prim["counts"], launches[0], card),
               _k7_entry(boxes, o, d, prim["bound"], launches[1], k7_err, card)]
    fields = {k: v for k, v in fields.items() if not k.startswith("need_over_tests")}
    fields["rays"] = {name: int(r["o"].shape[0]) for name, r in results.items()}
    fields["pt_path"] = info["path"]
    return entries, fields, scene


def _k6_entry(scene, o, d, counts, launches: int, card: str) -> dict:
    """K6's time, plain time and bound on the rays (o, d), whose counted
    work is `counts`, and K1's time on the same rays beside it (K6 is K1's
    kernel with two more counters)."""
    import torch

    from rayfinder_tpu_torch.ops.counted import (
        intersect_closest_counted, intersect_closest_counted_reference, walk_operations,
    )
    from rayfinder_tpu_torch.ops.walk import intersect_closest_kernel
    from rayfinder_tpu_torch.render.intersect import T_MAX

    n = o.shape[0]
    t_dev = torch.full((n,), T_MAX, device=o.device)  # no host copy inside the timing
    k6_ms = _time_ms(lambda: intersect_closest_counted(scene, o, d, t_dev), 20)
    k1_ms = _time_ms(lambda: intersect_closest_kernel(scene, o, d, t_dev), 20)
    _, k6_plain = _timed(lambda: intersect_closest_counted_reference(scene, o, d, T_MAX))
    c = counts.sum(0, dtype=torch.int64).tolist()
    k6_bound = _bound(walk_operations(c[0], c[2]), _nbytes(o, d, counts) + 12 * n
                      + _walk_bytes(scene), issue=_walk_issue(c[0], c[2]),
                      loaded=_walk_loaded(n, c[0], c[2]))
    print(f"K6 counted walk: {k6_ms:.4f} ms, K1 on the same rays {k1_ms:.4f} ms (plain "
          f"{k6_plain * 1e3:.1f} ms), bound {k6_bound['bound_ms']:.4f} ms "
          f"({k6_bound['bound_by']}), {_second(k6_bound)} at {n} rays [{card}]", flush=True)
    entry = _kernel_entry("intersect_closest_counted", "walk.cu", "prof/diag_iters.py:221",
                          launches, 0.0, k6_ms, k6_plain * 1e3, k6_bound, "phase 7 efficiency")
    entry["k1_ms_same_rays"] = k1_ms
    return entry


def _k6_on_built_scene(scene, camera, dev, card: str) -> dict:
    """--kernel-times: K6 and K1 on phase 7's primary rays without the .pt
    asset path (the built courtyard's 512x512 primaries), K6 held to its
    plain version and to K1 on every ray."""
    import torch

    from rayfinder_tpu_torch.ops.counted import (
        intersect_closest_counted, intersect_closest_counted_reference,
    )
    from rayfinder_tpu_torch.ops.walk import intersect_closest_kernel
    from rayfinder_tpu_torch.prof import diag_iters
    from rayfinder_tpu_torch.render.intersect import T_MAX

    o, d = diag_iters.primary_rays(camera, SLICE["width"], SLICE["height"], dev)
    _, t, tri, counts = intersect_closest_counted(scene, o, d, T_MAX)
    _, pt, ptri, pcounts = intersect_closest_counted_reference(scene, o, d, T_MAX)
    _, kt, ktri, kvisits = intersect_closest_kernel(scene, o, d, T_MAX)
    _require(torch.equal(t, pt) and torch.equal(tri, ptri) and torch.equal(counts, pcounts),
             "K6 differs from its plain version on the primary rays")
    _require(torch.equal(t, kt) and torch.equal(tri, ktri) and torch.equal(counts[:, 0], kvisits),
             "K6 differs from K1 on the primary rays")
    return _k6_entry(scene, o, d, counts, 0, card)


def _k7_entry(boxes, o, d, bound, launches: int, err: float, card: str) -> dict:
    """K7's time, plain time and bound at phase 7's shape: the rays (o, d)
    with their bounds against all the leaf boxes."""
    from rayfinder_tpu_torch.ops.slab import (
        PAIR_OPS, slab_entry_reduce, slab_entry_reduce_reference,
    )
    from rayfinder_tpu_torch.prof import diag_iters

    box_min, box_max, count, _ = boxes
    n, m = o.shape[0], box_min.shape[0]
    inv = (1.0 / d).contiguous()
    args = (box_min, box_max, count, o, inv, bound, diag_iters.GROUP)
    k7_ms = _time_ms(lambda: slab_entry_reduce(*args), 3)
    _, k7_plain = _timed(lambda: slab_entry_reduce_reference(*args))
    k7_bound = _bound(PAIR_OPS * n * m, _nbytes(box_min, box_max, count, o, inv, bound)
                      + 8 * n, issue=(PAIR_SLOTS[0] * n * m, PAIR_SLOTS[1] * n * m))
    print(f"K7 slab entry: {k7_ms:.3f} ms (plain {k7_plain * 1e3:.1f} ms), bound "
          f"{k7_bound['bound_ms']:.4f} ms ({k7_bound['bound_by']}), {_second(k7_bound)}, at {n} "
          f"rays x {m} leaves [{card}]", flush=True)
    return _kernel_entry("slab_entry_reduce", "slab_entry.cu", "prof/probe_prebuilt.py:28",
                         launches, err, k7_ms, k7_plain * 1e3, k7_bound, "phase 7 efficiency")


def _k7_on_built_scene(scene, camera, dev, card: str) -> dict:
    """--kernel-times: K7 at phase 7's shape without the .pt asset path: the
    built courtyard's leaves and its 512x512 primary rays, bounded by K1's
    hits; held to plain on 4,096 of them."""
    import torch

    from rayfinder_tpu_torch.ops.slab import slab_entry_reduce, slab_entry_reduce_reference
    from rayfinder_tpu_torch.ops.walk import intersect_closest_kernel
    from rayfinder_tpu_torch.prof import diag_iters
    from rayfinder_tpu_torch.render.intersect import T_MAX

    boxes = diag_iters.leaf_boxes(scene)
    o, d = diag_iters.primary_rays(camera, SLICE["width"], SLICE["height"], dev)
    _, t, _, _ = intersect_closest_kernel(scene, o, d, T_MAX)
    s = slice(100_000, 104_096)
    args = (*boxes[:3], o[s].contiguous(), (1.0 / d[s]).contiguous(), t[s].contiguous(),
            diag_iters.GROUP, True)
    _require(all(torch.equal(a, b) for a, b in zip(slab_entry_reduce(*args),
                                                   slab_entry_reduce_reference(*args))),
             "K7 differs from its plain version")
    return _k7_entry(boxes, o, d, t, 0, 0.0, card)


def _probes(dev, card: str, scene) -> tuple[dict, dict]:
    """Phase 8: K7 at the TPU probe's shapes; K8 in each mode and for each
    camera against its plain version, then timed. Returns (the K8 kernel
    entry, the probe numbers)."""
    import torch

    from rayfinder_tpu_torch.ops.counted import intersect_closest_counted, walk_operations
    from rayfinder_tpu_torch.ops.skyround import (
        MODES, REGEN_OPS, SKY_OPS, sky_round, sky_round_reference,
    )
    from rayfinder_tpu_torch.ops.slab import slab_entry_reduce, slab_entry_reduce_reference
    from rayfinder_tpu_torch.prof import probe_prebuilt, prof_skyround

    numbers = {}
    args = probe_prebuilt.probe_inputs(24, dev)
    got = slab_entry_reduce(*args, probe_prebuilt.G, True)
    want = slab_entry_reduce_reference(*args, probe_prebuilt.G, True)
    _require(all(torch.equal(a, b) for a, b in zip(got, want)),
             "K7 differs from its plain version at the probe's shape")
    numbers["k7_probe"] = probe_prebuilt.run_probe(24, dev, 200)
    p = numbers["k7_probe"]
    print(f"K7 at the probe's shape (24 x 128 boxes x 128 rays) == plain; with group minima "
          f"{p['with_group_min_ms'] * 1e3:.3f} us, need + selection "
          f"{p['need_and_first_ms'] * 1e3:.3f} us [{card}]", flush=True)

    rounds = prof_skyround.ROUNDS
    launches, err, times = 0, 0.0, {}
    for camera in prof_skyround.CAMERAS:
        pargs = prof_skyround.probe_args(scene, dev, camera)
        n = pargs[3].shape[0]
        hits = float(prof_skyround.first_ray_hits(pargs).float().mean())
        for mode in MODES:
            sky_round.launches = 0
            acc = sky_round(*pargs, 4, mode)
            launches += sky_round.launches
            _require(sky_round.launches == 1, f"K8 {mode} did not launch")
            ref = sky_round_reference(*pargs, 4, mode)
            diff = float((acc - ref).abs().max())
            err = max(err, diff)
            _require(bool(torch.allclose(acc, ref, rtol=1e-5, atol=1e-5)),
                     f"K8 {camera} {mode}: kernel and plain differ beyond rtol 1e-5")
            times[f"{camera}_{mode}"] = ms = _time_ms(
                lambda: sky_round(*pargs, rounds, mode), 3)
            print(f"K8 {camera} camera ({hits:.4f} of first rays hit), {mode:9s}: max |kernel - "
                  f"plain| at 4 rounds {diff:.3e}; {ms:.3f} ms at {n} lanes x {rounds} rounds, "
                  f"{ms * 1e6 / (n * rounds):.3f} ns/lane-round [{card}]", flush=True)
        numbers[f"hit_fraction_{camera}"] = hits
    numbers["k8_ms"] = times

    # The K8 entry: "full" with the Duck probe's camera at 64 rounds. Its
    # walks' work is K6's count over the rays of every round.
    pargs = prof_skyround.probe_args(scene, dev, "duck")
    n = pargs[3].shape[0]
    ref, plain_s = _timed(lambda: sky_round_reference(*pargs, rounds, "full"))
    acc = sky_round(*pargs, rounds, "full")
    diff = float((acc - ref).abs().max())
    err = max(err, diff)
    _require(bool(torch.allclose(acc, ref, rtol=1e-5, atol=1e-5)),
             f"K8 duck full at {rounds} rounds: kernel and plain differ beyond rtol 1e-5")
    nodes = tests = 0
    for r in range(rounds):
        c = intersect_closest_counted(scene, *prof_skyround.sample_rays(pargs, r),
                                      prof_skyround.T_MAX)[3].sum(0, dtype=torch.int64)
        nodes, tests = nodes + int(c[0]), tests + int(c[2])
    # (The sky's and the primary's operations are taken at the full rate.)
    full, half = _walk_issue(nodes, tests)
    bound = _bound(walk_operations(nodes, tests) + n * rounds * (SKY_OPS + REGEN_OPS),
                   _nbytes(*pargs[3:6]) + 4 * n + _walk_bytes(scene),
                   issue=(full + n * rounds * (SKY_OPS + REGEN_OPS), half),
                   loaded=_walk_loaded(n * rounds, nodes, tests))
    print(f"K8 full, duck camera, {rounds} rounds: max |kernel - plain| {diff:.3e}; plain "
          f"{plain_s * 1e3:.1f} ms, bound "
          f"{bound['bound_ms']:.4f} ms ({bound['bound_by']}), {_second(bound)} [{card}]",
          flush=True)
    entry = _kernel_entry("sky_round", "skyround.cu", "prof/prof_skyround.py:147", launches,
                          err, times["duck_full"], plain_s * 1e3, bound, "phase 8 probes")
    return entry, numbers


def _slice_dispatch(scene, camera, sky, tile, dev):
    """The slice's lanes in block order ({u, v_tex, noise_base}) and the
    dispatch of its first 16 samples through the "kernel" engine."""
    import numpy as np
    import torch

    from rayfinder_tpu_torch.render import pathtracer as pt
    from rayfinder_tpu_torch.render.tiling import block_order

    w, h = SLICE["width"], SLICE["height"]
    ys_np, xs_np, _ = block_order(w, h)
    ys, xs = torch.from_numpy(ys_np).to(dev), torch.from_numpy(xs_np).to(dev)
    lanes = dict(u=(xs.float() + 0.5) / float(w), v_tex=(ys.float() + 0.5) / float(h),
                 noise_base=tile[(ys % 128).long(), (xs % 128).long()].contiguous())
    disp = pt._Dispatch(
        scene=scene, sky=sky, camera=camera, kernels=pt._ENGINES["kernel"],
        inv_dims=(float(np.float32(1) / np.float32(w)), float(np.float32(1) / np.float32(h))),
        frame_base=0, spp=SLICE["spp"], nf=SLICE["num_frames"], num_bounces=SLICE["num_bounces"],
        sun_dir=torch.as_tensor(sky.sun_direction, device=dev),
        solar=torch.as_tensor(sky.solar_radiances, device=dev),
    )
    return lanes, disp


def _k3_args(scene, camera, sky, tile, dev) -> tuple:
    """K3's arguments at phase 6's shape: all 262,144 lanes after one kernel
    call and one shade step (NEE pending, scatter continuations and fresh
    primaries mixed). Also returns the lanes' flags."""
    import torch

    from rayfinder_tpu_torch.ops.regen import trace_regen
    from rayfinder_tpu_torch.render.intersect import T_MAX
    lanes, disp = _slice_dispatch(scene, camera, sky, tile, dev)
    n = lanes["u"].shape[0]
    sample = torch.zeros(n, dtype=torch.int32, device=dev)
    o0, d0 = disp.primary(lanes, sample)
    z3 = torch.zeros(n, 3, device=dev)
    pix = disp.pixel_args(lanes)
    out = trace_regen(
        *pix, T_MAX, sample, torch.ones_like(sample), torch.zeros_like(sample), o0, d0,
        torch.ones(n, 3, device=dev), z3, z3, torch.full((n, 3), 1e30, device=dev),
        torch.tensor([1.0, 0.0, 0.0], device=dev).expand(n, 3).contiguous(), z3,
    )
    sample1, bounce1, org1, dir1, thr1, srad1, lrad1, _t1, tri1 = out
    flag2, org2, dir2, thr2, bounce2, sho2, shd2, con2 = disp.shade(
        lanes["noise_base"], sample1, org1, dir1, tri1, thr1, bounce1)
    return (*pix, T_MAX, sample1, bounce2, flag2, org2, dir2, thr2, srad1, lrad1, sho2, shd2,
            con2), flag2


def _k5_args(scene, camera, sky, tile, dev) -> tuple:
    """K5's arguments (K = 2) at phase 6's shape: all 262,144 lanes after
    one iteration of the segs route. Also returns the slots' flags."""
    import torch

    from rayfinder_tpu_torch.render import pathtracer as pt
    from rayfinder_tpu_torch.render.intersect import T_MAX

    lanes, disp = _slice_dispatch(scene, camera, sky, tile, dev)
    n = lanes["u"].shape[0]
    st = pt._initial_slots(disp, lanes, n, 2, dev)
    lrad1, flags = disp.segs_step(st, lanes, torch.zeros(n, 3, device=dev))
    return (*disp.pixel_args(lanes), T_MAX, st["salloc"], lrad1, st["cnt"], st["ray"],
            st["thr"], st["nee"]), flags


def _k4_args(scene, camera, sky, tile, dev) -> tuple:
    """K4's arguments at phase 6's shape: the compacted lanes of the
    in-kernel route's first shaded phase, with that phase's per-tile floor.
    Also returns the phase's lane count and floor, and the initial state."""
    import torch

    from rayfinder_tpu_torch.render import pathtracer as pt
    from rayfinder_tpu_torch.render.intersect import T_MAX

    lanes, disp = _slice_dispatch(scene, camera, sky, tile, dev)
    n = lanes["u"].shape[0]
    sizes = pt._phase_sizes(n, pt._COMPACT_FLOOR)
    st = pt._initial_state(disp, lanes, n, dev)
    _, _, lrad0 = pt._split_phase0(disp, st, lanes, torch.zeros(n, 3, device=dev), sizes[1])
    floor = pt._tile_floor(sizes[1], sizes[2])
    args = (*disp.pixel_args(lanes), disp.num_bounces, floor, T_MAX, st["sample"], st["bounce"],
            st["flag"], st["origin"], st["direction"], st["thr"], st["srad"], lrad0,
            st["shadow_o"], st["shadow_d"], st["contrib"])
    return args, sizes[1], floor, st


def _k4_full_args(scene, camera, sky, tile, dev) -> tuple:
    """K4's arguments at the one-call route's shape: all 262,144 lanes from
    their initial state, floor 0."""
    import torch

    from rayfinder_tpu_torch.render import pathtracer as pt
    from rayfinder_tpu_torch.render.intersect import T_MAX

    lanes, disp = _slice_dispatch(scene, camera, sky, tile, dev)
    n = lanes["u"].shape[0]
    st = pt._initial_state(disp, lanes, n, dev)
    return (*disp.pixel_args(lanes), disp.num_bounces, 0, T_MAX, st["sample"], st["bounce"],
            st["flag"], st["origin"], st["direction"], st["thr"], st["srad"],
            torch.zeros(n, 3, device=dev), st["shadow_o"], st["shadow_d"], st["contrib"])


def _dispatch_kernel_times(scene, sky, camera, tile, dev, card: str) -> dict:
    """One instrumented dispatch of samples 16-31 per route, after a warm-up
    dispatch of samples 0-15: K3 on the split route, K5 on the segs=2 route,
    K4 on the in-kernel route (the hybrid, and in one call per dispatch),
    each launch's device time grouped by its lane count, and in launch order
    (_kernel_times_by_width)."""
    import torch

    from rayfinder_tpu_torch.render.pathtracer import accumulate_samples_regen

    w, h, nf = SLICE["width"], SLICE["height"], SLICE["num_frames"]
    kw = dict(width=w, height=h, num_bounces=SLICE["num_bounces"], spp=SLICE["spp"],
              num_frames=nf, engine="kernel")
    zeros = torch.zeros(w * h, 3, device=dev)
    times = {}
    kernel_of = {"split": "K3", "segs": "K5", "shaded": "K4"}
    # Every route by explicit keywords, which a tree from before the default
    # changed takes too.
    for name, field, route in (
            ("split", "split", dict(inkernel=False)), ("segs2", "segs", dict(segs=2)),
            ("inkernel", "shaded", dict(inkernel=True, compact_floor=4096)),
            ("inkernel_one_call", "shaded", dict(inkernel=True, compact_floor=w * h))):
        warm = accumulate_samples_regen(scene, sky, camera, tile, 0, zeros, **route, **kw)
        by_width, launch_ms = _kernel_times_by_width(field, lambda: accumulate_samples_regen(
            scene, sky, camera, tile, nf, warm, **route, **kw))
        times[name] = by_width
        times[f"{name}_launch_ms"] = launch_ms
        print(f"{kernel_of[field]} per dispatch on the {name} route: "
              f"{sum(launch_ms):.3f} ms over {len(launch_ms)} launches; by lane count [launches, "
              f"ms] {json.dumps(by_width)}; first launch {launch_ms[0]:.4f} ms, the five longest "
              f"{[round(ms, 4) for ms in sorted(launch_ms)[-5:]]} [{card}]", flush=True)
    return times


def _sass(library) -> dict:
    """{kernel: (SASS instructions, digest of the code)} of the built
    library, from cuobjdump -sass (empty where cuobjdump is missing), with
    addresses and encodings stripped: equal digests mean equal code."""
    import hashlib
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not pathlib.Path(tool).exists():
        return {}
    out = subprocess.run([tool, "-sass", str(library)], capture_output=True, text=True,
                         timeout=300).stdout
    code = {}
    for part in out.split("Function : ")[1:]:
        name = re.search(r"[a-z_]+_kernel(?:I(?:L[a-z]\d+E)+E)?", part.split("\n", 1)[0])
        lines = [re.sub(r"/\*[^*]*\*/", "", line).strip() for line in part.splitlines()[1:]]
        lines = [line for line in lines if line and not line.startswith(".")]
        if name:
            key = re.sub(r"I((?:L[a-z]\d+E)+)E", lambda m: "<" + ",".join(
                re.findall(r"L[a-z](\d+)E", m.group(1))) + ">", name.group(0))
            code[key] = (len(lines), hashlib.sha256("\n".join(lines).encode()).hexdigest()[:12])
    return code


def _build_report() -> dict:
    """Build the kernels and print the build time and each kernel's
    registers, stack frame, spills and SASS digest."""
    from rayfinder_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.library()
    print(f"build: {time.perf_counter() - t0:.1f} s -> {_build.library_path().name}", flush=True)
    regs = _ptxas(_build.build_log_path().read_text())
    for name, (count, digest) in _sass(_build.library_path()).items():
        regs.setdefault(name, {}).update(sass_instructions=count, sass_digest=digest)
    for name, r in regs.items():
        print(f"  ptxas {name}: {r.get('registers')} registers, {r.get('stack')} bytes stack "
              f"frame, spill stores {r.get('spill_stores')} loads {r.get('spill_loads')} bytes; "
              f"SASS {r.get('sass_instructions')} instructions, digest {r.get('sass_digest')}")
    return regs


def _ray_queries(scene26, camera, dev, card: str) -> list:
    """Phase 2 on the big courtyard: K1 and K2 through their wrappers on
    262,144 camera and random rays (launch counts read just after), held to
    the plain walks; K6 == K1 on the same rays; times and bounds. Returns
    the K1 and K2 kernel entries."""
    import torch

    from rayfinder_tpu_torch.ops.counted import intersect_closest_counted, walk_operations
    from rayfinder_tpu_torch.ops.walk import (
        intersect_any_kernel, intersect_any_reference,
        intersect_closest_kernel, intersect_closest_reference,
    )
    from rayfinder_tpu_torch.render.intersect import T_MAX
    from rayfinder_tpu_torch.render.traverse import count_work, intersect_any

    o, d = _rays(camera, 131072, 131072, seed=0, dev=dev)
    intersect_closest_kernel.launches = intersect_any_kernel.launches = 0
    walk = _check_walks(scene26, o, d, "courtyard26 camera+random")
    launches = intersect_closest_kernel.launches, intersect_any_kernel.launches
    print(f"  hit fraction {float((walk['tri'] >= 0).float().mean()):.4f}, "
          f"occluded fraction {float(walk['occ'].float().mean()):.4f}")
    # K1's work is K6's count on the same rays (K6 == K1 on t, tri, nodes);
    # K2's is the plain any-hit walk's count.
    _, t6, tri6, counts6 = intersect_closest_counted(scene26, o, d, T_MAX)
    _require(torch.equal(t6, walk["t"]) and torch.equal(tri6, walk["tri"])
             and torch.equal(counts6[:, 0], walk["visits"]), "K6 differs from K1")
    c = counts6.sum(0, dtype=torch.int64).tolist()
    n_rays = o.shape[0]
    ray_bytes = _nbytes(o, d) + 4 * n_rays + _walk_bytes(scene26)
    k1_bound = _bound(walk_operations(c[0], c[2]), ray_bytes + 12 * n_rays,
                      issue=_walk_issue(c[0], c[2]), loaded=_walk_loaded(n_rays, c[0], c[2]))
    # ... counted by the plane walk, which K2 must also equal.
    with count_work() as work:
        plane_occ = intersect_any(scene26, o, d, T_MAX)
    _require(torch.equal(plane_occ, walk["occ"]), "K2 differs from the plane walk")
    k2_bound = _bound(_walk_ops(work), ray_bytes + n_rays, **_work_second(work))
    # Timed with t_max already on the card: given a float, the wrappers copy
    # it from the host, which waits for the stream and puts a host gap
    # inside each event pair.
    t_dev = torch.full((n_rays,), T_MAX, device=dev)
    k1_ms = _time_ms(lambda: intersect_closest_kernel(scene26, o, d, t_dev), 20)
    k1_plain = _time_ms(lambda: intersect_closest_reference(scene26, o, d, T_MAX), 2)
    k2_ms = _time_ms(lambda: intersect_any_kernel(scene26, o, d, t_dev), 20)
    k2_plain = _time_ms(lambda: intersect_any_reference(scene26, o, d, T_MAX), 2)
    print(f"K1 closest: {k1_ms:.4f} ms (plain {k1_plain:.1f} ms, bound "
          f"{k1_bound['bound_ms']:.4f} ms, {k1_bound['bound_by']}, {_second(k1_bound)}); K2 any: "
          f"{k2_ms:.4f} ms (plain {k2_plain:.1f} ms, bound {k2_bound['bound_ms']:.4f} ms, "
          f"{k2_bound['bound_by']}, {_second(k2_bound)}) at {n_rays} rays; K6 == K1 and the "
          f"plane walk == K2 on them; nodes/ray {c[0] / n_rays:.2f}, triangle tests/ray "
          f"{c[2] / n_rays:.2f} [{card}]", flush=True)
    walk_path = "phase 2 ray queries"
    return [
        _kernel_entry("intersect_closest", "walk.cu", "rayfinder_tpu/ops/pallas_walk.py:2034",
                      launches[0], walk["t_err"], k1_ms, k1_plain, k1_bound, walk_path),
        _kernel_entry("intersect_any", "walk.cu", "rayfinder_tpu/ops/pallas_walk.py:2051",
                      launches[1], walk["occ_err"], k2_ms, k2_plain, k2_bound, walk_path),
    ]


def _path_kernels(scene26, camera, sky, tile, dev, card: str, launches: dict) -> list:
    """Phase 6: each path kernel against its plain version at the slice's
    shapes, with the walks' work of each call; K3 and K5 equal theirs on
    every output; K4 at two shapes. Returns the K3, K4 (two) and K5 kernel
    entries; `launches` holds each one's launches on the run that drives
    it."""
    import torch

    from rayfinder_tpu_torch.ops.regen import trace_regen, trace_regen_reference
    from rayfinder_tpu_torch.ops.regen_segs import trace_regen_segs, trace_regen_segs_reference
    from rayfinder_tpu_torch.ops.regen_shaded import (
        trace_regen_shaded, trace_regen_shaded_reference,
    )
    from rayfinder_tpu_torch.render.traverse import count_work

    n, nf = SLICE["width"] * SLICE["height"], SLICE["num_frames"]
    regen = "rayfinder_tpu/ops/pallas_regen.py"

    # K3: all lanes after one kernel call and one shade step.
    args, flag2 = _k3_args(scene26, camera, sky, tile, dev)
    k_out = trace_regen(*args)
    p_out, k3_plain, work = _plain_work(lambda: trace_regen_reference(*args))
    k3_bound = _bound(_walk_ops(work), _nbytes(*args, *k_out) + _walk_bytes(scene26),
                      **_work_second(work))
    k3_ms = _time_ms(lambda: trace_regen(*args), 10)
    print(f"K3 trace_regen: {k3_ms:.4f} ms (plain {k3_plain * 1e3:.1f} ms, bound "
          f"{k3_bound['bound_ms']:.4f} ms, {k3_bound['bound_by']}, {_second(k3_bound)}) at {n} "
          f"lanes; flags "
          f"{torch.bincount(flag2, minlength=3).tolist()}; walks [rays, nodes, leaves, tests] "
          f"{work} [{card}]", flush=True)
    k3_err = _equal("K3", ("sample", "bounce", "origin", "direction", "thr", "srad", "lrad",
                           "t", "tri"), k_out, p_out, card)

    # K4: the compacted lanes of the in-kernel route's first shaded phase,
    # with that phase's per-tile floor.
    k4_names = K4_OUTPUTS
    args, k4_lanes, floor, st = _k4_args(scene26, camera, sky, tile, dev)
    k_out = trace_regen_shaded(*args)
    p_out, k4_plain, work = _plain_work(lambda: trace_regen_shaded_reference(*args))
    k4_bound = _bound(_walk_ops(work), _nbytes(*args, *k_out) + _walk_bytes(scene26)
                      + _scene_bytes(scene26, SHADE_TABLES), **_work_second(work))
    k4_ms = _time_ms(lambda: trace_regen_shaded(*args), 5)
    live_after = int((k_out[0] < nf).sum())
    print(f"K4 trace_regen_shaded: {k4_ms:.4f} ms (plain {k4_plain * 1e3:.1f} ms, bound "
          f"{k4_bound['bound_ms']:.4f} ms, {k4_bound['bound_by']}, {_second(k4_bound)}) at "
          f"{k4_lanes} lanes, "
          f"per-tile floor {floor}: live {int((st['sample'] < nf).sum())} -> {live_after}; "
          f"walks {work} [{card}]", flush=True)
    k4_err = _hold("K4", k4_names, k_out, p_out, ("sample", "bounce", "flag"), card)
    _require(torch.equal(k_out[0], p_out[0]), "K4: the survivors per tile differ from plain")

    # K4 at the one-call route's shape: every lane from its initial state,
    # floor 0. Two launches must agree bit for bit (the lanes take their work
    # items in an order that varies). The plain version takes as long on a
    # 128x128 window as on the whole slice (its time is that of its launches,
    # ~65 rounds of two walks), so it is run once, on every lane, with the
    # walks' work counted in the same run (its time includes the counting).
    args = _k4_full_args(scene26, camera, sky, tile, dev)
    k_out = trace_regen_shaded(*args)
    _equal("K4 at floor 0", k4_names, k_out, trace_regen_shaded(*args), card,
           other="a second launch")
    with count_work() as work:
        p_out, k4f_plain = _timed(lambda: trace_regen_shaded_reference(*args))
    k4f_bound = _bound(_walk_ops(work), _nbytes(*args, *k_out) + _walk_bytes(scene26)
                       + _scene_bytes(scene26, SHADE_TABLES), **_work_second(work))
    k4f_ms = _time_ms(lambda: trace_regen_shaded(*args), 5)
    print(f"K4 trace_regen_shaded, one call: {k4f_ms:.4f} ms (plain {k4f_plain * 1e3:.1f} ms, "
          f"bound {k4f_bound['bound_ms']:.4f} ms, {k4f_bound['bound_by']}, "
          f"{_second(k4f_bound)}) at {n} lanes, floor "
          f"0, {nf} samples; walks {work} [{card}]", flush=True)
    k4f_err = _hold("K4 one call", k4_names, k_out, p_out, ("sample", "bounce", "flag"), card)

    # K5 (K = 2): all lanes after one iteration of the segs route.
    args, flags = _k5_args(scene26, camera, sky, tile, dev)
    k_out = trace_regen_segs(*args)
    p_out, k5_plain, work = _plain_work(lambda: trace_regen_segs_reference(*args))
    k5_bound = _bound(_walk_ops(work), _nbytes(*args, *k_out) + _walk_bytes(scene26),
                      **_work_second(work))
    k5_ms = _time_ms(lambda: trace_regen_segs(*args), 10)
    print(f"K5 trace_regen_segs: {k5_ms:.4f} ms (plain {k5_plain * 1e3:.1f} ms, bound "
          f"{k5_bound['bound_ms']:.4f} ms, {k5_bound['bound_by']}, {_second(k5_bound)}) at {n} "
          f"lanes x 2 slots; "
          f"slot flags {torch.bincount(flags, minlength=3).tolist()}; walks {work} [{card}]",
          flush=True)
    k5_err = _equal("K5", ("salloc", "lrad", "ocnt", "oray", "othr", "t"), k_out, p_out, card)

    return [
        _kernel_entry("trace_regen", "regen.cu", f"{regen}:1211", launches.get("K3", 0), k3_err,
                      k3_ms, k3_plain * 1e3, k3_bound, "phase 4 slice, split route"),
        _kernel_entry("trace_regen_shaded", "regen_shaded.cu", f"{regen}:1715",
                      launches.get("K4", 0), k4_err, k4_ms, k4_plain * 1e3, k4_bound,
                      "phase 5 slice, in-kernel route"),
        _kernel_entry("trace_regen_shaded_one_call", "regen_shaded.cu", f"{regen}:1715",
                      launches.get("K4 one call", 0), k4f_err, k4f_ms, k4f_plain * 1e3,
                      k4f_bound, "phase 5 slice, in-kernel route in one call"),
        _kernel_entry("trace_regen_segs", "regen_segs.cu", f"{regen}:1393",
                      launches.get("K5", 0), k5_err, k5_ms, k5_plain * 1e3, k5_bound,
                      "phase 5 slice, segs=2 route"),
    ]


# The routes of the fused loop, by accumulate_samples_regen's keywords; the
# first is what it does with none.
def _routes(batch: int) -> dict:
    return {"default": {}, "split": dict(inkernel=False),
            "inkernel_hybrid": dict(inkernel=True, compact_floor=4096),
            "segs2": dict(segs=2), "segs4": dict(segs=4),
            "inkernel_one_call": dict(inkernel=True, compact_floor=batch)}


def _route_ab(scene, sky, camera, tile, dev, card: str, label: str) -> dict:
    """Every route on one 512x512 scene: a warm-up dispatch of samples 0-15
    and a timed dispatch of samples 16-31, with each route's own exact ray
    counts and the path kernels' launch counts set to 0 just before and read
    just after; then three more timed dispatches of each route, in turns
    (host time spreads). Requires: the default route is one K4 call per
    dispatch and no K3 or K5 call, every route's counts equal the split
    route's, every accumulation agrees with the default's. Returns the
    numbers."""
    import torch

    from rayfinder_tpu_torch.ops.regen import trace_regen
    from rayfinder_tpu_torch.ops.regen_segs import trace_regen_segs
    from rayfinder_tpu_torch.ops.regen_shaded import trace_regen_shaded
    from rayfinder_tpu_torch.render.pathtracer import accumulate_samples_regen

    w, h, nf = SLICE["width"], SLICE["height"], SLICE["num_frames"]
    kw = dict(width=w, height=h, num_bounces=SLICE["num_bounces"], spp=SLICE["spp"],
              num_frames=nf, engine="kernel", count_rays=True)
    zeros = torch.zeros(w * h, 3, device=dev)
    kernels = {"K3": trace_regen, "K4": trace_regen_shaded, "K5": trace_regen_segs}
    out = {"mrays_per_s": {}, "seconds": {}, "launches": {}, "rays": {}, "repeats": {},
           "card": card}
    accum_w = accum_d = None
    for name, route_kw in _routes(w * h).items():
        for k in kernels.values():
            k.launches = 0
        (warm, _), warm_s = _timed(lambda: accumulate_samples_regen(
            scene, sky, camera, tile, 0, zeros, **route_kw, **kw))
        accum_w = warm if accum_w is None else accum_w
        (accum, rays), secs = _timed(lambda: accumulate_samples_regen(
            scene, sky, camera, tile, nf, accum_w, **route_kw, **kw))
        accum_d = accum if accum_d is None else accum_d
        counts = {k: fn.launches for k, fn in kernels.items()}
        out["launches"][name], out["rays"][name] = counts, rays.tolist()
        out["seconds"][name] = secs
        out["mrays_per_s"][name] = sum(out["rays"][name]) / secs / 1e6
        err = float((accum - accum_d).abs().max())
        print(f"{label} via {name}: {out['mrays_per_s'][name]:.3f} Mrays/s, {secs:.4f} s "
              f"(warm-up dispatch {warm_s:.3f} s), rays [closest, shadow] {out['rays'][name]}, "
              f"launches in 2 dispatches {counts}, max |accum - default| {err:.3e} [{card}]",
              flush=True)
        _require(bool(torch.isfinite(accum).all()) and float(accum.sum()) > 0.0,
                 f"{label} {name}: the radiance is not finite and non-zero")
        _require(bool(torch.allclose(accum, accum_d, rtol=1e-4, atol=2e-3)),
                 f"{label} {name}: the accumulation differs from the default route's")
    launches = out["launches"]
    for name in ("default", "inkernel_one_call"):
        _require(launches[name] == {"K3": 0, "K4": 2, "K5": 0},
                 f"{label}: the {name} route is not one K4 call per dispatch: {launches[name]}")
    _require(launches["split"]["K3"] > 0 and launches["split"]["K4"] == 0,
             f"{label}: the split route did not run K3 alone")
    _require(min(launches["inkernel_hybrid"]["K3"], launches["inkernel_hybrid"]["K4"]) > 0,
             f"{label}: the hybrid route did not run K3 and K4")
    _require(min(launches["segs2"]["K5"], launches["segs4"]["K5"]) > 0,
             f"{label}: the segs routes did not run K5")
    for name, rays in out["rays"].items():
        _require(rays == out["rays"]["split"],
                 f"{label}: the {name} route counts {rays}, the split route "
                 f"{out['rays']['split']}")
    repeats = out["repeats"] = {name: [] for name in out["rays"]}
    for _ in range(3):
        for name, route_kw in _routes(w * h).items():
            _, secs = _timed(lambda: accumulate_samples_regen(
                scene, sky, camera, tile, nf, accum_w, **route_kw, **kw))
            repeats[name].append(sum(out["rays"][name]) / secs / 1e6)
    print(f"{label} routes, Mrays/s over three more dispatches in turns (default first): "
          + "; ".join(f"{k} {', '.join(f'{x:.3f}' for x in v)}" for k, v in repeats.items())
          + f" [{card}]", flush=True)
    return out


def _capped_dispatch(scene, sky, camera, tile, dev, card: str) -> dict:
    """One dispatch of the default route whose K4 scratch would pass the
    cap: the slice's lanes with one sample more than a call may take. It
    must run in two K4 calls and equal, bit for bit, the same dispatch with
    the cap lifted (one call): radiance and ray counts."""
    import torch

    from rayfinder_tpu_torch.ops import regen_shaded
    from rayfinder_tpu_torch.render.pathtracer import accumulate_samples_regen

    w, h = SLICE["width"], SLICE["height"]
    cap = regen_shaded.SCRATCH_CAP_BYTES
    nf = regen_shaded.samples_per_call(w * h) + 1
    _require(12 * w * h * nf > cap, "the capped dispatch's scratch would fit the cap")
    kw = dict(width=w, height=h, num_bounces=SLICE["num_bounces"], spp=SLICE["spp"],
              num_frames=nf, count_rays=True)
    start = torch.rand(w * h, 3, device=dev)
    results = {}
    for name, lifted in (("capped", cap), ("cap lifted", 12 * w * h * nf)):
        regen_shaded.SCRATCH_CAP_BYTES = lifted
        regen_shaded.trace_regen_shaded.launches = 0
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        (accum, rays), secs = _timed(lambda: accumulate_samples_regen(
            scene, sky, camera, tile, 3, start, **kw))
        results[name] = (accum, rays, regen_shaded.trace_regen_shaded.launches, secs,
                         torch.cuda.max_memory_allocated() - before)
    regen_shaded.SCRATCH_CAP_BYTES = cap
    (a, ra, la, sa, pa), (b, rb, lb, sb, pb) = results["capped"], results["cap lifted"]
    same = bool(torch.equal(a, b)) and bool(torch.equal(ra, rb))
    print(f"capped dispatch, {w * h} lanes x {nf} samples (scratch {12 * w * h * nf} bytes "
          f"against the cap of {cap}): {la} K4 calls, {sa:.4f} s, peak {pa} bytes above the "
          f"start; cap lifted: {lb} call, {sb:.4f} s, peak {pb} bytes; equal bit for bit "
          f"(radiance, counts {ra.tolist()}): {same} [{card}]", flush=True)
    _require((la, lb) == (2, 1), f"the capped dispatch took {la} K4 calls, the lifted one {lb}")
    _require(same, "the capped dispatch differs from the uncapped one")
    return {"samples": nf, "calls": la, "seconds": sa, "seconds_cap_lifted": sb,
            "peak_bytes": pa, "peak_bytes_cap_lifted": pb, "rays": ra.tolist()}


def _hybrid_capped(scene, sky, camera, tile, dev, card: str) -> dict:
    """One 256-sample dispatch of the hybrid (compact_floor 131,072: a split
    phase 0, then one K4 call at floor 0 over the last phase's 131,072
    lanes, whose scratch would pass the cap): it must run its last call in
    chunks of lanes and equal the same dispatch with the cap lifted (one
    call), bit for bit, with the split route's ray counts."""
    import torch

    from rayfinder_tpu_torch.ops import regen_shaded
    from rayfinder_tpu_torch.render.pathtracer import accumulate_samples_regen

    w, h, nf, floor = SLICE["width"], SLICE["height"], 256, 131_072
    cap = regen_shaded.SCRATCH_CAP_BYTES
    _require(12 * floor * nf > cap, "the hybrid's last call would fit the cap")
    kw = dict(width=w, height=h, num_bounces=SLICE["num_bounces"], spp=nf, num_frames=nf,
              count_rays=True)
    zeros = torch.zeros(w * h, 3, device=dev)
    results = {}
    for name, lifted in (("capped", cap), ("cap lifted", 12 * floor * nf)):
        regen_shaded.SCRATCH_CAP_BYTES = lifted
        regen_shaded.trace_regen_shaded.launches = 0
        (accum, rays), secs = _timed(lambda: accumulate_samples_regen(
            scene, sky, camera, tile, 0, zeros, inkernel=True, compact_floor=floor, **kw))
        results[name] = (accum, rays, regen_shaded.trace_regen_shaded.launches, secs)
    regen_shaded.SCRATCH_CAP_BYTES = cap
    (_, split_rays), split_s = _timed(lambda: accumulate_samples_regen(
        scene, sky, camera, tile, 0, zeros, inkernel=False, **kw))
    (a, ra, la, sa), (b, rb, lb, sb) = results["capped"], results["cap lifted"]
    same = bool(torch.equal(a, b)) and bool(torch.equal(ra, rb))
    print(f"hybrid dispatch, {w * h} lanes x {nf} samples, compact_floor {floor} (last K4 call's "
          f"scratch {12 * floor * nf} bytes against the cap of {cap}): {la} K4 calls, {sa:.3f} s; "
          f"cap lifted: {lb} call, {sb:.3f} s; equal bit for bit (radiance, counts "
          f"{ra.tolist()}): {same}; split route {split_s:.3f} s, counts {split_rays.tolist()} "
          f"[{card}]", flush=True)
    _require((la, lb) == (2, 1), f"the capped hybrid took {la} K4 calls, the lifted one {lb}")
    _require(same, "the capped hybrid dispatch differs from the uncapped one")
    _require(ra.tolist() == split_rays.tolist(),
             f"the hybrid counts {ra.tolist()}, the split route {split_rays.tolist()}")
    return {"samples": nf, "compact_floor": floor, "calls": la, "seconds": sa,
            "seconds_cap_lifted": sb, "rays": ra.tolist()}


def _launch_counts() -> dict:
    """The ray-query kernels' launch counts (K1, K2)."""
    from rayfinder_tpu_torch.ops.walk import intersect_any_kernel, intersect_closest_kernel

    return {"K1": intersect_closest_kernel.launches, "K2": intersect_any_kernel.launches}


def _zero_launches() -> None:
    from rayfinder_tpu_torch.ops.walk import intersect_any_kernel, intersect_closest_kernel

    intersect_closest_kernel.launches = intersect_any_kernel.launches = 0


def _scan_renders(scene, sky, tile, dev, label: str, golden, card: str, plain: bool) -> dict:
    """Phase 9 at 128x96, 8 spp, 4 bounces: the unfused loop over K1/K2
    (accumulate_samples_regen engine="kernel_split") and render_image_tiled
    in 64x48 windows through the scan form with K1/K2 (engine="kernel"),
    against the default route (one K4 call): each image within RMSE 1e-3
    of the default route's and 5e-3 of the JAX golden, the unfused loop's
    ray counts equal to the default route's. With `plain`, also the scan
    form through the plain versions of K1/K2 (engine="plain"), in one
    window, which must equal the kernels' tiled image bit for bit (the
    plain default route ran in phase 3). Returns the launches and times."""
    import numpy as np
    import torch

    from rayfinder_tpu_torch.render.camera import create_camera
    from rayfinder_tpu_torch.render.pathtracer import (
        SamplingParams, accumulate_samples_regen, render_image_tiled,
    )

    w, h, spp = 128, 96, 8
    cam = create_camera(*CAMERA, w / h)
    kw = dict(width=w, height=h, num_bounces=4, spp=spp, num_frames=spp, count_rays=True)
    zeros = torch.zeros(w * h, 3, device=dev)
    images, counts, out = {}, {}, {"launches": {}, "seconds": {}}
    accums = {}
    for name, engine in (("default", "kernel"), ("unfused kernel_split", "kernel_split")):
        _zero_launches()
        (accums[name], rays), secs = _timed(lambda: accumulate_samples_regen(
            scene, sky, cam, tile, 0, zeros, engine=engine, **kw))
        images[name], counts[name] = _image(accums[name], w, h, spp), rays.tolist()
        out["launches"][name], out["seconds"][name] = _launch_counts(), secs
    tiled = [("tiled kernel", "kernel", 64, 48)] + ([("tiled plain", "plain", w, h)] if plain else [])
    for name, engine, tile_w, tile_h in tiled:
        _zero_launches()
        images[name], secs = _timed(lambda: render_image_tiled(
            scene, sky, cam, width=w, height=h, sampling=SamplingParams(spp, 4), exposure=0.25,
            engine=engine, tile_w=tile_w, tile_h=tile_h))
        out["launches"][name], out["seconds"][name] = _launch_counts(), secs
    for name, img in images.items():
        vs_default, vs_golden = _rmse(img, images["default"]), _rmse(img, golden["image"])
        print(f"{label} 128x96 8spp via {name}: {out['seconds'][name]:.2f} s, K1/K2 launches "
              f"{out['launches'][name]}, rays {counts.get(name, 'not counted')}; RMSE vs default "
              f"{vs_default:.3e}, vs golden {vs_golden:.3e} [{card}]", flush=True)
        _require(vs_default < 1e-3, f"{label}: {name} and the default route's images differ")
        _require(vs_golden < 5e-3, f"{label}: {name} image differs from the golden")
    _require(counts["unfused kernel_split"] == counts["default"],
             f"{label}: the unfused loop counts {counts['unfused kernel_split']}, the default "
             f"route {counts['default']}")
    got = out["launches"]["unfused kernel_split"]
    _require(got["K1"] > 0 and got["K1"] == got["K2"],
             f"{label}: the unfused loop launched K1/K2 {got}")
    # Four windows x 8 samples x 4 bounces, one K1 and one K2 per bounce.
    _require(out["launches"]["tiled kernel"] == {"K1": 128, "K2": 128},
             f"{label}: the tiled scan form launched {out['launches']['tiled kernel']}")
    if plain:
        _require(out["launches"]["tiled plain"] == {"K1": 0, "K2": 0},
                 f"{label}: the plain scan form launched K1/K2")
        same = np.array_equal(images["tiled kernel"], images["tiled plain"])
        print(f"  tiled scan form over K1/K2 (64x48 windows) == over their plain versions "
              f"(one window), bit for bit: {same}", flush=True)
        _require(same, f"{label}: the scan form over K1/K2 differs from its plain version")
    out["rays"] = counts
    return out


def _device_busy(label: str, fn, card: str) -> dict:
    """One call of fn under torch.profiler: the device time of every kernel
    and copy (the profiler's device events, not the operators that launched
    them) summed against the wall time (one stream, so their share of the
    wall is the device's busy share), and the kernels that took the most.
    Prints "not measured" where the profiler saw no device event."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, wall = _timed(fn)
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    device_us = {e.key: e.device_time_total for e in events}
    busy_s = sum(device_us.values()) * 1e-6
    launches = sum(e.count for e in events)
    top = sorted(device_us.items(), key=lambda kv: -kv[1])[:5]
    if busy_s <= 0.0:
        print(f"{label} under torch.profiler: wall {wall:.4f} s, device time not measured (no "
              f"device events) [{card}]", flush=True)
        return {"wall_s": wall, "device_busy_s": None}
    print(f"{label} under torch.profiler: wall {wall:.4f} s, kernels {busy_s:.4f} s over "
          f"{launches} launches, device busy {busy_s / wall:.3f}; most device time: "
          + "; ".join(f"{k[:60]} {v * 1e-3:.3f} ms" for k, v in top) + f" [{card}]", flush=True)
    return {"wall_s": wall, "device_busy_s": busy_s, "kernel_launches": launches,
            "top_ms": {k: v * 1e-3 for k, v in top}}


def _scan_query_check(scene, sky, camera, tile, dev, card: str) -> dict:
    """K1/K2 at the scan form's inputs: the rays of bounce 2 of one
    trace_radiance over the slice (sorted, with its parked lanes) and its
    shadow rays, recorded from the first sample of a scan dispatch, held to
    their plain versions exactly (t at atol 0, tri, nodes, occlusion), and
    timed, with their bounds from the rays' counted work."""
    import torch

    from rayfinder_tpu_torch.ops.counted import intersect_closest_counted, walk_operations
    from rayfinder_tpu_torch.ops.walk import (
        intersect_any_kernel, intersect_any_reference,
        intersect_closest_kernel, intersect_closest_reference,
    )
    from rayfinder_tpu_torch.render import pathtracer as pt
    from rayfinder_tpu_torch.render.traverse import count_work, intersect_any

    w, h = SLICE["width"], SLICE["height"]
    calls = {"closest": [], "any": []}
    closest, any_hit = pt._WALKS["kernel"]

    def record(kind, fn):
        def wrapped(scene_, o, d, t_max):
            calls[kind].append((o.clone(), d.clone(), t_max.clone()))
            return fn(scene_, o, d, t_max)
        return wrapped

    pt._WALKS["kernel"] = (record("closest", closest), record("any", any_hit))
    try:
        pt.accumulate_sample(scene, sky, camera, tile, 0, torch.zeros(w * h, 3, device=dev),
                             width=w, height=h, num_bounces=SLICE["num_bounces"], spp=SLICE["spp"])
    finally:
        pt._WALKS["kernel"] = (closest, any_hit)
    (o, d, t_max), (so, sd, st) = calls["closest"][1], calls["any"][1]
    parked = (int((o == 1e30).all(1).sum()), int((so == 1e30).all(1).sum()))
    _, t, tri, visits = intersect_closest_kernel(scene, o, d, t_max)
    occ = intersect_any_kernel(scene, so, sd, st)
    _, pt_, ptri, pvisits = intersect_closest_reference(scene, o, d, t_max)
    pocc = intersect_any_reference(scene, so, sd, st)
    same = dict(t=bool(torch.equal(t, pt_)), tri=bool(torch.equal(tri, ptri)),
                nodes=bool(torch.equal(visits, pvisits)), occ=bool(torch.equal(occ, pocc)))
    n = o.shape[0]
    print(f"K1/K2 at the scan form's bounce 2 over the slice: {n} rays ({parked[0]} parked), "
          f"{n} shadow rays ({parked[1]} parked); kernel == plain {same} [{card}]", flush=True)
    _require(all(same.values()), f"K1/K2 differ from plain at the scan form's bounce 2: {same}")
    _require(min(parked) > 0, "the scan form's bounce 2 handed K1/K2 no parked lane")
    c = intersect_closest_counted(scene, o, d, t_max)[3].sum(0, dtype=torch.int64).tolist()
    k1_bound = _bound(walk_operations(c[0], c[2]), _nbytes(o, d, t_max) + 12 * n
                      + _walk_bytes(scene), issue=_walk_issue(c[0], c[2]),
                      loaded=_walk_loaded(n, c[0], c[2]))
    with count_work() as work:
        intersect_any(scene, so, sd, st)
    k2_bound = _bound(_walk_ops(work), _nbytes(so, sd, st) + n + _walk_bytes(scene),
                      **_work_second(work))
    k1_ms = _time_ms(lambda: intersect_closest_kernel(scene, o, d, t_max), 20)
    k2_ms = _time_ms(lambda: intersect_any_kernel(scene, so, sd, st), 20)
    print(f"  K1 there {k1_ms:.4f} ms (bound {k1_bound['bound_ms']:.4f} ms, {k1_bound['bound_by']}), "
          f"K2 {k2_ms:.4f} ms (bound {k2_bound['bound_ms']:.4f} ms, {k2_bound['bound_by']}); "
          f"nodes/ray {c[0] / n:.2f} [{card}]", flush=True)
    return {"rays": n, "parked": parked, "k1_ms": k1_ms, "k2_ms": k2_ms,
            "k1_bound_ms": k1_bound["bound_ms"], "k2_bound_ms": k2_bound["bound_ms"]}


def _scan_slice(scene, sky, camera, tile, dev, card: str) -> dict:
    """Phase 9 on the slice (courtyard_scene(26), 512x512, 4 bounces): the
    default route, the scan form (accumulate_samples, engine "kernel") and
    the unfused loop (accumulate_samples_regen, engine "kernel_split"), each
    a warm-up dispatch of samples 0-15 and a timed one of 16-31 fenced by a
    device sync, K1/K2 launch counts set to 0 just before the timed dispatch
    and read just after. The scan form must launch 64 K1 and 64 K2 and
    accumulate within RMSE 1e-3 (tonemapped) of the default route; the
    unfused loop must count exactly SLICE_RAYS."""
    import torch

    from rayfinder_tpu_torch.render.pathtracer import accumulate_samples, accumulate_samples_regen

    w, h, nf = SLICE["width"], SLICE["height"], SLICE["num_frames"]
    kw = dict(width=w, height=h, num_bounces=SLICE["num_bounces"], spp=SLICE["spp"], num_frames=nf)
    zeros = torch.zeros(w * h, 3, device=dev)
    out = {"seconds": {}, "mrays_per_s": {}, "launches": {}, "warm_seconds": {}}
    accums = {}
    forms = (("default", lambda fb, a: accumulate_samples_regen(
                 scene, sky, camera, tile, fb, a, count_rays=True, **kw)),
             ("scan", lambda fb, a: accumulate_samples(
                 scene, sky, camera, tile, fb, a, engine="kernel", **kw)),
             ("unfused", lambda fb, a: accumulate_samples_regen(
                 scene, sky, camera, tile, fb, a, engine="kernel_split", count_rays=True, **kw)))
    for name, run in forms:
        warm, out["warm_seconds"][name] = _timed(lambda: run(0, zeros))
        warm = warm[0] if isinstance(warm, tuple) else warm
        _zero_launches()
        res, secs = _timed(lambda: run(nf, warm))
        out["launches"][name] = _launch_counts()
        accum, rays = res if isinstance(res, tuple) else (res, None)
        accums[name] = accum
        out["seconds"][name] = secs
        # The scan form traces the same segments as the counted forms.
        counted = rays.tolist() if rays is not None else SLICE_RAYS
        out["mrays_per_s"][name] = sum(counted) / secs / 1e6
        err = _rmse(_image(accum, w, h, 2 * nf), _image(accums["default"], w, h, 2 * nf))
        print(f"slice via {name}: {secs:.4f} s, {out['mrays_per_s'][name]:.3f} Mrays/s "
              f"(rays {counted}{'' if rays is not None else ', the counted forms'}), warm-up "
              f"dispatch {out['warm_seconds'][name]:.3f} s, K1/K2 launches {out['launches'][name]}, "
              f"RMSE vs default (tonemapped, 32 samples) {err:.3e} [{card}]", flush=True)
        _require(bool(torch.isfinite(accum).all()) and float(accum.sum()) > 0.0,
                 f"slice {name}: the radiance is not finite and non-zero")
        _require(err < 1e-3, f"slice {name}: the accumulation differs from the default route's")
        if rays is not None:
            _require(counted == SLICE_RAYS, f"slice {name}: counts {counted}, expected {SLICE_RAYS}")
    out["profile"] = {name: _device_busy(f"slice via {name}, samples 16-31", lambda: run(
        nf, accums[name]), card) for name, run in forms}
    launches = out["launches"]
    _require(launches["scan"] == {"K1": 64, "K2": 64},
             f"the scan form launched {launches['scan']}, expected 64 K1 and 64 K2")
    _require(launches["unfused"]["K1"] > 0 and launches["unfused"]["K1"] == launches["unfused"]["K2"],
             f"the unfused loop launched {launches['unfused']}")
    _require(launches["default"] == {"K1": 0, "K2": 0}, "the default route launched K1/K2")
    return out


def _renderer_check(scene, camera, dev, card: str) -> dict:
    """Phase 9's Renderer on the slice: three render(16) calls on the
    default engine counting rays; progress, frame count, total_rays against
    one counted dispatch of the same 48 samples; image_u8 against image();
    a checkpoint saved and loaded on the card bit for bit; reset only on a
    real parameter change."""
    import dataclasses

    import numpy as np
    import torch

    from rayfinder_tpu_torch.ops.regen_shaded import trace_regen_shaded
    from rayfinder_tpu_torch.render.pathtracer import SamplingParams, accumulate_samples_regen
    from rayfinder_tpu_torch.render.renderer import Renderer, RenderParameters, Sky

    w, h = SLICE["width"], SLICE["height"]
    params = RenderParameters(width=w, height=h, camera=camera,
                              sampling=SamplingParams(SLICE["spp"], SLICE["num_bounces"]),
                              sky=Sky(*SKY), exposure=0.25)
    r = Renderer(scene, params, engine="kernel", count_rays=True)
    trace_regen_shaded.launches = 0
    times = []
    for _ in range(3):
        _, secs = _timed(lambda: r.render(16))
        times.append(secs)
    k4 = trace_regen_shaded.launches
    accum, rays = accumulate_samples_regen(
        scene, Sky(*SKY).state(), camera, r._tile, 0, torch.zeros(w * h, 3, device=dev),
        width=w, height=h, num_bounces=SLICE["num_bounces"], spp=SLICE["spp"], num_frames=48,
        count_rays=True)
    same_accum = bool(torch.equal(accum, r._accum))
    print(f"Renderer on the slice: 3 x render(16) {[round(t, 4) for t in times]} s, rolling pass "
          f"{r.average_render_pass_duration_ms():.3f} ms, K4 launches {k4}, progress "
          f"{r.render_progress_percentage()}%, frames {r.frame_count}, total_rays {r.total_rays} "
          f"(one 48-sample dispatch {int(rays.sum())}, its accumulation equal bit for bit: "
          f"{same_accum}) [{card}]", flush=True)
    _require(k4 == 3, f"the Renderer took {k4} K4 calls for three render(16)")
    _require((r.accumulated_sample_count, r.frame_count) == (48, 48)
             and r.render_progress_percentage() == 100.0 * 48 / SLICE["spp"],
             "the Renderer's progress or frame count is wrong")
    _require(r.total_rays == int(rays.sum()), f"total_rays {r.total_rays} != {int(rays.sum())}")
    _require(bool(torch.allclose(accum, r._accum, rtol=1e-5, atol=1e-5)),
             "the Renderer's accumulation differs from one dispatch of its samples")
    u8, f32 = r.image_u8(), r.image()
    _require(np.array_equal(u8, np.clip(np.round(f32 * 255.0), 0, 255).astype(np.uint8)),
             "image_u8 is not the quantized image")
    with tempfile.TemporaryDirectory() as tmp:
        path = pathlib.Path(tmp) / "render.ckpt.npz"
        r.save_checkpoint(path)
        r2 = Renderer(scene, params, engine="kernel")
        r2.load_checkpoint(path)
    _require(r2._accum.device == r._accum.device and bool(torch.equal(r2._accum, r._accum))
             and (r2.accumulated_sample_count, r2.frame_count) == (48, 48),
             "the checkpoint did not load back bit for bit")
    r.set_render_parameters(dataclasses.replace(params))
    kept = r.accumulated_sample_count
    r.set_render_parameters(dataclasses.replace(params, exposure=0.5))
    _require(kept == 48 and r.accumulated_sample_count == 0 and r.frame_count == 48
             and not bool(r._accum.any()), "the Renderer's reset on a parameter change is wrong")
    print("  image_u8 == quantized image(); checkpoint round trip on the card bit for bit; "
          "reset on a changed exposure only", flush=True)
    return {"render_seconds": times, "k4_launches": k4, "total_rays": r.total_rays,
            "accum_equal_one_dispatch": same_accum}


def _full_hd(scene, sky, tile, dev, card: str) -> dict:
    """Phase 9 at 1920x1080, 4 bounces: render_image_tiled (scan form, K1/K2,
    512x512 windows) against render_image (default route, K4), 4 spp, RMSE
    < 1e-3; then the default route's seconds per sample from a timed
    32-sample dispatch after a warm-up one, and time_to_1024spp_1080p_s from
    it."""
    import torch

    from rayfinder_tpu_torch.render.camera import create_camera
    from rayfinder_tpu_torch.render.pathtracer import (
        SamplingParams, accumulate_samples_regen, render_image, render_image_tiled,
    )

    w, h = 1920, 1080
    cam = create_camera(*CAMERA, w / h)
    kw = dict(width=w, height=h, sampling=SamplingParams(4, SLICE["num_bounces"]), exposure=0.25)
    render_image(scene, sky, cam, **kw)  # warm-up: the pixel order of the size
    whole, whole_s = _timed(lambda: render_image(scene, sky, cam, **kw))
    _zero_launches()
    tiled, tiled_s = _timed(lambda: render_image_tiled(scene, sky, cam, engine="kernel", **kw))
    launches = _launch_counts()
    err = _rmse(tiled, whole)
    dkw = dict(width=w, height=h, num_bounces=SLICE["num_bounces"], spp=1024, num_frames=32,
               count_rays=True)
    warm, _ = accumulate_samples_regen(scene, sky, cam, tile, 0,
                                       torch.zeros(w * h, 3, device=dev), **dkw)
    (_, rays), secs = _timed(lambda: accumulate_samples_regen(scene, sky, cam, tile, 32, warm, **dkw))
    per_sample = secs / 32
    print(f"1920x1080, 4 spp: render_image_tiled (scan form, 512x512 windows) {tiled_s:.3f} s, "
          f"K1/K2 launches {launches}; render_image (default route) {whole_s:.4f} s; RMSE "
          f"{err:.3e} [{card}]", flush=True)
    print(f"1920x1080 default route: a 32-sample dispatch {secs:.4f} s, {per_sample:.6f} s per "
          f"sample, {sum(rays.tolist()) / secs / 1e6:.3f} Mrays/s (rays {rays.tolist()}); "
          f"time_to_1024spp_1080p_s {1024 * per_sample:.3f} [{card}]", flush=True)
    _require(err < 1e-3, f"tiled 1080p differs from untiled: RMSE {err:.3e}")
    _require(launches["K1"] == launches["K2"] == 12 * 4 * SLICE["num_bounces"],
             f"the tiled 1080p render launched {launches}")
    return {"tiled_seconds": tiled_s, "untiled_seconds": whole_s, "rmse": err,
            "launches_tiled": launches, "seconds_per_sample": per_sample,
            "time_to_1024spp_1080p_s": 1024 * per_sample, "rays_32": rays.tolist(),
            "card": card}

# Phase 10: the deferred renderer and the interactive layer over K1/K2.
DEFERRED_HD = dict(width=1920, height=1080, warm_frames=2, timed_frames=8)
# The rays at each end of a full-width query held to the plain walks (the
# plain walk takes ~0.7 s per 262,144 rays on the card).
QUERY_WINDOW = 262_144
VIEWER_SIZE = (640, 480)
HEAT_SIZE = (1280, 720)
RENDER_TOOL = dict(scene="procedural:courtyard:26", size=(640, 480), spp=16)


def _tagged(card: str, fn):
    """fn(), with each line it prints reprinted with the card's name and
    power limit (the viewer's readouts, the render tool's lines)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn()
    for line in buf.getvalue().splitlines():
        print(f"{line} [{card}]", flush=True)
    return out


def _deferred_small(scenes: dict, dev, card: str) -> dict:
    """Phase 10 (a): three DeferredRenderer frames of each courtyard_scene(8)
    at 128x96 on the kernels K1/K2 ("kernel") and on their plain versions
    ("plain"): the TAA accumulators equal bit for bit, the displays and the
    debug triptychs equal, each within RMSE 5e-3 of the JAX-baked golden
    (tests/goldens/courtyard_deferred_128x96_f3.npz); two K1 and two K2
    launches per frame on "kernel", none on "plain". Then the sun check: a
    9x9 camera above the untextured scene's root box staring at the sun
    reads above 1e4 at the centre pixel."""
    import numpy as np
    import torch

    sys.path.insert(0, str(GOLDENS))
    import bake_torch_smoke as cfg

    from rayfinder_tpu_torch.render.camera import create_camera
    from rayfinder_tpu_torch.render.deferred import DeferredRenderer, gbuffer_pass, lighting_pass
    from rayfinder_tpu_torch.sky.model import sky_state_from_ui

    golden = np.load(cfg.DEFERRED_GOLDEN)
    w, h = cfg.WIDTH, cfg.HEIGHT
    cam = create_camera(*cfg.CAMERA, w / h)
    out = {}
    for kind, scene in scenes.items():
        renderers = {e: DeferredRenderer(scene, w, h, engine=e) for e in ("kernel", "plain")}
        images, launches, secs = {}, {}, {}
        for engine, r in renderers.items():
            _zero_launches()
            t0 = time.perf_counter()
            for _ in range(cfg.DEFERRED_FRAMES):
                images[engine] = r.render(cam, sky_state_from_ui(*cfg.SKY), cfg.EXPOSURE)
            secs[engine] = time.perf_counter() - t0
            launches[engine] = _launch_counts()
        with np.errstate(invalid="ignore"):
            debug = {e: r.render_debug(cam) for e, r in renderers.items()}
        same_accum = bool(torch.equal(renderers["kernel"].accum, renderers["plain"].accum))
        same_display = bool(np.array_equal(images["kernel"], images["plain"]))
        same_debug = bool(np.array_equal(debug["kernel"], debug["plain"], equal_nan=True))
        vs_golden = _rmse(images["kernel"], golden[f"{kind}_display"] / 255.0)
        debug_vs_golden = _rmse(np.nan_to_num(debug["kernel"]),
                                np.nan_to_num(golden[f"{kind}_debug"]))
        print(f"deferred {kind} courtyard8 128x96, {cfg.DEFERRED_FRAMES} frames: kernel "
              f"{secs['kernel']:.3f} s (K1/K2 launches {launches['kernel']}), plain "
              f"{secs['plain']:.3f} s; accumulator kernel == plain {same_accum}, display "
              f"{same_display}, debug {same_debug}; RMSE vs golden display {vs_golden:.3e}, "
              f"debug {debug_vs_golden:.3e} [{card}]", flush=True)
        per_run = 2 * cfg.DEFERRED_FRAMES
        _require(launches["kernel"] == {"K1": per_run, "K2": per_run},
                 f"deferred {kind}: the kernel frames launched {launches['kernel']}")
        _require(launches["plain"] == {"K1": 0, "K2": 0}, f"deferred {kind}: plain launched K1/K2")
        _require(same_accum and same_display and same_debug,
                 f"deferred {kind}: the frames on K1/K2 differ from their plain versions")
        _require(vs_golden < 5e-3 and debug_vs_golden < 5e-3,
                 f"deferred {kind}: the frames differ from the golden")
        out[kind] = {"seconds": secs, "launches": launches, "rmse_golden": vs_golden,
                     "rmse_golden_debug": debug_vs_golden}

    scene = scenes["untextured"]
    sky = sky_state_from_ui(1.0, (1.0, 1.0, 1.0), 30.0, 0.0)
    sun_dir = np.asarray(sky.sun_direction, np.float64)
    origin = np.asarray([0.0, float(scene.bvh_aabb_max[0, 1]) + 50.0, 0.0])
    sun_cam = create_camera(origin, origin + sun_dir, 0.0, 1.0, 10.0, 1.0)
    gbuf = gbuffer_pass(scene, sun_cam, 0, width=9, height=9)
    centre = lighting_pass(scene, sky, gbuf, 0, width=9, height=9)[40].max().item()
    print(f"deferred sun check: the centre pixel of a 9x9 camera staring at the sun reads "
          f"{centre:.1f} (no hit: {not bool(gbuf['hit'].any())}) [{card}]", flush=True)
    _require(centre > 1e4 and not bool(gbuf["hit"].any()), "the deferred miss has no solar disk")
    out["sun_centre"] = centre
    return out


def _record_queries(fn) -> tuple:
    """fn() with every K1/K2 query of the "kernel" engine recorded:
    (fn's result, [(kind, o, d, t_max), ...] in call order)."""
    from rayfinder_tpu_torch.render import pathtracer as pt

    calls = []
    closest, any_hit = pt._WALKS["kernel"]

    def record(kind, query):
        def wrapped(scene, o, d, t_max):
            calls.append((kind, o, d, t_max))
            return query(scene, o, d, t_max)
        return wrapped

    pt._WALKS["kernel"] = (record("closest", closest), record("any", any_hit))
    try:
        out = fn()
    finally:
        pt._WALKS["kernel"] = (closest, any_hit)
    return out, calls


def _parking_ab(scene, cam, sky, card: str, rounds: int = 3) -> dict:
    """The deferred frame as it ships, every ray passed to K1/K2 as the JAX
    package passes them, against the same frame with the lanes whose result
    the pass drops parked far outside the scene (a miss pixel's three
    lighting queries, a missed bounce's sun sample), at 1920x1080 in turns
    (parked, through, through, parked) x rounds after a warm-up frame each:
    the wall of each render() and the CUDA-event span of its frame_pass,
    medians. The two renderers' accumulators must stay equal bit for bit: a
    lane's result that the pass drops may not reach the image."""
    import statistics

    import torch

    from rayfinder_tpu_torch.render import deferred
    from rayfinder_tpu_torch.render.deferred import DeferredRenderer
    from rayfinder_tpu_torch.render.shade import PARK

    closest, any_hit, frame_pass = deferred._closest, deferred._any, deferred.frame_pass
    # A frame's queries in order: primaries (all live), the G-buffer's sun
    # sample (live: hit), the bounce (hit), the bounce's sun sample (hit &
    # the bounce's hit). masks holds the live sets the closest queries found.
    masks = []

    def park(o, d, live):
        if live is None:
            return o, d
        return torch.where(live[:, None], o, PARK), torch.where(live[:, None], d, 1.0)

    def parked_closest(scene, o, d, engine):
        live = masks[0] if masks else None
        hit, t, tri = closest(scene, *park(o, d, live), engine)
        masks.append(hit if live is None else live & hit)
        return hit, t, tri

    def parked_any(scene, o, d, engine):
        return any_hit(scene, *park(o, d, masks[-1]), engine)

    def spanned(*args, **kwargs):
        spanned.events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        spanned.events[0].record()
        out = frame_pass(*args, **kwargs)
        spanned.events[1].record()
        return out

    w, h = DEFERRED_HD["width"], DEFERRED_HD["height"]
    forms = {"through": (closest, any_hit), "parked": (parked_closest, parked_any)}
    renderers = {k: DeferredRenderer(scene, w, h) for k in forms}
    wall = {k: [] for k in forms}
    span = {k: [] for k in forms}

    def frame(form: str, timed: bool) -> None:
        masks.clear()
        deferred._closest, deferred._any = forms[form]
        deferred.frame_pass = spanned
        try:
            t0 = time.perf_counter()
            renderers[form].render(cam, sky, 0.25)
            t1 = time.perf_counter()
        finally:
            deferred._closest, deferred._any, deferred.frame_pass = closest, any_hit, frame_pass
        if timed:
            wall[form].append(1e3 * (t1 - t0))
            span[form].append(spanned.events[0].elapsed_time(spanned.events[1]))

    for form in forms:
        frame(form, False)
    for _ in range(rounds):
        for form in ("parked", "through", "through", "parked"):
            frame(form, True)
    same = bool(torch.equal(renderers["parked"].accum, renderers["through"].accum))
    out = {k: {"wall_ms": wall[k], "span_ms": span[k],
               "median_wall_ms": statistics.median(wall[k]),
               "median_span_ms": statistics.median(span[k])} for k in forms}
    print("deferred 1080p, every ray passed through (as shipped) against the dropped lanes "
          "parked, in turns: " + "; ".join(
              f"{k} median {v['median_wall_ms']:.3f} ms per render(), frame_pass span "
              f"{v['median_span_ms']:.3f} ms (walls {[round(x, 3) for x in v['wall_ms']]})"
              for k, v in out.items()) + f"; accumulators equal {same} [{card}]", flush=True)
    _require(same, "parking the dropped lanes changed the deferred image")
    out["equal"] = same
    return out


def _deferred_full_hd(scene, dev, card: str) -> dict:
    """Phase 10 (b), the slice's path: DeferredRenderer on courtyard_scene(26)
    at 1920x1080 with the bench camera and sky, engine "kernel". Two warm-up
    frames, then eight timed render() calls (each synchronised, the u8
    readback included), K1/K2 launch counts set to 0 just before and read
    just after (2 + 2 per frame). The three passes unfused, each between
    CUDA events (the device timeline's span, host gaps included). One frame
    under torch.profiler (device busy share), the peak memory. One frame's
    four queries recorded: each launched on all its rays and that launch's
    result held to the plain version on its first and its last QUERY_WINDOW
    rays (t, tri, nodes, occlusion exact; the rays of each window whose
    result the pass drops counted), each timed at full width; K1's and
    K2's bounds on the primaries' and the G-buffer shadow rays' first
    windows from their counted work. Then the parking A/B (_parking_ab)."""
    import numpy as np
    import torch

    from rayfinder_tpu_torch.ops.counted import intersect_closest_counted, walk_operations
    from rayfinder_tpu_torch.ops.walk import (
        intersect_any_kernel, intersect_any_reference,
        intersect_closest_kernel, intersect_closest_reference,
    )
    from rayfinder_tpu_torch.render.camera import create_camera
    from rayfinder_tpu_torch.render.deferred import (
        DeferredRenderer, gbuffer_pass, lighting_pass, resolve_pass,
    )
    from rayfinder_tpu_torch.render.traverse import count_work, intersect_any
    from rayfinder_tpu_torch.sky.model import sky_state_from_ui

    w, h = DEFERRED_HD["width"], DEFERRED_HD["height"]
    cam = create_camera(*CAMERA, w / h)
    sky = sky_state_from_ui(*SKY)
    r = DeferredRenderer(scene, w, h)
    for _ in range(DEFERRED_HD["warm_frames"]):
        r.render(cam, sky, 0.25)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_launches()
    frame_s = []
    for _ in range(DEFERRED_HD["timed_frames"]):
        t0 = time.perf_counter()
        img = r.render(cam, sky, 0.25)
        frame_s.append(time.perf_counter() - t0)
    launches = _launch_counts()
    peak = torch.cuda.max_memory_allocated()
    n = DEFERRED_HD["timed_frames"]
    ms = 1e3 * sum(frame_s) / n
    print(f"deferred {w}x{h} on {scene.num_triangles} triangles: {ms:.3f} ms per frame "
          f"(synchronised, u8 readback "
          f"included; frames {[round(1e3 * s, 3) for s in frame_s]} ms), rolling 'frame' "
          f"{r.perf_stats()['frame']:.3f} ms, K1/K2 launches over {n} frames {launches}, peak "
          f"memory {peak / 2**20:.1f} MiB [{card}]", flush=True)
    _require(launches == {"K1": 2 * n, "K2": 2 * n},
             f"the 1080p deferred frames launched {launches}, expected {2 * n} each")
    _require(img.shape == (h, w, 3) and bool(np.isfinite(img).all()) and img.max() > 0.0
             and bool(torch.isfinite(r.accum).all()), "the 1080p deferred frame is not right")

    # The passes unfused, between CUDA events.
    spans = {"gbuffer": [], "lighting": [], "resolve": []}
    for _ in range(5):
        fc = r.frame_count
        torch.cuda.synchronize()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        gbuf = gbuffer_pass(scene, cam, fc, width=w, height=h)
        ev[1].record()
        sample = lighting_pass(scene, r._device_sky(sky), gbuf, fc, width=w, height=h,
                               tile=r._tile)
        ev[2].record()
        r.accum, _ = resolve_pass(sample, r.accum, fc, 0.25)
        ev[3].record()
        torch.cuda.synchronize()
        r.frame_count += 1
        for k, name in enumerate(spans):
            spans[name].append(ev[k].elapsed_time(ev[k + 1]))
    pass_ms = {k: sum(v) / len(v) for k, v in spans.items()}
    print("deferred 1080p passes unfused (CUDA events, mean of 5): " + ", ".join(
        f"{k} {v:.3f} ms" for k, v in pass_ms.items()) + f" [{card}]", flush=True)

    profile = _device_busy("deferred 1080p frame", lambda: r.render(cam, sky, 0.25), card)
    # The host's share of render(): the u8 frame's copy to the host, and its
    # conversion to the f32 image render() returns.
    img8 = torch.zeros(h * w, 3, dtype=torch.uint8, device=dev)
    _, copy_s = _timed(lambda: [img8.cpu() for _ in range(5)])
    u8 = img8.cpu().numpy().reshape(h, w, 3)
    t0 = time.perf_counter()
    for _ in range(5):
        u8.astype(np.float32) / np.float32(255.0)
    convert_ms = 1e3 * (time.perf_counter() - t0) / 5
    print(f"deferred 1080p readback: the u8 frame's copy to the host {1e3 * copy_s / 5:.3f} ms, "
          f"its conversion to f32 on the host {convert_ms:.3f} ms [{card}]", flush=True)

    # One frame's queries, each launched at full width: the launch's result
    # held to plain on a window at each end of the rays (the image's top and
    # bottom rows), and timed. Per window, the rays whose result the pass
    # drops (a miss pixel's three later queries, a missed bounce's sun
    # sample: live sets from the primaries' and the bounce's hits) and the
    # non-finite rays among them are counted.
    _, calls = _record_queries(lambda: r.render(cam, sky, 0.25))
    _require([c[0] for c in calls] == ["closest", "any", "closest", "any"],
             f"a deferred frame made the queries {[c[0] for c in calls]}")
    names = ("primaries", "gbuffer shadow rays", "bounce rays", "bounce shadow rays")
    rays = w * h
    windows = {"head": slice(0, QUERY_WINDOW), "tail": slice(rays - QUERY_WINDOW, rays)}
    query_ms, checks, dropped, nonfinite = {}, {}, {}, {}
    hits = []  # the G-buffer's hit, then hit & the bounce's hit
    for k, (name, (kind, o, d, t_max)) in enumerate(zip(names, calls)):
        _require(o.shape[0] == rays, f"the 1080p frame's {name} hold {o.shape[0]} rays")
        live = None if k == 0 else hits[0] if k < 3 else hits[1]
        if kind == "closest":
            full = intersect_closest_kernel(scene, o, d, t_max)
            plain = intersect_closest_reference
            query_ms[name] = _time_ms(lambda: intersect_closest_kernel(scene, o, d, t_max), 5)
            hits.append(full[0] if live is None else live & full[0])
        else:
            full = (intersect_any_kernel(scene, o, d, t_max),)
            plain = lambda *a: (intersect_any_reference(*a),)  # noqa: E731
            query_ms[name] = _time_ms(lambda: intersect_any_kernel(scene, o, d, t_max), 5)
        finite = torch.isfinite(o).all(1) & torch.isfinite(d).all(1)
        for side, win in windows.items():
            want = plain(scene, o[win].contiguous(), d[win].contiguous(), t_max[win].contiguous())
            same = all(bool(torch.equal(a[win], b)) for a, b in zip(full, want))
            checks[f"{name} {side}"] = same
            dropped[f"{name} {side}"] = 0 if live is None else int((~live[win]).sum())
            nonfinite[f"{name} {side}"] = int((~finite[win]).sum())
            _require(same, f"K1/K2 at {rays} rays differ from plain on the 1080p deferred "
                     f"frame's {name}, {side} window")
    print(f"K1/K2 launched on the {rays} rays of each of the 1080p frame's queries == plain on "
          f"the first and the last {QUERY_WINDOW}: {checks}; rays per window whose result the "
          f"pass drops {dropped}, non-finite rays {nonfinite}; per launch: " + ", ".join(
              f"{k} {v:.4f} ms" for k, v in query_ms.items())
          + f"; K1 + K2 per frame {sum(query_ms.values()):.4f} ms [{card}]", flush=True)

    parking = _parking_ab(scene, cam, sky, card)

    # Bounds and times on the windows of the primaries (K1) and the
    # G-buffer's shadow rays (K2).
    win = windows["head"]
    _, o, d, t_max = calls[0]
    ow, dw, tw = o[win].contiguous(), d[win].contiguous(), t_max[win].contiguous()
    c = intersect_closest_counted(scene, ow, dw, tw)[3].sum(0, dtype=torch.int64).tolist()
    k1_bound = _bound(walk_operations(c[0], c[2]), _nbytes(ow, dw, tw) + 12 * QUERY_WINDOW
                      + _walk_bytes(scene), issue=_walk_issue(c[0], c[2]),
                      loaded=_walk_loaded(QUERY_WINDOW, c[0], c[2]))
    k1_ms = _time_ms(lambda: intersect_closest_kernel(scene, ow, dw, tw), 20)
    _, so, sd, st = calls[1]
    so, sd, st = so[win].contiguous(), sd[win].contiguous(), st[win].contiguous()
    with count_work() as work:
        intersect_any(scene, so, sd, st)
    k2_bound = _bound(_walk_ops(work), _nbytes(so, sd, st) + QUERY_WINDOW + _walk_bytes(scene),
                      **_work_second(work))
    k2_ms = _time_ms(lambda: intersect_any_kernel(scene, so, sd, st), 20)
    print(f"  on {QUERY_WINDOW}-ray windows: K1 on the primaries {k1_ms:.4f} ms (bound "
          f"{k1_bound['bound_ms']:.4f} ms, {k1_bound['bound_by']}; nodes/ray "
          f"{c[0] / QUERY_WINDOW:.2f}), K2 on the G-buffer shadow rays {k2_ms:.4f} ms (bound "
          f"{k2_bound['bound_ms']:.4f} ms, {k2_bound['bound_by']}) [{card}]", flush=True)
    return {"ms_per_frame": ms, "frame_ms": [1e3 * s for s in frame_s], "launches": launches,
            "peak_bytes": peak, "pass_ms": pass_ms, "profile": profile, "query_ms": query_ms,
            "readback_ms": 1e3 * copy_s / 5, "convert_ms": convert_ms,
            "window_checks": checks, "window_dropped": dropped, "window_nonfinite": nonfinite,
            "parking_ab": parking,
            "k1_window_ms": k1_ms, "k2_window_ms": k2_ms,
            "k1_window_bound_ms": k1_bound["bound_ms"], "k2_window_bound_ms": k2_bound["bound_ms"],
            "card": card}


def _viewer_check(scene, dev, card: str, outdir: pathlib.Path) -> dict:
    """Phase 10 (c): a scripted ViewerSession on the slice's scene at 640x480
    (default engine, the bench camera): pt frames with the Mrays/s readout
    from the exact counts, a deferred frame, a move that resets both
    renderers, a focus pick through one K1 launch, four deferred frames (8 K1
    and 8 K2 launches) and a debug frame; every PNG written."""
    import numpy as np

    from rayfinder_tpu_torch.render.renderer import Sky
    from rayfinder_tpu_torch.tools.viewer import ViewerSession

    vw, vh = VIEWER_SIZE
    s = ViewerSession(scene, outdir / "viewer_pt.png", width=vw, height=vh, spp=16, bounces=2,
                      sky=Sky(*SKY), exposure=0.25)
    s.controller.position = np.asarray(CAMERA[0], np.float32)

    def handle(line: str) -> None:
        _tagged(card, lambda: s.handle(line))

    handle("lookat 12 2 0")
    t0 = time.perf_counter()
    handle("frames 8")
    _require(s.renderer.accumulated_sample_count == 8 and s.renderer.total_rays > 0
             and "Mrays/s" in s.status(), "the viewer's pt frames or readout are wrong")
    handle("renderer deferred")
    s.out_path = outdir / "viewer_deferred.png"
    handle("frames 1")
    handle("w 0.5")
    _require(s.renderer.accumulated_sample_count == 0 and s._deferred.frame_count == 0,
             "a move did not reset both renderers")
    focus = s.controller.focus_distance
    _zero_launches()
    handle(f"pick {vw // 2} {vh // 2}")
    _require(s.controller.focus_distance != focus and _launch_counts()["K1"] == 1,
             "the pick did not set the focus through one K1 launch")
    _zero_launches()
    handle("frames 4")
    _require(s._deferred.frame_count == 4 and _launch_counts() == {"K1": 8, "K2": 8},
             f"four deferred frames: frame count {s._deferred.frame_count}, {_launch_counts()}")
    handle("renderer debug")
    s.out_path = outdir / "viewer_debug.png"
    handle("frames 1")
    handle("renderer pt")
    s.out_path = outdir / "viewer_pt2.png"
    handle("frames 8")
    secs = time.perf_counter() - t0
    pngs = sorted(p.name for p in outdir.glob("viewer_*.png"))
    print(f"viewer script on {scene.num_triangles} triangles at {vw}x{vh}: {secs:.2f} s, focus "
          f"{focus:.3f} -> "
          f"{s.controller.focus_distance:.4f}, PNGs {pngs}; last readout {s.status()} [{card}]",
          flush=True)
    _require(len(pngs) == 4, f"the viewer wrote {pngs}")
    return {"seconds": secs, "focus": s.controller.focus_distance,
            "total_rays": s.renderer.total_rays, "status": s.status()}


def _heat_and_render(scene_pt, pt_path, dev, card: str, outdir: pathlib.Path) -> dict:
    """Phase 10 (d): the BVH heat map at 1280x720 of the slice's .pt
    (bvh_visualizer.visualize, which loads it), K1's node counts equal to
    the plain walk's on the first and the last QUERY_WINDOW rays; then tools/render.py
    on procedural:courtyard:26 at 640x480, 16 spp (default engine, the
    card)."""
    import numpy as np
    import torch

    from rayfinder_tpu_torch.ops.walk import intersect_closest_reference
    from rayfinder_tpu_torch.render.camera import generate_camera_ray
    from rayfinder_tpu_torch.tools import bvh_visualizer, render
    from rayfinder_tpu_torch.utils.image import read_png, write_png

    w, h = HEAT_SIZE
    _zero_launches()
    img, secs = _timed(lambda: bvh_visualizer.visualize(pt_path, w, h, device=dev))
    launches = _launch_counts()
    write_png(outdir / "bvh_heatmap.png", img)
    heat, visits = bvh_visualizer.heat_map(scene_pt, w, h)
    u, v = bvh_visualizer.pixel_uv(w, h)
    camera = bvh_visualizer.heat_camera(scene_pt, w, h)
    same = {}
    windows = {"head": slice(0, QUERY_WINDOW), "tail": slice(w * h - QUERY_WINDOW, w * h)}
    for side, win in windows.items():
        o, d = generate_camera_ray(camera, torch.from_numpy(u[win]).to(dev),
                                   torch.from_numpy(v[win]).to(dev))
        t_max = o.new_full((o.shape[0],), float(np.finfo(np.float32).max))
        plain = intersect_closest_reference(scene_pt, o, d, t_max)[3]
        same[side] = bool(torch.equal(visits[win], plain))
    print(f"BVH heat map {w}x{h} of {pt_path.name}: {secs:.3f} s (the .pt load included), K1 "
          f"launches {launches}, mean nodes/ray {float(visits.float().mean()):.2f}; K1's node "
          f"counts at {w * h} rays == plain walk's on the first and the last {QUERY_WINDOW}: "
          f"{same} [{card}]", flush=True)
    _require(all(same.values()) and np.array_equal(img, heat) and launches["K1"] == 1,
             "the heat map's node counts differ from the plain walk's")
    out = outdir / "render_tool.png"
    (rw, rh), spp = RENDER_TOOL["size"], RENDER_TOOL["spp"]
    argv = [RENDER_TOOL["scene"], "-o", str(out), "--width", str(rw), "--height", str(rh),
            "--spp", str(spp)]
    _, render_s = _timed(lambda: _tagged(card, lambda: render.main(argv)))
    rendered = read_png(out)
    print(f"tools/render.py {RENDER_TOOL['scene']} {rw}x{rh} {spp} spp: {render_s:.2f} s (scene "
          f"build included), PNG {rendered.shape}, mean {float(rendered.mean()):.1f} [{card}]",
          flush=True)
    _require(rendered.shape == (rh, rw, 3) and 0 < rendered.mean() < 255,
             "the render tool's image is not right")
    return {"heat_seconds": secs, "heat_launches": launches, "render_seconds": render_s}


# Phase 11: the wavefront engine, the sorted fused loop and the sharded
# renders over torch.distributed.
# The gloo meshes' image (courtyard_scene(8)), spp of their regen render and
# of the 2x2 scan form; the 1x1 nccl render at full width; the A/B's rounds.
MESH_IMAGE = dict(width=128, height=96, num_bounces=4)
MESH_REGEN_SPP = 16
MESH_SCAN_SPP = 4
GLOO_MESHES = ((2, 1), (1, 2), (2, 2))
SHARDED_HD = dict(width=1920, height=1080, spp=16, num_bounces=4)
AB_ROUNDS = 3
# Rays on which the wavefront engine and K1/K2 may differ, each side's slab
# test pruning by an ulp a box the other enters, or equal-t hits met in
# another order (_wavefront_check): at most this share of phase 2's rays.
WAVEFRONT_EXCEPTIONS = 5e-4
# The 2x2 scan form's image on K1/K2 against the same on the wavefront
# engine: phase 9's budget for one set of samples through two walks.
SCAN_ENGINES_RMSE = 1e-3


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _wavefront_check(scene, camera, dev, card: str) -> dict:
    """Phase 11 (a): the wavefront engine (render/wavefront.py, torch code)
    against K1/K2 on phase 2's 262,144 camera and random rays over the
    slice's scene. t, tri and occlusion must be equal but on three kinds of
    ray, each counted and printed: a hit nearer by at most a relative 1e-6
    (the stack walk's slab test pruned that triangle's leaf box by an ulp:
    ROADMAP.md section 3, flat_courtyard8 ray 6); a hit farther by at most a
    relative 1e-6 where the cluster box that holds K1's triangle is entered
    no nearer than the wavefront's hit (its entry rounds an ulp above its
    own triangle's t, so the walk prunes it); another triangle at an equal t
    (equal-t hits met in another order). Together at most
    WAVEFRONT_EXCEPTIONS of the rays. Also prints the escalations and the
    wavefront's wall time."""
    import torch

    from rayfinder_tpu_torch.ops.walk import intersect_any_kernel, intersect_closest_kernel
    from rayfinder_tpu_torch.render.intersect import T_MAX
    from rayfinder_tpu_torch.render.pathtracer import triangle_clusters
    from rayfinder_tpu_torch.render.wavefront import (
        _slab_entry, intersect_any_wavefront, intersect_closest_wavefront,
    )

    o, d = _rays(camera, 131072, 131072, seed=0, dev=dev)
    n = o.shape[0]
    t_dev = torch.full((n,), T_MAX, device=dev)
    _, kt, ktri, _ = intersect_closest_kernel(scene, o, d, t_dev)
    kocc = intersect_any_kernel(scene, o, d, t_dev)
    (_, wt, wtri, esc_closest), closest_s = _timed(
        lambda: intersect_closest_wavefront(scene, o, d, T_MAX))
    (wocc, esc_any), any_s = _timed(lambda: intersect_any_wavefront(scene, o, d, T_MAX))
    closer = wt < kt
    tie = (wt == kt) & (wtri != ktri)
    farther = torch.nonzero(wt > kt)[:, 0]
    cluster = triangle_clusters(scene)[ktri[farther].long()].long()
    inv = 1.0 / d[farther]
    box_hit, box_entry = _slab_entry(o[farther], inv, inv < 0.0, scene.cluster_min[cluster],
                                     scene.cluster_max[cluster], t_dev[farther])
    pruned = ~box_hit | (box_entry >= wt[farther])
    occ_more, occ_less = wocc & ~kocc, kocc & ~wocc
    rel = float(((kt - wt) / kt)[closer].max()) if bool(closer.any()) else 0.0
    rel_far = float(((wt - kt) / kt)[farther].max()) if farther.numel() else 0.0
    out = dict(rays=n, closer=int(closer.sum()), equal_t_other_tri=int(tie.sum()),
               farther=int(farther.numel()), farther_cluster_pruned=int(pruned.sum()),
               max_rel_farther=rel_far,
               occluded_only_by_wavefront=int(occ_more.sum()),
               occluded_only_by_k2=int(occ_less.sum()), max_rel_closer=rel,
               escalated_closest=int(esc_closest), escalated_any=int(esc_any),
               closest_s=closest_s, any_s=any_s, card=card)
    print(f"wavefront vs K1/K2 on {n} rays: t/tri/occ equal but for {out['closer']} rays "
          f"nearer by <= {rel:.2e} (relative; first {torch.nonzero(closer)[:8, 0].tolist()}), "
          f"{out['farther']} farther by <= {rel_far:.2e} (K1's triangle's cluster entered no "
          f"nearer than the wavefront's hit on {out['farther_cluster_pruned']}; first "
          f"{farther[:8].tolist()}), "
          f"{out['equal_t_other_tri']} with another triangle at an equal t; occlusion "
          f"{out['occluded_only_by_wavefront']} only by the wavefront, "
          f"{out['occluded_only_by_k2']} only by K2; escalated {int(esc_closest)} (closest), "
          f"{int(esc_any)} (any); wavefront {closest_s:.3f} s (closest), {any_s:.3f} s (any) "
          f"[{card}]", flush=True)
    _require(out["farther_cluster_pruned"] == out["farther"],
             "the wavefront engine missed a hit in a cluster entered before its own")
    _require(max(rel, rel_far) <= 1e-6,
             f"the wavefront engine's hits differ by {max(rel, rel_far):.2e}")
    exceptions = sum(out[k] for k in ("closer", "farther", "equal_t_other_tri",
                                      "occluded_only_by_wavefront", "occluded_only_by_k2"))
    _require(exceptions <= WAVEFRONT_EXCEPTIONS * n,
             f"the wavefront engine differs from K1/K2 on {exceptions} of {n} rays")
    return out


def _median(xs) -> float:
    xs = sorted(xs)
    return xs[len(xs) // 2]


def _k3_device_ms(fn) -> tuple[float, float, float]:
    """(K3's device time, all kernels' device time, wall) in ms of one fn()
    under torch.profiler, from its device events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, wall = _timed(fn)
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    k3 = sum(e.device_time_total for e in events if "trace_regen_kernel" in e.key)
    return k3 * 1e-3, sum(e.device_time_total for e in events) * 1e-3, wall * 1e3


def _sorted_ab(scene, sky, camera, tile, dev, card: str) -> dict:
    """Phase 11 (b): the split route sorted (the "dir" key every iteration)
    against unsorted on the slice. From a zero accumulator (samples 0-15)
    the two must be equal bit for bit with equal ray counts; from there,
    samples 16-31 must count SLICE_RAYS on both. Then the A/B: AB_ROUNDS
    dispatches of samples 16-31 each, in turns, for the wall time, and as
    many under torch.profiler for K3's device time per dispatch. Sorting
    stays the default on big scenes only if both medians favour it."""
    import torch

    from rayfinder_tpu_torch.ops.regen import trace_regen
    from rayfinder_tpu_torch.render.pathtracer import accumulate_samples_regen

    w, h, nf = SLICE["width"], SLICE["height"], SLICE["num_frames"]
    kw = dict(width=w, height=h, num_bounces=SLICE["num_bounces"], spp=SLICE["spp"],
              num_frames=nf, engine="kernel", count_rays=True, inkernel=False)
    zeros = torch.zeros(w * h, 3, device=dev)

    def dispatch(base, accum, sort):
        return accumulate_samples_regen(scene, sky, camera, tile, base, accum, sort=sort, **kw)

    first, launches, rays = {}, {}, {}
    for sort in (False, True):
        first[sort], _ = dispatch(0, zeros, sort)
    _require(torch.equal(first[False], first[True]),
             "sorted and unsorted differ from a zero accumulator")
    second = {}
    for sort in (False, True):
        trace_regen.launches = 0
        (second[sort], r), secs = _timed(lambda: dispatch(nf, first[False], sort))
        launches[sort], rays[sort] = trace_regen.launches, r.tolist()
        _require(rays[sort] == SLICE_RAYS, f"sort={sort}: {rays[sort]} rays, expected {SLICE_RAYS}")
    diff = float((second[True] - second[False]).abs().max())
    print(f"split route on the slice, samples 0-15 from zero: sorted == unsorted bit for bit; "
          f"samples 16-31: rays {rays[True]} both, K3 launches sorted {launches[True]} / unsorted "
          f"{launches[False]}, max |sorted - unsorted| {diff:.3e} [{card}]", flush=True)
    _require(bool(torch.allclose(second[True], second[False], rtol=1e-5, atol=1e-5)),
             "sorted and unsorted differ from a warm accumulator")
    wall = {False: [], True: []}
    for _ in range(AB_ROUNDS):
        for sort in (False, True):
            _, secs = _timed(lambda: dispatch(nf, first[False], sort))
            wall[sort].append(secs * 1e3)
    k3 = {False: [], True: []}
    busy = {False: [], True: []}
    for _ in range(AB_ROUNDS):
        for sort in (False, True):
            k3_ms, device_ms, wall_ms = _k3_device_ms(lambda: dispatch(nf, first[False], sort))
            k3[sort].append(k3_ms)
            busy[sort].append((device_ms, wall_ms))
    out = dict(launches={"sorted": launches[True], "unsorted": launches[False]},
               rays=rays[True], max_abs_diff_warm=diff,
               wall_ms={"sorted": wall[True], "unsorted": wall[False]},
               k3_ms={"sorted": k3[True], "unsorted": k3[False]},
               profiled_device_wall_ms={"sorted": busy[True], "unsorted": busy[False]},
               card=card)
    favours = dict(wall=_median(wall[True]) < _median(wall[False]),
                   k3=_median(k3[True]) < _median(k3[False]))
    out["sort_favoured"] = favours
    for name, xs in (("wall ms", wall), ("K3 device ms (profiler)", k3)):
        print(f"A/B in turns, {name} per dispatch of samples 16-31: unsorted "
              f"{', '.join(f'{x:.3f}' for x in xs[False])} (median {_median(xs[False]):.3f}); "
              f"sorted {', '.join(f'{x:.3f}' for x in xs[True])} (median "
              f"{_median(xs[True]):.3f}) [{card}]", flush=True)
    print(f"profiled dispatches [device ms, wall ms]: unsorted {busy[False]}, sorted "
          f"{busy[True]}; the medians favour sorting on wall: {favours['wall']}, on K3: "
          f"{favours['k3']} (the split route sorts by default only if both do; it does "
          f"not) [{card}]", flush=True)
    return out


def _mesh_worker(rank: int, world: int, port: int, samples: int, outdir: str) -> None:
    """One rank of a gloo mesh on the card (torch.multiprocessing.spawn):
    courtyard_scene(8) at MESH_IMAGE through render_image_sharded_regen
    (the default route per shard; its K4 launches counted), and on a 2x2
    mesh also render_image_sharded with "kernel" (K1/K2 launches counted)
    and "wavefront". Writes rank{rank}.npz into outdir."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from rayfinder_tpu_torch.ops.regen_shaded import trace_regen_shaded
    from rayfinder_tpu_torch.parallel.sharding import (
        make_render_mesh, render_image_sharded, render_image_sharded_regen,
    )
    from rayfinder_tpu_torch.render.camera import create_camera
    from rayfinder_tpu_torch.render.scene import build_device_scene
    from rayfinder_tpu_torch.scene.procedural import courtyard_scene
    from rayfinder_tpu_torch.sky.model import sky_state_from_ui

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world)
    mesh = make_render_mesh(sample_parallel=samples, device="cuda:0")
    flat, textures = courtyard_scene(8)
    scene = build_device_scene(flat, textures=textures, device=mesh.device)
    w, h, nb = MESH_IMAGE["width"], MESH_IMAGE["height"], MESH_IMAGE["num_bounces"]
    cam, sky = create_camera(*CAMERA, w / h), sky_state_from_ui(*SKY)
    kw = dict(mesh=mesh, width=w, height=h, num_bounces=nb, exposure=0.25)
    trace_regen_shaded.launches = 0
    out = dict(regen=render_image_sharded_regen(scene, sky, cam, spp=MESH_REGEN_SPP, **kw),
               k4=trace_regen_shaded.launches, shape=[mesh.shape["tiles"], mesh.shape["samples"]],
               ranks=[mesh.tile_rank, mesh.sample_rank])
    if (mesh.shape["tiles"], mesh.shape["samples"]) == (2, 2):
        from rayfinder_tpu_torch.ops.walk import intersect_any_kernel, intersect_closest_kernel

        for engine in ("kernel", "wavefront"):
            intersect_closest_kernel.launches = intersect_any_kernel.launches = 0
            out[engine] = render_image_sharded(scene, sky, cam, spp=MESH_SCAN_SPP, engine=engine,
                                               **kw)
            out[f"{engine}_k1_k2"] = [intersect_closest_kernel.launches,
                                      intersect_any_kernel.launches]
    np.savez(pathlib.Path(outdir) / f"rank{rank}.npz", **out)
    dist.destroy_process_group()


def _nccl_refusal_worker(rank: int, world: int, port: int) -> None:
    """One of two ranks asking for nccl on the same card: make_render_mesh
    must raise, naming the card, before any NCCL communicator is made."""
    import torch.distributed as dist

    from rayfinder_tpu_torch.parallel.sharding import make_render_mesh

    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world)
    make_render_mesh(device="cuda:0")


def _record_k4(fn) -> tuple:
    """fn() with the fused loop's K4 calls on the "kernel" engine recorded:
    (fn's result, (the last call's arguments, copied before its launch, and
    its outputs))."""
    import torch

    from rayfinder_tpu_torch.render import pathtracer as pt

    kernels = pt._ENGINES["kernel"]
    last = []

    def shaded(*args):
        saved = tuple(a.clone() if isinstance(a, torch.Tensor) else a for a in args)
        out = kernels.shaded(*args)
        last[:] = [(saved, out)]
        return out

    pt._ENGINES["kernel"] = kernels._replace(shaded=shaded)
    try:
        result = fn()
    finally:
        pt._ENGINES["kernel"] = kernels
    return result, last[0]


def _k4_windows(call, card: str) -> dict:
    """A recorded floor-0 K4 call of the sharded render held to its plain
    version (trace_regen_shaded_reference) on its first and its last
    QUERY_WINDOW lanes, with _hold's budget per window. At floor 0 no lane
    depends on another, so one plain run takes both windows' lanes."""
    import torch

    from rayfinder_tpu_torch.ops.regen_shaded import trace_regen_shaded_reference

    args, k_out = call
    n, floor, frame_base, nf = args[3].shape[0], args[11], args[7], args[9]
    _require(floor == 0 and n >= 2 * QUERY_WINDOW,
             f"the recorded K4 call has floor {floor} and {n} lanes")
    rows = torch.cat([torch.arange(QUERY_WINDOW), torch.arange(n - QUERY_WINDOW, n)])
    rows = rows.to(args[3].device)
    sub = tuple(a[rows] if isinstance(a, torch.Tensor) and a.dim() and a.shape[0] == n else a
                for a in args)
    p_out, plain_s = _timed(lambda: trace_regen_shaded_reference(*sub))
    print(f"K4 call of the 1x1 sharded render recorded: {n} lanes at floor 0, samples "
          f"{frame_base}-{frame_base + nf - 1}, rays {k_out[-1].tolist()}; its outputs against "
          f"the plain version on the first and the last {QUERY_WINDOW} lanes (plain "
          f"{plain_s:.1f} s for both) [{card}]", flush=True)
    errs = {}
    for i, name in enumerate(("head", "tail")):
        win = slice(i * QUERY_WINDOW, (i + 1) * QUERY_WINDOW)
        errs[name] = _hold(f"K4 sharded 1080p {name}", K4_OUTPUTS,
                           [o[rows][win] for o in k_out[:len(K4_OUTPUTS)]],
                           [o[win] for o in p_out[:len(K4_OUTPUTS)]],
                           ("sample", "bounce", "flag"), card)
    return dict(lanes=n, frame_base=frame_base, num_frames=nf, plain_s=plain_s,
                max_abs_err=errs)


def _sharded(scene26, sky, dev, card: str) -> dict:
    """Phase 11 (c, d, e): render_image_sharded_regen on a 1x1 nccl mesh at
    SHARDED_HD on the slice's scene, bit for bit the unsharded render_image
    (one dispatch of 16 samples) with the same K4 launches, and its last K4
    call held to plain on both ends (_k4_windows); the 1x1 images
    of courtyard_scene(8) at MESH_IMAGE (regen, and the scan form with
    "kernel" and "wavefront"); then each of GLOO_MESHES as that many gloo
    processes sharing the card, against the 1x1 images (RMSE < 1e-6, every
    rank the same image), the K4 launches per shard and the 2x2 scan form's
    K1/K2 launches per rank, its K1/K2 image within SCAN_ENGINES_RMSE of its
    wavefront image; then tools/render.py --mesh 2x1 --backend gloo
    under torch.distributed.run; and two nccl ranks on the one card,
    which make_render_mesh must refuse."""
    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    from rayfinder_tpu_torch.ops.regen_shaded import trace_regen_shaded
    from rayfinder_tpu_torch.parallel.sharding import (
        make_render_mesh, render_image_sharded, render_image_sharded_regen,
    )
    from rayfinder_tpu_torch.render.camera import create_camera
    from rayfinder_tpu_torch.render.pathtracer import SamplingParams, render_image
    from rayfinder_tpu_torch.render.scene import build_device_scene
    from rayfinder_tpu_torch.scene.procedural import courtyard_scene
    from rayfinder_tpu_torch.utils.image import read_png

    out = {"card": card}
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{_free_port()}", rank=0,
                            world_size=1)
    mesh = make_render_mesh(device=dev)
    _require(mesh.shape == {"tiles": 1, "samples": 1}, f"a world of 1 gave the mesh {mesh.shape}")
    hw, hh, spp, nb = (SHARDED_HD[k] for k in ("width", "height", "spp", "num_bounces"))
    cam = create_camera(*CAMERA, hw / hh)
    renders = {
        "sharded": lambda: render_image_sharded_regen(
            scene26, sky, cam, mesh=mesh, width=hw, height=hh, spp=spp, num_bounces=nb,
            exposure=0.25),
        "single": lambda: render_image(
            scene26, sky, cam, width=hw, height=hh, sampling=SamplingParams(spp, nb),
            exposure=0.25, samples_per_dispatch=spp),
    }
    images, k4, secs = {}, {}, {"sharded": [], "single": []}
    for _ in range(2):  # in turns; the first pair warms the allocator up
        for name, fn in renders.items():
            trace_regen_shaded.launches = 0
            images[name], s = _timed(fn)
            k4[name] = trace_regen_shaded.launches
            secs[name].append(s)
    same = bool(np.array_equal(images["sharded"], images["single"]))
    out["hd"] = dict(seconds=secs["sharded"], unsharded_seconds=secs["single"],
                     k4=k4["sharded"], k4_unsharded=k4["single"], equal=same)
    print(f"render_image_sharded_regen 1x1 nccl, slice scene {hw}x{hh} {spp} spp {nb} bounces: "
          f"{', '.join(f'{x:.4f}' for x in secs['sharded'])} s, K4 {k4['sharded']} launches; "
          f"render_image {', '.join(f'{x:.4f}' for x in secs['single'])} s, K4 {k4['single']} "
          f"(in turns); bit for bit equal: {same} [{card}]", flush=True)
    k4_sharded, k4_single = k4["sharded"], k4["single"]
    _require(same and k4_sharded == k4_single > 0,
             "the 1x1 sharded render differs from render_image")
    # The shard's own K4 calls held to plain: the last one, recorded in one
    # more render, which must give the same image.
    recorded, call = _record_k4(renders["sharded"])
    _require(bool(np.array_equal(recorded, images["sharded"])),
             "the recorded sharded render differs from the timed one")
    out["hd"]["k4_windows"] = _k4_windows(call, card)

    flat8, tex8 = courtyard_scene(8)
    scene8 = build_device_scene(flat8, textures=tex8, device=dev)
    w, h = MESH_IMAGE["width"], MESH_IMAGE["height"]
    cam8 = create_camera(*CAMERA, w / h)
    kw = dict(mesh=mesh, width=w, height=h, num_bounces=MESH_IMAGE["num_bounces"], exposure=0.25)
    ref = {"regen": render_image_sharded_regen(scene8, sky, cam8, spp=MESH_REGEN_SPP, **kw)}
    for engine in ("kernel", "wavefront"):
        ref[engine] = render_image_sharded(scene8, sky, cam8, spp=MESH_SCAN_SPP, engine=engine,
                                           **kw)
    dist.destroy_process_group()
    for name, img in ref.items():
        _require(bool(np.isfinite(img).all()) and img.shape == (h, w, 3),
                 f"the 1x1 {name} image is not finite of shape {(h, w, 3)}")

    out["meshes"] = {}
    for tiles, samples in GLOO_MESHES:
        world = tiles * samples
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            mp.spawn(_mesh_worker, args=(world, _free_port(), samples, tmp), nprocs=world)
            spawn_s = time.perf_counter() - t0
            ranks = [dict(np.load(pathlib.Path(tmp) / f"rank{r}.npz")) for r in range(world)]
        label = f"{tiles}x{samples}"
        entry = dict(seconds=spawn_s, k4_per_rank=[int(r["k4"]) for r in ranks])
        for r, rank in enumerate(ranks):
            _require(list(rank["shape"]) == [tiles, samples]
                     and list(rank["ranks"]) == [r // samples, r % samples],
                     f"mesh {label}: rank {r} has shape {rank['shape']}, place {rank['ranks']}")
        for name in [k for k in ("regen", "kernel", "wavefront") if k in ranks[0]]:
            for r, rank in enumerate(ranks[1:], 1):
                _require(np.array_equal(rank[name], ranks[0][name]),
                         f"mesh {label}: rank {r}'s {name} image differs from rank 0's")
            err = _rmse(ranks[0][name], ref[name])
            entry[f"{name}_rmse"] = err
            entry[f"{name}_max_abs"] = float(np.abs(ranks[0][name] - ref[name]).max())
            _require(err < 1e-6, f"mesh {label}: the {name} image differs from the 1x1 image "
                     f"(RMSE {err:.3e})")
        if "kernel" in ranks[0]:
            entry["scan_k1_k2_per_rank"] = [rank["kernel_k1_k2"].tolist() for rank in ranks]
            entry["wavefront_k1_k2_per_rank"] = [rank["wavefront_k1_k2"].tolist() for rank in ranks]
            steps = MESH_SCAN_SPP // samples
            _require(all(k == [steps * MESH_IMAGE["num_bounces"]] * 2
                         for k in entry["scan_k1_k2_per_rank"]),
                     f"mesh {label}: the scan form launched K1/K2 {entry['scan_k1_k2_per_rank']}")
            _require(all(k == [0, 0] for k in entry["wavefront_k1_k2_per_rank"]),
                     f"mesh {label}: the wavefront engine launched K1/K2")
            # K1/K2's image against the wavefront's, which walks no BVH:
            # the same samples through two walks.
            diff = np.abs(ranks[0]["kernel"] - ranks[0]["wavefront"])
            entry["kernel_vs_wavefront_rmse"] = err = _rmse(ranks[0]["kernel"],
                                                            ranks[0]["wavefront"])
            entry["kernel_vs_wavefront_max_abs"] = float(diff.max())
            entry["kernel_vs_wavefront_pixels"] = int((diff.max(axis=-1) > 0).sum())
            _require(err < SCAN_ENGINES_RMSE, f"mesh {label}: the scan form's kernel image is "
                     f"RMSE {err:.3e} from its wavefront image")
        _require(all(k == 1 for k in entry["k4_per_rank"]),
                 f"mesh {label}: K4 launches per shard {entry['k4_per_rank']}, expected 1")
        out["meshes"][label] = entry
        print(f"gloo mesh {label} ({world} processes on the card), courtyard_scene(8) {w}x{h}: "
              f"{spawn_s:.1f} s with start-up; K4 launches per shard {entry['k4_per_rank']}; "
              + ", ".join(f"{k} {v:.3e}" for k, v in entry.items() if k.endswith(("_rmse", "_max_abs")))
              + (f"; scan form K1/K2 per rank {entry['scan_k1_k2_per_rank']}, pixels where "
               f"kernel and wavefront differ {entry['kernel_vs_wavefront_pixels']}"
               if "scan_k1_k2_per_rank" in entry else "") + f" [{card}]", flush=True)

    refused = ""
    try:
        mp.spawn(_nccl_refusal_worker, args=(2, _free_port()), nprocs=2)
    except mp.ProcessRaisedException as err:
        refused = str(err)
    out["nccl_two_ranks_one_card"] = refused.strip().splitlines()[-1] if refused else ""
    print(f"nccl with two ranks on the card: {out['nccl_two_ranks_one_card'] or 'not refused'} "
          f"[{card}]", flush=True)
    _require("takes one rank per card" in refused and torch.cuda.get_device_name(0) in refused,
             "nccl with two ranks on one card was not refused, naming the card")

    with tempfile.TemporaryDirectory() as tmp:
        png = pathlib.Path(tmp) / "mesh.png"
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc-per-node", "2", "-m", "rayfinder_tpu_torch.tools.render",
               "procedural:courtyard:8", "-o", str(png), "--mesh", "2x1", "--backend", "gloo",
               "--width", str(w), "--height", str(h), "--spp", "4"]
        t0 = time.perf_counter()
        done = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600)
        tool_s = time.perf_counter() - t0
        for line in done.stdout.strip().splitlines():
            print(f"  {line} [{card}]", flush=True)
        _require(done.returncode == 0, f"tools/render.py --mesh 2x1 failed: {done.stderr[-2000:]}")
        img = read_png(png)
        _require(img.shape == (h, w, 3), f"tools/render.py --mesh wrote an image of {img.shape}")
    out["tool_seconds"] = tool_s
    print(f"tools/render.py --mesh 2x1 --backend gloo under torch.distributed.run: {tool_s:.1f} s "
          f"with start-up, PNG {w}x{h} [{card}]", flush=True)
    return out


def _phase11(scene26, sky, camera, tile, dev, card: str) -> dict:
    t0 = time.perf_counter()
    numbers = {
        "wavefront": _wavefront_check(scene26, camera, dev, card),
        "sorted": _sorted_ab(scene26, sky, camera, tile, dev, card),
        "sharded": _sharded(scene26, sky, dev, card),
    }
    numbers["seconds"] = time.perf_counter() - t0
    print(f"phase 11: {numbers['seconds']:.1f} s", flush=True)
    return numbers


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel-times", action="store_true",
                    help="phases 1, 2, 5's instrumented dispatches, 6 and 8 only")
    args = ap.parse_args(argv)
    full = not args.kernel_times

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)", file=sys.stderr)
        return 1
    _require((ROOT / "rayfinder_tpu_torch").is_dir(), f"no rayfinder_tpu_torch beside {__file__}")
    sys.path.insert(0, str(ROOT))

    import numpy as np

    from rayfinder_tpu_torch.render.camera import create_camera
    from rayfinder_tpu_torch.render.rng import blue_noise_tile
    from rayfinder_tpu_torch.render.scene import build_device_scene
    from rayfinder_tpu_torch.scene.procedural import courtyard_scene
    from rayfinder_tpu_torch.sky.model import sky_state_from_ui

    dev = torch.device("cuda", 0)
    card = _card()
    print(f"card: {card} | torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    # --- 1. build -----------------------------------------------------------
    t_start = time.perf_counter()
    ptxas = _build_report()
    L2_RATE["bytes_per_s"], l2_passes = _l2_rate(dev)
    print("data held in L2 moves at " + ", ".join(f"{v:.3f} TB/s ({k})" for k, v in
                                                   l2_passes.items())
          + f": the L2 rate is the fastest [{card}]", flush=True)

    sky = sky_state_from_ui(*SKY)
    tile = torch.from_numpy(blue_noise_tile()).to(dev)

    # --- 2. K1/K2: goldens and 262,144 rays over the big courtyard -----------
    if full:
        flat8, tex8 = courtyard_scene(8, textured=False)
        scene8 = build_device_scene(flat8, textures=tex8, device=dev)
        for name, need in (("grouped_courtyard8", 256), ("flat_courtyard8", 255)):
            g = np.load(GOLDENS / f"{name}.npz")
            o = torch.from_numpy(g["origins"]).to(dev)
            d = torch.from_numpy(g["directions"]).to(dev)
            r = _check_walks(scene8, o, d, name)
            agree = (
                (r["t"].cpu().numpy() == g["t"]) & (r["tri"].cpu().numpy() == g["tri"])
                & (r["occ"].cpu().numpy() == g["occ"].astype(bool))
            )
            print(f"golden {name}: {int(agree.sum())}/{agree.size} rays agree; differ: "
                  f"{np.nonzero(~agree)[0].tolist()}", flush=True)
            _require(int(agree.sum()) >= need, f"{name}: fewer than {need} rays agree")

    t0 = time.perf_counter()
    flat26, tex26 = courtyard_scene(26, textured=False)
    scene26 = build_device_scene(flat26, textures=tex26, device=dev)
    print(f"courtyard_scene(26): {scene26.num_triangles} triangles, {scene26.num_nodes} "
          f"nodes, built in {time.perf_counter() - t0:.1f} s; SoA node planes "
          f"{_scene_bytes(scene26, NODE_PLANES)} bytes, tri_positions "
          f"{_nbytes(scene26.tri_positions)} bytes; a walk must read {_walk_bytes(scene26)} "
          f"bytes", flush=True)
    if full:
        print(f"  packed walk tables: bvh_nodes2 {tuple(scene26.bvh_nodes2.shape)} "
              f"{_nbytes(scene26.bvh_nodes2)} bytes, tri_pos4 {tuple(scene26.tri_pos4.shape)} "
              f"{_nbytes(scene26.tri_pos4)} bytes", flush=True)
        print(f"  cluster tables: {scene26.num_clusters} clusters, cluster_tris "
              f"{tuple(scene26.cluster_tris.shape)} {_nbytes(scene26.cluster_tris)} bytes, all "
              f"five {_scene_bytes(scene26, CLUSTER_TABLES)} bytes", flush=True)
    camera = create_camera(*CAMERA, SLICE["width"] / SLICE["height"])
    walk_entries = _ray_queries(scene26, camera, dev, card)

    launches, slice_numbers, textured_numbers, scan_numbers = {}, {}, {}, {}
    if full:
        # --- 3. small render: kernels vs plain vs the JAX-baked golden ------
        # The default route (one K4 call) through the kernel and its plain
        # version, and the split, hybrid in-kernel and segs routes through
        # their kernels; every route counts its own rays.
        _render_routes(scene8, sky, tile, dev, "render", np.load(
            GOLDENS / "courtyard_untextured_128x96_8spp.npz"), {
                "default": dict(engine="kernel", count_rays=True),
                "default plain": dict(engine="plain", count_rays=True),
                "split": dict(engine="kernel", inkernel=False, count_rays=True),
                "split plain": dict(engine="plain", inkernel=False, count_rays=True),
                "inkernel hybrid": dict(engine="kernel", inkernel=True, compact_floor=1024,
                                        count_rays=True),
                "segs2": dict(engine="kernel", segs=2, count_rays=True),
            })

        # --- 3b. the textured courtyard, built without Pillow ---------------
        flat8t, tex8t = courtyard_scene(8, textured=True)
        scene8t = build_device_scene(flat8t, textures=tex8t, device=dev)
        _render_routes(scene8t, sky, tile, dev, "textured render", np.load(
            GOLDENS / "courtyard_textured_128x96_8spp.npz"), {
                "default": dict(engine="kernel", count_rays=True),
                "split": dict(engine="kernel", inkernel=False, count_rays=True),
                "inkernel hybrid": dict(engine="kernel", inkernel=True, compact_floor=1024,
                                        count_rays=True),
                "segs2": dict(engine="kernel", segs=2, count_rays=True),
                "default plain": dict(engine="plain", count_rays=True),
            })

        # --- 4, 5. the slice: courtyard_scene(26), 512x512, 4 bounces --------
        # The main path is the default route: accumulate_samples_regen with
        # no route keyword, one K4 call per dispatch, counting its own rays.
        # Then every other route the same way, and all of them in turns.
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        slice_numbers = _route_ab(scene26, sky, camera, tile, dev, card, "slice courtyard26")
        slice_numbers["peak_bytes"] = torch.cuda.max_memory_allocated()
        print(f"slice peak memory {slice_numbers['peak_bytes'] / 2**20:.1f} MiB", flush=True)
        _require(slice_numbers["rays"]["default"] == SLICE_RAYS,
                 f"the slice's timed dispatch counts {slice_numbers['rays']['default']}, "
                 f"expected {SLICE_RAYS}")
        route_launches = slice_numbers["launches"]
        launches = {"K3": route_launches["split"]["K3"],
                    "K4": route_launches["inkernel_hybrid"]["K4"],
                    "K5": route_launches["segs2"]["K5"],
                    "K4 one call": route_launches["default"]["K4"]}
        slice_numbers["capped"] = _capped_dispatch(scene26, sky, camera, tile, dev, card)
        slice_numbers["hybrid_capped"] = _hybrid_capped(scene26, sky, camera, tile, dev, card)

        # --- 5b. the routes on the textured courtyard at the slice's size ---
        t0 = time.perf_counter()
        flat26t, tex26t = courtyard_scene(26, textured=True)
        scene26t = build_device_scene(flat26t, textures=tex26t, device=dev)
        print(f"courtyard_scene(26, textured): {scene26t.num_triangles} triangles, "
              f"{len(tex26t)} textures, {_nbytes(scene26t.texels)} bytes of texels, built in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        textured_numbers = _route_ab(scene26t, sky, camera, tile, dev, card,
                                     "textured courtyard26")
        del scene26t

        # --- 9. the scan integrator, the unfused loop and the Renderer ------
        # Their main path is the scan form on the slice (64 K1 and 64 K2 per
        # 16-sample dispatch); the unfused loop launches both once per
        # iteration. Then the Renderer and 1080p.
        t0 = time.perf_counter()
        scan_numbers = {
            "render": _scan_renders(scene8, sky, tile, dev, "render", np.load(
                GOLDENS / "courtyard_untextured_128x96_8spp.npz"), card, plain=True),
            "textured_render": _scan_renders(scene8t, sky, tile, dev, "textured render", np.load(
                GOLDENS / "courtyard_textured_128x96_8spp.npz"), card, plain=False),
            "queries": _scan_query_check(scene26, sky, camera, tile, dev, card),
            "slice": _scan_slice(scene26, sky, camera, tile, dev, card),
            "renderer": _renderer_check(scene26, camera, dev, card),
            "full_hd": _full_hd(scene26, sky, tile, dev, card),
        }
        scan_numbers["seconds"] = time.perf_counter() - t0
        print(f"phase 9: {scan_numbers['seconds']:.1f} s", flush=True)
        for entry, key in zip(walk_entries, ("K1", "K2")):
            slice_launches = scan_numbers["slice"]["launches"]
            entry["launches_by_path"] = {
                "phase 2 ray queries": entry["launches"],
                "phase 9 scan form, slice dispatch": slice_launches["scan"][key],
                "phase 9 unfused loop, slice dispatch": slice_launches["unfused"][key],
            }
            entry["launches"] = slice_launches["scan"][key]
            entry["path"] = "phase 9 scan form, slice dispatch"
            entry["ms_scan_bounce2"] = scan_numbers["queries"][f"{key.lower()}_ms"]
            entry["bound_ms_scan_bounce2"] = scan_numbers["queries"][f"{key.lower()}_bound_ms"]

    # K3, K5 and K4 per dispatch: one instrumented dispatch per route.
    by_width = _dispatch_kernel_times(scene26, sky, camera, tile, dev, card)

    # --- 6. each path kernel against its plain version at slice shapes ------
    path_entries = _path_kernels(scene26, camera, sky, tile, dev, card, launches)

    # --- 7. the traversal-efficiency path: K6 and K7 -----------------------
    # (--kernel-times: K6 beside K1, and K7, on the built courtyard.)
    eff_entries, efficiency, scene_pt = _efficiency(dev, card) if full else (
        [_k6_on_built_scene(scene26, camera, dev, card),
         _k7_on_built_scene(scene26, camera, dev, card)], {}, scene26)

    # --- 8. the probes: K7 at the TPU probe's shapes, K8 ---------------------
    k8_entry, probes = _probes(dev, card, scene_pt)

    deferred_numbers = {}
    if full:
        # --- 10. the deferred renderer and the interactive layer -----------
        # Its main path is the 1080p deferred frame on the slice's scene: two
        # K1 and two K2 launches per frame, counted over the timed frames.
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp:
            outdir = pathlib.Path(tmp)
            deferred_numbers = {
                "small": _deferred_small({"untextured": scene8, "textured": scene8t}, dev, card),
                "full_hd": _deferred_full_hd(scene26, dev, card),
                "viewer": _viewer_check(scene26, dev, card, outdir),
                "tools": _heat_and_render(scene_pt, pathlib.Path(efficiency["pt_path"]), dev,
                                          card, outdir),
            }
        deferred_numbers["seconds"] = time.perf_counter() - t0
        print(f"phase 10: {deferred_numbers['seconds']:.1f} s", flush=True)
        hd = deferred_numbers["full_hd"]
        for entry, key in zip(walk_entries, ("K1", "K2")):
            path = f"phase 10 deferred 1920x1080, {DEFERRED_HD['timed_frames']} timed frames"
            entry["launches_by_path"][path] = hd["launches"][key]
            entry["launches"] = hd["launches"][key]
            entry["path"] = path
            entry["ms_deferred_window"] = hd[f"{key.lower()}_window_ms"]
            entry["bound_ms_deferred_window"] = hd[f"{key.lower()}_window_bound_ms"]

    phase11 = {}
    if full:
        # --- 11. the wavefront engine, the sorted loop, the sharded renders -
        # Their main paths: the sorted split route on the slice (K3 per
        # dispatch), each shard's default route (K4 per shard) and the 2x2
        # mesh's scan form (K1/K2 per rank), each counted from 0.
        phase11 = _phase11(scene26, sky, camera, tile, dev, card)
        sharded = phase11["sharded"]
        scan_2x2 = sharded["meshes"]["2x2"]["scan_k1_k2_per_rank"]
        for i, entry in enumerate(walk_entries):
            entry["launches_by_path"]["phase 11 2x2 gloo mesh scan form, per rank "
                                      f"({MESH_SCAN_SPP // 2} steps)"] = [k[i] for k in scan_2x2]
        k3_entry, k4_one_call = path_entries[0], path_entries[2]
        k3_entry["launches_by_path"] = {
            k3_entry["path"]: k3_entry["launches"],
            "phase 11 sorted split route, slice dispatch": phase11["sorted"]["launches"]["sorted"],
        }
        k4_one_call["launches_by_path"] = {
            k4_one_call["path"]: k4_one_call["launches"],
            "phase 11 1x1 nccl sharded 1920x1080 16 spp": sharded["hd"]["k4"],
            **{f"phase 11 {label} gloo mesh, per shard": m["k4_per_rank"]
               for label, m in sharded["meshes"].items()},
        }
        k4_one_call["max_abs_err_by_path"] = {
            k4_one_call["path"]: k4_one_call["max_abs_err"],
            "phase 11 1x1 nccl sharded 1920x1080, last K4 call, first and last "
            f"{QUERY_WINDOW} lanes": sharded["hd"]["k4_windows"]["max_abs_err"],
        }

    kernels = [*walk_entries, *path_entries, *eff_entries, k8_entry]
    print(f"total {time.perf_counter() - t_start:.1f} s from the start of the build",
          flush=True)
    print(card, flush=True)
    if not full:
        print(json.dumps({"kernel_times": {"kernels": kernels,
                                           "path_kernels_per_dispatch": by_width,
                                           "ptxas": ptxas, "card": card,
                                           "l2_bytes_per_s": L2_RATE["bytes_per_s"]}}),
              flush=True)
        return 0
    print(json.dumps({
        "kernels": kernels,
        "path_kernels_per_dispatch": by_width,
        "ptxas": ptxas,
        "efficiency": efficiency,
        "probes": probes,
        "slice": slice_numbers,
        "textured_slice": textured_numbers,
        "scan": scan_numbers,
        "deferred": deferred_numbers,
        "phase11": phase11,
        "l2_bytes_per_s": L2_RATE["bytes_per_s"],
    }), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
