"""The ray queries K1 and K2 and the sky-round probe K8 under the probe: what
a warp's walk spends its steps on, and other forms of the walk timed in
turns with the shipped kernels.

    python -m rayfinder_tpu_torch.prof.walk_probe steps [--scale 26]
    python -m rayfinder_tpu_torch.prof.walk_probe forms [--scale 26] [--rounds 2] [NAME ...]
    python -m rayfinder_tpu_torch.prof.walk_probe sky-steps [--scale 26]
    python -m rayfinder_tpu_torch.prof.walk_probe sky-forms [--scale 26] [--rounds 2] [NAME ...]

On 131,072 camera rays of the bench view and 131,072 random rays inside
courtyard_scene(scale), the two halves apart and together:

`steps` runs an instrumented closest walk over the packed tables
(walk_probe.cu rf_probe_steps) that takes one step (record, leaf or pop)
per warp-synchronous trip, and prints as JSON: per ray the records, leaves,
pops and steps; the lane utilisation per warp (steps over 32 x the warp's
longest lane); the share of a warp's trips that hold leaf lanes, record
lanes, both at once, and pop lanes, and how many lanes share such a trip;
and when the blocks start and end (%globaltimer), with the blocks resident
at 21 instants.

`forms` builds walk_probe.cu once per named form (FORMS; all by default),
checks every output of each against the shipped kernels' (t, tri, nodes
visited and occlusion, to T_MAX and to per-ray bounds), and times K1 and K2
of each form and of the shipped kernels, in turns, over `rounds` rounds, on
all rays and on each half alone.

On K8's lanes (prof/prof_skyround.py: 65,536 lanes x 64 rounds, for the
Duck probe's camera and the bench camera), in its "full" mode:

`sky-steps` runs K8 as it ran over the plane walk, one thread per lane
(walk_probe.cu rf_probe_sky_steps), and prints as JSON the nodes each lane
visits per round and in all, the lane utilisation per warp (nodes over 32
x the sum over rounds of the warp's longest walk), the blocks resident per
SM and the warps they hold, and when the blocks start and end.

`sky-forms` builds each named form of K8 (SKY_FORMS; all by default),
checks each one's acc against the shipped kernel's bit for bit, and times
each form and the shipped kernel in turns. With --check-only it builds and
checks the forms and times nothing.

Needs a CUDA device and nvcc; builds into the kernel library's build
directory. Every time is a mean of per-launch CUDA event pairs and names
the card and its power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess

import numpy as np
import torch

from ..ops import _build
from ..ops.walk import intersect_any_kernel, intersect_closest_kernel
from ..render.camera import create_camera, primary_ray
from ..render.intersect import T_MAX
from .scenes import BENCH_CAMERA

SOURCE = _build.CSRC.parent / "prof" / "walk_probe.cu"
N_CAMERA = N_RANDOM = 131072

_LOCAL = ["-DRF_LOOP=3"]  # walk_packed's loop, the stack in local memory
_SHIPPED = _LOCAL + ["-DRF_SMEM=16"]  # ... with K1's and K2's 16 entries in shared memory
# name -> macros of walk_probe.cu. "shipped form" is the shipped kernels'
# own form built from the probe's source.
FORMS = {
    "plane walk": ["-DRF_PLANE=1"],
    "one-step loop, 3-instruction min/max, local stack": ["-DRF_LOOP=0", "-DRF_PTX_MINMAX=0"],
    "one-step loop, local stack": ["-DRF_LOOP=0"],
    "while-while, local stack": ["-DRF_LOOP=1"],
    "seek, local stack": ["-DRF_LOOP=2"],
    "seek + while-while, 3-instruction min/max, local stack": _LOCAL + ["-DRF_PTX_MINMAX=0"],
    "seek + while-while, local stack": _LOCAL,
    "one-step loop, 16 stack entries in shared memory": ["-DRF_LOOP=0", "-DRF_SMEM=16"],
    "8 stack entries in shared memory": _LOCAL + ["-DRF_SMEM=8"],
    "12 stack entries in shared memory": _LOCAL + ["-DRF_SMEM=12"],
    "shipped form": _SHIPPED,
    "24 stack entries in shared memory": _LOCAL + ["-DRF_SMEM=24"],
    "all 32 stack entries in shared memory": _LOCAL + ["-DRF_SMEM=32"],
    "lop3 selects": _SHIPPED + ["-DRF_LOP3=1"],
    "16-byte stack entries": _SHIPPED + ["-DRF_STACK16=1"],
    "blocks of 64": _SHIPPED + ["-DRF_BLOCK=64"],
    "blocks of 256": _SHIPPED + ["-DRF_BLOCK=256"],
    "ld.global.cg": _SHIPPED + ["-DRF_LDHINT=1"],
    "ld.global.ca": _SHIPPED + ["-DRF_LDHINT=2"],
    "persistent, refill at 1": _SHIPPED + ["-DRF_PERSIST=1", "-DRF_REFILL_AT=1"],
    "persistent, refill at 16": _SHIPPED + ["-DRF_PERSIST=1", "-DRF_REFILL_AT=16"],
    "persistent, refill at 32": _SHIPPED + ["-DRF_PERSIST=1", "-DRF_REFILL_AT=32"],
    "persistent, refill at 1, local stack": _LOCAL + ["-DRF_PERSIST=1", "-DRF_REFILL_AT=1"],
    "11 blocks per SM, local stack": _LOCAL + ["-DRF_MIN_BLOCKS=11"],
}
# name -> macros of K8's forms (walk_probe.cu RF_SKY).
SKY_FORMS = {
    "lane per thread, plane walk": ["-DRF_SKY=0"],
    "lane per thread, local stack": ["-DRF_SKY=1", "-DRF_SMEM=0"],
    "lane per thread, 16 shared entries": ["-DRF_SKY=1", "-DRF_SMEM=16"],
    "warp per lane, local stack": ["-DRF_SKY=2", "-DRF_SMEM=0"],
    "warp per lane, 8 shared entries": ["-DRF_SKY=2", "-DRF_SMEM=8"],
    "warp per lane, 16 shared entries": ["-DRF_SKY=2", "-DRF_SMEM=16"],
    "items from a counter, local stack": ["-DRF_SKY=3", "-DRF_SMEM=0"],
    "items from a counter, 16 shared entries": ["-DRF_SKY=3", "-DRF_SMEM=16"],
}

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {
    "rf_probe_closest": [_P] * 6 + [_I] + [_P, _P, _P, _I, _P, _P, _P, _P, _P],
    "rf_probe_any": [_P] * 6 + [_I] + [_P, _P, _P, _I, _P, _P, _P],
    "rf_probe_plane": [_P] * 7 + [_I] + [_P, _P, _P, _I, _P, _P, _P, _P, _I, _P],
    "rf_probe_steps": [_P] * 6 + [_I] + [_P, _P, _P, _I] + [_P] * 6 + [_P],
    "rf_probe_sky": [_P] * 9 + [_I] + [_P, _I, _I] + [_P] * 7,
    "rf_probe_sky_steps": [_P] * 7 + [_I] + [_P, _I, _I] + [_P] * 8,
}


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 20) -> float:
    """Mean device time of fn() over reps launches, after one warm-up: one
    CUDA event pair per launch, the launches queued behind a busy-wait so
    that no host time falls inside a pair."""
    fn()
    torch.cuda.synchronize()
    pairs = []
    torch.cuda._sleep(2_000_000 * reps)
    for _ in range(reps):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        pairs.append((start, stop))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / reps


def query_rays(camera, dev, seed: int = 0):
    """N_CAMERA camera rays through a jittered 512-wide pixel grid, then
    N_RANDOM random rays from inside the courtyard, all unit length."""
    rng = np.random.default_rng(seed)
    w = 512
    h = N_CAMERA // w
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    u = torch.from_numpy(((xs.reshape(-1) + 0.5) / w).astype(np.float32)).to(dev)
    v = torch.from_numpy(((ys.reshape(-1) + 0.5) / h).astype(np.float32)).to(dev)
    noise = torch.from_numpy(rng.uniform(size=(N_CAMERA, 2)).astype(np.float32)).to(dev)
    co, cd = primary_ray(camera, u, v, noise, (1.0 / w, 1.0 / h))
    lo = np.asarray([-19.5, 0.2, -9.5], np.float32)
    hi = np.asarray([19.5, 11.5, 9.5], np.float32)
    ro = (lo + (hi - lo) * rng.uniform(size=(N_RANDOM, 3))).astype(np.float32)
    rd = rng.normal(size=(N_RANDOM, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    return (torch.cat([co, torch.from_numpy(ro).to(dev)]).contiguous(),
            torch.cat([cd, torch.from_numpy(rd).to(dev)]).contiguous())


def build(forms: dict, prefix: str = "walk_probe") -> dict:
    """One nvcc per form, all started together; returns {name: CDLL}."""
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for k, (name, flags) in enumerate(forms.items()):
        so = _build.BUILD_DIR / f"{prefix}_{k}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), *flags, "-shared",
               "-o", str(so), str(SOURCE)]
        procs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name!r}:\n{out}")
        lib = ctypes.CDLL(str(so))
        for fn, argtypes in _ARGTYPES.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def _runners(lib, flags, scene, o, d, t_max):
    """(k1, k2): callables that allocate their outputs as the wrappers do,
    launch the form's kernels and return (t, tri, visits) and occ."""
    dev, n = o.device, o.shape[0]
    plane = "-DRF_PLANE=1" in flags
    scene_args = _build.scene_args(scene, dev) if plane else _build.packed_args(scene, dev)
    rays = (o.data_ptr(), d.data_ptr(), t_max.data_ptr(), n)

    def k1():
        t = torch.empty(n, device=dev)
        tri = torch.empty(n, dtype=torch.int32, device=dev)
        visits = torch.empty(n, dtype=torch.int32, device=dev)
        if plane:
            err = lib.rf_probe_plane(*scene_args, *rays, t.data_ptr(), tri.data_ptr(),
                                     visits.data_ptr(), None, 0, _build.stream_of(dev))
        else:
            counter = torch.zeros(1, dtype=torch.int32, device=dev)
            err = lib.rf_probe_closest(*scene_args, *rays, t.data_ptr(), tri.data_ptr(),
                                       visits.data_ptr(), counter.data_ptr(),
                                       _build.stream_of(dev))
        _build.raise_on_error(err, "rf_probe_closest")
        return t, tri, visits

    def k2():
        occ = torch.empty(n, dtype=torch.bool, device=dev)
        if plane:
            err = lib.rf_probe_plane(*scene_args, *rays, None, None, None, occ.data_ptr(), 1,
                                     _build.stream_of(dev))
        else:
            counter = torch.zeros(1, dtype=torch.int32, device=dev)
            err = lib.rf_probe_any(*scene_args, *rays, occ.data_ptr(), counter.data_ptr(),
                                   _build.stream_of(dev))
        _build.raise_on_error(err, "rf_probe_any")
        return occ

    return k1, k2


def run_forms(scene, o, d, names, rounds: int, label: str) -> dict:
    """Check and time the named forms and the shipped kernels, in turns.
    Returns {name: [[K1, K2, camera K1, camera K2, random K1, random K2] ms
    per round]}."""
    dev, n = o.device, o.shape[0]
    forms = {name: FORMS[name] for name in names}
    libs = build(forms)
    t_far = torch.full((n,), T_MAX, device=dev)
    bound = torch.from_numpy(np.random.default_rng(1).uniform(0.5, 12.0, n)
                             .astype(np.float32)).to(dev)
    want = {}
    for key, t_max in (("far", t_far), ("bound", bound)):
        _, t, tri, visits = intersect_closest_kernel(scene, o, d, t_max)
        want[key] = (t, tri, visits, intersect_any_kernel(scene, o, d, t_max))
    halves = {"all": slice(0, n), "camera": slice(0, N_CAMERA), "random": slice(N_CAMERA, n)}
    parts = {k: (o[s].contiguous(), d[s].contiguous(), t_far[s].contiguous())
             for k, s in halves.items()}
    times = {}
    for _ in range(rounds):
        for name in ["shipped kernels", *forms]:
            row = []
            if name != "shipped kernels":
                for key, t_max in (("far", t_far), ("bound", bound)):
                    k1, k2 = _runners(libs[name], forms[name], scene, o, d, t_max)
                    got = (*k1(), k2())
                    if not all(torch.equal(a, b) for a, b in zip(got, want[key])):
                        raise RuntimeError(f"form {name!r} differs from the shipped kernels")
            for oo, dd, tt in parts.values():
                if name == "shipped kernels":
                    k1 = lambda: intersect_closest_kernel(scene, oo, dd, tt)  # noqa: E731
                    k2 = lambda: intersect_any_kernel(scene, oo, dd, tt)  # noqa: E731
                else:
                    k1, k2 = _runners(libs[name], forms[name], scene, oo, dd, tt)
                row += [time_ms(k1), time_ms(k2)]
            times.setdefault(name, []).append(row)
            print(f"{name}: K1 {row[0]:.4f} K2 {row[1]:.4f} ms; camera half alone "
                  f"{row[2]:.4f} / {row[3]:.4f}; random half alone {row[4]:.4f} / {row[5]:.4f}; "
                  f"outputs equal the shipped kernels' [{label}]", flush=True)
    return times


def run_steps(scene, o, d) -> dict:
    """The instrumented walk's counters, for the camera half, the random
    half and all rays, and the block timeline."""
    dev, n = o.device, o.shape[0]
    lib = build({"steps": []})["steps"]
    blocks, warps = -(-n // 128), -(-n // 32)
    t_far = torch.full((n,), T_MAX, device=dev)
    t = torch.empty(n, device=dev)
    tri = torch.empty(n, dtype=torch.int32, device=dev)
    lane_steps = torch.zeros(n, 3, dtype=torch.int32, device=dev)
    warp_steps = torch.zeros(warps, 6, dtype=torch.int32, device=dev)
    block_t = torch.zeros(blocks, 2, dtype=torch.int64, device=dev)
    block_sm = torch.zeros(blocks, dtype=torch.int32, device=dev)
    for _ in range(2):  # the second launch is the one read
        torch.cuda.synchronize()
        err = lib.rf_probe_steps(
            *_build.packed_args(scene, dev), o.data_ptr(), d.data_ptr(), t_far.data_ptr(), n,
            t.data_ptr(), tri.data_ptr(), lane_steps.data_ptr(), warp_steps.data_ptr(),
            block_t.data_ptr(), block_sm.data_ptr(), _build.stream_of(dev))
        _build.raise_on_error(err, "rf_probe_steps")
        torch.cuda.synchronize()
    _, kt, ktri, kvisits = intersect_closest_kernel(scene, o, d, t_far)
    if not (torch.equal(t, kt) and torch.equal(tri, ktri)
            and torch.equal(1 + 2 * lane_steps[:, 0], kvisits)):
        raise RuntimeError("the instrumented walk differs from K1")
    ls = lane_steps.cpu().numpy().astype(np.int64)
    ws = warp_steps.cpu().numpy().astype(np.int64)
    bt = block_t.cpu().numpy()
    res = {}
    for label, lo, hi in (("camera", 0, N_CAMERA), ("random", N_CAMERA, n), ("all", 0, n)):
        lane, warp = ls[lo:hi], ws[lo // 32:hi // 32]
        steps = lane.sum(1)
        trips = warp[:, 0]
        res[label] = {
            "rays": int(hi - lo),
            "records_per_ray": float(lane[:, 0].mean()),
            "leaves_per_ray": float(lane[:, 1].mean()),
            "pops_per_ray": float(lane[:, 2].mean()),
            "steps_per_ray": float(steps.mean()), "steps_max": int(steps.max()),
            "lane_utilisation_per_warp": float(steps.sum() / (32 * steps.reshape(-1, 32)
                                                               .max(1).sum())),
            "warp_trips_mean": float(trips.mean()), "warp_trips_max": int(trips.max()),
            "share_of_trips_with_leaf_lanes": float(warp[:, 1].sum() / trips.sum()),
            "share_of_trips_with_record_lanes": float(warp[:, 2].sum() / trips.sum()),
            "share_of_trips_with_both": float(warp[:, 3].sum() / trips.sum()),
            "share_of_trips_with_pop_lanes": float(warp[:, 5].sum() / trips.sum()),
            "leaf_lanes_per_leaf_trip": float(lane[:, 1].sum() / max(warp[:, 1].sum(), 1)),
            "record_lanes_per_record_trip": float(lane[:, 0].sum() / max(warp[:, 2].sum(), 1)),
            "block_longest_over_mean_warp": float(trips.reshape(-1, 4).max(1).sum()
                                                  / trips.reshape(-1, 4).mean(1).sum()),
        }
    t0 = bt[:, 0].min()
    begin, end = (bt[:, 0] - t0) / 1e6, (bt[:, 1] - t0) / 1e6
    half = N_CAMERA // 128
    res["blocks"] = {
        "count": int(blocks), "ms_last_start": float(begin.max()), "ms_last_end": float(end.max()),
        "ms_end_percentiles": {str(q): float(np.percentile(end, q))
                               for q in (1, 10, 25, 50, 75, 90, 99)},
        "block_ms_sum": float((end - begin).sum()),
        "block_ms_mean_camera": float((end - begin)[:half].mean()),
        "block_ms_mean_random": float((end - begin)[half:].mean()),
        "resident_at_ms": {f"{g:.3f}": int(((begin <= g) & (end > g)).sum())
                           for g in np.linspace(0, end.max(), 21)},
        "sms": int(len(np.unique(block_sm.cpu().numpy()))),
    }
    return res


def _sky_scene_args(scene, dev) -> list:
    """The scene arguments of rf_probe_sky: the planes, the triangle
    positions, the packed tables, the triangle count."""
    planes = _build.scene_args(scene, dev)[:7]
    packed = _build.packed_args(scene, dev)
    return planes + packed[4:6] + [scene.num_triangles]


def _sky_params(probe, rounds: int):
    from ..ops.regen import _params
    from .prof_skyround import T_MAX as SKY_T_MAX

    _, camera, sky, _, _, _, inv_dims = probe
    return _params(camera, sky, inv_dims, 0, 256, rounds, SKY_T_MAX)


def _sky_runner(lib, flags, scene, probe, rounds: int):
    """A callable that launches the form's K8 "full" and returns acc (the
    items form with its scratch and a zeroed counter, as K4's wrapper)."""
    u, v, nb = probe[3:6]
    dev, n = u.device, u.shape[0]
    args = _sky_scene_args(scene, dev)
    params = _sky_params(probe, rounds)
    items = "-DRF_SKY=3" in flags
    scratch = torch.empty(n * rounds * 4 if items else 4, device=dev)
    counter = torch.zeros(1, dtype=torch.int32, device=dev)

    def run():
        acc = torch.empty(n, device=dev)
        if items:
            counter.zero_()
        err = lib.rf_probe_sky(*args, ctypes.addressof(params), n, rounds, u.data_ptr(),
                               v.data_ptr(), nb.data_ptr(), acc.data_ptr(), scratch.data_ptr(),
                               counter.data_ptr(), _build.stream_of(dev))
        _build.raise_on_error(err, "rf_probe_sky")
        return acc

    return run


def run_sky_forms(scene, names, rounds: int, label: str, check_only: bool) -> dict:
    """Check the named K8 forms against the shipped kernel ("full", both
    cameras, ROUNDS rounds) and time them and it in turns. Returns
    {camera: {name: [ms per round of turns]}}."""
    from ..ops.skyround import sky_round
    from . import prof_skyround

    dev = torch.device("cuda", 0)
    forms = {name: SKY_FORMS[name] for name in names}
    libs = build(forms, prefix="sky_probe")
    times = {}
    for camera in prof_skyround.CAMERAS:
        probe = prof_skyround.probe_args(scene, dev, camera)
        runs = {name: _sky_runner(libs[name], forms[name], scene, probe, prof_skyround.ROUNDS)
                for name in forms}
        runs["shipped kernel"] = lambda probe=probe: sky_round(*probe, prof_skyround.ROUNDS,
                                                               "full")
        want = runs["shipped kernel"]()
        for name in forms:
            if not torch.equal(runs[name](), want):
                raise RuntimeError(f"K8 form {name!r} differs from the shipped kernel")
        print(f"K8 full, {camera} camera: every form's acc equals the shipped kernel's "
              f"[{label}]", flush=True)
        if check_only:
            continue
        times[camera] = {name: [] for name in runs}
        for _ in range(rounds):
            for name, fn in runs.items():
                ms = time_ms(fn, 5)
                times[camera][name].append(ms)
                print(f"K8 full, {camera} camera, {name}: {ms:.4f} ms [{label}]", flush=True)
    return times


def run_sky_steps(scene) -> dict:
    """K8 "full" over the plane walk, instrumented, for both cameras."""
    from ..ops.skyround import sky_round
    from . import prof_skyround

    dev = torch.device("cuda", 0)
    lib = build({"sky steps": ["-DRF_SKY=0"]}, prefix="sky_steps")["sky steps"]
    rounds = prof_skyround.ROUNDS
    res = {}
    for camera in prof_skyround.CAMERAS:
        probe = prof_skyround.probe_args(scene, dev, camera)
        u, v, nb = probe[3:6]
        n = u.shape[0]
        blocks = -(-n // 128)
        params = _sky_params(probe, rounds)
        acc = torch.empty(n, device=dev)
        visits = torch.zeros(n, rounds, dtype=torch.int32, device=dev)
        block_t = torch.zeros(blocks, 2, dtype=torch.int64, device=dev)
        block_sm = torch.zeros(blocks, dtype=torch.int32, device=dev)
        for _ in range(2):  # the second launch is the one read
            torch.cuda.synchronize()
            err = lib.rf_probe_sky_steps(
                *_build.scene_args(scene, dev)[:7], scene.num_triangles,
                ctypes.addressof(params), n, rounds, u.data_ptr(), v.data_ptr(), nb.data_ptr(),
                acc.data_ptr(), visits.data_ptr(), block_t.data_ptr(), block_sm.data_ptr(),
                _build.stream_of(dev))
            _build.raise_on_error(err, "rf_probe_sky_steps")
            torch.cuda.synchronize()
        if not torch.equal(acc, sky_round(*probe, rounds, "full")):
            raise RuntimeError("the instrumented K8 differs from the shipped kernel")
        hits = sum(int(intersect_closest_kernel(
            scene, *prof_skyround.sample_rays(probe, r), prof_skyround.T_MAX)[0].sum())
            for r in range(rounds))
        vis = visits.cpu().numpy().astype(np.int64)
        warp_max = vis.reshape(-1, 32, rounds).max(1)  # (warps, rounds)
        bt = block_t.cpu().numpy()
        sm = block_sm.cpu().numpy()
        t0 = bt[:, 0].min()
        begin, end = (bt[:, 0] - t0) / 1e6, (bt[:, 1] - t0) / 1e6
        per_sm = []
        for s_id in np.unique(sm):
            ev = sorted([(b, 1) for b in begin[sm == s_id]] + [(e, -1) for e in end[sm == s_id]],
                        key=lambda x: (x[0], x[1]))
            live = peak = 0
            for _, step in ev:
                live += step
                peak = max(peak, live)
            per_sm.append(peak)
        res[camera] = {
            "lanes": n, "rounds": rounds,
            "nodes_per_lane_round": float(vis.mean()), "nodes_max": int(vis.max()),
            "nodes_per_lane": float(vis.sum(1).mean()),
            "share_of_lane_rounds_that_hit": hits / (n * rounds),
            "lane_utilisation_per_warp": float(vis.sum() / (32 * warp_max.sum())),
            "warp_nodes_per_round_mean": float(warp_max.mean()),
            "blocks": {
                "count": int(blocks), "sms": int(len(per_sm)),
                "resident_blocks_per_sm_max": int(max(per_sm)),
                "resident_blocks_per_sm_mean_of_max": float(np.mean(per_sm)),
                "resident_warps_per_sm_max": 4 * int(max(per_sm)),
                "ms_last_start": float(begin.max()), "ms_last_end": float(end.max()),
                "ms_end_percentiles": {str(q): float(np.percentile(end, q))
                                       for q in (1, 10, 25, 50, 75, 90, 99)},
                "block_ms_sum": float((end - begin).sum()),
                "block_ms_mean": float((end - begin).mean()),
                "block_ms_max": float((end - begin).max()),
                "resident_at_ms": {f"{g:.3f}": int(((begin <= g) & (end > g)).sum())
                                   for g in np.linspace(0, end.max(), 21)},
            },
        }
    return res


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("what", choices=("steps", "forms", "sky-steps", "sky-forms"))
    ap.add_argument("names", nargs="*",
                    help="forms to time (default: all of FORMS, or of SKY_FORMS)")
    ap.add_argument("--scale", type=int, default=26)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--check-only", action="store_true",
                    help="sky-forms: build and check the forms, time nothing")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("walk_probe: needs a CUDA device (the kernels run only there)")
    from ..render.scene import build_device_scene
    from ..scene.procedural import courtyard_scene

    dev = torch.device("cuda", 0)
    label = card()
    flat, textures = courtyard_scene(args.scale, textured=False)
    scene = build_device_scene(flat, textures=textures, device=dev)
    if args.what.startswith("sky-"):
        print(f"courtyard_scene({args.scale}): {scene.num_triangles} triangles; K8's lanes "
              f"[{label}]", flush=True)
        if args.what == "sky-steps":
            print(json.dumps({"sky_steps": run_sky_steps(scene), "card": label}), flush=True)
            return
        unknown = [name for name in args.names if name not in SKY_FORMS]
        if unknown:
            raise SystemExit(f"walk_probe: unknown K8 forms {unknown}; known: {list(SKY_FORMS)}")
        times = run_sky_forms(scene, args.names or list(SKY_FORMS), args.rounds, label,
                              args.check_only)
        print(json.dumps({"sky_forms_ms": times, "card": label}), flush=True)
        return
    o, d = query_rays(create_camera(*BENCH_CAMERA, 1.0), dev)
    print(f"courtyard_scene({args.scale}): {scene.num_triangles} triangles; {N_CAMERA} camera "
          f"and {N_RANDOM} random rays [{label}]", flush=True)
    if args.what == "steps":
        print(json.dumps({"walk_steps": run_steps(scene, o, d), "card": label}), flush=True)
        return
    unknown = [name for name in args.names if name not in FORMS]
    if unknown:
        raise SystemExit(f"walk_probe: unknown forms {unknown}; known: {list(FORMS)}")
    times = run_forms(scene, o, d, args.names or list(FORMS), args.rounds, label)
    print(json.dumps({"walk_forms_ms": times, "card": label}), flush=True)


if __name__ == "__main__":
    main()
