"""Smoke run of the PyTorch port (rayfinder_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA device and the
CUDA toolkit (nvcc). It builds the port's CUDA kernels from csrc/, then:

1. prints the card's name and power limit and the build time;
2. runs the closest-hit (K1) and any-hit (K2) kernels on the 256 rays of
   each *_courtyard8.npz golden and on 262,144 camera and random rays over
   the 254K-triangle courtyard, and holds them to their plain torch
   versions on the same card exactly (t at atol 0, tri, nodes visited,
   occlusion);
3. renders the untextured courtyard_scene(8) at 128x96, 8 spp, 4 bounces
   through the kernels, through the plain versions, and through the
   in-kernel (K4) and segs=2 (K5) routes: the tonemapped images must agree
   at RMSE < 1e-3, each must lie within RMSE 5e-3 of
   tests/goldens/courtyard_untextured_128x96_8spp.npz (baked by the JAX
   package), the [closest, shadow] ray counts within 0.1%;
3b. the same for the textured courtyard_scene(8), built without Pillow
   (textured_courtyard), through the split, in-kernel and segs=2 routes
   and the plain in-kernel route, against
   tests/goldens/courtyard_textured_128x96_8spp.npz;
4. runs the slice -- courtyard_scene(26) untextured (254,176 triangles),
   512x512, 4 bounces, exact ray counts -- one warm-up dispatch of 16
   samples, then one timed dispatch of 16;
5. runs the slice through the in-kernel and segs=2 routes the same way,
   and through the in-kernel route in one K4 call per dispatch
   (compact_floor = the batch); holds their accumulations to the split
   route's and the segs ray counts to its counts, and times three more
   dispatches of each route in turns;
6. holds each path kernel (K3, K4, K5) to its plain version at the slice's
   shapes.

Any failed phase raises, so the script exits non-zero and prints no "ok"
line. The line before the last is a JSON object of per-kernel numbers; the
last is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
GOLDENS = ROOT / "tests" / "goldens"

# The bench configuration of the JAX package (bench.py main_courtyard).
SLICE = dict(width=512, height=512, num_bounces=4, spp=256, num_frames=16)
CAMERA = ([-16.0, 5.0, 0.0], [12.0, 2.0, 0.0], 0.0, 1.0, 70.0)
SKY = (2.5, (0.3, 0.3, 0.3), 35.0, 25.0)


# The textured courtyard's 14 textures (rayfinder_tpu/scene/procedural.py
# courtyard_textures): pattern function and arguments, in index order.
_COURTYARD_TEXTURES = (
    ("_checker_rgb", (512, (0.72, 0.66, 0.58), (0.5, 0.46, 0.42), 16)),
    ("_brick_rgb", (512, (0.78, 0.74, 0.7), (0.6, 0.57, 0.54))),
    ("_brick_rgb", (256, (0.84, 0.82, 0.74), (0.7, 0.68, 0.6))),
    ("_brick_rgb", (320, (0.75, 0.68, 0.62), (0.55, 0.5, 0.46))),
    ("_brick_rgb", (192, (0.8, 0.72, 0.66), (0.62, 0.55, 0.5))),
    ("_marble_rgb", (128, (0.85, 0.83, 0.78), (0.66, 0.64, 0.6), 0)),
    ("_marble_rgb", (96, (0.82, 0.8, 0.78), (0.6, 0.58, 0.56), 1)),
    ("_marble_rgb", (160, (0.88, 0.84, 0.76), (0.68, 0.64, 0.56), 2)),
    ("_marble_rgb", (64, (0.8, 0.78, 0.72), (0.58, 0.56, 0.5), 3)),
    ("_wood_rgb", (128, (0.6, 0.4, 0.22), (0.42, 0.26, 0.13), 0)),
    ("_wood_rgb", (96, (0.55, 0.36, 0.2), (0.38, 0.24, 0.12), 1)),
    ("_wood_rgb", (256, (0.64, 0.44, 0.26), (0.46, 0.3, 0.16), 2)),
    ("_wood_rgb", (64, (0.5, 0.33, 0.18), (0.34, 0.21, 0.1), 3)),
    ("_checker_rgb", (112, (0.6, 0.38, 0.2), (0.44, 0.27, 0.14), 8)),
)

# Material groups of the untextured courtyard, in chunk order: (untextured
# material, first textured material, chunks, textures cycled over).
_COURTYARD_GROUPS = ((0, 0, 1, 1), (1, 1, 4, 4), (2, 5, 18, 4), (3, 9, 12, 5))


def textured_courtyard(subdiv: int):
    """courtyard_scene(subdiv, textured=True) built without Pillow: the
    untextured geometry with UVs x 8, each chunk's material from its place
    in its group (floor, 4 walls, 18 columns, 12 crates; equal chunk sizes
    within a group), and the 14 textures packed to BGRA straight from the
    procedural patterns (PNG is lossless, so this is what decoding the PNG
    gives). Returns (FlattenedScene, textures)."""
    import numpy as np

    from rayfinder_tpu.scene import procedural
    from rayfinder_tpu.scene.flatten import FlattenedScene
    from rayfinder_tpu.scene.texture import Texture

    flat, _ = procedural.courtyard_scene(subdiv, textured=False)
    group = flat.texture_indices
    material = np.empty_like(group)
    for plain, first, chunks, cycle in _COURTYARD_GROUPS:
        rows = np.nonzero(group == plain)[0]
        chunk = (rows - rows[0]) // (rows.size // chunks)
        material[rows] = first + chunk % cycle
    textures = []
    for fn, args in _COURTYARD_TEXTURES:
        rgb = getattr(procedural, fn)(*args)
        u8 = np.clip(rgb * 255.0 + 0.5, 0, 255).astype(np.uint8).astype(np.uint32)
        bgra = u8[..., 2] | (u8[..., 1] << 8) | (u8[..., 0] << 16) | np.uint32(255 << 24)
        textures.append(Texture(bgra.reshape(-1).astype(np.uint32), width=rgb.shape[1],
                                height=rgb.shape[0]))
    scene = FlattenedScene(
        positions=flat.positions, normals=flat.normals,
        tex_coords=flat.tex_coords * np.float32(8.0), texture_indices=material,
    )
    return scene, textures


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def _time_ms(fn, reps: int) -> float:
    """Mean device time of fn() over reps launches, after one warm-up."""
    import torch

    fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


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
    return dict(t=t, tri=tri, occ=occ,
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
    other (RMSE < 1e-3) and to the JAX golden (RMSE < 5e-3), and the routes
    that count rays to each other (0.1%)."""
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
    print(f"  ray counts of {sorted(counts)} within 0.1% (golden counts "
          f"{golden['rays'].tolist()})", flush=True)
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


def _timed(fn):
    """(result, seconds) of fn(), fenced by a device sync."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)", file=sys.stderr)
        return 1
    _require((ROOT / "rayfinder_tpu_torch").is_dir(), f"no rayfinder_tpu_torch beside {__file__}")
    sys.path.insert(0, str(ROOT))

    import numpy as np

    from rayfinder_tpu.scene.procedural import courtyard_scene
    from rayfinder_tpu_torch.ops import _build
    from rayfinder_tpu_torch.ops.regen import trace_regen, trace_regen_reference
    from rayfinder_tpu_torch.ops.regen_segs import trace_regen_segs, trace_regen_segs_reference
    from rayfinder_tpu_torch.ops.regen_shaded import (
        trace_regen_shaded, trace_regen_shaded_reference,
    )
    from rayfinder_tpu_torch.ops.walk import (
        intersect_any_kernel, intersect_any_reference,
        intersect_closest_kernel, intersect_closest_reference,
    )
    from rayfinder_tpu_torch.render import pathtracer as pt
    from rayfinder_tpu_torch.render.camera import create_camera, primary_ray
    from rayfinder_tpu_torch.render.intersect import T_MAX
    from rayfinder_tpu_torch.render.pathtracer import (
        _nee_and_continuation, accumulate_samples_regen,
    )
    from rayfinder_tpu_torch.render.rng import blue_noise_tile, noise_of
    from rayfinder_tpu_torch.render.scene import build_device_scene
    from rayfinder_tpu_torch.render.tiling import block_order
    from rayfinder_tpu_torch.sky.model import sky_state_from_ui

    dev = torch.device("cuda", 0)
    card = _card()
    print(f"card: {card} | torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    # --- 1. build -----------------------------------------------------------
    t0 = time.perf_counter()
    _build.library()
    print(f"build: {time.perf_counter() - t0:.1f} s -> {_build.library_path().name}", flush=True)
    for line in _build.build_log_path().read_text().splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"  ptxas: {line.strip()[:120]}")

    sky = sky_state_from_ui(*SKY)
    tile = torch.from_numpy(blue_noise_tile()).to(dev)

    # --- 2. K1/K2: goldens and 262,144 rays over the big courtyard -----------
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
          f"nodes, built in {time.perf_counter() - t0:.1f} s", flush=True)
    camera = create_camera(*CAMERA, SLICE["width"] / SLICE["height"])
    o, d = _rays(camera, 131072, 131072, seed=0, dev=dev)
    walk = _check_walks(scene26, o, d, "courtyard26 camera+random")
    print(f"  hit fraction {float((walk['tri'] >= 0).float().mean()):.4f}, "
          f"occluded fraction {float(walk['occ'].float().mean()):.4f}")
    k1_ms = _time_ms(lambda: intersect_closest_kernel(scene26, o, d, T_MAX), 20)
    k1_plain = _time_ms(lambda: intersect_closest_reference(scene26, o, d, T_MAX), 2)
    k2_ms = _time_ms(lambda: intersect_any_kernel(scene26, o, d, T_MAX), 20)
    k2_plain = _time_ms(lambda: intersect_any_reference(scene26, o, d, T_MAX), 2)
    print(f"K1 closest: {k1_ms:.3f} ms (plain {k1_plain:.1f} ms); K2 any: {k2_ms:.3f} ms "
          f"(plain {k2_plain:.1f} ms) at 262144 rays [{card}]", flush=True)

    # --- 3. small render: kernels vs plain vs the JAX-baked golden ----------
    # The split route through the kernels and the plain versions, and the
    # in-kernel (K4) and segs (K5) routes through their kernels.
    _render_routes(scene8, sky, tile, dev, "render", np.load(
        GOLDENS / "courtyard_untextured_128x96_8spp.npz"), {
            "kernel": dict(engine="kernel", count_rays=True),
            "plain": dict(engine="plain", count_rays=True),
            "inkernel": dict(engine="kernel", inkernel=True),
            "segs2": dict(engine="kernel", segs=2, count_rays=True),
        })

    # --- 3b. the textured courtyard, built without Pillow -------------------
    flat8t, tex8t = textured_courtyard(8)
    scene8t = build_device_scene(flat8t, textures=tex8t, device=dev)
    _render_routes(scene8t, sky, tile, dev, "textured render", np.load(
        GOLDENS / "courtyard_textured_128x96_8spp.npz"), {
            "kernel": dict(engine="kernel", count_rays=True),
            "inkernel": dict(engine="kernel", inkernel=True),
            "segs2": dict(engine="kernel", segs=2, count_rays=True),
            "inkernel plain": dict(engine="plain", inkernel=True),
        })

    # --- 4. the slice: courtyard_scene(26), 512x512, 4 bounces --------------
    w, h = SLICE["width"], SLICE["height"]
    nf16 = SLICE["num_frames"]
    kw = dict(width=w, height=h, num_bounces=SLICE["num_bounces"], spp=SLICE["spp"],
              num_frames=nf16, engine="kernel")
    zeros = torch.zeros(w * h, 3, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    trace_regen.launches = 0
    intersect_closest_kernel.launches = 0
    intersect_any_kernel.launches = 0
    t0 = time.perf_counter()
    accum_w, _ = accumulate_samples_regen(scene26, sky, camera, tile, 0, zeros,
                                          count_rays=True, **kw)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    accum, rays = accumulate_samples_regen(scene26, sky, camera, tile, nf16, accum_w,
                                           count_rays=True, **kw)
    total = float(accum.sum())  # fences the dispatch
    dt = time.perf_counter() - t0
    k3_launches = trace_regen.launches
    closest, shadow = (int(x) for x in rays.cpu())
    mrays = (closest + shadow) / dt / 1e6
    peak = torch.cuda.max_memory_allocated()
    print(f"slice courtyard26 512x512 4 bounces, 16 samples timed: {mrays:.3f} Mrays/s, "
          f"{dt:.3f} s (warm-up dispatch {warm_s:.3f} s), rays closest={closest} "
          f"shadow={shadow}, peak memory {peak / 2**20:.1f} MiB, K3 launches "
          f"{k3_launches} (2 dispatches) [{card}]", flush=True)
    _require(k3_launches > 0, "the slice did not launch the path kernel")
    _require(bool(torch.isfinite(accum).all()) and total > 0.0,
             "the slice's radiance is not finite and non-zero")

    # --- 5. the in-kernel (K4) and segs (K5) routes at full width -----------
    # Each route: a warm-up dispatch of samples 0-15, then the timed
    # dispatch of samples 16-31 from phase 4's starting accumulation. The
    # in-kernel route ends whole paths inside K4 and cannot count rays: its
    # Mrays/s uses phase 4's exact counts, which are those of the same
    # samples. "inkernel_one_call" is the in-kernel route with a compaction
    # floor of the whole batch: no split phase, one K4 call per dispatch.
    routes = {"inkernel": (dict(inkernel=True), trace_regen_shaded),
              "segs2": (dict(segs=2, count_rays=True), trace_regen_segs),
              "inkernel_one_call": (dict(inkernel=True, compact_floor=w * h),
                                    trace_regen_shaded)}
    route_launches, route_rates = {}, {"split": mrays}
    for name, (route_kw, kernel) in routes.items():
        kernel.launches = 0
        _timed(lambda: accumulate_samples_regen(scene26, sky, camera, tile, 0, zeros,
                                                **route_kw, **kw))
        out, secs = _timed(lambda: accumulate_samples_regen(
            scene26, sky, camera, tile, nf16, accum_w, **route_kw, **kw))
        route_launches[name] = kernel.launches
        r_accum, r_rays = out if isinstance(out, tuple) else (out, None)
        route_rates[name] = (closest + shadow) / secs / 1e6
        counted = ("rays " + str(r_rays.tolist())) if r_rays is not None else (
            "rays not counted: the rate uses phase 4's counts of the same samples")
        err = float((r_accum - accum).abs().max())
        print(f"slice via {name}: {route_rates[name]:.3f} Mrays/s (split {mrays:.3f}), "
              f"{secs:.3f} s, {counted}, {kernel.__name__} launches {kernel.launches} "
              f"(2 dispatches), max |accum - split| {err:.3e} [{card}]", flush=True)
        _require(kernel.launches > 0, f"the {name} route did not launch {kernel.__name__}")
        _require(bool(torch.allclose(r_accum, accum, rtol=1e-4, atol=2e-3)),
                 f"{name}: the accumulation differs from the split route's")
        if r_rays is not None:
            _require(r_rays.tolist() == [closest, shadow],
                     f"{name}: ray counts differ from the split route's")

    # Host time is noisy: three more timed dispatches of each route, in turns.
    repeats = {name: [] for name in ("split", *routes)}
    route_kws = {"split": dict(count_rays=True), **{k: v[0] for k, v in routes.items()}}
    for _ in range(3):
        for name, route_kw in route_kws.items():
            _, secs = _timed(lambda: accumulate_samples_regen(
                scene26, sky, camera, tile, nf16, accum_w, **route_kw, **kw))
            repeats[name].append((closest + shadow) / secs / 1e6)
    print("slice routes, Mrays/s over three dispatches in turns: "
          + "; ".join(f"{k} {', '.join(f'{x:.3f}' for x in v)}" for k, v in repeats.items())
          + f" [{card}]", flush=True)

    # --- 6. each path kernel against its plain version at slice shapes ------
    ys_np, xs_np, _ = block_order(w, h)
    ys = torch.from_numpy(ys_np).to(dev)
    xs = torch.from_numpy(xs_np).to(dev)
    u = (xs.float() + 0.5) / float(w)
    v_tex = (ys.float() + 0.5) / float(h)
    nbase = tile[(ys % 128).long(), (xs % 128).long()].contiguous()
    inv_dims = (float(np.float32(1) / np.float32(w)), float(np.float32(1) / np.float32(h)))
    nf, spp, nb = nf16, SLICE["spp"], SLICE["num_bounces"]
    n = w * h

    # K3: the lane state after one kernel call and one shade step (NEE
    # pending, scatter continuations and fresh primaries mixed).
    sample = torch.zeros(n, dtype=torch.int32, device=dev)
    o0, d0 = primary_ray(camera, u, v_tex, noise_of(nbase, 0, sample, spp), inv_dims)
    z3 = torch.zeros(n, 3, device=dev)
    out = trace_regen(
        scene26, camera, sky, u, v_tex, nbase, inv_dims, 0, spp, nf, T_MAX,
        sample, torch.ones_like(sample), torch.zeros_like(sample), o0, d0,
        torch.ones(n, 3, device=dev), z3, z3, torch.full((n, 3), 1e30, device=dev),
        torch.tensor([1.0, 0.0, 0.0], device=dev).expand(n, 3).contiguous(), z3,
    )
    sample1, bounce1, org1, dir1, thr1, srad1, lrad1, _t1, tri1 = out
    noise1 = noise_of(nbase, 0, sample1, spp)
    flag2, org2, dir2, thr2, bounce2, sho2, shd2, con2 = _nee_and_continuation(
        scene26, noise1, org1, dir1, tri1, thr1, bounce1, sample1 < nf,
        torch.as_tensor(sky.sun_direction, device=dev),
        torch.as_tensor(sky.solar_radiances, device=dev), nb,
    )
    args = (scene26, camera, sky, u, v_tex, nbase, inv_dims, 0, spp, nf, T_MAX,
            sample1, bounce2, flag2, org2, dir2, thr2, srad1, lrad1, sho2, shd2, con2)
    k_out = trace_regen(*args)
    p_out, k3_plain = _timed(lambda: trace_regen_reference(*args))
    k3_plain *= 1e3
    k3_ms = _time_ms(lambda: trace_regen(*args), 5)
    print(f"K3 trace_regen: {k3_ms:.3f} ms (plain {k3_plain:.1f} ms) at {n} lanes; "
          f"flags {torch.bincount(flag2, minlength=3).tolist()} [{card}]", flush=True)
    k3_err = _hold("K3", ("sample", "bounce", "origin", "direction", "thr", "srad", "lrad",
                          "t", "tri"), k_out, p_out, ("sample", "bounce", "tri"), card)

    # K4: the compacted lanes of the in-kernel route's first shaded phase,
    # with that phase's per-tile floor.
    disp = pt._Dispatch(
        scene=scene26, sky=sky, camera=camera, kernels=pt._ENGINES["kernel"],
        inv_dims=inv_dims, frame_base=0, spp=spp, nf=nf, num_bounces=nb,
        sun_dir=torch.as_tensor(sky.sun_direction, device=dev),
        solar=torch.as_tensor(sky.solar_radiances, device=dev),
    )
    sizes = pt._phase_sizes(n, pt._COMPACT_FLOOR)
    lanes = dict(u=u, v_tex=v_tex, noise_base=nbase)
    st = pt._initial_state(disp, lanes, n, dev)
    _, _, lrad0 = pt._split_phase0(disp, st, lanes, zeros, sizes[1])
    floor = pt._tile_floor(sizes[1], sizes[2])
    args = (scene26, camera, sky, lanes["u"], lanes["v_tex"], lanes["noise_base"], inv_dims,
            0, spp, nf, nb, floor, T_MAX, st["sample"], st["bounce"], st["flag"],
            st["origin"], st["direction"], st["thr"], st["srad"], lrad0, st["shadow_o"],
            st["shadow_d"], st["contrib"])
    k_out = trace_regen_shaded(*args)
    p_out, k4_plain = _timed(lambda: trace_regen_shaded_reference(*args))
    k4_plain *= 1e3
    k4_ms = _time_ms(lambda: trace_regen_shaded(*args), 5)
    live_after = int((k_out[0] < nf).sum())
    print(f"K4 trace_regen_shaded: {k4_ms:.3f} ms (plain {k4_plain:.1f} ms) at {sizes[1]} "
          f"lanes, per-tile floor {floor}: live {int((st['sample'] < nf).sum())} -> "
          f"{live_after} [{card}]", flush=True)
    k4_err = _hold("K4", ("sample", "bounce", "flag", "origin", "direction", "thr", "srad",
                          "lrad", "shadow_o", "shadow_d", "contrib"), k_out, p_out,
                   ("sample", "bounce", "flag"), card)

    # K5 (K = 2): all 262,144 lanes after one iteration of the segs route.
    lanes = dict(u=u, v_tex=v_tex, noise_base=nbase)
    st = pt._initial_slots(disp, lanes, n, 2, dev)
    lrad1, flags = disp.segs_step(st, lanes, zeros)
    args = (scene26, camera, sky, u, v_tex, nbase, inv_dims, 0, spp, nf, T_MAX,
            st["salloc"], lrad1, st["cnt"], st["ray"], st["thr"], st["nee"])
    k_out = trace_regen_segs(*args)
    p_out, k5_plain = _timed(lambda: trace_regen_segs_reference(*args))
    k5_plain *= 1e3
    k5_ms = _time_ms(lambda: trace_regen_segs(*args), 5)
    print(f"K5 trace_regen_segs: {k5_ms:.3f} ms (plain {k5_plain:.1f} ms) at {n} lanes x 2 "
          f"slots; slot flags {torch.bincount(flags, minlength=3).tolist()} [{card}]",
          flush=True)
    k5_err = _hold("K5", ("salloc", "lrad", "ocnt", "oray", "othr", "t"), k_out, p_out,
                   ("salloc", "ocnt"), card)

    print(card, flush=True)
    kernels = [
        ("trace_regen", "regen.cu", ":1211", k3_launches, k3_err, k3_ms, k3_plain),
        ("trace_regen_shaded", "regen_shaded.cu", ":1715", route_launches["inkernel"],
         k4_err, k4_ms, k4_plain),
        ("trace_regen_segs", "regen_segs.cu", ":1393", route_launches["segs2"], k5_err,
         k5_ms, k5_plain),
    ]
    print(json.dumps({
        "kernels": [{
            "name": name, "route": "cuda", "source": f"rayfinder_tpu_torch/csrc/{src}",
            "replaces": f"rayfinder_tpu/ops/pallas_regen.py{line}", "launches": launches,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        } for name, src, line, launches, err, ms, plain_ms in kernels],
        # K1/K2 run inline in the path kernels on the main path (their
        # device functions), so the main path launches them 0 times alone.
        "standalone": [
            {"name": "intersect_closest", "route": "cuda",
             "source": "rayfinder_tpu_torch/csrc/walk.cu",
             "replaces": "rayfinder_tpu/ops/pallas_walk.py:2034",
             "runs_inline_in": "trace_regen", "max_abs_err": walk["t_err"],
             "ms": k1_ms, "plain_ms": k1_plain},
            {"name": "intersect_any", "route": "cuda",
             "source": "rayfinder_tpu_torch/csrc/walk.cu",
             "replaces": "rayfinder_tpu/ops/pallas_walk.py:2051",
             "runs_inline_in": "trace_regen", "max_abs_err": walk["occ_err"],
             "ms": k2_ms, "plain_ms": k2_plain},
        ],
        "slice": {"mrays_per_s": route_rates, "repeats": repeats, "seconds": dt,
                  "closest": closest, "shadow": shadow, "peak_bytes": peak, "card": card},
    }), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
