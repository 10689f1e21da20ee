"""The operations per ray that a path-tracing cell's walks need, counted
once and frozen into work/<cell>.json for metrics/k4_roofline.py.

    python3 portbench/tools/work.py --workload <cell> --seeds <n> [<n> ...]

On the CPU (these are counts of tests, not times), for each seed: the
session's first pose, PIXELS pixels drawn from the seed over the whole
image, and SAMPLES consecutive samples of each from
the session's first frame index; the reference's paths for them
(reference/render.py pt_samples) walked over a tree of the program's
quality (reference/sah.py, a frozen copy of the program's binned-SAH
builder) and, for comparison, over the reference's own median-split tree.
Every test of every ray is counted (no walk is finished by testing every
triangle). Operations per ray: slab tests x SLAB_OPS + triangle tests x
TRIANGLE_OPS + SKY_OPS per closest ray that misses (its sky evaluation),
over the closest and shadow rays. Prints one JSON line per seed and tree,
and the totals last.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[2]

# Operations of one slab test and one Moller-Trumbore test (each add,
# subtract, multiply, divide, min, max, abs and compare is one), and of one
# sky evaluation: the program's own counts (ops/counted.py, ops/skyround.py).
SLAB_OPS = 25
TRIANGLE_OPS = 60
SKY_OPS = 88
PIXELS = 4096
SAMPLES = 4


def ops_per_ray(work: dict) -> float:
    rays = work["closest"] + work["shadow"]
    misses = work["closest"] - work["closest_hits"]
    ops = ((work["closest_slabs"] + work["shadow_slabs"]) * SLAB_OPS
           + (work["closest_tests"] + work["shadow_tests"]) * TRIANGLE_OPS + misses * SKY_OPS)
    return ops / rays


def summary(work: dict) -> dict:
    rays = work["closest"] + work["shadow"]
    return dict(rays=rays, slab_tests_per_ray=(work["closest_slabs"] + work["shadow_slabs"]) / rays,
                triangle_tests_per_ray=(work["closest_tests"] + work["shadow_tests"]) / rays,
                closest_miss_share=(work["closest"] - work["closest_hits"]) / work["closest"],
                ops_per_ray=ops_per_ray(work))


def count(cell, seeds, pixels: int, samples: int, device, log=sys.stdout) -> dict:
    """{tree: the summed walk work} over the seeds, tree "sah" and "median"."""
    import numpy as np
    import torch

    from portbench import assets
    from portbench.reference import bvh, render, sah
    from portbench.reference import sky as ref_sky
    from portbench.session import Session

    cfg, mix = cell.config, cell.mix
    w, h = cfg["width"], cfg["height"]
    gen = assets.generate(cfg)
    sky_cfg, cam = cfg["sky"], cfg["camera"]
    sky = ref_sky.sky_state(sky_cfg["turbidity"], sky_cfg["albedo"],
                            sky_cfg["sun_zenith_degrees"], sky_cfg["sun_azimuth_degrees"])
    trees = {"sah": sah.tree, "median": bvh.build}
    totals = {}
    tail = bvh.TAIL_STEPS
    bvh.TAIL_STEPS = 1 << 30  # every ray walks to its end: its every test counted
    try:
        for name, build_tree in trees.items():
            t0 = time.perf_counter()
            scene = render.make_scene(gen, device, build_tree=build_tree)
            built = time.perf_counter() - t0
            work = render.new_counter()
            for seed in seeds:
                session = Session(seed, mix, w, h)
                rng = np.random.default_rng([int(seed) % 2**64, 1])
                flat = torch.from_numpy(rng.choice(w * h, size=pixels, replace=False)).to(device)
                ys, xs = (flat // w).repeat(samples), (flat % w).repeat(samples)
                frames = (session.start_frame + torch.arange(samples, device=device)
                          ).repeat_interleave(pixels)
                one = render.new_counter()
                c = render.camera(*session.pose(0), cam["aperture"], cam["focus_distance"],
                                  cam["vfov_degrees"], w / h)
                render.pt_samples(scene, sky, c, ys, xs, frames, width=w, height=h,
                                  spp=mix["spp"], bounces=mix["bounces"], counter=one)
                for k in work:
                    work[k] += one[k]
                if log is not None:
                    print(json.dumps(dict(tree=name, seed=seed, built_s=built, **summary(one))),
                          file=log, flush=True)
            totals[name] = work
    finally:
        bvh.TAIL_STEPS = tail
    return totals


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    import torch

    from portbench import cells

    totals = count(cells.find(args.workload), args.seeds, PIXELS, SAMPLES, torch.device("cpu"))
    print(json.dumps({"workload": args.workload, "seeds": args.seeds, "pixels": PIXELS,
                      "samples": SAMPLES,
                      **{name: summary(work) for name, work in totals.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
