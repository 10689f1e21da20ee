"""K7, the slab-entry reductions, timed at the TPU probe's shapes and at the
efficiency shape.

Counterpart of prof/probe_prebuilt.py, which timed the TPU's prebuilt
entry table: S groups of G = 128 boxes (random mins, maxs = mins + 1)
against one 128-ray tile (random origins and inverse directions, bound
1e4), the table plus per-group minima. Here K7 (ops/slab.py) computes the
need, the per-group minima (with and without writing them) and the
front-to-back selection at that shape, and then at the shape of the bench's
efficiency figures: the 512 x 512 primary rays of the bench camera against
every leaf of courtyard_scene(scale).

    python -m rayfinder_tpu_torch.prof.probe_prebuilt [S=24] [--scale 26] [--reps 200]

Needs a CUDA device: the times are the kernel's (CUDA events over
back-to-back launches).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..ops.slab import slab_entry_reduce

G = 128
TILE = 128


def time_ms(fn, reps: int) -> float:
    """Mean device time of fn() over reps launches, after one warm-up."""
    fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def probe_inputs(s: int, dev, seed: int = 0):
    """The TPU probe's inputs: S*G boxes and a TILE-ray tile. Returns
    (box_min, box_max, weight, origin, inv_dir, bound)."""
    rng = np.random.default_rng(seed)
    mins = rng.random((s * G, 3), dtype=np.float32)
    rays = rng.standard_normal((TILE, 9), dtype=np.float32)

    def to(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    return (to(mins), to(mins + np.float32(1.0)), torch.ones(s * G, dtype=torch.int32, device=dev),
            to(rays[:, 0:3]), to(rays[:, 6:9]), torch.full((TILE,), 1e4, device=dev))


def run_probe(s: int, dev, reps: int) -> dict:
    """K7's time at the probe's shape, with and without the group minima."""
    args = probe_inputs(s, dev)
    return {
        "with_group_min_ms": time_ms(lambda: slab_entry_reduce(*args, G, True), reps),
        "need_and_first_ms": time_ms(lambda: slab_entry_reduce(*args, G, False), reps),
        "pairs": s * G * TILE,
    }


def run_efficiency_shape(scale: int, dev, reps: int) -> dict:
    """K7's time at the efficiency shape: the bench's primary rays against
    every leaf of the courtyard, bound = a far t_max."""
    from ..render.camera import create_camera
    from .diag_iters import leaf_boxes, primary_rays
    from .scenes import BENCH_CAMERA, courtyard_pt_scene

    scene, _ = courtyard_pt_scene(scale, device=dev)
    box_min, box_max, weight, _ = leaf_boxes(scene)
    o, d = primary_rays(create_camera(*BENCH_CAMERA, 1.0), 512, 512, dev)
    inv = (1.0 / d).contiguous()
    bound = torch.full((o.shape[0],), 1e4, device=dev)
    ms = time_ms(lambda: slab_entry_reduce(box_min, box_max, weight, o, inv, bound, G), reps)
    return {"ms": ms, "rays": o.shape[0], "leaves": box_min.shape[0],
            "pairs": o.shape[0] * box_min.shape[0]}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("s", type=int, nargs="?", default=24)
    ap.add_argument("--scale", type=int, default=26)
    ap.add_argument("--reps", type=int, default=200)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("probe_prebuilt: needs a CUDA device (the times are the kernel's)")
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    p = run_probe(args.s, dev, args.reps)
    print(f"K7 at S={args.s} x G={G} boxes x {TILE} rays ({p['pairs']} pairs): with group "
          f"minima {p['with_group_min_ms'] * 1e3:.3f} us, need + selection only "
          f"{p['need_and_first_ms'] * 1e3:.3f} us [{name}]", flush=True)
    e = run_efficiency_shape(args.scale, dev, max(1, args.reps // 50))
    print(f"K7 at {e['rays']} rays x {e['leaves']} leaves ({e['pairs']} pairs): "
          f"{e['ms']:.3f} ms, {e['pairs'] / e['ms'] / 1e9:.3f} Gpairs/s [{name}]", flush=True)


if __name__ == "__main__":
    main()
