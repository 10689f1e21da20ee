"""One run of one cell: set-up, the measured window, the check, the line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up builds the program's scene from the configuration's `.pt` (written
through the program's asset path on a checkout's first run), makes the
renderer's session and warms the cell's own shapes. The window then drives
frames back to back for `--seconds` seconds (a closed loop: one user, each
frame waiting for the last). With --trace 1 the window runs under
torch.profiler, and the line carries the per-layer metrics in place of the
end-to-end ones. After the window: the peak device memory, the program's
state freed, the reference over what the window recorded, the check.

`setup_s` runs from the process's start to the window's first frame, and
so holds, on a checkout's first run, the kernel library's build and the
`.pt`'s writing. The line's `setup` key gives its parts apart: `start_s`
(imports, the card's look-up), `kernels_s` (the library's load or build),
`pt_write_s` (0 once the `.pt` is there), `scene_load_s`, `renderer_s` and
`warm_s`.
"""

from __future__ import annotations

import gc
import json
import sys
import time

import numpy as np

from . import assets, cells, check
from .reference import render as ref_render
from . import trace as tracing
from .session import Session

BANNED = ("jax", "jaxlib", "flax", "rayfinder_tpu")


class Run:
    """What a metric reader reads: the window's frames, the trace (None
    without --trace 1), the rays the program counted in the window (None
    where it counts none), the set-up's spans, the cell, and the card's
    power limit."""

    def __init__(self, cell, frames, trace, rays, spans, setup_s, power_limit_w):
        self.cell = cell
        self.frames = frames
        self.trace = trace
        self.rays = rays
        self.spans = spans
        self.setup_s = setup_s
        self.power_limit_w = power_limit_w


def banned_modules() -> list[str]:
    """Top-level names of loaded modules that the benchmark may not load."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(BANNED))


def power_limit_w():
    """The card's power limit from nvidia-smi, or None where it cannot say."""
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"], capture_output=True,
                             text=True, timeout=20, check=True).stdout
        return float(out.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def load_kernels():
    """Seconds to load the program's kernel library, which builds it on a
    checkout's first run (nvcc); None where the program has no such entry,
    and the library then loads at the warm-up's first kernel."""
    t0 = time.perf_counter()
    try:
        from rayfinder_tpu_torch.ops import _build
    except ImportError:
        return None
    library = getattr(_build, "library", None)
    if library is None:
        return None
    library()
    return time.perf_counter() - t0


def execute(cell, seed: int, seconds: float, trace: bool, device, t_process: float,
            log=sys.stderr) -> dict:
    """Run the cell once on `device` and return the result line's fields."""
    import torch

    cfg, mix = cell.config, cell.mix
    setup = {"start_s": time.perf_counter() - t_process}
    session = Session(seed, mix, cfg["width"], cfg["height"])
    loop = cells.load_module("renderers", cfg["renderer"])
    if device.type == "cuda":
        setup["kernels_s"] = load_kernels()
    scene, spans = assets.load(cfg, device)
    setup.update(pt_write_s=spans["pt_write_s"], scene_load_s=spans["scene_load_s"])
    t0 = time.perf_counter()
    user = loop.User(scene, cfg, mix, session, device, count_rays=trace)
    t1 = time.perf_counter()
    user.warm()
    setup.update(renderer_s=t1 - t0, warm_s=time.perf_counter() - t1)
    rays0 = user.rays()
    with tracing.traced(trace, assets.CACHE / "trace.json") as held:
        frames = user.window(seconds, trace)
    rays1 = user.rays()
    setup_s = frames[0]["t0"] - t_process
    peak = int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0
    user.close()
    del user, scene
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    print(f"window: {len(frames)} frames in {frames[-1]['t1'] - frames[0]['t0']:.3f} s, "
          f"set-up {setup_s:.3f} s: {json.dumps(setup)}", file=log)

    t0 = time.perf_counter()
    program = np.stack([f["out"] for f in frames])
    work = ref_render.new_counter()
    reference = loop.reference(assets.generate(cfg), cfg, mix, session, frames, device,
                                     counter=work)
    values = check.numbers(program, reference)
    correct, compared = check.judge(values, cell.limits)
    print(f"reference: {time.perf_counter() - t0:.3f} s over {program.shape[0]} frames x "
          f"{program.shape[1]} pixels; its walks: {json.dumps(work)}", file=log)

    run = Run(cell, frames, held["trace"], None if rays0 is None else rays1 - rays0, spans,
              setup_s, power_limit_w() if trace else None)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        folder = "metrics" if trace else "end_to_end"
        value = cells.load_module(folder, m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": peak}
    line = {"correct": bool(correct), "attempted": len(frames), "failed": 0,
            "metrics": metrics, "device": dev}
    if trace:
        tr = run.trace
        dev["busy_s"] = tr.busy_s()
        dev["window_s"] = tr.window_s
        line["breakdown"] = {"device_ops": tr.device_ops(), "idle_gaps": tr.idle_gaps()}
        if run.power_limit_w is not None:
            dev["power_limit_w"] = run.power_limit_w
    line["setup"] = setup
    line["check"] = compared
    return line


def print_line(line: dict, out=sys.stdout, log=sys.stderr) -> None:
    """The result as the last line of standard output, the compared numbers
    beside their limits as the last lines of standard error."""
    print(json.dumps(line), file=out, flush=True)
    for name, v in line["check"].items():
        print(f"check {name} {v['value']!r} limit {v['limit']!r}", file=log, flush=True)
