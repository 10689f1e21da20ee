"""K4's share of its roofline in the traced window, in %: the least time the
card could take for the window's K4 work over K4's device time
(ops/regen_shaded.py; csrc/regen_shaded.cu trace_regen_shaded_*_kernel, its
tile, item and fold kernels, by name in the trace).

The least time is the larger of the operations over 67 TFLOP/s (float32
outside the tensor cores, NVIDIA's data sheet for the H100 SXM at 700 W)
and the bytes over 3.35 TB/s. Operations: the rays the program counted in
the window (closest + shadow) times the cell's frozen operations per ray,
plus its operations per pixel sample. Both are the cell's own data, in
work/<cell>.json under "k4", counted once by tools/work.py with the
reference's walk over a tree of the program's quality (reference/sah.py),
never read from the program: a walk that needs fewer tests reads as a
higher share, not as a smaller bound. A cell whose window runs K4 without
that file or entry raises. Bytes: per K4 launch the scene's triangles (36
bytes each), and 24 bytes per pixel sample (the item scratch, written once
and read once). The card's power limit is printed beside the share on the
line (device.power_limit_w).

The kernel the traced window runs is the untraced window's: K4 counts its
rays in every call (ops/regen_shaded.py), and Renderer(count_rays=True)
only reads that count back once per dispatch.
"""

import json

from portbench import cells

F32_OPS_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12
K4_KERNELS = ("trace_regen_shaded",)
TRIANGLE_BYTES = 36
ITEM_BYTES = 24
WORK = cells.HERE / "work"


def work(cell: str) -> dict:
    """The cell's frozen K4 work: {"ops_per_ray", "ops_per_sample", ...}."""
    path = WORK / f"{cell}.json"
    try:
        with open(path) as f:
            return json.load(f)["k4"]
    except (OSError, KeyError) as e:
        raise KeyError(f"K4 runs in {cell}'s window, but {path.name} under work/ gives no "
                       f"'k4' operations for it (tools/work.py counts them)") from e


def read(run):
    tr = run.trace
    if tr is None:
        return None
    k4 = [(s, e) for n, s, e in tr.in_window() if any(k in n for k in K4_KERNELS)]
    if not k4:
        return None
    per = work(run.cell.name)
    if run.rays is None:
        return None
    k4_s = sum(e - s for s, e in k4)
    samples = sum(f["samples"] for f in run.frames)
    ops = run.rays * per["ops_per_ray"] + samples * per["ops_per_sample"]
    launches = sum(1 for n, _, _ in tr.in_window() if "items_kernel" in n) or len(run.frames)
    triangles = run.spans["triangles"]
    nbytes = launches * triangles * TRIANGLE_BYTES + samples * ITEM_BYTES
    bound_s = max(ops / F32_OPS_PER_S, nbytes / HBM_BYTES_PER_S)
    return 100.0 * bound_s / k4_s
