"""K4's device nanoseconds per interior BVH record that its walks read, in
the traced window: the device time of K4's kernels (by name in the trace,
as metrics/k4_roofline.py finds them) over the program's counter
rf.walk_records in the window (portbench/spans.py). The price of a record
with all of K4's other work per record: a walk that leaves the L2 cache
reads higher at the same walk_records_per_ray. None from a program without
the counter, or from a window that runs no K4."""

from portbench import spans

K4_KERNELS = ("trace_regen_shaded",)


def read(run):
    tr = run.trace
    if tr is None:
        return None
    k4_s = sum(e - s for n, s, e in tr.in_window() if any(k in n for k in K4_KERNELS))
    per = spans.count_per_frame(run, "rf.walk_records")
    if not k4_s or not per:
        return None
    return 1e9 * k4_s / (per * len(run.frames))
