"""Interior BVH records that K4's walks read per ray the program traced in
the window: its counter rf.walk_records (Renderer(count_rays=True), counted
inside csrc/regen_shaded.cu, closest and shadow walks), summed over the
window's frames from the program's recorder (portbench/spans.py), over the
closest and shadow rays it counted there. A walk that reads more records per
ray reads higher; a dearer record does not move it (k4_ns_per_record). None
from a program without the counter."""

from portbench import spans


def read(run):
    per = spans.count_per_frame(run, "rf.walk_records")
    if per is None or not run.rays:
        return None
    return per * len(run.frames) / run.rays
