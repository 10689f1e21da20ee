"""Triangle tests that K4's walks make per ray the program traced in the
window: its counter rf.walk_tests (Renderer(count_rays=True), counted inside
csrc/regen_shaded.cu, closest and shadow walks), summed over the window's
frames from the program's recorder (portbench/spans.py), over the closest
and shadow rays it counted there. Where leaves hold many overlapping
triangles (foliage) a walk tests more of them per record it reads
(walk_records_per_ray). None from a program without the counter."""

from portbench import spans


def read(run):
    per = spans.count_per_frame(run, "rf.walk_tests")
    if per is None or not run.rays:
        return None
    return per * len(run.frames) / run.rays
