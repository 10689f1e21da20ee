"""Megabytes (1e6 bytes) of host arrays the program copied to the card per
batch: its counter rf.h2d_bytes (render/pathtracer.py _pixels, the sky and
sun of accumulate_lanes_regen and the constant of _initial_state;
render/tiling.py unswizzle's index), summed over the window's frames from
the program's recorder (portbench/spans.py)."""

from portbench import spans


def read(run):
    per = spans.count_per_frame(run, "rf.h2d_bytes")
    return None if per is None else per / 1e6
