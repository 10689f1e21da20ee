"""Device idle ms per batch while the path tracer's host prepares a dispatch:
inside the self time of the program's spans rf.pt.lanes (the pixel tables,
u, v_tex and the blue-noise gather of render/pathtracer.py
accumulate_samples_regen) and rf.pt.initial_state (_initial_state), over
the traced window's idle intervals (portbench/spans.py)."""

from portbench import spans

NAMES = ("rf.pt.lanes", "rf.pt.initial_state")


def read(run):
    return spans.idle_ms_per_frame(run, NAMES, self_time=True)
