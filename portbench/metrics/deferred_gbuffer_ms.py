"""Device ms per frame of the deferred frame's gbuffer pass: the program's
span rf.deferred.gbuffer (render/deferred.py frame_pass), timed by its pair
of CUDA events from the pass's first device operation to its last, gaps
included, read from the program's recorder for the frames wholly inside the
window (portbench/spans.py)."""

from portbench import spans


def read(run):
    return spans.device_ms_per_frame(run, "rf.deferred.gbuffer", frame="rf.deferred.frame")
