"""Device idle ms per frame while the deferred frame's output reaches the
user: inside the program's spans rf.deferred.readback (the display bytes'
copy to the host) and rf.deferred.to_float (their float32 conversion in
numpy) of render/deferred.py DeferredRenderer.render, over the traced
window's idle intervals (portbench/spans.py)."""

from portbench import spans

NAMES = ("rf.deferred.readback", "rf.deferred.to_float")


def read(run):
    return spans.idle_ms_per_frame(run, NAMES, self_time=False)
