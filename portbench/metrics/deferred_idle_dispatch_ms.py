"""Device idle ms per frame while the host dispatches the deferred frame's
passes: inside the program's spans rf.deferred.gbuffer, rf.deferred.lighting
and rf.deferred.resolve (render/deferred.py frame_pass) and their children,
over the traced window's idle intervals (portbench/spans.py)."""

from portbench import spans

NAMES = ("rf.deferred.gbuffer", "rf.deferred.lighting", "rf.deferred.resolve")


def read(run):
    return spans.idle_ms_per_frame(run, NAMES, self_time=False)
