"""The 95th percentile of every frame's latency in the traced window, in ms:
the frame from its start to its output on the host, as `frame_ms` times it,
here under the profiler, which lengthens every frame."""

from portbench import window


def read(run):
    if not run.frames:
        return None
    return window.percentile(window.latencies(run.frames), 95.0) * 1e3
