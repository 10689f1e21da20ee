"""The device's side of a traced window, from torch.profiler.

The window runs under `torch.profiler.profile` (CPU and CUDA activities)
inside a span named `portbench.window`; the trace is exported as Chrome
trace JSON into the cache directory, read back and deleted. Device events
are the kernels, copies and fills (`cat` kernel, gpu_memcpy, gpu_memset);
host events the operators and the harness's own spans (`portbench.*`).
Times are in seconds on the trace's clock.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import pathlib
from collections import defaultdict

from . import window as win

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# A breakdown names an operation by at most this many characters of its name.
NAME_CHARS = 160
HOST_CATS = ("cpu_op", "user_annotation", "python_function")
WINDOW_SPAN = "portbench.window"


class Trace:
    """device: [(name, start, end)] sorted by start; host: the same for the
    host's events; window: (start, end) of the window's span."""

    def __init__(self, device, host, window):
        self.device = device
        self.host = host
        self.window = window

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def in_window(self):
        lo, hi = self.window
        return [(n, max(s, lo), min(e, hi)) for n, s, e in self.device if e > lo and s < hi]

    def busy_s(self) -> float:
        return win.busy_seconds([(s, e) for _, s, e in self.device], *self.window)

    def device_ops(self, top: int = 10):
        """The device operations that took most time: [[name, seconds]]."""
        tot = defaultdict(float)
        for n, s, e in self.in_window():
            tot[n] += e - s
        return [[n[:NAME_CHARS], t] for n, t in sorted(tot.items(), key=lambda x: -x[1])[:top]]

    def idle_gaps(self, top: int = 10):
        """The device's idle time inside the window by what the host was
        doing meanwhile (the innermost host event over the gap's middle):
        [[name, seconds]] of the names with the most idle time."""
        lo, hi = self.window
        busy = win.merge([(s, e) for _, s, e in self.in_window()])
        gaps, t = [], lo
        for s, e in busy:
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if hi > t:
            gaps.append((t, hi))
        host = [h for h in self.host if h[0] != WINDOW_SPAN]
        starts = [s for _, s, _ in host]
        tot = defaultdict(float)
        for g0, g1 in gaps:
            mid = 0.5 * (g0 + g1)
            i = bisect.bisect_right(starts, mid) - 1
            name = "(no host event)"
            while i >= 0:
                n, s, e = host[i]
                if e >= mid:
                    name = n
                    break
                i -= 1
                if mid - s > 1.0:
                    break
            tot[name] += g1 - g0
        return [[n[:NAME_CHARS], t] for n, t in sorted(tot.items(), key=lambda x: -x[1])[:top]]


def parse(path: pathlib.Path) -> Trace:
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    device, host, window = [], [], None
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat, name = ev.get("cat", ""), ev.get("name", "")
        s = float(ev["ts"]) * 1e-6
        e = s + float(ev.get("dur", 0.0)) * 1e-6
        if cat in DEVICE_CATS:
            device.append((name, s, e))
        elif cat in HOST_CATS:
            host.append((name, s, e))
            if name == WINDOW_SPAN and cat == "user_annotation":
                window = (s, e)
    if window is None:
        raise RuntimeError(f"the trace holds no {WINDOW_SPAN} span")
    device.sort(key=lambda x: x[1])
    host.sort(key=lambda x: x[1])
    return Trace(device, host, window)


@contextlib.contextmanager
def traced(enabled: bool, path: pathlib.Path):
    """Profile the body when enabled; `holder["trace"]` is the parsed Trace
    afterwards (None when not enabled)."""
    holder = {"trace": None}
    if not enabled:
        yield holder
        return
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(WINDOW_SPAN):
            yield holder
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    try:
        holder["trace"] = parse(path)
    finally:
        os.remove(path)
