"""The program's own spans and counters, as the per-layer readers read them.

The program (rayfinder_tpu_torch/utils/profiling.py) names its phases with
spans whose names begin with `rf.` and counts its host-to-device bytes under
`rf.h2d_bytes`; both are on only while torch.profiler runs, so in the traced
window alone. They come from two places:

- the trace (`run.trace.host`): each span as a `user_annotation`, on the
  trace's clock with the device's kernels and copies. The device's idle
  time inside a span is read here;
- the program's recorder (`profiling.PROFILED`): its spans with the device
  time between their CUDA events, and its counts, on the host's
  time.perf_counter() clock, as the window's frame records are.

A program without them (one from before its spans) gives nothing there, and
every reader returns None.
"""

from __future__ import annotations

import bisect

from rayfinder_tpu_torch.utils import profiling

from . import window as win

PREFIX = "rf."


def idle_intervals(trace):
    """The device's idle intervals inside the traced window: the window less
    the merged intervals of its kernels, copies and fills."""
    lo, hi = trace.window
    gaps, t = [], lo
    for s, e in win.merge([(s, e) for _, s, e in trace.in_window()]):
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if hi > t:
        gaps.append((t, hi))
    return gaps


def program_spans(trace):
    """The program's spans in the trace: [(name, start, end)] by start."""
    return [h for h in trace.host if h[0].startswith(PREFIX)]


def _less(interval, holes):
    """[interval] less the union of the intervals in holes."""
    out, t = [], interval[0]
    for s, e in win.merge(holes):
        if s > t:
            out.append((t, min(s, interval[1])))
        t = max(t, e)
    if interval[1] > t:
        out.append((t, interval[1]))
    return [(s, e) for s, e in out if e > s]


def self_intervals(spans, names):
    """The self time of every span named in `names`: its interval less the
    program's spans inside it (spans sorted by start)."""
    starts = [s for _, s, _ in spans]
    out = []
    for i, (n, s, e) in enumerate(spans):
        if n not in names:
            continue
        inside = []
        for j in range(bisect.bisect_left(starts, s), bisect.bisect_left(starts, e)):
            _, cs, ce = spans[j]
            if j != i and ce <= e:
                inside.append((cs, ce))
        out.extend(_less((s, e), inside))
    return out


def overlap_s(a, b) -> float:
    """Seconds covered by both unions of intervals."""
    a, b = win.merge(a), win.merge(b)
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_ms_per_frame(run, names, self_time: bool):
    """Device idle ms per frame of the window inside the spans named in
    `names`: inside their self time, or with `self_time` False inside their
    whole intervals, their child spans' too. None where the trace holds none
    of them."""
    tr = run.trace
    if tr is None or not run.frames:
        return None
    spans = program_spans(tr)
    if not any(n in names for n, _, _ in spans):
        return None
    inside = (self_intervals(spans, names) if self_time
              else [(s, e) for n, s, e in spans if n in names])
    return 1e3 * overlap_s(idle_intervals(tr), inside) / len(run.frames)


def records():
    """What the program recorded while the profiler ran, or None where the
    program keeps no recorder."""
    held = getattr(profiling, "PROFILED", None)
    return None if held is None else held.records()


def count_per_frame(run, name: str):
    """The counts of counter `name` made inside the window (from the first
    frame's start to the last frame's end) over its frames; None where the
    program made none."""
    recs = records()
    if not recs or not run.frames:
        return None
    counts = [r for r in recs if isinstance(r, profiling.Count) and r.name == name]
    if not counts:
        return None
    lo, hi = run.frames[0]["t0"], run.frames[-1]["t1"]
    return sum(c.n for c in counts if lo <= c.t <= hi) / len(run.frames)


def device_ms_per_frame(run, name: str, frame: str):
    """The mean device ms of span `name` over the frames (top-level spans
    named `frame`) that lie wholly inside the window; None where there is
    none with a device time."""
    recs = records()
    if not recs or not run.frames:
        return None
    lo, hi = run.frames[0]["t0"], run.frames[-1]["t1"]
    top, ms = None, []
    for r in recs:
        if not isinstance(r, profiling.Span):
            continue
        if r.parent is None:
            top = r
        elif (r.name == name and r.device_ms is not None and top is not None
              and top.name == frame and top.t1 is not None and lo <= top.t0 and top.t1 <= hi):
            ms.append(r.device_ms)
    return sum(ms) / len(ms) if ms else None
