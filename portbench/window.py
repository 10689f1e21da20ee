"""The window's arithmetic: rates, tails and busy time over records.

A frame record is one closed-loop step of the window: host clock at its
start and end (seconds) and the pixel samples it completed.
"""

from __future__ import annotations

import math


def window_seconds(frames) -> float:
    """From the first frame's start to the last frame's end."""
    return frames[-1]["t1"] - frames[0]["t0"]


def rate(frames, key: str = "samples") -> float:
    """All the work of the window over all its time."""
    return sum(f[key] for f in frames) / window_seconds(frames)


def mean_frame_s(frames) -> float:
    """The window over the frames it completed."""
    return window_seconds(frames) / len(frames)


def percentile(values, q: float) -> float:
    """The q-th percentile of every value, linearly interpolated between
    closest ranks (numpy's default)."""
    v = sorted(values)
    if not v:
        raise ValueError("no values")
    pos = (len(v) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def latencies(frames):
    return [f["t1"] - f["t0"] for f in frames]


def merge(intervals):
    """Union of (start, end) intervals, as sorted disjoint intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return [tuple(x) for x in out]


def clip(intervals, lo: float, hi: float):
    return [(max(s, lo), min(e, hi)) for s, e in intervals if e > lo and s < hi]


def busy_seconds(intervals, lo: float, hi: float) -> float:
    """Seconds of [lo, hi] covered by at least one interval."""
    return sum(e - s for s, e in merge(clip(intervals, lo, hi)))
