"""What --seed decides: the session of one user, drawn from a mix file.

Every seed gets the same amount of work, in another order: the mix fixes a
set of camera views (converge) or a closed fly loop (fly) that a window
goes round many times; the seed picks which view or which point of the loop
comes first, moves the poses by a small offset within the mix's `jitter`
(for converge one of each pose's own, so that consecutive passes over one
view are new poses, which reset the accumulation; for fly one for the whole
loop), picks
the path tracer's starting frame index (which sets the noise sequence; the
deferred renderer's window starts from frame 0), and draws the pixels whose
values the check compares.
"""

from __future__ import annotations

import numpy as np


class Session:
    def __init__(self, seed: int, mix: dict, width: int, height: int):
        self._entropy = int(seed) % 2**64
        rng = np.random.default_rng(self._entropy)
        self.mix = mix
        self.start_frame = int(rng.integers(0, mix["start_frame_below"]))
        views = mix.get("views")
        if mix["kind"] == "converge":
            self._first = int(rng.integers(0, len(views)))
        else:
            self._phase = float(rng.uniform(0.0, 1.0))
        n = mix["check_pixels"]
        flat = np.sort(rng.choice(width * height, size=n, replace=False))
        self.ys, self.xs = (flat // width).astype(np.int64), (flat % width).astype(np.int64)

    def pose(self, k: int):
        """(eye, look_at) of pose k: the k-th pass of a converge session or
        the k-th frame of a fly session."""
        if self.mix["kind"] == "converge":
            views = self.mix["views"]
            eye, look = views[(self._first + k) % len(views)]
        else:
            eye, look = _loop(self.mix["loop"], self._phase, k)
        # A converge pose's offset is its own; a fly session's is one for the loop.
        rng = np.random.default_rng([self._entropy, k if self.mix["kind"] == "converge" else 0])
        jit = self.mix["jitter"]
        eye = np.asarray(eye, np.float64) + rng.uniform(-1.0, 1.0, 3) * np.asarray(jit["eye"])
        look = np.asarray(look, np.float64) + rng.uniform(-1.0, 1.0, 3) * np.asarray(jit["look_at"])
        return [float(x) for x in eye], [float(x) for x in look]


def _loop(loop: dict, phase: float, k: int):
    """The point of the closed fly loop at frame k: the eye and the point
    looked at move along their own closed polylines at a constant share of
    the loop per frame, starting at `phase`."""
    s = (phase + k / loop["frames_per_lap"]) % 1.0
    return _along(loop["eye"], s), _along(loop["look_at"], s)


def _along(points, s: float):
    p = np.asarray(points, np.float64)
    seg = np.linalg.norm(np.roll(p, -1, axis=0) - p, axis=1)
    d = s * seg.sum()
    i = int(np.searchsorted(np.cumsum(seg), d, side="right"))
    i = min(i, len(p) - 1)
    start = np.cumsum(seg)[i] - seg[i]
    f = (d - start) / seg[i] if seg[i] > 0 else 0.0
    return p[i] + f * (p[(i + 1) % len(p)] - p[i])
