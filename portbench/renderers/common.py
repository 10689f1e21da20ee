"""What the renderers' frame loops share: the frame loop's clock and the records."""

from __future__ import annotations

import contextlib
import time

import numpy as np


def sync(device) -> None:
    if getattr(device, "type", None) == "cuda":
        import torch

        torch.cuda.synchronize(device)


def frame_scope(trace: bool, name: str):
    """A named span in the profiler's trace for the frame (trace runs only)."""
    if not trace:
        return contextlib.nullcontext()
    import torch

    return torch.profiler.record_function(name)


def run_loop(step, seconds: float, trace: bool):
    """Call step(k) for frames k = 0, 1, ... until `seconds` have passed
    since the first began; each returns its record, to which the loop adds
    the host clock at the frame's start and end (t0, t1). A frame ends when
    its output is on the host, so no device work runs past t1."""
    frames = []
    start = time.perf_counter()
    k = 0
    while True:
        t0 = time.perf_counter()
        with frame_scope(trace, "portbench.frame"):
            rec = step(k)
        t1 = time.perf_counter()
        rec["t0"], rec["t1"] = t0, t1
        frames.append(rec)
        k += 1
        if t1 - start >= seconds:
            return frames


def pixels_u8(image: np.ndarray, ys, xs) -> np.ndarray:
    """The check's pixels of a (H, W, 3) frame, as bytes; a float frame in
    [0, 1] is the display byte over 255."""
    px = image[ys, xs]
    if px.dtype != np.uint8:
        px = np.rint(px * np.float32(255.0)).astype(np.uint8)
    return px
