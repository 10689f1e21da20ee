"""Pass timing with device fencing.

Counterpart of `rayfinder_tpu.utils.profiling`, the analog of the
reference's GPU timestamp queries (reference_path_tracer.cpp:472-480,
653-703): wall-clock sections, optionally fenced on the device that produced
a tensor, kept in 30-entry rolling deques like the reference's perf UI.
"""

from __future__ import annotations

import collections
import contextlib
import time

import torch


class PassTimer:
    def __init__(self, window: int = 30):
        self._durations: dict[str, collections.deque] = {}
        self._window = window

    @contextlib.contextmanager
    def section(self, name: str, fence_value=None):
        """Time a section; pass a tensor as fence_value to wait for its
        device's queued work before the section ends (nothing to wait for
        on the CPU)."""
        t0 = time.perf_counter()
        yield
        if fence_value is not None and fence_value.device.type == "cuda":
            torch.cuda.synchronize(fence_value.device)
        self._durations.setdefault(
            name, collections.deque(maxlen=self._window)
        ).append(time.perf_counter() - t0)

    def averages_ms(self) -> dict[str, float]:
        return {
            name: 1000.0 * sum(d) / len(d) for name, d in self._durations.items() if d
        }

    def report(self) -> str:
        return "  ".join(f"{k}: {v:.1f}ms" for k, v in self.averages_ms().items())
