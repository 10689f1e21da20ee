"""Pass timing with device fencing, and the program's spans and counters.

Counterpart of `rayfinder_tpu.utils.profiling`, the analog of the
reference's GPU timestamp queries (reference_path_tracer.cpp:472-480,
653-703): wall-clock sections, optionally fenced on the device that produced
a tensor, kept in 30-entry rolling deques like the reference's perf UI.

`span(name)` names a phase of the renderers where its work happens and
`count(name, n)` adds to a named counter. Both are off, and cost one check,
unless torch.profiler is running or a `recording()` block is open. When on,
a span opens `torch.profiler.record_function(name)` (a `user_annotation` in
the profiler's trace, on the clock of the device's kernels and copies) and
appends a `Span` to the recorder: the innermost open `recording()` block's,
else `PROFILED`, which holds what the program recorded under the profiler
until a reader takes it. The renderers run on one thread; so do spans.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import time

import torch

# The bytes of host arrays that the frame path copies to the scene's device.
H2D_BYTES = "rf.h2d_bytes"
# Builds of the pixel tables on a device (render/tiling.py block_order_on).
PIXEL_TABLES = "rf.pixel_tables"
# The bytes of the deferred renderer's frame that it copies to the host.
D2H_BYTES = "rf.d2h_bytes"
# The interior BVH records that K4's walks read (Renderer(count_rays=True)).
WALK_RECORDS = "rf.walk_records"
# The triangle tests that K4's walks make (Renderer(count_rays=True)).
WALK_TESTS = "rf.walk_tests"
# The depth of a scene's BVH, counted once at its load (render/scene.py).
TREE_DEPTH = "rf.scene.tree_depth"
# Deferred frames whose passes ran as CUDA kernels (1 a frame that did, 0 one
# that did not; render/deferred.py DeferredRenderer.render).
KERNEL_FRAMES = "rf.deferred.kernel_frames"


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


@dataclasses.dataclass(slots=True)
class Span:
    """One span: host start and end on time.perf_counter() (end None while
    open), the enclosing span's name (None at the top), the renderer's frame
    number, and for a device span on the card the device's ms between the
    CUDA events recorded at its start and end (None until both are done)."""

    name: str
    t0: float
    t1: float | None
    parent: str | None
    frame: int | None
    device_ms: float | None = None
    events: tuple | None = None

    def _read_events(self) -> None:
        start, end = self.events
        if end is not None and end.query():
            self.device_ms = start.elapsed_time(end)
            self.events = None


@dataclasses.dataclass(slots=True)
class Count:
    """n added to counter `name` at host time t, in frame `frame`."""

    name: str
    t: float
    n: int
    frame: int | None


_recording: list[Recorder] = []  # the open recording() blocks, innermost last


class Recorder:
    """The spans and counts of the frames recorded, in the order each span
    opened or count was made. A top-level span given a frame number starts a
    frame; every other record belongs to the frame last started. With
    keep_frames=k only the last k frames are held."""

    def __init__(self, keep_frames: int | None = None):
        if keep_frames is not None and keep_frames < 1:
            raise ValueError(f"keep_frames={keep_frames}: at least 1, or None for all")
        self._frames: collections.deque[list] = collections.deque(maxlen=keep_frames)
        self._open: list[Span] = []
        self._frame: int | None = None

    def _append(self, record) -> None:
        if not self._frames:
            self._frames.append([])
        self._frames[-1].append(record)

    def records(self) -> list:
        """Every record held; device times are read where their events are
        done (after the frame's synchronise), never waited for."""
        out = [r for frame in self._frames for r in frame]
        for r in out:
            if isinstance(r, Span) and r.events is not None:
                r._read_events()
        return out

    def spans(self, name: str) -> list[Span]:
        return [r for r in self.records() if isinstance(r, Span) and r.name == name]

    def take(self) -> list:
        """The records, which the recorder then no longer holds."""
        out = self.records()
        self._frames.clear()
        return out

    def __enter__(self) -> Recorder:
        _recording.append(self)
        return self

    def __exit__(self, *exc):
        _recording.remove(self)
        return False


class _Open:
    """A span while it is open."""

    __slots__ = ("_recorder", "_name", "_device", "_frame", "_span", "_annotation")

    def __init__(self, recorder: Recorder, name: str, device: bool, frame: int | None):
        self._recorder, self._name, self._device, self._frame = recorder, name, device, frame

    def __enter__(self):
        rec = self._recorder
        parent = rec._open[-1] if rec._open else None
        if parent is None and self._frame is not None:
            rec._frame = self._frame
            rec._frames.append([])
        span = Span(self._name, 0.0, None, parent and parent.name,
                    rec._frame if parent is None else parent.frame)
        rec._append(span)
        rec._open.append(span)
        self._span = span
        self._annotation = torch.profiler.record_function(self._name)
        self._annotation.__enter__()
        if self._device and torch.cuda.is_initialized():
            start = torch.cuda.Event(enable_timing=True)
            start.record()
            span.events = (start, None)
        span.t0 = time.perf_counter()
        return span

    def __exit__(self, *exc):
        span = self._span
        span.t1 = time.perf_counter()
        if span.events is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            span.events = (span.events[0], end)
        self._recorder._open.pop()
        self._annotation.__exit__(*exc)
        return False


_OFF = contextlib.nullcontext()
_profiler_enabled = torch.autograd._profiler_enabled

# What the program records while torch.profiler runs and no recording()
# block is open, held until a reader takes it.
PROFILED = Recorder()


def recorder() -> Recorder | None:
    """The innermost open recording() block's recorder, or None."""
    return _recording[-1] if _recording else None


def span(name: str, device: bool = False, frame: int | None = None):
    """A context manager naming a phase of the program. Off: one shared no-op.
    On: a record_function and a Span in the recorder; device=True adds a
    pair of CUDA events on the current stream where CUDA is in use; frame
    (on a top-level span) is the renderer's frame number, which every span
    inside it shares."""
    if not (_recording or _profiler_enabled()):
        return _OFF
    return _Open(recorder() or PROFILED, name, device, frame)


def count(name: str, n: int) -> None:
    """Add n to counter `name` (nothing while off)."""
    if not (_recording or _profiler_enabled()):
        return
    rec = recorder() or PROFILED
    rec._append(Count(name, time.perf_counter(), int(n), rec._frame))


def recording(keep_frames: int | None = None) -> Recorder:
    """A new Recorder, which keeps the last keep_frames frames (all when
    None). Spans and counts are on, and go to it, while a `with` block holds
    it open."""
    return Recorder(keep_frames)
