"""The program's spans and its copy counters
(rayfinder_tpu_torch/utils/profiling.py), on the CPU at 32x24 on the plain
engine, and the benchmark's readers of them (portbench/spans.py and the
per-layer readers under portbench/metrics/) on made-up traces and records.
"""

import json
import types

import numpy as np
import pytest
import torch

from portbench import cells, trace
from rayfinder_tpu_torch.render import pathtracer as pt
from rayfinder_tpu_torch.render import tiling
from rayfinder_tpu_torch.render.camera import create_camera
from rayfinder_tpu_torch.render.deferred import DeferredRenderer
from rayfinder_tpu_torch.render.pathtracer import SamplingParams
from rayfinder_tpu_torch.render.renderer import Renderer, RenderParameters, Sky
from rayfinder_tpu_torch.render.rng import blue_noise_tile
from rayfinder_tpu_torch.render.scene import build_device_scene
from rayfinder_tpu_torch.scene.procedural import courtyard_scene
from rayfinder_tpu_torch.sky.model import sky_on_device
from rayfinder_tpu_torch.tools import viewer
from rayfinder_tpu_torch.utils import profiling
from rayfinder_tpu_torch.utils.profiling import (
    D2H_BYTES, H2D_BYTES, KERNEL_FRAMES, PIXEL_TABLES, Count, Span,
)

W, H = 32, 24
SKY = Sky(2.5, (0.3, 0.3, 0.3), 35.0, 25.0)
EXPOSURE = 0.25

# (name, parent) of one frame's spans, in the order they open, on the CPU
# (the card adds rf.pt.sync before the path tracer's readback, and
# rf.deferred.sync after the deferred frame's).
PT_SPANS = [("rf.pt.render", None), ("rf.pt.lanes", "rf.pt.render"),
            ("rf.pt.initial_state", "rf.pt.render"), ("rf.pt.k4", "rf.pt.render"),
            ("rf.pt.image", None), ("rf.pt.unswizzle", "rf.pt.image"),
            ("rf.pt.display", "rf.pt.image"), ("rf.pt.readback", "rf.pt.image")]
DEFERRED_SPANS = [("rf.deferred.frame", None), ("rf.deferred.gbuffer", "rf.deferred.frame"),
                  ("rf.deferred.lighting", "rf.deferred.frame"),
                  ("rf.deferred.resolve", "rf.deferred.frame"),
                  ("rf.deferred.to_float", "rf.deferred.frame"),
                  ("rf.deferred.readback", "rf.deferred.frame")]


@pytest.fixture(scope="module")
def scene():
    flat, textures = courtyard_scene(2, textured=True)
    return build_device_scene(flat, textures=textures, device="cpu")


def _camera():
    return create_camera([-16, 5, 0], [12, 2, 0], 0.0, 1.0, 70.0, W / H)


def _renderer(scene):
    return Renderer(scene, RenderParameters(W, H, _camera(), SamplingParams(8, 2), SKY,
                                            EXPOSURE), engine="plain")


def _pt_batch(r):
    r.render(2)
    r.image_u8()


def _deferred_frame(dr):
    dr.render(_camera(), SKY.state(), EXPOSURE)


def test_off_records_nothing(scene, monkeypatch):
    """With no profiler and no recording() block, a batch and a deferred
    frame open no record_function and record nothing; span() hands out one
    shared no-op and count() returns at once."""

    def refuse(name):
        raise AssertionError(f"{name} opened while the spans are off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    held = len(profiling.PROFILED.records())
    assert profiling.recorder() is None
    _pt_batch(_renderer(scene))
    dr = DeferredRenderer(scene, W, H, engine="plain")
    _deferred_frame(dr)
    assert len(profiling.PROFILED.records()) == held
    assert profiling.span("rf.a") is profiling.span("rf.b", device=True, frame=3)
    assert profiling.count(H2D_BYTES, 5) is None
    assert set(dr.perf_stats()) == {"frame"}


@pytest.mark.parametrize("kind", ["pt", "deferred"])
def test_recording_holds_the_spans_in_order(scene, kind):
    """Inside recording(): each frame's spans in the order they open, each
    inside its parent's interval, all with the frame's number; the recorder
    keeps the last keep_frames frames."""
    if kind == "pt":
        r = _renderer(scene)
        r.frame_count = 5
        want, step, frames = PT_SPANS, lambda: _pt_batch(r), [5, 7, 9]
    else:
        dr = DeferredRenderer(scene, W, H, engine="plain")
        want, step, frames = DEFERRED_SPANS, lambda: _deferred_frame(dr), [0, 1, 2]
    with profiling.recording(keep_frames=2) as rec:
        assert profiling.recorder() is rec
        for _ in range(3):
            step()
        if kind == "deferred":
            stats = dr.perf_stats()
            assert set(stats) == {"frame", "gbuffer", "lighting", "resolve"}
            assert all(v > 0.0 for v in stats.values())
    assert profiling.recorder() is None
    spans = [s for s in rec.records() if isinstance(s, Span)]
    assert [(s.name, s.parent) for s in spans] == want * 2
    assert [s.frame for s in spans] == [f for f in frames[1:] for _ in want]
    open_by_name = {}
    for s in spans:
        assert s.t0 <= s.t1 and s.device_ms is None  # no CUDA events on the CPU
        if s.parent is not None:
            p = open_by_name[s.parent]
            assert p.t0 <= s.t0 and s.t1 <= p.t1
        open_by_name[s.name] = s
    assert rec.take() and not rec.records()


@pytest.mark.parametrize("case", ["pt_batch", "pt_second_batch", "pt_split_batch",
                                  "deferred_new_sky", "deferred_same_sky"])
def test_h2d_bytes_are_the_listed_uploads(scene, case, monkeypatch):
    """rf.h2d_bytes over one 32x24 batch of the default route: the parked
    shadow direction of the initial state, the sky's four fields that K4's
    plain version reads (the kernel takes them by value in its parameter
    block, so on the card the batch copies 12 bytes: tests/test_torch_cuda.py),
    and on the first batch of a new image size the pixel tables (int32 ys
    and xs, unswizzle's int64 index), which stay on the device after it.
    Over a batch of the split route: the parked direction, the sky once for
    the shade step and once per call of K3's plain version. Over a deferred
    frame: the sky's four fields when the sky is new, else nothing."""
    sky = SKY.state()
    sky_bytes = sum(np.asarray(f, np.float32).nbytes for f in sky)
    if case == "pt_split_batch":
        tiling.block_order_on(W, H, "cpu")
        plain, calls = pt._ENGINES["plain"], []

        def split(*args):
            calls.append(args)
            return plain.split(*args)

        monkeypatch.setitem(pt._ENGINES, "plain", plain._replace(split=split))
        tile = torch.from_numpy(blue_noise_tile())
        step = lambda: pt.accumulate_samples_regen(  # noqa: E731
            scene, sky, _camera(), tile, 0, torch.zeros(W * H, 3), width=W, height=H,
            num_bounces=2, spp=8, num_frames=2, engine="plain", inkernel=False)
        want = lambda: 3 * 4 + sky_bytes * (1 + len(calls))  # noqa: E731
    elif case.startswith("pt"):
        tiling._block_order_on.cache_clear()
        r = _renderer(scene)
        if case == "pt_second_batch":
            _pt_batch(r)
        step = lambda: _pt_batch(r)  # noqa: E731
        first = W * H * (4 + 4 + 8) if case == "pt_batch" else 0
        want = lambda: 3 * 4 + sky_bytes + first  # noqa: E731
    else:
        dr = DeferredRenderer(scene, W, H, engine="plain")
        if case == "deferred_same_sky":
            _deferred_frame(dr)
        step = lambda: _deferred_frame(dr)  # noqa: E731
        want = lambda: 0 if case == "deferred_same_sky" else sky_bytes  # noqa: E731
    with profiling.recording() as rec:
        step()
    counts = [c for c in rec.records() if isinstance(c, Count)]
    assert {c.name for c in counts} <= {H2D_BYTES, D2H_BYTES, PIXEL_TABLES, KERNEL_FRAMES}
    assert sum(c.n for c in counts if c.name == H2D_BYTES) == want()
    if case == "pt_split_batch":
        assert calls


@pytest.mark.parametrize("route", ["default", "split", "unfused"])
def test_dispatch_copies_the_sky_only_where_torch_reads_it(scene, route, monkeypatch):
    """The dispatch holds the host sky and hands K3 and K4 its values; it
    asks sky_on_device for the sky once, and only where its own torch code
    reads it: the split route's shade step and the unfused loop, never the
    default route."""
    asked = []

    def spy(sky, device):
        asked.append(device)
        return sky_on_device(sky, device)

    monkeypatch.setattr(pt, "sky_on_device", spy)
    route_args = {"default": dict(engine="plain"), "split": dict(engine="plain", inkernel=False),
                  "unfused": dict(engine="reference")}[route]
    pt.accumulate_samples_regen(
        scene, SKY.state(), _camera(), torch.from_numpy(blue_noise_tile()), 0,
        torch.zeros(W * H, 3), width=W, height=H, num_bounces=2, spp=8, num_frames=2,
        **route_args)
    assert len(asked) == (0 if route == "default" else 1)


@pytest.mark.parametrize("case", ["pt_batch", "deferred_frame"])
def test_d2h_bytes_are_the_deferred_frame(scene, case):
    """rf.d2h_bytes: one count a deferred frame, the bytes of its (H, W, 3)
    float32 image copied to the host; none over a path tracer's batch."""
    if case == "pt_batch":
        r = _renderer(scene)
        step, want = (lambda: _pt_batch(r)), []  # noqa: E731
    else:
        dr = DeferredRenderer(scene, W, H, engine="plain")
        step, want = (lambda: _deferred_frame(dr)), [H * W * 3 * 4]  # noqa: E731
    with profiling.recording() as rec:
        step()
    assert [c.n for c in rec.records() if isinstance(c, Count) and c.name == D2H_BYTES] == want


def test_spans_reach_the_profilers_trace(scene, tmp_path):
    """Under torch.profiler the spans are on: the chrome trace holds each as
    a user_annotation, portbench.trace.parse reads them into host, and the
    program's recorder PROFILED holds them until taken."""
    r = _renderer(scene)
    profiling.PROFILED.take()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function(trace.WINDOW_SPAN):
            _pt_batch(r)
    held = profiling.PROFILED.take()
    assert [(s.name, s.parent) for s in held if isinstance(s, Span)] == PT_SPANS
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    cats = {(e["name"], e.get("cat")) for e in events if e.get("name", "").startswith("rf.")}
    assert cats == {(name, "user_annotation") for name, _ in PT_SPANS}
    host = {n for n, _, _ in trace.parse(path).host}
    assert host >= {name for name, _ in PT_SPANS}


def test_viewer_status_shows_the_pass_times(tmp_path, capsys):
    """The viewer records its session's last 30 frames, so its deferred
    status line carries each pass's time."""
    script = tmp_path / "cmds.txt"
    script.write_text("renderer deferred\nframes 2\n")
    assert viewer.main(["procedural:courtyard:2", "-o", str(tmp_path / "v.png"), "--width",
                        "16", "--height", "12", "--engine", "plain", "--device", "cpu",
                        "--script", str(script)]) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("[deferred frame 2]")
    assert all(f" {name}=" in line for name in ("frame", "gbuffer", "lighting", "resolve"))


# A made-up traced window of two path-tracer batches, in seconds, which the
# window (from 0.5) cuts: idle (0.5, 0.8), (1.5, 3.0), (6.0, 7.0), (9.5, 10).
PT_TRACE = trace.Trace(
    [("k4", 0.8, 1.5), ("k4", 3.0, 6.0), ("copy", 7.0, 9.5)],
    [("portbench.frame", 0.0, 5.0), ("rf.pt.render", 0.0, 3.2), ("rf.pt.lanes", 0.0, 1.0),
     ("rf.pt.initial_state", 1.0, 2.6), ("rf.pt.child", 1.8, 2.2), ("rf.pt.k4", 2.6, 3.2),
     ("portbench.frame", 5.0, 10.0), ("rf.pt.image", 5.5, 6.8),
     ("rf.pt.unswizzle", 5.5, 6.5), ("rf.pt.readback", 6.5, 6.8)],
    (0.5, 10.0))
# Two deferred frames in a window of (0, 4); the second runs past its end.
# Idle: (0, 0.2), (0.6, 1.0), (1.9, 2.4), (3.0, 4.0).
DEFERRED_TRACE = trace.Trace(
    [("k1", 0.2, 0.6), ("shade", 1.0, 1.9), ("k1", 2.4, 3.0)],
    [("rf.deferred.frame", 0.0, 2.5), ("rf.deferred.gbuffer", 0.0, 0.5),
     ("rf.deferred.lighting", 0.5, 1.2), ("rf.deferred.resolve", 1.2, 1.4),
     ("rf.deferred.sync", 1.4, 1.9), ("rf.deferred.readback", 1.9, 2.1),
     ("rf.deferred.to_float", 2.1, 2.5), ("rf.deferred.frame", 2.5, 4.5),
     ("rf.deferred.gbuffer", 2.5, 3.0), ("rf.deferred.to_float", 3.8, 4.5)],
    (0.0, 4.0))
FRAMES = [{"t0": 10.0, "t1": 11.0}, {"t0": 11.0, "t1": 12.0}]


def _frame(t0, t1, frame, gbuffer, lighting, resolve):
    top = Span("rf.deferred.frame", t0, t1, None, frame)
    dt = (t1 - t0) / 4
    return [top] + [Span(f"rf.deferred.{p}", t0 + i * dt, t0 + (i + 1) * dt,
                         "rf.deferred.frame", frame, ms)
                    for i, (p, ms) in enumerate(
                        [("gbuffer", gbuffer), ("lighting", lighting), ("resolve", resolve)])]


# The recorder's records: counts before, inside and after the window, one of
# another counter; a frame the window's start cuts (9.5), two inside, one the
# window's end cuts (11.9); a pass whose events are not yet done (None).
RECORDS = ([Count(H2D_BYTES, 9.9, 1_000, 0), Count(H2D_BYTES, 10.2, 2_000_000, 1),
            Count("rf.other", 10.3, 7, 1), Count(H2D_BYTES, 11.5, 4_000_000, 2),
            Count(H2D_BYTES, 12.1, 5_000, 3)]
           + _frame(9.5, 10.5, 0, 9.0, 9.0, 9.0) + _frame(10.5, 11.2, 1, 1.0, 3.0, 0.5)
           + _frame(11.2, 11.9, 2, 2.0, 5.0, None) + _frame(11.9, 12.4, 3, 7.0, 7.0, 7.0))


@pytest.mark.parametrize("metric, tr, want", [
    # Self time of lanes (0.0, 1.0) and of initial_state less its child:
    # (1.0, 1.8) + (2.2, 2.6). Idle there: 0.3 + 0.3 + 0.4 s over 2 batches.
    ("pt_idle_prep_ms", PT_TRACE, 500.0),
    # rf.pt.image with its children (5.5, 6.8): the gap (6.0, 7.0) across
    # the unswizzle's end, 0.8 s of it, over 2 batches.
    ("pt_idle_image_ms", PT_TRACE, 400.0),
    # The passes (0, 1.4): 0.2 + 0.4 s; the second frame's gbuffer is busy.
    ("deferred_idle_dispatch_ms", DEFERRED_TRACE, 300.0),
    # readback + to_float (1.9, 2.5) and (3.8, 4.5) cut at 4.0: 0.5 + 0.2 s.
    ("deferred_idle_output_ms", DEFERRED_TRACE, 350.0),
    # 6e6 bytes in the window over 2 batches.
    ("h2d_mb_per_batch", None, 3.0),
    # The two frames wholly inside the window; resolve's second not yet read.
    ("deferred_gbuffer_ms", None, 1.5),
    ("deferred_lighting_ms", None, 4.0),
    ("deferred_resolve_ms", None, 0.5),
])
def test_readers_give_the_hand_computed_value(monkeypatch, metric, tr, want):
    """Each new per-layer reader on a made-up trace or recorder, and None
    where the program has no spans: a trace without them, a program without
    a recorder."""
    read = cells.load_module("metrics", metric).read
    monkeypatch.setattr(profiling, "PROFILED", types.SimpleNamespace(records=lambda: RECORDS))
    run = types.SimpleNamespace(trace=tr, frames=FRAMES)
    assert read(run) == pytest.approx(want)
    if tr is not None:
        run.trace = trace.Trace(tr.device, [h for h in tr.host if not h[0].startswith("rf.")],
                                tr.window)
    else:
        monkeypatch.delattr(profiling, "PROFILED")
    assert read(run) is None
