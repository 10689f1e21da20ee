"""The window's arithmetic on made-up records."""

import json
import types

import pytest

from portbench import cells, trace, window


def _frames(latencies, samples=10, gap=0.0):
    out, t = [], 100.0
    for lat in latencies:
        out.append({"t0": t, "t1": t + lat, "samples": samples})
        t += lat + gap
    return out


def test_rate_is_all_work_over_all_time():
    frames = _frames([0.1, 0.3, 0.1], samples=30, gap=0.05)
    # 90 samples from 100.0 to 100.6.
    assert window.rate(frames) == pytest.approx(90 / 0.6)
    assert window.mean_frame_s(frames) == pytest.approx(0.6 / 3)


def test_p95_is_over_every_frame():
    lat = [0.01] * 95 + [0.2] * 5
    frames = _frames(lat)
    got = window.percentile(window.latencies(frames), 95.0)
    # Rank 94.05 of 100 sorted latencies: between the last 0.01 and a 0.2.
    assert got == pytest.approx(0.01 + 0.05 * 0.19)
    # Not a median of chunk p95s.
    chunks = [window.percentile(lat[i:i + 10], 95.0) for i in range(0, 100, 10)]
    assert got != pytest.approx(sorted(chunks)[5])
    # The per-layer reader reports it in ms, over the same frames.
    run = types.SimpleNamespace(frames=frames)
    assert cells.load_module("metrics", "frame_p95_ms").read(run) == pytest.approx(got * 1e3)


def test_idle_merges_overlapping_intervals():
    busy = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.6), (9.0, 12.0)]
    assert window.merge(busy) == [(0.0, 2.0), (3.0, 4.0), (9.0, 12.0)]
    assert window.busy_seconds(busy, 0.0, 10.0) == pytest.approx(4.0)
    tr = trace.Trace([("k", s, e) for s, e in busy], [("portbench.frame", 0.0, 10.0)],
                     (0.0, 10.0))
    idle = cells.load_module("metrics", "device_idle.converge").read(
        types.SimpleNamespace(trace=tr))
    assert idle == pytest.approx(60.0)
    assert tr.idle_gaps() == [["portbench.frame", pytest.approx(6.0)]]


def _k4_run(cell, rays=67_000_000):
    k4 = "void trace_regen_shaded_items_kernel<...>(...)"
    tr = trace.Trace([(k4, 0.0, 0.002), ("fold", 0.002, 0.003), (k4, 0.004, 0.006)], [],
                     (0.0, 0.01))
    return types.SimpleNamespace(trace=tr, rays=rays, cell=types.SimpleNamespace(name=cell),
                                 frames=[{"samples": 0}], spans={"triangles": 10})


def test_roofline_comes_from_the_cells_frozen_work(tmp_path, monkeypatch):
    mod = cells.load_module("metrics", "k4_roofline")
    monkeypatch.setattr(mod, "WORK", tmp_path)
    (tmp_path / "cell.json").write_text(json.dumps(
        {"k4": {"ops_per_ray": 1000.0, "ops_per_sample": 65}}))
    run = _k4_run("cell")
    # 6.7e10 operations at 67e12/s: 1 ms of bound over 4 ms of K4.
    assert mod.read(run) == pytest.approx(25.0)
    run.rays = None
    assert mod.read(run) is None
    # No K4 in the window: nothing to read, whatever the cell.
    run = _k4_run("other")
    run.trace.device = [("fold", 0.002, 0.003)]
    assert mod.read(run) is None


def test_roofline_of_a_k4_cell_without_its_work_file_raises(tmp_path, monkeypatch):
    mod = cells.load_module("metrics", "k4_roofline")
    monkeypatch.setattr(mod, "WORK", tmp_path)
    with pytest.raises(KeyError, match="new_cell"):
        mod.read(_k4_run("new_cell"))
    (tmp_path / "new_cell.json").write_text(json.dumps({"other": {}}))
    with pytest.raises(KeyError, match="new_cell"):
        mod.read(_k4_run("new_cell"))


def test_every_k4_cell_has_its_work():
    mod = cells.load_module("metrics", "k4_roofline")
    listed = next(m for m in cells.benchmark()["per_layer"] if m["name"] == "k4_roofline")
    for name in listed["workloads"]:
        w = mod.work(name)
        assert w["ops_per_ray"] > 0 and w["ops_per_sample"] > 0
