"""Cells, configurations, mixes, limits and metrics are found by name, and
a new one is added by adding files and entries alone."""

import json
import shutil

import pytest

from portbench import cells

NAME = r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$"


def test_every_cell_finds_its_parts():
    bench = cells.benchmark()
    for w in bench["workloads"]:
        cell = cells.find(w["name"], bench)
        assert cell.config["name"] == w["config"]
        assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
        assert len(cell.end_to_end) >= 2 and cell.per_layer
        cells.load_module("renderers", cell.config["renderer"])
        cells.load_module("scenes", cell.config["scene"]["generator"])
        assert set(cell.limits) and all("limit" in v for v in cell.limits.values())
    for m in bench["per_layer"]:
        assert callable(cells.load_module("metrics", m["name"]).read)
    for m in bench["end_to_end"]:
        assert callable(cells.load_module("end_to_end", m["name"]).read)


def test_unknown_cell_raises():
    with pytest.raises(KeyError):
        cells.find("no_such_cell")


def test_benchmark_file_keeps_its_format():
    import re

    bench = cells.benchmark()
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    names = [c["name"] for c in bench["configs"]] + [w["name"] for w in bench["workloads"]]
    names += [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names))
    assert all(re.match(NAME, n) for n in names)
    assert all(m["bound"] <= 0.25 for m in bench["end_to_end"])
    for c in bench["configs"]:
        assert c["file"].startswith("portbench/") and c["reduced"] == []
        assert json.loads((cells.ROOT / c["file"]).read_text())["name"] == c["name"]
    per_cell = {}
    for w in bench["workloads"]:
        assert (w["config"], w["traffic"]) not in per_cell
        per_cell[(w["config"], w["traffic"])] = w
        assert w["chips"] == 1
    assert len(json.dumps(bench)) < 64 * 1024


def test_new_mix_and_cell_need_no_edit(tmp_path):
    """A copy of the benchmark's data, a new mix file and a new cell entry:
    the new cell is found without a change to any file that was there."""
    here = tmp_path / "portbench"
    for d in ("configs", "mixes", "limits"):
        shutil.copytree(cells.HERE / d, here / d)
    bench = cells.benchmark()
    mix = json.loads((here / "mixes" / "converge.json").read_text())
    mix["bounces"] = 2
    (here / "mixes" / "converge_b2.json").write_text(json.dumps(mix))
    (here / "limits" / "pt_converge_1080p_b2.json").write_text(
        (here / "limits" / "pt_converge_1080p.json").read_text())
    before = {p: p.read_bytes() for p in here.rglob("*.json")}
    bench["workloads"].append({"name": "pt_converge_1080p_b2",
                               "config": "courtyard26_tex_pt_1080p", "traffic": "converge_b2",
                               "chips": 1, "why": "2 bounces"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "pt_converge_1080p" in m.get("workloads", []):
            m["workloads"].append("pt_converge_1080p_b2")
    cell = cells.find("pt_converge_1080p_b2", bench, here)
    assert cell.mix["bounces"] == 2 and cell.config["renderer"] == "pt"
    assert {m["name"] for m in cell.end_to_end} == {"msamples_per_s", "setup_s"}
    assert all(p.read_bytes() == b for p, b in before.items())
