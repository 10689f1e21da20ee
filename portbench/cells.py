"""Finding a cell and its parts by name.

A cell is an entry of `workloads` in BENCHMARK.json. Everything that belongs
to one configuration, one traffic mix or one cell is a file of its own,
found by its name: configs/<config>.json, mixes/<traffic>.json,
limits/<cell>.json; the scene generator scenes/<generator>.py and the
frame loop renderers/<renderer>.py that a configuration names; the per-layer
metric readers metrics/<metric>.py. Adding one is adding files and entries.
"""

from __future__ import annotations

import importlib.util
import json
import pathlib
from typing import NamedTuple

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent


class Cell(NamedTuple):
    name: str
    config: dict
    mix: dict
    limits: dict
    end_to_end: list  # the BENCHMARK.json entries this cell reports
    per_layer: list


def _load_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: pathlib.Path = ROOT) -> dict:
    return _load_json(root / "BENCHMARK.json")


def _reports(metric: dict, cell: str, e2e_of_cell: set) -> bool:
    """A per-layer metric is read in the cells it lists, or without a list
    in every cell that reports the end-to-end metric it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric["moves"] in e2e_of_cell


def find(name: str, bench: dict | None = None, here: pathlib.Path = HERE) -> Cell:
    """The cell `name` with its configuration, mix, limits and metrics.
    Raises KeyError for a name BENCHMARK.json does not hold."""
    bench = benchmark() if bench is None else bench
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: {sorted(entries)}")
    w = entries[name]
    e2e = [m for m in bench["end_to_end"] if "workloads" not in m or name in m["workloads"]]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _reports(m, name, names)]
    return Cell(name, _load_json(here / "configs" / f"{w['config']}.json"),
                _load_json(here / "mixes" / f"{w['traffic']}.json"),
                _load_json(here / "limits" / f"{name}.json"), e2e, per_layer)


def load_module(kind: str, name: str, here: pathlib.Path = HERE):
    """The module <kind>/<name>.py: imported as portbench.<kind>.<name>
    where the name is an identifier, else loaded by path (a metric's name
    may hold dots; such a file imports absolutely)."""
    path = here / kind / f"{name}.py"
    if not path.is_file():
        raise KeyError(f"no {kind} file {path.name}")
    if name.isidentifier() and here == HERE:
        return importlib.import_module(f"portbench.{kind}.{name}")
    spec = importlib.util.spec_from_file_location(f"portbench_{kind}_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
