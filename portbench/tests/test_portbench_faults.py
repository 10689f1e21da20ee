"""The check, driven through a whole run on the CPU at a tiny size (the
harness's look for a card skipped): sound runs come out correct; the
control and a timed path broken underneath come out not correct, once for
each fault a cell can have (one card: no exchange between chips to leave
out)."""

import time

import pytest
import torch

from portbench import cells, faults, harness
from portbench.tests.tiny import tiny_cell
from portbench.tools import readings

SEED = 2**31 + 977
CELLS = [w["name"] for w in cells.benchmark()["workloads"]]


def _run(cell, seconds=0.6):
    return harness.execute(cell, SEED, seconds, False, torch.device("cpu"), time.perf_counter())


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name, tmp_path, monkeypatch):
    line = _run(tiny_cell(name, tmp_path, monkeypatch))
    assert line["correct"], line["check"]
    assert line["attempted"] >= 1 and list(line)[-1] == "check"


@pytest.mark.parametrize("fault", faults.FAULTS)
@pytest.mark.parametrize("name", CELLS)
def test_broken_path_is_not_correct(name, fault, tmp_path, monkeypatch):
    """Through tools/readings.py --faults, as on the card: a whole run with
    the fault planted (faults.py), judged by check.judge."""
    cell = tiny_cell(name, tmp_path, monkeypatch)
    (row,) = readings.fault_readings(cell, [SEED], 0.6, torch.device("cpu"), faults=[fault],
                                     log=None)
    assert not row["correct"], row
    assert _run(cell)["correct"]  # the fault is gone once its run is over


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name, tmp_path, monkeypatch):
    """The reference in bfloat16 in the program's place fails the cell's
    limit, and the program's own reading passes it."""
    cell = tiny_cell(name, tmp_path, monkeypatch)
    (row,) = readings.readings(cell, [SEED], 0.6, torch.device("cpu"), log=None)
    assert not row["control_correct"]
    for key, v in row["control"].items():
        assert v > cell.limits[key]["limit"]
    for key, v in row["program"].items():
        assert v <= cell.limits[key]["limit"]
