"""On the card (marker cuda): a short run of each cell comes out correct,
and the control reads above each cell's limit at the cell's own size.

    python -m pytest portbench/tests -q -m cuda
"""

import time

import pytest

from portbench import cells, harness
from portbench.tools import readings

CELLS = [w["name"] for w in cells.benchmark()["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_short_run_is_correct(name, card):
    line = harness.execute(cells.find(name), 2**31 + 4242, 2.0, False, card, time.perf_counter())
    assert line["correct"], line["check"]
    assert line["device"]["memory_peak_bytes"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_at_the_cells_size(name, card):
    cell = cells.find(name)
    (row,) = readings.readings(cell, [2**31 + 4343], 2.0, card, log=None)
    assert all(v > cell.limits[k]["limit"] for k, v in row["control"].items())
    assert all(v <= cell.limits[k]["limit"] for k, v in row["program"].items())
