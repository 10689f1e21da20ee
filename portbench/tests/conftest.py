"""CPU tests of the benchmark, and its card tests (marker `cuda`).

    python -m pytest portbench/tests -q                 # CPU, tiny sizes
    python -m pytest portbench/tests -q -m cuda         # on the card

A card test asks for the `card` fixture, which skips where there is no CUDA
device; whether there is one is decided inside the fixture, never while a
module is imported.
"""

import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU; skips without a CUDA device")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda", 0)
