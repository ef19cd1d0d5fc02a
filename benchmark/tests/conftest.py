"""The benchmark's own tests: ``python3 -m pytest benchmark/tests``
from the repository's root (those marked ``gpu`` run on a card)."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

SMALL_STORM = {"16": 1, "8": 2, "2": 4}


def cut_cell(spec: dict, nodes: int, population: int,
             gangs: dict = SMALL_STORM) -> None:
    """A cell's shape at a small cluster: ``nodes`` and ``population``,
    storms of ``gangs``, and lifetimes that hold the population."""
    spec["config"].update(nodes=nodes, population=population)
    mix = spec["traffic"]
    mix["gangs"] = dict(gangs)
    pods = sum(int(k) * n for k, n in gangs.items())
    mean = population / (pods / mix["arrivals"]["every_s"])
    mix["lifetime_s"] = [mean / 2, mean * 3 / 2]


@pytest.fixture
def cut():
    return cut_cell
