"""A short run of each cell's shape at a small cluster on the card,
traced and untraced: ``python3 -m pytest -m gpu benchmark/tests``."""

import json
import time
from pathlib import Path

import pytest

from benchmark import run

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in
         json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.gpu
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_short_run_of_each_cell(card, cut, capsys, cell, trace):
    t = time.perf_counter()

    def patch(spec):
        cut(spec, spec["config"]["nodes"] // 10,
            spec["config"]["population"] // 10,
            {"64": 1, "16": 2, "8": 3, "2": 5})

    code = run.main(["--workload", cell, "--seed", "4294967311",
                     "--seconds", "8", "--trace", str(trace)],
                    t_start=t, patch=patch)
    assert code == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu"
    if trace:
        assert out["device"]["busy_s"] > 0
