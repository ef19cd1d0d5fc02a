"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level module name, and the reference's files load nothing of
the program."""

import json
import os
import subprocess
import sys

from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
HERE = Path(__file__).resolve().parent

FORBIDDEN = {"jax", "jaxlib", "flax", "kube_batch_tpu"}

RUN_TINY = """
import json, sys, time
T = time.perf_counter()
from benchmark import run
from conftest import cut_cell
def patch(spec):
    cut_cell(spec, 40, 400)
code = run.main(["--workload", "kb5k-storm", "--seed", "3", "--seconds",
                 "2", "--trace", "1"], device="cpu", t_start=T, patch=patch)
from benchmark import control, readings
for name in ("session.open_ms", "bid_sparse_roofline"):
    readings.load_reader(name)
print(json.dumps({"code": code,
                  "top": sorted({m.split('.')[0] for m in sys.modules})}))
"""

REFERENCE_ONLY = """
import json, sys
from benchmark import reference, traffic, work
print(json.dumps({"top": sorted({m.split('.')[0] for m in sys.modules})}))
"""


def _top(code):
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={**os.environ, "PYTHONPATH": str(HERE)},
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_run_loads_neither_jax_nor_the_jax_package():
    res = _top(RUN_TINY)
    assert res["code"] == 0
    assert "kube_batch_tpu_torch" in res["top"]
    assert not FORBIDDEN & set(res["top"])


def test_the_reference_loads_nothing_of_the_program():
    top = set(_top(REFERENCE_ONLY)["top"])
    assert not (FORBIDDEN | {"kube_batch_tpu_torch", "torch"}) & top
