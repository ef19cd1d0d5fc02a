"""The port stands alone: it imports neither JAX nor the JAX package
(nor PyYAML, which the card's machine may lack), and its entry points
run on CUDA unless the CPU is asked for."""

import os
import pathlib
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import kube_batch_tpu_torch
from kube_batch_tpu_torch import resolve_device
from kube_batch_tpu_torch.solver.snapshot import pack_inputs

from tests.test_torch_solver import snapshot_mixed

REPO = pathlib.Path(__file__).resolve().parents[1]
PKG = pathlib.Path(kube_batch_tpu_torch.__file__).parent

_PROBE = """
import importlib, pkgutil, sys
import kube_batch_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
bad = sorted(n for n in sys.modules
             if n == "jax" or n.startswith(("jax.", "jaxlib"))
             or n == "kube_batch_tpu" or n.startswith("kube_batch_tpu.")
             or n == "yaml" or n.startswith("yaml."))
print("LOADED", len([n for n in sys.modules
                     if n.startswith("kube_batch_tpu_torch")]))
print("BAD", bad)
"""


def test_imports_load_no_jax_and_no_jax_package():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], capture_output=True, text=True,
        cwd=REPO, env=env, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    lines = dict(line.split(" ", 1) for line in out.stdout.splitlines())
    assert int(lines["LOADED"]) >= 10
    assert lines["BAD"] == "[]"


def test_sources_import_neither():
    pattern = re.compile(
        r"^\s*(import|from)\s+(jax|jaxlib)\b|kube_batch_tpu\.", re.M
    )
    files = sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]
    for path in files:
        hits = pattern.findall(path.read_text())
        assert not hits, f"{path}: {hits}"


def test_entry_points_need_cuda_unless_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: cuda is a valid default")
    host = snapshot_mixed()
    with pytest.raises(RuntimeError, match="CUDA"):
        pack_inputs(host)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    packed = pack_inputs(host, device="cpu")
    assert packed.task_f32.device.type == "cpu"
    assert np.array_equal(packed.task_f32[0].numpy(), host.task_req)
    assert resolve_device("cpu") == torch.device("cpu")


def test_chip_smoke_refuses_to_run_without_the_card_or_the_repo(tmp_path):
    """chip_smoke.py exits non-zero with no ok line when CUDA is absent,
    and when it stands alone in a directory without the package."""
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(REPO / "chip_smoke.py", alone)
    runs = [(alone, tmp_path)]
    if not torch.cuda.is_available():
        runs.append((REPO / "chip_smoke.py", REPO))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    for script, cwd in runs:
        out = subprocess.run(
            [sys.executable, str(script)], capture_output=True, text=True,
            cwd=cwd, env=env, timeout=120,
        )
        assert out.returncode != 0, (script, out.stdout[-500:])
        assert '"ok": true' not in out.stdout
