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

# Modules of the process layer, of cluster truth and device-resident
# selection, of the simulator, of the real-cluster adapter and the perf
# harness, and of the multi-device solve, named so a walk that skipped
# them would fail.
SLICE_MODULES = (
    "kube_batch_tpu_torch.__main__",
    "kube_batch_tpu_torch.version",
    "kube_batch_tpu_torch.cli",
    "kube_batch_tpu_torch.cli.options",
    "kube_batch_tpu_torch.cli.state",
    "kube_batch_tpu_torch.cli.manifests",
    "kube_batch_tpu_torch.cli.server",
    "kube_batch_tpu_torch.cache.antientropy",
    "kube_batch_tpu_torch.cache.recovery",
    "kube_batch_tpu_torch.solver.select_device",
    "kube_batch_tpu_torch.sim",
    "kube_batch_tpu_torch.sim.clock",
    "kube_batch_tpu_torch.sim.trace",
    "kube_batch_tpu_torch.sim.workload",
    "kube_batch_tpu_torch.sim.invariants",
    "kube_batch_tpu_torch.sim.faults",
    "kube_batch_tpu_torch.sim.failover",
    "kube_batch_tpu_torch.sim.soak",
    "kube_batch_tpu_torch.sim.harness",
    "kube_batch_tpu_torch.sim.cli",
    "kube_batch_tpu_torch.sim.study",
    "kube_batch_tpu_torch.cluster.kube",
    "kube_batch_tpu_torch.utils.fake_kube",
    "kube_batch_tpu_torch.perf",
    "kube_batch_tpu_torch.solver.collectives",
    "kube_batch_tpu_torch.solver.sharding",
    "kube_batch_tpu_torch.solver.spmd",
)

_BAD = """
bad = sorted(n for n in sys.modules
             if n == "jax" or n.startswith(("jax.", "jaxlib"))
             or n == "kube_batch_tpu" or n.startswith("kube_batch_tpu.")
             or n == "yaml" or n.startswith("yaml."))
print("LOADED", sorted(n for n in sys.modules
                       if n.startswith("kube_batch_tpu_torch")))
print("BAD", bad)
"""

_PROBE = """
import importlib, pkgutil, sys
import kube_batch_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
""" + _BAD

# ``python -m kube_batch_tpu_torch --version``, in the same process as
# the check of what it loaded.
_VERSION_PROBE = """
import runpy, sys
sys.argv = ["kube_batch_tpu_torch", "--version"]
try:
    runpy.run_module("kube_batch_tpu_torch", run_name="__main__")
except SystemExit as exc:
    assert exc.code == 0, exc.code
""" + _BAD


def run_probe(script):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run(
        [sys.executable, "-c", script], capture_output=True, text=True,
        cwd=REPO, env=env, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    lines = dict(line.split(" ", 1) for line in out.stdout.splitlines()
                 if line.startswith(("LOADED ", "BAD ")))
    return eval(lines["LOADED"]), lines["BAD"], out.stdout


def test_imports_load_no_jax_and_no_jax_package():
    loaded, bad, _ = run_probe(_PROBE)
    assert len(loaded) >= 10
    assert set(SLICE_MODULES) <= set(loaded)
    assert bad == "[]"


def test_the_process_entry_point_loads_no_jax():
    """``python -m kube_batch_tpu_torch --version`` prints the banner
    and loads neither JAX, the JAX package nor PyYAML."""
    loaded, bad, stdout = run_probe(_VERSION_PROBE)
    assert "tpu-batch version" in stdout and "torch:" in stdout
    assert "kube_batch_tpu_torch.cli" in loaded
    assert bad == "[]"


# The real-cluster adapter through the package's lazy exports: a
# kubeconfig is parsed only when one is loaded, so PyYAML stays out.
_CLUSTER_PROBE = """
import sys
import kube_batch_tpu_torch.cluster as cluster
assert "kube_batch_tpu_torch.cluster.kube" not in sys.modules
config = cluster.KubeConfig("http://127.0.0.1:1", token="t")
cluster.KubeCluster(config, watch_kinds=())
import kube_batch_tpu_torch.perf, kube_batch_tpu_torch.utils.fake_kube
""" + _BAD


def test_the_cluster_adapter_and_perf_load_no_yaml():
    loaded, bad, _ = run_probe(_CLUSTER_PROBE)
    assert {"kube_batch_tpu_torch.cluster.kube",
            "kube_batch_tpu_torch.perf",
            "kube_batch_tpu_torch.utils.fake_kube"} <= set(loaded)
    assert bad == "[]"


def test_sources_import_neither():
    pattern = re.compile(
        r"^\s*(import|from)\s+(jax|jaxlib)\b|kube_batch_tpu\.", re.M
    )
    files = sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]
    scanned = {str(f.relative_to(REPO)) for f in files}
    for mod in SLICE_MODULES:
        rel = mod.replace(".", "/")
        assert f"{rel}.py" in scanned or f"{rel}/__init__.py" in scanned, mod
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
