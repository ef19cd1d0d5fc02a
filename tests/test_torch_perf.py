"""Parity of the port's perf harness (``perf.py``, the kubemark analog)
with the JAX package's, at the sizes of ``tests/e2e/test_perf.py``.

``percentiles`` is equal on seeded lists. ``run_density`` (40 pods x 8
hollow nodes) under the default policy and under the TPU policy runs
every pod in both packages, with the same artifact keys, config, counts
and latency labels (the latencies are wall clock and differ).
``run_multitenant`` and ``run_multitenant_compare`` admit all of tenant
B, backfill the best-effort pods and evict from tenant A in both
packages, with the same keys and config. ``main``'s argument errors exit
2 with the same message, and the port's ``--device cuda`` refuses
without CUDA. The port runs on the CPU with ``allocate_tpu`` on its
plain chain (``use_kernel=False``).
"""

import importlib
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

PKGS = ("kube_batch_tpu", "kube_batch_tpu_torch")
REPO = pathlib.Path(__file__).resolve().parents[1]
TPU_CONF = str(REPO / "config" / "tpu-batch-conf-tpu.yaml")
LABELS = ["create_to_scheduled_ms", "scheduled_to_running_ms",
          "running_to_watched_ms", "e2e_ms"]


def perf(pkg):
    importlib.import_module(f"{pkg}.actions")
    importlib.import_module(f"{pkg}.plugins")
    return importlib.import_module(f"{pkg}.perf")


def device(pkg):
    return {"device": "cpu"} if pkg.endswith("torch") else {}


@pytest.fixture
def plain_chain(monkeypatch):
    """The JAX package's TPU policy on one CPU device with host
    selection; the port's shared ``allocate_tpu`` on the plain chain."""
    from kube_batch_tpu.solver import sharding as JS
    from kube_batch_tpu_torch.framework import get_action

    monkeypatch.setenv("KBT_SOLVER", "jax")
    monkeypatch.setenv("KBT_SELECT_DEVICE", "0")
    monkeypatch.delenv("KBT_SOLVER_TOPK", raising=False)
    monkeypatch.setattr(JS, "default_mesh", lambda devices=None: None)
    perf(PKGS[1])
    action, _ = get_action("allocate_tpu")
    saved = action.use_kernel
    action.use_kernel = False
    yield
    action.use_kernel = saved


def shape(art):
    """An artifact without its wall-clock numbers: keys, config, counts
    and the latency labels."""
    out = {k: v for k, v in art.items()
           if k not in ("wall_seconds", "pods_per_second", "dataItems",
                        "reference_loop", "comparison", "tenant_a_evicted")}
    out["labels"] = [d["label"] for d in art["dataItems"]]
    out["keys"] = sorted(art)
    return out


@pytest.mark.parametrize("values", [
    [], [3.0], list(np.random.RandomState(0).exponential(5.0, 101)),
    list(np.random.RandomState(1).randint(0, 50, 1000).astype(float)),
])
def test_percentiles_equal(values):
    ref, got = (perf(p).percentiles(list(values)) for p in PKGS)
    assert got == ref
    assert list(got) == ["Perc50", "Perc90", "Perc99", "Perc100"]


@pytest.mark.parametrize("policy", ["default", "tpu"])
def test_density_small_cluster_equal(policy, plain_chain):
    conf = TPU_CONF if policy == "tpu" else None
    arts = [perf(p).run_density(
        total_pods=40, nodes=8, pods_per_group=10, schedule_period=0.05,
        kubelet_delay=0.01, timeout=60.0, scheduler_conf=conf, **device(p))
        for p in PKGS]
    ref, got = (shape(a) for a in arts)
    assert got == ref
    assert got["pods_running"] == got["pods_scheduled"] == 40
    assert got["labels"] == LABELS
    e2e = arts[1]["dataItems"][3]
    assert e2e["Perc100"] >= e2e["Perc50"] > 0
    json.dumps(arts[1])


def test_multitenant_small_cluster_equal():
    kw = dict(nodes=4, pods_per_group=4, node_cpu="4", pod_cpu="1",
              besteffort_pods=2, schedule_period=0.05, timeout=60)
    arts = [perf(p).run_multitenant(**kw, **device(p)) for p in PKGS]
    ref, got = (shape(a) for a in arts)
    assert got == ref
    for art in arts:
        assert art["tenant_b_running"] == art["config"]["tenant_b_pods"]
        assert art["besteffort_backfilled"] == 2
        assert art["tenant_a_evicted"] > 0
        assert art["dataItems"][0]["Perc100"] > 0


def test_multitenant_compare_small_cluster_equal(plain_chain):
    kw = dict(nodes=4, pods_per_group=4, node_cpu="4", pod_cpu="1",
              besteffort_pods=2, schedule_period=0.05, timeout=60)
    arts = [perf(p).run_multitenant_compare(**kw, **device(p))
            for p in PKGS]
    ref, got = (shape(a) for a in arts)
    assert got == ref
    assert got["config"]["allocate_action"] == "allocate_tpu"
    for art in arts:
        loop = art["reference_loop"]
        assert sorted(loop) == sorted(arts[0]["reference_loop"])
        assert loop["config"]["allocate_action"] == "allocate"
        for run in (art, loop):
            assert run["tenant_b_running"] == art["config"]["tenant_b_pods"]
            assert run["besteffort_backfilled"] == 2
            assert run["tenant_a_evicted"] > 0
        assert art["comparison"]["tpu_admission_complete"]
        assert art["comparison"]["reference_admission_complete"]
        assert sorted(art["comparison"]) == sorted(arts[0]["comparison"])


def run_main(pkg, argv):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=str(REPO), OMP_NUM_THREADS="1",
               JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "-m", f"{pkg}.perf", *argv],
                          capture_output=True, text=True, cwd=REPO, env=env,
                          timeout=120)


@pytest.mark.parametrize("argv", [
    ["--scenario", "multitenant", "--pods", "5"],
    ["--scenario", "multitenant-compare", "--conf", TPU_CONF],
    ["--scenario", "multitenant", "--min-member-frac", "0.5"],
    ["--scenario", "bogus"],
    ["--pods", "many"],
])
def test_main_argument_errors_equal(argv):
    """Refused before any scheduler runs: exit 2, the same message (the
    port adds ``--device`` to its usage line only)."""
    ref, got = (run_main(p, argv) for p in PKGS)
    assert ref.returncode == got.returncode == 2
    assert got.stderr.splitlines()[-1] == ref.stderr.splitlines()[-1]
    assert got.stdout == ref.stdout == ""


def test_main_needs_cuda_unless_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: --device cuda is valid")
    out = run_main(PKGS[1], ["--pods", "10", "--nodes", "2"])
    assert out.returncode != 0 and out.stdout == ""
    assert "--device cuda" in out.stderr and "Traceback" not in out.stderr
    with pytest.raises(RuntimeError, match="CUDA"):
        perf(PKGS[1]).run_density(total_pods=2, nodes=1)
    out = run_main(PKGS[1], ["--pods", "20", "--nodes", "2", "--period",
                             "0.05", "--kubelet-delay", "0.01", "--device",
                             "cpu"])
    assert out.returncode == 0, out.stderr[-2000:]
    art = json.loads(out.stdout.splitlines()[-1])
    assert art["pods_running"] == 20
