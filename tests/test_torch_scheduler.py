"""Parity of the port's ``Scheduler`` with the JAX package's.

``Scheduler(cache, conf).run_once()`` drives three cycles (cold, steady,
and one after a 1 % gang burst) on the same seeded, congested cluster in
both packages, with the TPU policy (``config/tpu-batch-conf-tpu.yaml``:
``allocate_tpu, backfill``) and with the default policy (``allocate,
backfill``). The port runs on ``device="cpu"`` with the plain chain
(``use_kernel=False`` on the policy's ``allocate_tpu``), the JAX package
its default chain on one device (run (i) of the action's parity tests).
After the cycles the bound (pod, node) sets, the flight records' phase
names and the ``explain`` verdict counts are equal, and the verdicts
reach ``metrics.update_unschedulable_reasons``.
"""

import collections
import importlib
import pathlib

import numpy as np
import pytest
import torch

import kube_batch_tpu_torch.actions  # noqa: F401 (registers actions)
from kube_batch_tpu_torch import metrics as port_metrics
from kube_batch_tpu_torch.actions import allocate_tpu as P_atpu
from kube_batch_tpu_torch.framework import get_action
from kube_batch_tpu_torch.obs import RECORDER as P_RECORDER
from kube_batch_tpu_torch.obs import explain as P_explain
from kube_batch_tpu_torch.scheduler import Scheduler as PScheduler

from tests.test_torch_action import add_burst, jax_side
from tests.test_torch_snapshot import PORT, empty_cache

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
TPU_CONF = str(REPO / "config" / "tpu-batch-conf-tpu.yaml")
SHAPE = (600, 16, 2, 12)  # tasks, nodes, queues, gangs: a carried backlog


@pytest.fixture
def both(monkeypatch):
    J, J_atpu, _, _, _, JS = jax_side()
    from kube_batch_tpu.obs import RECORDER as J_RECORDER
    from kube_batch_tpu.obs import explain as J_explain
    from kube_batch_tpu.scheduler import Scheduler as JScheduler

    monkeypatch.setenv("KBT_SOLVER", "jax")
    monkeypatch.setenv("KBT_SELECT_DEVICE", "0")
    monkeypatch.delenv("KBT_SOLVER_TOPK", raising=False)
    monkeypatch.setattr(JS, "default_mesh", lambda devices=None: None)
    action, _ = get_action("allocate_tpu")
    saved = (action.device, action.use_kernel)
    yield {
        "jax": (J, JScheduler, J_RECORDER, J_explain, J_atpu),
        "torch": (PORT, PScheduler, P_RECORDER, P_explain, P_atpu),
    }
    action.device, action.use_kernel = saved


def run_scheduler(side, conf, port):
    pkg, Scheduler, recorder, explain, atpu = side
    explain.clear()
    recorder.reset()
    # The greedy allocate picks at random among equal-scored nodes: pin
    # each package's tie-break RNG the same way.
    helper = pkg.tu.__name__.rsplit(".", 1)[0] + ".scheduler_helper"
    importlib.import_module(helper)._rng.seed(0)
    cache = pkg.build_cluster(*SHAPE, seed=0)
    if port:
        sched = Scheduler(cache, conf, device="cpu")
        for action in sched.actions:
            if action.name() == "allocate_tpu":
                action.use_kernel = False
        assert sched.device == torch.device("cpu")
    else:
        sched = Scheduler(cache, conf)
    rng = np.random.RandomState(1)
    outcomes = []
    for cycle in range(3):
        if cycle == 2:
            n_tasks, _, n_queues, n_groups = SHAPE
            add_burst(pkg, cache, rng, "burst", 1, n_tasks // n_groups,
                      n_queues)
        sched.run_once()
        assert cache.wait_for_side_effects(timeout=60.0)
        outcomes.append(atpu.last_stats.get("warm_outcome"))
    records = recorder.snapshot()
    verdicts = collections.Counter(v.reason for v in explain.all_verdicts())
    binds = dict(cache.binder.binds)
    cache.shutdown()
    return {
        "binds": binds,
        "phases": [sorted(r.get("phases_ms", {})) for r in records],
        "kinds": [r.get("cycle_kind") for r in records],
        "verdicts": verdicts,
        "outcomes": outcomes,
    }


@pytest.mark.parametrize("policy", ["tpu", "default"])
def test_scheduler_cycles_match_the_jax_package(both, policy):
    conf = TPU_CONF if policy == "tpu" else None
    ref = run_scheduler(both["jax"], conf, port=False)
    got = run_scheduler(both["torch"], conf, port=True)
    assert got["binds"] == ref["binds"]
    assert 0 < len(got["binds"]) < SHAPE[0] + SHAPE[0] // SHAPE[3]
    assert got["phases"] == ref["phases"] and len(got["phases"]) == 3
    assert got["kinds"] == ref["kinds"]
    assert got["verdicts"] == ref["verdicts"]
    if policy == "tpu":
        assert "action:allocate_tpu" in got["phases"][0]
        assert sum(got["verdicts"].values()) > 0
        assert got["outcomes"] == ref["outcomes"]
        assert got["outcomes"][0] == "cold"
    else:
        assert "action:allocate" in got["phases"][0]


def test_unschedulable_reasons_reach_the_metric():
    """The explain module is ported: the gauge update no longer raises."""
    port_metrics.update_unschedulable_reasons({"no-fit": 3})
    assert port_metrics.metrics.unschedulable_tasks.get(("no-fit",)) == 3.0
    port_metrics.update_unschedulable_reasons({})
    assert port_metrics.metrics.unschedulable_tasks.get(("no-fit",)) == 0.0


def test_scheduler_and_action_need_cuda_unless_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: cuda is a valid default")
    cache = empty_cache(PORT)
    with pytest.raises(RuntimeError, match="CUDA"):
        PScheduler(cache, TPU_CONF)
    # The registered action with no device asked for: a cycle with work
    # to solve raises; it never solves on the CPU or the native floor.
    cache = PORT.build_cluster(20, 2, 1, 2, seed=0)
    action = P_atpu.AllocateTpuAction()
    ssn = PORT.open_session(cache, PORT.make_tiers(
        ["priority", "gang"], ["predicates", "nodeorder"]))
    with pytest.raises(RuntimeError, match="CUDA"):
        action.execute(ssn)
    PORT.close_session(ssn)
    assert cache.binder.binds == {}
    cache.shutdown()


def test_census_counts_library_builds(monkeypatch, tmp_path):
    """The compiled-variant census counts requests to build the bid
    library, so a build per cycle would show as growth."""
    from kube_batch_tpu_torch.solver import _build
    from kube_batch_tpu_torch.solver.kernels import jit_compilation_count

    lib = tmp_path / _build.LIB_NAME
    lib.write_bytes(b"")
    monkeypatch.setattr(_build, "library_path", lambda: lib)
    before = jit_compilation_count()
    for _ in range(2):
        assert _build.build()["built"] is False
    assert jit_compilation_count() == before + 2


@pytest.mark.gpu
def test_census_stays_flat_across_cycles_on_the_card():
    """On the card the first cycle builds (or finds) the bid library
    once; the cycles after it leave the census where it was."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run `python -m pytest -m gpu "
                    "tests/test_torch_scheduler.py` on the card")
    from kube_batch_tpu_torch.solver.kernels import jit_compilation_count

    action, _ = get_action("allocate_tpu")
    saved = (action.device, action.use_kernel)
    cache = PORT.build_cluster(*SHAPE, seed=0)
    try:
        sched = PScheduler(cache, TPU_CONF)
        assert sched.device == torch.device("cuda") and action.use_kernel
        rng = np.random.RandomState(1)
        counts, backends = [], []
        for cycle in range(4):
            if cycle == 3:
                n_tasks, _, n_queues, n_groups = SHAPE
                add_burst(PORT, cache, rng, "burst", 1, n_tasks // n_groups,
                          n_queues)
            sched.run_once()
            assert cache.wait_for_side_effects(timeout=60.0)
            counts.append(jit_compilation_count())
            backends.append(P_atpu.last_stats.get("backend"))
    finally:
        cache.shutdown()
        action.device, action.use_kernel = saved
    assert backends[0] == "torch-cuda", backends
    assert counts[0] >= 1 and len(set(counts)) == 1, counts
