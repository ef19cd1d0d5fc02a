"""Each ``Scheduler`` solves on its own device.

The action registry keeps one ``allocate_tpu`` instance per process, and
every scheduler's policy names that same instance. The scheduler's
device therefore rides the session it opens, not the shared action: a
second scheduler built with another device leaves the first one's
solves where they were. The simulator's failover successors and a card
against CPU comparison in one process both build schedulers one after
another.

The CPU test builds a CPU scheduler, then a ``cuda`` one (its device
resolution stubbed where there is no card), and runs the CPU one's
cycle first: it must solve on the CPU, and the ``cuda`` one's cycle
must still ask for CUDA. The ``gpu`` test interleaves a card scheduler
and a CPU scheduler over the same seeded cluster; their binds are equal.
"""

import pathlib

import numpy as np
import pytest
import torch

import kube_batch_tpu_torch.actions  # noqa: F401 (registers actions)
from kube_batch_tpu_torch import scheduler as sched_mod
from kube_batch_tpu_torch.actions import allocate_tpu as P_atpu
from kube_batch_tpu_torch.framework import get_action
from kube_batch_tpu_torch.scheduler import Scheduler
from kube_batch_tpu_torch.utils import test_utils as tu

REPO = pathlib.Path(__file__).resolve().parents[1]
TPU_CONF = str(REPO / "config" / "tpu-batch-conf-tpu.yaml")
SHAPE = (120, 8, 2, 6)  # tasks, nodes, queues, gangs


@pytest.fixture
def shared_action():
    action, _ = get_action("allocate_tpu")
    saved = (action.device, action.use_kernel)
    yield action
    action.device, action.use_kernel = saved


def test_second_scheduler_leaves_the_first_on_its_device(
        shared_action, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the gpu test below runs")
    cpu_cache = tu.build_cluster(*SHAPE, seed=0)
    cuda_cache = tu.build_cluster(*SHAPE, seed=0)
    try:
        cpu_sched = Scheduler(cpu_cache, TPU_CONF, device="cpu")
        # A card scheduler, as far as construction goes: its cycles
        # still resolve ``cuda`` in the action, which raises here.
        monkeypatch.setattr(sched_mod, "resolve_device",
                            lambda device=None: torch.device("cuda"))
        cuda_sched = Scheduler(cuda_cache, TPU_CONF)
        assert cuda_sched.device == torch.device("cuda")
        rng = np.random.RandomState(1)
        for cycle in range(2):
            if cycle:  # new work, so the second cycle solves too
                n_tasks, _, n_queues, n_groups = SHAPE
                tu.add_gang_burst(cpu_cache, rng, "burst", 1,
                                  n_tasks // n_groups, n_queues)
            cpu_sched.run_once()
            assert cpu_cache.wait_for_side_effects(timeout=60.0)
            assert P_atpu.last_stats["backend"] == "torch-cpu"
            with pytest.raises(RuntimeError, match="CUDA"):
                cuda_sched.run_once()
        assert len(cpu_cache.binder.binds) > 0
        assert cuda_cache.binder.binds == {}
        # The shared instance was never rewritten by either scheduler.
        assert shared_action.device is None
    finally:
        cpu_cache.shutdown()
        cuda_cache.shutdown()


@pytest.mark.gpu
def test_card_and_cpu_schedulers_interleaved_bind_alike(shared_action):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run `python -m pytest -m gpu "
                    "tests/test_torch_scheduler_device.py` on the card")
    caches = {d: tu.build_cluster(*SHAPE, seed=0) for d in ("cuda", "cpu")}
    try:
        scheds = {d: Scheduler(c, TPU_CONF, device=d)
                  for d, c in caches.items()}
        rng = {d: np.random.RandomState(1) for d in caches}
        for cycle in range(4):
            for d in ("cuda", "cpu"):
                if cycle == 2:
                    n_tasks, _, n_queues, n_groups = SHAPE
                    tu.add_gang_burst(caches[d], rng[d], "burst", 1,
                                      n_tasks // n_groups, n_queues)
                scheds[d].run_once()
                assert caches[d].wait_for_side_effects(timeout=60.0)
                backend = P_atpu.last_stats.get("backend")
                if backend is not None:
                    assert backend == f"torch-{d}", (cycle, d, backend)
        binds = {d: dict(c.binder.binds) for d, c in caches.items()}
        assert binds["cuda"] == binds["cpu"]
        assert len(binds["cpu"]) > 0
    finally:
        for c in caches.values():
            c.shutdown()
