"""What the port records of its full dense solve, on the CPU.

A dense solve runs its preparation (the [T, N] feasibility and static
score matrices and the Releasing-capacity escape) under one
``solve.prep`` span before its first ``solve.round``. Its result counts
its ``bid_dense`` launches, one a round on the kernel path with CUDA
tensors and none on the plain chain or off the card, with the bundle's
T, N and R. Through the scheduler,
``allocate_tpu.last_stats["solve_path"]`` names the solver that
produced a cycle's result (``dense`` below the sparse size policy's
1,024 nodes, ``sparse`` above it), and ``last_stats["bid_dense"]``
carries the dense solve's count and shape.
"""

import pathlib

import pytest
import torch

import kube_batch_tpu_torch.actions  # noqa: F401 (registers actions)
import kube_batch_tpu_torch.plugins  # noqa: F401 (registers plugins)
from kube_batch_tpu_torch.actions import allocate_tpu as P_atpu
from kube_batch_tpu_torch.framework import (
    close_session,
    get_action,
    open_session,
)
from kube_batch_tpu_torch.obs.tracer import TRACER
from kube_batch_tpu_torch.scheduler import Scheduler
from kube_batch_tpu_torch.solver import kernels as PK
from kube_batch_tpu_torch.solver.snapshot import pack_inputs, tensorize
from kube_batch_tpu_torch.utils.test_utils import build_cluster, make_tiers

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
TPU_CONF = str(REPO / "config" / "tpu-batch-conf-tpu.yaml")
TIERS = (["priority", "gang", "conformance"],
         ["drf", "predicates", "proportion", "nodeorder"])


@pytest.fixture
def tracer():
    TRACER.disable()
    TRACER.reset()
    TRACER.enable()
    try:
        yield TRACER
    finally:
        TRACER.disable()
        TRACER.reset()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run `python -m pytest -m gpu "
                    "tests/test_torch_dense_stats.py` on the card")
    return torch.device("cuda")


@pytest.fixture
def shared_action():
    action, _ = get_action("allocate_tpu")
    saved = (action.device, action.use_kernel)
    yield action
    action.device, action.use_kernel = saved


def dense_bundle(monkeypatch, tasks=300, nodes=24, device="cpu"):
    """A tensorized snapshot of ``build_cluster`` with the sparse path
    off, packed on ``device``."""
    monkeypatch.setenv("KBT_SOLVER_TOPK", "off")
    monkeypatch.setenv("KBT_SELECT_DEVICE", "0")
    cache = build_cluster(tasks, nodes, 3, 10, seed=5)
    ssn = open_session(cache, make_tiers(*TIERS), device="cpu")
    _, ctx = tensorize(ssn, device=False)
    close_session(ssn)
    cache.shutdown()
    return pack_inputs(ctx.host_inputs, device).unpack()


def test_one_prep_span_before_the_first_round(tracer, monkeypatch):
    inputs = dense_bundle(monkeypatch)
    result = PK.solve(inputs, use_kernel=True)
    events = sorted(TRACER.events(), key=lambda e: e["ts"])
    names = [e["name"] for e in events]
    assert names.count("solve.prep") == 1
    assert names.count("solve.round") == result.rounds > 0
    prep = events[names.index("solve.prep")]
    first = events[names.index("solve.round")]
    assert prep["ts"] + prep["dur"] <= first["ts"]


@pytest.mark.parametrize("use_kernel", [True, False],
                         ids=["kernel", "plain"])
def test_the_result_counts_the_bid_passes_and_their_shape(
        monkeypatch, use_kernel):
    inputs = dense_bundle(monkeypatch)
    result = PK.solve(inputs, use_kernel=use_kernel)
    T, R = inputs.task_fit.shape
    got = result.bid_dense
    assert (got.rows, got.nodes, got.dims) == (
        T, inputs.node_idle.shape[0], R)
    assert got.static == (PK.build_static_score(inputs) is not None)
    # CPU tensors take the plain bid on either path: nothing launches.
    assert result.rounds > 0 and got.launches == 0


@pytest.mark.gpu
def test_each_kernel_round_launches_one_bid_dense_on_card(
        monkeypatch, cuda_device):
    from kube_batch_tpu_torch.solver import bid_kernels as BK

    inputs = dense_bundle(monkeypatch, device=cuda_device)
    before = BK.bid_dense.launches
    result = PK.solve(inputs, use_kernel=True)
    launched = BK.bid_dense.launches - before
    assert result.rounds > 0
    assert result.bid_dense.launches == result.rounds == launched
    assert PK.solve(inputs, use_kernel=False).bid_dense.launches == 0


def _one_cycle(tasks, nodes):
    cache = build_cluster(tasks, nodes, 3, 10, seed=7)
    try:
        Scheduler(cache, TPU_CONF, device="cpu").run_once()
        assert cache.wait_for_side_effects(timeout=60.0)
        assert cache.binder.binds
        return dict(P_atpu.last_stats)
    finally:
        cache.shutdown()


@pytest.mark.parametrize("use_kernel", [True, False],
                         ids=["kernel", "plain"])
def test_a_small_cycle_takes_the_dense_path(
        shared_action, monkeypatch, use_kernel):
    monkeypatch.delenv("KBT_SOLVER_TOPK", raising=False)
    shared_action.use_kernel = use_kernel
    stats = _one_cycle(240, 40)
    assert stats["solve_path"] == "dense"
    assert stats["sparse_engaged"] is False
    launches = stats["bid_dense"]
    assert stats["rounds"] > 0 and launches["launches"] == 0
    assert launches["dims"] >= 2 and launches["rows"] >= 240
    assert launches["nodes"] >= 40


def test_a_cycle_above_the_size_policy_takes_the_sparse_path(
        shared_action, monkeypatch):
    monkeypatch.delenv("KBT_SOLVER_TOPK", raising=False)
    shared_action.use_kernel = True
    stats = _one_cycle(1100, 1024)
    assert stats["solve_path"] == "sparse"
    assert stats["sparse_engaged"] is True
    assert "bid_dense" not in stats
