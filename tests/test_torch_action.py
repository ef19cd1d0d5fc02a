"""Parity of the port's ``allocate_tpu`` action with the JAX package's.

One seeded cluster per package (the two ``build_cluster`` copies) goes
through ``open_session`` → ``execute`` → ``close_session`` over the
cycles of the reference's ``bench.py::bench_cycle``: cold, steady, idle
and a 1 % delta burst (twice, so a congested cluster's carried backlog
meets new work and the warm plan answers with a subset solve). Two runs:

- (i) the JAX package's default chain against the port with
  ``use_kernel=False``, warm path on: every cycle bit-equal, warm
  subset cycles included;
- (ii) the JAX package with its Pallas bid kernels forced on (interpret
  mode, patched in the test only) against the port with the kernels
  (their plain versions on CPU tensors), both under ``KBT_WARM=0`` so
  every solving cycle is a full solve.

Per cycle: the assignment vector, ``rounds``, ``stages``, ``refills``,
the warm outcome, the ladder and the bound (pod, node) set are equal,
and ``last_stats`` carries the same keys apart from timings. The JAX
side runs with ``KBT_SOLVER=jax`` and ``KBT_SELECT_DEVICE=0`` on one
device: the suite's 8-device virtual mesh would otherwise shard its
dense solve, where its Pallas pass is off.

The warm-subset invariant on the kernels has no JAX run to compare with
(the JAX package bars its Pallas pass from subset bundles), so the
reference's warm/cold scripts (``tests/solver/test_warm_solve.py``) run
on the port with the kernels: a warm scheduler must leave the cluster
bit-identical to a cold one, and the congested scripts must reach
``subset``.
"""

import functools
import os

import numpy as np
import pytest
import torch

import kube_batch_tpu_torch.actions  # noqa: F401 (registers actions)
from kube_batch_tpu_torch.actions import allocate_tpu as P_atpu
from kube_batch_tpu_torch.api import PodPhase, TaskStatus, build_resource_list
from kube_batch_tpu_torch.framework import (
    close_session,
    get_action,
    open_session,
)
from kube_batch_tpu_torch.utils import test_utils as PTU

from tests.test_torch_snapshot import PORT, empty_cache, env, jax_pkg, tiers

torch.set_num_threads(1)

# Cycles of bench_cycle, plus a second delta (see the module docstring).
CYCLES = ("cold", "steady", "idle", "delta", "delta2")

# (build_cluster arguments, KBT_SOLVER_TOPK): ample capacity (every pod
# placed cold, the deltas solve warm), congested (a carried backlog, so
# the deltas solve as subsets), and the congested one with candidate
# slabs forced (the sparse solve and bid_sparse's plain version).
CLUSTERS = {
    "ample": ((1000, 100, 2, 20), "off"),
    "congested": ((1000, 24, 2, 20), "off"),
    "slabs": ((1000, 24, 2, 20), "4"),
}

# last_stats keys that vary from run to run: timings, the backend label,
# and whether the bind queue drained inside the overlap window.
VOLATILE = ("backend", "overlap_binds_drained")


@functools.cache
def jax_side():
    J = jax_pkg()
    import kube_batch_tpu.actions  # noqa: F401 (registers actions)
    from kube_batch_tpu.actions import allocate_tpu as J_atpu
    from kube_batch_tpu.framework import get_action as j_get_action
    from kube_batch_tpu.solver import kernels as JK
    from kube_batch_tpu.solver import pallas_kernels as JP
    from kube_batch_tpu.solver import sharding as JS

    return J, J_atpu, j_get_action, JK, JP, JS


def add_burst(pkg, cache, rng, prefix, groups, per_group, n_queues):
    """bench_cycle's delta burst in ``pkg``'s object model (the port's
    copy is ``test_utils.add_gang_burst``)."""
    a, tu = pkg.api, pkg.tu
    for g in range(groups):
        name = f"{prefix}{g}"
        cache.add_pod_group(tu.build_pod_group(
            name, namespace="bench",
            min_member=int(rng.randint(1, per_group + 1)),
            queue=f"q{g % n_queues}",
        ))
        for i in range(per_group):
            cache.add_pod(tu.build_pod(
                "bench", f"{name}-p{i}", "", a.PodPhase.PENDING,
                a.build_resource_list(
                    cpu=f"{int(rng.choice([250, 500, 1000, 2000, 4000]))}m",
                    memory=f"{int(rng.choice([256, 512, 1024, 4096, 8192]))}Mi",
                ),
                group_name=name,
            ))


@pytest.fixture
def setup(monkeypatch):
    """Both actions, their solve ladders wrapped to capture each solve's
    assignment and counters, the JAX side on one device with host
    selection, and the port's action on the CPU."""
    J, J_atpu, j_get_action, JK, JP, JS = jax_side()
    monkeypatch.setenv("KBT_SOLVER", "jax")
    monkeypatch.setenv("KBT_SELECT_DEVICE", "0")
    monkeypatch.setattr(JS, "default_mesh", lambda devices=None: None)
    solves = {"jax": [], "torch": []}
    for name, mod in (("jax", J_atpu), ("torch", P_atpu)):
        orig = mod.AllocateTpuAction._solve_ladder

        def wrapped(self, *args, _orig=orig, _out=solves[name]):
            assigned, handle = _orig(self, *args)
            _out.append({
                "assigned": np.asarray(assigned).copy(),
                "rounds": handle.rounds, "stages": handle.stages,
                "refills": handle.refills,
            })
            return assigned, handle

        monkeypatch.setattr(mod.AllocateTpuAction, "_solve_ladder", wrapped)
    port_action, _ = get_action("allocate_tpu")
    saved = (port_action.device, port_action.use_kernel)
    port_action.device = "cpu"
    yield {
        "J": J, "J_atpu": J_atpu, "jax_action": j_get_action(
            "allocate_tpu")[0], "port_action": port_action,
        "JK": JK, "JP": JP, "solves": solves,
    }
    port_action.device, port_action.use_kernel = saved


def counted(calls, name, fn):
    def wrapper(*args, **kw):
        calls[name] = calls.get(name, 0) + 1
        return fn(*args, **kw)

    return wrapper


def force_kernels(monkeypatch, JK, JP):
    """The JAX package's Pallas configuration on the CPU: the gate
    forced on, both kernels in interpret mode, and a fresh jit of
    ``solve_auto`` so no trace made without them is reused. Calls of
    both packages' bid passes are counted (the JAX ones once per trace,
    the port's per round)."""
    import jax

    from kube_batch_tpu_torch.solver import bid_kernels as BK

    calls = {}
    monkeypatch.setattr(JK, "_should_use_pallas", lambda: True)
    for name in ("pallas_bid", "pallas_bid_sparse"):
        monkeypatch.setattr(JP, name, counted(
            calls, name, functools.partial(getattr(JP, name), interpret=True)
        ))
    for name in ("bid_dense", "bid_sparse"):
        monkeypatch.setattr(BK, name, counted(calls, name, getattr(BK, name)))
    def solve_auto(inputs, max_rounds=256, allow_pallas=True):
        return JK.solve_auto(inputs, max_rounds=max_rounds,
                             allow_pallas=allow_pallas)

    # A new function: jax.jit of the module's own solve_auto would share
    # its trace cache.
    monkeypatch.setattr(JK, "solve_jit", jax.jit(
        solve_auto, static_argnames=("max_rounds", "allow_pallas")))
    return calls


def drive(pkg, action, stats, solves, shape):
    """The cycles of CYCLES on a fresh ``build_cluster`` of ``pkg``; per
    cycle the action's stats, the new solve (if any) and the binds."""
    n_tasks, _, n_queues, n_groups = shape
    cache = pkg.build_cluster(*shape, seed=0)
    rng = np.random.RandomState(1)
    per_group = n_tasks // n_groups
    out = []
    for cycle in CYCLES:
        if cycle.startswith("delta"):
            add_burst(pkg, cache, rng, f"pg{cycle}", max(1, n_groups // 100),
                      per_group, n_queues)
        before = len(solves)
        ssn = pkg.open_session(cache, tiers(pkg))
        action.execute(ssn)
        pkg.close_session(ssn)
        assert cache.wait_for_side_effects(timeout=60.0)
        out.append({
            "cycle": cycle,
            "stats": dict(stats),
            "solve": solves[before] if len(solves) > before else None,
            "binds": dict(cache.binder.binds),
        })
    cache.shutdown()
    return out


def assert_same_cycles(ref, got):
    for r, g in zip(ref, got, strict=True):
        what = r["cycle"]
        rs, gs = r["stats"], g["stats"]
        assert gs.get("warm_outcome") == rs.get("warm_outcome"), what
        assert gs.get("solve_ladder") == rs.get("solve_ladder"), what
        assert (r["solve"] is None) == (g["solve"] is None), what
        if r["solve"] is not None:
            assert np.array_equal(g["solve"]["assigned"],
                                  r["solve"]["assigned"]), what
            for k in ("rounds", "stages", "refills"):
                assert g["solve"][k] == r["solve"][k], (what, k)
            assert gs["backend"] == "torch-cpu", what
        assert g["binds"] == r["binds"], what
        keys = lambda s: {  # noqa: E731
            k for k in s if not k.endswith("_ms") and k not in VOLATILE
        }
        assert keys(gs) == keys(rs), (what, keys(gs) ^ keys(rs))
        for k in ("placed", "warm_carried", "sparse_engaged",
                  "unschedulable_reasons", "solve_degraded"):
            assert gs.get(k) == rs.get(k), (what, k)


def run_both(setup, shape, topk):
    J, s = setup["J"], setup["solves"]
    with env(KBT_SOLVER_TOPK=topk):
        ref = drive(J, setup["jax_action"], setup["J_atpu"].last_stats,
                    s["jax"], shape)
        got = drive(PORT, setup["port_action"], P_atpu.last_stats,
                    s["torch"], shape)
    return ref, got


@pytest.mark.parametrize("cluster", sorted(CLUSTERS))
def test_default_chain_cycles_bit_equal(setup, cluster):
    """Run (i): warm path on, plain chain."""
    shape, topk = CLUSTERS[cluster]
    setup["port_action"].use_kernel = False
    ref, got = run_both(setup, shape, topk)
    assert_same_cycles(ref, got)
    outcomes = [c["stats"].get("warm_outcome") for c in got]
    # The compiled-variant census stays flat across cycles.
    assert len({c["stats"]["jit_variants"] for c in got
                if "jit_variants" in c["stats"]}) == 1
    if cluster == "ample":
        assert outcomes == ["cold", "noop", "noop", "solve", "solve"]
    else:
        assert outcomes[0] == "cold" and "subset" in outcomes, outcomes
    if topk != "off":
        assert got[0]["stats"]["sparse_engaged"] is True


@pytest.mark.parametrize("cluster", sorted(CLUSTERS))
def test_kernel_cycles_bit_equal(setup, cluster, monkeypatch):
    """Run (ii): every solving cycle a full solve, kernels on."""
    shape, topk = CLUSTERS[cluster]
    calls = force_kernels(monkeypatch, setup["JK"], setup["JP"])
    monkeypatch.setenv("KBT_WARM", "0")
    setup["port_action"].use_kernel = True
    ref, got = run_both(setup, shape, topk)
    assert_same_cycles(ref, got)
    assert {c["stats"].get("warm_outcome") for c in got} == {"disabled"}
    kind = "sparse" if topk != "off" else "dense"
    if topk != "off":
        assert got[0]["stats"]["sparse_engaged"] is True
    assert calls.get(f"bid_{kind}", 0) > 0, calls
    assert calls.get("pallas_bid" + ("_sparse" if topk != "off" else ""),
                     0) > 0, calls


# ------------------------------------------------- warm subsets on kernels


class _PortScenario:
    """The reference's ``_ScenarioDriver`` replayed on the port: the
    same event scripts (drawn by ``_ScenarioDriver.script``), applied with
    the port's object model, through the port's action."""

    def __init__(self, nodes=8, queues=2):
        self.nodes = nodes
        self.queues = queues

    def run(self, script, warm):
        with env(KBT_WARM="1" if warm else "0"):
            cache = empty_cache(PORT)
            for q in range(self.queues):
                cache.add_queue(PTU.build_queue(f"q{q}", weight=q + 1))
            for j in range(self.nodes):
                cache.add_node(PTU.build_node(
                    f"n{j}",
                    build_resource_list(cpu="8", memory="32Gi", pods=110),
                ))
            action, _ = get_action("allocate_tpu")
            states, outcomes = [], []
            for events in script:
                self._apply(cache, events)
                ssn = open_session(cache, tiers(PORT))
                action.execute(ssn)
                outcomes.append(P_atpu.last_stats.get("warm_outcome"))
                close_session(ssn)
                assert cache.wait_for_side_effects(timeout=30.0)
                assert cache.wait_for_bookkeeping(timeout=30.0)
                states.append(self._state(cache))
            cache.shutdown()
        return states, outcomes

    def _gang(self, cache, name, min_member, queue, cpu, mem, pods):
        if min_member is not None:
            cache.add_pod_group(PTU.build_pod_group(
                name, namespace="ns", min_member=min_member, queue=queue,
            ))
        for i in pods:
            cache.add_pod(PTU.build_pod(
                "ns", f"{name}-p{i}", "", PodPhase.PENDING,
                build_resource_list(cpu=f"{cpu}m", memory=f"{mem}Mi"),
                group_name=name,
            ))

    def _apply(self, cache, events):
        for kind, payload in events:
            if kind == "gang":
                name, size, min_member, queue, cpu, mem = payload
                self._gang(cache, name, min_member, queue, cpu, mem,
                           range(size))
            elif kind == "gang-head":
                name, size, min_member, queue, cpu, mem, head = payload
                self._gang(cache, name, min_member, queue, cpu, mem,
                           range(head))
            elif kind == "gang-tail":
                name, size, min_member, queue, cpu, mem, head = payload
                self._gang(cache, name, None, queue, cpu, mem,
                           range(head, size))
            elif kind == "complete":
                bound = self._bound_tasks(cache)
                if bound:
                    pod = bound[payload % len(bound)].pod
                    pod.status.phase = PodPhase.SUCCEEDED
                    cache.delete_pod(pod)
            elif kind == "kill-node":
                node = cache.nodes.get(f"n{payload % self.nodes}")
                if node is not None and node.node is not None:
                    cache.delete_node(node.node)
            elif kind == "evict":
                bound = self._bound_tasks(cache)
                if bound:
                    try:
                        cache.evict(bound[payload % len(bound)],
                                    "test-preempt")
                    except Exception:
                        pass

    @staticmethod
    def _bound_tasks(cache):
        out = []
        with cache.mutex:
            for key in sorted(cache.jobs):
                job = cache.jobs[key]
                for uid in sorted(job.tasks):
                    t = job.tasks[uid]
                    if t.status == TaskStatus.BINDING and t.node_name:
                        out.append(t)
        return out

    @staticmethod
    def _state(cache):
        with cache.mutex:
            jobs = {
                key: sorted((uid, t.status.name, t.node_name)
                            for uid, t in job.tasks.items())
                for key, job in cache.jobs.items()
            }
            nodes = {
                name: (n.idle.milli_cpu, n.idle.memory, n.used.milli_cpu,
                       n.used.memory, len(n.tasks))
                for name, n in cache.nodes.items()
            }
        return jobs, nodes


@functools.cache
def reference_warm_scripts():
    from tests.solver import test_warm_solve as W

    return W


def warm_cold_pair(script, nodes=8):
    warm, outcomes = _PortScenario(nodes=nodes).run(script, warm=True)
    cold, cold_outcomes = _PortScenario(nodes=nodes).run(script, warm=False)
    assert set(cold_outcomes) == {"disabled"}
    for c, (w, k) in enumerate(zip(warm, cold, strict=True)):
        assert w == k, f"warm/cold diverged at cycle {c} ({outcomes[c]!r})"
    return outcomes


@pytest.fixture
def kernels_on_cpu():
    action, _ = get_action("allocate_tpu")
    saved = (action.device, action.use_kernel)
    action.device, action.use_kernel = "cpu", True
    os.environ.pop("KBT_SOLVER_TOPK", None)
    yield
    action.device, action.use_kernel = saved


@pytest.mark.parametrize("scenario", ["arrival", "completion", "node-death",
                                      "placement-wave", "preempt"])
def test_warm_equals_cold_on_the_kernels(kernels_on_cpu, scenario):
    """``TestWarmColdBitParity``'s randomized churn scripts."""
    W = reference_warm_scripts()
    kinds, cycles = W.SCENARIOS[scenario]
    for seed in (3, 17):
        script = W._ScenarioDriver(seed).script(kinds, cycles)
        outcomes = warm_cold_pair(script)
        assert outcomes[0] == "cold"


@pytest.mark.parametrize("seed,kinds,cycles", [
    (21, ["wave", "arrival"], 10),
    (23, ["wave", "arrival", "evict"], 10),
    (25, ["wave", "arrival", "completion"], 12),
])
def test_congested_subset_solves_equal_cold_on_the_kernels(
        kernels_on_cpu, seed, kinds, cycles):
    """``TestCongestedSubsetParity``: a carried backlog on 2 nodes meets
    new work every cycle; the subset solves must engage and leave the
    cluster as a cold scheduler does."""
    W = reference_warm_scripts()
    script = W._ScenarioDriver(seed, nodes=2).script(kinds, cycles)
    outcomes = warm_cold_pair(script, nodes=2)
    assert "subset" in outcomes, outcomes


def test_gang_spanning_cycle_boundary_on_the_kernels(kernels_on_cpu):
    script = [
        [("gang", ("gb0", 6, 2, "q0", 2000, 1024)),
         ("gang", ("gb1", 6, 2, "q1", 2000, 1024)),
         ("gang-head", ("gs", 4, 4, "q0", 500, 512, 2))],
        [("gang-tail", ("gs", 4, 4, "q0", 500, 512, 2))],
        [("complete", 0), ("complete", 1)],
        [("gang", ("gn", 2, 1, "q1", 500, 512))],
        [("complete", 2)],
        [],
    ]
    outcomes = warm_cold_pair(script, nodes=2)
    assert "subset" in outcomes, outcomes
