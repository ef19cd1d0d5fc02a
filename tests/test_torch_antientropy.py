"""Parity of the port's cluster-truth anti-entropy (``cache/antientropy.py``)
with the JAX package's.

The twelve cases of ``tests/unit/test_antientropy.py`` run the same
cluster script through both packages: an ``InProcessCluster`` and a
``SchedulerCache`` watching it, divergence injected by mutating the
cluster with the cache's watch detached, then a sweep. The sweep
reports (``detected``, ``repaired``, ``deferred``, ``exempt_inflight``,
bucket counts) and the cache contents after repair (tasks with their
node and status, node allocatable and idle) must be equal, and equal to
what the reference's cases expect. The warm-parity case runs the port's
``allocate_tpu`` on the CPU.
"""

import importlib
from types import SimpleNamespace

import pytest
import torch

PKGS = ("kube_batch_tpu", "kube_batch_tpu_torch")
REPORT_KEYS = ("detected", "repaired", "deferred", "exempt_inflight",
               "buckets_dirty")


def package(name):
    m = lambda sub: importlib.import_module(f"{name}.{sub}")  # noqa: E731
    m("actions")
    m("plugins")
    return SimpleNamespace(
        name=name, api=m("api"), tu=m("utils.test_utils"),
        SchedulerCache=m("cache").SchedulerCache,
        InProcessCluster=m("cluster").InProcessCluster,
        framework=m("framework"), atpu=m("actions.allocate_tpu"),
    )


def req(P, cpu="1000m", mem="1Gi"):
    return dict(P.api.build_resource_list(cpu=cpu, memory=mem))


def make_cluster_cache(P, nodes=3):
    tu = P.tu
    cluster = P.InProcessCluster(simulate_kubelet=True)
    cache = P.SchedulerCache(
        cluster=cluster, scheduler_name="tpu-batch",
        binder=tu.FakeBinder(), evictor=tu.FakeEvictor(),
        status_updater=tu.FakeStatusUpdater(),
        volume_binder=tu.FakeVolumeBinder(),
    )
    for j in range(nodes):
        cluster.create_node(tu.build_node(
            f"n{j}", P.api.build_resource_list(cpu="8", memory="16Gi",
                                               pods=110)))
    cluster.create_queue(tu.build_queue("default"))
    cache.start_ingest()
    return cluster, cache


def make_pod(P, name, node="", phase=None, group="g1"):
    pod = P.tu.build_pod("ns", name, node, phase or P.api.PodPhase.PENDING,
                         req(P), group_name=group)
    pod.spec.scheduler_name = "tpu-batch"
    return pod


def silent(cluster, cache, fn):
    """Apply a cluster mutation WITHOUT watch delivery — the divergence
    injector."""
    cluster.remove_watch(cache._on_watch_event)
    try:
        fn()
    finally:
        cluster.add_watch(cache._on_watch_event)


def report(rep):
    return {k: rep[k] for k in REPORT_KEYS}


def contents(cache):
    """The mirror after repair: every task with its node and status,
    every node's allocatable and idle CPU."""
    return {
        "tasks": sorted(
            (t.name, t.node_name, t.status.name)
            for j in cache.jobs.values() for t in j.tasks.values()
        ),
        "nodes": {
            name: (ni.allocatable.milli_cpu, ni.idle.milli_cpu,
                   sorted(ni.tasks))
            for name, ni in sorted(cache.nodes.items())
        },
    }


# ---------------------------------------------------------------- scripts
# Each takes a package namespace and returns what the test compares.


def missed_pod(P):
    cluster, cache = make_cluster_cache(P)
    silent(cluster, cache, lambda: cluster.create_pod(make_pod(P, "p1")))
    rep = cache.antientropy.sweep()
    out = dict(report(rep), dirty_job="ns/g1" in cache._dirty_jobs,
               cache=contents(cache))
    cache.shutdown()
    return out


def missed_bind(P):
    cluster, cache = make_cluster_cache(P)
    pod = make_pod(P, "p1")
    cluster.create_pod(pod)
    silent(cluster, cache, lambda: cluster.bind_pod(pod, "n0"))
    out = dict(report(cache.antientropy.sweep()), cache=contents(cache))
    cache.shutdown()
    return out


def phantom_task(P):
    cluster, cache = make_cluster_cache(P)
    pod = make_pod(P, "p1")
    cluster.create_pod(pod)
    silent(cluster, cache, lambda: cluster.delete_pod(pod))
    out = dict(report(cache.antientropy.sweep()), cache=contents(cache))
    cache.shutdown()
    return out


def vanished_and_missed_node(P):
    cluster, cache = make_cluster_cache(P)
    node = next(n for n in cluster.list_objects("Node") if n.name == "n0")
    silent(cluster, cache, lambda: cluster.delete("Node", node))
    new = P.tu.build_node("n9", P.api.build_resource_list(
        cpu="8", memory="16Gi", pods=110))
    silent(cluster, cache, lambda: cluster.create_node(new))
    out = dict(report(cache.antientropy.sweep()), cache=contents(cache))
    cache.shutdown()
    return out


def stale_node_capacity(P):
    cluster, cache = make_cluster_cache(P)
    node = next(n for n in cluster.list_objects("Node") if n.name == "n0")

    def shrink():
        node.status.allocatable = P.api.build_resource_list(
            cpu="2", memory="4Gi", pods=110)
        cluster.update("Node", node)

    silent(cluster, cache, shrink)
    out = dict(report(cache.antientropy.sweep()), cache=contents(cache))
    cache.shutdown()
    return out


def _binding_task(P, cluster, cache):
    pod = make_pod(P, "p1")
    cluster.create_pod(pod)
    job = next(iter(cache.jobs.values()))
    task = next(iter(job.tasks.values()))
    job.update_task_status(task, P.api.TaskStatus.BINDING)
    task.node_name = "n0"
    return pod


def inflight_binding_task_exempt(P):
    """A BINDING task (side effect on the wire) is never judged against
    truth mid-flight."""
    cluster, cache = make_cluster_cache(P)
    _binding_task(P, cluster, cache)
    out = dict(report(cache.antientropy.sweep()), cache=contents(cache))
    cache.shutdown()
    return out


def orphaned_binding_task_repaired(P):
    """A BINDING task whose pod is gone from truth is an orphan, not
    in-flight: the exemption does not shield it."""
    cluster, cache = make_cluster_cache(P)
    pod = _binding_task(P, cluster, cache)
    silent(cluster, cache, lambda: cluster.delete_pod(pod))
    out = dict(report(cache.antientropy.sweep()), cache=contents(cache))
    cache.shutdown()
    return out


def terminated_orphan(P):
    """A SUCCEEDED pod still in the cluster is cleanup's business; a
    mirror-terminated task whose pod is gone is a phantom."""
    cluster, cache = make_cluster_cache(P)
    pod = make_pod(P, "p1")
    cluster.create_pod(pod)
    pod.status.phase = P.api.PodPhase.SUCCEEDED
    cluster.update("Pod", pod)
    first = report(cache.antientropy.sweep())
    silent(cluster, cache, lambda: cluster.delete_pod(pod))
    out = dict(first=first, second=report(cache.antientropy.sweep()),
               cache=contents(cache))
    cache.shutdown()
    return out


def budget_defers_remainder(P):
    cluster, cache = make_cluster_cache(P)

    def create_many():
        for i in range(6):
            cluster.create_pod(make_pod(P, f"p{i}"))

    silent(cluster, cache, create_many)
    reps = [report(cache.antientropy.sweep(budget=2)),
            report(cache.antientropy.sweep(budget=None)),
            report(cache.antientropy.sweep())]
    out = dict(reports=reps, cache=contents(cache))
    cache.shutdown()
    return out


def consistent_sweep(P):
    cluster, cache = make_cluster_cache(P)
    cluster.create_pod(make_pod(P, "p1"))
    rep = report(cache.antientropy.sweep())
    state = cache.integrity_state()
    out = dict(rep, sweeps=state["sweeps"],
               divergence=state["divergence_detected"],
               cache=contents(cache))
    cache.shutdown()
    return out


def sweep_cadence(P, monkeypatch):
    monkeypatch.setenv("KBT_ANTIENTROPY_EVERY", "3")
    cluster, cache = make_cluster_cache(P)
    ran = [cache.run_antientropy_if_due() is not None for _ in range(7)]
    monkeypatch.setenv("KBT_ANTIENTROPY", "0")
    cache._antientropy = None
    off = cache.run_antientropy_if_due()
    monkeypatch.delenv("KBT_ANTIENTROPY")
    monkeypatch.delenv("KBT_ANTIENTROPY_EVERY")
    cache.shutdown()
    return dict(ran=ran, off=off)


SCRIPTS = {
    "missed_pod": missed_pod,
    "missed_bind": missed_bind,
    "phantom_task": phantom_task,
    "vanished_and_missed_node": vanished_and_missed_node,
    "stale_node_capacity": stale_node_capacity,
    "inflight_binding_task_exempt": inflight_binding_task_exempt,
    "orphaned_binding_task_repaired": orphaned_binding_task_repaired,
    "terminated_orphan_repaired_but_live_terminated_skipped":
        terminated_orphan,
    "budget_defers_remainder": budget_defers_remainder,
    "consistent_sweep_is_clean_and_counts": consistent_sweep,
}

# What the reference's cases expect of each script (port side).
EXPECT = {
    "missed_pod": lambda o: (
        o["detected"] == {"missed-pod": 1}
        and o["repaired"] == {"missed-pod": 1}
        and len(o["cache"]["tasks"]) == 1 and o["dirty_job"]),
    "missed_bind": lambda o: (
        o["detected"] == {"missed-bind": 1}
        and o["cache"]["tasks"][0][1] == "n0"
        and o["cache"]["nodes"]["n0"][2] != []),
    "phantom_task": lambda o: (
        o["detected"] == {"phantom-task": 1} and o["cache"]["tasks"] == []),
    "vanished_and_missed_node": lambda o: (
        o["detected"] == {"vanished-node": 1, "missed-node": 1}
        and "n0" not in o["cache"]["nodes"] and "n9" in o["cache"]["nodes"]),
    "stale_node_capacity": lambda o: (
        o["detected"] == {"stale-node": 1}
        and o["cache"]["nodes"]["n0"][0] == 2000.0),
    "inflight_binding_task_exempt": lambda o: (
        o["detected"] == {} and o["exempt_inflight"] == 1),
    "orphaned_binding_task_repaired": lambda o: (
        o["detected"] == {"phantom-task": 1}
        and o["repaired"] == {"phantom-task": 1}
        and o["cache"]["tasks"] == []),
    "terminated_orphan_repaired_but_live_terminated_skipped": lambda o: (
        o["first"]["detected"] == {}
        and o["second"]["detected"] == {"phantom-task": 1}
        and o["cache"]["tasks"] == []),
    "budget_defers_remainder": lambda o: (
        sum(o["reports"][0]["repaired"].values()) == 2
        and o["reports"][0]["deferred"] == 4
        and sum(o["reports"][1]["repaired"].values()) == 4
        and o["reports"][2]["detected"] == {}),
    "consistent_sweep_is_clean_and_counts": lambda o: (
        o["detected"] == {} and o["buckets_dirty"] == 0
        and o["sweeps"] == 1 and o["divergence"] == {}),
}


@pytest.mark.parametrize("case", sorted(SCRIPTS))
def test_sweep_matches_reference(case):
    ref, got = (SCRIPTS[case](package(p)) for p in PKGS)
    assert got == ref
    assert EXPECT[case](got), got


def test_sweep_cadence_matches_reference(monkeypatch):
    ref, got = (sweep_cadence(package(p), monkeypatch) for p in PKGS)
    assert got == ref
    assert got["ran"] == [True, False, False, True, False, False, True]
    assert got["off"] is None


@pytest.fixture
def allocate_on_cpu(monkeypatch):
    """The JAX action on one device with host selection; the port's
    action on the CPU (its wrappers run the plain versions there)."""
    from kube_batch_tpu.solver import sharding as JS

    monkeypatch.setenv("KBT_SOLVER", "jax")
    monkeypatch.setenv("KBT_SELECT_DEVICE", "0")
    monkeypatch.setattr(JS, "default_mesh", lambda devices=None: None)
    P = package(PKGS[1])
    action, _ = P.framework.get_action("allocate_tpu")
    saved = action.device
    action.device = torch.device("cpu")
    yield
    action.device = saved


def warm_run(P, warm, monkeypatch):
    """A wave places, a warm steady cycle, a silently created pod
    repaired by sweep, and the post-repair cycle."""
    if warm:
        monkeypatch.delenv("KBT_WARM", raising=False)
    else:
        monkeypatch.setenv("KBT_WARM", "0")
    cluster, cache = make_cluster_cache(P, nodes=4)
    action, _ = P.framework.get_action("allocate_tpu")
    if P.name == PKGS[0]:
        from tests.actions.test_actions import DEFAULT_TIERS_ARGS, make_tiers
    else:
        make_tiers = P.tu.make_tiers
        DEFAULT_TIERS_ARGS = P.tu.DEFAULT_TIERS_ARGS
    tiers = make_tiers(*DEFAULT_TIERS_ARGS)

    def cycle():
        ssn = P.framework.open_session(cache, tiers)
        action.execute(ssn)
        outcome = P.atpu.last_stats.get("warm_outcome")
        P.framework.close_session(ssn)
        assert cache.wait_for_side_effects(timeout=30.0)
        assert cache.wait_for_bookkeeping(timeout=30.0)
        cache.drain_resync_queue()
        cache.drain_cleanup_queue()
        return outcome

    cluster.create_pod_group(P.tu.build_pod_group(
        "g1", namespace="ns", min_member=1, queue="default"))
    for i in range(4):
        cluster.create_pod(make_pod(P, f"a{i}"))
    cycle()
    outcome2 = cycle()
    silent(cluster, cache,
           lambda: cluster.create_pod(make_pod(P, "late1")))
    repaired = cache.antientropy.sweep()["repaired"]
    outcome3 = cycle()
    out = dict(repaired=repaired, cache=contents(cache),
               outcomes=(outcome2, outcome3))
    cache.shutdown()
    return out


def test_warm_parity_across_repair(allocate_on_cpu, monkeypatch):
    """A repair lands in the dirty ledger, so the post-repair warm solve
    equals a cold (KBT_WARM=0) twin, in both packages and between them."""
    runs = {(p, warm): warm_run(package(p), warm, monkeypatch)
            for p in PKGS for warm in (True, False)}
    got_warm, got_cold = runs[(PKGS[1], True)], runs[(PKGS[1], False)]
    assert got_warm == runs[(PKGS[0], True)]
    assert got_cold["cache"] == runs[(PKGS[0], False)]["cache"]
    assert got_warm["cache"] == got_cold["cache"]
    assert got_warm["repaired"] == {"missed-pod": 1}
    assert got_warm["outcomes"][0] in ("noop", "solve")
    assert got_warm["outcomes"][1] != "noop"
    assert any(name == "late1" and node
               for name, node, _ in got_warm["cache"]["tasks"])
