"""Parity of the port's host snapshot path with the JAX package.

The same seeded clusters (and the same event sequences) go into both
packages' caches, through ``open_session`` with the default tiers and
``tensorize(ssn, device=False)``. Every field of ``ctx.host_inputs``
must be equal in dtype, shape and bytes, and ``ctx.tasks``,
``ctx.nodes`` and ``ctx.queues`` must come in the same order. Under
churn, each cycle's incremental bundle must also equal a cold
``tensorize`` on a freshly built cache, and ``last_tensorize_stats``
must equal the reference's. The helpers here are shared by
``tests/test_torch_device_cache.py``.
"""

import contextlib
import functools
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def host_selection(monkeypatch):
    """Host selection on the JAX side: its device selection needs
    jax.experimental.enable_x64, which this JAX version lacks, and the
    JAX package makes the two bit-equal."""
    monkeypatch.setenv("KBT_SELECT_DEVICE", "0")


@functools.cache
def jax_pkg():
    """The JAX package's side, imported at first use (``bench`` and the
    reference tests' helpers import by the ``tests.`` package path)."""
    import bench
    import kube_batch_tpu.plugins  # noqa: F401 (registers plugins)
    from kube_batch_tpu import api
    from kube_batch_tpu.cache import SchedulerCache
    from kube_batch_tpu.framework import close_session, open_session
    from kube_batch_tpu.solver import snapshot, topk
    from kube_batch_tpu.utils import test_utils
    from tests.actions.test_actions import make_tiers

    return SimpleNamespace(
        name="jax", api=api, tu=test_utils, SchedulerCache=SchedulerCache,
        build_cluster=bench.build_cluster, make_tiers=make_tiers,
        open_session=open_session, close_session=close_session,
        snapshot=snapshot, topk=topk,
    )


def _torch_pkg():
    import kube_batch_tpu_torch.plugins  # noqa: F401 (registers plugins)
    from kube_batch_tpu_torch import api
    from kube_batch_tpu_torch.cache import SchedulerCache
    from kube_batch_tpu_torch.framework import close_session, open_session
    from kube_batch_tpu_torch.solver import snapshot, topk
    from kube_batch_tpu_torch.utils import test_utils

    return SimpleNamespace(
        name="torch", api=api, tu=test_utils, SchedulerCache=SchedulerCache,
        build_cluster=test_utils.build_cluster,
        make_tiers=test_utils.make_tiers,
        open_session=open_session, close_session=close_session,
        snapshot=snapshot, topk=topk,
    )


PORT = _torch_pkg()
TIERS_ARGS = (
    ["priority", "gang", "conformance"],
    ["drf", "predicates", "proportion", "nodeorder"],
)


@contextlib.contextmanager
def env(**values):
    saved = {k: os.environ.get(k) for k in values}
    os.environ.update({k: str(v) for k, v in values.items()})
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def empty_cache(pkg):
    tu = pkg.tu
    return pkg.SchedulerCache(
        binder=tu.FakeBinder(), evictor=tu.FakeEvictor(),
        status_updater=tu.FakeStatusUpdater(),
        volume_binder=tu.FakeVolumeBinder(),
    )


def tiers(pkg):
    return pkg.make_tiers(*TIERS_ARGS)


# ---------------------------------------------------------------- clusters
# Each builder takes a package and returns a cache; both packages draw
# the same RNG values in the same order.

def cluster_bench(pkg, n_tasks=600, n_nodes=48, n_queues=3, n_groups=12,
                  seed=3):
    return pkg.build_cluster(n_tasks, n_nodes, n_queues, n_groups,
                             seed=seed)


def cluster_gpu(pkg, seed=7):
    """A scalar resource on every fourth node and in every third gang."""
    rng = np.random.RandomState(seed)
    a, tu = pkg.api, pkg.tu
    c = empty_cache(pkg)
    for q in range(2):
        c.add_queue(tu.build_queue(f"q{q}", weight=q + 1))
    for j in range(40):
        extra = {"nvidia.com/gpu": 4} if j % 4 == 0 else {}
        c.add_node(tu.build_node(f"n{j}", a.build_resource_list(
            cpu="16", memory="64Gi", pods=110, **extra)))
    for g in range(12):
        c.add_pod_group(tu.build_pod_group(
            f"pg{g}", namespace="ns", min_member=2, queue=f"q{g % 2}"))
        for i in range(20):
            extra = {"nvidia.com/gpu": 1} if g % 3 == 0 else {}
            c.add_pod(tu.build_pod(
                "ns", f"pg{g}-p{i}", "", a.PodPhase.PENDING,
                a.build_resource_list(
                    cpu=f"{int(rng.choice([250, 500, 1000]))}m",
                    memory=f"{int(rng.choice([256, 512, 2048]))}Mi",
                    **extra),
                group_name=f"pg{g}"))
    return c


def cluster_selector(pkg, seed=11):
    """Zone labels on the nodes; most gangs select a zone, some none."""
    rng = np.random.RandomState(seed)
    a, tu = pkg.api, pkg.tu
    c = empty_cache(pkg)
    for q in range(3):
        c.add_queue(tu.build_queue(f"q{q}", weight=q + 1))
    zones = ["a", "b", "c"]
    for j in range(36):
        c.add_node(tu.build_node(
            f"n{j}", a.build_resource_list(cpu="16", memory="64Gi",
                                           pods=110),
            labels={"zone": zones[j % 3], "rack": f"r{j // 6}"}))
    for g in range(15):
        sel = None if g % 5 == 4 else {"zone": zones[g % 3]}
        if g % 7 == 6:
            sel = {"zone": "a", "rack": "r0"}
        c.add_pod_group(tu.build_pod_group(
            f"pg{g}", namespace="ns", min_member=1, queue=f"q{g % 3}"))
        for i in range(int(rng.randint(4, 16))):
            c.add_pod(tu.build_pod(
                "ns", f"pg{g}-p{i}", "", a.PodPhase.PENDING,
                a.build_resource_list(
                    cpu=f"{int(rng.choice([250, 500, 1000]))}m",
                    memory=f"{int(rng.choice([256, 512]))}Mi"),
                group_name=f"pg{g}", selector=sel))
    return c


def cluster_running(pkg, seed=13):
    """Running pods already bound (used capacity), some of them
    terminating (releasing capacity), beside pending gangs."""
    rng = np.random.RandomState(seed)
    a, tu = pkg.api, pkg.tu
    c = empty_cache(pkg)
    for q in range(2):
        c.add_queue(tu.build_queue(f"q{q}", weight=q + 1))
    for j in range(24):
        c.add_node(tu.build_node(f"n{j}", a.build_resource_list(
            cpu="8", memory="32Gi", pods=110)))
    for g in range(6):
        c.add_pod_group(tu.build_pod_group(
            f"run{g}", namespace="ns", min_member=1, queue=f"q{g % 2}"))
        for i in range(10):
            pod = tu.build_pod(
                "ns", f"run{g}-p{i}", f"n{(g * 10 + i) % 24}",
                a.PodPhase.RUNNING,
                a.build_resource_list(
                    cpu=f"{int(rng.choice([500, 1000, 2000]))}m",
                    memory=f"{int(rng.choice([512, 1024]))}Mi"),
                group_name=f"run{g}")
            if i % 4 == 3:
                pod.metadata.deletion_timestamp = 1000.0 + g * 10 + i
            c.add_pod(pod)
    for g in range(8):
        c.add_pod_group(tu.build_pod_group(
            f"pg{g}", namespace="ns", min_member=2, queue=f"q{g % 2}"))
        for i in range(12):
            c.add_pod(tu.build_pod(
                "ns", f"pg{g}-p{i}", "", a.PodPhase.PENDING,
                a.build_resource_list(
                    cpu=f"{int(rng.choice([250, 500, 1000]))}m",
                    memory=f"{int(rng.choice([256, 512]))}Mi"),
                group_name=f"pg{g}"))
    return c


CASES = {
    "bench600x48": (cluster_bench, {}),
    "topk2000x300": (
        lambda pkg: cluster_bench(pkg, 2000, 300, 4, 40, seed=5),
        {"KBT_SOLVER_TOPK": "16"},
    ),
    # Past 2x the pool's chunk floors (1,024 nodes, 512 jobs), so the
    # node fill and the job scalar scan split across four workers.
    "workers4-3300x2100": (
        lambda pkg: cluster_bench(pkg, 3300, 2100, 3, 1100, seed=9),
        {"KBT_TENSORIZE_WORKERS": "4"},
    ),
    "scalar-gpu": (cluster_gpu, {}),
    "node-selector": (cluster_selector, {}),
    "running-terminating": (cluster_running, {}),
}


# ---------------------------------------------------------------- compare

def host_snapshot(pkg, cache):
    """``(host_inputs, ctx, last_tensorize_stats)`` of one session."""
    ssn = pkg.open_session(cache, tiers(pkg))
    try:
        host, ctx = pkg.snapshot.tensorize(ssn, device=False)
        stats = dict(pkg.snapshot.last_tensorize_stats)
    finally:
        pkg.close_session(ssn)
    return host, ctx, stats


def assert_bundles_equal(want, got, where=""):
    assert want is not None and got is not None, where
    assert type(got).__name__ == "SolverInputs"
    for f in want._fields:
        a, b = getattr(want, f), getattr(got, f)
        if a is None or b is None:
            assert a is None and b is None, (where, f)
            continue
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype, (where, f, a.dtype, b.dtype)
        assert a.shape == b.shape, (where, f, a.shape, b.shape)
        assert a.tobytes() == b.tobytes(), (where, f)


def assert_ctx_order_equal(want, got, where=""):
    assert [t.uid for t in want.tasks] == [t.uid for t in got.tasks], where
    assert [n.name for n in want.nodes] == [n.name for n in got.nodes], where
    assert [q.name for q in want.queues] == [q.name for q in got.queues], \
        where


# ------------------------------------------------------------------ tests

@pytest.mark.parametrize("case", sorted(CASES))
def test_tensorize_bundle_equals_reference(case):
    build, envs = CASES[case]
    with env(**envs):
        caches = [build(jax_pkg()), build(PORT)]
        (hj, cj, sj), (hp, cp, sp) = [
            host_snapshot(pkg, c) for pkg, c in zip((jax_pkg(), PORT), caches)
        ]
    assert_bundles_equal(hj, hp, case)
    assert_ctx_order_equal(cj, cp, case)
    assert sj == sp
    if case == "topk2000x300":
        assert hp.cand_idx.shape[0] > 0 and sp["sparse"]["enabled"]
    if case == "scalar-gpu":
        assert cp.layout.scalars == ["nvidia.com/gpu"]
    if case == "node-selector":
        assert hp.group_feas.shape[0] > 1
    if case == "running-terminating":
        assert hp.node_releasing.any() and hp.node_task_count.any()
    for c in caches:
        c.shutdown()


class Churn:
    """One package's side of the churn replay: a cluster plus the event
    log applied to it, replayable onto a fresh cache."""

    def __init__(self, pkg, build):
        self.pkg, self.build = pkg, build
        self.cache = build(pkg)
        self.log = []

    def apply(self, cache, event):
        pkg = self.pkg
        a, tu = pkg.api, pkg.tu
        kind = event[0]
        if kind == "add":
            _, group, queue, reqs = event
            cache.add_pod_group(tu.build_pod_group(
                group, namespace="churn", min_member=1, queue=queue))
            for i, (cpu, mem) in enumerate(reqs):
                cache.add_pod(tu.build_pod(
                    "churn", f"{group}-p{i}", "", a.PodPhase.PENDING,
                    a.build_resource_list(cpu=f"{cpu}m", memory=f"{mem}Mi"),
                    group_name=group))
        elif kind == "delete":
            for job_uid, uid in event[1]:
                cache.delete_pod(cache.jobs[job_uid].tasks[uid].pod)
        elif kind == "node":
            _, name, cpu = event
            old = cache.nodes[name].node
            cache.update_node(old, tu.build_node(
                name, a.build_resource_list(cpu=cpu, memory="128Gi",
                                            pods=110)))
        elif kind == "bind":
            for job_uid, uid, host in event[1]:
                cache.bind(cache.jobs[job_uid].tasks[uid], host)
            assert cache.wait_for_side_effects()
            assert cache.wait_for_bookkeeping()

    def step(self, event):
        self.log.append(event)
        self.apply(self.cache, event)

    def fresh(self):
        cache = self.build(self.pkg)
        for event in self.log:
            self.apply(cache, event)
        return cache


def churn_events(cycle, rng, ctx, nodes):
    """The events of one churn cycle, from the previous cycle's context
    (shared by both packages, so identical in both)."""
    pending = [t for t in ctx.tasks]
    delete = [(t.job, t.uid) for t in pending[3 * cycle:3 * cycle + 2]]
    bind = [
        (t.job, t.uid, nodes[(7 * cycle + i) % len(nodes)])
        for i, t in enumerate(pending[-4 * (cycle + 1):][:4])
    ]
    reqs = [(int(rng.choice([250, 500])), int(rng.choice([256, 512])))
            for _ in range(int(rng.randint(2, 6)))]
    return [
        ("add", f"c{cycle}", f"q{cycle % 2}", reqs),
        ("delete", delete),
        ("node", nodes[(5 * cycle + 1) % len(nodes)], str(32 - cycle)),
        ("bind", bind),
    ]


CHURN_CASES = {
    "bench": (lambda pkg: cluster_bench(pkg, 1200, 64, 2, 24, seed=19),
              "off"),
    "bench-topk16": (
        lambda pkg: cluster_bench(pkg, 1200, 64, 2, 24, seed=19), "16"),
    "node-selector": (cluster_selector, "off"),
    "running-terminating": (cluster_running, "off"),
}


@pytest.mark.parametrize("case", sorted(CHURN_CASES))
def test_churn_cycles_equal_reference_and_cold(case):
    """Five cycles of add / delete / node update / cache.bind replayed
    into both caches: each cycle's incremental bundle equals the JAX
    package's and a cold tensorize on a freshly built cache, and the
    incremental-path stats equal the reference's."""
    build, topk = CHURN_CASES[case]
    rng = np.random.RandomState(23)
    with env(KBT_SOLVER_TOPK=topk):
        sides = [Churn(jax_pkg(), build), Churn(PORT, build)]
        hj, cj, _ = host_snapshot(jax_pkg(), sides[0].cache)
        hp, cp, _ = host_snapshot(PORT, sides[1].cache)
        assert_bundles_equal(hj, hp, "cycle 0")
        saw_incremental = saw_sel_hits = False
        for cycle in range(1, 6):
            nodes = sorted(sides[1].cache.nodes)
            events = churn_events(cycle, rng, cp, nodes)
            for side in sides:
                for e in events:
                    side.step(e)
            hj, cj, sj = host_snapshot(jax_pkg(), sides[0].cache)
            hp, cp, sp = host_snapshot(PORT, sides[1].cache)
            where = f"cycle {cycle}"
            assert_bundles_equal(hj, hp, where)
            assert_ctx_order_equal(cj, cp, where)
            assert sj == sp, where
            fresh = sides[1].fresh()
            hc, cc, _ = host_snapshot(PORT, fresh)
            fresh.shutdown()
            assert_bundles_equal(hc, hp, where + " (cold)")
            assert_ctx_order_equal(cc, cp, where + " (cold)")
            saw_incremental |= sp.get("incremental", False)
            saw_sel_hits |= sp["sparse"].get("sel_cache_hits", 0) > 0
        assert saw_incremental
        if topk != "off":
            assert saw_sel_hits
    for side in sides:
        side.cache.shutdown()


def _selection_inputs(rng, T=300, N=200, R=2):
    """A host selection problem in tensorize's shapes (unpadded)."""
    group_rows = rng.rand(3, N) > 0.2
    score_rows_map = {int(i): rng.rand(N).astype(np.float32) * 3
                      for i in rng.choice(T, 3, replace=False)}
    pair_idx = np.sort(rng.choice(T, 4, replace=False)).astype(np.int32)
    req = rng.choice([250.0, 500.0, 1000.0], size=(T, R)).astype(np.float32)
    cap = np.full((N, R), 16000.0, np.float32)
    idle = (cap - rng.choice([0.0, 4000.0, 8000.0], size=(N, R))).astype(
        np.float32)
    return dict(
        task_group=rng.randint(0, 3, T).astype(np.int32),
        group_rows=group_rows, node_ok=rng.rand(N) > 0.05,
        pair_idx=pair_idx, pair_rows=rng.rand(len(pair_idx), N) > 0.3,
        score_rows_map=score_rows_map, task_req=req, task_fit=req.copy(),
        node_idle=idle, node_cap=cap,
        node_releasing=np.zeros((N, R), np.float32),
        node_task_count=rng.randint(0, 5, N).astype(np.int32),
        node_max_tasks=np.full(N, 110, np.int32),
        eps=np.full(R, 10.0, np.float32),
    )


def _select(pkg, p, holder, node_fp, k=16):
    from kube_batch_tpu_torch.solver.masks import CombinedMask

    mask = CombinedMask(p["node_ok"], p["task_group"], p["group_rows"],
                        p["pair_idx"], p["pair_rows"])
    return pkg.topk.select_candidates(
        mask, p["score_rows_map"], p["task_req"], p["task_fit"],
        p["node_idle"], p["node_cap"], p["node_releasing"],
        p["node_task_count"], p["node_max_tasks"], p["eps"],
        1.0, 1.0, k, cache_holder=holder, node_fp=node_fp,
    )


def test_selection_cache_slabs_and_hits_equal_reference():
    """Across cycles whose node columns change, the cached selection
    equals a fresh one, and its cache-hit stats equal the reference's
    on the same sequence."""
    rng = np.random.RandomState(31)
    p = _selection_inputs(rng)
    N = p["node_idle"].shape[0]
    holders = {"jax": SimpleNamespace(), "torch": SimpleNamespace()}
    pins = [object() for _ in range(N)]
    ids = np.fromiter(map(id, pins), np.int64, count=N)
    vers = np.zeros(N, np.int64)
    hits = []
    for cycle in range(4):
        if cycle:
            moved = rng.choice(N, 7, replace=False)
            p["node_idle"][moved] -= 250.0
            p["node_task_count"][moved] += 1
            vers = vers.copy()
            vers[moved] += 1
        fp = (ids, vers, pins)
        want = _select(jax_pkg(), p, holders["jax"], fp)
        cached = _select(PORT, p, holders["torch"], fp)
        fresh = _select(PORT, p, None, None)
        for f in ("task_cand", "cand_idx", "cand_static", "cand_info"):
            assert np.array_equal(getattr(cached, f), getattr(fresh, f)), f
            assert np.array_equal(getattr(cached, f), getattr(want, f)), f
        assert cached.stats["sel_cache_hits"] == want.stats["sel_cache_hits"]
        hits.append(cached.stats["sel_cache_hits"])
    assert hits[0] == 0 and min(hits[1:]) > 0
