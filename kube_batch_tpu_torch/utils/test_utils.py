"""Builders + fake side-effect seams for cluster-less tests.

Mirrors reference pkg/scheduler/util/test_utils.go:
- BuildNode/BuildPod/BuildResourceList builders (:33-91).
- FakeBinder/FakeEvictor record calls into maps + channels (:95-133);
  FakeStatusUpdater/FakeVolumeBinder no-op (:136-163).
Used by both the test suite and the synthetic benchmark generators.

``bench_objects`` is a copy of the reference's ``bench.py`` generator
(the same RNG draws in the same order, so one seed gives the same
cluster in both packages), filled into a cache by ``build_cluster`` and
into an in-process cluster by ``build_in_process_cluster``; ``make_tiers`` builds plugin tiers as the
reference's tests do, and ``DEFAULT_TIERS_ARGS`` names the default
tiers (``bench.py``'s ``TIERS_ARGS``).
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, List, Optional

from ..api import (
    GROUP_NAME_ANNOTATION_KEY,
    Container,
    Node,
    NodeSpec,
    NodeStatus,
    ObjectMeta,
    Pod,
    PodGroup,
    PodGroupSpec,
    PodSpec,
    PodStatus,
    Queue,
    QueueSpec,
    ResourceList,
)


def build_node(
    name: str,
    alloc: ResourceList,
    labels: Optional[Dict[str, str]] = None,
    capacity: Optional[ResourceList] = None,
) -> Node:
    """reference test_utils.go:33-46"""
    return Node(
        metadata=ObjectMeta(name=name, labels=dict(labels or {})),
        spec=NodeSpec(),
        status=NodeStatus(allocatable=dict(alloc), capacity=dict(capacity or alloc)),
    )


def build_pod(
    namespace: str,
    name: str,
    node_name: str,
    phase: str,
    req: ResourceList,
    group_name: str = "",
    labels: Optional[Dict[str, str]] = None,
    selector: Optional[Dict[str, str]] = None,
    priority: Optional[int] = None,
    owner_uid: str = "",
) -> Pod:
    """reference test_utils.go:49-81"""
    annotations = {}
    if group_name:
        annotations[GROUP_NAME_ANNOTATION_KEY] = group_name
    return Pod(
        metadata=ObjectMeta(
            name=name,
            namespace=namespace,
            uid=f"{namespace}-{name}",
            labels=dict(labels or {}),
            annotations=annotations,
            owner_uid=owner_uid,
        ),
        spec=PodSpec(
            node_name=node_name,
            node_selector=dict(selector or {}),
            containers=[Container(requests=dict(req))],
            priority=priority,
        ),
        status=PodStatus(phase=phase),
    )


def build_pod_group(
    name: str,
    namespace: str = "default",
    min_member: int = 1,
    queue: str = "default",
    priority_class_name: str = "",
) -> PodGroup:
    return PodGroup(
        metadata=ObjectMeta(name=name, namespace=namespace),
        spec=PodGroupSpec(
            min_member=min_member,
            queue=queue,
            priority_class_name=priority_class_name,
        ),
    )


def build_queue(name: str, weight: int = 1, capability=None) -> Queue:
    return Queue(
        metadata=ObjectMeta(name=name, namespace=""),
        spec=QueueSpec(weight=weight, capability=capability),
    )


class FakeBinder:
    """Records binds (reference test_utils.go:95-114)."""

    def __init__(self):
        self.binds: Dict[str, str] = {}
        self.channel: "queue.Queue[str]" = queue.Queue()
        self._lock = threading.Lock()

    def bind(self, pod: Pod, hostname: str) -> None:
        with self._lock:
            key = f"{pod.namespace}/{pod.name}"
            self.binds[key] = hostname
            self.channel.put(key)


class FakeEvictor:
    """Records evictions (reference test_utils.go:117-133)."""

    def __init__(self):
        self.evicts: List[str] = []
        self.channel: "queue.Queue[str]" = queue.Queue()
        self._lock = threading.Lock()

    def evict(self, pod: Pod) -> None:
        with self._lock:
            key = f"{pod.namespace}/{pod.name}"
            self.evicts.append(key)
            self.channel.put(key)


class FakeStatusUpdater:
    """No-op (reference test_utils.go:136-147)."""

    def update_pod_condition(self, pod: Pod, condition) -> None:
        return None

    def update_pod_group(self, pg: PodGroup) -> None:
        return None


class FakeVolumeBinder:
    """No-op (reference test_utils.go:150-163). Marks volumes ready like
    DefaultVolumeBinder's no-cluster behavior, so fakes exercise the same
    fast bind path production takes for claims-less pods."""

    def allocate_volumes(self, task, hostname: str) -> None:
        task.volume_ready = True

    def bind_volumes(self, task) -> None:
        return None

    def release_volumes(self, task) -> None:
        return None


# The default plugin tiers (the reference's ``bench.py`` TIERS_ARGS).
DEFAULT_TIERS_ARGS = (
    ["priority", "gang", "conformance"],
    ["drf", "predicates", "proportion", "nodeorder"],
)


def make_tiers(*names_per_tier):
    """``Tier`` list with each named plugin at its configuration
    defaults (``make_tiers(*DEFAULT_TIERS_ARGS)`` for the default)."""
    from ..conf import PluginOption, Tier, apply_plugin_conf_defaults

    tiers = []
    for names in names_per_tier:
        opts = []
        for name in names:
            opt = PluginOption(name=name)
            apply_plugin_conf_defaults(opt)
            opts.append(opt)
        tiers.append(Tier(plugins=opts))
    return tiers


def bench_objects(n_tasks, n_nodes, n_queues, n_groups, seed=0):
    """The synthetic benchmark cluster as ``(kind, object)`` pairs, in
    creation order: ``n_nodes`` nodes of 32 CPU / 128 Gi / 110 pods,
    ``n_queues`` weighted queues and ``n_groups`` gangs of ``n_tasks //
    n_groups`` pending pods with seeded CPU and memory requests."""
    import numpy as np

    from ..api import PodPhase, build_resource_list

    rng = np.random.RandomState(seed)
    for q in range(n_queues):
        yield "Queue", build_queue(f"q{q}", weight=q + 1)
    for j in range(n_nodes):
        yield "Node", build_node(
            f"n{j}", build_resource_list(cpu="32", memory="128Gi", pods=110)
        )
    per_group = n_tasks // n_groups
    cpus = rng.choice([250, 500, 1000, 2000, 4000], size=n_tasks)
    mems = rng.choice([256, 512, 1024, 4096, 8192], size=n_tasks)
    t = 0
    for g in range(n_groups):
        queue = f"q{g % n_queues}"
        min_member = int(rng.randint(1, per_group + 1))
        yield "PodGroup", build_pod_group(
            f"pg{g}", namespace="bench", min_member=min_member, queue=queue
        )
        for i in range(per_group):
            yield "Pod", build_pod(
                "bench", f"pg{g}-p{i}", "", PodPhase.PENDING,
                build_resource_list(
                    cpu=f"{int(cpus[t])}m", memory=f"{int(mems[t])}Mi"
                ),
                group_name=f"pg{g}",
            )
            t += 1


def build_cluster(n_tasks, n_nodes, n_queues, n_groups, seed=0):
    """A ``SchedulerCache`` holding :func:`bench_objects`' cluster."""
    from ..cache import SchedulerCache

    cache = SchedulerCache(
        binder=FakeBinder(),
        evictor=FakeEvictor(),
        status_updater=FakeStatusUpdater(),
        volume_binder=FakeVolumeBinder(),
    )
    add = {"Queue": cache.add_queue, "Node": cache.add_node,
           "PodGroup": cache.add_pod_group, "Pod": cache.add_pod}
    for kind, obj in bench_objects(n_tasks, n_nodes, n_queues, n_groups,
                                   seed):
        add[kind](obj)
    return cache


def build_in_process_cluster(n_tasks, n_nodes, n_queues, n_groups, seed=0,
                             simulate_kubelet=True):
    """An ``InProcessCluster`` holding :func:`bench_objects`' cluster,
    for the process entry point (``cli.run(opt, cluster=...)``)."""
    from ..cluster import InProcessCluster

    cluster = InProcessCluster(simulate_kubelet=simulate_kubelet)
    for kind, obj in bench_objects(n_tasks, n_nodes, n_queues, n_groups,
                                   seed):
        cluster.create(kind, obj)
    return cluster


def add_gang_burst(cache, rng, prefix, groups, per_group, n_queues):
    """The delta burst of the reference's ``bench.py::bench_cycle``:
    ``groups`` new gangs of ``per_group`` pending pods each, min-member
    and requests drawn from ``rng`` in the benchmark's order."""
    from ..api import PodPhase, build_resource_list

    for g in range(groups):
        name = f"{prefix}{g}"
        cache.add_pod_group(build_pod_group(
            name, namespace="bench",
            min_member=int(rng.randint(1, per_group + 1)),
            queue=f"q{g % n_queues}",
        ))
        for i in range(per_group):
            cache.add_pod(build_pod(
                "bench", f"{name}-p{i}", "", PodPhase.PENDING,
                build_resource_list(
                    cpu=f"{int(rng.choice([250, 500, 1000, 2000, 4000]))}m",
                    memory=f"{int(rng.choice([256, 512, 1024, 4096, 8192]))}Mi",
                ),
                group_name=name,
            ))

