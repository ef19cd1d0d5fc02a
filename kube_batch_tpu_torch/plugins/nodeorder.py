"""Nodeorder plugin: node scoring.

Mirrors reference plugins/nodeorder/nodeorder.go (:129-171), which installs
k8s prioritizers LeastRequested, BalancedResourceAllocation, NodeAffinity and
InterPodAffinity with weights from plugin arguments
{nodeaffinity,podaffinity,leastrequested,balancedresource}.weight
(:86-126). Scorers are implemented natively with the standard k8s formulas
(0..10 per scorer, weighted sum).

Reference bug NOT replicated: nodeorder.go:160,:166 passes
balancedRescourceWeight for NodeAffinity and InterPodAffinity; here each
scorer uses its own weight.
"""

from __future__ import annotations

from ..api import NodeInfo, TaskInfo
from ..framework import Plugin, register_plugin_builder
from .util import (
    match_affinity_term,
    match_node_selector_terms,
)

MAX_PRIORITY = 10.0

# Argument keys (reference nodeorder.go:75-84).
NODE_AFFINITY_WEIGHT = "nodeaffinity.weight"
POD_AFFINITY_WEIGHT = "podaffinity.weight"
LEAST_REQUESTED_WEIGHT = "leastrequested.weight"
BALANCED_RESOURCE_WEIGHT = "balancedresource.weight"


def least_requested_score(task: TaskInfo, node: NodeInfo) -> float:
    """k8s least_requested_priority: mean over cpu/mem of
    (capacity - requested) * 10 / capacity."""
    cpu_cap = node.allocatable.milli_cpu
    mem_cap = node.allocatable.memory
    cpu_req = node.used.milli_cpu + task.resreq.milli_cpu
    mem_req = node.used.memory + task.resreq.memory
    cpu_score = (
        max(0.0, (cpu_cap - cpu_req)) * MAX_PRIORITY / cpu_cap if cpu_cap > 0 else 0.0
    )
    mem_score = (
        max(0.0, (mem_cap - mem_req)) * MAX_PRIORITY / mem_cap if mem_cap > 0 else 0.0
    )
    return (cpu_score + mem_score) / 2.0


def balanced_resource_score(task: TaskInfo, node: NodeInfo) -> float:
    """k8s balanced_resource_allocation: 10 - |cpuFraction - memFraction|*10."""
    cpu_cap = node.allocatable.milli_cpu
    mem_cap = node.allocatable.memory
    cpu_frac = (
        (node.used.milli_cpu + task.resreq.milli_cpu) / cpu_cap if cpu_cap > 0 else 1.0
    )
    mem_frac = (node.used.memory + task.resreq.memory) / mem_cap if mem_cap > 0 else 1.0
    if cpu_frac >= 1.0 or mem_frac >= 1.0:
        return 0.0
    return MAX_PRIORITY - abs(cpu_frac - mem_frac) * MAX_PRIORITY


def node_affinity_score(task: TaskInfo, node: NodeInfo) -> float:
    """k8s CalculateNodeAffinityPriority: sum of matching preferred-term
    weights, normalized later by the caller across nodes; here normalized to
    0..10 by total preferred weight."""
    affinity = task.pod.spec.affinity
    if affinity is None or not affinity.node_preferred:
        return 0.0
    labels = node.node.metadata.labels if node.node else {}
    total = sum(t.get("weight", 1) for t in affinity.node_preferred)
    if total <= 0:
        return 0.0
    score = 0.0
    for term in affinity.node_preferred:
        if match_node_selector_terms(term.get("expressions"), labels):
            score += term.get("weight", 1)
    return score * MAX_PRIORITY / total


def make_inter_pod_affinity_score(ssn):
    """Preferred pod-affinity: +1 per matching session pod already on the
    node (normalized to 0..10 by count of terms)."""

    def inter_pod_affinity_score(task: TaskInfo, node: NodeInfo) -> float:
        affinity = task.pod.spec.affinity
        if affinity is None or not affinity.pod_affinity:
            return 0.0
        from .util import SessionPodLister

        on_node = SessionPodLister(ssn).pods_on_node(node.name)
        if not on_node:
            return 0.0
        matched = 0
        for term in affinity.pod_affinity:
            if any(
                match_affinity_term(term, t.pod.metadata.labels)
                for t in on_node
            ):
                matched += 1
        return matched * MAX_PRIORITY / len(affinity.pod_affinity)

    return inter_pod_affinity_score


class NodeOrderPlugin(Plugin):
    def __init__(self, arguments=None):
        self.arguments = arguments or {}

    def name(self) -> str:
        return "nodeorder"

    def _weight(self, key: str, default: int = 1) -> float:
        get_int = getattr(self.arguments, "get_int", None)
        if get_int is None:
            return float(default)
        return float(get_int(key, default))

    def on_session_open(self, ssn) -> None:
        ssn.add_node_order_fn(
            self.name(), least_requested_score, self._weight(LEAST_REQUESTED_WEIGHT)
        )
        ssn.add_node_order_fn(
            self.name(),
            balanced_resource_score,
            self._weight(BALANCED_RESOURCE_WEIGHT),
        )
        ssn.add_node_order_fn(
            self.name(), node_affinity_score, self._weight(NODE_AFFINITY_WEIGHT)
        )
        ssn.add_node_order_fn(
            self.name(),
            make_inter_pod_affinity_score(ssn),
            self._weight(POD_AFFINITY_WEIGHT),
        )

        # TPU solver path: LeastRequested/Balanced depend on the evolving
        # idle vectors, so the kernel recomputes them in-round from these
        # weights (keyed by plugin name so tier enablement can gate them);
        # the affinity scorers are static per session and are delivered as
        # a batched [T, N] matrix.
        ssn.solver_score_weights[self.name()] = {
            "leastrequested": self._weight(LEAST_REQUESTED_WEIGHT),
            "balancedresource": self._weight(BALANCED_RESOURCE_WEIGHT),
        }

        import numpy as np

        inter_pod = make_inter_pod_affinity_score(ssn)
        na_weight = self._weight(NODE_AFFINITY_WEIGHT)
        pa_weight = self._weight(POD_AFFINITY_WEIGHT)

        def batch_affinity_scores(tasks, nodes):
            """Sparse per-task score rows: only tasks carrying preferred
            node affinity or pod affinity contribute (solver/masks.py
            combine_score_rows folds the dict into the device inputs)."""
            N = len(nodes)
            rows = {}
            for i, task in enumerate(tasks):
                aff = task.pod.spec.affinity
                if aff is None or not (aff.node_preferred or aff.pod_affinity):
                    continue
                row = np.empty(N, dtype=np.float32)
                for j, node in enumerate(nodes):
                    row[j] = (
                        node_affinity_score(task, node) * na_weight
                        + inter_pod(task, node) * pa_weight
                    )
                rows[i] = row
            return rows

        ssn.add_batch_node_order_fn(self.name(), batch_affinity_scores)


register_plugin_builder("nodeorder", lambda args: NodeOrderPlugin(args))
