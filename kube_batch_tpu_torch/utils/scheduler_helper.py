"""Per-task node filter/score helpers used by the greedy actions.

Mirrors reference pkg/scheduler/util/scheduler_helper.go (:63 PredicateNodes,
:89 PrioritizeNodes weighted sum, :174 SortNodes, :188 SelectBestNode random
among max). The reference parallelizes with 16 goroutines; the greedy Python
path is the measured baseline only — the production path is the batched TPU
solve in ops/, which replaces this entire per-task machinery.
"""

from __future__ import annotations

import random
from typing import Callable, Dict, List, Sequence, Tuple

from ..api import NodeInfo, TaskInfo

# (node_name, score) pairs, higher is better.
HostPriorityList = List[Tuple[str, float]]


def predicate_nodes(
    task: TaskInfo, nodes: Sequence[NodeInfo], fn: Callable
) -> List[NodeInfo]:
    """Nodes passing the predicate; fn raises on failure
    (scheduler_helper.go:63-86)."""
    out: List[NodeInfo] = []
    for node in nodes:
        try:
            fn(task, node)
        except Exception:
            continue
        out.append(node)
    return out


def prioritize_nodes(
    task: TaskInfo,
    nodes: Sequence[NodeInfo],
    prioritizers: Sequence[Tuple[Callable, float]],
) -> HostPriorityList:
    """Weighted score sum per node (scheduler_helper.go:89-171)."""
    result: HostPriorityList = []
    for node in nodes:
        score = 0.0
        for fn, weight in prioritizers:
            score += weight * fn(task, node)
        result.append((node.name, score))
    return result


def sort_nodes(
    priority_list: HostPriorityList, nodes_info: Dict[str, NodeInfo]
) -> List[NodeInfo]:
    """Nodes in descending score order (scheduler_helper.go:174-185)."""
    ordered = sorted(priority_list, key=lambda hp: hp[1], reverse=True)
    return [nodes_info[name] for name, _ in ordered]


# Module-scoped RNG so tests can pin tie-breaking without mutating the
# process-wide stdlib random state.
_rng = random.Random()


def select_best_node(priority_list: HostPriorityList) -> str:
    """Highest score, random among ties (scheduler_helper.go:188-208)."""
    if not priority_list:
        raise ValueError("empty priority list")
    max_score = max(s for _, s in priority_list)
    best = [name for name, s in priority_list if s == max_score]
    return _rng.choice(best)


def get_node_list(nodes: Dict[str, NodeInfo]) -> List[NodeInfo]:
    """Stable order for determinism (reference returns map order,
    scheduler_helper.go:211-216)."""
    return [nodes[name] for name in sorted(nodes)]


class FeasibilityMemo:
    """Cycle-scoped, spec-keyed cache of predicate-feasible node lists.

    Actions that scan all nodes per pending task (reclaim claimants and
    their gang sims, extended backfill) pay O(tasks x nodes) predicate
    calls per cycle; at 1k nodes x 16k claimants that WAS reclaim
    throughput in the reference's multi-tenant profile. Tasks with equal constraint specs
    provably share a verdict for the SPEC-driven predicates, so they
    share one pass.

    Soundness limits, all handled here:

    - tasks with host ports or inter-pod (anti-)affinity are never
      cached (their verdict depends on what else is on the node, which
      changes mid-cycle);
    - the pod-count predicate (check_max_task_num) is dynamic for
      EVERYONE — pipelines add node tasks mid-cycle — so cached lists
      are re-filtered against the CURRENT count at every use. A node the
      build-time pass excluded that later gains headroom stays excluded
      (conservative: self-corrects next cycle); a node that filled up is
      dropped at use time (never over-placed).
    """

    def __init__(self, ssn):
        self.ssn = ssn
        self._entries: List[tuple] = []  # (spec, nodes)

    @staticmethod
    def _cacheable(spec) -> bool:
        if any(c.ports for c in spec.containers):
            return False
        aff = spec.affinity
        return aff is None or not (aff.pod_affinity or aff.pod_anti_affinity)

    @staticmethod
    def _has_headroom(node: NodeInfo) -> bool:
        cap = node.allocatable.max_task_num
        return not (0 < cap <= len(node.tasks))

    def feasible(self, task) -> List[NodeInfo]:
        spec = task.pod.spec
        if self._cacheable(spec):
            for seen_spec, nodes in self._entries:
                if (
                    spec.node_selector == seen_spec.node_selector
                    and spec.affinity == seen_spec.affinity
                    and spec.tolerations == seen_spec.tolerations
                ):
                    return [n for n in nodes if self._has_headroom(n)]
        nodes = []
        for node in get_node_list(self.ssn.nodes):
            try:
                self.ssn.predicate_fn(task, node)
            except Exception:
                continue
            nodes.append(node)
        if self._cacheable(spec):
            self._entries.append((spec, nodes))
        return nodes
