"""Serving workload classes, SLO specs, and node-class descriptors.

Every pod used to be a batch gang member; this module adds the second
workload class — **serving** — per "Scalable Joint Resource Allocation
for SLO-Constrained LLM Inference in Heterogeneous GPU Clouds"
(PAPERS.md): jobs carry a placement-latency SLO plus node-class
constraints (TPU generation, slice/ICI topology tier, spot-vs-reserved)
that the serving plugin compiles into extra feasibility-mask rows and
cost terms, exactly as gang minMember is compiled today.

Wire format: pod annotations (the PodGroup analog of the group-name
annotation) and node labels. Both sides parse here so the cache event
handlers, the JobInfo model, and the sim harness share one schema:

- pods: ``tpu-batch/workload-class`` = ``serving`` opts a job in;
  ``tpu-batch/slo-seconds`` (placement-latency target, float seconds),
  ``tpu-batch/replica-floor`` (members preempt/reclaim may never go
  below once reached), ``tpu-batch/tpu-generations`` (comma list of
  acceptable generations; empty = any), ``tpu-batch/min-topology-tier``
  (minimum ICI locality tier), ``tpu-batch/reserved-only`` ("1" =
  spot-excluded).
- nodes: ``tpu-batch/tpu-generation``, ``tpu-batch/topology-tier``,
  ``tpu-batch/capacity-type`` (``reserved`` | ``spot``).

Parsing is total: malformed values degrade to the unconstrained
default rather than raising — an annotation typo must not wedge the
watch ingest path.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, FrozenSet, Optional

# -- workload classes ---------------------------------------------------------

WORKLOAD_CLASS_BATCH = "batch"
WORKLOAD_CLASS_SERVING = "serving"

# Pod annotation keys (next to GROUP_NAME_ANNOTATION_KEY in spirit).
WORKLOAD_CLASS_ANNOTATION_KEY = "tpu-batch/workload-class"
SLO_SECONDS_ANNOTATION_KEY = "tpu-batch/slo-seconds"
REPLICA_FLOOR_ANNOTATION_KEY = "tpu-batch/replica-floor"
TPU_GENERATIONS_ANNOTATION_KEY = "tpu-batch/tpu-generations"
MIN_TOPOLOGY_TIER_ANNOTATION_KEY = "tpu-batch/min-topology-tier"
RESERVED_ONLY_ANNOTATION_KEY = "tpu-batch/reserved-only"

# Node label keys.
TPU_GENERATION_LABEL_KEY = "tpu-batch/tpu-generation"
TOPOLOGY_TIER_LABEL_KEY = "tpu-batch/topology-tier"
CAPACITY_TYPE_LABEL_KEY = "tpu-batch/capacity-type"

CAPACITY_RESERVED = "reserved"
CAPACITY_SPOT = "spot"


@dataclass(frozen=True)
class ServingSLO:
    """Per-job serving SLO spec (immutable; clones share it)."""

    # Placement-latency target in seconds (arrival → bind-applied on
    # the ledger's clock); None = class membership without a latency
    # target (floor/constraints still apply).
    target_seconds: Optional[float] = None
    # Once ready_task_num() reached this floor, preempt/reclaim may
    # never take the job below it (0 = no floor).
    replica_floor: int = 0
    # Acceptable TPU generations (empty = any).
    generations: FrozenSet[str] = frozenset()
    # Minimum ICI/slice topology tier (0 = any).
    min_topology_tier: int = 0
    # True = spot capacity is infeasible for this job.
    reserved_only: bool = False

    def constrains_nodes(self) -> bool:
        """Whether this spec excludes any node class at all (drives
        whether the serving plugin emits a mask row)."""
        return bool(
            self.generations or self.min_topology_tier > 0
            or self.reserved_only
        )


@dataclass(frozen=True)
class NodeClass:
    """Per-node class descriptor derived from labels (immutable;
    NodeInfo clones share it)."""

    generation: str = ""
    topology_tier: int = 0
    capacity: str = CAPACITY_RESERVED

    @property
    def spot(self) -> bool:
        return self.capacity == CAPACITY_SPOT


DEFAULT_NODE_CLASS = NodeClass()


def _to_float(raw: Optional[str]) -> Optional[float]:
    try:
        return float(raw) if raw else None
    except (TypeError, ValueError):
        return None


def _to_int(raw: Optional[str], default: int = 0) -> int:
    try:
        return int(raw) if raw else default
    except (TypeError, ValueError):
        return default


def parse_workload_class(annotations: Dict[str, str]) -> str:
    """Annotation → workload class; anything but ``serving`` is batch."""
    cls = (annotations or {}).get(WORKLOAD_CLASS_ANNOTATION_KEY, "")
    return (
        WORKLOAD_CLASS_SERVING if cls == WORKLOAD_CLASS_SERVING
        else WORKLOAD_CLASS_BATCH
    )


def parse_serving_slo(annotations: Dict[str, str]) -> Optional[ServingSLO]:
    """Pod annotations → ServingSLO; None for batch pods."""
    if parse_workload_class(annotations) != WORKLOAD_CLASS_SERVING:
        return None
    gens = frozenset(
        g.strip()
        for g in annotations.get(TPU_GENERATIONS_ANNOTATION_KEY, "").split(",")
        if g.strip()
    )
    return ServingSLO(
        target_seconds=_to_float(
            annotations.get(SLO_SECONDS_ANNOTATION_KEY)
        ),
        replica_floor=max(
            0, _to_int(annotations.get(REPLICA_FLOOR_ANNOTATION_KEY))
        ),
        generations=gens,
        min_topology_tier=max(
            0, _to_int(annotations.get(MIN_TOPOLOGY_TIER_ANNOTATION_KEY))
        ),
        reserved_only=(
            annotations.get(RESERVED_ONLY_ANNOTATION_KEY, "") == "1"
        ),
    )


def node_class_from_labels(labels: Dict[str, str]) -> NodeClass:
    """Node labels → NodeClass. Unlabeled nodes are the default class
    (reserved, tier 0, no generation) so batch-only clusters see no
    behavior change."""
    labels = labels or {}
    generation = labels.get(TPU_GENERATION_LABEL_KEY, "")
    tier = max(0, _to_int(labels.get(TOPOLOGY_TIER_LABEL_KEY)))
    capacity = (
        CAPACITY_SPOT
        if labels.get(CAPACITY_TYPE_LABEL_KEY, "") == CAPACITY_SPOT
        else CAPACITY_RESERVED
    )
    if not generation and tier == 0 and capacity == CAPACITY_RESERVED:
        return DEFAULT_NODE_CLASS
    return NodeClass(
        generation=generation, topology_tier=tier, capacity=capacity
    )


def slo_permits_node(slo: ServingSLO, node_class: NodeClass) -> bool:
    """The feasibility verdict the serving plugin compiles into mask
    rows: generation whitelist, minimum topology tier, spot exclusion."""
    if slo.generations and node_class.generation not in slo.generations:
        return False
    if node_class.topology_tier < slo.min_topology_tier:
        return False
    if slo.reserved_only and node_class.spot:
        return False
    return True
