"""Light-weight cluster object model (the k8s-analog API surface).

The reference schedules Kubernetes objects (v1.Pod, v1.Node, PodGroup/Queue
CRDs — pkg/apis/scheduling/v1alpha1/types.go). tpu-batch is standalone, so it
carries its own minimal object model with the same fields the scheduler reads.
These are plain dataclasses: they are what flows over the control-plane
adapter (cache event handlers) and what user code constructs.

Field parity notes (reference file:line):
- Pod joins a PodGroup via the group-name annotation
  (apis/scheduling/v1alpha1/labels.go:21, read in scheduler/api/job_info.go:56-66).
- PodGroupSpec{MinMember,Queue,PriorityClassName} (v1alpha1/types.go:107-129).
- QueueSpec{Weight,Capability} (v1alpha1/types.go, queue_info.go:63-66).
"""

from __future__ import annotations

import itertools
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from .resource_info import ResourceList

# reference: apis/scheduling/v1alpha1/labels.go:21
GROUP_NAME_ANNOTATION_KEY = "scheduling.k8s.io/group-name"

# CRD API group of PodGroup/Queue (reference register.go; one source of
# truth for both the manifest loader and the real-cluster adapter paths).
SCHEDULING_GROUP = "scheduling.incubator.k8s.io"

# Default scheduler name (reference: cmd/kube-batch/app/options/options.go:62).
DEFAULT_SCHEDULER_NAME = "tpu-batch"

_uid_counter = itertools.count(1)


def generate_uid(prefix: str = "obj") -> str:
    return f"{prefix}-{next(_uid_counter):08d}"


@dataclass
class ObjectMeta:
    """Object metadata (name/namespace/uid/labels/annotations/timestamps)."""

    name: str = ""
    namespace: str = "default"
    uid: str = ""
    labels: Dict[str, str] = field(default_factory=dict)
    annotations: Dict[str, str] = field(default_factory=dict)
    creation_timestamp: float = 0.0
    deletion_timestamp: Optional[float] = None
    owner_uid: Optional[str] = None  # analog of metav1.OwnerReference controller UID
    # Monotone per-cluster write stamp (the k8s resourceVersion analog):
    # assigned by InProcessCluster on every create/update/delete and
    # delivered with each watch event, so the cache's ingest guards can
    # detect duplicate, stale, out-of-order, and MISSING events
    # (doc/design/robustness.md, event-stream hardening). 0 = never
    # written through a versioning cluster.
    resource_version: int = 0

    def __post_init__(self):
        if not self.uid:
            self.uid = generate_uid(self.name or "obj")
        if not self.creation_timestamp:
            self.creation_timestamp = time.time()


@dataclass
class Toleration:
    key: str = ""
    operator: str = "Equal"  # Equal | Exists
    value: str = ""
    effect: str = ""  # "" matches all effects

    def tolerates(self, taint: "Taint") -> bool:
        """k8s toleration semantics (TolerationToleratesTaint)."""
        if self.effect and self.effect != taint.effect:
            return False
        if self.key and self.key != taint.key:
            return False
        if self.operator == "Exists":
            return True
        return self.value == taint.value


@dataclass
class Taint:
    key: str = ""
    value: str = ""
    effect: str = "NoSchedule"  # NoSchedule | PreferNoSchedule | NoExecute


@dataclass
class Container:
    name: str = "main"
    requests: ResourceList = field(default_factory=dict)
    ports: List[int] = field(default_factory=list)  # host ports


@dataclass
class Affinity:
    """Subset of k8s affinity the reference predicates/priorities evaluate."""

    # required node affinity: list of nodeSelectorTerms (OR across terms),
    # each term a list of match-expression dicts (AND within a term). A
    # flat expression list is accepted as shorthand for a single term.
    node_required: Optional[List] = None
    node_preferred: Optional[List[Dict]] = None  # [{"weight": w, "expressions": [...]}]
    # pod (anti-)affinity: required terms over pod labels, topology = node
    #   [{"label_selector": {k: v}, "match_expressions": [...]?}]
    pod_affinity: Optional[List[Dict]] = None
    pod_anti_affinity: Optional[List[Dict]] = None


@dataclass
class PodSpec:
    node_name: str = ""
    node_selector: Dict[str, str] = field(default_factory=dict)
    affinity: Optional[Affinity] = None
    tolerations: List[Toleration] = field(default_factory=list)
    containers: List[Container] = field(default_factory=list)
    init_containers: List[Container] = field(default_factory=list)
    priority: Optional[int] = None
    priority_class_name: str = ""
    scheduler_name: str = DEFAULT_SCHEDULER_NAME
    # PersistentVolumeClaim names this pod mounts (the subset of k8s
    # spec.volumes the scheduler cares about: what must be assumable on
    # the chosen node before bind, reference cache.go:200-268).
    volume_claims: List[str] = field(default_factory=list)


class PodPhase:
    PENDING = "Pending"
    RUNNING = "Running"
    SUCCEEDED = "Succeeded"
    FAILED = "Failed"
    UNKNOWN = "Unknown"


@dataclass
class PodCondition:
    type: str = ""
    status: str = ""
    reason: str = ""
    message: str = ""


@dataclass
class PodStatus:
    phase: str = PodPhase.PENDING
    conditions: List[PodCondition] = field(default_factory=list)


@dataclass
class Pod:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: PodSpec = field(default_factory=PodSpec)
    status: PodStatus = field(default_factory=PodStatus)

    @property
    def name(self) -> str:
        return self.metadata.name

    @property
    def namespace(self) -> str:
        return self.metadata.namespace

    @property
    def uid(self) -> str:
        return self.metadata.uid


@dataclass
class NodeSpec:
    taints: List[Taint] = field(default_factory=list)
    unschedulable: bool = False


@dataclass
class NodeCondition:
    type: str = ""  # Ready | OutOfDisk | MemoryPressure | DiskPressure | PIDPressure
    status: str = ""  # True | False | Unknown


@dataclass
class NodeStatus:
    allocatable: ResourceList = field(default_factory=dict)
    capacity: ResourceList = field(default_factory=dict)
    conditions: List[NodeCondition] = field(default_factory=list)


@dataclass
class Node:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: NodeSpec = field(default_factory=NodeSpec)
    status: NodeStatus = field(default_factory=NodeStatus)

    @property
    def name(self) -> str:
        return self.metadata.name


# --- PodGroup / Queue (the CRD analog; reference pkg/apis/scheduling) --------

# PodGroup phases (reference v1alpha1/types.go:24-44).
class PodGroupPhase:
    PENDING = "Pending"
    RUNNING = "Running"
    UNKNOWN = "Unknown"
    INQUEUE = "Inqueue"


# PodGroup condition type + reasons (reference v1alpha1/types.go:46-83).
POD_GROUP_CONDITION_UNSCHEDULABLE = "Unschedulable"
NOT_ENOUGH_RESOURCES_REASON = "NotEnoughResources"
NOT_ENOUGH_PODS_REASON = "NotEnoughTasks"


@dataclass
class PodGroupCondition:
    type: str = ""
    status: str = ""
    transition_id: str = ""
    reason: str = ""
    message: str = ""


@dataclass
class PodGroupSpec:
    min_member: int = 0
    queue: str = ""
    priority_class_name: str = ""


@dataclass
class PodGroupStatus:
    phase: str = PodGroupPhase.PENDING
    conditions: List[PodGroupCondition] = field(default_factory=list)
    running: int = 0
    succeeded: int = 0
    failed: int = 0


@dataclass
class PodGroup:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: PodGroupSpec = field(default_factory=PodGroupSpec)
    status: PodGroupStatus = field(default_factory=PodGroupStatus)

    @property
    def name(self) -> str:
        return self.metadata.name

    @property
    def namespace(self) -> str:
        return self.metadata.namespace


@dataclass
class QueueSpec:
    weight: int = 1
    capability: Optional[ResourceList] = None


@dataclass
class QueueStatus:
    pending: int = 0
    running: int = 0
    unknown: int = 0


@dataclass
class Queue:
    """Cluster-scoped queue (reference v1alpha1 Queue)."""

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: QueueSpec = field(default_factory=QueueSpec)
    status: QueueStatus = field(default_factory=QueueStatus)

    @property
    def name(self) -> str:
        return self.metadata.name


@dataclass
class PriorityClass:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    value: int = 0
    global_default: bool = False
    # System-critical classes are protected from preempt/reclaim
    # (reference plugins/conformance/conformance.go:45-58).
    system_critical: bool = False

    @property
    def name(self) -> str:
        return self.metadata.name


@dataclass
class PodDisruptionBudget:
    """Legacy gang source (reference event_handlers.go:662-773): a PDB
    whose controller owner matches a set of pods defines their gang's
    minAvailable without a PodGroup. metadata.owner_uid keys the job, the
    same way owned plain pods are keyed (apis/utils/utils.go:26-38)."""

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    min_available: int = 1

    @property
    def name(self) -> str:
        return self.metadata.name

    @property
    def namespace(self) -> str:
        return self.metadata.namespace
