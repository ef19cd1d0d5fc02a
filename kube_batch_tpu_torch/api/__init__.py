"""In-memory domain model (mirrors reference pkg/scheduler/api)."""

from .cluster_info import ClusterInfo
from .helpers import get_controller_uid, get_task_status, pod_key
from .job_info import JobID, JobInfo, QueueID, TaskID, TaskInfo, get_job_id
from .node_info import NodeInfo, NodeState
from .queue_info import QueueInfo
from .objects import (
    DEFAULT_SCHEDULER_NAME,
    GROUP_NAME_ANNOTATION_KEY,
    NOT_ENOUGH_PODS_REASON,
    NOT_ENOUGH_RESOURCES_REASON,
    POD_GROUP_CONDITION_UNSCHEDULABLE,
    Affinity,
    Container,
    Node,
    NodeCondition,
    NodeSpec,
    NodeStatus,
    ObjectMeta,
    Pod,
    PodCondition,
    PodDisruptionBudget,
    PodGroup,
    PodGroupCondition,
    PodGroupPhase,
    PodGroupSpec,
    PodGroupStatus,
    PodPhase,
    PodSpec,
    PodStatus,
    PriorityClass,
    Queue,
    QueueSpec,
    QueueStatus,
    Taint,
    Toleration,
    generate_uid,
)
from .pod_info import (
    get_pod_resource_request,
    get_pod_resource_without_init_containers,
)
from .serving import (
    CAPACITY_RESERVED,
    CAPACITY_SPOT,
    CAPACITY_TYPE_LABEL_KEY,
    DEFAULT_NODE_CLASS,
    MIN_TOPOLOGY_TIER_ANNOTATION_KEY,
    REPLICA_FLOOR_ANNOTATION_KEY,
    RESERVED_ONLY_ANNOTATION_KEY,
    SLO_SECONDS_ANNOTATION_KEY,
    TOPOLOGY_TIER_LABEL_KEY,
    TPU_GENERATION_LABEL_KEY,
    TPU_GENERATIONS_ANNOTATION_KEY,
    WORKLOAD_CLASS_ANNOTATION_KEY,
    WORKLOAD_CLASS_BATCH,
    WORKLOAD_CLASS_SERVING,
    NodeClass,
    ServingSLO,
    node_class_from_labels,
    parse_serving_slo,
    parse_workload_class,
    slo_permits_node,
)
from .resource_info import (
    GPU_RESOURCE_NAME,
    MIN_MEMORY,
    MIN_MILLI_CPU,
    MIN_MILLI_SCALAR,
    RESOURCE_CPU,
    RESOURCE_MEMORY,
    RESOURCE_PODS,
    TPU_RESOURCE_NAME,
    Resource,
    ResourceList,
    build_resource_list,
    min_resource,
    parse_quantity,
    share,
)
from .types import (
    ALLOCATED_STATUSES,
    NodePhase,
    TaskStatus,
    ValidateResult,
    allocated_status,
)
