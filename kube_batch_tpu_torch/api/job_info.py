"""TaskInfo and JobInfo: the per-pod and per-gang scheduling state.

Mirrors reference pkg/scheduler/api/job_info.go:
- TaskInfo (:36) with Resreq (running requirement) vs InitResreq (launch
  requirement, includes init-container max).
- JobInfo (:127) with a status-indexed task map, MinAvailable gang threshold,
  NodesFitDelta fit diagnostics, Ready/Pipelined gang readiness (:415,:422).
"""

from __future__ import annotations

from typing import Dict, List, Optional

from .helpers import get_task_status
from .objects import (
    GROUP_NAME_ANNOTATION_KEY,
    Pod,
    PodGroup,
)
from .pod_info import (
    get_pod_resource_request,
    get_pod_resource_without_init_containers,
)
from .resource_info import (
    RESOURCE_CPU,
    RESOURCE_MEMORY,
    Resource,
    freeze_resource,
)
from .serving import (
    WORKLOAD_CLASS_ANNOTATION_KEY,
    WORKLOAD_CLASS_BATCH,
    WORKLOAD_CLASS_SERVING,
    ServingSLO,
    parse_serving_slo,
)
from .types import TaskStatus, allocated_status, validate_status_update

TaskID = str
JobID = str
QueueID = str


def get_job_id(pod: Pod) -> JobID:
    """Pod → owning job key via group-name annotation
    (reference job_info.go:56-66)."""
    gn = pod.metadata.annotations.get(GROUP_NAME_ANNOTATION_KEY, "")
    if gn:
        return f"{pod.namespace}/{gn}"
    return ""


class TaskInfo:
    """All scheduling info about one task (reference job_info.go:36-54)."""

    __slots__ = (
        "uid",
        "job",
        "name",
        "namespace",
        "resreq",
        "init_resreq",
        "node_name",
        "status",
        "priority",
        "volume_ready",
        "pod",
    )

    def __init__(self, pod: Pod):
        self.uid: TaskID = pod.metadata.uid
        self.job: JobID = get_job_id(pod)
        self.name = pod.name
        self.namespace = pod.namespace
        self.node_name = pod.spec.node_name
        self.status = get_task_status(pod)
        self.priority: int = (
            pod.spec.priority if pod.spec.priority is not None else 1
        )
        self.volume_ready = False
        self.pod = pod
        # Frozen: clones share these (see TaskInfo.clone / FrozenResource).
        self.resreq: Resource = freeze_resource(
            get_pod_resource_without_init_containers(pod)
        )
        self.init_resreq: Resource = freeze_resource(
            get_pod_resource_request(pod)
        )

    def clone(self) -> "TaskInfo":
        # resreq/init_resreq are immutable by contract — nothing in the
        # package mutates a task's request vectors in place (aggregates
        # like job.allocated / node.idle clone before add/sub), so clones
        # SHARE them. With ~150k task clones per 50k-task cycle (snapshot
        # + node bookkeeping), cloning the two Resource payloads per task
        # was the single largest host cost of session open.
        c = object.__new__(TaskInfo)
        c.uid = self.uid
        c.job = self.job
        c.name = self.name
        c.namespace = self.namespace
        c.node_name = self.node_name
        c.status = self.status
        c.priority = self.priority
        c.volume_ready = self.volume_ready
        c.pod = self.pod
        c.resreq = self.resreq
        c.init_resreq = self.init_resreq
        return c

    @property
    def best_effort(self) -> bool:
        """A task with an empty resource request (allocate.go:108-113 skips
        these; backfill.go:45 targets them)."""
        return self.resreq.is_empty()

    def __repr__(self) -> str:
        return (
            f"Task ({self.uid}:{self.namespace}/{self.name}): job {self.job}, "
            f"status {self.status.name}, pri {self.priority}, resreq {self.resreq}"
        )


class JobInfo:
    """All scheduling info about one job/gang (reference job_info.go:127-154)."""

    def __init__(self, uid: JobID, *tasks: TaskInfo):
        self.uid = uid
        self.name = ""
        self.namespace = ""
        self.queue: QueueID = ""
        self.priority: int = 0
        self.min_available: int = 0
        self.node_selector: Dict[str, str] = {}
        self.nodes_fit_delta: Dict[str, Resource] = {}
        self.task_status_index: Dict[TaskStatus, Dict[TaskID, TaskInfo]] = {}
        self.tasks: Dict[TaskID, TaskInfo] = {}
        self.allocated = Resource.empty()
        self.total_request = Resource.empty()
        self.creation_timestamp: float = 0.0
        self.pod_group: Optional[PodGroup] = None
        # Workload class (api/serving.py): parsed from the first member
        # pod carrying the workload-class annotation. Batch is the
        # default and the pre-serving behavior; ``slo`` is None for
        # batch jobs and an immutable ServingSLO for serving jobs.
        self.workload_class: str = WORKLOAD_CLASS_BATCH
        self.slo: Optional[ServingSLO] = None
        # Legacy gang source (reference job_info.go:153, deprecated but
        # part of the surface): a PodDisruptionBudget standing in for a
        # PodGroup.
        self.pdb = None
        # Mutation counter: every state-changing method bumps it; the
        # cache's snapshot clone pool reuses a clone only while both the
        # source's and the clone's counters are unchanged (COW snapshots).
        self._ver = 0
        for task in tasks:
            self.add_task_info(task)

    # -- pod group ----------------------------------------------------------

    def set_pod_group(self, pg: PodGroup) -> None:
        """Attach PodGroup spec to the job (reference job_info.go:184-192)."""
        self._ver += 1
        self.name = pg.name
        self.namespace = pg.namespace
        self.min_available = pg.spec.min_member
        self.queue = pg.spec.queue
        self.creation_timestamp = pg.metadata.creation_timestamp
        self.pod_group = pg

    def unset_pod_group(self) -> None:
        self._ver += 1
        self.pod_group = None

    # -- PDB (legacy gang source, reference job_info.go:194-207) ------------

    def set_pdb(self, pdb) -> None:
        self._ver += 1
        self.name = pdb.name
        self.namespace = pdb.namespace
        self.min_available = pdb.min_available
        self.creation_timestamp = pdb.metadata.creation_timestamp
        self.pdb = pdb

    def unset_pdb(self) -> None:
        self._ver += 1
        self.pdb = None

    # -- task bookkeeping ---------------------------------------------------

    def _add_task_index(self, ti: TaskInfo) -> None:
        # Hot path (3 calls per placement): .get + conditional insert
        # avoids setdefault's throwaway dict allocation per call.
        idx = self.task_status_index.get(ti.status)
        if idx is None:
            idx = self.task_status_index[ti.status] = {}
        idx[ti.uid] = ti

    def _delete_task_index(self, ti: TaskInfo) -> None:
        tasks = self.task_status_index.get(ti.status)
        if tasks is not None:
            tasks.pop(ti.uid, None)
            if not tasks:
                del self.task_status_index[ti.status]

    def add_task_info(self, ti: TaskInfo) -> None:
        """reference job_info.go:233-242"""
        self._ver += 1
        self.tasks[ti.uid] = ti
        self._add_task_index(ti)
        self.total_request.add(ti.resreq)
        if allocated_status(ti.status):
            self.allocated.add(ti.resreq)
        # Serving-class opt-in: the first member carrying the
        # workload-class annotation classifies the job (one dict get on
        # the already-classified hot path; members of one job share
        # annotations by construction).
        if (
            self.slo is None
            and self.workload_class == WORKLOAD_CLASS_BATCH
            and ti.pod.metadata.annotations.get(
                WORKLOAD_CLASS_ANNOTATION_KEY
            ) == WORKLOAD_CLASS_SERVING
        ):
            self._ver += 1
            self.workload_class = WORKLOAD_CLASS_SERVING
            self.slo = parse_serving_slo(ti.pod.metadata.annotations)

    def delete_task_info(self, ti: TaskInfo) -> None:
        """reference job_info.go:271-287"""
        task = self.tasks.get(ti.uid)
        if task is None:
            raise KeyError(
                f"failed to find task <{ti.namespace}/{ti.name}> "
                f"in job <{self.namespace}/{self.name}>"
            )
        self._ver += 1
        self.total_request.sub(task.resreq)
        if allocated_status(task.status):
            self.allocated.sub(task.resreq)
        del self.tasks[task.uid]
        self._delete_task_index(task)

    def update_task_status(self, task: TaskInfo, status: TaskStatus) -> None:
        """Move a task to a new status index (reference job_info.go:245-258
        does delete+re-add; here the cancelling total_request sub/add is
        skipped and ``allocated`` is adjusted only when the allocated-ness
        of the status actually changes — same end state, and this runs
        3x per placement on the hot apply path)."""
        validate_status_update(task.status, status)
        stored = self.tasks.get(task.uid)
        if stored is None:
            raise KeyError(
                f"failed to find task <{task.namespace}/{task.name}> "
                f"in job <{self.namespace}/{self.name}>"
            )
        now = allocated_status(status)
        if stored is not task:
            # A clone was passed (its status/resreq may have drifted from
            # the stored task): keep the full delete+re-add accounting so
            # the stored entry leaves its true index bucket and the
            # aggregates track the replacement's resreq.
            self.delete_task_info(stored)
            task.status = status
            self.add_task_info(task)
            return
        self._ver += 1
        self._delete_task_index(stored)
        was = allocated_status(stored.status)
        if was and not now:
            self.allocated.sub(task.resreq)
        elif now and not was:
            self.allocated.add(task.resreq)
        task.status = status
        self._add_task_index(task)

    def update_tasks_status(
        self,
        tasks: List[TaskInfo],
        status: TaskStatus,
        resreq_delta: "Resource" = None,
    ) -> None:
        """Bulk :meth:`update_task_status` toward one destination status.
        Per-task semantics are identical (clones and missing tasks take
        the per-task path, including its KeyError); the stored-task fast
        path amortizes the version bump, the target-index lookup, and the
        empty-source-bucket cleanup across the whole group — this runs 3x
        per placement on the apply path, 150k calls per 50k-task cycle.

        ``resreq_delta``, when given, must be the EXACT sum of the
        group's resreqs; a status flip on the whole-bucket fast path
        then updates ``self.allocated`` with one aggregate add/sub
        instead of one per task (exact for integral milli/byte
        quantities — same argument as the node accounting aggregates).
        The per-task fallback paths ignore it and keep per-task math."""
        if not tasks:
            return
        self._ver += 1
        target = self.task_status_index.get(status)
        if target is None:
            target = self.task_status_index[status] = {}
        now = allocated_status(status)

        # Whole-bucket fast path: when the group IS one source bucket
        # (gang dispatch moves every ALLOCATED task of a job at once),
        # merge the bucket with one C-level dict.update instead of
        # per-task pops/inserts; a non-flipping transition (Allocated →
        # Binding, both allocated statuses) then needs no Resource math
        # at all.
        first = tasks[0]
        src_status = first.status
        if src_status is not status:
            bucket = self.task_status_index.get(src_status)
            if bucket is not None and len(bucket) == len(tasks):
                stored_get = self.tasks.get
                uniform = True
                seen = set()
                for t in tasks:
                    # The identity check makes uid-uniqueness ≡ object
                    # identity, so dedupe on id(): a duplicate-bearing
                    # list ([a, a] vs bucket {a, b}) would otherwise
                    # pass the length test, drag b along without a
                    # status write, and double-count a's resreq on a
                    # flipping transition.
                    if (t.status is not src_status
                            or stored_get(t.uid) is not t
                            or id(t) in seen):
                        uniform = False
                        break
                    seen.add(id(t))
                if uniform:
                    validate_status_update(src_status, status)
                    was = allocated_status(src_status)
                    if was != now:
                        agg = self.allocated
                        if resreq_delta is not None:
                            if now:
                                agg.add(resreq_delta)
                            else:
                                agg.sub(resreq_delta)
                        elif now:
                            for t in tasks:
                                agg.add(t.resreq)
                        else:
                            for t in tasks:
                                agg.sub(t.resreq)
                    target.update(bucket)
                    del self.task_status_index[src_status]
                    for t in tasks:
                        t.status = status
                    return

        sources = set()
        for task in tasks:
            stored = self.tasks.get(task.uid)
            if stored is not task:
                self.update_task_status(task, status)
                continue
            validate_status_update(task.status, status)
            src = self.task_status_index.get(task.status)
            if src is not None:
                src.pop(task.uid, None)
                sources.add(task.status)
            was = allocated_status(task.status)
            if was and not now:
                self.allocated.sub(task.resreq)
            elif now and not was:
                self.allocated.add(task.resreq)
            task.status = status
            target[task.uid] = task
        # Sorted: bucket-deletion order must not depend on set-hash
        # order (kbtlint replay-determinism; TaskStatus is an IntEnum).
        for src_status in sorted(sources):
            bucket = self.task_status_index.get(src_status)
            if bucket is not None and not bucket:
                del self.task_status_index[src_status]

    def move_status_bucket(
        self,
        src: TaskStatus,
        dst: TaskStatus,
        resreq_delta: "Resource" = None,
    ) -> List[TaskInfo]:
        """Move the ENTIRE ``src`` status bucket to ``dst`` — the
        trusted bulk form of :meth:`update_tasks_status` for callers
        that already hold the whole bucket (the batched apply path moves
        a job's complete PENDING set to ALLOCATED and its complete
        ALLOCATED set to BINDING). Skips the per-task stored-identity
        verification (the bucket's values ARE the stored tasks by
        construction) and, when the transition flips allocated-status,
        applies ``resreq_delta`` (or a per-task fold) once. Returns the
        moved tasks; no-op empty list when the bucket is missing."""
        bucket = self.task_status_index.get(src)
        if not bucket:
            return []
        validate_status_update(src, dst)
        self._ver += 1
        was, now = allocated_status(src), allocated_status(dst)
        if was != now:
            agg = self.allocated
            if resreq_delta is not None:
                if now:
                    agg.add(resreq_delta)
                else:
                    agg.sub(resreq_delta)
            elif now:
                for t in bucket.values():
                    agg.add(t.resreq)
            else:
                for t in bucket.values():
                    agg.sub(t.resreq)
        del self.task_status_index[src]
        target = self.task_status_index.get(dst)
        if target is None:
            # Reuse the bucket dict itself: no per-task re-inserts.
            self.task_status_index[dst] = bucket
        else:
            target.update(bucket)
        moved = list(bucket.values())
        for t in moved:
            t.status = dst
        return moved

    def get_tasks(self, *statuses: TaskStatus) -> List[TaskInfo]:
        """Clones of all tasks in the given statuses (reference :210-222)."""
        res: List[TaskInfo] = []
        for status in statuses:
            for task in self.task_status_index.get(status, {}).values():
                res.append(task.clone())
        return res

    def clone(self) -> "JobInfo":
        """Deep copy for the per-cycle snapshot (reference
        job_info.go:290-322). Like NodeInfo.clone, the aggregate vectors
        (total_request/allocated) are copied rather than re-accumulated
        task by task — they are invariants of the task set."""
        info = JobInfo(self.uid)
        info.name = self.name
        info.namespace = self.namespace
        info.queue = self.queue
        info.priority = self.priority
        info.min_available = self.min_available
        info.node_selector = dict(self.node_selector)
        info.creation_timestamp = self.creation_timestamp
        info.pod_group = self.pod_group
        info.workload_class = self.workload_class
        info.slo = self.slo  # immutable; clones share
        info.pdb = self.pdb
        info.total_request = self.total_request.clone()
        info.allocated = self.allocated.clone()
        for uid, task in self.tasks.items():
            ti = task.clone()
            info.tasks[uid] = ti
            info._add_task_index(ti)
        return info

    # -- fit diagnostics ----------------------------------------------------

    def record_fit_delta(self, node_name: str, delta: Resource) -> None:
        """Record missing-resource diagnostics for fit_error
        (allocate.go:168-173). Mutator so the COW snapshot pool sees the
        change — never write nodes_fit_delta directly."""
        self._ver += 1
        self.nodes_fit_delta[node_name] = delta

    def clear_fit_deltas(self) -> None:
        """Drop stale fit data (allocate.go:127-133)."""
        if self.nodes_fit_delta:
            self._ver += 1
            self.nodes_fit_delta = {}

    # -- gang readiness -----------------------------------------------------

    def ready_task_num(self) -> int:
        """Allocated/Bound/Binding/Running/Succeeded (reference :374-385)."""
        n = 0
        for status, tasks in self.task_status_index.items():
            if allocated_status(status) or status == TaskStatus.SUCCEEDED:
                n += len(tasks)
        return n

    def waiting_task_num(self) -> int:
        """Pipelined tasks (reference :387-397)."""
        return len(self.task_status_index.get(TaskStatus.PIPELINED, {}))

    def valid_task_num(self) -> int:
        """Tasks that can still count toward minAvailable (reference :399-412)."""
        n = 0
        for status, tasks in self.task_status_index.items():
            if (
                allocated_status(status)
                or status == TaskStatus.SUCCEEDED
                or status == TaskStatus.PIPELINED
                or status == TaskStatus.PENDING
            ):
                n += len(tasks)
        return n

    def ready(self) -> bool:
        """reference :415-419"""
        return self.ready_task_num() >= self.min_available

    def pipelined(self) -> bool:
        """reference :422-426"""
        return self.waiting_task_num() + self.ready_task_num() >= self.min_available

    # -- diagnostics --------------------------------------------------------

    def fit_error(self) -> str:
        """Human-readable insufficiency histogram (reference :340-372)."""
        if not self.nodes_fit_delta:
            return "0 nodes are available"
        reasons: Dict[str, int] = {}
        for delta in self.nodes_fit_delta.values():
            if delta.get(RESOURCE_CPU) < 0:
                reasons["cpu"] = reasons.get("cpu", 0) + 1
            if delta.get(RESOURCE_MEMORY) < 0:
                reasons["memory"] = reasons.get("memory", 0) + 1
            for name, quant in (delta.scalar_resources or {}).items():
                if quant < 0:
                    reasons[name] = reasons.get(name, 0) + 1
        parts = sorted(f"{v} insufficient {k}" for k, v in reasons.items())
        return (
            f"0/{len(self.nodes_fit_delta)} nodes are available, "
            f"{', '.join(parts)}."
        )

    def __repr__(self) -> str:
        return (
            f"Job ({self.uid}): namespace {self.namespace} ({self.queue}), "
            f"name {self.name}, minAvailable {self.min_available}, "
            f"tasks {len(self.tasks)}"
        )
