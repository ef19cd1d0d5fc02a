"""NodeInfo: per-node aggregated scheduling state.

Mirrors reference pkg/scheduler/api/node_info.go:
- Releasing / Idle / Used dual accounting (:36-44) so the scheduler can plan
  onto resources that are still being released ("Pipelined" placements).
- AddTask status-dependent accounting (:174-206): Releasing → take idle AND
  count releasing; Pipelined → consume releasing (not idle); default → take
  idle. RemoveTask is the exact inverse (:209-235).
- OutOfSync / NotReady state when accounting underflows (:107-131,:161-171).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Dict, List, Optional

from .helpers import POD_KEY_CACHE_ATTR, pod_key
from .job_info import TaskInfo
from .objects import Node, Pod
from .resource_info import Resource
from .serving import DEFAULT_NODE_CLASS, NodeClass, node_class_from_labels
from .types import NodePhase, TaskStatus

logger = logging.getLogger(__name__)


@dataclass
class NodeState:
    phase: str = NodePhase.NOT_READY
    reason: str = ""


class NodeInfo:
    """Node-level aggregated information (reference node_info.go:28-47)."""

    def __init__(self, node: Optional[Node] = None):
        self.name = ""
        # The backing k8s Node object. CONTRACT: in-place mutations of
        # this object (spec/conditions/labels/taints) are invisible to
        # the predicates plugin's static-verdict memo, which keys on
        # (id(node), _node_obj_ver) — deliver every change through
        # :meth:`set_node` (the watch ingest path does), even when
        # re-delivering the same object reference, so the generation
        # bumps and the memo re-evaluates. Code that tweaks
        # ``node_info.node`` directly between cycles will keep serving
        # the stale verdict indefinitely.
        self.node: Optional[Node] = None
        self.state = NodeState()
        self.releasing = Resource.empty()
        self.idle = Resource.empty()
        self.used = Resource.empty()
        self.allocatable = Resource.empty()
        self.capability = Resource.empty()
        self.tasks: Dict[str, TaskInfo] = {}
        # Mutation counter for the cache's COW snapshot pool (see
        # JobInfo._ver): bumped by every accounting mutator.
        self._ver = 0
        # Generation of the backing k8s object: bumped ONLY when a
        # watch update lands (set_node) — including in-place mutations
        # re-delivered as the same reference (InProcessCluster does
        # this). Keys the predicates plugin's static-node-verdict memo;
        # _ver cannot (it bumps on every bind).
        self._node_obj_ver = 0
        # Node-class descriptor (api/serving.py): derived from labels
        # here and on every set_node; immutable, so clones share it.
        self.node_class: NodeClass = DEFAULT_NODE_CLASS
        if node is not None:
            self.name = node.name
            self.node = node
            self.idle = Resource.from_resource_list(node.status.allocatable)
            self.allocatable = Resource.from_resource_list(node.status.allocatable)
            self.capability = Resource.from_resource_list(node.status.capacity)
            self.node_class = node_class_from_labels(node.metadata.labels)
        self._set_node_state(node)

    # -- state --------------------------------------------------------------

    def ready(self) -> bool:
        return self.state.phase == NodePhase.READY

    def _set_node_state(self, node: Optional[Node]) -> None:
        """reference node_info.go:107-131"""
        self._ver += 1
        if node is None:
            self.state = NodeState(NodePhase.NOT_READY, "UnInitialized")
            return
        if not self.used.less_equal(
            Resource.from_resource_list(node.status.allocatable)
        ):
            self.state = NodeState(NodePhase.NOT_READY, "OutOfSync")
            return
        self.state = NodeState(NodePhase.READY, "")

    def set_node(self, node: Node) -> None:
        """Recompute accounting from a fresh node object
        (reference node_info.go:134-159). This is the ONLY path that
        bumps ``_node_obj_ver`` — any in-place mutation of the backing
        object must be re-delivered through here to be observed by the
        predicates static-verdict memo (see the ``node`` attribute
        contract in ``__init__``)."""
        self._ver += 1
        self._node_obj_ver += 1
        self._set_node_state(node)
        if not self.ready():
            return
        self.name = node.name
        self.node = node
        self.node_class = node_class_from_labels(node.metadata.labels)
        self.allocatable = Resource.from_resource_list(node.status.allocatable)
        self.capability = Resource.from_resource_list(node.status.capacity)
        self.idle = Resource.from_resource_list(node.status.allocatable)
        self.used = Resource.empty()
        self.releasing = Resource.empty()
        for task in self.tasks.values():
            if task.status == TaskStatus.RELEASING:
                self.releasing.add(task.resreq)
            self.idle.sub(task.resreq)
            self.used.add(task.resreq)

    # -- task accounting ----------------------------------------------------

    def _allocate_idle_resource(self, ti: TaskInfo) -> None:
        """reference node_info.go:161-171"""
        if ti.resreq.less_equal(self.idle):
            self.idle.sub(ti.resreq)
            return
        self.state = NodeState(NodePhase.NOT_READY, "OutOfSync")
        raise ValueError("Selected node NotReady")

    def add_task(self, task: TaskInfo) -> None:
        """reference node_info.go:174-206; node holds a CLONE of the task so
        later status changes don't corrupt node accounting (:181-183)."""
        key = pod_key(task.pod)
        if key in self.tasks:
            raise ValueError(
                f"task <{task.namespace}/{task.name}> already on node <{self.name}>"
            )
        ti = task.clone()
        self._ver += 1
        if self.node is not None:
            if ti.status == TaskStatus.RELEASING:
                self._allocate_idle_resource(ti)
                self.releasing.add(ti.resreq)
            elif ti.status == TaskStatus.PIPELINED:
                self.releasing.sub(ti.resreq)
            else:
                self._allocate_idle_resource(ti)
            self.used.add(ti.resreq)
        self.tasks[key] = ti

    def add_tasks(self, tasks: List[TaskInfo]) -> None:
        """Batched :meth:`add_task` for same-status bulk placement (the
        apply phase): one aggregate idle/used update for the whole group
        instead of per-task Resource arithmetic. Only statuses on the
        default accounting branch (not Releasing/Pipelined) qualify, and
        pod keys must be unique across both the node and the batch.

        All-or-nothing: on any precondition failure it raises WITHOUT
        touching node state — notably, a failed aggregate fit check does
        NOT mark the node OutOfSync, because the single group epsilon is
        stricter than the per-task epsilon chain and the per-task
        fallback may still place everything on a healthy node."""
        if not tasks:
            return
        clones = []
        seen = set()
        for task in tasks:
            key = pod_key(task.pod)
            if key in self.tasks or key in seen:
                raise ValueError(
                    f"task <{task.namespace}/{task.name}> already on "
                    f"node <{self.name}>"
                )
            seen.add(key)
            if task.status in (TaskStatus.RELEASING, TaskStatus.PIPELINED):
                raise ValueError(
                    f"add_tasks only takes default-branch statuses, got "
                    f"{task.status.name}"
                )
            clones.append((key, task.clone()))
        if self.node is not None:
            delta = Resource.empty()
            for _, ti in clones:
                delta.add(ti.resreq)
            if not delta.less_equal(self.idle):
                raise ValueError(
                    f"batch of {len(clones)} tasks does not fit node "
                    f"<{self.name}> in aggregate"
                )
            self.idle.sub(delta)
            self.used.add(delta)
        self._ver += 1
        for key, ti in clones:
            self.tasks[key] = ti

    def add_tasks_prevalidated(
        self, tasks: List[TaskInfo], delta: "Resource"
    ) -> None:
        """Session-apply fast path: place a uniform default-branch group
        whose aggregate fit the solver's apply guard ALREADY verified,
        with ``delta`` its precomputed resreq sum. Stores the tasks
        THEMSELVES, not clones — only valid on session-lifetime nodes,
        where node entries and the session's task objects die together
        at close (the authoritative cache mirror must keep using
        add_task/add_tasks, whose clones protect accounting across
        cycles). Raises like :meth:`add_tasks` on duplicates or an
        aggregate misfit, without touching node state."""
        if not tasks:
            return
        new = {}
        node_tasks = self.tasks
        setdefault = new.setdefault
        for task in tasks:
            # Inline pod_key incl. its memo write: the function-call
            # overhead alone was measurable at 50k tasks per apply, and
            # the cold burst is exactly the first touch of every pod.
            pod = task.pod
            key = pod.__dict__.get(POD_KEY_CACHE_ATTR)
            if key is None:
                key = pod.metadata.uid or f"{pod.namespace}/{pod.name}"
                pod.__dict__[POD_KEY_CACHE_ATTR] = key
            # setdefault doubles as the intra-batch duplicate check.
            if key in node_tasks or setdefault(key, task) is not task:
                raise ValueError(
                    f"task <{task.namespace}/{task.name}> already on "
                    f"node <{self.name}>"
                )
        if len(new) != len(tasks):
            # Same task object listed twice slips past setdefault.
            raise ValueError(
                f"duplicate tasks in prevalidated batch for "
                f"node <{self.name}>"
            )
        if self.node is not None:
            if not delta.less_equal(self.idle):
                raise ValueError(
                    f"batch of {len(new)} tasks does not fit node "
                    f"<{self.name}> in aggregate"
                )
            self.idle.sub(delta)
            self.used.add(delta)
        self._ver += 1
        node_tasks.update(new)

    def add_tasks_with_fallback(self, tasks: List[TaskInfo]) -> List[TaskInfo]:
        """Batch-add with sequential per-task fallback, returning the
        tasks actually placed. The fallback covers the cases the strict
        batch path rejects (aggregate epsilon, mixed statuses, duplicate
        keys): per-task failures are logged and skipped, exactly like the
        sequential apply loop. Shared by Session.allocate_batch and
        SchedulerCache.bind_batch so the fallback policy lives next to
        the accounting it protects."""
        if len(tasks) > 1:
            # Degenerate single-task groups (e.g. a gang spread
            # one-task-per-node) skip the batch machinery and fall
            # through to the sequential loop directly.
            try:
                self.add_tasks(tasks)
                return list(tasks)
            except Exception:
                pass
        placed: List[TaskInfo] = []
        for task in tasks:
            try:
                self.add_task(task)
            except Exception:
                logger.exception(
                    "failed to place task <%s/%s> on node <%s>",
                    task.namespace, task.name, self.name,
                )
                continue
            placed.append(task)
        return placed

    def remove_task(self, ti: TaskInfo) -> None:
        """reference node_info.go:209-235"""
        key = pod_key(ti.pod)
        task = self.tasks.get(key)
        if task is None:
            raise KeyError(
                f"failed to find task <{ti.namespace}/{ti.name}> "
                f"on host <{self.name}>"
            )
        self._ver += 1
        if self.node is not None:
            if task.status == TaskStatus.RELEASING:
                self.releasing.sub(task.resreq)
                self.idle.add(task.resreq)
            elif task.status == TaskStatus.PIPELINED:
                self.releasing.add(task.resreq)
            else:
                self.idle.add(task.resreq)
            self.used.sub(task.resreq)
        del self.tasks[key]

    def update_task(self, ti: TaskInfo) -> None:
        """reference node_info.go:238-244"""
        self.remove_task(ti)
        self.add_task(ti)

    def clone(self) -> "NodeInfo":
        """Deep copy for the per-cycle snapshot (reference
        node_info.go:92-100). The reference rebuilds accounting by
        re-adding every task; here the already-consistent incremental
        vectors are copied directly — same result (idle/used/releasing
        are invariants of the task set) without re-parsing the node's
        quantity strings on every 1 Hz snapshot."""
        res = NodeInfo.__new__(NodeInfo)
        res._ver = 0
        res._node_obj_ver = self._node_obj_ver
        res.name = self.name
        res.node = self.node
        res.node_class = self.node_class  # immutable; clones share
        res.state = NodeState(self.state.phase, self.state.reason)
        res.releasing = self.releasing.clone()
        res.idle = self.idle.clone()
        res.used = self.used.clone()
        res.allocatable = self.allocatable.clone()
        res.capability = self.capability.clone()
        res.tasks = {k: t.clone() for k, t in self.tasks.items()}
        return res

    def pods(self) -> List[Pod]:
        return [t.pod for t in self.tasks.values()]

    def __repr__(self) -> str:
        return (
            f"Node ({self.name}): idle <{self.idle}>, used <{self.used}>, "
            f"releasing <{self.releasing}>, "
            f"state <phase {self.state.phase}, reason {self.state.reason}>"
        )
