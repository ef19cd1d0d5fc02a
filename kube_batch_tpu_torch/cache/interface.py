"""Cache interface + the four side-effect seams.

Mirrors reference pkg/scheduler/cache/interface.go:
- Cache (:26-55): Run, Snapshot, WaitForCacheSync, Bind, Evict,
  RecordJobStatusEvent, UpdateJobStatus, AllocateVolumes, BindVolumes.
- Binder/Evictor/StatusUpdater/VolumeBinder (:57-77) — the seams behind which
  all cluster I/O hides, making the decision core testable with zero cluster.
"""

from __future__ import annotations

import logging
from abc import ABC, abstractmethod
from typing import TYPE_CHECKING

if TYPE_CHECKING:
    from ..api import ClusterInfo, JobInfo, Pod, PodCondition, PodGroup, TaskInfo

logger = logging.getLogger(__name__)


class Binder(ABC):
    """reference interface.go:57-60"""

    @abstractmethod
    def bind(self, pod: "Pod", hostname: str) -> None: ...


class Evictor(ABC):
    """reference interface.go:62-65"""

    @abstractmethod
    def evict(self, pod: "Pod") -> None: ...


class StatusUpdater(ABC):
    """reference interface.go:67-71"""

    @abstractmethod
    def update_pod_condition(self, pod: "Pod", condition: "PodCondition") -> None: ...

    @abstractmethod
    def update_pod_group(self, pg: "PodGroup") -> None: ...


class VolumeBinder(ABC):
    """reference interface.go:73-77"""

    @abstractmethod
    def allocate_volumes(self, task: "TaskInfo", hostname: str) -> None: ...

    @abstractmethod
    def bind_volumes(self, task: "TaskInfo") -> None: ...

    def release_volumes(self, task: "TaskInfo") -> None:
        """Undo claim assumptions after a failed bind (default no-op;
        extension beyond the reference interface, needed because a
        timed-out bind must return its claims)."""
        return None


class Cache(ABC):
    """reference interface.go:26-55"""

    @abstractmethod
    def run(self, stop_event) -> None: ...

    @abstractmethod
    def wait_for_cache_sync(self, stop_event) -> bool: ...

    @abstractmethod
    def snapshot(self) -> "ClusterInfo": ...

    @abstractmethod
    def bind(self, task: "TaskInfo", hostname: str) -> None: ...

    def bind_batch(self, task_infos, on_accepted=None) -> list:
        """Batched bind (TPU-native extension): one bookkeeping pass + one
        async side-effect job for a whole gang. Default falls back to
        per-task bind(); SchedulerCache overrides with the real batch.
        Each task must carry node_name. Returns the tasks submitted;
        ``on_accepted`` (if given) is invoked — possibly later, from a
        worker thread — with the subset whose cache bookkeeping actually
        succeeded, so callers can observe per-task metrics without
        counting validation failures or node-rejected reverts."""
        bound = []
        for ti in task_infos:
            try:
                self.bind(ti, ti.node_name)
                bound.append(ti)
            except Exception:  # parity with bind_batch's skip-and-log
                logger.exception(
                    "failed to bind task %s/%s", ti.namespace, ti.name
                )
        if on_accepted is not None:
            try:
                on_accepted(bound)
            except Exception:  # same contract as the async batch path
                logger.exception("bind_batch on_accepted callback failed")
        return bound

    @abstractmethod
    def evict(self, task: "TaskInfo", reason: str) -> None: ...

    @abstractmethod
    def record_job_status_event(self, job: "JobInfo") -> None: ...

    @abstractmethod
    def update_job_status(self, job: "JobInfo") -> "JobInfo": ...

    @abstractmethod
    def allocate_volumes(self, task: "TaskInfo", hostname: str) -> None: ...

    def allocate_volumes_batch(self, tasks, hostname: str) -> list:
        """Batched volume allocation for one node's group (TPU-native
        extension). Default falls back to per-task allocate_volumes;
        SchedulerCache overrides with the claims-aware fast path.
        Returns the tasks that succeeded."""
        ok = []
        for task in tasks:
            try:
                self.allocate_volumes(task, hostname)
            except Exception:
                logger.exception(
                    "failed to allocate volumes of %s/%s",
                    task.namespace, task.name,
                )
                continue
            ok.append(task)
        return ok

    @abstractmethod
    def bind_volumes(self, task: "TaskInfo") -> None: ...
