"""Session events (reference framework/event.go:24-32).

TPU-native extension: the batched apply path (Session.allocate_batch /
evict_batch) groups a whole solved assignment set per job and hands
plugin handlers :class:`JobBatchEvent` aggregates — one precomputed
``delta`` (the exact resreq sum of the batch) per job — so a 50k-task
apply costs the handlers ~#jobs Resource updates instead of 50k
per-task calls (the reference fires one event per task,
session.go:273-276, mirrored by drf.go:137-157's per-event handlers).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional

from ..api import JobInfo, Resource, TaskInfo


@dataclass
class Event:
    task: TaskInfo


@dataclass
class JobBatchEvent:
    """One job's slice of a batched allocate/evict: the affected tasks
    plus their precomputed aggregate ``delta`` (sum of ``task.resreq``).

    ``delta`` is exact — resource quantities are integral milli-units /
    bytes, so the numpy/Python fold that builds it is bit-identical to
    summing the tasks one by one (same argument as the node accounting
    aggregates, NodeInfo.add_tasks_prevalidated).
    """

    job: JobInfo
    tasks: List[TaskInfo]
    delta: Resource


@dataclass
class EventHandler:
    allocate_func: Optional[Callable[[Event], None]] = None
    deallocate_func: Optional[Callable[[Event], None]] = None
    # TPU-native extension: aggregate batched forms, called ONCE with a
    # list of per-job JobBatchEvents by Session.allocate_batch_grouped /
    # evict_batch. A handler that provides a batch form must make it
    # equivalent to folding the per-event form over every task of every
    # batch (in order); handlers without one get the per-event fallback.
    batch_allocate_func: Optional[Callable[[List[JobBatchEvent]], None]] = None
    batch_deallocate_func: Optional[Callable[[List[JobBatchEvent]], None]] = None
