"""Statement: two-phase commit over evict/pipeline operations.

Mirrors reference framework/statement.go (:28 struct, :37 Evict applies the
session-level effect immediately and records the op, :113 Pipeline, :198
Discard undoes in reverse order, :212 Commit applies the real cache evictions
— pipeline ops are session-only so commit is a no-op for them :156).

Used by the preempt action so a failed gang preemption rolls back cleanly.
"""

from __future__ import annotations

import logging
from typing import List, Tuple

from ..api import TaskInfo, TaskStatus
from .event import Event

logger = logging.getLogger(__name__)


class Statement:
    def __init__(self, ssn):
        self.ssn = ssn
        self.operations: List[Tuple[str, tuple]] = []

    # -- recorded operations -------------------------------------------------

    def evict(self, reclaimee: TaskInfo, reason: str) -> None:
        """Session-level evict now; cache evict deferred to commit
        (statement.go:37-69)."""
        job = self.ssn.jobs.get(reclaimee.job)
        if job is not None:
            job.update_task_status(reclaimee, TaskStatus.RELEASING)
            self.ssn._touched_jobs.add(reclaimee.job)
        node = self.ssn.nodes.get(reclaimee.node_name)
        if node is not None:
            node.update_task(reclaimee)
            self.ssn._touched_nodes.add(reclaimee.node_name)
        for eh in self.ssn.event_handlers:
            if eh.deallocate_func is not None:
                eh.deallocate_func(Event(reclaimee))
        self.operations.append(("evict", (reclaimee, reason)))

    def pipeline(self, task: TaskInfo, hostname: str) -> None:
        """statement.go:113-154"""
        job = self.ssn.jobs.get(task.job)
        if job is not None:
            job.update_task_status(task, TaskStatus.PIPELINED)
            self.ssn._touched_jobs.add(task.job)
        task.node_name = hostname
        node = self.ssn.nodes.get(hostname)
        if node is not None:
            self.ssn._touched_nodes.add(hostname)
            try:
                node.add_task(task)
            except ValueError:
                logger.exception(
                    "failed to pipeline task %s/%s to %s",
                    task.namespace, task.name, hostname,
                )
        for eh in self.ssn.event_handlers:
            if eh.allocate_func is not None:
                eh.allocate_func(Event(task))
        self.operations.append(("pipeline", (task, hostname)))

    # -- undo ops (statement.go:83-110, :159-195) ----------------------------

    def _unevict(self, reclaimee: TaskInfo) -> None:
        job = self.ssn.jobs.get(reclaimee.job)
        if job is not None:
            job.update_task_status(reclaimee, TaskStatus.RUNNING)
            self.ssn._touched_jobs.add(reclaimee.job)
        node = self.ssn.nodes.get(reclaimee.node_name)
        if node is not None:
            node.update_task(reclaimee)
            self.ssn._touched_nodes.add(reclaimee.node_name)
        for eh in self.ssn.event_handlers:
            if eh.allocate_func is not None:
                eh.allocate_func(Event(reclaimee))

    def _unpipeline(self, task: TaskInfo) -> None:
        job = self.ssn.jobs.get(task.job)
        if job is not None:
            job.update_task_status(task, TaskStatus.PENDING)
            self.ssn._touched_jobs.add(task.job)
        node = self.ssn.nodes.get(task.node_name)
        if node is not None:
            self.ssn._touched_nodes.add(task.node_name)
            try:
                node.remove_task(task)
            except KeyError:
                logger.exception(
                    "failed to unpipeline task %s/%s", task.namespace, task.name
                )
        task.node_name = ""
        for eh in self.ssn.event_handlers:
            if eh.deallocate_func is not None:
                eh.deallocate_func(Event(task))

    def _commit_evict(self, reclaimee: TaskInfo, reason: str) -> None:
        """statement.go:71-81"""
        try:
            self.ssn.cache.evict(reclaimee, reason)
        except Exception:
            logger.exception(
                "cache evict failed for %s/%s; rolling back",
                reclaimee.namespace, reclaimee.name,
            )
            self._unevict(reclaimee)

    # -- transaction ends ----------------------------------------------------

    def discard(self) -> None:
        """Undo in reverse (statement.go:198-209). Drains any in-flight
        async solve first: a rollback must not race an outstanding
        device computation over the same session snapshot."""
        self.ssn.drain_inflight_solve()
        for name, args in reversed(self.operations):
            if name == "evict":
                self._unevict(args[0])
            elif name == "pipeline":
                self._unpipeline(args[0])
        self.operations = []

    def commit(self) -> None:
        """Apply real cache evictions (statement.go:212-222). Drains
        any in-flight async solve first (see :meth:`discard`)."""
        self.ssn.drain_inflight_solve()
        for name, args in self.operations:
            if name == "evict":
                self._commit_evict(args[0], args[1])
            # pipeline is session-only (statement.go:156-157)
        self.operations = []
