"""Allocate action: the reference-semantics greedy hot loop.

Mirrors reference actions/allocate/allocate.go:43-191 exactly: queue PQ by
QueueOrderFn, per-queue job PQs, per-job pending-task PQs (skipping
BestEffort), per task: resource-fit predicate (fit against node.Idle OR
node.Releasing) → predicate_nodes → prioritize_nodes → select_best_node →
ssn.allocate if it fits Idle, else record NodesFitDelta + ssn.pipeline onto
Releasing; requeue job on JobReady; queue pushed back every round.

This greedy path is the measured baseline; allocate_tpu is the batched
TPU drop-in replacement.
"""

from __future__ import annotations

import logging

from ..api import Resource, TaskStatus
from ..framework import Action, register_action
from ..utils import PriorityQueue
from ..utils.scheduler_helper import (
    get_node_list,
    predicate_nodes,
    prioritize_nodes,
    select_best_node,
)

logger = logging.getLogger(__name__)


class AllocateAction(Action):
    def name(self) -> str:
        return "allocate"

    def execute(self, ssn) -> None:
        queues = PriorityQueue(ssn.queue_order_fn)
        jobs_map = {}

        for job in ssn.jobs.values():
            queue = ssn.queues.get(job.queue)
            if queue is None:
                logger.warning(
                    "Skip adding Job <%s/%s>: queue %s not found",
                    job.namespace, job.name, job.queue,
                )
                continue
            queues.push(queue)
            if job.queue not in jobs_map:
                jobs_map[job.queue] = PriorityQueue(ssn.job_order_fn)
            jobs_map[job.queue].push(job)

        pending_tasks = {}
        all_nodes = get_node_list(ssn.nodes)

        def predicate_fn(task, node):
            # Resource fit against Idle OR Releasing (allocate.go:73-87).
            if not (
                task.init_resreq.less_equal(node.idle)
                or task.init_resreq.less_equal(node.releasing)
            ):
                raise ValueError(
                    f"task <{task.namespace}/{task.name}> ResourceFit failed "
                    f"on node <{node.name}>"
                )
            ssn.predicate_fn(task, node)

        while not queues.empty():
            queue = queues.pop()
            if ssn.overused(queue):
                continue
            jobs = jobs_map.get(queue.uid)
            if jobs is None or jobs.empty():
                continue
            job = jobs.pop()
            if job.uid not in pending_tasks:
                tasks = PriorityQueue(ssn.task_order_fn)
                for task in job.task_status_index.get(
                    TaskStatus.PENDING, {}
                ).values():
                    # Skip BestEffort tasks in allocate (allocate.go:108-113).
                    if task.resreq.is_empty():
                        continue
                    tasks.push(task)
                pending_tasks[job.uid] = tasks
            tasks = pending_tasks[job.uid]

            while not tasks.empty():
                task = tasks.pop()
                # Stale fit data is for tasks that eventually fit
                # (allocate.go:127-133).
                job.clear_fit_deltas()

                fit_nodes = predicate_nodes(task, all_nodes, predicate_fn)
                if not fit_nodes:
                    # Tasks are priority-ordered: if one fails, the rest of
                    # this job would too (allocate.go:144-148).
                    break
                priority_list = prioritize_nodes(
                    task, fit_nodes, ssn.node_prioritizers()
                )
                node_name = select_best_node(priority_list)
                node = ssn.nodes[node_name]

                if task.init_resreq.less_equal(node.idle):
                    try:
                        ssn.allocate(task, node.name)
                    except Exception:
                        logger.exception(
                            "Failed to bind Task %s on %s", task.uid, node.name
                        )
                else:
                    # Record missing resources (allocate.go:168-173).
                    delta = node.idle.clone()
                    delta.fit_delta(task.init_resreq)
                    job.record_fit_delta(node.name, delta)
                    # Pipeline onto releasing resources (allocate.go:175-181).
                    if task.init_resreq.less_equal(node.releasing):
                        try:
                            ssn.pipeline(task, node.name)
                        except Exception:
                            logger.exception(
                                "Failed to pipeline Task %s on %s",
                                task.uid, node.name,
                            )

                if ssn.job_ready(job):
                    jobs.push(job)
                    break

            queues.push(queue)


register_action(AllocateAction())
