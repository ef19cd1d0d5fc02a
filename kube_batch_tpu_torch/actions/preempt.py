"""Preempt action: priority preemption with transactional rollback.

Mirrors reference actions/preempt/preempt.go:44-271:
- Phase 1, inter-job within queue: starving jobs pop preemptor tasks;
  the Statement commits once JobPipelined, else discards (:76-135).
- Phase 2, intra-job task preemption; commit always (:137-167).
- preempt(): predicate nodes → prioritize → sort → per node: filtered
  running tasks → ssn.preemptable victims → victim PQ in REVERSE task order
  → stmt.evict until resreq covered → stmt.pipeline the preemptor
  (:171-254). validateVictims (:256-271).
"""

from __future__ import annotations

import logging

from .. import metrics
from ..api import Resource, TaskStatus
from ..framework import Action, register_action
from ..obs import explain
from ..utils import PriorityQueue
from ..utils.scheduler_helper import (
    FeasibilityMemo,
    get_node_list,
    predicate_nodes,
    prioritize_nodes,
    sort_nodes,
)

logger = logging.getLogger(__name__)


def _validate_victims(victims, resreq: Resource) -> bool:
    """reference preempt.go:256-271"""
    if not victims:
        return False
    all_res = Resource.empty()
    for v in victims:
        all_res.add(v.resreq)
    if all_res.less(resreq):
        return False
    return True


def _preempt(ssn, stmt, preemptor, nodes, filter_fn, memo=None,
             stats=None) -> bool:
    """reference preempt.go:171-254. ``stats``, when given, accumulates
    the attempt's victim count (explainability: obs/explain)."""
    assigned = False
    if memo is not None:
        # Cycle-scoped spec-keyed feasibility (same throughput reasoning
        # as reclaim's: preemptors re-scan every node per attempt, and a
        # starving backlog shares a handful of pod specs). Preempt's
        # predicate pass is pure ssn.predicate_fn — no resource-fit
        # term, victims are expected to free the resources — so the
        # memo's verdict-staleness rules apply unchanged; statement
        # rollbacks only REMOVE node tasks, which the memo's
        # conservative direction tolerates.
        fit_nodes = memo.feasible(preemptor)
    else:
        all_nodes = get_node_list(nodes)
        fit_nodes = predicate_nodes(preemptor, all_nodes, ssn.predicate_fn)
    priority_list = prioritize_nodes(
        preemptor, fit_nodes, ssn.node_prioritizers()
    )
    for node in sort_nodes(priority_list, ssn.nodes):
        preemptees = []
        for task in node.tasks.values():
            if filter_fn is None or filter_fn(task):
                preemptees.append(task.clone())
        victims = ssn.preemptable(preemptor, preemptees)
        metrics.update_preemption_victims(len(victims))

        resreq = preemptor.init_resreq.clone()
        if not _validate_victims(victims, resreq):
            continue

        # Lowest-priority victims first: REVERSE task order (preempt.go:204).
        victims_queue = PriorityQueue(lambda l, r: not ssn.task_order_fn(l, r))
        for victim in victims:
            victims_queue.push(victim)

        preempted = Resource.empty()
        while not victims_queue.empty():
            preemptee = victims_queue.pop()
            try:
                stmt.evict(preemptee, "preempt")
            except Exception:
                logger.exception(
                    "Failed to preempt Task <%s/%s>",
                    preemptee.namespace, preemptee.name,
                )
                continue
            preempted.add(preemptee.resreq)
            if stats is not None:
                stats["victims"] = stats.get("victims", 0) + 1
            if resreq.less_equal(preempted):
                break

        metrics.register_preemption_attempts()

        if preemptor.init_resreq.less_equal(preempted):
            try:
                stmt.pipeline(preemptor, node.name)
            except Exception:
                # Pipeline errors are corrected next cycle (preempt.go:234).
                logger.exception(
                    "Failed to pipeline Task <%s/%s> on <%s>",
                    preemptor.namespace, preemptor.name, node.name,
                )
            assigned = True
            break

    return assigned


class PreemptAction(Action):
    def name(self) -> str:
        return "preempt"

    def execute(self, ssn) -> None:
        preemptors_map = {}
        preemptor_tasks = {}
        under_request = []
        queues = {}

        for job in ssn.jobs.values():
            queue = ssn.queues.get(job.queue)
            if queue is None:
                continue
            queues.setdefault(queue.uid, queue)
            if job.task_status_index.get(TaskStatus.PENDING):
                if job.queue not in preemptors_map:
                    preemptors_map[job.queue] = PriorityQueue(ssn.job_order_fn)
                preemptors_map[job.queue].push(job)
                under_request.append(job)
                preemptor_tasks[job.uid] = PriorityQueue(ssn.task_order_fn)
                for task in job.task_status_index[TaskStatus.PENDING].values():
                    preemptor_tasks[job.uid].push(task)

        memo = FeasibilityMemo(ssn)

        # Phase 1: preemption between jobs within a queue (preempt.go:76-135).
        for queue in queues.values():
            while True:
                preemptors = preemptors_map.get(queue.uid)
                if preemptors is None or preemptors.empty():
                    break
                preemptor_job = preemptors.pop()

                stmt = ssn.statement()
                assigned = False
                stats = {"victims": 0}
                while True:
                    if preemptor_tasks[preemptor_job.uid].empty():
                        break
                    preemptor = preemptor_tasks[preemptor_job.uid].pop()

                    def filter_fn(task, _job=preemptor_job, _preemptor=preemptor):
                        if task.status != TaskStatus.RUNNING:
                            return False
                        job = ssn.jobs.get(task.job)
                        if job is None:
                            return False
                        return (
                            job.queue == _job.queue and _preemptor.job != task.job
                        )

                    if _preempt(ssn, stmt, preemptor, ssn.nodes,
                                filter_fn, memo=memo, stats=stats):
                        assigned = True
                    if ssn.job_pipelined(preemptor_job):
                        stmt.commit()
                        break

                placed = ssn.job_pipelined(preemptor_job)
                # Victim-selection outcome for the claimant's next
                # unschedulable verdict (obs/explain): how many victims
                # this attempt selected and whether the gang actually
                # got pipelined (a discard rolls the evictions back).
                explain.note_victim_outcome(
                    preemptor_job.uid, "preempt", stats["victims"], placed
                )
                if not placed:
                    stmt.discard()
                    continue
                if assigned:
                    preemptors.push(preemptor_job)

        # Phase 2: preemption between tasks within a job, ONCE after every
        # queue's phase 1 (preempt.go:137-167 — this loop sits outside the
        # queue loop in the reference; running it per queue would let
        # intra-job preemption act on later queues' jobs before their own
        # inter-job phase).
        for job in under_request:
            while True:
                tasks = preemptor_tasks.get(job.uid)
                if tasks is None or tasks.empty():
                    break
                preemptor = tasks.pop()
                stmt = ssn.statement()
                assigned = _preempt(
                    ssn,
                    stmt,
                    preemptor,
                    ssn.nodes,
                    lambda task, _p=preemptor: (
                        task.status == TaskStatus.RUNNING
                        and _p.job == task.job
                    ),
                    memo=memo,
                )
                stmt.commit()
                if not assigned:
                    break


register_action(PreemptAction())
