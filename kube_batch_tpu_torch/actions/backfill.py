"""Backfill action (reference actions/backfill/backfill.go:40-73): every
pending BestEffort task (empty resource request) goes to the first node
that passes predicates.

The reference leaves non-zero-request backfill and queue balancing as
TODOs (backfill.go:44, :67-69). tpu-batch implements both as the OPT-IN
``backfill_extended`` action (select it in the policy's ``actions``
list; plain ``backfill`` keeps strict reference parity): resourced
pending tasks — including those held back only by their queue's
deserved-share budget — may fill capacity nothing else can use.

Safety argument (the this-cycle guarantee): backfill runs AFTER
allocate, which runs to a fixed point — every task allocate WANTED to
place and could fit is placed. What remains pending yet placeable is
exactly what allocate's own shortcuts strand: chiefly members behind a
broken head-of-line task ("tasks are priority-ordered: if one fails,
the rest would too", allocate.go:144-148 — an assumption mixed-size
jobs violate), and tasks of overused queues. Consuming residual idle
for them cannot steal a this-cycle placement from anyone: a task that
did not fit node idle before a backfill still does not fit after idle
shrinks.

Letting an overused queue exceed its deserved share here is deliberate
use-it-or-lose-it balancing; the share is only borrowed — the moment
the deserving queue's demand becomes placeable, reclaim evicts down to
gang minAvailable floors (reclaim-action.md). Operators should prefer
elastic jobs (minMember < replicas) for backfill workloads, since
reclaim never breaches a gang's own floor.
"""

from __future__ import annotations

import logging

from ..api import TaskStatus
from ..framework import Action, register_action
from ..utils.scheduler_helper import FeasibilityMemo, get_node_list

logger = logging.getLogger(__name__)


class BackfillAction(Action):
    def __init__(self, extended: bool = False):
        self.extended = extended

    def name(self) -> str:
        return "backfill_extended" if self.extended else "backfill"

    def execute(self, ssn) -> None:
        # Cycle-scoped spec-keyed feasibility cache for the resourced
        # path (same throughput reasoning as reclaim's: a saturated
        # cluster can hold thousands of unplaceable pending tasks, and
        # they must not each pay a full predicate pass per cycle).
        memo = FeasibilityMemo(ssn) if self.extended else None
        for job in ssn.jobs.values():
            for task in list(
                job.task_status_index.get(TaskStatus.PENDING, {}).values()
            ):
                if not task.init_resreq.is_empty():
                    if self.extended:
                        self._backfill_resourced(ssn, task, memo)
                    # else reference parity: backfill only places tasks
                    # with an EMPTY resource request (BestEffort),
                    # backfill.go:45-49.
                    continue
                for node in get_node_list(ssn.nodes):
                    try:
                        ssn.predicate_fn(task, node)
                    except Exception:
                        continue
                    try:
                        ssn.allocate(task, node.name)
                    except Exception:
                        logger.exception(
                            "Failed to bind Task %s on %s", task.uid, node.name
                        )
                        continue
                    break

    @staticmethod
    def _backfill_resourced(ssn, task, memo: FeasibilityMemo) -> None:
        """Place one resourced pending task onto residual idle (see the
        module docstring's safety argument). First fit; gang gating
        still applies through ssn.allocate, so members of gangs that
        cannot reach minMember this cycle are held at the session layer
        and never dispatch."""
        for node in memo.feasible(task):
            if not task.init_resreq.less_equal(node.idle):
                continue
            try:
                ssn.allocate(task, node.name)
            except Exception:
                logger.exception(
                    "Failed to backfill Task %s on %s", task.uid, node.name
                )
                continue
            return


register_action(BackfillAction())
register_action(BackfillAction(extended=True))
