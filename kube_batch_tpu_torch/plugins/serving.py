"""Serving plugin: SLO/node-class compilation and the eviction gate.

tpu-batch extension (no reference counterpart; doc/design/serving.md).
Three jobs:

- compile each serving job's node-class constraints (TPU-generation
  whitelist, minimum ICI topology tier, spot exclusion — api/serving.py
  ``ServingSLO``) into feasibility-mask group rows for the solver, with
  a scalar predicate mirror for the host-side paths;
- score nodes for serving tasks (reserved-first, spot-penalty,
  topology-tier preference) as sparse solver score rows;
- gate preempt/reclaim victim selection so batch backfill can never
  evict a serving pod below its replica floor or past its
  SLO-violation budget (``KBT_SERVING_PREEMPT_OVERRIDE=1`` disables
  the gate for operator break-glass).

Bit-parity contract: with zero serving tasks in the snapshot, the
batch predicate returns an all-default ``BatchMask()`` and the scorer
returns no rows — solver/masks.py folds both in as nothing, so
batch-only mixes produce inputs (and placements) identical to a build
without this plugin (tests/sim/test_serving_sim.py pins this).

The eviction gate honours the reclaim memo contract
(framework/session.py add_reclaimable_fn): verdicts read only the
victim job's SLO spec, its ``ready_task_num()`` and its cumulative
ledger counters — claimant-independent, and eviction-monotone because
evictions only ever lower ``ready_task_num()``.
"""

from __future__ import annotations

import os

from ..api import slo_permits_node
from ..framework import Plugin, register_plugin_builder
from ..obs.latency import LEDGER
from ..solver.masks import BatchMask
from .util import PredicateError

MAX_PRIORITY = 10.0

# Break-glass: disable the serving eviction gate entirely (replica
# floors and violation budgets stop protecting serving victims).
PREEMPT_OVERRIDE_ENV = "KBT_SERVING_PREEMPT_OVERRIDE"

# Topology tiers at or above this score as full preference; the scale
# only needs to rank tiers, not measure them.
_TIER_CAP = 4


def _job_slo(ssn, task):
    job = ssn.jobs.get(task.job)
    return getattr(job, "slo", None)


def node_class_score(node_class) -> float:
    """0..10 preference for placing an SLO-targeted task on a node of
    ``node_class``: reserved capacity is worth half the scale (spot
    reclamation forces a re-placement that burns the latency budget),
    the rest rewards topology tier (higher ICI tier = tighter
    collective latency for the serving replicas)."""
    score = 0.0 if node_class.spot else MAX_PRIORITY / 2.0
    tier = min(node_class.topology_tier, _TIER_CAP)
    score += (MAX_PRIORITY / 2.0) * tier / _TIER_CAP
    return score


class ServingPlugin(Plugin):
    def __init__(self, arguments=None):
        self.arguments = arguments or {}

    def name(self) -> str:
        return "serving"

    def on_session_open(self, ssn) -> None:
        import numpy as np

        # ----------------------------------------------- feasibility
        def predicate_fn(task, node) -> None:
            slo = _job_slo(ssn, task)
            if slo is None or not slo.constrains_nodes():
                return
            if not slo_permits_node(slo, node.node_class):
                raise PredicateError(
                    f"node {node.name} class {node.node_class} "
                    f"violates serving constraints of job {task.job}"
                )

        ssn.add_predicate_fn(self.name(), predicate_fn)

        def batch_serving_feasible(tasks, nodes):
            """Group rows keyed by constraint signature: jobs sharing
            an SLO spec (the common case — replicas of one deployment,
            or many deployments with one profile) share one [N] row."""
            N = len(nodes)
            task_group = None
            group_rows = []
            sig_to_group = {}
            for i, task in enumerate(tasks):
                slo = _job_slo(ssn, task)
                if slo is None or not slo.constrains_nodes():
                    continue
                if task_group is None:
                    task_group = np.zeros(len(tasks), dtype=np.int32)
                    group_rows.append(np.ones(N, dtype=bool))  # unconstrained
                g = sig_to_group.get(slo)
                if g is None:
                    row = np.fromiter(
                        (
                            slo_permits_node(slo, node.node_class)
                            for node in nodes
                        ),
                        dtype=bool,
                        count=N,
                    )
                    group_rows.append(row)
                    g = len(group_rows) - 1
                    sig_to_group[slo] = g
                task_group[i] = g
            if task_group is None:
                return BatchMask()
            return BatchMask(
                task_group=task_group, group_rows=np.stack(group_rows)
            )

        ssn.add_batch_predicate_fn(self.name(), batch_serving_feasible)

        # ----------------------------------------------------- scoring
        def node_order_fn(task, node) -> float:
            if _job_slo(ssn, task) is None:
                return 0.0
            return node_class_score(node.node_class)

        ssn.add_node_order_fn(self.name(), node_order_fn)

        def batch_serving_scores(tasks, nodes):
            """Sparse rows: only serving tasks contribute. All serving
            tasks share one per-node class-preference row (the score
            depends only on the node's class), so the row is computed
            once per snapshot."""
            rows = {}
            shared = None
            for i, task in enumerate(tasks):
                if _job_slo(ssn, task) is None:
                    continue
                if shared is None:
                    shared = np.fromiter(
                        (
                            node_class_score(node.node_class)
                            for node in nodes
                        ),
                        dtype=np.float32,
                        count=len(nodes),
                    )
                rows[i] = shared
            return rows

        ssn.add_batch_node_order_fn(self.name(), batch_serving_scores)

        # ----------------------------------------- eviction gate
        override = os.environ.get(PREEMPT_OVERRIDE_ENV, "0") == "1"

        def evictable_fn(evictor, evictees):
            if override:
                return list(evictees)
            victims = []
            for evictee in evictees:
                job = ssn.jobs.get(evictee.job)
                slo = getattr(job, "slo", None)
                if slo is None:
                    victims.append(evictee)
                    continue
                if (
                    slo.replica_floor > 0
                    and job.ready_task_num() - 1 < slo.replica_floor
                ):
                    continue  # would breach the replica floor
                if not LEDGER.serving_budget_ok(evictee.job):
                    continue  # re-placement would blow the SLO budget
                victims.append(evictee)
            return victims

        ssn.add_reclaimable_fn(self.name(), evictable_fn)
        ssn.add_preemptable_fn(self.name(), evictable_fn)


register_plugin_builder("serving", lambda args: ServingPlugin(args))
