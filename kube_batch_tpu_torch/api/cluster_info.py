"""ClusterInfo: the per-cycle snapshot type.

Mirrors reference pkg/scheduler/api/cluster_info.go:21-26.
"""

from __future__ import annotations

from typing import Dict

from .job_info import JobID, JobInfo
from .node_info import NodeInfo
from .queue_info import QueueID, QueueInfo


class ClusterInfo:
    """A snapshot of cluster state used by one scheduling Session."""

    def __init__(self):
        self.jobs: Dict[JobID, JobInfo] = {}
        self.nodes: Dict[str, NodeInfo] = {}
        self.queues: Dict[QueueID, QueueInfo] = {}
        # Names of jobs/nodes the cache mirror touched since the
        # PREVIOUS snapshot (stamped by the watch/bind event handlers,
        # drained by SchedulerCache.snapshot). Observability for the
        # incremental tensorize path: the authoritative row-level
        # dirtiness is the clone fingerprints (a session can mutate its
        # clones after snapshot time), but these sets attribute WHERE
        # churn came from and size the expected patch work.
        self.dirty_jobs: frozenset = frozenset()
        self.dirty_nodes: frozenset = frozenset()
        # NARROW subsets (disjoint from the full sets above): names
        # whose only mutations were the scheduler's own bind
        # bookkeeping — known allocation deltas. The delta-aware
        # tensorize patches exactly those columns (idle + task count)
        # instead of treating the row as arbitrarily dirty.
        self.dirty_jobs_narrow: frozenset = frozenset()
        self.dirty_nodes_narrow: frozenset = frozenset()
        # Monotone snapshot generation (SchedulerCache._snap_gen) — the
        # warm-solve continuity token — and the cache-maintained sum of
        # ready-node allocatables (None when the cache predates it).
        self.snap_gen: int = 0
        self.total_allocatable = None

    def __repr__(self) -> str:
        return (
            f"ClusterInfo(jobs={len(self.jobs)}, nodes={len(self.nodes)}, "
            f"queues={len(self.queues)})"
        )
