"""Session: the per-cycle world view and decision surface.

Mirrors reference framework/session.go (:37 struct, :63 openSession,
:119 closeSession, :146 jobStatus, :194 Pipeline, :237 Allocate,
:294 dispatch, :321 Evict, :361 UpdateJobCondition) and
framework/session_plugins.go (tiered combinator dispatch).

The Session holds a deep-cloned snapshot; Allocate/Pipeline/Evict mutate the
snapshot and fire plugin event handlers; gang dispatch happens the moment a
job becomes Ready (session.go:281-289). This object is also what gets
vectorized into the dense tensor snapshot for the TPU solver (ops.snapshot).
"""

from __future__ import annotations

import logging
import time as _time
import uuid as _uuid
from typing import Callable, Dict, List, Optional

from .. import metrics
from ..api import (
    POD_GROUP_CONDITION_UNSCHEDULABLE,
    JobInfo,
    NodeInfo,
    PodGroupCondition,
    PodGroupPhase,
    QueueInfo,
    Resource,
    TaskInfo,
    TaskStatus,
    ValidateResult,
    allocated_status,
)
from ..conf import Tier
from .event import Event, EventHandler, JobBatchEvent

logger = logging.getLogger(__name__)

# Sub-phase wall times of the most recent allocate_batch (bench/perf
# forensics; the allocate_tpu action folds these into its last_stats).
last_apply_stats: dict = {}


def _move_tasks_logged(job, tasks, status, resreq_delta=None):
    """Bulk status move with the sequential loop's failure semantics: a
    group-level error degrades to per-task moves where each failure is
    logged and skipped instead of aborting the job's whole group.
    ``resreq_delta``, when given, is the exact aggregate resreq sum of
    ``tasks`` — the bulk path then updates ``job.allocated`` with ONE
    Resource op instead of one per task."""
    try:
        job.update_tasks_status(tasks, status, resreq_delta=resreq_delta)
    except Exception:
        for task in tasks:
            try:
                job.update_task_status(task, status)
            except Exception:
                logger.exception(
                    "Failed to move Task %s to %s", task.uid, status
                )


def _fold_job_batches(jobs_map, tasks):
    """Per-job :class:`JobBatchEvent` aggregates from a flat placed-task
    list (the slow path when no precomputed grouping hint is usable).
    Tasks whose job is unknown are logged and skipped."""
    by_job: Dict[str, JobBatchEvent] = {}
    for task in tasks:
        batch = by_job.get(task.job)
        if batch is None:
            job = jobs_map.get(task.job)
            if job is None:
                logger.warning(
                    "failed to find job %s for batch handlers", task.job
                )
                continue
            batch = by_job[task.job] = JobBatchEvent(
                job, [], Resource.empty()
            )
        batch.tasks.append(task)
        batch.delta.add(task.resreq)
    return list(by_job.values())


class Session:
    def __init__(
        self, cache, tiers: Optional[List[Tier]] = None,
        micro: bool = False, device=None,
    ):
        self.uid = str(_uuid.uuid4())
        self.cache = cache
        # The opening scheduler's device: allocate_tpu solves on it
        # (None: the action's own).
        self.device = device
        # Micro sessions tell the cache snapshot up front (the
        # ledger-verified fast path runs inside _open's snapshot call,
        # before run_micro could set the legacy micro_cycle attribute).
        self._micro = micro
        # Clone-touch ledger: uids/names of snapshot clones whose _ver
        # this session bumps (allocate/pipeline/evict/dispatch and
        # Statement ops). Reported to the cache at close so the next
        # micro snapshot's ledger verification rechecks exactly these
        # positions (cache.note_clones_touched).
        self._touched_jobs: set = set()
        self._touched_nodes: set = set()
        self.jobs: Dict[str, JobInfo] = {}
        self.nodes: Dict[str, NodeInfo] = {}
        self.queues: Dict[str, QueueInfo] = {}
        self.backlog: List[JobInfo] = []
        self.tiers: List[Tier] = tiers or []
        # Churn ledger from the cache snapshot (names touched since the
        # previous snapshot) — observability for incremental tensorize,
        # and (with the narrow subsets + generation) the warm-start
        # plan's delta preconditions (solver/warm.py).
        self.dirty_jobs: frozenset = frozenset()
        self.dirty_nodes: frozenset = frozenset()
        self.dirty_jobs_narrow: frozenset = frozenset()
        self.dirty_nodes_narrow: frozenset = frozenset()
        self.snap_gen: int = 0
        self._snap_total_allocatable = None
        # Event-driven micro cycle flag (Scheduler.run_micro): actions
        # place only through the warm path when set.
        self.micro_cycle = micro
        # The allocate_tpu AsyncSolveHandle currently in flight, if any
        # (drain guard: Statement boundaries and session close block on
        # it so no transaction or teardown races an outstanding solve).
        self._inflight_solve = None
        # Jobs whose conditions this session rewrote (update_job_condition)
        # — their close-time status write-back can never take the
        # unchanged-fingerprint skip.
        self._conditioned_jobs: set = set()

        self._total_allocatable: Optional[Resource] = None
        self.plugins: Dict[str, object] = {}
        self.event_handlers: List[EventHandler] = []
        self.job_order_fns: Dict[str, Callable] = {}
        self.queue_order_fns: Dict[str, Callable] = {}
        self.task_order_fns: Dict[str, Callable] = {}
        self.predicate_fns: Dict[str, Callable] = {}
        self.batch_predicate_fns: Dict[str, Callable] = {}
        self.batch_task_order_key_fns: Dict[str, Callable] = {}
        self.batch_job_order_key_fns: Dict[str, Callable] = {}
        self.preemptable_fns: Dict[str, Callable] = {}
        self.reclaimable_fns: Dict[str, Callable] = {}
        self.overused_fns: Dict[str, Callable] = {}
        self.job_ready_fns: Dict[str, Callable] = {}
        self.job_pipelined_fns: Dict[str, Callable] = {}
        self.job_valid_fns: Dict[str, Callable] = {}
        self.node_order_fns: Dict[str, List] = {}
        # TPU-solver seams: batched [T, N] score builders, per-queue budget
        # vectors, and weights for the scorers the kernel recomputes per
        # round (consumed by solver/snapshot.py).
        self.batch_node_order_fns: Dict[str, List] = {}
        self.queue_budget_fns: Dict[str, Callable] = {}
        # plugin name -> {scorer key -> weight} for in-kernel scorers
        self.solver_score_weights: Dict[str, Dict[str, float]] = {}

    # ------------------------------------------------------------------ open

    def _open(self) -> None:
        """reference session.go:63-117"""
        from ..obs import span

        with span("snapshot"):
            snapshot = self.cache.snapshot(micro=self._micro)
        self.jobs = snapshot.jobs
        self.nodes = snapshot.nodes
        self.queues = snapshot.queues
        self.dirty_jobs = getattr(snapshot, "dirty_jobs", frozenset())
        self.dirty_nodes = getattr(snapshot, "dirty_nodes", frozenset())
        self.dirty_jobs_narrow = getattr(
            snapshot, "dirty_jobs_narrow", frozenset()
        )
        self.dirty_nodes_narrow = getattr(
            snapshot, "dirty_nodes_narrow", frozenset()
        )
        self.snap_gen = getattr(snapshot, "snap_gen", 0)
        self._snap_total_allocatable = getattr(
            snapshot, "total_allocatable", None
        )

    def _validate_jobs(self) -> None:
        """Drop invalid jobs, persisting an Unschedulable condition
        (reference session.go:89-108). Called after plugins are opened so
        JobValid callbacks are installed."""
        for job in list(self.jobs.values()):
            # Fingerprint memo: a job that passed validation last cycle
            # and has not been mutated since passes again (JobValid
            # callbacks are pure functions of job state). Only PASSING
            # verdicts are memoized — invalid jobs re-run the full path
            # (condition write-back carries this session's transition
            # id). The attr lives on the clone, which the COW pool only
            # reuses while untouched, so a fresh clone self-invalidates.
            if getattr(job, "_valid_ok_ver", None) == job._ver:
                continue
            vr = self.job_valid(job)
            if vr is None or vr.passed:
                job._valid_ok_ver = job._ver
            if vr is not None and not vr.passed:
                cond = PodGroupCondition(
                    type=POD_GROUP_CONDITION_UNSCHEDULABLE,
                    status="True",
                    transition_id=self.uid,
                    reason=vr.reason,
                    message=vr.message,
                )
                try:
                    self.update_job_condition(job, cond)
                except KeyError:
                    logger.exception("failed to update job condition")
                del self.jobs[job.uid]

    def _close(self) -> None:
        """reference session.go:119-144"""
        if self._touched_jobs or self._touched_nodes:
            self.cache.note_clones_touched(
                self._touched_jobs, self._touched_nodes
            )
            self._touched_jobs = set()
            self._touched_nodes = set()
        conditioned = self._conditioned_jobs
        for job in self.jobs.values():
            if job.pod_group is None:
                self.cache.record_job_status_event(job)
                continue
            # Status write-back memo: an untouched job's recomputed
            # PodGroup status is identical to what the last close wrote
            # (status is a pure function of the task-status index, and
            # the unschedulable-condition term only fires for jobs
            # conditioned THIS session — tracked separately). The attr
            # lives on the clone; any mutation re-clones or bumps _ver.
            if (
                getattr(job, "_status_synced_ver", None) == job._ver
                and job.uid not in conditioned
                # An UNKNOWN phase decays once its condition's session
                # passes (the transition-id term) — never memoized.
                and job.pod_group.status.phase != PodGroupPhase.UNKNOWN
            ):
                continue
            job.pod_group.status = self._job_status(job)
            try:
                self.cache.update_job_status(job)
                job._status_synced_ver = job._ver
            except Exception:
                logger.exception(
                    "failed to update job <%s/%s>", job.namespace, job.name
                )
        self.jobs = {}
        self.nodes = {}
        self.backlog = []
        self._total_allocatable = None
        self.plugins = {}
        self.event_handlers = []
        self.job_order_fns = {}
        self.queue_order_fns = {}
        self.task_order_fns = {}
        self.predicate_fns = {}
        self.batch_predicate_fns = {}
        self.batch_task_order_key_fns = {}
        self.batch_job_order_key_fns = {}
        self.preemptable_fns = {}
        self.reclaimable_fns = {}
        self.overused_fns = {}
        self.job_ready_fns = {}
        self.job_pipelined_fns = {}
        self.job_valid_fns = {}
        self.node_order_fns = {}
        self.batch_node_order_fns = {}
        self.queue_budget_fns = {}
        self.solver_score_weights = {}

    def _job_status(self, job: JobInfo):
        """Recompute PodGroup status (reference session.go:146-184)."""
        status = job.pod_group.status
        unschedulable = any(
            c.type == POD_GROUP_CONDITION_UNSCHEDULABLE
            and c.status == "True"
            and c.transition_id == self.uid
            for c in status.conditions
        )
        if job.task_status_index.get(TaskStatus.RUNNING) and unschedulable:
            status.phase = PodGroupPhase.UNKNOWN
        else:
            allocated = sum(
                len(tasks)
                for st, tasks in job.task_status_index.items()
                if allocated_status(st)
            )
            if allocated >= job.pod_group.spec.min_member:
                status.phase = PodGroupPhase.RUNNING
            else:
                status.phase = PodGroupPhase.PENDING
        status.running = len(job.task_status_index.get(TaskStatus.RUNNING, {}))
        status.failed = len(job.task_status_index.get(TaskStatus.FAILED, {}))
        status.succeeded = len(job.task_status_index.get(TaskStatus.SUCCEEDED, {}))
        return status

    # ------------------------------------------------------- state mutation

    def statement(self) -> "Statement":
        from .statement import Statement

        return Statement(self)

    # ------------------------------------------- async-solve drain guard

    def register_inflight_solve(self, handle) -> None:
        """Track (or clear, with None) the action's in-flight async
        solve. While registered, any Statement commit/discard and the
        session close DRAIN the solve first — the overlapped cycle can
        never leak an outstanding device computation across a
        transaction boundary or session teardown."""
        self._inflight_solve = handle

    def drain_inflight_solve(self) -> None:
        """Block until any registered async solve is out of flight
        (no-op in the common already-fetched case)."""
        handle = self._inflight_solve
        if handle is not None:
            handle.drain()
            self._inflight_solve = None

    def total_node_allocatable(self) -> Resource:
        """Sum of ``allocatable`` over ALL session nodes (ready or not),
        computed once per session and shared — drf and proportion each
        paid their own O(nodes) accumulation pass at session open.
        Returns a fresh clone per call; callers own the result."""
        total = self._total_allocatable
        if total is None:
            # The cache maintains this sum across snapshots (O(churn)
            # adjustments in the pool walk); only a pre-maintenance
            # snapshot pays the O(nodes) accumulation here.
            total = self._snap_total_allocatable
            if total is None:
                total = Resource.empty()
                for node in self.nodes.values():
                    total.add(node.allocatable)
            self._total_allocatable = total
        return total.clone()

    def pipeline(self, task: TaskInfo, hostname: str) -> None:
        """Place onto releasing resources, session-only (session.go:194-234)."""
        job = self.jobs.get(task.job)
        if job is None:
            raise KeyError(f"failed to find job {task.job} when pipelining")
        job.update_task_status(task, TaskStatus.PIPELINED)
        self._touched_jobs.add(task.job)
        task.node_name = hostname
        node = self.nodes.get(hostname)
        if node is None:
            raise KeyError(f"failed to find node {hostname}")
        node.add_task(task)
        self._touched_nodes.add(hostname)
        for eh in self.event_handlers:
            if eh.allocate_func is not None:
                eh.allocate_func(Event(task))

    def allocate(self, task: TaskInfo, hostname: str) -> None:
        """Allocate in-session; dispatch the whole gang once JobReady
        (reference session.go:237-292)."""
        self.cache.allocate_volumes(task, hostname)
        job = self.jobs.get(task.job)
        if job is None:
            raise KeyError(f"failed to find job {task.job}")
        job.update_task_status(task, TaskStatus.ALLOCATED)
        self._touched_jobs.add(task.job)
        task.node_name = hostname
        node = self.nodes.get(hostname)
        if node is None:
            raise KeyError(f"failed to find node {hostname}")
        node.add_task(task)
        self._touched_nodes.add(hostname)
        for eh in self.event_handlers:
            if eh.allocate_func is not None:
                eh.allocate_func(Event(task))
        if self.job_ready(job):
            # Copy: dispatch mutates the Allocated index while we iterate.
            for t in list(
                job.task_status_index.get(TaskStatus.ALLOCATED, {}).values()
            ):
                self.dispatch(t)

    def allocate_batch(self, pairs) -> int:
        """Apply a solved assignment set in one pass: the batched
        equivalent of calling :meth:`allocate` per task, for the
        allocate_tpu apply phase (50k sequential allocate() calls
        dominated the reference's cycle).

        ``pairs`` is ``[(task, hostname), ...]`` in global priority order.
        Semantics preserved vs the sequential loop:

        - per-task volume assumption and node/job bookkeeping, in order;
        - plugin event handlers observe every allocation (batched form
          when the handler provides one, per-event otherwise);
        - gang dispatch: a job whose allocations make it JobReady has ALL
          its Allocated tasks dispatched (sequentially this happens the
          moment the gang crosses minAvailable and then after each later
          allocate — the end state, every Allocated task of a ready job
          dispatched, is identical);
        - per-task failures are logged and skipped, not fatal.

        Returns the number of tasks allocated.

        Thin wrapper: groups the pairs per hostname and delegates to
        :meth:`allocate_batch_grouped` (one implementation of the apply
        tail — events, handlers, gang dispatch — not two to keep in
        sync). allocate_tpu builds the groups itself from the solver's
        arrays and calls the grouped form directly."""
        staged: Dict[str, list] = {}  # hostname -> [tasks]
        for task, hostname in pairs:
            group = staged.get(hostname)
            if group is None:
                group = staged[hostname] = []
            group.append(task)
        return self.allocate_batch_grouped(
            [(hostname, tasks, None) for hostname, tasks in staged.items()]
        )

    def allocate_batch_grouped(self, node_groups, job_groups=None) -> int:
        """Apply a solved assignment set from PRE-GROUPED per-node lists
        — the zero-regroup fast path for allocate_tpu, whose fit guard
        already computed the per-node segmentation with numpy.

        ``node_groups`` is ``[(hostname, [tasks], delta)]`` where
        ``delta`` is the group's precomputed aggregate resreq (or None);
        tasks carry no node_name yet. ``job_groups``, when given, is the
        same assignment set PRE-GROUPED per job —
        ``[(job_uid, [tasks], delta)]`` with ``delta`` the exact
        aggregate resreq sum — so the apply tail skips the 50k per-task
        regroup pass, the per-task ``job.allocated`` arithmetic, AND the
        per-task plugin handler calls (aggregate JobBatchEvents go to
        ``batch_allocate_func`` handlers instead). The hint is trusted
        only while staging places every hinted task; any volume failure,
        vanished node/job, or node-accounting fallback drops back to the
        per-task fold so handler state can never drift from placements.

        Semantics are :meth:`allocate_batch`'s (volumes, status moves,
        node accounting, plugin events, gang dispatch); only the staging
        differs. Returns the number of tasks allocated."""
        last_apply_stats.clear()
        t0 = _time.perf_counter()
        hint_ok = job_groups is not None
        staged_total = 0
        alloc_groups: List[tuple] = []  # (hostname, node, [tasks], delta)
        for hostname, tasks, delta in node_groups:
            node = self.nodes.get(hostname)
            if node is None:
                logger.warning("failed to find node %s", hostname)
                hint_ok = False
                continue
            ok = self.cache.allocate_volumes_batch(
                tasks, hostname, assign_node_name=True
            )
            staged_total += len(ok)
            if len(ok) != len(tasks):
                hint_ok = False
            if ok:
                self._touched_nodes.add(hostname)
            alloc_groups.append((
                hostname, node, ok, delta if len(ok) == len(tasks) else None
            ))
        if hint_ok:
            hint_ok = staged_total == sum(
                len(group) for _, group, _ in job_groups
            ) and all(self.jobs.get(uid) is not None
                      for uid, _, _ in job_groups)
        # Per-job ALLOCATED moves: from the hint when valid (one
        # aggregate Resource op per job), else grouped with one
        # argsort-free pass (tasks of one job may span many nodes).
        jobs_by_uid: Dict[str, JobInfo] = {}
        job_batches: Optional[List[JobBatchEvent]] = None
        if hint_ok:
            job_batches = []
            for uid, group, delta in job_groups:
                job = self.jobs[uid]
                jobs_by_uid[uid] = job
                self._touched_jobs.add(uid)
                # Whole-bucket fast path: the solver's tasks ARE the
                # job's stored PENDING tasks (tensorize hands it the
                # bucket values), so a group covering the whole bucket
                # moves the bucket dict itself — no per-task
                # verification or re-insert (spot-checked on the first
                # task so a caller passing clones degrades safely).
                bucket = job.task_status_index.get(TaskStatus.PENDING)
                if (
                    bucket is not None
                    and len(bucket) == len(group)
                    and bucket.get(group[0].uid) is group[0]
                ):
                    try:
                        job.move_status_bucket(
                            TaskStatus.PENDING,
                            TaskStatus.ALLOCATED,
                            resreq_delta=delta,
                        )
                    except Exception:
                        logger.exception(
                            "bucket move failed for job %s; retrying "
                            "per task", uid,
                        )
                        _move_tasks_logged(
                            job, group, TaskStatus.ALLOCATED,
                            resreq_delta=delta,
                        )
                else:
                    _move_tasks_logged(
                        job, group, TaskStatus.ALLOCATED, resreq_delta=delta
                    )
                job_batches.append(JobBatchEvent(job, group, delta))
        else:
            by_job: Dict[str, list] = {}
            for _, _, tasks, _ in alloc_groups:
                for task in tasks:
                    group = by_job.get(task.job)
                    if group is None:
                        group = by_job[task.job] = []
                    group.append(task)
            for uid, group in by_job.items():
                job = self.jobs.get(uid)
                if job is None:
                    logger.warning("failed to find job %s", uid)
                    continue
                jobs_by_uid[uid] = job
                self._touched_jobs.add(uid)
                _move_tasks_logged(job, group, TaskStatus.ALLOCATED)
        t1 = _time.perf_counter()
        last_apply_stats["stage_ms"] = (t1 - t0) * 1e3

        placed_all: List[TaskInfo] = []
        for hostname, node, tasks, delta in alloc_groups:
            if delta is not None:
                try:
                    node.add_tasks_prevalidated(tasks, delta)
                    placed_all.extend(tasks)
                    continue
                except Exception:
                    logger.exception(
                        "prevalidated group rejected by node %s; "
                        "falling back to guarded add", hostname,
                    )
            placed_list = node.add_tasks_with_fallback(tasks)
            if len(placed_list) != len(tasks):
                job_batches = None  # hint no longer matches placements
            placed_all.extend(placed_list)
        t2 = _time.perf_counter()
        last_apply_stats["account_ms"] = (t2 - t1) * 1e3
        if not placed_all:
            return 0
        # Observability for the bench (BENCH attribution): aggregate
        # handler dispatch vs per-event, and whether the caller's
        # precomputed job grouping survived staging intact.
        last_apply_stats["handlers_batched"] = any(
            eh.batch_allocate_func is not None for eh in self.event_handlers
        )
        last_apply_stats["job_groups_hint"] = job_batches is not None
        self._fire_allocate_handlers(placed_all, job_batches)
        t3 = _time.perf_counter()
        last_apply_stats["handlers_ms"] = (t3 - t2) * 1e3

        dispatch_groups: List[tuple] = []
        for uid, job in jobs_by_uid.items():
            if self.job_ready(job):
                dispatch_groups.append((job, list(
                    job.task_status_index.get(
                        TaskStatus.ALLOCATED, {}
                    ).values()
                )))
        if dispatch_groups:
            self.dispatch_batch_grouped(dispatch_groups)
        last_apply_stats["dispatch_ms"] = (
            _time.perf_counter() - t3
        ) * 1e3
        return len(placed_all)

    def _fire_allocate_handlers(self, placed_all, job_batches) -> None:
        """Dispatch allocate events: aggregate JobBatchEvents to handlers
        with a batch form (folding them from ``placed_all`` when no valid
        pre-grouped hint survived staging), per-task Events to the rest."""
        batch_fns = [
            eh.batch_allocate_func
            for eh in self.event_handlers
            if eh.batch_allocate_func is not None
        ]
        legacy_fns = [
            eh.allocate_func
            for eh in self.event_handlers
            if eh.batch_allocate_func is None and eh.allocate_func is not None
        ]
        if batch_fns:
            if job_batches is None:
                job_batches = _fold_job_batches(self.jobs, placed_all)
            for fn in batch_fns:
                fn(job_batches)
        if legacy_fns:
            events = [Event(task) for task in placed_all]
            for fn in legacy_fns:
                for ev in events:
                    fn(ev)

    def dispatch_batch_grouped(self, groups) -> None:
        """Bind ready gangs from per-job groups: bulk BINDING moves per
        job (no regrouping pass), one batched metrics observe, one
        bind_batch submission."""
        all_ready: List[TaskInfo] = []
        for job, tasks in groups:
            # bind_volumes is a no-op for ready-volume tasks (the
            # overwhelming majority: claims-less pods) — scan first so
            # the common all-ready gang skips the per-task try/except.
            all_vols_ready = True
            for task in tasks:
                if not task.volume_ready:
                    all_vols_ready = False
                    break
            if all_vols_ready:
                ready = tasks
            else:
                ready = []
                for task in tasks:
                    if not task.volume_ready:
                        try:
                            self.cache.bind_volumes(task)
                        except Exception:
                            logger.exception(
                                "Failed to bind volumes of %s", task.uid
                            )
                            continue
                    ready.append(task)
            if not ready:
                continue
            # Whole-bucket fast path (see allocate_batch_grouped): a
            # ready gang's dispatch group IS its ALLOCATED bucket, so
            # move the bucket dict instead of re-verifying per task.
            # Allocated → Binding never flips allocated-status, so no
            # Resource math either way.
            bucket = job.task_status_index.get(TaskStatus.ALLOCATED)
            if (
                bucket is not None
                and len(bucket) == len(ready)
                and bucket.get(ready[0].uid) is ready[0]
            ):
                ready = job.move_status_bucket(
                    TaskStatus.ALLOCATED, TaskStatus.BINDING
                )
            else:
                _move_tasks_logged(job, ready, TaskStatus.BINDING)
            self._touched_jobs.add(job.uid)
            all_ready.extend(ready)
        # Latency is measured creation → dispatch (reference
        # session.go:316), so capture `now` here; but observe only the
        # tasks whose cache bookkeeping ACCEPTED the bind (the callback
        # fires from the bookkeeping worker), so validation failures and
        # node-rejected reverts don't inflate scheduled counts.
        now = _time.time()
        self.cache.bind_batch(
            all_ready,
            on_accepted=lambda accepted: (
                metrics.update_task_schedule_durations([
                    max(0.0, now - t.pod.metadata.creation_timestamp)
                    for t in accepted
                ])
            ),
        )

    def dispatch(self, task: TaskInfo) -> None:
        """Bind one gang member (reference session.go:294-318)."""
        self.cache.bind_volumes(task)
        self.cache.bind(task, task.node_name)
        job = self.jobs.get(task.job)
        if job is None:
            raise KeyError(f"failed to find job {task.job}")
        job.update_task_status(task, TaskStatus.BINDING)
        self._touched_jobs.add(task.job)
        # Time from pod creation to bind (reference session.go:316).
        metrics.update_task_schedule_duration(
            max(0.0, _time.time() - task.pod.metadata.creation_timestamp)
        )

    def dispatch_batch(self, tasks: List[TaskInfo]) -> None:
        """Bind a whole ready gang with one cache round trip (one mutex
        hold, one async side-effect job) instead of per-task dispatch.
        Thin wrapper: groups per job and delegates to
        :meth:`dispatch_batch_grouped`."""
        by_job: Dict[str, list] = {}
        for task in tasks:
            group = by_job.get(task.job)
            if group is None:
                group = by_job[task.job] = []
            group.append(task)
        groups = []
        for uid, group in by_job.items():
            job = self.jobs.get(uid)
            if job is None:
                logger.warning("failed to find job %s", uid)
                continue
            groups.append((job, group))
        if groups:
            self.dispatch_batch_grouped(groups)

    def evict(self, reclaimee: TaskInfo, reason: str) -> None:
        """Direct eviction (reference session.go:321-358)."""
        self.cache.evict(reclaimee, reason)
        job = self.jobs.get(reclaimee.job)
        if job is None:
            raise KeyError(f"failed to find job {reclaimee.job}")
        job.update_task_status(reclaimee, TaskStatus.RELEASING)
        self._touched_jobs.add(reclaimee.job)
        node = self.nodes.get(reclaimee.node_name)
        if node is not None:
            node.update_task(reclaimee)
            self._touched_nodes.add(reclaimee.node_name)
        for eh in self.event_handlers:
            if eh.deallocate_func is not None:
                eh.deallocate_func(Event(reclaimee))

    def evict_batch(
        self, reclaimees: List[TaskInfo], reason: str
    ) -> List[TaskInfo]:
        """Batched :meth:`evict`: cache side effects and node accounting
        keep their per-task semantics (each failure logged and skipped,
        not fatal — the degraded form of evict()'s raise), while the job
        status moves are bulked per job with one aggregate ``allocated``
        update, and plugin deallocate handlers fire ONCE with per-job
        :class:`JobBatchEvent` aggregates (per-event fallback for
        handlers without a batch form). Returns the tasks actually
        evicted (callers sum their resreqs to see what was freed)."""
        by_job: Dict[str, list] = {}
        for task in reclaimees:
            group = by_job.get(task.job)
            if group is None:
                group = by_job[task.job] = []
            group.append(task)
        batches: List[JobBatchEvent] = []
        for uid, group in by_job.items():
            job = self.jobs.get(uid)
            if job is None:
                logger.warning("failed to find job %s when evicting", uid)
                continue
            evicted: List[TaskInfo] = []
            delta = Resource.empty()
            for task in group:
                try:
                    self.cache.evict(task, reason)
                except Exception:
                    logger.exception("Failed to evict Task %s", task.uid)
                    continue
                evicted.append(task)
                delta.add(task.resreq)
            if not evicted:
                continue
            _move_tasks_logged(
                job, evicted, TaskStatus.RELEASING, resreq_delta=delta
            )
            self._touched_jobs.add(uid)
            for task in evicted:
                node = self.nodes.get(task.node_name)
                if node is not None:
                    node.update_task(task)
                    self._touched_nodes.add(task.node_name)
            batches.append(JobBatchEvent(job, evicted, delta))
        if not batches:
            return []
        legacy_events: Optional[List[Event]] = None
        for eh in self.event_handlers:
            if eh.batch_deallocate_func is not None:
                eh.batch_deallocate_func(batches)
            elif eh.deallocate_func is not None:
                if legacy_events is None:
                    legacy_events = [
                        Event(t) for b in batches for t in b.tasks
                    ]
                for ev in legacy_events:
                    eh.deallocate_func(ev)
        return [t for b in batches for t in b.tasks]

    def update_job_condition(self, job_info: JobInfo, cond: PodGroupCondition) -> None:
        """reference session.go:361-383"""
        job = self.jobs.get(job_info.uid)
        if job is None:
            raise KeyError(
                f"failed to find job <{job_info.namespace}/{job_info.name}>"
            )
        self._conditioned_jobs.add(job_info.uid)
        if job.pod_group is None:
            # Legacy PDB-sourced jobs have no PodGroup to carry conditions
            # (the reference would nil-deref here, session.go:368 — we log
            # instead; the diagnosis still reaches the user via events).
            logger.debug(
                "job <%s/%s> has no PodGroup; dropping condition %s",
                job.namespace, job.name, cond.type,
            )
            return
        for i, c in enumerate(job.pod_group.status.conditions):
            if c.type == cond.type:
                job.pod_group.status.conditions[i] = cond
                return
        job.pod_group.status.conditions.append(cond)

    def add_event_handler(self, eh: EventHandler) -> None:
        self.event_handlers.append(eh)

    # ------------------------------------------- callback registration API

    def add_job_order_fn(self, name, fn):
        self.job_order_fns[name] = fn

    def add_queue_order_fn(self, name, fn):
        self.queue_order_fns[name] = fn

    def add_task_order_fn(self, name, fn):
        self.task_order_fns[name] = fn

    def add_predicate_fn(self, name, fn):
        self.predicate_fns[name] = fn

    def add_batch_predicate_fn(self, name, fn):
        """TPU-native extension: vectorized predicate producing a
        solver BatchMask (or legacy [T,N] bool array) for a whole task
        batch at once (consumed by solver.snapshot)."""
        self.batch_predicate_fns[name] = fn

    def add_batch_task_order_key_fn(self, name, fn):
        """TPU-native extension: (tasks) -> ascending sort-key array
        equivalent to the plugin's task_order_fn, enabling vectorized
        task ordering in the snapshot path."""
        self.batch_task_order_key_fns[name] = fn

    def add_batch_job_order_key_fn(self, name, fn):
        """TPU-native extension: (jobs) -> ascending sort-key array
        equivalent to the plugin's job_order_fn, enabling one numpy
        lexsort over a queue's jobs in the snapshot path instead of
        O(J log J) tiered comparison calls."""
        self.batch_job_order_key_fns[name] = fn

    def add_preemptable_fn(self, name, fn):
        self.preemptable_fns[name] = fn

    def add_reclaimable_fn(self, name, fn):
        """Register ``fn(reclaimer, reclaimees) -> victims``.

        Contract the in-tree reclaim action's per-queue exhausted-node
        memo depends on (actions/reclaim.py): within one cycle, a
        registered fn's verdict about a given reclaimee must be
        (a) CLAIMANT-INDEPENDENT — it may read the reclaimee's job/queue
        state but not compare against the reclaimer (proportion, gang
        and conformance all qualify; an upstream-style priority-vs-victim
        comparison would not) — and (b) EVICTION-MONOTONE — evictions
        performed during the cycle may only shrink (never grow) the
        victim set it would return for the same node, except through a
        successful claimant pipeline (which reclaim already handles by
        invalidating other queues' memos). The reclaim action detects
        fns outside the known-safe set and disables the memo for the
        cycle, so registering a fn that violates this contract costs
        throughput, not correctness — but keep the contract in mind
        when writing one."""
        self.reclaimable_fns[name] = fn

    def add_overused_fn(self, name, fn):
        self.overused_fns[name] = fn

    def add_job_ready_fn(self, name, fn):
        self.job_ready_fns[name] = fn

    def add_job_pipelined_fn(self, name, fn):
        self.job_pipelined_fns[name] = fn

    def add_job_valid_fn(self, name, fn):
        self.job_valid_fns[name] = fn

    def add_node_order_fn(self, name, fn, weight: float = 1.0):
        """Node scorers; (task, node) -> float, higher is better. The
        reference plumbs k8s PriorityConfigs (session_plugins.go:354-369);
        here scorers are plain weighted functions, and plugins may also
        attach a ``batch_fn`` via add_batch_node_order_fn for the TPU path."""
        self.node_order_fns.setdefault(name, []).append((fn, weight))

    def add_batch_node_order_fn(self, name, fn, weight: float = 1.0):
        """Batched scorer: (tasks, nodes) -> np.ndarray [T, N] of 0..10
        scores, summed (weighted) into the solver's static score matrix."""
        self.batch_node_order_fns.setdefault(name, []).append((fn, weight))

    def add_queue_budget_fn(self, name, fn):
        """Queue budget vectors for the solver: (queue) ->
        (deserved: Resource, allocated: Resource) or None if the plugin has
        no opinion (proportion's water-filled shares, proportion.go:100-147)."""
        self.queue_budget_fns[name] = fn

    # ------------------------------------------------- tiered combinators
    # reference framework/session_plugins.go

    def _enabled(self, flag: Optional[bool]) -> bool:
        return bool(flag)

    def reclaimable(self, reclaimer: TaskInfo, reclaimees: List[TaskInfo]):
        """Intersection within a tier; first deciding tier wins
        (session_plugins.go:80-119)."""
        return self._evictable(
            reclaimer, reclaimees, self.reclaimable_fns, "enabled_reclaimable"
        )

    def preemptable(self, preemptor: TaskInfo, preemptees: List[TaskInfo]):
        """session_plugins.go:121-162"""
        return self._evictable(
            preemptor, preemptees, self.preemptable_fns, "enabled_preemptable"
        )

    def _evictable(self, evictor, evictees, fns, flag_attr):
        # Go-nil semantics matter here (session_plugins.go:80-119): a plugin
        # answering "no victims" (nil) poisons every later intersection, and a
        # tier only decides when its running intersection is non-empty.
        victims: Optional[List[TaskInfo]] = None
        init = False
        for tier in self.tiers:
            for plugin in tier.plugins:
                if not self._enabled(getattr(plugin, flag_attr)):
                    continue
                fn = fns.get(plugin.name)
                if fn is None:
                    continue
                candidates = fn(evictor, evictees) or None  # empty → Go nil
                if not init:
                    victims = candidates
                    init = True
                elif victims:
                    cand_uids = {c.uid for c in (candidates or [])}
                    victims = [v for v in victims if v.uid in cand_uids] or None
            if victims is not None:
                return victims
        return victims or []

    def overused(self, queue: QueueInfo) -> bool:
        """Any-true across all tiers (session_plugins.go:164-179)."""
        for tier in self.tiers:
            for plugin in tier.plugins:
                fn = self.overused_fns.get(plugin.name)
                if fn is not None and fn(queue):
                    return True
        return False

    def job_ready(self, obj) -> bool:
        """All-true (session_plugins.go:182-200)."""
        for tier in self.tiers:
            for plugin in tier.plugins:
                if not self._enabled(plugin.enabled_job_ready):
                    continue
                fn = self.job_ready_fns.get(plugin.name)
                if fn is not None and not fn(obj):
                    return False
        return True

    def job_pipelined(self, obj) -> bool:
        """All-true (session_plugins.go:202-221)."""
        for tier in self.tiers:
            for plugin in tier.plugins:
                if not self._enabled(plugin.enabled_job_pipelined):
                    continue
                fn = self.job_pipelined_fns.get(plugin.name)
                if fn is not None and not fn(obj):
                    return False
        return True

    def job_valid(self, obj) -> Optional[ValidateResult]:
        """First failure wins (session_plugins.go:224-240)."""
        for tier in self.tiers:
            for plugin in tier.plugins:
                fn = self.job_valid_fns.get(plugin.name)
                if fn is None:
                    continue
                vr = fn(obj)
                if vr is not None and not vr.passed:
                    return vr
        return None

    def job_order_fn(self, l: JobInfo, r: JobInfo) -> bool:
        """First nonzero comparison; creation-time+UID tiebreak
        (session_plugins.go:243-267)."""
        for tier in self.tiers:
            for plugin in tier.plugins:
                if not self._enabled(plugin.enabled_job_order):
                    continue
                fn = self.job_order_fns.get(plugin.name)
                if fn is None:
                    continue
                j = fn(l, r)
                if j != 0:
                    return j < 0
        if l.creation_timestamp == r.creation_timestamp:
            return l.uid < r.uid
        return l.creation_timestamp < r.creation_timestamp

    def queue_order_fn(self, l: QueueInfo, r: QueueInfo) -> bool:
        """session_plugins.go:270-295"""
        for tier in self.tiers:
            for plugin in tier.plugins:
                if not self._enabled(plugin.enabled_queue_order):
                    continue
                fn = self.queue_order_fns.get(plugin.name)
                if fn is None:
                    continue
                j = fn(l, r)
                if j != 0:
                    return j < 0
        lt = l.queue.metadata.creation_timestamp
        rt = r.queue.metadata.creation_timestamp
        if lt == rt:
            return l.uid < r.uid
        return lt < rt

    def task_compare_fns(self, l: TaskInfo, r: TaskInfo) -> int:
        """session_plugins.go:298-315"""
        for tier in self.tiers:
            for plugin in tier.plugins:
                if not self._enabled(plugin.enabled_task_order):
                    continue
                fn = self.task_order_fns.get(plugin.name)
                if fn is None:
                    continue
                j = fn(l, r)
                if j != 0:
                    return j
        return 0

    def task_order_fn(self, l: TaskInfo, r: TaskInfo) -> bool:
        """session_plugins.go:318-331"""
        res = self.task_compare_fns(l, r)
        if res != 0:
            return res < 0
        lt = l.pod.metadata.creation_timestamp
        rt = r.pod.metadata.creation_timestamp
        if lt == rt:
            return l.uid < r.uid
        return lt < rt

    def predicate_fn(self, task: TaskInfo, node: NodeInfo) -> None:
        """All must pass; raises PredicateError on failure
        (session_plugins.go:334-351)."""
        for tier in self.tiers:
            for plugin in tier.plugins:
                if not self._enabled(plugin.enabled_predicate):
                    continue
                fn = self.predicate_fns.get(plugin.name)
                if fn is None:
                    continue
                fn(task, node)  # raises on failure

    def node_prioritizers(self) -> List:
        """Concat enabled scorers (session_plugins.go:354-369)."""
        configs: List = []
        for tier in self.tiers:
            for plugin in tier.plugins:
                if not self._enabled(plugin.enabled_node_order):
                    continue
                configs.extend(self.node_order_fns.get(plugin.name, []))
        return configs

    # ------------------------------------------- TPU-solver tier gating
    # The batched seams honor the same per-tier enable flags as their
    # scalar counterparts, so allocate and allocate_tpu see identical
    # policy for a given scheduler conf.

    def batch_task_order_keys(self, tasks):
        """List of ascending key arrays (tier order) reproducing
        task_order_fn, or None if an enabled task-order plugin has no
        batch key form (callers then fall back to comparison sorting)."""
        keys: List = []
        for tier in self.tiers:
            for plugin in tier.plugins:
                if not self._enabled(plugin.enabled_task_order):
                    continue
                if self.task_order_fns.get(plugin.name) is None:
                    continue
                kfn = self.batch_task_order_key_fns.get(plugin.name)
                if kfn is None:
                    return None
                keys.append(kfn(tasks))
        return keys

    def batch_job_order_keys(self, jobs):
        """List of ascending key arrays (tier order) reproducing
        job_order_fn, or None if an enabled job-order plugin has no
        batch key form (callers then fall back to comparison sorting).
        The (creation_timestamp, uid) tiebreak is the caller's, exactly
        as in :meth:`job_order_fn`."""
        keys: List = []
        for tier in self.tiers:
            for plugin in tier.plugins:
                if not self._enabled(plugin.enabled_job_order):
                    continue
                if self.job_order_fns.get(plugin.name) is None:
                    continue
                kfn = self.batch_job_order_key_fns.get(plugin.name)
                if kfn is None:
                    return None
                keys.append(kfn(jobs))
        return keys

    def batch_predicates(self) -> List:
        """(name, fn) of enabled batched predicates, tier-gated like
        predicate_fn."""
        out: List = []
        for tier in self.tiers:
            for plugin in tier.plugins:
                if not self._enabled(plugin.enabled_predicate):
                    continue
                fn = self.batch_predicate_fns.get(plugin.name)
                if fn is not None:
                    out.append((plugin.name, fn))
        return out

    def scalar_only_predicates(self) -> List:
        """(name, fn) of enabled scalar predicates that have NO batched
        form (fallback path for unported plugins)."""
        out: List = []
        for tier in self.tiers:
            for plugin in tier.plugins:
                if not self._enabled(plugin.enabled_predicate):
                    continue
                if plugin.name in self.batch_predicate_fns:
                    continue
                fn = self.predicate_fns.get(plugin.name)
                if fn is not None:
                    out.append((plugin.name, fn))
        return out

    def batch_node_prioritizers(self) -> List:
        """(fn, weight) of enabled batched scorers, tier-gated like
        node_prioritizers."""
        configs: List = []
        for tier in self.tiers:
            for plugin in tier.plugins:
                if not self._enabled(plugin.enabled_node_order):
                    continue
                configs.extend(self.batch_node_order_fns.get(plugin.name, []))
        return configs

    def solver_dynamic_weights(self) -> Dict[str, float]:
        """Merged in-kernel scorer weights from plugins whose node-order is
        enabled (zeroed otherwise, matching node_prioritizers gating)."""
        merged: Dict[str, float] = {}
        for tier in self.tiers:
            for plugin in tier.plugins:
                if not self._enabled(plugin.enabled_node_order):
                    continue
                for key, w in self.solver_score_weights.get(
                    plugin.name, {}
                ).items():
                    merged[key] = merged.get(key, 0.0) + w
        return merged

    def __repr__(self) -> str:
        return (
            f"Session {self.uid}: jobs={len(self.jobs)}, "
            f"nodes={len(self.nodes)}, queues={len(self.queues)}"
        )
