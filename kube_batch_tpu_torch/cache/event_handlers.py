"""Cache event handlers: cluster watch events → domain-model mutations.

Mirrors reference pkg/scheduler/cache/event_handlers.go. These are the entry
points the watch dispatcher calls, and the same entry points the tests feed
synthetic objects through (the reference test pattern,
actions/allocate/allocate_test.go:164-176).

All handlers take the cache mutex; they mutate Jobs/Nodes/Queues maps only.
"""

from __future__ import annotations

import logging
from typing import Optional

from ..api import (
    JobInfo,
    Node,
    NodeInfo,
    Pod,
    PodGroup,
    PriorityClass,
    Queue,
    QueueInfo,
    TaskInfo,
    TaskStatus,
)
from .util import create_shadow_pod_group, job_terminated

logger = logging.getLogger(__name__)


def _is_terminated(status: TaskStatus) -> bool:
    return status in (TaskStatus.SUCCEEDED, TaskStatus.FAILED)


class EventHandlersMixin:
    """Handler methods mixed into SchedulerCache.

    Every mutation additionally stamps the touched job/node name into
    the cache's dirty ledger (``_dirty_jobs`` / ``_dirty_nodes``,
    drained by ``snapshot()`` into the ClusterInfo) so the incremental
    tensorize path can report how much churn arrived between cycles."""

    def _stamp_dirty(self, job_key: Optional[str] = None,
                     node_name: Optional[str] = None) -> None:
        if job_key:
            self._dirty_jobs.add(job_key)
        if node_name:
            self._dirty_nodes.add(node_name)

    def _stamp_dirty_alloc(self, job_key: Optional[str] = None,
                           node_name: Optional[str] = None) -> None:
        """NARROW stamp for the scheduler's own bind bookkeeping: the
        mutation is a known allocation delta (node idle/used/task-count,
        job status-index move), never a spec/labels/releasing/capacity
        change. snapshot() subtracts the full sets, so a name that also
        saw a third-party event stays conservatively full-dirty."""
        if job_key:
            self._dirty_jobs_alloc.add(job_key)
        if node_name:
            self._dirty_nodes_alloc.add(node_name)

    # ---- pods (reference event_handlers.go:45-262) -------------------------

    def _get_or_create_job(self, ti: TaskInfo) -> Optional[JobInfo]:
        """reference event_handlers.go:44-70; pods of other schedulers with no
        group get no job; group-less pods of ours get a shadow PodGroup whose
        name (controller/pod UID) is the job key, queued on the default queue
        (event_handlers.go:52-59)."""
        if not ti.job:
            if ti.pod.spec.scheduler_name != self.scheduler_name:
                return None
            pg = create_shadow_pod_group(ti.pod)
            ti.job = pg.name
            if ti.job not in self.jobs:
                job = JobInfo(ti.job)
                job.set_pod_group(pg)
                job.queue = self.default_queue
                self.jobs[ti.job] = job
                # New mirror entry: ledger-stamped HERE, not only by the
                # _add_task caller — kbtlint's dirty-ledger pass holds
                # every mutating function to "stamp reachable in the
                # same function" (stamps are idempotent set-adds).
                self._stamp_dirty(ti.job)
        elif ti.job not in self.jobs:
            self.jobs[ti.job] = JobInfo(ti.job)
            self._stamp_dirty(ti.job)
        return self.jobs[ti.job]

    def _effective_job_key(self, ti: TaskInfo) -> str:
        """The job key a pod WOULD be filed under, without creating anything.
        Divergence from the reference: updatePod/deletePod there rebuild the
        task from the pod and get Job=="" for shadow-group pods, so the shadow
        job's accounting is never cleaned up (event_handlers.go:128-180) —
        a double-count bug we do not reproduce."""
        if ti.job:
            return ti.job
        from ..api import get_controller_uid

        return get_controller_uid(ti.pod) or ti.pod.uid

    def _add_task(self, ti: TaskInfo) -> None:
        """reference event_handlers.go:60-90"""
        job = self._get_or_create_job(ti)
        self._stamp_dirty(ti.job, ti.node_name)
        if job is not None:
            job.add_task_info(ti)
        if ti.node_name:
            if ti.node_name not in self.nodes:
                self.nodes[ti.node_name] = NodeInfo(None)
            if not _is_terminated(ti.status):
                node = self.nodes[ti.node_name]
                from ..api import pod_key

                if pod_key(ti.pod) in node.tasks:
                    # Self-healing on reconcile: replace the stale entry
                    # instead of wedging the resync loop on a duplicate-add.
                    node.update_task(ti)
                else:
                    node.add_task(ti)

    def _delete_task(self, ti: TaskInfo) -> None:
        """reference event_handlers.go deleteTask"""
        self._stamp_dirty(ti.job, ti.node_name)
        job_err = node_err = None
        if ti.job:
            job = self.jobs.get(ti.job)
            if job is not None:
                try:
                    job.delete_task_info(ti)
                except KeyError as e:
                    job_err = e
            else:
                job_err = KeyError(f"job {ti.job} not found")
        if ti.node_name:
            node = self.nodes.get(ti.node_name)
            if node is not None:
                try:
                    node.remove_task(ti)
                except KeyError as e:
                    node_err = e
        if job_err or node_err:
            raise KeyError(f"failed to delete task {ti.namespace}/{ti.name}: "
                           f"{job_err or ''} {node_err or ''}")

    def _update_task(self, old: TaskInfo, new: TaskInfo) -> None:
        """Delete + re-add (reference event_handlers.go:119-129).
        Tolerates a missing old task: an update is "make the mirror
        match", and on the reconcile path the old entry may already be
        gone (duplicate delivery, a prior partial delete) — raising
        there turned one duplicate event into a resync-queue spin."""
        try:
            self._delete_task(old)
        except KeyError:
            logger.debug(
                "update of %s/%s found no old task to delete; adding",
                old.namespace, old.name,
            )
        self._add_pod_locked(new.pod)

    def _sync_task(self, old: TaskInfo) -> None:
        """Reconcile one task against cluster truth after a failed side
        effect (reference event_handlers.go:99-117). The cluster read
        runs OUTSIDE the mutex (on a real cluster it is a network GET)
        through the typed retry policy: transient errors retry in place
        with capped-exponential deterministic-jitter backoff, an
        exhausted retry surfaces to the caller's requeue contract, and
        ObjectGoneError reconciles as a delete (cluster/errors.py)."""
        pod = None
        if self.cluster is not None:
            from ..cluster.errors import ObjectGoneError, retry_transient

            try:
                pod = retry_transient(
                    lambda: self.cluster.get_pod(old.namespace, old.name),
                    salt=f"get-pod/{old.namespace}/{old.name}",
                )
            except ObjectGoneError:
                pod = None
        with self.mutex:
            if pod is None:
                try:
                    self._delete_task(old)
                except KeyError:
                    pass
                return
            self._update_task(old, TaskInfo(pod))

    def _accept_pod(self, pod: Pod) -> bool:
        """Informer filter analog (reference cache.go:305-316): pending pods of
        this scheduler + all non-pending pods (they hold resources)."""
        from ..api import PodPhase

        if pod.spec.scheduler_name == self.scheduler_name and (
            pod.status.phase == PodPhase.PENDING
        ):
            return True
        return pod.status.phase != PodPhase.PENDING

    def _add_pod_locked(self, pod: Pod) -> None:
        ti = TaskInfo(pod)
        # Idempotent: list-after-watch can replay ADDs (cache.py run()).
        job = self.jobs.get(self._effective_job_key(ti))
        if job is not None and ti.uid in job.tasks:
            return
        self._add_task(ti)

    def add_pod(self, pod: Pod) -> None:
        """reference event_handlers.go:185-201"""
        if not self._accept_pod(pod):
            return
        with self.mutex:
            self._add_pod_locked(pod)
        # Micro-cycle wake-up (outside the mutex): a pending pod of ours
        # is new schedulable work — the event-driven fast path places it
        # without waiting for the periodic cycle (scheduler.run_micro).
        from ..api import PodPhase

        if (
            pod.spec.scheduler_name == self.scheduler_name
            and pod.status.phase == PodPhase.PENDING
            and not pod.spec.node_name
        ):
            self._notify_arrival()
            # Placement-latency ledger: stamp the arrival (outside the
            # mutex — the ledger is its own leaf lock) so arrival→bind
            # latency starts at the truthful moment the pod became
            # schedulable work (obs/latency.py).
            from ..api import (
                WORKLOAD_CLASS_ANNOTATION_KEY,
                get_job_id,
                parse_serving_slo,
                parse_workload_class,
            )
            from ..obs.latency import LEDGER

            annotations = pod.metadata.annotations
            workload_class = (
                parse_workload_class(annotations)
                if WORKLOAD_CLASS_ANNOTATION_KEY in annotations
                else "batch"
            )
            slo = (
                parse_serving_slo(annotations)
                if workload_class == "serving"
                else None
            )
            LEDGER.note_arrival(
                pod.uid,
                f"{pod.namespace}/{pod.name}",
                get_job_id(pod) or pod.uid,
                workload_class=workload_class,
                slo_target=slo.target_seconds if slo is not None else None,
            )

    def _stored_task(self, ti: TaskInfo) -> TaskInfo:
        """Resolve to the cache's own TaskInfo (handles Binding status drift,
        reference event_handlers.go:162-170)."""
        job = self.jobs.get(self._effective_job_key(ti))
        if job is not None and ti.uid in job.tasks:
            return job.tasks[ti.uid]
        return ti

    def _allocated_status_flip(self, old_ti: TaskInfo,
                               new_ti: TaskInfo) -> bool:
        """True iff this pod MODIFIED event is a pure in-place status
        confirmation of a placement the scheduler already made — the
        kubelet flipping a bound pod to Running, or the API server
        confirming a bind: same pod on the same node, both statuses in
        the allocated family, identical resource requests. Such an
        event changes NO state the solver reads (node idle/releasing/
        count and job pending sets are all invariant), so it stamps the
        NARROW ledger — without this, every bind confirmation re-dirties
        its node fully one cycle later and the warm path can never
        engage against a live API server."""
        from ..api import allocated_status

        return bool(
            old_ti.uid == new_ti.uid
            and old_ti.node_name
            and old_ti.node_name == new_ti.node_name
            and allocated_status(old_ti.status)
            and allocated_status(new_ti.status)
            and old_ti.resreq == new_ti.resreq
            and old_ti.init_resreq == new_ti.init_resreq
        )

    def update_pod(self, old_pod: Pod, new_pod: Pod) -> None:
        """reference event_handlers.go:128-133 (deletePod + addPod)"""
        if not self._accept_pod(new_pod):
            return
        with self.mutex:
            old_ti = self._stored_task(TaskInfo(old_pod))
            narrow = self._allocated_status_flip(old_ti, TaskInfo(new_pod))
            job_key = self._effective_job_key(old_ti)
            node_name = old_ti.node_name
            if narrow:
                # Only demote stamps THIS event minted: a name already
                # full-dirty from an earlier event stays full-dirty.
                pre_job = job_key in self._dirty_jobs
                pre_node = node_name in self._dirty_nodes
            try:
                self._delete_task(old_ti)
            except KeyError:
                narrow = False
                pass
            self._add_pod_locked(new_pod)
            if narrow:
                if not pre_job:
                    self._dirty_jobs.discard(job_key)
                    self._dirty_jobs_alloc.add(job_key)
                if not pre_node:
                    self._dirty_nodes.discard(node_name)
                    self._dirty_nodes_alloc.add(node_name)

    def delete_pod(self, pod: Pod) -> None:
        """reference event_handlers.go:162-180"""
        with self.mutex:
            ti = TaskInfo(pod)
            task = self._stored_task(ti)
            job = self.jobs.get(self._effective_job_key(ti))
            try:
                self._delete_task(task)
            except KeyError:
                pass
            if job is not None and job_terminated(job):
                self._queue_job_cleanup(job)
        # A deleted pod's latency entry dies with it (outside the
        # mutex; the metrics-GC pattern — no per-pod ledger leak).
        from ..obs.latency import LEDGER

        LEDGER.forget_pod(pod.uid)

    # ---- nodes (reference event_handlers.go:264-366) -----------------------

    def add_node(self, node: Node) -> None:
        with self.mutex:
            self._stamp_dirty(node_name=node.name)
            if node.name in self.nodes:
                self.nodes[node.name].set_node(node)
            else:
                self.nodes[node.name] = NodeInfo(node)

    def update_node(self, old_node: Node, new_node: Node) -> None:
        with self.mutex:
            self._stamp_dirty(node_name=new_node.name)
            if new_node.name in self.nodes:
                self.nodes[new_node.name].set_node(new_node)
            else:
                self.nodes[new_node.name] = NodeInfo(new_node)

    def delete_node(self, node: Node) -> None:
        with self.mutex:
            self._stamp_dirty(node_name=node.name)
            self.nodes.pop(node.name, None)

    # ---- pod groups (reference event_handlers.go:370-659) ------------------

    def _job_key(self, pg: PodGroup) -> str:
        return f"{pg.namespace}/{pg.name}"

    def _set_pod_group(self, pg: PodGroup) -> None:
        """reference event_handlers.go:370-389 (incl. default-queue fallback)"""
        key = self._job_key(pg)
        self._stamp_dirty(key)
        if key not in self.jobs:
            self.jobs[key] = JobInfo(key)
        self.jobs[key].set_pod_group(pg)
        if not pg.spec.queue:
            self.jobs[key].queue = self.default_queue

    def add_pod_group(self, pg: PodGroup) -> None:
        with self.mutex:
            self._set_pod_group(pg)

    def update_pod_group(self, old_pg: PodGroup, new_pg: PodGroup) -> None:
        with self.mutex:
            self._set_pod_group(new_pg)

    def delete_pod_group(self, pg: PodGroup) -> None:
        with self.mutex:
            key = self._job_key(pg)
            self._stamp_dirty(key)
            job = self.jobs.get(key)
            if job is not None:
                job.unset_pod_group()
                if job_terminated(job):
                    self._queue_job_cleanup(job)

    # ---- PodDisruptionBudgets (reference event_handlers.go:662-773) --------
    # Legacy gang source: a PDB owned by a controller defines minAvailable
    # for the pods of that controller, without any PodGroup. The job key is
    # the PDB's controller owner UID — the same key owned plain pods file
    # under via the shadow-PodGroup path, so the two meet in one JobInfo.

    def _set_pdb_locked(self, pdb) -> bool:
        job_key = pdb.metadata.owner_uid or ""
        if not job_key:
            # An ownerless PDB is an ordinary disruption budget, not a
            # gang source — common in real clusters, so skip quietly
            # rather than raising per watch event.
            logger.debug(
                "PodDisruptionBudget %s/%s has no controller owner; "
                "not a gang source", pdb.namespace, pdb.name,
            )
            return False
        self._stamp_dirty(job_key)
        job = self.jobs.get(job_key)
        if job is None:
            job = self.jobs[job_key] = JobInfo(job_key)
        job.set_pdb(pdb)
        # PDBs carry no queue; they land on the default queue
        # (event_handlers.go:676).
        job.queue = self.default_queue
        return True

    def add_pdb(self, pdb) -> None:
        with self.mutex:
            self._set_pdb_locked(pdb)

    def update_pdb(self, old_pdb, new_pdb) -> None:
        with self.mutex:
            self._set_pdb_locked(new_pdb)

    def delete_pdb(self, pdb) -> None:
        with self.mutex:
            job_key = pdb.metadata.owner_uid or ""
            job = self.jobs.get(job_key)
            if job is None:
                return
            # Found by kbtlint's dirty-ledger pass: every sibling
            # handler stamps, but this one dropped the gang spec with
            # no stamp — the delta-aware tensorize would keep serving
            # the job's old min-available verdicts (a staleness
            # class of its own).
            self._stamp_dirty(job_key)
            job.unset_pdb()
            # The cleanup loop re-checks job_terminated before removal, so
            # queueing unconditionally matches the reference's deleteJob
            # (event_handlers.go:696-700, cache.go:556-585).
            self._queue_job_cleanup(job)

    # ---- queues (reference event_handlers.go:775-1036) ---------------------

    def add_queue(self, queue: Queue) -> None:
        with self.mutex:
            self.queues[queue.name] = QueueInfo(queue)

    def update_queue(self, old_queue: Queue, new_queue: Queue) -> None:
        with self.mutex:
            self.queues[new_queue.name] = QueueInfo(new_queue)

    def delete_queue(self, queue: Queue) -> None:
        with self.mutex:
            self.queues.pop(queue.name, None)

    # ---- priority classes (reference event_handlers.go:1038-1129) ----------

    def add_priority_class(self, pc: PriorityClass) -> None:
        with self.mutex:
            self._add_priority_class_locked(pc)

    def update_priority_class(self, old_pc: PriorityClass, new_pc: PriorityClass) -> None:
        with self.mutex:
            self._delete_priority_class_locked(old_pc)
            self._add_priority_class_locked(new_pc)

    def delete_priority_class(self, pc: PriorityClass) -> None:
        with self.mutex:
            self._delete_priority_class_locked(pc)

    def _add_priority_class_locked(self, pc: PriorityClass) -> None:
        if pc.global_default:
            self.default_priority_class = pc
            self.default_priority = pc.value
        self.priority_classes[pc.name] = pc
        # Job priorities are resolved from this map at snapshot time, so
        # a class change invalidates the incremental snapshot's premise
        # that untouched jobs kept their priority.
        self._priority_gen += 1

    def _delete_priority_class_locked(self, pc: PriorityClass) -> None:
        if pc.global_default:
            self.default_priority_class = None
            self.default_priority = 0
        self.priority_classes.pop(pc.name, None)
        self._priority_gen += 1
