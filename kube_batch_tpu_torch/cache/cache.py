"""SchedulerCache: the stateful cluster mirror.

Mirrors reference pkg/scheduler/cache/cache.go:
- One mutex over Jobs/Nodes/Queues/PriorityClasses maps (:73-115).
- Snapshot() deep-clones ready nodes, queues, and jobs that carry a scheduling
  spec, resolving job priority from PriorityClasses (:612-659).
- Bind/Evict mutate the mirror under lock, then fire the side effect
  asynchronously; failures trigger a rate-limited resync of the task
  (:421-522, :588-608).
- Deleted jobs are cleaned up via a queue once terminated (:556-585).

Watch ingest comes from a ClusterAPI watch (the informer analog); tests feed
the event-handler entry points directly.
"""

from __future__ import annotations

import logging
import os
import queue
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterable, List, Optional

logger = logging.getLogger(__name__)

from ..api import (
    ClusterInfo,
    JobInfo,
    Node,
    NodeInfo,
    Pod,
    PodCondition,
    PodGroup,
    PriorityClass,
    Queue,
    QueueInfo,
    TaskInfo,
    TaskStatus,
)
from ..obs.tracer import TRACER, span as _obs_span
from ..api.objects import DEFAULT_SCHEDULER_NAME
from ..cluster import ADDED, DELETED, MODIFIED, ClusterAPI
from ..utils.lockdebug import witness_writes, wrap_lock
from .event_handlers import EventHandlersMixin
from .interface import Binder, Cache, Evictor, StatusUpdater, VolumeBinder
from .util import job_terminated, shadow_pod_group


class CacheFencedError(RuntimeError):
    """A bind/evict was refused because the cache is fenced: the loop
    watchdog (or the leader-election layer) declared this process a
    deposed leader, and a deposed leader must not mutate the cluster —
    a successor holding the lease may already be scheduling the same
    tasks (doc/design/robustness.md)."""


class DefaultBinder(Binder):
    """reference cache.go:117-135 (POST /bind analog)"""

    def __init__(self, cluster: ClusterAPI):
        self.cluster = cluster

    def bind(self, pod: Pod, hostname: str) -> None:
        self.cluster.bind_pod(pod, hostname)


class DefaultEvictor(Evictor):
    """reference cache.go:137-148 (pod DELETE analog)"""

    def __init__(self, cluster: ClusterAPI):
        self.cluster = cluster

    def evict(self, pod: Pod) -> None:
        self.cluster.delete_pod(pod)


class DefaultStatusUpdater(StatusUpdater):
    """reference cache.go:151-197"""

    def __init__(self, cluster: ClusterAPI):
        self.cluster = cluster

    def update_pod_condition(self, pod: Pod, condition: PodCondition) -> None:
        self.cluster.update_pod_condition(pod, condition)

    def update_pod_group(self, pg: PodGroup) -> None:
        self.cluster.update_pod_group(pg)


class DefaultVolumeBinder(VolumeBinder):
    """Assume/bind volume lifecycle (reference cache.go:200-268).

    ``allocate_volumes`` assumes the pod's unbound claims onto the chosen
    node (conflicting assumptions fail the allocation, like
    AssumePodVolumes); ``task.volume_ready`` records whether every claim
    was already bound. ``bind_volumes`` then waits — up to ``bind_timeout``
    seconds, the reference's 30s — for the PV-controller analog to bind
    the assumed claims, raising TimeoutError on expiry so the dispatch
    fails and the task re-enters the resync path.

    Without a cluster (standalone decision-core use), volumes are
    instantly assumable, preserving the previous no-op behavior."""

    def __init__(self, cluster: Optional[ClusterAPI] = None,
                 bind_timeout: float = 30.0):
        self.cluster = cluster
        self.bind_timeout = bind_timeout

    def allocate_volumes(self, task: TaskInfo, hostname: str) -> None:
        if self.cluster is None or not task.pod.spec.volume_claims:
            task.volume_ready = True
            return
        # ClusterAPI's default treats volumes as instantly assumable;
        # InProcessCluster implements the real assume lifecycle.
        task.volume_ready = self.cluster.assume_pod_volumes(
            task.pod, hostname
        )

    def bind_volumes(self, task: TaskInfo) -> None:
        if task.volume_ready or self.cluster is None:
            return  # cache.go:214-217: ready volumes are not re-bound
        if not self.cluster.wait_pod_volumes_bound(
            task.pod, self.bind_timeout
        ):
            raise TimeoutError(
                f"volumes of {task.namespace}/{task.name} not bound "
                f"within {self.bind_timeout}s"
            )
        task.volume_ready = True

    def release_volumes(self, task: TaskInfo) -> None:
        """Drop the task's claim assumptions after a failed bind so the
        next cycle can place it (or a competitor) elsewhere."""
        if self.cluster is not None:
            self.cluster.release_pod_volumes(task.pod)


def _pool_entry(obj):
    """COW snapshot-pool entry for a job/node: ``(source version, clone,
    clone version)``. snapshot() reuses the clone while BOTH versions
    still match (source unchanged since the clone was cut, clone not
    mutated by the session it was handed to). Sole constructor of the
    entry shape — snapshot() and the bind-bookkeeping prewarm must stay
    in lockstep on this invariant."""
    clone = obj.clone()
    return (obj._ver, clone, clone._ver)


class SchedulerCache(Cache, EventHandlersMixin):
    def __init__(
        self,
        cluster: Optional[ClusterAPI] = None,
        scheduler_name: str = DEFAULT_SCHEDULER_NAME,
        default_queue: str = "default",
        binder: Optional[Binder] = None,
        evictor: Optional[Evictor] = None,
        status_updater: Optional[StatusUpdater] = None,
        volume_binder: Optional[VolumeBinder] = None,
        enable_priority_class: bool = True,
    ):
        # Named for the KBT_LOCK_DEBUG order-asserting harness (raw
        # locks when the flag is off — wrap_lock is identity then).
        self.mutex = wrap_lock("cache.mutex", threading.RLock())
        self.cluster = cluster
        self.scheduler_name = scheduler_name
        self.default_queue = default_queue
        self.enable_priority_class = enable_priority_class

        self.jobs: Dict[str, JobInfo] = {}
        self.nodes: Dict[str, NodeInfo] = {}
        self.queues: Dict[str, QueueInfo] = {}
        self.priority_classes: Dict[str, PriorityClass] = {}
        self.default_priority: int = 0
        self.default_priority_class: Optional[PriorityClass] = None

        self.binder = binder or (DefaultBinder(cluster) if cluster else None)
        self.evictor = evictor or (DefaultEvictor(cluster) if cluster else None)
        self.status_updater = status_updater or (
            DefaultStatusUpdater(cluster) if cluster else None
        )
        self.volume_binder = volume_binder or DefaultVolumeBinder(cluster)

        # Rate-limited retry queues (reference cache.go:588-608, :556-585).
        # Items carry a retry count; re-queues back off exponentially.
        self.err_tasks: "queue.Queue[tuple]" = queue.Queue()
        self.deleted_jobs: "queue.Queue[tuple]" = queue.Queue()
        self._base_retry_delay = 0.05
        self._max_retry_delay = 5.0
        # Poisoned-task cap: a task whose reconcile fails this many
        # times is dropped terminally (counted + named in the job's
        # unschedulable verdict) instead of circulating in the resync
        # queue forever — the reference rate-limits but never gives up,
        # which turns one poisoned task into permanent queue churn.
        self._max_resync_attempts = int(
            os.environ.get("KBT_RESYNC_MAX_ATTEMPTS", "8")
        )
        self._dispatch = self._build_dispatch()

        # COW snapshot pool: {key: (src_ver, clone, clone_ver)} per kind
        # (see snapshot()).
        self._snap_pool: tuple = ({}, {})
        # Job/node names touched since the last snapshot (stamped by the
        # event handlers and the bind bookkeeping under the mutex,
        # drained into ClusterInfo.dirty_jobs/dirty_nodes by snapshot()):
        # the cheap churn ledger the incremental tensorize stats report.
        self._dirty_jobs: set = set()
        self._dirty_nodes: set = set()
        # NARROW ledger: names whose only mutations since the last
        # snapshot were the scheduler's OWN bind bookkeeping (idle/used/
        # task-count moved by exactly the per-node deltas the apply
        # phase computed; releasing/capacity/labels/taints untouched,
        # job scalar-resource names untouched). Third-party watch
        # events stamp the FULL sets above; snapshot() reports
        # narrow = narrow - full so a name that saw both stays
        # conservatively full-dirty. Consumed by the delta-aware
        # tensorize + predicate caches (solver/snapshot.py,
        # plugins/predicates.py) to patch only the changed columns
        # instead of tripping the bulk-dirty full rebuild.
        self._dirty_jobs_alloc: set = set()
        self._dirty_nodes_alloc: set = set()
        # FULL-dirty backlog: names drained by snapshot() but not yet
        # ABSORBED by a tensorize refresh (cache.note_full_absorbed).
        # A cycle can drain the ledger and then never tensorize (a
        # deferred micro cycle, an error before the action, no ready
        # nodes) — if the dropped full-dirty name were later stamped
        # narrow, the delta-aware patch would treat a third-party
        # mutation as allocation-only and leave releasing/capacity/
        # static-verdict columns stale. The backlog keeps reporting a
        # name FULL until a refresh actually consumed it.
        self._full_backlog_jobs: set = set()
        self._full_backlog_nodes: set = set()
        # Monotone snapshot generation: the warm-solve state machine
        # (solver/warm.py) requires CONSECUTIVE snapshots — a cycle
        # whose ledger drained without a warm save invalidates the
        # carried verdicts.
        self._snap_gen = 0
        # Incremental-snapshot state: the previous snapshot's job/node
        # dicts (reused + delta-patched), the running sum of ready-node
        # allocatables, and the aligned verification fingerprint
        # (_SnapFingerprint) that detects EXACTLY which mirror objects
        # or pool clones moved since — no trust in any reporting.
        self._last_snap_jobs: Optional[Dict[str, JobInfo]] = None
        self._last_snap_nodes: Optional[Dict[str, NodeInfo]] = None
        self._snap_total_allocatable = None
        self._snap_fp: Optional[tuple] = None
        self._snap_fp_priority_gen = -1
        # Lazy name->fingerprint-position maps ([jobs, nodes]) for the
        # micro-snapshot ledger verification; rebuilt on demand whenever
        # the fingerprint name lists grew or were refreshed.
        self._snap_fp_index: list = [None, None]
        # Session-clone touch ledger: clone names whose _ver a session
        # bumped (Session/Statement mutators report via
        # note_clones_touched at close). Together with the dirty sets
        # this names every position the micro fast-verification must
        # recheck; drained by snapshot() with the other ledgers.
        self._touched_clone_jobs: set = set()
        self._touched_clone_nodes: set = set()
        # Forensics: how many snapshots took the ledger-verified micro
        # fast path vs the full O(n) fingerprint compare.
        self.snap_ledger_verifies = 0
        self.snap_full_verifies = 0
        # Priority-class generation: job priority is resolved from the
        # class map at snapshot time, so any class change forces the
        # full pool walk (the per-job priority recheck).
        self._priority_gen = 0
        # Event-driven micro-cycles: an arrival listener (Scheduler.run
        # installs a threading.Event setter) fired whenever a pending
        # pod of ours lands in the mirror.
        self._arrival_listener = None
        # Cross-session plugin fold store (plugins/drf.py,
        # plugins/proportion.py): per-plugin caches of open-time fold
        # results keyed on snapshot-clone identity + _ver, so a
        # steady-state micro open recomputes only the churned jobs'
        # contributions instead of the whole O(jobs) fold. Entries are
        # self-invalidating (a mutated job gets a fresh clone, missing
        # the identity compare), so no coordination with the snapshot
        # machinery is needed.
        self.plugin_fold: dict = {}

        # --- event-stream integrity (doc/design/robustness.md) ---------
        # Per-object resourceVersion memos + stream gap tracking,
        # guarded by self.mutex (the ingest path already serializes on
        # it). A versioning cluster (InProcessCluster) delivers each
        # watch event with a monotone rv; the guards absorb duplicate,
        # stale, and out-of-order delivery (counted in
        # cache_event_anomalies_total{kind}) and detect DROPPED events
        # as persistent holes in the rv stream — repaired by a bounded,
        # rate-limited relist through the drain_resync_queue seam
        # instead of a process restart. rv-less events (direct handler
        # calls in tests, list replay, KubeCluster's opaque string rvs)
        # bypass the guards entirely.
        self._watch_rv: Dict[tuple, int] = {}
        self._watch_deleted: deque = deque()
        self._stream_max_rv = 0
        # True once a stream position is established (start_ingest's
        # list adoption, or the first admitted event): only then is a
        # jump past max+1 a HOLE rather than a mid-stream attach.
        self._stream_baselined = False
        self._stream_missing: set = set()
        self._stream_missing_prev: set = set()
        self._event_anomalies: Dict[str, int] = {}
        self._anomaly_flush: list = []
        self._relist_pending = False
        # Injectable clock for relist rate limiting: the simulator
        # installs its virtual clock so record and replay gate relists
        # identically; production uses the monotonic wall clock.
        self._relist_clock = time.monotonic
        self._relist_last: Optional[float] = None
        self._relist_min_interval = float(
            os.environ.get("KBT_RELIST_MIN_INTERVAL", "5")
        )
        self._relist_stats = {"ok": 0, "failed": 0}
        # Anti-entropy reconciler (cache/antientropy.py), built lazily:
        # the periodic divergence sweep and the gap-repair relist share
        # one reconcile engine.
        self._antientropy = None

        # Bind-intent journal (doc/design/robustness.md, failover):
        # at commit-dispatch time every bind batch appends a durable
        # intent record to the cluster's journal seam BEFORE any side
        # effect is issued, and each task is marked applied/failed as
        # its bind drains — so a successor leader can classify every
        # in-flight bind after a crash. KBT_BIND_JOURNAL=0 disables.
        self.journal_enabled = (
            getattr(cluster, "supports_bind_journal", False)
            and os.environ.get("KBT_BIND_JOURNAL", "1") != "0"
        )
        # Identity stamped into journal records (the elector identity in
        # server mode, the sim instance id in drills): recovery
        # distinguishes a predecessor's intents from its own.
        self.leader_identity = f"{scheduler_name}-{os.getpid()}"

        self._executor = ThreadPoolExecutor(
            max_workers=4, thread_name_prefix="cache-sideeffect"
        )
        # Mirror bookkeeping gets its own single worker: snapshot()
        # barriers on it, so it must never queue behind a slow per-task
        # volume bind occupying the shared pool (those can block up to
        # the 30s bind timeout each).
        self._bookkeeping_executor = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="cache-bookkeeping"
        )
        self._inflight = 0
        self._bookkeeping_inflight = 0
        self._inflight_cond = threading.Condition(
            wrap_lock("cache.inflight_cond", threading.RLock())
        )
        self._synced = cluster is None
        self._stop = threading.Event()
        # Leadership fence (None = unfenced). Set by the loop watchdog /
        # leader-election layer; checked at every bind/evict dispatch
        # point, including the async side-effect halves — a side-effect
        # thread queued by a leader that has since been deposed must not
        # issue its bind against the cluster. Guarded by its OWN lock,
        # never self.mutex: the watchdog fences precisely when a wedged
        # cycle may be deadlocked HOLDING the mutex, and the fencing
        # path must not join that deadlock.
        self._fence_reason: Optional[str] = None
        # LEAF lock (lockdebug.LEAF_LOCKS + the kbtlint leaf rule):
        # nothing may be acquired while it is held.
        self._fence_lock = wrap_lock("cache.fence_lock")
        self._fence_refusals = 0

        # KBT_LOCK_DEBUG=2 write-witness (no-op otherwise): the runtime
        # twin of kbtlint's guarded-by pass, per named lock. Attribute
        # REBINDS only — item mutations of the mirror maps are covered
        # by the dirty-ledger pass + fingerprint verification.
        witness_writes(self, "cache.mutex", (
            "jobs", "nodes", "queues", "priority_classes",
            "default_priority", "default_priority_class", "_priority_gen",
            "_snap_gen", "_snap_pool", "_last_snap_jobs",
            "_last_snap_nodes", "_snap_total_allocatable", "_snap_fp",
            "_snap_fp_priority_gen", "_full_backlog_jobs",
            "_full_backlog_nodes",
        ))
        witness_writes(self, "cache.fence_lock", (
            "_fence_reason", "_fence_refusals",
        ))
        witness_writes(self, "cache.inflight_cond", (
            "_inflight", "_bookkeeping_inflight",
        ))

    # -- leadership fencing ---------------------------------------------------

    def fence(self, reason: str) -> None:
        """Refuse all future bind/evict side effects (idempotent; first
        reason wins — it names the original deposition cause)."""
        with self._fence_lock:
            if self._fence_reason is None:
                self._fence_reason = reason or "fenced"
        logger.error(
            "scheduler cache FENCED (%s): all bind/evict side effects "
            "will be refused", self._fence_reason,
        )

    def unfence(self) -> None:
        """Lift the fence (tests; a re-elected process restarts its
        cache instead — fencing is meant to be terminal)."""
        with self._fence_lock:
            self._fence_reason = None
            self._fence_refusals = 0

    def fence_reason(self) -> Optional[str]:
        return self._fence_reason

    def _refused_by_fence(self, what: str) -> bool:
        """One dispatch-point fence check; counts the refusal. Every
        refusal bumps the metric, but the log line is damped: fencing
        a leader with a deep bind backlog refuses one call per queued
        pod, and tens of thousands of identical warnings would bury
        the one FENCED line that names the deposition cause."""
        reason = self._fence_reason
        if reason is None:
            return False
        try:
            from .. import metrics

            metrics.register_bind_fenced()
        except Exception:  # pragma: no cover - metrics must never kill
            logger.exception("fence metric update failed")
        with self._fence_lock:
            self._fence_refusals += 1
            n = self._fence_refusals
        if n <= 3 or n % 1000 == 0:
            logger.warning(
                "fenced cache (%s) refused %s (%d refusals so far)",
                reason, what, n,
            )
        return True

    def _submit_side_effect(self, fn, bookkeeping: bool = False) -> None:
        """Run a bind/evict side effect on the async pool, tracking it so
        tests/benchmarks can barrier on completion (the reference's
        equivalent is draining the fake binder channel with a timeout,
        allocate_test.go:199-209). ``bookkeeping=True`` additionally
        counts the job toward the mirror-consistency barrier that
        :meth:`snapshot` takes — ONLY cache-mirror updates belong there;
        a slow per-task volume bind must never stall the next cycle."""
        with self._inflight_cond:
            self._inflight += 1
            if bookkeeping:
                self._bookkeeping_inflight += 1

        # Tracer handshake: side-effect spans adopt the submitting
        # span's id, so async binds/evicts render as worker-pool tracks
        # nested under the cycle that queued them.
        traced = TRACER.enabled
        parent = TRACER.capture() if traced else 0
        span_name = (
            "cache_bookkeeping" if bookkeeping else "cache_side_effect"
        )

        def wrapped():
            try:
                if traced:
                    with TRACER.adopt(parent), _obs_span(span_name):
                        fn()
                else:
                    fn()
            except Exception:
                # A side-effect job's Future is never read, so an
                # escaping exception would otherwise vanish — and for
                # bookkeeping jobs that means tasks already bulk-moved
                # to BINDING silently stay there. Log loudly; the
                # per-task revert/resync paths inside the job are the
                # real recovery, this is the backstop.
                logger.exception("side-effect job failed")
            finally:
                with self._inflight_cond:
                    self._inflight -= 1
                    if bookkeeping:
                        self._bookkeeping_inflight -= 1
                    self._inflight_cond.notify_all()

        (self._bookkeeping_executor if bookkeeping
         else self._executor).submit(wrapped)

    def wait_for_bookkeeping(self, timeout: float = 60.0) -> bool:
        """Block until every deferred cache-mirror update (bind_batch
        bookkeeping) has executed."""
        deadline = time.monotonic() + timeout
        with self._inflight_cond:
            while self._bookkeeping_inflight > 0:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._inflight_cond.wait(remaining)
        return True

    def wait_for_side_effects(self, timeout: float = 10.0) -> bool:
        """Block until every queued async bind/evict has executed."""
        deadline = time.monotonic() + timeout
        with self._inflight_cond:
            while self._inflight > 0:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._inflight_cond.wait(remaining)
        return True

    # -- watch ingest (informer analog) -------------------------------------

    def _build_dispatch(self):
        return {
            ("Pod", ADDED): self.add_pod,
            ("Pod", MODIFIED): lambda o: self.update_pod(o, o),
            ("Pod", DELETED): self.delete_pod,
            ("Node", ADDED): self.add_node,
            ("Node", MODIFIED): lambda o: self.update_node(o, o),
            ("Node", DELETED): self.delete_node,
            ("PodGroup", ADDED): self.add_pod_group,
            ("PodGroup", MODIFIED): lambda o: self.update_pod_group(o, o),
            ("PodGroup", DELETED): self.delete_pod_group,
            ("Queue", ADDED): self.add_queue,
            ("Queue", MODIFIED): lambda o: self.update_queue(o, o),
            ("Queue", DELETED): self.delete_queue,
            ("PriorityClass", ADDED): self.add_priority_class,
            ("PriorityClass", MODIFIED): lambda o: self.update_priority_class(o, o),
            ("PriorityClass", DELETED): self.delete_priority_class,
            ("PodDisruptionBudget", ADDED): self.add_pdb,
            ("PodDisruptionBudget", MODIFIED): lambda o: self.update_pdb(o, o),
            ("PodDisruptionBudget", DELETED): self.delete_pdb,
        }

    def _on_watch_event(self, kind: str, event_type: str, obj,
                        rv=None) -> None:
        if rv is None:
            self._dispatch_event(kind, event_type, obj)
            return
        # Admission and application are ATOMIC under the mutex: two
        # concurrent deliveries for the same object could otherwise be
        # admitted in rv order but applied inverted (B's DELETE rv=N+1
        # lands between A's admit of rv=N and A's apply), resurrecting
        # deleted state — exactly the regression the guard exists to
        # prevent. The mutex is re-entrant; handlers take it anyway.
        # Anomaly metrics flush AFTER the hold (no foreign locks under
        # cache.mutex).
        with self.mutex:
            admitted = self._admit_event(kind, event_type, obj, rv)
            if admitted:
                self._dispatch_event(kind, event_type, obj)
        self._flush_anomaly_metrics()

    def _dispatch_event(self, kind: str, event_type: str, obj) -> None:
        fn = self._dispatch.get((kind, event_type))
        if fn is not None:
            try:
                fn(obj)
            except Exception:  # watch handlers must not kill the dispatcher
                logger.exception(
                    "failed to handle %s %s event in cache", kind, event_type
                )

    # -- event-stream integrity guards ---------------------------------------

    # Per-object memos for objects already DELETED are pruned once the
    # stream has moved this far past the deletion — a very-late stale
    # event for a long-dead object is then applied-and-reconciled like
    # any rv-less event instead of guarded, which is safe (handlers are
    # idempotent) and keeps the memo map O(live objects).
    _WATCH_MEMO_WINDOW = 4096

    @staticmethod
    def _event_key(kind: str, obj) -> str:
        """Guard identity for one watched object. Pods key on uid (a
        recreated pod under the same name is a NEW object whose events
        must not be judged against its predecessor's versions);
        everything else keys on namespace/name like the cluster store."""
        if kind == "Pod":
            try:
                return obj.uid
            except AttributeError:
                pass
        meta = obj.metadata
        return f"{meta.namespace}/{meta.name}" if meta.namespace else meta.name

    def _note_anomaly_locked(self, kind: str, n: int = 1) -> None:
        """Count one absorbed anomaly into the state dict (caller holds
        the mutex). The Prometheus side is flushed AFTER the mutex is
        released (_flush_anomaly_metrics) — no foreign locks are taken
        under cache.mutex."""
        self._event_anomalies[kind] = (
            self._event_anomalies.get(kind, 0) + n
        )
        self._anomaly_flush.append((kind, n))

    def _flush_anomaly_metrics(self) -> None:
        # Lock-free fast path: anomalies are rare, and re-acquiring the
        # mutex on EVERY admitted event just to find the flush list
        # empty would double ingest-path mutex traffic. A benignly
        # stale non-empty miss only defers the flush to the next event
        # or checkpoint (appends happen under the mutex).
        if not self._anomaly_flush:
            return
        with self.mutex:
            pending, self._anomaly_flush = self._anomaly_flush, []
        if not pending:
            return
        try:
            from .. import metrics

            for kind, n in pending:
                metrics.register_event_anomaly(kind, n)
        except Exception:  # pragma: no cover - metrics must never kill
            logger.exception("event anomaly metric update failed")

    def _admit_event(self, kind: str, event_type: str, obj,
                     rv) -> bool:
        """Ordering/duplicate/gap guard for one watch delivery. Returns
        False when the event must be ABSORBED (duplicate or stale —
        applying it would regress mirror state that a newer event
        already wrote). Only integer rvs engage the guards; KubeCluster
        delivers opaque string rvs and relies on its own relist
        machinery."""
        if not isinstance(rv, int) or rv <= 0:
            return True
        key = (kind, self._event_key(kind, obj))
        admit = True
        with self.mutex:
            # Stream-level contiguity: every write bumps the cluster's
            # event rv by exactly one, so a hole that persists across
            # drain checkpoints is a DROPPED event (watch gap).
            if rv > self._stream_max_rv:
                if (
                    self._stream_baselined
                    and rv > self._stream_max_rv + 1
                ):
                    self._stream_missing.update(
                        range(self._stream_max_rv + 1, rv)
                    )
                    if len(self._stream_missing) > self._WATCH_MEMO_WINDOW:
                        # Pathological hole: stop tracking individual
                        # rvs and go straight to a full relist.
                        self._note_anomaly_locked("gap")
                        self._stream_missing.clear()
                        self._stream_missing_prev.clear()
                        self._relist_pending = True
                self._stream_max_rv = rv
                self._stream_baselined = True
            elif rv in self._stream_missing:
                # Late arrival of an out-of-order event: the hole was
                # delivery reordering, not loss — absorb the anomaly
                # count and fill the hole.
                self._stream_missing.discard(rv)
                self._stream_missing_prev.discard(rv)
                self._note_anomaly_locked("reorder")
            # Per-object ordering: a duplicate (same rv) or stale
            # (older rv) delivery is skipped — the mirror already
            # reflects the same-or-newer state for this object.
            last = self._watch_rv.get(key)
            if last is not None and rv <= last:
                self._note_anomaly_locked(
                    "duplicate" if rv == last else "stale"
                )
                admit = False
            if admit:
                self._watch_rv[key] = rv
                if event_type == DELETED:
                    self._watch_deleted.append((rv, key))
                while (
                    self._watch_deleted
                    and self._watch_deleted[0][0]
                    < self._stream_max_rv - self._WATCH_MEMO_WINDOW
                ):
                    old_rv, old_key = self._watch_deleted.popleft()
                    # Only drop the memo if no NEWER object recycled
                    # the key (a flapped node re-added by name).
                    if self._watch_rv.get(old_key, -1) <= old_rv:
                        self._watch_rv.pop(old_key, None)
        # NOTE: no metric flush here — the caller (_on_watch_event)
        # flushes after releasing its outer mutex hold.
        return admit

    def _adopt_listed_rv(self, kind: str, obj) -> None:
        """After a list/relist applied this object's state, pin its
        guard memo to the listed resourceVersion so late stale events
        predating the list are absorbed, not re-applied."""
        rv = getattr(obj.metadata, "resource_version", 0)
        if isinstance(rv, int) and rv > 0:
            with self.mutex:
                key = (kind, self._event_key(kind, obj))
                if self._watch_rv.get(key, 0) < rv:
                    self._watch_rv[key] = rv

    def _check_watch_gap(self) -> bool:
        """Gap-confirmation checkpoint, called at the deterministic
        drain points (drain_resync_queue; the background resync loop's
        idle beat in production). A missing rv seen at TWO consecutive
        checkpoints is a confirmed drop (in-flight reordering resolves
        within one); confirmation queues a relist, and the relist runs
        here — rate-limited — through the same drain seam. Returns True
        when integrity state changed (the settle loop's quiescence
        signal)."""
        if self.cluster is None:
            return False
        with self.mutex:
            confirmed = self._stream_missing & self._stream_missing_prev
            progressed = bool(
                self._stream_missing ^ self._stream_missing_prev
            )
            self._stream_missing_prev = set(self._stream_missing)
            if confirmed:
                self._note_anomaly_locked("gap", len(confirmed))
                self._stream_missing -= confirmed
                self._stream_missing_prev -= confirmed
                self._relist_pending = True
            pending = self._relist_pending
        self._flush_anomaly_metrics()
        relisted = self._maybe_relist() if pending else False
        return relisted or bool(confirmed) or progressed

    def _maybe_relist(self) -> bool:
        """Run the gap-repair relist unless rate-limited (at most one
        per KBT_RELIST_MIN_INTERVAL on the injectable relist clock —
        a relist is an O(cluster) read and a storm of gaps must not
        turn into a storm of lists). While rate-limited the gap stays
        pending: the periodic anti-entropy sweep repairs the affected
        objects meanwhile, and the next eligible checkpoint relists."""
        now = self._relist_clock()
        with self.mutex:
            if (
                self._relist_last is not None
                and now - self._relist_last < self._relist_min_interval
            ):
                return False
            self._relist_last = now
        ok = False
        try:
            report = self.antientropy.full_reconcile()
            ok = report is not None
        except Exception:
            logger.exception("watch-gap relist failed; gap stays pending")
        with self.mutex:
            self._relist_stats["ok" if ok else "failed"] += 1
            if ok:
                self._relist_pending = False
                # The reconcile IS the stream state now: holes predating
                # it are repaired by construction.
                self._stream_missing.clear()
                self._stream_missing_prev.clear()
                cur = getattr(
                    self.cluster, "current_resource_version", None
                )
                if cur is not None:
                    try:
                        self._stream_max_rv = max(
                            self._stream_max_rv, int(cur())
                        )
                    except Exception:  # pragma: no cover - defensive
                        logger.exception("relist stream-rv adoption failed")
        try:
            from .. import metrics

            metrics.register_relist("ok" if ok else "failed")
        except Exception:  # pragma: no cover - metrics must never kill
            logger.exception("relist metric update failed")
        return True

    @property
    def antientropy(self) -> object:
        """The cluster-truth reconciler (cache/antientropy.py), shared
        by the periodic divergence sweep and the gap-repair relist.
        Constructed under the mutex: the first relist (resync thread)
        and the first periodic sweep (scheduler thread) can race here,
        and two engines would split the divergence counters."""
        if self._antientropy is None:
            from .antientropy import AntiEntropy

            with self.mutex:
                if self._antientropy is None:
                    self._antientropy = AntiEntropy(self)
        return self._antientropy

    def run_antientropy_if_due(self) -> Optional[dict]:
        """Scheduler hook: run the periodic anti-entropy sweep when its
        cadence says so (see AntiEntropy.sweep_if_due)."""
        if self.cluster is None:
            return None
        try:
            return self.antientropy.sweep_if_due()
        except Exception:  # the sweep must never fail a cycle
            logger.exception("anti-entropy sweep failed")
            return None

    def integrity_state(self) -> dict:
        """One JSON-friendly blob for /debug/vars and the sim report:
        absorbed event anomalies, gap/relist state, and the anti-entropy
        divergence counters."""
        with self.mutex:
            state = {
                "event_anomalies": dict(
                    sorted(self._event_anomalies.items())
                ),
                "stream_max_rv": self._stream_max_rv,
                "stream_missing": len(self._stream_missing),
                "relist_pending": self._relist_pending,
                "relists": dict(self._relist_stats),
            }
        ae = self._antientropy
        if ae is not None:
            state.update(ae.state_dict())
        else:
            state.update({
                "divergence_detected": {},
                "divergence_repaired": {},
                "sweeps": 0,
            })
        return state

    def start_ingest(self) -> None:
        """Attach the cluster watch and replay the initial object list
        (the informer-start half of :meth:`run`), WITHOUT starting the
        background resync/cleanup loops. The simulator uses this
        directly: it drains the retry queues itself at deterministic
        barrier points (:meth:`drain_resync_queue` /
        :meth:`drain_cleanup_queue`), so no free-running thread may
        race its virtual clock."""
        if self.cluster is not None:
            # Watch BEFORE the initial list so objects created during the list
            # are not lost; duplicate ADDs are tolerated (handlers key by uid).
            self.cluster.add_watch(self._on_watch_event)
            for kind in (
                "Node",
                "Queue",
                "PriorityClass",
                "PodGroup",
                "PodDisruptionBudget",
                "Pod",
            ):
                for obj in self.cluster.list_objects(kind):
                    self._on_watch_event(kind, ADDED, obj)
                    # Pin the guard memos to the listed versions so a
                    # late stale event predating the list is absorbed.
                    self._adopt_listed_rv(kind, obj)
            # The list is the stream position now: gap tracking starts
            # from the cluster's current event rv, not from whatever
            # watch event happens to arrive first.
            cur = getattr(self.cluster, "current_resource_version", None)
            if cur is not None:
                try:
                    with self.mutex:
                        self._stream_max_rv = max(
                            self._stream_max_rv, int(cur())
                        )
                        self._stream_baselined = True
                except Exception:  # pragma: no cover - defensive
                    logger.exception("initial stream-rv adoption failed")
            self._synced = True

    def run(self, stop_event: Optional[threading.Event] = None) -> None:
        """Start ingest + resync/cleanup loops (reference cache.go:355-377)."""
        self._stop = stop_event or threading.Event()
        self.start_ingest()
        threading.Thread(
            target=self._process_resync_loop, daemon=True, name="cache-resync"
        ).start()
        threading.Thread(
            target=self._process_cleanup_loop, daemon=True, name="cache-cleanup"
        ).start()

    def wait_for_cache_sync(self, stop_event=None, timeout: float = 10.0) -> bool:
        deadline = time.time() + timeout
        while not self._synced and time.time() < deadline:
            time.sleep(0.01)
        return self._synced

    # -- retry loops --------------------------------------------------------

    def _retry_delay(self, attempt: int) -> float:
        return min(self._base_retry_delay * (2**attempt), self._max_retry_delay)

    def _resync_task(self, task: TaskInfo, attempt: int = 0) -> None:
        """reference cache.go:588-595 (AddRateLimited analog) — with a
        terminal cap: past ``KBT_RESYNC_MAX_ATTEMPTS`` the task is
        dropped (``task_resync_terminal_total``) and named in its job's
        unschedulable verdict so ``explain``/`/debug/jobs` answer "where
        did that pod go"."""
        if attempt >= self._max_resync_attempts:
            self._drop_poisoned_task(task, attempt)
            return
        self.err_tasks.put((task, attempt))

    def _drop_poisoned_task(self, task: TaskInfo, attempt: int) -> None:
        logger.error(
            "task %s/%s dropped from resync after %d failed reconcile "
            "attempts (poisoned; will not be retried — external pod "
            "events re-admit it)",
            task.namespace, task.name, attempt,
        )
        try:
            from .. import metrics

            metrics.register_resync_terminal()
        except Exception:  # pragma: no cover - metrics must never kill
            logger.exception("resync-terminal metric update failed")
        try:
            from ..obs import explain

            with self.mutex:
                job = self.jobs.get(task.job)
                job_name = job.name if job is not None else task.name
            explain.note_resync_terminal(
                task.job, task.namespace, job_name,
                f"{task.namespace}/{task.name}", attempt,
            )
        except Exception:  # pragma: no cover - forensics only
            logger.exception("resync-terminal verdict note failed")

    def _queue_job_cleanup(self, job: JobInfo, attempt: int = 0) -> None:
        self.deleted_jobs.put((job, attempt))

    def _process_resync_loop(self) -> None:
        while not self._stop.is_set():
            try:
                task, attempt = self.err_tasks.get(timeout=0.2)
            except queue.Empty:
                # Idle beat: the watch-gap checkpoint (and its
                # rate-limited relist) runs here in production — the
                # same seam the simulator drives via drain_resync_queue.
                try:
                    self._check_watch_gap()
                except Exception:
                    logger.exception("watch-gap checkpoint failed")
                continue
            try:
                self._sync_task(task)
            except Exception:
                logger.exception("failed to resync task %s/%s", task.namespace, task.name)
                self._stop.wait(self._retry_delay(attempt))
                self._resync_task(task, attempt + 1)

    def drain_resync_queue(self) -> int:
        """Synchronously reconcile every queued failed-side-effect task,
        in sorted order (queue arrival order depends on worker-thread
        timing; sorting makes the drain — and therefore a simulated
        cycle's end state — deterministic). Returns the amount of work
        done (synced tasks, plus one when the watch-gap checkpoint made
        progress — callers loop this drain to quiescence, and a pending
        gap confirmation or relist IS unfinished work). The background
        resync loop and this drain are mutually exclusive by
        construction: the loop only runs when :meth:`run` started it,
        the drain is for callers that used :meth:`start_ingest`."""
        # Watch-gap checkpoint first: a confirmed gap's relist repairs
        # the mirror BEFORE stale tasks are reconciled against it.
        gap_work = False
        try:
            gap_work = self._check_watch_gap()
        except Exception:
            logger.exception("watch-gap checkpoint failed during drain")
        tasks = []
        while True:
            try:
                tasks.append(self.err_tasks.get_nowait())
            except queue.Empty:
                break
        tasks.sort(key=lambda item: (
            item[0].namespace, item[0].name, item[0].uid
        ))
        synced = 0
        for task, attempt in tasks:
            try:
                self._sync_task(task)
                synced += 1
            except Exception:
                # Mirror the background loop's retry contract: a failed
                # reconcile goes back on the queue (attempt+1) for the
                # next drain instead of silently dropping the task into
                # permanent staleness. Only SUCCESSFUL syncs count
                # toward the return value, so a poisoned task cannot
                # spin the caller's drain-until-quiescent loop.
                logger.exception(
                    "failed to resync task %s/%s during drain; requeued",
                    task.namespace, task.name,
                )
                self._resync_task(task, attempt + 1)
        return synced + (1 if gap_work else 0)

    def drain_cleanup_queue(self) -> int:
        """Synchronously process the deleted-job queue once: terminated
        jobs are removed from the mirror, the rest are re-queued (the
        loop form waits with backoff; the drain leaves them for the next
        barrier). Returns the number of jobs actually removed."""
        jobs = []
        while True:
            try:
                jobs.append(self.deleted_jobs.get_nowait())
            except queue.Empty:
                break
        removed = 0
        for job, attempt in sorted(
            jobs, key=lambda item: item[0].uid
        ):
            with self.mutex:
                terminated = job_terminated(job)
                if terminated:
                    self.jobs.pop(job.uid, None)
                    # Removal must reach the incremental snapshot's
                    # delta set or the stale entry outlives the job.
                    self._stamp_dirty(job.uid)
                    removed += 1
            if terminated:
                self._forget_job_metrics(job)
            else:
                self._queue_job_cleanup(job, attempt + 1)
        return removed

    def _process_cleanup_loop(self) -> None:
        """reference cache.go:556-585 (waits for JobTerminated)"""
        while not self._stop.is_set():
            try:
                job, attempt = self.deleted_jobs.get(timeout=0.2)
            except queue.Empty:
                continue
            with self.mutex:
                terminated = job_terminated(job)
                if terminated:
                    self.jobs.pop(job.uid, None)
                    self._stamp_dirty(job.uid)
            if terminated:
                self._forget_job_metrics(job)
            else:
                self._stop.wait(self._retry_delay(attempt))
                self._queue_job_cleanup(job, attempt + 1)

    @staticmethod
    def _forget_job_metrics(job: JobInfo) -> None:
        """Label-set GC: a removed job's per-job metric series
        (``unschedule_task_count`` / ``job_retry_counts``, keyed on the
        pod-group name the gang plugin labels with) must leave the
        registry with it — an unbounded-cardinality leak otherwise.
        The placement-latency ledger's per-pod entries GC on the same
        hook (per-subject observability state dies with the
        subject)."""
        try:
            from .. import metrics

            metrics.forget_job(job.name)
        except Exception:  # pragma: no cover - metrics must never kill
            logger.exception("job metric label GC failed")
        try:
            from ..obs.latency import LEDGER

            LEDGER.forget_job(job.uid)
        except Exception:  # pragma: no cover - forensics only
            logger.exception("latency ledger job GC failed")

    # -- snapshot (reference cache.go:612-659) --------------------------------

    def snapshot(self, micro: bool = False) -> ClusterInfo:
        """Deep-clone the schedulable world — with a copy-on-write pool.

        ``micro=True`` marks a micro-cycle snapshot: the incremental
        path may verify only the ledger-named positions (plus the
        appended arrival tail) instead of the full O(n) fingerprint
        compare — see _snapshot_incremental. Periodic snapshots always
        run the full verification and remain the reconciliation
        authority for any out-of-band mutation the ledgers missed.

        The reference re-clones everything each 1 Hz cycle
        (cache.go:612-659); at 50k tasks that alone busts the cycle
        budget (SURVEY §7 hard part (e)). Here each clone is cached and
        REUSED while (a) its source object hasn't changed — every
        JobInfo/NodeInfo mutator bumps ``_ver`` — and (b) the clone
        itself wasn't mutated by the session it was handed to (session
        allocate/pipeline/evict bump the clone's ``_ver``). Either bump
        forces a fresh clone, so cache state can never leak into or out
        of a session. Consequence of reuse: clones are shared between
        CONSECUTIVE snapshots when nothing changed in between — valid
        because a snapshot's objects are only ever mutated by its own
        session, and the scheduler runs sessions strictly one at a time
        (reference semantics: one runOnce per cycle, scheduler.go:84)."""
        # Barrier on deferred bind bookkeeping (bind_batch runs the
        # mirror update on the side-effect pool): a snapshot taken with
        # a half-applied batch would re-place already-bound tasks. In
        # the 1 Hz steady state the batch finished long ago and this is
        # a no-op; a timeout degrades to the reference's behavior —
        # schedule on the freshest mirror available and let resync
        # reconcile. Deliberately NOT wait_for_side_effects: a slow
        # per-task volume bind must not stall the next cycle.
        if not self.wait_for_bookkeeping(timeout=60.0):
            logger.warning(
                "bind bookkeeping still in flight after 60s; snapshotting "
                "the current mirror state"
            )
        with self.mutex:
            snap = ClusterInfo()
            if (
                self._snap_fp is not None
                and self._snap_fp_priority_gen == self._priority_gen
                and os.environ.get("KBT_SNAPSHOT_INCREMENTAL", "1") != "0"
            ):
                self._snapshot_incremental(snap, micro=micro)
            else:
                self._snapshot_full(snap)
            for name, q in self.queues.items():
                snap.queues[name] = q.clone()
            self._snap_gen += 1
            snap.snap_gen = self._snap_gen
            total = self._snap_total_allocatable
            snap.total_allocatable = (
                total.clone() if total is not None else None
            )
            # Fold this interval's full-dirty names into the backlog;
            # report the WHOLE backlog (names stay full-dirty until a
            # refresh absorbs them — see note_full_absorbed). A name
            # that ALSO saw a third-party event, now or in any
            # un-absorbed interval, stays conservatively full-dirty.
            self._full_backlog_jobs |= self._dirty_jobs
            self._full_backlog_nodes |= self._dirty_nodes
            snap.dirty_jobs = frozenset(self._full_backlog_jobs)
            snap.dirty_nodes = frozenset(self._full_backlog_nodes)
            snap.dirty_jobs_narrow = frozenset(
                self._dirty_jobs_alloc - self._full_backlog_jobs
            )
            snap.dirty_nodes_narrow = frozenset(
                self._dirty_nodes_alloc - self._full_backlog_nodes
            )
            self._dirty_jobs.clear()
            self._dirty_nodes.clear()
            self._dirty_jobs_alloc.clear()
            self._dirty_nodes_alloc.clear()
            self._touched_clone_jobs.clear()
            self._touched_clone_nodes.clear()
            return snap

    def note_clones_touched(
        self, job_uids: Iterable[str], node_names: Iterable[str]
    ) -> None:
        """A closing session reports the snapshot clones whose ``_ver``
        it bumped (allocate/pipeline/evict/dispatch and Statement ops).
        The micro fast-verification rechecks exactly these positions;
        without the report every clone would need the O(n) ``_ver``
        listcomp compare that dominates the warm-noop open floor."""
        with self.mutex:
            self._touched_clone_jobs.update(job_uids)
            self._touched_clone_nodes.update(node_names)

    def note_full_absorbed(self, job_keys, node_names) -> None:
        """A tensorize refresh ran against a session carrying these
        full-dirty names: drop them from the backlog (called by
        solver/snapshot._store_refresh_stats). Names stamped since that
        session's snapshot live in the live ledger, not the backlog, so
        this never forgets fresh churn."""
        with self.mutex:
            self._full_backlog_jobs.difference_update(job_keys)
            self._full_backlog_nodes.difference_update(node_names)

    def _job_priority(self, job: JobInfo) -> None:
        """Resolve job priority from the class map (cache.go:641-650)."""
        if self.enable_priority_class and job.pod_group is not None:
            job.priority = self.default_priority
            pc = self.priority_classes.get(
                job.pod_group.spec.priority_class_name
            )
            if pc is not None:
                job.priority = pc.value

    def _snapshot_full(self, snap: ClusterInfo) -> None:
        """The reference-shaped pool walk: touch every mirror object,
        re-cloning any whose source or clone fingerprint moved. Also
        (re)establishes the incremental baseline: the last-snapshot
        dicts, the ready-node allocatable running sum, and the
        verification fingerprint."""
        from ..api import Resource

        pool_jobs: Dict[str, tuple] = {}
        pool_nodes: Dict[str, tuple] = {}
        old_jobs, old_nodes = self._snap_pool
        total = Resource.empty()
        for name, node in self.nodes.items():
            if not node.ready():
                continue
            entry = old_nodes.get(name)
            if (
                entry is not None
                and entry[0] == node._ver
                and entry[2] == entry[1]._ver
            ):
                pool_nodes[name] = entry
            else:
                entry = pool_nodes[name] = _pool_entry(node)
            snap.nodes[name] = entry[1]
            total.add(entry[1].allocatable)
        for key, job in self.jobs.items():
            # Jobs without a scheduling spec (neither PodGroup nor the
            # legacy PDB source) are not schedulable
            # (reference cache.go:634-640).
            if job.pod_group is None and job.pdb is None:
                continue
            self._job_priority(job)
            entry = old_jobs.get(key)
            if (
                entry is not None
                and entry[0] == job._ver
                and entry[2] == entry[1]._ver
                and entry[1].priority == job.priority
            ):
                pool_jobs[key] = entry
            else:
                entry = pool_jobs[key] = _pool_entry(job)
            snap.jobs[key] = entry[1]
        # Entries for deleted objects fall away with the pool swap.
        self._snap_pool = (pool_jobs, pool_nodes)
        self._last_snap_jobs = dict(snap.jobs)
        self._last_snap_nodes = dict(snap.nodes)
        self._snap_total_allocatable = total
        self._refresh_snap_fingerprint()

    def _refresh_snap_fingerprint(self) -> None:
        """Rebuild the aligned verification lists over the CURRENT
        mirror + pool state (called after every full walk). Object
        references are pinned in the lists — identity compares against
        them are exact witnesses (a pinned object's id can never be
        recycled under a new object)."""

        def fp(mirror: dict, pool: dict):
            names = list(mirror.keys())
            objs = list(mirror.values())
            vers = [o._ver for o in objs]
            entries = [pool.get(name) for name in names]
            clone_vers = [
                e[1]._ver if e is not None else -1 for e in entries
            ]
            return [names, objs, vers, entries, clone_vers]

        pool_jobs, pool_nodes = self._snap_pool
        self._snap_fp = (
            fp(self.jobs, pool_jobs), fp(self.nodes, pool_nodes)
        )
        self._snap_fp_priority_gen = self._priority_gen
        # Position maps are rebuilt lazily on the next micro snapshot
        # (an eager rebuild would tax every full walk even when no
        # micro cycle ever consumes it).
        self._snap_fp_index = [None, None]

    def _snapshot_incremental(self, snap: ClusterInfo, micro: bool = False) -> None:
        """O(churn) pool update behind an exact O(n)-cheap verification:
        C-level list compares of per-object (identity, _ver) and
        per-pool-entry (identity via pinned reference, clone _ver)
        against the previous snapshot's fingerprint find EXACTLY the
        names whose mirror object or session clone moved — no trust in
        the dirty ledger or any caller-side reporting, so a test poking
        objects directly is caught like any watch event. Only those
        names re-run the pool walk body; everything else reuses its
        entry untouched. Key APPENDS (new pods/jobs/nodes) extend the
        fingerprint in place; a deletion or reorder falls back to the
        full walk, as does any priority-class change.
        KBT_SNAPSHOT_INCREMENTAL=0 forces the full walk every cycle.

        MICRO snapshots (``micro=True``, default-on via
        KBT_MICRO_VERIFY=ledger) skip the two O(n) Python-level ``_ver``
        listcomps — the dominant term of the warm-noop open floor at
        scale — and verify only (a) the positions named by the dirty
        ledgers (watch events + bind/evict bookkeeping, whose
        completeness kbtlint's dirty-ledger pass enforces) and the
        session clone-touch reports (note_clones_touched), plus (b) the
        appended arrival tail. A deletion named by the ledger still
        falls back to the full walk. Out-of-band pokes that bypass every
        ledger (nothing in-tree does) are caught at the next PERIODIC
        snapshot, which always runs the full compare — the periodic
        cycle stays the reconciliation authority. KBT_MICRO_VERIFY=full
        pins the older behavior: full verification on every snapshot."""
        job_fp, node_fp = self._snap_fp
        pool_jobs, pool_nodes = self._snap_pool

        def dirty_positions(fp, mirror, pool):
            names, objs, vers, entries, clone_vers = fp
            n = len(names)
            if len(mirror) < n:
                return None  # deletion: full walk
            cur_objs = list(mirror.values())
            appended = []
            if len(cur_objs) > n:
                # Python dicts append new keys at the end; if the first
                # n entries are untouched, the tail is pure arrival.
                cur_names = list(mirror.keys())
                if cur_names[:n] != names:
                    return None
                appended = list(range(n, len(cur_names)))
                names.extend(cur_names[n:])
                objs.extend(cur_objs[n:])
                vers.extend(o._ver for o in cur_objs[n:])
                entries.extend([None] * len(appended))
                clone_vers.extend([-1] * len(appended))
                cur_objs = cur_objs[:n]
            head_objs = objs[:n] if appended else objs
            idxs = []
            if not (cur_objs == head_objs
                    and vers[:n] == [o._ver for o in cur_objs]):
                idxs = [
                    i for i, o in enumerate(cur_objs)
                    if head_objs[i] is not o or vers[i] != o._ver
                ]
                if list(mirror.keys())[:n] != names[:n]:
                    return None  # replacement/reorder: full walk
                for i in idxs:
                    objs[i] = cur_objs[i]
                    vers[i] = cur_objs[i]._ver
            # Session clones mutate without touching the mirror object:
            # the pinned entry references read the CURRENT clone _ver.
            if clone_vers[:n] != [
                e[1]._ver if e is not None else -1 for e in entries[:n]
            ]:
                seen = set(idxs)
                for i in range(n):
                    e = entries[i]
                    cv = e[1]._ver if e is not None else -1
                    if cv != clone_vers[i] and i not in seen:
                        idxs.append(i)
            return sorted(idxs) + appended

        def dirty_positions_ledger(
            fp: tuple, which: int, mirror: dict,
            ledger: Iterable[str],
        ) -> Optional[List[int]]:
            names, objs, vers, entries, clone_vers = fp
            n = len(names)
            m = len(mirror)
            if m < n:
                return None  # deletion: full walk
            index = self._snap_fp_index[which]
            if index is None or len(index) != n:
                # First micro after a refresh / slow-path append: one
                # O(n) dict build, amortized over the micro burst.
                index = {nm: i for i, nm in enumerate(names)}
                self._snap_fp_index[which] = index
            appended = []
            if m > n:
                cur_names = list(mirror.keys())
                if cur_names[:n] != names:
                    return None  # replacement/reorder: full walk
                cur_objs = list(mirror.values())
                appended = list(range(n, m))
                names.extend(cur_names[n:])
                objs.extend(cur_objs[n:])
                vers.extend(o._ver for o in cur_objs[n:])
                entries.extend([None] * len(appended))
                clone_vers.extend([-1] * len(appended))
                for i in appended:
                    index[names[i]] = i
            hit = set()
            # sorted: the walk order decides nothing (hit is a set,
            # emitted sorted) but keeps record/replay traces byte-equal.
            for nm in sorted(ledger):
                pos = index.get(nm)
                if pos is None or pos >= n:
                    continue  # arrival (tail-covered) or came-and-went
                o = mirror.get(nm)
                if o is None:
                    return None  # ledger-named deletion: full walk
                if objs[pos] is not o or vers[pos] != o._ver:
                    objs[pos] = o
                    vers[pos] = o._ver
                    hit.add(pos)
                    continue
                e = entries[pos]
                cv = e[1]._ver if e is not None else -1
                if cv != clone_vers[pos]:
                    hit.add(pos)
            return sorted(hit) + appended

        fast = micro and os.environ.get(
            "KBT_MICRO_VERIFY", "ledger"
        ) != "full"
        if fast:
            node_idxs = dirty_positions_ledger(
                node_fp, 1, self.nodes,
                self._dirty_nodes | self._dirty_nodes_alloc
                | self._touched_clone_nodes,
            )
            job_idxs = dirty_positions_ledger(
                job_fp, 0, self.jobs,
                self._dirty_jobs | self._dirty_jobs_alloc
                | self._touched_clone_jobs,
            )
            if node_idxs is not None and job_idxs is not None:
                self.snap_ledger_verifies += 1
        else:
            node_idxs = dirty_positions(node_fp, self.nodes, pool_nodes)
            job_idxs = dirty_positions(job_fp, self.jobs, pool_jobs)
            self.snap_full_verifies += 1
        if node_idxs is None or job_idxs is None:
            self._snapshot_full(snap)
            return
        dirty_node_names = [node_fp[0][i] for i in node_idxs]
        dirty_job_keys = [job_fp[0][i] for i in job_idxs]

        nodes_out = self._last_snap_nodes
        jobs_out = self._last_snap_jobs
        total = self._snap_total_allocatable
        for pos, name in zip(node_idxs, dirty_node_names):
            # In-place assignment (never pop+reinsert for a live name):
            # dict position IS the snapshot row order the tensorize
            # caches key on — reordering would read as node-set churn.
            prev = nodes_out.get(name)
            if prev is not None:
                total.sub(prev.allocatable)
            node = self.nodes[name]
            if not node.ready():
                nodes_out.pop(name, None)
                pool_nodes.pop(name, None)
                self._fp_patch(node_fp, pos, None)
                continue
            entry = pool_nodes.get(name)
            if not (
                entry is not None
                and entry[0] == node._ver
                and entry[2] == entry[1]._ver
            ):
                entry = pool_nodes[name] = _pool_entry(node)
            nodes_out[name] = entry[1]
            total.add(entry[1].allocatable)
            self._fp_patch(node_fp, pos, entry)

        for pos, key in zip(job_idxs, dirty_job_keys):
            job = self.jobs[key]
            if job.pod_group is None and job.pdb is None:
                pool_jobs.pop(key, None)
                jobs_out.pop(key, None)
                self._fp_patch(job_fp, pos, None)
                continue
            self._job_priority(job)
            entry = pool_jobs.get(key)
            if not (
                entry is not None
                and entry[0] == job._ver
                and entry[2] == entry[1]._ver
                and entry[1].priority == job.priority
            ):
                entry = pool_jobs[key] = _pool_entry(job)
            jobs_out[key] = entry[1]
            self._fp_patch(job_fp, pos, entry)

        # Hand out copies: sessions mutate their dicts (_validate_jobs
        # deletes invalid jobs; _close rebinds but tests may poke).
        snap.jobs = dict(jobs_out)
        snap.nodes = dict(nodes_out)
        snap.incremental = True

    @staticmethod
    def _fp_patch(fp, pos: int, entry) -> None:
        """Re-point one verification-fingerprint position at the pool
        entry the walk just (re)minted — the mirror-side lists were
        already adopted during verification."""
        fp[3][pos] = entry
        fp[4][pos] = entry[2] if entry is not None else -1

    # -- event-driven micro-cycles ------------------------------------------

    def set_arrival_listener(self, listener) -> None:
        """Install ``listener()`` fired (outside the mutex) whenever a
        pending pod of this scheduler lands in the mirror — the
        micro-cycle wake-up signal (scheduler.run_micro)."""
        self._arrival_listener = listener

    def _notify_arrival(self) -> None:
        listener = self._arrival_listener
        if listener is not None:
            try:
                listener()
            except Exception:  # pragma: no cover - listener is advisory
                logger.exception("arrival listener failed")

    # -- bind-intent journal --------------------------------------------------

    def _journal_append(self, task_infos) -> Optional[int]:
        """Append one intent record covering ``task_infos`` (each with
        node_name set) to the cluster journal; returns the seq, or None
        when journaling is off or the append failed. A failed append is
        LOGGED and the binds proceed — availability beats perfect
        recoverability; the resync path still covers the tasks."""
        if not self.journal_enabled or not task_infos:
            return None
        tasks = []
        gang_jobs = set()
        for ti in task_infos:
            tasks.append({
                "uid": ti.uid,
                "pod": f"{ti.namespace}/{ti.name}",
                "node": ti.node_name,
                "job": ti.job,
            })
            gang_jobs.add(ti.job)
        gangs = {}
        with self.mutex:
            for job_key in sorted(gang_jobs):
                job = self.jobs.get(job_key)
                if job is not None and job.min_available > 1:
                    gangs[job_key] = job.min_available
        record = {
            "leader": self.leader_identity,
            "tasks": tasks,
            "gangs": gangs,
        }
        try:
            seq = self.cluster.append_bind_intent(record)
        except Exception:
            logger.exception(
                "bind-intent journal append failed for %d task(s); "
                "binds proceed unjournaled", len(tasks),
            )
            return None
        try:
            from .. import metrics

            metrics.register_journal_event("appended")
        except Exception:  # pragma: no cover - metrics must never kill
            logger.exception("journal metric update failed")
        return seq

    def _journal_mark(self, seq: Optional[int], task_uid: str,
                      outcome: str) -> None:
        """Mark one task's intent outcome (applied/failed); best-effort
        — an unmarked intent classifies via cluster truth at recovery."""
        if seq is not None:
            self._journal_mark_many(seq, {task_uid: outcome})

    def _journal_mark_many(self, seq: Optional[int], marks) -> None:
        """Batched mark flush for one drained bind chunk: ONE journal
        round trip (on a real cluster, one Lease CAS) instead of one
        per task. Best-effort like the single form."""
        if seq is None or not marks:
            return
        try:
            resolved = self.cluster.mark_bind_intents(seq, marks)
        except Exception:
            logger.exception(
                "bind-intent mark flush failed for %d task(s)", len(marks)
            )
            return
        try:
            from .. import metrics

            for outcome in sorted(marks.values()):
                metrics.register_journal_event(outcome)
            if resolved:
                metrics.register_journal_event("resolved")
        except Exception:  # pragma: no cover - metrics must never kill
            logger.exception("journal metric update failed")

    # -- side effects --------------------------------------------------------

    def _find_job_and_task(self, ti: TaskInfo):
        """reference cache.go:397-419"""
        job = self.jobs.get(ti.job)
        if job is None:
            raise KeyError(f"failed to find job <{ti.job}>")
        task = job.tasks.get(ti.uid)
        if task is None:
            raise KeyError(f"failed to find task <{ti.namespace}/{ti.name}>")
        return job, task

    def _bind_bookkeeping(self, task_info: TaskInfo, hostname: str,
                          add_to_node: bool = True,
                          update_status: bool = True):
        """Under-mutex half of bind: validate, move to Binding, and (by
        default) account on the node. Returns ``(job, task, prior)``
        where ``task`` is the STORED task and ``prior`` its
        (status, node_name) before the move — what a caller must restore
        to revert a bind the node later rejects. Caller must hold
        self.mutex. ``add_to_node=False`` defers the node accounting to
        the caller (bind_batch groups it per node);
        ``update_status=False`` defers the status-index move too (the
        caller bulk-moves per job) — node_name is still set here."""
        job, task = self._find_job_and_task(task_info)
        node = self.nodes.get(hostname)
        if node is None:
            raise KeyError(
                f"failed to bind Task {task.uid} to host {hostname}: "
                f"host does not exist"
            )
        # NARROW stamp: a bind applies exactly the deltas the scheduler
        # itself computed (idle/used/count on the node, a status-index
        # move on the job) — the delta-aware tensorize patches those
        # columns instead of rebuilding the row (solver/snapshot.py).
        self._stamp_dirty_alloc(task_info.job, hostname)
        if task.status not in (TaskStatus.PENDING, TaskStatus.ALLOCATED):
            raise ValueError(
                f"failed to bind Task {task.uid}: status is "
                f"{task.status.name}, expected Pending/Allocated"
            )
        prior = (task.status, task.node_name)
        if update_status:
            job.update_task_status(task, TaskStatus.BINDING)
        task.node_name = hostname
        if add_to_node:
            node.add_task(task)
        return job, task, prior

    def _bind_side_effect(self, pod, hostname, task_snapshot,
                          journal_seq: Optional[int] = None,
                          mark_sink=None) -> None:
        """Async half of bind. The volume bind wait (up to the reference's
        30s, cache.go:260-268) runs HERE on the side-effect pool, not in
        the scheduling loop — one slow volume must not stall every other
        job's cycle. A timeout/failure releases the claim assumptions and
        resyncs the task without binding the pod.

        ``mark_sink``: chunked callers pass a dict collecting this
        task's journal outcome; the chunk flushes them in ONE journal
        round trip (_journal_mark_many) instead of one per task."""
        if self._refused_by_fence(
            f"bind side effect {pod.namespace}/{pod.name} -> {hostname}"
        ):
            # No resync either: the task is the NEW leader's to place —
            # and no journal mark: the intent stays open for the
            # successor's recovery pass to classify against cluster
            # truth (a fenced leader cannot know what landed).
            return
        try:
            self.volume_binder.bind_volumes(task_snapshot)
            self.binder.bind(pod, hostname)
            if mark_sink is not None:
                mark_sink[task_snapshot.uid] = "applied"
            else:
                self._journal_mark(journal_seq, task_snapshot.uid, "applied")
            # Placement-latency ledger: the applied stamp rides the
            # journal-mark seam — the bind LANDED, so this timestamp is
            # the truthful end of the pod's arrival→bind latency.
            from ..obs.latency import LEDGER

            LEDGER.note_applied(task_snapshot.uid)
            if self.cluster is not None:
                self.cluster.record_event(
                    pod, "Normal", "Scheduled",
                    f"Successfully assigned {pod.namespace}/{pod.name} "
                    f"to {hostname}",
                )
        except Exception:
            try:
                self.volume_binder.release_volumes(task_snapshot)
            except Exception:
                logger.exception(
                    "failed to release volumes of %s", task_snapshot.uid
                )
            if mark_sink is not None:
                mark_sink[task_snapshot.uid] = "failed"
            else:
                self._journal_mark(journal_seq, task_snapshot.uid, "failed")
            # Bind failure restarts the pod's latency clock (requeued
            # stage): the next placement is measured from here.
            from ..obs.latency import LEDGER

            LEDGER.note_bind_failed(task_snapshot.uid)
            self._resync_task(task_snapshot)

    def bind(self, task_info: TaskInfo, hostname: str) -> None:
        """reference cache.go:480-522"""
        if self._refused_by_fence(f"bind {task_info.uid} -> {hostname}"):
            raise CacheFencedError(
                f"bind of {task_info.uid} refused: {self._fence_reason}"
            )
        with self.mutex:
            _, task, _ = self._bind_bookkeeping(task_info, hostname)
            pod, task_snapshot = task.pod, task.clone()

        if self.binder is not None:
            def _single_bind():
                # Journal on the worker, not the dispatching cycle (on
                # a real cluster an append is a blocking Lease CAS, and
                # per-task dispatch paths call bind() in a loop); the
                # append still strictly precedes the bind in this job.
                from ..obs.latency import LEDGER
                from ..obs.quality import QUALITY

                LEDGER.note_dispatched((task_snapshot.uid,))
                QUALITY.note_bound((task_snapshot.uid,))
                seq = self._journal_append([task_snapshot])
                self._bind_side_effect(
                    pod, hostname, task_snapshot, journal_seq=seq
                )

            self._submit_side_effect(_single_bind)

    # Batched side-effect jobs are chunked so (a) a 50k-task gang doesn't
    # monopolize one of the pool's workers for its whole serial run and
    # (b) all workers share the bind backlog.
    _BIND_CHUNK = 1024

    def bind_batch(self, task_infos, on_accepted=None) -> list:
        """Batched :meth:`bind`, fully asynchronous: the cache-mirror
        bookkeeping AND the bind side effects run on the side-effect
        pool, overlapping the scheduler's remaining cycle and its
        think-time between cycles — the session works on its own
        snapshot, so nothing in the running cycle reads the cache mirror
        (in the reference's profiles the mirror update was most of a
        cold 50k apply). :meth:`snapshot` barriers on in-flight side effects, so
        the NEXT cycle observes the completed bookkeeping or waits.

        Returns the input tasks optimistically. The rare task whose
        bookkeeping the node later rejects (solver drift) is reverted to
        its prior status by the async job and rescheduled next cycle —
        the same self-correction contract as the reference's
        assume-then-resync bind (cache.go:480-522)."""
        infos = list(task_infos)
        if infos and self._refused_by_fence(
            f"bind_batch of {len(infos)} tasks"
        ):
            return []
        if not infos:
            if on_accepted is not None:
                try:
                    on_accepted(infos)
                except Exception:  # same contract as the async path
                    logger.exception(
                        "bind_batch on_accepted callback failed"
                    )
            return infos
        self._submit_side_effect(
            lambda: self._bind_batch_bookkeeping(infos, on_accepted),
            bookkeeping=True,
        )
        return infos

    def _bind_batch_bookkeeping(self, task_infos, on_accepted=None) -> list:
        """Under-mutex half of bind_batch + side-effect submission.
        Runs on the side-effect pool. Per-task semantics are bind()'s:
        validation failures are logged and skipped, side-effect failures
        release volumes and resync that task only. Tasks whose volumes
        are NOT ready are submitted as individual jobs — their bind may
        block up to the volume-bind timeout, and a slow volume must not
        head-of-line-block the rest of the gang. Each task_info must have
        node_name set. Returns the tasks whose bookkeeping succeeded."""
        # Journal the batch's intent FIRST — on this worker, not the
        # scheduling loop (on a real cluster an append is a blocking
        # HTTP CAS with retries; the cycle must not pay it). The
        # journal-before-any-side-effect ordering is preserved: every
        # bind of this batch is submitted from THIS job, below, and a
        # crash before this point leaves no cluster write to classify.
        journal_seq = self._journal_append(task_infos)
        binds = []
        slow_binds = []  # volume wait possible: isolate per task
        bound = []
        # Journal marks for tasks that terminally fail DURING the
        # under-mutex staging (validation failure, node revert). The
        # marks are issued AFTER the mutex is released: on a real
        # cluster a mark is an HTTP CAS, and blocking network I/O under
        # cache.mutex is exactly the class kbtlint's lock-order pass
        # forbids (it would stall snapshot/ingest and could trip the
        # watchdog on a slow API server).
        failed_marks: list = []
        with self.mutex:
            # hostname -> [(ti, stored, prior status/node for revert)]
            staged: Dict[str, list] = {}
            by_job: Dict[int, tuple] = {}  # id(job) -> (job, [stored])
            for ti in task_infos:
                try:
                    job, stored, prior = self._bind_bookkeeping(
                        ti, ti.node_name, add_to_node=False,
                        update_status=False,
                    )
                    staged.setdefault(ti.node_name, []).append(
                        (ti, stored, job, prior)
                    )
                    by_job.setdefault(id(job), (job, []))[1].append(stored)
                except Exception:
                    logger.exception(
                        "failed to bind task %s/%s", ti.namespace, ti.name
                    )
                    # Resolve the intent (post-mutex): this task's bind
                    # will never be issued, so an open mark would pin
                    # the record in the journal for the leader's life.
                    failed_marks.append(ti.uid)
            # Status-index moves bulked per job (3rd of the 3 per-task
            # moves on the apply path; see JobInfo.update_tasks_status).
            for job, group in by_job.values():
                job.update_tasks_status(group, TaskStatus.BINDING)

            def accept(ti, stored, hostname):
                snapshot = stored.clone()
                # Volume readiness lives on the CALLER's (session) task —
                # the cache-side clone never sees the session's
                # allocate/bind_volumes writes. Propagate it so the async
                # side effect doesn't re-wait on ready volumes.
                snapshot.volume_ready = ti.volume_ready
                item = (stored.pod, hostname, snapshot)
                # Only a task that could actually block on a volume wait
                # needs per-task isolation: it has claims AND they are
                # not known-bound. A claims-less pod (the overwhelming
                # majority in a batch cluster) can never wait, whatever
                # volume_ready says — routing it to the slow path turns
                # a 50k-task gang into 50k executor submissions.
                may_wait = (
                    not ti.volume_ready and ti.pod.spec.volume_claims
                )
                (slow_binds if may_wait else binds).append(item)
                bound.append(ti)

            def revert(ti, stored, job, prior, hostname, why):
                # The per-task bind() path surfaces a node rejection to
                # its caller by raising; here the caller is gone by
                # side-effect time, so a silently dropped task would sit
                # in BINDING with node_name set and no resync until an
                # external pod event. Revert the staged bookkeeping so
                # the task is schedulable again next cycle.
                prior_status, prior_node = prior
                try:
                    job.update_task_status(stored, prior_status)
                    stored.node_name = prior_node
                    # Drop the claim assumptions made at allocate time,
                    # like the per-task failure path (_bind_side_effect)
                    # — a stale assumption on the rejected host would
                    # fail every future placement of this task.
                    if stored.pod.spec.volume_claims:
                        self.volume_binder.release_volumes(stored)
                except Exception:
                    logger.exception(
                        "failed to revert %s bind %s/%s; resyncing",
                        why, ti.namespace, ti.name,
                    )
                    self._resync_task(stored.clone())
                logger.warning(
                    "node %s %s staged bind of %s/%s; reverted to %s",
                    hostname, why, ti.namespace, ti.name,
                    prior_status.name,
                )
                # A reverted bind is terminally not-applied: resolve
                # the intent (post-mutex) so the record can self-clean.
                failed_marks.append(stored.uid)

            # Node accounting grouped per node (one aggregate idle/used
            # update; fallback policy in NodeInfo.add_tasks_with_fallback).
            for hostname, items in staged.items():
                node = self.nodes.get(hostname)
                if node is None:
                    # A node-delete watch event can land in the async
                    # window between dispatch and bookkeeping. Treat the
                    # whole group as rejected — same revert path — so
                    # the batch's remaining groups still proceed.
                    for ti, stored, job, prior in items:
                        revert(ti, stored, job, prior, hostname,
                               "vanished under")
                    continue
                ok = {
                    id(s) for s in node.add_tasks_with_fallback(
                        [stored for _, stored, _, _ in items]
                    )
                }
                for ti, stored, job, prior in items:
                    if id(stored) in ok:
                        accept(ti, stored, hostname)
                    else:
                        revert(ti, stored, job, prior, hostname,
                               "rejected")

        self._journal_mark_many(
            journal_seq, {uid: "failed" for uid in failed_marks}
        )
        # Placement-latency ledger (outside the mutex): staged binds
        # are DISPATCHED; validation failures / node rejections restart
        # their pods' clocks exactly like an async bind failure.
        from ..obs.latency import LEDGER
        from ..obs.quality import QUALITY

        LEDGER.note_dispatched([t.uid for t in bound])
        QUALITY.note_bound([t.uid for t in bound])
        for uid in failed_marks:
            LEDGER.note_bind_failed(uid, reason="bind-rejected")

        # Pre-warm the COW snapshot pool for everything this batch
        # dirtied: re-clone the touched jobs/nodes HERE, on the
        # bookkeeping worker, so the next cycle's snapshot reuses them
        # instead of paying a full-world re-clone after a busy cycle
        # (steady open was ~200 ms at 50k — pure clone cost). Open cost
        # then scales with what changed SINCE this batch, not with
        # cluster size. Against a live API server, bind-confirmation
        # watch events re-dirty these objects and the next snapshot
        # re-clones them anyway — then the prewarm is wasted worker
        # time, but it never blocks the scheduling loop, and the cycle
        # cost is identical to not prewarming. Per-object lock holds
        # (not one long hold) so a concurrent watch burst interleaves;
        # _snap_pool is re-read under each hold because snapshot()
        # swaps the pool maps. snapshot() cannot run concurrently with
        # this (it barriers on bookkeeping), so entries cannot be lost
        # to a swap mid-loop except on barrier timeout — where dropped
        # entries only cost a re-clone.
        for job, _ in by_job.values():
            with self.mutex:
                self._snap_pool[0][job.uid] = _pool_entry(job)
        for hostname in staged:
            with self.mutex:
                node = self.nodes.get(hostname)
                if node is not None:
                    self._snap_pool[1][hostname] = _pool_entry(node)

        if self.binder is not None:
            def _do_binds(chunk):
                # Chunked drain: journal marks collected per chunk and
                # flushed in one round trip (one Lease CAS on a real
                # cluster) — the fenced case leaves no sink entry, so
                # those intents stay open for the successor.
                marks: Dict[str, str] = {}
                for pod, hostname, task_snapshot in chunk:
                    self._bind_side_effect(
                        pod, hostname, task_snapshot,
                        journal_seq=journal_seq, mark_sink=marks,
                    )
                self._journal_mark_many(journal_seq, marks)

            for start in range(0, len(binds), self._BIND_CHUNK):
                chunk = binds[start:start + self._BIND_CHUNK]
                self._submit_side_effect(lambda c=chunk: _do_binds(c))
            for pod, hostname, task_snapshot in slow_binds:
                self._submit_side_effect(
                    lambda p=pod, h=hostname, s=task_snapshot:
                        self._bind_side_effect(
                            p, h, s, journal_seq=journal_seq
                        )
                )
        if on_accepted is not None:
            try:
                on_accepted(bound)
            except Exception:
                logger.exception("bind_batch on_accepted callback failed")
        return bound

    def evict(self, task_info: TaskInfo, reason: str) -> None:
        """reference cache.go:421-477"""
        if self._refused_by_fence(f"evict {task_info.uid}"):
            raise CacheFencedError(
                f"evict of {task_info.uid} refused: {self._fence_reason}"
            )
        with self.mutex:
            job, task = self._find_job_and_task(task_info)
            node = self.nodes.get(task.node_name)
            if node is None:
                raise KeyError(
                    f"failed to evict Task {task.uid}: host {task.node_name} "
                    f"does not exist"
                )
            self._stamp_dirty(task_info.job, task.node_name)
            job.update_task_status(task, TaskStatus.RELEASING)
            node.update_task(task)
            pod = task.pod
            task_snapshot = task.clone()
            if not shadow_pod_group(job.pod_group) and self.cluster is not None:
                self.cluster.record_event(
                    job.pod_group, "Normal", "Evict", reason
                )
        # Preempt/reclaim eviction restarts the victim's placement
        # clock (requeued stage) — outside the mutex, leaf-lock ledger.
        # The quality monitor counts the same event as disruption churn
        # (and remembers the uid so its next bind counts as a RE-bind).
        from ..obs.latency import LEDGER
        from ..obs.quality import QUALITY

        LEDGER.note_requeued(
            task_info.uid, reason="evicted", job=task_info.job
        )
        QUALITY.note_eviction(task_info.uid, reason)

        def _do_evict():
            if self._refused_by_fence(
                f"evict side effect {pod.namespace}/{pod.name}"
            ):
                return
            try:
                self.evictor.evict(pod)
            except Exception:
                self._resync_task(task_snapshot)

        if self.evictor is not None:
            self._submit_side_effect(_do_evict)

    # -- volumes -------------------------------------------------------------

    def allocate_volumes(self, task: TaskInfo, hostname: str) -> None:
        self.volume_binder.allocate_volumes(task, hostname)

    def allocate_volumes_batch(
        self, tasks, hostname: str, assign_node_name: bool = False
    ) -> list:
        """Batched :meth:`allocate_volumes` for one node's group.
        Claims-less pods (the overwhelming majority) are marked ready in
        one tight loop without a seam call per task; only claim-bearing
        pods go through the per-task binder. Returns the tasks whose
        volume allocation succeeded (failures logged and skipped, like
        the sequential apply loop). ``assign_node_name`` additionally
        stamps ``task.node_name = hostname`` on each successful task —
        the apply path otherwise paid a second full pass for it."""
        ok = []
        append = ok.append
        allocate = self.volume_binder.allocate_volumes
        for task in tasks:
            if task.pod.spec.volume_claims:
                try:
                    allocate(task, hostname)
                except Exception:
                    logger.exception(
                        "Failed to allocate volumes of Task %s on %s",
                        task.uid, hostname,
                    )
                    continue
            else:
                task.volume_ready = True
            if assign_node_name:
                task.node_name = hostname
            append(task)
        return ok

    def bind_volumes(self, task: TaskInfo) -> None:
        """Dispatch-time seam (session.go:294-316 calls BindVolumes before
        Bind). Ready volumes short-circuit here; UNready volumes are bound
        inside the async bind job (cache.bind._do_bind) so a slow volume
        wait never blocks the scheduling loop — a failed/timed-out bind
        there releases the claim assumptions and resyncs the task."""
        if task.volume_ready:
            self.volume_binder.bind_volumes(task)

    # -- status / events -----------------------------------------------------

    def task_unschedulable(self, task: TaskInfo, message: str) -> None:
        """FailedScheduling event + PodScheduled=False condition
        (reference cache.go:533-554)."""
        pod = task.pod
        condition = PodCondition(
            type="PodScheduled", status="False",
            reason="Unschedulable", message=message,
        )
        if self.cluster is not None:
            self.cluster.record_event(pod, "Warning", "FailedScheduling", message)
        if self.status_updater is not None:
            self.status_updater.update_pod_condition(pod, condition)

    def record_job_status_event(self, job: JobInfo) -> None:
        """reference cache.go:695-746"""
        base_message = (
            f"{len(job.task_status_index.get(TaskStatus.PENDING, {}))} pods "
            f"are yet to be scheduled"
        )
        if not job.ready():
            if self.cluster is not None and not shadow_pod_group(job.pod_group):
                self.cluster.record_event(
                    job.pod_group, "Warning", "Unschedulable",
                    f"{job.namespace}/{job.name}: {base_message}",
                )
        # reference cache.go:736-744 iterates [Allocated, Pending].
        job_err_msg = job.fit_error()
        for status in (TaskStatus.ALLOCATED, TaskStatus.PENDING):
            for task in job.task_status_index.get(status, {}).values():
                self.task_unschedulable(task, job_err_msg)

    def update_job_status(self, job: JobInfo) -> JobInfo:
        """Persist PodGroup status (reference cache.go:749-764)."""
        if not shadow_pod_group(job.pod_group):
            pg = job.pod_group
            pg.status.running = len(job.task_status_index.get(TaskStatus.RUNNING, {}))
            pg.status.succeeded = len(
                job.task_status_index.get(TaskStatus.SUCCEEDED, {})
            )
            pg.status.failed = len(job.task_status_index.get(TaskStatus.FAILED, {}))
            if self.status_updater is not None:
                self.status_updater.update_pod_group(pg)
        return job

    # -- lifecycle -----------------------------------------------------------

    def shutdown(self) -> None:
        self._stop.set()
        # Bookkeeping first: its jobs submit side-effect chunks onto the
        # shared pool, so draining it before the shared pool guarantees
        # no post-shutdown submissions.
        self._bookkeeping_executor.shutdown(wait=True)
        self._executor.shutdown(wait=True)
        # Release the solver's device-resident snapshot buffers with the
        # mirror they shadow (accelerator memory outlives nothing).
        dc = getattr(self, "_torch_device_cache", None)
        if dc is not None:
            dc.drop()

    # String (reference cache.go String()) omitted; repr is enough.
    def __repr__(self) -> str:
        # Under the mutex: a log line formatting the cache from another
        # thread must not read the maps mid-mutation (kbtlint
        # guarded-by; the mutex is reentrant, so repr-while-held works).
        with self.mutex:
            return (
                f"SchedulerCache(jobs={len(self.jobs)}, "
                f"nodes={len(self.nodes)}, queues={len(self.queues)})"
            )


def new_scheduler_cache(cluster: ClusterAPI, scheduler_name: str, default_queue: str,
                        **kwargs) -> SchedulerCache:
    """reference cache.go:68 New / :223 newSchedulerCache"""
    return SchedulerCache(
        cluster=cluster,
        scheduler_name=scheduler_name,
        default_queue=default_queue,
        **kwargs,
    )
