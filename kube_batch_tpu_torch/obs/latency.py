"""Placement-latency SLI ledger + replay-stable decision audit log.

Until now the only arrival-to-placement signal in the system was the
bench's single micro-cycle number; nothing answered "how long does a
pod wait, in which stage, per queue" — the question every subsequent
ROADMAP item (micro-primary flip, SLO serving classes, closed-loop
autotuning) needs answered continuously. Two instruments live here:

**PlacementLedger** — every pending pod of this scheduler is stamped at
arrival (``cache/event_handlers.add_pod``) and tracked through stage
transitions until its bind APPLIES (the journal-mark seam in
``cache._bind_side_effect`` — the applied timestamp is the truthful
one, not the dispatch):

- ``queue_wait``  arrival → the solving cycle that placed it (minus
  that cycle's solve time); cycles considered-but-unplaced are counted
  per job, tagged with the explain verdict reason;
- ``solve``       the placing cycle's tensorize+solve+apply time
  (attributed to every pod it placed), labeled with the cycle kind
  (periodic vs micro), warm outcome and winning solver rung;
- ``dispatch``    placed → bind batch staged on the side-effect pool;
- ``bind``        dispatch → bind applied (or failed);
- ``total``       arrival → applied.

Apart from the stages, ``note_placed`` returns the placing cycle's
per-job wait record (the time each pod waited for that cycle to start,
from the cycle start ``begin_cycle`` stamps), which ``allocate_tpu``
keeps as ``last_stats["job_waits"]``.

A bind failure or a preempt/evict RESTARTS the clock (``requeued``
stage, requeue counter); ledger entries are GC'd with their pod/job
(the metrics-GC pattern — no per-pod leak). Gang semantics: a
gang's latency is its LAST member's bind-applied; per-member and
per-gang (``gang_total``) series are both kept.

Aggregation: per-(queue, cycle-kind, stage) DDSketch percentiles
(reusing ``QuantileSketch``), the Prometheus histogram
``pod_placement_latency_seconds{stage,queue,cycle_kind}`` on
MS_BUCKETS, the ``/debug/latency`` + ``/debug/vars`` snapshots, the
flight-dump embed, and per-cycle ``placement_p99:<queue>`` /
``latency_entries`` telemetry series (the soak drift/leak detectors
fit those).

**AuditLog** — a bounded append-only ring (``KBT_AUDIT_CAPACITY``) of
one structured record per job per cycle it was touched: verdict or
placement, counts, victim-selection outcome, solver attribution, and
latency-so-far. Records are stamped with the LEDGER CLOCK — the
scheduler's injectable clock, so the simulator's audit stream is
virtual-clock-stamped and **byte-identical under replay**
(``make latency-smoke`` pins this; wall-clock never enters a record,
honoring the kbtlint replay-determinism contract). ``dump_jsonl``
writes one canonical-JSON record per line, flight-recorder style.

The enabled path is deliberately cheap (one small dict op per stage
transition under one lock); the bench ``obs`` section pins ledger +
audit cost against the same <1%-of-an-idle-cycle budget as the tracer.
``KBT_LATENCY=0`` disables both at the source.
"""

from __future__ import annotations

import itertools
import json
import logging
import os
import time
from collections import deque
from operator import itemgetter
from typing import Callable, Dict, Iterable, List, Optional, Tuple

from ..utils.lockdebug import witness_writes, wrap_lock
from .sketch import QuantileSketch

logger = logging.getLogger(__name__)

LATENCY_ENV = "KBT_LATENCY"                 # "0" disables ledger + audit
AUDIT_CAPACITY_ENV = "KBT_AUDIT_CAPACITY"   # audit ring size (records)
# Serving SLO-attainment target (fraction of serving placements that
# must meet their per-job latency target). Defines the violation
# budget: misses allowed = (1 - target) x targeted placements.
SERVING_TARGET_ENV = "KBT_SERVING_ATTAINMENT_TARGET"
DEFAULT_SERVING_TARGET = 0.99
DEFAULT_AUDIT_CAPACITY = 4096
# Completed-entry ring served by /debug/latency (forensics only — the
# percentile sketches are the durable aggregate).
DONE_CAPACITY = 256

# Stage taxonomy (doc/design/observability.md carries the full table).
STAGES = ("queue_wait", "solve", "dispatch", "bind", "total")
GANG_STAGE = "gang_total"

QUANTILES = (("p50", 0.5), ("p95", 0.95), ("p99", 0.99))


def latency_enabled_from_env() -> bool:
    return os.environ.get(LATENCY_ENV, "1") != "0"


def serving_target_from_env() -> float:
    try:
        t = float(os.environ.get(
            SERVING_TARGET_ENV, DEFAULT_SERVING_TARGET
        ))
    except ValueError:
        return DEFAULT_SERVING_TARGET
    return min(1.0, max(0.0, t))


class _PodEntry:
    """One pending pod's stage stamps (ledger-clock values)."""

    __slots__ = (
        "uid", "pod", "job", "queue", "arrival_ts", "placed_ts",
        "dispatch_ts", "stage", "cycle_kind", "solve_s", "requeues",
        "last_reason",
    )

    def __init__(self, uid: str, pod: str, job: str, now: float):
        self.uid = uid
        self.pod = pod
        self.job = job
        self.queue = ""
        self.arrival_ts = now
        self.placed_ts: Optional[float] = None
        self.dispatch_ts: Optional[float] = None
        self.stage = "pending"
        self.cycle_kind = "periodic"
        self.solve_s = 0.0
        self.requeues = 0
        self.last_reason: Optional[str] = None

    def restart(self, now: float, reason: str) -> None:
        """A retry/evict restarts the clock: the next placement's
        latency is measured from the requeue, not the first arrival."""
        self.arrival_ts = now
        self.placed_ts = None
        self.dispatch_ts = None
        self.solve_s = 0.0
        self.stage = "requeued"
        self.requeues += 1
        self.last_reason = reason

    def to_dict(self) -> dict:
        return {
            "uid": self.uid,
            "pod": self.pod,
            "job": self.job,
            "queue": self.queue,
            "stage": self.stage,
            "cycle_kind": self.cycle_kind,
            "arrival_ts": round(self.arrival_ts, 6),
            "requeues": self.requeues,
            "last_reason": self.last_reason,
        }


class _JobWait:
    """Per-job queue-wait bookkeeping: cycles considered-but-unplaced
    (tagged with the explain verdict reason) and gang accounting."""

    __slots__ = (
        "cycles_waited", "waiting_since", "last_reason", "queue",
        "first_arrival_ts", "arrivals", "applied",
    )

    def __init__(self, now: float):
        self.cycles_waited = 0
        self.waiting_since = now
        self.last_reason: Optional[str] = None
        self.queue = ""
        self.first_arrival_ts: Optional[float] = now
        self.arrivals = 0
        self.applied = 0


class _StageStats:
    __slots__ = ("count", "sum", "sketch")

    def __init__(self):
        self.count = 0
        self.sum = 0.0
        self.sketch = QuantileSketch()

    def add(self, v: float) -> None:
        self.count += 1
        self.sum += v
        self.sketch.add(v)

    def to_dict(self) -> dict:
        out = {
            "count": self.count,
            "mean_s": round(self.sum / self.count, 6) if self.count else 0.0,
        }
        for name, q in QUANTILES:
            out[f"{name}_s"] = round(self.sketch.quantile(q), 6)
        return out


class PlacementLedger:
    """Per-pod arrival→bind latency ledger (module docstring)."""

    def __init__(self):
        self._lock = wrap_lock("obs.latency")
        # Written ONLY here (construction) — hot-path reads stay
        # lock-free; tests flip it through configure().
        self.enabled = latency_enabled_from_env()
        self._clock = time.monotonic
        self.reset()
        # KBT_LOCK_DEBUG=2 write-witness (no-op otherwise).
        witness_writes(self, "obs.latency", (
            "_entries", "_by_job", "_jobs", "_sketches", "_done",
            "stamped", "applied", "bind_failures", "requeues",
            "gang_samples", "_cycle", "_cycle_kind", "_cycle_t0",
            "_serving_jobs", "_slo_targets", "_serving_pending",
            "_job_slo_applied", "_job_slo_missed", "_slo_counts",
            "_serving_arrival", "_serving_target",
        ))

    # -- lifecycle -----------------------------------------------------------

    def reset(self) -> None:
        """Drop all entries/sketches/counters (sim run boundaries,
        tests). The injected clock survives a reset."""
        with self._lock:
            self._entries: Dict[str, _PodEntry] = {}
            # job -> set of pending member uids (order never read —
            # gang closure only needs emptiness; a list would cost
            # O(members) per applied, O(n^2) per large gang).
            self._by_job: Dict[str, set] = {}
            self._jobs: Dict[str, _JobWait] = {}
            self._sketches: Dict[Tuple[str, str, str], _StageStats] = {}
            self._done: deque = deque(maxlen=DONE_CAPACITY)
            self.stamped = 0
            self.applied = 0
            self.bind_failures = 0
            self.requeues = 0
            self.gang_samples = 0
            self._cycle = 0
            self._cycle_kind = "periodic"
            self._cycle_t0 = 0.0
            # -- serving SLO accounting (doc/design/serving.md) --------
            # Jobs classified serving at arrival; jobs with a latency
            # target additionally keyed into _slo_targets.
            self._serving_jobs: set = set()
            self._slo_targets: Dict[str, float] = {}
            # uid -> SLO deadline (arrival/restart ts + target) for the
            # pending serving entries — the serving-pressure signal.
            self._serving_pending: Dict[str, float] = {}
            # Per-job targeted placements and misses (the preempt
            # gate's violation-budget input; GC'd with the job).
            self._job_slo_applied: Dict[str, int] = {}
            self._job_slo_missed: Dict[str, int] = {}
            # Per-class [targeted placements, met, missed].
            self._slo_counts: Dict[str, List[int]] = {}
            # Set on a serving arrival, consumed by the scheduler's
            # micro coalescing window (serving arrivals ride the
            # minimum window — highest coalescing priority).
            self._serving_arrival = False
            self._serving_target = serving_target_from_env()

    def configure(
        self,
        enabled: Optional[bool] = None,
        clock: Optional[Callable[[], float]] = None,
    ) -> None:
        """Install an injectable clock (the scheduler's — virtual in
        the simulator, so every stamp is replay-deterministic) and/or
        flip the enabled gate. ``clock=None`` leaves it unchanged."""
        with self._lock:
            if clock is not None:
                self._clock = clock
            if enabled is not None:
                object.__setattr__(self, "enabled", bool(enabled))

    def now(self) -> float:
        with self._lock:
            return self._clock()

    # -- cycle context -------------------------------------------------------

    def begin_cycle(self, cycle: int, kind: str = "periodic") -> None:
        """Stamp the current scheduling-cycle context (Scheduler
        run_once/run_micro) and its start on the ledger clock. Cycle
        numbers come from the scheduler's deterministic counter, so
        audit records replay bit-equal."""
        if not self.enabled:
            return
        with self._lock:
            self._cycle = int(cycle)
            self._cycle_kind = kind
            self._cycle_t0 = self._clock()

    def cycle_info(self) -> Tuple[int, str, float]:
        """(cycle, kind, ledger-clock now) for audit stamping."""
        with self._lock:
            return self._cycle, self._cycle_kind, self._clock()

    # -- stage transitions ---------------------------------------------------

    def note_arrival(
        self,
        uid: str,
        pod_key: str,
        job: str,
        workload_class: str = "batch",
        slo_target: Optional[float] = None,
    ) -> None:
        """A pending pod of ours landed in the mirror (the cache event
        handler's add_pod seam). Idempotent per uid. Serving pods carry
        their class + placement-latency target so the ledger can keep
        per-class SLO accounting and the serving-pressure signal."""
        if not self.enabled:
            return
        with self._lock:
            if uid in self._entries:
                return
            now = self._clock()
            self._entries[uid] = _PodEntry(uid, pod_key, job, now)
            self._track_locked(uid, job, now)
            self.stamped += 1
            if workload_class == "serving":
                self._serving_jobs.add(job)
                self._serving_arrival = True
                if slo_target is not None and slo_target > 0:
                    self._slo_targets[job] = float(slo_target)
                    self._serving_pending[uid] = now + float(slo_target)

    def _track_locked(self, uid: str, job: str, now: float) -> None:
        """Register one entry in the job index + wait record (caller
        holds the lock and has already created the entry)."""
        self._by_job.setdefault(job, set()).add(uid)
        jw = self._jobs.get(job)
        if jw is None:
            jw = self._jobs[job] = _JobWait(now)
        if jw.first_arrival_ts is None:
            # A new gang wave after the previous one fully applied.
            jw.first_arrival_ts = now
            jw.waiting_since = now
        jw.arrivals += 1

    def note_unplaced_job(
        self, job: str, reason: str, queue: str = "",
    ) -> Optional[Tuple[int, float, float]]:
        """One solving cycle considered this job and left it (partly)
        unplaced, classified as ``reason`` by obs/explain. Returns
        ``(cycles_waited, waiting_since, waiting_seconds)`` for the
        verdict detail, or None when disabled/unknown."""
        if not self.enabled:
            return None
        with self._lock:
            jw = self._jobs.get(job)
            if jw is None:
                jw = self._jobs[job] = _JobWait(self._clock())
            jw.cycles_waited += 1
            jw.last_reason = reason
            if queue:
                jw.queue = queue
            now = self._clock()
            return (
                jw.cycles_waited,
                round(jw.waiting_since, 6),
                round(max(0.0, now - jw.waiting_since), 6),
            )

    def job_wait_info(self, job: str) -> Optional[Tuple[int, float, float]]:
        """(cycles_waited, waiting_since, waiting_seconds) or None."""
        with self._lock:
            jw = self._jobs.get(job)
            if jw is None:
                return None
            now = self._clock()
            return (
                jw.cycles_waited,
                round(jw.waiting_since, 6),
                round(max(0.0, now - jw.waiting_since), 6),
            )

    def note_placed(
        self,
        uid_jobs: Iterable[Tuple[str, str]],
        job_queues: Dict[str, str],
        kind: str = "periodic",
        solve_s: float = 0.0,
    ) -> Optional[dict]:
        """The solve placed these tasks this cycle (allocate_tpu apply;
        ``uid_jobs`` is an iterable of ``(uid, job)``). Entries unknown
        to the ledger (tasks predating the process, bench sessions that
        bypass add_pod) are created here so dispatch/bind stages still
        measure.

        Returns the cycle's wait record, ``{"cycle": ledger cycle,
        "waits": [[pods placed, mean wait ms], ...]}`` with one pair
        per job in first-placed order, where a pod's wait is
        ``max(0, cycle start - arrival)`` on the ledger clock: the time
        it waited for the cycle that placed it, exactly (unlike
        ``queue_wait``, which counts the placing cycle's session too).
        None when disabled."""
        if not self.enabled:
            return None
        waits: Dict[str, List[float]] = {}
        with self._lock:
            now = self._clock()
            t0 = self._cycle_t0
            # A job's tasks come in runs: per-job work once a run.
            for job, run in itertools.groupby(uid_jobs, key=itemgetter(1)):
                queue = job_queues.get(job)
                n, total = 0, 0.0
                for uid, _ in run:
                    e = self._entries.get(uid)
                    if e is None:
                        e = self._entries[uid] = _PodEntry(uid, uid, job, now)
                        self._track_locked(uid, job, now)
                        self.stamped += 1
                    n += 1
                    if t0 > e.arrival_ts:
                        total += t0 - e.arrival_ts
                    e.placed_ts = now
                    e.stage = "placed"
                    e.cycle_kind = kind
                    e.solve_s = solve_s
                    if queue:
                        e.queue = queue
                if queue:
                    jw = self._jobs.get(job)
                    if jw is not None:
                        jw.queue = queue
                w = waits.get(job)
                if w is None:
                    waits[job] = [n, total]
                else:
                    w[0] += n
                    w[1] += total
            cycle = self._cycle
        return {"cycle": cycle,
                "waits": [[n, total * 1e3 / n] for n, total in waits.values()]}

    def note_dispatched(self, uids: Iterable[str]) -> None:
        """Bind batch staged on the side-effect pool for these tasks."""
        if not self.enabled:
            return
        with self._lock:
            now = self._clock()
            for uid in uids:
                e = self._entries.get(uid)
                if e is not None:
                    e.dispatch_ts = now
                    e.stage = "dispatched"

    def note_applied(self, uid: str) -> None:
        """The bind side effect APPLIED (the journal-mark seam): the
        truthful end of this pod's placement latency. Emits the stage
        samples, advances the gang accounting, and drops the entry."""
        if not self.enabled:
            return
        metric_samples: List[Tuple[str, str, str, float]] = []
        slo_sample: Optional[Tuple[str, bool]] = None
        with self._lock:
            e = self._entries.pop(uid, None)
            if e is None:
                return
            self._serving_pending.pop(uid, None)
            now = self._clock()
            placed = e.placed_ts if e.placed_ts is not None else (
                e.dispatch_ts if e.dispatch_ts is not None else now
            )
            dispatch = e.dispatch_ts if e.dispatch_ts is not None else placed
            solve = max(0.0, min(e.solve_s, placed - e.arrival_ts))
            stages = {
                "queue_wait": max(0.0, placed - e.arrival_ts - solve),
                "solve": solve,
                "dispatch": max(0.0, dispatch - placed),
                "bind": max(0.0, now - dispatch),
                "total": max(0.0, now - e.arrival_ts),
            }
            queue, kind = e.queue or "-", e.cycle_kind
            for stage, v in stages.items():
                self._stage_stats(queue, kind, stage).add(v)
                metric_samples.append((stage, queue, kind, v))
            self.applied += 1
            # SLO verdict at the truthful bind-applied moment: a pod of
            # a targeted job met its SLO iff total <= target.
            target = self._slo_targets.get(e.job)
            if target is not None:
                cls = (
                    "serving" if e.job in self._serving_jobs else "batch"
                )
                met = stages["total"] <= target
                counts = self._slo_counts.get(cls)
                if counts is None:
                    counts = self._slo_counts[cls] = [0, 0, 0]
                counts[0] += 1
                counts[1 if met else 2] += 1
                self._job_slo_applied[e.job] = (
                    self._job_slo_applied.get(e.job, 0) + 1
                )
                if not met:
                    self._job_slo_missed[e.job] = (
                        self._job_slo_missed.get(e.job, 0) + 1
                    )
                slo_sample = (cls, met)
            members = self._by_job.get(e.job)
            if members is not None and uid in members:
                members.remove(uid)
            jw = self._jobs.get(e.job)
            if jw is not None:
                jw.applied += 1
                if queue != "-":
                    jw.queue = queue
                # Gang semantics: the gang's latency is its LAST
                # member's bind-applied. When no member of the current
                # wave is left pending, close the wave; later arrivals
                # (rebirths, scale-ups) open a new one.
                if not members and jw.first_arrival_ts is not None:
                    gang_total = max(0.0, now - jw.first_arrival_ts)
                    if jw.applied > 1:
                        self._stage_stats(
                            jw.queue or queue, kind, GANG_STAGE
                        ).add(gang_total)
                        self.gang_samples += 1
                        metric_samples.append((
                            GANG_STAGE, jw.queue or queue, kind,
                            gang_total,
                        ))
                    jw.first_arrival_ts = None
                    jw.arrivals = 0
                    jw.applied = 0
                    jw.cycles_waited = 0
            self._done.append({
                "pod": e.pod, "job": e.job, "queue": queue,
                "cycle_kind": kind, "requeues": e.requeues,
                **{f"{k}_s": round(v, 6) for k, v in stages.items()},
            })
        # Prometheus outside the ledger lock (the registry has its own
        # locks; no cross-lock hold).
        try:
            from .. import metrics

            for stage, q, kind, v in metric_samples:
                metrics.observe_placement_latency(stage, q, kind, v)
            if slo_sample is not None:
                cls, met = slo_sample
                metrics.pod_slo_placements.inc(
                    (cls, "met" if met else "missed")
                )
                serving = self.serving_summary()
                metrics.serving_slo_attainment.set(
                    serving["attainment_pct"] / 100.0
                )
                metrics.serving_slo_budget_burn.set(
                    serving["budget_burn"]
                )
        except Exception:  # pragma: no cover - metrics must never kill
            logger.exception("placement latency metric update failed")

    def note_bind_failed(self, uid: str, reason: str = "bind-failed") -> None:
        """The bind side effect failed/reverted: the task goes back to
        scheduling, and its clock restarts (``requeued``)."""
        if not self.enabled:
            return
        with self._lock:
            e = self._entries.get(uid)
            if e is None:
                return
            e.restart(self._clock(), reason)
            self.bind_failures += 1
            self.requeues += 1
            self._restart_serving_deadline(e)
            jw = self._jobs.get(e.job)
            if jw is not None:
                jw.waiting_since = e.arrival_ts

    def note_requeued(self, uid: str, reason: str, job: str = "") -> None:
        """Preempt/evict restarts the pod's clock. An already-applied
        pod's entry was dropped at bind-applied — re-create it under
        its JOB (callers pass it) so the re-placement's gang accounting
        and per-queue series stay attributed; a job-less orphan entry
        would silently fall out of both."""
        if not self.enabled:
            return
        with self._lock:
            now = self._clock()
            e = self._entries.get(uid)
            if e is None:
                e = self._entries[uid] = _PodEntry(uid, uid, job, now)
                self._track_locked(uid, e.job, now)
                self.stamped += 1
            e.restart(now, reason)
            self.requeues += 1
            self._restart_serving_deadline(e)

    def _restart_serving_deadline(self, e: _PodEntry) -> None:
        """A restarted clock restarts the pod's SLO deadline too
        (caller holds the lock)."""
        target = self._slo_targets.get(e.job)
        if target is not None:
            self._serving_pending[e.uid] = e.arrival_ts + target

    # -- GC (the metrics-GC pattern: no per-pod leak) -----------------------

    def forget_pod(self, uid: str) -> None:
        with self._lock:
            self._serving_pending.pop(uid, None)
            e = self._entries.pop(uid, None)
            if e is None:
                return
            members = self._by_job.get(e.job)
            if members is not None:
                if uid in members:
                    members.remove(uid)
                if not members:
                    # Last tracked member gone: the wait record goes
                    # too (covers jobs whose cleanup hook never fires —
                    # e.g. shadow-group pods filed under the pod uid).
                    self._by_job.pop(e.job, None)
                    self._jobs.pop(e.job, None)
                    self._forget_job_serving_locked(e.job)

    def forget_job(self, job: str) -> None:
        """A job left the mirror (terminated-job cleanup): drop its
        wait record and every member entry with it."""
        with self._lock:
            for uid in self._by_job.pop(job, ()):
                self._entries.pop(uid, None)
                self._serving_pending.pop(uid, None)
            self._jobs.pop(job, None)
            self._forget_job_serving_locked(job)

    def _forget_job_serving_locked(self, job: str) -> None:
        """Per-job serving state dies with the job (metrics-GC
        pattern); the cumulative class counters are run-level and
        stay."""
        self._serving_jobs.discard(job)
        self._slo_targets.pop(job, None)
        self._job_slo_applied.pop(job, None)
        self._job_slo_missed.pop(job, None)

    # -- serving SLO surface (doc/design/serving.md) -------------------------

    def serving_arrival_pending(self, consume: bool = True) -> bool:
        """True when a serving pod arrived since the last check. The
        scheduler's micro coalescing window consumes this to give
        serving arrivals the minimum (highest-priority) window."""
        if not self.enabled:
            return False
        with self._lock:
            pending = self._serving_arrival
            if consume:
                self._serving_arrival = False
            return pending

    def serving_pressure(self) -> bool:
        """True when some pending serving pod has outlived its
        placement-latency target — the early-fairness-pass trigger
        (scheduler satellite: preempt/reclaim must not starve behind a
        micro-cycle storm while a serving SLO is burning)."""
        if not self.enabled:
            return False
        with self._lock:
            if not self._serving_pending:
                return False
            now = self._clock()
            return any(
                deadline <= now
                for deadline in self._serving_pending.values()
            )

    def serving_budget_ok(self, job: str) -> bool:
        """Whether ``job`` could absorb ONE more SLO miss and stay
        inside its violation budget (misses allowed = (1 - target) x
        targeted placements). The preempt/reclaim gate excludes serving
        victims for which this is False — evicting one forces a
        re-placement that is overwhelmingly likely to miss. Jobs
        without a latency target always pass (the replica floor is
        their only protection). Eviction-monotone and claimant-
        independent by construction: the verdict reads only the
        victim job's own cumulative counters, which evictions never
        improve."""
        if not self.enabled:
            return True
        with self._lock:
            if job not in self._slo_targets:
                return True
            applied = self._job_slo_applied.get(job, 0)
            missed = self._job_slo_missed.get(job, 0)
            allowed = (1.0 - self._serving_target) * applied
            return missed + 1 <= allowed

    def serving_summary(self) -> dict:
        """Per-class SLO accounting (/debug/vars ``serving`` key, sim
        report, bench): targeted placements, met/missed, attainment %,
        violation-budget burn (missed / allowed; >1 = budget blown)."""
        with self._lock:
            classes = {
                cls: {
                    "placed": counts[0],
                    "met": counts[1],
                    "missed": counts[2],
                    "attainment_pct": round(
                        100.0 * counts[1] / counts[0], 3
                    ) if counts[0] else 100.0,
                }
                for cls, counts in sorted(self._slo_counts.items())
            }
            serving = self._slo_counts.get("serving", [0, 0, 0])
            allowed = (1.0 - self._serving_target) * serving[0]
            return {
                "target": self._serving_target,
                "serving_jobs": len(self._serving_jobs),
                "pending_targeted": len(self._serving_pending),
                "classes": classes,
                "attainment_pct": (
                    round(100.0 * serving[1] / serving[0], 3)
                    if serving[0] else 100.0
                ),
                "violations": serving[2],
                "budget_burn": (
                    round(serving[2] / allowed, 3) if allowed > 0
                    else (float(serving[2]))
                ),
            }

    # -- aggregation ---------------------------------------------------------

    def _stage_stats(self, queue: str, kind: str, stage: str) -> _StageStats:
        key = (queue, kind, stage)
        stats = self._sketches.get(key)
        if stats is None:
            stats = self._sketches[key] = _StageStats()
        return stats

    def entry_count(self) -> int:
        with self._lock:
            return len(self._entries)

    def queue_p99_seconds(self) -> Dict[str, float]:
        """Per-queue p99 of the ``total`` stage (kinds merged by max —
        the SLI is the worst path), for the telemetry
        ``placement_p99:<queue>`` series the soak drift detector
        bounds."""
        with self._lock:
            out: Dict[str, float] = {}
            for (queue, _kind, stage), stats in self._sketches.items():
                if stage != "total" or queue == "-":
                    continue
                p99 = stats.sketch.quantile(0.99)
                if p99 > out.get(queue, 0.0):
                    out[queue] = p99
            return out

    def telemetry_sample(self) -> Dict[str, float]:
        """Per-cycle keys folded into the telemetry time-series:
        ledger occupancy (leak watermark) + per-queue p99."""
        values = {"latency_entries": float(self.entry_count())}
        for queue, p99 in self.queue_p99_seconds().items():
            values[f"placement_p99:{queue}"] = round(p99, 6)
        # Serving SLO-miss rate (cumulative; emitted only once serving
        # placements exist so batch-only telemetry stays unchanged) —
        # the soak drift detector bounds this series.
        with self._lock:
            serving = self._slo_counts.get("serving")
        if serving and serving[0]:
            values["serving_slo_miss_rate"] = round(
                serving[2] / serving[0], 6
            )
        return values

    def percentiles(self) -> dict:
        """Nested {queue: {cycle_kind: {stage: {count, mean, p50/p95/
        p99}}}} over everything applied so far."""
        with self._lock:
            out: dict = {}
            for (queue, kind, stage), stats in sorted(
                self._sketches.items()
            ):
                out.setdefault(queue, {}).setdefault(kind, {})[stage] = (
                    stats.to_dict()
                )
            return out

    def stage_percentiles(self) -> dict:
        """Queue/kind-merged per-stage percentiles (the bench
        ``arrival_latency`` headline rows). Merging re-folds the
        per-key sketches into one per stage — exactly mergeable by
        construction (log-bucket counts add)."""
        with self._lock:
            merged: Dict[str, _StageStats] = {}
            for (_q, _k, stage), stats in self._sketches.items():
                agg = merged.get(stage)
                if agg is None:
                    agg = merged[stage] = _StageStats()
                agg.count += stats.count
                agg.sum += stats.sum
                agg.sketch.merge(stats.sketch)
            return {
                stage: stats.to_dict()
                for stage, stats in sorted(merged.items())
            }

    def summary(self) -> dict:
        """Small engagement summary (/debug/vars, sim report, flight
        embed): counters + per-queue p99 + merged stage p99s."""
        with self._lock:
            counters = {
                "enabled": self.enabled,
                "stamped": self.stamped,
                "applied": self.applied,
                "pending_entries": len(self._entries),
                "bind_failures": self.bind_failures,
                "requeues": self.requeues,
                "gang_samples": self.gang_samples,
            }
        counters["queue_p99_s"] = {
            q: round(v, 6) for q, v in self.queue_p99_seconds().items()
        }
        counters["stage_p99_s"] = {
            stage: stats["p99_s"]
            for stage, stats in self.stage_percentiles().items()
        }
        counters["serving"] = self.serving_summary()
        return counters

    def snapshot(self) -> dict:
        """The ``/debug/latency`` payload: summary + full percentile
        tree + the recent completed-entry ring + live entry sample."""
        with self._lock:
            done = list(self._done)
            live = [
                e.to_dict() for _uid, e in sorted(self._entries.items())
            ][:64]
        return {
            "type": "placement-latency",
            **self.summary(),
            "percentiles": self.percentiles(),
            "recent_applied": done,
            "pending_sample": live,
        }


# -- decision audit log -------------------------------------------------------


class AuditLog:
    """Bounded append-only ring of per-(job, cycle) decision records
    (module docstring). Records carry ONLY deterministic fields —
    scheduler cycle counter, ledger-clock stamps (virtual in the sim),
    verdicts, counts — so a replayed sim emits a byte-identical stream.
    Wall-clock appears nowhere in a record; dump metadata that needs it
    stays out of the JSONL body."""

    def __init__(self, capacity: Optional[int] = None):
        if capacity is None:
            try:
                capacity = int(os.environ.get(
                    AUDIT_CAPACITY_ENV, DEFAULT_AUDIT_CAPACITY
                ))
            except ValueError:
                capacity = DEFAULT_AUDIT_CAPACITY
        self._lock = wrap_lock("obs.audit")
        self.capacity = max(16, capacity)
        self._reset_unlocked()
        witness_writes(self, "obs.audit", ("_seq", "dropped"))

    def _reset_unlocked(self) -> None:
        self._ring: deque = deque(maxlen=self.capacity)
        self._seq = 0
        self.dropped = 0

    def reset(self) -> None:
        with self._lock:
            self._reset_unlocked()

    def configure(self, capacity: int) -> None:
        with self._lock:
            self.capacity = max(16, int(capacity))
            self._reset_unlocked()

    def append(self, record: dict) -> None:
        """Append one decision record; stamps the monotone seq and the
        ledger cycle context (cycle, kind, vclock)."""
        if not LEDGER.enabled:
            return
        cycle, kind, now = LEDGER.cycle_info()
        with self._lock:
            self._seq += 1
            if len(self._ring) == self._ring.maxlen:
                self.dropped += 1
            self._ring.append({
                "seq": self._seq,
                "cycle": cycle,
                "kind": record.get("kind", kind),
                "vclock": round(now, 6),
                **{k: v for k, v in record.items() if k != "kind"},
            })

    def records(self) -> List[dict]:
        with self._lock:
            return [dict(r) for r in self._ring]

    def meta(self) -> dict:
        with self._lock:
            return {
                "capacity": self.capacity,
                "records": len(self._ring),
                "seq": self._seq,
                "dropped": self.dropped,
            }

    def dump_lines(self) -> List[str]:
        """Canonical JSONL body (sorted keys, one record per line) —
        the byte-compared replay artifact."""
        return [
            json.dumps(r, sort_keys=True) for r in self.records()
        ]

    def dump_jsonl(self, path: str) -> str:
        """Write the stream to ``path`` (write-then-rename, like the
        flight recorder's dumps)."""
        parent = os.path.dirname(os.path.abspath(path))
        os.makedirs(parent, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "w") as f:
            for line in self.dump_lines():
                f.write(line + "\n")
        os.replace(tmp, path)
        return path


LEDGER = PlacementLedger()
AUDIT = AuditLog()
