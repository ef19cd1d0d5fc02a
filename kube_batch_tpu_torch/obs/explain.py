"""Pending-gang explainability: structured "why is this job not running".

Two granularities:

- **Per-cycle verdicts** (:func:`record_cycle_verdicts`, called by
  allocate_tpu after every solve): cheap classification of each job
  that still has unassigned tasks, from data the cycle already
  computed — the combined predicate mask's feasibility row for a
  representative pending task, the queue's overused state, gang
  readiness after apply, and the sparse solve's truncation flags.
  Stored in a process-wide registry keyed by job uid (the
  ``/debug/jobs`` endpoint and the ``explain`` CLI read it), stamped
  onto the session JobInfo as ``last_unschedulable``, and exported as
  the reason-labeled ``tpu_batch_unschedulable_tasks`` metric.

- **On-demand diagnosis** (:func:`diagnose_job`): the expensive
  per-(task, node) walk through the scalar predicate chain, tallying
  which named predicate (PodFitsHostPorts, PodToleratesNodeTaints,
  MatchNodeSelector, ...) rejected how many nodes, plus resource-fit
  shortfalls — the "gang needs 8, only 5 feasible nodes; 3 blocked by
  predicates: node-ports(2), toleration(1)" answer. Runs only for one
  job at a time (CLI / endpoint query), never in the hot cycle.

Reason taxonomy (doc/design/observability.md carries the full table):
``predicate-blocked`` > ``queue-overused`` > ``refill-exhausted`` >
``gang-minmember`` > ``no-fit`` — first matching verdict wins.
"""

from __future__ import annotations

import json
import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from ..utils.lockdebug import wrap_lock

logger = logging.getLogger(__name__)

REASON_PREDICATE = "predicate-blocked"
REASON_QUEUE = "queue-overused"
REASON_REFILL = "refill-exhausted"
REASON_GANG = "gang-minmember"
REASON_NO_FIT = "no-fit"

# Every reason the verdict classifier can emit, in precedence order;
# the metric helper zeroes absent reasons from exactly this list so
# stale gauge labels never linger.
REASON_RESYNC = "resync-terminal"

ALL_REASONS = (
    REASON_PREDICATE, REASON_QUEUE, REASON_REFILL, REASON_GANG,
    REASON_NO_FIT, REASON_RESYNC,
)


@dataclass
class JobVerdict:
    """Last unschedulable reason for one job (one solve cycle)."""

    uid: str
    namespace: str
    name: str
    queue: str
    reason: str
    message: str
    unassigned: int
    cycle_seq: Optional[int] = None
    ts: float = 0.0
    detail: Dict = field(default_factory=dict)

    def to_dict(self) -> dict:
        return {
            "uid": self.uid,
            "namespace": self.namespace,
            "name": self.name,
            "queue": self.queue,
            "reason": self.reason,
            "message": self.message,
            "unassigned": self.unassigned,
            "cycle_seq": self.cycle_seq,
            "ts": self.ts,
            "detail": dict(self.detail),
        }


_lock = wrap_lock("obs.explain")
# job uid -> JobVerdict (the process-wide registry behind /debug/jobs
# and the explain CLI).
VERDICTS: Dict[str, JobVerdict] = {}
# job uid -> latest preempt/reclaim victim-selection outcome, folded
# into the job's next verdict detail (actions note these as they run).
_VICTIM_NOTES: Dict[str, dict] = {}
# job uid -> {task key: {attempts, ts}} for tasks the cache dropped
# terminally from the resync queue (cache._drop_poisoned_task). Sticky
# (unlike victim notes): the drop is permanent, so every later verdict
# for the job keeps naming the task until the job leaves the registry.
_RESYNC_NOTES: Dict[str, Dict[str, dict]] = {}


def get_verdict(uid: str) -> Optional[JobVerdict]:
    with _lock:
        return VERDICTS.get(uid)


def all_verdicts() -> List[JobVerdict]:
    with _lock:
        return list(VERDICTS.values())


def clear() -> None:
    with _lock:
        VERDICTS.clear()
        _VICTIM_NOTES.clear()
        _RESYNC_NOTES.clear()


def note_resync_terminal(
    job_uid: str, namespace: str, job_name: str, task_key: str,
    attempts: int,
) -> None:
    """The cache dropped ``task_key`` from the resync queue terminally
    (poisoned: ``attempts`` consecutive reconcile failures). Record it
    immediately — a standalone ``resync-terminal`` verdict when the job
    has none yet, a detail note otherwise — so ``explain <job>`` and
    ``/debug/jobs`` name the task without waiting for the next solve
    cycle to classify the job."""
    now = time.time()
    note = {"attempts": int(attempts), "ts": now}
    with _lock:
        _RESYNC_NOTES.setdefault(job_uid, {})[task_key] = note
        tasks = dict(_RESYNC_NOTES[job_uid])
        v = VERDICTS.get(job_uid)
        if v is None:
            v = JobVerdict(
                uid=job_uid, namespace=namespace, name=job_name,
                queue="", reason=REASON_RESYNC,
                message=(
                    f"task {task_key} dropped from resync after "
                    f"{attempts} failed reconcile attempts"
                ),
                unassigned=0, ts=now,
            )
            VERDICTS[job_uid] = v
        v.detail["resync_terminal"] = tasks
        if v.reason == REASON_RESYNC:
            # The standalone verdict's unassigned count is the number
            # of terminally-dropped tasks, so the reason-labeled gauge
            # (which sums verdict.unassigned per reason on idle-cycle
            # re-derivation) actually reports the drops.
            v.unassigned = len(tasks)


def note_victim_outcome(
    job_uid: str, action: str, victims: int, placed: bool
) -> None:
    """Record a preempt/reclaim attempt's victim-selection outcome for
    a claimant job — whether victims were found and whether the
    claimant actually got pipelined onto the freed capacity."""
    with _lock:
        _VICTIM_NOTES[job_uid] = {
            "action": action,
            "victims": int(victims),
            "placed": bool(placed),
            "ts": time.time(),
        }


def _classify(feasible, overused, min_available, ready_now, sparse):
    """(reason, qualifier message) from the cheap per-cycle evidence.

    Structural reasons win: truncated candidate slabs are the NORMAL
    state of an engaged sparse solve (every class with more than K
    feasible nodes truncates) and both backends drain slab exhaustion
    to exact verdicts (device: dense-tail refill stages; native: bounded
    widen + per-task scan overflow), so truncation alone must never
    relabel a gang/no-fit verdict. ``refill-exhausted`` fires only when
    the solve itself signalled exhaustion pressure (``exhausted``) —
    the verdict may then be a top-K artifact rather than true
    infeasibility."""
    if feasible == 0:
        return REASON_PREDICATE, "no node passes the predicate mask"
    if overused:
        return REASON_QUEUE, "queue is above its deserved share"
    if sparse and sparse.get("engaged") and sparse.get("exhausted"):
        return REASON_REFILL, (
            "sparse solve exhausted its truncated candidate slab "
            "(K=%s); verdict may be a top-K artifact" % sparse.get("k")
        )
    if min_available > max(1, ready_now):
        return REASON_GANG, (
            f"gang needs {min_available}, has {ready_now} ready"
        )
    return REASON_NO_FIT, "feasible nodes lack capacity"


def record_cycle_verdicts(ssn, ctx, assigned, sparse=None) -> Dict[str, int]:
    """Classify every job the solve left (partly) unassigned; update
    the registry, the JobInfo, and the reason-labeled metric. Returns
    ``{reason: unassigned task count}`` (also handed to the flight
    recorder by the caller). Cost scales with the UNASSIGNED task
    count, not T — a healthy cycle pays almost nothing."""
    from .. import metrics

    T = len(ctx.tasks)
    a = np.asarray(assigned[:T])
    unassigned_idx = np.nonzero(a < 0)[0]

    # job uid -> (representative unassigned index, count). Grouped via
    # the snapshot's dense job-segment ids when available: a saturated
    # 50k cluster can leave tens of thousands unassigned, and the
    # numpy unique keeps this pass O(#pending-jobs) Python work.
    per_job: Dict[str, list] = {}
    host = getattr(ctx, "host_inputs", None)
    if unassigned_idx.size and host is not None:
        job_seg = np.asarray(host.task_job[:T])[unassigned_idx]
        _uniq, first, counts = np.unique(
            job_seg, return_index=True, return_counts=True
        )
        for k in range(first.size):
            rep = int(unassigned_idx[first[k]])
            per_job[ctx.tasks[rep].job] = [rep, int(counts[k])]
    else:
        for i in unassigned_idx.tolist():
            uid = ctx.tasks[i].job
            ent = per_job.get(uid)
            if ent is None:
                per_job[uid] = [i, 1]
            else:
                ent[1] += 1

    reason_counts: Dict[str, int] = {}
    now = time.time()
    with _lock:
        notes = dict(_VICTIM_NOTES)
        _VICTIM_NOTES.clear()
        resync_notes = {k: dict(v) for k, v in _RESYNC_NOTES.items()}
    from . import latency as latency_mod

    micro = bool(getattr(ssn, "micro_cycle", False))
    cycle_kind = "micro" if micro else "periodic"
    new_verdicts: Dict[str, JobVerdict] = {}
    for uid, (rep, count) in per_job.items():
        job = ssn.jobs.get(uid)
        if job is None:
            continue
        feasible = (
            int(ctx.mask.row(rep).sum()) if ctx.mask is not None else -1
        )
        queue = ssn.queues.get(job.queue)
        try:
            overused = queue is not None and ssn.overused(queue)
        except Exception:
            overused = False
        ready_now = job.ready_task_num()
        reason, qualifier = _classify(
            feasible, overused, job.min_available, ready_now, sparse
        )
        reason_counts[reason] = reason_counts.get(reason, 0) + count
        detail = {
            "pending_unassigned": count,
            "min_available": job.min_available,
            "ready_tasks": ready_now,
            "feasible_nodes": feasible,
            "queue_overused": overused,
        }
        if sparse:
            detail["sparse"] = dict(sparse)
        note = notes.get(uid)
        if note is not None:
            detail["victim_selection"] = note
        dropped = resync_notes.get(uid)
        if dropped:
            # Sticky: terminally-dropped tasks keep being named until
            # the job leaves the registry.
            detail["resync_terminal"] = dropped
        # Placement-latency ledger: this cycle considered the job and
        # left it unplaced — bump its queue-wait counter (tagged with
        # the verdict reason) and carry "how long" in the detail so
        # `explain <job>` / /debug/jobs answer how-long-and-why in one
        # query. One decision-audit record per touched job rides along.
        try:
            wait = latency_mod.LEDGER.note_unplaced_job(
                uid, reason, queue=job.queue
            )
            if wait is not None:
                detail["cycles_waited"] = wait[0]
                detail["waiting_since"] = wait[1]
                detail["waiting_seconds"] = wait[2]
            audit_rec = {
                "action": "unassigned",
                "job": uid,
                "queue": job.queue,
                "reason": reason,
                "count": count,
                "kind": cycle_kind,
                "waited_cycles": wait[0] if wait is not None else None,
            }
            if note is not None:
                audit_rec["victim_action"] = note["action"]
                audit_rec["victims"] = note["victims"]
                audit_rec["victim_placed"] = note["placed"]
            latency_mod.AUDIT.append(audit_rec)
        except Exception:  # pragma: no cover - forensics only
            logger.exception("latency ledger verdict update failed")
        message = (
            f"{count} task(s) unassigned: {qualifier}; representative "
            f"task has {feasible} feasible node(s)"
        )
        verdict = JobVerdict(
            uid=uid, namespace=job.namespace, name=job.name,
            queue=job.queue, reason=reason, message=message,
            unassigned=count, ts=now, detail=detail,
        )
        new_verdicts[uid] = verdict
        # In-session surface (consumed by gang's close-time conditions
        # and anything else holding the snapshot JobInfo).
        job.last_unschedulable = verdict

    from ..api import TaskStatus

    with _lock:
        VERDICTS.update(new_verdicts)
        # Drop verdicts for jobs that recovered (became ready, have no
        # pending tasks left, or left the cluster).
        for uid in list(VERDICTS):
            if uid in new_verdicts:
                continue
            job = ssn.jobs.get(uid)
            if (
                job is None
                or job.ready()
                or not job.task_status_index.get(TaskStatus.PENDING)
            ):
                VERDICTS.pop(uid, None)
                _RESYNC_NOTES.pop(uid, None)
            elif VERDICTS[uid].reason == REASON_RESYNC:
                # Surviving standalone resync-terminal verdicts describe
                # tasks the cache dropped — they are never in ctx.tasks,
                # so the per-cycle classification above cannot count
                # them. Fold them in here, or the absent-reason zeroing
                # in update_unschedulable_reasons erases the gauge
                # bucket on every busy cycle.
                reason_counts[REASON_RESYNC] = (
                    reason_counts.get(REASON_RESYNC, 0)
                    + VERDICTS[uid].unassigned
                )

    metrics.update_unschedulable_reasons(reason_counts)
    return reason_counts


def record_idle_cycle(ssn) -> None:
    """Idle solve (no pending, non-best-effort tasks — tensorize
    returned nothing): drop verdicts for jobs that recovered or left
    the cluster and re-derive the reason gauge from what survives, so
    neither the registry nor ``tpu_batch_unschedulable_tasks`` carries
    a stale bucket after the backlog drains."""
    from .. import metrics
    from ..api import TaskStatus

    counts: Dict[str, int] = {}
    with _lock:
        for uid in list(VERDICTS):
            job = ssn.jobs.get(uid)
            if (
                job is None
                or job.ready()
                or not job.task_status_index.get(TaskStatus.PENDING)
            ):
                VERDICTS.pop(uid, None)
                _RESYNC_NOTES.pop(uid, None)
            else:
                v = VERDICTS[uid]
                counts[v.reason] = counts.get(v.reason, 0) + v.unassigned
    metrics.update_unschedulable_reasons(counts)


# ---------------------------------------------------------------- diagnosis


def diagnose_job(ssn, job, max_pairs: int = 250_000) -> dict:
    """Deep per-(task, node) diagnosis of one pending job: walk the
    scalar predicate chain per node and tally rejections by the named
    predicate, then check resource fit on the surviving nodes.
    ``max_pairs`` bounds the walk (tasks are truncated, never nodes —
    gang members usually share a template so the representative rows
    are what matters)."""
    from ..api import TaskStatus
    from ..plugins.util import PredicateError

    pending = list(
        job.task_status_index.get(TaskStatus.PENDING, {}).values()
    )
    nodes = list(ssn.nodes.values())
    n_nodes = len(nodes)
    max_tasks = max(1, max_pairs // max(1, n_nodes))
    sampled = pending[:max_tasks]

    per_task = []
    for task in sampled:
        blocked: Dict[str, int] = {}
        feasible = no_fit = releasing_only = 0
        for node in nodes:
            try:
                ssn.predicate_fn(task, node)
            except PredicateError as e:
                blocked[e.reason] = blocked.get(e.reason, 0) + 1
                continue
            except Exception as e:  # scalar plugin without a reason
                key = type(e).__name__
                blocked[key] = blocked.get(key, 0) + 1
                continue
            if task.init_resreq.less_equal(node.idle):
                feasible += 1
            elif task.init_resreq.less_equal(node.releasing):
                releasing_only += 1
            else:
                no_fit += 1
        per_task.append({
            "task": f"{task.namespace}/{task.name}",
            "feasible_nodes": feasible,
            "no_fit_nodes": no_fit,
            "releasing_only_nodes": releasing_only,
            "blocked_by": blocked,
        })

    rep = per_task[0] if per_task else {
        "feasible_nodes": 0, "no_fit_nodes": 0,
        "releasing_only_nodes": 0, "blocked_by": {},
    }
    verdict = get_verdict(job.uid)
    return {
        "job": job.uid,
        "namespace": job.namespace,
        "name": job.name,
        "queue": job.queue,
        "min_available": job.min_available,
        "pending_tasks": len(pending),
        "ready_tasks": job.ready_task_num(),
        "nodes": n_nodes,
        "sampled_tasks": len(sampled),
        "representative": rep,
        "per_task": per_task[:8],
        "last_verdict": verdict.to_dict() if verdict else None,
    }


def format_diagnosis(diag: dict) -> str:
    """Human-readable explain output ("gang needs 8, only 5 feasible
    nodes; 3 blocked by predicates: ...")."""
    rep = diag["representative"]
    blocked = rep.get("blocked_by", {})
    lines = [
        f"job {diag['job']} (queue {diag['queue'] or '-'}): "
        f"gang needs {diag['min_available']}, has {diag['ready_tasks']} "
        f"ready; {diag['pending_tasks']} task(s) pending",
        f"  {rep['feasible_nodes']}/{diag['nodes']} node(s) feasible "
        f"for the representative pending task",
    ]
    if blocked:
        parts = ", ".join(
            f"{reason}({count})"
            for reason, count in sorted(
                blocked.items(), key=lambda kv: (-kv[1], kv[0])
            )
        )
        total = sum(blocked.values())
        lines.append(f"  {total} node(s) blocked by predicates: {parts}")
    if rep.get("no_fit_nodes"):
        lines.append(
            f"  {rep['no_fit_nodes']} node(s) pass predicates but lack "
            f"capacity"
        )
    if rep.get("releasing_only_nodes"):
        lines.append(
            f"  {rep['releasing_only_nodes']} node(s) only fit via "
            f"releasing capacity (pipeline candidates)"
        )
    verdict = diag.get("last_verdict")
    if verdict:
        lines.append(
            f"  last cycle verdict: {verdict['reason']} — "
            f"{verdict['message']}"
        )
        detail = verdict.get("detail") or {}
        if detail.get("cycles_waited") is not None:
            lines.append(
                f"  waiting {detail['cycles_waited']} solve cycle(s)"
                + (
                    f" ({detail['waiting_seconds']:.3f}s on the "
                    f"scheduler clock)"
                    if detail.get("waiting_seconds") is not None else ""
                )
            )
        vs = (verdict.get("detail") or {}).get("victim_selection")
        if vs:
            lines.append(
                f"  last {vs['action']}: {vs['victims']} victim(s) "
                f"selected, claimant "
                f"{'placed' if vs['placed'] else 'NOT placed'}"
            )
    else:
        lines.append("  no solver verdict recorded yet for this job")
    return "\n".join(lines)


# ------------------------------------------------------------------- CLI


def cli_main(argv: Optional[List[str]] = None) -> int:
    """``python -m kube_batch_tpu_torch explain <ns/name>``.

    Two modes: ``--server host:port`` queries a live scheduler's
    ``/debug/jobs`` endpoint; ``--cluster-state file.yaml`` loads the
    cluster, opens one diagnostic session with the default plugin
    tiers, and runs the full per-predicate walk offline."""
    import argparse

    parser = argparse.ArgumentParser(
        prog="tpu-batch explain",
        description="explain why a job/gang is not scheduled",
    )
    parser.add_argument(
        "job", help="job as <namespace>/<name> (PodGroup name)"
    )
    parser.add_argument(
        "--server", default=None, metavar="HOST:PORT",
        help="query a running scheduler's /debug/jobs endpoint",
    )
    parser.add_argument(
        "--cluster-state", default=None, metavar="PATH",
        help="offline: load this cluster-state YAML and diagnose "
             "in-process",
    )
    parser.add_argument(
        "--scheduler-conf", default=None, metavar="PATH",
        help="scheduler policy YAML for the offline diagnosis tiers",
    )
    parser.add_argument("--json", action="store_true",
                        help="print the raw JSON instead of prose")
    ns = parser.parse_args(argv)

    if "/" not in ns.job:
        ns.job = f"default/{ns.job}"

    if ns.server:
        import urllib.request

        url = f"http://{ns.server}/debug/jobs/{ns.job}"
        try:
            with urllib.request.urlopen(url, timeout=10) as resp:
                payload = json.loads(resp.read().decode())
        except Exception as exc:
            print(f"explain: failed to query {url}: {exc}")
            return 2
        if ns.json:
            print(json.dumps(payload, indent=2, sort_keys=True))
        else:
            verdict = payload.get("verdict") or payload
            print(
                f"job {ns.job}: {verdict.get('reason', 'unknown')} — "
                f"{verdict.get('message', '')}"
            )
            for key, value in sorted(
                (verdict.get("detail") or {}).items()
            ):
                print(f"  {key}: {value}")
        return 0

    if not ns.cluster_state:
        print("explain: need --server or --cluster-state")
        return 2

    from ..cache import new_scheduler_cache
    from ..cli.state import load_cluster_state
    from ..framework import close_session, open_session
    from ..scheduler import load_scheduler_conf

    import threading as _threading

    cluster = load_cluster_state(ns.cluster_state)
    cache = new_scheduler_cache(cluster, "tpu-batch", "default")
    conf = None
    if ns.scheduler_conf:
        with open(ns.scheduler_conf) as f:
            conf = f.read()
    from ..conf import DEFAULT_SCHEDULER_CONF

    _actions, tiers = load_scheduler_conf(conf or DEFAULT_SCHEDULER_CONF)
    stop = _threading.Event()
    try:
        cache.run(stop)
        cache.wait_for_cache_sync(stop)
        ssn = open_session(cache, tiers)
        try:
            job = ssn.jobs.get(ns.job)
            if job is None:
                print(f"explain: job {ns.job} not found "
                      f"(known: {sorted(ssn.jobs)[:10]})")
                return 3
            diag = diagnose_job(ssn, job)
        finally:
            close_session(ssn)
    finally:
        stop.set()
        cache.shutdown()

    if ns.json:
        print(json.dumps(diag, indent=2, sort_keys=True))
    else:
        print(format_diagnosis(diag))
    return 0
