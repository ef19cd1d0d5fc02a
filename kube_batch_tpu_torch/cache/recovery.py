"""Successor recovery: reconcile the bind-intent journal against
cluster truth after a leader change (doc/design/robustness.md,
failover section).

A leader that dies mid-bind-drain leaves the cluster in a state only
the journal can classify: some of its dispatched binds landed, some
never will, and a gang may sit below its minMember with no process
left that knows which members were in flight. This pass runs on the
SUCCESSOR, after lease acquisition and before its first scheduling
cycle, and is deliberately independent of the scheduler cache — it
reads cluster truth directly (the mirror ingests whatever it repairs
through ordinary watch events), the same first-principles discipline
as the simulator's InvariantChecker.

Per-task decision table (doc/design/robustness.md carries the prose
version):

| journal mark | cluster truth             | class      | action |
|--------------|---------------------------|------------|--------|
| applied      | any                       | applied    | none — the dead leader confirmed the bind |
| failed       | any                       | failed     | none — the dead leader already reverted/resynced it |
| (none)       | pod bound to intent node  | applied    | none — bind landed, the applied mark was lost in the crash |
| (none)       | pod bound elsewhere       | superseded | none — a later intent (or leader) owns the placement |
| (none)       | pod missing               | vanished   | none — the world moved on |
| (none)       | pod still unbound         | lost       | gang repair (below), else requeued to normal scheduling |

Gang repair (the all-or-nothing constraint may never stay
half-satisfied): lost tasks are grouped per job; a job whose BOUND
member count sits strictly between 0 and minMember is repaired by
**re-driving** each lost bind to its journaled node when the node is
still present, ready, and fits (an independent capacity recount — the
successor must not oversubscribe while repairing), or — when
completion cannot reach minMember — by **evicting** the partial
placement (every bound member deleted; the controller analog recreates
the gang whole). Re-drives are themselves journaled under the
successor's identity before being issued, so recovery is re-entrant
if the successor crashes too.

Every scanned predecessor record is removed once classified; the
journal after a recovery pass contains only the successor's own
(self-cleaning) re-drive intents.

PRECONDITION — the caller holds leadership. Recovery runs after lease
acquisition (Scheduler.run under the elector) and treats every
surviving intent as a DEAD leader's. Running it beside a live leader
(e.g. ``--once`` without election against a cluster that has an
elected scheduler) would classify that leader's still-draining binds
as lost and prune its journal — but that deployment already races the
live leader on every bind it makes; the single-scheduler assumption is
the same one scheduling itself carries there.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ..api import NodeInfo, Resource, TaskInfo

logger = logging.getLogger(__name__)

# Per-task reconciliation outcomes (the metric's label universe).
RECOVERY_OUTCOMES = (
    "applied", "failed", "redriven", "requeued", "evicted",
    "superseded", "vanished",
)

# Snapshot of the most recent recovery pass for /debug/vars (the
# handler has no scheduler reference; module global like
# scheduler.ACTIVE_WATCHDOG). Written once at successor startup.
LAST_RECOVERY: Optional[dict] = None


@dataclass
class RecoveryReport:
    """Outcome of one successor recovery pass."""

    leader: str
    intents_scanned: int = 0
    tasks_classified: int = 0
    outcomes: Dict[str, int] = field(default_factory=dict)
    # Pod keys re-driven to their journaled nodes / evicted to restore
    # gang atomicity (the sim harness schedules controller-analog
    # recreations for the evicted ones).
    redriven: List[dict] = field(default_factory=list)
    evicted: List[dict] = field(default_factory=list)
    gangs_repaired: List[str] = field(default_factory=list)
    gangs_evicted: List[str] = field(default_factory=list)
    errors: int = 0
    duration_ms: float = 0.0

    def count(self, outcome: str, n: int = 1) -> None:
        if n:
            self.outcomes[outcome] = self.outcomes.get(outcome, 0) + n
            self.tasks_classified += n

    def summary(self) -> dict:
        """Flight-record / trace / debug-vars blob (canonical-JSON
        friendly: plain types, sorted-stable content)."""
        return {
            "leader": self.leader,
            "intents_scanned": self.intents_scanned,
            "tasks_classified": self.tasks_classified,
            "outcomes": dict(sorted(self.outcomes.items())),
            "redriven": list(self.redriven),
            "evicted": list(self.evicted),
            "gangs_repaired": list(self.gangs_repaired),
            "gangs_evicted": list(self.gangs_evicted),
            "errors": self.errors,
            "duration_ms": round(self.duration_ms, 3),
        }


def _pod_bound(pod) -> bool:
    """Does this pod hold a node from the CLUSTER's point of view?"""
    from ..api import PodPhase

    return bool(pod.spec.node_name) and pod.status.phase not in (
        PodPhase.SUCCEEDED, PodPhase.FAILED
    )


def reconcile_journal(cluster: object, identity: str) -> RecoveryReport:
    """Classify every surviving bind intent against cluster truth and
    repair what the dead leader left half-done. ``identity`` stamps the
    successor's own re-drive intents. The scans are deliberately
    cluster-wide: the capacity recount behind gang re-drives must see
    EVERY bound pod's usage, whatever its namespace.

    Never raises: recovery is best-effort by construction — an error
    on one intent is counted and the pass continues, because a
    successor that refuses to start over a malformed record is a worse
    failure mode than the one being repaired."""
    global LAST_RECOVERY

    t0 = time.monotonic()
    report = RecoveryReport(leader=identity)
    try:
        intents = cluster.list_bind_intents()
    except Exception:
        logger.exception("recovery: journal scan failed; nothing to do")
        report.errors += 1
        report.duration_ms = (time.monotonic() - t0) * 1e3
        LAST_RECOVERY = report.summary()
        return report
    report.intents_scanned = len(intents)

    # -- cluster truth, one scan -----------------------------------------
    pods = list(cluster.list_objects("Pod"))
    pod_by_uid = {p.uid: p for p in pods}
    node_alloc: Dict[str, object] = {}
    node_used: Dict[str, object] = {}
    for node in cluster.list_objects("Node"):
        ni = NodeInfo(node)
        if not ni.ready():
            continue
        node_alloc[node.name] = ni.allocatable
        node_used[node.name] = Resource.empty()
    job_bound: Dict[str, List] = {}
    for pod in pods:
        if not _pod_bound(pod):
            continue
        ti = TaskInfo(pod)
        if ti.node_name in node_used:
            node_used[ti.node_name].add(ti.resreq)
        if ti.job:
            job_bound.setdefault(ti.job, []).append(pod)
    min_member: Dict[str, int] = {}
    for pg in cluster.list_objects("PodGroup"):
        min_member[f"{pg.namespace}/{pg.name}"] = pg.spec.min_member

    # -- classification ---------------------------------------------------
    # uid -> intent task dict still unbound (gang-repair input).
    # Keyed by uid, LATER seq wins: the same task can appear in two
    # open records (a failed bind whose 'failed' mark was lost, then a
    # resync re-dispatch) and a duplicate would double-book the
    # capacity recount and double-count the pod toward minMember.
    lost_tasks: Dict[str, dict] = {}
    scanned_seqs: List[int] = []
    for rec in intents:
        scanned_seqs.append(rec.get("seq", 0))
        try:
            marks = rec.get("marks", {}) or {}
            for gang, minm in sorted(
                (rec.get("gangs", {}) or {}).items()
            ):
                # Journal fallback for gang thresholds whose PodGroup
                # died with the leader (the live PodGroup wins).
                min_member.setdefault(gang, int(minm))
            for task in rec.get("tasks", []):
                uid = task.get("uid")
                mark = marks.get(uid)
                if mark in ("applied", "failed"):
                    report.count(mark)
                    continue
                pod = pod_by_uid.get(uid)
                if pod is None:
                    report.count("vanished")
                elif not pod.spec.node_name:
                    lost_tasks[uid] = task
                elif pod.spec.node_name == task.get("node"):
                    # Bind landed; the crash ate the applied mark.
                    # Cluster truth is the authority — applied.
                    report.count("applied")
                else:
                    report.count("superseded")
        except Exception:
            # The never-raises contract: one malformed record (schema
            # drift, a hand-edited annotation) is counted and skipped —
            # it must not pin the whole journal forever.
            logger.exception(
                "recovery: malformed intent record seq=%s skipped",
                rec.get("seq"),
            )
            report.errors += 1
    lost_by_job: Dict[str, List[dict]] = {}
    for uid in sorted(lost_tasks):
        task = lost_tasks[uid]
        lost_by_job.setdefault(task.get("job") or "", []).append(task)

    # -- gang repair -------------------------------------------------------
    for job_key in sorted(lost_by_job):
        try:
            entries = sorted(lost_by_job[job_key], key=lambda t: t["pod"])
            minm = min_member.get(job_key, 0)
            bound = len(job_bound.get(job_key, []))
            if minm <= 1 or bound <= 0 or bound >= minm:
                # No atomicity constraint at stake: unbound tasks simply
                # re-enter normal scheduling on the successor's first cycle.
                report.count("requeued", len(entries))
                continue
            # Partial gang. Plan completion: re-drive each lost bind to its
            # journaled node when it still exists, is ready, and fits an
            # independent capacity recount (reserving as we plan, so two
            # re-drives cannot double-book the same headroom).
            plan = []
            unplaceable = []
            for task in entries:
                pod = pod_by_uid[task["uid"]]
                node = task.get("node") or ""
                alloc = node_alloc.get(node)
                if alloc is None:
                    unplaceable.append(task)
                    continue
                req = TaskInfo(pod).resreq
                projected = node_used[node].clone().add(req)
                if projected.less_equal(alloc):
                    node_used[node] = projected
                    plan.append((task, pod, req))
                else:
                    unplaceable.append(task)
            if bound + len(plan) >= minm and plan:
                seq = _journal_redrive(cluster, identity, job_key, minm, plan)
                done = 0
                for task, pod, req in plan:
                    try:
                        cluster.bind_pod(pod, task["node"])
                    except Exception:
                        logger.exception(
                            "recovery: re-drive of %s -> %s failed",
                            task["pod"], task["node"],
                        )
                        report.errors += 1
                        report.count("requeued")
                        # Give the failed re-drive's reservation back: the
                        # headroom is real and later gangs may need it.
                        node_used[task["node"]].sub(req)
                        _mark_quiet(cluster, seq, task["uid"], "failed")
                        continue
                    done += 1
                    report.count("redriven")
                    report.redriven.append(
                        {"pod": task["pod"], "node": task["node"],
                         "job": job_key}
                    )
                    # Now a bound member: if completion still falls short
                    # the eviction arm must tear this one down too.
                    job_bound.setdefault(job_key, []).append(pod)
                    _mark_quiet(cluster, seq, task["uid"], "applied")
                report.count("requeued", len(unplaceable))
                if bound + done >= minm:
                    report.gangs_repaired.append(job_key)
                    continue
                # Re-drives failed under us: fall through to eviction so
                # the gang never stays half-satisfied.
            else:
                # Abandoned plan: roll its reservations back — leaving them
                # booked would make LATER gangs' journaled nodes look full
                # and spuriously route repairable gangs into eviction.
                for task, _pod, req in plan:
                    node_used[task["node"]].sub(req)
                report.count("requeued", len(plan) + len(unplaceable))
            _evict_partial_gang(cluster, job_key, job_bound, report, node_used)
        except Exception:
            # Same never-raises contract as classification: one
            # gang's repair blowing up must not abort the pass for
            # every other gang (or the journal prune below).
            logger.exception(
                "recovery: gang repair for %s failed", job_key
            )
            report.errors += 1

    # -- prune the predecessor's records (one batched sweep) ---------------
    try:
        cluster.remove_bind_intents(scanned_seqs)
    except Exception:
        logger.exception("recovery: journal prune sweep failed")
        report.errors += 1

    report.duration_ms = (time.monotonic() - t0) * 1e3
    _export(report)
    return report


def _journal_redrive(cluster, identity, job_key, minm, plan) -> Optional[int]:
    """Journal the recovery's own re-drive batch before issuing it —
    recovery must be as crash-tolerant as the dispatch it repairs."""
    try:
        return cluster.append_bind_intent({
            "leader": identity,
            "tasks": [
                {"uid": t["uid"], "pod": t["pod"], "node": t["node"],
                 "job": job_key}
                for t, _pod, _req in plan
            ],
            "gangs": {job_key: minm},
        })
    except Exception:
        logger.exception("recovery: re-drive journal append failed")
        return None


def _mark_quiet(cluster, seq, uid, outcome) -> None:
    if seq is None:
        return
    try:
        cluster.mark_bind_intent(seq, uid, outcome)
    except Exception:
        logger.exception("recovery: re-drive mark failed for %s", uid)


def _evict_partial_gang(cluster, job_key, job_bound, report,
                        node_used) -> None:
    """All-or-nothing restoration, the destructive arm: the gang cannot
    reach minMember, so every bound member is deleted (the controller
    analog recreates the gang whole and it re-schedules atomically).
    Each deletion credits the capacity ledger back — later gangs in the
    same pass must see the freed headroom, not a stale full node."""
    victims = sorted(
        job_bound.get(job_key, []), key=lambda p: (p.namespace, p.name)
    )
    for pod in victims:
        ti = TaskInfo(pod)
        try:
            cluster.delete_pod(pod)
        except Exception:
            logger.exception(
                "recovery: eviction of %s/%s failed",
                pod.namespace, pod.name,
            )
            report.errors += 1
            continue
        if ti.node_name in node_used:
            node_used[ti.node_name].sub(ti.resreq)
        report.count("evicted")
        report.evicted.append(
            {"pod": f"{pod.namespace}/{pod.name}", "job": job_key}
        )
    if victims:
        report.gangs_evicted.append(job_key)


def _export(report: RecoveryReport) -> None:
    """Metrics + the /debug/vars snapshot (never raises)."""
    global LAST_RECOVERY

    try:
        from .. import metrics

        for outcome in sorted(report.outcomes):
            metrics.register_failover_recovery(
                outcome, report.outcomes[outcome]
            )
    except Exception:  # pragma: no cover - metrics must never kill
        logger.exception("recovery metric update failed")
    LAST_RECOVERY = report.summary()
    if report.tasks_classified or report.intents_scanned:
        logger.warning(
            "successor recovery: %d intent(s), %d task(s) reconciled "
            "%s; gangs repaired=%s evicted=%s",
            report.intents_scanned, report.tasks_classified,
            dict(sorted(report.outcomes.items())),
            report.gangs_repaired, report.gangs_evicted,
        )
