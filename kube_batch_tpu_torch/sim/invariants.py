"""The kube-batch contract, checked after every simulated cycle.

Five invariant families over the settled cache mirror + cluster truth:

1. ``oversubscribe`` — per node, the resreq sum of resource-holding
   tasks fits allocatable, and the maintained idle/used aggregates
   agree with a from-scratch recount (accounting drift IS a bug even
   before it oversubscribes).
2. ``gang`` — minMember all-or-nothing: no gang ends a cycle partially
   dispatched (0 < ready < minAvailable). Jobs degraded by an injected
   fault (node death ate members, a bind failure re-pended one) are
   exempt until they are whole again — kube-batch's contract is that
   the SCHEDULER never creates a partial gang, not that faults can't.
3. ``conservation`` — no task lost or double-bound: cache tasks ↔
   cluster pods one-to-one, every resource-holding task present on
   exactly the node it names, no task on a node that doesn't hold it.
4. ``queue-share`` — per-queue allocation stays within the proportion
   plugin's water-filled deserved share, modulo one-gang overshoot
   (budgets gate per round, so a queue under budget may finish one more
   gang) and only when the queue GAINED allocation this cycle (deserved
   shrinks under node churn; holding old allocation is reclaim's
   business, not a scheduler bug).
5. ``serving-floor`` — once a serving job has reached its replica
   floor (``tpu-batch/replica-floor``, doc/design/serving.md), no
   cycle may end with it below the floor: batch backfill's
   preempt/reclaim must never take it there. Same degraded-exemption
   shape as the gang family — a fault (node death, injected kill,
   replica churn) may eat replicas; the scheduler may not.

The checker is deliberately independent code: it recomputes everything
from first principles (fresh water-fill, fresh per-node recount) so a
bookkeeping bug in the scheduler cannot hide in a shared helper.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

from ..api import Resource
from ..api.types import ALLOCATED_STATUSES, TaskStatus

# Resource-holding statuses from the CLUSTER's point of view at cycle
# end: RELEASING still occupies its node until the delete lands.
_HOLDING = frozenset(ALLOCATED_STATUSES | {TaskStatus.RELEASING})


@dataclass
class Violation:
    cycle: int
    invariant: str
    subject: str
    message: str

    def to_dict(self) -> dict:
        return {
            "cycle": self.cycle,
            "invariant": self.invariant,
            "subject": self.subject,
            "message": self.message,
        }


def _dims(r: Resource) -> Dict[str, float]:
    return {name: r.get(name) for name in r.resource_names()}


def _exceeds(a: Resource, bound: Resource, eps: float) -> Optional[str]:
    """First dimension where ``a > bound + eps``, else None."""
    dims = set(a.resource_names()) | set(bound.resource_names())
    for name in sorted(dims):
        if a.get(name) > bound.get(name) + eps:
            return (
                f"{name}: {a.get(name):.3f} > {bound.get(name):.3f}"
            )
    return None


def water_fill(
    total: Resource,
    weights: Dict[str, int],
    requests: Dict[str, Resource],
) -> Dict[str, Resource]:
    """Independent re-derivation of the proportion plugin's deserved
    shares (plugins/proportion.py water-filling)."""
    from ..api import min_resource

    deserved = {q: Resource.empty() for q in weights}
    meet: Dict[str, bool] = {}
    remaining = total.clone()
    for _ in range(len(weights) + 2):
        total_weight = sum(w for q, w in weights.items() if q not in meet)
        if total_weight == 0:
            break
        increased = Resource.empty()
        decreased = Resource.empty()
        for q in sorted(weights):
            if q in meet:
                continue
            old = deserved[q].clone()
            deserved[q].add(
                remaining.clone().multi(weights[q] / total_weight)
            )
            req = requests.get(q, Resource.empty())
            if req.less(deserved[q]):
                deserved[q] = min_resource(deserved[q], req)
                meet[q] = True
            inc, dec = deserved[q].diff(old)
            increased.add(inc)
            decreased.add(dec)
        remaining.sub(increased)
        remaining.add(decreased)
        if remaining.is_empty():
            break
    return deserved


class InvariantChecker:
    def __init__(self, eps: float = 1e-3, check_shares: bool = True):
        self.eps = eps
        self.check_shares = check_shares
        self.violations: List[Violation] = []
        # job key -> cycle it was degraded by an injected fault; cleared
        # once the job is whole (ready) again or gone.
        self.degraded: Dict[str, int] = {}
        self._prev_queue_alloc: Dict[str, Resource] = {}
        # Fault-induced divergence exemptions (the gang-degradation
        # pattern applied to the event-stream fault class): subjects
        # whose watch events the injector DROPPED are knowingly
        # diverged until the relist/anti-entropy machinery repairs them
        # — the scheduler didn't create the inconsistency, the fault
        # did, and the contract under test is that it gets detected and
        # repaired, not that it never exists. An exempt subject whose
        # flags stop firing is repaired and leaves the set; suppressed
        # flags are counted (and must be zero by run end — the CLI's
        # --require-divergence-repaired gate).
        self.diverged_uids: Dict[str, int] = {}
        self.diverged_nodes: Dict[str, int] = {}
        self.suppressed_total = 0
        # Serving replica-floor high-water: job key -> the floor it
        # reached. The floor binds only once reached (a deployment
        # still scaling up is not "below floor").
        self._floor_reached: Dict[str, int] = {}

    def mark_degraded(self, job_key: str, cycle: int) -> None:
        self.degraded.setdefault(job_key, cycle)

    def note_divergence(self, cycle: int, uids: Sequence[str] = (),
                        nodes: Sequence[str] = ()) -> None:
        """Register fault-induced divergence subjects (dropped pod
        events → uids; dropped node events → node names)."""
        for uid in uids:
            self.diverged_uids.setdefault(uid, cycle)
        for name in nodes:
            self.diverged_nodes.setdefault(name, cycle)

    def outstanding_divergence(self) -> int:
        return len(self.diverged_uids) + len(self.diverged_nodes)

    # -- entry point ---------------------------------------------------------

    def check(self, cache, cycle: int, namespace: str = "sim") -> List[Violation]:
        """Run every invariant against the settled cache (call only
        after the harness's end-of-cycle barrier). Returns (and
        accumulates) this cycle's violations."""
        found: List[Violation] = []
        suppressed_subjects: set = set()

        def flag(invariant: str, subject: str, message: str,
                 node: Optional[str] = None) -> None:
            # Fault-induced divergence suppression: a subject the
            # injector knowingly diverged (dropped watch event) is not
            # a scheduler bug while the repair machinery converges —
            # but it must CLEAR by run end (outstanding_divergence).
            if (
                subject in self.diverged_uids
                or subject in self.diverged_nodes
                or (node is not None and node in self.diverged_nodes)
            ):
                self.suppressed_total += 1
                suppressed_subjects.add(subject)
                if node is not None:
                    suppressed_subjects.add(node)
                return
            found.append(Violation(cycle, invariant, subject, message))

        with cache.mutex:
            self._check_nodes(cache, flag)
            self._check_gangs(cache, flag)
            self._check_serving_floors(cache, flag)
            self._check_conservation(cache, namespace, flag)
            if self.check_shares:
                self._check_queue_shares(cache, flag)
        # Exempt subjects that produced NO suppressed flag this cycle
        # are consistent again — repaired, exemption over.
        for exempt in (self.diverged_uids, self.diverged_nodes):
            for subject in list(exempt):
                if subject not in suppressed_subjects:
                    del exempt[subject]
        self.violations.extend(found)
        return found

    # -- 1. node accounting / oversubscription -------------------------------

    def _check_nodes(self, cache, flag) -> None:
        eps = self.eps
        for name, node in cache.nodes.items():
            if node.node is None:
                continue
            holding = Resource.empty()
            recount_used = Resource.empty()
            has_pipelined = False
            for task in node.tasks.values():
                recount_used.add(task.resreq)
                has_pipelined |= task.status == TaskStatus.PIPELINED
                if task.status in _HOLDING:
                    holding.add(task.resreq)
            over = _exceeds(holding, node.allocatable, eps)
            if over:
                flag(
                    "oversubscribe", name,
                    f"holding tasks exceed allocatable ({over}); "
                    f"tasks={len(node.tasks)}",
                )
            drift = _exceeds(recount_used, node.used, eps) or _exceeds(
                node.used, recount_used, eps
            )
            if drift:
                flag(
                    "oversubscribe", name,
                    f"node.used drifted from task recount ({drift})",
                )
            # idle + used must not exceed allocatable (a Pipelined task
            # legitimately consumes releasing rather than idle, so its
            # presence voids this ledger identity).
            if has_pipelined:
                continue
            ledger = node.idle.clone()
            ledger.add(node.used)
            drift = _exceeds(ledger, node.allocatable, eps)
            if drift:
                flag(
                    "oversubscribe", name,
                    f"idle+used exceeds allocatable ({drift})",
                )

    # -- 2. gang atomicity ---------------------------------------------------

    def _check_gangs(self, cache, flag) -> None:
        for key, job in cache.jobs.items():
            if job.pod_group is None or job.min_available <= 1:
                continue
            ready = job.ready_task_num()
            if ready >= job.min_available or key in self.degraded:
                if key in self.degraded and job.ready():
                    del self.degraded[key]  # whole again
                continue
            if 0 < ready:
                flag(
                    "gang", key,
                    f"partially dispatched gang: {ready} of "
                    f"minMember {job.min_available} hold resources",
                )
        # Drop degraded entries for jobs that no longer exist.
        for key in list(self.degraded):
            if key not in cache.jobs:
                del self.degraded[key]

    # -- 2b. serving replica floors ------------------------------------------

    def _check_serving_floors(self, cache, flag) -> None:
        """High-water floor check (gang-family shape): a serving job
        that has REACHED its replica floor may never end a cycle below
        it unless a fault degraded it (the harness marks fault kills
        and churn deletes degraded; scheduler evictions are not
        marked — a preempt/reclaim that takes a serving job below its
        floor flags here)."""
        for key, job in cache.jobs.items():
            slo = getattr(job, "slo", None)
            floor = slo.replica_floor if slo is not None else 0
            if floor <= 0:
                continue
            ready = job.ready_task_num()
            if ready >= floor:
                self._floor_reached[key] = floor
                if key in self.degraded and job.min_available <= 1:
                    # Whole again (the gang family only clears entries
                    # for minMember > 1 jobs it owns).
                    del self.degraded[key]
                continue
            if key not in self._floor_reached:
                continue  # still scaling up to its floor
            if key in self.degraded:
                continue  # fault/churn ate replicas; repair pending
            flag(
                "serving-floor", key,
                f"serving job below reached replica floor: {ready} of "
                f"floor {floor} hold resources",
            )
        for key in list(self._floor_reached):
            if key not in cache.jobs:
                del self._floor_reached[key]

    # -- 3. task conservation / double-bind ----------------------------------

    def _check_conservation(self, cache, namespace, flag) -> None:
        # Cache-side indexes.
        task_owner: Dict[str, str] = {}
        for key, job in cache.jobs.items():
            for uid, task in job.tasks.items():
                if uid in task_owner:
                    flag(
                        "conservation", uid,
                        f"task in two jobs: {task_owner[uid]} and {key}",
                    )
                task_owner[uid] = key

        node_of: Dict[str, str] = {}
        for nname, node in cache.nodes.items():
            for task in node.tasks.values():
                if task.uid in node_of:
                    flag(
                        "conservation", task.uid,
                        f"double-bind: task on nodes "
                        f"{node_of[task.uid]} and {nname}",
                    )
                node_of[task.uid] = nname

        for key, job in cache.jobs.items():
            for uid, task in job.tasks.items():
                holds = task.status in _HOLDING
                on = node_of.get(uid)
                if holds:
                    if on is None:
                        flag(
                            "conservation", uid,
                            f"{task.status.name} task missing from its "
                            f"node {task.node_name!r}",
                            node=task.node_name,
                        )
                    elif task.node_name and on != task.node_name:
                        flag(
                            "conservation", uid,
                            f"task says node {task.node_name} but is "
                            f"accounted on {on}",
                            node=task.node_name,
                        )
                elif task.status == TaskStatus.PENDING and on is not None:
                    flag(
                        "conservation", uid,
                        f"PENDING task still accounted on node {on}",
                    )

        # Cluster truth: every live sim pod has exactly one cache task;
        # no cache task outlives its pod (lost/ghost detection).
        cluster = cache.cluster
        if cluster is not None:
            pod_uids = {
                p.uid for p in cluster.list_objects("Pod")
                if p.namespace == namespace
            }
            cache_uids = {
                uid for uid in task_owner
                if task_owner[uid].startswith(f"{namespace}/")
            }
            for uid in sorted(pod_uids - cache_uids):
                flag("conservation", uid, "cluster pod lost by the cache")
            for uid in sorted(cache_uids - pod_uids):
                flag("conservation", uid, "cache task has no cluster pod")

    # -- 4. queue shares -----------------------------------------------------

    def _check_queue_shares(self, cache, flag) -> None:
        if len(cache.queues) < 2:
            self._prev_queue_alloc = {}
            return
        total = Resource.empty()
        for node in cache.nodes.values():
            if node.node is not None and node.ready():
                total.add(node.allocatable)
        weights = {q.name: q.weight for q in cache.queues.values()}
        allocated = {q: Resource.empty() for q in weights}
        requests = {q: Resource.empty() for q in weights}
        max_gang = {q: Resource.empty() for q in weights}
        for job in cache.jobs.values():
            if job.queue not in weights:
                continue
            allocated[job.queue].add(job.allocated)
            requests[job.queue].add(job.allocated)
            for t in job.task_status_index.get(
                TaskStatus.PENDING, {}
            ).values():
                requests[job.queue].add(t.resreq)
            max_gang[job.queue].set_max_resource(job.total_request)
        deserved = water_fill(total, weights, requests)
        for q in sorted(weights):
            prev = self._prev_queue_alloc.get(q)
            if prev is None:
                continue  # first pass establishes the baseline
            # The overused gate is checked per solver ROUND, so a queue
            # under budget may legitimately overshoot in the round that
            # crosses the line. What may never happen: a queue ALREADY
            # past deserved (+ one-gang slack for deserved drift under
            # mid-cycle churn) receiving MORE allocation.
            #
            # "Already past" must mirror the plugin's OverusedFn
            # contract (proportion.py:198-208 analog): a queue is
            # overused only when allocated covers deserved in EVERY
            # dimension. A cpu-saturated/memory-light queue is NOT
            # overused and may keep gaining cpu — the 100k-cycle soak
            # caught the earlier any-dimension form of this check
            # flagging exactly that (105 false violations, ~1/1000
            # cycles under a cpu-bound mix).
            bound = deserved[q].clone()
            bound.add(max_gang[q])
            already_over = bound.less_equal(prev)
            gained = _exceeds(allocated[q], prev, self.eps)
            if already_over and gained:
                over_dims = _exceeds(prev, bound, self.eps)
                flag(
                    "queue-share", q,
                    f"queue already past deserved + one gang in every "
                    f"dimension ({over_dims}) still gained allocation; "
                    f"deserved={_dims(deserved[q])}",
                )
        self._prev_queue_alloc = {
            q: allocated[q].clone() for q in allocated
        }
