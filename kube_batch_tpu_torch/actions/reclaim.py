"""Reclaim action: cross-queue eviction for starving queues.

Mirrors reference actions/reclaim/reclaim.go:41-196: for each non-overused
queue, pop starving job/task by order fns; per node, collect RUNNING tasks of
OTHER queues → ssn.reclaimable victims → ssn.evict("reclaim") until the
request is covered → ssn.pipeline the claimant. Direct evictions, no
Statement (no rollback).
"""

from __future__ import annotations

import logging

from ..api import Resource, TaskStatus
from ..framework import Action, register_action
from ..obs import explain
from ..utils import PriorityQueue
from ..utils.scheduler_helper import FeasibilityMemo

logger = logging.getLogger(__name__)

# Reclaimable fns audited against the exhausted-node memo's soundness
# contract (claimant-independent + eviction-monotone — see
# Session.add_reclaimable_fn). A reclaimable plugin OUTSIDE this set
# disables the memo for the cycle: an upstream-style
# priority-vs-claimant verdict could flip a node from victimless to
# victim-bearing for a later claimant, which the memo would hide.
MEMO_SAFE_RECLAIMABLE = frozenset({"proportion", "gang", "conformance", "serving"})


class ReclaimAction(Action):
    def name(self) -> str:
        return "reclaim"

    @staticmethod
    def _sim_gang_fits(memo, claimant, peeked):
        """First-fit-decreasing placement sim for the skip-eviction guard.
        Only sound for gangs WITHOUT member-vs-member constraints (caller
        gates on that): each member's predicate verdict is then a pure
        function of its spec's constraint fields against current node
        state, so members with equal constraint specs share one feasible
        set via the cycle-scoped memo (homogeneous gangs — the common
        case — cost one predicate pass total, shared with the outer
        claimant scan)."""
        members = sorted(
            [claimant] + peeked,
            key=lambda t: (t.init_resreq.milli_cpu, t.init_resreq.memory),
            reverse=True,
        )
        # One memo lookup per DISTINCT member spec (gangs are usually
        # uniform — the profile showed per-member re-lookups rebuilding
        # the filtered node list 10x per sim), and node state cloned
        # LAZILY on first mutation: a failing sim walks every node and
        # must not clone the whole cluster's vectors on the way.
        feas_cache: list = []  # [(spec, nodes)]
        sim = {}  # node name -> [idle, releasing] mutable copies
        for member in members:
            spec = member.pod.spec
            nodes = None
            for seen_spec, cached in feas_cache:
                if spec is seen_spec or (
                    spec.node_selector == seen_spec.node_selector
                    and spec.affinity == seen_spec.affinity
                    and spec.tolerations == seen_spec.tolerations
                ):
                    nodes = cached
                    break
            if nodes is None:
                nodes = memo.feasible(member)
                feas_cache.append((spec, nodes))
            req = member.init_resreq
            for node in nodes:
                entry = sim.get(node.name)
                idle = entry[0] if entry is not None else node.idle
                releasing = (
                    entry[1] if entry is not None else node.releasing
                )
                if req.less_equal(idle):
                    if entry is None:
                        entry = sim[node.name] = [
                            node.idle.clone(), node.releasing.clone(),
                        ]
                    entry[0].sub(req)
                    break
                if req.less_equal(releasing):
                    if entry is None:
                        entry = sim[node.name] = [
                            node.idle.clone(), node.releasing.clone(),
                        ]
                    entry[1].sub(req)
                    break
            else:
                return False
        return True

    def execute(self, ssn) -> None:
        queues = PriorityQueue(ssn.queue_order_fn)
        queue_map = {}
        preemptors_map = {}
        preemptor_tasks = {}

        for job in ssn.jobs.values():
            queue = ssn.queues.get(job.queue)
            if queue is None:
                logger.error(
                    "Failed to find Queue <%s> for Job <%s/%s>",
                    job.queue, job.namespace, job.name,
                )
                continue
            if queue.uid not in queue_map:
                queue_map[queue.uid] = queue
                queues.push(queue)
            if job.task_status_index.get(TaskStatus.PENDING):
                if job.queue not in preemptors_map:
                    preemptors_map[job.queue] = PriorityQueue(ssn.job_order_fn)
                preemptors_map[job.queue].push(job)
                preemptor_tasks[job.uid] = PriorityQueue(ssn.task_order_fn)
                for task in job.task_status_index[TaskStatus.PENDING].values():
                    preemptor_tasks[job.uid].push(task)

        # Cycle-scoped feasibility memo: claimants (and their gang-sim
        # members) with equal constraint specs share one predicate pass
        # over the node list — at 1k nodes x 16k claimants the
        # per-claimant pass WAS reclaim throughput in the reference's
        # multi-tenant profile. Staleness rules live in FeasibilityMemo.
        memo = FeasibilityMemo(ssn)
        # Cycle-scoped per-queue exhausted-node memo (see the victim
        # scan below for the monotonicity argument). Gated on the
        # enabled reclaimable plugin set: only fns audited against the
        # contract at Session.add_reclaimable_fn may feed it.
        enabled_reclaimable = {
            plugin.name
            for tier in ssn.tiers
            for plugin in tier.plugins
            if bool(getattr(plugin, "enabled_reclaimable", False))
            and plugin.name in ssn.reclaimable_fns
        }
        memo_enabled = enabled_reclaimable <= MEMO_SAFE_RECLAIMABLE
        if not memo_enabled:
            logger.info(
                "reclaimable plugins %s outside the audited set %s; "
                "running without the exhausted-node memo",
                sorted(enabled_reclaimable), sorted(MEMO_SAFE_RECLAIMABLE),
            )
        no_victims: dict = {}

        while not queues.empty():
            queue = queues.pop()
            if ssn.overused(queue):
                continue
            jobs = preemptors_map.get(queue.uid)
            if jobs is None or jobs.empty():
                continue
            job = jobs.pop()
            tasks = preemptor_tasks.get(job.uid)
            if tasks is None or tasks.empty():
                continue
            task = tasks.pop()

            # One predicate pass per DISTINCT spec: the feasible-node
            # list feeds both the skip guard and the eviction scan.
            feasible = memo.feasible(task)

            # Deliberate divergence from reclaim.go: skip eviction when
            # free capacity already suffices — allocate, which runs after
            # reclaim in the default policy, will place this same cycle.
            # The reference lacks this guard and relies on slow
            # real-cluster pod deletion to not over-evict; with an
            # instant substrate it would drain the victim queue far
            # below its deserved share (its own e2e contract,
            # test/e2e/queue.go:26-69). The guard must be GANG-aware
            # and PACKING-aware: "this one task fits" (or "the aggregate
            # fits") is not enough — if the job still needs k members
            # for minAvailable and free capacity cannot hold all k
            # per-node, skipping would deadlock (partial gang
            # allocations never dispatch, so the same free capacity
            # re-appears every cycle while reclaim keeps skipping).
            # Simulate allocate's placement test (fits Idle → bind, else
            # fits Releasing → pipeline) with first-fit-decreasing over
            # the feasible nodes; skip eviction only when EVERY needed
            # gang member places. First-fit may fail where a smarter
            # packing succeeds — that errs toward evicting, which is the
            # reference's own behavior and self-corrects next cycle.
            needed = max(
                1,
                job.min_available
                - job.ready_task_num()
                - job.waiting_task_num(),
            )
            peeked = []
            while len(peeked) < needed - 1 and not tasks.empty():
                peeked.append(tasks.pop())
            for t in peeked:
                tasks.push(t)
            # Each member places only onto nodes ITS OWN predicates
            # accept — a heterogeneous gang (per-member selectors/
            # affinity/ports) must not be simulated onto nodes some
            # members cannot use, or the skip guard under-evicts every
            # cycle (the exact livelock it exists to prevent).
            #
            # The sim evaluates predicates against CURRENT node state
            # only; it cannot model member-vs-member interaction (two
            # members claiming the same host port, or inter-pod
            # (anti-)affinity among the gang itself — whose verdict also
            # depends on each pod's own labels, breaking the spec-keyed
            # memo below). When any member declares such a constraint,
            # skip the guard entirely and take the eviction path: erring
            # toward evicting is the reference's own behavior and
            # self-corrects next cycle, while erring toward skipping is
            # the livelock.
            def interacts(member):
                spec = member.pod.spec
                if any(c.ports for c in spec.containers):
                    return True
                aff = spec.affinity
                return aff is not None and bool(
                    aff.pod_affinity or aff.pod_anti_affinity
                )

            if any(interacts(m) for m in [task] + peeked):
                all_fit = False
            else:
                all_fit = self._sim_gang_fits(memo, task, peeked)
            if all_fit:
                queues.push(queue)
                continue

            assigned = False
            victims_evicted = 0
            exhausted = no_victims.setdefault(job.queue, set())
            for node in feasible:
                # Memo soundness: within a cycle, verdicts in the
                # default reclaim chain move DOWN on evictions
                # (proportion's per-queue over-deserved quota shrinks,
                # gang's minAvailable floors approach, conformance is
                # static), so a node that yielded zero victims stays
                # victimless — UNLESS a successful pipeline raises some
                # claimant queue's allocated above its deserved share,
                # which can newly expose THAT queue's running tasks as
                # victims. A pipeline of queue Q therefore invalidates
                # the memos of every claimant queue EXCEPT Q (Q's own
                # claimants reclaim from queues whose availability only
                # shrank). With a single starving queue — and in the
                # saturated stall phase, where a backlog of claimants
                # re-evaluated every floored job on every node each
                # wave (measured 1.17M evictable calls per cycle at 1k
                # nodes under a scattered placement) — the memo
                # persists exactly where it pays.
                if memo_enabled and node.name in exhausted:
                    continue  # see memo soundness note below
                resreq = task.init_resreq.clone()
                reclaimed = Resource.empty()

                # Candidates are the live node-task objects — the
                # reclaimable chain only filters (proportion/gang/
                # conformance read), so cloning every RUNNING task per
                # (claimant, node) pair (~18M clones per saturated 1k-
                # node cycle) buys nothing HERE. The clone happens at
                # EVICT time instead, and is load-bearing there:
                # session.evict flips the task's status before
                # node.update_task, and NodeInfo.remove_task derives the
                # removal delta from its stored task's CURRENT status —
                # evicting the node's own object would erase the
                # RUNNING→RELEASING capacity move, the claimant's
                # pipeline would miss the released capacity, and the
                # next cycle would evict again (observed as doubling
                # every reclaim wave). Reference analog: reclaim.go:96
                # clones at candidate-build time.
                reclaimees = []
                for t in node.tasks.values():
                    if t.status != TaskStatus.RUNNING:
                        continue
                    j = ssn.jobs.get(t.job)
                    if j is None:
                        continue
                    if j.queue != job.queue:
                        reclaimees.append(t)
                victims = ssn.reclaimable(task, reclaimees)
                if not victims:
                    if memo_enabled:
                        exhausted.add(node.name)
                    continue

                all_res = Resource.empty()
                for v in victims:
                    all_res.add(v.resreq)
                if all_res.less(resreq):
                    continue

                # Minimal victim prefix covering the claim, then ONE
                # batched eviction: bulk RELEASING moves per job +
                # aggregate deallocate handlers (Session.evict_batch)
                # instead of per-victim handler fan-out. Clone HERE
                # (see the candidate-build comment): the eviction must
                # not mutate the node's stored object before node
                # accounting reads its pre-evict status. Divergence
                # from the sequential loop only in the rare
                # evict-failure case: the per-task loop would try the
                # NEXT victim to make up the shortfall, the batch
                # settles for what succeeded and lets the next cycle
                # correct — the reference's own self-correction
                # contract (reclaim.go:173-180).
                chosen = []
                for reclaimee in victims:
                    chosen.append(reclaimee.clone())
                    reclaimed.add(reclaimee.resreq)
                    if resreq.less_equal(reclaimed):
                        break
                evicted = ssn.evict_batch(chosen, "reclaim")
                victims_evicted += len(evicted)
                if len(evicted) != len(chosen):
                    reclaimed = Resource.empty()
                    for t in evicted:
                        reclaimed.add(t.resreq)

                if task.init_resreq.less_equal(reclaimed):
                    try:
                        ssn.pipeline(task, node.name)
                        # The pipeline raised THIS queue's allocated —
                        # only other claimant queues' verdicts about
                        # its tasks can flip up (soundness note at the
                        # scan above).
                        for quid in list(no_victims):
                            if quid != job.queue:
                                del no_victims[quid]
                    except Exception:
                        # Corrected in next scheduling loop (reclaim.go:173-180)
                        logger.exception(
                            "Failed to pipeline Task <%s/%s> on <%s>",
                            task.namespace, task.name, node.name,
                        )
                    assigned = True
                    break

            # Victim-selection outcome for the claimant's next
            # unschedulable verdict (obs/explain).
            explain.note_victim_outcome(
                job.uid, "reclaim", victims_evicted, assigned
            )
            if assigned:
                queues.push(queue)


register_action(ReclaimAction())
