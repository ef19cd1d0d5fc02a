"""Warm-started steady cycles: carry the previous solve's verdicts.

A periodic cycle at steady state re-derives a conclusion it already
reached one period ago: every pending task it re-solves was left
unassigned by the previous cycle, against capacities that have only
SHRUNK since (the scheduler's own placements), budgets that have only
tightened, and feasibility that has not moved. CvxCluster
gets its 100-1000x on granular allocation problems from exactly this
solution-reuse structure. This module is the state machine that decides,
per cycle, how much of the previous solve survives:

``noop``
    No job gained schedulable work since the previous solve and every
    delta precondition holds — the previous cycle's verdicts ARE this
    cycle's verdicts, bit-for-bit, and the solve/selection/apply phases
    are skipped entirely. Only the cache maintenance half of tensorize
    runs (``tensorize(warm_noop=True)``: node-array + predicate-column
    patching against the narrow ledger). Exactness argument: the solver
    runs rounds to a fixed point, and the cluster state at this snapshot
    IS the previous solve's fixed point (placements applied exactly the
    deltas the solve committed; nothing else moved, per the
    preconditions below) — re-running the rounds would accept nothing in
    round one and stop.

``solve``
    New work arrived (dirty jobs with pending tasks) and NO unassigned
    tasks were carried over — the problem contains exactly the new work,
    solved against the residual capacities already resident in the
    incremental tensorize / device caches. This is the steady
    placement-wave regime: cycle cost scales with churn.

``subset``
    New work arrived WHILE unassigned tasks are carried. The new work
    (plus a bounded, rotating drain batch of carried jobs) solves as a
    rank-stable SUBSET problem: tensorize runs its ordering pipeline
    over the FULL pending pool — cheap host numpy — and slices solver
    tensors to the subset rows, each carrying its GLOBAL rank
    (``tensorize(rank_pool=...)``), which the kernels consume for both
    priority ordering and bid-key tie hashes. Exactness: under this
    plan's preconditions every carried task outside the subset sits at
    the previous solve's fixed point (failed, job-broken, or budget-
    gated) against capacities that only shrink and budgets that only
    tighten, so the full problem would leave it unassigned and its rows
    contribute exact zeros to every queue/node reduction (x + 0.0 == x
    in f32) — the subset solve's placements are bit-equal to the full
    solve restricted to the subset, and the full solve places nothing
    else. This retires the former ``carried-interleave`` full-solve
    fallback: congested cycles (carried backlog + arrivals) now cost
    O(churn), not O(pending).

Events that merely VOID a carried verdict no longer force a full
solve: a third-party node event (capacity may have GROWN — every
carried verdict re-solves), a mutated carried job (completion,
preempt, partial-gang revert), or a moved queue budget (that queue's
carried jobs re-solve) each FOLD the affected carried jobs into the
subset instead. The exactness argument is unchanged — a re-solved row
is trivially exact, and only rows whose preconditions still hold stay
outside the subset. This is what keeps the micro path primary in the
congested regime, where completions dirty nodes every coalescing
window.

fallback (full solve, labeled by reason)
    The remaining precondition failures re-solve everything from the
    ground truth — bit-parity with a cold scheduler is the invariant
    the randomized churn tests pin. Reasons:

    - ``cold`` / ``stale``: no warm state, or a snapshot generation gap
      (some cycle's ledger drained without a warm save AND without the
      deferred-micro dirt fold below);
    - ``node-dirty``: a third-party node event with NO pending work
      anywhere (nothing to subset-solve — the periodic path refreshes);
    - ``releasing``: Releasing capacity exists — the pipeline epilogue
      may place carried tasks, outside the fixed-point argument;
    - ``mesh-changed``: the solver's device layout token moved since
      the save (KBT_SPARSE_SHARD_MODE flip — the device set itself is
      process-constant — or a node->rack map move under two-level mode:
      the token carries the rack-permutation digest suffix): the flat
      sharded mode is bit-parity but the two-level mode is not, so
      carried verdicts conservatively void whenever the layout a solve
      would run under differs from the one that produced them;
    - ``drift``: the warm-noop tensorize found node rows dirty beyond
      the narrow ledger (a session-side mutation the plan could not
      see) — the cycle re-runs as a full solve.

A micro cycle that still hits a fallback places nothing and defers —
but its session has already DRAINED the cache's dirty ledgers, so
``note_deferred`` folds the drained deltas into the state
(``pending_*`` sets) and keeps the snapshot-generation continuity;
without it one defer would strand every following micro cycle on
``stale`` until the next periodic solve.

The state lives on the SchedulerCache (``_warm_solve_state``), the same
lifetime pattern as the tensorize/device caches. ``plan_warm`` is
called by allocate_tpu before tensorize; ``save_warm_state`` after the
apply/verdict phases of every solving cycle (and ``advance_noop`` after
a no-op cycle).
"""

from __future__ import annotations

import logging
import os
from typing import Dict, List, Optional, Tuple

from ..api import TaskStatus

logger = logging.getLogger(__name__)


class WarmSolveState:
    """Carried verdicts of the most recent solve (see module doc)."""

    __slots__ = (
        "valid", "snap_gen", "carried", "queue_deserved", "has_releasing",
        "mesh_token", "drain_cursor",
        "pending_dirty_jobs", "pending_dirty_nodes", "pending_narrow",
    )

    def __init__(self):
        self.valid = False
        self.snap_gen = -1
        # Dirty-ledger deltas drained by DEFERRED micro cycles
        # (note_deferred): the next plan unions them with its session's
        # ledgers, so a defer never loses churn information. Cleared on
        # every successful warm save / noop advance.
        self.pending_dirty_jobs: set = set()
        self.pending_dirty_nodes: set = set()
        self.pending_narrow: set = set()
        # Rotating position into the sorted carried-uid list: each
        # subset solve drains the next KBT_MICRO_DRAIN carried jobs so
        # every carried verdict is refreshed within
        # ceil(carried / drain) subset cycles. Advanced only by subset
        # solves — a pure function of solve history, so replay-stable.
        self.drain_cursor = 0
        # Solver device-layout token at save time
        # (sharding.prospective_layout_token); None until a sharded
        # dispatch has pinned the device count.
        self.mesh_token = None
        # job uid -> (job clone object, clone _ver at save, pending
        # remainder at save). Identity+ver pins "untouched"; a
        # narrow-dirty re-clone passes iff its pending count still
        # equals the remainder (a bind-bookkeeping revert would grow
        # it, and a reverted task must be re-solved).
        self.carried: Dict[str, tuple] = {}
        # queue uid -> deserved Resource clone (None when no budget
        # plugin had an opinion) for every queue owning carried jobs.
        self.queue_deserved: Dict[str, object] = {}
        self.has_releasing = True  # conservative until first save


def warm_state_of(cache) -> Optional[WarmSolveState]:
    if cache is None:
        return None
    ws = getattr(cache, "_warm_solve_state", None)
    if ws is None:
        ws = WarmSolveState()
        try:
            cache._warm_solve_state = ws
        except Exception:  # slots-only stand-in cache
            return None
    return ws


def warm_enabled() -> bool:
    return os.environ.get("KBT_WARM", "1") != "0"


def _layout_token():
    """The solver device-layout token a solve dispatched now would run
    under (None before any sharded dispatch — see
    sharding.prospective_layout_token; never probes the backend, so
    the native-route and pre-init paths stay hang-safe)."""
    from . import sharding

    return sharding.prospective_layout_token()


def _res_eq(a, b) -> bool:
    """Exact Resource equality (Resource.__eq__); None-tolerant."""
    if a is None or b is None:
        return a is None and b is None
    return a == b


def _deserved_of(ssn, queue) -> Optional[object]:
    """The queue's deserved budget (first plugin with an opinion wins —
    the same resolution tensorize uses for its budget vectors)."""
    for fn in ssn.queue_budget_fns.values():
        budget = fn(queue)
        if budget is not None:
            return budget[0]
    return None


def plan_warm(ssn) -> Tuple[str, List]:
    """Classify this cycle against the warm state. Returns
    ``(outcome, live_jobs)``: outcome ``noop``/``solve`` when the warm
    path engages, else the fallback reason; ``live_jobs`` is the set of
    jobs with new schedulable work (empty for noop and for fallbacks,
    where the full solve covers everything anyway)."""
    if not warm_enabled():
        return "disabled", []
    ws = warm_state_of(ssn.cache)
    if ws is None or not ws.valid:
        return "cold", []
    if getattr(ssn, "snap_gen", 0) != ws.snap_gen + 1:
        return "stale", []
    cur_token = _layout_token()
    if (
        cur_token is not None
        and ws.mesh_token is not None
        and cur_token != ws.mesh_token
    ):
        # The solver's device layout moved under the carried verdicts
        # (a mode flip, or a change of the process's shard count or
        # rack map): conservatively re-solve — the two-level mode is not
        # bit-parity.
        return "mesh-changed", []
    if ws.has_releasing:
        return "releasing", []

    # The effective delta since the last warm processing: this
    # session's drained ledgers plus anything deferred micro cycles
    # drained before it (note_deferred).
    dirty_jobs = set(ssn.dirty_jobs) | ws.pending_dirty_jobs
    node_dirty = bool(ssn.dirty_nodes) or bool(ws.pending_dirty_nodes)
    narrow = set(ssn.dirty_jobs_narrow) | ws.pending_narrow

    pending_key = TaskStatus.PENDING
    carried = ws.carried
    live: List = []
    seen = set()
    # Sorted: the walk order must be replay-stable (kbtlint
    # replay-determinism) now that the union is a fresh set.
    for uid in sorted(dirty_jobs):
        job = ssn.jobs.get(uid)
        if job is not None and job.task_status_index.get(pending_key):
            live.append(job)
            seen.add(uid)

    # Carried verdicts whose preconditions no longer hold are FOLDED
    # into the subset (re-solved against current residuals/budgets)
    # instead of forcing a full solve — re-solved rows are trivially
    # exact, and only rows whose preconditions still hold stay outside.
    forced: List = []
    remaining: Dict[str, List] = {}  # queue uid -> kept-out carried jobs
    for uid, (obj, ver, remainder) in carried.items():
        if uid in seen:
            # Full-dirty carried job: its re-solve is part of the live
            # set; the carried verdict is simply superseded.
            continue
        job = ssn.jobs.get(uid)
        if job is None:
            # Deleted carried job: the full problem no longer contains
            # it — the entry is dead (advance/save paths prune it).
            continue
        if node_dirty:
            # Third-party node event: capacities may have GROWN, so any
            # carried verdict might now be placeable — every carried
            # job re-solves inside the subset.
            forced.append(job)
            seen.add(uid)
            continue
        if job is obj and job._ver == ver:
            remaining.setdefault(obj.queue, []).append(job)
            continue
        if (
            uid in narrow
            and len(job.task_status_index.get(pending_key) or ()) == remainder
        ):
            # Bind-only churn with the exact unassigned remainder left
            # pending: the job is in precisely the state the previous
            # solve ended in.
            remaining.setdefault(job.queue, []).append(job)
            continue
        # Mutated carried job (completion, preempt, partial-gang
        # revert) or a drifted remainder: its old verdict is void —
        # re-solve it.
        forced.append(job)
        seen.add(uid)

    # A narrow-dirty job that is NOT carried but has pending tasks means
    # a bind-bookkeeping revert put an assigned task back — re-solve it.
    for uid in sorted(narrow):
        if uid in carried or uid in seen:
            continue
        job = ssn.jobs.get(uid)
        if job is not None and job.task_status_index.get(pending_key):
            live.append(job)
            seen.add(uid)

    # Budget re-check over the queues whose carried jobs would stay
    # OUTSIDE the subset: a moved deserved budget voids exactly that
    # queue's kept-out verdicts — fold them in too. Sorted: the walk
    # must be replay-stable (kbtlint replay-determinism).
    for quid in sorted(remaining):
        queue = ssn.queues.get(quid)
        cur = _deserved_of(ssn, queue) if queue is not None else None
        if not _res_eq(cur, ws.queue_deserved.get(quid)):
            for job in remaining[quid]:
                forced.append(job)
                seen.add(job.uid)

    if not live and not forced:
        if node_dirty:
            # A node event with no pending work anywhere: nothing to
            # subset-solve — let the full path refresh the arrays.
            return "node-dirty", []
        return "noop", []
    if carried:
        # Carried unassigned tasks interleave with the new work: solve
        # the new work (plus every voided carried verdict) as a
        # rank-stable SUBSET problem (see module doc;
        # tensorize(rank_pool=...) carries global ranks so ordering and
        # tie hashes match the full problem restricted to these rows).
        return "subset", live + forced
    return "solve", live


def micro_drain_limit() -> int:
    """KBT_MICRO_DRAIN: carried jobs re-examined per subset solve."""
    try:
        return max(0, int(os.environ.get("KBT_MICRO_DRAIN", "32")))
    except ValueError:
        return 32


def subset_jobs(ssn: "object", live: List) -> List:
    """The subset bundle's job list: the live jobs plus a bounded drain
    batch of carried jobs — the next ``KBT_MICRO_DRAIN`` in rotating
    sorted-uid order, so every carried verdict is refreshed within
    ``ceil(carried / drain)`` subset cycles. Any superset of ``live``
    is parity-safe: carried tasks are inert in the full problem under
    this plan's preconditions, in or out of the subset. The cursor
    advances only here, a pure function of solve history, so sim
    replays stay byte-stable."""
    ws = warm_state_of(ssn.cache)
    jobs = list(live)
    if ws is None or not ws.carried:
        return jobs
    seen = {j.uid for j in live}
    uids = sorted(u for u in ws.carried if u not in seen)
    if not uids:
        return jobs
    n = min(micro_drain_limit(), len(uids))
    cur = ws.drain_cursor % len(uids)
    picked = [uids[(cur + i) % len(uids)] for i in range(n)]
    ws.drain_cursor = (cur + n) % len(uids)
    for uid in picked:
        job = ssn.jobs.get(uid)
        if job is not None:
            jobs.append(job)
    return jobs


def note_deferred(ssn: "object") -> None:
    """A micro cycle deferred (plan fallback) after its session already
    DRAINED the cache's dirty ledgers: fold the drained deltas into the
    warm state so the next plan still sees them, and keep the
    snapshot-generation continuity — without this a single defer would
    strand every following micro cycle on ``stale`` until the next
    periodic solve."""
    ws = warm_state_of(ssn.cache)
    if ws is None or not ws.valid:
        return
    ws.pending_dirty_jobs.update(ssn.dirty_jobs)
    ws.pending_dirty_nodes.update(ssn.dirty_nodes)
    ws.pending_narrow.update(ssn.dirty_jobs_narrow)
    ws.snap_gen = getattr(ssn, "snap_gen", 0)


def advance_noop(ssn) -> None:
    """A no-op cycle consumed one snapshot generation; keep continuity.
    Carried entries that passed the plan via the NARROW remainder check
    (a bind re-minted the job's clone) are re-pinned to the current
    clone — otherwise the very next cycle's identity check would fail
    against the drained ledger and force a spurious carried-changed
    full solve after every partial placement wave. Entries whose job
    was deleted are pruned (the full problem no longer contains them)."""
    ws = warm_state_of(ssn.cache)
    if ws is None:
        return
    ws.snap_gen = getattr(ssn, "snap_gen", 0)
    ws.mesh_token = _layout_token()
    ws.pending_dirty_jobs.clear()
    ws.pending_dirty_nodes.clear()
    ws.pending_narrow.clear()
    for uid, (obj, ver, remainder) in list(ws.carried.items()):
        job = ssn.jobs.get(uid)
        if job is None:
            del ws.carried[uid]
        elif job is not obj or job._ver != ver:
            ws.carried[uid] = (job, job._ver, remainder)


def invalidate(cache) -> None:
    ws = getattr(cache, "_warm_solve_state", None)
    if ws is not None:
        ws.valid = False


def save_warm_state(ssn, ctx, assigned) -> int:
    """Record this solve's carried verdicts (called post-apply). With
    ``ctx is None`` (an idle cycle: nothing pending) the carried set is
    empty — the strongest warm state there is. After a SUBSET solve
    (``ctx.subset_jobs``) carried entries OUTSIDE the subset keep their
    verdicts — re-pinned to the current clone where narrow bind churn
    re-minted it, like :func:`advance_noop` — and subset jobs'
    entries are superseded by this solve's unassigned rows. Returns the
    carried job count (stats)."""
    ws = warm_state_of(ssn.cache)
    if ws is None:
        return 0
    carried: Dict[str, tuple] = {}
    has_releasing = True
    subset = getattr(ctx, "subset_jobs", None) if ctx is not None else None
    if subset is not None and ws.valid:
        for uid, (obj, ver, remainder) in ws.carried.items():
            if uid in subset:
                continue
            job = ssn.jobs.get(uid)
            if job is None:
                continue
            if job is not obj or job._ver != ver:
                carried[uid] = (job, job._ver, remainder)
            else:
                carried[uid] = (obj, ver, remainder)
    if ctx is None:
        # Idle: no pending tasks at all. Releasing presence from the
        # tensorize cache's freshly absorbed columns.
        tc = getattr(ssn.cache, "_tensorize_cache", None)
        if tc is not None and tc.releasing is not None and len(
            getattr(tc, "node_objs", None) or ()
        ) == len(ssn.nodes):
            has_releasing = bool(tc.releasing.any())
    else:
        import numpy as np

        has_releasing = bool(ctx.has_releasing)
        T = len(ctx.tasks)
        a = np.asarray(assigned[:T])
        for i in np.nonzero(a < 0)[0].tolist():
            task = ctx.tasks[i]
            if task.job in carried:
                continue
            job = ssn.jobs.get(task.job)
            if job is None:
                continue
            carried[task.job] = (
                job, job._ver,
                len(job.task_status_index.get(TaskStatus.PENDING) or ()),
            )
    deserved: Dict[str, object] = {}
    for uid, (job, _v, _r) in carried.items():
        quid = job.queue
        if quid in deserved:
            continue
        queue = ssn.queues.get(quid)
        d = _deserved_of(ssn, queue) if queue is not None else None
        deserved[quid] = d.clone() if d is not None else None
    ws.carried = carried
    ws.queue_deserved = deserved
    ws.has_releasing = has_releasing
    ws.snap_gen = getattr(ssn, "snap_gen", 0)
    ws.mesh_token = _layout_token()
    ws.pending_dirty_jobs.clear()
    ws.pending_dirty_nodes.clear()
    ws.pending_narrow.clear()
    ws.valid = True
    return len(carried)
