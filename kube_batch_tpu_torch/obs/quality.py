"""Placement-quality scorecard: how WELL the scheduler places.

A copy of the reference's ``obs/quality.py``, with the simulator's
``water_fill`` copied in (the port has no simulator). The latency SLIs
and telemetry say how *fast* placement is; this module scores the *placements themselves*, per cycle, from arrays
the cycle already has (O(nodes + queues + jobs)):

- **packing density** — used/allocatable per resource dimension, both
  cluster-aggregate and node-count-weighted (the mean of per-node
  ratios — a cluster packed onto half its nodes with the other half
  empty scores the same aggregate but a lower node mean + a higher
  emptiable count, which is exactly the consolidation signal);
- **fragmentation** — how many nodes are empty, how many more could be
  *emptied* (their used vectors relocated into the remaining nodes'
  idle headroom, vectorized sorted-prefix water-fill over the idle
  matrix), and per queue the largest gang-member count its biggest
  pending gang could place RIGHT NOW (floor-divide of the idle matrix
  by the gang's per-member request, summed over nodes);
- **fairness** — per-queue signed distance between allocated and the
  water-filled deserved share (same math as the proportion plugin and
  the telemetry fairness probe), plus a Jain index over per-queue
  satisfaction ratios (1.0 = perfectly proportional);
- **disruption churn** — evictions / preemptions / re-binds per
  placement, accumulated by the cache's evict/bind seams and read as
  deltas per card;
- **solver quality rates** — sparse-solve engagement, candidate refill
  (spill) rounds, dense fallbacks, and micro-cycle defers, as counter
  deltas per card.

Everything feeds the established pipeline: telemetry series
(``quality:*``) with soak drift detectors, Prometheus gauges,
``/debug/quality`` + a ``/debug/vars`` block, the flight-record
``quality`` key, and a per-cycle ``quality`` block in the sim trace
(replay-compared minus the ``solver`` sub-dict — counter deltas are
path-dependent across solver modes; density/fairness/churn are pure
functions of the replayed cluster state).

The production feed amortizes the O(nodes) array walk on
``KBT_QUALITY_EVERY`` (default 64, same cadence as the fairness
probe); the simulator computes every cycle (small clusters).
``KBT_QUALITY=0`` disables the scheduler feed entirely. Cards contain
no wall-clock and all floats are rounded, so a card stream is
byte-stable under replay (canonical JSON).
"""

from __future__ import annotations

import logging
import os
from typing import TYPE_CHECKING, Dict, List, Optional, Sequence

from ..utils.lockdebug import witness_writes, wrap_lock

if TYPE_CHECKING:  # pragma: no cover - annotation-only import
    from ..cache import SchedulerCache

logger = logging.getLogger(__name__)

QUALITY_ENV = "KBT_QUALITY"              # "0" disables the feed
QUALITY_EVERY_ENV = "KBT_QUALITY_EVERY"  # production-feed cadence
DEFAULT_QUALITY_EVERY = 64
# The cluster-total Resource sum is O(nodes); refresh like the
# telemetry fairness probe (node-count change or every Nth card).
_NODE_TOTAL_REFRESH = 16
# Eviction-reason values that count as preemption churn (cache.evict
# callers pass these for preempt/reclaim victims).
_PREEMPT_REASONS = frozenset(("preempt", "reclaim"))
# The evicted-uid set exists to classify a later bind as a RE-bind; a
# uid evicted and never re-bound would otherwise pin memory forever on
# a production-length run.
_EVICTED_CAP = 1 << 18


def quality_enabled_from_env() -> bool:
    return os.environ.get(QUALITY_ENV, "1") != "0"


def quality_every_from_env() -> int:
    try:
        return max(1, int(os.environ.get(
            QUALITY_EVERY_ENV, DEFAULT_QUALITY_EVERY
        )))
    except ValueError:
        return DEFAULT_QUALITY_EVERY


def jain_index(values: Sequence[float]) -> float:
    """Jain's fairness index ``(Σx)² / (n·Σx²)`` over non-negative
    satisfaction ratios. Degenerate inputs are *defined*, not NaN: an
    empty vector and an all-zero vector both score 1.0 (a single queue,
    or every queue equally unserved, is perfectly fair)."""
    xs = [float(v) for v in values]
    if not xs:
        return 1.0
    s = sum(xs)
    sq = sum(v * v for v in xs)
    if sq <= 0.0:
        return 1.0
    return (s * s) / (len(xs) * sq)


def _dims_and_eps(nodes) -> "tuple":
    """Stable dimension order (cpu, memory, sorted scalars) + the
    per-dim epsilon vector matching Resource's comparison thresholds."""
    import numpy as np

    from ..api.resource_info import (
        MIN_MEMORY,
        MIN_MILLI_CPU,
        MIN_MILLI_SCALAR,
    )

    scalars = set()
    for node in nodes:
        scalars.update(node.allocatable.scalar_resources or {})
    dims = ["cpu", "memory"] + sorted(scalars)
    eps = np.array(
        [MIN_MILLI_CPU, MIN_MEMORY] + [MIN_MILLI_SCALAR] * len(scalars),
        dtype=np.float64,
    )
    return dims, eps


def _resource_rows(resources, dims) -> "object":
    """[N, R] float64 matrix of Resource vectors in ``dims`` order."""
    import numpy as np

    rows = np.empty((len(resources), len(dims)), dtype=np.float64)
    for j, dim in enumerate(dims):
        if dim == "cpu":
            rows[:, j] = [r.milli_cpu for r in resources]
        elif dim == "memory":
            rows[:, j] = [r.memory for r in resources]
        else:
            rows[:, j] = [
                (r.scalar_resources or {}).get(dim, 0.0)
                for r in resources
            ]
    return rows


def _emptiable_prefix(used, idle, eps) -> int:
    """Largest k such that the k least-loaded non-empty nodes could ALL
    be drained into the remaining nodes' idle headroom (per-dimension,
    epsilon-tolerant). Sorted-prefix water-fill: moving load off the
    least-loaded nodes first is optimal for the count, and feasibility
    is monotone in k (prefix used grows, destination idle shrinks), so
    the answer is the length of the leading feasible run."""
    import numpy as np

    n = used.shape[0]
    if n == 0:
        return 0
    alloc_frac = np.where(
        idle + used > 0.0, used / np.maximum(idle + used, 1e-12), 0.0
    )
    order = np.lexsort((np.arange(n), alloc_frac.max(axis=1)))
    cum_used = np.cumsum(used[order], axis=0)
    cum_idle = np.cumsum(idle[order], axis=0)
    total_idle = idle.sum(axis=0)
    feasible = np.all(
        cum_used <= (total_idle - cum_idle) + eps, axis=1
    )
    bad = np.flatnonzero(~feasible)
    return int(bad[0]) if bad.size else n


def _largest_placeable(idle, req, eps) -> int:
    """How many members of a gang with per-member request ``req`` the
    current idle matrix could hold: Σ_nodes min over requested dims of
    ``floor(idle / req)``."""
    import numpy as np

    mask = req > eps
    if not mask.any():
        return 0
    per_dim = np.floor(
        np.maximum(idle[:, mask], 0.0) / req[mask]
    )
    return int(per_dim.min(axis=1).sum())


def _solver_deltas(state: dict) -> Dict[str, float]:
    """Per-card deltas of the existing solver-quality counters (sparse
    engagement, refill/spill rounds, dense fallbacks, micro defers).
    Path-dependent (excluded from replay comparison)."""
    from .. import metrics

    totals = {
        "sparse_solves": metrics.solver_sparse_solves.total(),
        "refill_rounds": metrics.solver_sparse_refill_rounds.total(),
        "dense_fallbacks": metrics.solver_sparse_dense_fallbacks.total(),
        "micro_deferred": metrics.scheduler_micro_cycles.get(
            ("deferred",)
        ),
    }
    prev = state.setdefault("solver_totals", {})
    out = {
        key: round(float(v - prev.get(key, 0.0)), 6)
        for key, v in totals.items()
    }
    state["solver_totals"] = totals
    return out


def water_fill(
    total: "Resource",
    weights: Dict[str, int],
    requests: Dict[str, "Resource"],
) -> Dict[str, "Resource"]:
    """Independent re-derivation of the proportion plugin's deserved
    shares (plugins/proportion.py water-filling). A copy of the
    reference simulator's ``sim/invariants.py::water_fill``, the one
    function of the simulator that the scorecard and the telemetry
    fairness probe read."""
    from ..api import Resource, min_resource

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


def compute_scorecard(
    cache: "SchedulerCache",
    churn: Optional[Dict[str, float]] = None,
    state: Optional[dict] = None,
) -> dict:
    """One placement-quality card from the live cache. ``churn`` is the
    caller's delta dict (evictions/preemptions/rebinds/placements since
    its previous card — the scheduler feed and the simulator each own
    their own deltas so cadences never corrupt each other); ``state``
    memoizes the O(nodes) cluster total and the solver counter totals
    between cards."""
    import numpy as np

    from ..api import Resource
    from ..api.types import TaskStatus

    state = state if state is not None else {}
    with cache.mutex:
        nodes = [
            cache.nodes[name] for name in sorted(cache.nodes)
            if cache.nodes[name].node is not None
            and cache.nodes[name].ready()
        ]
        dims, eps = _dims_and_eps(nodes)
        alloc = _resource_rows([n.allocatable for n in nodes], dims)
        idle = _resource_rows([n.idle for n in nodes], dims)
        queues = {q.name: q.weight for q in cache.queues.values()}
        n_nodes = len(nodes)
        cards = state.get("cards", 0) + 1
        state["cards"] = cards
        if (
            state.get("n_nodes") != n_nodes
            or cards % _NODE_TOTAL_REFRESH == 1
            or "total" not in state
        ):
            total = Resource.empty()
            for node in nodes:
                total.add(node.allocatable)
            state["total"] = total
            state["n_nodes"] = n_nodes
        total = state["total"]
        allocated = {q: Resource.empty() for q in queues}
        requests = {q: Resource.empty() for q in queues}
        pending_gangs: Dict[str, tuple] = {}
        for job in cache.jobs.values():
            if job.queue not in queues:
                continue
            allocated[job.queue].add(job.allocated)
            requests[job.queue].add(job.total_request)
            pending = job.task_status_index.get(TaskStatus.PENDING)
            if pending:
                rep = pending[min(pending)]
                key = (len(pending), job.uid)
                best = pending_gangs.get(job.queue)
                # Largest pending gang wins; uid breaks ties so the
                # card is replay-deterministic across dict orders.
                if best is None or key > best[0]:
                    pending_gangs[job.queue] = (key, rep.resreq)

    # -- packing density (outside the mutex: pure array math) ---------------
    used = np.clip(alloc - idle, 0.0, None)
    alloc_sum = alloc.sum(axis=0)
    density = {
        dim: round(
            float(used[:, j].sum() / alloc_sum[j])
            if alloc_sum[j] > 0.0 else 0.0,
            6,
        )
        for j, dim in enumerate(dims)
    }
    if n_nodes:
        per_node = np.where(
            alloc > eps, used / np.maximum(alloc, 1e-12), 0.0
        )
        node_mean = {
            dim: round(float(per_node[:, j].mean()), 6)
            for j, dim in enumerate(dims)
        }
    else:
        node_mean = {dim: 0.0 for dim in dims}
    density_dom = max(density.values()) if density else 0.0

    # -- fragmentation -------------------------------------------------------
    empty_mask = (
        np.all(used < eps, axis=1) if n_nodes
        else np.zeros(0, dtype=bool)
    )
    empty_nodes = int(empty_mask.sum())
    emptiable = empty_nodes + _emptiable_prefix(
        used[~empty_mask], idle[~empty_mask], eps
    )
    largest_gang = {}
    for queue in sorted(pending_gangs):
        _key, resreq = pending_gangs[queue]
        req = _resource_rows([resreq], dims)[0]
        largest_gang[queue] = _largest_placeable(idle, req, eps)

    # -- fairness ------------------------------------------------------------
    distance: Dict[str, float] = {}
    satisfaction: List[float] = []
    if len(queues) >= 2:
        deserved = water_fill(total, queues, requests)
        cap_dims = [
            (dim, total.get(dim)) for dim in total.resource_names()
            if total.get(dim) > 0.0
        ]
        for q in sorted(queues):
            drift = 0.0
            for dim, cap in cap_dims:
                d = (allocated[q].get(dim) - deserved[q].get(dim)) / cap
                if abs(d) > abs(drift):
                    drift = d
            distance[q] = round(drift, 6)
            # Satisfaction ratio on the queue's dominant deserved dim:
            # how much of what water-filling owes it does it hold.
            dom = max(
                cap_dims, key=lambda dc: deserved[q].get(dc[0]) / dc[1],
                default=None,
            )
            if dom is not None and deserved[q].get(dom[0]) > 0.0:
                satisfaction.append(
                    min(
                        allocated[q].get(dom[0]) / deserved[q].get(dom[0]),
                        4.0,
                    )
                )
    jain = round(jain_index(satisfaction), 6)

    # -- churn ---------------------------------------------------------------
    churn = dict(churn or {})
    placements = float(churn.get("placements", 0.0))
    evictions = float(churn.get("evictions", 0.0))
    rebinds = float(churn.get("rebinds", 0.0))
    churn_card = {
        "evictions": round(evictions, 6),
        "preemptions": round(float(churn.get("preemptions", 0.0)), 6),
        "rebinds": round(rebinds, 6),
        "placements": round(placements, 6),
        "per_placement": round(
            (evictions + rebinds) / max(1.0, placements), 6
        ),
    }

    return {
        "nodes": n_nodes,
        "queues": len(queues),
        "density": density,
        "density_node_mean": node_mean,
        "density_dom": round(float(density_dom), 6),
        "frag": {
            "empty_nodes": empty_nodes,
            "emptiable_nodes": emptiable,
            "emptiable_frac": round(emptiable / max(1, n_nodes), 6),
            "largest_gang": largest_gang,
        },
        "fairness": {"jain": jain, "distance": distance},
        "churn": churn_card,
        "solver": _solver_deltas(state),
    }


def replay_view(card: Optional[dict]) -> Optional[dict]:
    """The replay-compared projection of a card: everything except the
    ``solver`` counter deltas, which are path-dependent (a two-level
    replay of a flat trace matches placements bit-for-bit but takes
    different refill rounds)."""
    if card is None:
        return None
    return {k: v for k, v in card.items() if k != "solver"}


def telemetry_values(card: dict) -> Dict[str, float]:
    """Flatten a card into the telemetry series the soak drift
    detectors watch (``quality:*``)."""
    values = {
        f"quality:density:{dim}": v
        for dim, v in card.get("density", {}).items()
    }
    values["quality:density_dom"] = float(card.get("density_dom", 0.0))
    fairness = card.get("fairness", {})
    values["quality:fairness_jain"] = float(fairness.get("jain", 1.0))
    values["quality:unfairness"] = round(
        1.0 - float(fairness.get("jain", 1.0)), 6
    )
    frag = card.get("frag", {})
    values["quality:frag_emptiable_frac"] = float(
        frag.get("emptiable_frac", 0.0)
    )
    values["quality:empty_nodes"] = float(frag.get("empty_nodes", 0))
    values["quality:churn_per_placement"] = float(
        card.get("churn", {}).get("per_placement", 0.0)
    )
    return values


class QualityMonitor:
    """Cumulative churn accounting + the amortized production feed.

    The cache's evict/bind seams call :meth:`note_eviction` /
    :meth:`note_bound` (cheap: one lock, counter bumps, a set probe to
    classify re-binds). ``Scheduler.run_once``/``run_micro`` call
    :meth:`annotate_cycle` before closing the flight record; every
    ``KBT_QUALITY_EVERY``-th cycle it computes a card, attaches it to
    the open flight record, and pushes the Prometheus gauges. The
    simulator bypasses the cadence and calls :func:`compute_scorecard`
    directly with its own delta state."""

    def __init__(self):
        self._lock = wrap_lock("obs.quality")
        self.enabled = quality_enabled_from_env()
        self.every = quality_every_from_env()
        self._cycles = 0
        self._cards = 0
        self._state: dict = {}
        self._prev: Dict[str, float] = {}
        self._last_card: Optional[dict] = None
        self.evictions = 0
        self.preemptions = 0
        self.rebinds = 0
        self.bound = 0
        self.evictions_by_reason: Dict[str, int] = {}
        self._evicted: set = set()
        witness_writes(self, "obs.quality", (
            "_cycles", "_cards", "_last_card", "evictions",
            "preemptions", "rebinds", "bound",
        ))

    def reset(self) -> None:
        with self._lock:
            self.enabled = quality_enabled_from_env()
            self.every = quality_every_from_env()
            self._cycles = 0
            self._cards = 0
            self._state = {}
            self._prev = {}
            self._last_card = None
            self.evictions = 0
            self.preemptions = 0
            self.rebinds = 0
            self.bound = 0
            self.evictions_by_reason = {}
            self._evicted = set()

    # -- churn seams (cache/cache.py) ---------------------------------------

    def note_eviction(self, uid: str, reason: str = "") -> None:
        with self._lock:
            self.evictions += 1
            key = reason or "unknown"
            self.evictions_by_reason[key] = (
                self.evictions_by_reason.get(key, 0) + 1
            )
            if reason in _PREEMPT_REASONS:
                self.preemptions += 1
            if len(self._evicted) >= _EVICTED_CAP:
                self._evicted.clear()
            self._evicted.add(uid)
        try:
            from .. import metrics

            metrics.register_quality_eviction(reason or "unknown")
        except Exception:  # pragma: no cover - metrics must never kill
            logger.exception("quality eviction metric failed")

    def note_bound(self, uids: Sequence[str]) -> None:
        if not uids:
            return
        with self._lock:
            self.bound += len(uids)
            rebound = [u for u in uids if u in self._evicted]
            if rebound:
                self.rebinds += len(rebound)
                self._evicted.difference_update(rebound)
        if rebound:
            try:
                from .. import metrics

                metrics.register_quality_rebinds(len(rebound))
            except Exception:  # pragma: no cover
                logger.exception("quality rebind metric failed")

    def counters(self) -> Dict[str, float]:
        with self._lock:
            return {
                "evictions": float(self.evictions),
                "preemptions": float(self.preemptions),
                "rebinds": float(self.rebinds),
                "placements": float(self.bound),
            }

    def churn_delta(self, prev: Dict[str, float]) -> Dict[str, float]:
        """Delta of the cumulative churn counters against ``prev``
        (caller-owned: the scheduler feed and any sim feed each pass
        their own), updating ``prev`` in place."""
        now = self.counters()
        delta = {k: now[k] - prev.get(k, 0.0) for k in now}
        prev.update(now)
        return delta

    # -- the production feed -------------------------------------------------

    def annotate_cycle(
        self, cache: Optional["SchedulerCache"]
    ) -> Optional[dict]:
        """Per-cycle entry point (both cycle kinds — micro cycles count
        toward the cadence exactly like the telemetry probes). On the
        cadence: compute a card, attach it to the OPEN flight record,
        push gauges. Returns the card when one was computed."""
        if not self.enabled or cache is None:
            return None
        with self._lock:
            cycle = self._cycles
            self._cycles += 1
        if cycle % self.every != 0:
            return None
        card = compute_scorecard(
            cache, churn=self.churn_delta(self._prev),
            state=self._state,
        )
        with self._lock:
            self._cards += 1
            self._last_card = card
        from .flightrecorder import RECORDER

        RECORDER.annotate("quality", card)
        try:
            from .. import metrics

            metrics.update_quality(card)
        except Exception:  # pragma: no cover - metrics must never kill
            logger.exception("quality metrics export failed")
        return card

    # -- read side (/debug/quality, /debug/vars) ----------------------------

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "type": "quality",
                "enabled": self.enabled,
                "every": self.every,
                "cycles_seen": self._cycles,
                "cards_computed": self._cards,
                "counters": {
                    "evictions": self.evictions,
                    "preemptions": self.preemptions,
                    "rebinds": self.rebinds,
                    "placements": self.bound,
                    "evictions_by_reason": dict(
                        self.evictions_by_reason
                    ),
                },
                "last": self._last_card,
            }


QUALITY = QualityMonitor()
