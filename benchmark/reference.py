"""The plain reference that decides ``correct``.

It works out again, from what the benchmark itself fed the cluster and
saw come back, whether the scheduler kept the guarantees its
configuration states, and it times every pod from its due time. It
reads the program's outputs only to judge them: the assignments each
cycle handed to the cache (``dispatch``), the binds that reached the
benchmark's binder (``ack``) and, once the loop has stopped, the
program's mirror of each node. Plain NumPy; it imports nothing of the
program.

The numbers it compares, each with the limit it must not pass:

- ``unbound``: pods due before the window closed that no bind reached
  by the end of the grace period;
- ``overcommit``: binds after which a node held more CPU, memory or
  pods than it has, replayed in time order against the pods the
  benchmark placed there and has not deleted;
- ``gang_below_min``: (cycle, gang) pairs after which a gang had some
  pods assigned but fewer than its minMember;
- ``apply_mismatch``: binds on another node than the last assignment of
  that pod, binds of a pod never assigned, second binds of one pod, and
  assignments that no bind followed;
- ``score_gap``: over every assignment a cycle made, the mean by which
  the assigned node's LeastRequested plus Balanced score (the policy's
  ``nodeorder``) lies below the best score of a node where the pod
  fits, both worked out from the cluster as the benchmark held it when
  the cycle started: what the benchmark placed and had not deleted,
  with the pods assigned and not yet bound. A round-based solver gives
  some of it away to pods that bid for one node in the same cycle;
  a wrong score, a wrong candidate set or a placement at random gives
  much more;
- ``mirror_mismatch``: nodes whose CPU, memory or pod count in the
  program's mirror differs from the cluster's after the drain;
- ``event_errors``: cluster events (an arrival, a Running flip, a
  delete) that the program's event handlers refused (counted by the
  harness, which delivered them).
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np

# The score gap's limit, in points of the 0..20 score (section 2 of
# PERF.md gives the readings it was set from).
SCORE_GAP_LIMIT = 2.5

# Every count is exact: one breach is a wrong answer. The score gap's
# limit lies between what sound runs of the program read and what the
# control reads (PERF.md, section 2).
LIMITS = {
    "unbound": 0,
    "overcommit": 0,
    "gang_below_min": 0,
    "apply_mismatch": 0,
    "score_gap": SCORE_GAP_LIMIT,
    "mirror_mismatch": 0,
    "event_errors": 0,
}


def percentile(values: Sequence[float], q: float) -> float:
    """Nearest-rank percentile; ``inf`` stands for a pod never bound,
    which misses every limit."""
    v = np.sort(np.asarray(values, dtype=np.float64))
    if v.size == 0:
        return math.nan
    k = max(int(math.ceil(q / 100.0 * v.size)) - 1, 0)
    return float(v[k])


def latencies_ms(due: np.ndarray, bound_at: np.ndarray) -> np.ndarray:
    """Due time to bind, in ms; ``inf`` where ``bound_at`` is NaN."""
    lat = (bound_at - due) * 1e3
    return np.where(np.isnan(bound_at), np.inf, lat)


class World:
    """What the benchmark fed: node sizes, every pod's requests and gang,
    and where the running population was placed."""

    def __init__(self, alloc: np.ndarray, pod_req: np.ndarray,
                 pod_gang: np.ndarray, gang_min: np.ndarray,
                 initial_node: np.ndarray):
        self.alloc = np.asarray(alloc, dtype=np.int64)          # [N, 3]
        self.pod_req = np.asarray(pod_req, dtype=np.int64)      # [P, 2]
        self.pod_gang = np.asarray(pod_gang, dtype=np.int64)    # [P]
        self.gang_min = np.asarray(gang_min, dtype=np.int64)    # [G]
        self.initial_node = np.asarray(initial_node, dtype=np.int64)  # [P]


def replay(world: World, log: List[tuple], due_pods: np.ndarray,
           mirror: np.ndarray) -> Dict[str, int]:
    """Every count of :data:`LIMITS` but ``event_errors`` from the run's
    log.

    ``log`` holds ``("dispatch", t, cycle, pod, node)``, ``("ack", t,
    pod, node)``, ``("delete", t, pod)``, ``("cycle_start", t, cycle)``
    and ``("cycle_end", t, cycle)`` records; ``due_pods`` the pods that had to be bound; ``mirror`` the
    program's [N, 3] CPU (m), memory (MiB) and pod count after the
    drain."""
    N = world.alloc.shape[0]
    usage = np.zeros((N, 3), dtype=np.int64)
    where = world.initial_node.copy()          # node a pod holds, or -1
    running = where >= 0
    np.add.at(usage, (where[running], 0), world.pod_req[running, 0])
    np.add.at(usage, (where[running], 1), world.pod_req[running, 1])
    np.add.at(usage, (where[running], 2), 1)

    held = usage.copy()                        # with assigned, unbound pods
    cap = world.alloc[:, :2].astype(np.float64)
    at_start: Dict[int, np.ndarray] = {}       # cycle: idle when it began
    made: Dict[int, list] = {}                 # cycle: [(pod, node)]
    gap_sum, gap_n = 0.0, 0

    assigned = np.full(where.shape, -1, dtype=np.int64)
    acked = np.zeros(where.shape, dtype=bool)
    gang_assigned = np.zeros(world.gang_min.shape, dtype=np.int64)
    touched: Dict[int, set] = {}
    out = dict.fromkeys(LIMITS, 0)
    del out["event_errors"]

    order = sorted(range(len(log)), key=lambda i: (log[i][1], i))
    for i in order:
        rec = log[i]
        kind = rec[0]
        if kind == "dispatch":
            _, _, cycle, pod, node = rec
            if assigned[pod] < 0 and not acked[pod]:
                gang_assigned[world.pod_gang[pod]] += 1
            if not acked[pod]:
                if assigned[pod] >= 0:
                    held[assigned[pod], :2] -= world.pod_req[pod]
                    held[assigned[pod], 2] -= 1
                held[node, :2] += world.pod_req[pod]
                held[node, 2] += 1
            assigned[pod] = node
            touched.setdefault(cycle, set()).add(int(world.pod_gang[pod]))
            if cycle in at_start:
                made.setdefault(cycle, []).append((pod, node))
        elif kind == "cycle_start":
            at_start[rec[2]] = world.alloc - held
        elif kind == "cycle_end":
            for g in touched.pop(rec[2], ()):
                if 0 < gang_assigned[g] < world.gang_min[g]:
                    out["gang_below_min"] += 1
            idle = at_start.pop(rec[2], None)
            pairs = made.pop(rec[2], [])
            if idle is not None and pairs:
                gaps = score_gaps(world.pod_req, idle, cap, pairs)
                gap_sum += float(gaps.sum())
                gap_n += gaps.size
        elif kind == "ack":
            _, _, pod, node = rec
            if acked[pod] or assigned[pod] != node:
                out["apply_mismatch"] += 1
            if acked[pod]:
                continue
            acked[pod] = True
            if assigned[pod] >= 0:
                held[assigned[pod], :2] -= world.pod_req[pod]
                held[assigned[pod], 2] -= 1
            held[node, :2] += world.pod_req[pod]
            held[node, 2] += 1
            assigned[pod] = -1
            where[pod] = node
            usage[node, :2] += world.pod_req[pod]
            usage[node, 2] += 1
            if (usage[node] > world.alloc[node]).any():
                out["overcommit"] += 1
        elif kind == "delete":
            pod = rec[2]
            node = where[pod]
            if node >= 0:
                usage[node, :2] -= world.pod_req[pod]
                usage[node, 2] -= 1
                held[node, :2] -= world.pod_req[pod]
                held[node, 2] -= 1
                where[pod] = -1
    out["apply_mismatch"] += int((assigned >= 0).sum())
    out["score_gap"] = gap_sum / gap_n if gap_n else 0.0
    out["unbound"] = int((~acked[due_pods]).sum())
    mirror = np.asarray(mirror, dtype=np.int64)
    out["mirror_mismatch"] = int((mirror != usage).any(axis=1).sum())
    return out


def scores(req: np.ndarray, idle: np.ndarray, cap: np.ndarray) -> np.ndarray:
    """Kubernetes' LeastRequested plus BalancedResourceAllocation (0..10
    each, weights 1 as the policy's nodeorder sets them) of one pod's
    CPU and memory ``req`` on every node, from the nodes' ``idle`` and
    ``cap`` [N, 2]."""
    left = idle - req
    least = np.clip(left, 0, None) * 10.0 / cap
    frac = 1.0 - left / cap
    balanced = np.where((frac >= 1.0).any(axis=1), 0.0,
                        10.0 - np.abs(frac[:, 0] - frac[:, 1]) * 10.0)
    return least.mean(axis=1) + balanced


def score_gaps(pod_req: np.ndarray, idle: np.ndarray, cap: np.ndarray,
               pairs: List[tuple]) -> np.ndarray:
    """For each ``(pod, node)`` of one cycle, the best score of a node
    where the pod fits less the score of ``node``, on the ``idle``
    [N, 3] the cycle started from. Pods with no node that fits then
    (one freed inside the cycle) are left out."""
    pods = np.array([p for p, _ in pairs], dtype=np.int64)
    nodes = np.array([n for _, n in pairs], dtype=np.int64)
    req = pod_req[pods]
    classes, cls = np.unique(req, axis=0, return_inverse=True)
    cls = cls.reshape(-1)
    out = np.full(pods.size, np.nan)
    free = idle[:, :2].astype(np.float64)
    room = idle[:, 2] >= 1
    for c, r in enumerate(classes):
        sel = cls == c
        fits = (free >= r).all(axis=1) & room
        if not fits.any():
            continue
        s = scores(r.astype(np.float64), free, cap)
        out[sel] = s[fits].max() - s[nodes[sel]]
    return out[~np.isnan(out)]


def judge(counts: Dict[str, int]) -> Dict[str, dict]:
    """Each number beside its limit."""
    return {k: {"value": counts[k], "limit": LIMITS[k]} for k in LIMITS}


def correct(checks: Dict[str, dict]) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())
