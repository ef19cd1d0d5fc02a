"""Session → solver bundle: the snapshot side of the batched solver.

A copy of the reference's ``solver/snapshot.py``. The whole Session
becomes one ``SolverInputs`` bundle of NumPy arrays (task-major arrays,
node arrays, predicates as a factorized boolean mask, static scores as
sparse rows), built incrementally across cycles against fingerprint
caches on the scheduler cache; the device pack stacks it into the few
buffers of :class:`~.kernels.PackedInputs` (:func:`stack_inputs`, shared
by :func:`tensorize` and :func:`pack_inputs`) and ships them through the
device-resident cache (``device_cache``).

Resource-dimension layout (`ResourceLayout`): dim 0 = milliCPU, dim 1 =
memory in MiB (scaled from bytes so f32 prefix sums stay far inside the
10 MiB epsilon, resource_info.go:68-70), dims 2+ = named milli-scalars
(nvidia.com/gpu, google.com/tpu, ...), the union over every task request and
node capacity in the session.

Priority ranks reproduce the greedy loop's nested priority-queue order
statically: queues sorted by ``ssn.queue_order_fn``, jobs within a queue by
``ssn.job_order_fn``, tasks within a job by ``ssn.task_order_fn``
(allocate.go:47-117). DRF/proportion shares evolve *during* the greedy loop;
the batched solver instead re-checks queue budgets every round and keeps
job/task order fixed per solve — same fairness stationary point, one
documented divergence in intermediate orderings.

Any object with the ``SolverInputs`` field names holding arrays (such as
the JAX package's ``ctx.host_inputs``) packs with :func:`pack_inputs`;
the way back is ``SolverResult.to_numpy()``.
"""

from __future__ import annotations

import functools
import logging
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..utils.lockdebug import wrap_lock
from .contracts import (
    contracts_enabled,
    validate_packed,
    validate_solver_inputs,
)

from ..api import (
    JobInfo,
    NodeInfo,
    NodePhase,
    QueueInfo,
    Resource,
    TaskInfo,
    TaskStatus,
)
from ..api.resource_info import (
    MIN_MEMORY,
    MIN_MILLI_CPU,
    MIN_MILLI_SCALAR,
)

MIB = 2.0**20

logger = logging.getLogger(__name__)

# Forensics of the most recent tensorize() (bench/metrics attribution,
# read by actions.allocate_tpu): whether the node-side arrays were
# patched incrementally, how many rows were dirty, and why a full
# rebuild happened when one did. Single-threaded by construction, like
# actions.allocate_tpu.last_stats.
last_tensorize_stats: dict = {}


@dataclass
class ResourceLayout:
    """Fixed ordering of resource dimensions for one solve."""

    scalars: List[str] = field(default_factory=list)

    @property
    def dims(self) -> int:
        return 2 + len(self.scalars)

    @classmethod
    def for_session(cls, ssn) -> "ResourceLayout":
        names = set()
        for node in ssn.nodes.values():
            sr = node.allocatable.scalar_resources
            if sr:
                names.update(sr)
        for job in ssn.jobs.values():
            for task in job.tasks.values():
                sr = task.resreq.scalar_resources
                if sr:
                    names.update(sr)
                sr = task.init_resreq.scalar_resources
                if sr:
                    names.update(sr)
        return cls(sorted(names))

    def vec(self, r: Resource) -> np.ndarray:
        out = np.zeros(self.dims, dtype=np.float32)
        out[0] = r.milli_cpu
        out[1] = r.memory / MIB
        for i, name in enumerate(self.scalars):
            out[2 + i] = (r.scalar_resources or {}).get(name, 0.0)
        return out

    def eps(self) -> np.ndarray:
        out = np.full(self.dims, MIN_MILLI_SCALAR, dtype=np.float32)
        out[0] = MIN_MILLI_CPU
        out[1] = MIN_MEMORY / MIB
        return out


@dataclass
class SnapshotContext:
    """Maps kernel indices back to session objects."""

    layout: ResourceLayout
    tasks: List[TaskInfo]
    nodes: List[NodeInfo]
    queues: List[QueueInfo]
    mask: Optional["CombinedMask"] = None  # host-side feasibility rows
    # Unpadded host copies for the vectorized apply-phase fit guard
    # (float64 so cumulative sums stay exact against the epsilon
    # comparisons): init_resreq rows (each task's own fit requirement),
    # resreq rows (what node accounting actually subtracts), node idle.
    task_fit_host: Optional[np.ndarray] = None
    task_req_host: Optional[np.ndarray] = None
    node_idle_host: Optional[np.ndarray] = None
    # NumPy-backed SolverInputs (same padded arrays that feed the device
    # pack).
    host_inputs: Optional[object] = None
    # True iff ANY node holds Releasing capacity this snapshot — lets
    # the action's pipeline epilogue skip its candidate scan outright in
    # the common no-eviction cycle.
    has_releasing: bool = False
    # Warm SUBSET bundle (solver/warm.py): the uids of the jobs whose
    # tasks this bundle covers (None for full bundles) and the full
    # pending pool's task count — the global rank domain the subset's
    # task_rank values index into.
    subset_jobs: Optional[frozenset] = None
    rank_total: int = 0


def _sorted_by(items, less_fn):
    """Sort with a reference-style less-function (returns True iff l
    schedules before r)."""

    def cmp(l, r):
        if less_fn(l, r):
            return -1
        if less_fn(r, l):
            return 1
        return 0

    return sorted(items, key=functools.cmp_to_key(cmp))


def _order_jobs(ssn, jobs):
    """Jobs in job_order_fn order — one numpy lexsort when every enabled
    job-order plugin provides a batch key (gang/drf/priority do),
    comparison sort otherwise. Tie-break (creation_timestamp, uid)
    matches Session.job_order_fn exactly."""
    if len(jobs) <= 1:
        return list(jobs)
    keys = ssn.batch_job_order_keys(jobs)
    if keys is None:
        return _sorted_by(jobs, ssn.job_order_fn)
    uids = np.asarray([j.uid or "" for j in jobs])
    ts = np.asarray([j.creation_timestamp for j in jobs], np.float64)
    order = np.lexsort(tuple([uids, ts]) + tuple(reversed(keys)))
    return [jobs[i] for i in order]


def _resource_matrix(resources, layout: ResourceLayout) -> np.ndarray:
    """Columnar [K, R] matrix from Resource objects (no per-item vec())."""
    out = np.zeros((len(resources), layout.dims), dtype=np.float64)
    out[:, 0] = [r.milli_cpu for r in resources]
    out[:, 1] = np.asarray([r.memory for r in resources], np.float64) / MIB
    for i, name in enumerate(layout.scalars):
        out[:, 2 + i] = [
            (r.scalar_resources or {}).get(name, 0.0) for r in resources
        ]
    return out


# ---------------------------------------------------------------- rebuild
# Cold-path parallelism: the ~240 ms full tensorize rebuild at 50k×5k is
# column fills and per-job scalar scans with no cross-row dependencies,
# so both chunk across a shared thread pool and scale with cores (numpy
# fills release the GIL for the vectorized part; the Python attribute
# walks at least interleave). KBT_TENSORIZE_WORKERS overrides the pool
# width (1 disables).

_rebuild_pool = None
_rebuild_pool_lock = wrap_lock("solver.rebuild_pool")
# Below these sizes the submit/join overhead beats any overlap.
_PAR_MIN_NODES = 1024
_PAR_MIN_JOBS = 512


def _tensorize_workers() -> int:
    raw = os.environ.get("KBT_TENSORIZE_WORKERS", "")
    try:
        if raw:
            return max(1, int(raw))
    except ValueError:
        pass
    # With the GIL enabled the chunk fills' Python attribute walks
    # serialize anyway and the submit/join overhead is a measured net
    # loss (A/B at 5k nodes: 5.2 ms serial vs 7.0 ms at 2 workers), so
    # the pool defaults on only where it can actually run in parallel
    # (free-threaded builds). KBT_TENSORIZE_WORKERS forces either way.
    import sys

    gil_enabled = getattr(sys, "_is_gil_enabled", lambda: True)()
    if gil_enabled:
        return 1
    return max(1, os.cpu_count() or 1)


def _rebuild_executor(workers: int):
    global _rebuild_pool
    with _rebuild_pool_lock:
        if _rebuild_pool is None or _rebuild_pool._max_workers < workers:
            from concurrent.futures import ThreadPoolExecutor

            if _rebuild_pool is not None:
                # Widening: retire the narrower pool's threads instead
                # of leaking them for process lifetime.
                _rebuild_pool.shutdown(wait=False)
            _rebuild_pool = ThreadPoolExecutor(
                max_workers=workers, thread_name_prefix="kbt-tensorize"
            )
        return _rebuild_pool


def _parallel_chunks(n: int, fill, min_chunk: int) -> int:
    """Run ``fill(start, end)`` over [0, n) in parallel chunks; returns
    the chunk count. ``fill`` must write only its own [start, end) rows
    of any shared output. Serial when the pool would not pay off."""
    workers = _tensorize_workers()
    if workers <= 1 or n < 2 * min_chunk:
        fill(0, n)
        return 1
    parts = min(workers, max(2, n // min_chunk))
    ex = _rebuild_executor(workers)
    chunk = -(-n // parts)
    futs = [
        ex.submit(fill, s, min(s + chunk, n)) for s in range(0, n, chunk)
    ]
    for f in futs:
        f.result()
    return len(futs)


class _TensorizeCache:
    """Cross-cycle columnar state, stored on the scheduler cache object.

    The COW snapshot pool (cache/cache.py) hands consecutive sessions
    the SAME JobInfo/NodeInfo clone objects while nothing changed, and
    every mutator bumps ``_ver`` — so ``(identity, _ver)`` is an exact
    cheap fingerprint of "this object's tensor rows are still valid".
    Holding the object references here also pins their ids, so a
    recycled id can never alias a dead fingerprint. The cache lives on
    the SchedulerCache (``_tensorize_cache`` attribute), giving it
    exactly the lifetime of the mirror it shadows."""

    __slots__ = (
        "job_scalars",   # {job uid: (job, _ver, frozenset(scalar names))}
        "layout_sig",    # tuple(layout.scalars) the node arrays were built for
        "node_objs",     # [NodeInfo] in row order (pins identities)
        "node_ids",      # int64[N] id() per row (identities pinned above)
        "node_vers",     # int64[N] node._ver at build/patch time
        "idle", "releasing", "cap",  # float64 [N, R]
        "count", "maxt",             # int32 [N]
        # Node-side scalar-resource names, maintained as a per-row
        # frozenset list + a multiset so dirty rows adjust it in O(row):
        # the resource-layout scan no longer walks every node.
        "node_scal_sets", "node_scal_counter", "node_scal_names",
    )

    def __init__(self):
        self.job_scalars = {}
        self.layout_sig = None
        self.node_objs = None
        self.node_ids = None
        self.node_vers = None
        self.idle = self.releasing = self.cap = None
        self.count = self.maxt = None
        self.node_scal_sets = None
        self.node_scal_counter = None
        self.node_scal_names = frozenset()


class _NodeScan:
    """One per-tensorize pass over the session's nodes: the ready row
    list, its identity/version arrays, and the dirty-row positions
    against the tensorize cache's baseline — shared by the node-array
    refresh, the resource-layout scan, and (via ``ssn._kbt_node_scan``)
    the predicates plugin's column cache, which all paid their own
    O(N) attribute scans per cycle before."""

    __slots__ = ("nodes", "ids", "vers", "dirty", "matched")

    def __init__(self, nodes, ids, vers, dirty, matched):
        self.nodes = nodes      # [NodeInfo] ready rows
        self.ids = ids          # int64[N]
        self.vers = vers        # int64[N]
        # Row positions whose (identity, _ver) moved vs the tc baseline
        # (None when the baseline is unusable: cold/set-change).
        self.dirty = dirty
        self.matched = matched  # baseline comparable (row count equal)


def _build_node_scan(ssn, tc) -> _NodeScan:
    """Build the shared node scan. Ready-phase filtering is applied
    only to rows whose fingerprint moved: a row bit-identical to the
    baseline was ready last cycle and every phase transition bumps
    ``_ver`` (NodeInfo._set_node_state), so clean rows are ready by
    induction. Also maintains the tc's node scalar-name multiset for
    dirty rows (the layout scan consumes the aggregate)."""
    vals = list(ssn.nodes.values())
    n = len(vals)
    ids = np.fromiter(map(id, vals), np.int64, count=n)
    vers = np.fromiter((o._ver for o in vals), np.int64, count=n)
    baseline_ok = (
        tc is not None
        and tc.node_objs is not None
        and tc.node_ids is not None
        and len(tc.node_objs) == n
    )
    if baseline_ok:
        mism = (ids != tc.node_ids) | (vers != tc.node_vers)
        dirty = np.nonzero(mism)[0].tolist()
        ready = NodePhase.READY
        if all(vals[j].state.phase == ready for j in dirty):
            _maintain_node_scalars(tc, vals, dirty)
            return _NodeScan(vals, ids, vers, dirty, True)
    # Cold / set-change / a dirty row went not-ready: full filter, no
    # usable baseline (the refresh takes its full-rebuild path).
    nodes = _ready_nodes(ssn)
    if len(nodes) != n:
        n = len(nodes)
        ids = np.fromiter(map(id, nodes), np.int64, count=n)
        vers = np.fromiter((o._ver for o in nodes), np.int64, count=n)
    else:
        nodes = vals
    if tc is not None:
        _rebuild_node_scalars(tc, nodes)
    return _NodeScan(nodes, ids, vers, None, False)


def _row_scalar_set(node) -> frozenset:
    sr = node.allocatable.scalar_resources
    return frozenset(sr) if sr else frozenset()


def _rebuild_node_scalars(tc, nodes) -> None:
    from collections import Counter

    sets = [_row_scalar_set(n) for n in nodes]
    counter: Counter = Counter()
    for s in sets:
        counter.update(s)
    tc.node_scal_sets = sets
    tc.node_scal_counter = counter
    tc.node_scal_names = frozenset(counter)


def _maintain_node_scalars(tc, nodes, dirty) -> None:
    if tc.node_scal_sets is None or len(tc.node_scal_sets) != len(nodes):
        _rebuild_node_scalars(tc, nodes)
        return
    if not dirty:
        return
    sets, counter = tc.node_scal_sets, tc.node_scal_counter
    changed = False
    for j in dirty:
        new = _row_scalar_set(nodes[j])
        old = sets[j]
        if new == old:
            continue
        changed = True
        sets[j] = new
        for name in old - new:
            counter[name] -= 1
            if counter[name] <= 0:
                del counter[name]
        counter.update(new - old)
    if changed:
        tc.node_scal_names = frozenset(counter)


def _tensor_cache_of(cache) -> Optional[_TensorizeCache]:
    if cache is None:
        return None
    tc = getattr(cache, "_tensorize_cache", None)
    if tc is None:
        tc = _TensorizeCache()
        try:
            cache._tensorize_cache = tc
        except Exception:  # slots-only stand-in cache: run uncached
            return None
    return tc


def _layout_for_session(
    ssn, tc: Optional[_TensorizeCache], scan: Optional[_NodeScan] = None
) -> ResourceLayout:
    """:meth:`ResourceLayout.for_session` with the per-job task scan
    memoized on the job fingerprint — steady-state cycles cost O(#jobs)
    instead of O(all tasks) — and the node-side scalar names maintained
    by the shared node scan (O(dirty rows) instead of every node, every
    cycle). Scan semantics are identical (all jobs of the session,
    every task's resreq + init_resreq, all node allocatables)."""
    if tc is None:
        return ResourceLayout.for_session(ssn)
    names: set = set()
    if scan is not None and tc.node_scal_sets is not None:
        names.update(tc.node_scal_names)
    else:
        for node in ssn.nodes.values():
            sr = node.allocatable.scalar_resources
            if sr:
                names.update(sr)
    cached = tc.job_scalars
    narrow = getattr(ssn, "dirty_jobs_narrow", frozenset())
    fresh: Dict[str, tuple] = {}
    stale: List[tuple] = []
    for key, job in ssn.jobs.items():
        ent = cached.get(key)
        if ent is None or ent[0] is not job or ent[1] != job._ver:
            # NARROW job churn (the scheduler's own bind bookkeeping):
            # a status move never changes any task's resreq/init_resreq
            # scalar names, so the cached name set is carried forward
            # under a refreshed fingerprint instead of rescanning every
            # task of a freshly re-cloned but scalar-identical job.
            if ent is not None and key in narrow:
                ent = (job, job._ver, ent[2])
                fresh[key] = ent
                names |= ent[2]
                continue
            fresh[key] = None  # placeholder keeps insertion order
            stale.append((key, job))
        else:
            fresh[key] = ent
            names |= ent[2]
    if stale:
        # Cold/bursty path: rescan stale jobs in parallel chunks. Each
        # chunk writes only its own pre-inserted keys of ``fresh``.
        def scan(start, end):
            for key, job in stale[start:end]:
                s: set = set()
                for task in job.tasks.values():
                    sr = task.resreq.scalar_resources
                    if sr:
                        s.update(sr)
                    sr = task.init_resreq.scalar_resources
                    if sr:
                        s.update(sr)
                fresh[key] = (job, job._ver, frozenset(s))

        _parallel_chunks(len(stale), scan, _PAR_MIN_JOBS)
        for key, _job in stale:
            names |= fresh[key][2]
    tc.job_scalars = fresh
    return ResourceLayout(sorted(names))


def _fill_node_row(row: np.ndarray, r: Resource, scalars: List[str]) -> None:
    row[0] = r.milli_cpu
    row[1] = r.memory / MIB
    sr = r.scalar_resources
    for k, name in enumerate(scalars):
        row[2 + k] = sr.get(name, 0.0) if sr else 0.0


def _refresh_node_arrays(nodes, layout: ResourceLayout, tc,
                         narrow_names=frozenset(), scan=None):
    """Columnar node state (float64 idle/releasing/cap + int32 counts),
    patched incrementally against the fingerprint cache. Falls back to a
    full vectorized rebuild on layout change, node-set change, or a cold
    cache. Dirty rows are patched with the same VECTORIZED column fills
    the full rebuild uses (scatter on the gathered dirty subset), so a
    placement wave dirtying every node costs the same as a rebuild of
    those rows — there is no bulk-dirty cliff anymore. Rows whose name
    is in ``narrow_names`` (the cache's allocation-only ledger) patch
    only the columns an allocation can move — idle and the task count —
    skipping the releasing/capacity/max-task fills entirely; the count
    of such rows is returned for the wave-patch metric. Returns
    ``(idle, releasing, cap, count, maxt, dirty_rows, full_reason,
    wave_patched)``; the arrays are the CACHE's own — callers must copy
    before exposing them beyond the current cycle."""
    N = len(nodes)
    sig = tuple(layout.scalars)
    full_reason = None
    if tc is None:
        full_reason = "uncached"
    elif tc.node_objs is None:
        full_reason = "cold"
    elif tc.layout_sig != sig:
        full_reason = "layout-change"
    elif len(tc.node_objs) != N:
        full_reason = "node-set-change"
    dirty_idx: List[int] = []
    if full_reason is None:
        if scan is not None and scan.matched and scan.nodes is nodes:
            # The shared scan already diffed (identity, _ver) arrays
            # against this cache's baseline.
            dirty_idx = scan.dirty
        else:
            objs, vers = tc.node_objs, tc.node_vers
            if tc.node_ids is None:
                full_reason = "cold"
            elif objs == nodes:
                ver_arr = np.fromiter(
                    (n._ver for n in nodes), np.int64, count=N
                )
                dirty_idx = np.nonzero(ver_arr != vers)[0].tolist()
            else:
                id_arr = np.fromiter(map(id, nodes), np.int64, count=N)
                ver_arr = np.fromiter(
                    (n._ver for n in nodes), np.int64, count=N
                )
                dirty_idx = np.nonzero(
                    (id_arr != tc.node_ids) | (ver_arr != vers)
                )[0].tolist()
    wave_patched = 0
    if full_reason is not None:
        # Full vectorized rebuild, chunked across the rebuild pool on
        # big clusters (each chunk fills only its own rows).
        R = layout.dims
        idle = np.zeros((N, R), dtype=np.float64)
        releasing = np.zeros((N, R), dtype=np.float64)
        cap = np.zeros((N, R), dtype=np.float64)
        count = np.zeros(N, dtype=np.int32)
        maxt = np.zeros(N, dtype=np.int32)

        def fill(start, end):
            chunk = nodes[start:end]
            idle[start:end] = _resource_matrix(
                [n.idle for n in chunk], layout
            )
            releasing[start:end] = _resource_matrix(
                [n.releasing for n in chunk], layout
            )
            cap[start:end] = _resource_matrix(
                [n.allocatable for n in chunk], layout
            )
            count[start:end] = [len(n.tasks) for n in chunk]
            maxt[start:end] = [
                n.allocatable.max_task_num for n in chunk
            ]

        _parallel_chunks(N, fill, _PAR_MIN_NODES)
        dirty = N
    else:
        idle, releasing, cap = tc.idle, tc.releasing, tc.cap
        count, maxt = tc.count, tc.maxt
        if dirty_idx:
            if narrow_names:
                wave_idx = [
                    j for j in dirty_idx
                    if nodes[j].name in narrow_names
                ]
            else:
                wave_idx = []
            wave_patched = len(wave_idx)
            if wave_patched != len(dirty_idx):
                full_idx = (
                    [j for j in dirty_idx
                     if nodes[j].name not in narrow_names]
                    if wave_idx else dirty_idx
                )
            else:
                full_idx = []
            if wave_idx:
                # Allocation-only rows: one gathered column fill for
                # idle + the task count; releasing/cap/max-task are
                # untouched by a bind, by the narrow-ledger contract
                # (cache/event_handlers._stamp_dirty_alloc).
                wnodes = [nodes[j] for j in wave_idx]
                idle[wave_idx] = _resource_matrix(
                    [n.idle for n in wnodes], layout
                )
                count[wave_idx] = [len(n.tasks) for n in wnodes]
            if full_idx:
                fnodes = [nodes[j] for j in full_idx]
                idle[full_idx] = _resource_matrix(
                    [n.idle for n in fnodes], layout
                )
                releasing[full_idx] = _resource_matrix(
                    [n.releasing for n in fnodes], layout
                )
                cap[full_idx] = _resource_matrix(
                    [n.allocatable for n in fnodes], layout
                )
                count[full_idx] = [len(n.tasks) for n in fnodes]
                maxt[full_idx] = [
                    n.allocatable.max_task_num for n in fnodes
                ]
        dirty = len(dirty_idx)
    if tc is not None and (full_reason is not None or dirty):
        tc.layout_sig = sig
        tc.node_objs = list(nodes)
        if scan is not None and scan.nodes is nodes:
            tc.node_ids, tc.node_vers = scan.ids, scan.vers
        else:
            tc.node_ids = np.fromiter(map(id, nodes), np.int64, count=N)
            tc.node_vers = np.fromiter(
                (n._ver for n in nodes), np.int64, count=N
            )
        tc.idle, tc.releasing, tc.cap = idle, releasing, cap
        tc.count, tc.maxt = count, maxt
    return idle, releasing, cap, count, maxt, dirty, full_reason, wave_patched


def _ready_nodes(ssn) -> List[NodeInfo]:
    # Inlined NodeInfo.ready(): a method call per node is measurable on
    # a 5k-node cluster walked every cycle.
    ready = NodePhase.READY
    return [n for n in ssn.nodes.values() if n.state.phase == ready]


def _store_refresh_stats(ssn, n_nodes: int, refreshed) -> None:
    dirty_rows, full_reason, wave_patched = (
        refreshed[5], refreshed[6], refreshed[7]
    )
    last_tensorize_stats.update(
        incremental=full_reason is None,
        dirty_nodes=dirty_rows,
        nodes=n_nodes,
        # Rows patched through the allocation-only (wave) path.
        wave_patched=wave_patched,
        # What the cache's own churn ledger expected (names touched
        # since the previous snapshot) — row-level truth is the clone
        # fingerprints, but divergence here flags session-side churn.
        cache_dirty_nodes=len(getattr(ssn, "dirty_nodes", ())),
        cache_dirty_jobs=len(getattr(ssn, "dirty_jobs", ())),
        cache_narrow_nodes=len(getattr(ssn, "dirty_nodes_narrow", ())),
        cache_narrow_jobs=len(getattr(ssn, "dirty_jobs_narrow", ())),
    )
    if full_reason is not None:
        last_tensorize_stats["full_reason"] = full_reason
    # The refresh consumed this session's full-dirty names: clear them
    # from the cache's backlog (they stop being reported full-dirty).
    note = getattr(ssn.cache, "note_full_absorbed", None)
    if note is not None:
        note(
            getattr(ssn, "dirty_jobs", ()) or (),
            getattr(ssn, "dirty_nodes", ()) or (),
        )
    try:
        from .. import metrics

        metrics.update_tensorize_cycle(
            full_reason is None, dirty_rows, full_reason,
            wave_patched=wave_patched,
        )
    except Exception:  # pragma: no cover - metrics must never kill
        logger.exception("tensorize metrics export failed")


def _absorb_dirty(ssn) -> None:
    """Cache-maintenance half of a cycle that solves nothing (idle, or
    a warm no-op): patch the node arrays and predicate columns against
    the churn ledger so the NEXT real solve starts from a clean cache.
    A truly quiet cycle (empty ledger, narrow included) is a no-op."""
    if not (
        getattr(ssn, "dirty_nodes", None)
        or getattr(ssn, "dirty_jobs", None)
        or getattr(ssn, "dirty_nodes_narrow", None)
        or getattr(ssn, "dirty_jobs_narrow", None)
    ):
        return
    tc = _tensor_cache_of(ssn.cache)
    if tc is None:
        return
    scan = _build_node_scan(ssn, tc)
    nodes = scan.nodes
    if not nodes:
        return
    ssn._kbt_node_scan = scan
    layout = _layout_for_session(ssn, tc, scan)
    refreshed = _refresh_node_arrays(
        nodes, layout, tc,
        narrow_names=getattr(ssn, "dirty_nodes_narrow", frozenset()),
        scan=scan,
    )
    _store_refresh_stats(ssn, len(nodes), refreshed)
    for _name, fn in ssn.batch_predicates():
        try:
            fn([], nodes)
        except Exception:
            logger.exception(
                "batch predicate %s failed on idle warm-up", _name,
            )


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def _task_bucket(n: int) -> int:
    """Shape bucket for the task axis: fine-grained below 4096, multiples
    of 2048 above — bounds distinct jit compilations as cluster load
    fluctuates cycle to cycle while wasting <6% padding at 50k."""
    return _round_up(n, 256) if n <= 4096 else _round_up(n, 2048)


def _pow2(n: int) -> int:
    if n <= 0:
        return 0
    return 1 << (n - 1).bit_length()


def tensorize(
    ssn,
    include_jobs: Optional[List[JobInfo]] = None,
    pad=True,
    device=True,
    warm_noop=False,
    rank_pool: Optional[List[JobInfo]] = None,
):
    """Build `(inputs, SnapshotContext)` for the session's pending,
    non-best-effort tasks, or ``(None, None)`` if there is nothing to solve.

    ``include_jobs`` restricts the task set (used by tests and by actions
    that solve for a subset). ``rank_pool`` (warm SUBSET bundles,
    solver/warm.py) additionally names the FULL pending job pool the
    ordering pipeline runs over: queue ranks, job order, progressive-
    filling keys, and the final lexsort are computed across every pool
    task — cheap host numpy, O(pool) — and only ``include_jobs``' rows
    are sliced into the solver tensors, each carrying its GLOBAL rank in
    ``task_rank``. The solver's bid-key tie hashes consume that rank
    (kernels.bid_keys ``task_ids``), so the subset's bid order is the
    full problem's restricted to those rows, bit for bit. With ``pad``
    (default), array shapes are
    rounded up to buckets (padded tasks/nodes are marked invalid) so a
    long-running scheduler re-jits only when the cluster crosses a bucket
    boundary, not on every snapshot.

    With ``device`` (default True), ``inputs`` is a :class:`PackedInputs`
    of stacked torch buffers, resident on the scheduler cache's device
    cache (``device_cache.device_cache_of``), valid until the next pack
    on the same scheduler cache. ``device`` may name the device (``"cuda"``,
    ``"cpu"`` or a ``torch.device``): the device cache is created there
    on first use, and naming another device than the cache's raises.
    ``True`` takes the cache's device (``cuda`` for a new cache). With
    ``device=False`` the pack is skipped and ``inputs`` is the
    NumPy-backed :class:`SolverInputs` (also always available as
    ``ctx.host_inputs``).

    ``warm_noop`` (solver/warm.py): the warm plan proved every pending
    task keeps last cycle's verdict, so only the cycle's cache
    maintenance runs — node-array/predicate-column patching against the
    ledger — and ``(None, None)`` is returned without touching the task
    side.

    INCREMENTAL: the node-side columnar arrays and the resource layout's
    per-job scalar scan live across cycles in a fingerprint-keyed cache
    on ``ssn.cache`` (:class:`_TensorizeCache`), so a cycle pays only
    for rows whose objects actually changed — the delta-burst tensorize
    cost scales with churn, not cluster size. Any layout change
    (resource-dim growth/shrink) or node-set change falls back to the
    full vectorized rebuild; either path produces bit-identical arrays
    (pinned by the churn parity tests). ``last_tensorize_stats`` records
    which path ran and how many rows were dirty."""
    from .kernels import SolverInputs
    from .masks import combine_masks, combine_score_rows

    last_tensorize_stats.clear()
    if warm_noop:
        _absorb_dirty(ssn)
        last_tensorize_stats["warm_noop"] = True
        return None, None
    if rank_pool is not None:
        job_pool = rank_pool
    elif include_jobs is not None:
        job_pool = include_jobs
    else:
        job_pool = ssn.jobs.values()
    subset_mode = rank_pool is not None and include_jobs is not None

    # --- ordered task list: queue rank → job rank → task rank -------------
    # Only jobs with at least one PENDING task participate: a fully
    # placed job contributes no solver rows, and at steady state placed
    # jobs are the overwhelming majority — keeping them would pay the
    # job-order sort for nothing. Queue ranks/budgets are unaffected: a
    # queue with zero pending tasks constrains nobody this solve.
    jobs_by_queue: Dict[str, List[JobInfo]] = {}
    for job in job_pool:
        if job.queue not in ssn.queues:
            continue
        if not job.task_status_index.get(TaskStatus.PENDING):
            continue
        jobs_by_queue.setdefault(job.queue, []).append(job)

    if not jobs_by_queue:
        # Idle cycle. When the cache's churn ledger says the mirror
        # moved since the last snapshot, absorb the dirtiness NOW — in
        # think-time — so a later burst starts from a clean cache
        # instead of paying the whole patch backlog in its own budget
        # (the warm predicate call with an empty batch refreshes that
        # plugin's node columns the same way). A truly idle cycle (empty
        # ledger) costs only the pending scan above.
        _absorb_dirty(ssn)
        return None, None

    tc = _tensor_cache_of(ssn.cache)
    scan = _build_node_scan(ssn, tc) if tc is not None else None
    nodes = scan.nodes if scan is not None else _ready_nodes(ssn)
    if not nodes:
        return None, None
    # Hand the scan to the batch predicates (same (identity, _ver)
    # diff, their own baseline) — they receive this exact node list.
    ssn._kbt_node_scan = scan
    layout = _layout_for_session(ssn, tc, scan)
    refreshed = _refresh_node_arrays(
        nodes, layout, tc,
        narrow_names=getattr(ssn, "dirty_nodes_narrow", frozenset()),
        scan=scan,
    )
    (node_idle64, node_rel64, node_cap64, node_count, node_maxt,
     _dirty_rows, _full_reason, _wave_patched) = refreshed
    _store_refresh_stats(ssn, len(nodes), refreshed)

    # Order only queues that HAVE jobs — the greedy loop discovers
    # queues from jobs (allocate.go:67-99), so plugin queue-order
    # state (e.g. proportion's queue_attrs, built per job-bearing
    # queue) may not cover an idle queue; comparing one would KeyError
    # (seen live: a tenant queue created ahead of its first jobs
    # crashed every allocate_tpu cycle until the jobs arrived).
    queues = [
        q for q in ssn.queues.values() if q.uid in jobs_by_queue
    ]
    queue_order = _sorted_by(queues, ssn.queue_order_fn)
    queue_index = {q.uid: i for i, q in enumerate(queue_order)}

    # Per-queue task sequences (jobs by job_order_fn, tasks by
    # task_order_fn). Jobs are few (comparison sort is fine); tasks are
    # many, so when every enabled task-order plugin provides a batch key
    # (batch_task_order_keys) all jobs' pending tasks are ordered with ONE
    # numpy lexsort — per-job blocks stay intact via the block id key, and
    # the (creation_timestamp, uid) tiebreak matches task_order_fn.
    pending_all: List[TaskInfo] = []
    pending_block: List[int] = []
    block_bounds: List[Tuple[str, int, int]] = []  # (queue uid, start, end)
    for q in queue_order:
        for job in _order_jobs(ssn, jobs_by_queue.get(q.uid, [])):
            pending = [
                t
                for t in job.task_status_index.get(
                    TaskStatus.PENDING, {}
                ).values()
                if not t.resreq.is_empty()
                # BestEffort: allocate skips (allocate.go:103-117)
            ]
            start = len(pending_all)
            pending_all.extend(pending)
            pending_block.extend([len(block_bounds)] * len(pending))
            block_bounds.append((q.uid, start, len(pending_all)))

    queue_sequences: Dict[str, List[TaskInfo]] = {
        q.uid: [] for q in queue_order
    }
    batch_keys = (
        ssn.batch_task_order_keys(pending_all) if pending_all else []
    )
    if batch_keys is None:
        for quid, start, end in block_bounds:
            queue_sequences[quid].extend(
                _sorted_by(pending_all[start:end], ssn.task_order_fn)
            )
    else:
        uids = np.asarray([t.uid or "" for t in pending_all])
        ts = np.asarray(
            [t.pod.metadata.creation_timestamp for t in pending_all],
            np.float64,
        )
        order = np.lexsort(
            tuple([uids, ts])
            + tuple(reversed(batch_keys))
            + (np.asarray(pending_block, np.int64),)
        )
        # Block id is the primary key, so the result is grouped by job;
        # one pass distributes tasks to their queue sequence in order.
        for idx in order:
            quid = block_bounds[pending_block[idx]][0]
            queue_sequences[quid].append(pending_all[idx])

    # Global priority ranks via PROGRESSIVE FILLING: the greedy loop pops
    # the lowest-share queue each turn (queue PQ re-pushed per iteration,
    # allocate.go:67,191, with proportion's share-based QueueOrderFn).
    # Ordering every task by the share its queue reaches AFTER its own
    # allocation reproduces that interleave statically: shares grow
    # monotonically within a queue, so sorting by (share-after, queue rank,
    # in-queue position) yields exactly the sequence the dynamic
    # round-robin would visit when all tasks fit.
    # Evaluate queue budgets once (first plugin with an opinion wins);
    # reused for both the progressive-filling ranks and the budget tensors.
    queue_budgets: Dict[str, Tuple[Resource, Resource]] = {}
    for q in queue_order:
        for fn in ssn.queue_budget_fns.values():
            budget = fn(q)
            if budget is not None:
                queue_budgets[q.uid] = budget
                break

    # Flatten tasks in (queue-rank, in-queue) order, columnar from here on.
    flat_tasks: List[TaskInfo] = []
    flat_qi: List[int] = []
    flat_pos: List[int] = []
    queue_blocks: List[Tuple[str, int, int]] = []  # (uid, start, end)
    for q in queue_order:
        seq = queue_sequences[q.uid]
        start = len(flat_tasks)
        flat_tasks.extend(seq)
        flat_qi.extend([queue_index[q.uid]] * len(seq))
        flat_pos.extend(range(len(seq)))
        queue_blocks.append((q.uid, start, len(flat_tasks)))
    if not flat_tasks:
        return None, None

    T, N, R = len(flat_tasks), len(nodes), layout.dims
    req_mat = _resource_matrix([t.resreq for t in flat_tasks], layout)
    fit_mat = _resource_matrix([t.init_resreq for t in flat_tasks], layout)

    # Progressive-filling keys, vectorized per queue: cumulative share the
    # queue reaches after each of its tasks (see module docstring).
    keys = np.zeros(T, dtype=np.float64)
    for uid, start, end in queue_blocks:
        budget = queue_budgets.get(uid)
        if budget is None or start == end:
            continue
        deserved, allocated = budget
        d_vec = _resource_matrix([deserved], layout)[0]
        a_vec = _resource_matrix([allocated], layout)[0]
        dims = [0, 1] + [
            2 + k
            for k, name in enumerate(layout.scalars)
            if name in (deserved.scalar_resources or {})
        ]
        cum = a_vec[dims] + np.cumsum(req_mat[start:end, dims], axis=0)
        d = d_vec[dims]
        with np.errstate(divide="ignore", invalid="ignore"):
            shares = np.where(d == 0, (cum > 0).astype(np.float64), cum / d)
        keys[start:end] = shares.max(axis=1)

    order = np.lexsort(
        (np.asarray(flat_pos), np.asarray(flat_qi), keys)
    )
    rank_total = T
    if subset_mode:
        # SUBSET bundle: the ordering above ran over the full pool, so
        # each kept row keeps its GLOBAL position as its rank; only the
        # kept rows pay predicates/scores/selection/solve.
        sub_uids = {j.uid for j in include_jobs}
        keep = np.fromiter(
            (flat_tasks[i].job in sub_uids for i in order), bool, count=T
        )
        gpos = np.nonzero(keep)[0].astype(np.int32)
        order = order[keep]
        T = int(len(order))
        last_tensorize_stats["subset"] = {
            "pool_tasks": rank_total,
            "subset_tasks": T,
            "subset_jobs": len(sub_uids),
        }
        if T == 0:
            return None, None
        task_rank = gpos
    else:
        task_rank = np.arange(T, dtype=np.int32)
    tasks = [flat_tasks[i] for i in order]
    task_req = req_mat[order].astype(np.float32)
    task_fit = fit_mat[order].astype(np.float32)
    task_queue = np.asarray(flat_qi, np.int32)[order]
    # Dense job segment ids in first-occurrence order: the kernel only
    # needs task_job as a per-job segment id < T (segment_min grouping),
    # so a dict factorization replaces the 50k-string np.unique sort
    # (~30 ms of the cold snapshot at 50k).
    job_ids: Dict[str, int] = {}
    task_job = np.fromiter(
        (
            job_ids.setdefault(t.job or "", len(job_ids))
            for t in tasks
        ),
        np.int32,
        count=T,
    )

    # Node-side columns come from the cross-cycle cache refreshed above.
    # Every handed-out array is a fresh copy (astype/copy): the cache
    # patches its own arrays in place next cycle, and callers (bench,
    # parity tests) may hold ctx/inputs across cycles.
    node_idle = node_idle64.astype(np.float32)
    node_releasing = node_rel64.astype(np.float32)
    node_cap = node_cap64.astype(np.float32)
    node_task_count = node_count.copy()
    node_max_tasks = node_maxt.copy()

    # --- predicates → factorized mask (tier-gated like predicate_fn) ------
    from ..obs import span as _span

    with _span("predicate_mask"):
        mask_parts = [
            fn(tasks, nodes) for name, fn in ssn.batch_predicates()
        ]
    # Scalar-only predicate plugins (no batched form) fall back to the
    # per-pair path so correctness never depends on a plugin being ported.
    scalar_only = ssn.scalar_only_predicates()
    if scalar_only:
        dense = np.ones((T, N), dtype=bool)
        for name, fn in scalar_only:
            for i, task in enumerate(tasks):
                for j, node in enumerate(nodes):
                    if not dense[i, j]:
                        continue
                    try:
                        fn(task, node)
                    except Exception:
                        dense[i, j] = False
        mask_parts.append(dense)
    mask = combine_masks(mask_parts, T, N)

    # --- static scores → sparse rows (tier-gated like node_prioritizers) --
    score_rows_map = combine_score_rows(
        [(fn(tasks, nodes), weight)
         for fn, weight in ssn.batch_node_prioritizers()],
        T, N,
    )
    # Tie-breaking happens in-kernel via hashed integer bid keys
    # (kernels.bid_keys); nothing to materialize host-side.

    weights = ssn.solver_dynamic_weights()
    lr_w = float(weights.get("leastrequested", 0.0))
    br_w = float(weights.get("balancedresource", 0.0))

    # --- shape buckets + padded node stacks --------------------------------
    Tp = _task_bucket(T) if pad else T
    Np = _round_up(N, 128) if pad else N

    def pad_rows(a, rows, fill=0):
        if rows == a.shape[0]:
            return a
        out = np.full((rows,) + a.shape[1:], fill, dtype=a.dtype)
        out[: a.shape[0]] = a
        return out

    node_feas_p = pad_rows(mask.node_ok, Np, fill=False)
    # Pad both axes of the group rows: nodes to Np, and the group count
    # to a power of two (all-False rows no task references) so the
    # signature mix churning cycle-to-cycle does not re-jit the solver.
    group_feas = np.ascontiguousarray(
        pad_rows(mask.group_rows.T, Np, fill=False).T
    )
    Gp = max(1, _pow2(group_feas.shape[0])) if pad else group_feas.shape[0]
    group_feas = pad_rows(group_feas, Gp, fill=False)
    node_f32_stack = np.stack([
        pad_rows(node_idle, Np), pad_rows(node_releasing, Np),
        pad_rows(node_cap, Np),
    ])
    node_i32_stack = np.stack([
        pad_rows(node_task_count, Np), pad_rows(node_max_tasks, Np),
        node_feas_p.astype(np.int32),
    ])

    # --- top-K candidate selection (solver/topk.py) -----------------------
    # Phase 1 of the sparse solve: dedup tasks into candidate classes
    # and keep each class's top-K nodes by the fused feasibility +
    # initial-idle score pass. Runs against the UNPADDED node arrays
    # (host path) or the padded resident stacks (device path); the
    # slabs are padded/bucketed below with everything else.
    from .topk import select_candidates, topk_config

    tk = topk_config(T, N)
    cand_sel = None
    sparse_reason = tk.reason
    device_state = None
    named = None if device is True else device
    if device and tk.enabled:
        from .device_cache import device_cache_of
        from .select_device import SelectionDeviceState, device_select_enabled
        from .sharding import packed_sparse_placement

        dc0 = device_cache_of(ssn.cache, named)
        if (
            dc0 is not None
            and device_select_enabled()
            and not bool(node_rel64.any())
        ):
            try:
                placement0, token0 = packed_sparse_placement(Tp, dc0.device)
                placed = dc0.pack_partial(
                    {
                        "node_f32": node_f32_stack,
                        "node_i32": node_i32_stack,
                        "group_feas": group_feas,
                    },
                    placement=placement0, layout_token=token0,
                )
                device_state = SelectionDeviceState(
                    ssn.cache, placed["node_f32"], placed["node_i32"],
                    placed["group_feas"], Np, token0,
                )
            except Exception:
                # Labelled, never quiet: select_path reads
                # host:device-unavailable for this cycle.
                logger.exception("device-selection pre-pack failed")
                device_state = SelectionDeviceState(
                    ssn.cache, None, None, None, Np
                )
    if tk.enabled:
        with _span("topk_select", k=tk.k):
            cand_sel = select_candidates(
                mask, score_rows_map, task_req, task_fit,
                node_idle, node_cap, node_releasing,
                node_task_count, node_max_tasks,
                layout.eps(), lr_w, br_w, tk.k,
                cache_holder=ssn.cache,
                node_fp=(
                    (scan.ids, scan.vers, scan.nodes)
                    if scan is not None and scan.nodes is nodes
                    else None
                ),
                device_state=device_state,
            )
        if cand_sel is None:
            sparse_reason = "class-budget"
    sparse_stats = {
        "enabled": cand_sel is not None,
        "k": tk.k,
        "reason": sparse_reason,
    }
    if cand_sel is not None:
        sparse_stats.update(cand_sel.stats)
    last_tensorize_stats["sparse"] = sparse_stats

    # --- queue budget vectors ---------------------------------------------
    Qn = max(1, len(queue_order))
    queue_deserved = np.full((Qn, R), np.inf, dtype=np.float32)
    queue_allocated = np.zeros((Qn, R), dtype=np.float32)
    for q in queue_order:
        budget = queue_budgets.get(q.uid)
        if budget is None:
            continue
        deserved, allocated = budget
        queue_deserved[queue_index[q.uid]] = layout.vec(deserved)
        queue_allocated[queue_index[q.uid]] = layout.vec(allocated)

    # --- padding to shape buckets (Tp/Np/pad_rows hoisted above) ----------
    task_valid = np.zeros(Tp, dtype=bool)
    task_valid[:T] = True

    task_req = pad_rows(task_req, Tp)
    task_fit = pad_rows(task_fit, Tp)
    if subset_mode:
        # Padded rows take unique ranks past the pool so they can never
        # collide with a real global rank in tie hashes or job breaks.
        task_rank = np.concatenate(
            [task_rank, rank_total + np.arange(Tp - T, dtype=np.int32)]
        )
    else:
        task_rank = np.arange(Tp, dtype=np.int32)
    task_queue = pad_rows(task_queue, Tp)
    # Padded tasks get unique job ids so they never interact with
    # job_blocked segment reductions.
    task_job = np.concatenate(
        [task_job, np.arange(T, Tp, dtype=np.int32)]
    )
    task_group = pad_rows(mask.task_group, Tp)
    # Padded node tables were built above; host_inputs holds views of
    # the stacks.
    node_feas = node_feas_p
    node_idle = node_f32_stack[0]
    node_releasing = node_f32_stack[1]
    node_cap = node_f32_stack[2]
    node_task_count = node_i32_stack[0]
    node_max_tasks = node_i32_stack[1]

    P = len(mask.pair_idx)
    Pp = _pow2(P) if pad else P
    pair_idx = np.full(Pp, Tp, dtype=np.int32)  # Tp = scatter-discard row
    pair_idx[:P] = mask.pair_idx
    pair_feas = np.ones((Pp, Np), dtype=bool)
    pair_feas[:P, :N] = mask.pair_rows
    pair_feas[:, N:] = False

    S = len(score_rows_map)
    Sp = _pow2(S) if pad else S
    score_idx = np.full(Sp, Tp, dtype=np.int32)
    score_rows = np.zeros((Sp, Np), dtype=np.float32)
    for k, i in enumerate(sorted(score_rows_map)):
        score_idx[k] = i
        score_rows[k, :N] = score_rows_map[i]

    # Candidate slabs: class axis pow2-bucketed like pair/score rows;
    # the invalid-node sentinel moves from N (selection-time) to the
    # PADDED node count so the kernel's single `cand < N` check covers
    # selection padding, class padding, and node padding alike.
    if cand_sel is not None:
        task_cand = pad_rows(cand_sel.task_cand, Tp)
        cand_idx = cand_sel.cand_idx
        cand_idx[cand_idx >= N] = Np
        Cn = cand_idx.shape[0]
        Cp = _pow2(Cn) if pad else Cn
        cand_idx = pad_rows(cand_idx, Cp, fill=Np)
        cand_static = pad_rows(cand_sel.cand_static, Cp)
        cand_info = np.zeros((3, Cp), dtype=np.int32)
        cand_info[:, :Cn] = cand_sel.cand_info
    else:
        task_cand = np.zeros(Tp, dtype=np.int32)
        cand_idx = np.zeros((0, 1), dtype=np.int32)
        cand_static = np.zeros((0, 1), dtype=np.float32)
        cand_info = np.zeros((3, 0), dtype=np.int32)

    # NumPy-backed SolverInputs: the source arrays for the device pack
    # below (and the bundle itself with ``device=False``).
    host_inputs = SolverInputs(
        task_req=task_req,
        task_fit=task_fit,
        task_rank=task_rank,
        task_job=task_job,
        task_queue=task_queue,
        task_valid=task_valid,
        task_group=task_group,
        node_feas=node_feas,
        group_feas=group_feas,
        pair_idx=pair_idx,
        pair_feas=pair_feas,
        score_idx=score_idx,
        score_rows=score_rows,
        node_idle=node_idle,
        node_releasing=node_releasing,
        node_cap=node_cap,
        node_task_count=node_task_count,
        node_max_tasks=node_max_tasks,
        queue_deserved=queue_deserved,
        queue_allocated=queue_allocated,
        eps=layout.eps(),
        lr_weight=np.float32(lr_w),
        br_weight=np.float32(br_w),
        task_cand=task_cand,
        cand_idx=cand_idx,
        cand_static=cand_static,
        cand_info=cand_info,
    )
    if contracts_enabled():
        # KBT_CHECK_CONTRACTS=1: the host bundle against the declaration
        # table before anything downstream consumes it.
        validate_solver_inputs(host_inputs, where="tensorize")
    ctx = SnapshotContext(
        layout, tasks, nodes, queue_order, mask,
        task_fit_host=fit_mat[order], task_req_host=req_mat[order],
        node_idle_host=node_idle64.copy(),
        host_inputs=host_inputs,
        has_releasing=bool(node_rel64.any()),
        subset_jobs=(
            frozenset(j.uid for j in include_jobs) if subset_mode else None
        ),
        rank_total=rank_total,
    )
    if not device:
        return host_inputs, ctx

    # Pack: the stacked buffers go through the DEVICE-RESIDENT snapshot
    # cache (device_cache.py): unchanged fields reuse their resident
    # buffer (zero upload), small row deltas are patched in place, and
    # only cold/shape-changed/bulk-dirty fields pay a full upload.
    # device_cache.last_pack_stats records which.
    from .device_cache import device_cache_of
    from .sharding import packed_sparse_placement

    stacked = stack_inputs(host_inputs)
    dc = device_cache_of(ssn.cache, named)
    if dc is not None:
        # The token keys residency to the solver's layout (a mesh or
        # mode flip re-uploads everything, labeled mesh-change).
        placement, layout_token = packed_sparse_placement(
            Tp if cand_sel is not None else 0, dc.device
        )
        return dc.pack(
            stacked, placement=placement, layout_token=layout_token
        ), ctx
    return _to_device(stacked, resolve_device(named)), ctx


def _field(host, name):
    v = getattr(host, name, None)
    return None if v is None else np.asarray(v)


def stack_inputs(host) -> dict:
    """The stacked NumPy buffers of :class:`PackedInputs` from a host
    ``SolverInputs`` bundle, in tensorize's layout and dtypes."""
    f32, i32 = np.float32, np.int32
    T = _field(host, "task_req").shape[0]
    task_cand = _field(host, "task_cand")
    if task_cand is None:
        task_cand = np.zeros(T, i32)
    cand_idx = _field(host, "cand_idx")
    cand_static = _field(host, "cand_static")
    cand_info = _field(host, "cand_info")
    if cand_idx is None:
        cand_idx = np.zeros((0, 1), i32)
        cand_static = np.zeros((0, 1), f32)
        cand_info = np.zeros((3, 0), i32)
    g = lambda name, dt: np.asarray(_field(host, name), dt)  # noqa: E731
    return {
        "task_f32": np.stack([g("task_req", f32), g("task_fit", f32)]),
        "task_i32": np.stack([
            g("task_rank", i32), g("task_queue", i32), g("task_job", i32),
            g("task_group", i32), g("task_valid", bool).astype(i32),
            np.asarray(task_cand, i32),
        ]),
        "node_f32": np.stack([
            g("node_idle", f32), g("node_releasing", f32), g("node_cap", f32),
        ]),
        "node_i32": np.stack([
            g("node_task_count", i32), g("node_max_tasks", i32),
            g("node_feas", bool).astype(i32),
        ]),
        "group_feas": g("group_feas", bool),
        "pair_idx": g("pair_idx", i32),
        "pair_feas": g("pair_feas", bool),
        "score_idx": g("score_idx", i32),
        "score_rows": g("score_rows", f32),
        "queue_f32": np.stack([
            g("queue_deserved", f32), g("queue_allocated", f32),
        ]),
        "misc": np.concatenate([
            g("eps", f32), np.asarray([_field(host, "lr_weight"),
                                       _field(host, "br_weight")], f32),
        ]).astype(f32),
        "cand_idx": np.asarray(cand_idx, i32),
        "cand_static": np.asarray(cand_static, f32),
        "cand_info": np.asarray(cand_info, i32),
    }


def _to_device(stacked: dict, dev: torch.device):
    from .kernels import PackedInputs

    return PackedInputs(**{
        k: torch.from_numpy(np.ascontiguousarray(v)).to(dev, copy=True)
        for k, v in stacked.items()
    })


def pack_inputs(host_inputs, device=None):
    """Stack a host ``SolverInputs`` bundle and copy it to ``device``
    (``cuda`` unless the caller passes ``"cpu"``; raises when CUDA is
    absent and the CPU was not asked for). Uncached: every call ships
    every buffer."""
    dev = resolve_device(device)
    stacked = stack_inputs(host_inputs)
    validate_packed(stacked, where="pack_inputs")
    return _to_device(stacked, dev)
