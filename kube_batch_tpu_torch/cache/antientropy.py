"""Anti-entropy: periodic cluster-truth reconciliation of the mirror.

Fault containment covers solver faults and the failover work covers process
death, but the cache still TRUSTED its event stream: a lost, duplicated,
or reordered watch event silently corrupts every later warm solve. The
ingest guards (cache.py `_admit_event`) absorb what they can see; this
module is the backstop for what they cannot — divergence that already
happened. A periodic, budget-bounded sweep fingerprints the mirror
against cluster truth in hash buckets, classifies every divergence, and
repairs it through the ordinary event-handler entry points, so every
repair stamps the dirty ledger (warm-solve exactness) and the
mirror converges without a restart. The reference kube-batch leans on
informer relist for this; a production system needs the divergence
*detected, classified and counted*, not silently papered over.

Mechanics:

- Per object (accepted pods → the union of all mirror tasks; nodes), a
  **canonical state string** captures exactly the solver-relevant
  truth: identity, placement (node), status class, resource request —
  for nodes: allocatable + readiness. Both sides canonicalize through
  the SAME code path (truth pods via ``TaskInfo(pod)``), so equality is
  by construction when consistent.
- blake2b(canonical) digests are cached per object keyed on a cheap
  version witness (mirror: ``JobInfo._ver`` / ``NodeInfo._ver``; truth:
  the cluster's per-write ``resource_version``) — a steady-state sweep
  re-hashes only objects that actually changed.
- Digests XOR-fold into ``KBT_ANTIENTROPY_BUCKETS`` buckets keyed on a
  pure identity hash, so the detailed diff walks only mismatched
  buckets: O(changed buckets) steady-state.
- Mirror tasks whose status is scheduler-internal/in-flight (ALLOCATED,
  BINDING, RELEASING, PIPELINED — a side effect is on the wire) are
  EXEMPT on both sides: the journal/resync own them, and judging them
  against truth mid-flight would "repair" perfectly healthy binds.

Divergence kinds and repairs (all through stamping entry points):

| kind | meaning | repair |
|---|---|---|
| ``phantom-task``  | mirror task, no cluster pod | ``_sync_task`` → delete |
| ``missed-pod``    | unbound cluster pod the mirror never saw | ``add_pod`` |
| ``missed-bind``   | cluster pod bound, mirror thinks unbound/absent | ``add_pod`` / ``_sync_task`` |
| ``stale-task``    | both present, state differs | ``_sync_task`` → update |
| ``vanished-node`` | mirror node, no cluster node | ``delete_node`` |
| ``missed-node``   | cluster node the mirror never saw | ``add_node`` |
| ``stale-node``    | capacity/readiness drifted | ``update_node`` |

``full_reconcile()`` is the same engine with the cadence and repair
budget waived — it is the watch-gap relist the ingest guards trigger
through the ``drain_resync_queue`` seam (cache.py `_maybe_relist`).
"""

from __future__ import annotations

import hashlib
import logging
import os
from typing import Dict, List, Optional, Tuple

from ..api import TaskInfo
from ..api.types import TaskStatus
from ..cluster.errors import retry_transient
from ..utils.lockdebug import wrap_lock

logger = logging.getLogger(__name__)

# Mirror statuses with a side effect (or session decision) in flight:
# truth legitimately disagrees until it drains, so both sides skip
# these uids for the sweep.
_INFLIGHT = frozenset({
    TaskStatus.ALLOCATED, TaskStatus.BINDING,
    TaskStatus.RELEASING, TaskStatus.PIPELINED,
})

DIVERGENCE_KINDS = (
    "phantom-task", "missed-pod", "missed-bind", "stale-task",
    "vanished-node", "missed-node", "stale-node",
)


def _res_key(r) -> str:
    sr = r.scalar_resources
    scalars = (
        ",".join(f"{k}={sr[k]:.3f}" for k in sorted(sr)) if sr else ""
    )
    return f"{r.milli_cpu:.3f}/{r.memory:.1f}/{scalars}"


def _task_canonical(ti) -> Optional[str]:
    """Solver-relevant canonical state of one task/pod, or None when
    the task is outside the sweep's jurisdiction. Truth pods and
    mirror tasks both flow through this — equality by construction
    when consistent. Outside jurisdiction: in-flight statuses (a side
    effect is on the wire; the journal/resync own them) and TERMINATED
    ones — the job-cleanup queue legitimately forgets terminated jobs
    while their pods still exist in the cluster, and judging that
    asymmetry would make the sweep re-add what cleanup just removed,
    forever."""
    status = ti.status
    if status in _INFLIGHT:
        return None
    if status == TaskStatus.PENDING:
        cls, node = "p", ""
    elif status in (
        TaskStatus.SUCCEEDED, TaskStatus.FAILED, TaskStatus.UNKNOWN
    ):
        return None
    else:  # BOUND / RUNNING — truth-visible placement
        cls, node = "r", ti.node_name or ""
    return f"{ti.uid}|{cls}|{node}|{_res_key(ti.resreq)}"


def _digest(canonical: str) -> int:
    return int.from_bytes(
        hashlib.blake2b(canonical.encode(), digest_size=8).digest(), "big"
    )


def _bucket_of(key: str, buckets: int) -> int:
    return int.from_bytes(
        hashlib.blake2b(key.encode(), digest_size=4).digest(), "big"
    ) % buckets


class AntiEntropy:
    """One cache's cluster-truth reconciler. Sweeps are serialized on
    an internal lock: in production the periodic sweep runs on the
    scheduling loop while the gap-repair relist runs on the cache's
    resync daemon thread (its idle beat), and the fingerprint caches +
    incremental XOR folds must never see an interleaved pair of
    read-modify-write passes — a torn fold would read as permanent
    phantom divergence. The lock is held across the WHOLE sweep
    (listing included): reconciles are rare and idempotent, and a
    relist waiting out a periodic sweep is strictly cheaper than
    corrupting the folds. Lock order: the sweep lock is taken BEFORE
    cache.mutex (the mirror pass and every repair acquire the mutex
    inside); nothing acquires the sweep lock while holding the mutex."""

    def __init__(self, cache):
        self.cache = cache
        self._sweep_lock = wrap_lock("cache.antientropy")
        # Process-constant configuration (census: configuration.md).
        self.enabled = os.environ.get("KBT_ANTIENTROPY", "1") != "0"
        try:
            self.every = max(
                1, int(os.environ.get("KBT_ANTIENTROPY_EVERY", "256"))
            )
        except ValueError:
            self.every = 256
        try:
            self.buckets = max(
                1, int(os.environ.get("KBT_ANTIENTROPY_BUCKETS", "64"))
            )
        except ValueError:
            self.buckets = 64
        try:
            self.budget = max(
                1, int(os.environ.get("KBT_ANTIENTROPY_BUDGET", "256"))
            )
        except ValueError:
            self.budget = 256
        self._calls = 0
        # Digest caches keyed on cheap version witnesses, with
        # INCREMENTALLY maintained per-bucket XOR folds alongside —
        # a steady-state sweep re-hashes only changed objects and the
        # bucket compare is 4×B integer equality checks, never an
        # O(objects) Python fold.
        # truth pods: uid -> (rv, digest, bucket, canonical)
        self._truth_pod_fp: Dict[str, tuple] = {}
        # truth nodes: name -> (rv, digest, bucket, canonical)
        self._truth_node_fp: Dict[str, tuple] = {}
        # mirror jobs: job_key -> (id(job), ver,
        #     {uid: (digest, bucket, canonical)}, exempt_uids,
        #     {bucket: xor-of-digests})
        self._mirror_job_fp: Dict[str, tuple] = {}
        # mirror nodes: name -> (id(ni), ver, digest, bucket, canonical)
        self._mirror_node_fp: Dict[str, tuple] = {}
        self._fold_truth_pods = [0] * self.buckets
        self._fold_truth_nodes = [0] * self.buckets
        self._fold_mirror_pods = [0] * self.buckets
        self._fold_mirror_nodes = [0] * self.buckets
        # Cumulative counters (integrity_state / sim report).
        self.detected: Dict[str, int] = {}
        self.repaired: Dict[str, int] = {}
        self.sweeps = 0
        self.last_sweep: dict = {}
        # Truth-side shortcut witnesses: when the cluster's monotone
        # event rv hasn't moved since the last sweep (and the exempt
        # set is unchanged), truth provably didn't change — the listing
        # and the O(pods) loop are skipped wholesale.
        self._last_truth_rv: Optional[int] = None
        self._last_exempt: frozenset = frozenset()

    # -- public entry points -------------------------------------------------

    def sweep_if_due(self) -> Optional[dict]:
        """Cadence gate for the periodic sweep: every
        ``KBT_ANTIENTROPY_EVERY``-th call (the scheduler calls once per
        periodic cycle) runs a budget-bounded sweep."""
        if not self.enabled:
            return None
        self._calls += 1
        if (self._calls - 1) % self.every:
            return None
        return self.sweep(budget=self.budget)

    def full_reconcile(self) -> dict:
        """The watch-gap relist: one unbudgeted sweep. Raises on a list
        failure (after the typed retry ladder) — the caller keeps the
        gap pending."""
        return self.sweep(budget=None, adopt_rvs=True)

    # -- the sweep -----------------------------------------------------------

    def sweep(self, budget: Optional[int] = None,
              adopt_rvs: bool = False) -> dict:
        """Fingerprint mirror vs truth, diff mismatched buckets, repair
        up to ``budget`` divergences (None = all). Returns the sweep
        report; raises only when the truth listing itself fails.
        Serialized on the sweep lock (see class docstring)."""
        with self._sweep_lock:
            return self._sweep_locked(budget, adopt_rvs)

    def _sweep_locked(self, budget: Optional[int],
                      adopt_rvs: bool) -> dict:
        cache = self.cache
        cluster = cache.cluster

        # Mirror canonical maps + exempt uids, under the mutex (cheap:
        # version-witnessed digest reuse; no cluster I/O inside).
        with cache.mutex:
            mirror_jobs, exempt, terminated = self._mirror_pod_fps()
            mirror_nodes = self._mirror_node_fps()

        # Truth-side shortcut: the cluster's monotone event rv is a
        # whole-world version witness — unmoved rv (and an unchanged
        # exempt set, which filters the truth maps) means the previous
        # truth fingerprints are exact, no list, no O(pods) loop. Never
        # taken on a relist (adopt_rvs): a gap means the STREAM lied,
        # so the reconcile must re-read ground truth regardless.
        cur_rv_fn = getattr(cluster, "current_resource_version", None)
        truth_rv: Optional[int] = None
        if cur_rv_fn is not None:
            try:
                truth_rv = int(cur_rv_fn())
            except Exception:  # pragma: no cover - defensive
                truth_rv = None
        exempt_frozen = frozenset(exempt)

        def read_truth() -> tuple:
            # Truth listing through the relist seam (typed retry; the
            # sim's relist-fail fault injects TransientClusterError
            # here).
            pods = retry_transient(
                lambda: cluster.list_for_relist("Pod"),
                salt="antientropy/pods",
            )
            nodes = retry_transient(
                lambda: cluster.list_for_relist("Node"),
                salt="antientropy/nodes",
            )
            pod_map = self._truth_pod_fps(pods, exempt)
            node_map = self._truth_node_fps(nodes)
            self._last_truth_rv = truth_rv
            self._last_exempt = exempt_frozen
            return pods, nodes, pod_map, node_map

        def bucket_diff() -> set:
            return {
                b for b in range(self.buckets)
                if self._fold_mirror_pods[b] != self._fold_truth_pods[b]
                or self._fold_mirror_nodes[b]
                != self._fold_truth_nodes[b]
            }

        used_shortcut = (
            not adopt_rvs
            and truth_rv is not None
            and truth_rv == self._last_truth_rv
            and exempt_frozen == self._last_exempt
        )
        if used_shortcut:
            truth_pods: list = []
            truth_nodes: list = []
            truth_pod_map = self._truth_pod_fp
            truth_node_map = self._truth_node_fp
        else:
            truth_pods, truth_nodes, truth_pod_map, truth_node_map = (
                read_truth()
            )

        # Bucket compare on the incrementally maintained folds: 2×B
        # integer checks; the detailed diff walks only disagreeing
        # buckets (empty on every consistent sweep).
        dirty = bucket_diff()
        if dirty and used_shortcut:
            # The mirror diverged without any cluster write landing (a
            # direct poke, or repair fallout): re-read ground truth
            # before judging — repairs need the live objects.
            used_shortcut = False
            truth_pods, truth_nodes, truth_pod_map, truth_node_map = (
                read_truth()
            )
            dirty = bucket_diff()

        divergences: List[Tuple[str, str, str]] = []
        if dirty:
            divergences = self._diff(
                dirty, mirror_jobs, truth_pod_map,
                mirror_nodes, truth_node_map,
            )
        if (terminated or exempt) and not used_shortcut:
            # Terminated and in-flight tasks live outside the fold, but
            # one whose cluster pod is GONE is a phantom the
            # conservation invariant flags: a terminated orphan is
            # cleanup debris, and a BINDING/RELEASING task with no pod
            # cannot be "in flight" — its bind confirm AND its delete
            # were both lost (the storm's double-drop class), so the
            # exemption must not shield it forever. (Under the rv
            # shortcut there was no listing, and no cluster delete can
            # have happened without moving the rv.)
            truth_uids = {p.metadata.uid for p in truth_pods}
            for uid in sorted((terminated | exempt) - truth_uids):
                divergences.append(("phantom-task", uid, uid))

        report = {
            "pods": len(truth_pod_map),
            "nodes": len(truth_node_map),
            "buckets_dirty": len(dirty),
            "exempt_inflight": len(exempt),
            "detected": {},
            "repaired": {},
            "deferred": 0,
        }
        for kind, _subj, _key in divergences:
            report["detected"][kind] = report["detected"].get(kind, 0) + 1
            self.detected[kind] = self.detected.get(kind, 0) + 1

        repaired_n = 0
        truth_pod_by_uid = {
            p.uid: p for p in truth_pods if p.uid in truth_pod_map
        }
        truth_node_by_name = {n.name: n for n in truth_nodes}
        for kind, subject, _key in divergences:
            if budget is not None and repaired_n >= budget:
                report["deferred"] += 1
                continue
            if self._repair(
                kind, subject, truth_pod_by_uid, truth_node_by_name,
                adopt_rvs,
            ):
                repaired_n += 1
                report["repaired"][kind] = (
                    report["repaired"].get(kind, 0) + 1
                )
                self.repaired[kind] = self.repaired.get(kind, 0) + 1
        if adopt_rvs:
            # Relist semantics: the listed versions ARE the guard
            # baseline now — late stale events predating the list must
            # be absorbed, not re-applied.
            for pod in truth_pods:
                cache._adopt_listed_rv("Pod", pod)
            for node in truth_nodes:
                cache._adopt_listed_rv("Node", node)

        self.sweeps += 1
        self.last_sweep = report
        self._export(report)
        return report

    # -- canonical fingerprint maps ------------------------------------------

    def _mirror_pod_fps(self):
        """Per-job fingerprint entries over every mirror task, plus the
        exempt (in-flight) uid set and the TERMINATED uid set;
        maintains the mirror-pod bucket fold incrementally. Caller
        holds cache.mutex. Per-JOB memoization on (identity, _ver): an
        untouched job contributes nothing but two comparisons.

        Terminated tasks live outside the fold (see _task_canonical)
        but are collected separately: one whose cluster pod is GONE is
        a phantom the conservation invariant would flag forever, so the
        sweep still repairs exactly that case (sweep() checks the set
        against the listed truth uids)."""
        exempt: set = set()
        terminated: set = set()
        fresh: Dict[str, tuple] = {}
        old = self._mirror_job_fp
        folds = self._fold_mirror_pods
        B = self.buckets
        for job_key, job in self.cache.jobs.items():
            entry = old.get(job_key)
            if (
                entry is not None
                and entry[0] == id(job)
                and entry[1] == job._ver
            ):
                fresh[job_key] = entry
                if entry[3]:
                    exempt.update(entry[3])
                if entry[5]:
                    terminated.update(entry[5])
                continue
            fps: Dict[str, tuple] = {}
            job_exempt: set = set()
            job_term: set = set()
            jfold: Dict[int, int] = {}
            for uid, task in job.tasks.items():
                canonical = _task_canonical(task)
                if canonical is None:
                    if task.status in (
                        TaskStatus.SUCCEEDED, TaskStatus.FAILED
                    ):
                        job_term.add(uid)
                    else:
                        job_exempt.add(uid)
                    continue
                d = _digest(canonical)
                b = _bucket_of(uid, B)
                fps[uid] = (d, b, canonical)
                jfold[b] = jfold.get(b, 0) ^ d
            fresh[job_key] = (
                id(job), job._ver, fps, job_exempt, jfold, job_term
            )
            if entry is not None:
                for b, x in entry[4].items():
                    folds[b] ^= x
            for b, x in jfold.items():
                folds[b] ^= x
            if job_exempt:
                exempt.update(job_exempt)
            if job_term:
                terminated.update(job_term)
        for job_key in old.keys() - fresh.keys():
            for b, x in old[job_key][4].items():
                folds[b] ^= x
        self._mirror_job_fp = fresh  # deleted jobs fall away
        return fresh, exempt, terminated

    def _mirror_node_fps(self):
        """{name: (id, ver, digest, bucket, canonical)} over mirror
        nodes, fold maintained incrementally. Caller holds cache.mutex.
        Placeholder entries (``node is None``, minted for pods naming
        an unlisted node) canonicalize as placeholders — truth either
        fills them (stale-node) or they are phantoms (vanished-node)."""
        fresh: Dict[str, tuple] = {}
        old = self._mirror_node_fp
        folds = self._fold_mirror_nodes
        for name, ni in self.cache.nodes.items():
            entry = old.get(name)
            if (
                entry is not None
                and entry[0] == id(ni)
                and entry[1] == ni._ver
            ):
                fresh[name] = entry
                continue
            if ni.node is None:
                canonical = f"{name}|placeholder"
            else:
                canonical = (
                    f"{name}|{int(ni.ready())}|{_res_key(ni.allocatable)}"
                )
            d = _digest(canonical)
            b = _bucket_of(name, self.buckets)
            fresh[name] = (id(ni), ni._ver, d, b, canonical)
            if entry is not None:
                folds[entry[3]] ^= entry[2]
            folds[b] ^= d
        for name in old.keys() - fresh.keys():
            entry = old[name]
            folds[entry[3]] ^= entry[2]
        self._mirror_node_fp = fresh
        return fresh

    def _truth_pod_fps(self, pods, exempt):
        """{uid: (rv, digest, bucket, canonical)} over accepted cluster
        pods, excluding in-flight-exempt uids; fold maintained
        incrementally. Per-pod memoization on the cluster's write
        resourceVersion — an unchanged pod costs one dict get."""
        accept = self.cache._accept_pod
        fresh: Dict[str, tuple] = {}
        old = self._truth_pod_fp
        folds = self._fold_truth_pods
        B = self.buckets
        for pod in pods:
            uid = pod.metadata.uid
            if uid in exempt:
                continue
            entry = old.get(uid)
            rv = pod.metadata.resource_version
            if entry is not None and rv and entry[0] == rv:
                fresh[uid] = entry
                continue
            if not accept(pod):
                continue
            canonical = _task_canonical(TaskInfo(pod))
            if canonical is None:
                # Truth-side in-flight analog (deletion-stamped pod):
                # exempt this sweep.
                continue
            d = _digest(canonical)
            b = _bucket_of(uid, B)
            fresh[uid] = (rv, d, b, canonical)
            if entry is not None:
                folds[entry[2]] ^= entry[1]
            folds[b] ^= d
        for uid in old.keys() - fresh.keys():
            entry = old[uid]
            folds[entry[2]] ^= entry[1]
        self._truth_pod_fp = fresh
        return fresh

    def _truth_node_fps(self, nodes):
        from ..api import NodeInfo

        fresh: Dict[str, tuple] = {}
        old = self._truth_node_fp
        folds = self._fold_truth_nodes
        for node in nodes:
            name = node.name
            rv = node.metadata.resource_version
            entry = old.get(name)
            if entry is not None and rv and entry[0] == rv:
                fresh[name] = entry
                continue
            ni = NodeInfo(node)
            canonical = (
                f"{name}|{int(ni.ready())}|{_res_key(ni.allocatable)}"
            )
            d = _digest(canonical)
            b = _bucket_of(name, self.buckets)
            fresh[name] = (rv, d, b, canonical)
            if entry is not None:
                folds[entry[2]] ^= entry[1]
            folds[b] ^= d
        self._truth_node_fp = fresh
        return fresh

    # -- diffing -------------------------------------------------------------

    def _diff(self, dirty, mirror_jobs, truth_pods, mirror_nodes,
              truth_nodes) -> List[Tuple[str, str, str]]:
        """Object-level diff restricted to the dirty buckets (runs only
        when a bucket fold disagreed — never on a consistent sweep).
        Returns sorted (kind, subject, key) triples so repairs apply in
        a replay-deterministic order."""
        out: List[Tuple[str, str, str]] = []
        m_pods: Dict[str, tuple] = {}
        for entry in mirror_jobs.values():
            for uid, fp in entry[2].items():
                if fp[1] in dirty:
                    m_pods[uid] = fp
        t_pods = {
            uid: (e[1], e[2], e[3])
            for uid, e in truth_pods.items() if e[2] in dirty
        }
        for uid in sorted(m_pods.keys() | t_pods.keys()):
            m = m_pods.get(uid)
            t = t_pods.get(uid)
            if m is not None and t is None:
                out.append(("phantom-task", uid, uid))
            elif m is None and t is not None:
                bound = t[2].split("|", 3)[1] == "r"
                out.append((
                    "missed-bind" if bound else "missed-pod", uid, uid
                ))
            elif m[0] != t[0]:
                m_cls = m[2].split("|", 3)[1]
                t_cls = t[2].split("|", 3)[1]
                kind = (
                    "missed-bind" if t_cls == "r" and m_cls != "r"
                    else "stale-task"
                )
                out.append((kind, uid, uid))
        m_nodes = {
            name: (e[2], e[3], e[4])
            for name, e in mirror_nodes.items() if e[3] in dirty
        }
        t_nodes = {
            name: (e[1], e[2], e[3])
            for name, e in truth_nodes.items() if e[2] in dirty
        }
        for name in sorted(m_nodes.keys() | t_nodes.keys()):
            m = m_nodes.get(name)
            t = t_nodes.get(name)
            if m is not None and t is None:
                out.append(("vanished-node", name, name))
            elif m is None and t is not None:
                out.append(("missed-node", name, name))
            elif m[0] != t[0]:
                out.append(("stale-node", name, name))
        out.sort()
        return out

    # -- repair --------------------------------------------------------------

    def _repair(self, kind, subject, truth_pod_by_uid,
                truth_node_by_name, adopt_rvs: bool) -> bool:
        """One divergence repair through the stamping entry points.
        Returns True when the repair was applied. Never raises — one
        broken object must not stall the sweep (same contract as
        recovery.reconcile_journal)."""
        cache = self.cache
        try:
            if kind in ("missed-pod",):
                cache.add_pod(truth_pod_by_uid[subject])
            elif kind in ("missed-bind", "stale-task", "phantom-task"):
                with cache.mutex:
                    task = None
                    for job in cache.jobs.values():
                        task = job.tasks.get(subject)
                        if task is not None:
                            task = task.clone()
                            break
                if task is not None:
                    # _sync_task reconciles to cluster truth: updates
                    # to the live pod, or deletes when it vanished.
                    cache._sync_task(task)
                elif subject in truth_pod_by_uid:
                    cache.add_pod(truth_pod_by_uid[subject])
                else:
                    return False
            elif kind == "missed-node":
                cache.add_node(truth_node_by_name[subject])
            elif kind == "stale-node":
                node = truth_node_by_name[subject]
                cache.update_node(node, node)
            elif kind == "vanished-node":
                with cache.mutex:
                    ni = cache.nodes.get(subject)
                    node = ni.node if ni is not None else None
                if node is None:
                    from ..api import Node
                    from ..api.objects import ObjectMeta

                    node = Node(metadata=ObjectMeta(
                        name=subject, namespace="",
                    ))
                cache.delete_node(node)
            else:  # pragma: no cover - defensive
                return False
        except Exception:
            logger.exception(
                "anti-entropy repair %s of %s failed", kind, subject
            )
            return False
        return True

    # -- reporting -----------------------------------------------------------

    def _export(self, report: dict) -> None:
        """Metrics + flight-record annotation (never raises)."""
        try:
            from .. import metrics

            for kind in sorted(report["detected"]):
                metrics.register_divergence(
                    "detected", kind, report["detected"][kind]
                )
            for kind in sorted(report["repaired"]):
                metrics.register_divergence(
                    "repaired", kind, report["repaired"][kind]
                )
        except Exception:  # pragma: no cover - metrics must never kill
            logger.exception("divergence metric update failed")
        if report["detected"]:
            logger.warning(
                "anti-entropy sweep found divergence: %s (repaired %s, "
                "deferred %d)",
                report["detected"], report["repaired"],
                report["deferred"],
            )
            try:
                from ..obs import RECORDER

                RECORDER.annotate("integrity", {
                    "divergence_detected": dict(
                        sorted(report["detected"].items())
                    ),
                    "divergence_repaired": dict(
                        sorted(report["repaired"].items())
                    ),
                    "deferred": report["deferred"],
                })
            except Exception:  # pragma: no cover - forensics only
                logger.exception("integrity flight annotation failed")

    def state_dict(self) -> dict:
        return {
            "divergence_detected": dict(sorted(self.detected.items())),
            "divergence_repaired": dict(sorted(self.repaired.items())),
            "sweeps": self.sweeps,
            "last_sweep": dict(self.last_sweep),
        }
