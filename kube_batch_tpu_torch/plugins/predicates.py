"""Predicates plugin: node feasibility checks.

Mirrors reference plugins/predicates/predicates.go (:113-265), which delegates
to the vendored k8s default-scheduler predicates. Implemented natively here
against the standalone object model, same check set and order:
- MaxTaskNum pod-count (:128)
- CheckNodeCondition (:133) — node Ready, not under unschedulable taint
- CheckNodeUnschedulable via spec (:147)
- PodMatchNodeSelector incl. required node affinity (:161)
- PodFitsHostPorts (:175)
- PodToleratesNodeTaints (:189)
- Memory/Disk/PID pressure, gated by plugin arguments
  predicate.{Memory,Disk,PID}PressureEnable (:75-110, :203-249)
- Inter-pod affinity/anti-affinity over session state (:252-262)

Each predicate raises PredicateError(reason) on rejection. The plugin also
registers a *batch* predicate (TPU-native extension) that evaluates the
static checks for a whole task batch as a [T, N] numpy mask — used by
ops.snapshot to build the device-side feasibility mask without a Python
per-(task, node) loop.
"""

from __future__ import annotations

from typing import List

import numpy as np

from ..api import NodeInfo, TaskInfo
from ..framework import Plugin, register_plugin_builder
from .util import (
    PLACED_STATUSES,
    PredicateError,
    SessionPodLister,
    match_affinity_term,
    match_label_selector,
    match_node_selector_terms,
)

# Per-pod memo attribute this plugin stamps onto (immutable) pod specs
# for tensorize speed: one tuple (template signature, has host ports,
# has inter-pod affinity) so a 50k-task cold burst pays ONE dict
# lookup + write per pod, not two. Anything that needs to re-cold the
# cache (the bench's burst simulation) must go through
# clear_pod_caches so the attr list lives in exactly one place.
POD_CACHE_ATTRS = ("_pred_cache",)


def clear_pod_caches(pods) -> None:
    """Drop the per-pod memos: this plugin's (POD_CACHE_ATTRS) plus the
    pod_key memo (api.helpers), so a re-cold simulation pays every
    first-touch cost a genuinely fresh pod would."""
    from ..api.helpers import POD_KEY_CACHE_ATTR

    attrs = POD_CACHE_ATTRS + (POD_KEY_CACHE_ATTR,)
    for pod in pods:
        for attr in attrs:
            if hasattr(pod, attr):
                delattr(pod, attr)


# Argument keys (reference predicates.go:75-95).
MEMORY_PRESSURE_ENABLE = "predicate.MemoryPressureEnable"
DISK_PRESSURE_ENABLE = "predicate.DiskPressureEnable"
PID_PRESSURE_ENABLE = "predicate.PIDPressureEnable"


def _node_condition(node: NodeInfo, cond_type: str) -> str:
    if node.node is None:
        return "Unknown"
    for c in node.node.status.conditions:
        if c.type == cond_type:
            return c.status
    return ""


def check_node_condition(task: TaskInfo, node: NodeInfo) -> None:
    """Node must be Ready and not OutOfDisk (k8s CheckNodeCondition)."""
    ready = _node_condition(node, "Ready")
    if ready not in ("", "True"):
        raise PredicateError("NodeNotReady", f"node {node.name} is not ready")
    if _node_condition(node, "OutOfDisk") == "True":
        raise PredicateError("NodeOutOfDisk", f"node {node.name} is out of disk")


def check_node_unschedulable(task: TaskInfo, node: NodeInfo) -> None:
    if node.node is not None and node.node.spec.unschedulable:
        raise PredicateError(
            "NodeUnschedulable", f"node {node.name} is unschedulable"
        )


def check_max_task_num(task: TaskInfo, node: NodeInfo) -> None:
    """reference predicates.go:128-131"""
    if len(node.tasks) >= node.allocatable.max_task_num > 0:
        raise PredicateError(
            "NodePodNumberExceeded",
            f"node {node.name} has {len(node.tasks)} tasks, "
            f"max {node.allocatable.max_task_num}",
        )


def pod_match_node_selector(task: TaskInfo, node: NodeInfo) -> None:
    """nodeSelector + required node affinity (k8s PodMatchNodeSelector)."""
    labels = node.node.metadata.labels if node.node else {}
    if task.pod.spec.node_selector and not match_label_selector(
        task.pod.spec.node_selector, labels
    ):
        raise PredicateError(
            "MatchNodeSelector", f"node {node.name} does not match node selector"
        )
    affinity = task.pod.spec.affinity
    if affinity and affinity.node_required is not None:
        if not match_node_selector_terms(affinity.node_required, labels):
            raise PredicateError(
                "MatchNodeSelector",
                f"node {node.name} does not match required node affinity",
            )


def pod_fits_host_ports(task: TaskInfo, node: NodeInfo) -> None:
    wanted = set()
    for c in task.pod.spec.containers:
        wanted.update(c.ports)
    if not wanted:
        return
    for other in node.tasks.values():
        for c in other.pod.spec.containers:
            if wanted.intersection(c.ports):
                raise PredicateError(
                    "PodFitsHostPorts", f"host port conflict on {node.name}"
                )


def pod_tolerates_node_taints(task: TaskInfo, node: NodeInfo) -> None:
    if node.node is None:
        return
    for taint in node.node.spec.taints:
        if taint.effect not in ("NoSchedule", "NoExecute"):
            continue  # PreferNoSchedule is a soft constraint
        if not any(t.tolerates(taint) for t in task.pod.spec.tolerations):
            raise PredicateError(
                "PodToleratesNodeTaints",
                f"taint {taint.key}={taint.value}:{taint.effect} not tolerated",
            )


def _check_pressure(node: NodeInfo, cond_type: str, reason: str) -> None:
    if _node_condition(node, cond_type) == "True":
        raise PredicateError(reason, f"node under {cond_type}")


class _PredNodeCache:
    """Cross-cycle node-column + template-group-row cache for the batch
    predicate (stored on the scheduler cache as ``_pred_batch_cache``).

    Same fingerprint contract as the tensorize cache
    (solver/snapshot._TensorizeCache): the COW snapshot pool hands
    consecutive sessions identical NodeInfo clone objects while nothing
    changed, and every mutator bumps ``_ver``, so ``(identity, _ver)``
    exactly identifies a node whose verdict columns are still valid.
    Holding the node references pins their ids. ``sig_rows`` maps a pod
    template signature to ``(rep_pod, has_selaff, row)`` — the [N] group
    row is patched column-wise for dirty nodes and reused whole for the
    rest."""

    __slots__ = (
        "flags", "node_objs", "node_ids", "node_vers", "node_ok",
        "has_taints", "static_ok", "sig_rows",
    )
    # Retention bound for template rows whose signature did not appear
    # in the current batch (kept warm so alternating bursts reuse them).
    MAX_RETAINED_SIGS = 128

    def __init__(self):
        self.flags = None
        self.node_objs = None
        self.node_ids = None
        self.node_vers = None
        self.node_ok = None
        self.has_taints = None
        # Watch-object-only half of node_ok (conditions, cordon,
        # pressure): invariant under the scheduler's own placements, so
        # narrow-dirty nodes recompute only the live pod-count cap.
        self.static_ok = None
        self.sig_rows = {}


class _SigRep:
    """Minimal task stand-in for re-evaluating a cached signature row
    (the predicate helpers only read ``task.pod``)."""

    __slots__ = ("pod",)

    def __init__(self, pod):
        self.pod = pod


class PredicatesPlugin(Plugin):
    def __init__(self, arguments=None):
        self.arguments = arguments or {}

    def name(self) -> str:
        return "predicates"

    def _pressure_flags(self):
        getb = getattr(self.arguments, "get_bool", None)
        if getb is None:
            return False, False, False
        return (
            bool(getb(MEMORY_PRESSURE_ENABLE, False)),
            bool(getb(DISK_PRESSURE_ENABLE, False)),
            bool(getb(PID_PRESSURE_ENABLE, False)),
        )

    def on_session_open(self, ssn) -> None:
        mem_enable, disk_enable, pid_enable = self._pressure_flags()
        lister = SessionPodLister(ssn)

        def check_pod_affinity(task: TaskInfo, node: NodeInfo) -> None:
            """Simplified inter-pod (anti-)affinity with node-level topology
            (reference predicates.go:252-262 via vendored k8s checker)."""
            affinity = task.pod.spec.affinity
            if affinity is None:
                return
            on_node = lister.pods_on_node(node.name)
            for term in affinity.pod_affinity or []:
                if not any(
                    match_affinity_term(term, t.pod.metadata.labels)
                    for t in on_node
                ):
                    # k8s bootstrap rule (vendored predicates
                    # satisfiesPodsAffinityAntiAffinity): a required term with
                    # NO matching pod anywhere is satisfied if the incoming
                    # pod itself matches the selector — the first pod of a
                    # self-affine group must be schedulable somewhere.
                    exists_anywhere = any(
                        match_affinity_term(term, t.pod.metadata.labels)
                        for t in lister.tasks()
                        if t.uid != task.uid and t.status in PLACED_STATUSES
                    )
                    if exists_anywhere or not match_affinity_term(
                        term, task.pod.metadata.labels
                    ):
                        raise PredicateError(
                            "MatchInterPodAffinity",
                            f"pod affinity not satisfied on {node.name}",
                        )
            for term in affinity.pod_anti_affinity or []:
                if any(
                    match_affinity_term(term, t.pod.metadata.labels)
                    for t in on_node
                    if t.uid != task.uid
                ):
                    raise PredicateError(
                        "MatchInterPodAntiAffinity",
                        f"pod anti-affinity violated on {node.name}",
                    )

        def predicate_fn(task: TaskInfo, node: NodeInfo) -> None:
            """reference predicates.go:124-264, same check order."""
            check_max_task_num(task, node)
            check_node_condition(task, node)
            check_node_unschedulable(task, node)
            pod_match_node_selector(task, node)
            pod_fits_host_ports(task, node)
            pod_tolerates_node_taints(task, node)
            if mem_enable:
                _check_pressure(node, "MemoryPressure", "NodeUnderMemoryPressure")
            if disk_enable:
                _check_pressure(node, "DiskPressure", "NodeUnderDiskPressure")
            if pid_enable:
                _check_pressure(node, "PIDPressure", "NodeUnderPIDPressure")
            check_pod_affinity(task, node)

        ssn.add_predicate_fn(self.name(), predicate_fn)

        def batch_predicate_fn(tasks: List[TaskInfo], nodes: List[NodeInfo]):
            """Factorized feasibility (solver/masks.BatchMask).

            Node-level checks (conditions, unschedulable, pressure,
            pod-count) produce one [N] column mask. Tolerations, node
            selectors, and required node affinity are functions of the pod
            TEMPLATE, not the pod — tasks are grouped by their
            (tolerations, selector, affinity) signature and each of the G
            distinct signatures is evaluated against all nodes once:
            O(N + G·N) host work instead of O(T·N). Host ports and
            inter-pod (anti-)affinity depend on per-node session state and
            get private per-task rows (sparse: only tasks that carry
            them).

            This factorization is ALSO what the top-K candidate
            selection pass consumes (solver/topk.py): combine_masks
            folds these parts into CombinedMask, whose ``rows_for``
            emits per-class candidate-column masks — one row per
            distinct (group, req/fit, private-row) class, not per task.
            A custom plugin returning a dense [T, N] mask still works
            (combine_masks dedups identical rows into groups), but any
            per-task row variance it introduces multiplies the class
            count and can push the selection pass over its budget
            (dense fallback, reason "class-budget") — prefer BatchMask's
            group/pair form."""
            from ..solver.masks import BatchMask

            T, N = len(tasks), len(nodes)

            # Node column: the static verdict (conditions, cordon,
            # pressure gates, has-taints) reads only the immutable
            # watch object, so it is memoized on node.node keyed by the
            # pressure-flag combo — a watch update replaces the object
            # and invalidates naturally, exactly like the pod spec memo
            # below. Only the pod-count cap stays live per cycle.
            flags = (mem_enable, disk_enable, pid_enable)

            def node_verdict(node):
                """(schedulable, has_taints, static_ok) for one node —
                exactly the pre-incremental per-node loop body, with the
                watch-object-only half exposed for the narrow-churn
                fast path."""
                knode = node.node
                if knode is None:
                    # No backing object: evaluate directly (the checks
                    # define the Unknown-condition semantics).
                    try:
                        check_node_condition(None, node)
                        check_node_unschedulable(None, node)
                    except PredicateError:
                        return False, False, False
                    has_taints = False
                else:
                    # Unlike pod specs, node specs/conditions are
                    # MUTABLE: the memo key carries id(owner) — a
                    # copied object (copy.deepcopy in tests/tools)
                    # inherits the attr but its own id never matches —
                    # AND the NodeInfo's watch-object generation
                    # (bumped by set_node), which catches an in-place
                    # mutation re-delivered as the SAME reference
                    # (InProcessCluster.update does exactly that).
                    gen = node._node_obj_ver
                    cached = knode.__dict__.get("_node_pred")
                    if (
                        cached is None
                        or cached[0] != (flags, id(knode), gen)
                    ):
                        ok = True
                        try:
                            check_node_condition(None, node)
                            check_node_unschedulable(None, node)
                            if mem_enable:
                                _check_pressure(node, "MemoryPressure", "x")
                            if disk_enable:
                                _check_pressure(node, "DiskPressure", "x")
                            if pid_enable:
                                _check_pressure(node, "PIDPressure", "x")
                        except PredicateError:
                            ok = False
                        cached = knode._node_pred = (
                            (flags, id(knode), gen),
                            ok,
                            bool(knode.spec.taints),
                        )
                    has_taints = cached[2]
                    if not cached[1]:
                        return False, has_taints, False
                if 0 < node.allocatable.max_task_num <= len(node.tasks):
                    return False, has_taints, True
                return True, has_taints, True

            # Cross-cycle columns (see _PredNodeCache): dirty nodes are
            # the fingerprint misses; only their verdicts re-run. A
            # flags/node-set change rebuilds everything. This pass ran
            # over EVERY node EVERY cycle before — it was most of the
            # 1%-delta tensorize floor at 5k nodes.
            pc = None
            cache_host = getattr(ssn, "cache", None)
            if cache_host is not None:
                pc = getattr(cache_host, "_pred_batch_cache", None)
                if pc is None:
                    pc = _PredNodeCache()
                    try:
                        cache_host._pred_batch_cache = pc
                    except Exception:
                        pc = None
            # Shared per-tensorize node scan (solver/snapshot): the
            # (identity, _ver) arrays are computed once per cycle and
            # reused here when the caller passed its exact node list.
            scan = getattr(ssn, "_kbt_node_scan", None)
            if scan is not None and scan.nodes is nodes:
                cur_ids, cur_vers = scan.ids, scan.vers
            else:
                cur_ids = np.fromiter(map(id, nodes), np.int64, count=N)
                cur_vers = np.fromiter(
                    (n._ver for n in nodes), np.int64, count=N
                )
            if (
                pc is None
                or pc.node_objs is None
                or pc.node_ids is None
                or pc.flags != flags
                or pc.static_ok is None
                or len(pc.node_objs) != N
            ):
                node_ok = np.empty(N, dtype=bool)
                has_taints_col = np.empty(N, dtype=bool)
                static_ok_col = np.empty(N, dtype=bool)
                dirty = list(range(N))
                recheck = dirty
                prev_sig_rows = {}
            else:
                node_ok = pc.node_ok
                has_taints_col = pc.has_taints
                static_ok_col = pc.static_ok
                dirty = np.nonzero(
                    (cur_ids != pc.node_ids)
                    | (cur_vers != pc.node_vers)
                )[0].tolist()
                prev_sig_rows = pc.sig_rows
                # NARROW split: rows whose only churn was the
                # scheduler's own placements keep their watch-object
                # verdict and taint/selector columns — only the live
                # pod-count cap can move. Their sig-row columns need a
                # re-verdict ONLY when that cap flipped node_ok.
                narrow = getattr(ssn, "dirty_nodes_narrow", None)
                if dirty and narrow:
                    recheck = []
                    for j in dirty:
                        n = nodes[j]
                        if n.name in narrow:
                            ok = bool(static_ok_col[j]) and not (
                                0 < n.allocatable.max_task_num
                                <= len(n.tasks)
                            )
                            if ok != node_ok[j]:
                                # Pod-count cap flipped the verdict:
                                # fall through to the full re-verdict
                                # so the sig-row columns re-derive too.
                                recheck.append(j)
                        else:
                            recheck.append(j)
                else:
                    recheck = dirty
            for j in recheck:
                (
                    node_ok[j], has_taints_col[j], static_ok_col[j],
                ) = node_verdict(nodes[j])
            if pc is not None and (dirty or pc.node_objs is None):
                pc.flags = flags
                pc.node_objs = list(nodes)
                pc.node_ids = cur_ids
                pc.node_vers = cur_vers
                pc.node_ok = node_ok
                pc.has_taints = has_taints_col
                pc.static_ok = static_ok_col
            tainted = np.nonzero(node_ok & has_taints_col)[0].tolist()

            def _terms_sig(terms):
                # node_required is a list of terms (each a list of
                # expression dicts), or a flat expression list treated as
                # one term — mirror match_node_selector_terms.
                if terms and isinstance(terms[0], dict):
                    terms = [terms]
                return tuple(
                    tuple(
                        (
                            e.get("key"),
                            e.get("operator"),
                            tuple(e.get("values") or ()),
                        )
                        for e in term
                    )
                    for term in terms
                )

            # ONE pass over the task list: template-signature grouping
            # AND the private-row (host ports / inter-pod affinity)
            # verdicts together. Pod specs are immutable after creation
            # (k8s semantics), so everything derived from the spec is
            # cached on the pod object in one tuple — tasks are cloned
            # every snapshot but share the pod, making the derivation a
            # once-per-pod cost and this loop two dict ops per task
            # (measured: the split loops + separate caches were ~40% of
            # first-cycle tensorize at 50k tasks).
            sig_to_group: dict = {}
            task_group = np.empty(T, dtype=np.int32)
            reps: List[TaskInfo] = []
            sig_list: List[tuple] = []  # signature per group, ∥ reps
            private: List[tuple] = []  # (i, task, has_ports, has_pod_aff)
            sig_get = sig_to_group.get
            for i, task in enumerate(tasks):
                pod = task.pod
                cached = pod.__dict__.get("_pred_cache")
                if cached is None:
                    spec = pod.spec
                    # Plain pods (no tolerations/selector/affinity) are
                    # the bulk of a big snapshot; skip tuple building
                    # for their empty fields.
                    tol = spec.tolerations
                    tol_sig = tuple(
                        (t.key, t.operator, t.value, t.effect)
                        for t in tol
                    ) if tol else ()
                    sel = spec.node_selector
                    sel_sig = tuple(sorted(sel.items())) if sel else ()
                    aff = spec.affinity
                    req_aff = (
                        _terms_sig(aff.node_required)
                        if aff is not None and aff.node_required
                        else None
                    )
                    has_ports = False
                    for c in spec.containers:  # plain loop: a genexpr
                        if c.ports:            # frame per pod was ~9%
                            has_ports = True   # of a 50k cold tensorize
                            break
                    cached = pod._pred_cache = (
                        (tol_sig, sel_sig, req_aff),
                        has_ports,
                        aff is not None and bool(
                            aff.pod_affinity or aff.pod_anti_affinity
                        ),
                    )
                sig, has_ports, has_pod_aff = cached
                g = sig_get(sig)
                if g is None:
                    g = sig_to_group[sig] = len(reps)
                    reps.append(task)
                    sig_list.append(sig)
                task_group[i] = g
                if has_ports or has_pod_aff:
                    private.append((i, task, has_ports, has_pod_aff))

            def build_sig_row(rep, has_selaff):
                """Full [N] group row — the pre-incremental loops."""
                row = np.ones(N, dtype=bool)
                for j in tainted:
                    try:
                        pod_tolerates_node_taints(rep, nodes[j])
                    except PredicateError:
                        row[j] = False
                if has_selaff:
                    for j in range(N):
                        if not (node_ok[j] and row[j]):
                            continue
                        try:
                            pod_match_node_selector(rep, nodes[j])
                        except PredicateError:
                            row[j] = False
                return row

            def patch_sig_row(row, rep, has_selaff):
                """Re-verdict only the re-checked columns of a cached
                row (narrow-churn columns with an unchanged verdict are
                already exact). Column-for-column identical to
                build_sig_row: a not-ok node's column resets to True
                (never evaluated), taints then selector in order for
                the rest."""
                for j in recheck:
                    row[j] = True
                    if not node_ok[j]:
                        continue
                    if has_taints_col[j]:
                        try:
                            pod_tolerates_node_taints(rep, nodes[j])
                        except PredicateError:
                            row[j] = False
                            continue
                    if has_selaff:
                        try:
                            pod_match_node_selector(rep, nodes[j])
                        except PredicateError:
                            row[j] = False
                return row

            # Template-group rows, kept alive across cycles per
            # signature: a signature seen before costs O(dirty nodes);
            # only new signatures pay the O(N) build. Rows retained for
            # signatures absent from THIS batch (bounded) are patched
            # too, so they stay valid for the next burst.
            new_sig_rows: dict = {}
            group_rows = np.empty((len(reps), N), dtype=bool)
            for g, rep in enumerate(reps):
                spec = rep.pod.spec
                aff = spec.affinity
                has_selaff = bool(spec.node_selector) or (
                    aff is not None and bool(aff.node_required)
                )
                ent = prev_sig_rows.get(sig_list[g])
                if ent is None:
                    row = build_sig_row(rep, has_selaff)
                else:
                    row = patch_sig_row(ent[2], rep, has_selaff)
                new_sig_rows[sig_list[g]] = (rep.pod, has_selaff, row)
                group_rows[g] = row
            if pc is not None:
                for sig, ent in prev_sig_rows.items():
                    if sig in new_sig_rows:
                        continue
                    if len(new_sig_rows) >= _PredNodeCache.MAX_RETAINED_SIGS:
                        break
                    rep_pod, has_selaff, row = ent
                    new_sig_rows[sig] = (
                        rep_pod,
                        has_selaff,
                        patch_sig_row(row, _SigRep(rep_pod), has_selaff),
                    )
                pc.sig_rows = new_sig_rows

            # Private rows: host ports and inter-pod (anti-)affinity —
            # only for the (rare) tasks collected above.
            rows = {}
            for i, task, has_ports, has_pod_aff in private:
                row = np.ones(N, dtype=bool)
                for j, node in enumerate(nodes):
                    if not (node_ok[j] and group_rows[task_group[i], j]):
                        row[j] = False
                        continue
                    try:
                        if has_ports:
                            pod_fits_host_ports(task, node)
                        if has_pod_aff:
                            check_pod_affinity(task, node)
                    except PredicateError:
                        row[j] = False
                rows[i] = row

            return BatchMask(
                # Copy: the cache patches its column in place next cycle
                # and callers may hold the mask across cycles.
                node_ok=node_ok.copy(),
                task_group=task_group,
                group_rows=group_rows,
                rows=rows,
            )

        ssn.add_batch_predicate_fn(self.name(), batch_predicate_fn)


register_plugin_builder("predicates", lambda args: PredicatesPlugin(args))
