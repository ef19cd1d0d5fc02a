"""Post-solve placement validation: the last gate before binds.

A copy of ``kube_batch_tpu/solver/validate.py`` that reads the host
snapshot arrays (the feasibility factors, ``task_req`` and
``node_idle`` of a ``SolverInputs`` bundle) in place of the session's
snapshot context. Every proposed placement is rechecked on the host in
O(placements) work:

- **bad-index**: assignment outside [0, N);
- **infeasible**: the placement violates the feasibility mask the solve
  was given (group row AND node column AND private row);
- **capacity**: a node's aggregate assigned request exceeds its idle
  capacity by more than a per-task epsilon slack.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np


def _np(x) -> np.ndarray:
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def validate_placements(
    snapshot: object,
    assigned,
    n_tasks: Optional[int] = None,
    n_nodes: Optional[int] = None,
) -> Tuple[np.ndarray, Dict[str, int]]:
    """Validate one solve's placements against ``snapshot`` (any object
    with the ``SolverInputs`` fields ``group_feas``, ``task_group``,
    ``node_feas``, ``pair_idx``, ``pair_feas``, ``task_req``,
    ``node_idle`` and ``eps``, as NumPy arrays or tensors). ``n_tasks``
    / ``n_nodes`` are the unpadded counts (default: every row). Returns
    ``(bad_task_indices, reason_counts)``, empty on a clean result."""
    group_feas = _np(snapshot.group_feas)
    task_group = _np(snapshot.task_group)
    node_ok = _np(snapshot.node_feas).astype(bool)
    pair_idx = _np(snapshot.pair_idx)
    pair_rows = _np(snapshot.pair_feas)
    task_req = _np(snapshot.task_req)
    node_idle = _np(snapshot.node_idle)
    eps = _np(snapshot.eps).astype(np.float64)
    T = len(task_req) if n_tasks is None else int(n_tasks)
    N = len(node_idle) if n_nodes is None else int(n_nodes)
    a = _np(assigned)[:T]
    # Only the -1 sentinel means unassigned: any other negative index is
    # corruption, rejected as bad-index.
    sel = np.nonzero(a != -1)[0]
    if sel.size == 0:
        return np.empty(0, dtype=np.int64), {}

    reasons: Dict[str, int] = {}
    nodes_sel = a[sel]
    bad_parts = []

    oob = (nodes_sel >= N) | (nodes_sel < 0)
    if oob.any():
        bad_parts.append(sel[oob])
        reasons["bad-index"] = int(oob.sum())
    ok = ~oob
    sel_ok = sel[ok]
    nodes_ok = nodes_sel[ok].astype(np.int64)
    if sel_ok.size == 0:
        return np.unique(np.concatenate(bad_parts)), reasons

    feas = group_feas[task_group[sel_ok], nodes_ok] & node_ok[nodes_ok]
    P = len(pair_idx)
    if P:
        pos = np.clip(np.searchsorted(pair_idx, sel_ok), 0, P - 1)
        has_pair = pair_idx[pos] == sel_ok
        if has_pair.any():
            feas = feas.copy()
            feas[has_pair] &= pair_rows[pos[has_pair], nodes_ok[has_pair]]
    infeasible = ~feas
    if infeasible.any():
        bad_parts.append(sel_ok[infeasible])
        reasons["infeasible"] = int(infeasible.sum())

    # Capacity recount with a generous slack (per-task eps x count), so
    # a legitimate solve's rounding never trips it; every placement on
    # an overfull node is flagged.
    feas_sel = sel_ok[feas]
    feas_nodes = nodes_ok[feas]
    if feas_sel.size:
        req_rows = task_req[feas_sel].astype(np.float64)
        R = req_rows.shape[1]
        bins = np.empty((N, R), dtype=np.float64)
        for r in range(R):
            bins[:, r] = np.bincount(
                feas_nodes, weights=req_rows[:, r], minlength=N
            )[:N]
        counts = np.bincount(feas_nodes, minlength=N)[:N].astype(np.float64)
        slack = np.outer(np.maximum(counts, 1.0) + 1.0, eps)
        overfull = (bins > node_idle[:N].astype(np.float64) + slack).any(1)
        if overfull.any():
            on_overfull = overfull[feas_nodes]
            if on_overfull.any():
                bad_parts.append(feas_sel[on_overfull])
                reasons["capacity"] = int(on_overfull.sum())

    if not bad_parts:
        return np.empty(0, dtype=np.int64), {}
    return np.unique(np.concatenate(bad_parts)), reasons
