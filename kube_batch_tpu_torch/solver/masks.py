"""Compact host↔device feasibility/score representations.

At 50k tasks × 5k nodes a dense [T, N] host mask is 250 MB (and a dense f32
score matrix 1 GB) — allocating and shipping those per cycle dominated the
snapshot path. But predicate structure is low-rank: most checks are
node-level (conditions, unschedulable, pressure — one [N] column mask) or
shared across every task with the same pod template (tolerations, node
selectors — a handful of [N] group rows), and only a few tasks need private
rows (host ports, inter-pod affinity). ``BatchMask`` captures exactly that
factorization; the full [T, N] mask is materialized on-device by the solver
(kernels.solve) from O(T + G·N + P·N) parts.

Scores factor the same way: LeastRequested/Balanced are recomputed in-kernel
from idle vectors; only affinity scorers contribute static per-task rows.

Plugins may still return a plain dense ``np.ndarray [T, N]`` from their batch
fns (the compatibility path, used by custom plugins and tests); it is folded
in as per-task rows.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np


@dataclass
class BatchMask:
    """Factorized [T, N] boolean feasibility mask.

    full[i, j] = node_ok[j] AND group_rows[task_group[i], j] AND rows[i][j]
    (missing parts default to True).
    """

    node_ok: Optional[np.ndarray] = None       # bool[N]
    task_group: Optional[np.ndarray] = None    # int32[T]
    group_rows: Optional[np.ndarray] = None    # bool[G, N]
    rows: Dict[int, np.ndarray] = field(default_factory=dict)  # i -> bool[N]

    def dense(self, T: int, N: int) -> np.ndarray:
        """Materialize the full mask (tests / small fallbacks only)."""
        out = np.ones((T, N), dtype=bool)
        if self.node_ok is not None:
            out &= self.node_ok[None, :]
        if self.task_group is not None and self.group_rows is not None:
            out &= self.group_rows[self.task_group]
        for i, row in self.rows.items():
            out[i] &= row
        return out


@dataclass
class CombinedMask:
    """AND-combination of several BatchMasks, ready for the device."""

    node_ok: np.ndarray                        # bool[N]
    task_group: np.ndarray                     # int32[T]
    group_rows: np.ndarray                     # bool[G, N]
    pair_idx: np.ndarray                       # int32[P] sorted unique
    pair_rows: np.ndarray                      # bool[P, N]

    def row(self, i: int) -> np.ndarray:
        """Full feasibility row for task i (host-side epilogue use)."""
        out = self.group_rows[self.task_group[i]] & self.node_ok
        p = np.searchsorted(self.pair_idx, i)
        if p < len(self.pair_idx) and self.pair_idx[p] == i:
            out = out & self.pair_rows[p]
        return out

    def rows_for(self, task_ids: np.ndarray) -> np.ndarray:
        """Full feasibility rows for a batch of task indices — [B, N],
        the vectorized :meth:`row`. This is the candidate-column mask
        the top-K selection pass (solver/topk.py) scores classes
        against: one representative row per candidate class instead of
        a dense [T, N] materialization."""
        task_ids = np.asarray(task_ids, np.int64)
        out = self.group_rows[self.task_group[task_ids]] & self.node_ok
        P = len(self.pair_idx)
        if P:
            pos = np.clip(
                np.searchsorted(self.pair_idx, task_ids), 0, P - 1
            )
            match = self.pair_idx[pos] == task_ids
            if match.any():
                out = out & np.where(
                    match[:, None], self.pair_rows[pos], True
                )
        return out


def combine_masks(masks: List, T: int, N: int) -> CombinedMask:
    """AND together BatchMasks (or legacy dense [T, N] arrays)."""
    node_ok = np.ones(N, dtype=bool)
    group_parts: List[Tuple[np.ndarray, np.ndarray]] = []
    rows: Dict[int, np.ndarray] = {}

    def add_row(i: int, row: np.ndarray) -> None:
        cur = rows.get(i)
        rows[i] = row.copy() if cur is None else (cur & row)

    for m in masks:
        if isinstance(m, np.ndarray):
            # Legacy dense mask: deduplicate identical rows into a group
            # part (exact, and compact whenever pod templates repeat).
            combos, inv = np.unique(
                np.asarray(m, bool), axis=0, return_inverse=True
            )
            group_parts.append((inv.reshape(-1).astype(np.int64), combos))
            continue
        if m.node_ok is not None:
            node_ok &= m.node_ok
        if m.task_group is not None and m.group_rows is not None:
            group_parts.append(
                (np.asarray(m.task_group, np.int64), m.group_rows)
            )
        for i, row in m.rows.items():
            add_row(int(i), np.asarray(row, bool))

    if group_parts:
        key = np.stack([tg for tg, _ in group_parts], axis=1)    # [T, k]
        combos, task_group = np.unique(key, axis=0, return_inverse=True)
        group_rows = np.ones((len(combos), N), dtype=bool)
        for k, (_, gr) in enumerate(group_parts):
            group_rows &= gr[combos[:, k]]
        task_group = task_group.astype(np.int32)
    else:
        task_group = np.zeros(T, dtype=np.int32)
        group_rows = np.ones((1, N), dtype=bool)

    if rows:
        pair_idx = np.asarray(sorted(rows), dtype=np.int32)
        pair_rows = np.stack([rows[int(i)] for i in pair_idx])
    else:
        pair_idx = np.zeros((0,), dtype=np.int32)
        pair_rows = np.zeros((0, N), dtype=bool)
    return CombinedMask(node_ok, task_group, group_rows, pair_idx, pair_rows)


def combine_score_rows(
    parts: List[Tuple[object, float]], T: int, N: int
) -> Dict[int, np.ndarray]:
    """Weighted sum of sparse score contributions.

    Each part is (result, weight) where result is a dict {task_i: f32[N]}
    or a legacy dense [T, N] ndarray.
    """
    rows: Dict[int, np.ndarray] = {}

    def add(i: int, row: np.ndarray, w: float) -> None:
        cur = rows.get(i)
        contrib = w * np.asarray(row, np.float32)
        rows[i] = contrib if cur is None else cur + contrib

    for result, weight in parts:
        if result is None:
            continue
        if isinstance(result, np.ndarray):
            for i in np.nonzero(np.any(result != 0.0, axis=1))[0]:
                add(int(i), result[i], weight)
        else:
            for i, row in result.items():
                add(int(i), row, weight)
    return rows
