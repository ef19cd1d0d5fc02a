"""Factorized feasibility mask (host side).

A copy of ``CombinedMask`` from ``kube_batch_tpu/solver/masks.py``, the
part candidate selection reads: the full [T, N] mask is
``node_ok[j] AND group_rows[task_group[i], j] AND pair_rows[i][j]``
(private rows only for the tasks in ``pair_idx``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class CombinedMask:
    node_ok: np.ndarray      # bool[N]
    task_group: np.ndarray   # int32[T]
    group_rows: np.ndarray   # bool[G, N]
    pair_idx: np.ndarray     # int32[P] sorted unique
    pair_rows: np.ndarray    # bool[P, N]

    def rows_for(self, task_ids: np.ndarray) -> np.ndarray:
        """Full feasibility rows for a batch of task indices, [B, N]."""
        task_ids = np.asarray(task_ids, np.int64)
        out = self.group_rows[self.task_group[task_ids]] & self.node_ok
        P = len(self.pair_idx)
        if P:
            pos = np.clip(np.searchsorted(self.pair_idx, task_ids), 0, P - 1)
            match = self.pair_idx[pos] == task_ids
            if match.any():
                out = out & np.where(
                    match[:, None], self.pair_rows[pos], True
                )
        return out
