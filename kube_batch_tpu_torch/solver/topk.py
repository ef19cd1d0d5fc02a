"""Phase 1 of the candidate-sparsified solve: top-K node selection.

A copy of the host NumPy selection in ``kube_batch_tpu/solver/topk.py``
(``topk_config`` and ``select_candidates``). Tasks that share a score
surface (feasibility group, req/fit rows, no private rows) form one
candidate CLASS; one fused feasibility + initial-idle score pass keeps
each class's top-K nodes, and the solver's rounds then run on gathered
[T, K] slabs. A class whose eligible set (feasible, fitting at initial
idle, pod-count capacity open) has at most K nodes gets a complete slab
(``cand_info[0]``, the refill gauge).

Device-resident selection and the cross-cycle selection cache are later
slices; this module always runs the full host computation, which the
JAX package's cached and device paths are bit-equal to.

``KBT_SOLVER_TOPK`` overrides the policy: an integer forces that K at
any problem size; ``0``/``off``/``dense`` disables sparsification.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np

from .kernels import (
    _KEY_BIAS,
    _KEY_HASH_BITS,
    CPU_DIM,
    MAX_PRIORITY,
    MEM_DIM,
    SCORE_QUANTUM,
)

_SPARSE_MIN_TASKS = 64
_SPARSE_MIN_CELLS = 1 << 20
_SPARSE_MIN_NODES = 1024
DEFAULT_K = 64

# Selection costs O(C * N); past this budget class dedup has degenerated
# and the policy falls back to dense.
_CLASS_BUDGET_FACTOR = 4

# Deterministic top-K tie rule: larger key first, equal keys -> smaller
# node id, via the int64 composite ``(skey << 31) + (2^31-1 - node_id)``.
_TIE_BITS = 31


@dataclass(frozen=True)
class TopKConfig:
    """Resolved candidate-sparsification policy for one snapshot."""

    k: int
    enabled: bool
    reason: str


def _pow2(n: int) -> int:
    if n <= 0:
        return 1
    return 1 << (n - 1).bit_length()


def topk_config(n_tasks: int, n_nodes: int) -> TopKConfig:
    """Resolve K and the sparse on/off decision for a (T, N) snapshot."""
    raw = os.environ.get("KBT_SOLVER_TOPK", "").strip().lower()
    if raw in ("0", "off", "dense", "disable", "disabled", "false"):
        return TopKConfig(0, False, "env-disabled")
    k = DEFAULT_K
    forced = False
    if raw:
        try:
            k = max(1, int(raw))
            forced = True
        except ValueError:
            pass
    k = _pow2(k)
    if forced:
        return TopKConfig(k, True, "env-forced")
    if (
        n_tasks < _SPARSE_MIN_TASKS
        or n_nodes < _SPARSE_MIN_NODES
        or n_tasks * n_nodes < _SPARSE_MIN_CELLS
    ):
        return TopKConfig(k, False, "small-problem")
    if 4 * k >= n_nodes:
        return TopKConfig(k, False, "k-covers-nodes")
    return TopKConfig(k, True, "size-policy")


@dataclass
class CandidateSet:
    """Selection output, pre-padding (node sentinel = N unpadded)."""

    task_cand: np.ndarray    # i32[T] class id per task
    cand_idx: np.ndarray     # i32[C, K] candidate node ids ascending
    cand_static: np.ndarray  # f32[C, K] static score slab
    cand_info: np.ndarray    # i32[3, C] total / any_feas / fits_releasing
    stats: dict


def _sel_hash(c_ids: np.ndarray, n_ids: np.ndarray) -> np.ndarray:
    """Decorrelated per-(class, node) hash in [0, 1024)."""
    x = (c_ids.astype(np.uint32) * np.uint32(2654435761)) ^ (
        n_ids.astype(np.uint32) * np.uint32(0x9E3779B9)
    )
    x = x ^ (x >> np.uint32(13))
    x = x * np.uint32(2246822519)
    return (
        (x >> np.uint32(8)) & np.uint32((1 << _KEY_HASH_BITS) - 1)
    ).astype(np.int64)


def _dyn_score_np(req, idle, cap, lr_w, br_w):
    """[C, N] LeastRequested + Balanced in float32 NumPy, per-dimension
    2-D passes (selection quality only; rounds rescore on the device)."""
    ten = np.float32(MAX_PRIORITY)
    lr_acc = None
    fracs = []
    over = None
    for d in (CPU_DIM, MEM_DIM):
        req_d = req[:, d:d + 1].astype(np.float32)
        idle_d = idle[None, :, d].astype(np.float32)
        cap_d = cap[None, :, d].astype(np.float32)
        pos = cap_d > 0
        safe_cap = np.where(pos, cap_d, np.float32(1.0))
        remaining = idle_d - req_d
        lr = np.where(
            pos, np.maximum(remaining, 0.0) * ten / safe_cap,
            np.float32(0.0),
        )
        lr_acc = lr if lr_acc is None else lr_acc + lr
        frac = np.where(pos, 1.0 - remaining / safe_cap, np.float32(1.0))
        fracs.append(frac)
        o = frac >= 1.0
        over = o if over is None else (over | o)
    lr_score = lr_acc * np.float32(0.5)
    diff = np.abs(fracs[0] - fracs[1])
    br_score = np.where(over, np.float32(0.0), ten - diff * ten)
    return (
        np.float32(lr_w) * lr_score + np.float32(br_w) * br_score
    ).astype(np.float32)


def _quantized_keys(score, elig, class_ids, cols):
    q = np.clip(
        np.round(score / np.float32(SCORE_QUANTUM)).astype(np.int64)
        + _KEY_BIAS,
        0, (1 << 20) - 1,
    )
    skey = (q << _KEY_HASH_BITS) | _sel_hash(
        np.asarray(class_ids, np.int64)[:, None],
        np.asarray(cols, np.int64)[None, :],
    )
    return np.where(elig, skey, -1)


def _skey_block(req_rows, fit_rows, class_ids, cols,
                idle32, cap32, eps32, cap_ok0, feas_cols, lr_w, br_w):
    """Integer selection keys for ``class_ids`` x ``cols``:
    eligibility-masked quantized score + class/node hash."""
    R = req_rows.shape[1]
    idle_c = idle32[cols]
    cap_c = cap32[cols]
    fit_ok = np.ones((req_rows.shape[0], len(cols)), dtype=bool)
    for d in range(R):
        fit_ok &= fit_rows[:, d:d + 1] - idle_c[None, :, d] < eps32[d]
    elig = feas_cols & fit_ok & cap_ok0[cols][None, :]
    score = _dyn_score_np(req_rows, idle_c, cap_c, lr_w, br_w)
    return _quantized_keys(score, elig, class_ids, cols)


def _skey_priv_row(req_row, fit_row, class_id,
                   idle32, cap32, eps32, cap_ok0, feas_row, srow,
                   lr_w, br_w):
    """One class's key row with its private static score row folded in
    before quantization."""
    R = req_row.shape[1]
    N = idle32.shape[0]
    fit_ok = np.ones((1, N), dtype=bool)
    for d in range(R):
        fit_ok &= fit_row[:, d:d + 1] - idle32[None, :, d] < eps32[d]
    elig = feas_row & fit_ok & cap_ok0[None, :]
    score = _dyn_score_np(req_row, idle32, cap32, lr_w, br_w) + srow
    return _quantized_keys(
        score, elig, [class_id], np.arange(N, dtype=np.int64)
    )[0]


def select_candidates(
    mask,                         # masks.CombinedMask (unpadded)
    score_rows_map: Dict[int, np.ndarray],
    task_req: np.ndarray,         # f32[T, R] rank-ordered
    task_fit: np.ndarray,         # f32[T, R]
    node_idle: np.ndarray,        # [N, R]
    node_cap: np.ndarray,         # [N, R]
    node_releasing: np.ndarray,   # [N, R]
    node_task_count: np.ndarray,  # i32[N]
    node_max_tasks: np.ndarray,   # i32[N]
    eps: np.ndarray,              # [R]
    lr_weight: float,
    br_weight: float,
    k: int,
) -> Optional[CandidateSet]:
    """Run the fused feasibility + static-score selection pass.

    Returns None (dense solve) when class dedup degenerates past the
    selection budget."""
    T, R = task_req.shape
    N = node_idle.shape[0]
    k = min(_pow2(k), _pow2(N))

    # ---- class dedup: (feasibility group, private-row id, req, fit) ----
    priv = np.full(T, -1, np.int64)
    if len(mask.pair_idx):
        priv[mask.pair_idx] = mask.pair_idx
    for i in score_rows_map:
        priv[int(i)] = int(i)
    key_mat = np.column_stack([
        mask.task_group.astype(np.float32),
        priv.astype(np.float32),
        task_req.astype(np.float32),
        task_fit.astype(np.float32),
    ])
    _, rep_idx, task_cand = np.unique(
        key_mat, axis=0, return_index=True, return_inverse=True
    )
    task_cand = task_cand.reshape(-1).astype(np.int32)
    rep_idx = rep_idx.astype(np.int64)
    C = len(rep_idx)
    if C * N > max(_CLASS_BUDGET_FACTOR * T * k, 1 << 22):
        return None

    idle32 = np.ascontiguousarray(node_idle, np.float32)
    cap32 = np.ascontiguousarray(node_cap, np.float32)
    eps32 = np.asarray(eps, np.float32)
    cap_ok0 = (node_max_tasks == 0) | (node_task_count < node_max_tasks)
    has_releasing = bool(np.asarray(node_releasing).any())
    rel32 = (
        np.ascontiguousarray(node_releasing, np.float32)
        if has_releasing else None
    )
    rep_fit = task_fit[rep_idx].astype(np.float32)
    rep_req = task_req[rep_idx].astype(np.float32)
    rep_priv = priv[rep_idx]

    cand_idx = np.full((C, k), N, np.int32)
    cand_static = np.zeros((C, k), np.float32)
    cand_info = np.zeros((3, C), np.int32)

    node_ids = np.arange(N, dtype=np.int64)
    # Composite tie term: smaller node id -> larger low bits.
    tie_lo = (np.int64(1) << _TIE_BITS) - 1 - node_ids
    chunk = max(1, min(C, (1 << 22) // max(N, 1)))
    for c0 in range(0, C, chunk):
        c1 = min(c0 + chunk, C)
        rows = c1 - c0
        feas = mask.rows_for(rep_idx[c0:c1])                 # [rows, N]
        fit_chunk = rep_fit[c0:c1]
        req_chunk = rep_req[c0:c1]

        skey = np.empty((rows, N), dtype=np.int64)
        srows = {}
        plain = []
        for local in range(rows):
            p = int(rep_priv[c0 + local])
            if p >= 0 and p in score_rows_map:
                # Singleton classes keep their private static rows: the
                # slab ships the gathered values, the key folds them in.
                srow = np.asarray(score_rows_map[p], np.float32)
                srows[local] = srow
                skey[local] = _skey_priv_row(
                    req_chunk[local:local + 1],
                    fit_chunk[local:local + 1], c0 + local,
                    idle32, cap32, eps32, cap_ok0,
                    feas[local:local + 1], srow,
                    lr_weight, br_weight,
                )
            else:
                plain.append(local)
        if plain:
            full = _skey_block(
                req_chunk[plain], fit_chunk[plain],
                [c0 + lo for lo in plain], node_ids,
                idle32, cap32, eps32, cap_ok0, feas[plain],
                lr_weight, br_weight,
            )
            for i, local in enumerate(plain):
                skey[local] = full[i]

        elig_count = (skey >= 0).sum(axis=1)
        cand_info[0, c0:c1] = np.minimum(elig_count, np.iinfo(np.int32).max)
        cand_info[1, c0:c1] = (feas & cap_ok0[None, :]).any(axis=1)
        if has_releasing:
            rel_ok = np.ones((rows, N), dtype=bool)
            for d in range(R):
                rel_ok &= (
                    fit_chunk[:, d:d + 1] - rel32[None, :, d] < eps32[d]
                )
            cand_info[2, c0:c1] = (rel_ok & feas).any(axis=1)

        if k < N:
            skey2 = (skey << _TIE_BITS) + tie_lo[None, :]
            part = np.argpartition(skey2, N - k, axis=1)[:, N - k:]
            pkey = np.take_along_axis(skey2, part, axis=1)
        else:
            part = np.broadcast_to(node_ids[None, :], (rows, N)).copy()
            pkey = np.take_along_axis(skey, part, axis=1)
        part = part.astype(np.int32)
        part[pkey < 0] = N           # ineligible picks -> sentinel
        part.sort(axis=1)            # ascending node id, sentinels last
        cand_idx[c0:c1, : part.shape[1]] = part[:, :k]
        for local, srow in srows.items():
            row = cand_idx[c0 + local]
            sel = row < N
            cand_static[c0 + local, sel] = srow[row[sel]]

    slab_bytes = (
        cand_idx.nbytes + cand_static.nbytes + cand_info.nbytes
        + task_cand.nbytes
    )
    stats = {
        "classes": int(C),
        "k": int(k),
        "slab_bytes": int(slab_bytes),
        "dense_mask_bytes": int(T) * int(N),
        "dense_score_bytes": int(T) * int(N) * 4,
        "truncated_classes": int((cand_info[0] > k).sum()),
        "select_path": "host",
    }
    return CandidateSet(task_cand, cand_idx, cand_static, cand_info, stats)
