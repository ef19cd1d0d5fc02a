"""ctypes wrapper for csrc/greedy.cpp, the native CPU floor.

A copy of the reference's ``native/greedy.py`` with its C++ source and
Makefile (``csrc/``). This is the degradation ladder's last rung and the
``KBT_SOLVER=native`` route, not a kernel of the card. ``make`` builds
``libgreedy.so`` into ``csrc/build/`` (ignored by git) at first use, in
a scratch directory that is renamed into place, so processes that build
at once never load a half-written library. numpy in, numpy out; see
greedy.cpp for semantics.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from typing import Optional, Tuple

import numpy as np

from ..utils.lockdebug import wrap_lock

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
_BUILD_DIR = os.path.join(_NATIVE_DIR, "build")

_lock = wrap_lock("native.loader")
_lib: Optional[ctypes.CDLL] = None
_load_error: Optional[str] = None


class NativeUnavailable(RuntimeError):
    """The native library could not be built/loaded on this host."""


def _load() -> ctypes.CDLL:
    global _lib, _load_error
    with _lock:
        if _lib is not None:
            return _lib
        if _load_error is not None:
            raise NativeUnavailable(_load_error)
        src = os.path.join(_NATIVE_DIR, "greedy.cpp")
        so_path = os.path.join(_BUILD_DIR, "libgreedy.so")
        try:
            stale = not os.path.exists(so_path) or (
                os.path.getmtime(so_path) < os.path.getmtime(src)
            )
            if stale:
                scratch = os.path.join(_BUILD_DIR, f".tmp-{os.getpid()}")
                try:
                    subprocess.run(
                        ["make", "-B", "-C", _NATIVE_DIR, f"BUILD={scratch}"],
                        check=True, capture_output=True, text=True,
                    )
                    os.replace(
                        os.path.join(scratch, "libgreedy.so"), so_path
                    )
                finally:
                    shutil.rmtree(scratch, ignore_errors=True)
            lib = ctypes.CDLL(so_path)
        except (OSError, subprocess.CalledProcessError) as e:
            detail = getattr(e, "stderr", "") or str(e)
            _load_error = f"native greedy unavailable: {detail}"
            raise NativeUnavailable(_load_error) from e
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        lib.greedy_allocate.restype = ctypes.c_int64
        lib.greedy_allocate.argtypes = [
            f32p, i32p, f32p, f32p, f32p, f32p, f32p,
            ctypes.c_double, ctypes.c_double,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            i32p,
        ]
        lib.greedy_allocate_masked.restype = ctypes.c_int64
        lib.greedy_allocate_masked.argtypes = [
            f32p, f32p, i32p, i32p, u8p, i32p,      # task req/fit/queue/job/valid/group
            u8p, u8p,                               # node_feas, group_feas
            i32p, u8p,                              # pair_idx, pair_feas
            i32p, f32p,                             # score_idx, score_rows
            f32p, f32p, i32p, i32p,                 # node idle/cap/task_count/max_tasks
            f32p, f32p, f32p,                       # queue deserved/alloc, eps
            ctypes.c_double, ctypes.c_double,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            i32p,
        ]
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        lib.greedy_allocate_sparse.restype = ctypes.c_int64
        lib.greedy_allocate_sparse.argtypes = [
            f32p, f32p, i32p, i32p, u8p, i32p,      # task req/fit/queue/job/valid/group
            u8p, u8p,                               # node_feas, group_feas
            i32p, u8p,                              # pair_idx, pair_feas
            i32p, f32p,                             # score_idx, score_rows
            f32p, f32p, i32p, i32p,                 # node idle/cap/task_count/max_tasks
            f32p, f32p, f32p,                       # queue deserved/alloc, eps
            ctypes.c_double, ctypes.c_double,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            i32p, i32p, f32p, i32p, i32p,           # task_cand, cand slabs
            ctypes.c_int64, ctypes.c_int64,         # C, K
            i64p,                                   # out_stats[4]
            i32p,
        ]
        _lib = lib
        return lib


def native_available() -> bool:
    try:
        _load()
        return True
    except NativeUnavailable:
        return False


def greedy_allocate(
    task_req: np.ndarray,       # f32[T, R]
    task_queue: np.ndarray,     # i32[T]
    node_idle: np.ndarray,      # f32[N, R]
    node_cap: np.ndarray,       # f32[N, R]
    queue_deserved: np.ndarray, # f32[Q, R]
    queue_allocated: np.ndarray,# f32[Q, R]
    eps: np.ndarray,            # f32[R]
    lr_weight: float = 1.0,
    br_weight: float = 1.0,
) -> Tuple[np.ndarray, int]:
    """Run the native greedy loop; returns (assignment i32[T], placed)."""
    lib = _load()
    task_req = np.ascontiguousarray(task_req, np.float32)
    task_queue = np.ascontiguousarray(task_queue, np.int32)
    node_idle = np.ascontiguousarray(node_idle, np.float32)
    node_cap = np.ascontiguousarray(node_cap, np.float32)
    queue_deserved = np.ascontiguousarray(queue_deserved, np.float32)
    queue_allocated = np.ascontiguousarray(queue_allocated, np.float32)
    eps = np.ascontiguousarray(eps, np.float32)
    T, R = task_req.shape
    N = node_idle.shape[0]
    Q = queue_deserved.shape[0]
    out = np.empty(T, dtype=np.int32)
    placed = lib.greedy_allocate(
        task_req, task_queue, node_idle, node_cap,
        queue_deserved, queue_allocated, eps,
        float(lr_weight), float(br_weight),
        T, N, Q, R, out,
    )
    return out, int(placed)


# Forensics of the most recent solve_native (sparse engagement + refill
# counts for bench/metrics attribution). Single-threaded by construction,
# like actions.allocate_tpu.last_stats (one in-flight native solve).
last_solve_stats: dict = {}


def solve_native(inputs) -> Tuple[np.ndarray, int]:
    """Production CPU fallback: run greedy.cpp's feasibility-aware loop
    on a host solver bundle (``ctx.host_inputs``) — the candidate-sparsified
    ``greedy_allocate_sparse`` when the snapshot carries top-K candidate
    slabs (solver/topk.py), ``greedy_allocate_masked`` otherwise.

    Consumes the SAME factorized snapshot the device solve consumes —
    predicate groups/pairs, init-resreq fit vs resreq subtract, static
    score rows, queue budgets, pod-count caps, and the reference's
    job-break semantics (allocate.go:144-148). Returns
    ``(assignment i32[T], placed)`` with node indices into the unfiltered
    (padded) node table, matching ``SolverResult.assigned``'s contract so
    ``allocate_tpu`` can apply either interchangeably. Sparse-path
    forensics (refill rounds, fallback scans) land in
    :data:`last_solve_stats`."""
    lib = _load()
    # PackedInputs (the transfer bundle) or bare SolverInputs.
    s = inputs.unpack() if hasattr(inputs, "unpack") else inputs

    def f32(a):
        return np.ascontiguousarray(np.asarray(a), np.float32)

    def i32(a):
        return np.ascontiguousarray(np.asarray(a), np.int32)

    def u8(a):
        return np.ascontiguousarray(np.asarray(a), np.uint8)

    task_req, task_fit = f32(s.task_req), f32(s.task_fit)
    T, R = task_req.shape
    node_idle, node_cap = f32(s.node_idle), f32(s.node_cap)
    N = node_idle.shape[0]
    queue_deserved = f32(s.queue_deserved)
    Q = queue_deserved.shape[0]
    group_feas = u8(s.group_feas)
    pair_idx, pair_feas = i32(s.pair_idx), u8(s.pair_feas)
    score_idx, score_rows = i32(s.score_idx), f32(s.score_rows)
    out = np.empty(T, dtype=np.int32)
    last_solve_stats.clear()

    cand_idx = getattr(s, "cand_idx", None)
    task_cand = getattr(s, "task_cand", None)
    sparse = (
        cand_idx is not None
        and task_cand is not None
        and np.asarray(cand_idx).shape[0] > 0
    )
    if sparse:
        cand_idx = i32(cand_idx)
        C, K = cand_idx.shape
        cand_static = f32(s.cand_static)
        cand_info = i32(s.cand_info)
        stats = np.zeros(4, dtype=np.int64)
        placed = lib.greedy_allocate_sparse(
            task_req, task_fit, i32(s.task_queue), i32(s.task_job),
            u8(s.task_valid), i32(s.task_group),
            u8(s.node_feas), group_feas,
            pair_idx, pair_feas,
            score_idx, score_rows,
            node_idle, node_cap, i32(s.node_task_count),
            i32(s.node_max_tasks),
            queue_deserved, f32(s.queue_allocated), f32(s.eps),
            float(np.asarray(s.lr_weight)), float(np.asarray(s.br_weight)),
            T, N, Q, R,
            group_feas.shape[0], pair_idx.shape[0], score_idx.shape[0],
            i32(task_cand), cand_idx,
            np.ascontiguousarray(cand_static),
            np.ascontiguousarray(cand_info[0]),
            np.ascontiguousarray(cand_info[1]),
            C, K,
            stats,
            out,
        )
        last_solve_stats.update(
            sparse=True, k=int(K), classes=int(C),
            refill_rounds=int(stats[0]), fallback_scans=int(stats[1]),
            class_inits=int(stats[2]), widened=int(stats[3]),
        )
        return out, int(placed)

    placed = lib.greedy_allocate_masked(
        task_req, task_fit, i32(s.task_queue), i32(s.task_job),
        u8(s.task_valid), i32(s.task_group),
        u8(s.node_feas), group_feas,
        pair_idx, pair_feas,
        score_idx, score_rows,
        node_idle, node_cap, i32(s.node_task_count), i32(s.node_max_tasks),
        queue_deserved, f32(s.queue_allocated), f32(s.eps),
        float(np.asarray(s.lr_weight)), float(np.asarray(s.br_weight)),
        T, N, Q, R,
        group_feas.shape[0], pair_idx.shape[0], score_idx.shape[0],
        out,
    )
    last_solve_stats.update(sparse=False)
    return out, int(placed)
