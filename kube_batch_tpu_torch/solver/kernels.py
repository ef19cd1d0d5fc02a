"""Batched assignment solver on PyTorch tensors.

Counterpart of ``kube_batch_tpu/solver/kernels.py``: the same round-based
batched greedy (epsilon fit against current idle, LeastRequested +
Balanced scores plus static rows, integer bid keys, row argmax, conflict
resolution by lexicographic sort and segmented prefix sums, task-order
commit), with the same dense, staged and sparse solvers and the same
dispatch by snapshot shape. Every function takes and returns tensors on
one device; nothing here chooses the device (see ``device.py`` and
``snapshot.pack_inputs``).

The results are bit-equal to the JAX package as XLA compiles it on the
CPU, which fixes a few numeric details that a straight transcription
would miss:

- XLA contracts two multiply-adds of the score into fused multiply-adds
  (``10 - diff*10`` and ``lr_w*lr + br_w*br``); :func:`_fma_f32` gives
  the same single rounding here, on any device.
- XLA rewrites ``score / SCORE_QUANTUM`` as ``score * 50.0``; the keys
  here multiply by the same constant.
- ``lax.associative_scan`` fixes the association of the segmented
  prefix sums; :func:`_associative_scan` repeats its odd/even recursion,
  and on the card :func:`segmented_cumsum`'s kernel (``csrc/scan.cu``)
  computes the same tree in one launch.
- ``segment_sum`` adds in task order; :func:`_segment_sum` folds each
  segment in task order with ``torch.segment_reduce``, never with
  atomics.
- ``lax.sort`` over (key, rank) and ``lax.top_k``'s lower-index rule
  become stable sorts on composite integer keys.

``lax.while_loop`` becomes a Python loop that reads one flag from the
device per round. With tracing on, each round runs under a
``solve.round`` span and its blocking read of that flag under a
``solve.sync`` child, so the spans of a solve number its ``rounds``;
each compacted stage of the dense tail runs under ``solve.tail``, and
the full dense solve's preparation (the [T, N] feasibility and static
score matrices and the Releasing-capacity escape) under ``solve.prep``.
A dense solve's result counts its ``bid_dense`` passes and the shape
they saw (:class:`BidDenseLaunches`).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..obs.tracer import span

# Resource-dimension layout contract (dimension 0 milli-CPU, 1 MiB).
CPU_DIM = 0
MEM_DIM = 1

MAX_PRIORITY = 10.0

# Bid keys: quantized score in the high bits, a per-(task, node) hash in
# the low bits (the batched form of the reference's random pick among
# equal-scored nodes).
SCORE_QUANTUM = 0.02
_KEY_HASH_BITS = 10
_KEY_BIAS = 1 << 19
_KEY_MAX = (1 << 20) - 1
# The JAX package divides by SCORE_QUANTUM; XLA folds that division into
# a multiplication by the float32 reciprocal, which rounds to exactly 50.
_INV_QUANTUM = 50.0

# Largest resource-dimension count the CUDA kernels take (the bid
# kernels hold a task's fit row in registers).
MAX_R = 8

# Conflict-resolution commits per score pass of the plain chain.
COMMITS_PER_ROUND = 6

INT_MAX = int(np.iinfo(np.int32).max)
_U32 = 0xFFFFFFFF


class SolverInputs(NamedTuple):
    """Dense snapshot of one scheduling session, as torch tensors.

    Shapes: T tasks, N nodes, R resource dims, Q queues, G feasibility
    groups, P private-row tasks, S static-score rows, C candidate
    classes, K candidate width. Padded tasks have ``task_valid`` False,
    padded nodes ``node_feas`` False. The [T, N] mask and static scores
    are factorized and built on the device (:func:`build_feasibility`,
    :func:`build_static_score`).
    """

    task_req: torch.Tensor        # f32[T, R] resreq (subtracted on allocate)
    task_fit: torch.Tensor        # f32[T, R] init_resreq (fit checks)
    task_rank: torch.Tensor       # i32[T] global priority rank, smaller first
    task_job: torch.Tensor        # i32[T] dense job index (< T)
    task_queue: torch.Tensor      # i32[T] queue index
    task_valid: torch.Tensor      # bool[T] False for padding rows
    task_group: torch.Tensor      # i32[T] feasibility group per task
    node_feas: torch.Tensor       # bool[N] node-level predicate column
    group_feas: torch.Tensor      # bool[G, N] per-group node masks
    pair_idx: torch.Tensor        # i32[P] tasks with private rows
    pair_feas: torch.Tensor       # bool[P, N]
    score_idx: torch.Tensor       # i32[S] tasks with static score rows
    score_rows: torch.Tensor      # f32[S, N]
    node_idle: torch.Tensor       # f32[N, R]
    node_releasing: torch.Tensor  # f32[N, R]
    node_cap: torch.Tensor        # f32[N, R] allocatable
    node_task_count: torch.Tensor # i32[N]
    node_max_tasks: torch.Tensor  # i32[N] 0 = unlimited
    queue_deserved: torch.Tensor  # f32[Q, R] +inf where proportion is off
    queue_allocated: torch.Tensor # f32[Q, R]
    eps: torch.Tensor             # f32[R]
    lr_weight: torch.Tensor       # f32[] LeastRequested weight
    br_weight: torch.Tensor       # f32[] BalancedResourceAllocation weight
    task_cand: Optional[torch.Tensor] = None    # i32[T] candidate class
    cand_idx: Optional[torch.Tensor] = None     # i32[C, K] node ids, >= N pad
    cand_static: Optional[torch.Tensor] = None  # f32[C, K]
    cand_info: Optional[torch.Tensor] = None    # i32[3, C]


class PackedInputs(NamedTuple):
    """Stacked form of :class:`SolverInputs` (the JAX package's
    transfer layout): a handful of buffers, carved by :meth:`unpack`."""

    task_f32: torch.Tensor   # [2, T, R] req, fit
    task_i32: torch.Tensor   # [6, T] rank, queue, job, group, valid, cand
    node_f32: torch.Tensor   # [3, N, R] idle, releasing, cap
    node_i32: torch.Tensor   # [3, N] task_count, max_tasks, feas
    group_feas: torch.Tensor # bool[G, N]
    pair_idx: torch.Tensor   # i32[P]
    pair_feas: torch.Tensor  # bool[P, N]
    score_idx: torch.Tensor  # i32[S]
    score_rows: torch.Tensor # f32[S, N]
    queue_f32: torch.Tensor  # [2, Q, R] deserved, allocated
    misc: torch.Tensor       # f32[R + 2] eps, lr_weight, br_weight
    cand_idx: Optional[torch.Tensor] = None     # i32[C, K]
    cand_static: Optional[torch.Tensor] = None  # f32[C, K]
    cand_info: Optional[torch.Tensor] = None    # i32[3, C]

    def unpack(self) -> SolverInputs:
        R = self.task_f32.shape[2]
        task_cand = (
            self.task_i32[5] if self.task_i32.shape[0] > 5 else None
        )
        return SolverInputs(
            task_req=self.task_f32[0],
            task_fit=self.task_f32[1],
            task_rank=self.task_i32[0],
            task_queue=self.task_i32[1],
            task_job=self.task_i32[2],
            task_group=self.task_i32[3],
            task_valid=self.task_i32[4].bool(),
            task_cand=task_cand,
            cand_idx=self.cand_idx,
            cand_static=self.cand_static,
            cand_info=self.cand_info,
            node_feas=self.node_i32[2].bool(),
            group_feas=self.group_feas,
            pair_idx=self.pair_idx,
            pair_feas=self.pair_feas,
            score_idx=self.score_idx,
            score_rows=self.score_rows,
            node_idle=self.node_f32[0],
            node_releasing=self.node_f32[1],
            node_cap=self.node_f32[2],
            node_task_count=self.node_i32[0],
            node_max_tasks=self.node_i32[1],
            queue_deserved=self.queue_f32[0],
            queue_allocated=self.queue_f32[1],
            eps=self.misc[:R],
            lr_weight=self.misc[R],
            br_weight=self.misc[R + 1],
        )


class BidDenseLaunches(NamedTuple):
    """A dense solve's ``bid_dense`` passes: how many, and the shape
    every one of them saw (host integers the solve already holds)."""

    launches: int                  # 0 on the plain chain and off CUDA
    rows: int                      # T
    nodes: int                     # N
    dims: int                      # R
    static: bool                   # static score rows passed


class SolverResult(NamedTuple):
    assigned: torch.Tensor         # i32[T] node index or -1
    node_idle: torch.Tensor        # f32[N, R] idle after assignment
    queue_allocated: torch.Tensor  # f32[Q, R]
    rounds: int                    # rounds executed
    stages: Optional[int] = None   # dense tail stages (staged / sparse)
    refills: Optional[int] = None  # tasks routed to candidate refill
    reconcile_rounds: Optional[int] = None  # sharded sparse global rounds
    bid_dense: Optional[BidDenseLaunches] = None  # full-width dense rounds

    def to_numpy(self) -> dict:
        """Host copies: arrays for the tensors, ints for the counters."""
        return {
            "assigned": self.assigned.cpu().numpy(),
            "node_idle": self.node_idle.cpu().numpy(),
            "queue_allocated": self.queue_allocated.cpu().numpy(),
            "rounds": self.rounds,
            "stages": self.stages,
            "refills": self.refills,
        }


def make_inputs(*, feas=None, static_score=None, **kw) -> SolverInputs:
    """Build :class:`SolverInputs` from dense [T, N] mask/score tensors
    (tests and tools); folds them into the factorized fields."""
    T = kw["task_req"].shape[0]
    N = kw["node_idle"].shape[0]
    dev = kw["task_req"].device
    kw.setdefault("task_valid", torch.ones(T, dtype=torch.bool, device=dev))
    kw.setdefault("node_feas", torch.ones(N, dtype=torch.bool, device=dev))
    if feas is not None:
        kw.setdefault(
            "task_group", torch.arange(T, dtype=torch.int32, device=dev)
        )
        kw.setdefault("group_feas", feas.bool())
    else:
        kw.setdefault(
            "task_group", torch.zeros(T, dtype=torch.int32, device=dev)
        )
        kw.setdefault(
            "group_feas", torch.ones((1, N), dtype=torch.bool, device=dev)
        )
    kw.setdefault("pair_idx", torch.zeros(0, dtype=torch.int32, device=dev))
    kw.setdefault(
        "pair_feas", torch.zeros((0, N), dtype=torch.bool, device=dev)
    )
    if static_score is not None and bool((static_score != 0).any()):
        kw.setdefault(
            "score_idx", torch.arange(T, dtype=torch.int32, device=dev)
        )
        kw.setdefault("score_rows", static_score.float())
    else:
        kw.setdefault(
            "score_idx", torch.zeros(0, dtype=torch.int32, device=dev)
        )
        kw.setdefault(
            "score_rows", torch.zeros((0, N), dtype=torch.float32, device=dev)
        )
    return SolverInputs(**kw)


def build_feasibility(inputs: SolverInputs) -> torch.Tensor:
    """Materialize the [T, N] static predicate mask on the device."""
    T = inputs.task_req.shape[0]
    N = inputs.node_idle.shape[0]
    feas = (
        inputs.group_feas[inputs.task_group.long()]
        & inputs.node_feas[None, :]
        & inputs.task_valid[:, None]
    )
    if inputs.pair_idx.shape[0]:
        # Private rows AND into the group/column mask; row T absorbs the
        # padded pair indices.
        ext = torch.ones((T + 1, N), dtype=torch.bool, device=feas.device)
        ext[inputs.pair_idx.long()] = inputs.pair_feas
        feas = feas & ext[:T]
    return feas


def build_static_score(inputs: SolverInputs) -> Optional[torch.Tensor]:
    """Materialize the [T, N] static score matrix, or None when no
    plugin contributed rows."""
    T = inputs.task_req.shape[0]
    N = inputs.node_idle.shape[0]
    if not inputs.score_idx.shape[0]:
        return None
    ext = torch.zeros(
        (T + 1, N), dtype=torch.float32, device=inputs.score_rows.device
    )
    # Real rows have distinct indices; padded rows all land on row T.
    ext.index_add_(0, inputs.score_idx.long(), inputs.score_rows)
    return ext[:T]


def less_equal(a: torch.Tensor, b: torch.Tensor, eps) -> torch.Tensor:
    """Epsilon-tolerant per-dimension <= reduced over the last axis
    (``a - b < eps`` in every dimension)."""
    return (a - b < eps).all(dim=-1)


def _fits_all(fit: torch.Tensor, table: torch.Tensor, eps) -> torch.Tensor:
    """[T, N] ``less_equal(fit[:, None], table[None], eps)`` built one
    dimension at a time, without the [T, N, R] intermediate."""
    out = None
    for d in range(fit.shape[1]):
        ok = fit[:, None, d] - table[None, :, d] < eps[d]
        out = ok if out is None else out & ok
    return out


# ---------------------------------------------------------------------------
# Scans and segment sums with the JAX package's association and order.
# ---------------------------------------------------------------------------


def _associative_scan(combine: Callable, elems: tuple) -> tuple:
    """Inclusive scan along axis 0 with the odd/even recursion of
    ``jax.lax.associative_scan``, so floats associate identically."""
    n = elems[0].shape[0]
    if n < 2:
        return elems
    reduced = combine(
        tuple(e[0:-1:2] for e in elems), tuple(e[1::2] for e in elems)
    )
    odd = _associative_scan(combine, reduced)
    if n % 2 == 0:
        even = combine(
            tuple(e[:-1] for e in odd), tuple(e[2::2] for e in elems)
        )
    else:
        even = combine(odd, tuple(e[2::2] for e in elems))
    out = []
    for e, ev, od in zip(elems, even, odd):
        res = torch.empty_like(e)
        res[0] = e[0]
        res[2::2] = ev
        res[1::2] = od
        out.append(res)
    return tuple(out)


def _segmented_cumsum_plain(x: torch.Tensor,
                            is_start: torch.Tensor) -> torch.Tensor:
    """The specification of :func:`segmented_cumsum`: the odd/even
    recursion of eager torch ops, on any device."""

    def combine(a, b):
        a_flag, a_val = a
        b_flag, b_val = b
        keep = b_flag[:, None] if b_val.dim() > b_flag.dim() else b_flag
        return (a_flag | b_flag, torch.where(keep, b_val, a_val + b_val))

    return _associative_scan(combine, (is_start, x))[1]


def _check_scan_inputs(x: torch.Tensor, is_start: torch.Tensor) -> int:
    """What the scan kernel takes: ``x`` float32 [T] or [T, R] with
    R <= MAX_R, contiguous; ``is_start`` bool [T], contiguous, on x's
    device. Raises otherwise; returns R (1 for [T])."""
    if x.dtype != torch.float32:
        raise TypeError(f"x: dtype {x.dtype}, the scan kernel takes float32")
    if x.dim() not in (1, 2):
        raise ValueError(f"x: shape {tuple(x.shape)}, expected [T] or [T, R]")
    R = 1 if x.dim() == 1 else x.shape[1]
    if not 1 <= R <= MAX_R:
        raise ValueError(f"R={R}: the kernel takes 1 to {MAX_R} columns")
    if is_start.dtype != torch.bool:
        raise TypeError(f"is_start: dtype {is_start.dtype}, expected bool")
    if tuple(is_start.shape) != (x.shape[0],):
        raise ValueError(f"is_start: shape {tuple(is_start.shape)}, "
                         f"expected ({x.shape[0]},)")
    if is_start.device != x.device:
        raise ValueError(f"is_start: on {is_start.device}, expected "
                         f"{x.device}")
    if not (x.is_contiguous() and is_start.is_contiguous()):
        raise ValueError("x and is_start must be contiguous")
    return R


def segmented_cumsum(x: torch.Tensor, is_start: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum along axis 0 that resets where is_start.

    CPU tensors run :func:`_segmented_cumsum_plain`. Other tensors
    launch the kernel of ``csrc/scan.cu`` (one launch, same bits), or
    raise; ``segmented_cumsum.launches`` counts the launches."""
    if x.device.type == "cpu":
        return _segmented_cumsum_plain(x, is_start)
    from ._build import load_library

    R = _check_scan_inputs(x, is_start)
    T = x.shape[0]
    out = torch.empty_like(x)
    if T == 0:
        return out
    lib = load_library()
    # Columns longer than one tile of the kernel keep the tiles' totals
    # here. Freed on return: the caching allocator hands it out again
    # only to work queued after the kernel on this stream.
    nbytes = lib.kbt_seg_cumsum_scratch_bytes(T, R)
    scratch = (torch.empty(nbytes, dtype=torch.uint8, device=x.device)
               if nbytes else None)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.kbt_seg_cumsum(
        x.data_ptr(), is_start.data_ptr(), out.data_ptr(),
        scratch.data_ptr() if nbytes else None, nbytes, T, R, stream,
    )
    if err != 0:
        raise RuntimeError(f"scan kernel launch failed: CUDA error {err}")
    segmented_cumsum.launches += 1
    return out


segmented_cumsum.launches = 0


def segmented_cummin(x: torch.Tensor, is_start: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix MIN along axis 0 that resets where is_start."""

    def combine(a, b):
        a_flag, a_val = a
        b_flag, b_val = b
        return (
            a_flag | b_flag,
            torch.where(b_flag, b_val, torch.minimum(a_val, b_val)),
        )

    return _associative_scan(combine, (is_start, x))[1]


def _segment_count(seg: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Members per segment id in [0, num_segments). Unlike
    ``torch.bincount``, never reads the largest id back to the host."""
    seg = seg.long()
    return torch.zeros(
        num_segments, dtype=torch.int64, device=seg.device
    ).scatter_add_(0, seg, torch.ones_like(seg))


def _segment_sum(values: torch.Tensor, seg: torch.Tensor,
                 num_segments: int) -> torch.Tensor:
    """``jax.ops.segment_sum`` with its summation order: each segment
    is folded from 0 in task order (a stable sort by segment, then one
    sequential fold per segment)."""
    seg = seg.long()
    order = torch.sort(seg, stable=True).indices
    lengths = _segment_count(seg, num_segments)
    return torch.segment_reduce(
        values[order], "sum", lengths=lengths, axis=0, unsafe=True
    )


def _sort_pairs(major: torch.Tensor, minor: torch.Tensor) -> torch.Tensor:
    """Permutation sorting by (major, minor), both non-negative int32 —
    ``lax.sort((major, minor, arange), num_keys=2)``'s third output."""
    key = (major.long() << 32) | minor.long()
    return torch.sort(key, stable=True).indices


def _starts(sorted_ids: torch.Tensor) -> torch.Tensor:
    first = torch.ones(1, dtype=torch.bool, device=sorted_ids.device)
    return torch.cat([first, sorted_ids[1:] != sorted_ids[:-1]])


# ---------------------------------------------------------------------------
# Scores and bid keys.
# ---------------------------------------------------------------------------


def _f64(x):
    if isinstance(x, torch.Tensor):
        return x.double()
    return float(x)


def _fma_f32(a, b, c) -> torch.Tensor:
    """float32 ``a*b + c`` rounded once, as a fused multiply-add gives.

    Computed in float64, where the product of two float32 values is
    exact; TwoSum yields the sum's rounding error. Rounding the float64
    sum to float32 is then a single rounding except when that sum lies
    exactly on a float32 midpoint and the error is not zero; there the
    error's sign picks the neighbour.
    """
    p = _f64(a) * _f64(b)
    c64 = _f64(c)
    s = p + c64
    bb = s - p
    err = (p - (s - bb)) + (c64 - bb)
    r = s.float()
    r64 = r.double()
    up = s > r64
    toward = torch.where(up, float("inf"), float("-inf")).float()
    n = torch.nextafter(r, toward)
    mid = (r64 + n.double()) * 0.5
    fix = (s == mid) & (err != 0) & ((err > 0) == up)
    return torch.where(fix, n, r)


def _dyn_score_core(req_cm, idle_cm, cap_cm, lr_weight, br_weight):
    """LeastRequested + Balanced on broadcast-compatible [..., 2] views
    (cpu, mem), in the JAX package's operation order."""
    pos = cap_cm > 0
    safe_cap = torch.where(pos, cap_cm, 1.0)
    remaining = idle_cm - req_cm
    lr = torch.where(
        pos, torch.clamp_min(remaining, 0.0) * MAX_PRIORITY / safe_cap, 0.0
    )
    lr_score = (lr[..., 0] + lr[..., 1]) * 0.5
    frac = torch.where(pos, 1.0 - remaining / safe_cap, 1.0)
    diff = (frac[..., 0] - frac[..., 1]).abs()
    br_score = torch.where(
        (frac >= 1.0).any(dim=-1),
        0.0,
        _fma_f32(-diff, MAX_PRIORITY, MAX_PRIORITY),
    )
    return _fma_f32(br_weight, br_score, lr_score * lr_weight)


def dynamic_scores(task_req, node_idle, node_cap, lr_weight, br_weight):
    """[T, N] LeastRequested + BalancedResourceAllocation against the
    current idle (k8s formulas, 0..10 each)."""
    dims = [CPU_DIM, MEM_DIM]
    return _dyn_score_core(
        task_req[:, None, dims],
        node_idle[None, :, dims],
        node_cap[None, :, dims],
        lr_weight,
        br_weight,
    )


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 x in [0, 2^32), without int64
    overflow (the CPU has no uint32 shifts, so the hash runs in int64)."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _U32


def _bid_hash(t_idx: torch.Tensor, n_idx: torch.Tensor) -> torch.Tensor:
    """Decorrelated per-(task, node) hash in [0, 2^_KEY_HASH_BITS)."""
    x = _mul32(t_idx.long() & _U32, 2654435761) ^ _mul32(
        n_idx.long() & _U32, 0x9E3779B9
    )
    x = x ^ (x >> 13)
    x = _mul32(x, 2246822519)
    return ((x >> 8) & ((1 << _KEY_HASH_BITS) - 1)).int()


def bid_keys(score, t_idx, n_idx) -> torch.Tensor:
    """int32 argmax keys from float scores plus hashed tie bits."""
    q = torch.round(score * _INV_QUANTUM) + float(_KEY_BIAS)
    q = q.clamp(0.0, float(_KEY_MAX)).int()
    return (q << _KEY_HASH_BITS) | _bid_hash(t_idx, n_idx)


# ---------------------------------------------------------------------------
# Conflict resolution and commit.
# ---------------------------------------------------------------------------


def _resolve_bids(
    bid, idle, ntask, qalloc,
    *, task_req, task_fit, task_rank, task_queue,
    node_max_tasks, queue_deserved, eps,
):
    """Accept bidders per node in priority order while they fit, then
    enforce per-queue budgets. Returns the accept mask in task order."""
    T, R = task_req.shape
    N = idle.shape[0]
    Q = queue_deserved.shape[0]
    dev = task_req.device

    order = _sort_pairs(bid, task_rank)
    sbid = bid[order].long()
    sreq = task_req[order]
    sfit = task_fit[order]
    is_start = _starts(sbid)
    within_excl = segmented_cumsum(sreq, is_start) - sreq
    # 1-based position inside the node's segment (integers: any
    # association gives the same values).
    pos = torch.arange(T, device=dev)
    seg_first = torch.cummax(
        torch.where(is_start, pos, torch.zeros_like(pos)), dim=0
    ).values
    seg_pos = (pos - seg_first + 1).int()
    idle_pad = torch.cat([idle, idle.new_zeros((1, R))])
    ntask_pad = torch.cat([ntask, ntask.new_zeros(1)])
    max_pad = torch.cat([node_max_tasks, node_max_tasks.new_zeros(1)])
    fit_ok = less_equal(within_excl + sfit, idle_pad[sbid], eps)
    smax = max_pad[sbid]
    count_ok = (smax == 0) | (ntask_pad[sbid] + seg_pos <= smax)
    accept = (sbid < N) & fit_ok & count_ok

    # Queue-budget pass in (queue, rank) order.
    srank = task_rank[order]
    squeue = task_queue[order]
    q_sort_ids = torch.where(accept, squeue, Q)
    qorder = _sort_pairs(q_sort_ids, srank)
    sq = q_sort_ids[qorder].long()
    acc_q = accept[qorder]
    q_req = torch.where(acc_q[:, None], sreq[qorder], 0.0)
    q_prefix_excl = segmented_cumsum(q_req, _starts(sq)) - q_req
    deserved_pad = torch.cat(
        [queue_deserved, queue_deserved.new_full((1, R), float("inf"))]
    )
    qalloc_pad = torch.cat([qalloc, qalloc.new_zeros((1, R))])
    budget_ok = ~less_equal(
        deserved_pad[sq], qalloc_pad[sq] + q_prefix_excl, eps
    )
    accept_sorted = torch.zeros_like(accept)
    accept_sorted[qorder] = acc_q & budget_ok
    out = torch.zeros(T, dtype=torch.bool, device=dev)
    out[order] = accept_sorted
    return out


def _apply_accepts(
    accept, bid, assigned, idle, ntask, qalloc,
    *, task_req, task_queue,
):
    """Apply a task-order accept mask; float sums run in task order.
    Returns (assigned, idle, ntask, qalloc)."""
    N = idle.shape[0]
    Q = qalloc.shape[0]
    sbid = torch.where(accept, bid, N)
    delta = torch.where(accept[:, None], task_req, 0.0)
    idle = idle - _segment_sum(delta, sbid, N + 1)[:N]
    ntask = ntask + _segment_count(sbid, N + 1)[:N].int()
    q_ids = torch.where(accept, task_queue, Q)
    qalloc = qalloc + _segment_sum(delta, q_ids, Q + 1)[:Q]
    assigned = torch.where(accept, sbid, assigned)
    return assigned, idle, ntask, qalloc


def _commit_bids(
    bid, assigned, idle, ntask, qalloc,
    *, task_req, task_fit, task_rank, task_queue,
    node_max_tasks, queue_deserved, eps,
):
    """:func:`_resolve_bids` then :func:`_apply_accepts`.
    Returns (assigned, idle, ntask, qalloc, any_accept)."""
    accept = _resolve_bids(
        bid, idle, ntask, qalloc,
        task_req=task_req, task_fit=task_fit,
        task_rank=task_rank, task_queue=task_queue,
        node_max_tasks=node_max_tasks,
        queue_deserved=queue_deserved, eps=eps,
    )
    assigned, idle, ntask, qalloc = _apply_accepts(
        accept, bid, assigned, idle, ntask, qalloc,
        task_req=task_req, task_queue=task_queue,
    )
    return assigned, idle, ntask, qalloc, accept.any()


def _commit_chain(
    key, cols, assigned, idle, ntask, qalloc, *, commit_kw,
):
    """COMMITS_PER_ROUND commits from one persistent key matrix: each
    commit re-argmaxes the row, and a loser voids the column it lost.
    ``cols`` maps key columns to node ids (None: the column is the id).
    Returns (assigned, idle, ntask, qalloc, any_accept)."""
    T = key.shape[0]
    N = idle.shape[0]
    arange_t = torch.arange(T, device=key.device)
    any_acc = torch.zeros((), dtype=torch.bool, device=key.device)
    for _ in range(COMMITS_PER_ROUND):
        live = assigned < 0
        bid_col = key.argmax(dim=1)
        has_bid = live & (key[arange_t, bid_col] >= 0)
        node = bid_col if cols is None else cols[arange_t, bid_col]
        bid = torch.where(has_bid, node.int(), N)
        assigned, idle, ntask, qalloc, acc = _commit_bids(
            bid, assigned, idle, ntask, qalloc, **commit_kw
        )
        lost = has_bid & (assigned < 0)
        col = torch.where(has_bid, bid_col, 0)
        key[arange_t, col] = torch.where(lost, -1, key[arange_t, col])
        any_acc = any_acc | acc
    return assigned, idle, ntask, qalloc, any_acc


def _solve_round(
    assigned, idle, ntask, qalloc, failed,
    *, task_req, task_fit, task_rank, task_queue, task_sel, task_ids,
    feas, static_score, fits_releasing, blocked_of,
    node_cap, node_max_tasks, queue_deserved,
    lr_weight, br_weight, eps, use_kernel=False,
):
    """ONE dense round (gate, mask, fail, score, bid, commit), shared by
    solve / staged head / staged tail. With ``use_kernel`` the bid pass
    is :func:`bid_kernels.bid_dense` and the round commits once;
    otherwise the plain chain commits COMMITS_PER_ROUND times.
    Returns (assigned, idle, ntask, qalloc, failed, any_accept)."""
    N = idle.shape[0]
    pending = assigned < 0
    q_over = less_equal(queue_deserved, qalloc, eps)
    task_ok = (
        pending & task_sel & ~q_over[task_queue.long()] & ~blocked_of(failed)
    )
    cap_ok = (node_max_tasks == 0) | (ntask < node_max_tasks)
    commit_kw = dict(
        task_req=task_req, task_fit=task_fit,
        task_rank=task_rank, task_queue=task_queue,
        node_max_tasks=node_max_tasks,
        queue_deserved=queue_deserved, eps=eps,
    )
    if use_kernel:
        from .bid_kernels import bid_dense

        bid, any_feas = bid_dense(
            task_fit, task_req, task_ok, feas, idle, node_cap, cap_ok,
            eps, lr_weight, br_weight, task_ids, static_score,
        )
        failed = failed | (task_ok & ~any_feas & ~fits_releasing)
        bid = torch.where(blocked_of(failed), N, bid)
        assigned, idle, ntask, qalloc, any_accept = _commit_bids(
            bid, assigned, idle, ntask, qalloc, **commit_kw
        )
        return assigned, idle, ntask, qalloc, failed, any_accept

    mask = _fits_all(task_fit, idle, eps) & feas & cap_ok[None, :]
    mask = mask & task_ok[:, None]
    failed = failed | (task_ok & ~mask.any(dim=1) & ~fits_releasing)
    mask = mask & ~blocked_of(failed)[:, None]
    score = dynamic_scores(task_req, idle, node_cap, lr_weight, br_weight)
    if static_score is not None:
        score = score + static_score
    n_ids = torch.arange(N, dtype=torch.int32, device=idle.device)
    key = bid_keys(score, task_ids[:, None], n_ids[None, :])
    key = torch.where(mask, key, -1)
    assigned, idle, ntask, qalloc, any_accept = _commit_chain(
        key, None, assigned, idle, ntask, qalloc, commit_kw=commit_kw
    )
    return assigned, idle, ntask, qalloc, failed, any_accept


def _job_blocked_fn(task_rank: torch.Tensor, task_job: torch.Tensor):
    """Greedy break semantics: once a task of a job finds no feasible
    node, every later-ranked task of that job is skipped."""
    T = task_rank.shape[0]
    job = task_job.long()

    def job_blocked(failed):
        first_fail = torch.full(
            (T,), INT_MAX, dtype=torch.int32, device=task_rank.device
        ).scatter_reduce(
            0, job, torch.where(failed, task_rank, INT_MAX), "amin"
        )
        return task_rank > first_fail[job]

    return job_blocked


def _fits_releasing(inputs: SolverInputs, feas0) -> torch.Tensor:
    """Tasks that fit some feasible node's Releasing capacity (the
    escape hatch that keeps them pending instead of failing the job)."""
    return (
        _fits_all(inputs.task_fit, inputs.node_releasing, inputs.eps)
        & feas0
    ).any(dim=1)


def _weights(inputs: SolverInputs):
    return float(inputs.lr_weight), float(inputs.br_weight)


def _as_inputs(inputs) -> SolverInputs:
    return inputs.unpack() if isinstance(inputs, PackedInputs) else inputs


def _init_state(inputs: SolverInputs):
    T = inputs.task_req.shape[0]
    dev = inputs.task_req.device
    return (
        torch.full((T,), -1, dtype=torch.int32, device=dev),
        inputs.node_idle.clone(),
        inputs.node_task_count.clone(),
        inputs.queue_allocated.clone(),
        torch.zeros(T, dtype=torch.bool, device=dev),
    )


def solve(inputs, max_rounds: int = 256,
          use_kernel: bool = False) -> SolverResult:
    """Run the round-based batched allocation to a fixed point."""
    inputs = _as_inputs(inputs)
    lr_w, br_w = _weights(inputs)
    with span("solve.prep"):
        feas0 = build_feasibility(inputs)
        static = build_static_score(inputs)
        fits_releasing = _fits_releasing(inputs, feas0)
    round_kw = dict(
        task_req=inputs.task_req, task_fit=inputs.task_fit,
        task_rank=inputs.task_rank, task_queue=inputs.task_queue,
        # Global-rank tie hashes (rank == row position on full bundles).
        task_sel=inputs.task_valid, task_ids=inputs.task_rank,
        feas=feas0, static_score=static,
        fits_releasing=fits_releasing,
        blocked_of=_job_blocked_fn(inputs.task_rank, inputs.task_job),
        node_cap=inputs.node_cap, node_max_tasks=inputs.node_max_tasks,
        queue_deserved=inputs.queue_deserved,
        lr_weight=lr_w, br_weight=br_w, eps=inputs.eps,
        use_kernel=use_kernel,
    )
    assigned, idle, ntask, qalloc, failed = _init_state(inputs)
    rounds = 0
    changed = True
    while changed and rounds < max_rounds:
        with span("solve.round"):
            assigned, idle, ntask, qalloc, failed, any_accept = _solve_round(
                assigned, idle, ntask, qalloc, failed, **round_kw
            )
            rounds += 1
            with span("solve.sync"):
                changed = bool(any_accept)
    return SolverResult(
        assigned, idle, qalloc, rounds,
        bid_dense=_bid_dense_launches(inputs, rounds, use_kernel, static),
    )


def _bid_dense_launches(inputs: SolverInputs, rounds: int, use_kernel: bool,
                        static) -> BidDenseLaunches:
    """``rounds`` full-width rounds' bid passes: one ``bid_dense``
    launch each on the kernel path with CUDA tensors; none for an empty
    bundle, which the wrapper does not launch, none on CPU tensors,
    which take the plain bid, and none on the plain chain."""
    T, R = inputs.task_fit.shape
    on_card = inputs.task_fit.device.type == "cuda"
    n = rounds if use_kernel and on_card and T else 0
    return BidDenseLaunches(n, int(T), int(inputs.node_idle.shape[0]),
                            int(R), static is not None)


def tail_subset_feas(inputs: SolverInputs, idxs, valid2) -> torch.Tensor:
    """Factorized predicate-mask rows for a compacted task subset."""
    f2 = (
        inputs.group_feas[inputs.task_group[idxs].long()]
        & inputs.node_feas[None, :]
        & valid2[:, None]
    )
    P = inputs.pair_idx.shape[0]
    if P:
        pos = torch.searchsorted(
            inputs.pair_idx, idxs.to(inputs.pair_idx.dtype)
        ).clamp(0, P - 1)
        match = inputs.pair_idx[pos] == idxs
        f2 = f2 & torch.where(match[:, None], inputs.pair_feas[pos], True)
    return f2


def tail_subset_static(inputs: SolverInputs, idxs) -> Optional[torch.Tensor]:
    """Static score rows for a compacted subset (None: no rows)."""
    S = inputs.score_idx.shape[0]
    if not S:
        return None
    pos = torch.searchsorted(
        inputs.score_idx, idxs.to(inputs.score_idx.dtype)
    ).clamp(0, S - 1)
    match = inputs.score_idx[pos] == idxs
    return torch.where(match[:, None], inputs.score_rows[pos], 0.0)


def tail_local_blocked(inputs: SolverInputs, idxs, B: int):
    """Subset-local job-break scan for a compacted tail stage. Returns
    ``(blocked_from, rank2)``."""
    dev = idxs.device
    job2 = inputs.task_job[idxs]
    rank2 = inputs.task_rank[idxs]
    jord = _sort_pairs(job2, rank2)
    sjob = job2[jord]
    srank2 = rank2[jord]
    jstart = _starts(sjob)
    inv_jord = torch.empty(B, dtype=torch.int64, device=dev)
    inv_jord[jord] = torch.arange(B, device=dev)

    def blocked_from(failed2):
        f_rank = torch.where(failed2[jord], srank2, INT_MAX)
        prefmin = segmented_cummin(f_rank, jstart)
        return (srank2 > prefmin)[inv_jord]

    return blocked_from, rank2


def _eligible(inputs, assigned, qalloc, failed, job_blocked):
    q_over = less_equal(inputs.queue_deserved, qalloc, inputs.eps)
    return (
        (assigned < 0)
        & inputs.task_valid
        & ~failed
        & ~job_blocked(failed)
        & ~q_over[inputs.task_queue.long()]
    )


def _dense_tail(
    inputs: SolverInputs,
    assigned, idle, ntask, qalloc, failed, rounds: int,
    *, fits_releasing, job_blocked, shared_kw,
    max_rounds: int, tail_bucket: int,
):
    """Compacted dense drain shared by :func:`solve_staged` and
    :func:`solve_sparse`: compact the highest-priority eligible tasks
    into a [tail_bucket] block and run plain-chain rounds on it until a
    stage places nothing. Returns
    ``(assigned, idle, ntask, qalloc, failed, rounds, stages)``."""
    B = min(tail_bucket, int(inputs.task_req.shape[0]))
    stages = 0
    progressed = True
    while True:
        remaining = _eligible(inputs, assigned, qalloc, failed, job_blocked)
        if not (
            progressed and rounds < max_rounds and stages < 64
            and bool(remaining.any())
        ):
            break
        with span("solve.tail"):
            # The stage's eligible set is the cond's (same state).
            sel_key = torch.where(remaining, inputs.task_rank, INT_MAX)
            # lax.top_k(-sel_key, B): smallest ranks, lower index on ties.
            idxs = torch.sort(sel_key, stable=True).indices[:B]
            valid2 = sel_key[idxs] != INT_MAX
            blocked_from, rank2 = tail_local_blocked(inputs, idxs, B)
            tail_kw = dict(
                task_req=inputs.task_req[idxs], task_fit=inputs.task_fit[idxs],
                task_rank=rank2, task_queue=inputs.task_queue[idxs],
                task_sel=valid2, task_ids=rank2,
                feas=tail_subset_feas(inputs, idxs, valid2),
                static_score=tail_subset_static(inputs, idxs),
                fits_releasing=fits_releasing[idxs], blocked_of=blocked_from,
                **shared_kw,
            )
            sub_assigned = torch.full(
                (B,), -1, dtype=torch.int32, device=idxs.device
            )
            failed2 = failed[idxs]
            changed = True
            while changed and rounds < max_rounds:
                with span("solve.round"):
                    (
                        sub_assigned, idle, ntask, qalloc, failed2, any_accept
                    ) = _solve_round(
                        sub_assigned, idle, ntask, qalloc, failed2, **tail_kw
                    )
                    rounds += 1
                    with span("solve.sync"):
                        changed = bool(any_accept)
            placed2 = sub_assigned >= 0
            assigned[idxs] = torch.where(placed2, sub_assigned, assigned[idxs])
            failed[idxs] = failed2
            progressed = bool(placed2.any())
            stages += 1
    return assigned, idle, ntask, qalloc, failed, rounds, stages


def solve_staged(
    inputs,
    max_rounds: int = 256,
    tail_bucket: int = 3072,
    use_kernel: bool = False,
) -> SolverResult:
    """Head of full-width rounds while more than ``tail_bucket`` tasks
    stay eligible, then the compacted dense tail (:func:`_dense_tail`).
    Head rounds use the bid kernel when ``use_kernel``; the tail always
    runs the plain chain, as in the JAX package."""
    inputs = _as_inputs(inputs)
    T = inputs.task_req.shape[0]
    if T <= tail_bucket:
        return solve(inputs, max_rounds=max_rounds, use_kernel=use_kernel)
    lr_w, br_w = _weights(inputs)
    feas0 = build_feasibility(inputs)
    fits_releasing = _fits_releasing(inputs, feas0)
    job_blocked = _job_blocked_fn(inputs.task_rank, inputs.task_job)
    shared_kw = dict(
        node_cap=inputs.node_cap, node_max_tasks=inputs.node_max_tasks,
        queue_deserved=inputs.queue_deserved,
        lr_weight=lr_w, br_weight=br_w, eps=inputs.eps,
    )
    static = build_static_score(inputs)
    head_kw = dict(
        task_req=inputs.task_req, task_fit=inputs.task_fit,
        task_rank=inputs.task_rank, task_queue=inputs.task_queue,
        task_sel=inputs.task_valid, task_ids=inputs.task_rank,
        feas=feas0, static_score=static,
        fits_releasing=fits_releasing, blocked_of=job_blocked,
        use_kernel=use_kernel,
        **shared_kw,
    )
    assigned, idle, ntask, qalloc, failed = _init_state(inputs)
    rounds = 0
    changed, still = True, T
    while changed and rounds < max_rounds and still > tail_bucket:
        with span("solve.round"):
            assigned, idle, ntask, qalloc, failed, any_accept = _solve_round(
                assigned, idle, ntask, qalloc, failed, **head_kw
            )
            rounds += 1
            # Handoff gauge: tasks the tail could still act on.
            n_still = _eligible(
                inputs, assigned, qalloc, failed, job_blocked
            ).sum()
            with span("solve.sync"):
                changed, still = torch.stack(
                    [any_accept.long(), n_still]).tolist()
    head = _bid_dense_launches(inputs, rounds, use_kernel, static)
    assigned, idle, _, qalloc, _, rounds, stages = _dense_tail(
        inputs, assigned, idle, ntask, qalloc, failed, rounds,
        fits_releasing=fits_releasing, job_blocked=job_blocked,
        shared_kw=shared_kw, max_rounds=max_rounds, tail_bucket=tail_bucket,
    )
    return SolverResult(assigned, idle, qalloc, rounds, stages,
                        bid_dense=head)


def _sparse_round(
    assigned, idle, ntask, qalloc, failed, refill,
    *, task_req, task_fit, task_rank, task_queue, task_sel, task_ids,
    cand_nodes, cand_static, cand_total, fits_releasing, blocked_of,
    node_cap, node_max_tasks, queue_deserved,
    lr_weight, br_weight, eps, use_kernel=False,
):
    """ONE candidate-slab round: the dense round's chain on gathered
    [T, K] slabs with global node ids. Slab exhaustion fails the task
    when its slab held every eligible node (``cand_total <= K``) and
    routes it to refill otherwise.
    Returns (assigned, idle, ntask, qalloc, failed, refill, any_accept)."""
    N = idle.shape[0]
    K = cand_nodes.shape[1]
    pending = assigned < 0
    q_over = less_equal(queue_deserved, qalloc, eps)
    task_ok = (
        pending & task_sel & ~q_over[task_queue.long()] & ~blocked_of(failed)
        & ~refill
    )
    cap_ok = (node_max_tasks == 0) | (ntask < node_max_tasks)
    commit_kw = dict(
        task_req=task_req, task_fit=task_fit,
        task_rank=task_rank, task_queue=task_queue,
        node_max_tasks=node_max_tasks,
        queue_deserved=queue_deserved, eps=eps,
    )
    if use_kernel:
        from .bid_kernels import bid_sparse

        bid, any_feas = bid_sparse(
            task_fit, task_req, task_ok, cand_nodes, cand_static,
            idle, node_cap, cap_ok, eps, lr_weight, br_weight, task_ids,
        )
        exhausted = task_ok & ~any_feas
        failed = failed | (exhausted & (cand_total <= K) & ~fits_releasing)
        refill = refill | (exhausted & (cand_total > K))
        bid = torch.where(blocked_of(failed) | refill, N, bid)
        assigned, idle, ntask, qalloc, any_accept = _commit_bids(
            bid, assigned, idle, ntask, qalloc, **commit_kw
        )
        return assigned, idle, ntask, qalloc, failed, refill, any_accept

    valid = cand_nodes < N
    safe = cand_nodes.clamp_max(N - 1).long()
    idle_slab = idle[safe]                               # [T, K, R]
    mask = less_equal(task_fit[:, None, :], idle_slab, eps)
    mask = mask & valid & cap_ok[safe] & task_ok[:, None]
    exhausted = task_ok & ~mask.any(dim=1)
    failed = failed | (exhausted & (cand_total <= K) & ~fits_releasing)
    refill = refill | (exhausted & (cand_total > K))
    mask = mask & ~(blocked_of(failed) | refill)[:, None]
    dims = [CPU_DIM, MEM_DIM]
    score = _dyn_score_core(
        task_req[:, None, dims], idle_slab[..., dims],
        node_cap[safe][..., dims], lr_weight, br_weight,
    ) + cand_static
    key = torch.where(mask, bid_keys(score, task_ids[:, None], cand_nodes), -1)
    assigned, idle, ntask, qalloc, any_accept = _commit_chain(
        key, cand_nodes, assigned, idle, ntask, qalloc, commit_kw=commit_kw
    )
    return assigned, idle, ntask, qalloc, failed, refill, any_accept


def _cand_classes(inputs) -> int:
    """Candidate-class count of an inputs bundle (0 = dense)."""
    if inputs.cand_idx is None or inputs.task_cand is None:
        return 0
    return int(inputs.cand_idx.shape[0])


def solve_sparse(
    inputs,
    max_rounds: int = 256,
    tail_bucket: int = 3072,
    use_kernel: bool = False,
) -> SolverResult:
    """Slab rounds to a fixed point, then the compacted dense stage
    drains refill-flagged tasks and stragglers. ``refills`` counts the
    tasks routed to refill, ``stages`` the dense stages that drained
    them."""
    inputs = _as_inputs(inputs)
    if _cand_classes(inputs) == 0:
        return _dense_auto(inputs, max_rounds, use_kernel)
    C, K = inputs.cand_idx.shape
    lr_w, br_w = _weights(inputs)
    cls = inputs.task_cand.clamp(0, C - 1).long()
    fits_releasing = inputs.cand_info[2][cls].bool()
    job_blocked = _job_blocked_fn(inputs.task_rank, inputs.task_job)
    shared_kw = dict(
        node_cap=inputs.node_cap, node_max_tasks=inputs.node_max_tasks,
        queue_deserved=inputs.queue_deserved,
        lr_weight=lr_w, br_weight=br_w, eps=inputs.eps,
    )
    head_kw = dict(
        task_req=inputs.task_req, task_fit=inputs.task_fit,
        task_rank=inputs.task_rank, task_queue=inputs.task_queue,
        task_sel=inputs.task_valid, task_ids=inputs.task_rank,
        cand_nodes=inputs.cand_idx[cls].contiguous(),
        cand_static=inputs.cand_static[cls].contiguous(),
        cand_total=inputs.cand_info[0][cls],
        fits_releasing=fits_releasing, blocked_of=job_blocked,
        use_kernel=use_kernel,
        **shared_kw,
    )
    assigned, idle, ntask, qalloc, failed = _init_state(inputs)
    refill = torch.zeros_like(failed)
    rounds = 0
    changed = True
    while changed and rounds < max_rounds:
        with span("solve.round"):
            (
                assigned, idle, ntask, qalloc, failed, refill, any_accept
            ) = _sparse_round(
                assigned, idle, ntask, qalloc, failed, refill, **head_kw
            )
            rounds += 1
            with span("solve.sync"):
                changed = bool(any_accept)
    refills = int(refill.sum())
    assigned, idle, _, qalloc, _, rounds, stages = _dense_tail(
        inputs, assigned, idle, ntask, qalloc, failed, rounds,
        fits_releasing=fits_releasing, job_blocked=job_blocked,
        shared_kw=shared_kw, max_rounds=max_rounds, tail_bucket=tail_bucket,
    )
    return SolverResult(assigned, idle, qalloc, rounds, stages, refills)


# Above this size the staged head + compacted tail wins.
_STAGED_MIN_NODES = 768
_STAGED_MIN_TASKS = 16384


def _dense_auto(inputs: SolverInputs, max_rounds: int,
                use_kernel: bool) -> SolverResult:
    """Shape dispatch between the full and staged dense solvers."""
    T = inputs.task_req.shape[0]
    N = inputs.node_idle.shape[0]
    if N >= _STAGED_MIN_NODES and T >= _STAGED_MIN_TASKS:
        return solve_staged(inputs, max_rounds=max_rounds,
                            use_kernel=use_kernel)
    return solve(inputs, max_rounds=max_rounds, use_kernel=use_kernel)


def solve_auto(inputs, max_rounds: int = 256,
               use_kernel: bool = True) -> SolverResult:
    """Sparse solve when the bundle carries candidate slabs, else the
    full or staged dense solve. ``use_kernel`` routes the head rounds
    through the bid kernels (one commit per round); False runs the
    plain six-commit chain everywhere."""
    inputs = _as_inputs(inputs)
    if _cand_classes(inputs) > 0:
        return solve_sparse(inputs, max_rounds=max_rounds,
                            use_kernel=use_kernel)
    return _dense_auto(inputs, max_rounds, use_kernel)


def jit_compilation_count() -> int:
    """Counterpart of the reference's compiled-variant census: how many
    times this process asked for the bid library to be built
    (``_build.build``, once from the first ``load_library`` on a card,
    plus any direct caller such as ``chip_smoke.py``), plus the distinct
    shape buckets device-resident selection has minted (top-K, row and
    column variants, ``select_device.census``), as the reference adds
    its selection jits. The port's solve runs eager torch ops with no
    per-shape compilation, so this census, like the reference's, must
    stay flat across steady cycles once the buckets are warm; growth
    would mean a build per cycle or a shape drifting per cycle."""
    from . import _build
    from .select_device import census

    return _build.build_calls + census()
