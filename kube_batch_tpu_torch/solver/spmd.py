"""Explicit-SPMD sharded solves: the port of the reference's
``solver/spmd.py``.

Each solve runs one body per shard (a generator, see
``collectives.run_spmd``) with the reference's collectives at the
reference's points, so the sharded program is the reference's program:

- **Dense** (:func:`solve_spmd`): each shard owns N/s node COLUMNS. The
  O(T·N) work — fit mask, dynamic scores, integer bid keys, per-task
  argmax — runs on the local [T, N/s] block; shards exchange [T]-sized
  candidates (one all_gather), every shard picks the same global winner
  (ties to the lowest shard, then the lowest local column: the
  single-device argmax's first-max rule), shard 0 runs the sort-based
  commit against the replicated node/queue tables and psum-broadcasts
  its packed result (zeros from the others). The ``pool`` style
  gathers each shard's top ``COMMITS_PER_ROUND`` candidates once a round
  (task blocks of T <= ``_POOL_MAX_T``); the ``commit`` style gathers
  once a commit. Both are bit-equal to the single-device plain chain
  (``kernels.solve`` / ``solve_staged`` with ``use_kernel=False``).
- **Sparse** (:func:`solve_sparse_spmd`): each shard owns a block of
  T/s slab ROWS. ``flat`` mirrors ``kernels._sparse_round`` with a
  delta-packed commit (slab-column codes gathered, the accept mask
  bit-packed and psum-broadcast from shard 0, every shard applying it)
  and the shared ``kernels._dense_tail`` on shard 0: bit-equal to
  ``kernels.solve_sparse(use_kernel=False)``. ``two-level`` first solves
  each shard's rows on its own rack of N/s nodes under a 1/s slice of
  every queue's headroom (no collective), reconciles the disjoint
  deltas with one psum, and drains the leftovers through the flat
  rounds and the dense tail: quality-approximate, invariant-exact.

The bodies run the plain chain (no bid kernel), as the reference's
sharded bodies run its jnp chain. Collectives and the conflict
resolution reuse ``kernels`` (``_commit_bids``, ``_resolve_bids``,
``_apply_accepts``, ``_dense_tail``, ``_dyn_score_core``, ``bid_keys``,
``less_equal``).
"""

from __future__ import annotations

from typing import Any, Dict, List

import torch

from .collectives import AllGather, Mesh, Psum, run_spmd
from .contracts import (
    DENSE_SPMD_SHARD_DIMS,
    SPARSE_SHARD_DIMS,
    check_shard_dims,
)
from .kernels import (
    COMMITS_PER_ROUND,
    CPU_DIM,
    INT_MAX,
    MEM_DIM,
    PackedInputs,
    SolverInputs,
    SolverResult,
    _apply_accepts,
    _as_inputs,
    _commit_bids,
    _dense_tail,
    _dyn_score_core,
    _eligible,
    _fits_all,
    _init_state,
    _job_blocked_fn,
    _resolve_bids,
    _weights,
    bid_keys,
    less_equal,
    tail_local_blocked,
    tail_subset_feas,
    tail_subset_static,
)

# Round style dispatch: the candidate-pool round pays one top-C
# extraction per round, then commits touch only the pool; the
# per-commit round re-argmaxes [T, N/s] per commit. The reference
# measured the crossover on its 8-device mesh.
_POOL_MAX_T = 4096

_DIMS = [CPU_DIM, MEM_DIM]


def spmd_shardings_for(inputs, mesh: Mesh):
    """Split spec for the dense SPMD solver: per field, the axis split
    over the mesh (node COLUMN fields, ``contracts.DENSE_SPMD_SHARD_DIMS``),
    or None (replicated or absent). A PackedInputs bundle keeps its node
    stacks replicated; its group/pair/score rows split on axis 1. The
    solve places its shards from this spec."""
    check_shard_dims()
    cls = type(inputs)
    if isinstance(inputs, PackedInputs):
        split = {"group_feas": 1, "pair_feas": 1, "score_rows": 1}
    else:
        split = DENSE_SPMD_SHARD_DIMS
    return cls(**{
        f: split.get(f) if getattr(inputs, f, None) is not None else None
        for f in cls._fields
    })


def sparse_spmd_shardings_for(inputs, mesh: Mesh):
    """Split spec for the sharded sparse solve: every input field is
    replicated (``contracts.SPARSE_SHARD_DIMS`` is empty); the [T, K]
    slab expansions split inside the shard bodies."""
    check_shard_dims()
    cls = type(inputs)
    return cls(**{f: SPARSE_SHARD_DIMS.get(f) for f in cls._fields})


def _place(inputs: SolverInputs, spec, mesh: Mesh) -> List[SolverInputs]:
    """Per local shard: ``inputs`` on the shard's device, each field that
    ``spec`` (a split spec over the same fields) splits narrowed to the
    shard's block along its axis."""
    out = []
    for sid, dev in zip(mesh.shard_ids, mesh.devices):
        fields = {}
        for f, axis in zip(SolverInputs._fields, spec):
            v = getattr(inputs, f)
            if v is not None and axis is not None:
                n = v.shape[axis] // mesh.size
                v = v.narrow(axis, sid * n, n)
            fields[f] = None if v is None else v.to(dev, non_blocking=True)
        out.append(SolverInputs(**fields))
    return out


def _block(x: torch.Tensor, off: int, n: int) -> torch.Tensor:
    """Rows [off, off + n) of a replicated table (the reference's
    ``lax.dynamic_slice_in_dim``, which would clamp; here an
    out-of-range block is an error)."""
    if off < 0 or off + n > x.shape[0]:
        raise ValueError(
            f"block [{off}, {off + n}) outside an axis of {x.shape[0]}"
        )
    return x.narrow(0, off, n)


def _pack_commit(assigned, idle, ntask, qalloc, acc):
    """Pack one commit's state into (i32, f32) psum buffers."""
    return (
        torch.cat([assigned, ntask, acc.to(torch.int32).reshape(1)]),
        torch.cat([idle.reshape(-1), qalloc.reshape(-1)]),
    )


def _unpack_commit(ibuf, fbuf, T, N, Q, R):
    return (
        ibuf[:T],                        # assigned
        fbuf[:N * R].reshape(N, R),      # idle
        ibuf[T:T + N],                   # ntask
        fbuf[N * R:].reshape(Q, R),      # qalloc
        ibuf[T + N] > 0,                 # any_accept
    )


def _commit_zeros(T, N, Q, R, dev):
    """What the shards other than 0 add to the commit broadcast."""
    return (
        torch.zeros(T + N + 1, dtype=torch.int32, device=dev),
        torch.zeros(N * R + Q * R, dtype=torch.float32, device=dev),
    )


# ---------------------------------------------------------------------------
# Dense SPMD: node columns over the mesh.
# ---------------------------------------------------------------------------


def _local_feasibility(inputs: SolverInputs, n_local: int, valid):
    """[T, N/s] static predicate mask from the shard's local columns
    (local form of kernels.build_feasibility)."""
    T = inputs.task_req.shape[0]
    feas = (
        inputs.group_feas[inputs.task_group.long()]
        & inputs.node_feas[None, :]
        & valid[:, None]
    )
    if inputs.pair_idx.shape[0]:
        ext = torch.ones((T + 1, n_local), dtype=torch.bool,
                         device=feas.device)
        ext[inputs.pair_idx.long()] = inputs.pair_feas
        feas = feas & ext[:T]
    return feas


def _local_static_score(inputs: SolverInputs, n_local: int):
    """[T, N/s] static score block, or None when no plugin contributed
    rows (local kernels.build_static_score)."""
    T = inputs.task_req.shape[0]
    if not inputs.score_idx.shape[0]:
        return None
    ext = torch.zeros((T + 1, n_local), dtype=torch.float32,
                      device=inputs.score_rows.device)
    ext.index_add_(0, inputs.score_idx.long(), inputs.score_rows)
    return ext[:T]


def _spmd_round(
    shard, nshards, assigned, idle, ntask, qalloc, failed,
    *, task_req, task_fit, task_rank, task_queue, task_sel, task_ids,
    feas_l, static_l, fits_releasing, blocked_of,
    node_cap, node_max_tasks, queue_deserved,
    lr_weight, br_weight, eps, n_off, n_local, style,
):
    """One solver round on shard ``shard`` (a generator body). Mirrors
    kernels._solve_round's plain chain (same gating, job-break rule and
    COMMITS_PER_ROUND cascade) with the key block on the shard's local
    columns; see the module docstring for the two styles. Row gates
    (task_ok, job-block) apply at bid time, which equals masking rows
    before the argmax because both are row-independent.
    Returns (assigned, idle, ntask, qalloc, failed, any_accept)."""
    N = idle.shape[0]
    T = task_req.shape[0]
    Q, R = qalloc.shape
    C = COMMITS_PER_ROUND
    dev = idle.device
    arange_t = torch.arange(T, device=dev)

    pending = assigned < 0
    q_over = less_equal(queue_deserved, qalloc, eps)
    task_ok = (
        pending & task_sel & ~q_over[task_queue.long()] & ~blocked_of(failed)
    )

    # Local node slices of the replicated tables.
    idle_l = _block(idle, n_off, n_local)
    cap_l = _block(node_cap, n_off, n_local)
    ntask_l = _block(ntask, n_off, n_local)
    maxt_l = _block(node_max_tasks, n_off, n_local)
    cap_ok_l = (maxt_l == 0) | (ntask_l < maxt_l)

    # Column-level masks only; row gates apply at the pool. The keys are
    # stale within the round by design (as in the single-device
    # cascade): fits and budgets are re-checked in every _commit_bids.
    mask_l = (_fits_all(task_fit, idle_l, eps) & feas_l
              & cap_ok_l[None, :] & task_sel[:, None])
    score_l = _dyn_score_core(
        task_req[:, None, _DIMS], idle_l[None, :, _DIMS],
        cap_l[None, :, _DIMS], lr_weight, br_weight,
    )
    if static_l is not None:
        score_l = score_l + static_l
    # GLOBAL column ids in the hash, so keys match the single device's.
    cols = torch.arange(n_off, n_off + n_local, dtype=torch.int32,
                        device=dev)
    key_l = torch.where(
        mask_l, bid_keys(score_l, task_ids[:, None], cols[None, :]), -1
    )
    commit_kw = dict(
        task_req=task_req, task_fit=task_fit,
        task_rank=task_rank, task_queue=task_queue,
        node_max_tasks=node_max_tasks,
        queue_deserved=queue_deserved, eps=eps,
    )

    if style == "pool":
        # Per-shard top-C candidates by iterative argmax+void (the first
        # index of the max, as the single-device argmax). A task voids at
        # most one column per commit and the LAST commit sees at most
        # C - 1 voids, so the pool always holds the global argmax.
        ck, cn = [], []
        for _ in range(C):
            b = key_l.argmax(dim=1)
            ck.append(key_l[arange_t, b])
            cn.append((b + n_off).to(torch.int32))
            key_l[arange_t, b] = -1
        g = yield AllGather(torch.stack([torch.stack(ck), torch.stack(cn)]))
        pool_k = g[:, 0].reshape(nshards * C, T)        # [s*C, T]
        pool_n = g[:, 1].reshape(nshards * C, T)

        # Job-break verdict: any feasible column anywhere == pool top-1
        # somewhere (``failed`` is ANDed with task_ok, as in the round).
        any_feas = pool_k.max(dim=0).values >= 0
        failed = failed | (task_ok & ~any_feas & ~fits_releasing)
        gate = task_ok & ~blocked_of(failed)

        if shard == 0:
            any_acc = torch.zeros((), dtype=torch.bool, device=dev)
            for _ in range(C):
                live = gate & (assigned < 0)
                wkey = pool_k.max(dim=0).values
                # Lowest global node among max-key entries == the full
                # matrix argmax's first-max-index rule.
                wnode = torch.where(
                    pool_k == wkey[None, :], pool_n, INT_MAX
                ).min(dim=0).values
                has_bid = live & (wkey >= 0)
                bid = torch.where(has_bid, wnode, N)
                assigned, idle, ntask, qalloc, acc = _commit_bids(
                    bid, assigned, idle, ntask, qalloc, **commit_kw
                )
                # Losers stop re-bidding the column they just lost
                # (global node ids are unique across shards).
                lost = has_bid & (assigned < 0)
                pool_k = torch.where(
                    lost[None, :] & (pool_n == wnode[None, :]), -1, pool_k
                )
                any_acc = any_acc | acc
            contrib = _pack_commit(assigned, idle, ntask, qalloc, any_acc)
        else:
            contrib = _commit_zeros(T, N, Q, R, dev)
        ibuf, fbuf = yield Psum(contrib)
        assigned, idle, ntask, qalloc, any_accept = _unpack_commit(
            ibuf, fbuf, T, N, Q, R
        )
        return assigned, idle, ntask, qalloc, failed, any_accept

    # ---- style == "commit": per-commit reconcile -----------------------
    # Each commit re-argmaxes the live local block and gathers one packed
    # two-vector candidate; the commit runs on shard 0 and broadcasts.
    # The job-break verdict folds into the FIRST commit's gather (the
    # keys are void-free there).
    any_acc = torch.zeros((), dtype=torch.bool, device=dev)
    gate = None
    for c in range(C):
        live = assigned < 0
        lbid = key_l.argmax(dim=1)
        lkey = key_l[arange_t, lbid]
        gkn = yield AllGather(torch.stack([lkey, lbid.to(torch.int32)]))
        gk, gn = gkn[:, 0, :], gkn[:, 1, :]             # [s, T]
        wshard = gk.argmax(dim=0)                       # lowest shard on ties
        wkey = gk.max(dim=0).values
        wnode = gn.gather(0, wshard[None, :])[0]
        if c == 0:
            failed = failed | (task_ok & ~(wkey >= 0) & ~fits_releasing)
            gate = task_ok & ~blocked_of(failed)
        has_bid = gate & live & (wkey >= 0)
        bid = torch.where(
            has_bid, (wshard * n_local + wnode).to(torch.int32), N
        )
        if shard == 0:
            contrib = _pack_commit(*_commit_bids(
                bid, assigned, idle, ntask, qalloc, **commit_kw
            ))
        else:
            contrib = _commit_zeros(T, N, Q, R, dev)
        ibuf, fbuf = yield Psum(contrib)
        assigned, idle, ntask, qalloc, acc = _unpack_commit(
            ibuf, fbuf, T, N, Q, R
        )
        # Void lost columns — only the owner shard holds that column.
        lost = has_bid & (assigned < 0)
        mine = wshard == shard
        col = torch.where(has_bid & mine, wnode.long(), 0)
        key_l[arange_t, col] = torch.where(
            lost & mine, -1, key_l[arange_t, col]
        )
        any_acc = any_acc | acc
    return assigned, idle, ntask, qalloc, failed, any_acc


def _solve_spmd_local(shard, nshards, inputs: SolverInputs, *,
                      max_rounds: int, tail_bucket: int, staged: bool):
    """The per-shard body of the dense SPMD solve. ``inputs`` holds the
    LOCAL blocks of the four column-split fields and whole replicated
    tables for everything else."""
    T, R = inputs.task_req.shape
    if staged and T <= tail_bucket:
        # solve_staged's escape: a snapshot no larger than the tail
        # bucket IS one tail-sized block.
        staged = False
    n_local = inputs.node_feas.shape[0]
    N = inputs.node_idle.shape[0]
    if n_local * nshards != N:
        raise ValueError(
            f"{N} nodes do not split into {nshards} shards of {n_local} "
            f"(pad with sharding.pad_nodes)"
        )
    n_off = shard * n_local
    eps = inputs.eps
    lr_w, br_w = _weights(inputs)

    feas_l = _local_feasibility(inputs, n_local, inputs.task_valid)
    static_l = _local_static_score(inputs, n_local)
    rel_l = _block(inputs.node_releasing, n_off, n_local)
    fr = yield Psum(
        (_fits_all(inputs.task_fit, rel_l, eps) & feas_l)
        .any(dim=1).to(torch.int32)
    )
    fits_releasing = fr > 0
    job_blocked = _job_blocked_fn(inputs.task_rank, inputs.task_job)

    shared_kw = dict(
        node_cap=inputs.node_cap, node_max_tasks=inputs.node_max_tasks,
        queue_deserved=inputs.queue_deserved,
        lr_weight=lr_w, br_weight=br_w, eps=eps,
        n_off=n_off, n_local=n_local,
    )
    head_kw = dict(
        task_req=inputs.task_req, task_fit=inputs.task_fit,
        task_rank=inputs.task_rank, task_queue=inputs.task_queue,
        task_sel=inputs.task_valid,
        # Global-rank tie hashes (== arange on full bundles).
        task_ids=inputs.task_rank,
        feas_l=feas_l, static_l=static_l,
        fits_releasing=fits_releasing, blocked_of=job_blocked,
        style="pool" if T <= _POOL_MAX_T else "commit",
        **shared_kw,
    )
    assigned, idle, ntask, qalloc, failed = _init_state(inputs)
    rounds = 0

    if not staged:
        changed = True
        while changed and rounds < max_rounds:
            (
                assigned, idle, ntask, qalloc, failed, any_accept
            ) = yield from _spmd_round(
                shard, nshards, assigned, idle, ntask, qalloc, failed,
                **head_kw,
            )
            rounds += 1
            changed = bool(any_accept)
        return SolverResult(assigned, idle, qalloc, rounds)

    # ---- staged: full-width head + compacted tail (solve_staged's
    # structure with local column blocks) -------------------------------
    B = tail_bucket
    changed, still = True, T
    while changed and rounds < max_rounds and still > B:
        (
            assigned, idle, ntask, qalloc, failed, any_accept
        ) = yield from _spmd_round(
            shard, nshards, assigned, idle, ntask, qalloc, failed, **head_kw,
        )
        rounds += 1
        n_still = _eligible(inputs, assigned, qalloc, failed, job_blocked).sum()
        changed, still = torch.stack([any_accept.long(), n_still]).tolist()

    stages = 0
    progressed = True
    while True:
        remaining = _eligible(inputs, assigned, qalloc, failed, job_blocked)
        if not (
            progressed and rounds < max_rounds and stages < 64
            and bool(remaining.any())
        ):
            break
        sel_key = torch.where(remaining, inputs.task_rank, INT_MAX)
        # lax.top_k(-sel_key, B): smallest ranks, lower index on ties.
        idxs = torch.sort(sel_key, stable=True).indices[:B]
        valid2 = sel_key[idxs] != INT_MAX
        # With local column blocks the shared subset helpers produce
        # [B, N/s] rows.
        blocked_from, rank2 = tail_local_blocked(inputs, idxs, B)
        tail_kw = dict(
            task_req=inputs.task_req[idxs], task_fit=inputs.task_fit[idxs],
            task_rank=rank2, task_queue=inputs.task_queue[idxs],
            task_sel=valid2, task_ids=rank2,
            feas_l=tail_subset_feas(inputs, idxs, valid2),
            static_l=tail_subset_static(inputs, idxs),
            fits_releasing=fits_releasing[idxs], blocked_of=blocked_from,
            style="pool" if B <= _POOL_MAX_T else "commit",
            **shared_kw,
        )
        sub_assigned = torch.full((B,), -1, dtype=torch.int32,
                                  device=idxs.device)
        failed2 = failed[idxs]
        changed = True
        while changed and rounds < max_rounds:
            (
                sub_assigned, idle, ntask, qalloc, failed2, any_accept
            ) = yield from _spmd_round(
                shard, nshards, sub_assigned, idle, ntask, qalloc, failed2,
                **tail_kw,
            )
            rounds += 1
            changed = bool(any_accept)
        placed2 = sub_assigned >= 0
        assigned[idxs] = torch.where(placed2, sub_assigned, assigned[idxs])
        failed[idxs] = failed2
        progressed = bool(placed2.any())
        stages += 1
    return SolverResult(assigned, idle, qalloc, rounds, stages)


def solve_spmd(
    inputs,
    mesh: Mesh,
    max_rounds: int = 256,
    staged: bool = False,
    tail_bucket: int = 3072,
) -> SolverResult:
    """Run the node-sharded solve on ``mesh``. Same results as the
    single-device plain ``solve`` (or ``solve_staged`` when ``staged``),
    bit for bit. The node axis must divide by ``mesh.size``
    (sharding.pad_nodes; tensorize buckets N to multiples of 256)."""
    inputs = _as_inputs(inputs)
    N = inputs.node_idle.shape[0]
    if N % mesh.size:
        raise ValueError(
            f"{N} nodes do not divide by the mesh size {mesh.size} "
            f"(pad with sharding.pad_nodes)"
        )
    parts = _place(inputs, spmd_shardings_for(inputs, mesh), mesh)
    bodies = [
        _solve_spmd_local(sid, mesh.size, part, max_rounds=max_rounds,
                          tail_bucket=tail_bucket, staged=bool(staged))
        for sid, part in zip(mesh.shard_ids, parts)
    ]
    return run_spmd(mesh, bodies)[0]


# ---------------------------------------------------------------------------
# Sharded SPARSE solve: slab rows over the mesh.
#
# The candidate-sparsified solve has no [T, N] structure; its round-
# dominating tensors are per-TASK slab expansions ([T, K] candidate ids
# and keys, [T, K, R] idle gathers), so the axis to split is the TASK
# axis. Each shard owns T/s slab rows and runs the row-independent mask →
# score → key → argmax chain locally, bit for bit what the single device
# computes for those rows. Conflict resolution is the one cross-task
# step: one all_gather assembles the full bid vector, shard 0 resolves
# it, one psum broadcasts the accept bits, and every shard applies them.
# Exhaustion verdicts gather once a round, so failed/refill/job-break
# state stays replicated. Refill-flagged tasks drain through the SAME
# ``_dense_tail`` the single-device sparse solve uses, on shard 0.
# ---------------------------------------------------------------------------


def _slab_mask(task_fit_l, idle, ntask, node_max_tasks, cand_nodes_l,
               col_ok_l, task_ok_l, eps):
    """[Tl, K] slab eligibility: fit against CURRENT idle, pod-count
    caps, column validity, row gate — kernels._sparse_round's mask, one
    definition for the flat and two-level rounds.
    Returns (mask_l, idle_slab, safe_l)."""
    N = idle.shape[0]
    cap_ok = (node_max_tasks == 0) | (ntask < node_max_tasks)
    safe_l = cand_nodes_l.clamp_max(N - 1).long()
    idle_slab = idle[safe_l]                             # [Tl, K, R]
    fits_l = less_equal(task_fit_l[:, None, :], idle_slab, eps)
    mask_l = fits_l & col_ok_l & cap_ok[safe_l] & task_ok_l[:, None]
    return mask_l, idle_slab, safe_l


def _slab_keys(task_req_l, task_ids_l, cand_nodes_l, cand_static_l,
               idle_slab, safe_l, node_cap, lr_weight, br_weight, mask_l):
    """[Tl, K] masked integer bid keys (kernels._sparse_round's
    score→key chain, GLOBAL task/node ids in the hash bits)."""
    score_l = _dyn_score_core(
        task_req_l[:, None, _DIMS], idle_slab[..., _DIMS],
        node_cap[safe_l][..., _DIMS], lr_weight, br_weight,
    ) + cand_static_l
    key_l = bid_keys(score_l, task_ids_l[:, None], cand_nodes_l)
    return torch.where(mask_l, key_l, -1)


def _commit_code_dtype(k: int) -> torch.dtype:
    """Dtype of the slab-column commit codes: one byte per task while K
    (plus the no-bid sentinel K) fits one, else two."""
    return torch.uint8 if k < 255 else torch.int16


def _pack_bits(mask: torch.Tensor) -> torch.Tensor:
    """Bit-pack a [T] bool mask into ceil(T/32) 32-bit words (bit i of
    word w = element w*32+i): the reference's u32 wire format, carried
    as int32 with the same bits (torch has little uint32 arithmetic;
    the shifts run in int64)."""
    T = mask.shape[0]
    Tp = -(-T // 32) * 32
    m = torch.zeros(Tp, dtype=torch.int64, device=mask.device)
    m[:T] = mask.to(torch.int64)
    shifts = torch.arange(32, dtype=torch.int64, device=mask.device)
    words = (m.reshape(-1, 32) << shifts).sum(dim=1)    # in [0, 2^32)
    return (words - ((words >> 31) << 32)).to(torch.int32)


def _unpack_bits(words: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse of :func:`_pack_bits`: the first ``n`` bits as [n] bool;
    [S, W] gathered rows give [S, n]."""
    shifts = torch.arange(32, dtype=torch.int64, device=words.device)
    bits = ((words.to(torch.int64) & 0xFFFFFFFF)[..., None] >> shifts) & 1
    flat = bits.reshape(*words.shape[:-1], -1)
    return flat[..., :n].bool()


def _commit_delta(shard, code_l, cand_flat, cls, assigned, idle, ntask,
                  qalloc, *, slab_k, task_req, task_fit, task_rank,
                  task_queue, node_max_tasks, queue_deserved, eps):
    """Delta-packed capacity commit (a generator step): all_gather every
    shard's slab-column codes and rebuild the full bid vector from the
    replicated slab; shard 0 resolves the conflicts and psum-broadcasts
    the accept mask bit-packed; every shard applies the accepts through
    ``_apply_accepts``, so the replicated tables stay bit-identical.
    Returns (assigned, idle, ntask, qalloc, any_accept)."""
    T = assigned.shape[0]
    N = idle.shape[0]
    codes = (yield AllGather(code_l)).reshape(T).to(torch.int64)
    has_bid = codes < slab_k
    bid = torch.where(
        has_bid, cand_flat[cls * slab_k + codes.clamp_max(slab_k - 1)], N
    )
    if shard == 0:
        words = _pack_bits(_resolve_bids(
            bid, idle, ntask, qalloc,
            task_req=task_req, task_fit=task_fit,
            task_rank=task_rank, task_queue=task_queue,
            node_max_tasks=node_max_tasks,
            queue_deserved=queue_deserved, eps=eps,
        ))
    else:
        words = torch.zeros(-(-T // 32), dtype=torch.int32,
                            device=assigned.device)
    accept = _unpack_bits((yield Psum(words)), T)
    assigned, idle, ntask, qalloc = _apply_accepts(
        accept, bid, assigned, idle, ntask, qalloc,
        task_req=task_req, task_queue=task_queue,
    )
    return assigned, idle, ntask, qalloc, accept.any()


def commit_exchange_bytes(T: int, N: int, Q: int, R: int, K: int
                          ) -> Dict[str, int]:
    """Per-commit byte accounting of the sparse commit collective (what
    one shard receives per commit): the delta-packed exchange against
    the full-state broadcast it replaced. Shape arithmetic only."""
    code_bytes = T * torch.empty(
        0, dtype=_commit_code_dtype(K)).element_size()
    accept_bytes = (-(-T // 32)) * 4
    delta = code_bytes + accept_bytes
    full = T * 4 + (T + N + 1) * 4 + (N * R + Q * R) * 4
    return {
        "commit_bytes_exchanged": int(delta),
        "commit_bytes_full_broadcast": int(full),
        "commit_bytes_per_round": int(delta) * COMMITS_PER_ROUND,
    }


def _spmd_sparse_round(
    assigned, idle, ntask, qalloc, failed, refill,
    *, shard, t_off, n_local_tasks,
    task_req, task_fit, task_rank, task_queue, task_valid,
    cand_nodes_l, cand_static_l, cand_flat, cls, cand_total,
    fits_releasing, blocked_of,
    node_cap, node_max_tasks, queue_deserved,
    lr_weight, br_weight, eps,
):
    """One sharded candidate-slab round (a generator body). Mirrors
    kernels._sparse_round's plain chain — same gating, the same
    complete-vs-truncated exhaustion split, the same commit cascade —
    with the [T, K] work on the local row block, one bit-packed
    exhaustion gather per round and two collectives per commit.
    Returns (assigned, idle, ntask, qalloc, failed, refill, any_accept)."""
    N = idle.shape[0]
    Tl = n_local_tasks
    K = cand_nodes_l.shape[1]
    code_dtype = _commit_code_dtype(K)
    dev = idle.device
    arange_l = torch.arange(Tl, device=dev)

    def loc(v: torch.Tensor) -> torch.Tensor:
        return v.narrow(0, t_off, Tl)

    # Global-rank tie hashes (== t_off + arange on full bundles).
    task_ids_l = loc(task_rank)
    pending = assigned < 0
    q_over = less_equal(queue_deserved, qalloc, eps)
    task_ok = (
        pending & task_valid & ~q_over[task_queue.long()]
        & ~blocked_of(failed) & ~refill
    )
    mask_l, idle_slab, safe_l = _slab_mask(
        loc(task_fit), idle, ntask, node_max_tasks, cand_nodes_l,
        cand_nodes_l < N, loc(task_ok), eps,
    )

    # The round's one non-commit collective: exhaustion verdicts,
    # bit-packed, so failed/refill/job-break state stays replicated.
    exhausted_l = loc(task_ok) & ~mask_l.any(dim=1)
    exhausted = _unpack_bits(
        (yield AllGather(_pack_bits(exhausted_l))), Tl
    ).reshape(-1)
    failed = failed | (exhausted & (cand_total <= K) & ~fits_releasing)
    refill = refill | (exhausted & (cand_total > K))
    mask_l = mask_l & ~loc(blocked_of(failed) | refill)[:, None]
    key_l = _slab_keys(
        loc(task_req), task_ids_l, cand_nodes_l, cand_static_l,
        idle_slab, safe_l, node_cap, lr_weight, br_weight, mask_l,
    )
    commit_kw = dict(
        slab_k=K, task_req=task_req, task_fit=task_fit,
        task_rank=task_rank, task_queue=task_queue,
        node_max_tasks=node_max_tasks,
        queue_deserved=queue_deserved, eps=eps,
    )
    any_acc = torch.zeros((), dtype=torch.bool, device=dev)
    for _ in range(COMMITS_PER_ROUND):
        live_l = loc(assigned) < 0
        bid_col = key_l.argmax(dim=1)
        has_bid_l = live_l & (key_l[arange_l, bid_col] >= 0)
        # The slab COLUMN index (K = no bid), one byte per task; every
        # shard rebuilds the same full bid vector from the slab.
        code_l = torch.where(has_bid_l, bid_col, K).to(code_dtype)
        assigned, idle, ntask, qalloc, acc = yield from _commit_delta(
            shard, code_l, cand_flat, cls, assigned, idle, ntask, qalloc,
            **commit_kw,
        )
        # Losers stop re-bidding the slab column they just lost.
        lost_l = has_bid_l & (loc(assigned) < 0)
        col = torch.where(has_bid_l, bid_col, 0)
        key_l[arange_l, col] = torch.where(
            lost_l, -1, key_l[arange_l, col]
        )
        any_acc = any_acc | acc
    return assigned, idle, ntask, qalloc, failed, refill, any_acc


def _solve_sparse_spmd_local(shard, inputs: SolverInputs, *, nshards,
                             max_rounds, tail_bucket, two_level, rack):
    """Per-shard body of the sharded sparse solve (every ``inputs`` field
    whole). The task axis must divide by ``nshards`` (sharding.pad_tasks);
    for ``two_level`` the node axis too (sharding.pad_nodes). ``rack`` is
    the node block the shard owns in the two-level phase
    (sharding.rack_perm)."""
    T, R = inputs.task_req.shape
    N = inputs.node_idle.shape[0]
    C, K = inputs.cand_idx.shape
    Tl = T // nshards
    t_off = shard * Tl
    eps = inputs.eps
    dev = inputs.task_req.device
    lr_w, br_w = _weights(inputs)

    def loc(v: torch.Tensor) -> torch.Tensor:
        return v.narrow(0, t_off, Tl)

    # Class → task slab expansion, LOCAL rows only: the [T/s, K] block is
    # the largest structure a shard materializes.
    cls = inputs.task_cand.clamp(0, C - 1).long()
    cls_l = loc(cls)
    cand_nodes_l = inputs.cand_idx[cls_l]                # i32[Tl, K]
    cand_static_l = inputs.cand_static[cls_l]            # f32[Tl, K]
    cand_total = inputs.cand_info[0][cls]                # i32[T]
    fits_releasing = inputs.cand_info[2][cls].bool()
    job_blocked = _job_blocked_fn(inputs.task_rank, inputs.task_job)

    shared_kw = dict(
        node_cap=inputs.node_cap, node_max_tasks=inputs.node_max_tasks,
        queue_deserved=inputs.queue_deserved,
        lr_weight=lr_w, br_weight=br_w, eps=eps,
    )
    round_kw = dict(
        shard=shard, t_off=t_off, n_local_tasks=Tl,
        task_req=inputs.task_req, task_fit=inputs.task_fit,
        task_rank=inputs.task_rank, task_queue=inputs.task_queue,
        task_valid=inputs.task_valid,
        cand_nodes_l=cand_nodes_l, cand_static_l=cand_static_l,
        cand_flat=inputs.cand_idx.reshape(-1), cls=cls,
        cand_total=cand_total,
        fits_releasing=fits_releasing, blocked_of=job_blocked,
        **shared_kw,
    )
    assigned = torch.full((T,), -1, dtype=torch.int32, device=dev)
    idle = inputs.node_idle
    ntask = inputs.node_task_count
    qalloc = inputs.queue_allocated
    local_rounds = 0

    if two_level:
        # ---- level 1: collective-free per-rack solve ----------------
        # The shard owns its rack's node rows and a 1/s slice of every
        # queue's remaining headroom, and places its own task block on
        # that rack's candidate columns only. Disjoint node ownership and
        # sliced budgets make the psum below exact; anything unplaced
        # spills to the global drain.
        Nl = N // nshards
        rack_lo = rack * Nl
        rack_hi = rack_lo + Nl
        headroom = inputs.queue_deserved - inputs.queue_allocated
        # True division by a device tensor: CUDA divides by a host
        # scalar through its reciprocal, which rounds otherwise when s
        # is not a power of two.
        deserved_l = torch.where(
            torch.isinf(inputs.queue_deserved),
            inputs.queue_deserved,
            inputs.queue_allocated + headroom / torch.tensor(
                float(nshards), device=dev),
        )
        arange_l = torch.arange(Tl, device=dev)
        req_l = loc(inputs.task_req)
        fit_l = loc(inputs.task_fit)
        rank_l = loc(inputs.task_rank)
        queue_l = loc(inputs.task_queue)
        valid_task_l = loc(inputs.task_valid)
        in_rack = (cand_nodes_l >= rack_lo) & (cand_nodes_l < rack_hi)
        local_commit_kw = dict(
            task_req=req_l, task_fit=fit_l,
            task_rank=rank_l, task_queue=queue_l,
            node_max_tasks=inputs.node_max_tasks,
            queue_deserved=deserved_l, eps=eps,
        )
        assigned_l = torch.full((Tl,), -1, dtype=torch.int32, device=dev)
        idle_L, ntask_L, qalloc_L = idle, ntask, qalloc
        spill_l = torch.zeros(Tl, dtype=torch.bool, device=dev)
        changed = True
        while changed and local_rounds < max_rounds:
            pending_l = assigned_l < 0
            q_over = less_equal(deserved_l, qalloc_L, eps)
            task_ok_l = (
                pending_l & valid_task_l & ~q_over[queue_l.long()]
                & ~spill_l
            )
            mask_l, idle_slab, safe_l = _slab_mask(
                fit_l, idle_L, ntask_L, inputs.node_max_tasks,
                cand_nodes_l, in_rack, task_ok_l, eps,
            )
            # A rack-local exhaustion is a SPILL, never a job break: the
            # global drain holds the complete-slab evidence.
            spill_l = spill_l | (task_ok_l & ~mask_l.any(dim=1))
            key_l = _slab_keys(
                req_l, rank_l, cand_nodes_l, cand_static_l, idle_slab,
                safe_l, inputs.node_cap, lr_w, br_w, mask_l,
            )
            any_acc = torch.zeros((), dtype=torch.bool, device=dev)
            for _ in range(COMMITS_PER_ROUND):
                live_l = assigned_l < 0
                bid_col = key_l.argmax(dim=1)
                has_bid = live_l & (key_l[arange_l, bid_col] >= 0)
                bid_l = torch.where(
                    has_bid, cand_nodes_l[arange_l, bid_col], N
                )
                (
                    assigned_l, idle_L, ntask_L, qalloc_L, acc
                ) = _commit_bids(
                    bid_l, assigned_l, idle_L, ntask_L, qalloc_L,
                    **local_commit_kw,
                )
                lost = has_bid & (assigned_l < 0)
                col = torch.where(has_bid, bid_col, 0)
                key_l[arange_l, col] = torch.where(
                    lost, -1, key_l[arange_l, col]
                )
                any_acc = any_acc | acc
            local_rounds += 1
            changed = bool(any_acc)

        # ---- reconcile: exact psum merge of the disjoint deltas -------
        assigned = (yield AllGather(assigned_l)).reshape(T)
        d_idle, d_ntask, d_qalloc = yield Psum(
            (idle_L - idle, ntask_L - ntask, qalloc_L - qalloc)
        )
        idle = idle + d_idle
        ntask = ntask + d_ntask
        qalloc = qalloc + d_qalloc
        g = yield AllGather(torch.tensor(local_rounds, device=dev))
        local_rounds = int(g.max())

    # ---- flat sharded rounds to a fixed point -------------------------
    # (two-level enters here as the global drain: spilled tasks re-bid
    # their FULL slabs against the merged state.)
    failed = torch.zeros(T, dtype=torch.bool, device=dev)
    refill = torch.zeros(T, dtype=torch.bool, device=dev)
    grounds = 0
    changed = True
    while changed and grounds < max_rounds:
        (
            assigned, idle, ntask, qalloc, failed, refill, any_accept
        ) = yield from _spmd_sparse_round(
            assigned, idle, ntask, qalloc, failed, refill, **round_kw
        )
        grounds += 1
        changed = bool(any_accept)
    refills = int(refill.sum())
    rounds = local_rounds + grounds

    # ---- refill / drain: the SHARED compacted dense stage, on shard 0
    # and broadcast (replicated tail compute is free on parallel chips,
    # s times the wall time on a virtual mesh).
    Q = qalloc.shape[0]
    if shard == 0:
        a, i, _nt, q, _f, rr, st = _dense_tail(
            inputs, assigned, idle, ntask, qalloc, failed, rounds, fits_releasing=fits_releasing, job_blocked=job_blocked,
            shared_kw=shared_kw, max_rounds=max_rounds,
            tail_bucket=tail_bucket,
        )
        contrib = (
            torch.cat([a, torch.tensor([rr, st], dtype=torch.int32,
                                       device=dev)]),
            torch.cat([i.reshape(-1), q.reshape(-1)]),
        )
    else:
        contrib = (
            torch.zeros(T + 2, dtype=torch.int32, device=dev),
            torch.zeros(N * R + Q * R, dtype=torch.float32, device=dev),
        )
    ibuf, fbuf = yield Psum(contrib)
    stats = ibuf[T:].tolist()
    return SolverResult(
        ibuf[:T], fbuf[:N * R].reshape(N, R), fbuf[N * R:].reshape(Q, R),
        stats[0], stats[1], refills, reconcile_rounds=grounds,
    )


def solve_sparse_spmd(
    inputs: Any,
    mesh: Mesh,
    max_rounds: int = 256,
    tail_bucket: int = 3072,
    two_level: bool = False,
) -> SolverResult:
    """Run the candidate-sparsified solve with slab rows sharded over
    ``mesh``. ``flat`` (default) is bit-equal to the single-device
    ``kernels.solve_sparse(use_kernel=False)``; ``two_level`` runs the
    per-rack solve plus global reconciliation (quality-approximate,
    invariant-exact). The task axis must divide by ``mesh.size``
    (sharding.pad_tasks), and the node axis too for ``two_level``."""
    note_commit_stats(inputs)
    return run_sparse_spmd(inputs, mesh, max_rounds, tail_bucket,
                           two_level)


def run_sparse_spmd(inputs: Any, mesh: Mesh, max_rounds: int = 256,
                    tail_bucket: int = 3072, two_level: bool = False
                    ) -> SolverResult:
    """:func:`solve_sparse_spmd` without the byte accounting, which the
    dispatch (sharding.solve_sharded) records on the unpadded bundle."""
    from .sharding import rack_perm

    inputs = _as_inputs(inputs)
    T = inputs.task_req.shape[0]
    N = inputs.node_idle.shape[0]
    if T % mesh.size or (two_level and N % mesh.size):
        raise ValueError(
            f"sparse sharded solve needs task{'/node' if two_level else ''} "
            f"axes divisible by the mesh size {mesh.size}"
        )
    racks = rack_perm(mesh)
    parts = _place(inputs, sparse_spmd_shardings_for(inputs, mesh), mesh)
    bodies = [
        _solve_sparse_spmd_local(
            sid, part, nshards=mesh.size, max_rounds=max_rounds,
            tail_bucket=tail_bucket, two_level=bool(two_level),
            rack=int(racks[sid]),
        )
        for sid, part in zip(mesh.shard_ids, parts)
    ]
    return run_spmd(mesh, bodies)[0]


# Byte accounting of the LAST sparse sharded solve's commit collective
# (shape arithmetic, set per dispatch). Keys: commit_bytes_exchanged
# (delta-packed, per commit), commit_bytes_full_broadcast (the
# full-state psum it replaced), commit_bytes_per_round.
last_commit_stats: Dict[str, int] = {}


def note_commit_stats(inputs: Any) -> None:
    """Record the commit collective's byte accounting for this dispatch
    into ``last_commit_stats``."""
    if isinstance(inputs, PackedInputs):
        T, R = inputs.task_f32.shape[1], inputs.task_f32.shape[2]
        N = inputs.node_f32.shape[1]
        Q = inputs.queue_f32.shape[1]
    else:
        T, R = inputs.task_req.shape
        N = inputs.node_idle.shape[0]
        Q = inputs.queue_deserved.shape[0]
    K = inputs.cand_idx.shape[1] if inputs.cand_idx is not None else 0
    last_commit_stats.clear()
    last_commit_stats.update(
        commit_exchange_bytes(int(T), int(N), int(Q), int(R), max(int(K), 1))
    )
