#!/usr/bin/env python3
"""Drive the PyTorch port's solver on one CUDA card and check it.

Run from the root of the repository: ``python3 chip_smoke.py``. It needs
one CUDA device and ``nvcc`` (``$CUDA_HOME`` or ``/usr/local/cuda``), and
exits non-zero without printing a result when either is missing or any
phase fails. Phases:

1. build the bid kernels from ``kube_batch_tpu_torch/solver/csrc``,
   report each kernel's registers and spills from ``ptxas -v`` (a spill
   fails the run) and the card (``nvidia-smi`` name and power limit);
2. hold each kernel against its plain PyTorch version on the card, on
   the seeded ``EDGE_CASES`` and on the round-0 inputs of phases 3-5
   (bid and any_feas exactly equal), and the scan/segment-sum glue
   against the CPU;
3. main path, sparse: a 50,000-pod x 5,000-node snapshot shaped like
   ``bench.py::build_cluster`` (5 weighted queues, 500 gangs, K=64 slabs
   from the port's host selection) through ``solve_auto`` with the
   kernels; placements validated, and the whole result bit-equal to the
   same solve on the CPU;
4. dense staged: the same snapshot without slabs (the path taken when
   class dedup degenerates) through ``solve_auto``; validated;
5. dense full ``solve``: 10,000 x 1,000 (no slabs below 1,024 nodes),
   bit-equal to the CPU;
6. timings: warm medians per phase, a profiled solve per phase, and at
   the main path's shapes each kernel's time per launch over 20
   back-to-back wrapper calls (CUDA events: ``ms``), its device time per
   launch with the L2 flushed before each (``device_ms``), the plain
   versions' times and each kernel's bound.

Each phase sets the kernels' launch counters to 0 just before it drives
the path and reads them just after. The next-to-last line of standard
output is the kernels' JSON record, the last ``{"ok": true, ...}``.
Details go to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from kube_batch_tpu_torch.solver import _build
from kube_batch_tpu_torch.solver import bid_kernels as BK
from kube_batch_tpu_torch.solver import kernels as K
from kube_batch_tpu_torch.solver.masks import CombinedMask
from kube_batch_tpu_torch.solver.snapshot import pack_inputs
from kube_batch_tpu_torch.solver.topk import select_candidates, topk_config
from kube_batch_tpu_torch.solver.validate import validate_placements

OUT_DIR = Path("chiprun_out")

# NVIDIA H100 SXM data-sheet peaks (dense, no sparsity), at 700 W.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12

# float32 operations per scored cell of the bid chain (csrc/bid.cu):
# 2 sub (remaining), 2 max + 2 mul + 2 div (LeastRequested), add + mul
# (mean), 2 div + 2 sub (fractions), sub + abs (diff), 2 compares, fma
# (2) for Balanced, mul + fma (3) for the weights, mul + rint + add +
# min + max for the key: 28, plus 1 for a static score; and 2 per
# dimension for every epsilon fit check.
OPS_PER_SCORED_CELL = 28
OPS_PER_FIT_DIM = 2

SOURCE = "kube_batch_tpu_torch/solver/csrc/bid.cu"
REPLACES = {
    "bid_dense": "kube_batch_tpu/solver/pallas_kernels.py:204",
    "bid_sparse": "kube_batch_tpu/solver/pallas_kernels.py:373",
}


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(msg):
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# Snapshots shaped like bench.py::build_cluster, as tensorize emits them.
# ---------------------------------------------------------------------------


def _round_up(n, m):
    return ((n + m - 1) // m) * m


def _task_bucket(n):
    return _round_up(n, 256) if n <= 4096 else _round_up(n, 2048)


def _pad(a, rows, fill=0):
    out = np.full((rows,) + a.shape[1:], fill, dtype=a.dtype)
    out[: a.shape[0]] = a
    return out


def _proportion(weights, request, total):
    """Deserved share per queue: weighted water-filling of the cluster
    total, each queue capped at its request (the proportion plugin)."""
    Q = len(weights)
    deserved = np.zeros_like(request)
    met = np.zeros(Q, bool)
    remaining = total.copy()
    while not met.all():
        w = weights[~met].sum()
        before = remaining.copy()
        for q in np.flatnonzero(~met):
            deserved[q] += remaining * weights[q] / w
            if (request[q] <= deserved[q]).all():
                deserved[q] = np.minimum(deserved[q], request[q])
                met[q] = True
        remaining = total - deserved.sum(0)
        if (remaining <= 0).all() or np.array_equal(remaining, before):
            break
    return deserved


def build_snapshot(n_tasks, n_nodes, n_queues, n_groups, seed=0, k=None):
    """Host SolverInputs fields for a build_cluster-shaped cluster: nodes
    of 32 CPU / 128 GiB / 110 pods; pod CPU from {250..4000} m and memory
    from {256..8192} MiB; queue q of weight q+1; gang g in queue
    g % n_queues with a random minMember. ``k`` adds candidate slabs
    from the port's host selection. Returns (fields, T, N)."""
    rng = np.random.RandomState(seed)
    per_group = n_tasks // n_groups
    T, N, R = per_group * n_groups, n_nodes, 2
    cpus = rng.choice([250, 500, 1000, 2000, 4000], size=n_tasks)[:T]
    mems = rng.choice([256, 512, 1024, 4096, 8192], size=n_tasks)[:T]
    rng.randint(1, per_group + 1, size=n_groups)  # minMember (gang plugin)
    req = np.c_[cpus, mems].astype(np.float32)
    job = np.repeat(np.arange(n_groups), per_group).astype(np.int32)
    queue = (job % n_queues).astype(np.int32)
    cap = np.tile(np.array([[32000, 131072]], np.float32), (N, 1))
    weights = np.arange(1, n_queues + 1, dtype=np.float64)
    request = np.stack([req[queue == q].sum(0, dtype=np.float64)
                        for q in range(n_queues)])
    deserved = _proportion(weights, request, cap.sum(0, dtype=np.float64))
    Tp, Np = _task_bucket(T), _round_up(N, 128)
    eps = np.full(R, 10.0, np.float32)
    node_ok = np.ones(N, bool)
    max_tasks = np.full(N, 110, np.int32)
    count = np.zeros(N, np.int32)
    task_group = np.zeros(T, np.int32)
    group_rows = np.ones((1, N), bool)
    if k is not None:
        mask = CombinedMask(node_ok, task_group, group_rows,
                            np.zeros(0, np.int32), np.zeros((0, N), bool))
        cs = select_candidates(mask, {}, req, req, cap, cap,
                               np.zeros_like(cap), count, max_tasks, eps,
                               1.0, 1.0, k)
        check(cs is not None, "candidate selection fell back to dense")
        cand_idx = cs.cand_idx
        cand_idx[cand_idx >= N] = Np
        Cp = 1 << max(0, (cand_idx.shape[0] - 1).bit_length())
        task_cand = _pad(cs.task_cand, Tp)
        cand_idx = _pad(cand_idx, Cp, fill=Np)
        cand_static = _pad(cs.cand_static, Cp)
        cand_info = np.zeros((3, Cp), np.int32)
        cand_info[:, : cs.cand_info.shape[1]] = cs.cand_info
    else:
        task_cand = np.zeros(Tp, np.int32)
        cand_idx = np.zeros((0, 1), np.int32)
        cand_static = np.zeros((0, 1), np.float32)
        cand_info = np.zeros((3, 0), np.int32)
    valid = np.zeros(Tp, bool)
    valid[:T] = True
    fields = dict(
        task_req=_pad(req, Tp), task_fit=_pad(req, Tp),
        task_rank=np.arange(Tp, dtype=np.int32),
        task_job=np.concatenate([job, np.arange(T, Tp, dtype=np.int32)]),
        task_queue=_pad(queue, Tp), task_valid=valid,
        task_group=_pad(task_group, Tp),
        node_feas=_pad(node_ok, Np, fill=False),
        group_feas=np.ascontiguousarray(_pad(group_rows.T, Np, False).T),
        pair_idx=np.zeros(0, np.int32), pair_feas=np.zeros((0, Np), bool),
        score_idx=np.zeros(0, np.int32),
        score_rows=np.zeros((0, Np), np.float32),
        node_idle=_pad(cap, Np), node_releasing=np.zeros((Np, R), np.float32),
        node_cap=_pad(cap, Np), node_task_count=_pad(count, Np),
        node_max_tasks=_pad(max_tasks, Np),
        queue_deserved=deserved.astype(np.float32),
        queue_allocated=np.zeros((n_queues, R), np.float32),
        eps=eps, lr_weight=np.float32(1.0), br_weight=np.float32(1.0),
        task_cand=task_cand, cand_idx=cand_idx, cand_static=cand_static,
        cand_info=cand_info,
    )
    return K.SolverInputs(**fields), T, N


# ---------------------------------------------------------------------------
# Round-0 kernel inputs, exactly as the solvers form them.
# ---------------------------------------------------------------------------


def _round0_common(s):
    q_over = K.less_equal(s.queue_deserved, s.queue_allocated, s.eps)
    task_ok = s.task_valid & ~q_over[s.task_queue.long()]
    cap_ok = (s.node_max_tasks == 0) | (s.node_task_count < s.node_max_tasks)
    return task_ok, cap_ok


def dense_round0(packed):
    s = packed.unpack()
    task_ok, cap_ok = _round0_common(s)
    return (s.task_fit, s.task_req, task_ok, K.build_feasibility(s),
            s.node_idle, s.node_cap, cap_ok, s.eps, float(s.lr_weight),
            float(s.br_weight), s.task_rank, K.build_static_score(s))


def sparse_round0(packed):
    s = packed.unpack()
    task_ok, cap_ok = _round0_common(s)
    cls = s.task_cand.clamp(0, s.cand_idx.shape[0] - 1).long()
    return (s.task_fit, s.task_req, task_ok,
            s.cand_idx[cls].contiguous(), s.cand_static[cls].contiguous(),
            s.node_idle, s.node_cap, cap_ok, s.eps, float(s.lr_weight),
            float(s.br_weight), s.task_rank)


def dense_work(args):
    """(bytes, operations) the dense bid pass needs on these inputs."""
    fit, req, ok, feas, idle, cap, cap_ok, eps, _, _, ids, static = args
    T, R = fit.shape
    N = idle.shape[0]
    nbytes = (T * N + (4 * T * N if static is not None else 0)
              + T * (8 * R + 1 + 4) + N * (8 * R + 1) + 4 * R + T * 5)
    live = feas & cap_ok[None, :] & ok[:, None]
    checked = int(live.sum())
    scored = int((live & K._fits_all(fit, idle, eps)).sum())
    per = OPS_PER_SCORED_CELL + (1 if static is not None else 0)
    return nbytes, checked * R * OPS_PER_FIT_DIM + scored * per


def sparse_work(args):
    fit, req, ok, cand, cst, idle, cap, cap_ok, eps, _, _, ids = args
    T, R = fit.shape
    N = idle.shape[0]
    Kw = cand.shape[1]
    nbytes = T * Kw * 8 + T * (8 * R + 1 + 4) + N * (8 * R + 1) + 4 * R + T * 5
    valid = (cand >= 0) & (cand < N)
    safe = cand.clamp(0, N - 1).long()
    live = valid & cap_ok[safe] & ok[:, None]
    fits = K.less_equal(fit[:, None, :], idle[safe], eps)
    return nbytes, (int(live.sum()) * R * OPS_PER_FIT_DIM
                    + int((live & fits).sum()) * (OPS_PER_SCORED_CELL + 1))


# ---------------------------------------------------------------------------
# Measurement helpers.
# ---------------------------------------------------------------------------


def event_ms(fn, reps, warm=2):
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


# Before each call that device_ms times, the L2 is flushed (this many
# bytes overwritten: five times the H100's 50 MB L2) and the card spins
# (this many cycles, ~0.5 ms), so the host has queued the call before the
# card reaches it.
L2_FLUSH_BYTES = 256 << 20
SPIN_CYCLES = 1_000_000


def device_ms(fn, reps=20, warm=2):
    """Mean device time of one call of `fn` with a cold L2: each call
    between its own pair of CUDA events, queued behind an L2 flush and a
    spin of the card. The events then time the kernel alone, not the
    host's call, reading its inputs from HBM as in the solve's round
    loop, where ~1,800 other kernels run between two bid launches."""
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    for _ in range(warm):
        fn()
    pairs = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        pairs.append((t0, t1))
    torch.cuda.synchronize()
    return statistics.fmean(t0.elapsed_time(t1) for t0, t1 in pairs)


def wall_ms(fn, reps):
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def compare_kernel(name, args, record):
    """Kernel vs plain version on the card; exact equality required.
    The launches made here are not counted against the main path."""
    fn = getattr(BK, name)
    plain = getattr(BK, name + "_plain")
    saved = fn.launches
    got = fn(*args)
    torch.cuda.synchronize()
    fn.launches = saved
    want = plain(*args)
    diff = int((got[0].long() - want[0].long()).abs().max()) if len(
        got[0]) else 0
    mism = int((got[1] != want[1]).sum())
    record["max_abs_err"] = max(record.get("max_abs_err", 0), diff, mism)
    record.setdefault("cases", 0)
    record["cases"] += 1
    check(diff == 0 and mism == 0,
          f"{name}: kernel differs from plain (max |bid diff| {diff}, "
          f"{mism} any_feas mismatches, T={args[0].shape[0]})")


# (seed, T, N, R, K, static rows, (lr_w, br_w), variant). The kernels
# take rows in groups of 16 (dense) or 32 (sparse) over a grid of one or
# a few blocks per SM, and hold node tables of up to 7,808 columns at
# R=2 (4,464 at R=8) in shared memory; the sizes below cross those.
EDGE_CASES = [
    (1, 1001, 333, 3, 64, True, (0.7, 1.3), None),
    (2, 100, 4097, 2, 64, False, (1.0, 1.0), None),
    (3, 33, 64, 2, 64, True, (1.0, 1.0), None),
    # several dense tiles; the sparse table exceeds shared memory
    (4, 300, 20000, 8, 64, True, (1.0, 1.0), None),
    # N not a multiple of 16, T not a multiple of the grid, K = 37
    (5, 2117, 1009, 2, 37, False, (0.7, 1.3), None),
    # identical nodes: max-key ties across 16-column groups and tiles
    (6, 700, 9000, 2, 64, False, (1.0, 1.0), "identical"),
    (7, 500, 4097, 2, 64, True, (1.0, 1.0), "identical"),
    (8, 800, 2000, 3, 48, False, (1.0, 1.0), "zero_cap"),
    (9, 600, 1500, 2, 64, True, (0.7, 1.3), "extreme"),
    (10, 640, 777, 2, 64, False, (1.0, 1.0), "odd_rows"),
    (11, 257, 500, 2, 64, True, (1.0, 1.0), "shifted"),
]


def _shifted(a, by, dev):
    """A contiguous copy of `a` whose storage starts `by` elements into a
    buffer: rows lose their 16-byte alignment."""
    flat = torch.zeros(a.size + by, dtype=torch.from_numpy(a[:0]).dtype,
                       device=dev)
    out = flat[by:].view(a.shape)
    out.copy_(torch.from_numpy(np.ascontiguousarray(a)))
    return out


def edge_case(dev, seed, T, N, R, K, static, weights, variant):
    """Kernel arguments (dense, sparse) for one seeded case. Variants:
    ``identical`` nodes (ties everywhere); ``zero_cap``: zero or negative
    capacity in one dimension on a fifth of the nodes; ``extreme``:
    capacities 2^-120..2^120 with idle up to twice the capacity and
    requests 2^-100..2^100 (outside the kernels' reciprocal route);
    ``odd_rows``: requests of 0 and 2^-60, and a run of rows with
    task_ok false; ``shifted``: inputs whose rows are not 16-byte
    aligned."""
    rng = np.random.RandomState(seed)
    req = rng.uniform(100, 3000, (T, R)).astype(np.float32)
    idle = rng.uniform(500, 32000, (N, R)).astype(np.float32)
    cap = idle * rng.uniform(1.0, 1.5, (N, 1)).astype(np.float32)
    eps = np.full(R, 10, np.float32)
    task_ok = rng.rand(T) > 0.1
    cap_ok = rng.rand(N) > 0.1
    cap_ok[: N // 10] = False
    if variant == "identical":
        idle[:] = idle[0]
        cap[:] = cap[0]
        cap_ok[:] = True
    elif variant == "zero_cap":
        cap[rng.rand(N) < 0.2, 0] = 0.0
        cap[rng.rand(N) < 0.2, 1] = 0.0
        cap[rng.rand(N) < 0.05, 0] = -5.0
    elif variant == "extreme":
        scale = np.exp2(rng.uniform(-120, 120, (N, R)))
        cap = (scale * rng.uniform(1.0, 1.5, (N, R))).astype(np.float32)
        idle = (cap * rng.uniform(0.5, 2.0, (N, R))).astype(np.float32)
        req = (np.exp2(rng.uniform(-100, 100, (T, R)))
               * rng.uniform(1.0, 2.0, (T, R))).astype(np.float32)
        eps[:] = np.float32(2.0 ** 126)
    elif variant == "odd_rows":
        req[rng.rand(T) < 0.1, 0] = 0.0
        req[rng.rand(T) < 0.1, 1] = np.float32(2.0 ** -60)
        task_ok[T // 4: T // 2] = False
    fit = req * np.float32(1.05)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa
    shift = (lambda a, by: _shifted(a, by, dev)) if variant == "shifted" \
        else (lambda a, by: t(a))
    base = [t(fit), t(req), t(task_ok)]
    nodes = [t(idle), t(cap), t(cap_ok), t(eps), *weights,
             t(np.arange(T, dtype=np.int32))]
    feas = shift(rng.rand(T, N) > 0.2, 3)
    st = (shift(rng.uniform(0, 10, (T, N)).astype(np.float32), 1)
          if static else None)
    cand = np.sort(np.argsort(rng.rand(T, N), 1)[:, :K], 1).astype(np.int32)
    cand[rng.rand(T, K) < 0.15] = N
    cand.sort(1)
    cand[0] = N  # an all-padding row
    sparse = base + [
        shift(cand, 1), shift(rng.uniform(0, 5, (T, K)).astype(np.float32), 1),
    ] + nodes
    return base + [feas] + nodes + [st], sparse


def edge_cases(dev):
    """Every EDGE_CASES entry as (kernel name, arguments)."""
    out = []
    for case in EDGE_CASES:
        dense, sparse = edge_case(dev, *case)
        out += [("bid_dense", dense), ("bid_sparse", sparse)]
    return out


def glue_matches_cpu(dev):
    """The order-sensitive torch glue (segment sums, associative scans)
    gives the CPU's bits on the card, at magnitudes past 2^24."""
    rng = np.random.RandomState(0)
    vals = (rng.choice([4097.0, 8191.0, 12289.0, 3.5], (60000, 2))
            * 3.7).astype(np.float32)
    seg = rng.randint(0, 6, 60000).astype(np.int32)
    v, s = torch.from_numpy(vals), torch.from_numpy(seg)
    check(torch.equal(K._segment_sum(v, s, 6),
                      K._segment_sum(v.to(dev), s.to(dev), 6).cpu()),
          "segment sum on the card differs from the CPU")
    x = torch.from_numpy(
        (rng.choice([4097.0, 8191.0, 0.3], (50001, 2)) * 997).astype(
            np.float32))
    st = torch.from_numpy(rng.rand(50001) < 0.01)
    st[0] = True
    check(torch.equal(K.segmented_cumsum(x, st),
                      K.segmented_cumsum(x.to(dev), st.to(dev)).cpu()),
          "segmented cumsum on the card differs from the CPU")


def profile_solve(packed):
    """One warm ``solve_auto`` under torch.profiler: wall ms, device
    busy ms (the sum of kernel times; one stream, so they do not
    overlap), the device's idle share, kernel launches, and the kernels
    that took the most device time."""
    from torch.profiler import ProfilerActivity, profile

    K.solve_auto(packed, use_kernel=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        K.solve_auto(packed, use_kernel=True)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
    if not kernels:
        return {"wall_ms": wall, "device_busy_ms": "not measured"}
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    bid = sum(e.self_device_time_total for e in kernels
              if "bid_" in e.key) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]
    return {
        "wall_ms": wall, "device_busy_ms": busy, "bid_kernels_ms": bid,
        "idle_share": 1.0 - busy / wall,
        "kernel_launches": sum(e.count for e in kernels),
        "top": [{"kernel": e.key[:100], "count": e.count,
                 "ms": e.self_device_time_total / 1e3} for e in top],
    }


def run_path(packed):
    """Drive solve_auto once with the kernels, launch counts read just
    around the run."""
    BK.bid_dense.launches = 0
    BK.bid_sparse.launches = 0
    t0 = time.perf_counter()
    res = K.solve_auto(packed, use_kernel=True)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches = {"bid_dense": BK.bid_dense.launches,
                "bid_sparse": BK.bid_sparse.launches}
    return res, launches, ms


def same_result(a, b, what):
    for key in ("rounds", "stages", "refills"):
        check(a[key] == b[key], f"{what}: {key} {a[key]} != {b[key]}")
    for key in ("assigned", "node_idle", "queue_allocated"):
        check(a[key].tobytes() == b[key].tobytes(),
              f"{what}: {key} differs between the card and the CPU")


def summarize(res, T):
    a = res.assigned[:T]
    return {"rounds": res.rounds, "stages": res.stages,
            "refills": res.refills, "placed": int((a >= 0).sum())}


def validated(host, res, T, N, what):
    bad, reasons = validate_placements(host, res.assigned, T, N)
    check(bad.size == 0, f"{what}: validation rejected {reasons}")


def ptxas_report(log_text):
    """Registers, shared memory and spill bytes per kernel instance from
    nvcc's ``-Xptxas -v`` report."""
    out, name = {}, None
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            mangled = m.group(1)
            base = re.search(r"\d(bid_(?:dense|sparse)_kernel)", mangled)
            targs = re.search(r"_kernelILi(\d+)ELb([01])E", mangled)
            name = base.group(1) if base else mangled
            if targs:
                r = "any" if targs.group(1) == "0" else targs.group(1)
                flag = "true" if targs.group(2) == "1" else "false"
                name += f"<R={r}, {flag}>"
            out[name] = {}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[name]["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name]["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            out[name]["static_smem_bytes"] = int(sm.group(1)) if sm else 0
    return out


def sass_dense_loop(lib_path):
    """For each R=2 instance of bid_dense_kernel in the built library
    (``cuobjdump -sass``): the instructions of its 16-column group loop
    (the smallest loop that holds a 16-byte load), per cell, and how
    many of them are MUFU (the unit IEEE division would use)."""
    cuobjdump = Path(_build.nvcc_path()).parent / "cuobjdump"
    if not cuobjdump.is_file():
        return "not measured: no cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib_path)],
                          capture_output=True, text=True).stdout
    out = {}
    for part in sass.split("Function : ")[1:]:
        name = part.split()[0]
        targs = re.search(r"16bid_dense_kernelILi2ELb([01])E", name)
        if not targs:
            continue
        ins = [(int(a, 16), op.strip()) for a, op in
               re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]+);", part)]
        loops = []
        for i, (addr, op) in enumerate(ins):
            m = re.search(r"\bBRA\s+(?:\S+,\s*)?0x([0-9a-f]+)", op)
            if m and int(m.group(1), 16) < addr:
                body = [o for a, o in ins
                        if int(m.group(1), 16) <= a <= addr]
                if any("LDG.E.128" in o for o in body):
                    loops.append(body)
        if not loops:
            continue
        body = min(loops, key=len)
        static = "true" if targs.group(1) == "1" else "false"
        out[f"bid_dense_kernel<R=2, {static}>"] = {
            "loop_instructions": len(body),
            "per_cell": len(body) / 16,
            "mufu_in_loop": sum("MUFU" in o for o in body),
        }
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    OUT_DIR.mkdir(exist_ok=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    report = {"device": torch.cuda.get_device_name(0),
              "torch": torch.__version__, "cuda": torch.version.cuda}

    # -- phase 1: build and report ---------------------------------------
    t0 = time.perf_counter()
    build = _build.build()
    report["build"] = {k: build[k] for k in ("path", "built", "seconds")}
    ptxas = build["log"] or (Path(build["path"]).parent
                             / "nvcc.log").read_text()
    (OUT_DIR / "ptxas.log").write_text(ptxas)
    report["ptxas"] = ptxas_report(ptxas)
    check(report["ptxas"], "no kernel in the ptxas report")
    spills = {k: v for k, v in report["ptxas"].items() if v["spill_bytes"]}
    check(not spills, f"ptxas reports spills: {spills}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    report["nvidia_smi"] = smi
    log(f"phase 1: built {build['path']} "
        f"({'compiled' if build['built'] else 'cached'}, "
        f"{build['seconds']:.1f} s)")
    log(smi)
    for kname, info in report["ptxas"].items():
        log(f"phase 1: {kname}: {info['registers']} registers, "
            f"{info['spill_bytes']} bytes spilled")
    report["sass"] = sass_dense_loop(build["path"])
    log(f"phase 1: dense group loop (SASS): {report['sass']}")

    # -- snapshots -----------------------------------------------------------
    check(topk_config(50_000, 5_000).enabled, "topk policy off at 50k x 5k")
    check(not topk_config(10_000, 1_000).enabled, "topk on at 10k x 1k")
    host_s, T_l, N_l = build_snapshot(50_000, 5_000, 5, 500, seed=0, k=64)
    host_d = host_s._replace(
        task_cand=np.zeros_like(host_s.task_cand),
        cand_idx=np.zeros((0, 1), np.int32),
        cand_static=np.zeros((0, 1), np.float32),
        cand_info=np.zeros((3, 0), np.int32),
    )
    host_m, T_m, N_m = build_snapshot(10_000, 1_000, 4, 100, seed=0)
    packed = {name: pack_inputs(h, dev) for name, h in
              (("sparse", host_s), ("staged", host_d), ("full", host_m))}
    report["snapshots"] = {
        "sparse": {"T": T_l, "N": N_l, "Tp": host_s.task_req.shape[0],
                   "Np": host_s.node_idle.shape[0],
                   "classes": int(host_s.cand_idx.shape[0]),
                   "K": int(host_s.cand_idx.shape[1])},
        "full": {"T": T_m, "N": N_m, "Tp": host_m.task_req.shape[0],
                 "Np": host_m.node_idle.shape[0]},
    }
    log(f"snapshots ready ({time.perf_counter() - t0:.1f} s)")

    # -- phase 2: kernels against plain versions ----------------------------
    kern = {"bid_dense": {}, "bid_sparse": {}}
    for name, args in edge_cases(dev):
        compare_kernel(name, args, kern[name])
    r0 = {"bid_sparse": sparse_round0(packed["sparse"]),
          "bid_dense": dense_round0(packed["staged"]),
          "bid_dense_full": dense_round0(packed["full"])}
    compare_kernel("bid_sparse", r0["bid_sparse"], kern["bid_sparse"])
    compare_kernel("bid_dense", r0["bid_dense"], kern["bid_dense"])
    compare_kernel("bid_dense", r0["bid_dense_full"], kern["bid_dense"])
    glue_matches_cpu(dev)
    log(f"phase 2: kernels equal their plain versions on "
        f"{kern['bid_dense']['cases']} dense and "
        f"{kern['bid_sparse']['cases']} sparse cases; glue matches the CPU")

    phases = {}
    # -- phase 3: main path, sparse -------------------------------------------
    res, launches, first_ms = run_path(packed["sparse"])
    check(launches["bid_sparse"] > 0, "phase 3: bid_sparse never launched")
    validated(host_s, res, T_l, N_l, "phase 3")
    t_cpu = time.perf_counter()
    cpu = K.solve_auto(pack_inputs(host_s, "cpu"), use_kernel=True)
    cpu_s = time.perf_counter() - t_cpu
    same_result(res.to_numpy(), cpu.to_numpy(), "phase 3")
    phases["sparse_50k_5k"] = dict(
        summarize(res, T_l), launches=launches, first_ms=first_ms,
        cpu_seconds=cpu_s)
    kern["bid_sparse"]["launches"] = launches["bid_sparse"]
    log(f"phase 3: sparse {phases['sparse_50k_5k']}")

    # -- phase 4: dense staged ----------------------------------------------
    res, launches, first_ms = run_path(packed["staged"])
    check(launches["bid_dense"] > 0, "phase 4: bid_dense never launched")
    check(res.stages is not None, "phase 4: staged solver not taken")
    validated(host_d, res, T_l, N_l, "phase 4")
    phases["staged_50k_5k"] = dict(summarize(res, T_l), launches=launches,
                                   first_ms=first_ms)
    kern["bid_dense"]["launches"] = launches["bid_dense"]
    log(f"phase 4: staged {phases['staged_50k_5k']}")

    # -- phase 5: dense full solve ------------------------------------------
    res, launches, first_ms = run_path(packed["full"])
    check(launches["bid_dense"] > 0, "phase 5: bid_dense never launched")
    check(res.stages is None, "phase 5: full solve not taken")
    validated(host_m, res, T_m, N_m, "phase 5")
    t_cpu = time.perf_counter()
    cpu = K.solve_auto(pack_inputs(host_m, "cpu"), use_kernel=True)
    cpu_s = time.perf_counter() - t_cpu
    same_result(res.to_numpy(), cpu.to_numpy(), "phase 5")
    phases["full_10k_1k"] = dict(summarize(res, T_m), launches=launches,
                                 first_ms=first_ms, cpu_seconds=cpu_s)
    log(f"phase 5: full {phases['full_10k_1k']}")

    # -- phase 6: timings ----------------------------------------------------
    for name, key in (("sparse_50k_5k", "sparse"), ("staged_50k_5k", "staged"),
                      ("full_10k_1k", "full")):
        phases[name]["warm_ms"] = wall_ms(
            lambda p=packed[key]: K.solve_auto(p, use_kernel=True), 3)
        phases[name]["profile"] = profile_solve(packed[key])
    works = {"bid_sparse": sparse_work(r0["bid_sparse"]),
             "bid_dense": dense_work(r0["bid_dense"])}
    records = []
    for name in ("bid_dense", "bid_sparse"):
        args = r0[name]
        fn, plain = getattr(BK, name), getattr(BK, name + "_plain")
        saved = fn.launches
        ms = event_ms(lambda: fn(*args), reps=20)
        dev_ms = device_ms(lambda: fn(*args))
        fn.launches = saved
        plain_ms = event_ms(lambda: plain(*args), reps=3, warm=1)
        nbytes, ops = works[name]
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / FP32_FLOP_PER_S * 1e3
        kern[name].update(ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                          bytes=nbytes, ops=ops)
        records.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name],
            "launches": kern[name]["launches"],
            "max_abs_err": kern[name]["max_abs_err"],
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            # No single PyTorch call computes either bid function.
            "library_ms": None,
            "device_ms": dev_ms,
        })
    report.update(phases=phases, kernels=kern, records=records,
                  seconds=time.perf_counter() - t0)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    for name, ph in phases.items():
        prof = ph["profile"]
        log(f"phase 6: {name}: warm {ph['warm_ms']:.1f} ms, rounds "
            f"{ph['rounds']}, placed {ph['placed']}, launches "
            f"{ph['launches']}; profiled {prof['wall_ms']:.1f} ms wall, "
            f"device busy {prof['device_busy_ms']} ms, idle share "
            f"{prof.get('idle_share', 'not measured')}")
    for rec in records:
        log(f"phase 6: {rec['name']}: {rec['ms']:.4f} ms a launch (events), "
            f"{rec['device_ms']:.4f} ms on the device, L2 flushed (plain "
            f"{rec['plain_ms']:.3f} ms, bound {rec['bound_ms']:.3f} ms by "
            f"{rec['bound_by']}), {rec['launches']} launches; no PyTorch "
            f"call computes it, so library_ms is null")
    log(smi)
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
