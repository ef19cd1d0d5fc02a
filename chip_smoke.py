#!/usr/bin/env python3
"""Drive the PyTorch port's scheduling cycle on one CUDA card and check it.

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
   against the CPU; time the segmented-cumsum kernel (``csrc/scan.cu``)
   against its plain version at T = 1,280 and 4,096 rows of phase 3's R
   (CUDA events, 20 back-to-back calls; the kernel also alone on the
   device, L2 flushed) and require equal bits;
3. main path, sparse: a 50,000-pod x 5,000-node snapshot shaped like
   ``bench.py::build_cluster`` (5 weighted queues, 500 gangs, K=64 slabs
   from the port's host selection) through ``solve_auto`` with the
   kernels; placements validated; the whole result of the same solve at
   12,000 x 1,200 (K=64; slab rounds, refills and a dense stage)
   bit-equal on the card and on the CPU (cut from
   50,000 x 5,000, 59-66 s on the CPU, when phase 14 joined: phase 8
   holds the 50,000 x 5,000 cycle's binds to the CPU's); the
   50,000 x 5,000 solve launches the scan kernel twice a commit;
4. dense staged: the same snapshot without slabs (the path taken when
   class dedup degenerates) through ``solve_auto``; validated;
5. dense full ``solve``: 10,000 x 1,000 (no slabs below 1,024 nodes),
   bit-equal to the CPU;
6. timings: warm medians per phase, a profiled solve per phase, and at
   the main path's shapes each kernel's time per launch over 20
   back-to-back wrapper calls (CUDA events: ``ms``), its device time per
   launch with the L2 flushed before each (``device_ms``), the plain
   versions' times and each kernel's bound;
7. cycle: the system's own path from a cluster to validated placements,
   by hand: ``build_cluster(10000, 1000, 4, 100, seed=0)`` in the port's
   ``SchedulerCache`` → ``open_session`` with the default tiers →
   ``tensorize`` packed through the device-resident cache onto ``cuda``
   → ``solve_auto`` (``bid_dense``) → ``validate_placements`` →
   ``close_session``; the pack equals ``pack_inputs`` of the host
   bundle and the result equals the same solve on the CPU. Then one
   churn cycle: 1 % of pending pods deleted and as many added, the
   previous cycle's first 1 % of placements bound through
   ``cache.bind``, 1 % of nodes updated; the pack must patch in place
   and equal a cold pack, the solve the CPU's. Warm medians of 3 for
   the snapshot, ``open_session``, ``tensorize`` (host; the candidate
   selection within it), the pack (full and patched), the solve and
   the validation. (50,000 x 5,000 and three churn cycles until the
   scheduler phases joined; cut to this size for time: phase 8 drives
   50,000 x 5,000 through the scheduler loop, phase 10 through the
   process);
8. the scheduler loop: ``Scheduler(cache, TPU policy, device="cuda")
   .run_once()`` (``allocate_tpu``: warm plan, ``tensorize`` with the
   device pack, the solve on the device worker, the overlap window, the
   deadline-bounded fetch down the ladder, validation, the grouped
   apply, the Releasing epilogue, verdicts; then ``backfill``) over
   bench.py's ``bench_cycle`` cycles: cold, steady, idle and a 1 % gang
   burst, at 50,000 x 5,000 (``bid_sparse``) and 10,000 x 1,000
   (``bid_dense``), twice on the card (candidate selection on the
   device, then with ``KBT_SELECT_DEVICE=0`` on the host) and once on
   the CPU. Every solving cycle must run on ``torch-cuda`` on one ``ok``
   rung (``sparse``, resp. ``dense``) with its kernel launched, no
   breaker pin, no ladder descent and no rejected placement; at 50,000
   x 5,000 the cold and delta cycles select on the device
   (``select_path == "device"``) and their slabs equal the host
   selection's; the (pod, node) binds must equal the CPU run's; the
   census stays flat from the cold cycle through the idle one. Per
   cycle the selection's time, the action's phases
   (``tensorize``, ``solve`` = launch + overlap + block, ``apply``,
   ``epilogue``, ``verdicts``) and the flight record's (``open``,
   ``backfill``, ``close``, the whole cycle), the warm outcome and the
   device pack's outcome;
9. the ladder on the card at 50,000 x 5,000 through
   ``containment.set_device_fault_hook``: (a) a raise at the first
   ``"solve"`` descends ``sparse -> dense`` on the card (``bid_dense``
   launched) and binds what a clean dense solve binds; (b) a hook that
   sleeps past a 0.5 s budget ends on the native floor with the breaker
   open; the next cycle is pinned to the floor, and after
   ``reset_breaker()`` the next device pack is a full upload labelled
   ``solve-abandoned``. Run twice: once with the abandoned worker
   joined before the next cycle, once with it held mid-rounds until
   that cycle has packed and launched, so both solves issue rounds at
   once; the binds after every cycle must be the same in both runs;
10. the process on the card: (1) ``python -m kube_batch_tpu_torch
   --cluster-state config/example-cluster.yaml --scheduler-conf <TPU
   policy> --once`` in a subprocess binds the example gang of 3 on
   ``torch-cuda``; (2) ``cli.run`` in loop mode (period 0.5 s) over an
   ``InProcessCluster`` filled with phase 8's clusters, stopped by a
   thread that polls ``/debug/vars`` after at least 3 cycles: every
   cycle healthy on the card, the first solving cold with the kernel
   (device selection at 50,000 x 5,000), gangs all or nothing, and the
   binds equal phase 8's CPU binds after its idle cycle; (3) in the
   10,000 x 1,000 loop, a pod created and a bind made with the cache's
   watch detached: the sweep reports ``missed-pod`` and
   ``missed-bind`` and a card cycle binds the pod; a successor process
   (``--once``, file lease) over a fenced predecessor's bind-intent
   journal reports the CPU run's ``reconcile_journal`` and binds on the
   card;
11. the simulator (``kube_batch_tpu_torch.sim.ClusterSimulator``), each
   run once on the card and once on the CPU in this process: (1) the
   reference's smoke seeds (seed 5, 60 cycles, 10 nodes, bind and
   node-flap faults, dense): card trace = CPU trace (records after the
   header, quality cards through ``replay_view``, integrity blocks
   aside), ``bid_dense`` launched; its replay on the card under sparse
   K=16 has no mismatch and launches ``bid_sparse``; (2) the Makefile's
   chaos and diverge mixes (seeds 11 and 15, 120 cycles, dense) and a
   failover drill (seed 13, 70 cycles, a leader killed at each of the
   four cut points, hangs added): no violation or cycle error, every
   fault kind injected, the breaker re-closed, card placements = CPU
   placements, every timed-out solve drops its leader's resident
   buffers, the successors solve on the card; (3) 5,000 nodes of
   ``bench.py::build_cluster``'s shape, 400 gang arrivals a cycle, up to
   4,000 jobs, bind faults, ``auto``, 8 cycles (16 cost 33-82 s a
   device, most of it the harness's host work; cut for phase 12's
   time): card trace = CPU trace,
   ``bid_sparse`` launched, selection on the device; per cycle the
   ``run_once`` time, the solve time and the placements. A failed check
   of phase 11 is kept and the phase goes on; it fails at its end.
   ``python3 chip_smoke.py --phase 11`` runs phases 1 and 11 alone and
   prints no result line;
12. the real-cluster process and the perf harness on the card: (1)
   ``perf.run_density`` with the TPU policy at the reference's kubemark
   scale (3,000 pods on 100 hollow nodes, gangs of 10) and at 50,000 x
   5,000: every pod Running, every gang whole, every solving cycle
   (periodic or micro) on ``torch-cuda`` on one ``ok`` rung, a bid
   kernel launched; the four latency distributions and pods per second
   are recorded; (2) ``perf.run_multitenant_compare`` on 100 nodes:
   both loops backfill the best-effort pods and evict from tenant A
   with every gang whole and no node over capacity, the greedy loop
   admits all of tenant B and launches no kernel, the ``allocate_tpu``
   loop launches a bid kernel on healthy cycles (how much of B it
   admits depends on timing at this size, in the reference too, and is
   recorded); (3) 5,000 x 500 of ``build_cluster``'s shape (4 queues,
   50 gangs of 100; bench.py ``medium`` at half its size, cut from
   10,000 x 1,000 for time when phase 14 joined) as API documents in a
   ``FakeKube`` in this process, and
   ``python -m kube_batch_tpu_torch --master URL --once`` in a
   subprocess on the card, then with ``--device cpu`` against a fresh
   FakeKube: ``bid_dense`` launched, gangs whole, no node over
   capacity, the bindings equal; (4) the Lease failover: leader A
   (``--leader-elect``, loop mode) over the same cluster with its last
   10 gangs pending and each bind POST held 5 ms, killed with SIGKILL
   once the Lease annotation journals its bind intent and a third of
   that intent's pods are bound; B (``--once``), started once A leads,
   takes the Lease after it expires, reconciles A's journal, binds the
   rest on the card and leaves the journal empty and the Lease free; no
   pod bound twice, no node over capacity, every gang whole, every pod
   bound. ``python3 chip_smoke.py --phase 12`` runs phases 1 and 12
   alone and prints no result line;
13. the mesh on the card, virtual shards of ``cuda:0``
   (``solver/collectives.Mesh``; the sharded bodies run the plain
   chain, so no bid kernel may launch in them): (1) the node-sharded
   dense solve on 2, 4 and 8 shards at 10,000 x 1,000 (commit-style
   rounds), 4,000 x 1,000 (pool style) and staged at 50,000 x 5,000,
   each equal to the card's single-device ``use_kernel=False`` solve and
   (but the staged one) to the same sharded solve on the CPU on 4
   shards; ``flat`` and ``two-level`` forced at 50,000 x 5,000 on 2, 4
   and 8 shards (flat = the card's ``solve_sparse(use_kernel=False)``,
   two-level valid and reconciled; forced two-level on 4 shards at
   10,000 x 2,048 equal to the CPU, cut from 50,000 x 5,000 for time),
   then the policy's own sizes on 4 shards: flat at 100,000 x 10,000 =
   the single-device chain, two-level at 524,288 x 20,480 valid and the
   same over two runs; the commit bytes and reconcile rounds; (2)
   ``Scheduler.run_once`` at 50,000 x 5,000: unforced under 4 shards it
   dispatches ``single``, launches ``bid_sparse`` and binds what the
   mesh-less run binds; forced flat on the plain chain it reports
   ``sparse_sharded_engaged``, mode ``flat``, 4 shards and binds what the
   mesh-less plain chain binds; a cycle after 4 -> 2 shards reads the
   warm plan's ``mesh-changed``; (3) ``sim --host-devices 4 --backend
   sparse --topk 8`` (flat forced, 20 cycles, 12 nodes): card trace =
   CPU trace; ``sim-study --preset twolevel`` on the card (1 seed, 20
   cycles); (4) ``init_distributed`` on NCCL, world size 1, 4 virtual
   shards: the solve = the single-device one; (5) where there are two or
   more cards, (1)'s dense and flat cases on a mesh of distinct cards,
   else a line that says it was not run. ``python3 chip_smoke.py
   --phase 13`` runs phases 1 and 13 alone and prints no result line;
14. the benchmark entry point, bench.py's sections on the port
   (``kube_batch_tpu_torch.bench``): (1) ``python -m
   kube_batch_tpu_torch.bench --smoke`` in a subprocess: exit 0, the
   sparse path engaged on ``torch-cuda``; (2) ``bench.main(["--quick"])``
   in this process (``medium``, 10,000 x 1,000: the headline solve with
   ``bid_dense``, the native baseline, ``bench_cycle``'s cycles with the
   obs and quality sections, the device cache, the simulator, recovery,
   latency, serving and integrity sections): ``device_provenance``
   names the card, no section holds ``error``, and the headline's
   placed, rounds and assignment equal ``bench_tpu`` on the CPU on the
   same (kernel) chain; (3) ``bench_sparse_scale("200000x20000")``:
   device selection's slabs equal the host's, the device solve
   (``bid_sparse``) validates clean, the native solve beside it.
   ``python3 chip_smoke.py --phase 14`` runs phases 1 and 14 alone and
   prints no result line;
15. the reference's last tools on the card (``kube_batch_tpu_torch.tools``),
   15.1-15.3 at once: (1) ``tools.soak`` in this process with the TPU
   policy (50 nodes, period 0.2 s, 1.5 minutes of gang churn and node
   flaps): exit 0, at least half the nominal cycles, every solving cycle
   on ``torch-cuda`` on one ``ok`` rung with ``bid_dense`` launched, no
   breaker pin or trip, ``torch.cuda.memory_allocated`` at the end within
   16 MiB of its value after the first solving cycle; (2) ``python -m
   kube_batch_tpu_torch sim --soak`` at the Makefile's soak-smoke mix
   (seed 3, 2,000 cycles) with ``--backend dense`` and ``native`` in
   subprocesses: exit 0, no detector tripped, the CUDA allocator series
   fitted under ``dense``; (3) ``tools.latency_smoke`` with the native
   and the dense backend on the card and the dense one on the CPU: exit
   0 each, the dense audit stream on the card byte-equal to the CPU's
   once its records' ``"backend": "torch-cuda"`` reads ``torch-cpu``;
   then (4) ``tools.multichip_50k``'s stages on 8 virtual shards of the
   card, 50,000 x 5,120 staged and 10,000 x 1,001 full: sharded = single
   device, placed, rounds and best-of-2 times. ``python3 chip_smoke.py
   --phase 15`` runs phases 1 and 15 alone and prints no result line.

Each phase sets the kernels' launch counters to 0 just before it drives
the path and reads them just after (phase 7: around each cycle, from
``open_session`` to the solve; phases 8 and 10: around each
``run_once``; 10.1, 12.3 and 12.4: each subprocess starts from 0;
phase 11: after each simulator's construction, whose warm-up solves
launch both; 12.1 and 12.2: around each periodic and micro cycle; phase
13: around each solve and ``run_once``; phase 14: around 14.2 and
around 14.3, 14.1 starting from 0 in its subprocess; phase 15: around
the soak and each stage of 15.4, 15.2-15.3 in their subprocesses). The
kernels' ``launches`` in the JSON record are phase 8's first card run
(the four cycles at the kernel's size); ``phase14_launches`` are 14.2's
and 14.3's together, ``phase15_launches`` the soak's. The next-to-last line of
standard output is the kernels' JSON record, the last
``{"ok": true, ...}``.
Details go to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import contextlib
import gc
import hashlib
import io
import json
import os
import re
import statistics
import socket
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import torch

import kube_batch_tpu_torch.plugins  # noqa: F401 (registers the plugins)
from kube_batch_tpu_torch import device as DEV
from kube_batch_tpu_torch import metrics
from kube_batch_tpu_torch.actions import allocate_tpu as ATPU
from kube_batch_tpu_torch.api import (
    GROUP_NAME_ANNOTATION_KEY,
    PodPhase,
    build_resource_list,
)
from kube_batch_tpu_torch.cluster.kube import KubeCluster, KubeConfig
from kube_batch_tpu_torch.framework import close_session, open_session
from kube_batch_tpu_torch.native import greedy as NATIVE
from kube_batch_tpu_torch.obs import RECORDER
from kube_batch_tpu_torch.obs.quality import replay_view
from kube_batch_tpu_torch.scheduler import Scheduler
from kube_batch_tpu_torch.solver import _build
from kube_batch_tpu_torch.solver import bid_kernels as BK
from kube_batch_tpu_torch.solver import containment
from kube_batch_tpu_torch.solver import device_cache as DC
from kube_batch_tpu_torch.solver import kernels as K
from kube_batch_tpu_torch.solver import select_device as SD
from kube_batch_tpu_torch.solver import sharding as SH
from kube_batch_tpu_torch.solver import snapshot as S
from kube_batch_tpu_torch.solver import spmd as SP
from kube_batch_tpu_torch.solver import topk as TK
from kube_batch_tpu_torch.solver.collectives import Mesh
from kube_batch_tpu_torch.solver.masks import CombinedMask
from kube_batch_tpu_torch.solver.snapshot import pack_inputs
from kube_batch_tpu_torch.solver.topk import select_candidates, topk_config
from kube_batch_tpu_torch.sim import SimConfig, TraceReader, WorkloadSpec
from kube_batch_tpu_torch.sim.harness import ClusterSimulator
from kube_batch_tpu_torch.sim.trace import canon
from kube_batch_tpu_torch.solver.validate import validate_placements
from kube_batch_tpu_torch.utils.fake_kube import FakeKube
from kube_batch_tpu_torch.utils.test_utils import (
    DEFAULT_TIERS_ARGS,
    add_gang_burst,
    bench_objects,
    build_cluster,
    build_in_process_cluster,
    build_node,
    build_pod,
    build_pod_group,
    build_queue,
    make_tiers,
)

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

# Phase 3 holds the sparse solve card = CPU at this build_cluster shape.
CPU_SPARSE = (12_000, 1_200, 4, 120)
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


def scan_kernel_step(dev, R):
    """The segmented-cumsum kernel against its plain version on the card
    at a slab round's rows (1,280) and a tile's (4,096): equal bits, each
    one's time a call over 20 back-to-back calls (CUDA events), and the
    kernel's device time with the L2 flushed (``device_ms``)."""
    rng = np.random.RandomState(1)
    out = {}
    for T in (1280, 4096):
        x = torch.from_numpy((rng.choice([4097.0, 8191.0, 0.3], (T, R))
                              * 997).astype(np.float32)).to(dev)
        st = torch.from_numpy(rng.rand(T) < 0.05).to(dev)
        st[0] = True
        saved = K.segmented_cumsum.launches
        got = K.segmented_cumsum(x, st)
        want = K._segmented_cumsum_plain(x, st)
        check(torch.equal(got.view(torch.int32), want.view(torch.int32)),
              f"scan kernel differs from plain at T={T}, R={R}")
        ms = event_ms(lambda: K.segmented_cumsum(x, st), reps=20)
        dev_ms = device_ms(lambda: K.segmented_cumsum(x, st))
        K.segmented_cumsum.launches = saved
        plain_ms = event_ms(lambda: K._segmented_cumsum_plain(x, st),
                            reps=20)
        out[f"T{T}_R{R}"] = {"ms": ms, "device_ms": dev_ms,
                             "plain_ms": plain_ms}
    return out


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
    around the run; ``commits`` counts its conflict resolutions (two
    scans each)."""
    BK.bid_dense.launches = 0
    BK.bid_sparse.launches = 0
    K.segmented_cumsum.launches = 0
    resolve = K._resolve_bids
    commits = 0

    def counted(*args, **kwargs):
        nonlocal commits
        commits += 1
        return resolve(*args, **kwargs)

    K._resolve_bids = counted
    try:
        t0 = time.perf_counter()
        res = K.solve_auto(packed, use_kernel=True)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
    finally:
        K._resolve_bids = resolve
    launches = {"bid_dense": BK.bid_dense.launches,
                "bid_sparse": BK.bid_sparse.launches,
                "segmented_cumsum": K.segmented_cumsum.launches,
                "commits": commits}
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
            base = re.search(r"\d(bid_(?:dense|sparse)_kernel"
                             r"|seg_cumsum(?:_tiled)?_kernel)", mangled)
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


# ---------------------------------------------------------------------------
# Phase 7: the scheduling cycle through the system's own entry points.
# ---------------------------------------------------------------------------


class CycleClock:
    """Host clocks around the cycle's layers, each read after a
    synchronize where it brackets device work: the cache snapshot
    (inside ``open_session``), the candidate selection and the device
    pack (inside ``tensorize``) are timed by wrapping them for the
    clock's lifetime."""

    def __init__(self, cache):
        self.cache = cache
        self.ms = {}

    def __enter__(self):
        orig_snapshot = self.cache.snapshot
        orig_pack = DC.DeviceSnapshotCache.pack
        clock = self

        def snapshot(*args, **kwargs):
            t0 = time.perf_counter()
            out = orig_snapshot(*args, **kwargs)
            clock.ms["snapshot_ms"] = (time.perf_counter() - t0) * 1e3
            return out

        orig_select = TK.select_candidates

        def select(*args, **kwargs):
            t0 = time.perf_counter()
            out = orig_select(*args, **kwargs)
            clock.ms["select_ms"] = (time.perf_counter() - t0) * 1e3
            return out

        def pack(dc, arrays, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = orig_pack(dc, arrays, **kwargs)
            torch.cuda.synchronize()
            clock.ms["pack_ms"] = (time.perf_counter() - t0) * 1e3
            return out

        self._orig = (orig_pack, orig_select)
        self.cache.snapshot = snapshot
        DC.DeviceSnapshotCache.pack = pack
        TK.select_candidates = select
        return self

    def __exit__(self, *exc):
        del self.cache.snapshot
        DC.DeviceSnapshotCache.pack, TK.select_candidates = self._orig
        return False


def drive_cycle(cache, tiers):
    """One cycle: open_session → tensorize (packed onto the cache's
    device) → solve_auto with the kernels → validate_placements →
    close_session. Launch counters are zeroed before open_session and
    read after the solve."""
    BK.bid_dense.launches = 0
    BK.bid_sparse.launches = 0
    with CycleClock(cache) as clock:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ssn = open_session(cache, tiers)
        t1 = time.perf_counter()
        packed, ctx = S.tensorize(ssn)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        tstats = dict(S.last_tensorize_stats)
        pstats = dict(DC.last_pack_stats)
        res = K.solve_auto(packed, use_kernel=True)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        launches = {"bid_dense": BK.bid_dense.launches,
                    "bid_sparse": BK.bid_sparse.launches}
        T, N = len(ctx.tasks), len(ctx.nodes)
        bad, reasons = validate_placements(ctx.host_inputs, res.assigned,
                                           T, N)
        t4 = time.perf_counter()
        close_session(ssn)
        ms = dict(clock.ms)
    ms.update(open_session_ms=(t1 - t0) * 1e3,
              tensorize_ms=(t2 - t1) * 1e3,
              tensorize_host_ms=(t2 - t1) * 1e3 - ms["pack_ms"],
              solve_ms=(t3 - t2) * 1e3, validate_ms=(t4 - t3) * 1e3)
    check(bad.size == 0, f"phase 7: validation rejected {reasons}")
    return {"packed": packed, "ctx": ctx, "res": res, "ms": ms,
            "launches": launches, "tensorize": tstats, "pack": pstats,
            "T": T, "N": N}


def cold_pack(host, dev):
    """A pack of ``host`` into a fresh device cache, timed."""
    arrays = S.stack_inputs(host)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    packed = DC.DeviceSnapshotCache(dev).pack(arrays)
    torch.cuda.synchronize()
    return packed, (time.perf_counter() - t0) * 1e3


def check_cycle(cyc, dev, what, cold=None):
    """The resident pack equals ``pack_inputs`` of the host bundle (and
    a cold pack, when given) field by field, and the card's result
    equals the CPU's bit for bit."""
    host = cyc["ctx"].host_inputs
    want = pack_inputs(host, dev)
    for f in K.PackedInputs._fields:
        got = getattr(cyc["packed"], f)
        check(torch.equal(got, getattr(want, f)),
              f"{what}: resident {f} differs from pack_inputs")
        if cold is not None:
            check(torch.equal(got, getattr(cold, f)),
                  f"{what}: patched {f} differs from a cold pack")
    t0 = time.perf_counter()
    cpu = K.solve_auto(pack_inputs(host, "cpu"), use_kernel=True)
    cpu_s = time.perf_counter() - t0
    same_result(cyc["res"].to_numpy(), cpu.to_numpy(), what)
    return cpu_s


def cycle_summary(cyc):
    res, T = cyc["res"], cyc["T"]
    out = dict(summarize(res, T), T=T, N=cyc["N"],
               Tp=int(cyc["packed"].task_f32.shape[1]),
               classes=cyc["tensorize"]["sparse"].get("classes", 0),
               slab_rows=int(cyc["packed"].cand_idx.shape[0]),
               launches=cyc["launches"], ms=cyc["ms"],
               tensorize=cyc["tensorize"],
               pack={k: cyc["pack"][k] for k in (
                   "reuses", "patches", "uploads", "rows_patched",
                   "bytes_shipped", "bytes_total", "field_outcomes")})
    return out


LAYERS = ("snapshot_ms", "open_session_ms", "tensorize_host_ms",
          "select_ms", "pack_ms", "solve_ms", "validate_ms")


def medians(cycles):
    """Median of each layer's time over ``cycles`` (the layers every
    cycle ran: selection runs only when the bundle carries slabs)."""
    return {k: statistics.median(c["ms"][k] for c in cycles)
            for k in LAYERS if all(k in c["ms"] for c in cycles)}


def churn(cache, cyc, rng, cycle):
    """1 % of pending pods deleted and as many added in new gangs, the
    previous cycle's first 1 % of placements bound through cache.bind,
    1 % of nodes updated (allocatable CPU 32 → 31)."""
    ctx, T = cyc["ctx"], cyc["T"]
    n = max(1, T // 100)
    deleted = set()
    for t in ctx.tasks[::100][:n]:
        cache.delete_pod(t.pod)
        deleted.add(t.uid)
    per_gang = 100
    for g in range(-(-n // per_gang)):
        name = f"churn{cycle}-{g}"
        cache.add_pod_group(build_pod_group(
            name, namespace="bench", min_member=1, queue=f"q{g % 5}"))
        for i in range(min(per_gang, n - g * per_gang)):
            cache.add_pod(build_pod(
                "bench", f"{name}-p{i}", "", PodPhase.PENDING,
                build_resource_list(
                    cpu=f"{int(rng.choice([250, 500, 1000, 2000, 4000]))}m",
                    memory=f"{int(rng.choice([256, 512, 1024, 4096, 8192]))}Mi",
                ),
                group_name=name))
    assigned = cyc["res"].assigned[:T].cpu().numpy()
    placed = [i for i in np.flatnonzero(assigned >= 0)
              if ctx.tasks[i].uid not in deleted][:n]
    for i in placed:
        cache.bind(ctx.tasks[i], ctx.nodes[int(assigned[i])].name)
    check(cache.wait_for_side_effects(), "phase 7: binds did not drain")
    check(cache.wait_for_bookkeeping(), "phase 7: bookkeeping did not drain")
    names = sorted(cache.nodes)
    for j in range(0, len(names), 100):
        old = cache.nodes[names[j]].node
        cache.update_node(old, build_node(names[j], build_resource_list(
            cpu="31", memory="128Gi", pods=110)))
    return {"deleted": len(deleted), "added": n, "bound": len(placed),
            "nodes_updated": len(range(0, len(names), 100))}


# Phase 7's clusters: (name, build_cluster arguments, kernel of the
# path). 10k x 1k only, to keep the script inside half its time limit:
# at 50k x 5k each cycle also solved on the CPU (~40 s).
CYCLES = (
    ("b_10k_1k", (10_000, 1_000, 4, 100), "bid_dense"),
)


def run_cycles(dev):
    """Phase 7: the cycle by hand at 10k×1k, then one churn cycle."""
    tiers = make_tiers(*DEFAULT_TIERS_ARGS)
    out = {}
    n_fields = len(K.PackedInputs._fields)
    for name, shape, kernel in CYCLES:
        t0 = time.perf_counter()
        cache = build_cluster(*shape, seed=0)
        build_s = time.perf_counter() - t0
        DC.device_cache_of(cache, dev)
        first = drive_cycle(cache, tiers)
        what = f"phase 7 {name}"
        check(first["launches"][kernel] > 0, f"{what}: {kernel} never launched")
        check(first["pack"]["uploads"] == n_fields,
              f"{what}: the first pack did not upload every field")
        cpu_s = check_cycle(first, dev, what)
        warm = [drive_cycle(cache, tiers) for _ in range(3)]
        for w in warm:
            check(w["pack"]["reuses"] == n_fields,
                  f"{what}: an unchanged cycle did not reuse every buffer")
            check(w["launches"][kernel] > 0, f"{what}: {kernel} not launched")
            same_result(w["res"].to_numpy(), first["res"].to_numpy(), what)
        fulls = [cold_pack(first["ctx"].host_inputs, dev)[1]
                 for _ in range(3)]
        rec = {
            "build_cluster_s": build_s, "cpu_solve_s": cpu_s,
            "first": cycle_summary(first),
            "warm_ms": medians(warm),
            "pack_full_ms": statistics.median(fulls),
            "pack_full_bytes": first["pack"]["bytes_shipped"],
        }
        # One churn cycle: the pack patches in place.
        events = churn(cache, first, np.random.RandomState(1), 0)
        cyc = drive_cycle(cache, tiers)
        cw = f"{what} churn"
        check(cyc["launches"][kernel] > 0, f"{cw}: {kernel} idle")
        check(cyc["pack"]["patches"] > 0, f"{cw}: nothing patched")
        check(cyc["pack"]["uploads"] < n_fields,
              f"{cw}: every field re-uploaded")
        cold, _ = cold_pack(cyc["ctx"].host_inputs, dev)
        cs = check_cycle(cyc, dev, cw, cold=cold)
        churned = [dict(cycle_summary(cyc), events=events, cpu_solve_s=cs)]
        rec["churn"] = churned
        rec["pack_patched_ms"] = cyc["ms"]["pack_ms"]
        rec["pack_patched_bytes"] = cyc["pack"]["bytes_shipped"]
        rec["churn_ms"] = medians(churned)
        cache.shutdown()
        out[name] = rec
        log(f"phase 7: {name}: {json.dumps(rec['warm_ms'])}; pack full "
            f"{rec['pack_full_ms']:.3f} ms ({rec['pack_full_bytes']} B); "
            f"first {json.dumps({k: v for k, v in rec['first'].items() if k not in ('tensorize', 'pack')})}")
        log(f"phase 7: {name} churn: {json.dumps(rec['churn_ms'])}; "
            f"pack patched {rec['pack_patched_ms']:.3f} ms "
            f"({rec['pack_patched_bytes']} B); "
            + "; ".join(json.dumps(c["pack"]) for c in rec["churn"]))
    return out


# -- phases 8 and 9: the scheduler loop -----------------------------------------

TPU_CONF = "config/tpu-batch-conf-tpu.yaml"

# Phase 8's clusters, bench.py's ``large`` and ``medium``: (name,
# build_cluster arguments, kernel of the path, the rung every solving
# cycle must take).
SCHED_CLUSTERS = (
    ("large_50k_5k", (50_000, 5_000, 5, 500), "bid_sparse", "sparse"),
    ("medium_10k_1k", (10_000, 1_000, 4, 100), "bid_dense", "dense"),
)
SCHED_CYCLES = ("cold", "steady", "idle", "delta")
# last_stats keys printed per cycle (the solve split into its launch,
# overlap window and block point).
STAT_PHASES = ("tensorize_ms", "solve_ms", "solve_launch_ms", "overlap_ms",
               "solve_block_ms", "apply_ms", "epilogue_ms", "verdicts_ms")


@contextlib.contextmanager
def environ(**values):
    """Set environment variables for the block, then restore them."""
    saved = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


class LoopClock:
    """Time spent around one ``run_once`` outside its actions: garbage
    collection pauses (``gc.callbacks``; the loop defers collection
    during the cycle and collects the young generations when it ends),
    and the quality scorecard and telemetry feeds that follow the
    cycle's flight record."""

    def __init__(self):
        self.ms = {"gc_ms": 0.0, "quality_ms": 0.0, "telemetry_ms": 0.0}
        self._gc_t0 = None

    def _gc(self, phase, info):
        if phase == "start":
            self._gc_t0 = time.perf_counter()
        elif self._gc_t0 is not None:
            self.ms["gc_ms"] += (time.perf_counter() - self._gc_t0) * 1e3
            self._gc_t0 = None

    def _timed(self, key, fn):
        def run(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                self.ms[key] += (time.perf_counter() - t0) * 1e3
        return run

    def __enter__(self):
        from kube_batch_tpu_torch.obs import QUALITY, TELEMETRY

        gc.callbacks.append(self._gc)
        self._feeds = ((QUALITY, "annotate_cycle", "quality_ms"),
                       (TELEMETRY, "observe_scheduler_cycle", "telemetry_ms"))
        for obj, name, key in self._feeds:
            setattr(obj, name, self._timed(key, getattr(obj, name)))
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self._gc)
        for obj, name, _ in self._feeds:
            delattr(obj, name)


class SelectionLog:
    """Records every ``topk.select_candidates`` call while it lasts: its
    host time (the device path ends in a device->host read, so the
    clock brackets its device work), its ``select_path`` and a digest
    of the slabs it produced (``task_cand``, ``cand_idx``,
    ``cand_static``, ``cand_info``)."""

    def __init__(self):
        self.calls = []

    def __enter__(self):
        self._orig = orig = TK.select_candidates

        def select(*args, **kwargs):
            t0 = time.perf_counter()
            out = orig(*args, **kwargs)
            ms = (time.perf_counter() - t0) * 1e3
            rec = {"ms": ms, "path": None, "digest": None}
            if out is not None:
                h = hashlib.blake2b(digest_size=16)
                for f in ("task_cand", "cand_idx", "cand_static",
                          "cand_info"):
                    h.update(np.ascontiguousarray(getattr(out, f)).tobytes())
                rec.update(path=out.stats["select_path"],
                           digest=h.hexdigest(),
                           hits=out.stats["sel_cache_hits"],
                           rows_rebuilt=out.stats.get("sel_rows_rebuilt"),
                           cols_patched=out.stats.get("sel_cols_patched"))
            self.calls.append(rec)
            return out

        TK.select_candidates = select
        return self

    def __exit__(self, *exc):
        TK.select_candidates = self._orig
        return False


def scheduler_cycle(sched, dev):
    """One ``Scheduler.run_once`` with the launch counters zeroed just
    before and read just after; the binder is drained afterwards,
    outside the timed region."""
    BK.bid_dense.launches = 0
    BK.bid_sparse.launches = 0
    fallbacks = metrics.metrics.solver_fallback.total()
    _sync(dev)
    with LoopClock() as loop, SelectionLog() as sel:
        t0 = time.perf_counter()
        sched.run_once()
        _sync(dev)
        wall_ms = (time.perf_counter() - t0) * 1e3
    launches = {"bid_dense": BK.bid_dense.launches,
                "bid_sparse": BK.bid_sparse.launches}
    stats = dict(ATPU.last_stats)
    rec = RECORDER.snapshot()[-1]
    check(sched.cache.wait_for_side_effects(timeout=600.0),
          "phase 8: binds did not drain")
    ph = rec.get("phases_ms", {})
    times = {"open_ms": ph.get("open_session"),
             "allocate_tpu_ms": ph.get("action:allocate_tpu"),
             "backfill_ms": ph.get("action:backfill"),
             "close_ms": ph.get("close_session"),
             "cycle_ms": rec.get("e2e_ms"), "wall_ms": wall_ms}
    times.update(loop.ms)
    times.update({k: stats[k] for k in STAT_PHASES if k in stats})
    return {
        "stats": stats, "launches": launches, "ms": times,
        "new_fallbacks": metrics.metrics.solver_fallback.total() - fallbacks,
        "warm": stats.get("warm_outcome"),
        "pack": {k[len("device_"):]: v for k, v in stats.items()
                 if k.startswith("device_")},
        "select": sel.calls,
        "census": {"builds": _build.build_calls, "selection": SD.census()},
    }


def check_healthy(cyc, kernel, rung, backend, what):
    """A solving cycle ran on ``backend`` on one ``ok`` rung, launched
    ``kernel`` (on the card), and neither the ladder nor the breaker
    engaged; a cycle that solved nothing engaged neither either."""
    st = cyc["stats"]
    check(not st.get("breaker_pinned"), f"{what}: breaker pinned")
    check(cyc["new_fallbacks"] == 0, f"{what}: the ladder descended")
    check("validation_rejected" not in st, f"{what}: validation rejected")
    if "backend" not in st:
        return False
    check(st["backend"] == backend,
          f"{what}: solved on {st['backend']}, not {backend}")
    check(st["solve_ladder"] == [{"rung": rung, "outcome": "ok"}],
          f"{what}: ladder {st['solve_ladder']}")
    if backend == "torch-cuda":
        check(cyc["launches"][kernel] > 0, f"{what}: {kernel} not launched")
    return True


def run_scheduler(shape, dev, kernel, rung, what, host_select=False):
    """bench_cycle's four cycles through ``Scheduler.run_once`` with the
    TPU policy on a fresh seeded cluster; returns the per-cycle records
    and the final (pod, node) binds. ``host_select`` closes the device
    selection gate (``KBT_SELECT_DEVICE=0``) for the run."""
    n_tasks, _, n_queues, n_groups = shape
    cache = build_cluster(*shape, seed=0)
    sched = Scheduler(cache, TPU_CONF, device=dev)
    if dev.type == "cpu":
        # The CPU solve at 50k x 5k takes tens of seconds: widen the
        # fetch deadline so the comparison run never descends the ladder.
        containment.configure(solve_budget=3600.0)
    backend = f"torch-{dev.type}"
    rng = np.random.RandomState(1)  # bench_cycle: seed + 1
    cycles = {}
    gate = {SD.SELECT_DEVICE_ENV: "0"} if host_select else {}
    try:
        with environ(**gate):
            for name in SCHED_CYCLES:
                if name == "delta":
                    add_gang_burst(cache, rng, "pgd",
                                   max(1, n_groups // 100),
                                   n_tasks // n_groups, n_queues)
                cyc = scheduler_cycle(sched, dev)
                cyc["solved"] = check_healthy(cyc, kernel, rung, backend,
                                              f"{what} {name}")
                cyc["binds"] = dict(cache.binder.binds)
                cycles[name] = cyc
        binds = dict(cache.binder.binds)
    finally:
        containment.configure(None)
        cache.shutdown()
    check(cycles["cold"]["solved"] and cycles["delta"]["solved"],
          f"{what}: the cold and delta cycles must solve")
    # The census: builds of the bid library flat across the four
    # cycles; selection's shape buckets flat from the cold cycle through
    # the steady and idle ones, and the delta cycle may mint at most a
    # new row bucket and a new column bucket.
    builds = {c["census"]["builds"] for c in cycles.values()}
    check(len(builds) == 1 and (dev.type == "cpu" or min(builds) >= 1),
          f"{what}: the bid-library census moved across cycles: {builds}")
    sel = [cycles[c]["census"]["selection"] for c in SCHED_CYCLES]
    check(sel[0] == sel[1] == sel[2] and sel[3] - sel[2] <= 2,
          f"{what}: the selection census moved across steady cycles: {sel}")
    for name, cyc in cycles.items():
        want = "host" if host_select else "device"
        for rec in cyc["select"]:
            check(rec["path"] == want,
                  f"{what} {name}: select_path {rec['path']}, not {want}")
    return cycles, binds


def cycle_line(cyc):
    ms = {k: (round(v, 3) if isinstance(v, float) else v)
          for k, v in cyc["ms"].items()}
    st = cyc["stats"]
    out = {"warm": cyc["warm"], "backend": st.get("backend"),
           "rounds": st.get("rounds"), "placed": st.get("placed"),
           "launches": cyc["launches"], "ms": ms,
           "pack": {k: cyc["pack"].get(k) for k in (
               "reuses", "patches", "uploads", "bytes_shipped")}}
    if cyc.get("select"):
        out["select"] = [{k: (round(v, 3) if isinstance(v, float) else v)
                          for k, v in r.items() if k != "digest"}
                         for r in cyc["select"]]
    if "census" in cyc:
        out["census"] = cyc["census"]
    return out


# The CPU run's binds after phase 8's idle cycle, by cluster.
PHASE8_CPU_BINDS = {}


def run_phase8(dev):
    """Phase 8: the scheduler loop at 50k x 5k and 10k x 1k, on the card
    twice (device selection, then host selection) and on the CPU once;
    binds must match the CPU's, and the slabs of every selecting cycle
    must be the same in all three runs."""
    out = {}
    cpu = torch.device("cpu")
    for name, shape, kernel, rung in SCHED_CLUSTERS:
        rec = {}
        runs = {}
        for run in ("card_1", "card_2"):
            t0 = time.perf_counter()
            cycles, binds = run_scheduler(shape, dev, kernel, rung,
                                          f"phase 8 {name} {run}",
                                          host_select=run == "card_2")
            runs[run] = cycles
            rec[run] = {c: cycle_line(cyc) for c, cyc in cycles.items()}
            rec[run]["seconds"] = time.perf_counter() - t0
            rec[run]["binds"] = len(binds)
            for c, cyc in cycles.items():
                log(f"phase 8: {name} {run} {c}: "
                    f"{json.dumps(rec[run][c])}")
            if run == "card_1":
                card_binds = binds
            else:
                check(binds == card_binds,
                      f"phase 8 {name}: device and host selection on the "
                      f"card bound differently")
        t0 = time.perf_counter()
        cycles, cpu_binds = run_scheduler(shape, cpu, kernel, rung,
                                          f"phase 8 {name} cpu")
        runs["cpu"] = cycles
        rec["cpu_seconds"] = time.perf_counter() - t0
        check(card_binds == cpu_binds,
              f"phase 8 {name}: the card bound {len(card_binds)} pods, the "
              f"CPU {len(cpu_binds)}; the (pod, node) sets differ")
        check(len(card_binds) > 0, f"phase 8 {name}: nothing bound")
        # Slabs: device selection on the card = host selection on the
        # card = the CPU run's, cycle by cycle.
        selecting = []
        for c in SCHED_CYCLES:
            digests = {run: [r["digest"] for r in runs[run][c]["select"]]
                       for run in runs}
            check(len({tuple(d) for d in digests.values()}) == 1,
                  f"phase 8 {name} {c}: slabs differ between device and "
                  f"host selection: {digests}")
            if digests["card_1"]:
                selecting.append(c)
        if kernel == "bid_sparse":
            check(selecting[:1] == ["cold"] and "delta" in selecting,
                  f"phase 8 {name}: the cold and delta cycles must select "
                  f"(selected: {selecting})")
        rec["selection"] = {
            c: {"device_ms": [r["ms"] for r in runs["card_1"][c]["select"]],
                "host_ms": [r["ms"] for r in runs["card_2"][c]["select"]],
                "cpu_device_path_ms": [r["ms"] for r in
                                       runs["cpu"][c]["select"]]}
            for c in selecting}
        for c, t in rec["selection"].items():
            log(f"phase 8: {name} {c}: selection on the card "
                f"{t['device_ms']} ms (device path) against "
                f"{t['host_ms']} ms (host path); slabs equal")
        # Phase 10 compares the process's binds with these.
        PHASE8_CPU_BINDS[name] = runs["cpu"]["idle"]["binds"]
        rec["launches"] = {
            k: sum(rec["card_1"][c]["launches"][k] for c in SCHED_CYCLES)
            for k in ("bid_dense", "bid_sparse")}
        log(f"phase 8: {name}: {len(card_binds)} binds, card = CPU "
            f"(CPU run {rec['cpu_seconds']:.1f} s); launches over the "
            f"four cycles {rec['launches']}")
        out[name] = rec
    return out


def run_phase9(dev):
    """Phase 9: the ladder on the card at 50k x 5k through the device
    fault hook."""
    shape = SCHED_CLUSTERS[0][1]
    out = {}

    # (a) sparse raises once -> dense on the card; the same binds as a
    # clean dense solve (slabs off).
    calls = []

    def raise_once(stage):
        if stage == "solve" and not calls:
            calls.append(stage)
            raise RuntimeError("injected device fault")

    containment.reset_breaker()
    cache = build_cluster(*shape, seed=0)
    sched = Scheduler(cache, TPU_CONF, device=dev)
    containment.set_device_fault_hook(raise_once)
    try:
        cyc = scheduler_cycle(sched, dev)
    finally:
        containment.set_device_fault_hook(None)
    st = cyc["stats"]
    ladder = [(e["rung"], e["outcome"]) for e in st["solve_ladder"]]
    check(ladder == [("sparse", "exception"), ("dense", "ok")],
          f"phase 9a: ladder {ladder}")
    backend = f"torch-{dev.type}"
    check(st["backend"] == backend, f"phase 9a: {st['backend']}")
    check(dev.type != "cuda" or cyc["launches"]["bid_dense"] > 0,
          "phase 9a: bid_dense idle")
    descended = dict(cache.binder.binds)
    cache.shutdown()
    containment.reset_breaker()
    with environ(KBT_SOLVER_TOPK="off"):
        cache = build_cluster(*shape, seed=0)
        clean = scheduler_cycle(Scheduler(cache, TPU_CONF, device=dev), dev)
        check_healthy(clean, "bid_dense", "dense", backend,
                      "phase 9a clean dense")
        clean_binds = dict(cache.binder.binds)
        cache.shutdown()
    check(descended == clean_binds,
          "phase 9a: the descended dense solve bound other pods than a "
          "clean dense solve")
    out["a"] = {"ladder": st["solve_ladder"], "binds": len(descended),
                "descended": cycle_line(cyc), "clean": cycle_line(clean)}
    log(f"phase 9a: sparse -> dense on the card, {len(descended)} binds "
        f"= a clean dense solve; {json.dumps(out['a']['descended'])}")

    # (b) a hang past a 0.5 s budget -> native floor, breaker open; the
    # next device pack is a labelled full upload into fresh buffers,
    # with the abandoned solve joined first, then with it still issuing
    # rounds beside the next cycle's solve.
    joined = timeout_sequence(dev, overlap=False)
    overlapped = timeout_sequence(dev, overlap=True)
    check(overlapped["binds"] == joined["binds"],
          "phase 9b: the cycles beside the abandoned solve bound other pods "
          "than the cycles after it ended")
    out["b"] = {"joined": joined["record"], "overlapped": overlapped["record"]}
    log(f"phase 9b: timeout -> native, breaker open; binds per cycle "
        f"{[len(b) for b in joined['binds']]} with the abandoned solve "
        f"joined = with it overlapping the next cycle; "
        f"{json.dumps(out['b']['overlapped'])}")
    return out


class HeldSolve:
    """Stands in for ``_build.load_library`` while one 9b run lasts. The
    first thread that launches ``bid_sparse`` (the solve the cycle will
    abandon) is held before its second launch until another thread
    launches ``bid_sparse`` (the next device cycle, after its pack);
    then it runs its remaining rounds beside that cycle's solve. The
    launches themselves, and their counts, are unchanged."""

    def __init__(self):
        self._load = _build.load_library
        self.first = None
        self.first_launches = 0
        self.late_launches = 0
        self.held = threading.Event()
        self.released = threading.Event()

    def __enter__(self):
        _build.load_library = lambda: self
        return self

    def __exit__(self, *exc):
        self.released.set()
        _build.load_library = self._load

    def __getattr__(self, name):
        fn = getattr(self._load(), name)
        if name != "kbt_bid_sparse":
            return fn

        def launch(*args):
            me = threading.current_thread()
            if self.first is None:
                self.first = me
            if me is self.first:
                self.first_launches += 1
                if self.first_launches == 2:
                    self.held.set()
                    self.released.wait(600.0)
                if self.released.is_set():
                    self.late_launches += 1
            else:
                self.released.set()
            return fn(*args)

        return launch


def timeout_sequence(dev, overlap):
    """Phase 9b's three cycles at 50k x 5k: the solve outsleeps a 0.5 s
    budget and the cycle ends on the native floor; a burst is pinned to
    the floor by the open breaker; after ``reset_breaker()`` a second
    burst runs on the card. ``overlap`` holds the abandoned solve
    mid-rounds until that last cycle has packed and launched (else it
    is joined before the pinned cycle). Returns the binds after each
    cycle and the record."""
    what = f"phase 9b ({'overlapped' if overlap else 'joined'})"
    backend = f"torch-{dev.type}"
    containment.reset_breaker()
    cache = build_cluster(*SCHED_CLUSTERS[0][1], seed=0)
    sched = Scheduler(cache, TPU_CONF, device=dev)
    containment.configure(solve_budget=0.5)
    hung = []

    def hang(stage):
        if stage == "solve":
            hung.append(threading.current_thread())
            time.sleep(3.0)

    def end_of_worker():
        # The abandoned worker finishes its rounds, then enters the hook
        # (at the device->host read) and sleeps; wait for it to end.
        deadline = time.perf_counter() + 300.0
        while not hung and time.perf_counter() < deadline:
            time.sleep(0.05)
        check(len(hung) == 1, f"{what}: the hook did not run once")
        hung[0].join(timeout=60.0)
        check(not hung[0].is_alive(), f"{what}: the abandoned worker lives on")

    binds = []
    with HeldSolve() if overlap else contextlib.nullcontext() as held:
        containment.set_device_fault_hook(hang)
        try:
            cyc = scheduler_cycle(sched, dev)
        finally:
            containment.set_device_fault_hook(None)
        st = cyc["stats"]
        ladder = [(e["rung"], e["outcome"]) for e in st["solve_ladder"]]
        check(ladder == [("sparse", "timeout"), ("native", "ok")],
              f"{what}: ladder {ladder}")
        check(st["backend"] == "native", f"{what}: {st['backend']}")
        check(containment.BREAKER.state == "open", f"{what}: breaker closed")
        dc = DC.device_cache_of(cache)
        check(not dc.dev and dc.drop_reason == "solve-abandoned",
              f"{what}: the resident pack was not dropped")
        binds.append(dict(cache.binder.binds))
        if overlap:
            check(held.held.wait(300.0),
                  f"{what}: the abandoned solve never reached its second "
                  f"bid_sparse launch")
        else:
            end_of_worker()
        # Breaker open: the next cycle is pinned to the native floor.
        add_gang_burst(cache, np.random.RandomState(1), "pgx", 5, 100, 5)
        pinned = scheduler_cycle(sched, dev)
        check(pinned["stats"].get("breaker_pinned") is True,
              f"{what}: the open breaker did not pin the next cycle")
        binds.append(dict(cache.binder.binds))
        containment.reset_breaker()
        containment.configure(None)
        add_gang_burst(cache, np.random.RandomState(2), "pgy", 5, 100, 5)
        if overlap:
            check(not hung and held.first.is_alive(),
                  f"{what}: the abandoned solve ended before the next pack")
        after = scheduler_cycle(sched, dev)
        check_healthy(after, "bid_sparse", "sparse", backend,
                      f"{what} after reset")
        reasons = after["stats"].get("device_full_reasons") or {}
        check(reasons and set(reasons.values()) == {"solve-abandoned"}
              and after["pack"]["uploads"] == len(K.PackedInputs._fields),
              f"{what}: the next pack was not a labelled full upload: "
              f"{reasons}")
        binds.append(dict(cache.binder.binds))
        if overlap:
            check(held.late_launches > 0,
                  f"{what}: the abandoned solve launched nothing beside the "
                  f"next cycle's solve")
            end_of_worker()
    cache.shutdown()
    record = {"ladder": st["solve_ladder"], "binds": [len(b) for b in binds],
              "breaker": "open", "timed_out": cycle_line(cyc),
              "pinned": cycle_line(pinned), "after": cycle_line(after),
              "pack_reasons": sorted(set(reasons.values()))}
    if overlap:
        record["abandoned_launches"] = {"before": held.first_launches
                                        - held.late_launches,
                                        "beside_next": held.late_launches}
    return {"binds": binds, "record": record}


# -- phase 10: the process on the card --------------------------------------------

EXAMPLE_STATE = "config/example-cluster.yaml"
# The loop's scheduling period (s) and the least number of periodic
# cycles each loop runs: the cold one, then steady or idle ones.
LOOP_PERIOD = 0.5
LOOP_CYCLES = 3

# ``python -m kube_batch_tpu_torch <argv>`` with the in-process cluster's
# bind_pod wrapped to print each bind; after the module's ``__main__``
# returns, the action's backend and the kernels' launch counts.
_ONCE_PROBE = """
import json, runpy, sys
from kube_batch_tpu_torch.actions import allocate_tpu as ATPU
from kube_batch_tpu_torch.cluster import api
from kube_batch_tpu_torch.solver import bid_kernels as BK
bind = api.InProcessCluster.bind_pod
def traced(self, pod, hostname):
    bind(self, pod, hostname)
    print("BIND " + json.dumps([pod.metadata.name, hostname]), flush=True)
api.InProcessCluster.bind_pod = traced
sys.argv = ["kube_batch_tpu_torch"] + %r
runpy.run_module("kube_batch_tpu_torch", run_name="__main__")
print("RESULT " + json.dumps({
    "backend": ATPU.last_stats.get("backend"),
    "launches": {"bid_dense": BK.bid_dense.launches,
                 "bid_sparse": BK.bid_sparse.launches}}))
"""


def free_port():
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def truth_binds(cluster, namespace="bench"):
    return {f"{p.namespace}/{p.name}": p.spec.node_name
            for p in cluster.list_objects("Pod")
            if p.spec.node_name and p.namespace == namespace}


def gangs_whole(cluster, namespace="bench"):
    """The PodGroups of ``namespace`` whose bound pods are fewer than
    minMember but more than none (the scheduler binds all or nothing)."""
    bound = {}
    for p in cluster.list_objects("Pod"):
        group = p.metadata.annotations.get(GROUP_NAME_ANNOTATION_KEY)
        if group and p.spec.node_name and p.namespace == namespace:
            bound[group] = bound.get(group, 0) + 1
    return [pg.name for pg in cluster.list_objects("PodGroup")
            if pg.namespace == namespace
            and 0 < bound.get(pg.name, 0) < pg.spec.min_member]


def run_once_subprocess(dev):
    """10.1: the example gang through ``python -m kube_batch_tpu_torch
    --once`` in its own process, on the card (the default device)."""
    argv = ["--cluster-state", EXAMPLE_STATE, "--scheduler-conf",
            TPU_CONF, "--once", "--listen-address", "127.0.0.1:0"]
    if dev.type != "cuda":
        argv += ["--device", dev.type]
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-c", _ONCE_PROBE % (argv,)], capture_output=True,
        text=True, timeout=300,
    )
    seconds = time.perf_counter() - t0
    (OUT_DIR / "phase10_once.log").write_text(out.stdout + out.stderr)
    check(out.returncode == 0,
          f"phase 10.1: the process exited {out.returncode}: "
          f"{out.stderr[-1500:]}")
    binds = sorted(tuple(json.loads(line[5:]))
                   for line in out.stdout.splitlines()
                   if line.startswith("BIND "))
    result = json.loads(next(line[7:] for line in out.stdout.splitlines()
                             if line.startswith("RESULT ")))
    check([b[0] for b in binds] == ["qj-1-p0", "qj-1-p1", "qj-1-p2"],
          f"phase 10.1: binds {binds}")
    check(result["backend"] == f"torch-{dev.type}",
          f"phase 10.1: solved on {result['backend']}")
    check(dev.type != "cuda" or result["launches"]["bid_dense"] > 0,
          "phase 10.1: bid_dense never launched")
    return {"seconds": seconds, "binds": binds, **result}


def run_cli_loop(cluster, dev, what, hook=None, timeout_s=300.0):
    """``cli.run`` in loop mode on ``dev`` over ``cluster``. Every
    periodic cycle is traced: the launch counters are zeroed just before
    its ``run_once`` and read just after, with its stats and time. A
    thread polls ``/debug/vars`` on the metrics port, calls ``hook(sched,
    vars, cycles)`` on every poll until it returns True, and sets the
    stop event once ``LOOP_CYCLES`` cycles ran and the hook is done."""
    from kube_batch_tpu_torch import cli

    port = free_port()
    opt = cli.ServerOption(scheduler_conf=TPU_CONF,
                           schedule_period=LOOP_PERIOD,
                           listen_address=f"127.0.0.1:{port}",
                           device=dev.type)
    stop = threading.Event()
    cycles, failure, polled = [], [], []
    state = {"sched": None}
    orig = Scheduler.run_once

    def traced(sched):
        state["sched"] = sched
        BK.bid_dense.launches = 0
        BK.bid_sparse.launches = 0
        _sync(dev)
        t0 = time.perf_counter()
        try:
            return orig(sched)
        finally:
            _sync(dev)
            ms = (time.perf_counter() - t0) * 1e3
            rec = RECORDER.snapshot()[-1]
            cycles.append({
                "ms": ms, "cycle_ms": rec.get("e2e_ms"),
                "launches": {"bid_dense": BK.bid_dense.launches,
                             "bid_sparse": BK.bid_sparse.launches},
                "stats": dict(ATPU.last_stats),
            })

    def poll():
        deadline = time.perf_counter() + timeout_s
        done = hook is None
        while not stop.is_set():
            if time.perf_counter() > deadline:
                failure.append(f"no end within {timeout_s} s (hook done: "
                               f"{done}, {len(cycles)} cycles)")
                break
            try:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{port}/debug/vars",
                        timeout=10) as resp:
                    dvars = json.loads(resp.read())
            except OSError:
                time.sleep(0.2)
                continue
            polled.append(dvars.get("cycles_recorded"))
            if not done and state["sched"] is not None:
                try:
                    done = hook(state["sched"], dvars, len(cycles))
                except Exception as exc:  # the phase fails, the loop stops
                    failure.append(f"hook: {exc!r}")
                    break
            if done and len(cycles) >= LOOP_CYCLES:
                break
            time.sleep(0.2)
        stop.set()

    Scheduler.run_once = traced
    poller = threading.Thread(target=poll, daemon=True, name="smoke-poll")
    poller.start()
    t0 = time.perf_counter()
    try:
        cli.run(opt, cluster=cluster, stop_event=stop)
    finally:
        Scheduler.run_once = orig
        stop.set()
        poller.join(timeout=30.0)
    seconds = time.perf_counter() - t0
    sched = state["sched"]
    check(sched is not None, f"{what}: the loop ran no cycle")
    check(sched.cache.wait_for_side_effects(timeout=600.0),
          f"{what}: binds did not drain")
    check(not failure, f"{what}: {failure}")
    check(polled, f"{what}: /debug/vars never answered")
    return sched, cycles, seconds


def loop_checks(cluster, cycles, kernel, dev, what):
    """Every cycle healthy on the card, the first one solving with the
    kernel, the bound gangs whole."""
    for i, cyc in enumerate(cycles):
        st = cyc["stats"]
        check("validation_rejected" not in st,
              f"{what} cycle {i}: validation rejected placements")
        check(not st.get("breaker_pinned"), f"{what} cycle {i}: pinned")
        if "backend" in st:
            check(st["backend"] == f"torch-{dev.type}",
                  f"{what} cycle {i}: solved on {st['backend']}")
    cold = cycles[0]
    check(cold["stats"].get("warm_outcome") == "cold"
          and (dev.type != "cuda" or cold["launches"][kernel] > 0),
          f"{what}: the first cycle did not solve cold with {kernel}: "
          f"{cold['stats'].get('warm_outcome')}, {cold['launches']}")
    if kernel == "bid_sparse":
        check(cold["stats"].get("select_path") == "device",
              f"{what}: select_path {cold['stats'].get('select_path')}")
    broken = gangs_whole(cluster)
    check(not broken, f"{what}: gangs bound below minMember: {broken[:5]}")


class TruthInjection:
    """10.3 inside the 10k x 1k loop. Before the loop: a gang that can
    never start (minMember 2, one pod) and an empty gang. Once the loop
    has placed the cluster and every bound pod runs, with the cache's
    watch detached: a pod created in the empty gang (``missed-pod``)
    and the blocked pod bound by another agent, its kubelet start
    included (``missed-bind``). Then the sweep must report both and a
    later card cycle must bind the missed pod."""

    NS = "truth"

    def __init__(self, cluster):
        self.cluster = cluster
        for name, minm in (("blocked", 2), ("late", 1)):
            cluster.create_pod_group(build_pod_group(
                name, namespace=self.NS, min_member=minm, queue="q0"))
        self.blocked = self.pod("blocked")
        cluster.create_pod(self.blocked)
        self.step = "wait"
        self.marks = {}

    def pod(self, group):
        return build_pod(self.NS, f"{group}-p0", "", PodPhase.PENDING,
                         build_resource_list(cpu="250m", memory="256Mi"),
                         group_name=group)

    def settled(self):
        pods = self.cluster.list_objects("Pod")
        return all(p.status.phase == PodPhase.RUNNING
                   for p in pods if p.spec.node_name)

    def __call__(self, sched, dvars, n_cycles):
        cluster, cache = self.cluster, sched.cache
        if self.step == "wait" and n_cycles >= 2 and self.settled():
            handler = cache._on_watch_event
            cluster.remove_watch(handler)
            try:
                cluster.create_pod(self.pod("late"))
                cluster.bind_pod(self.blocked, "n0")
                deadline = time.perf_counter() + 30.0
                while (cluster.get_pod(self.NS, "blocked-p0").status.phase
                       != PodPhase.RUNNING):
                    check(time.perf_counter() < deadline,
                          "phase 10.3: the kubelet never started the pod")
                    time.sleep(0.01)
            finally:
                cluster.add_watch(handler)
            self.marks["injected_after_cycle"] = n_cycles
            self.step = "sweep"
        if self.step == "sweep":
            seen = (dvars.get("integrity") or {}).get(
                "divergence_detected") or {}
            if seen.get("missed-pod") and seen.get("missed-bind"):
                self.marks.update(detected=seen, swept_by_cycle=n_cycles)
                self.step = "bind"
        if self.step == "bind":
            late = cluster.get_pod(self.NS, "late-p0")
            if late is not None and late.spec.node_name:
                self.marks.update(late_bound_by_cycle=n_cycles,
                                  late_node=late.spec.node_name,
                                  integrity=dvars.get("integrity"))
                self.step = "done"
        return self.step == "done"


def recovery_run(dev, lock_dir):
    """10.3: a successor process (``cli.run --once`` with the file lease)
    over a cluster holding a fenced predecessor's journal: a gang of 4
    with 2 members bound and intents for all 4, a stale lease of the
    predecessor, and a second gang pending. Returns the recovery summary
    (without its duration), the binds and the cycle's backend."""
    from kube_batch_tpu_torch import cli
    from kube_batch_tpu_torch.cache import recovery
    from kube_batch_tpu_torch.cluster import InProcessCluster

    cluster = InProcessCluster(simulate_kubelet=True)
    cluster.create_queue(build_queue("default"))
    for j in range(4):
        cluster.create_node(build_node(f"r{j}", build_resource_list(
            cpu="8", memory="16Gi", pods=110)))
    pods = {}
    for group, members, minm in (("redo", 4, 4), ("fresh", 3, 3)):
        cluster.create_pod_group(build_pod_group(
            group, namespace="rec", min_member=minm, queue="default"))
        pods[group] = []
        for i in range(members):
            pod = build_pod("rec", f"{group}-{i}", "", PodPhase.PENDING,
                            build_resource_list(cpu="500m", memory="512Mi"),
                            group_name=group)
            cluster.create_pod(pod)
            pods[group].append(pod)
    for pod in pods["redo"][:2]:
        cluster.bind_pod(pod, "r0")
    cluster.append_bind_intent({
        "leader": "dead-0",
        "tasks": [{"uid": p.uid, "pod": f"rec/{p.name}", "node": n,
                   "job": "rec/redo"}
                  for p, n in zip(pods["redo"], ["r0", "r0", "r1", "r1"])],
        "gangs": {"rec/redo": 4},
    })
    lock_dir.mkdir(parents=True, exist_ok=True)
    (lock_dir / "tpu-batch-leader.lock").write_text(json.dumps(
        {"holder": "dead-0", "renew_ts": time.time() - 3600.0}))
    opt = cli.ServerOption(once=True, enable_leader_election=True,
                           lock_object_namespace=str(lock_dir),
                           scheduler_conf=TPU_CONF, device=dev.type,
                           listen_address="127.0.0.1:0")
    recovery.LAST_RECOVERY = None
    BK.bid_dense.launches = 0
    BK.bid_sparse.launches = 0
    cli.run(opt, cluster=cluster)
    launches = {"bid_dense": BK.bid_dense.launches,
                "bid_sparse": BK.bid_sparse.launches}
    summary = dict(recovery.LAST_RECOVERY or {})
    summary.pop("duration_ms", None)
    return {"summary": summary, "binds": truth_binds(cluster, "rec"),
            "backend": ATPU.last_stats.get("backend"),
            "launches": launches}


def run_phase10(dev):
    """Phase 10: the process on the card."""
    out = {}
    cpu = torch.device("cpu")
    out["once"] = run_once_subprocess(dev)
    log(f"phase 10.1: python -m kube_batch_tpu_torch --once bound "
        f"{out['once']['binds']} on {out['once']['backend']} in "
        f"{out['once']['seconds']:.1f} s, launches "
        f"{out['once']['launches']}")

    # 10.2 and 10.3: the loop at both sizes, cluster truth at 10k x 1k.
    # Periodic cycles only (micro cycles would place the repaired pod
    # outside the traced run_once); the 10k x 1k loop sweeps every cycle.
    with environ(KBT_MICRO="0"):
        for name, shape, kernel, _rung in SCHED_CLUSTERS:
            what = f"phase 10.2 {name}"
            t0 = time.perf_counter()
            cluster = build_in_process_cluster(*shape, seed=0)
            fill_s = time.perf_counter() - t0
            truth = kernel == "bid_dense"
            inject = TruthInjection(cluster) if truth else None
            with environ(KBT_ANTIENTROPY_EVERY="1" if truth else "256"):
                sched, cycles, seconds = run_cli_loop(cluster, dev, what,
                                                      hook=inject)
            loop_checks(cluster, cycles, kernel, dev, what)
            binds = truth_binds(cluster)
            want = PHASE8_CPU_BINDS[name]
            check(binds == want,
                  f"{what}: the process bound {len(binds)} pods, phase 8's "
                  f"CPU run {len(want)} after its idle cycle; the (pod, "
                  f"node) sets differ")
            rec = {"fill_s": fill_s, "seconds": seconds, "binds": len(binds),
                   "cycles": [{
                       "ms": round(c["ms"], 3),
                       "cycle_ms": c["cycle_ms"],
                       "warm": c["stats"].get("warm_outcome"),
                       "placed": c["stats"].get("placed"),
                       "select_path": c["stats"].get("select_path"),
                       "launches": c["launches"],
                       "ms_by_phase": {k: round(c["stats"][k], 3)
                                       for k in STAT_PHASES
                                       if k in c["stats"]},
                   } for c in cycles]}
            if inject is not None:
                marks = inject.marks
                check(inject.step == "done", f"phase 10.3: {inject.step}")
                # The sweep opens the cycle that follows the injection,
                # before its session: that cycle or a later one binds.
                after = [c for c in cycles[marks["injected_after_cycle"]:]
                         if c["stats"].get("placed")]
                check(after
                      and after[0]["stats"]["backend"] == f"torch-{dev.type}"
                      and (dev.type != "cuda"
                           or after[0]["launches"]["bid_dense"] > 0),
                      f"phase 10.3: the missed pod was not bound by a card "
                      f"cycle: {marks}, cycles "
                      f"{[(c['stats'].get('warm_outcome'), c['stats'].get('placed'), c['stats'].get('backend')) for c in cycles]}")
                rec["truth"] = {k: v for k, v in marks.items()
                                if k != "integrity"}
                rec["truth"]["integrity"] = {
                    k: marks["integrity"].get(k) for k in (
                        "sweeps", "divergence_detected",
                        "divergence_repaired")}
                log(f"phase 10.3: sweep detected {marks['detected']}; the "
                    f"missed pod bound on the card by cycle "
                    f"{marks['late_bound_by_cycle']}")
            sched.cache.shutdown()
            del cluster, sched
            gc.collect()
            out[name] = rec
            log(f"{what}: {len(cycles)} cycles in {seconds:.1f} s (fill "
                f"{fill_s:.1f} s), {len(binds)} binds = phase 8's CPU "
                f"binds; {json.dumps(rec['cycles'])}")

    # 10.3: journal recovery by a successor, on the CPU and on the card.
    lease = OUT_DIR / "phase10_lease"
    ref = recovery_run(cpu, lease / "cpu")
    got = recovery_run(dev, lease / "card")
    check(got["summary"] == ref["summary"] and got["binds"] == ref["binds"],
          f"phase 10.3: recovery on the card {got} differs from the CPU's "
          f"{ref}")
    check(got["summary"].get("outcomes") == {"applied": 2, "redriven": 2},
          f"phase 10.3: recovery outcomes {got['summary'].get('outcomes')}")
    check(len(got["binds"]) == 7 and got["backend"] == f"torch-{dev.type}"
          and (dev.type != "cuda" or got["launches"]["bid_dense"] > 0),
          f"phase 10.3: the successor's card cycle: {got}")
    out["recovery"] = got
    log(f"phase 10.3: reconcile_journal on the card = the CPU's "
        f"({got['summary']['outcomes']}); the successor bound "
        f"{len(got['binds'])} pods on {got['backend']}")
    return out


# -- phase 11: the simulator on the card -------------------------------------

# The reference's smoke seeds (tests/sim/test_sim_smoke.py).
SIM_SMOKE = dict(cycles=60, seed=5, faults="bind:0.05,node-flap:0.02",
                 workload=WorkloadSpec(nodes=10, arrival_rate=1.2),
                 backend="dense")
# The Makefile's chaos-smoke and diverge-smoke mixes at 120 cycles, and
# its failover-smoke drill on the dense backend with hangs added, so a
# successor's abandoned solve shows whether it drops its device cache.
SIM_CHAOS = (
    ("chaos", dict(cycles=120, seed=11, backend="dense",
                   faults="solver-exc:0.08,solver-hang:0.02,bind:0.05")),
    ("diverge", dict(
        cycles=120, seed=15, backend="dense", antientropy_every=1,
        faults="event-drop:0.06,event-dup:0.06,event-reorder:0.05,"
               "event-stale:0.05,relist-fail:0.25,solver-corrupt:0.04,"
               "bind:0.03",
        workload=WorkloadSpec(node_add_rate=0.02, node_drain_rate=0.02))),
    ("drill", dict(
        cycles=70, seed=13, backend="dense",
        faults="bind:0.03,solver-hang:0.03",
        workload=WorkloadSpec(arrival_rate=3.0),
        kill_plan={8: "pre-solve", 20: "post-solve-pre-drain",
                   32: "mid-bind-drain", 44: "mid-close"})),
)
# The fault kinds each of those runs must have injected.
SIM_CHAOS_KINDS = {
    "chaos": ("solver-exc", "solver-hang", "bind"),
    "diverge": ("event-drop", "event-dup", "event-reorder", "event-stale",
                "relist-fail", "solver-corrupt", "bind"),
    "drill": ("leader-kill", "solver-hang", "bind"),
}
# A real-size cluster: bench.py::build_cluster's nodes, ~1,000 pod
# arrivals a cycle under the default gang mix, up to 4,000 jobs resident
# (reached by cycle 10). Cut from 24 cycles for the script's time.
SIM_LARGE = dict(
    cycles=8, seed=0, faults="bind:0.03", backend="auto",
    workload=WorkloadSpec(nodes=5000, node_cpu_m=32000,
                          node_mem_mi=131072, arrival_rate=400,
                          arrival_profile="sustained",
                          max_jobs_in_flight=4000))
# Process state a run sets and must give back.
SIM_ENV = ("KBT_SOLVER", "KBT_SOLVER_TOPK", "KBT_ANTIENTROPY_EVERY")


def sim_records(records):
    """Trace records after the header as canonical JSON, each quality
    card through ``replay_view`` (the path-dependent solver deltas
    dropped) and without the integrity block, which the harness's own
    replay verifier leaves out too: which cycle an ingest anomaly lands
    on follows the bind workers' timing (two CPU runs of phase 11.3's
    cluster place the same three reorders in different cycles)."""
    out = []
    for rec in records[1:]:
        rec = dict(rec)
        rec.pop("integrity", None)
        if "quality" in rec:
            rec["quality"] = replay_view(rec["quality"])
        out.append(canon(rec))
    return out


def sim_run(dev, what, **cfg):
    """One ``ClusterSimulator`` run on ``dev``. The launch counters are
    zeroed after construction (the harness's warm-up solves) and read
    after the run; every periodic ``run_once`` is timed and its leader,
    device, backend, ladder and launches kept, and every drop of
    resident buffers is logged with its cache's leader. The run must
    give back the environment it set."""
    env = {k: os.environ.get(k) for k in SIM_ENV}
    cycles, drops = [], []
    guarded, drop = Scheduler.run_once_guarded, ATPU.drop_resident

    def timed(sched):
        before = (BK.bid_dense.launches, BK.bid_sparse.launches)
        t0 = time.perf_counter()
        ok = guarded(sched)
        _sync(dev)
        st = ATPU.last_stats
        cycles.append({
            "ms": (time.perf_counter() - t0) * 1e3, "ok": ok,
            "leader": sched.cache.leader_identity,
            "device": sched.device.type, "backend": st.get("backend"),
            "ladder": [(e["rung"], e["outcome"])
                       for e in st.get("solve_ladder") or ()],
            "solve_ms": st.get("solve_ms"),
            "select_path": st.get("select_path"),
            "launches": {"bid_dense": BK.bid_dense.launches - before[0],
                         "bid_sparse": BK.bid_sparse.launches - before[1]},
        })
        return ok

    def dropped(cache, reason):
        drops.append((cache.leader_identity, reason))
        return drop(cache, reason)

    Scheduler.run_once_guarded = timed
    ATPU.drop_resident = dropped
    try:
        sim = ClusterSimulator(SimConfig(device=dev.type, **cfg))
        BK.bid_dense.launches = 0
        BK.bid_sparse.launches = 0
        selections = metrics.solver_selection_device.total()
        t0 = time.perf_counter()
        report = sim.run()
        seconds = time.perf_counter() - t0
    finally:
        Scheduler.run_once_guarded = guarded
        ATPU.drop_resident = drop
    check({k: os.environ.get(k) for k in SIM_ENV} == env,
          f"{what}: the run left the environment changed")
    return {
        "report": report.to_dict(), "trace": sim.writer.records,
        "records": sim_records(sim.writer.records),
        "placements": [r["placements"] for r in sim.writer.records[1:]],
        "seconds": seconds, "cycles": cycles, "drops": drops,
        "launches": {"bid_dense": BK.bid_dense.launches,
                     "bid_sparse": BK.bid_sparse.launches},
        "device_selections": int(
            metrics.solver_selection_device.total() - selections),
    }


def sim_clean(run, what):
    rep = run["report"]
    check(rep["violations"] == [],
          f"{what}: {len(rep['violations'])} invariant violations, first "
          f"{rep['violations'][:1]}")
    check(rep["cycle_errors"] == 0,
          f"{what}: {rep['cycle_errors']} cycle errors")


def sim_on(run, what, dev):
    """Every scheduler of the run, successors included, was built on
    ``dev``, and its device cycles solved there."""
    backends = {c["backend"] for c in run["cycles"] if c["backend"]}
    check(f"torch-{dev.type}" in backends
          and backends <= {f"torch-{dev.type}", "native"},
          f"{what}: solved on {sorted(backends)}")
    check({c["device"] for c in run["cycles"]} == {dev.type},
          f"{what}: a scheduler was built off {dev.type}")


def sim_first_diff(a, b):
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            x, y = json.loads(x), json.loads(y)
            keys = sorted(k for k in set(x) | set(y) if x.get(k) != y.get(k))
            return f"cycle {i}: {keys}"
    return f"lengths {len(a)} and {len(b)}"


def sim_summary(run):
    rep = run["report"]
    out = {k: rep.get(k) for k in (
        "cycles", "placements", "fault_counts", "bind_failures",
        "cycle_errors", "jobs_created", "jobs_completed", "leader_kills",
        "recovery_failures", "breaker", "integrity")}
    out.update(seconds=run["seconds"], launches=run["launches"],
               device_selections=run["device_selections"],
               violations=len(rep["violations"]), drops=run["drops"])
    return out


def sim_card_and_cpu(dev, what, **cfg):
    card = sim_run(dev, f"{what} card", **cfg)
    host = sim_run(torch.device("cpu"), f"{what} cpu", **cfg)
    for run, where in ((card, "card"), (host, "cpu")):
        sim_clean(run, f"{what} {where}")
    sim_on(card, f"{what} card", dev)
    return card, host


def run_phase11(dev):
    """Phase 11: the simulator on the card, each run once on ``dev`` and
    once on the CPU in this process. A failed check is kept and the
    phase goes on; it fails at its end with every message."""
    out, failures = {}, []

    def part(name, fn):
        try:
            fn()
        except SmokeFailure as exc:
            failures.append(f"phase {name}: {exc}")
            log(f"phase {name}: FAILED: {exc}")

    def smoke():
        what = "11.1 smoke"
        card, host = sim_card_and_cpu(dev, what, **SIM_SMOKE)
        out["smoke"] = {"card": sim_summary(card), "cpu": sim_summary(host)}
        check(card["records"] == host["records"],
              f"{what}: card and CPU traces differ at "
              f"{sim_first_diff(card['records'], host['records'])}")
        check(card["report"]["placements"] > 100, f"{what}: few placements")
        replay = sim_run(dev, f"{what} replay", backend="sparse", topk=16,
                         replay=TraceReader(card["trace"]))
        out["smoke"]["replay"] = sim_summary(replay)
        sim_clean(replay, f"{what} replay")
        check(replay["report"]["replay_mismatches"] == []
              and not replay["report"].get("quality_mismatches"),
              f"{what} replay: mismatches at "
              f"{replay['report']['replay_mismatches'][:10]}, quality "
              f"{replay['report'].get('quality_mismatches', [])[:10]}")
        if dev.type == "cuda":
            check(card["launches"]["bid_dense"] > 0,
                  f"{what}: bid_dense not launched: {card['launches']}")
            check(replay["launches"]["bid_sparse"] > 0,
                  f"{what} replay: bid_sparse not launched: "
                  f"{replay['launches']}")
        log(f"phase {what}: {card['report']['placements']} placements in "
            f"{card['report']['cycles']} cycles, card trace = CPU trace "
            f"({card['seconds']:.1f} s on the card, {host['seconds']:.1f} s "
            f"on the CPU), launches {card['launches']}; the replay under "
            f"sparse K=16 matched every cycle, launches "
            f"{replay['launches']}")

    def chaos(name, cfg):
        what = f"11.2 {name}"
        card, host = sim_card_and_cpu(dev, what, **cfg)
        out[name] = {"card": sim_summary(card), "cpu": sim_summary(host)}
        rep = card["report"]
        for kind in SIM_CHAOS_KINDS[name]:
            check(rep["fault_counts"].get(kind, 0) > 0,
                  f"{what}: no {kind} fault injected: {rep['fault_counts']}")
        check(rep["fault_counts"] == host["report"]["fault_counts"],
              f"{what}: fault counts {rep['fault_counts']} on the card, "
              f"{host['report']['fault_counts']} on the CPU")
        check(rep["breaker"]["state"] == "closed",
              f"{what}: the breaker ended {rep['breaker']['state']}")
        if "solver-hang" in SIM_CHAOS_KINDS[name]:
            check(rep["breaker"]["trips"] >= 1
                  and rep["breaker"]["reclosures"] >= 1,
                  f"{what}: breaker {rep['breaker']}")
        if name == "diverge":
            check(rep["integrity"]["unrepaired_end"] == 0,
                  f"{what}: unrepaired at the end: {rep['integrity']}")
        check(card["placements"] == host["placements"],
              f"{what}: card and CPU placements differ at "
              f"{sim_first_diff(card['records'], host['records'])}")
        timeouts = [c for c in card["cycles"]
                    if (("dense", "timeout") in c["ladder"])]
        for c in timeouts:
            check((c["leader"], "solve-abandoned") in card["drops"],
                  f"{what}: {c['leader']} timed out and kept its resident "
                  f"buffers: drops {card['drops']}")
        if name == "drill":
            check(rep["leader_kills"] == 4 and rep["recovery_failures"] == 0,
                  f"{what}: {rep['leader_kills']} kills, "
                  f"{rep['recovery_failures']} recovery failures")
            succ = [c for c in card["cycles"]
                    if c["leader"] != "sim-leader-0"]
            check(any(c["backend"] == f"torch-{dev.type}" for c in succ),
                  f"{what}: no successor solved on {dev.type}")
            check(any(c["leader"] != "sim-leader-0" for c in timeouts),
                  f"{what}: no successor's solve timed out: "
                  f"{[(c['leader'], c['ladder']) for c in timeouts]}")
            if dev.type == "cuda":
                check(sum(c["launches"]["bid_dense"] for c in succ) > 0,
                      f"{what}: successors launched no bid_dense")
        if dev.type == "cuda":
            check(card["launches"]["bid_dense"] > 0,
                  f"{what}: bid_dense not launched")
        log(f"phase {what}: faults {rep['fault_counts']}, breaker trips "
            f"{rep['breaker']['trips']} / reclosures "
            f"{rep['breaker']['reclosures']} ({rep['breaker']['state']}), "
            f"{len(timeouts)} timed-out solves each dropping its leader's "
            f"resident buffers, {rep['placements']} placements = the CPU's, "
            f"{card['seconds']:.1f} s on the card / {host['seconds']:.1f} s "
            f"on the CPU, launches {card['launches']}"
            + (f", {rep['leader_kills']} leader kills, failovers "
               f"{[f['cut'] for f in rep['failovers']]}"
               if name == "drill" else ""))

    def large():
        what = "11.3 5,000 nodes"
        card, host = sim_card_and_cpu(dev, what, **SIM_LARGE)
        rows = [{"ms": round(c["ms"], 1),
                 "solve_ms": (round(c["solve_ms"], 1)
                              if c["solve_ms"] is not None else None),
                 "placed": len(p), "select_path": c["select_path"],
                 "launches": c["launches"]}
                for c, p in zip(card["cycles"], card["placements"])]
        out["large"] = {"card": sim_summary(card), "cpu": sim_summary(host),
                        "card_cycles": rows,
                        "cpu_cycle_ms": [round(c["ms"], 1)
                                         for c in host["cycles"]]}
        for i, row in enumerate(rows):
            log(f"phase {what} cycle {i}: run_once {row['ms']} ms, solve "
                f"{row['solve_ms']} ms, {row['placed']} placed, selection "
                f"{row['select_path']}, launches {row['launches']}")
        check(card["records"] == host["records"],
              f"{what}: card and CPU traces differ at "
              f"{sim_first_diff(card['records'], host['records'])}")
        check(card["device_selections"] > 0,
              f"{what}: no selection ran on the device")
        if dev.type == "cuda":
            check(card["launches"]["bid_sparse"] > 0,
                  f"{what}: bid_sparse not launched: {card['launches']}")
        log(f"phase {what}: {card['report']['placements']} placements in "
            f"{card['report']['cycles']} cycles ({card['seconds']:.1f} s on "
            f"the card, {host['seconds']:.1f} s on the CPU), card trace = "
            f"CPU trace, {card['device_selections']} device selections, "
            f"launches {card['launches']}")

    part("11.1", smoke)
    for name, cfg in SIM_CHAOS:
        part(f"11.2 {name}", lambda name=name, cfg=cfg: chaos(name, cfg))
    part("11.3", large)
    out["failures"] = failures
    return out


# -- phase 12: the real-cluster process and the perf harness on the card ----

# perf.run_density at the reference's kubemark design scale (3,000 pods on
# 100 hollow nodes, gangs of 10: perf.py's docstring) and at the north
# star's cluster size (bench.py ``large``: 50,000 pods x 5,000 nodes) with
# density's own pod shape; perf.run_multitenant_compare at the
# reference's 100 nodes; 5,000 x 500 of build_cluster's shape (4 queues,
# 50 gangs of 100: bench.py ``medium`` at half its size, cut for time)
# as API documents behind the FakeKube for 12.3 and 12.4.
PHASE12 = {
    "density": (("kubemark_3k_100", dict(total_pods=3_000, nodes=100,
                                         pods_per_group=10, timeout=120.0)),
                ("north_star_50k_5k", dict(total_pods=50_000, nodes=5_000,
                                           pods_per_group=10,
                                           timeout=180.0))),
    # 60 s a run, half of it for tenant B's admission (perf.py splits it).
    "multitenant": dict(nodes=100, timeout=60.0),
    "http": (5_000, 500, 4, 50),
    # 12.4: the last gangs are still pending when leader A starts (the
    # others run where 12.3's card run bound them), so A's first cycle
    # journals one bind intent under the Lease annotation's byte budget
    # (a 10,000-task record is over it and binds unjournaled, as in the
    # reference); each bind POST is held this long until A is killed.
    "failover_pending_gangs": 10,
    "failover_bind_delay_s": 0.005,
}
API_GROUP = "scheduling.incubator.k8s.io"
LEASE_NS = "kube-system"
LEASES = f"/apis/coordination.k8s.io/v1/namespaces/{LEASE_NS}/leases"


@contextlib.contextmanager
def patched(obj, name, value):
    saved = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, saved)


@contextlib.contextmanager
def traced_cycles(dev):
    """Every periodic and micro cycle of the schedulers the block builds:
    the launch counters and the action's stats are cleared just before
    it and read just after, with its time."""
    cycles = []
    saved = {name: getattr(Scheduler, name)
             for name in ("run_once", "run_micro")}

    def wrap(kind, fn):
        def traced(sched):
            BK.bid_dense.launches = 0
            BK.bid_sparse.launches = 0
            ATPU.last_stats.clear()
            t0 = time.perf_counter()
            try:
                return fn(sched)
            finally:
                _sync(dev)
                cycles.append({
                    "kind": kind, "ms": (time.perf_counter() - t0) * 1e3,
                    "launches": {"bid_dense": BK.bid_dense.launches,
                                 "bid_sparse": BK.bid_sparse.launches},
                    "stats": dict(ATPU.last_stats)})
        return traced

    for name, fn in saved.items():
        setattr(Scheduler, name, wrap(name, fn))
    try:
        yield cycles
    finally:
        for name, fn in saved.items():
            setattr(Scheduler, name, fn)


def solving_summary(cycles, dev, what, kernels=True):
    """Every cycle that solved ran on ``dev`` on one ``ok`` rung with no
    breaker pin or rejected placement; returns the counts, and with
    ``kernels`` a bid kernel must have launched on the card."""
    solving, rungs = 0, set()
    for i, cyc in enumerate(cycles):
        st = cyc["stats"]
        check(not st.get("breaker_pinned"), f"{what} cycle {i}: pinned")
        check("validation_rejected" not in st,
              f"{what} cycle {i}: validation rejected placements")
        if "backend" not in st:
            continue
        solving += 1
        check(st["backend"] == f"torch-{dev.type}",
              f"{what} cycle {i}: solved on {st['backend']}")
        ladder = st.get("solve_ladder") or []
        check(len(ladder) == 1 and ladder[0]["outcome"] == "ok",
              f"{what} cycle {i}: ladder {ladder}")
        rungs.add(ladder[0]["rung"])
    launches = {k: sum(c["launches"][k] for c in cycles)
                for k in ("bid_dense", "bid_sparse")}
    if kernels:
        check(solving > 0, f"{what}: no cycle solved")
        check(dev.type != "cuda" or sum(launches.values()) > 0,
              f"{what}: no bid kernel launched")
    return {"cycles": len(cycles),
            "micro": sum(c["kind"] == "run_micro" for c in cycles),
            "solving": solving, "rungs": sorted(rungs),
            "launches": launches,
            "solve_ms_max": max((c["stats"].get("solve_block_ms", 0.0)
                                 for c in cycles), default=0.0)}


def latency_items(art):
    return {d["label"]: {k: round(v, 3) for k, v in d.items()
                         if k != "label"} for d in art["dataItems"]}


def density_run(dev, what, kw):
    """12.1: ``perf.run_density`` with the TPU policy on ``dev``."""
    from kube_batch_tpu_torch import perf
    from kube_batch_tpu_torch.cluster import InProcessCluster

    made = []

    def cluster_factory(**ckw):
        made.append(InProcessCluster(**ckw))
        return made[-1]

    with patched(perf, "InProcessCluster", cluster_factory), \
            traced_cycles(dev) as cycles:
        art = perf.run_density(scheduler_conf=TPU_CONF, device=dev, **kw)
    total = kw["total_pods"]
    check(art["pods_running"] == total and art["pods_scheduled"] == total,
          f"{what}: {art['pods_running']} of {total} pods running in "
          f"{art['wall_seconds']} s")
    broken = gangs_whole(made[0], namespace="perf")
    check(not broken, f"{what}: gangs bound below minMember: {broken[:5]}")
    out = {"wall_seconds": art["wall_seconds"],
           "pods_per_second": art["pods_per_second"],
           "latency_ms": latency_items(art),
           **solving_summary(cycles, dev, what)}
    del made[:]
    gc.collect()
    return out


def nodes_over(alloc, placed):
    """The nodes whose pods request more CPU, memory or pod slots than
    the node has: ``alloc`` maps a node to its allocatable quantities,
    ``placed`` holds a (node, requests) pair for each bound pod."""
    from kube_batch_tpu_torch.api.resource_info import parse_quantity

    used = {}
    for node, req in placed:
        row = used.setdefault(node, [0.0, 0.0, 0])
        row[0] += parse_quantity(req.get("cpu", 0))
        row[1] += parse_quantity(req.get("memory", 0))
        row[2] += 1
    return sorted(
        n for n, (cpu, mem, count) in used.items()
        if n not in alloc
        or cpu > parse_quantity(alloc[n].get("cpu", 0)) + 1e-9
        or mem > parse_quantity(alloc[n].get("memory", 0))
        or count > int(alloc[n].get("pods", 0)))


def over_capacity(cluster):
    """:func:`nodes_over` of an in-process cluster (one container a
    pod, as every pod the perf harness builds)."""
    return nodes_over(
        {n.name: n.status.allocatable for n in cluster.list_objects("Node")},
        ((p.spec.node_name, p.spec.containers[0].requests)
         for p in cluster.list_objects("Pod") if p.spec.node_name))


def multitenant_run(dev, what, kw):
    """12.2: ``perf.run_multitenant_compare``; each of its two runs is
    traced on its own (the counters zeroed around each cycle) and its
    cluster kept. Both loops backfill the best-effort pods and evict
    from tenant A without taking a gang below minMember, no node is over
    capacity, and the greedy loop admits all of tenant B. How much of B
    the ``allocate_tpu`` loop admits depends on timing at this size in
    the reference too (the tenants' reclaimable pods are exactly B's
    demand: one gang of evictions B does not use leaves its last gangs
    short), so it is recorded, not held to all."""
    from kube_batch_tpu_torch import perf
    from kube_batch_tpu_torch.cluster import InProcessCluster

    runs, clusters = {}, []
    inner = perf.run_multitenant

    def traced_run(**rkw):
        with traced_cycles(dev) as cycles:
            art = inner(**rkw)
        runs[rkw["allocate_action"]] = (cycles, clusters[-1])
        return art

    def cluster_factory(**ckw):
        clusters.append(InProcessCluster(**ckw))
        return clusters[-1]

    with patched(perf, "run_multitenant", traced_run), \
            patched(perf, "InProcessCluster", cluster_factory):
        art = perf.run_multitenant_compare(device=dev, **kw)
    out = {"comparison": art["comparison"]}
    want_b = art["config"]["tenant_b_pods"]
    for action, run in (("allocate_tpu", art),
                        ("allocate", art["reference_loop"])):
        cycles, cluster = runs[action]
        check(run["besteffort_backfilled"]
              == art["config"]["besteffort_pods"],
              f"{what} {action}: {run['besteffort_backfilled']} best-effort "
              f"pods backfilled")
        check(run["tenant_a_evicted"] > 0 and run["tenant_b_running"] > 0,
              f"{what} {action}: {run['tenant_a_evicted']} evicted, "
              f"{run['tenant_b_running']} of tenant B admitted")
        broken = gangs_whole(cluster, namespace="perf")
        check(not broken, f"{what} {action}: gangs below minMember: "
              f"{broken[:5]}")
        over = over_capacity(cluster)
        check(not over, f"{what} {action}: nodes over capacity {over[:5]}")
        summary = solving_summary(cycles, dev, f"{what} {action}",
                                  kernels=action == "allocate_tpu")
        if action == "allocate":
            check(run["tenant_b_running"] == want_b,
                  f"{what} {action}: tenant B {run['tenant_b_running']} of "
                  f"{want_b} admitted")
            check(summary["solving"] == 0
                  and sum(summary["launches"].values()) == 0,
                  f"{what}: the greedy loop launched {summary['launches']}")
        out[action] = {
            "tenant_a_running_initial": run["tenant_a_running_initial"],
            "besteffort_backfilled": run["besteffort_backfilled"],
            "tenant_b_running": run["tenant_b_running"],
            "tenant_a_evicted": run["tenant_a_evicted"],
            "wall_seconds": run["wall_seconds"],
            "admission_ms": latency_items(run)["tenant_b_admission_ms"],
            **summary}
    del clusters[:]
    gc.collect()
    return out


def api_documents(n_tasks, n_nodes, n_queues, n_groups, seed=0):
    """``build_cluster``'s seeded objects as Kubernetes API documents, in
    creation order."""
    docs = []
    for kind, obj in bench_objects(n_tasks, n_nodes, n_queues, n_groups,
                                   seed):
        meta = {"name": obj.metadata.name}
        if kind == "Queue":
            docs.append((kind, {
                "apiVersion": f"{API_GROUP}/v1alpha1", "kind": kind,
                "metadata": meta, "spec": {"weight": obj.spec.weight}}))
        elif kind == "Node":
            alloc = {k: str(v) for k, v in obj.status.allocatable.items()}
            docs.append((kind, {
                "apiVersion": "v1", "kind": kind,
                "metadata": dict(meta, uid=f"uid-{obj.metadata.name}"),
                "status": {"allocatable": alloc, "capacity": dict(alloc)}}))
        elif kind == "PodGroup":
            docs.append((kind, {
                "apiVersion": f"{API_GROUP}/v1alpha1", "kind": kind,
                "metadata": dict(meta, namespace=obj.metadata.namespace),
                "spec": {"minMember": obj.spec.min_member,
                         "queue": obj.spec.queue}}))
        else:
            docs.append((kind, {
                "apiVersion": "v1", "kind": kind,
                "metadata": dict(
                    meta, namespace=obj.metadata.namespace,
                    uid=obj.metadata.uid,
                    annotations=dict(obj.metadata.annotations)),
                "spec": {"schedulerName": "tpu-batch", "containers": [{
                    "name": "main", "resources": {"requests": {
                        k: str(v) for k, v in
                        obj.spec.containers[0].requests.items()}}}]},
                "status": {"phase": "Pending"}}))
    return docs


def serve(docs, bound=None):
    """A FakeKube holding ``docs`` (fresh copies); pods in ``bound``
    (``ns/name`` -> node) are already bound and Running."""
    fake = FakeKube()
    for kind, doc in docs:
        doc = json.loads(json.dumps(doc))
        key = f"{doc['metadata'].get('namespace')}/{doc['metadata']['name']}"
        if kind == "Pod" and bound and key in bound:
            doc["spec"]["nodeName"] = bound[key]
            doc["status"]["phase"] = "Running"
        fake.create(kind, doc)
    return fake


def api_truth(fake):
    """From the API server's objects: the bound pods (``ns/name`` ->
    node), the gangs bound below minMember, and the nodes over capacity
    (:func:`nodes_over`; one container a pod, as :func:`api_documents`
    writes them)."""
    with fake.lock:
        pods = [json.loads(json.dumps(p))
                for p in fake.objects["Pod"].values()]
        groups = {k: g["spec"]["minMember"]
                  for k, g in fake.objects["PodGroup"].items()}
        nodes = {k: dict(n["status"]["allocatable"])
                 for k, n in fake.objects["Node"].items()}
    bound, per_group, placed = {}, {}, []
    for p in pods:
        node = p["spec"].get("nodeName")
        if not node:
            continue
        md = p["metadata"]
        bound[f"{md['namespace']}/{md['name']}"] = node
        placed.append((node, p["spec"]["containers"][0]["resources"]
                       ["requests"]))
        group = (md.get("annotations") or {}).get(GROUP_NAME_ANNOTATION_KEY)
        if group:
            key = f"{md['namespace']}/{group}"
            per_group[key] = per_group.get(key, 0) + 1
    broken = sorted(g for g, minm in groups.items()
                    if 0 < per_group.get(g, 0) < minm)
    return {"bound": bound, "broken": broken,
            "over": nodes_over(nodes, placed), "pods": len(pods)}


# ``python -m kube_batch_tpu_torch <argv>`` over HTTP; after its
# ``__main__`` returns, the action's backend, the kernels' launch counts
# and the recovery report of the process.
_HTTP_PROBE = """
import json, runpy, sys
from kube_batch_tpu_torch.actions import allocate_tpu as ATPU
from kube_batch_tpu_torch.cache import recovery
from kube_batch_tpu_torch.solver import bid_kernels as BK
sys.argv = ["kube_batch_tpu_torch"] + %r
runpy.run_module("kube_batch_tpu_torch", run_name="__main__")
print("RESULT " + json.dumps({
    "backend": ATPU.last_stats.get("backend"),
    "solve_ladder": ATPU.last_stats.get("solve_ladder"),
    "launches": {"bid_dense": BK.bid_dense.launches,
                 "bid_sparse": BK.bid_sparse.launches},
    "recovery": recovery.LAST_RECOVERY}), flush=True)
"""


def process_argv(fake, dev, *extra):
    argv = ["--master", fake.url, "--scheduler-conf", TPU_CONF,
            "--listen-address", "127.0.0.1:0", *extra]
    if dev.type != "cuda":
        argv += ["--device", dev.type]
    return [sys.executable, "-c", _HTTP_PROBE % (argv,)]


def probe_result(text, what):
    lines = [line[7:] for line in text.splitlines()
             if line.startswith("RESULT ")]
    check(lines, f"{what}: the process printed no result")
    return json.loads(lines[-1])


def http_once(dev, docs, what):
    """12.3: ``python -m kube_batch_tpu_torch --master URL --once`` on
    ``dev`` against a fresh FakeKube holding ``docs``."""
    fake = serve(docs)
    landed = []
    fake.bind_failure_hook = lambda pod_key, hostname: landed.append(
        time.perf_counter())
    try:
        t0 = time.perf_counter()
        out = subprocess.run(process_argv(fake, dev, "--once"),
                             capture_output=True, text=True, timeout=600)
        seconds = time.perf_counter() - t0
        (OUT_DIR / f"phase12_once_{dev.type}.log").write_text(
            out.stdout + out.stderr)
        check(out.returncode == 0, f"{what}: the process exited "
              f"{out.returncode}: {out.stderr[-1500:]}")
        result = probe_result(out.stdout, what)
        truth = api_truth(fake)
        binds = sorted(fake.bindings)
    finally:
        fake.close()
    check(result["backend"] == f"torch-{dev.type}",
          f"{what}: solved on {result['backend']}")
    check(dev.type != "cuda" or result["launches"]["bid_dense"] > 0,
          f"{what}: bid_dense not launched: {result['launches']}")
    check(landed, f"{what}: the process bound nothing")
    check(len({p for p, _ in binds}) == len(binds),
          f"{what}: a pod was bound twice")
    check(not truth["broken"] and not truth["over"],
          f"{what}: gangs below minMember {truth['broken'][:5]}, nodes "
          f"over capacity {truth['over'][:5]}")
    return {"seconds": seconds, "first_bind_s": landed[0] - t0,
            "last_bind_s": landed[-1] - t0, "binds": binds,
            "bound": truth["bound"], "backend": result["backend"],
            "launches": result["launches"], "ladder": result["solve_ladder"]}


def journal_records(fake):
    with fake.lock:
        lease = fake.leases.get(f"{LEASES}/{KubeCluster.JOURNAL_LEASE_NAME}")
        raw = ((lease or {}).get("metadata", {}).get("annotations") or {}
               ).get(KubeCluster.JOURNAL_ANNOTATION, "")
    return json.loads(raw).get("records", []) if raw else []


def lease_holder(fake):
    with fake.lock:
        lease = fake.leases.get(f"{LEASES}/tpu-batch")
    return (lease or {}).get("spec", {}).get("holderIdentity")


def http_failover(dev, docs, card_bound, scale, what):
    """12.4: leader A (``--leader-elect``, loop mode) is killed with
    SIGKILL once the Lease annotation journals its bind intent and a
    third of that intent's pods are bound; B, started beside it once A
    leads, takes the Lease when it expires, reconciles A's journal and
    binds the rest (``--once``)."""
    n_groups = scale["http"][3]
    pending = {f"bench/pg{g}" for g in range(
        n_groups - scale["failover_pending_gangs"], n_groups)}
    prebound = {}
    for kind, doc in docs:
        if kind != "Pod":
            continue
        md = doc["metadata"]
        key = f"{md['namespace']}/{md['name']}"
        group = f"{md['namespace']}/{md['annotations'][GROUP_NAME_ANNOTATION_KEY]}"
        if group not in pending and key in card_bound:
            prebound[key] = card_bound[key]
    fake = serve(docs, bound=prebound)
    state = {"delay": scale["failover_bind_delay_s"], "times": []}

    def hold_bind(pod_key, hostname):
        state["times"].append(time.perf_counter())
        if state["delay"]:
            time.sleep(state["delay"])
        return None

    fake.bind_failure_hook = hold_bind
    argv = ("--leader-elect", "--lock-object-namespace", LEASE_NS)
    logs = {name: open(OUT_DIR / f"phase12_failover_{name}.log", "w+")
            for name in ("a", "b")}
    procs = {}
    try:
        t0 = time.perf_counter()
        procs["a"] = subprocess.Popen(process_argv(fake, dev, *argv),
                                      stdout=logs["a"], stderr=logs["a"])
        a_identity = f"-{procs['a'].pid}"
        deadline = time.perf_counter() + 300.0
        while not (lease_holder(fake) or "").endswith(a_identity):
            check(procs["a"].poll() is None and time.perf_counter()
                  < deadline, f"{what}: leader A never took the Lease")
            time.sleep(0.05)
        t_lead = time.perf_counter() - t0
        procs["b"] = subprocess.Popen(
            process_argv(fake, dev, *argv, "--once"),
            stdout=logs["b"], stderr=logs["b"])
        cut = None
        while cut is None:
            check(procs["a"].poll() is None and time.perf_counter()
                  < deadline, f"{what}: no cut point: A exited or its "
                  f"binds drained first ({len(fake.bindings)} binds)")
            records = journal_records(fake)
            with fake.lock:
                landed = {p for p, _ in fake.bindings}
            for rec in records:
                pods = [t["pod"] for t in rec["tasks"]]
                done = sum(p in landed for p in pods)
                if done * 3 >= len(pods):
                    cut = {"records": len(records), "tasks": len(pods),
                           "bound": done, "seq": rec["seq"]}
                    break
            if cut is None:
                time.sleep(0.01)
        procs["a"].kill()
        t_kill = time.perf_counter()
        procs["a"].wait(timeout=60)
        state["delay"] = 0.0
        cut["binds_before"] = len(fake.bindings)
        check(procs["b"].wait(timeout=300) == 0,
              f"{what}: successor B exited {procs['b'].returncode}")
        seconds = time.perf_counter() - t0
        logs["b"].seek(0)
        result = probe_result(logs["b"].read(), f"{what} B")
        after = [t - t_kill for t in state["times"] if t > t_kill + 1.0]
        truth = api_truth(fake)
        binds = list(fake.bindings)
        left = KubeCluster(KubeConfig(fake.url),
                           watch_kinds=()).list_bind_intents()
        holder = lease_holder(fake)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=60)
        for f in logs.values():
            f.close()
        fake.close()
    rec = result["recovery"] or {}
    check(rec.get("intents_scanned", 0) >= 1 and rec.get("errors") == 0,
          f"{what}: B's recovery {rec}")
    check(result["backend"] == f"torch-{dev.type}"
          and (dev.type != "cuda" or result["launches"]["bid_dense"] > 0),
          f"{what}: B solved on {result['backend']}, launches "
          f"{result['launches']}")
    check(after, f"{what}: B bound nothing")
    check(not left, f"{what}: the journal still holds {len(left)} intents")
    check(len({p for p, _ in binds}) == len(binds),
          f"{what}: a pod was bound twice")
    check(len(truth["bound"]) == truth["pods"],
          f"{what}: {len(truth['bound'])} of {truth['pods']} pods bound")
    check(not truth["broken"] and not truth["over"],
          f"{what}: gangs below minMember {truth['broken'][:5]}, nodes "
          f"over capacity {truth['over'][:5]}")
    check(holder == "", f"{what}: B left the Lease held by {holder!r}")
    return {"seconds": seconds, "a_leads_after_s": t_lead, "cut": cut,
            "prebound": len(prebound),
            "successor_first_bind_s": min(after),
            "successor_binds": len(after), "recovery": {
                k: rec.get(k) for k in ("intents_scanned", "outcomes",
                                        "gangs_repaired", "gangs_evicted")},
            "backend": result["backend"], "launches": result["launches"],
            "pods_left": truth["pods"]}


def run_phase12(dev, scale=PHASE12):
    """Phase 12: the perf harness in this process, then the process over
    HTTP against the FakeKube."""
    out, t_phase = {}, time.perf_counter()
    for name, kw in scale["density"]:
        what = f"phase 12.1 density {name}"
        out[name] = density_run(dev, what, kw)
        d = out[name]
        log(f"{what}: {kw['total_pods']} pods running in "
            f"{d['wall_seconds']} s ({d['pods_per_second']} pods/s), "
            f"{d['cycles']} cycles ({d['micro']} micro), {d['solving']} "
            f"solving on {d['rungs']}, launches {d['launches']}; latency ms "
            f"{json.dumps(d['latency_ms'])}")

    what = "phase 12.2 multitenant-compare"
    out["multitenant"] = multitenant_run(dev, what, scale["multitenant"])
    m = out["multitenant"]
    for action in ("allocate_tpu", "allocate"):
        r = m[action]
        log(f"{what} {action}: tenant B {r['tenant_b_running']} admitted, "
            f"{r['besteffort_backfilled']} backfilled, "
            f"{r['tenant_a_evicted']} evicted, admission ms "
            f"{json.dumps(r['admission_ms'])}, {r['wall_seconds']} s, "
            f"launches {r['launches']}")
    log(f"{what}: comparison {json.dumps(m['comparison'])}")

    what = "phase 12.3 --master --once"
    docs = api_documents(*scale["http"], seed=0)
    card = http_once(dev, docs, f"{what} ({dev.type})")
    cpu = http_once(torch.device("cpu"), docs, f"{what} (cpu)")
    check(card["binds"] == cpu["binds"],
          f"{what}: the card bound {len(card['binds'])} pods, the CPU "
          f"{len(cpu['binds'])}; the (pod, node) sets differ")
    out["http_once"] = {
        dev.type: {k: v for k, v in card.items()
                   if k not in ("binds", "bound")},
        "cpu": {k: v for k, v in cpu.items() if k not in ("binds", "bound")},
        "binds": len(card["binds"])}
    log(f"{what}: {len(card['binds'])} binds over HTTP, card = CPU; "
        f"{card['seconds']:.1f} s on the card (binds from "
        f"{card['first_bind_s']:.1f} to {card['last_bind_s']:.1f} s, "
        f"{card['launches']}), {cpu['seconds']:.1f} s on the CPU (binds "
        f"from {cpu['first_bind_s']:.1f} to {cpu['last_bind_s']:.1f} s)")

    what = "phase 12.4 Lease failover"
    out["failover"] = fo = http_failover(dev, docs, card["bound"], scale,
                                         what)
    log(f"{what}: A led after {fo['a_leads_after_s']:.1f} s, killed at "
        f"{json.dumps(fo['cut'])}; B's first bind "
        f"{fo['successor_first_bind_s']:.1f} s after the kill, "
        f"{fo['successor_binds']} binds on {fo['backend']} "
        f"({fo['launches']}), recovery {json.dumps(fo['recovery'])}; "
        f"{fo['seconds']:.1f} s")
    out["seconds"] = time.perf_counter() - t_phase
    log(f"phase 12: {out['seconds']:.1f} s")
    return out

# -- phase 13: the mesh on the card ------------------------------------------

# Shapes (tasks, nodes, queues, gangs) of phase 13. ``dense`` runs the
# commit-style rounds (T > spmd._POOL_MAX_T), ``pool`` the pool style,
# ``staged`` a commit-style head and pool-style tails; ``sparse`` forces
# flat and two-level; ``flat`` and ``two_level`` are the policy's own
# engagement sizes (T >= 2^16, and T >= 2^19 on 4 shards).
PHASE13 = dict(
    dense=(10_000, 1_000, 4, 100),
    pool=(4_000, 1_000, 4, 100),
    staged=(50_000, 5_000, 5, 500),
    sparse=(50_000, 5_000, 5, 500),
    flat=(100_000, 10_000, 5, 1_000),
    two_level=(524_288, 20_480, 5, 4_096),
    k=64,
    shards=(2, 4, 8),
    # The CPU runs of 13.1, on this many shards: the dense and pool
    # shapes, and forced two-level at cpu_two_level (card = CPU; at 50k x
    # 5k the card's two-level is held valid, its CPU run, 42-58 s, was
    # cut for time when phase 14 joined, as was forced flat's, 54 s:
    # flat is held to the card's single-device chain). The staged 50k x
    # 5k dense solve is held to the card's single-device solve only (on
    # the CPU its [T, N] rounds take minutes).
    cpu_shards=4,
    cpu_two_level=(10_000, 2_048, 4, 100),
    cluster=(50_000, 5_000, 5, 500),
    sim=dict(cycles=20, seed=3, backend="sparse", topk=8,
             workload=WorkloadSpec(nodes=12, arrival_rate=1.5,
                                   max_jobs_in_flight=64)),
    study=("--seeds", "1", "--cycles", "20", "--workers", "2"),
)


@contextlib.contextmanager
def virtual_shards(n):
    """The process's virtual shard count for the block."""
    saved = DEV.host_device_count()
    DEV.set_host_device_count(n)
    try:
        yield
    finally:
        DEV.set_host_device_count(saved)


def zero_launches():
    BK.bid_dense.launches = 0
    BK.bid_sparse.launches = 0


def read_launches():
    return {"bid_dense": BK.bid_dense.launches,
            "bid_sparse": BK.bid_sparse.launches}


def timed(fn, dev):
    _sync(dev)
    t0 = time.perf_counter()
    res = fn()
    _sync(dev)
    return res, (time.perf_counter() - t0) * 1e3


def sharded_run(packed, mesh, dev, what, mode=None, staged=None):
    """``solve_sharded`` over ``mesh``, with KBT_SPARSE_SHARD_MODE forced
    to ``mode`` when given; the sharded bodies run the plain chain, so no
    bid kernel may launch."""
    env = {"KBT_SPARSE_SHARD_MODE": mode} if mode else {}
    zero_launches()
    with environ(**env):
        res, ms = timed(
            lambda: SH.solve_sharded(packed, mesh, staged=staged), dev)
    check(read_launches() == {"bid_dense": 0, "bid_sparse": 0},
          f"{what}: a bid kernel launched in the sharded bodies")
    return res, ms, dict(SH.last_dispatch)


def placed(res, T):
    return int((res.assigned[:T] >= 0).sum())


def queue_accounting(host, res, T, what):
    """The result's queue allocation is the start plus the placed
    requests, per queue (float64 sum against the solver's float32
    folds: within 1.0, ten times under the 10.0 epsilon)."""
    a = res.assigned[:T].cpu().numpy()
    want = host.queue_allocated.astype(np.float64).copy()
    sel = a >= 0
    np.add.at(want, host.task_queue[:T][sel], host.task_req[:T][sel])
    got = res.queue_allocated.cpu().numpy()
    check(np.allclose(got, want, atol=1.0, rtol=1e-6),
          f"{what}: queue accounting off by "
          f"{np.abs(got - want).max():.3f}")
    caps = host.node_max_tasks
    counts = np.bincount(a[sel], minlength=len(caps))
    check(((caps == 0) | (counts <= caps)).all(),
          f"{what}: a node over its pod cap")


def mesh_dense(dev, scale, smi):
    """13.1, dense: the node-sharded solve on 2, 4 and 8 virtual shards
    of the card, bit-equal to the card's single-device plain chain, and
    (at the smaller shapes) to the same sharded solve on the CPU."""
    out = {}
    for name, staged in (("dense", False), ("pool", False),
                         ("staged", True)):
        host, T, N = build_snapshot(*scale[name], seed=0)
        packed = pack_inputs(host, dev)
        single = K.solve_staged if staged else K.solve
        ref, ref_ms = timed(
            lambda: single(packed, use_kernel=False), dev)
        refn = ref.to_numpy()
        rec = {"T": T, "N": N, "Tp": host.task_req.shape[0],
               "rounds": ref.rounds, "stages": ref.stages,
               "placed": placed(ref, T), "single_ms": ref_ms, "shards": {}}
        for n in scale["shards"]:
            what = f"13.1 {name} on {n} shards"
            res, ms, disp = sharded_run(packed, Mesh([dev] * n), dev, what,
                                        staged=staged)
            check(disp == {"mode": "dense-spmd", "shards": n,
                           "sparse_sharded": False}, f"{what}: {disp}")
            same_result(res.to_numpy(), refn, what)
            rec["shards"][n] = ms
        if name != "staged":
            n = scale["cpu_shards"]
            cpu, cpu_ms = timed(lambda: SH.solve_sharded(
                pack_inputs(host, "cpu"), Mesh(["cpu"] * n),
                staged=staged), torch.device("cpu"))
            same_result(cpu.to_numpy(), refn, f"13.1 {name} CPU")
            rec["cpu_ms"] = cpu_ms
        out[name] = rec
        log(f"phase 13.1: dense {name} {T}x{N} (Tp {rec['Tp']}): "
            f"{rec['rounds']} rounds, {rec['stages']} stages, placed "
            f"{rec['placed']}; single plain {ref_ms:.1f} ms, sharded "
            + ", ".join(f"{n}: {ms:.1f} ms" for n, ms in
                        rec["shards"].items())
            + (f", CPU on {scale['cpu_shards']}: {rec['cpu_ms']:.1f} ms"
               if "cpu_ms" in rec else "") + f" ({smi})")
    return out


def mesh_sparse(dev, scale, smi):
    """13.1, sparse: flat and two-level forced at 50k x 5k (two-level
    card = CPU at the smaller ``cpu_two_level`` shape), then the
    policy's own engagement sizes on the card."""
    out = {}
    k = scale["k"]
    host, T, N = build_snapshot(*scale["sparse"], seed=0, k=k)
    packed = pack_inputs(host, dev)
    ref, ref_ms = timed(
        lambda: K.solve_sparse(packed, use_kernel=False), dev)
    refn = ref.to_numpy()
    rec = {"T": T, "N": N, "rounds": ref.rounds, "stages": ref.stages,
           "refills": ref.refills, "placed": placed(ref, T),
           "single_ms": ref_ms, "flat": {}, "two_level": {}}
    card_two = {}
    for n in scale["shards"]:
        mesh = Mesh([dev] * n)
        what = f"13.1 flat on {n} shards"
        res, ms, disp = sharded_run(packed, mesh, dev, what, mode="flat")
        check(disp["mode"] == "flat" and disp["shards"] == n,
              f"{what}: {disp}")
        same_result(res.to_numpy(), refn, what)
        rec["flat"][n] = {"ms": ms, "reconcile_rounds": res.reconcile_rounds,
                          **SP.last_commit_stats}
        what = f"13.1 two-level on {n} shards"
        res, ms, disp = sharded_run(packed, mesh, dev, what,
                                    mode="two-level")
        check(disp["mode"] == "two-level", f"{what}: {disp}")
        validated(host, res, T, N, what)
        queue_accounting(host, res, T, what)
        card_two[n] = res.to_numpy()
        rec["two_level"][n] = {
            "ms": ms, "rounds": res.rounds, "stages": res.stages,
            "refills": res.refills, "placed": placed(res, T),
            "reconcile_rounds": res.reconcile_rounds}
    # Card = CPU for forced two-level at the smaller cpu_two_level shape
    # (its CPU run at 50k x 5k took 42-58 s).
    n = scale["cpu_shards"]
    small, Ts, Ns = build_snapshot(*scale["cpu_two_level"], seed=0, k=k)
    with environ(KBT_SPARSE_SHARD_MODE="two-level"):
        card_small = SH.solve_sharded(pack_inputs(small, dev),
                                      Mesh([dev] * n)).to_numpy()
        res, cpu_ms = timed(lambda: SH.solve_sharded(
            pack_inputs(small, "cpu"), Mesh(["cpu"] * n)),
            torch.device("cpu"))
    same_result(res.to_numpy(), card_small,
                f"13.1 two-level CPU on {n} shards at {Ts}x{Ns}")
    rec["cpu_two_level_ms"] = cpu_ms
    rec["cpu_two_level_shape"] = f"{Ts}x{Ns}"
    out["forced_50k"] = rec
    log(f"phase 13.1: sparse {T}x{N} K={k}: single plain {ref_ms:.1f} ms "
        f"({rec['rounds']} rounds, {rec['refills']} refills, placed "
        f"{rec['placed']}); flat "
        + ", ".join(f"{n}: {r['ms']:.1f} ms" for n, r in rec["flat"].items())
        + "; two-level "
        + ", ".join(f"{n}: {r['ms']:.1f} ms placed {r['placed']}"
                    for n, r in rec["two_level"].items())
        + f"; two-level on the CPU at {rec['cpu_two_level_shape']} "
        f"{rec['cpu_two_level_ms']:.1f} ms, equal to the card ({smi})")
    flat = rec["flat"][scale["cpu_shards"]]
    log(f"phase 13.1: commit bytes per commit {flat['commit_bytes_exchanged']}"
        f" (full broadcast {flat['commit_bytes_full_broadcast']}, per round "
        f"{flat['commit_bytes_per_round']}), reconcile rounds "
        f"{flat['reconcile_rounds']}")

    # The policy's own engagement sizes, unforced, on 4 shards.
    mesh = Mesh([dev] * 4)
    host, T, N = build_snapshot(*scale["flat"], seed=0, k=k)
    packed = pack_inputs(host, dev)
    check(SH.sparse_shard_mode(host.task_req.shape[0], mesh) == "flat",
          "13.1: the flat size is outside the flat policy")
    ref, ref_ms = timed(
        lambda: K.solve_sparse(packed, use_kernel=False), dev)
    res, ms, disp = sharded_run(packed, mesh, dev, "13.1 flat unforced")
    check(disp["mode"] == "flat", f"13.1 flat unforced: {disp}")
    same_result(res.to_numpy(), ref.to_numpy(), "13.1 flat unforced")
    out["flat_policy"] = {"T": T, "N": N, "single_ms": ref_ms, "ms": ms,
                          "rounds": res.rounds, "refills": res.refills,
                          "placed": placed(res, T),
                          "reconcile_rounds": res.reconcile_rounds}
    log(f"phase 13.1: flat unforced {T}x{N} on 4 shards: {ms:.1f} ms "
        f"(single plain {ref_ms:.1f} ms), placed {placed(res, T)} ({smi})")
    del packed, ref, res
    host, T, N = build_snapshot(*scale["two_level"], seed=0, k=k)
    packed = pack_inputs(host, dev)
    check(SH.sparse_shard_mode(host.task_req.shape[0], mesh) == "two-level",
          "13.1: the two-level size is outside the two-level policy")
    runs = []
    for i in range(2):
        res, ms, disp = sharded_run(packed, mesh, dev,
                                    f"13.1 two-level unforced run {i}")
        check(disp["mode"] == "two-level",
              f"13.1 two-level unforced: {disp}")
        runs.append((res, ms))
    (a, ms0), (b, ms1) = runs
    same_result(a.to_numpy(), b.to_numpy(), "13.1 two-level determinism")
    validated(host, a, T, N, "13.1 two-level unforced")
    queue_accounting(host, a, T, "13.1 two-level unforced")
    out["two_level_policy"] = {
        "T": T, "N": N, "ms": [ms0, ms1], "rounds": a.rounds,
        "stages": a.stages, "refills": a.refills, "placed": placed(a, T),
        "reconcile_rounds": a.reconcile_rounds}
    log(f"phase 13.1: two-level unforced {T}x{N} on 4 shards: {ms0:.1f} / "
        f"{ms1:.1f} ms, identical, placed {placed(a, T)}, "
        f"{a.rounds} rounds ({a.reconcile_rounds} reconcile), "
        f"{a.refills} refills ({smi})")
    return out


def mesh_cycle(dev, shape, shards, what, mode=None, plain=False,
               then=None):
    """A cold ``Scheduler.run_once`` at 50k x 5k under ``shards`` virtual
    shards (``mode`` forcing KBT_SPARSE_SHARD_MODE, ``plain`` the plain
    chain on the shared action); ``then`` is a shard count for a second
    cycle. Returns (cold cycle, binds, dispatch, second cycle)."""
    cache = build_cluster(*shape, seed=0)
    env = {"KBT_SPARSE_SHARD_MODE": mode} if mode else {}
    second = None
    try:
        with virtual_shards(shards), environ(**env):
            sched = Scheduler(cache, TPU_CONF, device=dev)
            tpu = [a for a in sched.actions if a.name() == "allocate_tpu"]
            saved = [a.use_kernel for a in tpu]
            for a in tpu:
                a.use_kernel = not plain
            try:
                cyc = scheduler_cycle(sched, dev)
                disp = dict(SH.last_dispatch)
                binds = dict(cache.binder.binds)
                if then is not None:
                    DEV.set_host_device_count(then)
                    second = scheduler_cycle(sched, dev)
            finally:
                for a, u in zip(tpu, saved):
                    a.use_kernel = u
    finally:
        cache.shutdown()
    check(cyc["stats"].get("backend") == f"torch-{dev.type}",
          f"{what}: solved on {cyc['stats'].get('backend')}")
    check(cyc["new_fallbacks"] == 0, f"{what}: the ladder descended")
    return cyc, binds, disp, second


def mesh_scheduler(dev, scale, smi):
    """13.2: ``Scheduler.run_once`` under a 4-shard mesh at 50k x 5k."""
    out = {}
    shape = scale["cluster"]
    ref, ref_binds, _, _ = mesh_cycle(dev, shape, 1, "13.2 mesh-less")
    cyc, binds, disp, second = mesh_cycle(dev, shape, 4, "13.2 unforced",
                                          then=2)
    check(disp["mode"] == "single" and disp["shards"] == 4,
          f"13.2 unforced: dispatch {disp}")
    check(dev.type != "cuda" or cyc["launches"]["bid_sparse"] > 0,
          "13.2 unforced: bid_sparse not launched under the mesh")
    check(binds == ref_binds, "13.2 unforced: binds differ from the "
          "mesh-less run")
    check(second["warm"] == "mesh-changed",
          f"13.2: after 4 -> 2 shards the warm plan read {second['warm']}")
    plain_ref, plain_binds, _, _ = mesh_cycle(dev, shape, 1, "13.2 plain",
                                              plain=True)
    flat, flat_binds, _, _ = mesh_cycle(dev, shape, 4, "13.2 flat",
                                        mode="flat", plain=True)
    st = flat["stats"]
    check(st.get("sparse_sharded_engaged") is True
          and st.get("sparse_shard_mode") == "flat"
          and st.get("sparse_shard_count") == 4,
          f"13.2 flat: stats {({k: st.get(k) for k in ('sparse_sharded_engaged', 'sparse_shard_mode', 'sparse_shard_count')})}")
    check(flat_binds == plain_binds,
          "13.2 flat: binds differ from the single-device chain's")
    for name, c in (("mesh-less", ref), ("unforced", cyc),
                    ("plain", plain_ref), ("flat", flat),
                    ("after 4->2", second)):
        out[name] = {"launches": c["launches"], "warm": c["warm"],
                     "ms": c["ms"],
                     **{k: c["stats"].get(k) for k in (
                         "sparse_engaged", "sparse_sharded_engaged",
                         "sparse_shard_mode", "sparse_shard_count",
                         "sparse_reconcile_rounds", "solve_ms")}}
        log(f"phase 13.2: {name}: cycle {c['ms']['wall_ms']:.1f} ms, solve "
            f"{c['stats'].get('solve_ms')} ms, warm {c['warm']}, launches "
            f"{c['launches']}, sharded {c['stats'].get('sparse_shard_mode')}"
            f" ({smi})")
    out["binds"] = len(binds)
    out["launches"] = cyc["launches"]
    return out


def mesh_entry_points(dev, scale, smi):
    """13.3: ``sim --host-devices 4 --backend sparse --topk 8`` card =
    CPU (flat forced, so the sharded path runs), and ``sim-study --preset
    twolevel`` on the card."""
    before = metrics.solver_sparse_sharded.total()
    with virtual_shards(4), environ(KBT_SPARSE_SHARD_MODE="flat"):
        card, host = sim_card_and_cpu(dev, "13.3 sim", **scale["sim"])
    check(card["records"] == host["records"],
          f"13.3 sim: card trace != CPU trace at "
          f"{sim_first_diff(card['records'], host['records'])}")
    sharded = int(metrics.solver_sparse_sharded.total() - before)
    check(sharded > 0, "13.3 sim: no sharded sparse solve ran")
    out = {"sim": {"card": sim_summary(card), "cpu": sim_summary(host),
                   "sharded_solves": sharded}}
    log(f"phase 13.3: sim --host-devices 4 (flat): {len(card['records'])} "
        f"cycles, card {card['seconds']:.1f} s = CPU {host['seconds']:.1f} "
        f"s record for record, {sharded} sharded solves ({smi})")
    path = OUT_DIR / "phase13_study.json"
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "kube_batch_tpu_torch", "sim-study",
         "--preset", "twolevel", "--device", dev.type, *scale["study"],
         "--out", str(path), "--quiet"],
        capture_output=True, text=True, timeout=600,
    )
    check(proc.returncode == 0,
          f"13.3 sim-study: exit {proc.returncode}: {proc.stderr[-2000:]}")
    study = json.loads(path.read_text())
    verdict = study.get("verdict") or {}
    out["study"] = {"seconds": time.perf_counter() - t0,
                    "verdict": verdict, "per_seed": study.get("per_seed")}
    log(f"phase 13.3: sim-study --preset twolevel on the card: "
        f"{verdict.get('verdict')} (density median delta "
        f"{verdict.get('density_dom_median_delta')}, fairness "
        f"{verdict.get('fairness_jain_median_delta')}) in "
        f"{out['study']['seconds']:.1f} s ({smi})")
    return out


def mesh_distributed(dev, scale, smi):
    """13.4: ``init_distributed`` on NCCL, world size 1, 4 virtual
    shards; the cross-process leg of the collectives on the card."""
    import torch.distributed as dist

    from kube_batch_tpu_torch.solver.collectives import _gather_processes

    host, T, N = build_snapshot(*scale["pool"], seed=0)
    packed = pack_inputs(host, dev)
    ref = K.solve(packed, use_kernel=False).to_numpy()
    check(SH.init_distributed(f"127.0.0.1:{free_port()}", 1, 0, device=dev),
          "13.4: init_distributed did not join")
    try:
        want = "nccl" if dev.type == "cuda" else "gloo"
        check(dist.get_backend() == want, f"13.4: not {want}")
        check(SH.init_distributed("127.0.0.1:1", 1, 0, device=dev),
              "13.4: a second join is not idempotent")
        x = torch.arange(12, device=dev, dtype=torch.int32).reshape(2, 6)
        check(torch.equal(_gather_processes(x), x),
              "13.4: the NCCL leg changed a world-1 gather")
        with virtual_shards(4):
            mesh = SH.default_mesh(device=dev)
            check(mesh is not None and mesh.size == 4 and mesh.world == 1,
                  f"13.4: mesh {mesh}")
            res, ms, _ = sharded_run(packed, mesh, dev, "13.4", staged=False)
        same_result(res.to_numpy(), ref, "13.4")
    finally:
        dist.destroy_process_group()
    log(f"phase 13.4: {want} world 1, 4 virtual shards: {ms:.1f} ms, equal "
        f"to the single-device solve ({smi})")
    return {"ms": ms}


def mesh_real(dev, scale, smi):
    """13.5: 13.1's dense and flat cases on a mesh of distinct cards,
    where there are two or more."""
    count = torch.cuda.device_count()
    if count < 2:
        log(f"phase 13.5: the real multi-card mesh was not run: "
            f"{count} CUDA device visible ({smi})")
        return {"run": False, "devices": count}
    mesh = Mesh([torch.device("cuda", i) for i in range(count)])
    out = {"run": True, "devices": count}
    host, T, N = build_snapshot(*scale["dense"], seed=0)
    packed = pack_inputs(host, dev)
    ref = K.solve(packed, use_kernel=False).to_numpy()
    res, ms, _ = sharded_run(packed, mesh, dev, "13.5 dense", staged=False)
    same_result(res.to_numpy(), ref, "13.5 dense")
    out["dense_ms"] = ms
    host, T, N = build_snapshot(*scale["sparse"], seed=0, k=scale["k"])
    packed = pack_inputs(host, dev)
    ref = K.solve_sparse(packed, use_kernel=False).to_numpy()
    res, ms, _ = sharded_run(packed, mesh, dev, "13.5 flat", mode="flat")
    same_result(res.to_numpy(), ref, "13.5 flat")
    out["flat_ms"] = ms
    log(f"phase 13.5: {count} cards: dense {out['dense_ms']:.1f} ms, flat "
        f"{ms:.1f} ms, equal to the single-device solves ({smi})")
    return out


def run_phase13(dev, smi, scale=PHASE13):
    """Phase 13: the mesh on the card (virtual shards of ``dev``)."""
    t0 = time.perf_counter()
    out = {"dense": mesh_dense(dev, scale, smi),
           "sparse": mesh_sparse(dev, scale, smi)}
    out["scheduler"] = mesh_scheduler(dev, scale, smi)
    out["entry_points"] = mesh_entry_points(dev, scale, smi)
    out["distributed"] = mesh_distributed(dev, scale, smi)
    out["real_mesh"] = mesh_real(dev, scale, smi)
    out["seconds"] = time.perf_counter() - t0
    log(f"phase 13: {out['seconds']:.1f} s ({smi})")
    return out


# ---------------------------------------------------------------------------
# Phase 14: the benchmark entry point (kube_batch_tpu_torch.bench).
# ---------------------------------------------------------------------------

PHASE14 = dict(quick=["--quick"], scale="200000x20000")


def bench_smoke_subprocess(dev):
    """14.1: ``python -m kube_batch_tpu_torch.bench --smoke`` on the
    card, in a subprocess."""
    env = dict(os.environ)
    env.pop("KBT_SOLVER_TOPK", None)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "kube_batch_tpu_torch.bench", "--smoke",
         "--device", dev.type],
        capture_output=True, text=True, timeout=600, env=env,
    )
    seconds = time.perf_counter() - t0
    check(proc.returncode == 0,
          f"14.1 bench --smoke: exit {proc.returncode}: "
          f"{proc.stderr[-2000:]}")
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    check(out.get("sparse_engaged") is True,
          f"14.1 bench --smoke: sparse_engaged {out.get('sparse_engaged')}")
    check(out.get("backend") == f"torch-{dev.type}",
          f"14.1 bench --smoke: backend {out.get('backend')}")
    cold = out["cycle"]["cold"]
    return {"seconds": seconds, "backend": out["backend"],
            "sparse_k": out.get("sparse_k"),
            "cold_solve_ms": out.get("cold_solve_ms"),
            "cold_cycle_ms": cold.get("cycle_ms"),
            "placed": cold.get("placed")}


def section_errors(out, path=""):
    """Every ``error`` key under a bench record, by its path."""
    found = []
    if isinstance(out, dict):
        for k, v in out.items():
            if k == "error":
                found.append(f"{path or '/'}: {v}")
            else:
                found += section_errors(v, f"{path}/{k}")
    return found


def bench_quick(dev, scale, smi):
    """14.2: ``bench.main(["--quick"])`` in this process on the card; the
    headline held to ``bench_tpu`` on the CPU on the same (kernel)
    chain."""
    from kube_batch_tpu_torch import bench as PB

    seen = {}
    real = PB.bench_tpu

    def spy(cfg, *a, **kw):
        seen.update(real(cfg, *a, **kw), cfg=cfg)
        return seen

    buf = io.StringIO()
    zero_launches()
    t0 = time.perf_counter()
    with patched(PB, "bench_tpu", spy), contextlib.redirect_stdout(buf):
        PB.main([*scale["quick"], "--device", dev.type])
    seconds = time.perf_counter() - t0
    launches = read_launches()
    out = json.loads(buf.getvalue().strip().splitlines()[-1])
    (OUT_DIR / "phase14_quick.json").write_text(json.dumps(out, indent=1))
    prov = out["device_provenance"]
    if dev.type == "cuda":
        check(prov["device_kind"] == torch.cuda.get_device_name(0),
              f"14.2: device_provenance {prov}")
    errors = section_errors(out)
    check(not errors, f"14.2: sections failed: {errors}")
    # On the CPU the native loop is the headline (as in the reference).
    check(dev.type != "cuda" or out["solver_path"] == "torch-cuda",
          f"14.2: solver_path {out['solver_path']}")
    cpu = PB.bench_tpu(seen["cfg"], device="cpu")
    cpu["cache"].shutdown()
    check(cpu["placed"] == seen["placed"],
          f"14.2: placed {seen['placed']} on the card, {cpu['placed']} on "
          f"the CPU")
    check(cpu["rounds"] == seen["rounds"],
          f"14.2: rounds {seen['rounds']} on the card, {cpu['rounds']} on "
          f"the CPU")
    check(dev.type != "cuda" or (out["pods_placed"], out["solver_rounds"])
          == (seen["placed"], seen["rounds"]),
          "14.2: the printed headline is not the measured solve's")
    check(np.array_equal(cpu["assigned"], seen["assigned"]),
          "14.2: the headline's assignment differs from the CPU's")
    cycle = out["cycle"]
    return {"seconds": seconds, "launches": launches,
            "metric": out["metric"], "value": out["value"],
            "vs_baseline": out["vs_baseline"],
            "native_greedy_ms": out.get("native_greedy_ms"),
            "pods_placed": out["pods_placed"],
            "solver_rounds": out["solver_rounds"],
            "cycle_ms": {k: cycle[k].get("cycle_ms") for k in (
                "cold", "steady", "idle", "delta", "degraded",
                "steady_warm")},
            "device_provenance": prov}


def bench_scale(dev, scale, smi):
    """14.3: ``bench_sparse_scale`` at 200,000 x 20,000 on the card."""
    from kube_batch_tpu_torch import bench as PB

    zero_launches()
    t0 = time.perf_counter()
    out = PB.bench_sparse_scale(scale["scale"], device=dev)
    seconds = time.perf_counter() - t0
    launches = read_launches()
    check("error" not in out, f"14.3: {out.get('error')}")
    check(out.get("select_device_parity") == 1,
          f"14.3: select_device_parity {out.get('select_device_parity')} "
          f"(path {out.get('select_path')})")
    check(out["invalid_placements"] == 0,
          f"14.3: {out['invalid_placements']} placements rejected")
    check(out["backend"] == f"torch-{dev.type}", f"14.3: {out['backend']}")
    check(dev.type != "cuda" or launches["bid_sparse"] > 0,
          "14.3: bid_sparse not launched")
    return dict(out, seconds=seconds, launches=launches)


def run_phase14(dev, smi, scale=PHASE14):
    """Phase 14: the benchmark entry point on the card."""
    t0 = time.perf_counter()
    out = {"smoke": bench_smoke_subprocess(dev)}
    sm = out["smoke"]
    log(f"phase 14.1: bench --smoke: exit 0, sparse K={sm['sparse_k']} on "
        f"{sm['backend']}, cold cycle {sm['cold_cycle_ms']} ms (solve "
        f"{sm['cold_solve_ms']} ms), {sm['seconds']:.1f} s ({smi})")
    out["quick"] = bench_quick(dev, scale, smi)
    q = out["quick"]
    log(f"phase 14.2: bench --quick: {q['metric']} {q['value']} ms against "
        f"native {q['native_greedy_ms']} ms (vs_baseline {q['vs_baseline']}"
        f"), {q['pods_placed']} placed in {q['solver_rounds']} rounds = "
        f"CPU; cycles {q['cycle_ms']} ms; launches {q['launches']}; "
        f"{q['seconds']:.1f} s ({smi})")
    out["scale"] = bench_scale(dev, scale, smi)
    c = out["scale"]
    log(f"phase 14.3: {c['shape']}: selection device {c['select_ms_device']}"
        f" ms cold, {c.get('select_ms_device_warm')} warm against host "
        f"{c['select_ms_host']} / {c.get('select_ms_host_warm')} ms "
        f"(parity {c['select_device_parity']}, {c['classes']} classes); "
        f"solve {c['solve_ms']} ms, placed {c['placed']} in {c['rounds']} "
        f"rounds, valid; native {c['native_solve_ms']} ms, placed "
        f"{c['native_placed']}; launches {c['launches']} ({smi})")
    out["launches"] = {
        k: out["quick"]["launches"][k] + out["scale"]["launches"][k]
        for k in out["quick"]["launches"]}
    check(dev.type != "cuda" or all(out["launches"].values()),
          f"phase 14: a kernel was not launched: {out['launches']}")
    out["seconds"] = time.perf_counter() - t0
    log(f"phase 14: {out['seconds']:.1f} s ({smi})")
    return out


# ---------------------------------------------------------------------------
# Phase 15: the reference's last tools on the card (kube_batch_tpu_torch.tools).
# ---------------------------------------------------------------------------

# soak: the endurance soak with the TPU policy (the tool's default is the
# greedy allocate, which solves on no device), cut from the reference's 5
# minutes to 1.5 for the script's time. sim_soak: the Makefile's
# soak-smoke mix (seed 3, 2,000 cycles) on the card. latency_backends: the
# latency smoke's backends on the card. devices: the virtual shards of
# the card that multichip_50k's two stages run on.
PHASE15 = dict(
    soak=["--minutes", "1.5", "--nodes", "50", "--period", "0.2",
          "--conf", TPU_CONF],
    sim_soak=["--cycles", "2000", "--seed", "3", "--soak", "--quiet"],
    sim_backends=("dense", "native"),
    latency_backends=("native", "dense"),
    devices=8,
)
# The soak detectors' absolute floor for the CUDA allocator series
# (sim/soak.py GROWTH_POLICY): the soak's live bytes at its end must stay
# within it of their value after the first solving cycle.
SOAK_MEMORY_SLACK = 16 * 1024 * 1024


def tool_soak(dev, scale, smi):
    """15.1: ``tools.soak`` with the TPU policy on the card, in this
    process: exit 0, at least half the nominal cycles, every solving
    cycle on the card on one ``ok`` rung with ``bid_dense`` launched, no
    breaker pin or trip, the allocator's live bytes flat."""
    from kube_batch_tpu_torch.tools import soak as SOAK

    args = SOAK.parse_args([*scale["soak"], "--device", dev.type])
    zero_launches()
    t0 = time.perf_counter()
    out = SOAK.soak(args)
    seconds = time.perf_counter() - t0
    launches = read_launches()
    rc = SOAK.report(out)
    check(rc == 0, f"15.1 soak: exit {rc}: {out['failures']}")
    nominal = args.minutes * 60 / args.period
    check(out["cycles"] >= nominal / 2,
          f"15.1 soak: {out['cycles']} cycles of {nominal:.0f} nominal")
    cycles = out.pop("observed")
    summary = solving_summary(cycles, dev, "15.1 soak")
    unlaunched = [i for i, c in enumerate(cycles)
                  if dev.type == "cuda" and "backend" in c["stats"]
                  and not c["launches"]["bid_dense"]]
    check(not unlaunched,
          f"15.1 soak: solving cycles {unlaunched[:10]} launched no "
          f"bid_dense")
    check(out["breaker_trips"] == 0,
          f"15.1 soak: {out['breaker_trips']} breaker trips")
    if dev.type == "cuda":
        drift = out["memory_end"] - out["memory_first_solve"]
        check(abs(drift) <= SOAK_MEMORY_SLACK,
              f"15.1 soak: memory_allocated moved {drift} B from "
              f"{out['memory_first_solve']} after the first solving cycle")
    check(launches == out["launches"],
          f"15.1 soak: launches {launches} against the cycles' "
          f"{out['launches']}")
    return dict(out, seconds=seconds, launches=launches, summary=summary,
                nominal_cycles=nominal)


def tool_sim_soak(dev, scale, backend):
    """15.2: ``python -m kube_batch_tpu_torch sim --soak`` at the soak-smoke
    mix on the card: exit 0, no detector tripped; under ``dense`` the
    CUDA allocator series were fitted."""
    report = OUT_DIR / f"phase15_sim_soak_{backend}.json"
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "kube_batch_tpu_torch", "sim",
         *scale["sim_soak"], "--backend", backend, "--device", dev.type,
         "--report-out", str(report)],
        capture_output=True, text=True, timeout=600,
    )
    seconds = time.perf_counter() - t0
    what = f"15.2 sim --soak --backend {backend}"
    check(proc.returncode == 0,
          f"{what}: exit {proc.returncode}: {proc.stderr[-2000:]}")
    out = json.loads(report.read_text())
    soak = out["soak"]
    check(not soak["tripped"], f"{what}: tripped {soak['tripped']}")
    fitted = {d["series"]: d for d in soak["detectors"]}
    if backend == "dense" and dev.type == "cuda":
        for key in ("cuda_memory_allocated_bytes",
                    "cuda_memory_reserved_bytes"):
            check(key in fitted, f"{what}: no {key} detector result")
    check(out["cycle_errors"] == 0, f"{what}: {out['cycle_errors']} errors")
    return {"seconds": seconds, "cycles": out["cycles"],
            "placements": out.get("placements"),
            "tripped": soak["tripped"],
            "detectors": {k: {f: d.get(f) for f in (
                "tripped", "windows_fit", "slope_per_kcycle", "r2",
                "growth", "baseline")} for k, d in fitted.items()}}


def tool_latency(device, backend):
    """One ``tools.latency_smoke`` run; returns its exit code and the
    recorded audit stream's bytes."""
    from kube_batch_tpu_torch.tools import latency_smoke as LS

    workdir = OUT_DIR / f"phase15_latency_{device}_{backend}"
    workdir.mkdir(exist_ok=True)
    t0 = time.perf_counter()
    try:
        rc = LS.main(["--device", device], backend=backend,
                     workdir=str(workdir))
    except SystemExit as exc:  # a sim run failed (the tool's exit 1)
        rc = exc.code
    audit = workdir / "audit-record.jsonl"
    return {"rc": rc, "seconds": time.perf_counter() - t0,
            "audit": audit.read_bytes() if audit.exists() else b""}


def tool_stages(dev, scale, smi):
    """15.4: ``tools.multichip_50k``'s stages on 8 virtual shards of the
    card: 50,000 x 5,120 staged and 10,000 x 1,001 full, each sharded
    solve equal to the single-device one (the stage raises otherwise)."""
    from kube_batch_tpu_torch.tools import multichip_50k as MC

    out = {}
    for name, shape, staged in (("headline", MC.HEADLINE, True),
                                ("medium", MC.MEDIUM, False)):
        zero_launches()
        t0 = time.perf_counter()
        r = MC.run_stage(shape, scale["devices"], dev, staged=staged)
        r.pop("assigned")
        check(r["parity_with_single_device"] and r["placed"] > 0,
              f"15.4 {name}: {r}")
        check(read_launches() == {"bid_dense": 0, "bid_sparse": 0},
              f"15.4 {name}: a bid kernel launched on the plain chain")
        out[name] = dict(r, seconds=time.perf_counter() - t0)
        log(f"phase 15.4 {name}: {r['shape'][0]}x{r['shape'][1]} on "
            f"{r['devices']} virtual shards of {r['device']}: parity 1, "
            f"placed {r['placed']}, rounds {r['rounds']}, stages "
            f"{r['stages']}; best of 2 single {r['single_s'] * 1e3:.1f} ms, "
            f"sharded {r['sharded_s'] * 1e3:.1f} ms ({smi})")
    return out


def run_phase15(dev, smi, scale=PHASE15):
    """Phase 15: the soak, the simulator's soak and the latency smoke on
    the card at once (the soak in this process, the others in their own
    processes), then the multi-device proof."""
    from concurrent.futures import ThreadPoolExecutor

    t0 = time.perf_counter()
    out = {}
    with environ(OMP_NUM_THREADS="1"), ThreadPoolExecutor(8) as pool:
        sims = {b: pool.submit(tool_sim_soak, dev, scale, b)
                for b in scale["sim_backends"]}
        lat = {(dev.type, b): pool.submit(tool_latency, dev.type, b)
               for b in scale["latency_backends"]}
        lat[("cpu", "dense")] = pool.submit(tool_latency, "cpu", "dense")
        out["soak"] = tool_soak(dev, scale, smi)
        out["sim_soak"] = {b: f.result() for b, f in sims.items()}
        latency = {k: f.result() for k, f in lat.items()}
    s = out["soak"]
    log(f"phase 15.1 soak: {s['cycles']} cycles in {s['minutes']} min "
        f"(nominal {s['nominal_cycles']:.0f}), {s['submitted']} gangs, "
        f"{s['flaps']} node flaps, solving {s['solving']} on rungs "
        f"{s['summary']['rungs']}, launches {s['launches']}, breaker trips "
        f"{s['breaker_trips']}, memory_allocated {s['memory_first_solve']} "
        f"B after the first solving cycle, {s['memory_end']} B at the end; "
        f"{s['seconds']:.1f} s ({smi})")
    for b, r in out["sim_soak"].items():
        cuda = {k: v for k, v in r["detectors"].items()
                if k.startswith("cuda_memory")}
        log(f"phase 15.2 sim --soak --backend {b}: {r['cycles']} cycles, "
            f"{len(r['detectors'])} detectors, none tripped; CUDA series "
            f"{cuda}; {r['seconds']:.1f} s ({smi})")
    for (device, b), r in latency.items():
        check(r["rc"] == 0, f"15.3 latency smoke {device} {b}: exit {r['rc']}")
    # Each placed record names the backend that solved it
    # (``torch-cuda`` / ``torch-cpu``); the streams are otherwise equal.
    card, cpu = latency[(dev.type, "dense")], latency[("cpu", "dense")]
    named = b'"backend": "torch-%s"'
    check(card["audit"].count(named % dev.type.encode()) > 0,
          "15.3: no audit record of the card run names its device")
    check(card["audit"].replace(named % dev.type.encode(), named % b"cpu")
          == cpu["audit"],
          "15.3: the dense audit stream on the card differs from the CPU's")
    out["latency"] = {f"{d}_{b}": {"rc": r["rc"], "seconds": r["seconds"],
                                   "audit_records": r["audit"].count(b"\n")}
                      for (d, b), r in latency.items()}
    log(f"phase 15.3 latency smoke: exit 0 for {sorted(out['latency'])}; "
        f"dense audit on the card = the CPU's but for the backend's name "
        f"({out['latency'][f'{dev.type}_dense']['audit_records']} records) "
        f"({smi})")
    out["stages"] = tool_stages(dev, scale, smi)
    out["launches"] = out["soak"]["launches"]
    check(dev.type != "cuda" or out["launches"]["bid_dense"] > 0,
          f"phase 15: bid_dense was not launched: {out['launches']}")
    out["seconds"] = time.perf_counter() - t0
    log(f"phase 15: {out['seconds']:.1f} s ({smi})")
    return out


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    only = args[1] if args in (["--phase", "11"], ["--phase", "12"],
                               ["--phase", "13"], ["--phase", "14"],
                               ["--phase", "15"]) else None
    check(not args or only,
          f"usage: chip_smoke.py [--phase 11|12|13|14|15], not {args}")
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
    # The native floor (phase 9's last rung) builds with g++ while nvcc
    # builds the kernels.
    native = threading.Thread(target=NATIVE.native_available)
    native.start()
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
    native.join()
    check(NATIVE.native_available(), "the native floor did not build")
    if only:
        # Phase 1, then phase 11, 12, 13, 14 or 15 alone (a shorter call
        # while that phase is worked on); prints no result line.
        if only == "11":
            report["sim"] = run_phase11(dev)
        elif only == "12":
            report["real_cluster"] = run_phase12(dev)
        elif only == "13":
            report["mesh"] = run_phase13(dev, smi)
        elif only == "14":
            report["bench"] = run_phase14(dev, smi)
        else:
            report["tools"] = run_phase15(dev, smi)
        report["seconds"] = time.perf_counter() - t0
        (OUT_DIR / "chip_smoke.json").write_text(
            json.dumps(report, indent=1))
        log(smi)
        if only == "11":
            check(not report["sim"]["failures"],
                  "; ".join(report["sim"]["failures"]))
        log(f"phases 1 and {only} passed in {report['seconds']:.1f} s")
        return 0

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
    report["scan"] = scan_kernel_step(dev, host_s.task_req.shape[1])
    for shape, t in report["scan"].items():
        log(f"phase 2: segmented_cumsum {shape}: kernel {t['ms']:.4f} ms "
            f"a call ({t['device_ms']:.4f} on the device, L2 flushed), "
            f"plain {t['plain_ms']:.4f} ms (events), equal bits")

    phases = {}
    # -- phase 3: main path, sparse -------------------------------------------
    res, launches, first_ms = run_path(packed["sparse"])
    check(launches["bid_sparse"] > 0, "phase 3: bid_sparse never launched")
    check(launches["segmented_cumsum"] == 2 * launches["commits"] > 0,
          f"phase 3: {launches['segmented_cumsum']} scan launches for "
          f"{launches['commits']} commits")
    log(f"phase 3: segmented_cumsum.launches {launches['segmented_cumsum']} "
        f"over {launches['commits']} commits")
    validated(host_s, res, T_l, N_l, "phase 3")
    host_c, _, _ = build_snapshot(*CPU_SPARSE, seed=0, k=64)
    card = K.solve_auto(pack_inputs(host_c, dev), use_kernel=True)
    t_cpu = time.perf_counter()
    cpu = K.solve_auto(pack_inputs(host_c, "cpu"), use_kernel=True)
    cpu_s = time.perf_counter() - t_cpu
    check(card.refills, "phase 3: the CPU-size bundle refilled nothing")
    same_result(card.to_numpy(), cpu.to_numpy(), "phase 3 (12k x 1.2k)")
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
    report.update(phases=phases, kernels=kern, records=records)
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

    # -- phase 7: the cycle ---------------------------------------------------
    report["cycle"] = run_cycles(dev)

    # -- phase 8: the scheduler loop ------------------------------------------
    report["scheduler"] = run_phase8(dev)
    # The main path's launches: bench_cycle's four cycles on the card,
    # bid_sparse at 50k x 5k and bid_dense at 10k x 1k.
    for rec in records:
        size = "large_50k_5k" if rec["name"] == "bid_sparse" else (
            "medium_10k_1k")
        rec["launches"] = report["scheduler"][size]["launches"][rec["name"]]
        check(rec["launches"] > 0, f"phase 8: {rec['name']} never launched")

    # -- phase 9: the ladder on the card ---------------------------------------
    report["ladder"] = run_phase9(dev)

    # -- phase 10: the process on the card ----------------------------------
    report["process"] = run_phase10(dev)

    # -- phase 11: the simulator on the card ---------------------------------
    report["sim"] = run_phase11(dev)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    check(not report["sim"]["failures"], "; ".join(report["sim"]["failures"]))

    # -- phase 12: the real-cluster process and the perf harness -------------
    report["real_cluster"] = run_phase12(dev)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(report, indent=1))

    # -- phase 13: the mesh on the card ---------------------------------------
    report["mesh"] = run_phase13(dev, smi)
    for name, n in report["mesh"]["scheduler"]["launches"].items():
        kern[name]["phase13_launches"] = n
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(report, indent=1))

    # -- phase 14: the benchmark entry point ------------------------------------
    report["bench"] = run_phase14(dev, smi)
    for rec in records:
        n = report["bench"]["launches"][rec["name"]]
        kern[rec["name"]]["phase14_launches"] = n
        rec["phase14_launches"] = n
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(report, indent=1))

    # -- phase 15: the reference's last tools -----------------------------------
    report["tools"] = run_phase15(dev, smi)
    for rec in records:
        n = report["tools"]["launches"][rec["name"]]
        kern[rec["name"]]["phase15_launches"] = n
        rec["phase15_launches"] = n
    report["seconds"] = time.perf_counter() - t0
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    log(f"all phases passed in {report['seconds']:.1f} s")
    log(smi)
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
