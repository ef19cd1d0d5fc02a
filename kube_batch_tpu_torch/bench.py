"""tpu-batch benchmark harness, on the port.

Reproduces the BASELINE.json synthetic configs (1k pods x 100 nodes,
10k x 1k, 50k x 5k gang mix) through the REAL pipeline: SchedulerCache
event ingest -> Session open (plugins) -> tensorize -> batched solve on
the card with the bid kernels (``solver/csrc/bid.cu``). The baseline is
the NATIVE (C++) reimplementation of the reference's greedy allocate
loop (``native/csrc/greedy.cpp``), measured outright at the headline
scale on the same snapshot arrays, on the same host: the fair stand-in
for the reference's compiled Go loop. The Python greedy action is also
timed on the small config as a sanity datapoint (and as extrapolation
fallback when no native toolchain exists).

Prints ONE JSON line:
  {"metric": ..., "value": <ms>, "unit": "ms", "vs_baseline": <speedup>, ...}

- value: headline batched solve latency (ms, warm, the assignment
  vector fetched to the host inside the clock; host snapshot time
  reported separately).
- vs_baseline: measured-native-greedy-ms / device-solve-ms.

Usage: ``python -m kube_batch_tpu_torch.bench [--quick] [--config
small|medium|large] [--smoke] [--shape TxN] [--shape-xl TxN] [--trace
PATH] [--profile DIR] [--device cuda|cpu]``.

A copy of the JAX package's ``bench.py`` on the port's modules, with
the same sections and keys, except:

- The device is ``--device`` (``cuda`` unless ``cpu`` is asked for;
  without CUDA the default exits non-zero). There is no backend probe
  and no silent CPU fallback: ``--require-accelerator`` is accepted and
  is the only behavior.
- ``jax_solve_cpu_ms`` / ``jax_solver_rounds`` are ``device_solve_ms``
  / ``device_solver_rounds``; they appear only under ``--device cpu``,
  where, as in the reference's CPU branch, the native masked loop is
  the headline (``solver_path`` ``native-masked-cpu`` or
  ``native-sparse-cpu``). On the card ``solver_path`` is
  ``torch-cuda``.
- ``solver_sparse["jax"]`` is ``solver_sparse["torch"]``.
- ``last_tpu_validation`` (a pointer to TPU evidence) is dropped.
- ``device_provenance`` names the torch device type, the card
  (``torch.cuda.get_device_name``) and the device count.
- ``sparse_scale`` / ``sparse_scale_xl``: ``solve_ms``, ``placed`` and
  ``backend`` (``torch-cuda``) are the port's sparse solve on the
  device with the kernels, where the reference solved with the native
  loop when it could; the native solve goes beside it as
  ``native_solve_ms``, ``native_placed``, ``native_refill_rounds`` and
  ``native_widened``. ``invalid_placements`` counts what
  ``validate_placements`` rejects in the device solve.
- ``sharded_vs_single`` and ``twolevel_quality`` run in a child process
  on 4 virtual shards of the device (``device.set_host_device_count``),
  where the reference forced a 4-device CPU mesh; ``mesh`` says so. On
  one card that measures launches and parity, not scale-out.
  ``single_ms`` is the single-device plain chain, the chain the flat
  mode is bit-equal to.
- ``--profile DIR`` writes a ``torch.profiler`` Chrome trace of one
  headline solve, where the reference used ``jax.profiler``, and adds a
  ``profile`` section: that solve's wall and device-busy ms, the
  device's idle share and its kernel launches.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import resource
import subprocess
import sys
import time

import numpy as np
import torch

from . import actions  # noqa: F401 (registers the actions)
from . import plugins  # noqa: F401 (registers the plugins)
from .api import PodPhase, TaskStatus, build_resource_list
from .cache import SchedulerCache
from .device import resolve_device
from .framework import close_session, get_action, open_session
from .solver import (
    default_mesh,
    sharded_step,
    solve_auto,
    tensorize,
)
from .utils.test_utils import (
    FakeBinder,
    FakeEvictor,
    FakeStatusUpdater,
    FakeVolumeBinder,
    add_gang_burst,
    bench_objects,
    build_cluster,
    build_node,
    build_pod,
    build_pod_group,
    build_queue,
    make_tiers,
)

# The package's root directory: child processes run from there.
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CONFIGS = {
    # name: (tasks, nodes, queues, groups)
    "small": (1_000, 100, 1, 10),
    "medium": (10_000, 1_000, 4, 100),
    "large": (50_000, 5_000, 5, 500),
}

TIERS_ARGS = (
    ["priority", "gang", "conformance"],
    ["drf", "predicates", "proportion", "nodeorder"],
)


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def bench_greedy(cfg, seed=0, runs=3):
    """Greedy allocate action wall time (full Execute) on a config.

    The sample subproblem is PINNED — fixed seed, fixed config shape —
    and the reported time is the MEDIAN of ``runs`` independent
    executions on freshly built clusters (a single shot swings ~2x on
    allocator/GC noise, and it feeds greedy_extrapolated_ms)."""
    n_tasks, n_nodes, n_queues, n_groups = CONFIGS[cfg]
    times = []
    placed = 0
    for _ in range(max(1, runs)):
        cache = build_cluster(n_tasks, n_nodes, n_queues, n_groups, seed)
        ssn = open_session(cache, make_tiers(*TIERS_ARGS))
        action, _ = get_action("allocate")
        start = time.perf_counter()
        action.execute(ssn)
        times.append(time.perf_counter() - start)
        placed = len(cache.binder.binds)
        close_session(ssn)
        cache.shutdown()
    times.sort()
    return times[len(times) // 2], placed, n_tasks * n_nodes


def bench_native_greedy(inputs, repeats=2):
    """Measured native (C++) reference-loop baseline on the SAME snapshot
    arrays the device solver consumes (csrc/greedy.cpp) — the fair
    stand-in for the reference's compiled Go loop. Returns (seconds,
    placed) or None when no toolchain is available."""
    try:
        from .native import NativeUnavailable, greedy_allocate
    except Exception:
        return None
    solver_in = inputs.unpack() if hasattr(inputs, "unpack") else inputs
    task_req = np.asarray(solver_in.task_req)
    valid = np.asarray(solver_in.task_valid)
    task_req = task_req[valid]
    task_queue = np.asarray(solver_in.task_queue)[valid]
    node_feas = np.asarray(solver_in.node_feas)
    node_idle = np.asarray(solver_in.node_idle)[node_feas]
    node_cap = np.asarray(solver_in.node_cap)[node_feas]
    qd = np.asarray(solver_in.queue_deserved)
    qa = np.asarray(solver_in.queue_allocated)
    eps = np.asarray(solver_in.eps)
    lr = float(np.asarray(solver_in.lr_weight))
    br = float(np.asarray(solver_in.br_weight))
    try:
        times = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            _, placed = greedy_allocate(
                task_req, task_queue, node_idle, node_cap, qd, qa, eps,
                lr, br,
            )
            times.append(time.perf_counter() - t0)
        return min(times), placed
    except NativeUnavailable:
        return None


def bench_native_masked(inputs, repeats=3):
    """The framework's native floor (allocate_tpu's last rung):
    greedy.cpp's feasibility-aware loop on the same factorized
    snapshot. Returns (seconds, placed) or None."""
    try:
        from .native import NativeUnavailable, solve_native
    except Exception:
        return None
    try:
        times = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            _, placed = solve_native(inputs)
            times.append(time.perf_counter() - t0)
        return min(times), placed
    except NativeUnavailable:
        return None


def headline_step(inputs, dev, use_kernel=True):
    """``(step, inputs)`` of the headline solve: the sharded step over
    the device's mesh when there is one, else ``solve_auto`` with the
    bid kernels (``use_kernel``) on the one device."""
    mesh = default_mesh(device=dev)
    if mesh is not None:
        return sharded_step(inputs, mesh)
    return functools.partial(solve_auto, use_kernel=use_kernel), inputs


def bench_tpu(cfg, seed=0, repeats=3, device=None, use_kernel=True):
    """Batched solve on a config on ``device``: the session, the
    snapshot, one warm-up solve, then the min of ``repeats`` timed
    solves, each ending with the assignment vector on the host."""
    dev = resolve_device(device)
    n_tasks, n_nodes, n_queues, n_groups = CONFIGS[cfg]
    cache = build_cluster(n_tasks, n_nodes, n_queues, n_groups, seed)

    t0 = time.perf_counter()
    ssn = open_session(cache, make_tiers(*TIERS_ARGS), device=dev)
    t_session = time.perf_counter() - t0

    t0 = time.perf_counter()
    inputs, ctx = tensorize(ssn, device=dev)
    _sync(dev)
    t_snapshot = time.perf_counter() - t0
    from .solver.snapshot import last_tensorize_stats

    sparse_stats = dict(last_tensorize_stats.get("sparse") or {})

    # One warm-up solve (the process's first use of the kernels lands
    # there), then the steady-state latency. Timing includes the
    # device->host fetch of the assignment vector (what a real cycle
    # needs back), so asynchronous launches cannot flatter the number.
    # With a mesh the padding happens ONCE outside the timed loop.
    step, dev_inputs = headline_step(inputs, dev, use_kernel)
    result = step(dev_inputs)
    result.assigned.cpu()
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        result = step(dev_inputs)
        assigned_host = result.assigned.cpu().numpy()
        times.append(time.perf_counter() - t0)
    solve_s = min(times)
    placed = int((assigned_host >= 0).sum())
    rounds = int(result.rounds)
    if result.refills is not None:
        sparse_stats["torch"] = {
            "refill_tasks": int(result.refills),
            "refill_rounds": int(result.stages),
        }
    close_session(ssn)
    return {
        "session_s": t_session,
        "snapshot_s": t_snapshot,
        "solve_s": solve_s,
        "placed": placed,
        "rounds": rounds,
        "work": n_tasks * n_nodes,
        "inputs": inputs,
        "assigned": assigned_host,
        # Candidate-selection stats of this snapshot (solver/topk.py).
        "sparse": sparse_stats,
        # NumPy-backed SolverInputs for the native baselines.
        "host_inputs": ctx.host_inputs,
        # Every task is still Pending (the solve was never applied):
        # bench_cycle reuses this cluster instead of rebuilding it.
        "cache": cache,
        "device": dev,
        "use_kernel": use_kernel,
    }


def bench_cycle(cfg, seed=0, cache=None, trace_path=None,
                measure_obs=False, device=None):
    """Full scheduling cycles through the production allocate_tpu action
    on ``device`` — the number BASELINE.md's <100 ms target is really
    about (the reference hot path is the whole runOnce, not the inner
    kernel). Scenarios:

    - cold:   first cycle on a fresh full-scale pending burst;
    - steady: the very next cycle — every placed job/node changed in
      cold, so the COW snapshot pool re-clones the world;
    - idle:   one more unchanged cycle;
    - delta:  a ~1% batch of new gangs arrives, next cycle;
    - degraded: a same-size burst with the breaker PINNED open (the
      native floor);
    - steady_warm: five warm-started ~1% bursts, then the absorb cycle;
    - micro_cycle: arrival-to-placement at ~0.1% and ~1% churn.

    Each cycle reports open/action/close phases plus every key of
    ``actions.allocate_tpu.last_stats`` (attribution flags included).
    With ``trace_path`` the span tracer records the cycles and exports
    one Chrome trace-event file. ``measure_obs`` appends the ``obs``
    and ``quality`` sections."""
    from .actions import allocate_tpu as _atpu
    from .obs import span
    from .obs.tracer import TRACER
    from .utils import deferred_gc

    dev = resolve_device(device)
    n_tasks, n_nodes, n_queues, n_groups = CONFIGS[cfg]
    if cache is None:
        cache = build_cluster(n_tasks, n_nodes, n_queues, n_groups, seed)
    else:
        # The passed cache saw a prior session open + tensorize, so the
        # COW pool and the per-pod tensorize caches are warm; a real
        # pending burst arrives with fresh pods. Re-cold BOTH: dirty
        # every job (forces re-clone) and drop the per-pod predicate
        # caches.
        from .plugins.predicates import clear_pod_caches

        for job in cache.jobs.values():
            job._ver += 1
            clear_pod_caches(t.pod for t in job.tasks.values())
    action, _ = get_action("allocate_tpu")

    cycle_counter = [0]

    def one_cycle():
        # Same GC deferral as the production Scheduler.run_once: the
        # collection runs after t_close, in what would be think-time.
        TRACER.begin_cycle(cycle_counter[0])
        cycle_counter[0] += 1
        t_start = time.perf_counter()
        with span("cycle"), deferred_gc():
            ssn = open_session(cache, make_tiers(*TIERS_ARGS), device=dev)
            t_open = time.perf_counter()
            action.execute(ssn)
            t_exec = time.perf_counter()
            close_session(ssn)
            t_close = time.perf_counter()
        out = {
            "open_ms": round((t_open - t_start) * 1e3, 1),
            "action_ms": round((t_exec - t_open) * 1e3, 1),
            "close_ms": round((t_close - t_exec) * 1e3, 1),
            "cycle_ms": round((t_close - t_start) * 1e3, 3),
            "close_gc_deferred": True,
        }
        for k, v in _atpu.last_stats.items():
            # The per-job wait record (a pair per placed job) stays out.
            if k != "job_waits":
                out[k] = round(v, 1) if isinstance(v, float) else v
        # Drain async bind side effects outside the timed region.
        out["drain_ok"] = cache.wait_for_side_effects(timeout=120.0)
        return out

    tracing = trace_path is not None
    if tracing:
        TRACER.reset()
        TRACER.enable()

    def spans_since(mark):
        return TRACER.spans_recorded - mark

    mark = TRACER.spans_recorded
    cold = one_cycle()
    cold["spans"] = spans_since(mark)
    mark = TRACER.spans_recorded
    steady = one_cycle()
    steady["spans"] = spans_since(mark)
    mark = TRACER.spans_recorded
    idle = one_cycle()
    idle["spans"] = spans_since(mark)
    mark = TRACER.spans_recorded

    # ~1% new gangs arrive, drawn from the same shape mix as build_cluster.
    rng = np.random.RandomState(seed + 1)
    new_groups = max(1, n_groups // 100)
    per_group = n_tasks // n_groups

    def add_burst(prefix, groups=None):
        add_gang_burst(cache, rng, prefix,
                       groups if groups is not None else new_groups,
                       per_group, n_queues)

    add_burst("pgd")
    delta = one_cycle()
    delta["spans"] = spans_since(mark)

    # Degraded-mode floor: one more same-size burst cycle with the
    # fault-containment breaker PINNED open — the whole cycle runs on
    # the native floor with zero device dispatch.
    from .solver import containment

    add_burst("pgx")
    mark = TRACER.spans_recorded
    containment.BREAKER.pin_open("bench-degraded")
    try:
        degraded = one_cycle()
    finally:
        containment.BREAKER.unpin()
    degraded["spans"] = spans_since(mark)

    # --- steady_warm: the warm-started 1%-churn steady state ---------
    one_cycle()  # settle the degraded round's wave; re-warms the state
    warm_rounds = []
    for r in range(5):
        add_burst(f"pgw{r}_")
        warm_rounds.append(one_cycle())
    absorb = one_cycle()
    warm_med = sorted(
        r["cycle_ms"] for r in warm_rounds
    )[len(warm_rounds) // 2]
    steady_warm = {
        "cycle_ms": round(warm_med, 3),
        "rounds_ms": [round(r["cycle_ms"], 3) for r in warm_rounds],
        "warm_outcome": warm_rounds[-1].get("warm_outcome"),
        "warm_engaged": all(
            r.get("warm_outcome") in ("solve", "noop")
            for r in warm_rounds
        ),
        "tensorize_incremental": all(
            r.get("tensorize_incremental", False) for r in warm_rounds
        ),
        "tensorize_wave_patched": warm_rounds[-1].get(
            "tensorize_wave_patched"
        ),
        "placed_per_round": [r.get("placed", 0) for r in warm_rounds],
        "sparse_engaged": warm_rounds[-1].get("sparse_engaged"),
        "absorb_cycle_ms": absorb["cycle_ms"],
        "absorb_warm_outcome": absorb.get("warm_outcome"),
        "open_ms": warm_rounds[-1].get("open_ms"),
        "action_ms": warm_rounds[-1].get("action_ms"),
        "close_ms": warm_rounds[-1].get("close_ms"),
        "tensorize_ms": warm_rounds[-1].get("tensorize_ms"),
        "solve_ms": warm_rounds[-1].get("solve_ms"),
        "apply_ms": warm_rounds[-1].get("apply_ms"),
    }

    # --- micro_cycle: arrival-to-placement latency ------------------
    def micro_round(prefix, burst_tasks):
        groups = max(1, burst_tasks // per_group)
        add_burst(prefix, groups=groups)
        t0 = time.perf_counter()
        with deferred_gc():
            ssn = open_session(cache, make_tiers(*TIERS_ARGS), device=dev)
            ssn.micro_cycle = True
            action.execute(ssn)
            close_session(ssn)
            # Stop the clock INSIDE the guard: the deferred collection
            # at guard exit belongs to think-time.
            ms = (time.perf_counter() - t0) * 1e3
        stats = dict(_atpu.last_stats)
        cache.wait_for_side_effects(timeout=120.0)
        one_cycle()  # absorb the wave before the next round
        return {
            "arrival_to_placement_ms": round(ms, 3),
            "burst_tasks": groups * per_group,
            "placed": stats.get("placed", 0),
            "warm_outcome": stats.get("warm_outcome"),
            "deferred": stats.get("micro_deferred"),
        }

    micro_cycle = {
        "burst_0p1": micro_round("pgm1_", max(1, n_tasks // 1000)),
        "burst_1p": micro_round("pgm2_", max(1, n_tasks // 100)),
    }

    out = {"cold": cold, "steady": steady, "idle": idle, "delta": delta,
           "degraded": degraded, "steady_warm": steady_warm,
           "micro_cycle": micro_cycle}
    if tracing:
        out["trace_path"] = TRACER.export(trace_path)
        out["trace_spans"] = TRACER.spans_recorded
        out["trace_spans_dropped"] = TRACER.dropped
        TRACER.disable()
    if measure_obs:
        out["obs"] = bench_obs(one_cycle, cache=cache)
        out["quality"] = bench_quality(
            cache, steady_ms=steady_warm.get("cycle_ms")
        )
    cache.shutdown()
    return out


def bench_obs(one_cycle, runs=7, cache=None):
    """Tracer + telemetry overhead at the benched shape: the pinned
    per-span cost times spans per cycle against the tracer-OFF idle
    cycle median, interleaved off/on cycle medians as corroboration,
    and the telemetry, placement-ledger and audit enabled-path costs
    (each against the same <1%-of-an-idle-cycle budget)."""
    from .obs.tracer import TRACER

    was_enabled = TRACER.enabled
    TRACER.disable()
    one_cycle()  # settle after the caller's last cycle
    off, on = [], []
    span_count = 0
    for _ in range(runs):
        TRACER.disable()
        off.append(one_cycle()["cycle_ms"])
        TRACER.enable()
        mark = TRACER.spans_recorded
        on.append(one_cycle()["cycle_ms"])
        span_count += TRACER.spans_recorded - mark
    off.sort()
    on.sort()
    off_ms = off[len(off) // 2]
    on_ms = on[len(on) // 2]
    spans_per_cycle = span_count / float(runs)

    # Deterministic per-span cost of the ENABLED recording path.
    probe_n = 20_000
    TRACER.reset()
    TRACER.enable()
    t0 = time.perf_counter()
    for _ in range(probe_n):
        with TRACER.span("obs-probe"):
            pass
    span_cost_us = (time.perf_counter() - t0) / probe_n * 1e6
    TRACER.reset()
    TRACER.enabled = was_enabled

    # Telemetry enabled-path cost on a scratch instance, 1024 cycles
    # (window rolls and the amortized probes included).
    from .obs.telemetry import Telemetry

    scratch = Telemetry(window_cycles=64, max_windows=64,
                        raw_capacity=128)
    fake_rec = {
        "e2e_ms": off_ms,
        "phases_ms": {
            "open_session": 2.0,
            "action:allocate_tpu": off_ms * 0.8,
            "close_session": 2.0,
        },
        "solver": {"placed": 0, "tasks": 0, "rounds": 1},
    }
    telem_n = 1024
    t0 = time.perf_counter()
    for _ in range(telem_n):
        scratch.observe_scheduler_cycle(fake_rec, cache=cache)
    telemetry_cost_us = (time.perf_counter() - t0) / telem_n * 1e6

    # Placement-ledger + decision-audit enabled-path cost.
    from .obs.latency import AuditLog, PlacementLedger

    scratch_ledger = PlacementLedger()
    lat_n = 5_000
    t0 = time.perf_counter()
    for i in range(lat_n):
        uid = f"obs-lat-{i}"
        job = f"obs-job-{i % 50}"
        scratch_ledger.note_arrival(uid, uid, job)
        scratch_ledger.note_placed(((uid, job),), {job: "q0"})
        scratch_ledger.note_dispatched((uid,))
        scratch_ledger.note_applied(uid)
    latency_pod_cost_us = (time.perf_counter() - t0) / lat_n * 1e6

    scratch_audit = AuditLog(capacity=1024)
    audit_n = 5_000
    t0 = time.perf_counter()
    for i in range(audit_n):
        scratch_audit.append({
            "action": "placed", "job": f"obs-job-{i % 50}",
            "queue": "q0", "count": 1, "kind": "periodic",
            "backend": "native", "warm": "solve", "degraded": False,
        })
    audit_append_cost_us = (time.perf_counter() - t0) / audit_n * 1e6

    cyc_n = 2_000
    t0 = time.perf_counter()
    for i in range(cyc_n):
        scratch_ledger.begin_cycle(i)
        scratch_ledger.telemetry_sample()
    latency_cycle_cost_us = (time.perf_counter() - t0) / cyc_n * 1e6

    overhead_ms = spans_per_cycle * span_cost_us / 1e3
    delta_ms = max(0.0, on_ms - off_ms)
    return {
        "latency_pod_cost_us": round(latency_pod_cost_us, 2),
        "audit_append_cost_us": round(audit_append_cost_us, 2),
        "latency_cycle_cost_us": round(latency_cycle_cost_us, 2),
        "latency_overhead_pct": (
            round(latency_cycle_cost_us / 1e3 / off_ms * 100.0, 3)
            if off_ms else 0.0
        ),
        "telemetry_cost_us": round(telemetry_cost_us, 2),
        "telemetry_overhead_pct": (
            round(telemetry_cost_us / 1e3 / off_ms * 100.0, 3)
            if off_ms else 0.0
        ),
        "idle_cycle_off_ms": round(off_ms, 3),
        "idle_cycle_on_ms": round(on_ms, 3),
        "spans_per_cycle": round(spans_per_cycle, 1),
        "span_cost_us": round(span_cost_us, 2),
        "tracer_overhead_ms": round(overhead_ms, 4),
        "tracer_overhead_pct": (
            round(overhead_ms / off_ms * 100.0, 3) if off_ms else 0.0
        ),
        "ab_delta_ms": round(delta_ms, 3),
        "ab_delta_pct": (
            round(delta_ms / off_ms * 100.0, 2) if off_ms else 0.0
        ),
        "runs": runs,
    }


def bench_quality(cache, steady_ms=None, repeats=5):
    """Placement-quality scorecard cost at the benched shape
    (obs/quality.py): a full ``compute_scorecard`` against the benched
    cache, median of ``repeats`` with the memo state warm, plus the
    amortized production overhead (per-card cost over the
    KBT_QUALITY_EVERY cadence, as a share of the warm steady cycle),
    and the snapshot's density/fairness numbers."""
    from .obs.quality import DEFAULT_QUALITY_EVERY, compute_scorecard

    state = {}
    card = compute_scorecard(cache, state=state)  # cold: builds memos
    times = []
    for _ in range(max(1, repeats)):
        t0 = time.perf_counter()
        card = compute_scorecard(cache, state=state)
        times.append(time.perf_counter() - t0)
    times.sort()
    card_ms = times[len(times) // 2] * 1e3
    every = DEFAULT_QUALITY_EVERY
    out = {
        "card_ms": round(card_ms, 3),
        "every": every,
        "amortized_ms": round(card_ms / every, 4),
        "nodes": card["nodes"],
        "queues": card["queues"],
        "density_dom": card["density_dom"],
        "density": card["density"],
        "fairness_jain": card["fairness"]["jain"],
        "emptiable_frac": card["frag"]["emptiable_frac"],
    }
    if steady_ms:
        out["overhead_pct_of_steady"] = round(
            100.0 * (card_ms / every) / steady_ms, 3
        )
    return out


def _sim_backend():
    """The sim sections' backend: the native floor when it builds, as
    in the reference, else ``auto`` (the device)."""
    from .native import native_available

    return "native" if native_available() else "auto"


def bench_arrival_latency(quick=False, seed=23, device=None):
    """Stage-decomposed arrival→bind placement-latency percentiles
    under the high-arrival sim mixes (obs/latency.py): seeded
    deterministic-simulator runs — ~0.1% and ~1% of the 50k headline
    as sustained arrivals, a 10k+-pods-per-virtual-second burst, and
    the congested micro steady state and storm — each reporting the
    ledger's p50/p95/p99 per stage and per (queue, cycle kind).

    Latencies are VIRTUAL seconds off the sim clock (exactly
    reproducible; the solve stage carries the real solve wall time)."""
    from .obs.latency import LEDGER
    from .sim import SimConfig, WorkloadSpec
    from .sim.harness import run_sim

    dev = resolve_device(device)
    backend = _sim_backend()

    def mix(cycles, micro_every=0, period=1.0, nodes=64, **spec_kw):
        spec = WorkloadSpec(
            nodes=nodes, node_cpu_m=16000, node_mem_mi=32768,
            duration_cycles=(2, 6), **spec_kw,
        )
        report, records = run_sim(SimConfig(
            cycles=cycles, seed=seed, workload=spec, backend=backend,
            check_invariants=False, micro_every=micro_every,
            period=period, device=dev.type,
        ))
        lat = report.latency or {}
        stages = LEDGER.stage_percentiles()
        # Carried-backlog depth off the trace records (replay-stable).
        carried = [
            (r.get("stats") or {}).get("carried", 0)
            for r in records if r.get("type") == "cycle"
        ]
        step = max(1, len(carried) // 64)
        return {
            "cycles": cycles,
            "placements": report.placements,
            "carried_depth_max": max(carried) if carried else 0,
            "carried_depth_end": carried[-1] if carried else 0,
            "carried_depth_series": carried[::step],
            "stamped": lat.get("stamped", 0),
            "applied": lat.get("applied", 0),
            "queue_p99_s": lat.get("queue_p99_s", {}),
            "total_p99_s": (stages.get("total") or {}).get("p99_s"),
            "queue_wait_p99_s": (
                (stages.get("queue_wait") or {}).get("p99_s")
            ),
            "gang_total_p99_s": (
                (stages.get("gang_total") or {}).get("p99_s")
            ),
            "stages": stages,
            "by_queue_kind": LEDGER.percentiles(),
            "audit_records": report.audit_records,
        }

    # Mix sizes are pod-arrival equivalents of the 50k-pod headline;
    # quick mode scales ~10x down with the same keys and stages.
    scale = 10 if quick else 1
    return {
        "sustained_0p1": mix(
            120 // (2 if quick else 1), micro_every=2,
            arrival_rate=20 / scale,
            arrival_profile="sustained", max_jobs_in_flight=512,
        ),
        "sustained_1p": mix(
            40 // (2 if quick else 1), arrival_rate=200 / scale,
            arrival_profile="sustained", max_jobs_in_flight=2048,
        ),
        "burst": mix(
            30 // (2 if quick else 1), arrival_rate=2,
            arrival_profile="burst",
            burst_every=50, burst_size=4200 // scale,
            max_jobs_in_flight=20000,
        ),
        # Congested micro steady state: sim ticks are the micro
        # coalescing windows (5 ms virtual), the periodic cycle every
        # 8th tick; and 400-job storms against half the cluster.
        "congested_10k": mix(
            400 // (4 if quick else 1), micro_every=8, period=0.005,
            arrival_rate=20 / scale,
            arrival_profile="sustained", max_jobs_in_flight=4096,
        ),
        "congested_burst": mix(
            300 // (3 if quick else 1), micro_every=8, period=0.005,
            nodes=32, arrival_rate=4,
            arrival_profile="burst", burst_every=100,
            burst_size=400 // scale, max_jobs_in_flight=8192,
        ),
    }


def bench_serving(quick=False, seed=29, device=None):
    """Serving-SLO section: the congested micro steady-state mix with a
    serving deployment stream on top (50 ms arrival→bind SLO replicas,
    replica churn, a 20% spot slice, two topology tiers). Reports the
    ledger's per-class attainment/violations/budget burn and the
    per-class arrival→bind p99 (virtual time)."""
    from .obs.latency import LEDGER
    from .sim import SimConfig, WorkloadSpec
    from .sim.harness import run_sim

    dev = resolve_device(device)
    backend = _sim_backend()
    scale = 10 if quick else 1
    cycles = 400 // (4 if quick else 1)
    spec = WorkloadSpec(
        nodes=64, node_cpu_m=16000, node_mem_mi=32768,
        duration_cycles=(2, 6),
        arrival_rate=20 / scale, arrival_profile="sustained",
        max_jobs_in_flight=4096,
        serving_rate=2 / scale, serving_slo_s=0.05,
        serving_churn=0.05, reserved_frac=0.8, node_tiers=2,
    )
    report, _records = run_sim(SimConfig(
        cycles=cycles, seed=seed, workload=spec, backend=backend,
        check_invariants=False, micro_every=8, period=0.005,
        device=dev.type,
    ))
    lat = report.latency or {}
    serving = lat.get("serving") or {}
    per_queue = {"serving": 0.0, "batch": 0.0}
    for queue, kinds in LEDGER.percentiles().items():
        cls = "serving" if queue == "serving" else "batch"
        for stages_of_kind in kinds.values():
            total = stages_of_kind.get("total") or {}
            p99 = total.get("p99_s")
            if p99 is not None and p99 > per_queue[cls]:
                per_queue[cls] = p99
    stages = LEDGER.stage_percentiles()
    return {
        "cycles": cycles,
        "placements": report.placements,
        "attainment_pct": serving.get("attainment_pct"),
        "violations": serving.get("violations"),
        "budget_burn": serving.get("budget_burn"),
        "classes": serving.get("classes", {}),
        "serving_bind_p99_s": per_queue["serving"],
        "batch_bind_p99_s": per_queue["batch"],
        "total_p99_s": (stages.get("total") or {}).get("p99_s"),
    }


def bench_device_cache(cfg="small", seed=0, device=None):
    """Device-resident snapshot pack across cold/steady/delta cycles:
    the per-field reuse/patch/upload stats (solver/device_cache.py)."""
    from .solver.device_cache import last_pack_stats

    dev = resolve_device(device)
    n_tasks, n_nodes, n_queues, n_groups = CONFIGS[cfg]
    cache = build_cluster(n_tasks, n_nodes, n_queues, n_groups, seed)
    tiers = make_tiers(*TIERS_ARGS)
    out = {"config": cfg}

    def pack_summary(t_ms):
        keys = ("uploads", "patches", "reuses", "rows_patched",
                "bytes_shipped", "bytes_total")
        s = {k: last_pack_stats.get(k, 0) for k in keys}
        s["tensorize_ms"] = round(t_ms, 1)
        return s

    def one(label, ssn):
        t0 = time.perf_counter()
        inputs, _ctx = tensorize(ssn, device=dev)
        _sync(dev)
        out[label] = pack_summary((time.perf_counter() - t0) * 1e3)
        return inputs

    ssn = open_session(cache, tiers, device=dev)
    one("cold", ssn)      # every field uploads (cold cache)
    one("steady", ssn)    # nothing changed: zero uploads, zero bytes
    # Small churn: allocate ONE whole gang through the session (a full
    # gang is JobReady, so its binds reach the cache mirror), packed
    # onto a couple of nodes so the next pack patches node rows.
    job = min(
        (j for j in ssn.jobs.values()
         if j.task_status_index.get(TaskStatus.PENDING)),
        key=lambda j: (len(j.task_status_index[TaskStatus.PENDING]),
                       j.uid),
    )
    gang = sorted(
        job.task_status_index[TaskStatus.PENDING].values(),
        key=lambda t: t.uid,
    )
    nodes = sorted(ssn.nodes)[: max(8, n_nodes // 10)]
    ssn.allocate_batch([
        (t, nodes[i % len(nodes)]) for i, t in enumerate(gang)
    ])
    cache.wait_for_side_effects()
    cache.wait_for_bookkeeping()
    close_session(ssn)
    ssn = open_session(cache, tiers, device=dev)
    one("delta", ssn)     # dirty node rows patch; untouched fields reuse
    close_session(ssn)
    cache.shutdown()
    return out


def _select_scale_ab(mask, task_req, node_idle, eps, k, seed=0,
                     device=None):
    """Selection device-vs-host A/B at a scale point. Four timed runs:

    - ``select_ms_host``: host NumPy full pass (cold);
    - ``select_ms_device``: device-resident full pass, cold (engine
      allocation + every key row built on the device + top-K);
    - ``select_ms_host_warm`` / ``select_ms_device_warm``: the same ~1%
      node churn through both paths with their cross-cycle caches warm;
    - ``select_device_parity``: 1 iff the device slabs were bit-equal
      to the host slabs on BOTH the cold and the churned-warm run.

    ``select_ms`` is the steady-state cost of the engaged path (the
    churned-warm device pass when the device path engaged, else the
    host cold pass; ``select_path`` records which). Returns ``(keys,
    host_cold_cs)`` — the host CandidateSet feeds the solve."""
    from .solver import select_device
    from .solver.topk import select_candidates

    dev = resolve_device(device)
    N = node_idle.shape[0]
    zeros = np.zeros_like(node_idle)
    zc = np.zeros(N, np.int32)
    ids = np.arange(N, dtype=np.int64)
    vers = np.zeros(N, np.int64)

    class _Holder:  # anchor for the cross-cycle selection caches
        pass

    # Separate holders per path: the host leg's _SelectionCache rows
    # are GBs at XL shapes and the device path never reads them.
    holder_host = _Holder()
    holder_dev = _Holder()

    def run(idle, vers_, state, holder):
        t0 = time.perf_counter()
        cs_ = select_candidates(
            mask, {}, task_req, task_req, idle, idle, zeros, zc, zc,
            eps, 1.0, 1.0, k, cache_holder=holder,
            node_fp=(ids, vers_, None), device_state=state,
        )
        _sync(dev)
        return round((time.perf_counter() - t0) * 1e3, 1), cs_

    host_ms, cs = run(node_idle, vers, None, holder_host)
    out = {"select_ms": host_ms, "select_ms_host": host_ms,
           "select_path": "host"}
    if cs is None or not select_device.device_select_enabled():
        if cs is not None:
            out["select_path"] = "host:env-disabled"
        return out, cs

    state = select_device.standalone_state(
        node_idle, node_idle, zc, zc, mask.node_ok, mask.group_rows, dev
    )
    dev_ms, dev_cs = run(node_idle, vers, state, holder_dev)
    if dev_cs is None or dev_cs.stats.get("select_path") != "device":
        out["select_path"] = (
            dev_cs.stats.get("select_path", "host")
            if dev_cs is not None else "host"
        )
        return out, cs
    parity = int(
        (dev_cs.cand_idx == cs.cand_idx).all()
        and (dev_cs.cand_info == cs.cand_info).all()
        and (dev_cs.task_cand == cs.task_cand).all()
    )

    # Churned warm cycle: ~1% of nodes lose idle capacity; the engine
    # (resident key matrix + row digests) is carried across.
    rng = np.random.RandomState(seed + 1)
    churn = rng.choice(N, size=max(N // 100, 1), replace=False)
    idle2 = node_idle.copy()
    idle2[churn] = np.maximum(idle2[churn] - 500.0, 0.0)
    vers2 = vers.copy()
    vers2[churn] += 1
    state2 = select_device.standalone_state(
        idle2, idle2, zc, zc, mask.node_ok, mask.group_rows, dev
    )
    state2._engine = state.engine()
    # Device warm before host warm: the warm device pass is the
    # headline, and the order must not tax it.
    dev_warm_ms, dev_warm_cs = run(idle2, vers2, state2, holder_dev)
    host_warm_ms, host_warm_cs = run(idle2, vers2, None, holder_host)
    if (
        host_warm_cs is not None and dev_warm_cs is not None
        and dev_warm_cs.stats.get("select_path") == "device"
    ):
        parity = int(parity and (
            (dev_warm_cs.cand_idx == host_warm_cs.cand_idx).all()
            and (dev_warm_cs.cand_info == host_warm_cs.cand_info).all()
        ))
        out.update(
            select_ms_host_warm=host_warm_ms,
            select_ms_device_warm=dev_warm_ms,
            sel_cache_hits_warm=int(
                dev_warm_cs.stats.get("sel_cache_hits", 0)
            ),
        )
    steady_ms = out.get("select_ms_device_warm", dev_ms)
    out.update(
        select_ms=steady_ms,
        select_ms_device=dev_ms,
        select_path="device",
        select_device_parity=parity,
        select_device_speedup=round(host_ms / max(steady_ms, 1e-6), 1),
    )
    return out, cs


def bench_sparse_scale(shape="200000x20000", seed=0, wide_mix=False,
                       device=None, use_kernel=True):
    """Sparse-only scale point: shapes where the DENSE solver is
    arithmetically infeasible (one [T, N] f32 score matrix is 16 GB at
    200k x 20k, 400 GB at 1M x 100k), so completion is the result.

    Solver inputs are built synthetically at the array level (the 50k
    headline config covers the full-pipeline path). Candidate selection
    runs the REAL top-K pass, A/B'd device-vs-host with a bit-equality
    check and a churned-warm leg (:func:`_select_scale_ab`); the solve
    runs the port's sparse solver on ``device`` (with the bid kernels
    unless ``use_kernel`` is False), and the native loop's solve of the
    same inputs goes beside it.

    ``wide_mix`` draws requests from a 64x32-value grid instead of the
    5x5 one (the 1M x 100k point): class diversity sizes the slab
    union."""
    from .solver.kernels import SolverInputs
    from .solver.masks import CombinedMask
    from .solver.snapshot import pack_inputs
    from .solver.topk import topk_config
    from .solver.validate import validate_placements

    dev = resolve_device(device)
    T, N = (int(x) for x in shape.lower().split("x"))
    rng = np.random.RandomState(seed)
    R = 2
    if wide_mix:
        # ~66% cluster utilisation at 1M x 100k (32-cpu/128Gi nodes):
        # the scale point measures solver throughput, not overload.
        cpu_mix = np.linspace(250, 4000, 64).round()
        mem_mix = np.linspace(256, 16384, 32).round()
    else:
        cpu_mix = [250, 500, 1000, 2000, 4000]
        mem_mix = [256, 512, 1024, 4096, 8192]
    task_req = np.c_[
        rng.choice(cpu_mix, T),
        rng.choice(mem_mix, T),
    ].astype(np.float32)
    node_idle = np.tile(
        np.asarray([32000.0, 128 * 1024.0], np.float32), (N, 1)
    )
    eps = np.asarray([10.0, 10.0], np.float32)
    mask = CombinedMask(
        node_ok=np.ones(N, bool),
        task_group=np.zeros(T, np.int32),
        group_rows=np.ones((1, N), bool),
        pair_idx=np.zeros((0,), np.int32),
        pair_rows=np.zeros((0, N), bool),
    )
    tk = topk_config(T, N)
    k = tk.k if tk.enabled else 64
    sel, cs = _select_scale_ab(mask, task_req, node_idle, eps, k, seed,
                               dev)
    out = {
        "shape": f"{T}x{N}",
        "k": int(k),
        **sel,
        "dense_score_bytes": int(T) * int(N) * 4,
        "dense_documented_infeasible": True,
    }
    if cs is None:
        out["error"] = "selection aborted (class budget)"
        return out
    out.update({
        key: cs.stats[key]
        for key in ("classes", "slab_bytes", "truncated_classes")
    })
    inputs = SolverInputs(
        task_req=task_req, task_fit=task_req,
        task_rank=np.arange(T, dtype=np.int32),
        task_job=(np.arange(T) // 10).astype(np.int32),
        task_queue=np.zeros(T, np.int32),
        task_valid=np.ones(T, bool),
        task_group=np.zeros(T, np.int32),
        node_feas=np.ones(N, bool),
        group_feas=np.ones((1, N), bool),
        pair_idx=np.zeros((0,), np.int32),
        pair_feas=np.zeros((0, N), bool),
        score_idx=np.zeros((0,), np.int32),
        score_rows=np.zeros((0, N), np.float32),
        node_idle=node_idle,
        node_releasing=np.zeros_like(node_idle),
        node_cap=node_idle,
        node_task_count=np.zeros(N, np.int32),
        node_max_tasks=np.zeros(N, np.int32),
        queue_deserved=np.full((1, R), np.inf, np.float32),
        queue_allocated=np.zeros((1, R), np.float32),
        eps=eps,
        lr_weight=np.float32(1.0),
        br_weight=np.float32(1.0),
        task_cand=cs.task_cand, cand_idx=cs.cand_idx,
        cand_static=cs.cand_static, cand_info=cs.cand_info,
    )
    packed = pack_inputs(inputs, dev)
    result = solve_auto(packed, use_kernel=use_kernel)  # first use
    result.assigned.cpu()
    t0 = time.perf_counter()
    result = solve_auto(packed, use_kernel=use_kernel)
    assigned = result.assigned.cpu().numpy()
    solve_ms = round((time.perf_counter() - t0) * 1e3, 1)
    bad, _reasons = validate_placements(inputs, assigned, T, N)
    out.update(
        solve_ms=solve_ms,
        backend=f"torch-{dev.type}",
        placed=int((assigned >= 0).sum()),
        rounds=int(result.rounds),
        refill_rounds=int(result.stages),
        refill_tasks=int(result.refills),
        invalid_placements=int(len(bad)),
    )
    del packed, result
    try:
        from .native import last_solve_stats, solve_native

        t0 = time.perf_counter()
        _assigned, placed = solve_native(inputs)
    except Exception as exc:  # NativeUnavailable / no toolchain
        out["native_error"] = f"{type(exc).__name__}: {exc}"
        return out
    out.update(
        native_solve_ms=round((time.perf_counter() - t0) * 1e3, 1),
        native_placed=int(placed),
        native_refill_rounds=int(last_solve_stats.get("refill_rounds", 0)),
        native_widened=int(last_solve_stats.get("widened", 0)),
    )
    return out


_SHARDED_AB_SCRIPT = r"""
import json, time
import numpy as np
import torch
from kube_batch_tpu_torch.device import resolve_device, set_host_device_count
set_host_device_count(%(devices)d)
from kube_batch_tpu_torch.solver import (
    default_mesh, make_inputs, pad_tasks, solve_sparse, solve_sparse_spmd,
)
from kube_batch_tpu_torch.solver.masks import CombinedMask
from kube_batch_tpu_torch.solver.topk import select_candidates

dev = resolve_device(%(device)r)
T, N, K = %(tasks)d, %(nodes)d, 64
rng = np.random.RandomState(7)
R = 2
task_req = np.c_[
    rng.choice(np.linspace(250, 4000, 64).round(), T),
    rng.choice(np.linspace(256, 16384, 32).round(), T),
].astype(np.float32)
node_idle = np.tile(
    np.asarray([32000.0, 128 * 1024.0], np.float32), (N, 1)
)
eps = np.asarray([10.0, 10.0], np.float32)
mask = CombinedMask(
    node_ok=np.ones(N, bool), task_group=np.zeros(T, np.int32),
    group_rows=np.ones((1, N), bool),
    pair_idx=np.zeros((0,), np.int32),
    pair_rows=np.zeros((0, N), bool),
)
cs = select_candidates(
    mask, {}, task_req, task_req, node_idle, node_idle,
    np.zeros_like(node_idle), np.zeros(N, np.int32),
    np.zeros(N, np.int32), eps, 1.0, 1.0, K,
)
put = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=dev)
inputs = make_inputs(
    task_req=put(task_req), task_fit=put(task_req),
    task_rank=torch.arange(T, dtype=torch.int32, device=dev),
    task_job=put((np.arange(T) // 10).astype(np.int32)),
    task_queue=torch.zeros(T, dtype=torch.int32, device=dev),
    node_idle=put(node_idle),
    node_releasing=torch.zeros((N, R), dtype=torch.float32, device=dev),
    node_cap=put(node_idle),
    node_task_count=torch.zeros(N, dtype=torch.int32, device=dev),
    node_max_tasks=torch.zeros(N, dtype=torch.int32, device=dev),
    queue_deserved=torch.full((1, R), float("inf"), device=dev),
    queue_allocated=torch.zeros((1, R), dtype=torch.float32, device=dev),
    eps=put(eps),
    lr_weight=torch.tensor(1.0, device=dev),
    br_weight=torch.tensor(1.0, device=dev),
    task_cand=put(cs.task_cand), cand_idx=put(cs.cand_idx),
    cand_static=put(cs.cand_static), cand_info=put(cs.cand_info),
)
mesh = default_mesh(device=dev)
out = {"devices": mesh.size, "mesh": "virtual shards of one card"
       if dev.type == "cuda" else "virtual shards of the CPU",
       "shape": f"{T}x{N}", "k": K}

def timed(fn, *a, **kw):
    fn(*a, **kw).assigned.cpu()  # first use
    t0 = time.perf_counter()
    r = fn(*a, **kw)
    assigned = r.assigned.cpu().numpy()
    return (time.perf_counter() - t0) * 1e3, assigned

single_ms, single_a = timed(solve_sparse, inputs, use_kernel=False)
padded = pad_tasks(inputs, mesh.size)
flat_ms, flat_a = timed(solve_sparse_spmd, padded, mesh)
from kube_batch_tpu_torch.solver import spmd as _spmd
out.update({k: int(v) for k, v in _spmd.last_commit_stats.items()})
two_ms, two_a = timed(solve_sparse_spmd, padded, mesh, two_level=True)
out.update(
    single_ms=round(single_ms, 1),
    flat_ms=round(flat_ms, 1),
    two_level_ms=round(two_ms, 1),
    parity=int((single_a == flat_a[:T]).all()),
    placed=int((single_a >= 0).sum()),
    two_level_placed=int((two_a[:T] >= 0).sum()),
)
print("SHARDED_AB " + json.dumps(out))
"""


def _child(script, marker, env_extra=None, timeout=1800):
    """Run ``script`` in a fresh interpreter from the package's root and
    return the JSON after ``marker`` in its output, else an error
    record with the end of its standard error."""
    env = dict(os.environ)
    env.update(env_extra or {})
    proc = subprocess.run(
        [sys.executable, "-c", script], capture_output=True, text=True,
        timeout=timeout, env=env, cwd=ROOT,
    )
    for line in proc.stdout.splitlines():
        if line.startswith(marker + " "):
            return json.loads(line[len(marker) + 1:])
    return {
        "error": f"subprocess exit {proc.returncode}",
        "stderr": proc.stderr[-2000:],
    }


def bench_sharded_vs_single(tasks=65536, nodes=4096, devices=4,
                            device=None):
    """Sharded-vs-single sparse A/B on ``devices`` virtual shards of
    the device, in a SUBPROCESS (the shard count is process-wide). On
    one device the shards run one after another, so the target here is
    ``parity == 1`` (flat bit-equal to the single-device plain chain)
    and completion of both sharded modes, not a speedup; the timings
    track the collective overhead."""
    dev = resolve_device(device)
    script = _SHARDED_AB_SCRIPT % {
        "devices": devices, "tasks": tasks, "nodes": nodes,
        "device": dev.type,
    }
    return _child(script, "SHARDED_AB")


_TWOLEVEL_QUALITY_SCRIPT = r"""
import json
from kube_batch_tpu_torch.device import set_host_device_count
set_host_device_count(%(devices)d)
from kube_batch_tpu_torch import metrics
from kube_batch_tpu_torch.sim import SimConfig, WorkloadSpec
from kube_batch_tpu_torch.sim.harness import run_sim

report, _ = run_sim(SimConfig(
    cycles=%(cycles)d, seed=%(seed)d, backend="sparse", topk=8,
    workload=WorkloadSpec(
        nodes=%(nodes)d, arrival_rate=4.0, max_jobs_in_flight=128,
    ),
    check_invariants=True, device=%(device)r,
))
out = {
    "placements": int(report.placements),
    "violations": len(report.violations),
    "cycle_errors": int(report.cycle_errors),
    "bind_failures": int(report.bind_failures),
    "jobs_completed": int(report.jobs_completed),
    "sharded_solves": int(metrics.solver_sparse_sharded.total()),
}
print("TWOLEVEL_Q " + json.dumps(out))
"""


def bench_twolevel_quality(devices=4, cycles=60, seed=9, nodes=32,
                           device=None):
    """Sim-based placement-quality study of the two-level (per-rack)
    sharded solve against the bit-equal flat mode: the same seeded
    workload through the FULL production cycle on ``devices`` virtual
    shards with ``KBT_SPARSE_SHARD_MODE`` pinning each mode, in
    subprocesses like :func:`bench_sharded_vs_single`. The numbers that
    matter are the placement delta and a clean invariant checker in
    BOTH modes."""
    dev = resolve_device(device)

    def one(mode):
        script = _TWOLEVEL_QUALITY_SCRIPT % {
            "devices": devices, "cycles": cycles, "seed": seed,
            "nodes": nodes, "device": dev.type,
        }
        return _child(script, "TWOLEVEL_Q",
                      {"KBT_SPARSE_SHARD_MODE": mode})

    flat = one("flat")
    two = one("two-level")
    out = {
        "devices": devices, "cycles": cycles, "nodes": nodes,
        "mesh": ("virtual shards of one card" if dev.type == "cuda"
                 else "virtual shards of the CPU"),
        "flat": flat, "two_level": two,
    }
    if flat.get("placements"):
        out["placements_delta_pct"] = round(
            100.0 * (two.get("placements", 0) - flat["placements"])
            / flat["placements"], 2,
        )
    return out


def bench_integrity(cfg="large", seed=0, device=None):
    """Cluster-truth anti-entropy + post-solve validation cost at the
    headline shape:

    - ``sweep_cold_ms`` / ``sweep_steady_ms`` / ``sweep_churned_ms``:
      first sweep, consistent-mirror median, one benign write first;
    - ``sweep_divergent_ms``: sweep over a 1%-divergent mirror (watch
      detached, pods bound and deleted behind the cache's back), with
      detected/repaired counts;
    - ``validation_ms`` (full placement vector),
      ``validation_steady_ms`` (1% of tasks placed) and
      ``validation_reject_ms`` (a tampered vector).

    The snapshot is taken on ``device``; validation runs on the host
    bundle, as ``allocate_tpu`` validates."""
    from .cluster import InProcessCluster
    from .solver.validate import validate_placements

    dev = resolve_device(device)
    n_tasks, n_nodes, n_queues, n_groups = CONFIGS[cfg]
    rng = np.random.RandomState(seed)
    cluster = InProcessCluster(simulate_kubelet=False)
    cache = SchedulerCache(
        cluster=cluster,
        binder=FakeBinder(),
        evictor=FakeEvictor(),
        status_updater=FakeStatusUpdater(),
        volume_binder=FakeVolumeBinder(),
    )
    # The headline's cluster, drawn from ``rng``; the divergence picks
    # below go on drawing from it, as in the reference.
    pods = []
    for kind, obj in bench_objects(n_tasks, n_nodes, n_queues, n_groups,
                                   rng=rng):
        cluster.create(kind, obj)
        if kind == "Pod":
            pods.append(obj)
    cache.start_ingest()

    ae = cache.antientropy
    t0 = time.perf_counter()
    ae.sweep()
    sweep_cold_ms = (time.perf_counter() - t0) * 1e3
    steady = []
    for _ in range(3):
        t0 = time.perf_counter()
        rep = ae.sweep()
        steady.append((time.perf_counter() - t0) * 1e3)
    assert not rep["detected"], rep
    sweep_steady_ms = sorted(steady)[1]
    # Churned variant: one benign cluster write moves the event rv, so
    # the sweep pays the full truth listing + O(pods) witness loop.
    churned = []
    for _ in range(3):
        cluster.update("Pod", pods[0])
        t0 = time.perf_counter()
        rep = ae.sweep()
        churned.append((time.perf_counter() - t0) * 1e3)
    assert not rep["detected"], rep
    sweep_churned_ms = sorted(churned)[1]

    # 1% divergence injected behind the cache's back.
    cluster.remove_watch(cache._on_watch_event)
    n_div = max(2, n_tasks // 100)
    picks = rng.choice(len(pods), size=n_div, replace=False)
    for k, idx in enumerate(picks):
        pod = pods[int(idx)]
        if k % 8 == 0:
            cluster.delete_pod(pod)
        else:
            try:
                cluster.bind_pod(pod, f"n{int(idx) % n_nodes}")
            except ValueError:
                pass  # already bound by an earlier pick
    cluster.add_watch(cache._on_watch_event)
    t0 = time.perf_counter()
    div = ae.sweep(budget=None)
    sweep_divergent_ms = (time.perf_counter() - t0) * 1e3
    detected = sum(div["detected"].values())
    repaired = sum(div["repaired"].values())

    # Post-solve validation cost on a FULL placement vector.
    ssn = open_session(cache, make_tiers(*TIERS_ARGS), device=dev)
    try:
        inputs, ctx = tensorize(ssn, device=False)
        host = ctx.host_inputs
        T, N = len(ctx.tasks), len(ctx.nodes)
        a = (np.arange(T) % N).astype(np.int64)
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            validate_placements(host, a, T, N)
            times.append((time.perf_counter() - t0) * 1e3)
        validation_ms = sorted(times)[2]
        a_steady = np.full(T, -1, dtype=np.int64)
        n_churn = max(1, T // 100)
        a_steady[:n_churn] = a[:n_churn]
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            validate_placements(host, a_steady, T, N)
            times.append((time.perf_counter() - t0) * 1e3)
        validation_steady_ms = sorted(times)[2]
        tampered = a.copy()
        tampered[: min(16, T)] = 2**30
        t0 = time.perf_counter()
        _bad_t, reasons_t = validate_placements(host, tampered, T, N)
        validation_reject_ms = (time.perf_counter() - t0) * 1e3
        assert reasons_t.get("bad-index", 0) >= 1, reasons_t
    finally:
        close_session(ssn)
    cache.shutdown()

    return {
        "config": cfg,
        "pods": n_tasks,
        "nodes": n_nodes,
        "sweep_cold_ms": round(sweep_cold_ms, 2),
        "sweep_steady_ms": round(sweep_steady_ms, 2),
        "sweep_churned_ms": round(sweep_churned_ms, 2),
        "sweep_divergent_ms": round(sweep_divergent_ms, 2),
        "divergence_injected": int(n_div),
        "divergence_detected": int(detected),
        "divergence_repaired": int(repaired),
        "validation_ms": round(validation_ms, 3),
        "validation_steady_ms": round(validation_steady_ms, 3),
        "validation_reject_ms": round(validation_reject_ms, 3),
    }


def bench_sim(cycles=80, seed=11, device=None):
    """Deterministic-simulator throughput: a seeded fault run through
    the full production cycle (virtual clock), once with the invariant
    checker and once without."""
    from .sim import SimConfig, WorkloadSpec
    from .sim.harness import run_sim

    dev = resolve_device(device)
    backend = _sim_backend()

    def one(check):
        report, _ = run_sim(SimConfig(
            cycles=cycles,
            seed=seed,
            faults="bind:0.05,node-flap:0.02",
            workload=WorkloadSpec(nodes=12),
            backend=backend,
            check_invariants=check,
            device=dev.type,
        ))
        return report

    checked = one(True)
    unchecked = one(False)
    return {
        "cycles": cycles,
        "backend": backend,
        "placements": checked.placements,
        "violations": len(checked.violations),
        "cycles_per_sec": round(checked.cycles_per_sec, 1),
        "cycles_per_sec_nocheck": round(unchecked.cycles_per_sec, 1),
        "invariant_check_ms_per_cycle": round(
            checked.check_seconds / cycles * 1e3, 3
        ),
        "invariant_check_overhead_pct": round(
            100.0 * checked.check_seconds
            / max(checked.wall_seconds, 1e-9), 1
        ),
    }


def bench_recovery(cfg="large", seed=0, device=None):
    """Cold-takeover failover recovery at the benched shape: a
    predecessor died mid-bind-drain leaving a populated cluster and a
    bind-intent journal with every classification class represented;
    measure what a successor pays before it can schedule — fresh-cache
    ingest, the journal scan + reconcile (gang re-drives and one
    eviction), and its first post-recovery cycle on ``device``."""
    from .api.objects import DEFAULT_SCHEDULER_NAME
    from .cache.recovery import reconcile_journal
    from .cluster import InProcessCluster

    dev = resolve_device(device)
    n_tasks, n_nodes, n_queues, n_groups = CONFIGS[cfg]
    rng = np.random.RandomState(seed)
    cluster = InProcessCluster(simulate_kubelet=True)
    for q in range(n_queues):
        cluster.create_queue(build_queue(f"q{q}", weight=q + 1))
    for j in range(n_nodes):
        cluster.create_node(build_node(
            f"n{j}", build_resource_list(cpu="32", memory="128Gi", pods=110)
        ))
    per_group = n_tasks // n_groups
    # ~1/16 of the gangs were mid-dispatch at the crash; the rest are
    # the predecessor's steady-state placements (bound + Running).
    inflight_from = n_groups - max(2, n_groups // 16)
    cpus = rng.choice([250, 500, 1000, 2000], size=n_tasks)
    mems = rng.choice([256, 512, 1024, 4096], size=n_tasks)
    t = 0
    journaled = 0
    intents = []
    for g in range(n_groups):
        inflight = g >= inflight_from
        # The last in-flight gang targets a node that died with the
        # leader: recovery must evict its partial placement.
        node_gone = inflight and g == n_groups - 1
        cluster.create_pod_group(build_pod_group(
            f"pg{g}", namespace="bench",
            min_member=per_group if inflight else int(
                rng.randint(1, per_group + 1)
            ),
            queue=f"q{g % n_queues}",
        ))
        tasks = []
        for i in range(per_group):
            target = f"n{t % n_nodes}"
            pod = build_pod(
                "bench", f"pg{g}-p{i}", "",
                PodPhase.PENDING,
                build_resource_list(
                    cpu=f"{int(cpus[t])}m", memory=f"{int(mems[t])}Mi"
                ),
                group_name=f"pg{g}",
            )
            cluster.create_pod(pod)
            if not inflight:
                cluster.bind_pod(pod, target)
            else:
                lot = i % 5
                if node_gone:
                    # Half bound (to evict), half lost to a dead node.
                    if lot < 2:
                        cluster.bind_pod(pod, target)
                    else:
                        target = "nGONE"
                elif lot < 2:
                    cluster.bind_pod(pod, target)  # applied, marked
                elif lot == 2:
                    cluster.bind_pod(pod, target)  # applied, mark lost
                # lot > 2: lost — recovery re-drives to complete
                tasks.append({
                    "uid": pod.uid, "pod": f"bench/{pod.name}",
                    "node": target, "job": f"bench/pg{g}",
                    "mark": "applied" if lot < 2 else None,
                })
            t += 1
        if tasks:
            journaled += len(tasks)
            seq = cluster.append_bind_intent({
                "leader": "bench-dead-leader",
                "tasks": [
                    {k: v for k, v in task.items() if k != "mark"}
                    for task in tasks
                ],
                "gangs": {f"bench/pg{g}": per_group},
            })
            intents.append(seq)
            for task in tasks:
                if task["mark"]:
                    cluster.mark_bind_intent(seq, task["uid"], task["mark"])

    # The successor: fresh cache, full ingest, reconcile, first cycle.
    t0 = time.perf_counter()
    cache = SchedulerCache(
        cluster=cluster, scheduler_name=DEFAULT_SCHEDULER_NAME,
        default_queue="q0",
    )
    cache.start_ingest()
    ingest_s = time.perf_counter() - t0

    t1 = time.perf_counter()
    report = reconcile_journal(cluster, "bench-successor")
    reconcile_s = time.perf_counter() - t1
    cache.wait_for_side_effects()

    t2 = time.perf_counter()
    ssn = open_session(cache, make_tiers(*TIERS_ARGS), device=dev)
    action, _ = get_action("allocate_tpu")
    action.execute(ssn)
    close_session(ssn)
    first_cycle_s = time.perf_counter() - t2
    cache.wait_for_side_effects()
    cache.shutdown()
    return {
        "shape": f"{n_tasks}x{n_nodes}",
        "intents": len(intents),
        "tasks_journaled": journaled,
        "ingest_ms": round(ingest_s * 1e3, 1),
        "reconcile_ms": round(reconcile_s * 1e3, 1),
        "first_cycle_ms": round(first_cycle_s * 1e3, 1),
        "takeover_ms": round(
            (ingest_s + reconcile_s + first_cycle_s) * 1e3, 1
        ),
        "outcomes": dict(sorted(report.outcomes.items())),
        "gangs_repaired": len(report.gangs_repaired),
        "gangs_evicted": len(report.gangs_evicted),
        "recovery_errors": report.errors,
    }


def run_smoke(device=None):
    """``--smoke``: small shapes through the full production cycle with
    the sparse solver FORCED (KBT_SOLVER_TOPK defaults to 8 here so the
    small config engages it), asserting via the cycle stats that the
    candidate path ran — exit 4 when it fell back to dense, 5 when the
    steady cycle was not incremental."""
    os.environ.setdefault("KBT_SOLVER_TOPK", "8")
    cycle = bench_cycle("small", device=device)
    cold = cycle.get("cold", {})
    engaged = bool(cold.get("sparse_engaged"))
    print(json.dumps({
        "metric": "bench-smoke-sparse",
        "sparse_engaged": engaged,
        "sparse_k": cold.get("sparse_k"),
        "sparse_refill_rounds": cold.get("sparse_refill_rounds"),
        "cold_solve_ms": cold.get("solve_ms"),
        "backend": cold.get("backend"),
        "cycle": cycle,
    }), flush=True)
    if not engaged:
        print("bench-smoke: sparse path did NOT engage", file=sys.stderr)
        sys.exit(4)
    # The cycle after a placement wave must ride the incremental
    # tensorize, and the warm-started rounds must engage.
    steady = cycle.get("steady", {})
    warm = cycle.get("steady_warm", {})
    steady_ok = (
        steady.get("tensorize_incremental", True)
        and "tensorize_full_reason" not in steady
        and warm.get("warm_engaged", False)
        and warm.get("tensorize_incremental", False)
    )
    if not steady_ok:
        print(
            "bench-smoke: steady cycle did NOT stay incremental "
            f"(steady={ {k: v for k, v in steady.items() if 'tensorize' in k} }, "
            f"warm_engaged={warm.get('warm_engaged')})",
            file=sys.stderr,
        )
        sys.exit(5)


def _guarded(fn, *args, **kwargs):
    """Run one section; an exception becomes ``{"error": ...}`` so a
    long run keeps its headline."""
    try:
        return fn(*args, **kwargs)
    except Exception as exc:  # pragma: no cover - defensive
        return {"error": f"{type(exc).__name__}: {exc}"}


def profile_headline(tpu, out_dir):
    """One headline solve under ``torch.profiler``: its Chrome trace in
    ``out_dir``, the wall ms (synchronized), the device's busy ms (the
    sum of kernel times; one stream, so they do not overlap), its idle
    share and the kernel launches."""
    from torch.profiler import ProfilerActivity, profile

    dev = tpu["device"]
    step, dev_inputs = headline_step(tpu["inputs"], dev, tpu["use_kernel"])
    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(out_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        step(dev_inputs).assigned.cpu()
        _sync(dev)
        wall = (time.perf_counter() - t0) * 1e3
    path = os.path.join(out_dir, "headline_solve.trace.json")
    prof.export_chrome_trace(path)
    out = {"trace_path": path, "wall_ms": round(wall, 3)}
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
    if not kernels:
        out["device_busy_ms"] = "not measured"
        return out
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    out.update(
        device_busy_ms=round(busy, 3),
        idle_share=round(1.0 - busy / wall, 4),
        kernel_launches=sum(e.count for e in kernels),
        bid_kernels_ms=round(sum(e.self_device_time_total for e in kernels
                                 if "bid_" in e.key) / 1e3, 3),
    )
    return out


def device_provenance(dev):
    """Which device produced the numbers."""
    cuda = dev.type == "cuda"
    return {
        "platform": dev.type,
        "device_kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
        "num_devices": torch.cuda.device_count() if cuda else 1,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
    }


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m kube_batch_tpu_torch.bench")
    ap.add_argument("--quick", action="store_true",
                    help="small+medium only (CI-sized)")
    ap.add_argument("--config", choices=list(CONFIGS), default=None)
    ap.add_argument("--device", default=None,
                    help="torch device to run on: cuda (default; exits "
                         "non-zero without CUDA) or cpu")
    ap.add_argument("--profile", metavar="DIR", default=None,
                    help="write a torch.profiler Chrome trace of one "
                         "headline solve into DIR")
    ap.add_argument(
        "--require-accelerator", action="store_true",
        help="accepted for the reference's command lines; the device "
             "is always required (there is no CPU fallback)",
    )
    ap.add_argument(
        "--smoke", action="store_true",
        help="sparse-path smoke: small config through the full cycle "
             "with KBT_SOLVER_TOPK forced; exit 4 unless the sparse "
             "solver engaged, 5 unless the steady cycle stayed "
             "incremental",
    )
    ap.add_argument(
        "--shape", default=None, metavar="TxN",
        help="extra sparse-only scale point (e.g. 200000x20000); the "
             "default large run includes 200000x20000 automatically",
    )
    ap.add_argument(
        "--shape-xl", default=None, metavar="TxN",
        help="headline sparse scale point with the wide class mix "
             "(default large run: 1000000x100000 — dense [T,N] is 400 "
             "GB there, completion itself is the result)",
    )
    ap.add_argument(
        "--trace", metavar="PATH", default=None,
        help="export one Chrome trace-event JSON of the benched "
             "production cycles to PATH (open in Perfetto)",
    )
    args = ap.parse_args(argv)
    try:
        dev = resolve_device(args.device)
    except (RuntimeError, ValueError) as exc:
        print(f"bench: --device {args.device or 'cuda'}: {exc}",
              file=sys.stderr)
        sys.exit(3)
    if args.smoke:
        run_smoke(device=dev)
        return

    headline_cfg = args.config or ("medium" if args.quick else "large")

    # Python greedy action on the small config (sanity datapoint only).
    greedy_s, greedy_placed, greedy_work = bench_greedy("small")

    tpu = bench_tpu(headline_cfg, device=dev)
    solve_ms = tpu["solve_s"] * 1e3

    extra = {}
    if args.profile:
        extra["profile"] = profile_headline(tpu, args.profile)

    # vs_baseline: measured NATIVE reference loop at the headline scale
    # on the same host; the O(T*N)-extrapolated Python greedy when no
    # native toolchain exists.
    native = bench_native_greedy(tpu["host_inputs"])
    headline_work = CONFIGS[headline_cfg][0] * CONFIGS[headline_cfg][1]
    greedy_extrapolated_s = greedy_s * headline_work / greedy_work
    if native is not None:
        native_s, native_placed = native
        speedup = native_s / tpu["solve_s"]
        extra.update({
            "native_greedy_ms": round(native_s * 1e3, 1),
            "native_greedy_placed": native_placed,
            "baseline_kind": "native-greedy-measured",
        })
    else:
        speedup = greedy_extrapolated_s / tpu["solve_s"]
        extra["baseline_kind"] = "python-greedy-extrapolated"

    headline_ms = solve_ms
    headline_placed = tpu["placed"]
    headline_solve_s = tpu["solve_s"]
    headline_rounds = tpu["rounds"]
    extra["solver_path"] = f"torch-{dev.type}"
    if dev.type == "cpu":
        # Asked for the CPU: the framework's production CPU path is the
        # native loop (allocate_tpu's floor, candidate-sparsified when
        # the snapshot carries slabs), so THAT is the headline, as in
        # the reference's CPU branch; the batched solve on the CPU is
        # kept as a side metric.
        masked = bench_native_masked(tpu["host_inputs"])
        if masked is not None:
            masked_s, masked_placed = masked
            headline_ms = masked_s * 1e3
            headline_placed = masked_placed
            headline_solve_s = masked_s
            headline_rounds = 1  # sequential loop, not the solver rounds
            extra["device_solve_ms"] = round(solve_ms, 1)
            extra["device_solver_rounds"] = tpu["rounds"]
            extra["solver_path"] = "native-masked-cpu"
            from .native.greedy import last_solve_stats as _nstats

            if _nstats.get("sparse"):
                extra["solver_path"] = "native-sparse-cpu"
                tpu["sparse"]["native"] = {
                    key: _nstats.get(key, 0)
                    for key in ("refill_rounds", "fallback_scans",
                                "widened", "classes", "k")
                }
                # Dense A/B on the SAME snapshot (slabs stripped).
                dense_in = tpu["host_inputs"]._replace(
                    task_cand=None, cand_idx=None,
                    cand_static=None, cand_info=None,
                )
                dense_masked = bench_native_masked(dense_in)
                if dense_masked is not None:
                    extra["native_masked_dense_ms"] = round(
                        dense_masked[0] * 1e3, 1
                    )
                    extra["sparse_vs_dense_native"] = round(
                        dense_masked[0] / masked_s, 2
                    )
            if native is not None:
                speedup = native[0] / masked_s
            else:
                speedup = greedy_extrapolated_s / masked_s

    # Full production cycles at the headline scale, reusing the
    # headline's cluster. Guarded: a crash here must not lose the
    # already-measured headline.
    cycle = _guarded(
        bench_cycle, headline_cfg, cache=tpu["cache"],
        trace_path=args.trace, measure_obs=True, device=dev,
    )
    obs = cycle.pop("obs", None) if isinstance(cycle, dict) else None
    quality = (
        cycle.pop("quality", None) if isinstance(cycle, dict) else None
    )
    device_cache = _guarded(bench_device_cache, "small", device=dev)

    # Sparse-only scale points: shapes the dense path cannot touch.
    sparse_scale = None
    scale_shape = args.shape or (
        "200000x20000" if headline_cfg == "large" else None
    )
    if scale_shape:
        sparse_scale = _guarded(bench_sparse_scale, scale_shape, device=dev)
    sparse_scale_xl = None
    xl_shape = args.shape_xl or (
        "1000000x100000" if headline_cfg == "large" else None
    )
    if xl_shape:
        sparse_scale_xl = _guarded(bench_sparse_scale, xl_shape,
                                   wide_mix=True, device=dev)
    sharded_vs_single = None
    twolevel_quality = None
    if headline_cfg == "large":
        sharded_vs_single = _guarded(bench_sharded_vs_single, device=dev)
        twolevel_quality = _guarded(bench_twolevel_quality, device=dev)

    sim = _guarded(bench_sim, device=dev)
    recovery = _guarded(bench_recovery, headline_cfg, device=dev)
    arrival_latency = _guarded(
        bench_arrival_latency, quick=headline_cfg != "large", device=dev
    )
    serving = _guarded(
        bench_serving, quick=headline_cfg != "large", device=dev
    )
    integrity = _guarded(bench_integrity, headline_cfg, device=dev)
    steady_ms = None
    if isinstance(cycle, dict):
        sw = cycle.get("steady_warm") or cycle.get("steady") or {}
        steady_ms = sw.get("cycle_ms")
    if steady_ms and "error" not in integrity:
        integrity["validation_pct_of_steady"] = round(
            100.0 * integrity["validation_steady_ms"] / steady_ms, 3
        )
        every = int(os.environ.get("KBT_ANTIENTROPY_EVERY", "256"))
        integrity["sweep_every"] = every
        # Amortized off the CHURNED sweep (churn moves the cluster rv
        # every cycle, so the idle-cluster shortcut never fires there).
        integrity["sweep_amortized_pct_of_steady"] = round(
            100.0 * (integrity["sweep_churned_ms"] / every)
            / steady_ms, 3,
        )
        integrity["integrity_pct_of_steady"] = round(
            integrity["sweep_amortized_pct_of_steady"]
            + integrity["validation_pct_of_steady"], 3,
        )

    print(json.dumps({
        "metric": f"gang-cycle-solve-latency-{headline_cfg}"
                  f"-{CONFIGS[headline_cfg][0]}x{CONFIGS[headline_cfg][1]}",
        "value": round(headline_ms, 3),
        "unit": "ms",
        "vs_baseline": round(speedup, 1),
        "pods_placed": headline_placed,
        "pods_placed_per_sec": round(headline_placed / headline_solve_s, 1),
        "solver_rounds": headline_rounds,
        "host_snapshot_ms": round(tpu["snapshot_s"] * 1e3, 1),
        "session_open_ms": round(tpu["session_s"] * 1e3, 1),
        "greedy_small_ms": round(greedy_s * 1e3, 1),
        "greedy_extrapolated_ms": round(greedy_extrapolated_s * 1e3, 1),
        "device": dev.type,
        "device_provenance": device_provenance(dev),
        # The process's peak resident host memory over the whole run.
        "host_max_rss_mib": round(
            resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024, 1),
        "cycle": cycle,
        "obs": obs,
        "quality": quality,
        "device_cache": device_cache,
        "solver_sparse": tpu["sparse"],
        "sim": sim,
        "recovery": recovery,
        "arrival_latency": arrival_latency,
        "serving": serving,
        "integrity": integrity,
        **({"sparse_scale": sparse_scale} if sparse_scale else {}),
        **({"sparse_scale_xl": sparse_scale_xl} if sparse_scale_xl
           else {}),
        **({"sharded_vs_single": sharded_vs_single} if sharded_vs_single
           else {}),
        **({"twolevel_quality": twolevel_quality} if twolevel_quality
           else {}),
        **extra,
    }), flush=True)


if __name__ == "__main__":
    main()
