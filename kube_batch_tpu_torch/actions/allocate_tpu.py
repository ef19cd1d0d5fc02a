"""allocate_tpu: the batched drop-in for the allocate action.

A port of the reference's ``actions/allocate_tpu.py``: a new action,
selectable in the scheduler policy exactly where ``allocate`` goes, that
snapshots the session into dense tensors, runs the batched assignment
solve once, and drives the stock ``ssn.allocate`` path with the result —
so gang gating, event handlers (DRF/proportion share updates),
dispatch-on-JobReady, and bind side effects all behave exactly as in the
greedy path (framework/session.go:237-289).

What differs from the reference:

- **The device belongs to the cycle**: the session's, which a
  ``Scheduler`` opens with its own device, else the action's
  (``AllocateTpuAction(device=)``). The registry shares one action
  instance across schedulers, so a scheduler never writes its device
  into it. Either is resolved by ``device.resolve_device``: ``cuda``
  unless ``"cpu"`` is asked for, a raise when there is no CUDA. The
  scheduler cache's device
  snapshot cache is created on it, and the bid library is built the
  first time the action meets a CUDA device, outside any solve budget.
- **Native routing.** The reference routes to the native floor whenever
  JAX finds only a CPU. Here a cycle solves on the action's device; only
  ``KBT_SOLVER=native`` (the operator's pin), an open breaker and a
  ladder descent take it to the native floor. ``KBT_SOLVER=jax`` has no
  counterpart.
- **The asynchronous launch.** The port's solve reads one flag from the
  device per round, so it would block a caller until it ends. The whole
  device solve therefore runs on the single-slot device worker, on the
  CUDA stream that was current when ``tensorize`` packed the bundle;
  ``launch`` returns at once and ``fetch(timeout)`` is the one block
  point, with the reference's memoisation and abandonment. The backend
  label is ``torch-cuda`` or ``torch-cpu``.
- **Kernels on every bundle.** ``use_kernel`` (default True) runs the
  head rounds through ``bid_dense`` and ``bid_sparse`` on full and warm
  subset bundles alike: the kernels hash ``task_ids`` (the global rank),
  so the reference's bar on its Pallas pass for subset bundles does not
  apply. ``use_kernel=False`` runs the plain six-commit chain.
- **An abandoned solve** may still be issuing rounds that read the
  resident buffers, so a ``SolveTimeout`` drops the device snapshot
  cache; the next pack is a full upload labelled ``solve-abandoned``.

Semantics vs the greedy `allocate` action:
- identical predicate + resource-fit + epsilon rules (in-kernel);
- identical scorer formulas (LeastRequested/Balanced recomputed against
  the evolving idle state, static affinity scores precomputed);
- queue fair-share budgets enforced per solver round instead of per task;
- assignments are applied host-side in global priority order, so session
  bookkeeping matches what the greedy loop would produce for the same
  assignment set.

Pipelining onto Releasing resources (allocate.go:175-181) is handled in a
host-side epilogue for tasks the kernel left unassigned.
"""

from __future__ import annotations

import logging
import os
import time
from contextlib import nullcontext

import numpy as np
import torch

from .. import metrics
from ..api import Resource
from ..device import resolve_device
from ..framework import Action, register_action
from ..obs import RECORDER, span
from ..obs.tracer import TRACER
from ..solver import solve_sharded, tensorize
from ..solver.device_cache import drop_resident
from ..utils.lockdebug import wrap_lock
from ..utils.scheduler_helper import prioritize_nodes, select_best_node

logger = logging.getLogger(__name__)

# Phase timings of the most recent execute(), read by the bench harness
# and chip_smoke.py. The same phases feed /metrics via
# metrics.update_solver_phase — the cycle target is for the WHOLE
# cycle, not the kernel, so the budget split must be observable.
# Single-threaded by construction: one scheduler loop mutates it, bench
# reads it between cycles.
last_stats: dict = {}


def _record_phase(phase: str, ms: float) -> None:
    last_stats[phase + "_ms"] = ms
    metrics.update_solver_phase(phase, ms / 1e3)


def _use_native_solver() -> bool:
    """The operator's pin to the native floor (``KBT_SOLVER=native``).
    Nothing else routes a cycle there before the solve: the cycle solves
    on the action's device, whatever it is (see the module docstring)."""
    return os.environ.get("KBT_SOLVER", "").lower() == "native"


class _AbandonableWorker:
    """One persistent single-slot executor that can be ABANDONED when
    its occupant blows a deadline: the slot is wedged inside a foreign
    blocking call (greedy.cpp via ctypes, or a device solve's host read)
    that cannot be cancelled, so :meth:`abandon` detaches the pool (no
    wait — the thread dies whenever the call returns, its result
    unread) and the next submit lazily builds a fresh slot instead of
    queueing behind the hang forever. A persistent worker, not a
    thread per call: the block point is on the steady-cycle hot path
    with a ~1% overhead budget."""

    def __init__(self, name: str):
        self._name = name
        self._pool = None
        # Per-instance identity: the native-solve and device-sync
        # workers are distinct locks and must not alias in the
        # KBT_LOCK_DEBUG order harness.
        self._lock = wrap_lock(f"action.worker.{name}")

    def submit(self, fn):
        with self._lock:
            if self._pool is None:
                from concurrent.futures import ThreadPoolExecutor

                self._pool = ThreadPoolExecutor(
                    max_workers=1, thread_name_prefix=self._name
                )
            return self._pool.submit(fn)

    def abandon(self):
        with self._lock:
            pool, self._pool = self._pool, None
        if pool is not None:
            pool.shutdown(wait=False)


# Single worker for the native in-flight solve: the ctypes call into
# greedy.cpp releases the GIL, so the scheduler thread's host work
# genuinely overlaps the C++ rounds. One scheduler loop → one slot.
_NATIVE_WORKER = _AbandonableWorker("kbt-native-solve")

# The device solve (its rounds and the device→host read of the result),
# same single-slot contract: one scheduler loop, one solve in flight.
_DEVICE_SYNC_WORKER = _AbandonableWorker("kbt-device-sync")


class AsyncSolveHandle:
    """One in-flight batched solve with a SINGLE block point.

    - device solves: the whole solve (rounds, then the one device→host
      read of the assignment vector) runs on the device worker, on the
      CUDA stream current at launch, so :meth:`launch` returns at once
      and stream order keeps the solve behind the pack it reads;
    - native backend: greedy.cpp runs on a worker thread (ctypes
      releases the GIL for the foreign call), same fetch contract.

    The session registers the handle at launch
    (``Session.register_inflight_solve``) so ``Statement``
    commit/discard and session close DRAIN it before touching the world
    the solve snapshotted — commit/discard semantics are unchanged: no
    transaction boundary can run concurrently with an outstanding
    solve. ``fetch`` memoizes BOTH outcomes: the result, and — fault
    containment — the failure, so a second fetch of a failed handle
    re-raises a typed :class:`~..solver.containment.SolveFailed`
    instead of hitting a consumed future.

    ``fetch(timeout=...)`` is the solve deadline: on expiry the handle
    is ABANDONED — the future is detached with its worker slot, a late
    arrival is discarded, and :class:`SolveTimeout` is raised (and
    memoized) so the caller's degradation ladder re-solves on a lower
    rung.
    """

    __slots__ = (
        "backend", "rounds", "refills", "stages", "reconcile_rounds",
        "native_stats", "_future", "_worker", "_assigned", "_error",
    )

    def __init__(self, backend: str):
        self.backend = backend
        self.rounds = 0
        # Sparse-solve forensics, populated by fetch(): the device path
        # reports SolverResult.refills/stages (None on a dense solve) and
        # reconcile_rounds (sharded sparse only), the native path
        # snapshots native.greedy.last_solve_stats.
        self.refills = None
        self.stages = None
        self.reconcile_rounds = None
        self.native_stats = None
        self._future = None
        self._worker = None
        self._assigned = None
        self._error = None

    @classmethod
    def launch(cls, inputs, use_native: bool, max_rounds: int,
               fault_hook=None, use_kernel: bool = True,
               device=None) -> "AsyncSolveHandle":
        # Worker-thread span adopted under the launching span: the
        # exported trace shows the solve as a concurrent track nested
        # under this cycle.
        parent = TRACER.capture()
        if use_native:
            handle = cls("native")
            from ..native import native_available, solve_native

            # greedy.cpp is built at its first use, here, outside the
            # fetch's deadline; a failed build raises in the worker.
            native_available()

            def traced_solve():
                with TRACER.adopt(parent), span("native_solve"):
                    return solve_native(inputs)

            handle._worker = _NATIVE_WORKER
            handle._future = _NATIVE_WORKER.submit(traced_solve)
            return handle
        dev = resolve_device(device)
        handle = cls(f"torch-{dev.type}")
        # The stream tensorize packed the bundle on: the worker issues
        # every round on it, so stream order covers pack → solve.
        stream = torch.cuda.current_stream(dev) if dev.type == "cuda" else None

        # The session's mesh: the device repeated over the process's
        # virtual shards, or every visible card (None: one device).
        from ..solver import default_mesh

        mesh = default_mesh(device=dev)

        def device_solve():
            from ..solver import solve_sharded

            with TRACER.adopt(parent), span("device_solve"):
                with (torch.cuda.stream(stream) if stream is not None
                      else nullcontext()):
                    result = solve_sharded(
                        inputs, mesh, max_rounds=max_rounds,
                        use_kernel=use_kernel,
                    )
                    # Sim chaos seam (containment.device_fault_hook): a
                    # raise/hang here lands exactly where a real device
                    # fault would, at the device→host read.
                    if fault_hook is not None:
                        fault_hook("solve")
                    return result, result.assigned.cpu().numpy()

        handle._worker = _DEVICE_SYNC_WORKER
        handle._future = _DEVICE_SYNC_WORKER.submit(device_solve)
        return handle

    def done(self) -> bool:
        """Non-blocking completion poll."""
        if self._assigned is not None or self._error is not None:
            return True
        return self._future is not None and self._future.done()

    def _wait(self, timeout):
        """The future's value, or SolveTimeout after ``timeout`` seconds
        with the worker slot abandoned (its late result is never read)."""
        from concurrent.futures import TimeoutError as FutTimeout

        from ..solver.containment import SolveTimeout

        try:
            return self._future.result(timeout=timeout)
        except FutTimeout as exc:
            self._worker.abandon()
            raise SolveTimeout(
                f"{self.backend} solve exceeded its {timeout:.3f}s "
                f"budget; abandoned (late result will be discarded)"
            ) from exc

    def _fetch_native(self, timeout):
        assigned, _ = self._wait(timeout)
        self._assigned = np.asarray(assigned)
        self.rounds = 1
        from ..native.greedy import last_solve_stats

        self.native_stats = dict(last_solve_stats)

    def _fetch_device(self, timeout):
        result, assigned = self._wait(timeout)
        self._assigned = assigned
        self.rounds = int(result.rounds)
        if result.refills is not None:
            self.refills = int(result.refills)
        if result.stages is not None:
            self.stages = int(result.stages)
        rr = getattr(result, "reconcile_rounds", None)
        if rr is not None:
            self.reconcile_rounds = int(rr)

    def fetch(self, timeout=None) -> np.ndarray:
        """The block point: the assignment vector as a host array.
        Memoized both ways — a second fetch of a completed handle is
        free, a second fetch of a FAILED handle re-raises the memoized
        failure as ``SolveFailed`` (never a consumed-future error)."""
        from ..solver.containment import SolveFailed

        if self._assigned is not None:
            return self._assigned
        if self._error is not None:
            raise SolveFailed(
                f"{self.backend} solve already failed: {self._error!r}"
            ) from self._error
        try:
            if self.backend == "native":
                self._fetch_native(timeout)
            else:
                self._fetch_device(timeout)
        except BaseException as exc:
            self._error = exc
            # Detach: the failed future is dead to us; anything
            # arriving late is discarded with this ref.
            self._future = None
            if not isinstance(exc, Exception):
                # KeyboardInterrupt/SystemExit must terminate, not be
                # rewrapped into the degradation ladder's Exception
                # handling (a Ctrl-C at the block point would otherwise
                # be absorbed as a "device failure" and the loop would
                # keep running).
                raise
            if isinstance(exc, SolveFailed):
                raise
            raise SolveFailed(
                f"{self.backend} solve failed: {exc}"
            ) from exc
        return self._assigned

    def failed(self) -> bool:
        return self._error is not None

    def drain(self) -> None:
        """Guard-path fetch: block until the solve is out of flight,
        swallowing errors (the caller is tearing down or about to
        mutate state; a failed solve must not mask that path). Deadline
        -bounded like the action's own fetch — a hung solve must not
        wedge a transaction boundary or session close either."""
        from ..solver import containment

        try:
            self.fetch(timeout=containment.solve_budget())
        except Exception:  # pragma: no cover - defensive
            logger.exception("in-flight solve drain failed")


def _restamp_deferred(ssn, outcome: str) -> None:
    """A deferred micro cycle placed NOTHING: re-stamp the arrival
    batch's pending pods as ``requeued`` in the placement-latency
    ledger, so the wait they accrue until the periodic cycle picks them
    up is attributed to the defer (requeue counter + restarted clock)
    instead of silently absorbed into ``queue_wait``."""
    from ..api import TaskStatus
    from ..obs import latency as latency_mod

    if not latency_mod.LEDGER.enabled:
        return
    try:
        pending_key = TaskStatus.PENDING
        for uid in ssn.dirty_jobs:
            job = ssn.jobs.get(uid)
            if job is None:
                continue
            for t in (
                job.task_status_index.get(pending_key) or {}
            ).values():
                latency_mod.LEDGER.note_requeued(
                    t.uid, f"micro-defer:{outcome}", job=uid
                )
    except Exception:  # pragma: no cover - metrics must never kill
        logger.exception("micro-defer requeue restamp failed")


def _bundle_device(inputs) -> torch.device:
    """Where a bundle lives: a ``PackedInputs``' stacks or a
    ``SolverInputs``' tensors."""
    task = getattr(inputs, "task_f32", None)
    return (inputs.task_req if task is None else task).device


class AllocateTpuAction(Action):
    # Eligible for the scheduler's event-driven micro cycles
    # (Scheduler.run_micro): in micro mode the action places only
    # through the warm-start plan and defers otherwise.
    micro_capable = True

    def __init__(self, max_rounds: int = 256, device=None,
                 use_kernel: bool = True):
        self.max_rounds = max_rounds
        # None: ``cuda`` (resolved at each device cycle, so importing
        # the action on a machine without CUDA never raises). A session
        # opened by a Scheduler carries that scheduler's device, which
        # wins: the registry shares this instance across schedulers.
        self.device = device
        self.use_kernel = use_kernel

    def name(self) -> str:
        return "allocate_tpu"

    def _cycle_device(self, ssn):
        """The device this cycle solves on: the session's (its
        scheduler's), else the action's own."""
        device = getattr(ssn, "device", None)
        return self.device if device is None else device

    def _resolve_device(self, device) -> torch.device:
        """The cycle's device (raises without CUDA unless ``"cpu"`` was
        asked for). The first time it is a CUDA device and the kernels
        are on, the bid library is built here, outside any solve budget:
        a cold ``nvcc`` inside the first fetch would blow the deadline
        and open the breaker."""
        dev = resolve_device(device)
        if dev.type == "cuda" and self.use_kernel:
            from ..solver._build import load_library

            load_library()
        return dev

    # -- fault-containment ladder -------------------------------------------

    def _launch_rung(self, rung: str, inputs, ctx) -> AsyncSolveHandle:
        """One rung's dispatch. ``native`` consumes the host-side
        :class:`SolverInputs` that every tensorize (device or not)
        leaves on the context — the floor must never touch a device
        that just failed, not even to read the fallback bundle. Device
        rungs solve where ``tensorize`` packed the bundle (the cycle's
        device), and run the kernels on subset bundles too: they hash
        the global rank (``task_ids``), not the row position."""
        from ..solver import containment

        if rung == "native":
            return AsyncSolveHandle.launch(
                ctx.host_inputs, True, self.max_rounds
            )
        return AsyncSolveHandle.launch(
            inputs, False, self.max_rounds,
            fault_hook=containment.device_fault_hook(),
            use_kernel=self.use_kernel,
            device=_bundle_device(inputs),
        )

    def _solve_ladder(self, ssn, rungs, inputs, ctx, handle, budget,
                      ladder):
        """Fetch with degradation: any failure in a device rung re-solves
        the SAME cycle on the next rung down (sparse → dense → native);
        a deadline expiry jumps straight to the native floor (the device
        is wedged — a dense re-dispatch would just burn another budget)
        and quarantines the backend via the breaker. Returns
        ``(assigned, final_handle)``; raises ``SolveFailed`` only when
        the native floor itself fails (the guarded loop absorbs it).

        ``ladder`` accumulates one record per attempt — the flight
        record / verdict / bench attribution of which rungs ran."""
        from ..solver import containment as _containment
        from ..solver.containment import (
            BREAKER,
            SolveFailed,
            SolveTimeout,
            note_fallback,
            strip_candidates,
        )
        from ..solver.validate import validate_placements

        idx = 0
        cur_inputs = inputs
        while True:
            rung = rungs[idx]
            try:
                if handle is None:
                    handle = self._launch_rung(rung, cur_inputs, ctx)
                    ssn.register_inflight_solve(handle)
                assigned = handle.fetch(timeout=budget)
            except Exception as exc:
                ssn.register_inflight_solve(None)
                handle = None
                timed_out = isinstance(exc, SolveTimeout)
                reason = "timeout" if timed_out else "exception"
                exc_name = type(exc.__cause__ or exc).__name__
                ladder.append({
                    "rung": rung, "outcome": reason, "exc": exc_name,
                })
                if rung == "native":
                    # The floor failed: nothing below it — surface the
                    # typed failure to the guarded cycle loop.
                    if isinstance(exc, SolveFailed):
                        raise
                    raise SolveFailed(
                        f"native floor solve failed: {exc}"
                    ) from exc
                BREAKER.record_device_failure(
                    reason, exc=exc_name, open_now=timed_out
                )
                if timed_out:
                    # The abandoned solve may still be issuing rounds
                    # that read the resident buffers; the next pack
                    # must not patch them in place under it.
                    drop_resident(ssn.cache, "solve-abandoned")
                nxt = "native" if timed_out else rungs[idx + 1]
                idx = rungs.index(nxt)
                metrics.register_solver_fallback(rung, nxt, reason)
                note_fallback(rung, nxt, reason, exc=exc_name)
                logger.error(
                    "solve rung %r failed (%s: %s); re-solving this "
                    "cycle on %r", rung, reason, exc_name, nxt,
                )
                if nxt == "dense":
                    cur_inputs = strip_candidates(cur_inputs)
                continue
            # --- post-solve placement validation ----------------------
            # The last gate before the result can reach bind dispatch:
            # recheck every proposed placement against the feasibility
            # mask + a capacity recount, O(placements) host-side. A
            # device rung is additionally exposed to the sim's
            # solver-corrupt tamper seam here — exactly where a silent
            # device miscompute would land.
            if rung != "native":
                assigned = _containment.apply_result_tamper(assigned)
            bad, vreasons = validate_placements(
                ctx.host_inputs, assigned, len(ctx.tasks), len(ctx.nodes)
            )
            if bad.size:
                for reason in sorted(vreasons):
                    metrics.register_solver_output_rejected(
                        reason, vreasons[reason]
                    )
                if rung != "native":
                    # Corrupted device output: same containment as a
                    # rung exception — feed the breaker's failure
                    # streak and re-solve this cycle ONE rung down.
                    ssn.register_inflight_solve(None)
                    handle = None
                    ladder.append({
                        "rung": rung, "outcome": "rejected",
                        "rejected": int(bad.size),
                        "reasons": dict(sorted(vreasons.items())),
                    })
                    BREAKER.record_device_failure(
                        "rejected", exc="ValidationRejected"
                    )
                    nxt = rungs[idx + 1]
                    idx = rungs.index(nxt)
                    metrics.register_solver_fallback(
                        rung, nxt, "rejected"
                    )
                    note_fallback(
                        rung, nxt, "rejected", exc="ValidationRejected"
                    )
                    logger.error(
                        "solve rung %r output failed post-solve "
                        "validation (%s; %d placement(s)); re-solving "
                        "this cycle on %r", rung, vreasons,
                        int(bad.size), nxt,
                    )
                    if nxt == "dense":
                        cur_inputs = strip_candidates(cur_inputs)
                    continue
                # Native floor: nothing below it — DROP the offending
                # placements (they never reach bind dispatch) and keep
                # the rest of the cycle's work.
                assigned = np.array(assigned, copy=True)
                assigned[bad] = -1
                ladder.append({
                    "rung": rung, "outcome": "rejected-dropped",
                    "rejected": int(bad.size),
                    "reasons": dict(sorted(vreasons.items())),
                })
                logger.error(
                    "native-floor output failed post-solve validation "
                    "(%s); dropped %d placement(s) before dispatch",
                    vreasons, int(bad.size),
                )
            if rung != "native" and not ladder:
                # Only a CLEAN device cycle resets the failure streak.
                # A cycle rescued by a lower device rung (sparse failed,
                # dense solved) still had a device-path failure — if
                # dense kept resetting the streak, a persistently broken
                # sparse program would burn a failed dispatch every
                # cycle forever without ever reaching the breaker
                # threshold.
                BREAKER.record_device_success()
            ladder.append({"rung": rung, "outcome": "ok"})
            return assigned, handle

    @staticmethod
    def _releasing_candidates(ssn, ctx):
        """Nodes that actually hold Releasing capacity (the only ones
        the pipeline epilogue can use). In the common no-eviction cycle
        this is empty and the O(leftovers x nodes) epilogue pass is
        skipped. Candidates are narrowed with one numpy pass over the
        snapshot's releasing matrix (releasing only accumulates task
        resreqs, whose dims are always in the layout, so a non-empty
        releasing always has a nonzero row) — the per-node Python walk
        cost ~10 ms at 5k nodes on every cycle, releasing or not.
        Assignment-independent, so it runs in the solve's overlap
        window."""
        if not ctx.has_releasing:
            return []
        rel_rows = np.asarray(
            ctx.host_inputs.node_releasing[: len(ctx.nodes)]
        )
        return [
            (j, ssn.nodes[ctx.nodes[j].name])
            for j in np.nonzero(rel_rows.any(axis=1))[0].tolist()
            if not ssn.nodes[ctx.nodes[j].name].releasing.is_empty()
        ]

    def execute(self, ssn) -> None:
        from ..solver import containment

        # Clear BEFORE tensorize: if it raises, readers (bench cycle
        # block, metrics) must see an empty dict, not the previous
        # cycle's timings attributed to the failed cycle.
        last_stats.clear()
        # Backend decision BEFORE tensorize: the native floor consumes
        # the host NumPy arrays directly (device=False), skipping the
        # device pack. Only the operator's pin routes there up front; a
        # device cycle resolves the action's device here, and raises
        # when that is CUDA and no CUDA device exists.
        use_native = _use_native_solver()
        dev = None
        if not use_native:
            dev = self._resolve_device(self._cycle_device(ssn))
        # Circuit-breaker gate (solver/containment.py), also before
        # tensorize: an OPEN breaker pins the cycle to the native floor
        # without touching the quarantined device at all — no device
        # pack, no dispatch, no per-cycle failure latency. allow_device
        # ticks the cooldown and, at expiry, runs the bounded canary
        # probe (success re-promotes this very cycle).
        breaker_pinned = False
        # The canary probe solves on the action's device.
        if not use_native and not containment.BREAKER.allow_device(dev):
            use_native = True
            breaker_pinned = True
            last_stats["breaker_pinned"] = True

        # --- warm-start plan (solver/warm.py) -------------------------
        # Decide how much of the previous cycle's solve survives BEFORE
        # tensorize: a ``noop`` outcome skips the task side, selection,
        # solve, and apply outright (the previous verdicts are this
        # cycle's verdicts, bit-for-bit); ``solve`` means the problem is
        # exactly the new work against residual capacities; any other
        # outcome is a labeled full-solve fallback.
        from ..solver import warm as warm_mod

        micro = bool(getattr(ssn, "micro_cycle", False))
        warm_outcome, warm_live = warm_mod.plan_warm(ssn)
        last_stats["warm_outcome"] = warm_outcome
        if micro and warm_outcome not in ("noop", "solve", "subset"):
            # Micro cycles place ONLY through the warm path: a plan
            # fallback means a full solve, which belongs to the
            # periodic cycle (the fairness/preempt authority). Place
            # nothing and defer.
            last_stats["micro_deferred"] = warm_outcome
            metrics.register_warm_start(warm_outcome)
            metrics.register_micro_cycle("deferred")
            warm_mod.note_deferred(ssn)
            _restamp_deferred(ssn, warm_outcome)
            return
        if warm_outcome == "noop":
            t0 = time.perf_counter()
            with span("tensorize"):
                tensorize(ssn, warm_noop=True)
            _record_phase("tensorize", (time.perf_counter() - t0) * 1e3)
            from ..solver.snapshot import last_tensorize_stats

            ts = dict(last_tensorize_stats)
            drift = ts.get("incremental") is False or (
                ts.get("dirty_nodes", 0) != ts.get("wave_patched", 0)
            )
            for k, v in ts.items():
                last_stats[f"tensorize_{k}"] = v
            if not drift:
                warm_mod.advance_noop(ssn)
                metrics.register_warm_start("noop")
                if micro:
                    metrics.register_micro_cycle("noop")
                try:
                    from ..obs import explain

                    explain.record_idle_cycle(ssn)
                except Exception:  # pragma: no cover - forensics only
                    logger.exception("idle-cycle verdict GC failed")
                RECORDER.annotate("solver", {
                    "warm": "noop",
                    "tensorize_wave_patched": ts.get("wave_patched"),
                })
                return
            # Node rows moved beyond the narrow ledger: a session-side
            # mutation the plan could not see. Void the carried state
            # and fall through to the full solve (the arrays are clean
            # now; the re-tensorize below is cheap). In a MICRO cycle
            # the fallthrough is not allowed — same contract as the
            # plan-time fallbacks above: place nothing, defer the full
            # solve to the periodic cycle.
            warm_outcome = "drift"
            last_stats["warm_outcome"] = warm_outcome
            warm_mod.invalidate(ssn.cache)
            if micro:
                last_stats["micro_deferred"] = warm_outcome
                metrics.register_warm_start(warm_outcome)
                metrics.register_micro_cycle("deferred")
                _restamp_deferred(ssn, warm_outcome)
                return
        metrics.register_warm_start(warm_outcome)

        tensorize_kw = {}
        if warm_outcome == "subset":
            # Rank-stable subset bundle (solver/warm.py): the new work
            # plus a bounded rotating drain batch of carried jobs, with
            # GLOBAL ranks computed over the full pending pool so the
            # solve is bit-equal to the full problem restricted to
            # these rows.
            sub = warm_mod.subset_jobs(ssn, warm_live)
            last_stats["warm_subset_jobs"] = len(sub)
            tensorize_kw = dict(
                include_jobs=sub, rank_pool=list(ssn.jobs.values()),
            )
        t0 = time.perf_counter()
        with span("tensorize"):
            try:
                inputs, ctx = tensorize(
                    ssn, device=False if use_native else dev,
                    **tensorize_kw
                )
            except Exception as exc:
                if use_native:
                    raise
                # Device pack failed (dead backend, OOM during the
                # host→device upload): same containment as a dispatch
                # failure — quarantine via the breaker and rebuild
                # host-side for the native floor.
                exc_name = type(exc).__name__
                containment.BREAKER.record_device_failure(
                    "exception", exc=exc_name
                )
                metrics.register_solver_fallback(
                    "device", "native", "tensorize"
                )
                containment.note_fallback(
                    "device", "native", "tensorize", exc=exc_name
                )
                logger.error(
                    "device tensorize failed (%s); re-packing "
                    "host-side for the native floor", exc_name,
                )
                use_native = True
                inputs, ctx = tensorize(ssn, device=False, **tensorize_kw)
        _record_phase("tensorize", (time.perf_counter() - t0) * 1e3)
        # Incremental-tensorize forensics (dirty-row counts, fallback
        # reasons) for the bench/BENCH attribution.
        from ..solver.snapshot import last_tensorize_stats

        for k, v in last_tensorize_stats.items():
            last_stats[f"tensorize_{k}"] = v
        if inputs is None:
            # Idle cycle: nothing to solve, but verdicts recorded on
            # earlier cycles must not outlive the jobs they describe
            # (the reason gauge and /debug/jobs GC live in the verdict
            # pass, which only runs after a real solve).
            try:
                from ..obs import explain

                explain.record_idle_cycle(ssn)
            except Exception:  # pragma: no cover - forensics only
                logger.exception("idle-cycle verdict GC failed")
            if warm_outcome == "subset":
                # The subset's rows all vanished host-side (every live
                # pending task empty-resreq): nothing to solve, but the
                # carried verdicts STAND — advance like a noop cycle,
                # never wipe them as an idle save would.
                warm_mod.advance_noop(ssn)
                ws = warm_mod.warm_state_of(ssn.cache)
                last_stats["warm_carried"] = (
                    len(ws.carried) if ws is not None else 0
                )
            else:
                # An idle cycle leaves the strongest warm state there
                # is: zero carried verdicts.
                last_stats["warm_carried"] = warm_mod.save_warm_state(
                    ssn, None, None
                )
            if micro:
                metrics.register_micro_cycle("noop")
            return
        if breaker_pinned:
            # Counted here, not at the gate: the metric's documented
            # semantics are ladder descents — a cycle actually re-solved
            # on a lower rung — and an idle cycle (inputs None above)
            # solves nothing, so a breaker open across an idle stretch
            # must not tick one phantom descent per period.
            metrics.register_solver_fallback(
                "device", "native", "breaker-open"
            )

        # Degradation-ladder rungs for this cycle, top first. The top
        # rung is whatever the backend decision + tensorize produced
        # (candidate slabs → sparse program); every device cycle keeps
        # dense and the native CPU floor below it, so a runtime device
        # fault degrades scheduling quality, never the cycle.
        if use_native:
            rungs = ["native"]
        else:
            cand = getattr(inputs, "cand_idx", None)
            sparse_slabs = cand is not None and int(cand.shape[0]) > 0
            rungs = (["sparse"] if sparse_slabs else []) + [
                "dense", "native"
            ]

        t0 = time.perf_counter()
        # OVERLAPPED solve: launch is async (device rounds on the
        # device worker, native rounds on a GIL-releasing worker thread);
        # the window below runs host work that does not depend on the
        # assignment, and handle.fetch() is the single block point.
        with span("solve_dispatch", annotate=True):
            try:
                handle = self._launch_rung(rungs[0], inputs, ctx)
            except Exception as exc:
                # Synchronous dispatch failure (trace/compile error,
                # device lost at launch): enter the ladder handle-less.
                # Its first iteration re-launches this rung inside the
                # guarded try, so the failure descends rungs instead of
                # escaping the cycle — the one uncontained window the
                # async fetch path would otherwise leave.
                handle = None
                logger.error(
                    "solve dispatch on rung %r raised %s; deferring "
                    "to the degradation ladder",
                    rungs[0], type(exc).__name__,
                )
        ssn.register_inflight_solve(handle)
        t_launch = time.perf_counter()
        last_stats["solve_launch_ms"] = (t_launch - t0) * 1e3

        # --- overlap window -------------------------------------------
        # Device-cache pack forensics (dirty-ledger bookkeeping).
        if not use_native:
            from ..solver.device_cache import last_pack_stats

            for k, v in last_pack_stats.items():
                if k == "full_reasons":
                    if v:
                        last_stats["device_full_reasons"] = dict(v)
                else:
                    last_stats[f"device_{k}"] = v
        # Epilogue prep: the Releasing-capacity candidate scan reads
        # only the snapshot, never the assignment.
        with span("overlap_window"):
            releasing_nodes = self._releasing_candidates(ssn, ctx)
            if handle is not None and not handle.done():
                # The previous cycle's async bind/evict side effects
                # drain on their worker threads; parking here (bounded)
                # yields the GIL to them inside the solve's shadow
                # instead of letting the backlog contend with the apply
                # phase. Bool: did the previous cycle's bind queue
                # fully drain inside the overlap window (vs the bounded
                # wait timing out with backlog left).
                with span("bind_drain"):
                    last_stats["overlap_binds_drained"] = (
                        ssn.cache.wait_for_side_effects(timeout=0.02)
                    )
        last_stats["overlap_ms"] = (
            time.perf_counter() - t_launch
        ) * 1e3

        t_block = time.perf_counter()
        # The block point, now deadline-bounded and ladder-guarded: any
        # device-rung exception re-solves THIS cycle one rung down, a
        # budget expiry abandons the handle and drops to the native
        # floor (quarantining the backend via the breaker). Only a
        # native-floor failure escapes to the guarded cycle loop.
        ladder: list = []
        budget = containment.solve_budget()
        with span("solve_block", annotate=True):
            assigned, handle = self._solve_ladder(
                ssn, rungs, inputs, ctx, handle, budget, ladder
            )
        ssn.register_inflight_solve(None)
        rounds, backend = handle.rounds, handle.backend
        metrics.update_solver_cycle(rounds, backend)
        last_stats["solve_block_ms"] = (
            time.perf_counter() - t_block
        ) * 1e3
        _record_phase("solve", (time.perf_counter() - t0) * 1e3)
        last_stats.update(backend=backend, rounds=rounds)
        last_stats["solve_ladder"] = ladder
        rejected_total = sum(e.get("rejected", 0) for e in ladder)
        if rejected_total:
            # Post-solve validation rejected placements somewhere on the
            # ladder (descended rung and/or native-floor drops).
            last_stats["validation_rejected"] = rejected_total
        if len(ladder) > 1:
            # Rung descents happened: flag the cycle as degraded so the
            # bench/flight-record readers need no ladder parsing.
            last_stats["solve_degraded"] = True

        # Sparse-solve attribution: whether this cycle's solve ran the
        # candidate-sparsified path, how much refill work it needed, and
        # why it fell back to dense when it did (bench + Prometheus).
        tsparse = last_stats.get("tensorize_sparse") or {}
        engaged = False
        refill_rounds = 0
        fallback_reason = None
        if backend == "native":
            ns = handle.native_stats or {}
            engaged = bool(ns.get("sparse"))
            refill_rounds = int(ns.get("refill_rounds", 0))
            if engaged:
                last_stats["sparse_fallback_scans"] = ns.get(
                    "fallback_scans", 0
                )
                last_stats["sparse_widened"] = ns.get("widened", 0)
        else:
            engaged = handle.refills is not None
            if engaged:
                # Refill ROUNDS = compacted dense stages that drained
                # the refill-flagged tasks; the task count rides along.
                refill_rounds = int(handle.stages or 0)
                last_stats["sparse_refill_tasks"] = handle.refills
            elif tsparse.get("enabled"):
                # tensorize built slabs but the final solve ran dense:
                # a ladder descent stripped them (the sparse rung
                # failed), or a legacy explicit-staged call ignored
                # them.
                fallback_reason = (
                    "ladder-degraded" if len(ladder) > 1
                    else "sharded-mesh"
                )
        if not engaged and fallback_reason is None:
            fallback_reason = tsparse.get("reason")
        last_stats["sparse_engaged"] = engaged
        if engaged:
            last_stats["sparse_k"] = tsparse.get("k")
            last_stats["sparse_refill_rounds"] = refill_rounds
        elif fallback_reason:
            last_stats["sparse_fallback_reason"] = fallback_reason
        metrics.update_solver_sparse(engaged, refill_rounds,
                                     fallback_reason)
        # Sharded-sparse attribution: whether the FINAL successful rung
        # ran the slab solve sharded over the mesh, under which mode,
        # and how many cross-shard reconciliation rounds it took
        # (sharding.last_dispatch reflects the last solve_sharded
        # dispatch — exactly the winning rung's).
        from ..solver import sharding as sharding_mod

        disp = sharding_mod.last_dispatch
        sharded_engaged = bool(
            engaged and backend != "native"
            and disp.get("sparse_sharded")
        )
        last_stats["sparse_sharded_engaged"] = sharded_engaged
        if sharded_engaged:
            last_stats["sparse_shard_mode"] = disp.get("mode")
            last_stats["sparse_shard_count"] = disp.get("shards")
            if handle.reconcile_rounds is not None:
                last_stats["sparse_reconcile_rounds"] = (
                    handle.reconcile_rounds
                )
            metrics.register_sparse_sharded(disp.get("mode"))
            # Delta-packed commit accounting (spmd.note_commit_stats):
            # per-round wire bytes of the code + accept-bit exchange
            # against the full-state broadcast it replaced.
            from ..solver import spmd as spmd_mod

            for key in (
                "commit_bytes_exchanged",
                "commit_bytes_full_broadcast",
                "commit_bytes_per_round",
            ):
                if key in spmd_mod.last_commit_stats:
                    last_stats[key] = spmd_mod.last_commit_stats[key]
        # Which path produced the candidate slabs (device-resident
        # selection vs labeled host fallback) — tensorize stats carry
        # the label; the device counter is incremented at the source.
        if tsparse.get("select_path"):
            last_stats["select_path"] = tsparse.get("select_path")
        from ..solver.kernels import jit_compilation_count

        count = jit_compilation_count()
        last_stats["jit_variants"] = count
        metrics.update_solver_jit_cache(count)

        t0 = time.perf_counter()
        # ctx.tasks is already in global priority-rank order. The
        # sequential guard ("does this task still fit the node, given
        # everything applied before it?") is evaluated for ALL assignments
        # at once. Sequential semantics being reproduced: each allocation
        # checks its own init_resreq against idle (allocate_tpu guard /
        # node_info.go:161-171), while applied allocations shrink idle by
        # RESREQ (add_task subtracts resreq, not init_resreq). So per
        # node, in priority order: exclusive-prefix(resreq) + own
        # init_resreq < idle + eps per dim (less_equal's epsilon,
        # resource_info.go:253-277). When everything fits — the invariant
        # the kernel's capacity accounting guarantees — the whole set is
        # applied via the batched session path; on drift (should not
        # happen) fall back to the per-task guarded loop.
        T = len(ctx.tasks)
        a = np.asarray(assigned[:T])
        sel = np.nonzero(a >= 0)[0]
        all_fit = True
        order = seg_starts = nodes_sorted = None
        if sel.size:
            nodes_sel = a[sel]
            order = np.argsort(nodes_sel, kind="stable")
            nodes_sorted = nodes_sel[order]
            req_sel = ctx.task_req_host[sel]  # shared with the job view
            req_rows = req_sel[order]
            fit_rows = ctx.task_fit_host[sel][order]
            cum = np.cumsum(req_rows, axis=0)
            seg_starts = np.nonzero(
                np.diff(nodes_sorted, prepend=-1)
            )[0]
            base = np.zeros_like(cum)
            base[seg_starts[1:]] = cum[seg_starts[1:] - 1]
            # exclusive within-node prefix of resreq consumption
            prefix = cum - req_rows - np.maximum.accumulate(base, axis=0)
            idle = ctx.node_idle_host[nodes_sorted]
            eps = ctx.layout.eps().astype(np.float64)
            all_fit = bool((prefix + fit_rows < idle + eps).all())
        placed_tasks: list = []
        if all_fit:
            if sel.size:
                # Per-node groups straight from the fit guard's
                # segmentation — the session path never re-groups with
                # per-task dict passes, and each group carries its
                # aggregate resreq delta (a cumsum difference) so node
                # accounting skips per-task Resource math too.
                layout = ctx.layout
                mib = 1024.0 * 1024.0

                def row_to_resource(row):
                    delta = Resource(row[0], row[1] * mib)
                    for k, name in enumerate(layout.scalars):
                        v = float(row[2 + k])
                        if v:
                            delta.add_scalar(name, v)
                    return delta

                getter = ctx.tasks.__getitem__
                tasks_sorted = list(map(getter, sel[order].tolist()))
                seg_list = seg_starts.tolist()
                seg_ends = seg_list[1:] + [len(tasks_sorted)]
                zero = np.zeros_like(cum[0])
                node_groups = []
                for s, e in zip(seg_list, seg_ends):
                    row = cum[e - 1] - (cum[s - 1] if s else zero)
                    node_groups.append((
                        ctx.nodes[int(nodes_sorted[s])].name,
                        tasks_sorted[s:e],
                        row_to_resource(row),
                    ))
                # Per-JOB groups with aggregate resreq deltas, same
                # cumsum-difference trick on a job-sorted view: the
                # session's apply tail then runs ~#jobs aggregate
                # updates (status-index move, job.allocated, plugin
                # batch handlers) instead of 50k per-task passes.
                job_idx = np.asarray(
                    ctx.host_inputs.task_job[:T]
                )[sel]
                jorder = np.argsort(job_idx, kind="stable")
                jtasks = list(map(getter, sel[jorder].tolist()))
                jcum = np.cumsum(req_sel[jorder], axis=0)
                jstarts = np.nonzero(
                    np.diff(job_idx[jorder], prepend=-1)
                )[0].tolist()
                jends = jstarts[1:] + [len(jtasks)]
                job_groups = []
                for s, e in zip(jstarts, jends):
                    row = jcum[e - 1] - (jcum[s - 1] if s else zero)
                    job_groups.append((
                        jtasks[s].job, jtasks[s:e], row_to_resource(row)
                    ))
                placed = ssn.allocate_batch_grouped(
                    node_groups, job_groups=job_groups
                )
                if placed == len(tasks_sorted):
                    placed_tasks = tasks_sorted
                else:
                    # Staging dropped tasks (vanished node, volume
                    # failure): only tasks whose status actually moved
                    # count as placed — the ledger/audit must not
                    # claim pods the apply path dropped.
                    from ..api import allocated_status

                    placed_tasks = [
                        t for t in tasks_sorted
                        if allocated_status(t.status)
                    ]
            else:
                placed = 0
        else:
            logger.warning(
                "solver assignment drifted from session accounting; "
                "applying with the per-task guard"
            )
            placed = 0
            for i in sel:
                task, node_name = ctx.tasks[i], ctx.nodes[a[i]].name
                node = ssn.nodes[node_name]
                if not task.init_resreq.less_equal(node.idle):
                    logger.warning(
                        "solver assignment no longer fits: task %s on %s",
                        task.uid, node_name,
                    )
                    continue
                try:
                    ssn.allocate(task, node_name)
                    placed += 1
                    placed_tasks.append(task)
                except Exception:
                    logger.exception(
                        "Failed to bind Task %s on %s", task.uid, node_name
                    )

        _record_phase("apply", (time.perf_counter() - t0) * 1e3)
        TRACER.complete("apply", t0)
        last_stats["placed"] = placed
        # Apply sub-phase forensics from the batched session path.
        from ..framework.session import last_apply_stats

        for k, v in last_apply_stats.items():
            last_stats[f"apply_{k}"] = v

        # Placement-latency ledger + decision audit (obs/latency.py):
        # stamp every task the solve placed (cycle kind, warm outcome,
        # winning rung, this cycle's solve time) and append one audit
        # record per placed job. Cost is O(placed) — zero on the idle
        # cycle the <1% obs budget is pinned against. Deterministic
        # fields only: the sim's audit stream must replay byte-equal.
        cycle_kind = "micro" if micro else "periodic"
        try:
            from ..obs import latency as latency_mod

            if placed_tasks and latency_mod.LEDGER.enabled:
                placed_by_job: dict = {}
                for task in placed_tasks:
                    placed_by_job[task.job] = (
                        placed_by_job.get(task.job, 0) + 1
                    )
                job_queues = {}
                for job_uid in placed_by_job:
                    job = ssn.jobs.get(job_uid)
                    if job is not None:
                        job_queues[job_uid] = job.queue
                latency_mod.LEDGER.note_placed(
                    ((task.uid, task.job) for task in placed_tasks),
                    job_queues,
                    kind=cycle_kind,
                    solve_s=(
                        last_stats.get("tensorize_ms", 0.0)
                        + last_stats.get("solve_ms", 0.0)
                        + last_stats.get("apply_ms", 0.0)
                    ) / 1e3,
                )
                for job_uid, count in placed_by_job.items():
                    latency_mod.AUDIT.append({
                        "action": "placed",
                        "job": job_uid,
                        "queue": job_queues.get(job_uid, ""),
                        "count": count,
                        "kind": cycle_kind,
                        "backend": backend,
                        "warm": warm_outcome,
                        "degraded": len(ladder) > 1 or breaker_pinned,
                    })
        except Exception:  # pragma: no cover - forensics only
            logger.exception("placement-latency ledger update failed")

        t0 = time.perf_counter()
        # Epilogue: pipeline unassigned tasks onto Releasing resources
        # (allocate.go:168-181), a host-side pass over the leftovers.
        # Same gates as greedy: the task must pass predicates on the node
        # (kernel feas mask), its queue must not be overused
        # (allocate.go:94-95), and among eligible nodes the best-scored one
        # wins, mirroring PrioritizeNodes → SelectBestNode. The candidate
        # set was computed in the solve's overlap window.
        leftovers = enumerate(ctx.tasks) if releasing_nodes else ()
        for i, task in leftovers:
            if int(assigned[i]) >= 0:
                continue
            job = ssn.jobs.get(task.job)
            if job is None:
                continue
            queue = ssn.queues.get(job.queue)
            if queue is not None and ssn.overused(queue):
                continue
            feas_row = ctx.mask.row(i)
            candidates = [
                node
                for j, node in releasing_nodes
                if feas_row[j]
                and task.init_resreq.less_equal(node.releasing)
            ]
            if not candidates:
                continue
            priority_list = prioritize_nodes(
                task, candidates, ssn.node_prioritizers()
            )
            best = ssn.nodes[select_best_node(priority_list)]
            delta = best.idle.clone()
            delta.fit_delta(task.init_resreq)
            job.record_fit_delta(best.name, delta)
            try:
                ssn.pipeline(task, best.name)
            except Exception:
                logger.exception(
                    "Failed to pipeline Task %s on %s", task.uid, best.name
                )

        _record_phase("epilogue", (time.perf_counter() - t0) * 1e3)
        TRACER.complete("epilogue", t0)

        # --- explainability + flight-recorder attribution --------------
        # Per-job verdicts for everything the solve left unassigned
        # (obs/explain.py), classified from the cycle's own evidence —
        # cost scales with the unassigned count. The flight recorder's
        # open cycle record absorbs the cycle's solver attribution so
        # an error/SIGUSR1 dump carries it without re-deriving.
        t0 = time.perf_counter()
        with span("verdicts"):
            try:
                from ..obs import explain

                # "exhausted" = the sparse solve reported pressure past
                # its truncated slabs (native per-task scan-overflow
                # fallbacks). Truncation ALONE is normal and both
                # backends refill to exact verdicts — see
                # explain._classify.
                ns = handle.native_stats or {}
                sparse_info = {
                    "engaged": engaged,
                    "k": tsparse.get("k"),
                    "truncated": bool(tsparse.get("truncated_classes")),
                    "exhausted": bool(
                        engaged and ns.get("fallback_scans", 0)
                    ),
                    "refill_rounds": refill_rounds,
                    "fallback_reason": fallback_reason,
                }
                reason_counts = explain.record_cycle_verdicts(
                    ssn, ctx, assigned, sparse=sparse_info
                )
                if reason_counts:
                    last_stats["unschedulable_reasons"] = reason_counts
            except Exception:  # pragma: no cover - forensics only
                logger.exception("verdict recording failed")
                reason_counts = {}
        last_stats["verdicts_ms"] = (time.perf_counter() - t0) * 1e3
        # Warm-state save: this solve's unassigned remainder becomes the
        # carried-verdict set the next cycle's plan checks against.
        last_stats["warm_carried"] = warm_mod.save_warm_state(
            ssn, ctx, assigned
        )
        if micro:
            metrics.register_micro_cycle("solve")
        RECORDER.annotate("solver", {
            "backend": backend,
            "rounds": rounds,
            "placed": placed,
            "tasks": len(ctx.tasks),
            "warm": warm_outcome,
            "warm_carried": last_stats["warm_carried"],
            # Fault-containment attribution: the rung sequence this
            # cycle actually ran (one entry per attempt), the breaker's
            # state after it, and the last ladder descent — the flight
            # record's "why is this cycle degraded" answer.
            "ladder": list(ladder),
            "degraded": len(ladder) > 1 or breaker_pinned,
            "breaker_state": containment.BREAKER.state,
            "sparse_engaged": engaged,
            "sparse_k": tsparse.get("k") if engaged else None,
            "sparse_refill_rounds": refill_rounds if engaged else None,
            "sparse_sharded": sharded_engaged,
            "sparse_shard_mode": (
                last_stats.get("sparse_shard_mode")
                if sharded_engaged else None
            ),
            "fallback_reason": fallback_reason,
            "device_bytes_shipped": last_stats.get("device_bytes_shipped"),
            "device_rows_patched": last_stats.get("device_rows_patched"),
            "unschedulable_reasons": reason_counts,
        })
        logger.debug(
            "allocate_tpu placed %d/%d tasks in %d rounds",
            placed, len(ctx.tasks), rounds,
        )


register_action(AllocateTpuAction())
