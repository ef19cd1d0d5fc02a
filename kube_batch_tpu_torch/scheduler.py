"""Scheduler core loop.

Mirrors reference pkg/scheduler/scheduler.go (:35 struct, :45 NewScheduler,
:63 Run — wait.Until(runOnce, period), :88 runOnce: OpenSession → execute
configured actions in order → CloseSession, with per-action latency metrics)
and pkg/scheduler/util.go (:44 loadSchedulerConf, :32 defaultSchedulerConf).

A copy of the reference's ``scheduler.py``. The one addition is the
device: ``Scheduler(..., device=None)`` resolves it like every entry
point of the port (``cuda`` unless ``"cpu"`` is asked for; a raise when
there is no CUDA) and opens every session with it (``ssn.device``), where
the ``allocate_tpu`` action, one instance shared by every scheduler of
the process, reads it.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Callable, List, Optional, Tuple

from . import metrics
from .conf import DEFAULT_SCHEDULER_CONF, Tier, parse_scheduler_conf
from .device import resolve_device
from .framework import Action, close_session, get_action, open_session
from .obs import RECORDER, export_trace, span
from .obs.tracer import TRACER, maybe_enable_from_env
from .utils import deferred_gc
from .utils.lockdebug import witness_writes, wrap_lock

logger = logging.getLogger(__name__)

# The running loop's watchdog (set by Scheduler.run when it starts
# one): the /debug/vars handler has no Scheduler reference, so the
# degraded-mode surface reads the live state from here.
ACTIVE_WATCHDOG: Optional["LoopWatchdog"] = None

# Most recent lease-TTL sanity verdict (Scheduler.check_lease_ttl —
# called by cli/server.py once the elector exists); surfaced in
# /debug/vars' robustness block like ACTIVE_WATCHDOG.
LEASE_TTL_CHECK: Optional[dict] = None


class LoopWatchdog:
    """No-cycle-progress detector: the last line of the solver
    fault-containment layer (doc/design/robustness.md).

    The in-cycle deadlines (``AsyncSolveHandle.fetch(timeout=...)``)
    bound the SOLVE; this thread bounds the whole cycle, catching hangs
    the fetch deadline cannot see — a wedged plugin, a deadlocked
    session close, a foreign call outside the solve. The scheduler
    stamps ``cycle_begin``/``cycle_end`` around ``run_once``; when a
    cycle stays in flight past ``budget`` seconds the watchdog trips
    ONCE for that cycle: flight recorder dumped (KBT_FLIGHT_DIR),
    ``scheduler_watchdog_trips_total`` bumped, and the ``on_trip``
    fencing callback fired — which tells the leader-election layer to
    stop renewing and release the lease, and fences the cache so the
    side-effect threads of this now-deposed leader can issue no binds.
    The wedged process is left to the operator (it may be unkillable
    from inside); what matters is the CLUSTER moves on to a new leader
    that is not hostage to this one's lease."""

    def __init__(
        self,
        budget: float,
        on_trip: Optional[Callable[[str], None]] = None,
        interval: Optional[float] = None,
    ):
        self.budget = float(budget)
        self.interval = interval or max(0.2, min(5.0, self.budget / 4.0))
        self.on_trip = on_trip
        self.trips = 0
        self.last_trip: Optional[dict] = None
        self._lock = wrap_lock("scheduler.watchdog")
        self._inflight_since: Optional[float] = None
        self._inflight_cycle: Optional[int] = None
        self._tripped_cycle: Optional[int] = None
        self._thread: Optional[threading.Thread] = None
        self._stop: Optional[threading.Event] = None
        # KBT_LOCK_DEBUG=2 write-witness (no-op otherwise). _thread/
        # _stop stay out: start() runs once before the thread exists.
        witness_writes(self, "scheduler.watchdog", (
            "_inflight_since", "_inflight_cycle", "_tripped_cycle",
            "trips", "last_trip",
        ))

    def cycle_begin(self, cycle: int) -> None:
        with self._lock:
            self._inflight_since = time.monotonic()
            self._inflight_cycle = cycle

    def cycle_end(self) -> None:
        with self._lock:
            self._inflight_since = None
            self._inflight_cycle = None

    def start(self, stop_event: threading.Event) -> None:
        self._stop = stop_event
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="kbt-loop-watchdog"
        )
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self.check()
            except Exception:  # pragma: no cover - watchdog must survive
                logger.exception("loop watchdog check failed")

    def check(self, now: Optional[float] = None) -> bool:
        """One poll; returns True iff it tripped. Public so tests (and
        embedders without the thread) can drive it synchronously."""
        now = time.monotonic() if now is None else now
        with self._lock:
            since, cycle = self._inflight_since, self._inflight_cycle
            if (
                since is None
                or now - since <= self.budget
                or cycle == self._tripped_cycle
            ):
                return False
            self._tripped_cycle = cycle  # once per wedged cycle
            age = now - since
            self.trips += 1
            self.last_trip = {
                "cycle": cycle, "age_seconds": round(age, 3),
                "budget_seconds": self.budget, "ts": time.time(),
            }
        logger.error(
            "loop watchdog TRIPPED: cycle %s in flight %.1fs (budget "
            "%.1fs) — dumping flight recorder and fencing leadership",
            cycle, age, self.budget,
        )
        metrics.register_watchdog_trip()
        try:
            RECORDER.dump_on_error()
        except Exception:  # pragma: no cover - forensics only
            logger.exception("watchdog flight dump failed")
        if self.on_trip is not None:
            try:
                self.on_trip(
                    f"watchdog: cycle {cycle} exceeded "
                    f"{self.budget:.1f}s no-progress budget"
                )
            except Exception:  # pragma: no cover - fencing is best-effort
                logger.exception("watchdog on_trip fencing hook failed")
        return True

    def state_dict(self) -> dict:
        """/debug/vars snapshot."""
        with self._lock:
            inflight = (
                round(time.monotonic() - self._inflight_since, 3)
                if self._inflight_since is not None else None
            )
            return {
                "budget_seconds": self.budget,
                "trips": self.trips,
                "last_trip": dict(self.last_trip) if self.last_trip else None,
                "cycle_inflight_seconds": inflight,
            }


def load_scheduler_conf(confstr: str) -> Tuple[List[Action], List[Tier]]:
    """YAML policy → (ordered actions, plugin tiers). Misconfigured action
    names are a hard error (reference scheduler/util.go:44-72)."""
    conf = parse_scheduler_conf(confstr)
    actions: List[Action] = []
    for name in conf.actions.split(","):
        name = name.strip()
        if not name:
            continue
        action, found = get_action(name)
        if not found:
            raise ValueError(f"failed to find Action {name}, ignore it")
        actions.append(action)
    return actions, conf.tiers


class _WallClock:
    """Default scheduler pacing: real time. The simulator injects
    ``sim.clock.VirtualClock`` (same surface) to drive thousands of
    cycles in virtual time; ``real`` gates wall-clock-bounded side work
    (the think-time side-effect drain)."""

    real = True

    def now(self) -> float:
        return time.perf_counter()

    def wait(self, event: threading.Event, seconds: float) -> bool:
        if seconds <= 0:
            return event.is_set()
        return event.wait(seconds)


class Scheduler:
    # Per-cycle error backoff (capped exponential): a persistently
    # failing cycle must not busy-spin the loop, and a transient fault
    # (an injected bind storm, a wedged backend probe) must not kill the
    # process — the reference's wait.Until keeps the loop alive the same
    # way.
    CYCLE_ERROR_BACKOFF_BASE = 0.5
    CYCLE_ERROR_BACKOFF_MAX = 30.0

    def __init__(
        self,
        cache,
        scheduler_conf: Optional[str] = None,
        schedule_period: float = 1.0,
        clock=None,
        device=None,
    ):
        """scheduler_conf: YAML policy string or path to one; defaults to the
        reference default policy (allocate, backfill; 2 plugin tiers).
        ``device``: where the policy's ``allocate_tpu`` solves (``cuda``
        unless ``"cpu"``; raises when CUDA is asked for and absent)."""
        self.device = resolve_device(device)
        # Ensure builtin registries are populated (blank-import analog,
        # reference cmd/kube-batch/main.go:33-35).
        from . import actions as _actions  # noqa: F401
        from . import plugins as _plugins  # noqa: F401

        self.cache = cache
        self.schedule_period = schedule_period
        self.clock = clock or _WallClock()
        self._error_streak = 0
        self._cycle_count = 0
        # Solver fault containment: stamp the process-wide solve budget
        # from this scheduler's period (solver/containment.py; the
        # simulator overrides it after construction with a small
        # real-time budget). The loop watchdog's no-progress budget sits
        # ABOVE the fetch deadline — the fetch recovering a hung solve
        # must never race the watchdog fencing the leader for it.
        from .solver import containment

        containment.configure_from_period(schedule_period)
        # solve_budget() (not the stamped value): the fetch deadline
        # honors a KBT_SOLVE_BUDGET override, and the watchdog budget
        # must track the deadline it sits above — otherwise a raised
        # solve budget lets the watchdog fence a healthy leader
        # mid-solve. 4x, not 2x: the degradation ladder's worst case is
        # THREE sequential budget-bounded rung attempts in one cycle
        # (sparse fails just under the budget, dense likewise, native
        # floor solves) — a cycle actively recovering down the ladder
        # must never be fenced as wedged.
        solve_budget = containment.solve_budget()
        default_budget = 4.0 * solve_budget + 10.0 * schedule_period
        env_budget = os.environ.get("KBT_WATCHDOG_BUDGET")
        self.watchdog_budget = default_budget
        if env_budget:
            try:
                parsed = float(env_budget)
            except ValueError:
                logger.warning(
                    "unparseable KBT_WATCHDOG_BUDGET=%r ignored "
                    "(using %.1fs)", env_budget, default_budget,
                )
            else:
                # <= 0 disables the watchdog (same as KBT_WATCHDOG=0):
                # a 0-second budget would fence a healthy leader on the
                # first poll of any in-flight cycle.
                self.watchdog_budget = parsed
        # Fencing callbacks beyond the cache (cli/server.py appends the
        # leader elector's fence); fired from the watchdog thread.
        self.fence_hooks: List[Callable[[str], None]] = []
        self.watchdog: Optional[LoopWatchdog] = None
        # Event-driven micro-cycles (KBT_MICRO=0 opts out): pod
        # arrivals wake the loop during think time and a bounded fast
        # path places them through the warm-start plan without waiting
        # for the period (doc/design/cycle-pipeline.md §micro steady
        # state). Under sustained arrivals micro cycles are the PRIMARY
        # placement path — noop/solve/subset warm outcomes all place —
        # and the periodic cycle is the reconciliation/fairness sweep
        # (preempt/reclaim, anti-entropy, journal pruning). A micro
        # cycle whose warm plan cannot engage places nothing and
        # defers.
        self.micro_enabled = os.environ.get("KBT_MICRO", "1") == "1"
        try:
            self.micro_max_per_period = max(
                1, int(os.environ.get("KBT_MICRO_MAX", "64"))
            )
        except ValueError:
            self.micro_max_per_period = 64
        # Coalescing window: KBT_MICRO_BATCH_MS=auto (default) tunes it
        # from the arrival-rate EWMA each micro wake-up — wait long
        # enough to coalesce ~KBT_MICRO_BATCH_TARGET arrivals, clamped
        # to [KBT_MICRO_BATCH_MIN_MS, KBT_MICRO_BATCH_MAX_MS]. A fixed
        # millisecond value pins it (the older fixed-window behavior).
        batch_ms = os.environ.get("KBT_MICRO_BATCH_MS", "auto")
        self.micro_batch_auto = batch_ms.strip().lower() in ("", "auto")
        if self.micro_batch_auto:
            self.micro_batch_window = 0.005
        else:
            try:
                self.micro_batch_window = max(0.0, float(batch_ms) / 1e3)
            except ValueError:
                self.micro_batch_auto = True
                self.micro_batch_window = 0.005

        def _ms_env(name: str, default: str) -> float:
            try:
                return max(
                    0.0, float(os.environ.get(name, default)) / 1e3
                )
            except ValueError:
                return float(default) / 1e3

        self.micro_batch_min = _ms_env("KBT_MICRO_BATCH_MIN_MS", "1")
        self.micro_batch_max = max(
            self.micro_batch_min, _ms_env("KBT_MICRO_BATCH_MAX_MS", "20")
        )
        try:
            self.micro_batch_target = max(
                1, int(os.environ.get("KBT_MICRO_BATCH_TARGET", "64"))
            )
        except ValueError:
            self.micro_batch_target = 64
        # Early periodic fairness pass (doc/design/serving.md): when a
        # pending serving pod has outlived its placement-latency target,
        # or the warm carried backlog is deeper than this threshold, the
        # think-time tail is cut short and the periodic cycle — the
        # preempt/reclaim/fairness authority — runs NOW instead of after
        # a micro-cycle storm finishes riding the period out (0
        # disables the backlog trigger).
        try:
            self.serving_early_backlog = max(
                0, int(os.environ.get("KBT_SERVING_EARLY_BACKLOG", "1024"))
            )
        except ValueError:
            self.serving_early_backlog = 1024
        self.early_fairness_passes = 0
        # Arrival-rate EWMA for the auto-tune (real-clock only: the
        # simulator drives micro cycles deterministically via
        # --micro-every and never enters _micro_wait, so this estimator
        # carries no replay taint).
        self._arrival_rate = 0.0
        self._arrival_count = 0
        self._arrival_mark = time.perf_counter()
        self.micro_window_last = self.micro_batch_window
        self._micro_arrival = threading.Event()
        self.micro_cycles_run = 0
        # KBT_TRACE_DIR arms the span tracer for the whole loop; the
        # trace file is written on loop exit and on cycle errors.
        maybe_enable_from_env()
        # Placement-latency ledger clock: stamps ride the scheduler's
        # injectable clock, so the simulator's ledger (and its audit
        # stream) run on virtual time — replay-deterministic by
        # construction (obs/latency.py).
        from .obs.latency import LEDGER

        LEDGER.configure(clock=self.clock.now)
        # Per-cycle telemetry feed (KBT_TELEMETRY=0 disables).
        from .obs.telemetry import telemetry_enabled_from_env

        self._telemetry = telemetry_enabled_from_env()
        confstr = scheduler_conf or DEFAULT_SCHEDULER_CONF
        if "\n" not in confstr and confstr.endswith((".yaml", ".yml")):
            with open(confstr) as f:
                confstr = f.read()
        self.actions, self.tiers = load_scheduler_conf(confstr)
        # Successor-recovery note for the first post-recovery cycle's
        # flight record (recover_from_journal sets it; run_once drains
        # it into RECORDER.annotate("recovery", ...)).
        self._pending_recovery_note: Optional[dict] = None

    def check_lease_ttl(self, lease_duration: float) -> dict:
        """Lease-TTL sanity check (called by the server once the
        elector exists): a lease TTL shorter than the watchdog's
        no-progress budget means a healthy-but-slow leader — one the
        watchdog would deliberately NOT fence, e.g. a cycle riding the
        degradation ladder through three budget-bounded rung attempts —
        can lose its lease mid-cycle if it stalls hard enough to miss
        renewals, handing the cluster a split recovery the fencing
        order was designed to prevent. Warn loudly and export the
        verdict (/debug/vars robustness.lease_ttl)."""
        global LEASE_TTL_CHECK

        verdict = {
            "lease_duration_seconds": float(lease_duration),
            "watchdog_budget_seconds": float(self.watchdog_budget),
            "sane": (
                self.watchdog_budget <= 0
                or lease_duration >= self.watchdog_budget
            ),
        }
        if not verdict["sane"]:
            logger.warning(
                "elector lease TTL %.1fs is SHORTER than the watchdog "
                "no-progress budget %.1fs: a healthy-but-slow leader "
                "can lose its lease mid-cycle before the watchdog "
                "would fence it — raise the lease duration or lower "
                "KBT_WATCHDOG_BUDGET",
                lease_duration, self.watchdog_budget,
            )
        LEASE_TTL_CHECK = verdict
        return verdict

    def recover_from_journal(self):
        """Successor recovery pass (cache/recovery.py): after lease
        acquisition and cache sync, reconcile the bind-intent journal
        a dead predecessor left behind against cluster truth — classify
        every in-flight bind, re-drive or revert, repair partial gangs
        — BEFORE the first scheduling cycle plans against a state it
        doesn't understand. Returns the RecoveryReport, or None when
        the cluster has no journal seam or KBT_RECOVERY=0."""
        cluster = getattr(self.cache, "cluster", None)
        if cluster is None or not getattr(
            cluster, "supports_bind_journal", False
        ):
            return None
        if os.environ.get("KBT_RECOVERY", "1") == "0":
            return None
        from .cache.recovery import reconcile_journal

        identity = getattr(
            self.cache, "leader_identity", f"scheduler-{os.getpid()}"
        )
        report = reconcile_journal(cluster, identity)
        if report.intents_scanned or report.tasks_classified:
            self._pending_recovery_note = report.summary()
        return report

    def run_once_guarded(self) -> bool:
        """One cycle that cannot kill the loop: exceptions are logged,
        counted (``scheduler_cycle_errors_total``), and folded into the
        error streak that drives :meth:`cycle_error_backoff`. Returns
        True iff the cycle completed. Shared by :meth:`run` and the
        simulator's cycle driver, so a sim fault run exercises exactly
        the production error path."""
        try:
            try:
                self.run_once()
            finally:
                # An errored cycle still ENDED — the watchdog only
                # fences cycles that never come back.
                if self.watchdog is not None:
                    self.watchdog.cycle_end()
        except Exception as exc:
            self._error_streak += 1
            metrics.register_cycle_error()
            # Flight-recorder forensics: the open cycle record absorbs
            # the failing phase + traceback and is committed to the
            # ring; a dump file lands in KBT_FLIGHT_DIR when set, and a
            # Chrome trace alongside it when tracing is armed.
            RECORDER.record_error(exc)
            RECORDER.dump_on_error()
            export_trace(tag="trace-cycle-error")
            logger.exception(
                "scheduling cycle failed (streak %d, next backoff %.1fs)",
                self._error_streak, self.cycle_error_backoff(),
            )
            return False
        self._error_streak = 0
        return True

    def cycle_error_backoff(self) -> float:
        """Current retry delay: base * 2^(streak-1), capped."""
        if self._error_streak <= 0:
            return 0.0
        return min(
            self.CYCLE_ERROR_BACKOFF_BASE * (2 ** (self._error_streak - 1)),
            self.CYCLE_ERROR_BACKOFF_MAX,
        )

    def run(self, stop_event: Optional[threading.Event] = None) -> None:
        """reference scheduler.go:63-85"""
        from .obs import install_sigusr1

        stop = stop_event or threading.Event()
        clock = self.clock
        # Live-process forensics: SIGUSR1 dumps the flight-recorder ring
        # (no-op on non-main threads — the sim drives cycles directly).
        install_sigusr1()
        # Loop watchdog (KBT_WATCHDOG=0 disables): only the free-running
        # production loop gets one — run_once embedders and the
        # simulator bound their cycles themselves.
        if (os.environ.get("KBT_WATCHDOG", "1") != "0"
                and self.watchdog_budget > 0):
            self._run_stop = stop
            self.watchdog = LoopWatchdog(
                self.watchdog_budget, on_trip=self._on_watchdog_trip
            )
            self.watchdog.start(stop)
            global ACTIVE_WATCHDOG
            ACTIVE_WATCHDOG = self.watchdog
        self.cache.run(stop)
        self.cache.wait_for_cache_sync(stop)
        # Failover recovery BEFORE the first cycle: a successor must
        # classify the dead predecessor's in-flight binds (and repair
        # any gang left below minMember) before planning placements on
        # top of them. Guarded — a recovery error must not keep a
        # healthy leader from scheduling.
        try:
            self.recover_from_journal()
        except Exception:
            logger.exception("startup journal recovery failed; continuing")
        if self.micro_enabled:
            # Arm the arrival wake-up: pending pods of ours landing in
            # the mirror set the event the think-time wait below parks
            # on (cache/event_handlers.add_pod → _notify_arrival).
            arm = getattr(self.cache, "set_arrival_listener", None)
            if arm is not None:
                arm(self._note_arrival)
        while not stop.is_set():
            start = clock.now()
            if not self.run_once_guarded():
                with span("loop.sleep"):
                    clock.wait(stop, self.cycle_error_backoff())
                continue
            elapsed = clock.now() - start
            remaining = max(0.0, self.schedule_period - elapsed)
            if remaining > 0 and clock.real:
                # Think-time drain: absorb this cycle's async bind/evict
                # backlog while the loop would otherwise sleep, so the
                # next cycle's overlapped solve window starts from an
                # empty side-effect queue (allocate_tpu parks on the
                # same queue inside the solve's shadow). Sliced waits so
                # the stop event stays responsive mid-drain.
                deadline = time.perf_counter() + remaining
                try:
                    with span("loop.drain"):
                        while not stop.is_set():
                            left = deadline - time.perf_counter()
                            if left <= 0:
                                break
                            if self.cache.wait_for_side_effects(
                                timeout=min(0.2, left)
                            ):
                                break
                except Exception:
                    logger.exception("think-time side-effect drain failed")
                if self.micro_enabled and self._micro_wait(stop, deadline):
                    # Fairness pressure (serving SLO burning or deep
                    # carried backlog): skip the rest of the think time
                    # and run the periodic fairness pass immediately.
                    self.early_fairness_passes += 1
                    continue
                remaining = max(0.0, deadline - time.perf_counter())
            with span("loop.sleep"):
                clock.wait(stop, remaining)
        # Loop exit with tracing armed (KBT_TRACE_DIR): persist the
        # buffered spans so an operator-stopped run leaves a trace.
        export_trace(tag="trace")

    def _note_arrival(self) -> None:
        """Cache arrival-listener hook (one tick per arriving pod of
        ours): feed the rate estimator and wake the think-time wait."""
        self._arrival_count += 1
        self._micro_arrival.set()

    def _micro_tuned_window(self) -> float:
        """The coalescing window for the next micro cycle. Serving
        arrivals always get the MINIMUM window — coalescing buys
        throughput, and a serving pod pays for every waited millisecond
        out of its placement-latency SLO budget, so they are the
        highest-coalescing-priority class. With
        ``KBT_MICRO_BATCH_MS=auto`` (default) the window is otherwise
        sized from the ledger's MEASURED solve-stage p99
        (obs/latency.py): waiting to coalesce is free exactly while the
        wait stays below the per-cycle solve cost it amortizes, so the
        window tracks what solves actually cost on this cluster rather
        than a raw arrival-count guess. The arrival-rate EWMA remains
        as the cold-start fallback until the ledger has applied
        samples; clamped to [MIN_MS, MAX_MS] either way. A fixed value
        returns unchanged."""
        from .obs.latency import LEDGER

        if LEDGER.serving_arrival_pending():
            self.micro_window_last = self.micro_batch_min
            return self.micro_batch_min
        if not self.micro_batch_auto:
            self.micro_window_last = self.micro_batch_window
            return self.micro_batch_window
        window = None
        try:
            solve = LEDGER.stage_percentiles().get("solve")
            if solve and solve.get("count", 0) >= 8:
                window = min(
                    self.micro_batch_max,
                    max(self.micro_batch_min, float(solve["p99_s"])),
                )
        except Exception:  # pragma: no cover - tuning must not wedge
            window = None
        if window is None:
            now = time.perf_counter()
            dt = now - self._arrival_mark
            if dt >= 0.5:
                inst = self._arrival_count / dt
                self._arrival_count = 0
                self._arrival_mark = now
                self._arrival_rate = (
                    inst
                    if self._arrival_rate == 0.0
                    else 0.7 * self._arrival_rate + 0.3 * inst
                )
            rate = self._arrival_rate
            if rate <= 0.0:
                window = self.micro_batch_min
            else:
                window = min(
                    self.micro_batch_max,
                    max(
                        self.micro_batch_min,
                        self.micro_batch_target / rate,
                    ),
                )
        self.micro_window_last = window
        return window

    def _fairness_pressure(self) -> bool:
        """Whether the periodic fairness pass should run EARLY: a
        pending serving pod has outlived its placement-latency target
        (its SLO is burning while only warm-plan micro placements run),
        or the warm carried backlog is deeper than
        ``KBT_SERVING_EARLY_BACKLOG`` (deep carried work starves behind
        a micro-cycle storm — only the periodic preempt/reclaim sweep
        can evict room for it)."""
        from .obs.latency import LEDGER

        if LEDGER.serving_pressure():
            return True
        if self.serving_early_backlog <= 0:
            return False
        ws = getattr(self.cache, "_warm_solve_state", None)
        if ws is None or not getattr(ws, "valid", False):
            return False
        return len(ws.carried) > self.serving_early_backlog

    def _micro_wait(self, stop, deadline: float) -> bool:
        """Think-time tail with event-driven placement: park on the
        arrival event until the period deadline; each wake-up runs one
        bounded micro cycle (after the coalescing window — auto-tuned
        from the ledger's measured solve p99 by default — so a gang's
        pod burst lands in one cycle), at most ``micro_max_per_period``
        per period. A micro-cycle error falls through to the normal
        per-cycle error accounting — the periodic loop's backoff is not
        engaged (the next periodic cycle is the recovery authority).

        Returns True when fairness pressure (serving SLO burning, deep
        carried backlog — :meth:`_fairness_pressure`) says the periodic
        pass must run NOW; the run loop then skips the rest of the
        think time. The park is sliced so pressure that develops
        between arrivals (a pending serving deadline expiring) is seen
        within ~a quarter second, not at the period boundary."""
        used = 0
        while not stop.is_set():
            if self._fairness_pressure():
                return True
            if used >= self.micro_max_per_period:
                return False
            left = deadline - time.perf_counter()
            if left <= 0:
                return False
            with span("loop.park"):
                arrived = self._micro_arrival.wait(timeout=min(left, 0.25))
            if not arrived:
                continue
            with span("loop.coalesce"):
                window = self._micro_tuned_window()
                if window > 0:
                    stop.wait(window)
            self._micro_arrival.clear()
            used += 1
            try:
                self.run_micro()
            except Exception:  # pragma: no cover - guarded inside
                logger.exception("micro cycle failed")
        return False

    def run_micro(self) -> bool:
        """One event-driven micro cycle: the allocate fast path between
        periodic cycles. Opens a REAL session (full plugin state — the
        placements it makes are exactly what the periodic cycle would
        have made) but runs only the micro-capable actions, each told
        via ``ssn.micro_cycle`` to place ONLY through the warm-start
        plan: if the plan cannot engage, the cycle places nothing and
        defers to the next periodic cycle, which remains the
        fairness/preempt authority. Returns True iff the cycle
        completed without error."""
        cycle = self._cycle_count
        self._cycle_count += 1
        TRACER.begin_cycle(cycle)
        RECORDER.begin_cycle(cycle, kind="micro")
        from .obs.latency import LEDGER

        LEDGER.begin_cycle(cycle, kind="micro")
        if self.watchdog is not None:
            self.watchdog.cycle_begin(cycle)
        cycle_start = time.perf_counter()
        ok = True
        try:
            with span("cycle"):
                with deferred_gc():
                    RECORDER.phase("open_session")
                    t0 = time.perf_counter()
                    with span("open_session"):
                        ssn = open_session(
                            self.cache, self.tiers, micro=True,
                            device=self.device,
                        )
                    RECORDER.phase_done(
                        "open_session", (time.perf_counter() - t0) * 1e3
                    )
                    try:
                        for action in self.actions:
                            if not getattr(action, "micro_capable", False):
                                continue
                            name = action.name()
                            RECORDER.phase(f"action:{name}")
                            action_start = time.perf_counter()
                            with span(f"action:{name}"):
                                action.initialize()
                                action.execute(ssn)
                                action.un_initialize()
                            elapsed = time.perf_counter() - action_start
                            metrics.update_action_duration(name, elapsed)
                            RECORDER.phase_done(
                                f"action:{name}", elapsed * 1e3
                            )
                    except BaseException:
                        RECORDER.mark_failed_phase()
                        raise
                    finally:
                        RECORDER.phase("close_session")
                        t0 = time.perf_counter()
                        with span("close_session"):
                            close_session(ssn)
                        RECORDER.phase_done(
                            "close_session", (time.perf_counter() - t0) * 1e3
                        )
        except Exception as exc:
            ok = False
            metrics.register_cycle_error()
            RECORDER.record_error(exc)
            RECORDER.dump_on_error()
            logger.exception("micro cycle failed")
        finally:
            if self.watchdog is not None:
                self.watchdog.cycle_end()
        self._cycle_epilogue(time.perf_counter() - cycle_start, ok=ok)
        self.micro_cycles_run += 1
        return ok

    def _cycle_epilogue(self, e2e: float, **end) -> None:
        """The cycle's bookkeeping after its ``cycle`` span, under the
        ``cycle_epilogue`` span: the quality scorecard BEFORE end_cycle
        (the card rides in this cycle's still-open flight record; micro
        cycles count toward the KBT_QUALITY_EVERY cadence exactly like
        the telemetry probes, so under micro-primary steady state the
        card does not go stale), the flight record, then the
        long-horizon telemetry feed (this cycle's record and resource
        watermarks, obs/telemetry.py). Guarded: a probe failure never
        fails a cycle."""
        with span("cycle_epilogue"):
            metrics.update_e2e_duration(e2e)
            RECORDER.phase("done")
            with span("quality"):
                try:
                    from .obs.quality import QUALITY

                    QUALITY.annotate_cycle(self.cache)
                except Exception:
                    logger.exception("quality cycle feed failed")
            with span("flight_record"):
                rec = RECORDER.end_cycle(e2e_ms=round(e2e * 1e3, 3), **end)
            if self._telemetry:
                with span("telemetry"):
                    try:
                        from .obs.telemetry import TELEMETRY

                        TELEMETRY.observe_scheduler_cycle(
                            rec, cache=self.cache
                        )
                    except Exception:
                        logger.exception("telemetry cycle feed failed")

    def _on_watchdog_trip(self, reason: str) -> None:
        """Fencing half of a watchdog trip: this (possibly wedged)
        process must lose the power to mutate the cluster BEFORE a
        successor takes the lease — cache side-effect threads refuse
        binds/evicts from here on, and every registered fence hook
        (the leader elector: stop renewing, release) fires."""
        # Cache fence FIRST: it is non-blocking by construction (its
        # own lock, never cache.mutex — the wedged cycle may hold the
        # mutex), while the elector's fence can block draining its
        # renew thread. Releasing the lease before the fence lands
        # would let this leader's queued side-effect threads keep
        # binding while a successor starts placing the same tasks —
        # the process must lose bind power BEFORE anyone else can
        # take the lease.
        fence = getattr(self.cache, "fence", None)
        if fence is not None:
            fence(reason)
        for hook in self.fence_hooks:
            try:
                hook(reason)
            except Exception:  # pragma: no cover - fencing best-effort
                logger.exception("fence hook failed")
        # A fenced scheduler can never bind again — stop the run loop
        # so the process exits (and a supervisor restarts it) instead
        # of spinning CacheFencedError cycles forever. With an elector
        # the lost-leadership path stops it anyway; standalone (no
        # fence hooks) this is the only exit.
        run_stop = getattr(self, "_run_stop", None)
        if run_stop is not None:
            run_stop.set()

    def run_once(self) -> None:
        """One scheduling cycle (reference scheduler.go:88-103). GC is
        deferred for the cycle's duration — collections triggered by the
        apply phase's allocation burst otherwise stop the world mid-cycle
        (~350 ms at 50k tasks); the deferred collection runs in the
        scheduler's think-time gap instead (utils/gc_guard.py).

        Instrumented end to end: every phase runs under a tracer span
        and stamps the flight recorder's open cycle record, so an error
        dump names the phase that raised and the Chrome trace shows the
        phase timeline across the overlap window's worker threads."""
        cycle = self._cycle_count
        self._cycle_count += 1
        TRACER.begin_cycle(cycle)
        RECORDER.begin_cycle(cycle)
        from .obs.latency import LEDGER

        LEDGER.begin_cycle(cycle, kind="periodic")
        if self._pending_recovery_note is not None:
            # First post-recovery cycle: the failover reconciliation's
            # outcome rides in this cycle's flight record, so an error
            # dump (or the sim's trace) shows what recovery changed
            # underneath the cycle that then ran.
            RECORDER.annotate("recovery", self._pending_recovery_note)
            self._pending_recovery_note = None
        if self.watchdog is not None:
            self.watchdog.cycle_begin(cycle)
        # Anti-entropy sweep (cache/antientropy.py) BEFORE the session
        # opens: divergence repairs land in the mirror + dirty ledger
        # first, so this cycle's snapshot — and the warm-start plan
        # judging it — already sees the reconciled world. Periodic
        # cycles only (run_micro never sweeps); cadence and budget are
        # the sweeper's own (KBT_ANTIENTROPY_EVERY), and a sweep failure
        # never fails the cycle.
        with span("antientropy"):
            self.cache.run_antientropy_if_due()
        cycle_start = time.perf_counter()
        with span("cycle"):
            with deferred_gc():
                RECORDER.phase("open_session")
                t0 = time.perf_counter()
                with span("open_session"):
                    ssn = open_session(
                        self.cache, self.tiers, device=self.device
                    )
                RECORDER.phase_done(
                    "open_session", (time.perf_counter() - t0) * 1e3
                )
                try:
                    for action in self.actions:
                        name = action.name()
                        RECORDER.phase(f"action:{name}")
                        action_start = time.perf_counter()
                        with span(f"action:{name}"):
                            action.initialize()
                            action.execute(ssn)
                            action.un_initialize()
                        elapsed = time.perf_counter() - action_start
                        metrics.update_action_duration(name, elapsed)
                        RECORDER.phase_done(
                            f"action:{name}", elapsed * 1e3
                        )
                except BaseException:
                    # Pin the phase that actually raised before the
                    # finally's close_session overwrites it — the error
                    # dump must name the FAILING phase.
                    RECORDER.mark_failed_phase()
                    raise
                finally:
                    RECORDER.phase("close_session")
                    t0 = time.perf_counter()
                    with span("close_session"):
                        close_session(ssn)
                    RECORDER.phase_done(
                        "close_session", (time.perf_counter() - t0) * 1e3
                    )
        self._cycle_epilogue(time.perf_counter() - cycle_start)
