"""Solver fault containment: degradation ladder plumbing, circuit
breaker, and solve deadlines.

A port of the reference's ``solver/containment.py``; only the canary
probe and :func:`strip_candidates` changed, to run on torch tensors.

The scheduler's availability contract (doc/design/robustness.md): an
accelerator failure degrades scheduling QUALITY, never scheduler
LIVENESS. Three cooperating pieces live here, consumed by
``actions/allocate_tpu.py`` and ``scheduler.py``:

- **Typed failures + deadline waits.** :class:`SolveFailed` /
  :class:`SolveTimeout` are what ``AsyncSolveHandle.fetch`` raises
  (memoized — a handle that failed once keeps failing the same way);
  :func:`call_with_deadline` runs a blocking materialization on a
  detached daemon thread so a hung device sync can be ABANDONED at the
  budget instead of wedging the cycle loop (the late result, if it
  ever arrives, is discarded).

- **Circuit breaker** (:data:`BREAKER`). M consecutive device-path
  failures open it; while open, allocate_tpu pins cycles straight to
  the native floor (no device dispatch, no per-cycle failure latency).
  After a cooldown measured in CYCLES (wall time would break sim
  replay determinism) the breaker half-opens and runs a bounded canary
  probe — a 1×1 solve through ``solve_auto`` and the bid kernels on the
  action's device (``BREAKER.allow_device(device)``), ended by one device→host
  read — and re-closes on success.
  The probe is synchronous but deadline-bounded, so re-promotion costs
  at most ``probe_timeout`` once per cooldown window.

- **Fault-injection seam** (:func:`set_device_fault_hook`). The
  deterministic simulator arms a hook that raises (``solver-exc`` /
  ``backend-loss``) or outsleeps the budget (``solver-hang``) inside
  the device-solve materialization and the canary probe — planned from
  the seeded fault stream, so chaos runs replay bit-identically.

The solve budget is derived from the driving scheduler's
``schedule_period`` (stamped via :func:`configure_from_period` at
Scheduler construction; the simulator then overrides it with a small
real-time budget so injected hangs cost fractions of a second);
``KBT_SOLVE_BUDGET`` overrides both for operators.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Callable, Optional

from ..utils.lockdebug import witness_writes, wrap_lock

logger = logging.getLogger(__name__)


class SolveFailed(RuntimeError):
    """A solve attempt failed (wraps the original exception). Raised
    consistently by ``AsyncSolveHandle.fetch`` — including on re-fetch
    of a handle whose first fetch raised (the failure is memoized; a
    consumed concurrent.futures future would otherwise raise a
    different error the second time)."""


class SolveTimeout(SolveFailed):
    """The solve exceeded its deadline budget and was abandoned."""


# -- deadline-bounded waits ---------------------------------------------------


def call_with_deadline(fn, timeout: float, label: str = "solve"):
    """Run ``fn()`` on a detached daemon thread; return its result or
    raise within ``timeout`` seconds. On expiry raises
    :class:`SolveTimeout` and ABANDONS the thread — it keeps running
    (there is no way to cancel a foreign blocking call) but its late
    result/exception is discarded, never delivered. The caller must
    treat whatever the call was reading as quarantined."""
    box: dict = {}
    done = threading.Event()

    def runner():
        try:
            box["result"] = fn()
        except BaseException as exc:  # delivered to the waiter below
            box["error"] = exc
        finally:
            done.set()

    thread = threading.Thread(
        target=runner, daemon=True, name=f"kbt-deadline-{label}"
    )
    thread.start()
    if not done.wait(timeout):
        raise SolveTimeout(
            f"{label} exceeded its {timeout:.3f}s budget; abandoned "
            f"(late result will be discarded)"
        )
    if "error" in box:
        raise box["error"]
    return box.get("result")


# -- solve budget -------------------------------------------------------------

# Default when no scheduler has stamped a period-derived budget and no
# env override exists: generous enough for a cold-compile first solve,
# small enough that a wedged backend costs one budget, not forever.
DEFAULT_SOLVE_BUDGET = 30.0

_config = {"solve_budget": None}


def configure(solve_budget: Optional[float] = None) -> None:
    """Stamp the process-wide solve budget. ``None`` clears back to
    the default. Callers: ``Scheduler.__init__`` (period-derived, via
    :func:`configure_from_period`) and the simulator (small real-time
    budget — constructed AFTER its Scheduler, so its stamp wins)."""
    _config["solve_budget"] = solve_budget


def configure_from_period(schedule_period: float) -> float:
    """Derive + stamp the solve budget from the scheduler's cycle
    period: generous enough that a healthy solve (cold compiles
    included) never trips it, bounded so a wedged backend costs one
    budget. Returns the stamped value."""
    budget = max(DEFAULT_SOLVE_BUDGET, 10.0 * float(schedule_period))
    configure(budget)
    return budget


def solve_budget() -> float:
    """Effective fetch deadline: ``KBT_SOLVE_BUDGET`` env wins, then
    the configured (scheduler-derived) value, then the default."""
    env = os.environ.get("KBT_SOLVE_BUDGET")
    if env:
        try:
            return float(env)
        except ValueError:
            logger.warning("unparseable KBT_SOLVE_BUDGET=%r ignored", env)
    return _config["solve_budget"] or DEFAULT_SOLVE_BUDGET


# -- fault-injection seam (deterministic simulator) ---------------------------

# callable(stage: str) -> None; stage is "solve" (device-solve
# materialization) or "probe" (breaker canary). May raise to fail the
# stage or sleep past the budget to simulate a hang. None in production.
_DEVICE_FAULT_HOOK: Optional[Callable[[str], None]] = None


def set_device_fault_hook(hook: Optional[Callable[[str], None]]) -> None:
    global _DEVICE_FAULT_HOOK
    _DEVICE_FAULT_HOOK = hook


def device_fault_hook() -> Optional[Callable[[str], None]]:
    return _DEVICE_FAULT_HOOK


# callable(assigned: np.ndarray) -> np.ndarray; the simulator's
# solver-corrupt fault TAMPERS with a device rung's fetched assignment
# vector here — modeling a silent miscompute rather than a raise/hang —
# so the post-solve validation layer (solver/validate.py) has a real
# corrupted result to reject. None in production. Applied to device
# rungs only: the native floor's result is host-computed and is the
# trusted fallback the ladder descends to.
_RESULT_TAMPER_HOOK: Optional[Callable] = None


def set_result_tamper_hook(hook: Optional[Callable]) -> None:
    global _RESULT_TAMPER_HOOK
    _RESULT_TAMPER_HOOK = hook


def apply_result_tamper(assigned: object) -> object:
    """Run the sim's result-tamper hook, if armed (device rungs only —
    see the allocate_tpu ladder)."""
    hook = _RESULT_TAMPER_HOOK
    if hook is None:
        return assigned
    return hook(assigned)


# -- ladder helpers -----------------------------------------------------------


def strip_candidates(inputs):
    """Dense-rung inputs from sparse-rung inputs: drop the top-K
    candidate slabs so ``solve_sharded``/``solve_auto`` dispatch the
    dense program. The replacement fields are empty tensors on the
    bundle's device (the same shapes dense tensorize produces): creating
    an empty tensor copies nothing from the device, and the dense rung
    solves on that device anyway."""
    cand = getattr(inputs, "cand_idx", None)
    if cand is None:
        return inputs
    import torch

    dev = cand.device
    return inputs._replace(
        cand_idx=torch.zeros((0, 1), dtype=torch.int32, device=dev),
        cand_static=torch.zeros((0, 1), dtype=torch.float32, device=dev),
        cand_info=torch.zeros((3, 0), dtype=torch.int32, device=dev),
    )


# Most recent ladder descent (one small dict, overwritten per fallback):
# the /debug/vars "one-curl visibility into degraded mode" surface.
last_fallback: dict = {}


def note_fallback(frm: str, to: str, reason: str, exc: str = "") -> None:
    last_fallback.clear()
    last_fallback.update(
        {"from": frm, "to": to, "reason": reason, "exc": exc,
         "ts": time.time()}
    )


# -- circuit breaker ----------------------------------------------------------

STATE_CLOSED = "closed"
STATE_OPEN = "open"
STATE_HALF_OPEN = "half-open"


def _canary_probe(timeout: float, device=None) -> bool:
    """Bounded device-health probe: a 1×1 solve through ``solve_auto``
    with the bid kernels on ``device`` (``None`` means ``cuda``, which
    raises inside the probe where no CUDA device exists), ended by the one
    device→host read of ``assigned``. True iff the whole round trip
    completes within ``timeout``. Consults the sim fault hook first so
    injected backend loss fails the probe deterministically."""
    hook = _DEVICE_FAULT_HOOK
    if hook is not None:
        hook("probe")  # raises while the injected fault window is open

    def run():
        import torch

        from ..device import resolve_device
        from .kernels import make_inputs, solve_auto

        dev = resolve_device(device)

        def t(x, dtype=torch.float32):
            return torch.as_tensor(x, dtype=dtype, device=dev)

        inputs = make_inputs(
            task_req=t([[1.0, 1.0]]),
            task_fit=t([[1.0, 1.0]]),
            task_rank=t([0], torch.int32),
            task_job=t([0], torch.int32),
            task_queue=t([0], torch.int32),
            node_idle=t([[4.0, 4.0]]),
            node_releasing=t([[0.0, 0.0]]),
            node_cap=t([[4.0, 4.0]]),
            node_task_count=t([0], torch.int32),
            node_max_tasks=t([0], torch.int32),
            queue_deserved=t([[float("inf"), float("inf")]]),
            queue_allocated=t([[0.0, 0.0]]),
            eps=t([1e-3, 1e-3]),
            lr_weight=t(1.0),
            br_weight=t(0.0),
        )
        result = solve_auto(inputs, max_rounds=4, use_kernel=True)
        result.assigned.cpu()  # the device→host block point
        return True

    return bool(call_with_deadline(run, timeout, label="canary-probe"))


class CircuitBreaker:
    """Closed → (M consecutive device failures) → open → (cooldown
    cycles, then canary probe) → half-open → closed | open.

    Cycle-counted cooldown, synchronous bounded probe: both choices are
    what keep a chaos-sim run (and its replay) bit-deterministic — no
    wall-clock races decide which cycle re-promotes. ``pin_open`` is
    the operator/bench override: stay open unconditionally (no probe)
    until ``unpin``."""

    def __init__(
        self,
        failure_threshold: int = 3,
        cooldown_cycles: int = 8,
        probe: Optional[Callable[[float, object], bool]] = None,
        probe_timeout: float = 5.0,
    ):
        self._lock = wrap_lock("solver.breaker")
        self.failure_threshold = int(
            os.environ.get("KBT_BREAKER_THRESHOLD", failure_threshold)
        )
        self.cooldown_cycles = int(
            os.environ.get("KBT_BREAKER_COOLDOWN", cooldown_cycles)
        )
        self.probe = probe or _canary_probe
        self.probe_timeout = probe_timeout
        self.state = STATE_CLOSED
        self.failure_streak = 0
        self.trips = 0
        self.reclosures = 0
        self.probes_ok = 0
        self.probes_failed = 0
        self.last_failure: Optional[dict] = None
        self._cooldown_left = 0
        self._opened_ts: Optional[float] = None
        self._pinned_reason: Optional[str] = None
        # KBT_LOCK_DEBUG=2 write-witness: every transition field is
        # lock-guarded by contract (no-op below level 2).
        witness_writes(self, "solver.breaker", (
            "state", "failure_streak", "trips", "reclosures",
            "probes_ok", "probes_failed", "last_failure",
            "_cooldown_left", "_opened_ts", "_pinned_reason",
        ))

    # -- transitions (callers hold no lock) ----------------------------------

    def _set_state(self, state: str, transition: bool = True) -> None:
        """Lock held by caller. ``transition=False`` updates the state
        gauge without counting a transition — pin/unpin are operator
        overrides, and ``solver_breaker_transitions_total``'s documented
        semantics are quarantine trips / canary re-promotions only."""
        if state == self.state:
            return
        self.state = state
        try:
            from .. import metrics

            metrics.update_breaker_state(state, transition=transition)
        except Exception:  # pragma: no cover - metrics must never kill
            logger.exception("breaker metric update failed")

    def record_device_failure(self, reason: str, exc: str = "",
                              open_now: bool = False) -> None:
        """One device-path solve failed (exception or abandoned on
        timeout). Opens the breaker at the threshold; a half-open
        failure re-opens immediately. ``open_now`` skips the threshold
        — a solve ABANDONED on timeout left a wedged device sync behind
        it, and re-dispatching next cycle just to time out again costs
        a full budget per cycle, so quarantine immediately."""
        with self._lock:
            self.failure_streak += 1
            self.last_failure = {
                "reason": reason, "exc": exc, "ts": time.time(),
            }
            should_open = (
                open_now
                or self.state == STATE_HALF_OPEN
                or (
                    self.state == STATE_CLOSED
                    and self.failure_streak >= self.failure_threshold
                )
            )
            if should_open:
                self.trips += 1
                self._cooldown_left = self.cooldown_cycles
                self._opened_ts = time.time()
                self._set_state(STATE_OPEN)
                logger.error(
                    "solver circuit breaker OPEN after %d consecutive "
                    "device failures (last: %s %s); pinning cycles to "
                    "the native floor for %d cycles",
                    self.failure_streak, reason, exc, self._cooldown_left,
                )

    def record_device_success(self) -> None:
        with self._lock:
            self.failure_streak = 0

    def allow_device(self, device=None) -> bool:
        """Gate consulted once per cycle BEFORE tensorize. Closed →
        True. Open → tick the cooldown; when it expires, half-open and
        run the bounded canary probe synchronously on ``device`` (the
        action's): success re-closes
        (this very cycle runs on the device again), failure re-opens
        with a fresh cooldown."""
        with self._lock:
            if self._pinned_reason is not None:
                return False
            if self.state == STATE_CLOSED:
                return True
            if self.state == STATE_OPEN:
                self._cooldown_left -= 1
                if self._cooldown_left > 0:
                    return False
                self._set_state(STATE_HALF_OPEN)
            # half-open: probe outside the state flip but under the
            # lock — one loop, one breaker; a concurrent /debug/vars
            # reader uses state_dict() which takes the lock briefly.
            probe = self.probe
            timeout = min(self.probe_timeout, max(0.1, solve_budget()))
        ok = False
        try:
            ok = bool(probe(timeout, device))
        except Exception as exc:
            logger.warning("breaker canary probe raised: %s", exc)
        with self._lock:
            if ok:
                self.probes_ok += 1
                self.reclosures += 1
                self.failure_streak = 0
                self._opened_ts = None
                self._set_state(STATE_CLOSED)
                logger.warning(
                    "solver circuit breaker re-CLOSED: canary probe "
                    "succeeded; device path re-promoted"
                )
                return True
            self.probes_failed += 1
            self._cooldown_left = self.cooldown_cycles
            self._set_state(STATE_OPEN)
            return False

    def pin_open(self, reason: str) -> None:
        """Hold the breaker open unconditionally (no cooldown, no
        probe) — the bench ``degraded`` point and operator overrides."""
        with self._lock:
            self._pinned_reason = reason
            if self._opened_ts is None:
                self._opened_ts = time.time()
            self._set_state(STATE_OPEN, transition=False)

    def unpin(self) -> None:
        with self._lock:
            self._pinned_reason = None
            self._opened_ts = None
            self.failure_streak = 0
            self._cooldown_left = 0
            self._set_state(STATE_CLOSED, transition=False)

    def state_dict(self) -> dict:
        """/debug/vars + flight-record snapshot."""
        with self._lock:
            return {
                "state": self.state,
                "failure_streak": self.failure_streak,
                "failure_threshold": self.failure_threshold,
                "trips": self.trips,
                "reclosures": self.reclosures,
                "cooldown_cycles_left": max(0, self._cooldown_left),
                "quarantine_age_seconds": (
                    round(time.time() - self._opened_ts, 3)
                    if self._opened_ts is not None else None
                ),
                "probes": {
                    "ok": self.probes_ok, "failed": self.probes_failed,
                },
                "pinned": self._pinned_reason,
                "last_failure": (
                    dict(self.last_failure) if self.last_failure else None
                ),
            }


BREAKER = CircuitBreaker()


def reset_breaker(**kwargs) -> CircuitBreaker:
    """Fresh breaker (tests, and each simulator run — breaker state
    must not leak from a recording run into its replay)."""
    global BREAKER
    BREAKER = CircuitBreaker(**kwargs)
    last_fallback.clear()
    try:
        from .. import metrics

        metrics.update_breaker_state(STATE_CLOSED, transition=False)
    except Exception:  # pragma: no cover
        pass
    return BREAKER
