"""Flight recorder: a fixed-size ring of per-cycle forensic records.

Aggregate Prometheus counters say THAT cycles are slow or failing; the
flight recorder says WHICH phase, with the solver's own attribution
(sparse engagement / refill rounds / fallback reason, device-cache
bytes shipped, verdict counts) and — on a cycle error — the failing
phase plus the full traceback, captured at the moment
``Scheduler.run_once_guarded`` absorbed it.

Dump triggers (doc/design/observability.md):
- cycle error in the guarded loop (written to ``KBT_FLIGHT_DIR`` when
  set; always kept in the ring either way);
- ``SIGUSR1`` (``install_sigusr1``), for a live process that is
  misbehaving but not erroring;
- the metrics HTTP server's ``/debug/flightrecorder`` endpoint;
- the simulator, alongside its JSONL trace, on any invariant violation
  or cycle error.

Records are canonical JSON (sorted keys) so dumps diff cleanly; values
that do not serialize are repr()'d rather than dropped.
"""

from __future__ import annotations

import json
import logging
import os
import signal
import threading
import time
import traceback
from collections import deque
from typing import List, Optional

from ..utils.lockdebug import witness_writes, wrap_lock

logger = logging.getLogger(__name__)

DUMP_VERSION = 1
FLIGHT_DIR_ENV = "KBT_FLIGHT_DIR"
FLIGHT_CAPACITY_ENV = "KBT_FLIGHT_CAPACITY"
DEFAULT_CAPACITY = 256


def _jsonable(obj):
    """Best-effort canonical-JSON coercion (numpy scalars, exceptions,
    arbitrary objects) — a forensic record must never fail to dump."""
    try:
        json.dumps(obj)
        return obj
    except (TypeError, ValueError):
        pass
    item = getattr(obj, "item", None)  # numpy scalars
    if callable(item):
        try:
            return _jsonable(item())
        except Exception:
            pass
    if isinstance(obj, dict):
        return {str(k): _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple, set, frozenset)):
        return [_jsonable(v) for v in obj]
    return repr(obj)


class FlightRecorder:
    def __init__(self, capacity: Optional[int] = None):
        if capacity is None:
            capacity = int(
                os.environ.get(FLIGHT_CAPACITY_ENV, DEFAULT_CAPACITY)
            )
        self.capacity = capacity
        self._ring: deque = deque(maxlen=capacity)
        self._lock = wrap_lock("obs.flightrecorder")
        self._seq = 0
        self._open: Optional[dict] = None
        self.started_at = time.time()
        self.last_cycle_ts: Optional[float] = None
        self.error_count = 0
        # KBT_LOCK_DEBUG=2 write-witness (no-op otherwise).
        witness_writes(self, "obs.flightrecorder", (
            "_seq", "_open", "last_cycle_ts", "error_count",
        ))

    # -- per-cycle lifecycle ------------------------------------------------

    def begin_cycle(self, cycle=None, kind: str = "periodic") -> dict:
        """Open this cycle's record; phases and annotations accumulate
        into it until :meth:`end_cycle` commits it to the ring.
        ``kind`` distinguishes the periodic loop from the event-driven
        micro-cycle fast path (``periodic`` | ``micro``)."""
        with self._lock:
            prev = self._open
            if prev is not None:
                # An unguarded caller raised past end_cycle: keep the
                # interrupted record rather than silently dropping it.
                prev["abandoned"] = True
                prev["ok"] = False
                self._ring.append(prev)
            self._seq += 1
            rec = {
                "seq": self._seq,
                "cycle": cycle if cycle is not None else self._seq - 1,
                "cycle_kind": kind,
                "t_start": time.time(),
                "phase": "start",
                "phases_ms": {},
            }
            self._open = rec
            return rec

    def phase(self, name: str) -> None:
        """Mark the phase the cycle is currently in — this is what an
        error dump reports as the failing phase. All mutations of the
        open record take the lock: snapshot()/dump() copy it from HTTP
        worker threads (and the SIGUSR1 dump thread) concurrently."""
        with self._lock:
            rec = self._open
            if rec is not None:
                rec["phase"] = name

    def phase_done(self, name: str, ms: float) -> None:
        with self._lock:
            rec = self._open
            if rec is not None:
                rec["phases_ms"][name] = round(float(ms), 3)

    def annotate(self, key: str, value) -> None:
        """Attach a forensic blob (solver stats, verdict counts, device
        cache) to the open record; no-op when no cycle is open (direct
        ``action.execute`` callers outside a scheduler loop)."""
        payload = _jsonable(value)
        with self._lock:
            rec = self._open
            if rec is not None:
                rec[key] = payload

    def mark_failed_phase(self) -> None:
        """Pin the currently-marked phase as the FAILING one — called
        from an except block before guard layers (a finally-close) move
        the phase on. :meth:`record_error` then reports it."""
        with self._lock:
            rec = self._open
            if rec is not None:
                rec["failed_phase"] = rec.get("phase")

    def record_error(self, exc: BaseException) -> dict:
        """Fold an absorbed cycle error into the open record (creating
        one if the failure predates begin_cycle) and commit it."""
        tb = traceback.format_exception(type(exc), exc, exc.__traceback__)
        with self._lock:
            rec = self._open
        if rec is None:
            rec = self.begin_cycle()
        with self._lock:
            # A guard layer (close_session in a finally) may have moved
            # the phase on after the failure — the pinned failing phase
            # wins.
            failed = rec.pop("failed_phase", None)
            if failed:
                rec["phase"] = failed
            rec["error"] = f"{type(exc).__name__}: {exc}"
            rec["traceback"] = tb
            self.error_count += 1
        return self.end_cycle(ok=False)

    def end_cycle(self, ok: bool = True, **extra) -> Optional[dict]:
        # Coerce outside the lock (can be arbitrarily nested), commit
        # atomically: a dump taken mid-commit must see the cycle either
        # still open or in the ring — never in neither.
        extra = {key: _jsonable(value) for key, value in extra.items()}
        with self._lock:
            rec = self._open
            if rec is None:
                return None
            self._open = None
            rec["t_end"] = time.time()
            rec["ok"] = bool(ok)
            rec.update(extra)
            self.last_cycle_ts = rec["t_end"]
            self._ring.append(rec)
        return rec

    # -- dumping ------------------------------------------------------------

    def snapshot(self) -> List[dict]:
        with self._lock:
            records = list(self._ring)
            open_rec = self._open
            if open_rec is not None:
                # Copy one level deep (phases_ms keeps being written by
                # the cycle thread) while still under the lock.
                open_rec = {
                    k: (dict(v) if isinstance(v, dict) else v)
                    for k, v in open_rec.items()
                }
                open_rec["in_flight"] = True
        if open_rec is not None:
            records.append(open_rec)
        return records

    def dump(self, reason: str = "on-demand") -> dict:
        out = {
            "type": "flightrecorder",
            "version": DUMP_VERSION,
            "reason": reason,
            "pid": os.getpid(),
            "dumped_at": time.time(),
            "started_at": self.started_at,
            "capacity": self.capacity,
            "cycle_errors": self.error_count,
            "records": _jsonable(self.snapshot()),
        }
        # Trajectory context rides along with the per-cycle forensics:
        # the newest telemetry rollup windows (obs/telemetry.py) say
        # whether the dumped cycles sit on a flat line or a trend.
        try:
            from .telemetry import TELEMETRY

            if TELEMETRY.cycles_observed:
                out["telemetry"] = _jsonable(
                    TELEMETRY.snapshot(recent_raw=32, recent_windows=64)
                )
        except Exception:  # pragma: no cover - dump must never fail
            logger.exception("telemetry embed in flight dump failed")
        # Placement-latency context: the ledger's engagement summary
        # (stage p99s, per-queue p99, requeue counters) + audit-ring
        # meta ride along, so an error dump answers "were pods waiting,
        # and how long" without a second endpoint scrape.
        try:
            from .latency import AUDIT, LEDGER

            if LEDGER.enabled and LEDGER.stamped:
                out["latency"] = _jsonable({
                    **LEDGER.summary(), "audit": AUDIT.meta(),
                })
        except Exception:  # pragma: no cover - dump must never fail
            logger.exception("latency embed in flight dump failed")
        return out

    def dump_json(self, reason: str = "on-demand") -> str:
        """Canonical JSON (sorted keys) of the whole ring."""
        return json.dumps(self.dump(reason), sort_keys=True)

    def dump_to(self, path: str, reason: str = "on-demand") -> str:
        parent = os.path.dirname(os.path.abspath(path))
        os.makedirs(parent, exist_ok=True)
        # Write-then-rename: dumps are picked up by pollers (the
        # SIGUSR1 workflow watches the directory for the dump name)
        # which must never see a half-written file. The scratch name is
        # a dotfile carrying neither the reason nor the target name so
        # name-based watchers cannot match it.
        tmp = os.path.join(
            parent,
            f".flightdump-{os.getpid()}-{threading.get_ident()}.tmp",
        )
        with open(tmp, "w") as f:
            f.write(self.dump_json(reason) + "\n")
        os.replace(tmp, path)
        return path

    def dump_on_error(self, directory: Optional[str] = None) -> Optional[str]:
        """Error-path dump: write to ``directory`` (default
        ``KBT_FLIGHT_DIR``) when one is configured; the ring keeps the
        record regardless."""
        directory = directory or os.environ.get(FLIGHT_DIR_ENV)
        if not directory:
            return None
        with self._lock:
            seq = self._seq
        path = os.path.join(
            directory, f"flight-{os.getpid()}-err-{seq}.json"
        )
        try:
            self.dump_to(path, reason="cycle-error")
        except OSError:
            logger.exception("flight-recorder error dump failed")
            return None
        logger.error("flight recorder dumped to %s", path)
        return path

    def reset(self) -> None:
        with self._lock:
            self._ring.clear()
            self._open = None
            self._seq = 0
            self.error_count = 0
            self.last_cycle_ts = None


RECORDER = FlightRecorder()


def install_sigusr1(directory: Optional[str] = None) -> bool:
    """SIGUSR1 → dump the global recorder to ``directory`` (default
    ``KBT_FLIGHT_DIR``, falling back to the process cwd). Returns False
    on platforms/threads where the handler cannot be installed."""

    def _dump():
        target = directory or os.environ.get(FLIGHT_DIR_ENV) or "."
        path = os.path.join(
            target, f"flight-{os.getpid()}-sigusr1-{int(time.time())}.json"
        )
        try:
            RECORDER.dump_to(path, reason="sigusr1")
            logger.info("flight recorder dumped to %s (SIGUSR1)", path)
        except OSError:
            logger.exception("SIGUSR1 flight dump failed")

    def _handler(signum, frame):  # pragma: no cover - exercised via kill
        # The handler runs ON the interrupted main thread, which may be
        # holding the recorder's (non-reentrant) lock mid-cycle — dump
        # from a fresh thread so the handler returns immediately and
        # the lock drains normally.
        threading.Thread(
            target=_dump, name="flight-sigusr1-dump", daemon=True
        ).start()

    try:
        signal.signal(signal.SIGUSR1, _handler)
        return True
    except (ValueError, OSError, AttributeError):
        # Non-main thread or platform without SIGUSR1.
        return False
