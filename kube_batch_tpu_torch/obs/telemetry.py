"""Long-horizon telemetry: per-cycle time-series with rollup windows.

A copy of the reference's ``obs/telemetry.py``. The flight recorder,
spans and verdicts make a *single* cycle observable; this module watches
the *trajectory*. Every scheduling cycle
folds one small ``{key: float}`` sample — the flight-recorder record's
phase timings and solver attribution, plus resource-watermark probes
(host RSS, allocator blocks, CUDA memory allocated and reserved (read
only once CUDA is initialised), the bid-kernel build census
(``kernels.jit_compilation_count``), device-resident snapshot bytes, tracer/flight
ring occupancy and drops, metrics label-series cardinality, verdict
registry size, GC collection counts, per-queue fairness drift) — into:

- a **raw ring**: the last N per-cycle samples verbatim (fixed
  capacity, default 512), the "what just happened" view served by
  ``/debug/timeseries``;
- **rollup windows**: every W cycles the open window closes carrying
  count/sum/min/max and a quantile sketch per key (fixed window-ring
  capacity, oldest windows drop with a counter). Windows are what the
  soak-mode leak/drift detectors (``sim/soak.py``) fit trends over: a
  100k-cycle run at W=200 is 500 windows of a few hundred bytes each,
  so the full horizon stays resident at O(1) memory per cycle.

The enabled path is deliberately cheap — one dict of floats, one lock,
a handful of ``/proc`` and counter reads; the bench ``obs`` section
pins its cost against the same <1 %-of-an-idle-cycle budget as the span
tracer. ``KBT_TELEMETRY=0`` disables the scheduler feed entirely.

The quantile sketch is DDSketch-style (log-spaced buckets, relative
error <= ``alpha``): deterministic, mergeable, O(1) insert; it lives in
``obs/sketch.py``, shared with the placement-latency ledger.
"""

from __future__ import annotations

import logging
import math
import os
import time
import weakref
from collections import deque
from typing import Dict, List, Optional

from ..utils.lockdebug import witness_writes, wrap_lock
from .sketch import QuantileSketch

logger = logging.getLogger(__name__)

TELEMETRY_ENV = "KBT_TELEMETRY"            # "0" disables the feed
TELEMETRY_WINDOW_ENV = "KBT_TELEMETRY_WINDOW"      # cycles per window
TELEMETRY_WINDOWS_ENV = "KBT_TELEMETRY_WINDOWS"    # window ring capacity
DEFAULT_WINDOW_CYCLES = 64
DEFAULT_MAX_WINDOWS = 1024
DEFAULT_RAW_CAPACITY = 512
# Fairness probes are O(jobs) (aggregate sums + a water-fill, several
# ms at the 50k/500-job bench shape); amortize them across cycles —
# drift is a windowed-mean quantity, so sparse samples lose nothing
# but resolution (a 195-cycle soak window still gets ~3 samples).
FAIRNESS_EVERY = 64
# The non-O(1)/slow watermark probes — the /proc RSS read (hundreds of
# µs on some kernels) and the compiled-variant census — run every Nth
# cycle; the
# cheap counter reads run every cycle. Rollup windows tolerate sparse
# keys, so the amortized series just carries 1/N the samples (a
# 100k-cycle soak still gets ~1.5k points per slow series). Intervals
# sized so the whole enabled path stays under the 1% idle-cycle budget
# (bench obs telemetry_overhead_pct).
EXPENSIVE_EVERY = 64
# The cluster-total Resource sum is O(nodes); refresh it only when the
# node count changes or this many fairness probes have passed
# (allocatable changes without node add/remove are rare).
_NODE_TOTAL_REFRESH = 16


def telemetry_enabled_from_env() -> bool:
    return os.environ.get(TELEMETRY_ENV, "1") != "0"


class _KeyStats:
    __slots__ = ("count", "sum", "min", "max", "sketch")

    def __init__(self):
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        self.sketch = QuantileSketch()

    def add(self, v: float) -> None:
        self.count += 1
        self.sum += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v
        self.sketch.add(v)

    def to_dict(self) -> dict:
        s = self.sketch
        return {
            "count": self.count,
            "sum": round(self.sum, 6),
            "mean": round(self.sum / self.count, 6) if self.count else 0.0,
            "min": round(self.min, 6),
            "max": round(self.max, 6),
            "p50": round(s.quantile(0.5), 6),
            "p90": round(s.quantile(0.9), 6),
            "p99": round(s.quantile(0.99), 6),
        }


class Telemetry:
    """Per-cycle sample sink: raw ring + rollup windows (see module
    docstring). All mutation happens on the scheduler thread once per
    cycle; the lock exists for the HTTP/dump readers."""

    def __init__(
        self,
        window_cycles: Optional[int] = None,
        max_windows: Optional[int] = None,
        raw_capacity: int = DEFAULT_RAW_CAPACITY,
    ):
        if window_cycles is None:
            window_cycles = int(os.environ.get(
                TELEMETRY_WINDOW_ENV, DEFAULT_WINDOW_CYCLES
            ))
        if max_windows is None:
            max_windows = int(os.environ.get(
                TELEMETRY_WINDOWS_ENV, DEFAULT_MAX_WINDOWS
            ))
        self._lock = wrap_lock("obs.telemetry")
        self._cache_ref = None          # weakref to the fed SchedulerCache
        self._fair_state: dict = {}     # fairness probe memo (node total)
        self.configure(window_cycles, max_windows, raw_capacity)
        # KBT_LOCK_DEBUG=2 write-witness (no-op otherwise). configure()
        # re-arms are fine: it writes under the lock.
        witness_writes(self, "obs.telemetry", (
            "window_cycles", "max_windows", "raw_capacity", "_raw",
            "_windows", "_open", "_open_start", "_open_cycles",
            "cycles_observed", "windows_rolled", "windows_dropped",
            "_last_cycle",
        ))

    def configure(
        self,
        window_cycles: int,
        max_windows: Optional[int] = None,
        raw_capacity: Optional[int] = None,
    ) -> None:
        """(Re)size and reset — the soak harness calls this so a 100k
        run's windows all fit the ring."""
        with self._lock:
            self.window_cycles = max(1, int(window_cycles))
            if max_windows is not None:
                self.max_windows = max(2, int(max_windows))
            elif not hasattr(self, "max_windows"):
                self.max_windows = DEFAULT_MAX_WINDOWS
            if raw_capacity is not None:
                self.raw_capacity = max(2, int(raw_capacity))
            elif not hasattr(self, "raw_capacity"):
                self.raw_capacity = DEFAULT_RAW_CAPACITY
            self._raw: deque = deque(maxlen=self.raw_capacity)
            self._windows: deque = deque(maxlen=self.max_windows)
            self._open: Dict[str, _KeyStats] = {}
            self._open_start: Optional[int] = None
            self._open_cycles = 0
            self.cycles_observed = 0
            self.windows_rolled = 0
            self.windows_dropped = 0
            self._last_cycle: Optional[int] = None

    def reset(self) -> None:
        self.configure(self.window_cycles)

    # -- ingest --------------------------------------------------------------

    def observe_values(self, values: Dict[str, float],
                       cycle: Optional[int] = None) -> None:
        """Fold one cycle's sample dict in. ``cycle`` defaults to a
        running counter; the raw ring keeps the dict verbatim."""
        with self._lock:
            if cycle is None:
                cycle = (
                    self._last_cycle + 1
                    if self._last_cycle is not None
                    else self.cycles_observed
                )
            # Deferred roll: a full window is closed by the NEXT
            # cycle's first sample (or flush()), not by its own last
            # sample — ``annotate_cycle`` additions arrive after
            # ``observe_values`` for the same cycle and must land in
            # the window that cycle belongs to, boundary cycles
            # included.
            if self._open_cycles >= self.window_cycles:
                self._roll_locked(
                    self._last_cycle if self._last_cycle is not None
                    else cycle
                )
            self._last_cycle = cycle
            self.cycles_observed += 1
            if self._open_start is None:
                self._open_start = cycle
            self._raw.append({"cycle": cycle, **values})
            for key, v in values.items():
                stats = self._open.get(key)
                if stats is None:
                    stats = self._open[key] = _KeyStats()
                try:
                    stats.add(float(v))
                except (TypeError, ValueError):
                    continue
            self._open_cycles += 1

    def annotate_cycle(self, values: Dict[str, float]) -> None:
        """Merge extra keys into the OPEN window without advancing the
        cycle count (the simulator's post-cycle additions: invariant
        violations, placements — they land after run_once already fed
        the window)."""
        with self._lock:
            for key, v in values.items():
                stats = self._open.get(key)
                if stats is None:
                    stats = self._open[key] = _KeyStats()
                try:
                    stats.add(float(v))
                except (TypeError, ValueError):
                    continue
            if self._raw:
                self._raw[-1].update(values)

    def _roll_locked(self, end_cycle: int) -> None:
        if not self._open:
            self._open_start = None
            self._open_cycles = 0
            return
        if len(self._windows) == self._windows.maxlen:
            self.windows_dropped += 1
        # Closed windows are stored SERIALIZED (one str per window, not
        # ~40 key-dicts of floats): the telemetry layer watches for
        # leaks, so its own resident footprint must be negligible —
        # with object windows the ring itself was the largest residual
        # allocator growth a 100k-cycle soak saw. Readers parse on
        # demand (end-of-run detectors, HTTP snapshots — both rare).
        import json

        # _open_start is None when the window only ever saw
        # annotate_cycle content (e.g. every cycle in it errored before
        # the observe_values feed): anchor it to end_cycle so readers
        # doing midpoint arithmetic never meet a None.
        self._windows.append(json.dumps({
            "start_cycle": (
                self._open_start if self._open_start is not None
                else end_cycle
            ),
            "end_cycle": end_cycle,
            "cycles": self._open_cycles,
            "t": round(time.time(), 3),
            "keys": {k: s.to_dict() for k, s in self._open.items()},
        }))
        self.windows_rolled += 1
        self._open = {}
        self._open_start = None
        self._open_cycles = 0

    def flush(self) -> None:
        """Close the open window early (end of a soak run: the tail
        cycles — including a deferred full window and its post-cycle
        annotations — must reach the detectors)."""
        with self._lock:
            if self._open_cycles or self._open:
                self._roll_locked(
                    self._last_cycle if self._last_cycle is not None else 0
                )

    # -- the production feed -------------------------------------------------

    def observe_scheduler_cycle(self, rec: Optional[dict],
                                cache=None) -> Dict[str, float]:
        """The per-cycle entry point ``Scheduler.run_once`` calls:
        extract the flight record's numeric attribution, add watermark
        (and, amortized, fairness) probes, fold the sample in, and push
        the watermark gauges to Prometheus. Returns the sample (bench
        uses it)."""
        values: Dict[str, float] = {}
        if rec:
            e2e = rec.get("e2e_ms")
            if e2e is not None:
                values["e2e_ms"] = float(e2e)
            for phase, ms in (rec.get("phases_ms") or {}).items():
                values[f"phase_ms:{phase}"] = float(ms)
            solver = rec.get("solver") or {}
            for key in ("placed", "tasks", "rounds",
                        "device_bytes_shipped", "device_rows_patched"):
                v = solver.get(key)
                if v is not None:
                    values[f"solver:{key}"] = float(v)
            # Placement-quality card (obs/quality.py, attached before
            # end_cycle on the KBT_QUALITY_EVERY cadence) → quality:*
            # series; cycles without a card simply lack the keys
            # (rollup windows tolerate sparse series).
            quality = rec.get("quality")
            if quality:
                try:
                    from .quality import telemetry_values

                    values.update(telemetry_values(quality))
                except Exception:  # pragma: no cover - probes only
                    logger.exception("quality telemetry flatten failed")
        if cache is not None:
            self._cache_ref = weakref.ref(cache)
        values.update(collect_watermarks(
            cache=cache,
            expensive=self.cycles_observed % EXPENSIVE_EVERY == 0,
        ))
        # Placement-latency series (obs/latency.py): ledger occupancy
        # (the leak watermark) + per-queue p99 arrival→bind latency —
        # the series the soak drift detector bounds so a slow
        # scheduling-latency regression fails a soak instead of hiding.
        try:
            from .latency import LEDGER

            if LEDGER.enabled:
                values.update(LEDGER.telemetry_sample())
        except Exception:  # pragma: no cover - probes must never kill
            logger.exception("placement-latency telemetry probe failed")
        fairness_ran = False
        if cache is not None and self.cycles_observed % FAIRNESS_EVERY == 0:
            try:
                values.update(collect_fairness(cache, self._fair_state))
                fairness_ran = True
            except Exception:  # pragma: no cover - forensics only
                logger.exception("fairness probe failed")
        self.observe_values(values)
        with self._lock:
            # A concurrent configure() rebinds the rings; snapshot the
            # watermark inputs under the same lock every other reader
            # holds (kbtlint guarded-by).
            raw_occupancy = len(self._raw)
            windows_rolled = self.windows_rolled
        try:
            from .. import metrics

            metrics.update_telemetry_watermarks(
                values,
                raw_occupancy=raw_occupancy,
                windows_rolled=windows_rolled,
                fairness_ran=fairness_ran,
            )
        except Exception:  # pragma: no cover - metrics must never kill
            logger.exception("telemetry metrics export failed")
        return values

    def attached_cache(self):
        """The most recently fed SchedulerCache (HTTP probes), or None."""
        ref = self._cache_ref
        return ref() if ref is not None else None

    # -- read side -----------------------------------------------------------

    def windows(self) -> List[dict]:
        import json

        with self._lock:
            raw = list(self._windows)
        return [json.loads(w) for w in raw]

    def raw(self, limit: Optional[int] = None) -> List[dict]:
        with self._lock:
            records = list(self._raw)
        return records[-limit:] if limit else records

    def keys(self) -> List[str]:
        seen = set()
        for w in self.windows():
            seen.update(w["keys"])
        with self._lock:
            seen.update(self._open)
        return sorted(seen)

    def snapshot(self, recent_raw: int = 64,
                 recent_windows: Optional[int] = None) -> dict:
        """The ``/debug/timeseries`` payload (also embedded in flight
        dumps): config, counters, the rolled windows (all of them, or
        the newest ``recent_windows``), and the newest raw samples."""
        import json

        # Copy refs under the lock, parse outside it (like windows()):
        # json.loads over up to max_windows serialized strings takes
        # milliseconds, and the scheduler's per-cycle feed blocks on
        # the same lock.
        with self._lock:
            windows = list(self._windows)
            raw = list(self._raw)[-recent_raw:]
            open_keys = sorted(self._open)
            meta = {
                "window_cycles": self.window_cycles,
                "max_windows": self.max_windows,
                "raw_capacity": self.raw_capacity,
                "cycles_observed": self.cycles_observed,
                "windows_rolled": self.windows_rolled,
                "windows_dropped": self.windows_dropped,
            }
        if recent_windows is not None:
            windows = windows[-recent_windows:]
        return {
            "type": "telemetry",
            **meta,
            "open_window_keys": open_keys,
            "windows": [json.loads(w) for w in windows],
            "raw_recent": raw,
        }


# -- watermark probes --------------------------------------------------------

_PAGE_SIZE = os.sysconf("SC_PAGE_SIZE") if hasattr(os, "sysconf") else 4096


def _rss_bytes() -> Optional[float]:
    try:
        with open("/proc/self/statm") as f:
            return float(int(f.read().split()[1]) * _PAGE_SIZE)
    except (OSError, ValueError, IndexError):
        return None


def collect_watermarks(cache=None, expensive: bool = True) -> Dict[str, float]:
    """One sample of every resource watermark the soak detectors fit
    growth on. Everything is guarded: a probe that cannot run (no
    /proc, CUDA not initialised yet) is simply absent from the sample —
    detectors skip absent series. Nothing here *imports* heavy modules;
    probes only read state of subsystems already loaded.

    ``expensive=False`` skips the probes that are not O(1) counter
    reads (the /proc RSS read, the variant census) — the scheduler
    feed passes it on 63 of 64 cycles (``EXPENSIVE_EVERY``) to stay
    inside the 1% cycle budget; on-demand callers (/debug/vars, soak
    window boundaries) get the full set."""
    import gc
    import sys

    values: Dict[str, float] = {}
    if expensive:
        rss = _rss_bytes()
        if rss is not None:
            values["rss_bytes"] = rss
        # NOT an O(1) counter on modern CPython: walks the allocator's
        # segments, ~250 µs on a 50k-scale heap.
        values["alloc_blocks"] = float(sys.getallocatedblocks())
    try:
        values["gc_gen2_collections"] = float(
            gc.get_stats()[2]["collections"]
        )
    except (IndexError, KeyError, TypeError):  # pragma: no cover
        pass

    # Observability rings (self-watermarks: the recorder infrastructure
    # must not itself leak).
    from .flightrecorder import RECORDER
    from .tracer import TRACER

    values["tracer_ring"] = float(len(TRACER._events))
    values["tracer_dropped"] = float(TRACER.dropped)
    values["flight_ring"] = float(len(RECORDER._ring))

    if expensive:
        # Iterates every registered metric's label map (O(series)).
        try:
            from .. import metrics

            values["metrics_series"] = float(
                metrics.REGISTRY.series_count()
            )
        except Exception:  # pragma: no cover - registry drift
            pass
    try:
        from . import explain

        values["explain_verdicts"] = float(len(explain.all_verdicts()))
    except Exception:  # pragma: no cover
        pass

    # CUDA memory, read only when CUDA is already initialised (a probe
    # must never create a context).
    torch = sys.modules.get("torch")
    if torch is not None:
        try:
            if torch.cuda.is_initialized():
                values["cuda_memory_allocated_bytes"] = float(
                    torch.cuda.memory_allocated()
                )
                values["cuda_memory_reserved_bytes"] = float(
                    torch.cuda.memory_reserved()
                )
        except Exception:  # pragma: no cover - backend quirk
            pass
    if expensive and "kube_batch_tpu_torch.solver.kernels" in sys.modules:
        try:
            from ..solver.kernels import jit_compilation_count

            values["jit_cache_entries"] = float(jit_compilation_count())
        except Exception:  # pragma: no cover
            pass
    if cache is not None:
        dc = getattr(cache, "_torch_device_cache", None)
        if dc is not None:
            values["device_resident_bytes"] = float(
                sum(arr.nbytes for arr in dc.host.values())
            )
    # Carried-backlog depth (solver/warm.py): unplaced jobs the subset
    # solves are rotating through. A congested-but-keeping-up scheduler
    # holds this roughly flat; sustained growth means arrivals are
    # outpacing what the micro steady state retires — the soak growth
    # detector bounds the windowed slope.
    if cache is not None:
        ws = getattr(cache, "_warm_solve_state", None)
        if ws is not None and getattr(ws, "valid", False):
            values["carried_backlog_depth"] = float(len(ws.carried))
    return values


def collect_fairness(cache, state: Optional[dict] = None) -> Dict[str, float]:
    """Per-queue fairness drift: ``(allocated - deserved)`` on the
    dominant dimension, as a fraction of cluster capacity. Positive
    values mean the queue holds more than its water-filled deserved
    share; the soak detector bounds the windowed mean. Uses the
    maintained JobInfo aggregates (``allocated`` / ``total_request``)
    so the probe is O(jobs), and memoizes the O(nodes) cluster total in
    ``state`` keyed on the node count."""
    from ..api import Resource
    from .quality import water_fill

    state = state if state is not None else {}
    with cache.mutex:
        queues = {q.name: q.weight for q in cache.queues.values()}
        if len(queues) < 2:
            return {}
        n_nodes = len(cache.nodes)
        probes = state.get("probes", 0) + 1
        state["probes"] = probes
        if (
            state.get("n_nodes") != n_nodes
            or probes % _NODE_TOTAL_REFRESH == 1
            or "total" not in state
        ):
            total = Resource.empty()
            for node in cache.nodes.values():
                if node.node is not None and node.ready():
                    total.add(node.allocatable)
            state["total"] = total
            state["n_nodes"] = n_nodes
        total = state["total"]
        allocated = {q: Resource.empty() for q in queues}
        requests = {q: Resource.empty() for q in queues}
        for job in cache.jobs.values():
            if job.queue not in queues:
                continue
            allocated[job.queue].add(job.allocated)
            requests[job.queue].add(job.total_request)
    deserved = water_fill(total, queues, requests)
    out: Dict[str, float] = {}
    for q in sorted(queues):
        drift = 0.0
        for dim in total.resource_names():
            cap = total.get(dim)
            if cap <= 0:
                continue
            d = (allocated[q].get(dim) - deserved[q].get(dim)) / cap
            if abs(d) > abs(drift):
                drift = d
        out[f"fairness_drift:{q}"] = drift
    return out


TELEMETRY = Telemetry()
