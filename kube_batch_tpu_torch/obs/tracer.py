"""Hierarchical span tracer with Chrome trace-event export.

Design constraints (ISSUE 5 tentpole):

- **Low overhead.** A disabled ``span()`` is one attribute read, one
  bool test, and a shared no-op context manager — no allocation, no
  clock read. An enabled span costs two ``perf_counter`` reads, one
  small dict, and one lock-free ``deque.append``. The bench's ``obs``
  section pins the enabled overhead against idle cycles.
- **Thread-aware hierarchy.** Each thread keeps its own span stack
  (``threading.local``), so spans opened on the overlap window's worker
  threads (native solve worker, cache side-effect pool, tensorize
  chunk pool) nest correctly. Cross-thread parentage — a worker span
  belonging to the scheduler thread's cycle — uses an explicit capture/
  adopt handshake: the submitting thread calls :meth:`Tracer.capture`
  and the worker wraps its work in ``with TRACER.adopt(token):``.
- **True concurrency in the export.** Events are Chrome trace "X"
  (complete) events keyed by real thread id, so Perfetto renders the
  overlapped solve/apply window as concurrent tracks; ``args`` carry
  the owning cycle and parent span id for programmatic assertions.

``KBT_TRACE_DIR`` enables tracing process-wide (the scheduler loop and
the guarded error path export there); bench ``--trace`` and sim
``--trace-out`` enable it explicitly for one run. ``KBT_TRACE_JAX=1``
additionally wraps solver-stage spans in
``torch.profiler.record_function`` so they show up inside
``torch.profiler`` traces.
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
from collections import deque
from typing import Optional

TRACE_DIR_ENV = "KBT_TRACE_DIR"
TRACE_JAX_ENV = "KBT_TRACE_JAX"
# Ring bound on buffered events: a week-long scheduler run with tracing
# left on must stay at a fixed memory footprint (oldest spans drop, the
# `dropped` stat records how many).
DEFAULT_CAPACITY = 200_000


def trace_dir_from_env() -> Optional[str]:
    """The process-wide trace directory, or None when tracing is off."""
    return os.environ.get(TRACE_DIR_ENV) or None


class _NullSpan:
    """Shared no-op context manager for the disabled path."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _NullSpan()


# Sentinel distinguishing "no adopted cycle override" from an adopted
# cycle that is legitimately None.
_UNSET = object()


class _Span:
    __slots__ = (
        "tracer", "name", "args", "sid", "parent", "cycle", "t0",
        "_prof_ctx",
    )

    def __init__(self, tracer: "Tracer", name: str, args, annotate):
        self.tracer = tracer
        self.name = name
        self.args = args
        self._prof_ctx = None
        if annotate and tracer.profiler_annotations:
            import torch

            self._prof_ctx = torch.profiler.record_function(name)

    def __enter__(self):
        t = self.tracer
        tls = t._tls
        stack = getattr(tls, "stack", None)
        if stack is None:
            stack = tls.stack = []
        self.sid = next(t._ids)
        self.parent = (
            stack[-1] if stack else getattr(tls, "adopted", 0)
        )
        # Owning cycle, resolved at ENTRY: an adopted worker span (and
        # anything nested under it) belongs to the cycle that queued
        # it, even when the scheduler thread has already advanced the
        # global cycle counter by the time the worker drains.
        override = getattr(tls, "adopted_cycle", _UNSET)
        self.cycle = t.cycle if override is _UNSET else override
        stack.append(self.sid)
        if self._prof_ctx is not None:
            self._prof_ctx.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        t = self.tracer
        if self._prof_ctx is not None:
            self._prof_ctx.__exit__(*exc)
        stack = t._tls.stack
        if stack and stack[-1] == self.sid:
            stack.pop()
        t._record(
            self.name, self.t0, t1, self.sid, self.parent, self.cycle,
            self.args,
        )
        return False


class _Adopt:
    """Context manager installing a cross-thread parent span id (and
    the owning cycle) captured by :meth:`Tracer.capture`."""

    __slots__ = ("tracer", "token", "_prev", "_prev_cycle")

    def __init__(self, tracer: "Tracer", token):
        self.tracer = tracer
        self.token = token

    def __enter__(self):
        tls = self.tracer._tls
        self._prev = getattr(tls, "adopted", 0)
        self._prev_cycle = getattr(tls, "adopted_cycle", _UNSET)
        token = self.token
        if isinstance(token, tuple):
            sid, cycle = token
        else:
            # Back-compat: a bare span id adopts the live cycle.
            sid, cycle = token, _UNSET
        tls.adopted = sid or 0
        tls.adopted_cycle = cycle
        return self

    def __exit__(self, *exc):
        tls = self.tracer._tls
        tls.adopted = self._prev
        tls.adopted_cycle = self._prev_cycle
        return False


class Tracer:
    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self.enabled = False
        self.capacity = capacity
        self.cycle = None              # stamped by the scheduler loop
        self.annotator = None          # e.g. the sim's virtual-time stamp
        self.profiler_annotations = os.environ.get(TRACE_JAX_ENV) == "1"
        self.spans_recorded = 0
        self._events: deque = deque(maxlen=capacity)
        self._thread_names: dict = {}
        self._tls = threading.local()
        self._ids = itertools.count(1)  # count().__next__ is atomic
        self._epoch = time.perf_counter()
        self._pid = os.getpid()

    # -- lifecycle ----------------------------------------------------------

    def enable(self, capacity: Optional[int] = None) -> None:
        if capacity is not None and capacity != self.capacity:
            self.capacity = capacity
            self._events = deque(self._events, maxlen=capacity)
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def reset(self) -> None:
        """Drop buffered events and stats (keeps enabled state).
        Thread names are kept: threads cache their tid in TLS and
        register the name only once, so clearing the map would leave
        later exports without thread_name metadata."""
        self._events.clear()
        self.spans_recorded = 0
        self.cycle = None

    # -- spans --------------------------------------------------------------

    def span(self, name: str, annotate: bool = False, **args):
        if not self.enabled:
            return _NULL
        return _Span(self, name, args or None, annotate)

    def begin_cycle(self, cycle) -> None:
        """Stamp the cycle id every subsequent span's args carry (worker
        threads included, via capture/adopt)."""
        self.cycle = cycle

    def _record(self, name, t0, t1, sid, parent, cycle, span_args) -> None:
        """Shared recording tail of ``_Span.__exit__`` and
        :meth:`complete`: annotator resolution, TLS-cached tid (the
        current_thread().name lookup costs microseconds and only needs
        to run once per thread), and the flat-tuple append — deque
        appends are atomic, so the hot path takes no lock; the Chrome
        event dicts are built at export time."""
        extra = self.annotator
        if extra is not None:
            try:
                extra = extra()
            except Exception:  # pragma: no cover - annotator bug
                extra = None
        tls = self._tls
        tid = getattr(tls, "tid", None)
        if tid is None:
            tid = tls.tid = threading.get_ident()
            self._thread_names[tid] = threading.current_thread().name
        self._events.append((
            name, t0, t1, tid, sid, parent, cycle, span_args, extra,
        ))
        self.spans_recorded += 1

    def complete(self, name: str, t0: float, t1: Optional[float] = None,
                 **args) -> None:
        """Record an already-timed interval as a span — for phases whose
        begin/end are measured with explicit ``perf_counter`` reads
        (the allocate_tpu apply/epilogue blocks). The current thread's
        innermost open span is taken as the parent."""
        if not self.enabled:
            return
        if t1 is None:
            t1 = time.perf_counter()
        tls = self._tls
        stack = getattr(tls, "stack", None)
        parent = stack[-1] if stack else getattr(tls, "adopted", 0)
        override = getattr(tls, "adopted_cycle", _UNSET)
        cycle = self.cycle if override is _UNSET else override
        self._record(name, t0, t1, next(self._ids), parent, cycle,
                     args or None)

    def capture(self):
        """Opaque token — (current span id, owning cycle) of THIS
        thread — for a worker to ``adopt`` so its spans nest under the
        submitting span AND keep the submitting cycle's stamp even when
        they drain after the scheduler thread advanced the counter
        (async binds deliberately drain in the NEXT cycle's overlap
        window)."""
        tls = self._tls
        override = getattr(tls, "adopted_cycle", _UNSET)
        cycle = self.cycle if override is _UNSET else override
        stack = getattr(tls, "stack", None)
        if stack:
            return (stack[-1], cycle)
        return (getattr(tls, "adopted", 0), cycle)

    def adopt(self, token) -> _Adopt:
        return _Adopt(self, token)

    # -- export -------------------------------------------------------------

    def _to_event(self, rec) -> dict:
        name, t0, t1, tid, sid, parent, cycle, span_args, extra = rec
        args = {"sid": sid, "parent": parent, "cycle": cycle}
        if span_args:
            args.update(span_args)
        if extra:
            args.update(extra)
        return {
            "name": name,
            "ph": "X",
            "ts": (t0 - self._epoch) * 1e6,
            "dur": (t1 - t0) * 1e6,
            "pid": self._pid,
            "tid": tid,
            "args": args,
        }

    def events(self) -> list:
        """Buffered spans as Chrome trace-event dicts (built lazily —
        the recording hot path stores flat tuples)."""
        return [self._to_event(rec) for rec in list(self._events)]

    @property
    def dropped(self) -> int:
        return max(0, self.spans_recorded - len(self._events))

    def export(self, path: str) -> str:
        """Write the buffered spans as a Chrome trace-event JSON file
        (load in Perfetto / chrome://tracing). Returns the path."""
        events = self.events()
        meta = [
            {
                "name": "thread_name",
                "ph": "M",
                "pid": self._pid,
                "tid": tid,
                "args": {"name": name},
            }
            for tid, name in sorted(self._thread_names.items())
        ]
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            json.dump(
                {"traceEvents": meta + events, "displayTimeUnit": "ms"},
                f,
            )
        return path


TRACER = Tracer()


def span(name: str, annotate: bool = False, **args):
    """Module-level convenience: ``with obs.span("solve"): ...``."""
    t = TRACER
    if not t.enabled:
        return _NULL
    return _Span(t, name, args or None, annotate)


def export_trace(path: Optional[str] = None, tag: str = "trace") -> Optional[str]:
    """Export the global tracer's buffer.

    With an explicit ``path``, write there. Otherwise write
    ``<KBT_TRACE_DIR>/<tag>-<pid>.json`` when the env dir is set, else
    do nothing (returns None)."""
    if path is None:
        trace_dir = trace_dir_from_env()
        if trace_dir is None:
            return None
        path = os.path.join(trace_dir, f"{tag}-{os.getpid()}.json")
    return TRACER.export(path)


def maybe_enable_from_env() -> bool:
    """Enable the global tracer iff ``KBT_TRACE_DIR`` is set (called by
    the scheduler/server startup paths). Returns the enabled state."""
    if trace_dir_from_env() is not None:
        TRACER.enable()
    return TRACER.enabled
