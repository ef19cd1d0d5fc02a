"""Cycle-scoped garbage-collection deferral.

A 50k-task apply allocates ~100k short-lived objects (events, clones,
dict entries); CPython's generational GC triggers multiple collections
inside the scheduling cycle, and full collections scan the ~1M-object
cluster mirror — a large share of the reference's cold 50k apply,
indistinguishable from "slow bookkeeping" until isolated.

The Go reference pays this as concurrent GC; CPython stops the world.
``deferred_gc()`` moves the cost off the critical path: collection is
disabled for the duration of the cycle and a bounded young-generation
collection runs on exit — in the scheduler's think-time gap, where a
pause costs nothing. Nesting is safe (only the outermost guard
re-enables); an exception still restores GC. GC state is process-wide,
so the guard is too: a lock serializes the depth/enable bookkeeping and
the OUTERMOST enter records whether GC was on, so concurrent guards
from different threads (e.g. scheduler cycle + side-effect worker)
cannot strand GC disabled.

The exit collection runs WHILE HOLDING the guard lock, decided by the
last exiter (an earlier collect-after-release re-check
only narrowed the race — a thread entering between the re-check and the
collection's end still ate a stop-the-world pause inside its
"GC-free" cycle). The trade: a concurrent guard entry now blocks for
the duration of the exit collection — bounded, young-generation-only,
and in the exiter's think time — which is strictly better than an
unbounded pause landing mid-cycle. The lock is reentrant so a finalizer
that somehow enters a guard during the collection cannot deadlock."""

from __future__ import annotations

import gc
import threading
from contextlib import contextmanager

from .lockdebug import wrap_lock

_lock = wrap_lock("utils.gc_guard", threading.RLock())
_depth = 0
_outer_was_enabled = False


@contextmanager
def deferred_gc(collect_generation: int = 1):
    """Disable GC for the guarded block; on exit, re-enable and run one
    ``gc.collect(collect_generation)`` (default: young+middle
    generations — bounded, does not scan the full mirror). Pass -1 to
    skip the exit collection entirely."""
    global _depth, _outer_was_enabled
    with _lock:
        if _depth == 0:
            _outer_was_enabled = gc.isenabled()
            if _outer_was_enabled:
                gc.disable()
        _depth += 1
    try:
        yield
    finally:
        with _lock:
            _depth -= 1
            if _depth == 0 and _outer_was_enabled:
                gc.enable()
                if collect_generation >= 0:
                    # Under the lock, by the last exiter (see module
                    # docstring): an entering thread waits here instead
                    # of collecting mid-cycle later.
                    gc.collect(collect_generation)
