"""Runtime lock-order race harness (``KBT_LOCK_DEBUG=1``) and
guarded-write witness (``KBT_LOCK_DEBUG=2``).

The static half of the story — ``tools/kbtlint``'s lock-order and
guarded-by passes — proves ordering and lock ownership over the sites
it can resolve; this module asserts them over the acquisitions and
writes that actually HAPPEN. With ``KBT_LOCK_DEBUG=1`` the project's
named locks are wrapped in order-asserting proxies:

- every ``A held while acquiring B`` acquisition records the edge
  ``A→B`` with the traceback of its first witness;
- acquiring ``A`` while holding ``B`` after ``B→A`` was ever observed
  raises :class:`LockOrderViolation` carrying BOTH acquisition
  tracebacks — forensics that otherwise take a production deadlock
  to obtain;
- acquiring anything while holding a **leaf** lock (the cache fence
  lock) raises immediately — the fence path must never join a lock
  queue, because it runs precisely when a wedged cycle may be
  deadlocked holding the mutex;
- re-acquiring a held non-reentrant ``Lock`` raises instead of
  deadlocking silently.

``KBT_LOCK_DEBUG=2`` keeps everything level 1 does and additionally
arms the **write-witness**: shared-state classes register their
lock-guarded attributes at the end of ``__init__`` via
:func:`witness_writes` (same named-lock identities as ``wrap_lock``),
and every subsequent ``obj.attr = ...`` of a registered attribute on a
thread NOT holding the named lock raises
:class:`GuardedWriteViolation` with the writing site — the runtime
twin of kbtlint's guarded-by inference, catching the unguarded writes
the static pass cannot resolve (dynamic dispatch, exec'd plugins).
``KBT_LOCK_WITNESS_SAMPLE=N`` checks every Nth guarded write (default
1 = all) when the full check is too hot for a soak.

Off by default and zero-cost when off: ``wrap_lock`` returns the raw
lock and ``witness_writes`` is a no-op unless the env flag is set at
construction time. The chaos/micro smoke suites run with
``KBT_LOCK_DEBUG=2`` (Makefile), so every injected fault storm doubles
as a lock-order AND write-ownership soak. Violations are additionally
collected in :data:`VIOLATIONS` for harness-level assertions.

Condition variables: pass a wrapped lock to ``threading.Condition`` —
the proxy implements ``_release_save``/``_acquire_restore``/
``_is_owned``, so ``wait()`` keeps the held-stack bookkeeping exact
across the release/reacquire pair.
"""

from __future__ import annotations

import os
import threading
import traceback
from typing import Dict, List, Tuple

LOCK_DEBUG_ENV = "KBT_LOCK_DEBUG"

# Locks that must be leaves: nothing may be acquired while one is held
# (mirrors tools/kbtlint/lock_order.LEAF_LOCK_ATTRS).
LEAF_LOCKS = frozenset({"cache.fence_lock"})

_MAX_VIOLATIONS = 100


class LockOrderViolation(AssertionError):
    """Two named locks were acquired in both orders (or a leaf lock
    was held across another acquisition). Message carries the
    tracebacks of both acquisition sites."""


class GuardedWriteViolation(AssertionError):
    """A registered lock-guarded attribute was written by a thread not
    holding its named lock (``KBT_LOCK_DEBUG=2``). Message carries the
    writing site."""


# (held_name, acquired_name) -> formatted traceback of first witness
_edges: Dict[Tuple[str, str], str] = {}
_edges_lock = threading.Lock()  # raw on purpose: the meta-lock
_tls = threading.local()

VIOLATIONS: List[str] = []


def level() -> int:
    raw = os.environ.get(LOCK_DEBUG_ENV, "0")
    try:
        return max(0, int(raw))
    except ValueError:
        return 0


def enabled() -> bool:
    return level() >= 1


def witness_enabled() -> bool:
    return level() >= 2


def reset() -> None:
    """Clear recorded edges/violations and the witness sample cache
    (tests; each harness run starts from an empty order history)."""
    with _edges_lock:
        _edges.clear()
        del VIOLATIONS[:]
    _witness_sample_cached[0] = 0


def _held() -> List[List]:
    held = getattr(_tls, "held", None)
    if held is None:
        held = _tls.held = []
    return held


def _site() -> str:
    # Drop the lockdebug frames themselves: the caller wants to see
    # WHO acquired, not the proxy plumbing.
    frames = traceback.format_stack()[:-3]
    return "".join(frames[-12:])


def _violate(message: str, exc_type=LockOrderViolation) -> None:
    if len(VIOLATIONS) < _MAX_VIOLATIONS:
        VIOLATIONS.append(message)
    raise exc_type(message)


def _check_order(name: str, reentrant: bool) -> None:
    """Order assertions for acquiring ``name`` with the current held
    stack; called BEFORE blocking on the real lock so a would-be
    deadlock surfaces as an exception, not a hang."""
    held = _held()
    for entry in held:
        if entry[0] == name:
            if reentrant:
                return  # re-entry: no new edges
            _violate(
                f"self-deadlock: non-reentrant lock {name!r} "
                f"re-acquired by the thread already holding it\n"
                f"second acquisition:\n{_site()}"
            )
    if not held:
        return  # nothing held: no ordering to assert
    # Steady state must stay CHEAP: a bind storm nests
    # cache.mutex→cluster.store thousands of times per cycle, so the
    # stack capture (the expensive part) only happens for a new edge's
    # first witness or an actual violation — re-walking a known edge
    # costs two dict lookups.
    for entry in held:
        held_name = entry[0]
        if held_name in LEAF_LOCKS:
            _violate(
                f"leaf-lock violation: acquiring {name!r} while "
                f"holding leaf lock {held_name!r} (the fence path must "
                f"never join a lock queue)\nacquisition:\n{_site()}"
            )
        edge = (held_name, name)
        reverse = (name, held_name)
        with _edges_lock:
            reverse_site = _edges.get(reverse)
            known = edge in _edges
        if reverse_site is not None:
            _violate(
                f"lock-order violation: {held_name!r} held while "
                f"acquiring {name!r}, but the opposite order was "
                f"observed earlier\n--- this acquisition "
                f"({held_name} -> {name}):\n{_site()}\n--- first "
                f"acquisition of the reverse order ({name} -> "
                f"{held_name}):\n{reverse_site}"
            )
        if not known:
            site = _site()
            with _edges_lock:
                _edges.setdefault(edge, site)


def _push(name: str) -> None:
    held = _held()
    for entry in held:
        if entry[0] == name:
            entry[1] += 1
            return
    held.append([name, 1])


def _pop(name: str) -> None:
    held = _held()
    for i in range(len(held) - 1, -1, -1):
        if held[i][0] == name:
            held[i][1] -= 1
            if held[i][1] <= 0:
                del held[i]
            return


class _OrderAssertingLock:
    """Proxy over a Lock/RLock asserting acquisition order."""

    _reentrant = False

    def __init__(self, name: str, inner):
        self._name = name
        self._inner = inner

    def acquire(self, blocking: bool = True, timeout: float = -1):
        _check_order(self._name, self._reentrant)
        got = self._inner.acquire(blocking, timeout)
        if got:
            _push(self._name)
        return got

    def release(self) -> None:
        self._inner.release()
        _pop(self._name)

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    # -- Condition integration (threading.Condition duck-typing) ----------

    def _release_save(self):
        held = _held()
        count = 0
        for entry in held:
            if entry[0] == self._name:
                count = entry[1]
                break
        for i in range(len(held) - 1, -1, -1):
            if held[i][0] == self._name:
                del held[i]
                break
        save = self._release_save_inner()
        return (save, count)

    def _release_save_inner(self):
        inner_save = getattr(self._inner, "_release_save", None)
        if inner_save is not None:
            return inner_save()
        self._inner.release()
        return None

    def _acquire_restore(self, state) -> None:
        save, count = state
        _check_order(self._name, self._reentrant)
        inner_restore = getattr(self._inner, "_acquire_restore", None)
        if inner_restore is not None:
            inner_restore(save)
        else:
            self._inner.acquire()
        held = _held()
        held.append([self._name, max(1, count)])

    def _is_owned(self) -> bool:
        inner_owned = getattr(self._inner, "_is_owned", None)
        if inner_owned is not None:
            return inner_owned()
        # Plain Lock: owned iff this thread's held stack says so.
        return any(e[0] == self._name for e in _held())

    def locked(self):
        return self._inner.locked()

    def __repr__(self) -> str:
        return f"<OrderAssertingLock {self._name!r} over {self._inner!r}>"


class _OrderAssertingRLock(_OrderAssertingLock):
    _reentrant = True


def wrap_lock(name: str, lock=None):
    """Wrap ``lock`` (default: a new ``threading.Lock``) in an
    order-asserting proxy when ``KBT_LOCK_DEBUG=1``; return it raw
    otherwise. ``name`` is the stable identity order edges are keyed
    on — use dotted ``component.lock`` names."""
    if lock is None:
        lock = threading.Lock()
    if not enabled():
        return lock
    # An RLock reports its type via repr ("<unlocked _thread.RLock...");
    # isinstance against the factory types is version-fragile, so key
    # on the canonical constructors.
    if isinstance(lock, type(threading.RLock())):
        return _OrderAssertingRLock(name, lock)
    return _OrderAssertingLock(name, lock)


# -- guarded-write witness (KBT_LOCK_DEBUG=2) --------------------------------

WITNESS_SAMPLE_ENV = "KBT_LOCK_WITNESS_SAMPLE"

# (class, lock_name, attrs) -> generated witness subclass, so every
# instance of one registration shape shares one class object.
_witness_classes: Dict[tuple, type] = {}
_witness_counter = [0]  # guarded-write serial for sampling
_witness_sample_cached = [0]  # 0 = unresolved


def _witness_sample() -> int:
    if not _witness_sample_cached[0]:
        raw = os.environ.get(WITNESS_SAMPLE_ENV, "1")
        try:
            _witness_sample_cached[0] = max(1, int(raw))
        except ValueError:
            _witness_sample_cached[0] = 1
    return _witness_sample_cached[0]


def _holds(lock_name: str) -> bool:
    return any(entry[0] == lock_name for entry in _held())


def _witness_check(cls_name: str, lock_name: str, attr: str) -> None:
    if not witness_enabled():
        # A witnessed instance outlives an env change (tests lower the
        # level on teardown; the class swap is permanent) — the check
        # must track the LIVE level, not the level at registration.
        return
    _witness_counter[0] += 1
    if _witness_counter[0] % _witness_sample():
        return
    if _holds(lock_name):
        return
    _violate(
        f"guarded-write violation: {cls_name}.{attr} written without "
        f"holding {lock_name!r}\nwrite site:\n{_site()}",
        exc_type=GuardedWriteViolation,
    )


def witness_writes(obj, lock_name: str, attrs) -> None:
    """Arm the write-witness on ``obj``: any later ``obj.<attr> = ...``
    for ``attr`` in ``attrs`` on a thread not holding ``lock_name``
    raises :class:`GuardedWriteViolation`. No-op below
    ``KBT_LOCK_DEBUG=2``. Call at the END of ``__init__`` — writes
    before arming are construction (happens-before publication) and
    exempt by design."""
    if not witness_enabled():
        return
    cls = type(obj)
    key = (cls, lock_name, frozenset(attrs))
    wcls = _witness_classes.get(key)
    if wcls is None:
        guarded = frozenset(attrs)

        def __setattr__(self, name, value, _cls=cls, _g=guarded,
                        _lock=lock_name):
            if name in _g:
                _witness_check(_cls.__name__, _lock, name)
            _cls.__setattr__(self, name, value)

        wcls = type(
            f"{cls.__name__}(witnessed)", (cls,),
            {"__setattr__": __setattr__, "__module__": cls.__module__},
        )
        _witness_classes[key] = wcls
    obj.__class__ = wcls
