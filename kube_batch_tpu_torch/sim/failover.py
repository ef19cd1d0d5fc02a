"""Leader-kill emulation: the process-death seam of the failover drill.

The `crash` fault injects an in-cycle EXCEPTION — the guarded loop
absorbs it and the same process retries. `leader-kill` models the
failure class PR 7 deliberately stopped at: the leader PROCESS dies
mid-flight, nothing fences, nothing unwinds, and whatever subset of
its dispatched side effects already reached the cluster is simply...
there. A successor must take the lease and reconcile
(cache/recovery.py).

In-process we cannot kill threads, so death is emulated at the one
place it is observable: the cluster boundary. Each scheduler instance
talks to the shared :class:`InProcessCluster` through its own
:class:`SimClusterEndpoint`; killing the leader arms a per-cut-point
write policy on its endpoint, and after the cycle the endpoint is
finalized (everything refused, watch detached) and the instance
discarded. The scheduler thread itself runs the cycle to completion —
every write a dead process "would have issued" is refused, so the
cluster-visible outcome is exactly a process that died at the cut
point, while the cycle stays deterministic and replayable.

Cut points and their write policies (doc/design/robustness.md):

| cut                   | journal append | binds        | applied marks | status writes |
|-----------------------|----------------|--------------|---------------|---------------|
| `pre-solve`           | refused        | refused      | refused       | refused       |
| `post-solve-pre-drain`| land           | refused      | refused       | refused       |
| `mid-bind-drain`      | land           | hash subset  | follow bind, hash subset dropped | refused |
| `mid-close`           | land           | land         | land          | refused       |

The mid-bind-drain subset is decided per pod by a pure
``blake2b(seed, cycle, uid)`` hash — the same determinism regime as
the `bind` fault seam: bind side effects run concurrently on the
cache's worker pool, so "first K then dead" would be timing-dependent,
while a hash-selected subset is an equally valid half-applied batch
and replays bit-identically. A slice of the landed binds additionally
loses its applied MARK (crash between bind and mark), exercising the
recovery table's "unmarked but bound = applied" row.
"""

from __future__ import annotations

import logging
import threading
from typing import List, Optional

from ..api import Pod, PodCondition, PodGroup
from ..cluster import ClusterAPI
from .faults import _hash01

logger = logging.getLogger(__name__)

# Seeded kill cut points, in cycle order.
CUT_POINTS = (
    "pre-solve", "post-solve-pre-drain", "mid-bind-drain", "mid-close",
)

# mid-bind-drain hash policy: h < _H_BIND_LANDS → bind + mark land;
# h < _H_MARK_LOST → bind lands, applied mark lost in the crash;
# else → the bind never left the dying process.
_H_BIND_LANDS = 0.40
_H_MARK_LOST = 0.60


class SimProcessDead(RuntimeError):
    """A write issued by a scheduler instance the drill has declared
    dead — in reality this instruction would never have executed."""


class SimClusterEndpoint(ClusterAPI):
    """One scheduler instance's connection to the shared cluster.

    Alive: pure delegation. Kill armed: per-operation policy above.
    Finalized (post-failover): every operation refuses — the process
    is gone; reads return empty so stray worker threads drain quietly.
    """

    supports_bind_journal = True

    def __init__(self, inner, seed: int, fault_injector=None):
        self.inner = inner
        self.seed = seed
        # Event-stream fault seam (sim/faults.py): when set, watch
        # handlers registered through this endpoint are wrapped in the
        # injector's delivery interceptor (drop/dup/reorder/stale), and
        # list_for_relist consults its relist-fail seam.
        self.fault_injector = fault_injector
        self._cut: Optional[str] = None
        self._kill_cycle = -1
        self._dead = False
        self._handlers: List = []
        # original handler -> the interceptor wrapper registered for it
        # (remove_watch is handed the original; see add_watch).
        self._wrapped: dict = {}
        # Deterministic forensics for the trace's failover block —
        # byte-compared at replay, and incremented from the cache's
        # CONCURRENT side-effect workers, so the += must be atomic
        # (a lost increment would read as replay divergence).
        self._count_lock = threading.Lock()
        self.binds_refused = 0
        self.marks_dropped = 0

    def _count_refused(self) -> None:
        with self._count_lock:
            self.binds_refused += 1

    def _count_mark_dropped(self) -> None:
        with self._count_lock:
            self.marks_dropped += 1

    # -- drill control -------------------------------------------------------

    def arm_kill(self, cut: str, cycle: int) -> None:
        if cut not in CUT_POINTS:
            raise ValueError(f"unknown leader-kill cut {cut!r}")
        self._cut = cut
        self._kill_cycle = cycle

    def finalize_death(self) -> None:
        """The instance is now fully dead: refuse everything and stop
        observing the cluster (a dead process holds no watch)."""
        self._dead = True
        for handler in self._handlers:
            try:
                self.inner.remove_watch(handler)
            except Exception:  # pragma: no cover - teardown best-effort
                logger.exception("failover watch detach failed")
        self._handlers = []

    # -- policy --------------------------------------------------------------

    def _bind_fate(self, uid: str) -> str:
        """'lands' | 'mark-lost' | 'refused' for one bind of the kill
        cycle (pure hash — see module docstring)."""
        h = _hash01(self.seed, "leader-kill", self._kill_cycle, uid)
        if h < _H_BIND_LANDS:
            return "lands"
        if h < _H_MARK_LOST:
            return "mark-lost"
        return "refused"

    def _refuse(self, what: str):
        raise SimProcessDead(
            f"dead leader (cut={self._cut}) cannot {what}"
        )

    @property
    def _killed(self) -> bool:
        return self._dead or self._cut is not None

    # -- reads / watches -----------------------------------------------------

    def list_objects(self, kind: str) -> list:
        if self._dead:
            return []
        return self.inner.list_objects(kind)

    def list_for_relist(self, kind: str) -> list:
        """The cache's reconcile-read seam: the injector's relist-fail
        fault raises a typed TransientClusterError here — the harness's
        own bookkeeping reads go through list_objects and never see
        it."""
        if self._dead:
            return []
        if self.fault_injector is not None:
            self.fault_injector.on_relist(kind)
        return self.inner.list_objects(kind)

    def current_resource_version(self) -> int:
        return self.inner.current_resource_version()

    def get_pod(self, namespace: str, name: str) -> Optional[Pod]:
        if self._dead:
            return None
        return self.inner.get_pod(namespace, name)

    def add_watch(self, handler: object) -> None:
        registered = handler
        if self.fault_injector is not None:
            registered = self.fault_injector.wrap_watch_handler(handler)
            # remove_watch gets the ORIGINAL handler back; remember
            # which wrapper was registered for it, or the detach would
            # silently match nothing and the watch would keep firing.
            self._wrapped[handler] = registered
        self._handlers.append(registered)
        self.inner.add_watch(registered)

    def remove_watch(self, handler: object) -> None:
        registered = self._wrapped.pop(handler, handler)
        try:
            self._handlers.remove(registered)
        except ValueError:
            pass
        self.inner.remove_watch(registered)

    # -- binds ---------------------------------------------------------------

    def bind_pod(self, pod: Pod, hostname: str) -> None:
        if self._dead or self._cut in ("pre-solve", "post-solve-pre-drain"):
            self._count_refused()
            self._refuse(f"bind {pod.namespace}/{pod.name}")
        if self._cut == "mid-bind-drain":
            if self._bind_fate(pod.uid) == "refused":
                self._count_refused()
                self._refuse(f"bind {pod.namespace}/{pod.name}")
        self.inner.bind_pod(pod, hostname)

    def delete_pod(self, pod: Pod) -> None:
        # Evictions of a killed leader silently never execute (the
        # caller's success/failure branches are both artifacts of a
        # process that no longer exists; its mirror is discarded).
        if self._killed:
            return
        self.inner.delete_pod(pod)

    # -- status writes (dropped at every cut: the process died before
    # its close-phase write-backs could land) --------------------------------

    def update_pod_condition(self, pod: Pod, condition: PodCondition) -> None:
        if self._killed:
            return
        self.inner.update_pod_condition(pod, condition)

    def update_pod_group(self, pg: PodGroup) -> None:
        if self._killed:
            return
        self.inner.update_pod_group(pg)

    def record_event(self, obj: object, event_type: str, reason: str,
                     message: str) -> None:
        if self._killed:
            return  # forensics-only channel; drop quietly
        self.inner.record_event(obj, event_type, reason, message)

    # -- volumes -------------------------------------------------------------

    def assume_pod_volumes(self, pod: Pod, hostname: str) -> bool:
        if self._dead:
            return True
        return self.inner.assume_pod_volumes(pod, hostname)

    def release_pod_volumes(self, pod: Pod) -> None:
        if self._dead:
            return
        self.inner.release_pod_volumes(pod)

    def wait_pod_volumes_bound(self, pod: Pod, timeout: float) -> bool:
        if self._dead:
            return False
        return self.inner.wait_pod_volumes_bound(pod, timeout)

    # -- bind-intent journal -------------------------------------------------

    def append_bind_intent(self, record: dict) -> int:
        # pre-solve dies before dispatch reaches the journal; every
        # other cut dies after the synchronous append landed.
        if self._dead or self._cut == "pre-solve":
            self._refuse("append bind intent")
        return self.inner.append_bind_intent(record)

    def mark_bind_intent(self, seq: int, task_uid: str,
                         outcome: str) -> bool:
        if self._dead or self._cut in (
            "pre-solve", "post-solve-pre-drain"
        ):
            # Dropped, not raised: a dead process's mark simply never
            # executed — the intent stays open for recovery.
            self._count_mark_dropped()
            return False
        if self._cut == "mid-bind-drain":
            fate = self._bind_fate(task_uid)
            if fate == "mark-lost" and outcome == "applied":
                # The bind landed but the process died before the
                # applied mark — recovery must classify from truth.
                self._count_mark_dropped()
                return False
            if fate == "refused":
                # Its bind was refused as dead; the 'failed' mark the
                # side-effect error path now tries to write would never
                # have executed either.
                self._count_mark_dropped()
                return False
        return self.inner.mark_bind_intent(seq, task_uid, outcome)

    def list_bind_intents(self) -> list:
        if self._dead:
            return []
        return self.inner.list_bind_intents()

    def remove_bind_intent(self, seq: int) -> None:
        if self._killed:
            return  # a dead leader prunes nothing
        self.inner.remove_bind_intent(seq)

    # -- leases (delegated; the harness drives takeover explicitly) ----------

    def try_acquire_lease(self, *args: object, **kwargs: object) -> bool:
        if self._killed:
            self._refuse("renew lease")
        return self.inner.try_acquire_lease(*args, **kwargs)

    def release_lease(self, *args: object, **kwargs: object) -> None:
        if self._killed:
            # Process death releases nothing — that is the point: the
            # successor must wait out the TTL.
            return
        return self.inner.release_lease(*args, **kwargs)
