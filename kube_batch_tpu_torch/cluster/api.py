"""The cluster substrate: an in-process API-server analog.

The reference's distributed "communication backend" is the Kubernetes API
server — informer watches in, REST writes out (SURVEY.md §2). tpu-batch is
standalone, so this module provides the same contract as a small event-sourced
object store:

- ``ClusterAPI``: list/watch objects, bind/delete pods, update statuses.
- ``InProcessCluster``: thread-safe implementation with watch fan-out and an
  optional kubelet simulation (bound pods transition to Running), which is the
  kubemark-analog used by e2e-style tests and the benchmark harness.

A real deployment would put a gRPC or k8s adapter behind the same interface;
the scheduler cache only ever sees ``ClusterAPI``.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional

from ..utils.lockdebug import wrap_lock
from ..api import (
    Node,
    Pod,
    PodCondition,
    PodGroup,
    PodPhase,
    PriorityClass,
    Queue,
)

# Watch event types.
ADDED = "ADDED"
MODIFIED = "MODIFIED"
DELETED = "DELETED"

# Watch handlers take (kind, event_type, obj) and MAY take a fourth
# ``rv`` parameter — the cluster's monotone event resourceVersion.
# Handlers declaring it (the scheduler cache's ingest guards) receive
# the stamp; three-parameter legacy handlers keep working (arity is
# detected once at add_watch time).
WatchHandler = Callable[[str, str, object], None]


def _handler_accepts_rv(handler) -> bool:
    """True iff ``handler`` can take the 4th resourceVersion argument.
    Detected ONCE at registration — calling with 4 args inside a
    try/except TypeError would mask genuine TypeErrors raised inside
    the handler body."""
    import inspect

    try:
        sig = inspect.signature(handler)
    except (TypeError, ValueError):  # builtins/partials without sigs
        return False
    positional = 0
    for param in sig.parameters.values():
        if param.kind in (
            param.POSITIONAL_ONLY, param.POSITIONAL_OR_KEYWORD
        ):
            positional += 1
        elif param.kind == param.VAR_POSITIONAL:
            return True
    return positional >= 4


class ClusterAPI:
    """Contract between the scheduler cache and the cluster substrate."""

    # Real-cluster implementations that expose try_acquire_lease /
    # release_lease (API-server-backed leader election) set this True;
    # the server then uses cross-host Lease election instead of the
    # single-host file lock.
    supports_lease_election = False

    # -- volume claims (optional capability) --------------------------------
    # Default: no claim store — volumes are instantly assumable and never
    # block binds. InProcessCluster overrides with a real assume/bind
    # lifecycle; KubeCluster implements the same contract against live
    # PVC phases (watch-fed store + GET fallback).

    def assume_pod_volumes(self, pod: Pod, hostname: str) -> bool:
        return True  # all claims "already bound"

    def wait_pod_volumes_bound(self, pod: Pod, timeout: float) -> bool:
        return True

    def release_pod_volumes(self, pod: Pod) -> None:
        return None

    # -- bind-intent journal (optional capability) --------------------------
    # Crash-tolerant failover seam (doc/design/robustness.md, failover
    # section): the scheduler appends a durable intent record per bind
    # batch BEFORE any bind side effect is issued, and marks each task
    # applied/failed as the side effects drain. A successor leader
    # reconciles the surviving intents against cluster truth
    # (cache/recovery.py) so a leader killed mid-bind-drain never
    # leaves a half-applied gang placement behind unclassifiable.
    # Implementations: in-memory store (InProcessCluster), Lease
    # annotation (KubeCluster). ``supports_bind_journal = False`` means
    # the cache skips journaling entirely.

    supports_bind_journal = False

    def append_bind_intent(self, record: dict) -> int:
        """Durably append one intent record; returns the journal's
        monotone sequence number assigned to it."""
        raise NotImplementedError

    def mark_bind_intent(self, seq: int, task_uid: str, outcome: str) -> bool:
        """Mark one task of intent ``seq`` as ``applied`` or ``failed``.
        Returns True iff the record became fully resolved (every task
        marked) and was pruned from the journal."""
        raise NotImplementedError

    def mark_bind_intents(self, seq: int, marks: Dict[str, str]) -> bool:
        """Batched :meth:`mark_bind_intent` for one bind chunk's drain.
        The default loops (in sorted order, for determinism); backends
        whose mark is a network CAS override with ONE round trip —
        per-task marks on a 50k-gang batch would otherwise be
        O(tasks x journal-size) API-server traffic."""
        resolved = False
        for uid in sorted(marks):
            resolved = self.mark_bind_intent(seq, uid, marks[uid]) or resolved
        return resolved

    def list_bind_intents(self) -> List[dict]:
        """All live intent records, ascending by seq."""
        raise NotImplementedError

    def remove_bind_intent(self, seq: int) -> None:
        raise NotImplementedError

    def remove_bind_intents(self, seqs) -> None:
        """Batched prune (the successor's end-of-recovery sweep). The
        default loops; network-CAS backends override with ONE round
        trip — per-record prune of a full journal is O(records) GET+PUT
        of the whole annotation otherwise."""
        for seq in sorted(seqs):
            self.remove_bind_intent(seq)

    # -- reads / watches ----------------------------------------------------

    def list_objects(self, kind: str) -> List[object]:
        raise NotImplementedError

    def list_for_relist(self, kind: str) -> List[object]:
        """The watch-gap recovery read path: semantically
        :meth:`list_objects`, but a DISTINCT seam so (a) backends can
        route it through their consistent-list machinery and (b) the
        simulator can inject typed transient failures (``relist-fail``)
        into exactly the reconciliation reads without perturbing its
        own bookkeeping lists. Raises the typed taxonomy
        (cluster/errors.py) on failure; callers retry via
        ``retry_transient``."""
        return self.list_objects(kind)

    def get_pod(self, namespace: str, name: str) -> Optional[Pod]:
        raise NotImplementedError

    def add_watch(self, handler: WatchHandler) -> None:
        raise NotImplementedError

    def remove_watch(self, handler: WatchHandler) -> None:
        """Detach a previously added watch handler (failover teardown:
        a dead scheduler instance must stop observing the cluster)."""
        raise NotImplementedError

    # -- writes (the scheduler's side effects) ------------------------------

    def bind_pod(self, pod: Pod, hostname: str) -> None:
        raise NotImplementedError

    def delete_pod(self, pod: Pod) -> None:
        raise NotImplementedError

    def update_pod_condition(self, pod: Pod, condition: PodCondition) -> None:
        raise NotImplementedError

    def update_pod_group(self, pg: PodGroup) -> None:
        raise NotImplementedError

    def record_event(self, obj: object, event_type: str, reason: str, message: str) -> None:
        raise NotImplementedError


class InProcessCluster(ClusterAPI):
    """Thread-safe in-memory cluster with watch fan-out.

    ``simulate_kubelet=True`` makes binds eventually set the pod Running
    (the hollow-node/kubemark analog, reference test/kubemark/)."""

    KINDS = (
        "Pod",
        "Node",
        "PodGroup",
        "Queue",
        "PriorityClass",
        "PodDisruptionBudget",
    )

    def __init__(
        self,
        simulate_kubelet: bool = True,
        kubelet_delay: float = 0.0,
    ):
        """``kubelet_delay`` > 0 makes the simulated kubelet flip a bound
        pod to Running after that many seconds (on a timer thread, with a
        second MODIFIED event) instead of instantly — gives the perf
        harness a measurable scheduled→running phase like kubemark's
        hollow kubelets."""
        self._lock = wrap_lock("cluster.store", threading.RLock())
        self._objects: Dict[str, Dict[str, object]] = {k: {} for k in self.KINDS}
        # (handler, accepts_rv) pairs — arity detected at registration.
        self._watchers: List[tuple] = []
        # Monotone event resourceVersion: bumped under the store lock on
        # every create/update/delete (incl. bind and kubelet-flip
        # writes), stamped onto the object's metadata, and delivered
        # with the watch event. The cache's ingest guards use it to
        # detect duplicate/stale/out-of-order delivery and — via the
        # strict +1 contiguity of the stream — DROPPED events
        # (doc/design/robustness.md, event-stream hardening).
        self._event_rv = 0
        self.simulate_kubelet = simulate_kubelet
        self.kubelet_delay = kubelet_delay
        self._kubelet_queue: "deque" = deque()
        self._kubelet_thread: Optional[threading.Thread] = None
        # Recorded cluster events (observability). Bounded: real
        # apiservers TTL events (1 h default); an unbounded list grows
        # one "Scheduled" tuple per bind forever — the soak leak
        # detector found exactly that over a 100k-cycle run.
        self.events: "deque" = deque(maxlen=4096)
        # PersistentVolumeClaim analog (reference wraps the k8s
        # volumebinder, cache.go:200-268): ns/name -> {"bound": bool,
        # "assumed_node": str|None}. A Condition signals binds so waiters
        # need no polling.
        self._claims: Dict[str, Dict] = {}
        self._claims_changed = threading.Condition(self._lock)
        # Bind-intent journal (crash-tolerant failover): seq -> record.
        # Records self-clean when fully marked (mark_bind_intent), so
        # the steady-state journal holds only in-flight batches.
        self._journal: Dict[int, dict] = {}
        self._journal_seq = 0
        self._journal_warned = False
        # Lease store ("ns/name" -> {holder, renew_ts, transitions}):
        # the KubeCluster coordination/v1 Lease analog, used by the
        # failover drill's lease handoff (sim/harness.py). The server's
        # elector selection keys on supports_lease_election, which
        # stays False here — single-host runs keep the file lease.
        self._leases: Dict[str, Dict] = {}

    # -- internal -----------------------------------------------------------

    @staticmethod
    def _key(obj) -> str:
        meta = obj.metadata
        return f"{meta.namespace}/{meta.name}" if meta.namespace else meta.name

    def _stamp_rv(self, obj) -> int:
        """Assign the next event resourceVersion (caller holds the
        store lock) and stamp it onto the object's metadata."""
        self._event_rv += 1
        rv = self._event_rv
        try:
            obj.metadata.resource_version = rv
        except AttributeError:  # pragma: no cover - foreign object
            pass
        return rv

    def _notify(self, kind: str, event_type: str, obj,
                rv: Optional[int] = None) -> None:
        for handler, accepts_rv in list(self._watchers):
            if accepts_rv:
                handler(kind, event_type, obj, rv)
            else:
                handler(kind, event_type, obj)

    # -- generic object store -----------------------------------------------

    def create(self, kind: str, obj) -> None:
        with self._lock:
            rv = self._stamp_rv(obj)
            self._objects[kind][self._key(obj)] = obj
        self._notify(kind, ADDED, obj, rv)

    def update(self, kind: str, obj) -> None:
        with self._lock:
            rv = self._stamp_rv(obj)
            self._objects[kind][self._key(obj)] = obj
        self._notify(kind, MODIFIED, obj, rv)

    def delete(self, kind: str, obj) -> None:
        with self._lock:
            rv = self._stamp_rv(obj)
            self._objects[kind].pop(self._key(obj), None)
        self._notify(kind, DELETED, obj, rv)

    def list_objects(self, kind: str) -> List[object]:
        with self._lock:
            return list(self._objects[kind].values())

    def current_resource_version(self) -> int:
        """The newest event resourceVersion assigned so far — the
        stream position a relist is consistent WITH (the cache resets
        its gap tracking to it after a successful reconcile)."""
        with self._lock:
            return self._event_rv

    def get_pod(self, namespace: str, name: str) -> Optional[Pod]:
        with self._lock:
            return self._objects["Pod"].get(f"{namespace}/{name}")

    def add_watch(self, handler: WatchHandler) -> None:
        with self._lock:
            self._watchers.append((handler, _handler_accepts_rv(handler)))

    def remove_watch(self, handler: WatchHandler) -> None:
        with self._lock:
            # Equality, not identity: handlers are usually bound
            # methods, and each attribute access mints a fresh bound-
            # method object (== compares __self__/__func__).
            self._watchers = [
                entry for entry in self._watchers if entry[0] != handler
            ]

    # -- bind-intent journal -------------------------------------------------

    supports_bind_journal = True

    # Soft cap on live (unresolved) records: the journal self-cleans on
    # resolution, so sustained growth past this means marks are not
    # draining — warn once rather than dropping recoverability.
    JOURNAL_SOFT_CAP = 4096

    def append_bind_intent(self, record: dict) -> int:
        with self._lock:
            self._journal_seq += 1
            seq = self._journal_seq
            rec = dict(record)
            rec["seq"] = seq
            rec.setdefault("marks", {})
            rec.setdefault("tasks", [])
            self._journal[seq] = rec
            over = (
                len(self._journal) > self.JOURNAL_SOFT_CAP
                and not self._journal_warned
            )
            if over:
                self._journal_warned = True
        if over:
            import logging

            logging.getLogger(__name__).warning(
                "bind-intent journal exceeds %d live records — bind "
                "side effects are not draining their applied/failed "
                "marks", self.JOURNAL_SOFT_CAP,
            )
        return seq

    def mark_bind_intent(self, seq: int, task_uid: str, outcome: str) -> bool:
        with self._lock:
            rec = self._journal.get(seq)
            if rec is None:
                return False
            rec["marks"][task_uid] = outcome
            if all(t["uid"] in rec["marks"] for t in rec["tasks"]):
                # Fully resolved: every task's bind either landed
                # (applied) or was reverted/resynced (failed) — nothing
                # left for a successor to classify. Self-cleaning keeps
                # the journal O(in-flight batches), not O(history).
                del self._journal[seq]
                return True
            return False

    def mark_bind_intents(self, seq: int, marks: Dict[str, str]) -> bool:
        """One lock hold for a whole chunk's marks."""
        if not marks:
            return False
        with self._lock:
            rec = self._journal.get(seq)
            if rec is None:
                return False
            rec["marks"].update(marks)
            if all(t["uid"] in rec["marks"] for t in rec["tasks"]):
                del self._journal[seq]
                return True
            return False

    def list_bind_intents(self) -> List[dict]:
        with self._lock:
            return [
                {**rec, "tasks": [dict(t) for t in rec["tasks"]],
                 "marks": dict(rec["marks"])}
                for _, rec in sorted(self._journal.items())
            ]

    def remove_bind_intent(self, seq: int) -> None:
        with self._lock:
            self._journal.pop(seq, None)

    def remove_bind_intents(self, seqs) -> None:
        with self._lock:
            for seq in seqs:
                self._journal.pop(seq, None)

    # -- leases (KubeCluster try_acquire_lease analog) -----------------------

    def try_acquire_lease(self, namespace: str, name: str, identity: str,
                          lease_duration: float,
                          now: Optional[float] = None) -> bool:
        """CAS on the in-memory lease: take when free, held by this
        identity, or expired (renew_ts older than lease_duration).
        ``now`` is injectable so the simulator's failover drill drives
        expiry on the virtual clock (replay-deterministic takeover)."""
        now = time.time() if now is None else now
        key = f"{namespace}/{name}"
        with self._lock:
            lease = self._leases.get(key)
            if lease is not None and lease["holder"] not in ("", identity):
                if now - lease["renew_ts"] <= lease_duration:
                    return False
            taken_over = lease is None or lease["holder"] != identity
            self._leases[key] = {
                "holder": identity,
                "renew_ts": now,
                "transitions": (
                    (lease["transitions"] + 1) if lease is not None
                    and taken_over else
                    (lease["transitions"] if lease is not None else 0)
                ),
            }
            return True

    def release_lease(self, namespace: str, name: str, identity: str) -> None:
        key = f"{namespace}/{name}"
        with self._lock:
            lease = self._leases.get(key)
            if lease is not None and lease["holder"] == identity:
                lease["holder"] = ""

    def read_lease(self, namespace: str, name: str) -> Optional[Dict]:
        with self._lock:
            lease = self._leases.get(f"{namespace}/{name}")
            return dict(lease) if lease is not None else None

    # -- typed conveniences ---------------------------------------------------

    def create_pod(self, pod: Pod) -> None:
        self.create("Pod", pod)

    def create_node(self, node: Node) -> None:
        self.create("Node", node)

    def create_pod_group(self, pg: PodGroup) -> None:
        self.create("PodGroup", pg)

    def create_queue(self, q: Queue) -> None:
        self.create("Queue", q)

    def create_priority_class(self, pc: PriorityClass) -> None:
        self.create("PriorityClass", pc)

    # -- scheduler side effects ---------------------------------------------

    def bind_pod(self, pod: Pod, hostname: str) -> None:
        """Analog of POST pods/<name>/binding (reference cache.go:121-135)."""
        with self._lock:
            stored = self._objects["Pod"].get(self._key(pod))
            if stored is None:
                raise KeyError(f"pod {self._key(pod)} not found")
            if stored.spec.node_name and stored.spec.node_name != hostname:
                raise ValueError(
                    f"pod {self._key(pod)} already bound to {stored.spec.node_name}"
                )
            stored.spec.node_name = hostname
            if self.simulate_kubelet and self.kubelet_delay <= 0:
                stored.status.phase = PodPhase.RUNNING
            rv = self._stamp_rv(stored)
        self._notify("Pod", MODIFIED, stored, rv)
        if self.simulate_kubelet and self.kubelet_delay > 0:
            self._enqueue_kubelet_start(self._key(stored))

    def _enqueue_kubelet_start(self, key: str) -> None:
        """Queue a delayed Pending→Running flip on ONE shared worker
        thread (a Timer per bind would put thousands of thread spawns
        inside the latency the perf harness measures)."""
        deadline = time.monotonic() + self.kubelet_delay
        with self._lock:
            self._kubelet_queue.append((deadline, key))
            if self._kubelet_thread is None or not self._kubelet_thread.is_alive():
                self._kubelet_thread = threading.Thread(
                    target=self._kubelet_loop, daemon=True,
                    name="hollow-kubelet",
                )
                self._kubelet_thread.start()

    def _kubelet_loop(self) -> None:
        while True:
            with self._lock:
                if not self._kubelet_queue:
                    # Hand off under the lock: clearing _kubelet_thread
                    # BEFORE the thread exits means a concurrent enqueue
                    # cannot observe a dying-but-still-alive worker and
                    # skip the restart (which would strand the final
                    # Pending→Running flip until the next bind).
                    self._kubelet_thread = None
                    return
                deadline, key = self._kubelet_queue[0]
            delay = deadline - time.monotonic()
            if delay > 0:
                time.sleep(delay)
            with self._lock:
                self._kubelet_queue.popleft()
                # Re-fetch: the pod may have been evicted/deleted while
                # the delay ran — a stale notify would resurrect it in
                # the scheduler cache as a RUNNING ghost.
                pod = self._objects["Pod"].get(key)
                if (
                    pod is None
                    or not pod.spec.node_name
                    or pod.status.phase != PodPhase.PENDING
                ):
                    continue
                pod.status.phase = PodPhase.RUNNING
                rv = self._stamp_rv(pod)
            self._notify("Pod", MODIFIED, pod, rv)

    def delete_pod(self, pod: Pod) -> None:
        """Analog of pod DELETE for eviction (reference cache.go:137-148)."""
        self.release_pod_volumes(pod)
        self.delete("Pod", pod)

    # -- volume claims (PV-controller analog, reference cache.go:200-268) ---

    def create_claim(self, namespace: str, name: str, bound: bool = False) -> None:
        with self._lock:
            self._claims[f"{namespace}/{name}"] = {
                "bound": bound, "assumed_node": None, "assumed_pod": None,
            }

    def set_claim_bound(self, namespace: str, name: str) -> None:
        """What the PV controller would do once a volume is provisioned."""
        with self._claims_changed:
            claim = self._claims.get(f"{namespace}/{name}")
            if claim is None:
                raise KeyError(f"claim {namespace}/{name} not found")
            claim["bound"] = True
            self._claims_changed.notify_all()

    def assume_pod_volumes(self, pod: Pod, hostname: str) -> bool:
        """Assume the pod's unbound claims onto ``hostname``; returns True
        iff every claim was ALREADY bound (the k8s AssumePodVolumes
        contract the reference relies on, cache.go:205-210). The same pod
        may re-assume a claim onto a different node (a later cycle chose
        elsewhere); only assumptions held by a DIFFERENT pod conflict."""
        with self._lock:
            all_bound = True
            for name in pod.spec.volume_claims:
                key = f"{pod.namespace}/{name}"
                claim = self._claims.get(key)
                if claim is None:
                    raise KeyError(f"claim {key} not found")
                if claim["bound"]:
                    continue
                all_bound = False
                holder = claim["assumed_pod"]
                if holder is not None and holder != pod.uid:
                    raise ValueError(
                        f"claim {key} already assumed by another pod on "
                        f"{claim['assumed_node']}"
                    )
                claim["assumed_node"] = hostname
                claim["assumed_pod"] = pod.uid
            return all_bound

    def release_pod_volumes(self, pod: Pod) -> None:
        """Drop this pod's claim assumptions (after a failed/timed-out
        bind, or when the pod is deleted) so another placement — or
        another pod — can assume them."""
        with self._lock:
            for name in pod.spec.volume_claims:
                claim = self._claims.get(f"{pod.namespace}/{name}")
                if claim is not None and claim["assumed_pod"] == pod.uid:
                    claim["assumed_node"] = None
                    claim["assumed_pod"] = None

    def wait_pod_volumes_bound(self, pod: Pod, timeout: float) -> bool:
        """Block until every claim of ``pod`` is bound, or ``timeout``
        elapses (the 30s bind wait of reference cache.go:260-268)."""
        deadline = time.monotonic() + timeout
        with self._claims_changed:
            while True:
                pending = [
                    name for name in pod.spec.volume_claims
                    if not self._claims.get(
                        f"{pod.namespace}/{name}", {"bound": False}
                    )["bound"]
                ]
                if not pending:
                    return True
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._claims_changed.wait(remaining)

    def update_pod_condition(self, pod: Pod, condition: PodCondition) -> None:
        with self._lock:
            stored = self._objects["Pod"].get(self._key(pod))
            if stored is None:
                return
            for i, c in enumerate(stored.status.conditions):
                if c.type == condition.type:
                    stored.status.conditions[i] = condition
                    break
            else:
                stored.status.conditions.append(condition)

    def update_pod_group(self, pg: PodGroup) -> None:
        with self._lock:
            rv = self._stamp_rv(pg)
            self._objects["PodGroup"][self._key(pg)] = pg
        self._notify("PodGroup", MODIFIED, pg, rv)

    def record_event(self, obj, event_type: str, reason: str, message: str) -> None:
        with self._lock:
            self.events.append((type(obj).__name__, self._key(obj), event_type, reason, message))
