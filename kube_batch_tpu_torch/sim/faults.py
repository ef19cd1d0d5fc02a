"""Deterministic fault injection.

Spec grammar (doc/design/simulator.md): comma-separated
``kind:probability`` terms, e.g. ``"bind:0.05,node-flap:0.02"``.

| kind           | seam | effect |
|----------------|------|--------|
| ``bind``       | Binder wrapper | bind side effect raises; the cache's resync path re-pends the task |
| ``node-flap``  | pre-cycle      | node removed (pods killed + recreated Pending), returns after a seeded 1-4 cycles |
| ``node-death`` | mid-cycle      | node doomed for the cycle: every bind to it fails AND the first one deletes the node under the in-flight batch; permanent |
| ``evict``      | pre-cycle      | one seeded Running pod deleted (external eviction race); recreated Pending |
| ``solver``     | per-cycle env  | forces ``KBT_SOLVER=native`` for the cycle (accelerator-backend failure → native fallback) |
| ``crash``      | action shim    | in-cycle EXCEPTION injection: a raising action is prepended for the cycle; the SAME process absorbs it through the guarded-cycle error backoff and keeps scheduling. NOT a crash analog for process death — see ``leader-kill`` |
| ``leader-kill``| cluster endpoint | PROCESS-death analog: the leader is hard-stopped at a seeded cut point (``pre-solve`` / ``post-solve-pre-drain`` / ``mid-bind-drain`` / ``mid-close``, sim/failover.py) — nothing fences, nothing unwinds, its surviving writes stay in the cluster; a successor instance takes the lease and runs journal recovery (cache/recovery.py) |
| ``solver-exc`` | device-fault hook | the device-solve materialization raises for the cycle; the containment ladder must re-solve on a lower rung |
| ``solver-hang``| device-fault hook | the device-solve materialization outsleeps the solve budget; the fetch deadline must abandon it and drop to native |
| ``backend-loss``| device-fault hook | device solves AND the breaker's canary probe raise for a seeded 1-4 cycles (device lost); the breaker must hold open until the window closes, then re-promote |
| ``event-drop``  | watch interceptor | a Pod/Node watch event is never delivered — the mirror silently diverges; gap detection (relist) + the anti-entropy sweep must repair it |
| ``event-dup``   | watch interceptor | the event is delivered twice (same rv); the ingest guard must absorb the duplicate |
| ``event-reorder``| watch interceptor | delivery SWAP: stashed and delivered after the next event (flushed at the cycle barrier) |
| ``event-stale`` | watch interceptor | the object's previous event (older rv) is redelivered after the current one; the per-object guard must skip it |
| ``relist-fail`` | relist seam | list_for_relist raises a typed TransientClusterError (hash per call); the deterministic-jitter retry ladder absorbs it |
| ``solver-corrupt``| result tamper hook | a device rung's fetched assignment vector is rewritten to out-of-universe indices; post-solve validation must reject it before any bind dispatches |

The device-fault kinds are armed through
``solver.containment.set_device_fault_hook`` — the hook fires inside
the fetch-side materialization and the canary probe, exactly where a
real accelerator fault lands. All three are planned per cycle from the
seeded stream (the hang/raise DECISION is planned; only its wall-time
cost is real), so chaos runs replay bit-identically.

Two determinism regimes:
- cycle-planned faults (flap/death/evict/solver/crash) are drawn from a
  seeded stream in the sim thread BEFORE the cycle runs and recorded in
  the trace as fault events;
- per-bind failures are decided by a pure hash of
  ``(seed, pod uid, attempt#)`` — bind side effects run concurrently on
  the cache's worker pool, so a shared RNG stream there would make the
  decision order (hence the decisions) timing-dependent. A hash keyed
  on stable identities is thread-safe AND replays bit-identically.
"""

from __future__ import annotations

import random
import time
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

from ..utils.determinism import hash01 as _hash01
from ..utils.lockdebug import wrap_lock

# _hash01: stable uniform [0,1) from identity parts (independent of
# PYTHONHASHSEED and thread timing) — the shared implementation in
# utils/determinism, under the name the sim package (and
# sim/failover.py) has always used.

FAULT_KINDS = (
    "bind", "node-flap", "node-death", "evict", "solver", "crash",
    "solver-exc", "solver-hang", "backend-loss", "leader-kill",
    "event-drop", "event-dup", "event-reorder", "event-stale",
    "relist-fail", "solver-corrupt",
)

# Event-stream fault kinds fire at the WATCH DELIVERY seam (the
# injector's interceptor wraps the cache's watch handler via
# SimClusterEndpoint.add_watch) and only on Pod/Node events — the
# kinds the cache's relist + anti-entropy reconcile cover.
EVENT_FAULT_KINDS = (
    "event-drop", "event-dup", "event-reorder", "event-stale",
)
_EVENT_FAULT_TARGET_KINDS = frozenset({"Pod", "Node"})


class SimBindFailure(RuntimeError):
    """Injected bind failure (distinguishable from real bind errors)."""


class SimSolverFault(RuntimeError):
    """Injected device-solve failure (solver-exc / backend-loss; raised
    from the containment layer's device fault hook)."""


def parse_fault_spec(spec: str) -> Dict[str, float]:
    """``"bind:0.05,node-flap:0.02"`` → ``{"bind": 0.05, ...}``.
    Unknown kinds and out-of-range probabilities are hard errors — a
    typo silently injecting nothing would green-light a broken run."""
    out: Dict[str, float] = {}
    for term in (spec or "").split(","):
        term = term.strip()
        if not term:
            continue
        kind, sep, prob = term.partition(":")
        kind = kind.strip()
        if kind not in FAULT_KINDS:
            raise ValueError(
                f"unknown fault kind {kind!r} (known: {', '.join(FAULT_KINDS)})"
            )
        if not sep:
            raise ValueError(f"fault term {term!r} missing ':probability'")
        p = float(prob)
        if not 0.0 <= p <= 1.0:
            raise ValueError(f"fault probability out of [0,1]: {term!r}")
        out[kind] = p
    return out


class _FaultyBinder:
    """Binder wrapper: consults the injector before delegating."""

    def __init__(self, inner, injector: "FaultInjector"):
        self.inner = inner
        self.injector = injector

    def bind(self, pod, hostname: str) -> None:
        self.injector.on_bind(pod, hostname)
        self.inner.bind(pod, hostname)


class _CrashAction:
    """Prepended for a crash-fault cycle: run_once raises, the guarded
    scheduler loop must absorb it."""

    def name(self) -> str:
        return "sim-crash"

    def initialize(self) -> None:
        pass

    def un_initialize(self) -> None:
        pass

    def execute(self, ssn) -> None:
        raise SimBindFailure("injected scheduler-cycle crash")


class FaultInjector:
    def __init__(self, spec: Dict[str, float], seed: int):
        self.spec = dict(spec or {})
        self.seed = seed
        self.rng = random.Random(f"{seed}/faults")
        self._lock = wrap_lock("sim.faults")
        self._bind_attempts: Dict[str, int] = {}
        self._cycle = -1
        self._active = False
        # Mid-cycle death state: nodes doomed this cycle, and the
        # cluster handle used to delete them under the in-flight batch.
        self._doomed: Set[str] = set()
        self._cluster = None
        self._killed_mid_cycle: Set[str] = set()
        # Device-fault state (solver-exc / solver-hang / backend-loss):
        # the per-cycle armed fault and the backend-loss window's end
        # cycle (exclusive). Consulted by the containment-layer hook.
        self._solver_fault: Optional[str] = None
        self._backend_loss_until = -1
        # Result-corruption state (solver-corrupt): armed per cycle;
        # the containment tamper hook rewrites a device rung's fetched
        # assignment vector deterministically (hash of seed+cycle).
        self._corrupt_cycle = False
        # Event-stream fault state (event-drop/dup/reorder/stale,
        # relist-fail): armed for the whole cycle window (events apply
        # BEFORE the scheduling step, so arming rides
        # begin_cycle_events, not begin_cycle). Decisions are pure
        # hashes of (seed, fault, object key, per-key delivery seq) —
        # the bind-seam determinism regime: deliveries happen on
        # concurrent watch/side-effect threads, so a shared RNG stream
        # would be timing-dependent.
        self._events_active = False
        self._event_cycle = -1
        self._event_seq: Dict[Tuple[str, str], int] = {}
        self._reorder_stash: List[tuple] = []
        self._stale_memo: Dict[Tuple[str, str], tuple] = {}
        self._event_forensics: Dict[str, int] = {}
        self._dropped_events: List[Tuple[str, str, str]] = []
        self._relist_calls = 0
        self._relist_fails = 0
        self._wrapped_inner = None
        # Forensics drained by the harness each cycle. _bind_faults
        # counts the hash-decided failures only (doomed-node rejections
        # ride under their planned node-death event).
        self._bind_failures: List[Tuple[str, str]] = []
        self._bind_faults = 0

    # -- wiring --------------------------------------------------------------

    def wrap_binder(self, binder):
        if binder is None:
            return None
        return _FaultyBinder(binder, self)

    def attach_cluster(self, cluster) -> None:
        self._cluster = cluster

    crash_action_factory = _CrashAction

    # -- cycle planning (sim thread, deterministic stream) -------------------

    def plan_cycle(
        self,
        cycle: int,
        node_names: Sequence[str],
        running_pods: Sequence[str],
    ) -> List[dict]:
        """Draw this cycle's planned faults. Returns trace-ready fault
        event dicts; the harness applies them (and ``begin_cycle`` arms
        the bind/doom seams)."""
        rng, spec = self.rng, self.spec
        events: List[dict] = []
        p_flap = spec.get("node-flap", 0.0)
        if p_flap and node_names and rng.random() < p_flap:
            victim = rng.choice(sorted(node_names))
            down_for = rng.randint(1, 4)
            events.append({
                "kind": "node-flap", "name": victim, "down_for": down_for,
            })
        p_death = spec.get("node-death", 0.0)
        if p_death and node_names and rng.random() < p_death:
            victim = rng.choice(sorted(node_names))
            events.append({"kind": "node-death", "name": victim})
        p_evict = spec.get("evict", 0.0)
        if p_evict and running_pods and rng.random() < p_evict:
            victim = rng.choice(sorted(running_pods))
            events.append({"kind": "evict", "pod": victim})
        if spec.get("solver", 0.0) and rng.random() < spec["solver"]:
            events.append({"kind": "solver"})
        if spec.get("crash", 0.0) and rng.random() < spec["crash"]:
            events.append({"kind": "crash"})
        if (
            spec.get("solver-exc", 0.0)
            and rng.random() < spec["solver-exc"]
        ):
            events.append({"kind": "solver-exc"})
        if (
            spec.get("solver-hang", 0.0)
            and rng.random() < spec["solver-hang"]
        ):
            events.append({"kind": "solver-hang"})
        p_loss = spec.get("backend-loss", 0.0)
        if p_loss and rng.random() < p_loss:
            events.append({
                "kind": "backend-loss", "down_for": rng.randint(1, 4),
            })
        if (
            spec.get("solver-corrupt", 0.0)
            and rng.random() < spec["solver-corrupt"]
        ):
            events.append({"kind": "solver-corrupt"})
        p_kill = spec.get("leader-kill", 0.0)
        if p_kill and rng.random() < p_kill:
            from .failover import CUT_POINTS

            events.append({
                "kind": "leader-kill", "cut": rng.choice(CUT_POINTS),
            })
        return events

    # -- cycle arming --------------------------------------------------------

    def begin_cycle(self, cycle: int, doomed_nodes: Sequence[str] = (),
                    solver_fault: Optional[str] = None,
                    corrupt: bool = False) -> None:
        with self._lock:
            self._cycle = cycle
            self._active = True
            self._doomed = set(doomed_nodes)
            self._killed_mid_cycle = set()
            self._solver_fault = solver_fault  # "exc" | "hang" | None
            self._corrupt_cycle = bool(corrupt)

    def begin_cycle_events(self, cycle: int) -> None:
        """Arm the event-stream fault seam for this cycle's whole
        window (workload events apply BEFORE the scheduling step, so
        this is called ahead of :meth:`begin_cycle`)."""
        with self._lock:
            self._events_active = True
            self._event_cycle = cycle
            self._relist_calls = 0

    def note_backend_loss(self, cycle: int, down_for: int) -> None:
        """Open (or extend) a backend-loss window: device solves AND
        the breaker's canary probe fail until ``cycle + down_for``."""
        with self._lock:
            self._backend_loss_until = max(
                self._backend_loss_until, cycle + int(down_for)
            )

    def device_fault_hook(self):
        """The callable the harness installs via
        ``solver.containment.set_device_fault_hook``. Runs inside the
        device-solve materialization (``stage="solve"``) and the
        breaker canary (``stage="probe"``); raising fails the stage,
        outsleeping the budget simulates a hung device sync. Decisions are
        pure functions of the planned per-cycle state — thread-safe and
        replay-deterministic like the bind hash seam."""

        def hook(stage: str) -> None:
            with self._lock:
                if not self._active:
                    return
                loss = self._cycle < self._backend_loss_until
                fault = self._solver_fault
            if loss:
                raise SimSolverFault(
                    f"injected backend loss ({stage} stage)"
                )
            if stage != "solve" or fault is None:
                return
            if fault == "exc":
                raise SimSolverFault("injected device-solve exception")
            # "hang": outsleep the fetch deadline; the abandoned
            # deadline thread wakes later and its result is discarded.
            from ..solver.containment import solve_budget

            time.sleep(min(3.0 * solve_budget(), 5.0))

        return hook

    # -- event-stream fault seam (watch delivery interceptor) ----------------

    @staticmethod
    def _event_subject(kind: str, obj) -> str:
        if kind == "Pod":
            try:
                return obj.uid
            except AttributeError:
                pass
        return obj.metadata.name

    def _decide_event_fault_locked(self, kind: str, obj) -> Optional[str]:
        """One delivery's fault decision (caller holds the lock):
        drop > reorder > dup > stale, each drawn from a pure hash of
        (seed, fault, kind, key, per-key delivery seq)."""
        if not self._events_active or kind not in _EVENT_FAULT_TARGET_KINDS:
            return None
        key = self._event_subject(kind, obj)
        seq = self._event_seq.get((kind, key), 0)
        self._event_seq[(kind, key)] = seq + 1
        for fault in EVENT_FAULT_KINDS:
            p = self.spec.get(fault, 0.0)
            if p and _hash01(self.seed, fault, kind, key, seq) < p:
                return fault
        return None

    def wrap_watch_handler(self, handler: Callable) -> Callable:
        """Interpose the event-stream fault seam between the cluster's
        watch fan-out and the cache's ingest (installed by
        SimClusterEndpoint.add_watch). Deliveries run OUTSIDE the
        injector lock; only decisions and the reorder stash are locked.
        Faulted kinds: Pod/Node (the reconcile scope of the cache's
        relist + anti-entropy sweep)."""

        def intercept(kind: str, event_type: str, obj: object,
                      rv: Optional[int] = None) -> None:
            deliveries: List[tuple] = []
            with self._lock:
                # Any arriving event flushes a stashed reordered one —
                # delivered AFTER the current event (the swap).
                flush, self._reorder_stash = self._reorder_stash, []
                action = self._decide_event_fault_locked(kind, obj)
                memo_key = (kind, self._event_subject(kind, obj))
                prev = self._stale_memo.get(memo_key)
                if action == "event-drop":
                    self._event_forensics["event-drop"] = (
                        self._event_forensics.get("event-drop", 0) + 1
                    )
                    self._dropped_events.append(
                        (kind, event_type, memo_key[1])
                    )
                    deliveries = flush
                elif action == "event-reorder":
                    self._event_forensics["event-reorder"] = (
                        self._event_forensics.get("event-reorder", 0) + 1
                    )
                    self._reorder_stash = [(kind, event_type, obj, rv)]
                    deliveries = flush
                else:
                    deliveries = [(kind, event_type, obj, rv)] + flush
                    if action == "event-dup":
                        self._event_forensics["event-dup"] = (
                            self._event_forensics.get("event-dup", 0) + 1
                        )
                        deliveries.append((kind, event_type, obj, rv))
                    elif action == "event-stale" and prev is not None:
                        self._event_forensics["event-stale"] = (
                            self._event_forensics.get("event-stale", 0)
                            + 1
                        )
                        # Redeliver the key's PREVIOUS event (older rv)
                        # after the current one — a genuinely stale
                        # arrival the cache guard must absorb.
                        deliveries.append(prev)
                if action != "event-drop":
                    if event_type == "DELETED":
                        self._stale_memo.pop(memo_key, None)
                    else:
                        self._stale_memo[memo_key] = (
                            kind, event_type, obj, rv
                        )
            for d in deliveries:
                handler(*d)

        # Remember the inner target so flush_events can late-deliver a
        # stashed reordered event at the harness's barrier. The wrapper
        # takes 4 positional args so the versioning cluster's arity
        # detection hands it the rv stamp.
        self._wrapped_inner = handler
        return intercept

    def flush_events(self) -> None:
        """Deliver any stashed reordered event (the harness calls this
        at its deterministic barrier, before the settle drains — a
        reorder is a SWAP, never a loss)."""
        with self._lock:
            stashes, self._reorder_stash = self._reorder_stash, []
        handler = getattr(self, "_wrapped_inner", None)
        if handler is None:
            return
        for kind, event_type, obj, rv in stashes:
            handler(kind, event_type, obj, rv)

    def on_relist(self, kind: str) -> None:
        """The relist/anti-entropy read seam
        (SimClusterEndpoint.list_for_relist): while armed, each list
        call fails with a typed TransientClusterError by a pure hash of
        (seed, cycle, call#) — exercising the capped-exponential retry
        ladder while staying replay-deterministic. Per-call draws keep
        the full-ladder-failure probability at p^attempts, so a failed
        reconcile defers to the next sweep instead of wedging."""
        p = self.spec.get("relist-fail", 0.0)
        with self._lock:
            if not self._events_active or p <= 0:
                return
            call = self._relist_calls
            self._relist_calls += 1
            fail = _hash01(
                self.seed, "relist-fail", self._event_cycle, kind, call
            ) < p
            if fail:
                self._relist_fails += 1
        if fail:
            from ..cluster.errors import TransientClusterError

            raise TransientClusterError(
                f"injected relist failure ({kind} list, cycle "
                f"{self._event_cycle})"
            )

    def result_tamper_hook(self) -> Callable:
        """The callable installed via
        ``solver.containment.set_result_tamper_hook``: on a
        solver-corrupt cycle, rewrite a deterministic subset of a
        device rung's assignments to out-of-universe node indices — a
        silent device miscompute the post-solve validation layer must
        reject before bind dispatch."""

        def tamper(assigned: object) -> object:
            import numpy as np

            with self._lock:
                armed = self._active and self._corrupt_cycle
                cycle = self._cycle
            if not armed:
                return assigned
            arr = np.array(assigned, copy=True)
            sel = np.nonzero(np.asarray(arr) >= 0)[0]
            if sel.size == 0:
                return assigned
            k = min(4, int(sel.size))
            for j in range(k):
                pick = sel[
                    int(_hash01(self.seed, "corrupt", cycle, j)
                        * sel.size)
                ]
                arr[pick] = 2**30 - j  # far outside any node universe
            return arr

        return tamper

    def prune_bind_attempts(self, live_uids) -> int:
        """Drop per-pod bind-attempt counters for pods that no longer
        exist. A dead pod's counter is unreachable: its uid never binds
        again (the controller analog recreates killed pods under
        generation-suffixed names — ``<base>r<gen>``, harness
        ``_schedule_recreate`` — so a uid, once dead, never recurs),
        so pruning cannot change any fault decision — but
        keeping them leaks one dict entry + uid string per pod that
        ever bound, forever (the soak leak detector found this as a
        perfectly linear alloc_blocks climb). The harness calls this at
        a deterministic barrier with the settled cluster's live uids."""
        live = set(live_uids)
        with self._lock:
            dead = [u for u in self._bind_attempts if u not in live]
            for uid in dead:
                del self._bind_attempts[uid]
        return len(dead)

    def end_cycle(self) -> dict:
        """Disarm and drain the cycle's bind-seam + event-seam
        forensics. The harness flushes the reorder stash BEFORE its
        settle barrier, so by the time this runs no event is in
        flight."""
        with self._lock:
            self._active = False
            self._events_active = False
            self._corrupt_cycle = False
            failures = sorted(self._bind_failures)
            self._bind_failures = []
            killed = sorted(self._killed_mid_cycle)
            self._doomed = set()
            bind_faults = self._bind_faults
            self._bind_faults = 0
            event_faults = dict(sorted(self._event_forensics.items()))
            self._event_forensics = {}
            dropped = sorted(self._dropped_events)
            self._dropped_events = []
            relist_fails = self._relist_fails
            self._relist_fails = 0
        return {
            "bind_failures": failures,
            "nodes_killed": killed,
            "bind_faults": bind_faults,
            "event_faults": event_faults,
            "events_dropped": dropped,
            "relist_fails": relist_fails,
        }

    # -- the bind seam (side-effect pool threads) ----------------------------

    def on_bind(self, pod, hostname: str) -> None:
        key = f"{pod.namespace}/{pod.name}"
        with self._lock:
            if not self._active:
                return
            doomed = hostname in self._doomed
            kill_node = doomed and hostname not in self._killed_mid_cycle
            if kill_node:
                self._killed_mid_cycle.add(hostname)
            if not doomed:
                p = self.spec.get("bind", 0.0)
                if p <= 0:
                    # No bind faults configured: do not even track the
                    # attempt counter — it is only hash input, and a
                    # per-pod-uid dict entry on every bind is a leak
                    # over a 100k-cycle soak.
                    return
                attempt = self._bind_attempts.get(pod.uid, 0)
                self._bind_attempts[pod.uid] = attempt + 1
                fail = _hash01(
                    self.seed, "bind", pod.uid, attempt
                ) < p
                if not fail:
                    return
                # Planned faults (flap/death/evict/...) are counted by
                # the harness when it applies their events; only the
                # per-bind hash decisions are counted here.
                self._bind_faults += 1
            self._bind_failures.append((key, hostname))
        if kill_node and self._cluster is not None:
            # Delete the node UNDER the in-flight bind batch: the watch
            # event lands in the cache synchronously, so the remaining
            # staged binds of this node see it vanish mid-cycle.
            for node in self._cluster.list_objects("Node"):
                if node.name == hostname:
                    self._cluster.delete("Node", node)
                    break
        raise SimBindFailure(
            f"injected {'node-death' if doomed else 'bind'} failure: "
            f"{key} -> {hostname}"
        )
