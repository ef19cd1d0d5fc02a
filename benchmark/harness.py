"""One run of one cell: the cluster built from the seed, the program's
loop (``kube_batch_tpu_torch.scheduler.Scheduler.run``) started on it,
the traffic played in an open loop for the window, then the drain, the
reference's judgement and the metrics.

The benchmark plays the API server and the kubelets:

- the running population is LISTed into the cache before the loop
  starts, already placed (a first fit from a rotating start node);
- the feeder thread delivers each pod arrival at its due time through
  the cache's event handlers, as an informer would, flips each bound
  pod to Running, and deletes it when its lifetime ends (the PodGroup
  with its last pod);
- the binder acknowledges each bind and stamps its time.

Every pod is timed from its due time, so a feeder that runs late adds to
the latency it measures; how late it ran is printed on its own line.
"""

from __future__ import annotations

import copy
import gc
import heapq
import math
import sys
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional

import numpy as np

from . import reference, traffic as traffic_mod

# Seconds the loop may take after the window to bind what was due in it.
GRACE_S = 60.0
# Seconds set-up waits for the warm-up burst to be bound.
WARMUP_TIMEOUT_S = 120.0
# Periods set-up waits after the warm-up burst is bound, before the
# window opens (the flips settle).
SETTLE_PERIODS = 2


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


# ---------------------------------------------------------------------------
# The cluster's side effects.
# ---------------------------------------------------------------------------


class Binder:
    """The bind endpoint: stamps each bind and hands it to the feeder."""

    def __init__(self, inbox: deque, clock: Callable[[], float]):
        self.inbox = inbox
        self.clock = clock

    def bind(self, pod, hostname: str) -> None:
        self.inbox.append(("ack", self.clock(), int(pod.metadata.uid[1:]),
                           hostname))


class Evictor:
    def __init__(self):
        self.evicted: List[str] = []

    def evict(self, pod) -> None:
        self.evicted.append(pod.metadata.uid)


class StatusUpdater:
    def update_pod_condition(self, pod, condition) -> None:
        return None

    def update_pod_group(self, pg) -> None:
        return None


class VolumeBinder:
    def allocate_volumes(self, task, hostname: str) -> None:
        task.volume_ready = True

    def bind_volumes(self, task) -> None:
        return None

    def release_volumes(self, task) -> None:
        return None


# ---------------------------------------------------------------------------
# The objects of the run.
# ---------------------------------------------------------------------------


def first_fit(alloc: np.ndarray, req: np.ndarray) -> np.ndarray:
    """Node of each pod: the first that fits, trying from node ``i % N``
    for pod ``i``, so the population spreads as a LeastRequested
    scheduler would leave it."""
    N = alloc.shape[0]
    free = alloc.astype(np.int64).copy()
    out = np.empty(req.shape[0], dtype=np.int64)
    for i in range(req.shape[0]):
        c, m = int(req[i, 0]), int(req[i, 1])
        j = i % N
        for _ in range(N):
            f = free[j]
            if f[0] >= c and f[1] >= m and f[2] >= 1:
                f[0] -= c
                f[1] -= m
                f[2] -= 1
                break
            j = (j + 1) % N
        else:
            raise ValueError("the running population does not fit")
        out[i] = j
    return out


class World:
    """Every object of the run, built in set-up, and the plain arrays the
    reference reads."""

    def __init__(self, config: dict, plan: traffic_mod.Plan):
        from kube_batch_tpu_torch import api

        a = config["node_allocatable"]
        N = config["nodes"]
        self.alloc = np.tile([a["cpu_m"], a["memory_mi"], a["pods"]], (N, 1))
        self.node_names = [f"n{j}" for j in range(N)]
        self.nodes = [
            api.Node(
                metadata=api.ObjectMeta(name=name, namespace=""),
                spec=api.NodeSpec(),
                status=api.NodeStatus(
                    allocatable=api.build_resource_list(
                        cpu=f"{a['cpu_m']}m", memory=f"{a['memory_mi']}Mi",
                        pods=a["pods"]),
                    capacity=api.build_resource_list(
                        cpu=f"{a['cpu_m']}m", memory=f"{a['memory_mi']}Mi",
                        pods=a["pods"])),
            )
            for name in self.node_names
        ]
        self.queues = [
            api.Queue(metadata=api.ObjectMeta(name=f"q{q}", namespace=""),
                      spec=api.QueueSpec(weight=q + 1))
            for q in range(config["queues"])
        ]
        gangs = plan.initial + plan.arrivals
        self.gangs = gangs
        sizes = np.array([len(g.cpu_m) for g in gangs], dtype=np.int64)
        self.gang_first = np.concatenate([[0], np.cumsum(sizes)])
        P = int(sizes.sum())
        self.pod_gang = np.repeat(np.arange(len(gangs)), sizes)
        self.req = np.stack([
            np.concatenate([g.cpu_m for g in gangs]),
            np.concatenate([g.mem_mi for g in gangs]),
        ], axis=1).astype(np.int64)
        self.lifetime = np.concatenate([g.lifetime for g in gangs])
        self.gang_min = np.array([g.min_member for g in gangs])
        n_init = sum(len(g.cpu_m) for g in plan.initial)
        self.n_initial = n_init
        self.initial_node = np.full(P, -1, dtype=np.int64)
        self.initial_node[:n_init] = first_fit(self.alloc, self.req[:n_init])

        containers: Dict[tuple, object] = {}
        key = api.GROUP_NAME_ANNOTATION_KEY
        self.pod_groups = [
            api.PodGroup(
                metadata=api.ObjectMeta(name=g.name, namespace="bench"),
                spec=api.PodGroupSpec(min_member=int(g.min_member),
                                      queue=f"q{g.queue}"))
            for g in gangs
        ]
        self.pods = []
        self.running = []
        for p in range(P):
            c, m = int(self.req[p, 0]), int(self.req[p, 1])
            cont = containers.get((c, m))
            if cont is None:
                cont = containers[(c, m)] = api.Container(
                    requests=api.build_resource_list(cpu=f"{c}m",
                                                     memory=f"{m}Mi"))
            node = int(self.initial_node[p])
            pod = api.Pod(
                metadata=api.ObjectMeta(
                    name=f"p{p}", namespace="bench", uid=f"p{p}",
                    annotations={key: gangs[self.pod_gang[p]].name}),
                spec=api.PodSpec(
                    node_name=self.node_names[node] if node >= 0 else "",
                    containers=[cont]),
                status=api.PodStatus(
                    phase=api.PodPhase.RUNNING if node >= 0
                    else api.PodPhase.PENDING),
            )
            self.pods.append(pod)
            if node >= 0:
                self.running.append(pod)
            else:
                twin = copy.copy(pod)
                twin.spec = copy.copy(pod.spec)
                twin.status = api.PodStatus(phase=api.PodPhase.RUNNING)
                self.running.append(twin)

    def reference_world(self) -> reference.World:
        return reference.World(self.alloc, self.req, self.pod_gang,
                               self.gang_min, self.initial_node)


# ---------------------------------------------------------------------------
# The feeder: API server and kubelets in one thread.
# ---------------------------------------------------------------------------


class Feeder(threading.Thread):
    """Delivers timed events to the cache: gang arrivals at their due
    time, a Running flip at each acknowledged bind, a delete at the end
    of each lifetime. Every delivery is logged for the reference."""

    def __init__(self, world: World, cache, inbox: deque, log_: list,
                 clock: Callable[[], float]):
        super().__init__(name="bench-feeder", daemon=True)
        self.world = world
        self.cache = cache
        self.inbox = inbox
        self.log = log_
        self.clock = clock
        self.heap: list = []
        self.seq = 0
        self.stop_event = threading.Event()
        self.lock = threading.Lock()
        P = len(world.pods)
        self.bound_at = np.full(P, np.nan)
        self.delivered_at = np.full(P, np.nan)
        self.bound_node = np.full(P, -1, dtype=np.int64)
        self.alive = np.diff(world.gang_first).astype(np.int64)
        self.node_index = {n: j for j, n in enumerate(world.node_names)}
        self.errors: List[str] = []

    def push(self, due: float, kind: str, arg) -> None:
        with self.lock:
            heapq.heappush(self.heap, (due, self.seq, kind, arg))
            self.seq += 1

    def schedule_gang(self, g: int, due: float) -> None:
        self.push(due, "gang", g)

    def schedule_initial_deletes(self, t0: float) -> None:
        w = self.world
        for p in range(w.n_initial):
            self.push(t0 + float(w.lifetime[p]), "delete", p)

    def _drain_inbox(self) -> None:
        while self.inbox:
            _, t, p, host = self.inbox.popleft()
            node = self.node_index.get(host, -1)
            self.log.append(("ack", t, p, node))
            if not math.isnan(self.bound_at[p]):
                continue
            self.bound_at[p] = t
            self.bound_node[p] = node
            self.push(t, "flip", p)
            self.push(t + float(self.world.lifetime[p]), "delete", p)

    def _deliver(self, kind: str, arg) -> None:
        w, cache = self.world, self.cache
        if kind == "gang":
            g = arg
            cache.add_pod_group(w.pod_groups[g])
            for p in range(w.gang_first[g], w.gang_first[g + 1]):
                cache.add_pod(w.pods[p])
                self.delivered_at[p] = self.clock()
        elif kind == "flip":
            p = arg
            twin = w.running[p]
            twin.spec.node_name = w.node_names[self.bound_node[p]]
            cache.update_pod(w.pods[p], twin)
        elif kind == "delete":
            p = arg
            self.log.append(("delete", self.clock(), p))
            cache.delete_pod(w.running[p])
            g = w.pod_gang[p]
            self.alive[g] -= 1
            if self.alive[g] == 0:
                cache.delete_pod_group(w.pod_groups[g])

    def run(self) -> None:
        while not self.stop_event.is_set():
            self._drain_inbox()
            now = self.clock()
            with self.lock:
                item = (heapq.heappop(self.heap)
                        if self.heap and self.heap[0][0] <= now else None)
                wait = (self.heap[0][0] - now) if self.heap else 0.005
            if item is None:
                self.stop_event.wait(min(max(wait, 0.0), 0.005))
                continue
            try:
                self._deliver(item[2], item[3])
            except Exception as exc:  # the cache refused an event: judged
                self.errors.append(f"{item[2]} {item[3]}: {exc!r}")

    def stop(self) -> None:
        self.stop_event.set()
        self.join(timeout=30.0)
        self._drain_inbox()


# ---------------------------------------------------------------------------
# What the benchmark records around the program's entry points.
# ---------------------------------------------------------------------------


class Recorder:
    """Times every cycle the loop runs (its own clock around
    ``run_once`` and ``run_micro``), keeps each cycle's action stats,
    and logs each assignment the cycle hands to the cache."""

    def __init__(self, log_: list, clock: Callable[[], float]):
        self.log = log_
        self.clock = clock
        self.cycles: List[dict] = []
        self.cycle = None

    def wrap_cycles(self, sched, stats: Optional[dict]) -> None:
        def observed(kind, inner):
            def cycle(*a, **k):
                cid = len(self.cycles)
                rec = {"id": cid, "kind": kind, "t0": self.clock()}
                self.cycles.append(rec)
                self.log.append(("cycle_start", rec["t0"], cid))
                self.cycle = cid
                try:
                    return inner(*a, **k)
                finally:
                    rec["t1"] = self.clock()
                    if stats is not None:
                        rec["stats"] = dict(stats)
                    self.log.append(("cycle_end", rec["t1"], cid))
                    self.cycle = None
            return cycle

        sched.run_once = observed("periodic", sched.run_once)
        sched.run_micro = observed("micro", sched.run_micro)

    def wrap_binds(self, cache) -> None:
        index = {}

        def note(task, host):
            t = self.clock()
            j = index.get(host)
            if j is None:
                j = index[host] = int(host[1:])
            self.log.append(("dispatch", t, self.cycle, int(task.uid[1:]), j))
            if self.cycle is not None:
                self.cycles[self.cycle]["placed"] = (
                    self.cycles[self.cycle].get("placed", 0) + 1)

        bind_batch, bind = cache.bind_batch, cache.bind

        def bind_batch_logged(task_infos, *a, **k):
            infos = list(task_infos)
            for ti in infos:
                note(ti, ti.node_name)
            return bind_batch(infos, *a, **k)

        def bind_logged(task_info, hostname):
            note(task_info, hostname)
            return bind(task_info, hostname)

        cache.bind_batch = bind_batch_logged
        cache.bind = bind_logged


# ---------------------------------------------------------------------------
# The run.
# ---------------------------------------------------------------------------


def mirror_usage(cache, world: World) -> np.ndarray:
    """The program's mirror of each node: CPU (m), memory (MiB), pods."""
    out = np.zeros((len(world.node_names), 3), dtype=np.int64)
    with cache.mutex:
        for j, name in enumerate(world.node_names):
            node = cache.nodes.get(name)
            if node is None:
                out[j] = -1
                continue
            out[j] = (round(node.used.milli_cpu),
                      round(node.used.memory / (1 << 20)), len(node.tasks))
    return out


def backlog(world: World, gangs: List[int], bound_at: np.ndarray,
            t0: float) -> List[int]:
    """At each storm's due time, the pods of the window's earlier
    arrivals still unbound: the loop keeps up when this does not grow
    from storm to storm."""
    pods = np.concatenate([
        np.arange(world.gang_first[g], world.gang_first[g + 1])
        for g in gangs]) if gangs else np.zeros(0, np.int64)
    due = np.array([world.gangs[world.pod_gang[p]].due for p in pods])
    late = np.nan_to_num(bound_at[pods] - t0, nan=np.inf)
    return [int(((due < d) & (late > d)).sum())
            for d in sorted(set(due.tolist()))]


def storm_latencies(world: World, gangs: List[int], lat: np.ndarray,
                    due_pods: np.ndarray) -> list:
    """Median, 95th percentile and most of each arrival time's pods, in
    ms: where a run's tail comes from."""
    due = np.array([world.gangs[world.pod_gang[p]].due for p in due_pods])
    out = []
    for d in sorted(set(due.tolist())):
        sel = lat[due == d]
        out.append([round(reference.percentile(sel, q), 1)
                    for q in (50, 95, 100)])
    return out


def wait_until(pred: Callable[[], bool], timeout: float,
               step: float = 0.02) -> bool:
    end = time.perf_counter() + timeout
    while time.perf_counter() < end:
        if pred():
            return True
        time.sleep(step)
    return pred()


def run(config: dict, traffic: dict, seed: int, seconds: float,
        device: str = "cuda", t_start: float = None,
        scheduler_factory=None, tracing=None) -> dict:
    """One run. Returns the raw record: timings, cycles, the reference's
    counts and the latencies; ``run.py`` turns it into the result line.

    ``scheduler_factory(cache, conf, period, device)`` replaces the
    program's scheduler (the control does); a traced run's ``tracing``
    (``trace.Tracing``) captures a bid launch in the warm-up, then traces
    the window."""
    clock = time.perf_counter
    t_start = clock() if t_start is None else t_start
    from kube_batch_tpu_torch.cache import SchedulerCache

    plan = traffic_mod.make_plan(traffic, config, seed, seconds)
    world = World(config, plan)
    t_built = clock()

    inbox: deque = deque()
    log_: list = []
    cache = SchedulerCache(
        binder=Binder(inbox, clock), evictor=Evictor(),
        status_updater=StatusUpdater(), volume_binder=VolumeBinder(),
    )
    for q in world.queues:
        cache.add_queue(q)
    for n in world.nodes:
        cache.add_node(n)
    for g in range(len(plan.initial)):
        cache.add_pod_group(world.pod_groups[g])
    for p in range(world.n_initial):
        cache.add_pod(world.pods[p])
    t_listed = clock()

    conf_path = traffic_mod.HERE / "configs" / config["policy"]
    conf = conf_path.read_text()
    period = float(config["schedule_period_s"])
    if scheduler_factory is None:
        from kube_batch_tpu_torch.actions import allocate_tpu
        from kube_batch_tpu_torch.scheduler import Scheduler

        if device == "cuda":
            from kube_batch_tpu_torch.solver import _build

            _build.build()
        sched = Scheduler(cache, scheduler_conf=conf, schedule_period=period,
                          device=device)
        stats = allocate_tpu.last_stats
    else:
        sched = scheduler_factory(cache, conf, period, device)
        stats = None
    recorder = Recorder(log_, clock)
    recorder.wrap_cycles(sched, stats)
    recorder.wrap_binds(cache)

    feeder = Feeder(world, cache, inbox, log_, clock)
    stop = threading.Event()
    loop = threading.Thread(target=sched.run, args=(stop,), name="bench-loop",
                            daemon=True)
    loop.start()
    feeder.start()
    if scheduler_factory is None:
        wait_until(lambda: any("t1" in c for c in recorder.cycles), 600.0)
    t_loop = clock()

    # Warm-up: one burst of the cell's own shape, bound before the window.
    first_storm = [g for g, gang in enumerate(world.gangs)
                   if g >= len(plan.initial) and gang.warmup]
    warm_pods = np.concatenate([
        np.arange(world.gang_first[g], world.gang_first[g + 1])
        for g in first_storm]) if first_storm else np.zeros(0, np.int64)
    if tracing is not None:
        tracing.arm()
    now = clock()
    for g in first_storm:
        feeder.schedule_gang(g, now)
    warmed = wait_until(
        lambda: not np.isnan(feeder.bound_at[warm_pods]).any(),
        WARMUP_TIMEOUT_S)
    time.sleep(SETTLE_PERIODS * period)

    # The window.
    if tracing is not None:
        tracing.begin()
    t0 = clock()
    setup_s = t0 - t_start
    feeder.schedule_initial_deletes(t0)
    n_arrivals = len(plan.initial) + len(first_storm)
    window_gangs = list(range(n_arrivals, len(world.gangs)))
    for g in window_gangs:
        feeder.schedule_gang(g, t0 + world.gangs[g].due)
    t_end = t0 + seconds
    time.sleep(max(0.0, t_end - clock()))
    t_closed = clock()
    if tracing is not None:
        tracing.end()
    due_pods = np.concatenate([
        np.arange(world.gang_first[g], world.gang_first[g + 1])
        for g in window_gangs]) if window_gangs else np.zeros(0, np.int64)
    wait_until(lambda: not np.isnan(feeder.bound_at[due_pods]).any(),
               GRACE_S, step=0.05)
    t_drained = clock()

    stop.set()
    loop.join(timeout=120.0)
    if hasattr(cache, "wait_for_side_effects"):
        cache.wait_for_side_effects(timeout=60.0)
    feeder.stop()
    mirror = mirror_usage(cache, world)
    memory_peak = None
    if device == "cuda":
        import torch

        torch.cuda.synchronize()
        memory_peak = int(torch.cuda.max_memory_allocated())
    cache.shutdown()
    loop_alive = loop.is_alive()

    # The window's own numbers, then the reference.
    busy = 0.0
    for c in recorder.cycles:
        if "t1" in c:
            busy += max(0.0, min(c["t1"], t_closed) - max(c["t0"], t0))
    due = np.array([t0 + world.gangs[world.pod_gang[p]].due
                    for p in due_pods])
    bound = feeder.bound_at[due_pods]
    lat = reference.latencies_ms(due, bound)
    late = feeder.delivered_at[due_pods] - due
    del sched
    gc.collect()
    t_ref = clock()
    counts = reference.replay(
        world.reference_world(), log_,
        np.concatenate([warm_pods, due_pods]).astype(np.int64), mirror)
    counts["event_errors"] = len(feeder.errors)
    return {
        "setup_s": setup_s,
        "t_start": t_start, "t0": t0, "t_closed": t_closed,
        "phases": {
            "build_s": t_built - t_start, "list_s": t_listed - t_built,
            "loop_start_s": t_loop - t_listed,
            "warmup_s": t0 - t_loop, "warmed": bool(warmed),
            "drain_s": t_drained - t_closed, "reference_s": clock() - t_ref,
        },
        "window_s": t_closed - t0,
        "busy_s": busy,
        "latency_ms": lat,
        "attempted": int(due_pods.size),
        "failed": int(np.isinf(lat).sum()),
        "feeder_late_s": {
            "mean": float(np.nanmean(late)) if late.size else 0.0,
            "max": float(np.nanmax(late)) if late.size else 0.0,
        },
        "event_errors": feeder.errors[:10],
        "loop_alive_after_stop": loop_alive,
        "evictions": len(cache.evictor.evicted),
        "cycles": recorder.cycles,
        "log": log_,
        "counts": counts,
        "memory_peak_bytes": memory_peak,
        "plan": {"pods_per_s": plan.pods_per_s, "storm_pods": plan.storm_pods,
                 "storms": len({world.gangs[g].due for g in window_gangs})},
        "backlog": backlog(world, window_gangs, feeder.bound_at, t0),
        "storm_ms": storm_latencies(world, window_gangs, lat, due_pods),
    }
