"""Seeded synthetic workload generator.

Emits per-cycle EVENT DICTS (the trace's lingua franca — the harness
applies the same dicts whether they come from this generator or from a
replayed trace): gang arrivals drawn from a size/req mix, completions
after a seeded fully-running duration, and planned node add/drain
churn. All randomness flows from one named ``random.Random`` stream so
a (seed, spec) pair always yields the same event sequence; nothing here
reads the wall clock (timestamps are virtual-time values the harness
passes in).
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple


@dataclass
class WorkloadSpec:
    """Knobs of the synthetic cluster + arrival process."""

    nodes: int = 12
    node_cpu_m: int = 8000          # per-node allocatable millicores
    node_mem_mi: int = 16384        # per-node allocatable MiB
    queues: Dict[str, int] = field(
        default_factory=lambda: {"default": 1, "batch": 2}
    )
    # (gang size, weight) mix; min_member == size (full gangs).
    gang_sizes: Sequence[Tuple[int, float]] = (
        (1, 0.45), (2, 0.25), (4, 0.2), (8, 0.1)
    )
    # (cpu_m, mem_mi, weight) per-task request mix.
    reqs: Sequence[Tuple[int, int, float]] = (
        (500, 512, 0.6), (1000, 1024, 0.3), (2000, 2048, 0.1)
    )
    arrival_rate: float = 1.5       # expected job arrivals per cycle
    # Arrival profile (the high-arrival SLI mixes, obs/latency.py):
    # - "poisson":   seeded Poisson draws at arrival_rate (default);
    # - "sustained": exactly round(arrival_rate) jobs EVERY cycle — a
    #   flat firehose with no draw jitter (the 10k+ arrivals/s-
    #   equivalent sustained mix is this with a large rate);
    # - "burst":     Poisson base rate plus a spike of burst_size jobs
    #   every burst_every cycles (thundering-herd arrival waves).
    arrival_profile: str = "poisson"
    burst_every: int = 16           # cycles between burst spikes
    burst_size: int = 64            # jobs per burst spike
    duration_cycles: Tuple[int, int] = (4, 16)  # fully-running lifetime
    max_jobs_in_flight: int = 64    # arrival back-pressure bound
    # Planned churn: per-cycle probability of one node-add / node-drain
    # event (drain deletes the node; its pods are killed and recreated
    # as Pending by the harness — the replicaset-controller analog).
    node_add_rate: float = 0.0
    node_drain_rate: float = 0.0
    min_nodes: int = 4
    max_nodes: int = 64
    # -- serving mix (doc/design/serving.md). serving_rate == 0 keeps
    # the generator BYTE-IDENTICAL to the batch-only stream: no extra
    # rng draws, no label/annotation keys on any event (the batch-only
    # bit-parity contract rides on this).
    serving_rate: float = 0.0       # expected serving arrivals per cycle
    serving_sizes: Sequence[Tuple[int, float]] = (
        (2, 0.5), (4, 0.35), (8, 0.15)
    )
    serving_duration: Tuple[int, int] = (32, 128)  # long-lived deployments
    serving_slo_s: float = 2.0      # placement-latency target (virtual s)
    serving_floor_frac: float = 0.5  # replica floor = ceil(size * frac)
    serving_reserved_frac: float = 0.5  # P(job is spot-excluded)
    serving_gen_frac: float = 0.25  # P(job pins one TPU generation)
    serving_churn: float = 0.0      # per-cycle P(one replica churns)
    serving_queue: str = "serving"
    # Node classes (labels ride node-add events, only when a serving
    # mix is configured): generation/tier cycle deterministically over
    # the node index; reserved_frac of nodes are reserved, rest spot
    # (10% granularity).
    reserved_frac: float = 1.0
    node_generations: Sequence[str] = ("v5e", "v5p")
    node_tiers: int = 1

    def to_dict(self) -> dict:
        return {
            "nodes": self.nodes,
            "node_cpu_m": self.node_cpu_m,
            "node_mem_mi": self.node_mem_mi,
            "queues": dict(self.queues),
            "gang_sizes": [list(g) for g in self.gang_sizes],
            "reqs": [list(r) for r in self.reqs],
            "arrival_rate": self.arrival_rate,
            "arrival_profile": self.arrival_profile,
            "burst_every": self.burst_every,
            "burst_size": self.burst_size,
            "duration_cycles": list(self.duration_cycles),
            "max_jobs_in_flight": self.max_jobs_in_flight,
            "node_add_rate": self.node_add_rate,
            "node_drain_rate": self.node_drain_rate,
            "min_nodes": self.min_nodes,
            "max_nodes": self.max_nodes,
            "serving_rate": self.serving_rate,
            "serving_sizes": [list(s) for s in self.serving_sizes],
            "serving_duration": list(self.serving_duration),
            "serving_slo_s": self.serving_slo_s,
            "serving_floor_frac": self.serving_floor_frac,
            "serving_reserved_frac": self.serving_reserved_frac,
            "serving_gen_frac": self.serving_gen_frac,
            "serving_churn": self.serving_churn,
            "serving_queue": self.serving_queue,
            "reserved_frac": self.reserved_frac,
            "node_generations": list(self.node_generations),
            "node_tiers": self.node_tiers,
        }


def _poisson(rng: random.Random, lam: float) -> int:
    """Knuth inverse-transform Poisson sample off the seeded stream."""
    if lam <= 0:
        return 0
    import math

    limit = math.exp(-lam)
    k, p = 0, 1.0
    while True:
        p *= rng.random()
        if p <= limit:
            return k
        k += 1


def _weighted(rng: random.Random, mix: Sequence[tuple]):
    """Pick an entry from a (..., weight) mix."""
    total = sum(m[-1] for m in mix)
    x = rng.random() * total
    for m in mix:
        x -= m[-1]
        if x <= 0:
            return m
    return mix[-1]


class WorkloadGenerator:
    """Per-cycle event emitter; the harness feeds back observed state
    (which jobs are fully running, which nodes exist) through the
    ``running_since`` / ``node_names`` arguments — both derived from
    deterministic cluster state, so the feedback loop stays replayable."""

    def __init__(self, spec: WorkloadSpec, seed: int):
        self.spec = spec
        self.rng = random.Random(f"{seed}/workload")
        self._job_seq = 0
        self._node_seq = spec.nodes
        # name -> {"duration": d, "min_member": m}; jobs the generator
        # considers alive (created, not yet deleted).
        self.alive: Dict[str, dict] = {}
        self._pending_delete: List[str] = []

    # -- bootstrap -----------------------------------------------------------

    def _serving_enabled(self) -> bool:
        return self.spec.serving_rate > 0

    def initial_events(self) -> List[dict]:
        queues = dict(self.spec.queues)
        if self._serving_enabled():
            queues.setdefault(self.spec.serving_queue, 2)
        events = [
            {"kind": "queue-add", "name": name, "weight": weight}
            for name, weight in sorted(queues.items())
        ]
        events.extend(
            self._node_event(f"sim-node-{i:03d}", i)
            for i in range(self.spec.nodes)
        )
        return events

    def _node_event(self, name: str, index: int) -> dict:
        event = {
            "kind": "node-add",
            "name": name,
            "cpu_m": self.spec.node_cpu_m,
            "mem_mi": self.spec.node_mem_mi,
        }
        if self._serving_enabled():
            event["labels"] = self._node_labels(index)
        return event

    def _node_labels(self, index: int) -> Dict[str, str]:
        """Node-class labels (api/serving.py schema), a pure function
        of the node INDEX so churn-added nodes land in deterministic
        classes under replay."""
        from ..api import (
            CAPACITY_SPOT,
            CAPACITY_TYPE_LABEL_KEY,
            TOPOLOGY_TIER_LABEL_KEY,
            TPU_GENERATION_LABEL_KEY,
        )

        spec = self.spec
        labels: Dict[str, str] = {}
        if spec.node_generations:
            labels[TPU_GENERATION_LABEL_KEY] = spec.node_generations[
                index % len(spec.node_generations)
            ]
        if spec.node_tiers > 1:
            labels[TOPOLOGY_TIER_LABEL_KEY] = str(index % spec.node_tiers)
        reserved_slots = int(round(max(0.0, min(1.0, spec.reserved_frac)) * 10))
        if index % 10 >= reserved_slots:
            labels[CAPACITY_TYPE_LABEL_KEY] = CAPACITY_SPOT
        return labels

    # -- per cycle -----------------------------------------------------------

    def events_for_cycle(
        self,
        cycle: int,
        running_since: Dict[str, int],
        node_names: Sequence[str],
    ) -> List[dict]:
        spec, rng = self.spec, self.rng
        events: List[dict] = []

        # Deletions scheduled by last cycle's completions run first so
        # the job's Succeeded pods leave before new arrivals land.
        for name in self._pending_delete:
            events.append({"kind": "job-delete", "name": name})
            self.alive.pop(name, None)
        self._pending_delete = []

        # Completions: a job that has been fully running for its seeded
        # duration succeeds now and is deleted next cycle (exercising
        # the terminated-job cleanup path in between).
        for name in sorted(self.alive):
            since = running_since.get(name)
            if since is None:
                continue
            if cycle - since >= self.alive[name]["duration"]:
                events.append({"kind": "job-complete", "name": name})
                self._pending_delete.append(name)

        # Node churn (planned, seeded).
        n_nodes = len(node_names)
        if (
            spec.node_add_rate > 0
            and n_nodes < spec.max_nodes
            and rng.random() < spec.node_add_rate
        ):
            index = self._node_seq
            self._node_seq += 1
            events.append(self._node_event(f"sim-node-{index:03d}", index))
        if (
            spec.node_drain_rate > 0
            and n_nodes > spec.min_nodes
            and rng.random() < spec.node_drain_rate
        ):
            victim = rng.choice(sorted(node_names))
            events.append(
                {"kind": "node-remove", "name": victim, "reason": "drain"}
            )

        # Serving arrivals + replica churn FIRST (highest-priority
        # class; their draws only happen when a serving mix is
        # configured, so batch-only streams stay byte-identical).
        if self._serving_enabled():
            events.extend(
                self._serving_events(cycle, running_since)
            )

        # Arrivals (profile-shaped; every random draw stays on the one
        # seeded stream so (seed, spec) still pins the event sequence).
        if spec.arrival_profile == "sustained":
            arrivals = max(0, int(round(spec.arrival_rate)))
        else:
            arrivals = _poisson(rng, spec.arrival_rate)
            if (
                spec.arrival_profile == "burst"
                and spec.burst_every > 0
                and cycle % spec.burst_every == 0
            ):
                arrivals += max(0, int(spec.burst_size))
        for _ in range(arrivals):
            if len(self.alive) - len(self._pending_delete) >= (
                spec.max_jobs_in_flight
            ):
                break
            size = int(_weighted(rng, spec.gang_sizes)[0])
            cpu_m, mem_mi, _ = _weighted(rng, spec.reqs)
            queue = sorted(spec.queues)[
                rng.randrange(len(spec.queues))
            ]
            duration = rng.randint(*spec.duration_cycles)
            name = f"simjob-{self._job_seq:05d}"
            self._job_seq += 1
            self.alive[name] = {"duration": duration, "min_member": size}
            events.append({
                "kind": "job-create",
                "name": name,
                "queue": queue,
                "replicas": size,
                "min_member": size,
                "cpu_m": int(cpu_m),
                "mem_mi": int(mem_mi),
                "duration": duration,
            })
        return events

    # -- serving mix ---------------------------------------------------------

    def _serving_events(
        self, cycle: int, running_since: Dict[str, int]
    ) -> List[dict]:
        """Serving deployment arrivals (annotated per the api/serving.py
        schema) and replica churn: one replica of a running serving job
        is deleted and a fresh Pending replacement created — the
        rolling-restart analog, re-measuring placement latency on the
        replacement."""
        import math

        from ..api import (
            REPLICA_FLOOR_ANNOTATION_KEY,
            RESERVED_ONLY_ANNOTATION_KEY,
            SLO_SECONDS_ANNOTATION_KEY,
            TPU_GENERATIONS_ANNOTATION_KEY,
            WORKLOAD_CLASS_ANNOTATION_KEY,
            WORKLOAD_CLASS_SERVING,
        )

        spec, rng = self.spec, self.rng
        events: List[dict] = []

        # Replica churn on one running serving job.
        if spec.serving_churn > 0 and rng.random() < spec.serving_churn:
            candidates = sorted(
                name for name, meta in self.alive.items()
                if meta.get("serving")
                and meta.get("replicas")
                and name in running_since
                and name not in self._pending_delete
            )
            if candidates:
                job = candidates[rng.randrange(len(candidates))]
                meta = self.alive[job]
                victim = meta["replicas"].pop(0)
                churned = meta.get("churned", 0)
                meta["churned"] = churned + 1
                replacement = f"{job}-c{churned}"
                meta["replicas"].append(replacement)
                events.append({
                    "kind": "pod-delete",
                    "pod": f"sim/{victim}",
                })
                events.append({
                    "kind": "pod-recreate",
                    "job": job,
                    "names": [replacement],
                })

        arrivals = _poisson(rng, spec.serving_rate)
        for _ in range(arrivals):
            if len(self.alive) - len(self._pending_delete) >= (
                spec.max_jobs_in_flight
            ):
                break
            size = int(_weighted(rng, spec.serving_sizes)[0])
            cpu_m, mem_mi, _ = _weighted(rng, spec.reqs)
            duration = rng.randint(*spec.serving_duration)
            floor = max(
                1, math.ceil(size * max(0.0, spec.serving_floor_frac))
            )
            annotations = {
                WORKLOAD_CLASS_ANNOTATION_KEY: WORKLOAD_CLASS_SERVING,
                SLO_SECONDS_ANNOTATION_KEY: str(spec.serving_slo_s),
                REPLICA_FLOOR_ANNOTATION_KEY: str(floor),
            }
            if rng.random() < spec.serving_reserved_frac:
                annotations[RESERVED_ONLY_ANNOTATION_KEY] = "1"
            if (
                spec.node_generations
                and rng.random() < spec.serving_gen_frac
            ):
                annotations[TPU_GENERATIONS_ANNOTATION_KEY] = (
                    spec.node_generations[
                        rng.randrange(len(spec.node_generations))
                    ]
                )
            name = f"simserve-{self._job_seq:05d}"
            self._job_seq += 1
            self.alive[name] = {
                "duration": duration,
                "min_member": 1,
                "serving": True,
                "replicas": [f"{name}-{i}" for i in range(size)],
                "churned": 0,
            }
            events.append({
                "kind": "job-create",
                "name": name,
                "queue": spec.serving_queue,
                "replicas": size,
                "min_member": 1,
                "cpu_m": int(cpu_m),
                "mem_mi": int(mem_mi),
                "duration": duration,
                "annotations": dict(annotations),
                "replica_floor": floor,
            })
        return events

