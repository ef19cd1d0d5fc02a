"""The one traffic generator: a traffic mix's parameters and a
configuration in, a seeded plan of the cluster's pods out.

A mix is a data file in ``benchmark/traffic/`` (found by name). Its keys:

- ``arrivals``: ``{"kind": "storm", "every_s": E, "jitter_s": J}`` (a
  storm of the mix's ``gangs`` every E seconds, each storm offset by
  0..J seconds, stratified) or ``{"kind": "poisson"}`` (gangs one at a
  time drawn from ``gang_sizes``, at exponential gaps, at ``rate`` pods
  a second);
- ``gangs`` (storms): ``{size: count}``, the gangs of one storm;
  ``gang_sizes`` (Poisson): ``{size: probability}``;
- ``min_member``: ``"uniform"`` (1..size, as kube-batch's synthetic
  benchmark draws it, stratified over an arrival's gangs) or
  ``"size"``;
- ``lifetime_s``: ``[a, b]``, a pod's run time from its bind, uniform;
- ``queue_share``: each queue's share of the gangs, stratified over an
  arrival's gangs (one entry a queue of the configuration).

The running population at the start is the configuration's count of
pods, in gangs of the mix, each with a residual lifetime drawn from the
stationary residual law of the lifetime, so the population holds from
the first second when the mix's rate times its mean lifetime is the
population. Requests come from the configuration's mix as a balanced
set (each value equally often) in seeded order, and a storm's gangs,
minMembers, queues and the storms' offsets are stratified: every seed
gets the same set of sizes and arrivals, in another order.

Everything here is plain NumPy and imports nothing of the program.
"""

from __future__ import annotations

import json
import math
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List

import numpy as np

HERE = Path(__file__).resolve().parent


def load_json(folder: str, name: str) -> dict:
    """The data file ``benchmark/<folder>/<name>.json``."""
    path = HERE / folder / f"{name}.json"
    with open(path) as f:
        return json.load(f)


@dataclass
class Gang:
    """One PodGroup and its pods. ``due`` is seconds from the window's
    start (``-inf`` for the running population); ``lifetime`` is each
    pod's run time from its bind, or for a pod running at the start
    what is left of it."""

    name: str
    queue: int
    min_member: int
    due: float
    cpu_m: np.ndarray
    mem_mi: np.ndarray
    lifetime: np.ndarray
    warmup: bool = False


@dataclass
class Plan:
    initial: List[Gang]
    arrivals: List[Gang]      # in due order, warm-up first
    pods_per_s: float
    storm_pods: int           # pods a storm (0 for other arrivals)


def rng_for(seed: int, stream: int) -> np.random.Generator:
    """An independent generator per stream of one seed (any integer)."""
    return np.random.default_rng([seed % (1 << 64), stream])


def storm_sizes(traffic: dict) -> List[int]:
    """The gang sizes of one storm, largest first."""
    return [int(k) for k, n in sorted(traffic["gangs"].items(),
                                      key=lambda kv: -int(kv[0]))
            for _ in range(int(n))]


def pods_per_second(traffic: dict) -> float:
    """The mix's arrival rate."""
    arr = traffic["arrivals"]
    if arr["kind"] == "storm":
        return sum(storm_sizes(traffic)) / float(arr["every_s"])
    return float(traffic["rate"])


def residual_lifetimes(rng, n: int, a: float, b: float) -> np.ndarray:
    """Inverse-CDF draws from the stationary residual life of U(a, b),
    whose density is P(L > r) / E[L]."""
    m = (a + b) / 2.0
    um = rng.random(n) * m
    tail = b - np.sqrt(np.maximum((b - a) * (a + b - 2.0 * um), 0.0))
    return np.where(um <= a, um, tail)


def balanced(rng, values, n: int) -> np.ndarray:
    """``n`` values of ``values``, each equally often, in seeded order."""
    reps = -(-n // len(values))
    return rng.permutation(np.tile(np.asarray(values, dtype=np.int64),
                                   reps))[:n]


def one_gang_size(rng, traffic: dict) -> int:
    sizes = {int(k): float(v) for k, v in traffic["gang_sizes"].items()}
    keys = sorted(sizes)
    p = np.array([sizes[k] for k in keys])
    return int(rng.choice(keys, p=p / p.sum()))


def population_sizes(rng, traffic: dict, total: int) -> List[int]:
    """Gang sizes of the running population, adding up to ``total`` (the
    last gang is cut to fit): storms of the mix one after another, each
    in seeded order, or draws from a Poisson mix's sizes."""
    out, left = [], total
    while left > 0:
        if "gangs" in traffic:
            batch = [int(s) for s in rng.permutation(storm_sizes(traffic))]
        else:
            batch = [one_gang_size(rng, traffic)]
        for s in batch:
            if left <= 0:
                break
            out.append(min(s, left))
            left -= out[-1]
    return out


def strata(rng, n: int) -> np.ndarray:
    """``n`` draws of U(0, 1), one from each of ``n`` equal slices, in
    seeded order: every seed gets the same spread of values."""
    return (rng.permutation(n) + 0.5) / n


def min_members(rng, traffic: dict, sizes: List[int]) -> List[int]:
    """minMember of each gang of one arrival. ``"uniform"`` is 1..size
    (kube-batch's synthetic benchmark), stratified over the arrival's
    gangs of each size, so every seed gets the same pairs of size and
    minMember."""
    rule = traffic["min_member"]
    if rule == "size":
        return list(sizes)
    if rule != "uniform":
        raise ValueError(f"unknown min_member rule {rule!r}")
    sizes = np.asarray(sizes, dtype=np.int64)
    out = np.empty(sizes.size, dtype=np.int64)
    for s in np.unique(sizes):
        at = np.flatnonzero(sizes == s)
        u = strata(rng, at.size) if at.size > 1 else rng.random(1)
        out[at] = np.minimum((u * s + 1e-9).astype(np.int64) + 1, s)
    return out.tolist()


def queues(rng, traffic: dict, config: dict, sizes: List[int]) -> np.ndarray:
    """Queue of each gang of one arrival, by the mix's shares, stratified
    over the arrival's gangs of each size: every seed gives each queue
    the same gangs."""
    share = np.asarray(traffic["queue_share"], dtype=np.float64)
    if share.size != config["queues"]:
        raise ValueError(f"queue_share has {share.size} entries for "
                         f"{config['queues']} queues")
    cum = np.cumsum(share / share.sum())
    sizes = np.asarray(sizes, dtype=np.int64)
    out = np.empty(sizes.size, dtype=np.int64)
    for s in np.unique(sizes):
        at = np.flatnonzero(sizes == s)
        u = strata(rng, at.size) if at.size > 1 else rng.random(1)
        out[at] = np.searchsorted(cum, u, side="right")
    return np.minimum(out, share.size - 1)


def _gangs(rng, traffic, config, prefix, sizes, due, lifetimes, warm):
    n = sum(sizes)
    req = config["requests"]
    cpu = balanced(rng, req["cpu_m"], n)
    mem = balanced(rng, req["memory_mi"], n)
    mins = min_members(rng, traffic, sizes)
    qs = queues(rng, traffic, config, sizes)
    out, off = [], 0
    for i, s in enumerate(sizes):
        sl = slice(off, off + s)
        out.append(Gang(
            name=f"{prefix}g{i}", queue=int(qs[i]),
            min_member=mins[i], due=due,
            cpu_m=cpu[sl], mem_mi=mem[sl], lifetime=lifetimes[sl],
            warmup=warm,
        ))
        off += s
    return out


def make_plan(traffic: dict, config: dict, seed: int,
              seconds: float) -> Plan:
    """The seeded plan of one run: the running population, one warm-up
    burst (delivered in set-up, before the window) and every arrival
    due in ``[0, seconds)``. The warm-up burst counts toward the
    configuration's population, so the window opens on that many
    running pods."""
    rate = pods_per_second(traffic)
    a, b = (float(x) for x in traffic["lifetime_s"])
    arr = traffic["arrivals"]
    rng = rng_for(seed, 1)
    arrivals: List[Gang] = []
    storm = 0
    if arr["kind"] == "storm":
        every = float(arr["every_s"])
        sizes = storm_sizes(traffic)
        storm = sum(sizes)
        count = int(math.ceil(seconds / every))
        offsets = strata(rng, count) * arr["jitter_s"]
        dues = [-1.0] + [k * every + float(offsets[k]) for k in range(count)]
        for k, due in enumerate(dues):
            if due >= seconds:
                break
            arrivals += _gangs(
                rng, traffic, config, f"s{k}",
                [int(s) for s in rng.permutation(sizes)],
                due, rng.uniform(a, b, storm), k == 0,
            )
    elif arr["kind"] == "poisson":
        mean_size = sum(int(k) * float(v)
                        for k, v in traffic["gang_sizes"].items())
        gang_rate = rate / mean_size
        t, k = -1.0, 0
        while t < seconds:
            size = one_gang_size(rng, traffic)
            arrivals += _gangs(rng, traffic, config, f"p{k}-", [size], t,
                               rng.uniform(a, b, size), t < 0)
            t = max(t, 0.0) + float(rng.exponential(1.0 / gang_rate))
            k += 1
    else:
        raise ValueError(f"unknown arrival kind {arr['kind']!r}")
    warm = sum(len(g.lifetime) for g in arrivals if g.warmup)
    rng = rng_for(seed, 0)
    pop = max(config["population"] - warm, 0)
    initial = _gangs(rng, traffic, config, "r",
                     population_sizes(rng, traffic, pop), -math.inf,
                     residual_lifetimes(rng, pop, a, b), False)
    return Plan(initial, arrivals, rate, storm)


def simulate_population(plan: Plan, horizon: float,
                        step: float = 1.0) -> Dict[str, np.ndarray]:
    """Running pods at each ``step`` of ``[0, horizon)`` if every pod
    ran from its due time for its lifetime: the generator's own balance
    check, with no scheduler in it."""
    starts = [np.zeros(sum(len(g.lifetime) for g in plan.initial))]
    ends = [np.concatenate([g.lifetime for g in plan.initial])]
    for g in plan.arrivals:
        starts.append(np.full(len(g.lifetime), g.due))
        ends.append(g.due + g.lifetime)
    s = np.sort(np.concatenate(starts))
    e = np.sort(np.concatenate(ends))
    t = np.arange(0.0, horizon, step)
    running = (np.searchsorted(s, t, side="right")
               - np.searchsorted(e, t, side="right"))
    return {"t": t, "running": running}
