#!/usr/bin/env python3
"""Time the port's scheduler loop in two checkouts on one CUDA card, in turns.

    python3 chip_cycle_ab.py DIR_A DIR_B [--pairs N] [--shape T N Q G]

Each run is a fresh process started in one checkout's directory (so it
imports that checkout's ``kube_batch_tpu_torch``). It builds
``build_cluster(T, N, Q, G, seed=0)`` (50,000 x 5,000, 5 queues, 500
gangs by default: bench.py's ``large``), loads the bid library before
the clock starts, and drives ``Scheduler(cache, TPU policy,
device="cuda").run_once()`` over bench.py's ``bench_cycle`` cycles:
cold, steady, idle and a 1 % gang burst. Per cycle it records the flight
record's cycle time, the wall time of ``run_once`` (synchronized), the
action's ``tensorize_ms`` and ``solve_ms``, ``select_path`` and the
binds. The runs go A, B, B, A per pair, so neither checkout always runs
first; both checkouts must bind the same (pod, node) set.

It uses only what both checkouts have (``build_cluster``,
``add_gang_burst``, ``Scheduler``, ``allocate_tpu.last_stats``, the
flight recorder). Needs one CUDA card and ``nvcc``; prints one JSON
object per run and a summary (medians per checkout and cycle), and
writes them to ``chiprun_out/chip_cycle_ab.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

_RUNNER = r"""
import hashlib, json, sys, time
import numpy as np
import torch
import kube_batch_tpu_torch.plugins  # noqa: F401
from kube_batch_tpu_torch.actions import allocate_tpu as ATPU
from kube_batch_tpu_torch.obs import RECORDER
from kube_batch_tpu_torch.scheduler import Scheduler
from kube_batch_tpu_torch.solver import _build
from kube_batch_tpu_torch.utils.test_utils import add_gang_burst, build_cluster

n_tasks, n_nodes, n_queues, n_groups = SHAPE
_build.load_library()
cache = build_cluster(n_tasks, n_nodes, n_queues, n_groups, seed=0)
sched = Scheduler(cache, "config/tpu-batch-conf-tpu.yaml", device="cuda")
rng = np.random.RandomState(1)
out = {}
for name in ("cold", "steady", "idle", "delta"):
    if name == "delta":
        add_gang_burst(cache, rng, "pgd", max(1, n_groups // 100),
                       n_tasks // n_groups, n_queues)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sched.run_once()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    assert cache.wait_for_side_effects(timeout=600.0)
    st = dict(ATPU.last_stats)
    out[name] = {"cycle_ms": RECORDER.snapshot()[-1].get("e2e_ms"),
                 "wall_ms": wall, "tensorize_ms": st.get("tensorize_ms"),
                 "solve_ms": st.get("solve_ms"),
                 "select_path": st.get("select_path"),
                 "backend": st.get("backend")}
binds = sorted(cache.binder.binds.items())
out["binds"] = len(binds)
out["binds_digest"] = hashlib.blake2b(
    json.dumps(binds).encode(), digest_size=16).hexdigest()
cache.shutdown()
print("RESULT " + json.dumps(out))
"""

METRICS = ("cycle_ms", "wall_ms", "tensorize_ms", "solve_ms")


def run(tree: Path, shape, timeout):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", _RUNNER.replace("SHAPE", repr(shape))],
        cwd=tree, env=env, capture_output=True, text=True, timeout=timeout,
    )
    if out.returncode != 0:
        raise SystemExit(f"{tree}: exit {out.returncode}\n{out.stderr[-3000:]}")
    line = next(l for l in out.stdout.splitlines() if l.startswith("RESULT "))
    return json.loads(line[len("RESULT "):])


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("a", type=Path)
    parser.add_argument("b", type=Path)
    parser.add_argument("--pairs", type=int, default=2)
    parser.add_argument("--shape", type=int, nargs=4,
                        default=(50_000, 5_000, 5, 500))
    parser.add_argument("--timeout", type=float, default=600.0)
    ns = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("chip_cycle_ab: no CUDA device is available", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    runs = []
    for pair in range(ns.pairs):
        for side, tree in (("a", ns.a), ("b", ns.b), ("b", ns.b),
                           ("a", ns.a)):
            res = run(tree.resolve(), tuple(ns.shape), ns.timeout)
            res.update(side=side, pair=pair)
            runs.append(res)
            print(json.dumps(res), flush=True)
    digests = {r["binds_digest"] for r in runs}
    summary = {"card": smi, "shape": ns.shape, "runs": len(runs),
               "same_binds": len(digests) == 1, "median": {}}
    for side in ("a", "b"):
        mine = [r for r in runs if r["side"] == side]
        summary["median"][side] = {
            cycle: {m: statistics.median(r[cycle][m] for r in mine)
                    for m in METRICS if mine[0][cycle][m] is not None}
            for cycle in ("cold", "steady", "idle", "delta")}
    print(json.dumps(summary))
    Path("chiprun_out").mkdir(exist_ok=True)
    Path("chiprun_out/chip_cycle_ab.json").write_text(
        json.dumps({"summary": summary, "runs": runs}, indent=1))
    return 0 if summary["same_binds"] else 1


if __name__ == "__main__":
    sys.exit(main())
