"""Reductions shared by the per-layer metric readers in
``benchmark/metrics/``: the traced run's spans grouped by cycle, the
solve intervals, and the device's busy time inside an interval.

A reader is a file ``benchmark/metrics/<metric name>.py`` with
``read(ctx) -> float | None``; ``None`` (nothing to read in this run)
leaves the metric out of the result line. ``ctx`` is a :class:`Context`.
"""

from __future__ import annotations

import importlib.util
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Optional, Tuple

HERE = Path(__file__).resolve().parent


class Context:
    """What a traced run read: the window, the benchmark's own cycle
    records and dispatch log, the program's spans, and the device
    trace."""

    def __init__(self, window, cycles, log, tracing):
        self.window = window
        self.cycles = cycles
        self.log = log
        self.spans = tracing.spans
        self.kernels = tracing.kernels
        self.profiled = tracing.profiled
        self.kernel = tracing.kernel
        self.kernel_ms = tracing.kernel_ms
        self.kernel_work = tracing.kernel_work

    def in_window(self, t: float) -> bool:
        return self.window[0] <= t < self.window[1]

    def spans_by_cycle(self) -> Dict[object, Dict[str, List[tuple]]]:
        """{program cycle: {span name: [(t0, t1), ...]}} for spans that
        start in the window."""
        out: Dict[object, Dict[str, List[tuple]]] = defaultdict(
            lambda: defaultdict(list))
        for name, t0, t1, cycle, _ in self.spans:
            if self.in_window(t0):
                out[cycle][name].append((t0, t1))
        return out

    def solving_cycles(self) -> List[Dict[str, List[tuple]]]:
        """The window's cycles that dispatched a solve."""
        return [c for c in self.spans_by_cycle().values()
                if c.get("solve_dispatch") and c.get("solve_block")]

    def solve_intervals(self) -> List[Tuple[float, float]]:
        """[dispatch start, block end] of each solving cycle."""
        return [(min(t0 for t0, _ in c["solve_dispatch"]),
                 max(t1 for _, t1 in c["solve_block"]))
                for c in self.solving_cycles()]

    def cycle_at(self, t: float) -> Optional[dict]:
        """The benchmark's record of the loop cycle running at ``t``."""
        for c in self.cycles:
            if c["t0"] <= t <= c.get("t1", c["t0"]):
                return c
        return None


def union_length(intervals, lo: float, hi: float) -> float:
    """Length of the union of ``intervals`` clipped to [lo, hi]."""
    total, end = 0.0, lo
    for a, b in sorted(intervals):
        a, b = max(a, end), min(b, hi)
        if b > a:
            total += b - a
            end = b
    return total


def mean(values) -> Optional[float]:
    values = list(values)
    return sum(values) / len(values) if values else None


def load_reader(name: str):
    """``benchmark/metrics/<name>.py``'s ``read``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def breakdown(ctx: Context) -> Optional[dict]:
    """The device operations that took most time in the profiled part,
    and the idle time between kernels by the innermost program span
    open on the host across it."""
    if not ctx.kernels or ctx.profiled is None:
        return None
    lo, hi = ctx.profiled
    by_name: Dict[str, float] = defaultdict(float)
    for name, a, b in ctx.kernels:
        by_name[name] += b - a
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps: Dict[str, float] = defaultdict(float)
    spans = sorted((s for s in ctx.spans if s[2] > lo and s[1] < hi),
                   key=lambda s: s[1])
    active: list = []
    nxt, end = 0, lo
    for _, a, b in ctx.kernels + [("", hi, hi)]:
        if a > end:
            mid = (a + end) / 2.0
            while nxt < len(spans) and spans[nxt][1] <= mid:
                active.append(spans[nxt])
                nxt += 1
            active = [s for s in active if s[2] >= mid]
            inner = min(active, key=lambda s: s[2] - s[1], default=None)
            gaps[inner[0] if inner else "no span"] += a - end
        end = max(end, b)
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k, v] for k, v in ops],
            "idle_gaps": [[k, v] for k, v in idle]}
