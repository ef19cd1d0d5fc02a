"""Span reductions shared by the readers of the loop's, the solver's,
the collector's and the informer's spans (``solve.round_ms``,
``solve.round_issue_ms``, ``gc.pause_pct``, ``cycle.epilogue_ms``,
``cache.ingest_pct``). Each reads only the spans that start in the
window; a program without the span gives ``None``, never 0."""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import List, Optional, Tuple

from benchmark.readings import mean, union_length


def named(ctx, name: str) -> List[Tuple[float, float, object]]:
    """``(t0, t1, thread)`` of every ``name`` span that starts in the
    window."""
    return [(t0, t1, tid) for n, t0, t1, _, tid in ctx.spans
            if n == name and ctx.in_window(t0)]


def mean_ms(ctx, name: str) -> Optional[float]:
    """Mean duration of the window's ``name`` spans, in ms."""
    return mean((t1 - t0) * 1e3 for t0, t1, _ in named(ctx, name))


def window_pct(ctx, name: str) -> Optional[float]:
    """The union of the window's ``name`` spans, on any thread and cut
    to the window, over the window's length, in %."""
    found = named(ctx, name)
    if not found:
        return None
    lo, hi = ctx.window
    return 100.0 * union_length([(a, b) for a, b, _ in found], lo, hi) \
        / (hi - lo)


def self_ms(ctx, name: str, child: str) -> Optional[float]:
    """Mean duration of the window's ``name`` spans less the ``child``
    spans on the same thread that lie inside each, in ms."""
    parents = named(ctx, name)
    if not parents:
        return None
    kids = defaultdict(list)
    for a, b, tid in named(ctx, child):
        kids[tid].append((a, b))
    starts = {}
    for tid, inner in kids.items():
        inner.sort()
        starts[tid] = [k[0] for k in inner]
    total = 0.0
    for a, b, tid in parents:
        inner = kids.get(tid, ())
        i = bisect.bisect_left(starts.get(tid, ()), a)
        covered = 0.0
        while i < len(inner) and inner[i][0] <= b:
            if inner[i][1] <= b:
                covered += inner[i][1] - inner[i][0]
            i += 1
        total += (b - a) - covered
    return total * 1e3 / len(parents)
