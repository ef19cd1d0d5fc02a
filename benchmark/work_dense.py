"""The full dense solve's readings: which of a traced run's solving
cycles took it, and the bytes one ``bid_dense`` launch needs.

A cycle took the full dense solve when the program's own counter says
so (``allocate_tpu.last_stats["solve_path"] == "dense"``); a program
without that counter has no such cycles here, and every reader of
``dense.*`` gives ``None``. The bytes are a frozen copy of the ``nbytes``
of ``chip_smoke.py``'s ``dense_work``, from the shape the program
records of each launch (``last_stats["bid_dense"]``: rows T, nodes N,
dimensions R, static score rows), at ``work.HBM_BYTES_PER_S``. The
operations are left out: counting them needs a pass over the [T, N]
inputs on the device that the loop should not pay for, so a share of
the roofline from these bytes alone can only read low, never high.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from benchmark import work

KERNEL = "bid_dense_kernel"


def launch_bytes(rows: int, nodes: int, dims: int, static: bool) -> int:
    """Bytes one dense bid launch reads and writes: the [T, N] mask
    (and static scores), the task rows, the node tables, epsilon, and
    the bid and flag it writes, each once."""
    T, N, R = rows, nodes, dims
    return (T * N + (4 * T * N if static else 0)
            + T * (8 * R + 1 + 4) + N * (8 * R + 1) + 4 * R + T * 5)


def least_s(record: dict) -> float:
    """Least time the card could take for a cycle's ``bid_dense``
    launches (``last_stats["bid_dense"]``), bound by its memory."""
    return record["launches"] * launch_bytes(
        record["rows"], record["nodes"], record["dims"],
        record["static"]) / work.HBM_BYTES_PER_S


def dense_solves(ctx) -> List[Tuple[dict, dict, float, float]]:
    """``(spans, stats, start, end)`` of each solving cycle of the window
    whose solve took the full dense path: its spans by name, the
    program's stats the harness kept for the loop cycle that ran it, and
    its solve interval (dispatch start to block end)."""
    out = []
    for spans in ctx.solving_cycles():
        s0 = min(t0 for t0, _ in spans["solve_dispatch"])
        s1 = max(t1 for _, t1 in spans["solve_block"])
        stats = (ctx.cycle_at(s0) or {}).get("stats", {})
        if stats.get("solve_path") == "dense":
            out.append((spans, stats, s0, s1))
    return out


def profiled(ctx) -> Optional[List[Tuple[dict, dict, float, float]]]:
    """The dense solves that lie inside the device trace, or ``None``
    without a device trace."""
    if ctx.profiled is None or not ctx.kernels:
        return None
    lo, hi = ctx.profiled
    return [d for d in dense_solves(ctx) if lo <= d[2] and d[3] <= hi]
