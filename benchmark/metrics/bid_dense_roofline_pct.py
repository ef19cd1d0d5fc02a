"""The dense bid kernel's share of its roofline in the cell's own
solves: over the solving cycles inside the device trace whose solve
took the full dense path and whose every ``bid_dense`` launch (the
program's count, ``last_stats["bid_dense"]``) has its
``bid_dense_kernel`` event in the cycle's solve interval, the summed
least time of those launches (bytes only, ``benchmark/work_dense.py``)
over the summed device time of those events.

The name does not end in ``_roofline``: ``run.roofline_kernel`` would
then arm ``trace.Capture`` on ``bid_dense`` for a replay that
``trace.WORK`` has no work figures for, and ``Tracing.finish`` would
raise. The share is read from the window's own device trace instead,
with no replay."""

from benchmark.work_dense import KERNEL, least_s, profiled


def read(ctx):
    solves = profiled(ctx)
    if not solves:
        return None
    events = [(a, b) for name, a, b in ctx.kernels if KERNEL in name]
    least = took = 0.0
    for _, stats, s0, s1 in solves:
        rec = stats.get("bid_dense")
        if not rec or not rec["launches"]:
            continue
        inside = [b - a for a, b in events if s0 <= a < s1]
        if len(inside) != rec["launches"]:
            continue
        least += least_s(rec)
        took += sum(inside)
    return 100.0 * least / took if took > 0 else None
