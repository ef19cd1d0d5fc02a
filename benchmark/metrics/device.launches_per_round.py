"""Kernels that started inside the solve's spans, over the solver's
rounds, for the solving cycles inside the device trace."""

import bisect


def read(ctx):
    if ctx.profiled is None or not ctx.kernels:
        return None
    lo, hi = ctx.profiled
    starts = [a for _, a, _ in ctx.kernels]
    launches = rounds = 0
    for s0, s1 in ctx.solve_intervals():
        if s0 < lo or s1 > hi:
            continue
        cyc = ctx.cycle_at(s0)
        r = (cyc or {}).get("stats", {}).get("rounds")
        if not r:
            continue
        launches += bisect.bisect_left(starts, s1) - bisect.bisect_left(starts, s0)
        rounds += r
    return launches / rounds if rounds else None
