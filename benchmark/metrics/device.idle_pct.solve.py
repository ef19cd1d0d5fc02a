"""Share of the solve's time (dispatch to the fetched assignment) in
which the card ran no kernel, over the solving cycles inside the
device trace."""

from benchmark.readings import union_length


def read(ctx):
    if ctx.profiled is None or not ctx.kernels:
        return None
    lo, hi = ctx.profiled
    total = busy = 0.0
    spans = [(a, b) for name, a, b in ctx.kernels]
    for s0, s1 in ctx.solve_intervals():
        if s0 < lo or s1 > hi:
            continue
        total += s1 - s0
        busy += union_length(spans, s0, s1)
    if total <= 0:
        return None
    return 100.0 * (1.0 - busy / total)
