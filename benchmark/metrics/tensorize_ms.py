"""Mean time of the program's ``tensorize`` spans per solving cycle of
the window (masks, candidate selection and the device pack)."""

from benchmark.readings import mean


def read(ctx):
    return mean(sum(t1 - t0 for t0, t1 in c.get("tensorize", ())) * 1e3
                for c in ctx.solving_cycles())
