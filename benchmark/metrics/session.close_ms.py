"""Mean time of the program's ``close_session`` span over every cycle
of the window."""

from benchmark.readings import mean


def read(ctx):
    return mean((t1 - t0) * 1e3 for c in ctx.spans_by_cycle().values()
                for t0, t1 in c.get("close_session", ()))
