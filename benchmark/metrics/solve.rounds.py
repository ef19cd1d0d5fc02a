"""Mean rounds of the solver per solving cycle of the window, from the
allocate_tpu action's own count (``rounds``)."""

from benchmark.readings import mean


def read(ctx):
    return mean(c["stats"]["rounds"] for c in ctx.cycles
                if ctx.in_window(c["t0"]) and "rounds" in c.get("stats", {}))
