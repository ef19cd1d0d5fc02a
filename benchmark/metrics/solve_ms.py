"""Mean per solving cycle of the program's ``solve_dispatch`` plus
``solve_block`` spans; the block ends with the assignment fetched to
the host, so the time is the device's as the host waits for it."""

from benchmark.readings import mean


def read(ctx):
    return mean(sum(t1 - t0 for t0, t1 in c["solve_dispatch"] + c["solve_block"])
                * 1e3 for c in ctx.solving_cycles())
