"""Mean time of the loop's ``cycle_epilogue`` span a cycle: the work
after the cycle's ``cycle`` span (quality scorecard, flight record,
telemetry feed) that still counts as the loop's busy time."""

from benchmark import spans


def read(ctx):
    return spans.mean_ms(ctx, "cycle_epilogue")
