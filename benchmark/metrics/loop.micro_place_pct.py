"""Share of the window's assignments made by micro cycles (the loop's
event-driven fast path) rather than periodic ones: the benchmark's own
record of which cycle handed each assignment to the cache."""


def read(ctx):
    kinds = [ctx.cycles[rec[2]]["kind"] for rec in ctx.log
             if rec[0] == "dispatch" and rec[2] is not None
             and ctx.in_window(rec[1])]
    if not kinds:
        return None
    return 100.0 * sum(k == "micro" for k in kinds) / len(kinds)
