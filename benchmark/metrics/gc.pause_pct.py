"""Share of the window in which CPython's garbage collector ran on some
thread: the union of the program's ``gc`` spans (one per collection,
the loop's deferred collection at each cycle's end included) over the
window's length."""

from benchmark import spans


def read(ctx):
    return spans.window_pct(ctx, "gc")
