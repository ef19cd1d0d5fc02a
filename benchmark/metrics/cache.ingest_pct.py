"""Share of the window spent in the cache's pod and PodGroup event
handlers, the wait for the cache's mutex included: the union of the
program's ``ingest`` spans over the window's length."""

from benchmark import spans


def read(ctx):
    return spans.window_pct(ctx, "ingest")
